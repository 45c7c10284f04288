// K4 (flashd_varlen.cu) at head dims 64 and 96: a translation unit of its own, so
// that nvcc builds the head dims in parallel (kernels/_build.py UNITS).
#include "flashd_varlen.cuh"

namespace flashd {
namespace varlen {
FLASHD_VARLEN_HD(64) { return dispatch_types<64>(a, q_type, kv_type, nbr, s); }
FLASHD_VARLEN_HD(96) { return dispatch_types<96>(a, q_type, kv_type, nbr, s); }
}  // namespace varlen
}  // namespace flashd
