// K4 (flashd_varlen.cu) at head dim 256: a translation unit of its own, so
// that nvcc builds the head dims in parallel (kernels/_build.py UNITS).
#include "flashd_varlen.cuh"

namespace flashd {
namespace varlen {
FLASHD_VARLEN_HD(256) { return dispatch_types<256>(a, q_type, kv_type, nbr, s); }
}  // namespace varlen
}  // namespace flashd
