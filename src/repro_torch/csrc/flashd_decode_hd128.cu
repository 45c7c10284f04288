// K2 / K3 (flashd_decode.cu) at head dims 96 and 128: a translation unit of its own,
// so that nvcc builds the head dims in parallel (kernels/_build.py UNITS).
#include "flashd_decode.cuh"

namespace flashd {
namespace decode {
FLASHD_DECODE_HD(96) { return dispatch_types<96>(a, q_type, kv_type, paged, s); }
FLASHD_DECODE_HD(128) { return dispatch_types<128>(a, q_type, kv_type, paged, s); }
}  // namespace decode
}  // namespace flashd
