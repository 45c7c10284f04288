// K2 / K3 (flashd_decode.cu) at head dim 256: a translation unit of its own,
// so that nvcc builds the head dims in parallel (kernels/_build.py UNITS).
#include "flashd_decode.cuh"

namespace flashd {
namespace decode {
FLASHD_DECODE_HD(256) { return dispatch_types<256>(a, q_type, kv_type, paged, s); }
}  // namespace decode
}  // namespace flashd
