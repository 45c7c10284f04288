// K2 / K3 (flashd_decode.cu) at head dims 48 and 64: a translation unit of its own,
// so that nvcc builds the head dims in parallel (kernels/_build.py UNITS).
#include "flashd_decode.cuh"

namespace flashd {
namespace decode {
FLASHD_DECODE_HD(48) { return dispatch_types<48>(a, q_type, kv_type, paged, s); }
FLASHD_DECODE_HD(64) { return dispatch_types<64>(a, q_type, kv_type, paged, s); }
}  // namespace decode
}  // namespace flashd
