// K5 (flashd_bwd.cu) at head dim 256: a translation unit of its own, so that
// nvcc builds it beside the other head dims (kernels/_build.py UNITS).
#include "flashd_bwd.cuh"

namespace flashd {
namespace bwd {
FLASHD_BWD_HD(256) { return bf16 ? launch<__nv_bfloat16, 256>(a, s) : launch<float, 256>(a, s); }
}  // namespace bwd
}  // namespace flashd
