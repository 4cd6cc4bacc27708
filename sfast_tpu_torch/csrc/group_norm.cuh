// GroupNorm pieces shared by K3 (group_norm_stats.cu), K5
// (group_norm_apply.cu) and the fused GroupNorm (group_norm_fused.cu): the
// activations, the apply of one 16-byte vector (8 bf16 channels) from its
// channels' scale and shift, and the sums of one vector.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sfast {
namespace gn {

// SiLU is y / (1 + e^-y) with the MUFU exponential and reciprocal
// (__expf, __fdividef: a few ulp of f32, far below the bf16 rounding of the
// output).  Built with -DSFAST_GN_SILU_IEEE it takes expf and an IEEE
// division, as K5 did before; tools/gn_silu_cost.py times the two forms.
template <int ACT>
__device__ __forceinline__ float activate(float y) {
#ifdef SFAST_GN_SILU_IEEE
  if (ACT == 1) return y / (1.f + expf(-y));  // SiLU
#else
  if (ACT == 1) return __fdividef(y, 1.f + __expf(-y));  // SiLU
#endif
  if (ACT == 2) {                              // GELU, tanh form
    const float u = 0.7978845608028654f * (y + 0.044715f * y * y * y);
    return 0.5f * y * (1.f + tanhf(u));
  }
  return y;
}

// act(x * scale + shift) of 8 channels, f32 math, rounded to bf16 once.
template <int ACT>
__device__ __forceinline__ uint4 apply_vec(uint4 in, const float* scale, const float* shift) {
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&in);
  uint4 res;
  __nv_bfloat162* r = reinterpret_cast<__nv_bfloat162*>(&res);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(e[j]);
    r[j] = __floats2bfloat162_rn(activate<ACT>(f.x * scale[2 * j] + shift[2 * j]),
                                 activate<ACT>(f.y * scale[2 * j + 1] + shift[2 * j + 1]));
  }
  return res;
}

// Adds a vector's 8 channels to per-channel sums of x and x^2.
__device__ __forceinline__ void accumulate_vec(uint4 in, float* s1, float* s2) {
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&in);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(e[j]);
    s1[2 * j] += f.x;
    s1[2 * j + 1] += f.y;
    s2[2 * j] += f.x * f.x;
    s2[2 * j + 1] += f.y * f.y;
  }
}

}  // namespace gn
}  // namespace sfast
