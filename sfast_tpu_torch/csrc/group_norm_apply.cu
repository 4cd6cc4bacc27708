// K5: GroupNorm apply over NHWC bf16 x from its per-channel statistics:
// out = act((x - mean) * rstd * gamma + beta), f32 math, bf16 out, with
// act one of none, SiLU and the tanh GELU.
//
// Replaces the Pallas kernel sfast_tpu/ops/group_norm.py::_norm_apply_kernel
// (the second pallas_call of group_norm_pallas; the first is K3's
// statistics kernel, csrc/group_norm_stats.cu).  On the opt-in path
// (enable_fused_group_norm) it runs every UNet GroupNorm: (2, H, W, C) for
// H*W in {64^2, 32^2, 16^2, 8^2} and C from 320 to 2560, 61 per UNet eval.
//
// What bounds it on the H100: device memory.  It reads x once and writes
// the output once (2.6 MB each at the largest UNet shape) with a few flops
// per element, so the target is one coalesced pass at full bandwidth.
//
// Design:
// - each thread moves 16-byte vectors (8 channels) of x, so every load and
//   store is a full 16-byte access and a warp covers 512 contiguous bytes;
// - the per-(n, c) affine folds into one multiply-add: scale = rstd * gamma,
//   shift = beta - mean * scale.  Each block computes them for all C
//   channels of its sample into shared memory once, and then streams a
//   contiguous run of its sample's vectors, about 4 per thread;
// - the activation is a template parameter, so each variant is a plain
//   streaming loop with no branch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int VECS_PER_THREAD = 4;
constexpr int VECS_PER_BLOCK = THREADS * VECS_PER_THREAD;

template <int ACT>
__device__ __forceinline__ float activate(float y) {
  if (ACT == 1) return y / (1.f + expf(-y));  // SiLU
  if (ACT == 2) {                              // GELU, tanh form
    const float u = 0.7978845608028654f * (y + 0.044715f * y * y * y);
    return 0.5f * y * (1.f + tanhf(u));
  }
  return y;
}

template <int ACT>
__global__ void __launch_bounds__(THREADS)
    gn_apply_kernel(const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ mean,
                    const float* __restrict__ rstd,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta,
                    __nv_bfloat16* __restrict__ out, long long vecs_per_sample,
                    int c) {
  extern __shared__ __align__(16) float affine[];  // scale[c], shift[c]
  float* scale = affine;
  float* shift = affine + c;
  const int n = blockIdx.y;
  for (int ch = threadIdx.x; ch < c; ch += THREADS) {
    const float s = rstd[n * c + ch] * gamma[ch];
    scale[ch] = s;
    shift[ch] = beta[ch] - mean[n * c + ch] * s;
  }
  __syncthreads();

  const int vpr = c / 8;  // vectors per pixel
  const long long v0 = static_cast<long long>(blockIdx.x) * VECS_PER_BLOCK;
  const long long v1 = min(vecs_per_sample, v0 + VECS_PER_BLOCK);
  const uint4* xs = reinterpret_cast<const uint4*>(x) + n * vecs_per_sample;
  uint4* os = reinterpret_cast<uint4*>(out) + n * vecs_per_sample;
  for (long long v = v0 + threadIdx.x; v < v1; v += THREADS) {
    const int c0 = static_cast<int>(v % vpr) * 8;
    const uint4 in = xs[v];
    const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&in);
    uint4 res;
    __nv_bfloat162* r = reinterpret_cast<__nv_bfloat162*>(&res);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(e[j]);
      const int ch = c0 + 2 * j;
      const float y0 = activate<ACT>(f.x * scale[ch] + shift[ch]);
      const float y1 = activate<ACT>(f.y * scale[ch + 1] + shift[ch + 1]);
      r[j] = __floats2bfloat162_rn(y0, y1);
    }
    os[v] = res;
  }
}

template <int ACT>
cudaError_t launch(const void* x, const void* mean, const void* rstd,
                   const void* gamma, const void* beta, void* out, int n,
                   int hw, int c, cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(c) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gn_apply_kernel<ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long vecs = static_cast<long long>(hw) * (c / 8);
  const dim3 grid(static_cast<unsigned>((vecs + VECS_PER_BLOCK - 1) / VECS_PER_BLOCK), n);
  gn_apply_kernel<ACT><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<__nv_bfloat16*>(out), vecs, c);
  return cudaGetLastError();
}

}  // namespace

// x, out: (n, hw, c) bf16; mean, rstd: (n, c) f32; gamma, beta: (c,) f32.
// act: 0 none, 1 SiLU, 2 tanh GELU.  Requires c % 8 == 0 (the Python
// wrapper checks it); returns cudaErrorInvalidValue otherwise.
extern "C" int sfast_group_norm_apply_bf16(const void* x, const void* mean,
                                           const void* rstd, const void* gamma,
                                           const void* beta, void* out, int n,
                                           int hw, int c, int act, void* stream) {
  if (c % 8 != 0 || n <= 0 || hw <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (act) {
    case 0: return launch<0>(x, mean, rstd, gamma, beta, out, n, hw, c, st);
    case 1: return launch<1>(x, mean, rstd, gamma, beta, out, n, hw, c, st);
    case 2: return launch<2>(x, mean, rstd, gamma, beta, out, n, hw, c, st);
    default: return cudaErrorInvalidValue;
  }
}
