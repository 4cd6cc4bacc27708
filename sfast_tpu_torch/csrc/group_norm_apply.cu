// K5: GroupNorm apply over NHWC bf16 x from its per-channel statistics:
// out = act((x - mean) * rstd * gamma + beta), f32 math, bf16 out, with
// act one of none, SiLU and the tanh GELU.
//
// Replaces the Pallas kernel sfast_tpu/ops/group_norm.py::_norm_apply_kernel
// (the second pallas_call of group_norm_pallas; the first is K3's
// statistics kernel, csrc/group_norm_stats.cu).  It is that kernel's own
// entry point, group_norm_apply, and the second half of
// group_norm(backend='kernel') for a shape the fused GroupNorm's rule
// refuses (csrc/group_norm_fused.cu runs the UNet's 61 GroupNorms an eval).
//
// What bounds it on the H100: device memory.  It reads x once and writes
// the output once with a few flops per element, so the target is one
// coalesced pass at full bandwidth.
//
// Design:
// - grid (row blocks, channel slabs, n).  A slab is up to 256 16-byte
//   vectors (8 channels each) of a row; thread t owns vector t % vs of its
//   slab in every rp-th row of its block (rp = threads / vs), so its 8
//   channels never change: it computes their scale = rstd * gamma and
//   shift = beta - mean * scale once, into registers, from the statistics
//   of those channels only, and does no index arithmetic per vector;
// - every load and store is a full 16-byte access and a warp covers
//   contiguous runs of a row;
// - a block takes 1 to 4 of its threads' row steps, fewer on small maps,
//   so that the grid has about two blocks per SM where the map allows;
// - the apply of one vector (gn::apply_vec, group_norm.cuh) is the fused
//   GroupNorm's; the activation is a template parameter, so each variant
//   is a plain streaming loop with no branch.

#include "group_norm.cuh"

namespace {

using namespace sfast::gn;

constexpr int THREADS = 256;
constexpr int MAX_STEPS = 4;
constexpr int TARGET_BLOCKS = 2 * 132;

template <int ACT>
__global__ void __launch_bounds__(THREADS)
    gn_apply_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ mean,
                    const float* __restrict__ rstd, const float* __restrict__ gamma,
                    const float* __restrict__ beta, __nv_bfloat16* __restrict__ out, int hw,
                    int c, int vs, int rp, int rows_per_block) {
  const int vpr = c / 8, n = blockIdx.z;
  const int v = blockIdx.y * vs + threadIdx.x % vs, rl = threadIdx.x / vs;
  if (v >= vpr || rl >= rp) return;
  float sc[8], sh[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int ch = v * 8 + j;
    sc[j] = rstd[n * c + ch] * gamma[ch];
    sh[j] = beta[ch] - mean[n * c + ch] * sc[j];
  }
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(hw, r0 + rows_per_block);
  const long long base = static_cast<long long>(n) * hw * c + v * 8;
  for (int r = r0 + rl; r < r1; r += rp) {
    const long long off = base + static_cast<long long>(r) * c;
    *reinterpret_cast<uint4*>(out + off) =
        apply_vec<ACT>(*reinterpret_cast<const uint4*>(x + off), sc, sh);
  }
}

template <int ACT>
cudaError_t launch(const void* x, const void* mean, const void* rstd, const void* gamma,
                   const void* beta, void* out, int n, int hw, int c, cudaStream_t stream) {
  const int vpr = c / 8;
  const int slabs = (vpr + THREADS - 1) / THREADS;
  const int vs = (vpr + slabs - 1) / slabs;
  const int rp = THREADS / vs;
  const long long steps = (hw + rp - 1) / rp;  // row steps of one (slab, sample)
  const int per_block = static_cast<int>(
      max(1LL, min(static_cast<long long>(MAX_STEPS), steps * slabs * n / TARGET_BLOCKS)));
  const int rows_per_block = rp * per_block;
  const dim3 grid((hw + rows_per_block - 1) / rows_per_block, slabs, n);
  gn_apply_kernel<ACT><<<grid, vs * rp, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(mean),
      static_cast<const float*>(rstd), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<__nv_bfloat16*>(out), hw, c, vs, rp,
      rows_per_block);
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
