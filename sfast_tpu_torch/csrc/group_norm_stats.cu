// K3: GroupNorm statistics of NHWC bf16 x: per-(n, c) mean and rstd of
// the channel's group, in f32.
//
// Replaces the Pallas kernel sfast_tpu/ops/group_norm.py::_stats_kernel
// (entry point group_norm_stats, reached through conv_pallas.gn_affine).
// On the main path it reads the SD VAE decoder's resnet inputs, up to
// (1, 512^2, 256) bf16 = 128 MiB per call.
//
// What bounds it on the H100: device memory.  It is a pure reduction,
// one read of x and next to no arithmetic, so the target is one coalesced
// pass at full bandwidth.
//
// Design (two launches on one stream):
// 1. partial sums: a block reduces a chunk of rows (pixels) of one sample.
//    Its threads tile a row with 16-byte loads (8 channels each) and take
//    several rows at once; each thread keeps f32 sums of x and x^2 for its
//    8 channels in registers, the block folds them in shared memory and
//    writes one (2, C) partial per chunk.  The wrapper sizes chunks so the
//    grid has about 256 blocks, two per SM, enough to keep every SM
//    streaming.
// 2. fold: one block per (group, sample) adds that group's partials (its
//    channels of every chunk) with a fixed assignment to threads and a
//    fixed tree, computes var = E[x^2] - E[x]^2 (as JAX does) and
//    rstd = rsqrt(var + eps), and writes both to the group's channels.
//    groups x batch blocks keep the fold parallel at the UNet's batch 2,
//    where up to 2560 channels x 128 chunks are folded per sample.
// The partials and the fixed order make the result deterministic: no
// atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    stats_partial_kernel(const __nv_bfloat16* __restrict__ x,
                         float* __restrict__ partial, int hw, int c,
                         int rows_per_chunk, int n_chunks) {
  __shared__ float red[THREADS * 16];
  const int n = blockIdx.y, chunk = blockIdx.x;
  const int vpr = c / 8;                    // 16-byte vectors per row
  const int lanes = min(vpr, THREADS);      // threads across a row
  const int row_par = THREADS / lanes;      // rows taken at once
  const int tid = threadIdx.x;
  const int lane = tid % lanes, rp = tid / lanes;
  const bool active = rp < row_par;
  const int r_begin = chunk * rows_per_chunk;
  const int r_end = min(hw, r_begin + rows_per_chunk);
  const __nv_bfloat16* xs = x + static_cast<long long>(n) * hw * c;
  float* out = partial + (static_cast<long long>(n) * n_chunks + chunk) * 2 * c;

  for (int pass = 0; pass * lanes < vpr; ++pass) {
    const int v = pass * lanes + lane;
    float s1[8], s2[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) s1[j] = s2[j] = 0.f;
    if (active && v < vpr) {
      for (int r = r_begin + rp; r < r_end; r += row_par) {
        uint4 val = *reinterpret_cast<const uint4*>(
            xs + static_cast<long long>(r) * c + v * 8);
        const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&val);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(e[j]);
          s1[2 * j] += f.x;
          s1[2 * j + 1] += f.y;
          s2[2 * j] += f.x * f.x;
          s2[2 * j + 1] += f.y * f.y;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      red[tid * 16 + j] = s1[j];
      red[tid * 16 + 8 + j] = s2[j];
    }
    __syncthreads();
    for (int idx = tid; idx < lanes * 16; idx += THREADS) {
      const int ln = idx / 16, i = idx % 16;
      float s = 0.f;
      for (int q = 0; q < row_par; ++q) s += red[(q * lanes + ln) * 16 + i];
      const int ch = (pass * lanes + ln) * 8 + (i % 8);
      if (ch < c) out[(i / 8) * c + ch] = s;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
    stats_fold_kernel(const float* __restrict__ partial, float* __restrict__ mean,
                      float* __restrict__ rstd, int hw, int c, int groups,
                      int n_chunks, float eps) {
  __shared__ float red[2][THREADS];
  const int grp = blockIdx.x, n = blockIdx.y, tid = threadIdx.x;
  const int cpg = c / groups, c0 = grp * cpg;
  const float* pn = partial + static_cast<long long>(n) * n_chunks * 2 * c + c0;
  float a = 0.f, b = 0.f;
  for (int i = tid; i < n_chunks * cpg; i += THREADS) {
    const int k = i / cpg, ch = i - k * cpg;
    a += pn[static_cast<long long>(k) * 2 * c + ch];
    b += pn[static_cast<long long>(k) * 2 * c + c + ch];
  }
  red[0][tid] = a;
  red[1][tid] = b;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) {
      red[0][tid] += red[0][tid + s];
      red[1][tid] += red[1][tid + s];
    }
    __syncthreads();
  }
  const float cnt = static_cast<float>(hw) * cpg;
  const float m = red[0][0] / cnt;
  const float var = red[1][0] / cnt - m * m;
  const float r = rsqrtf(var + eps);
  for (int ch = tid; ch < cpg; ch += THREADS) {
    mean[n * c + c0 + ch] = m;
    rstd[n * c + c0 + ch] = r;
  }
}

}  // namespace

// partial: f32 scratch of n * n_chunks * 2 * c elements.  Requires
// c % 8 == 0 and c % groups == 0; the Python wrapper checks both.
extern "C" int sfast_group_norm_stats_bf16(const void* x, void* partial,
                                           void* mean, void* rstd, int n,
                                           int hw, int c, int groups,
                                           float eps, int rows_per_chunk,
                                           int n_chunks, void* stream) {
  if (c % 8 != 0 || c % groups != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  stats_partial_kernel<<<dim3(n_chunks, n), THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<float*>(partial), hw, c,
      rows_per_chunk, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stats_fold_kernel<<<dim3(groups, n), THREADS, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(mean),
      static_cast<float*>(rstd), hw, c, groups, n_chunks, eps);
  return cudaGetLastError();
}

extern "C" const char* sfast_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
