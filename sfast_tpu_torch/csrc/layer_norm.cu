// K7: LayerNorm over the last dim of bf16 rows (M, C), in one pass:
// y = (x - mean) * rsqrt(var + eps) * gamma + beta with f32 statistics,
// var = E[x^2] - E[x]^2, rounded to bf16 once (round to nearest even).
// gamma and beta are f32 and each optional.
//
// Replaces no Pallas kernel: sfast_tpu/ops/layer_norm.py computes the same
// formula with jnp, which XLA fuses into one pass on the TPU.  PyTorch runs
// that form as thirteen unfused kernels (a bf16 -> f32 copy, two means,
// x*x, mean^2, a subtraction, an add and the rsqrt, three multiplies, an
// add and the cast back), about 60 bytes moved an element; this kernel is
// the fusion the port lost, at 4 bytes an element.  The formula and the
// order of its f32 operations are the plain form's (ops/layer_norm.py),
// with no contraction into FMAs after the sums, so the kernel and the two
// packages round alike; only the order of summation differs.
//
// What bounds it on the H100: device memory.  It reads x once and writes y
// once with a few flops an element, so the design serves bandwidth:
// - a row is reduced by a sub-warp of L lanes sized to C, so that each lane
//   holds V = C / (8 L) 16-byte vectors (3 to 5 at the instantiated widths:
//   at C = 320, 8 lanes of 5; at C = 1280, 32 lanes of 5); the row stays in
//   registers from the load to the store, and the sums meet by shuffles;
// - every load and store is a full 16-byte access, and the lanes of a
//   sub-warp cover contiguous 16-byte runs of the row;
// - the grid is persistent (as many blocks as fit on the SMs at once) and
//   strides over the rows, so each thread reads its columns' gamma and beta
//   into registers once;
// - all of a lane's V loads are issued before the first sum, and at two or
//   more 256-thread blocks an SM that keeps tens of KB a SM in flight.
// Any other width with C % 8 == 0 (up to 4096) takes ln_fused_kernel_any:
// one block a row, one vector a thread, the sums met through shared memory.
//
// It can be captured in a CUDA graph: no allocation, no host sync, and the
// launch on the stream it is given.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ANY_THREADS = 512;  // the generic kernel's most: 4096 / 8 vectors

// (x - mean) * rstd * gamma (+ beta) of 8 columns, in the plain form's
// order, rounded to bf16 once.  Without gamma g holds 1, an exact product.
__device__ __forceinline__ uint4 normalize_vec(uint4 in, float mean, float rstd,
                                               const float* g, const float* b,
                                               bool has_beta) {
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&in);
  uint4 res;
  __nv_bfloat162* r = reinterpret_cast<__nv_bfloat162*>(&res);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(e[j]);
    float y0 = __fmul_rn(__fmul_rn(__fsub_rn(f.x, mean), rstd), g[2 * j]);
    float y1 = __fmul_rn(__fmul_rn(__fsub_rn(f.y, mean), rstd), g[2 * j + 1]);
    if (has_beta) {
      y0 = __fadd_rn(y0, b[2 * j]);
      y1 = __fadd_rn(y1, b[2 * j + 1]);
    }
    r[j] = __floats2bfloat162_rn(y0, y1);
  }
  return res;
}

// Adds a vector's 8 values to the sums of x and x^2.
__device__ __forceinline__ void accumulate(uint4 in, float& s, float& ss) {
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&in);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(e[j]);
    s += f.x;
    s += f.y;
    ss = fmaf(f.x, f.x, ss);
    ss = fmaf(f.y, f.y, ss);
  }
}

// The statistics from a row's sums: mean, then rsqrt(E[x^2] - mean^2 + eps).
__device__ __forceinline__ float2 row_stats(float s, float ss, float inv_c, float eps) {
  const float mean = __fmul_rn(s, inv_c);
  const float var = __fsub_rn(__fmul_rn(ss, inv_c), __fmul_rn(mean, mean));
  return make_float2(mean, rsqrtf(__fadd_rn(var, eps)));
}

__device__ __forceinline__ void load_affine(const float* __restrict__ gamma,
                                            const float* __restrict__ beta, int col, float* g,
                                            float* b) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    g[j] = gamma != nullptr ? gamma[col + j] : 1.f;
    b[j] = beta != nullptr ? beta[col + j] : 0.f;
  }
}

// Rows of C columns, L lanes a row: lane l holds vectors l, l + L, ...
template <int C, int L>
__global__ void __launch_bounds__(THREADS)
    ln_fused_kernel(const __nv_bfloat16* __restrict__ x, long long ldx,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    __nv_bfloat16* __restrict__ y, long long m, float eps) {
  constexpr int V = C / 8 / L;
  static_assert(V * 8 * L == C && 32 % L == 0, "a row is L lanes of V whole vectors");
  const int lane = threadIdx.x % L;
  // the sub-warp's own lanes: sub-warps of one warp may leave the loop apart
  const unsigned mask = (0xffffffffu >> (32 - L)) << (threadIdx.x % 32 / L * L);
  float g[V][8], b[V][8];
#pragma unroll
  for (int v = 0; v < V; ++v) load_affine(gamma, beta, (v * L + lane) * 8, g[v], b[v]);
  const bool has_beta = beta != nullptr;
  const long long step = static_cast<long long>(gridDim.x) * (THREADS / L);
  for (long long r = (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) / L; r < m;
       r += step) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + r * ldx);
    uint4 in[V];
#pragma unroll
    for (int v = 0; v < V; ++v) in[v] = xr[v * L + lane];
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) accumulate(in[v], s, ss);
#pragma unroll
    for (int o = L / 2; o > 0; o /= 2) {  // a butterfly: every lane ends with the same sums
      s += __shfl_xor_sync(mask, s, o);
      ss += __shfl_xor_sync(mask, ss, o);
    }
    const float2 st = row_stats(s, ss, 1.f / C, eps);
    uint4* yr = reinterpret_cast<uint4*>(y + r * C);
#pragma unroll
    for (int v = 0; v < V; ++v)
      yr[v * L + lane] = normalize_vec(in[v], st.x, st.y, g[v], b[v], has_beta);
  }
}

// Any C % 8 == 0 up to 4096: one block a row (blockDim.x = C / 8 rounded up
// to a warp), thread t holds vector t.  The warps' sums meet in shared
// memory, double-buffered by the row's parity, so one barrier a row keeps a
// row's writes from overtaking the reads of the row before it.
__global__ void __launch_bounds__(ANY_THREADS)
    ln_fused_kernel_any(const __nv_bfloat16* __restrict__ x, long long ldx,
                        const float* __restrict__ gamma, const float* __restrict__ beta,
                        __nv_bfloat16* __restrict__ y, long long m, int c, float eps) {
  __shared__ float red[2][2][ANY_THREADS / 32];
  const int vpr = c / 8, t = threadIdx.x, warp = t / 32, warps = blockDim.x / 32;
  const bool active = t < vpr;
  float g[8], b[8];
  load_affine(gamma, beta, active ? t * 8 : 0, g, b);
  const bool has_beta = beta != nullptr;
  int parity = 0;
  for (long long r = blockIdx.x; r < m; r += gridDim.x, parity ^= 1) {
    const uint4 in =
        active ? reinterpret_cast<const uint4*>(x + r * ldx)[t] : make_uint4(0, 0, 0, 0);
    float s = 0.f, ss = 0.f;
    accumulate(in, s, ss);  // zeros past the row add nothing
#pragma unroll
    for (int o = 16; o > 0; o /= 2) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    if (t % 32 == 0) {
      red[parity][0][warp] = s;
      red[parity][1][warp] = ss;
    }
    __syncthreads();
    s = ss = 0.f;
    for (int w = 0; w < warps; ++w) {
      s += red[parity][0][w];
      ss += red[parity][1][w];
    }
    const float2 st = row_stats(s, ss, 1.f / c, eps);
    if (active)
      reinterpret_cast<uint4*>(y + r * c)[t] = normalize_vec(in, st.x, st.y, g, b, has_beta);
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return sms;
}

template <int C, int L>
cudaError_t launch(const void* x, long long ldx, const void* gamma, const void* beta, void* y,
                   long long m, float eps, cudaStream_t stream) {
  static const int per_sm = [] {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ln_fused_kernel<C, L>, THREADS, 0) !=
        cudaSuccess)
      n = 1;
    return n > 0 ? n : 1;
  }();
  constexpr int rows_per_block = THREADS / L;
  const long long needed = (m + rows_per_block - 1) / rows_per_block;
  const long long most = static_cast<long long>(per_sm) * sm_count();
  const int blocks = static_cast<int>(needed < most ? needed : most);
  ln_fused_kernel<C, L><<<blocks, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), ldx, static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<__nv_bfloat16*>(y), m, eps);
  return cudaGetLastError();
}

cudaError_t launch_any(const void* x, long long ldx, const void* gamma, const void* beta,
                       void* y, long long m, int c, float eps, cudaStream_t stream) {
  const int threads = (c / 8 + 31) / 32 * 32;
  static const int per_sm = [] {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ln_fused_kernel_any, ANY_THREADS, 0) !=
        cudaSuccess)
      n = 1;
    return n > 0 ? n : 1;
  }();
  const long long most = static_cast<long long>(per_sm) * (ANY_THREADS / threads) * sm_count();
  const int blocks = static_cast<int>(m < most ? m : most);
  ln_fused_kernel_any<<<blocks, threads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), ldx, static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<__nv_bfloat16*>(y), m, c, eps);
  return cudaGetLastError();
}

}  // namespace

// x: (m, c) bf16 rows ldx elements apart, 16-byte aligned; y: (m, c) bf16,
// contiguous; gamma, beta: (c,) f32 or null.  Requires c % 8 == 0,
// 0 < c <= 4096, ldx % 8 == 0 (the Python wrapper sees to it); returns
// cudaErrorInvalidValue otherwise.
extern "C" int sfast_layer_norm_bf16(const void* x, long long ldx, const void* gamma,
                                     const void* beta, void* y, long long m, int c, float eps,
                                     void* stream) {
  if (c <= 0 || c % 8 != 0 || c > 4096 || m < 0 || ldx % 8 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 320: return launch<320, 8>(x, ldx, gamma, beta, y, m, eps, st);
    case 640: return launch<640, 16>(x, ldx, gamma, beta, y, m, eps, st);
    case 768: return launch<768, 32>(x, ldx, gamma, beta, y, m, eps, st);
    case 1024: return launch<1024, 32>(x, ldx, gamma, beta, y, m, eps, st);
    case 1280: return launch<1280, 32>(x, ldx, gamma, beta, y, m, eps, st);
    default: return launch_any(x, ldx, gamma, beta, y, m, c, eps, st);
  }
}
