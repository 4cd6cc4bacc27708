// K3: GroupNorm statistics of NHWC bf16 x: per-(n, c) mean and rstd of
// the channel's group, in f32, in one launch.
//
// Replaces the Pallas kernel sfast_tpu/ops/group_norm.py::_stats_kernel
// (entry point group_norm_stats, reached through conv_pallas.gn_affine).
// On the main path it reads the SD VAE decoder's resnet inputs, up to
// (1, 512^2, 256) bf16 = 128 MiB per call.  It also serves every other
// group_norm_stats call (backend 'hybrid', and K3' where the fused
// GroupNorm's rule, ops/group_norm.fused_plan, refuses a shape).
//
// What bounds it on the H100: device memory.  It is a pure reduction,
// one read of x and next to no arithmetic, so the target is one coalesced
// pass at full bandwidth, and on small maps as little latency as one
// launch allows.
//
// Design (one launch):
// - grid (chunks, n): a block reduces a chunk of rows (pixels) of one
//   sample.  Its threads tile a row with 16-byte loads (8 channels each),
//   every thread of a row lane on the same channels, and take several rows
//   at once; the block folds the threads' f32 sums of x and x^2 per
//   channel and then per group in shared memory, in a fixed order, and
//   writes one (2, groups) partial per chunk.  The wrapper sizes chunks by
//   the work: about 32 KB of x a block, at most two blocks an SM, and a
//   partial of at most an eighth of the bytes of x it sums.
// - fold: each block then takes a ticket from an integer counter of its
//   sample; the block that takes the last one adds that sample's partials
//   in chunk order, computes var = E[x^2] - E[x]^2 (as JAX does) and
//   rstd = rsqrt(var + eps), writes both to the group's channels and sets
//   the counter back to 0 for the next call.  The sums never depend on
//   which block finishes last, so two calls give identical results: the
//   ticket is the only atomic, and it is an integer.

#include "group_norm.cuh"

namespace {

using namespace sfast::gn;

constexpr int MAX_THREADS = 512;
constexpr int MAX_GROUPS = 512;

// Sums in a fixed order with a short serial chain: for each of nval values
// i, the sum over k < count of term(i, k) is taken as nsub contiguous runs
// of k, one thread each, then the runs in order (sum_of_runs).  The order
// depends only on the arguments, so two calls give the same bits.
// sum_lanes (on the host) picks nsub: the most with nsub^2 <= count and
// nval * nsub <= threads, about 2 sqrt(count) serial adds in all; scratch
// holds max(threads, nval) floats.
inline int sum_lanes(int count, int nval, int threads) {
  int s = 1;
  while ((s + 1) * (s + 1) <= count && (s + 1) * nval <= threads) ++s;
  return s;
}

// First level: (i = idx % nval, sub = idx / nval) writes its run's sum to
// scratch[sub * nval + i].  Every thread of the block calls it.
template <typename Term>
__device__ __forceinline__ void sum_runs(int nval, int count, int nsub, float* scratch,
                                         Term term) {
  const int run = (count + nsub - 1) / nsub;
  for (int idx = threadIdx.x; idx < nval * nsub; idx += blockDim.x) {
    const int i = idx % nval, sub = idx / nval;
    const int k1 = min(count, (sub + 1) * run);
    float acc = 0.f;
#pragma unroll 8
    for (int k = sub * run; k < k1; ++k) acc += term(i, k);
    scratch[sub * nval + i] = acc;
  }
  __syncthreads();
}

__device__ __forceinline__ float sum_of_runs(int i, int nval, int nsub, const float* scratch) {
  float acc = 0.f;
  for (int sub = 0; sub < nsub; ++sub) acc += scratch[sub * nval + i];
  return acc;
}

__global__ void __launch_bounds__(MAX_THREADS)
    gn_stats_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ partial,
                    unsigned int* __restrict__ ticket, float* __restrict__ mean,
                    float* __restrict__ rstd, int hw, int c, int groups, int rows_per_chunk,
                    int n_chunks, int lanes, int sub_group, int sub_fold, float eps) {
  __shared__ float red[MAX_THREADS * 16];
  __shared__ float scratch[2 * MAX_GROUPS];  // max(threads, 2 * groups)
  __shared__ float gsum[2 * MAX_GROUPS];
  __shared__ bool last;
  const int n = blockIdx.y, chunk = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int vpr = c / 8, cpg = c / groups, nv = 2 * groups;
  const int rp = nt / lanes, lane = tid % lanes, q = tid / lanes;
  const int r_begin = chunk * rows_per_chunk;
  const int r_end = min(hw, r_begin + rows_per_chunk);
  const __nv_bfloat16* xs = x + static_cast<long long>(n) * hw * c;

  for (int i = tid; i < nv; i += nt) gsum[i] = 0.f;
  for (int p0 = 0; p0 < vpr; p0 += lanes) {
    const int v = p0 + lane;
    float s1[8], s2[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) s1[j] = s2[j] = 0.f;
    if (v < vpr) {
#pragma unroll 4
      for (int r = r_begin + q; r < r_end; r += rp)
        accumulate_vec(*reinterpret_cast<const uint4*>(xs + static_cast<long long>(r) * c + v * 8),
                       s1, s2);
    }
    // red[s][t], s = stat * 8 + j: a warp's stores fall on 32 banks
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      red[j * nt + tid] = s1[j];
      red[(8 + j) * nt + tid] = s2[j];
    }
    __syncthreads();
    // per channel, over the row lanes in order, into the first lane's slot
    // (only the thread that writes a slot reads it)
    for (int i = tid; i < 16 * lanes; i += nt) {
      float* col = red + (i / lanes) * nt + i % lanes;
      float acc = 0.f;
      for (int k = 0; k < rp; ++k) acc += col[k * lanes];
      col[0] = acc;
    }
    __syncthreads();
    // per group, over this pass's channels in order
    const int ch0 = p0 * 8, nch = min(c, (p0 + lanes) * 8) - ch0;
    sum_runs(nv, cpg, sub_group, scratch, [&](int i, int k) {
      const int stat = i / groups, ch = (i - stat * groups) * cpg + k - ch0;
      return ch < 0 || ch >= nch ? 0.f : red[(stat * 8 + (ch & 7)) * nt + (ch >> 3)];
    });
    for (int i = tid; i < nv; i += nt) gsum[i] += sum_of_runs(i, nv, sub_group, scratch);
    __syncthreads();
  }

  float* mine = partial + (static_cast<long long>(n) * n_chunks + chunk) * nv;
  for (int i = tid; i < nv; i += nt) {
    mine[i] = gsum[i];
    __threadfence();  // the partial is visible device-wide before the ticket
  }
  __syncthreads();
  if (tid == 0) last = atomicAdd(&ticket[n], 1u) == static_cast<unsigned>(n_chunks - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last block of sample n adds the partials in chunk order
  const float* pn = partial + static_cast<long long>(n) * n_chunks * nv;
  sum_runs(nv, n_chunks, sub_fold, scratch,
           [&](int i, int k) { return __ldcg(pn + static_cast<long long>(k) * nv + i); });
  for (int i = tid; i < nv; i += nt) gsum[i] = sum_of_runs(i, nv, sub_fold, scratch);
  __syncthreads();
  const float cnt = static_cast<float>(hw) * cpg;
  for (int ch = tid; ch < c; ch += nt) {
    const int g = ch / cpg;
    const float m = gsum[g] / cnt;
    const float var = gsum[groups + g] / cnt - m * m;
    mean[static_cast<long long>(n) * c + ch] = m;
    rstd[static_cast<long long>(n) * c + ch] = rsqrtf(var + eps);
  }
  if (tid == 0) ticket[n] = 0u;
}

}  // namespace

// partial: f32 scratch of n * n_chunks * 2 * groups elements; ticket: n
// unsigned ints, 0 before the call and 0 after it (calls that share a
// ticket must not run at the same time: the wrapper keeps one set per
// stream).  lanes: threads across a row's c / 8 vectors; the block has
// lanes * (512 / lanes) threads.  Requires
// c % 8 == 0, c % groups == 0 and groups <= 512; the Python wrapper
// checks them, and any other argument returns cudaErrorInvalidValue.
extern "C" int sfast_group_norm_stats_bf16(const void* x, void* partial, void* ticket,
                                           void* mean, void* rstd, int n, int hw, int c,
                                           int groups, float eps, int rows_per_chunk,
                                           int n_chunks, int lanes, void* stream) {
  if (c % 8 != 0 || groups <= 0 || groups > MAX_GROUPS || c % groups != 0 || n <= 0 ||
      lanes < 1 || lanes > MAX_THREADS || rows_per_chunk < 1 || n_chunks < 1)
    return cudaErrorInvalidValue;
  const int threads = lanes * (MAX_THREADS / lanes);
  const int sub_group = sum_lanes(c / groups, 2 * groups, threads);
  const int sub_fold = sum_lanes(n_chunks, 2 * groups, threads);
  gn_stats_kernel<<<dim3(n_chunks, n), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<float*>(partial),
      static_cast<unsigned int*>(ticket), static_cast<float*>(mean), static_cast<float*>(rstd),
      hw, c, groups, rows_per_chunk, n_chunks, lanes, sub_group, sub_fold, eps);
  return cudaGetLastError();
}

extern "C" const char* sfast_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
