// Fused GroupNorm over NHWC bf16 x in one launch: statistics, normalize,
// affine and activation (none, SiLU or the tanh GELU), f32 math, bf16 out.
//
// Replaces the pair of Pallas kernels of sfast_tpu/ops/group_norm.py's
// group_norm_pallas: _stats_kernel (K3', the first pallas_call) followed by
// _norm_apply_kernel (K5).  On the opt-in path (enable_fused_group_norm) it
// runs every UNet GroupNorm: (2, H, W, C) for H*W in {64^2, 32^2, 16^2, 8^2}
// and C from 320 to 2560, 61 per UNet eval.
//
// What bounds it on the H100: device memory at the largest maps (one read
// of x and one write of y, 15.7 MB each at 64^2*960), and latency and
// launches at the rest (0.33 MB at 8^2*1280).  So x is read once, the
// statistics never leave the chip, and one launch does it all.
//
// Design:
// - grid (cluster, bands, n) with cluster dimension (cluster, 1, 1): one
//   thread-block cluster per (sample, band).  A band is bg whole groups
//   whose bg*cpg channels are a multiple of 8 (16 bytes): at C = 320 four
//   groups of 10 make 40 channels.  The cluster's CTAs split the sample's
//   H*W rows; the Python rule (ops/group_norm.fused_plan) picks bg, the
//   cluster size (2 to 8, 16 where a tile of 8 would leave one CTA an SM)
//   and the threads so the grid fills the card and each CTA's tile fits.
//   A CTA has 32 * m threads for each of the band's vb 16-byte vectors.
// - each CTA copies its (rows x band) tile into shared memory once by
//   16-byte cp.async, every copy in flight at once, and keeps it there.
// - statistics: warp w sums x and x^2 of vector w % vb over every 32-th
//   row, folds its 8 channels into the (at most two, as cpg >= 8) groups
//   they belong to, and reduces the 4 sums over its lanes by shuffles.
//   A thread per (stat, group) adds the warps' sums of its group in a
//   fixed order.  The CTAs of the cluster then write their per-group sums
//   into every peer's shared memory (distributed shared memory) and meet
//   at one barrier.cluster arrive/wait pair; each CTA adds the cluster's
//   sums in rank order.  All CTAs of a cluster compute the same bits, and
//   two calls give identical output: no atomics.  var = E[x^2] - E[x]^2
//   and rstd = rsqrt(var + eps), as JAX computes them.  No shared memory
//   is read across CTAs, so no CTA waits on its peers before it exits.
// - apply: a thread per band channel forms scale = rstd * gamma and
//   shift = beta - mean * scale; thread t then owns vector t % vb of every
//   (nt / vb)-th row, so its 8 scales and shifts stay in registers, and
//   writes y = act(x * scale + shift) from the tile in shared memory once.

#include <stdint.h>

#include "group_norm.cuh"

namespace {

using namespace sfast::gn;

constexpr int MAX_THREADS = 512;
constexpr int MAX_CLUSTER = 16;  // above 8 with the non-portable attribute
constexpr int SMEM_LIMIT = 232448;

// Dynamic shared memory of one CTA; ops/group_norm.fused_smem_bytes
// mirrors it.  Layout: tile (rows x vb uint4), wred (4 f32 a warp), gin
// (MAX_CLUSTER x 2 bg f32: every CTA's per-group sums), gtot (2 bg f32),
// aff (2 bc f32).
size_t smem_bytes(int rows_per_cta, int vb, int threads, int bg) {
  return static_cast<size_t>(rows_per_cta) * vb * 16 + threads / 32 * 16 +
         (MAX_CLUSTER + 1) * 8 * bg + 64 * vb;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, bypassing L1 (cp.async.cg).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster arrives (releasing its writes to
// shared memory) and then waits (acquiring the others').
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

// Stores v at p's offset in the shared memory of cluster CTA `rank`.
__device__ __forceinline__ void st_dsmem(float* p, uint32_t rank, float v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(v) : "memory");
}

struct Params {
  const __nv_bfloat16* x;
  const float* gamma;
  const float* beta;
  __nv_bfloat16* out;
  float* mean_out;  // (n, c) or null
  float* rstd_out;
  int hw, c, cpg, bg, rows_per_cta;
  float eps;
};

template <int ACT>
__global__ void __launch_bounds__(MAX_THREADS) gn_fused_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cpg = p.cpg, bg = p.bg, c = p.c;
  const int bc = bg * cpg, vb = bc / 8, nt = blockDim.x, tid = threadIdx.x;
  const int nw = nt / 32, rp = nt / vb;  // warps; row lanes of the apply
  uint4* tile = reinterpret_cast<uint4*>(smem);
  float* wred = reinterpret_cast<float*>(tile + static_cast<size_t>(p.rows_per_cta) * vb);
  float* gin = wred + 4 * nw;  // gin[rank][i], i = stat * bg + group
  float* gtot = gin + MAX_CLUSTER * 2 * bg;
  float* aff = gtot + 2 * bg;  // per channel: scale[bc], shift[bc]

  cluster_arrive_relaxed();  // this CTA has started; peers may write to it
  const uint32_t rank = cluster_rank(), cs = cluster_size();
  const int n = blockIdx.z, c0 = blockIdx.y * bc;
  const int r0 = static_cast<int>(rank) * p.rows_per_cta;
  const int rows = max(0, min(p.rows_per_cta, p.hw - r0));
  const __nv_bfloat16* xs = p.x + (static_cast<long long>(n) * p.hw + r0) * c + c0;

  // the tile: thread t copies vector t % vb of every rp-th row
  const int v = tid % vb, rl = tid / vb;
  for (int r = rl; r < rows; r += rp)
    cp_async16(&tile[r * vb + v], xs + static_cast<long long>(r) * c + v * 8);
  float gam = 0.f, bet = 0.f;  // thread t < bc: channel t's, loaded while the tile lands
  if (tid < bc) {
    gam = p.gamma[c0 + tid];
    bet = p.beta[c0 + tid];
  }
  cp_async_wait_all();
  __syncthreads();

  // warp w: vector w % vb of rows (w / vb) * 32 + lane, stepping by 32 m
  const int w = tid / 32, lane = tid % 32, wv = w % vb;
  const int ga = wv * 8 / cpg, jb = (ga + 1) * cpg - wv * 8;  // channels j < jb: group ga
  float s1[8], s2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s1[j] = s2[j] = 0.f;
  for (int r = (w / vb) * 32 + lane; r < rows; r += 32 * (nw / vb))
    accumulate_vec(tile[r * vb + wv], s1, s2);
  float part[4] = {0.f, 0.f, 0.f, 0.f};  // Σx, Σx² of group ga, then of ga + 1
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const bool in_a = j < jb;
    part[0] += in_a ? s1[j] : 0.f;
    part[1] += in_a ? s2[j] : 0.f;
    part[2] += in_a ? 0.f : s1[j];
    part[3] += in_a ? 0.f : s2[j];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part[k] += __shfl_xor_sync(0xffffffffu, part[k], off);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) wred[w * 4 + k] = part[k];
  }
  __syncthreads();
  cluster_wait();  // every CTA of the cluster has started
  if (tid < 2 * bg) {
    // group g's vectors, warp by warp in order: slot A where the vector
    // starts in g, slot B where it starts in the group before
    const int stat = tid / bg, g = tid - stat * bg;
    const int v0 = g * cpg / 8, v1 = ((g + 1) * cpg - 1) / 8;
    float s = 0.f;
    for (int b = 0; b < nw / vb; ++b)
      for (int u = v0; u <= v1; ++u)
        s += wred[(b * vb + u) * 4 + (u * 8 >= g * cpg ? 0 : 2) + stat];
    for (uint32_t k = 0; k < cs; ++k) st_dsmem(&gin[rank * 2 * bg + tid], k, s);
  }
  cluster_arrive();
  cluster_wait();  // every CTA's sums are in every CTA's gin
  if (tid < 2 * bg) {
    float s = 0.f;
    for (uint32_t k = 0; k < cs; ++k) s += gin[k * 2 * bg + tid];
    gtot[tid] = s;
  }
  __syncthreads();
  if (tid < bc) {
    const int g = tid / cpg;
    const float cnt = static_cast<float>(p.hw) * cpg;
    const float m = gtot[g] / cnt;
    const float rs = rsqrtf(gtot[bg + g] / cnt - m * m + p.eps);
    aff[tid] = rs * gam;
    aff[bc + tid] = bet - m * (rs * gam);
    if (p.mean_out != nullptr && rank == 0) {
      p.mean_out[static_cast<long long>(n) * c + c0 + tid] = m;
      p.rstd_out[static_cast<long long>(n) * c + c0 + tid] = rs;
    }
  }
  __syncthreads();

  float sc[8], sh[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sc[j] = aff[v * 8 + j];
    sh[j] = aff[bc + v * 8 + j];
  }
  __nv_bfloat16* os = p.out + (static_cast<long long>(n) * p.hw + r0) * c + c0 + v * 8;
  for (int r = rl; r < rows; r += rp)
    *reinterpret_cast<uint4*>(os + static_cast<long long>(r) * c) =
        apply_vec<ACT>(tile[r * vb + v], sc, sh);
}

cudaError_t launch(void (*kernel)(Params), bool* configured, const Params& p, int n,
                   int groups, int cluster, int threads, cudaStream_t stream) {
  if (!*configured) {  // the largest dynamic smem and clusters of 16, set once per kernel
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    *configured = true;
  }
  const size_t smem = smem_bytes(p.rows_per_cta, p.bg * p.cpg / 8, threads, p.bg);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, groups / p.bg, n);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// x, out: (n, hw, c) bf16; gamma, beta: (c,) f32; mean, rstd: (n, c) f32 or
// both null (the statistics as K3 gives them, for checks).  bg groups a band
// (groups % bg == 0, cpg = c / groups >= 8, bg * cpg % 8 == 0), cluster
// CTAs a (sample, band), 32 * m threads for each of the band's vb = bg *
// cpg / 8 vectors (at most 512 in all).  act: 0 none, 1 SiLU, 2 tanh GELU.
// The Python rule checks these; an argument outside them returns
// cudaErrorInvalidValue.
extern "C" int sfast_group_norm_fused_bf16(const void* x, const void* gamma, const void* beta,
                                           void* out, void* mean, void* rstd, int n, int hw,
                                           int c, int groups, float eps, int act, int bg,
                                           int cluster, int m, void* stream) {
  if (out == nullptr || n <= 0 || hw <= 0 || groups <= 0 || c % groups != 0 ||
      c / groups < 8 || bg <= 0 || groups % bg != 0 || (bg * (c / groups)) % 8 != 0 ||
      cluster < 1 || cluster > MAX_CLUSTER || m < 1 || (mean == nullptr) != (rstd == nullptr))
    return cudaErrorInvalidValue;
  const int vb = bg * (c / groups) / 8, threads = 32 * m * vb;
  if (threads > MAX_THREADS) return cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.mean_out = static_cast<float*>(mean);
  p.rstd_out = static_cast<float*>(rstd);
  p.hw = hw;
  p.c = c;
  p.cpg = c / groups;
  p.bg = bg;
  p.rows_per_cta = (hw + cluster - 1) / cluster;
  p.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  static bool configured[3] = {false, false, false};
  switch (act) {
    case 0: return launch(gn_fused_kernel<0>, &configured[0], p, n, groups, cluster, threads, st);
    case 1: return launch(gn_fused_kernel<1>, &configured[1], p, n, groups, cluster, threads, st);
    case 2: return launch(gn_fused_kernel<2>, &configured[2], p, n, groups, cluster, threads, st);
    default: return cudaErrorInvalidValue;
  }
}
