// K4: fused linear + GEGLU, out = (x W1^T + b1) * gelu_tanh(x W2^T + b2),
// bf16 in and out, f32 accumulation, bias and epilogue.
//
// Replaces the Pallas kernel sfast_tpu/ops/geglu.py::_geglu_kernel (entry
// point linear_geglu_pallas).  On the opt-in path
// (enable_fused_linear_geglu) it runs the feed-forward input projection of
// the UNet transformer blocks whose widths pass JAX's rule (2F % 256 == 0,
// K % 128 == 0): M x K x F = 2048 x 640 x 2560 (level 1),
// 512 x 1280 x 5120 (level 2) and 128 x 1280 x 5120 (mid), bf16.  The
// weight is torch's (2F, K): rows [0, F) give the hidden half, rows
// [F, 2F) the gate.
//
// What bounds it on the H100: the tensor cores at M = 2048 and 512 (13.4
// GFLOP, 13.6 µs at the bf16 peak), the 26 MB weight read at M = 128
// (7.8 µs at 3.35 TB/s).  The unfused route writes and reads the (M, 2F)
// GEMM output and the (M, F) halves on top.  Every block reads its x and
// W tiles from L2, so at 128 x 64 tiles the L2 traffic (x once per F tile,
// W once per M tile: 210 MB at M = 2048) weighs as much as the products.
//
// Design (a wgmma dual GEMM):
// - One block per (128-row M tile, 64 output columns): two consumer
//   warpgroups of 64 rows and a producer warp that issues the TMA loads.
//   Two blocks share an SM, so one's prologue and epilogue run under the
//   other's products.
// - x and both W halves come by TMA in 64-wide k tiles with the 128-byte
//   swizzle, all K-major as they lie (torch's (2F, K) weight needs no
//   transpose), through a 3-stage ring on mbarriers.  Rows past M and a K
//   tail narrower than the box arrive as zeros, so any M and K % 32 == 0
//   need no special case.
// - The hidden and gate tiles lie back to back in shared memory, one B
//   operand of 128 rows: one wgmma m64n128k16 per k16 step reads the x
//   tile once for both products, whose accumulators never leave
//   registers.  Each stage's products are awaited only after the next
//   stage's are issued, and its slot is then released to the producer.
// - The epilogue adds the f32 biases (read as bf16 or f32), applies the
//   tanh GELU with PTX tanh.approx.f32 (as the reference's CUTLASS
//   epilogue) and multiplies, in registers, and stores bf16 pairs.

#include "sm90.cuh"

namespace {

namespace s9 = sfast::sm90;

constexpr int BM = 128;   // rows of x per block: two consumer warpgroups of 64
constexpr int BN = 64;    // output columns per block: 2·BN rows of W
constexpr int BK = 64;    // k tile: one 128-byte swizzle atom of bf16
constexpr int ST = 3;     // ring stages
constexpr int THREADS = 288;  // two consumer warpgroups and a producer warp
constexpr int X_BYTES = BM * BK * 2;
constexpr int W_BYTES = BN * BK * 2;  // one half
constexpr int STAGE = X_BYTES + 2 * W_BYTES;
constexpr int OFF_BAR = ST * STAGE;
constexpr int SMEM = OFF_BAR + 2 * ST * 8 + 1024;  // + alignment slack: two blocks an SM

__device__ __forceinline__ float gelu_tanh(float y) {
  const float u = 0.7978845608028654f * (y + 0.044715f * y * y * y);
  float th;
  asm("tanh.approx.f32 %0, %1;" : "=f"(th) : "f"(u));
  return 0.5f * y * (1.f + th);
}

struct Params {
  const void* bias;  // (2f,) f32 or bf16, or null
  int bias_bf16;
  __nv_bfloat16* out;
  int m, k, f;
};

__device__ __forceinline__ float bias_at(const Params& p, int i) {
  if (p.bias == nullptr) return 0.f;
  return p.bias_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.bias)[i])
                     : static_cast<const float*>(p.bias)[i];
}

__global__ void __launch_bounds__(THREADS, 2)
    geglu_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wmap, const Params p) {
  constexpr int NACC = BN;  // hidden: acc[4j..] for j < BN / 8, gate above
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* empty = full + ST;
  const int m0 = blockIdx.x * BM, f0 = blockIdx.y * BN;
  const int nk = (p.k + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < ST; ++i) {
      s9::mbar_init(&full[i], 1);
      s9::mbar_init(&empty[i], 2);  // one arrival per consumer warpgroup
    }
    s9::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer warp
    if (threadIdx.x == 256) {
      s9::prefetch_tensormap(&xmap);
      s9::prefetch_tensormap(&wmap);
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % ST;
        unsigned char* stage = smem + st * STAGE;
        s9::mbar_wait(&empty[st], ((kt / ST) & 1) ^ 1);
        s9::mbar_expect_tx(&full[st], STAGE);
        s9::tma_load_2d(stage, &xmap, &full[st], kt * BK, m0);
        s9::tma_load_2d(stage + X_BYTES, &wmap, &full[st], kt * BK, f0);
        s9::tma_load_2d(stage + X_BYTES + W_BYTES, &wmap, &full[st], kt * BK, p.f + f0);
      }
    }
    return;
  }
  const int wg = threadIdx.x / 128;
  const int wtid = threadIdx.x % 128;
  float acc[NACC];
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % ST;
    const uint32_t xs = sfast::smem_addr(smem + st * STAGE) + wg * 64 * 128;
    const uint32_t ws = sfast::smem_addr(smem + st * STAGE + X_BYTES);
    s9::mbar_wait(&full[st], (kt / ST) & 1);
    s9::fence_regs<NACC>(acc);
    s9::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      s9::wgmma_m64n128k16_ss(acc, s9::make_desc(xs + kk * 32, 16, 1024, 1),
                              s9::make_desc(ws + kk * 32, 16, 1024, 1), kt > 0 || kk > 0);
    s9::wgmma_commit();
    s9::wgmma_wait<1>();  // the previous stage's products are done
    s9::fence_regs<NACC>(acc);
    if (kt > 0 && wtid == 0) s9::mbar_arrive(&empty[(kt - 1) % ST]);
  }
  s9::wgmma_wait<0>();
  s9::fence_regs<NACC>(acc);

  const int warp = wtid / 32, lane = wtid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row_a = m0 + wg * 64 + warp * 16 + g;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = f0 + j * 8 + 2 * t;
    const float b1[2] = {bias_at(p, col), bias_at(p, col + 1)};
    const float b2[2] = {bias_at(p, p.f + col), bias_at(p, p.f + col + 1)};
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // rows g and g + 8
      const int row = row_a + half * 8;
      if (row >= p.m) continue;
      const float* hv = acc + 4 * j + 2 * half;
      const float* gv = acc + 4 * (j + BN / 8) + 2 * half;
      *reinterpret_cast<__nv_bfloat162*>(p.out + static_cast<long long>(row) * p.f + col) =
          __floats2bfloat162_rn((hv[0] + b1[0]) * gelu_tanh(gv[0] + b2[0]),
                                (hv[1] + b1[1]) * gelu_tanh(gv[1] + b2[1]));
    }
  }
}

// A row-major bf16 (rows, k) matrix as a 2-D map, boxes of 64 x box_rows
// landing 128-byte swizzled
bool encode_rows(CUtensorMap* map, const void* ptr, int rows, int k, int box_rows) {
  const uint64_t dims[2] = {static_cast<uint64_t>(k), static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {2ull * k};
  const uint32_t box[2] = {BK, static_cast<uint32_t>(box_rows)};
  return s9::encode_tensor_map(map, ptr, 2, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace

// x: (m, k) bf16; w: (2f, k) bf16; bias: (2f,) f32 (bias_bf16 = 0) or bf16
// (1), or null; out: (m, f) bf16; all contiguous, x and w 16-byte aligned.
// Requires k % 32 == 0 and f % 64 == 0 (the Python wrapper checks both);
// returns cudaErrorInvalidValue otherwise.
extern "C" int sfast_linear_geglu_bf16(const void* x, const void* w, const void* bias,
                                       int bias_bf16, void* out, int m, int k, int f,
                                       void* stream) {
  if (m <= 0 || k % 32 != 0 || k <= 0 || f % BN != 0 || f <= 0) return cudaErrorInvalidValue;
  Params p;
  p.bias = bias;
  p.bias_bf16 = bias_bf16;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.m = m;
  p.k = k;
  p.f = f;
  CUtensorMap xm, wm;
  if (!encode_rows(&xm, x, m, k, BM) || !encode_rows(&wm, w, 2 * f, k, BN))
    return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      geglu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((m + BM - 1) / BM, f / BN);
  geglu_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(xm, wm, p);
  return cudaGetLastError();
}
