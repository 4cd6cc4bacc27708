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
// What bounds it on the H100: the tensor cores.  At the level-1 shape it
// is 13.4 GFLOP against 13 MB of x, W and out.  The unfused route writes
// and reads the (M, 2F) GEMM output and the (M, F) halves on top.
//
// Design:
// - one block of 8 warps per (128-row M tile, 64-column F tile); it
//   computes both accumulators, hidden and gate, from one shared x tile,
//   so x is read once per F tile and the two products never leave
//   registers.  Warps tile the block 4 (M) x 2 (F): 32 rows by 32 columns
//   of each product per warp;
// - mma.sync m16n8k16 in bf16 with f32 accumulation.  For "row.col" the
//   B operand is K-contiguous per output column, which is exactly torch's
//   (2F, K) weight, so W tiles are copied as they lie and no transpose is
//   needed anywhere;
// - 32-wide k tiles of x and of both W halves are double-buffered in shared
//   memory and filled with cp.async, so the next tile loads while this one
//   is multiplied; x rows past M are zero-filled by the copy itself;
// - shared rows are padded from 32 to 40 elements, so the 32-bit fragment
//   loads of a warp hit 32 distinct banks;
// - the epilogue adds the f32 biases, applies the tanh GELU to the gate
//   and multiplies, in registers, and stores bf16 pairs.

#include "mma.cuh"

namespace {

using sfast::cp_async16;
using sfast::cp_async_commit;
using sfast::cp_async_wait;
using sfast::ld_u32;
using sfast::mma_bf16_16816;

constexpr int BM = 128;     // rows of x per block
constexpr int BF = 64;      // output columns per block
constexpr int BK = 32;      // k tile
constexpr int LD = BK + 8;  // shared row, in elements
constexpr int THREADS = 256;
constexpr int STAGE = (BM + 2 * BF) * LD;  // elements per stage: x, hidden W, gate W
constexpr size_t SMEM = 2 * STAGE * sizeof(__nv_bfloat16);

__device__ __forceinline__ float gelu_tanh(float y) {
  const float u = 0.7978845608028654f * (y + 0.044715f * y * y * y);
  return 0.5f * y * (1.f + tanhf(u));
}

__global__ void __launch_bounds__(THREADS)
    geglu_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w,
                 const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                 int m, int k, int f) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int m0 = blockIdx.x * BM, f0 = blockIdx.y * BF;

  auto load_stage = [&](int buf, int kt) {
    __nv_bfloat16* Xs = sm + buf * STAGE;
    __nv_bfloat16* Ws = Xs + BM * LD;  // rows [0, BF) hidden, [BF, 2BF) gate
    const int k0 = kt * BK;
    for (int i = threadIdx.x; i < BM * (BK / 8); i += THREADS) {
      const int r = i / (BK / 8), v = i % (BK / 8);
      const bool in = m0 + r < m;
      cp_async16(Xs + r * LD + v * 8,
                 in ? x + static_cast<long long>(m0 + r) * k + k0 + v * 8 : x,
                 in ? 16 : 0);
    }
    for (int i = threadIdx.x; i < 2 * BF * (BK / 8); i += THREADS) {
      const int r = i / (BK / 8), v = i % (BK / 8);
      const int wrow = r < BF ? f0 + r : f + f0 + (r - BF);
      cp_async16(Ws + r * LD + v * 8, w + static_cast<long long>(wrow) * k + k0 + v * 8, 16);
    }
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp & 3) * 32;   // warp's first row in the block
  const int wf = (warp >> 2) * 32;  // warp's first column in the block

  float acc_h[2][4][4], acc_g[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_h[i][j][e] = acc_g[i][j][e] = 0.f;

  const int nk = k / BK;
  load_stage(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_stage((kt + 1) & 1, kt + 1);  // the buffer kt - 1 used, released below
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Xs = sm + (kt & 1) * STAGE;
    const __nv_bfloat16* Ws = Xs + BM * LD;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const __nv_bfloat16* p = Xs + (wm + mt * 16 + g) * LD + kk * 16 + 2 * t;
        a[mt][0] = ld_u32(p);
        a[mt][1] = ld_u32(p + 8 * LD);
        a[mt][2] = ld_u32(p + 8);
        a[mt][3] = ld_u32(p + 8 * LD + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const __nv_bfloat16* ph = Ws + (wf + nt * 8 + g) * LD + kk * 16 + 2 * t;
        const __nv_bfloat16* pg = ph + BF * LD;
        const uint32_t bh[2] = {ld_u32(ph), ld_u32(ph + 8)};
        const uint32_t bg[2] = {ld_u32(pg), ld_u32(pg + 8)};
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16_16816(acc_h[mt][nt], a[mt], bh);
          mma_bf16_16816(acc_g[mt][nt], a[mt], bg);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }

#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = f0 + wf + nt * 8 + 2 * t;
    float b1[2] = {0.f, 0.f}, b2[2] = {0.f, 0.f};
    if (bias != nullptr) {
      b1[0] = bias[col];
      b1[1] = bias[col + 1];
      b2[0] = bias[f + col];
      b2[1] = bias[f + col + 1];
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // rows g and g + 8
        const int row = m0 + wm + mt * 16 + g + half * 8;
        if (row >= m) continue;
        const float* h = acc_h[mt][nt] + 2 * half;
        const float* gt = acc_g[mt][nt] + 2 * half;
        const float y0 = (h[0] + b1[0]) * gelu_tanh(gt[0] + b2[0]);
        const float y1 = (h[1] + b1[1]) * gelu_tanh(gt[1] + b2[1]);
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long long>(row) * f + col) =
            __floats2bfloat162_rn(y0, y1);
      }
    }
  }
}

}  // namespace

// x: (m, k) bf16; w: (2f, k) bf16; bias: (2f,) f32 or null; out: (m, f)
// bf16, all contiguous.  Requires k % 32 == 0 and f % 64 == 0 (the Python
// wrapper checks both); returns cudaErrorInvalidValue otherwise.
extern "C" int sfast_linear_geglu_bf16(const void* x, const void* w,
                                       const void* bias, void* out, int m,
                                       int k, int f, void* stream) {
  if (m <= 0 || k % BK != 0 || k <= 0 || f % BF != 0 || f <= 0)
    return cudaErrorInvalidValue;
  static_assert(SMEM <= 48 * 1024, "above 48 KB needs cudaFuncSetAttribute");
  const dim3 grid((m + BM - 1) / BM, f / BF);
  geglu_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), m, k, f);
  return cudaGetLastError();
}
