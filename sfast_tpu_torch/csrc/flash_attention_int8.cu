// K6: forward flash attention with int8 q.k^T and p.v (SageAttention-style
// quantization), f32 softmax state, bf16 output.
//
// Replaces the Pallas kernel sfast_tpu/ops/flash_attention.py::
// _flash_int8_kernel (entry point flash_attention_int8).  On the opt-in
// path (enable_int8_attention) it runs the SD1.5 UNet's level-0
// self-attention: (2, 8, 4096, 40), non-causal, 5 per UNet eval.  The
// wrapper (ops/flash_attention_int8.py) does JAX's pre-processing outside
// the kernel, as JAX does: q pre-scaled by scale * log2(e); q, k and v
// mean-centred, q's mean returned exactly as the per-column corr = qbar.k^T;
// q and k quantized per (b*h), v per (b*h, channel); after the kernel the
// wrapper adds v's mean back.
//
// What bounds it on the H100: the two products and the softmax between
// them, 4*S^2*D ops per (b, h).  int8 mma.sync runs at twice the bf16
// rate, so for d = 40 the exp2 and the quantization of p weigh about as
// much as the products.
//
// Design (K1's, csrc/flash_attention.cu, with int8 operands):
// - one block of 8 warps per (b*h, 128-row q tile), a loop over 64-wide kv
//   tiles inside it; m, l and the output accumulator stay in registers;
// - k, v and corr tiles are double-buffered in shared memory and filled
//   with cp.async; q and k rows are d bytes, so they move in 8-byte copies,
//   and rows past the end are zero-filled by the copy itself;
// - q.k^T: mma.sync m16n8k32 s8 x s8 -> s32, d padded to DP (a multiple of
//   32) in shared memory only, by zeroing the tile once;
// - dequantization s = s_i32 * (s_q * s_k) + corr, then the mask: columns
//   past kv (or above the diagonal) become -inf, since an int8 zero scores
//   corr, not -inf;
// - online softmax in exp2 (log2 e is in q's scale).  As in the Pallas
//   kernel, p = exp2(s - m_tile) is taken against the row max of its own kv
//   tile, so it peaks at 1 in every tile and is quantized to
//   int8(p * 127 + 0.5) with the full range; beta = exp2(m_tile - m_new)
//   dequantizes the tile's p.v, s_v / 127 per channel, and l sums the
//   unquantized p;
// - p.v: mma.sync m16n8k32 again.  The s32 C fragment of q.k^T gives a
//   thread columns {2t, 2t+1} of each n8 tile, but the s8 A fragment wants
//   columns {4t..4t+3} of each 32-wide chunk.  Any permutation of kv applied
//   to both p's columns and v's rows leaves p.v unchanged, so the wrapper
//   stores v as v^T, (b*h, d, kv), with each 16-wide kv group in the order
//   (0, 1, 8, 9, 2, 3, 10, 11, 4, 5, 12, 13, 6, 7, 14, 15): then a thread's
//   own quantized scores are exactly its A registers, and each B register is
//   one 32-bit load of 4 consecutive kv of one v^T row;
// - v^T rows are padded to a multiple of 64 kv by the wrapper, so its tiles
//   need no bounds checks; the padded columns carry p = 0.
// Shared rows are padded by 16 bytes so that each warp's 32-bit fragment
// loads hit 32 distinct banks.

#include "mma.cuh"

namespace {

using sfast::cp_async16;
using sfast::cp_async8;
using sfast::cp_async_commit;
using sfast::cp_async_wait;
using sfast::ld_u32;
using sfast::mma_s8_16832;

constexpr int BQ = 128;           // q rows per block (8 warps x 16)
constexpr int BKV = 64;           // kv columns per tile
constexpr int LDV = BKV + 16;     // shared row of v^T, in bytes
constexpr int THREADS = 256;

// q tile, two k tiles, two v^T tiles, two corr tiles; a multiple of 16
template <int DP>
__host__ __device__ constexpr int smem_bytes() {
  return (BQ + 2 * BKV) * (DP + 16) + 2 * DP * LDV + 2 * BKV * 4;
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return static_cast<uint32_t>(a) | (static_cast<uint32_t>(b) << 8) |
         (static_cast<uint32_t>(c) << 16) | (static_cast<uint32_t>(d) << 24);
}

// DP: d padded to a multiple of 32 (the k of an int8 product); ND: n8 tiles
// of the output, at least d / 8.
template <int DP, int ND>
__global__ void __launch_bounds__(THREADS)
    flash_int8_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                      const int8_t* __restrict__ vt, const float* __restrict__ sqk,
                      const float* __restrict__ sv, const float* __restrict__ corr,
                      __nv_bfloat16* __restrict__ o, int heads, int sq, int sk,
                      int skp, int d, long long o_sb, long long o_sh,
                      long long o_ss, int causal) {
  constexpr int LD = DP + 16;  // shared row of q and k, in bytes
  constexpr int NT = BKV / 8;  // n8 tiles of the score block
  constexpr int KQ = DP / 32;  // k32 steps of q.k^T
  constexpr int KV = BKV / 32; // k32 steps of p.v
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* Qs = reinterpret_cast<int8_t*>(smem_raw);            // [BQ][LD]
  int8_t* Ks = Qs + BQ * LD;                                   // [2][BKV][LD]
  int8_t* Vs = Ks + 2 * BKV * LD;                              // [2][DP][LDV]
  float* Cs = reinterpret_cast<float*>(Vs + 2 * DP * LDV);     // [2][BKV]

  // zero all of smem once: this keeps the d padding of q at zero
  for (int i = threadIdx.x; i < smem_bytes<DP>() / 16; i += THREADS)
    reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh - b * heads;
  const int q0 = blockIdx.x * BQ;
  const int8_t* qp = q + static_cast<long long>(bh) * sq * d;
  const int8_t* kp = k + static_cast<long long>(bh) * sk * d;
  const int8_t* vp = vt + static_cast<long long>(bh) * d * skp;
  const float* cp = corr + static_cast<long long>(bh) * skp;
  __nv_bfloat16* op = o + b * o_sb + h * o_sh;

  const int cpr = d / 8;  // 8-byte copies per q or k row
  auto load_rows = [&](int8_t* dst, const int8_t* src, int row0, int nrow, int nrows) {
    for (int i = threadIdx.x; i < nrow * cpr; i += THREADS) {
      const int r = i / cpr, c = i - r * cpr;
      const bool in = row0 + r < nrows;
      cp_async8(dst + r * LD + c * 8,
                in ? src + static_cast<long long>(row0 + r) * d + c * 8 : src, in ? 8 : 0);
    }
  };
  auto load_kv = [&](int tile) {
    const int buf = tile & 1, k0 = tile * BKV;
    load_rows(Ks + buf * BKV * LD, kp, k0, BKV, sk);
    int8_t* vdst = Vs + buf * DP * LDV;
    for (int i = threadIdx.x; i < d * (BKV / 16); i += THREADS) {
      const int r = i / (BKV / 16), c = i % (BKV / 16);
      cp_async16(vdst + r * LDV + c * 16, vp + static_cast<long long>(r) * skp + k0 + c * 16, 16);
    }
    if (threadIdx.x < BKV / 4)
      cp_async16(Cs + buf * BKV + threadIdx.x * 4, cp + k0 + threadIdx.x * 4, 16);
  };

  const int kv_end = causal ? min(sk, q0 + BQ) : sk;
  const int ntiles = (kv_end + BKV - 1) / BKV;
  load_rows(Qs, qp, q0, BQ, sq);
  load_kv(0);
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;
  const int row_a = q0 + r0 + g;  // this thread's two q rows
  const int row_b = row_a + 8;

  const float s_qk = sqk[bh];
  float s_v[ND][2];  // s_v / 127 of this thread's output columns
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = n * 8 + 2 * t + e;
      s_v[n][e] = col < d ? sv[static_cast<long long>(bh) * d + col] : 0.f;
    }

  uint32_t qf[KQ][4];
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int tile = 0; tile < ntiles; ++tile) {
    if (tile + 1 < ntiles) {
      load_kv(tile + 1);  // into the buffer tile - 1 used, released below
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and on the first pass q) is in smem
    if (tile == 0) {
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        const int8_t* p = Qs + (r0 + g) * LD + kk * 32 + 4 * t;
        qf[kk][0] = ld_u32(p);
        qf[kk][1] = ld_u32(p + 8 * LD);
        qf[kk][2] = ld_u32(p + 16);
        qf[kk][3] = ld_u32(p + 8 * LD + 16);
      }
    }
    const int k0 = tile * BKV;
    const int8_t* Kt = Ks + (tile & 1) * BKV * LD;
    const int8_t* Vt = Vs + (tile & 1) * DP * LDV;
    const float* Ct = Cs + (tile & 1) * BKV;

    int si[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      si[j][0] = si[j][1] = si[j][2] = si[j][3] = 0;
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        const int8_t* p = Kt + (j * 8 + g) * LD + kk * 32 + 4 * t;
        const uint32_t bf[2] = {ld_u32(p), ld_u32(p + 16)};
        mma_s8_16832(si[j], qf[kk], bf);
      }
    }

    // dequantize, add q's mean term, mask; the tile's row max
    const bool need_mask = causal || (k0 + BKV > sk);
    float s[NT][4];
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = j * 8 + 2 * t + (e & 1);
        float x = __fadd_rn(__fmul_rn(static_cast<float>(si[j][e]), s_qk), Ct[cl]);
        if (need_mask) {
          const int row = (e < 2) ? row_a : row_b;
          if (k0 + cl >= sk || (causal && k0 + cl > row)) x = -INFINITY;
        }
        s[j][e] = x;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
      }
    }
    float base[2], alpha[2], beta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffff, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffff, tmax[r], 2));
      const float m_new = fmaxf(m[r], tmax[r]);
      // a row masked across this whole tile adds nothing: p = 0, beta = 0
      // (the Pallas kernel gets the same from its finite -1e30 mask)
      base[r] = (tmax[r] == -INFINITY) ? 0.f : tmax[r];
      alpha[r] = (m_new == -INFINITY) ? 0.f : exp2f(m[r] - m_new);
      beta[r] = (tmax[r] == -INFINITY) ? 0.f : exp2f(tmax[r] - m_new);
      m[r] = m_new;
    }

    // p against the tile's row max; l sums it unquantized
    int pq[NT][4];
    float rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - base[e >> 1]);
        rsum[e >> 1] += p;
        pq[j][e] = static_cast<int>(__fadd_rn(__fmul_rn(p, 127.f), 0.5f));
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] += __shfl_xor_sync(0xffffffff, rsum[r], 1);
      rsum[r] += __shfl_xor_sync(0xffffffff, rsum[r], 2);
      l[r] = l[r] * alpha[r] + beta[r] * rsum[r];
    }

    // a thread's quantized scores, in the permuted kv order, are its A
    // registers: chunk c takes n8 tiles 4c..4c+3
    uint32_t pa[KV][4];
#pragma unroll
    for (int c = 0; c < KV; ++c) {
      pa[c][0] = pack4(pq[4 * c][0], pq[4 * c][1], pq[4 * c + 1][0], pq[4 * c + 1][1]);
      pa[c][1] = pack4(pq[4 * c][2], pq[4 * c][3], pq[4 * c + 1][2], pq[4 * c + 1][3]);
      pa[c][2] = pack4(pq[4 * c + 2][0], pq[4 * c + 2][1], pq[4 * c + 3][0], pq[4 * c + 3][1]);
      pa[c][3] = pack4(pq[4 * c + 2][2], pq[4 * c + 2][3], pq[4 * c + 3][2], pq[4 * c + 3][3]);
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      int pv[4] = {0, 0, 0, 0};
#pragma unroll
      for (int c = 0; c < KV; ++c) {
        const int8_t* p = Vt + (n * 8 + g) * LDV + c * 32 + 4 * t;
        const uint32_t bf[2] = {ld_u32(p), ld_u32(p + 16)};
        mma_s8_16832(pv, pa[c], bf);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float add = __fmul_rn(__fmul_rn(static_cast<float>(pv[e]), beta[r]), s_v[n][e & 1]);
        acc[n][e] = __fadd_rn(__fmul_rn(acc[n][e], alpha[r]), add);
      }
    }
    __syncthreads();  // every warp is done with this tile's buffers
  }

#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = n * 8 + 2 * t;
    if (col >= d) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? row_b : row_a;
      if (row >= sq) continue;
      const float lr = l[half];
      *reinterpret_cast<__nv_bfloat162*>(op + row * o_ss + col) = __floats2bfloat162_rn(
          __fdiv_rn(acc[n][2 * half], lr), __fdiv_rn(acc[n][2 * half + 1], lr));
    }
  }
}

template <int DP, int ND>
cudaError_t launch(const void* q, const void* k, const void* vt, const void* sqk,
                   const void* sv, const void* corr, void* o, int batch, int heads,
                   int sq, int sk, int skp, int d, long long o_sb, long long o_sh,
                   long long o_ss, int causal, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DP>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(flash_int8_kernel<DP, ND>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((sq + BQ - 1) / BQ, batch * heads);
  flash_int8_kernel<DP, ND><<<grid, THREADS, smem, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(vt), static_cast<const float*>(sqk),
      static_cast<const float*>(sv), static_cast<const float*>(corr),
      static_cast<__nv_bfloat16*>(o), heads, sq, sk, skp, d, o_sb, o_sh, o_ss, causal);
  return cudaGetLastError();
}

}  // namespace

// q: (b*h, sq, d) int8, k: (b*h, sk, d) int8, vt: (b*h, d, skp) int8 in the
// permuted kv order, sqk: (b*h,) f32, sv: (b*h, d) f32 (s_v / 127), corr:
// (b*h, skp) f32, all contiguous; o: bf16 through (b, h, s) strides with a
// unit d stride.  d is a multiple of 8 up to 160, skp a multiple of 64 and
// at least sk; returns cudaErrorInvalidValue otherwise.
extern "C" int sfast_flash_attention_int8(const void* q, const void* k, const void* vt,
                                          const void* sqk, const void* sv,
                                          const void* corr, void* o, int batch,
                                          int heads, int sq, int sk, int skp, int d,
                                          long long o_sb, long long o_sh,
                                          long long o_ss, int causal, void* stream) {
  if (d % 8 != 0 || d <= 0 || d > 160 || skp % BKV != 0 || skp < sk || sk <= 0 || sq <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SFAST_INT8_CASE(DPV, NDV)                                                   \
  return launch<DPV, NDV>(q, k, vt, sqk, sv, corr, o, batch, heads, sq, sk, skp, d, \
                          o_sb, o_sh, o_ss, causal, st);
  if (d == 40) SFAST_INT8_CASE(64, 5)  // SD1.5 level 0: no dead output tiles
  if (d <= 32) SFAST_INT8_CASE(32, 4)
  if (d <= 64) SFAST_INT8_CASE(64, 8)
  if (d <= 96) SFAST_INT8_CASE(96, 12)
  if (d <= 128) SFAST_INT8_CASE(128, 16)
  SFAST_INT8_CASE(160, 20)
#undef SFAST_INT8_CASE
}
