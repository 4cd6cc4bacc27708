// K6: forward flash attention with int8 q·kᵀ and p·v (SageAttention-style
// quantization), f32 softmax state, bf16 output.
//
// Replaces the Pallas kernel sfast_tpu/ops/flash_attention.py::
// _flash_int8_kernel (entry point flash_attention_int8).  On the opt-in
// path (enable_int8_attention) it runs the SD1.5 UNet's level-0
// self-attention: (2, 8, 4096, 40), non-causal, 5 per UNet eval.  Its
// inputs come from K6's pre-processing (csrc/quantize_qkv.cu): q
// prescaled by scale·log2(e), q, k and v mean-centred and quantized, q's
// mean as the per-column corr = q̄·kᵀ; the epilogue adds v's mean back.
//
// What bounds it on the H100: the two int8 products, 4·S²·D operations per
// (b, h) — 21.7 µs at 1979 TOP/s for the main-path call — and at d = 40
// the work per score between them: one MUFU exp2 each, S² per (b, h),
// against 16 per clock per SM, about 64 µs, and about ten more
// instructions each for the dequantization, the row max and sum and p's
// int8 code, which the issue rate bounds.
//
// Design (K1's, csrc/flash_attention.cu, with s8 wgmma):
// - One block per (b·h, 64·NWG q rows): NWG consumer warpgroups of 64 rows
//   (3 at d <= 64, 2 above) and a producer warpgroup whose one thread
//   issues the TMA loads.  A loop over kv tiles (128 kv at d <= 64, 64 at
//   d <= 128, 32 above, so that the score tile, p, the tile's p·v and the
//   output accumulator fit a consumer's registers) keeps m, l and the
//   accumulator in registers.
// - 8-bit wgmma takes both operands K-major: q and k as rows, v as vᵀ.
//   The pre-processing writes q8 and k8 as rows zero-padded to KP (d
//   rounded up to 32) and vᵀ as d rows of kv, so TMA lands them in
//   swizzled K-major atoms (q, k: 64-byte rows up to KP = 64, 128 above;
//   vᵀ: rows of one kv tile).  Rows past S, columns past KP and vᵀ rows
//   past d arrive as zeros; corr comes with k, by TMA, on k's barrier.  k,
//   corr and v go through a 3-stage ring on mbarriers.
// - S = q·kᵀ by wgmma m64nBKVk32 s8 from shared memory; pv = p·v by wgmma
//   with p in registers: the s8 A fragment is mma.m16n8k32's over each
//   warp's rows, so storing vᵀ with each 16-kv group in the order (0, 1,
//   8, 9, 2, 3, 10, 11, 4, 5, 12, 13, 6, 7, 14, 15) makes a thread's own
//   quantized scores its A registers (any permutation of kv applied to
//   p's columns and v's rows leaves p·v unchanged).  N = d rounded up to
//   one of 32, 48, 64, 96, 128, 160 (s8 wgmma has no N = 40).
// - Per tile, tile i's q·kᵀ and tile i-1's p·v are issued together; the
//   softmax of tile i runs while p·v is in flight, and p is packed once
//   neither is.  Each tile's p·v has an s32 accumulator of its own, since
//   the tile's β and the carry α scale it in f32: acc = acc·α + pv·β.
// - Per score, no I2F, F2I or non-ftz exp2: the s32 score (below 2^22:
//   127²·160 ≈ 2.6·10⁶) becomes f32 by an integer add of 1.5·2^23's bits
//   and one subtraction; exp2 is ex2.approx.ftz; the int8 code of p,
//   JAX's truncating int8(p·127 + 0.5), is the low byte of
//   __fadd_rd(y, 2^23) with y = p·127 + 0.5 rounded as the plain version
//   rounds it (a multiply, then an add); prmt packs four codes.
// - The Pallas kernel's semantics: p is taken against its own kv tile's
//   row max, so it peaks at 1 in every tile and uses the full int8 range;
//   β = exp2(m_tile − m_new) and s_v / 127 per channel dequantize p·v; l
//   sums the unquantized p in f32; columns past kv and above the diagonal
//   are −inf (an int8 zero scores corr, not −inf), and a tile masked for a
//   row adds nothing to it (p = 0, β = 0).  The epilogue stores
//   bf16(acc·s_v / l) + bf16(v̄), as (acc / l).astype(bf16) +
//   vm.astype(bf16).  No atomics: two calls agree bit for bit.

#include "sm90.cuh"

namespace {

namespace s9 = sfast::sm90;

constexpr float MAGIC = 12582912.f;          // 1.5·2^23
constexpr int MAGIC_BITS = 0x4B400000;       // its bits
constexpr float ROUND_SHIFT = 8388608.f;     // 2^23: one unit in the last place is 1

struct Params {
  __nv_bfloat16* o;
  long long o_sb, o_sh, o_ss;
  const float* sqk;  // (b·h,)
  const float* sv;   // (b·h, d): s_v / 127
  const float* vm;   // (b·h, d)
  int heads, sq, sk, d, causal;
};

// NPV: p·v's N, d padded; NWG: consumer warpgroups of 64 q rows each
template <int NPV, int NWG>
struct Cfg {
  static constexpr int BQ = 64 * NWG;              // q rows per block
  static constexpr int THREADS = 128 * (NWG + 1);  // + the producer warpgroup
  static constexpr int CONSUMER_REGS = NWG == 2 ? 240 : 160;
  // kv per tile, p's quantization tile: the score tile, p, the tile's p·v
  // and the output accumulator stay in a consumer's registers
  static constexpr int BKV = NPV <= 64 ? 128 : (NPV <= 128 ? 64 : 32);
  static constexpr int KP = (NPV + 31) / 32 * 32;  // q8 and k8 row bytes
  // q and k land in swizzle atoms of QK_SW bytes a row (64 up to KP = 64,
  // else 128), NA of them; q·kᵀ's depth is NA·QK_SW, zeros past KP
  static constexpr int QK_SW = KP <= 64 ? 64 : 128;
  static constexpr int NA = (KP + QK_SW - 1) / QK_SW;
  static constexpr int ST = 3;                     // ring stages
  static constexpr int Q_ATOM = BQ * QK_SW;
  static constexpr int K_ATOM = BKV * QK_SW;
  static constexpr int Q_BYTES = NA * Q_ATOM;
  static constexpr int K_BYTES = NA * K_ATOM;
  static constexpr int V_BYTES = NPV * BKV;        // vᵀ rows of one tile: one swizzle atom
  static constexpr int C_BYTES = BKV * 4;          // corr
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + ST * K_BYTES;
  static constexpr int OFF_C = OFF_V + ST * V_BYTES;
  static constexpr int OFF_BAR = OFF_C + ST * C_BYTES;
  static constexpr int SMEM = OFF_BAR + (1 + 4 * ST) * 8 + 1024;  // + alignment slack
};

// the wgmma descriptor's layout type of a K-major swizzle of `bytes` a row
__host__ __device__ constexpr uint32_t swizzle_type(int bytes) {
  return bytes == 128 ? 1 : (bytes == 64 ? 2 : 3);
}
constexpr CUtensorMapSwizzle swizzle_mode(int bytes) {
  return bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                      : (bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B);
}

template <int BKV>
__device__ __forceinline__ void wgmma_qk(uint32_t* s, uint64_t a, uint64_t b, int acc);
template <>
__device__ __forceinline__ void wgmma_qk<32>(uint32_t* s, uint64_t a, uint64_t b, int acc) {
  s9::wgmma_m64n32k32_ss_s8(s, a, b, acc);
}
template <>
__device__ __forceinline__ void wgmma_qk<64>(uint32_t* s, uint64_t a, uint64_t b, int acc) {
  s9::wgmma_m64n64k32_ss_s8(s, a, b, acc);
}
template <>
__device__ __forceinline__ void wgmma_qk<128>(uint32_t* s, uint64_t a, uint64_t b, int acc) {
  s9::wgmma_m64n128k32_ss_s8(s, a, b, acc);
}

template <int NPV>
__device__ __forceinline__ void wgmma_pv(uint32_t* o, const uint32_t* a, uint64_t b, int acc);
#define SFAST_PV(N)                                                                     \
  template <>                                                                           \
  __device__ __forceinline__ void wgmma_pv<N>(uint32_t* o, const uint32_t* a, uint64_t b, \
                                              int acc) {                                \
    s9::wgmma_m64n##N##k32_rs_s8(o, a, b, acc);                                         \
  }
SFAST_PV(32)
SFAST_PV(48)
SFAST_PV(64)
SFAST_PV(96)
SFAST_PV(128)
SFAST_PV(160)
#undef SFAST_PV

// 2^x on MUFU, flushing results below 2^-126 to 0
__device__ __forceinline__ float exp2_mufu(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// an s32 below 2^22 in magnitude, exactly, without I2F: its sum with the
// bits of 1.5·2^23 is the float 1.5·2^23 + s
__device__ __forceinline__ float s32_to_f32(uint32_t s) {
  return __int_as_float(static_cast<int>(s) + MAGIC_BITS) - MAGIC;
}

// the low bytes of four registers, a's lowest
__device__ __forceinline__ uint32_t pack_bytes(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// One score tile in place: s (s32 scores) becomes the bits of __fadd_rd(y,
// 2^23), whose low byte is p's int8 code; l and m move on, alpha and beta
// are this tile's carry and dequantization factors.  row_a, row_b: this
// thread's two q rows.
template <int NT>
__device__ __forceinline__ void softmax_tile(uint32_t (&s)[NT * 4], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float (&beta)[2], const float* corr, float sqk,
                                             const Params& p, int k0, int t, int row_a,
                                             int row_b) {
  float x[NT * 4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 c = *reinterpret_cast<const float2*>(corr + j * 8 + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[4 * j + e] = fmaf(s32_to_f32(s[4 * j + e]), sqk, (e & 1) ? c.y : c.x);
  }
  if (p.causal || k0 + NT * 8 > p.sk) {  // only the tiles that need it
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const int row = (e < 2) ? row_a : row_b;
        if (col >= p.sk || (p.causal && col > row)) x[4 * j + e] = -INFINITY;
      }
  }
  float mx[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u) mx[r][u] = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    mx[0][j % 4] = fmaxf(mx[0][j % 4], fmaxf(x[4 * j + 0], x[4 * j + 1]));
    mx[1][j % 4] = fmaxf(mx[1][j % 4], fmaxf(x[4 * j + 2], x[4 * j + 3]));
  }
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float tmax = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffff, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffff, tmax, 2));
    const float m_new = fmaxf(m[r], tmax);
    // a row masked across this whole tile adds nothing: p = 0, beta = 0
    base[r] = tmax == -INFINITY ? 0.f : tmax;
    alpha[r] = m_new == -INFINITY ? 0.f : exp2_mufu(m[r] - m_new);
    beta[r] = tmax == -INFINITY ? 0.f : exp2_mufu(tmax - m_new);
    m[r] = m_new;
  }
  float rs[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pr = exp2_mufu(x[4 * j + e] - base[e >> 1]);
      rs[e >> 1][j % 4] += pr;
      const float y = __fadd_rn(__fmul_rn(pr, 127.f), 0.5f);
      s[4 * j + e] = __float_as_uint(__fadd_rd(y, ROUND_SHIFT));
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float rsum = (rs[r][0] + rs[r][1]) + (rs[r][2] + rs[r][3]);
    rsum += __shfl_xor_sync(0xffffffff, rsum, 1);
    rsum += __shfl_xor_sync(0xffffffff, rsum, 2);
    l[r] = l[r] * alpha[r] + beta[r] * rsum;
  }
}

// p's codes as the A registers of p·v: k32 step c takes n8 tiles 4c..4c+3
template <int NT>
__device__ __forceinline__ void pack_p(const uint32_t (&s)[NT * 4], uint32_t (&pa)[NT / 4][4]) {
#pragma unroll
  for (int c = 0; c < NT / 4; ++c) {
    const uint32_t* a = s + 16 * c;
    pa[c][0] = pack_bytes(a[0], a[1], a[4], a[5]);
    pa[c][1] = pack_bytes(a[2], a[3], a[6], a[7]);
    pa[c][2] = pack_bytes(a[8], a[9], a[12], a[13]);
    pa[c][3] = pack_bytes(a[10], a[11], a[14], a[15]);
  }
}

// acc = acc·alpha + pv·beta over this thread's output columns (|pv| <=
// 127²·128 < 2^22)
template <int N>
__device__ __forceinline__ void rescale(float* acc, const uint32_t* pv, const float (&alpha)[2],
                                        const float (&beta)[2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = (i >> 1) & 1;
    acc[i] = fmaf(s32_to_f32(pv[i]), beta[r], acc[i] * alpha[r]);
  }
}

template <int NPV, int NWG>
__global__ void __launch_bounds__(Cfg<NPV, NWG>::THREADS, 1)
    flash_int8_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap cmap, const Params p) {
  using C = Cfg<NPV, NWG>;
  constexpr int BKV = C::BKV, NT = BKV / 8, CONSUMERS = 128 * NWG;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = smem;
  unsigned char* ks = smem + C::OFF_K;
  unsigned char* vs = smem + C::OFF_V;
  float* cs = reinterpret_cast<float*>(smem + C::OFF_C);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + C::ST;
  uint64_t* v_full = k_empty + C::ST;
  uint64_t* v_empty = v_full + C::ST;

  const int bh = blockIdx.y;
  const int b = bh / p.heads, h = bh - b * p.heads;
  const int q0 = blockIdx.x * C::BQ;
  const int kv_end = p.causal ? min(p.sk, q0 + C::BQ) : p.sk;
  const int ntiles = (kv_end + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
    s9::mbar_init(q_full, 1);
    for (int i = 0; i < C::ST; ++i) {
      s9::mbar_init(&k_full[i], 1);
      s9::mbar_init(&k_empty[i], NWG);  // one arrival per consumer warpgroup
      s9::mbar_init(&v_full[i], 1);
      s9::mbar_init(&v_empty[i], NWG);
    }
    s9::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // producer warpgroup
    s9::setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS) {
      s9::prefetch_tensormap(&qmap);
      s9::prefetch_tensormap(&kmap);
      s9::prefetch_tensormap(&vmap);
      s9::prefetch_tensormap(&cmap);
      s9::mbar_expect_tx(q_full, C::Q_BYTES);
      for (int a = 0; a < C::NA; ++a)
        s9::tma_load_3d(qs + a * C::Q_ATOM, &qmap, q_full, a * C::QK_SW, q0, bh);
      for (int i = 0; i < ntiles; ++i) {
        const int st = i % C::ST;
        const uint32_t ph = ((i / C::ST) & 1) ^ 1;
        s9::mbar_wait(&k_empty[st], ph);
        s9::mbar_expect_tx(&k_full[st], C::K_BYTES + C::C_BYTES);
        for (int a = 0; a < C::NA; ++a)
          s9::tma_load_3d(ks + st * C::K_BYTES + a * C::K_ATOM, &kmap, &k_full[st],
                          a * C::QK_SW, i * BKV, bh);
        s9::tma_load_2d(cs + st * BKV, &cmap, &k_full[st], i * BKV, bh);
        s9::mbar_wait(&v_empty[st], ph);
        s9::mbar_expect_tx(&v_full[st], C::V_BYTES);
        s9::tma_load_3d(vs + st * C::V_BYTES, &vmap, &v_full[st], i * BKV, 0, bh);
      }
    }
    return;
  }

  s9::setmaxnreg_inc<C::CONSUMER_REGS>();
  const int wg = threadIdx.x / 128;
  const int wtid = threadIdx.x % 128;
  const int warp = wtid / 32, lane = wtid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row_a = q0 + wg * 64 + warp * 16 + g;  // this thread's two q rows
  const int row_b = row_a + 8;
  const float sqk = p.sqk[bh];

  float acc[NPV / 2];
#pragma unroll
  for (int i = 0; i < NPV / 2; ++i) acc[i] = 0.f;
  uint32_t pv[NPV / 2];
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float alpha[2], beta[2], alpha_p[2], beta_p[2];  // this tile's, the previous tile's
  uint32_t s[NT * 4];
  uint32_t pa[NT / 4][4];

  const uint32_t q_base = sfast::smem_addr(qs) + wg * 64 * C::QK_SW;
  // S = q·kᵀ for tile i, issued and committed, not awaited
  auto issue_qk = [&](int i) {
    const int st = i % C::ST;
    s9::mbar_wait(&k_full[st], (i / C::ST) & 1);
    const uint32_t k_base = sfast::smem_addr(ks + st * C::K_BYTES);
    s9::fence_regs<NT * 4>(s);
    s9::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::NA * C::QK_SW / 32; ++kk) {
      // 32 bytes of K: a step inside a swizzled row, or the next atom
      const int atom = kk / (C::QK_SW / 32), off = (kk % (C::QK_SW / 32)) * 32;
      constexpr uint32_t sw = swizzle_type(C::QK_SW);
      wgmma_qk<BKV>(s, s9::make_desc(q_base + atom * C::Q_ATOM + off, 16, 8 * C::QK_SW, sw),
                    s9::make_desc(k_base + atom * C::K_ATOM + off, 16, 8 * C::QK_SW, sw),
                    kk > 0);
    }
    s9::wgmma_commit();
  };
  // pv = p·v for tile i, issued and committed, not awaited
  auto issue_pv = [&](int i) {
    const int st = i % C::ST;
    s9::mbar_wait(&v_full[st], (i / C::ST) & 1);
    const uint32_t v_base = sfast::smem_addr(vs + st * C::V_BYTES);
    s9::fence_regs<NPV / 2>(pv);
    s9::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 32; ++kk)
      wgmma_pv<NPV>(pv, pa[kk],
                    s9::make_desc(v_base + kk * 32, 16, 8 * BKV, swizzle_type(BKV)), kk > 0);
    s9::wgmma_commit();
  };

  s9::mbar_wait(q_full, 0);
  issue_qk(0);
  s9::wgmma_wait<0>();
  s9::fence_regs<NT * 4>(s);
  softmax_tile<NT>(s, m, l, alpha, beta, cs, sqk, p, 0, t, row_a, row_b);
  if (wtid == 0) s9::mbar_arrive(&k_empty[0]);
  pack_p<NT>(s, pa);

  // tile i's q·kᵀ and tile i-1's p·v run while tile i's softmax waits for
  // the first, then runs under the second; p is packed once neither is in
  // flight
  for (int i = 1; i < ntiles; ++i) {
    const int st = i % C::ST;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha_p[r] = alpha[r];
      beta_p[r] = beta[r];
    }
    issue_qk(i);
    issue_pv(i - 1);
    s9::wgmma_wait<1>();
    s9::fence_regs<NT * 4>(s);
    softmax_tile<NT>(s, m, l, alpha, beta, cs + st * BKV, sqk, p, i * BKV, t, row_a, row_b);
    if (wtid == 0) s9::mbar_arrive(&k_empty[st]);
    s9::wgmma_wait<0>();
    s9::fence_regs<NPV / 2>(pv);
    s9::fence_regs<NT>(&pa[0][0]);
    if (wtid == 0) s9::mbar_arrive(&v_empty[(i - 1) % C::ST]);
    rescale<NPV / 2>(acc, pv, alpha_p, beta_p);
    pack_p<NT>(s, pa);
  }
  issue_pv(ntiles - 1);
  s9::wgmma_wait<0>();
  s9::fence_regs<NPV / 2>(pv);
  if (wtid == 0) s9::mbar_arrive(&v_empty[(ntiles - 1) % C::ST]);
  rescale<NPV / 2>(acc, pv, alpha, beta);

  const float inv_a = l[0] > 0.f ? 1.f / l[0] : 0.f;
  const float inv_b = l[1] > 0.f ? 1.f / l[1] : 0.f;
  __nv_bfloat16* op = p.o + b * p.o_sb + h * p.o_sh;
  const float* sv = p.sv + static_cast<long long>(bh) * p.d;
  const float* vm = p.vm + static_cast<long long>(bh) * p.d;
#pragma unroll
  for (int n = 0; n < NPV / 8; ++n) {
    const int col = n * 8 + 2 * t;  // even; d % 8 == 0
    if (col >= p.d) continue;
    const float2 scl = *reinterpret_cast<const float2*>(sv + col);
    const __nv_bfloat162 mean = __floats2bfloat162_rn(vm[col], vm[col + 1]);
    if (row_a < p.sq)
      *reinterpret_cast<__nv_bfloat162*>(op + row_a * p.o_ss + col) = __hadd2(
          __floats2bfloat162_rn(acc[4 * n + 0] * scl.x * inv_a, acc[4 * n + 1] * scl.y * inv_a),
          mean);
    if (row_b < p.sq)
      *reinterpret_cast<__nv_bfloat162*>(op + row_b * p.o_ss + col) = __hadd2(
          __floats2bfloat162_rn(acc[4 * n + 2] * scl.x * inv_b, acc[4 * n + 3] * scl.y * inv_b),
          mean);
  }
}

// (b·h, rows, cols) bytes as the 3-D map (cols, rows, b·h), boxes of
// box_cols x box_rows landing with the swizzle of box_cols bytes
bool encode_rows(CUtensorMap* map, const void* ptr, int bh, int rows, int cols, int box_cols,
                 int box_rows) {
  const uint64_t dims[3] = {static_cast<uint64_t>(cols), static_cast<uint64_t>(rows),
                            static_cast<uint64_t>(bh)};
  const uint64_t strides[2] = {static_cast<uint64_t>(cols), static_cast<uint64_t>(cols) * rows};
  const uint32_t box[3] = {static_cast<uint32_t>(box_cols), static_cast<uint32_t>(box_rows), 1};
  return s9::encode_tensor_map(map, ptr, 3, dims, strides, box, swizzle_mode(box_cols),
                               CU_TENSOR_MAP_DATA_TYPE_UINT8);
}

template <int NPV, int NWG>
cudaError_t launch(const void* q8, const void* k8, const void* vt, const void* corr,
                   const Params& p, int batch, int skp, cudaStream_t stream) {
  using C = Cfg<NPV, NWG>;
  const int bh = batch * p.heads;
  CUtensorMap qm, km, vm, cm;
  const uint64_t cdims[2] = {static_cast<uint64_t>(skp), static_cast<uint64_t>(bh)};
  const uint64_t cstrides[1] = {4ull * skp};
  const uint32_t cbox[2] = {static_cast<uint32_t>(C::BKV), 1};
  // q8, k8: rows of KP bytes; vᵀ: d rows of skp bytes (its rows past d, up
  // to NPV, and columns past KP load as zeros)
  if (!encode_rows(&qm, q8, bh, p.sq, C::KP, C::QK_SW, C::BQ) ||
      !encode_rows(&km, k8, bh, p.sk, C::KP, C::QK_SW, C::BKV) ||
      !encode_rows(&vm, vt, bh, p.d, skp, C::BKV, NPV) ||
      !s9::encode_tensor_map(&cm, corr, 2, cdims, cstrides, cbox, CU_TENSOR_MAP_SWIZZLE_NONE,
                             CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
    return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(  // once per instantiation
      flash_int8_kernel<NPV, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.sq + C::BQ - 1) / C::BQ, bh);
  flash_int8_kernel<NPV, NWG><<<grid, C::THREADS, C::SMEM, stream>>>(qm, km, vm, cm, p);
  return cudaGetLastError();
}

}  // namespace

// The inputs as csrc/quantize_qkv.cu writes them: q8 (b·h, sq, kp) and k8
// (b·h, sk, kp) int8 with kp = d rounded up to 32; vt (b·h, d, skp) int8
// in the permuted kv order and corr (b·h, skp) f32 with skp = sk rounded up
// to 16; sqk (b·h,), sv and vm (b·h, d) f32; all contiguous.  o: bf16
// through (b, h, s) strides with a unit d stride.  d is a multiple of 8 up
// to 160; returns cudaErrorInvalidValue otherwise.
extern "C" int sfast_flash_attention_int8(const void* q8, const void* k8, const void* vt,
                                          const void* corr, const void* sqk, const void* sv,
                                          const void* vm, void* o, int batch, int heads,
                                          int sq, int sk, int d, long long o_sb,
                                          long long o_sh, long long o_ss, int causal,
                                          void* stream) {
  if (d % 8 != 0 || d <= 0 || d > 160 || sk <= 0 || sq <= 0) return cudaErrorInvalidValue;
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.o_sb = o_sb;
  p.o_sh = o_sh;
  p.o_ss = o_ss;
  p.sqk = static_cast<const float*>(sqk);
  p.sv = static_cast<const float*>(sv);
  p.vm = static_cast<const float*>(vm);
  p.heads = heads;
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.causal = causal;
  const int skp = (sk + 15) / 16 * 16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 32) return launch<32, 3>(q8, k8, vt, corr, p, batch, skp, st);
  if (d <= 48) return launch<48, 3>(q8, k8, vt, corr, p, batch, skp, st);
  if (d <= 64) return launch<64, 3>(q8, k8, vt, corr, p, batch, skp, st);
  if (d <= 96) return launch<96, 2>(q8, k8, vt, corr, p, batch, skp, st);
  if (d <= 128) return launch<128, 2>(q8, k8, vt, corr, p, batch, skp, st);
  return launch<160, 2>(q8, k8, vt, corr, p, batch, skp, st);
}
