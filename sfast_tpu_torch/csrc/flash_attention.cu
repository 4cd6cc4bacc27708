// K1: forward flash attention over (B, H, S, D) bf16, f32 softmax state.
//
// Replaces the Pallas kernel sfast_tpu/ops/flash_attention.py::_flash_kernel
// (entry point flash_attention).  On the main path it runs the SD1.5 UNet's
// level-0 self-attention: (2, 8, 4096, 40) bf16, non-causal.
//
// What bounds it on the H100: the two matrix products, 4·S²·D flops per
// (b, h) — 42.9 GFLOP, 43 µs at the bf16 peak, per main-path call — and at
// d = 40 the exponentials: one per 160 flops, S² per (b, h), against 16
// exp2 per clock per SM, about 64 µs.  q, k, v and o are 21 MB (6 µs).
//
// Design (FlashAttention-3's shape, without its ping-pong scheduling):
// - One block per (b·h, 64·NWG q rows): NWG consumer warpgroups of 64 rows
//   each (3 at d <= 64, 2 above, where the accumulators need the
//   registers) and a producer warpgroup whose one thread issues the TMA
//   loads and gives its registers to the consumers (setmaxnreg).  A loop
//   over kv tiles (128 rows; 64 at d > 128) replaces the TPU's sequential
//   kv grid axis, so m, l and the output accumulator stay in registers.
// - q, k and v are 4-D tensor maps (d, S, H, B) over the caller's
//   strides, so the head-split views of (B, S, H·D) projections need no
//   copy.  A box is 64 columns wide and lands 128-byte swizzled, one wgmma
//   atom.  Columns past d and rows past S lie outside the map and arrive
//   as zeros: at d = 40 the 48-deep q·kᵀ reads zeros for its last 8
//   columns, never the next head's, and a ragged kv tail is zeros too.
// - q loads once; k and v go through a ring of 3 stages (2 above d = 64)
//   on mbarriers, with barriers of their own, so q·kᵀ starts when k lands.
// - S = q·kᵀ by wgmma m64nBKVk16, both operands K-major from shared memory.
//   p·v by wgmma with A = p in registers (the S accumulator's bf16 pairs
//   are wgmma's register A layout) and B = v as it lies, MN-major (tnspB),
//   N = the head dim padded to 64, 80, 128 or 160 — and at d <= 40,
//   N = 48: v then loads as five unswizzled 8-column boxes and a sixth
//   chunk, written once, holds 1.0 in its first column, so p·v's column 40
//   is l, the sum of the bf16-rounded p, accumulated by the tensor cores.
//   That takes the row sum (two integer and one float instruction per
//   score) off the softmax, whose instruction issue bounds this kernel.
// - Per tile, tile i's q·kᵀ and tile i-1's p·v are issued together; the
//   softmax of tile i runs while p·v is in flight.
// - exp2 on MUFU as ex2.approx.ftz (the non-ftz exp2f adds a denormal
//   range fix around every exponential and more than doubled the kernel's
//   time).  FlashAttention-4's offload of a share of the exponentials to a
//   polynomial on the FMA pipe made this kernel slower at every share
//   measured on the H100 (PERF.md): the softmax is bound by instruction
//   issue, not by the MUFU rate, so every exponential stays on MUFU.
// - Kept from the mma.sync kernel: scale·log2(e) applied in the one FFMA
//   before each exponential (the row max is taken on raw scores, so the
//   scale must be positive; the wrapper checks); p rounded to bf16 for p·v
//   and l summing those rounded values; a row masked everywhere gets p = 0
//   and no NaN; ragged kv and causal masking; no atomics, so two calls
//   agree bit for bit.

#include "sm90.cuh"

namespace {

namespace s9 = sfast::sm90;

constexpr int ATOM_ROW = 128;  // bytes of one row of a 64-column swizzle atom
// consumer warpgroups at d <= 64: 3 measured faster than 2 (PERF.md)
constexpr int NWG_SMALL = 3;

struct Params {
  __nv_bfloat16* o;
  long long o_sb, o_sh, o_ss;
  int heads, sq, sk, d;
  float scale_log2e;
  int causal;
};

// DP: the padded head dim; NWG: consumer warpgroups of 64 q rows each
template <int DP, int NWG>
struct Cfg {
  static constexpr int BQ = 64 * NWG;               // q rows per block
  static constexpr int THREADS = 128 * (NWG + 1);   // + the producer warpgroup
  // registers each consumer thread may take once the producer gives up its own
  static constexpr int CONSUMER_REGS = NWG == 2 ? 240 : 160;
  static constexpr int BKV = DP > 128 ? 64 : 128;   // kv rows per tile
  static constexpr int NA = (DP + 63) / 64;         // 64-column atoms per row
  static constexpr int KQ = (DP + 15) / 16 * 16;    // q·kᵀ's reduction depth
  static constexpr int ST = NA == 1 ? 3 : 2;        // kv ring stages
  // At DP = 40, v sits unswizzled as [8-column chunk][kv row][8] with a
  // sixth chunk that holds 1.0 in its first column: p·v's column 40 is then
  // l, the sum of the bf16 p, accumulated by the tensor cores.
  static constexpr bool ONES = DP == 40;
  static constexpr int NPV = ONES ? 48 : DP;  // p·v's N
  static constexpr int V_CHUNK = BKV * 16;    // bytes of one 8-column chunk of v
  static constexpr int Q_ATOM = BQ * ATOM_ROW;
  static constexpr int KV_ATOM = BKV * ATOM_ROW;
  static constexpr int Q_BYTES = NA * Q_ATOM;
  static constexpr int K_BYTES = NA * KV_ATOM;
  static constexpr int V_BYTES = ONES ? 6 * V_CHUNK : NA * KV_ATOM;
  static constexpr int V_LOAD = ONES ? 5 * V_CHUNK : V_BYTES;  // bytes TMA writes
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + ST * K_BYTES;
  static constexpr int OFF_BAR = OFF_V + ST * V_BYTES;
  static constexpr int SMEM = OFF_BAR + (1 + 4 * ST) * 8 + 1024;  // + alignment slack
};

template <int BKV>
__device__ __forceinline__ void wgmma_qk(float* s, uint64_t a, uint64_t b, int acc);
template <>
__device__ __forceinline__ void wgmma_qk<64>(float* s, uint64_t a, uint64_t b, int acc) {
  s9::wgmma_m64n64k16_ss(s, a, b, acc);
}
template <>
__device__ __forceinline__ void wgmma_qk<128>(float* s, uint64_t a, uint64_t b, int acc) {
  s9::wgmma_m64n128k16_ss(s, a, b, acc);
}

template <int DP>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a, uint64_t b);
template <>
__device__ __forceinline__ void wgmma_pv<48>(float* o, const uint32_t* a, uint64_t b) {
  s9::wgmma_m64n48k16_rs(o, a, b);
}
template <>
__device__ __forceinline__ void wgmma_pv<64>(float* o, const uint32_t* a, uint64_t b) {
  s9::wgmma_m64n64k16_rs(o, a, b);
}
template <>
__device__ __forceinline__ void wgmma_pv<80>(float* o, const uint32_t* a, uint64_t b) {
  s9::wgmma_m64n80k16_rs(o, a, b);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float* o, const uint32_t* a, uint64_t b) {
  s9::wgmma_m64n128k16_rs(o, a, b);
}
template <>
__device__ __forceinline__ void wgmma_pv<160>(float* o, const uint32_t* a, uint64_t b) {
  s9::wgmma_m64n160k16_rs(o, a, b);
}

// 2^x on MUFU, flushing results below 2^-126 to 0
__device__ __forceinline__ float exp2_mufu(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Online softmax of one score tile in place: s becomes exp2((s - m)·scale),
// unrounded; m moves to the new running max and alpha is the factor that
// carries the old sums over.  row_a, row_b: this thread's two q rows.
template <int NT>
__device__ __forceinline__ void softmax_tile(float (&s)[NT * 4], float (&m)[2],
                                             float (&alpha)[2], const Params& p, int k0,
                                             int t, int row_a, int row_b) {
  if (p.causal || k0 + NT * 8 > p.sk) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const int row = (e < 2) ? row_a : row_b;
        if (col >= p.sk || (p.causal && col > row)) s[4 * j + e] = -INFINITY;
      }
  }
  // four independent partial maxima per row, then a tree
  float mx[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u) mx[r][u] = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    mx[0][j % 4] = fmaxf(mx[0][j % 4], fmaxf(s[4 * j + 0], s[4 * j + 1]));
    mx[1][j % 4] = fmaxf(mx[1][j % 4], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float base[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float tmax = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffff, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffff, tmax, 2));
    const float m_new = fmaxf(m[r], tmax);
    // a row masked everywhere so far keeps m = -inf; exp2 against 0 then
    // gives p = 0 and alpha = 0 instead of NaN
    base[r] = (m_new == -INFINITY) ? 0.f : m_new * p.scale_log2e;
    alpha[r] = exp2_mufu(m[r] * p.scale_log2e - base[r]);
    m[r] = m_new;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[4 * j + e] = exp2_mufu(fmaf(s[4 * j + e], p.scale_log2e, -base[e >> 1]));
}

// p rounded to bf16 as the A registers of p·v; l sums the rounded values
// (unless p·v computes it: ONES)
template <int NT, bool ONES>
__device__ __forceinline__ void pack_p(const float (&s)[NT * 4], uint32_t (&pa)[NT / 2][4],
                                       float (&l)[2], const float (&alpha)[2]) {
  float rs[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const uint32_t lo = pack_bf16(s[4 * j + 0], s[4 * j + 1]);
    const uint32_t hi = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
    if constexpr (!ONES) {
      rs[0][j % 4] += __uint_as_float(lo << 16) + __uint_as_float(lo & 0xffff0000u);
      rs[1][j % 4] += __uint_as_float(hi << 16) + __uint_as_float(hi & 0xffff0000u);
    }
    pa[j / 2][(j & 1) * 2 + 0] = lo;
    pa[j / 2][(j & 1) * 2 + 1] = hi;
  }
  if constexpr (!ONES) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float rsum = (rs[r][0] + rs[r][1]) + (rs[r][2] + rs[r][3]);
      rsum += __shfl_xor_sync(0xffffffff, rsum, 1);
      rsum += __shfl_xor_sync(0xffffffff, rsum, 2);
      l[r] = l[r] * alpha[r] + rsum;
    }
  }
}

template <int DP, int NWG>
__global__ void __launch_bounds__(Cfg<DP, NWG>::THREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, const Params p) {
  using C = Cfg<DP, NWG>;
  constexpr int BKV = C::BKV, NT = BKV / 8, CONSUMERS = 128 * NWG;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = smem;
  unsigned char* ks = smem + C::OFF_K;
  unsigned char* vs = smem + C::OFF_V;
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
  if (C::ONES) {  // the sixth v chunk of every stage: 1.0, then zeros, per row
    for (int r = threadIdx.x; r < C::ST * BKV; r += C::THREADS)
      *reinterpret_cast<uint4*>(vs + (r / BKV) * C::V_BYTES + 5 * C::V_CHUNK + (r % BKV) * 16) =
          make_uint4(0x3f80u, 0u, 0u, 0u);
    s9::fence_proxy_async();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // producer warpgroup
    s9::setmaxnreg_dec<24>();
    if (threadIdx.x == CONSUMERS) {
      s9::prefetch_tensormap(&qmap);
      s9::prefetch_tensormap(&kmap);
      s9::prefetch_tensormap(&vmap);
      s9::mbar_expect_tx(q_full, C::Q_BYTES);
      for (int a = 0; a < C::NA; ++a)
        s9::tma_load_4d(qs + a * C::Q_ATOM, &qmap, q_full, 64 * a, q0, h, b);
      for (int i = 0; i < ntiles; ++i) {
        const int st = i % C::ST;
        const uint32_t ph = ((i / C::ST) & 1) ^ 1;
        s9::mbar_wait(&k_empty[st], ph);
        s9::mbar_expect_tx(&k_full[st], C::K_BYTES);
        for (int a = 0; a < C::NA; ++a)
          s9::tma_load_4d(ks + st * C::K_BYTES + a * C::KV_ATOM, &kmap, &k_full[st], 64 * a,
                          i * BKV, h, b);
        s9::mbar_wait(&v_empty[st], ph);
        s9::mbar_expect_tx(&v_full[st], C::V_LOAD);
        if (C::ONES) {
          for (int c = 0; c < 5; ++c)
            s9::tma_load_4d(vs + st * C::V_BYTES + c * C::V_CHUNK, &vmap, &v_full[st], 8 * c,
                            i * BKV, h, b);
        } else {
          for (int a = 0; a < C::NA; ++a)
            s9::tma_load_4d(vs + st * C::V_BYTES + a * C::KV_ATOM, &vmap, &v_full[st], 64 * a,
                            i * BKV, h, b);
        }
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

  float o[C::NPV / 2];
#pragma unroll
  for (int i = 0; i < C::NPV / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float alpha[2];
  float s[NT * 4];
  uint32_t pa[NT / 2][4];

  const uint32_t q_base = sfast::smem_addr(qs) + wg * 64 * ATOM_ROW;
  // S = q·kᵀ for the tile in stage st, issued and committed, not awaited
  auto issue_qk = [&](int st) {
    const uint32_t k_base = sfast::smem_addr(ks + st * C::K_BYTES);
    s9::fence_regs<NT * 4>(s);
    s9::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::KQ / 16; ++kk) {
      const int off = (kk % 4) * 32;  // 16 columns of a 128-byte swizzled row
      wgmma_qk<BKV>(s, s9::make_desc(q_base + (kk / 4) * C::Q_ATOM + off, 16, 1024, 1),
                    s9::make_desc(k_base + (kk / 4) * C::KV_ATOM + off, 16, 1024, 1), kk > 0);
    }
    s9::wgmma_commit();
  };
  // o += p·v for the tile in stage st, issued and committed, not awaited
  auto issue_pv = [&](int st) {
    const uint32_t v_base = sfast::smem_addr(vs + st * C::V_BYTES);
    s9::fence_regs<C::NPV / 2>(o);
    s9::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      // 16 kv rows: unswizzled, LBO 8 rows, SBO one chunk; swizzled, 2048
      // bytes of 128-byte rows, LBO one 64-column atom
      const uint64_t dv = C::ONES ? s9::make_desc(v_base + kk * 256, 128, C::V_CHUNK, 0)
                                  : s9::make_desc(v_base + kk * 2048, C::KV_ATOM, 1024, 1);
      wgmma_pv<C::NPV>(o, pa[kk], dv);
    }
    s9::wgmma_commit();
  };

  s9::mbar_wait(q_full, 0);
  s9::mbar_wait(&k_full[0], 0);
  issue_qk(0);
  s9::wgmma_wait<0>();
  s9::fence_regs<NT * 4>(s);
  if (wtid == 0) s9::mbar_arrive(&k_empty[0]);
  softmax_tile<NT>(s, m, alpha, p, 0, t, row_a, row_b);
  pack_p<NT, C::ONES>(s, pa, l, alpha);

  // tile i's q·kᵀ and tile i-1's p·v run while tile i's softmax waits for
  // the first, then runs under the second
  for (int i = 1; i < ntiles; ++i) {
    const int st = i % C::ST, pst = (i - 1) % C::ST;
    s9::mbar_wait(&k_full[st], (i / C::ST) & 1);
    issue_qk(st);
    s9::mbar_wait(&v_full[pst], ((i - 1) / C::ST) & 1);
    issue_pv(pst);
    s9::wgmma_wait<1>();
    s9::fence_regs<NT * 4>(s);
    if (wtid == 0) s9::mbar_arrive(&k_empty[st]);
    softmax_tile<NT>(s, m, alpha, p, i * BKV, t, row_a, row_b);
    s9::wgmma_wait<0>();
    s9::fence_regs<C::NPV / 2>(o);
    s9::fence_regs<NT * 2>(&pa[0][0]);
    if (wtid == 0) s9::mbar_arrive(&v_empty[pst]);
#pragma unroll
    for (int n = 0; n < C::NPV / 8; ++n) {
      o[4 * n + 0] *= alpha[0];
      o[4 * n + 1] *= alpha[0];
      o[4 * n + 2] *= alpha[1];
      o[4 * n + 3] *= alpha[1];
    }
    pack_p<NT, C::ONES>(s, pa, l, alpha);
  }
  const int lst = (ntiles - 1) % C::ST;
  s9::mbar_wait(&v_full[lst], ((ntiles - 1) / C::ST) & 1);
  issue_pv(lst);
  s9::wgmma_wait<0>();
  s9::fence_regs<C::NPV / 2>(o);
  s9::fence_regs<NT * 2>(&pa[0][0]);
  if (wtid == 0) s9::mbar_arrive(&v_empty[lst]);

  if (C::ONES) {  // column 40 of p·v, held by the lanes with t = 0
    l[0] = __shfl_sync(0xffffffff, o[20], lane & ~3);
    l[1] = __shfl_sync(0xffffffff, o[22], lane & ~3);
  }
  const float inv_a = l[0] > 0.f ? 1.f / l[0] : 0.f;
  const float inv_b = l[1] > 0.f ? 1.f / l[1] : 0.f;
  __nv_bfloat16* op = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = n * 8 + 2 * t;  // even; d % 8 == 0
    if (col >= p.d) continue;
    if (row_a < p.sq)
      *reinterpret_cast<__nv_bfloat162*>(op + row_a * p.o_ss + col) =
          __floats2bfloat162_rn(o[4 * n + 0] * inv_a, o[4 * n + 1] * inv_a);
    if (row_b < p.sq)
      *reinterpret_cast<__nv_bfloat162*>(op + row_b * p.o_ss + col) =
          __floats2bfloat162_rn(o[4 * n + 2] * inv_b, o[4 * n + 3] * inv_b);
  }
}

// (B, H, S, d) with strides in elements as the 4-D map (d, S, H, B), one
// box of 8 columns x 128 rows
bool encode_qkv(CUtensorMap* map, const void* ptr, int batch, int heads, int s, int d,
                long long sb, long long sh, long long ss, int box_rows, bool swizzle) {
  const uint64_t dims[4] = {static_cast<uint64_t>(d), static_cast<uint64_t>(s),
                            static_cast<uint64_t>(heads), static_cast<uint64_t>(batch)};
  const uint64_t strides[3] = {2ull * ss, 2ull * sh, 2ull * sb};
  const uint32_t box[4] = {swizzle ? 64u : 8u, static_cast<uint32_t>(box_rows), 1, 1};
  return s9::encode_tensor_map(map, ptr, 4, dims, strides, box,
                               swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <int DP, int NWG>
cudaError_t launch(const void* q, const void* k, const void* v, const long long* qs,
                   const long long* ks, const long long* vs, const Params& p, int batch,
                   cudaStream_t stream) {
  using C = Cfg<DP, NWG>;
  CUtensorMap qm, km, vm;
  if (!encode_qkv(&qm, q, batch, p.heads, p.sq, p.d, qs[0], qs[1], qs[2], C::BQ, true) ||
      !encode_qkv(&km, k, batch, p.heads, p.sk, p.d, ks[0], ks[1], ks[2], C::BKV, true) ||
      !encode_qkv(&vm, v, batch, p.heads, p.sk, p.d, vs[0], vs[1], vs[2], C::BKV, !C::ONES))
    return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(  // once per instantiation
      flash_fwd_kernel<DP, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.sq + C::BQ - 1) / C::BQ, batch * p.heads);
  flash_fwd_kernel<DP, NWG><<<grid, C::THREADS, C::SMEM, stream>>>(qm, km, vm, p);
  return cudaGetLastError();
}

}  // namespace

// Head dims that are multiples of 8 up to 160 (SD1.5: 40, 80, 160; SDXL and
// SD2: 64), padded to the next of 40, 64, 80, 128, 160 inside the kernel;
// strides in elements, the d stride 1 and the others multiples of 8 (the
// wrapper checks).  Returns cudaErrorInvalidValue for anything else.
extern "C" int sfast_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, int batch, int heads, int sq,
    int sk, int d, long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss, float scale_log2e, int causal,
    void* stream) {
  if (d % 8 != 0 || d <= 0 || d > 160) return cudaErrorInvalidValue;
  const long long qs[3] = {q_sb, q_sh, q_ss}, ks[3] = {k_sb, k_sh, k_ss},
                  vs[3] = {v_sb, v_sh, v_ss};
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.o_sb = o_sb;
  p.o_sh = o_sh;
  p.o_ss = o_ss;
  p.heads = heads;
  p.sq = sq;
  p.sk = sk;
  p.d = d;
  p.scale_log2e = scale_log2e;
  p.causal = causal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 40) return launch<40, NWG_SMALL>(q, k, v, qs, ks, vs, p, batch, st);
  if (d <= 64) return launch<64, NWG_SMALL>(q, k, v, qs, ks, vs, p, batch, st);
  if (d <= 80) return launch<80, 2>(q, k, v, qs, ks, vs, p, batch, st);
  if (d <= 128) return launch<128, 2>(q, k, v, qs, ks, vs, p, batch, st);
  return launch<160, 2>(q, k, v, qs, ks, vs, p, batch, st);
}
