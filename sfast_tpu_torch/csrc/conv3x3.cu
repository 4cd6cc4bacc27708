// K2: fused GroupNorm+SiLU -> 3x3 conv (stride 1, SAME) over NHWC bf16,
// with a bias / residual / 1/output_scale epilogue and optional per-(n, f)
// sums of y and y^2 for the next GroupNorm.
//
// Replaces the Pallas kernel sfast_tpu/ops/conv_pallas.py::_conv3x3_kernel
// (entry points conv3x3_block, conv3x3_gn_silu).  On the main path it runs
// the SD VAE decoder's resnet convs and upsample convs at 128^2..512^2,
// e.g. 128^2 x 512 -> 512 (2 x 16384 x 4608 x 512 = 77.3 GFLOP).
//
// What bounds it on the H100: the matrix product, about 9·C flops per byte
// of input, far above the card's 295 flops per byte: tensor-core issue,
// which only wgmma reaches, and feeding it from shared memory.
//
// Design: an implicit GEMM with M = output pixels, N = F, K = 9·C, on
// wgmma (m64nBNk16, bf16 in, f32 accumulate) fed by TMA.
// - A block owns a 16 x 8 patch of output pixels (M = 128) and BN output
//   channels, 256 where F is a multiple of 256 (each halo element then
//   feeds twice the products, and GroupNorm costs half as much per flop),
//   else 128; two consumer warpgroups each own 8 rows of the patch (m64)
//   and a producer warpgroup issues the TMA loads.
// - Input by TMA as a halo tile: per 64-channel slice, eight 4-D boxes
//   (8 channels, 10 columns, 18 rows, 1 image) land in shared memory as
//   [channel chunk][halo pixel][8 channels].  Pixels outside the image
//   arrive as zeros, so SAME padding costs no instruction, and every input
//   element arrives once per (patch, slice), not once per tap.
// - The nine taps are nine shifted A operands of that one halo tile: with a
//   patch 8 pixels wide, eight consecutive output pixels (one wgmma core
//   matrix) are eight consecutive halo pixels, 16 bytes apart, so the
//   no-swizzle K-major descriptor takes LBO = one channel chunk and
//   SBO = one halo row (160 bytes), and tap (dy, dx) moves only its start
//   address, by (10·dy + dx)·16 bytes.  (Building A in registers from
//   shared memory was the other way; it costs ld.shared per tap and was
//   not taken.)
// - Weights by TMA: the (F, 3, 3, C) OHWI matrix the modules already hand
//   over is a 3-D map (C, 9, F); a (64, 1, BN) box per (slice, tap) lands
//   128-byte swizzled, the B operand of a K-major descriptor.  Channels
//   past C and rows past F arrive as zeros.
// - Rings on mbarriers: 3 halo stages and 4 weight stages; one producer
//   thread loads weights, another halos, so neither ring waits on the
//   other.
// - GroupNorm+SiLU once per halo element, in shared memory: while the
//   wgmmas of slice s run, the consumers apply scale, shift and SiLU to
//   the halo of slice s + 1 (a sixth of it after each of the first six
//   taps), set positions outside the image back to 0 — TMA's zeros are
//   pre-GN and silu(shift) != 0; conv_pallas.py:164-173 pads after the
//   GN — then fence.proxy.async and a named barrier before its wgmmas.
//   That is 180/128 = 1.4 passes per input element instead of 9.
// - Epilogue in f32 from the accumulator registers: + bias[n, f] (conv
//   bias + temb, staged in shared memory at the start), + residual (loads
//   issued in groups before their stores, so their latencies overlap),
//   x 1/output_scale, store bf16.  With stats,
//   per-column sums over valid pixels are reduced by shuffles and across
//   the eight consumer warps in shared memory in a fixed order, and each
//   block writes its own partial row of an (2, N, patches, F) f32 buffer
//   that the caller sums in a fixed order: no atomics, so the result is
//   the same on every run.
// - One block per SM (146 KB of shared memory at BN = 128, 217 KB at
//   256); the producer warpgroup drops to 40 registers so that the
//   consumers can hold BN/2 accumulators each in 232.  (A 32 x 8 patch at
//   BN = 128, 128 accumulators as at 256, measured no faster at 512²·128
//   -> 128, so the patch stays 16 x 8.)
// Requires C % 8 == 0 and F % 8 == 0 (the wrapper checks): TMA strides
// are multiples of 16 bytes and an 8-channel chunk is in or out whole.

#include "sm90.cuh"

namespace {

namespace s9 = sfast::sm90;

constexpr int TH = 16, TW = 8;                 // output patch (rows, cols)
constexpr int HH = TH + 2, HW = TW + 2;        // halo patch
constexpr int HALO_PIX = HH * HW;              // 180
constexpr int KC = 64;                         // channels per slice
constexpr int CHUNKS = KC / 8;                 // 8-channel chunks per slice
constexpr int CHUNK_BOX = HALO_PIX * 16;       // 2880 bytes a TMA box writes
constexpr int CHUNK_BYTES = 2944;              // padded to 128 bytes
constexpr int HALO_BYTES = CHUNKS * CHUNK_BYTES;
constexpr int WST = 4, HST = 3;                // ring stages
constexpr int THREADS = 384;                   // 2 consumer + 1 producer warpgroups
constexpr int CONSUMERS = 256;
constexpr int GN_VECS = CHUNKS * HALO_PIX;     // 16-byte vectors per halo
constexpr int GN_STEPS = (GN_VECS + CONSUMERS - 1) / CONSUMERS;  // 6 (<= 9 taps)

// BN output channels per block: 256 where F is a multiple of 256, else 128
template <int BN>
struct Cfg {
  static constexpr int W_BYTES = BN * KC * 2;  // one (slice, tap) weight tile
  static constexpr int OFF_W = 0;
  static constexpr int OFF_HALO = OFF_W + WST * W_BYTES;
  static constexpr int OFF_RED = OFF_HALO + HST * HALO_BYTES;
  static constexpr int OFF_BIAS = OFF_RED + 8 * 2 * BN * 4;
  static constexpr int OFF_BAR = OFF_BIAS + BN * 4;
  static constexpr int SMEM = OFF_BAR + 2 * (WST + HST) * 8 + 1024;  // + alignment slack
};

template <int BN>
__device__ __forceinline__ void wgmma_tap(float* acc, uint64_t a, uint64_t b);
template <>
__device__ __forceinline__ void wgmma_tap<128>(float* acc, uint64_t a, uint64_t b) {
  sfast::sm90::wgmma_m64n128k16_ss(acc, a, b);
}
template <>
__device__ __forceinline__ void wgmma_tap<256>(float* acc, uint64_t a, uint64_t b) {
  sfast::sm90::wgmma_m64n256k16_ss(acc, a, b);
}

struct Params {
  const float* bias;      // (N, F)
  const float* gn_scale;  // (N, C) or null
  const float* gn_shift;  // (N, C) or null
  const __nv_bfloat16* residual;  // (N, H, W, F) or null
  __nv_bfloat16* out;             // (N, H, W, F)
  float* stats;                   // (2, N, patches, F) partials, or null
  int n, h, wd, c, f;
  float inv_scale;
};

// scale, shift and SiLU on one 16-byte vector of the halo of slice `slice`
// in place; out-of-image pixels and channels past C become 0
__device__ __forceinline__ void gn_silu_vec(unsigned char* halo, int v, int slice, int y0,
                                            int x0, int n, const Params& p) {
  const int chunk = v / HALO_PIX, pix = v - chunk * HALO_PIX;
  const int hy = pix / HW, hx = pix - hy * HW;
  const int c = slice * KC + chunk * 8;
  const int iy = y0 - 1 + hy, ix = x0 - 1 + hx;
  uint4* ptr = reinterpret_cast<uint4*>(halo + chunk * CHUNK_BYTES + pix * 16);
  uint4 val = make_uint4(0, 0, 0, 0);
  if (c < p.c && iy >= 0 && iy < p.h && ix >= 0 && ix < p.wd) {
    val = *ptr;
    const float4* sc = reinterpret_cast<const float4*>(p.gn_scale + n * p.c + c);
    const float4* sh = reinterpret_cast<const float4*>(p.gn_shift + n * p.c + c);
    const float4 sc0 = sc[0], sc1 = sc[1], sh0 = sh[0], sh1 = sh[1];
    const float s[8] = {sc0.x, sc0.y, sc0.z, sc0.w, sc1.x, sc1.y, sc1.z, sc1.w};
    const float b[8] = {sh0.x, sh0.y, sh0.z, sh0.w, sh1.x, sh1.y, sh1.z, sh1.w};
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float2 xf = __bfloat1622float2(e[j]);
      xf.x = xf.x * s[2 * j] + b[2 * j];
      xf.y = xf.y * s[2 * j + 1] + b[2 * j + 1];
      xf.x = __fdividef(xf.x, 1.f + __expf(-xf.x));
      xf.y = __fdividef(xf.y, 1.f + __expf(-xf.y));
      e[j] = __floats2bfloat162_rn(xf.x, xf.y);
    }
  }
  *ptr = val;
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    conv3x3_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap, const Params p) {
  using Cf = Cfg<BN>;
  constexpr int W_BYTES = Cf::W_BYTES, NACC = BN / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* wbuf = smem + Cf::OFF_W;
  unsigned char* hbuf = smem + Cf::OFF_HALO;
  float* red = reinterpret_cast<float*>(smem + Cf::OFF_RED);  // [8 warps][Σy, Σy²][BN]
  float* bias_s = reinterpret_cast<float*>(smem + Cf::OFF_BIAS);  // bias[n, f0 + c]
  uint64_t* w_full = reinterpret_cast<uint64_t*>(smem + Cf::OFF_BAR);
  uint64_t* w_empty = w_full + WST;
  uint64_t* h_full = w_empty + WST;
  uint64_t* h_empty = h_full + HST;

  const int tiles_x = (p.wd + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_x) * TH;
  const int x0 = (blockIdx.x % tiles_x) * TW;
  const int f0 = blockIdx.y * BN;
  const int n = blockIdx.z;
  const int nslices = (p.c + KC - 1) / KC;
  const bool gn = p.gn_scale != nullptr;

  if (threadIdx.x == 0) {
    for (int i = 0; i < WST; ++i) {
      s9::mbar_init(&w_full[i], 1);
      s9::mbar_init(&w_empty[i], 2);  // one arrival per consumer warpgroup
    }
    for (int i = 0; i < HST; ++i) {
      s9::mbar_init(&h_full[i], 1);
      s9::mbar_init(&h_empty[i], 2);
    }
    s9::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // producer warpgroup: lane 0 of its first warp loads weights, lane 0
    // of its second warp loads halos; its registers go to the consumers
    s9::setmaxnreg_dec<40>();
    const int warp = (threadIdx.x - CONSUMERS) / 32, lane = threadIdx.x % 32;
    if (warp == 0 && lane == 0) {
      s9::prefetch_tensormap(&wmap);
      int st = 0;
      uint32_t ph = 0;
      for (int s = 0; s < nslices; ++s) {
        for (int tap = 0; tap < 9; ++tap) {
          s9::mbar_wait(&w_empty[st], ph ^ 1);
          s9::mbar_expect_tx(&w_full[st], W_BYTES);
          s9::tma_load_3d(wbuf + st * W_BYTES, &wmap, &w_full[st], s * KC, tap, f0);
          if (++st == WST) {
            st = 0;
            ph ^= 1;
          }
        }
      }
    } else if (warp == 1 && lane == 0) {
      s9::prefetch_tensormap(&xmap);
      for (int s = 0; s < nslices; ++s) {
        const int hs = s % HST;
        s9::mbar_wait(&h_empty[hs], ((s / HST) & 1) ^ 1);
        s9::mbar_expect_tx(&h_full[hs], CHUNKS * CHUNK_BOX);
        for (int j = 0; j < CHUNKS; ++j)
          s9::tma_load_4d(hbuf + hs * HALO_BYTES + j * CHUNK_BYTES, &xmap, &h_full[hs],
                          s * KC + 8 * j, x0 - 1, y0 - 1, n);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns patch rows [8·wg, 8·wg + 8)
  s9::setmaxnreg_inc<232>();
  const int wg = threadIdx.x / 128;
  const int wtid = threadIdx.x % 128;
  const int warp = wtid / 32, lane = wtid % 32;
  const int g = lane >> 2, t = lane & 3;

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  // the epilogue's bias, read once here, where its latency hides
  for (int c = threadIdx.x; c < BN; c += CONSUMERS)
    bias_s[c] = f0 + c < p.f ? p.bias[n * p.f + f0 + c] : 0.f;

  if (gn) {  // the first slice's halo, before any wgmma
    s9::mbar_wait(&h_full[0], 0);
    for (int i = 0; i < GN_STEPS; ++i) {
      const int v = threadIdx.x + i * CONSUMERS;
      if (v < GN_VECS) gn_silu_vec(hbuf, v, 0, y0, x0, n, p);
    }
    s9::fence_proxy_async();
    s9::named_barrier_sync(1, CONSUMERS);
  }

  int st = 0, prev = 0;
  uint32_t ph = 0;
  for (int s = 0; s < nslices; ++s) {
    const int hs = s % HST;
    unsigned char* halo = hbuf + hs * HALO_BYTES;
    if (!gn) s9::mbar_wait(&h_full[hs], (s / HST) & 1);
    const int s1 = s + 1;
    const bool gn_next = gn && s1 < nslices;
    unsigned char* halo1 = hbuf + (s1 % HST) * HALO_BYTES;
    const uint32_t a0 = sfast::smem_addr(halo) + (wg * 8 * HW) * 16;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      s9::mbar_wait(&w_full[st], ph);
      const int dy = tap / 3, dx = tap - dy * 3;
      const uint32_t a_tap = a0 + (dy * HW + dx) * 16;
      const uint32_t b_tap = sfast::smem_addr(wbuf + st * W_BYTES);
      s9::fence_regs<NACC>(acc);
      s9::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        const uint64_t da = s9::make_desc(a_tap + 2 * kk * CHUNK_BYTES, CHUNK_BYTES, HW * 16, 0);
        const uint64_t db = s9::make_desc(b_tap + kk * 32, 16, 1024, 1);
        wgmma_tap<BN>(acc, da, db);
      }
      s9::wgmma_commit();
      if (gn_next && tap < GN_STEPS) {  // next slice's GN under this tap's wgmmas
        if (tap == 0) s9::mbar_wait(&h_full[s1 % HST], (s1 / HST) & 1);
        const int v = threadIdx.x + tap * CONSUMERS;
        if (v < GN_VECS) gn_silu_vec(halo1, v, s1, y0, x0, n, p);
      }
      s9::wgmma_wait<1>();
      s9::fence_regs<NACC>(acc);
      if (tap > 0 && wtid == 0) s9::mbar_arrive(&w_empty[prev]);  // tap - 1 is done
      prev = st;
      if (++st == WST) {
        st = 0;
        ph ^= 1;
      }
    }
    s9::wgmma_wait<0>();
    s9::fence_regs<NACC>(acc);
    if (wtid == 0) {
      s9::mbar_arrive(&w_empty[prev]);
      s9::mbar_arrive(&h_empty[hs]);
    }
    if (gn_next) {
      s9::fence_proxy_async();
      s9::named_barrier_sync(1, CONSUMERS);
    }
  }

  // epilogue: this thread's rows are patch rows 8·wg + 2·warp + half,
  // column g; its columns f0 + 8j + 2t + e.  Column sums of this warp's
  // 16 rows are reduced over g by shuffles as each 8-column block is done.
  const int hw = p.h * p.wd;
  const int cw = wg * 4 + warp;  // consumer warp 0..7
  const bool stats = p.stats != nullptr;
  bool row_ok[2];
  long long row[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int oy = y0 + wg * 8 + 2 * warp + half, ox = x0 + g;
    row_ok[half] = oy < p.h && ox < p.wd;
    row[half] = static_cast<long long>(n) * hw + oy * p.wd + ox;
  }
  s9::named_barrier_sync(2, CONSUMERS);  // bias_s is written
  // columns in groups of JG 8-column blocks: the group's residual loads are
  // issued together, before any of its stores, so their latencies overlap
  constexpr int JG = 8;
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += JG) {
    uint32_t res[JG][2];
#pragma unroll
    for (int jj = 0; jj < JG; ++jj)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int fc = f0 + (j0 + jj) * 8 + 2 * t;
        res[jj][half] = p.residual != nullptr && row_ok[half] && fc < p.f
                            ? *reinterpret_cast<const uint32_t*>(p.residual + row[half] * p.f + fc)
                            : 0u;
      }
#pragma unroll
    for (int jj = 0; jj < JG; ++jj) {
      const int j = j0 + jj;
      const int fc = f0 + j * 8 + 2 * t;  // even; F % 8 == 0
      float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // [Σy, Σy²][column e]
      if (fc < p.f) {
        const float b0 = bias_s[j * 8 + 2 * t], b1 = bias_s[j * 8 + 2 * t + 1];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (!row_ok[half]) continue;
          // bf16 residual pair to f32: the low half is the first column
          const float y0v =
              (acc[4 * j + 2 * half] + b0 + __uint_as_float(res[jj][half] << 16)) * p.inv_scale;
          const float y1v = (acc[4 * j + 2 * half + 1] + b1 +
                             __uint_as_float(res[jj][half] & 0xffff0000u)) *
                            p.inv_scale;
          *reinterpret_cast<__nv_bfloat162*>(p.out + row[half] * p.f + fc) =
              __floats2bfloat162_rn(y0v, y1v);
          sum[0][0] += y0v;
          sum[0][1] += y1v;
          sum[1][0] += y0v * y0v;
          sum[1][1] += y1v * y1v;
        }
      }
      if (stats) {
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
#pragma unroll
            for (int off = 4; off < 32; off <<= 1)  // over g (lanes t, t+4, ...)
              sum[k][e] += __shfl_xor_sync(0xffffffff, sum[k][e], off);
            if (g == 0) red[(cw * 2 + k) * BN + j * 8 + 2 * t + e] = sum[k][e];
          }
      }
    }
  }

  if (!stats) return;
  s9::named_barrier_sync(2, CONSUMERS);
  for (int c = threadIdx.x; c < BN; c += CONSUMERS) {
    if (f0 + c >= p.f) break;
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) {  // fixed order
      a += red[(w * 2 + 0) * BN + c];
      b += red[(w * 2 + 1) * BN + c];
    }
    const long long prow = static_cast<long long>(n) * gridDim.x + blockIdx.x;
    p.stats[prow * p.f + f0 + c] = a;
    p.stats[(static_cast<long long>(p.n) * gridDim.x + prow) * p.f + f0 + c] = b;
  }
}

template <int BN>
cudaError_t launch(const CUtensorMap& xmap, const CUtensorMap& wmap, const Params& p,
                   cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(  // once per instantiation
      conv3x3_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<BN>::SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(((p.h + TH - 1) / TH) * ((p.wd + TW - 1) / TW), (p.f + BN - 1) / BN, p.n);
  conv3x3_kernel<BN><<<grid, THREADS, Cfg<BN>::SMEM, stream>>>(xmap, wmap, p);
  return cudaGetLastError();
}

}  // namespace

// Requires C % 8 == 0 and F % 8 == 0; the Python wrapper checks both.  A
// block takes 256 output channels where F % 256 == 0, else 128.  The stats
// buffer, when given, holds ceil(H/16)·ceil(W/8) partial rows per image.
extern "C" int sfast_conv3x3_bf16(const void* x, const void* w, const void* bias,
                                  const void* gn_scale, const void* gn_shift,
                                  const void* residual, void* out, void* stats, int n, int h,
                                  int wd, int c, int f, float inv_scale, void* stream) {
  if (c % 8 != 0 || f % 8 != 0) return cudaErrorInvalidValue;
  // x as (C, W, H, N); one box is one 8-channel chunk of the halo
  const uint64_t xdims[4] = {static_cast<uint64_t>(c), static_cast<uint64_t>(wd),
                             static_cast<uint64_t>(h), static_cast<uint64_t>(n)};
  const uint64_t xstrides[3] = {2ull * c, 2ull * c * wd, 2ull * c * wd * h};
  const uint32_t xbox[4] = {8, HW, HH, 1};
  // w as (C, 9 taps, F); one box is one (slice, tap) of 128 output channels
  const uint64_t wdims[3] = {static_cast<uint64_t>(c), 9, static_cast<uint64_t>(f)};
  const uint64_t wstrides[2] = {2ull * c, 18ull * c};
  const int bn = f % 256 == 0 ? 256 : 128;
  const uint32_t wbox[3] = {KC, 1, static_cast<uint32_t>(bn)};
  CUtensorMap xmap, wmap;
  if (!sfast::sm90::encode_tensor_map(&xmap, x, 4, xdims, xstrides, xbox,
                                      CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !sfast::sm90::encode_tensor_map(&wmap, w, 3, wdims, wstrides, wbox,
                                      CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  Params p;
  p.bias = static_cast<const float*>(bias);
  p.gn_scale = static_cast<const float*>(gn_scale);
  p.gn_shift = static_cast<const float*>(gn_shift);
  p.residual = static_cast<const __nv_bfloat16*>(residual);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.stats = static_cast<float*>(stats);
  p.n = n;
  p.h = h;
  p.wd = wd;
  p.c = c;
  p.f = f;
  p.inv_scale = inv_scale;
  return bn == 256 ? launch<256>(xmap, wmap, p, static_cast<cudaStream_t>(stream))
                   : launch<128>(xmap, wmap, p, static_cast<cudaStream_t>(stream));
}
