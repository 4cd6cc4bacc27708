// K6's pre-processing: the quantization of q, k and v that JAX's
// flash_attention_int8 runs before its Pallas kernel
// (sfast_tpu/ops/flash_attention.py:326-349), in two launches that read
// q, k and v through their strides, so the head-split (B, H, S, D) views
// of the UNet take no copy.  Its plain version is kernel_inputs in
// ops/flash_attention_int8.py.
//
// What it computes, per (b·h):
// - q prescaled by f32(scale·log2 e); the per-channel means q̄, k̄, v̄ over
//   the sequence and the centred values;
// - one amax for the centred q and one for k, and one per channel for v;
//   scale = max(amax, 1e-6) / 127 and code = round-half-even(x / scale),
//   IEEE division, clamped to ±127;
// - corr = q̄·(k − k̄)ᵀ, the exact per-column term of the q centring;
// - sqk = s_q·s_k, sv = s_v / 127 and v̄, which the body reads.
//
// What bounds it on the H100: bytes.  Two passes read q, k and v (7.9 MB
// each at the main path's (2, 8, 4096, 40)); the second writes 2.6 MB of
// codes, about 5 µs of traffic in all at 3.35 TB/s.
//
// Design:
// 1. stats_kernel: one block per (tensor, b·h, 256-row chunk) sums each
//    channel and takes its max and min, then folds its threads' partials
//    in a fixed order and writes them to `part`.  No atomics: two calls
//    agree bit for bit.
// 2. quantize_kernel: every block folds its (b·h)'s partials in chunk
//    order into the means and the amax of the centred values, exactly:
//    max |x − m| = max(rn(max x − m), rn(m − min x)), since rounding is
//    monotonic; then it quantizes its 256 rows, one thread per row.  q8
//    and k8 are written as (b·h, S, KP): rows zero-padded to KP = d
//    rounded up to 32, the K padding of the body's q·kᵀ (a d = 40 row, 40
//    bytes, could not be a TMA row: global strides must be multiples of 16
//    bytes).  vᵀ is (b·h, d, SKP), SKP = S rounded up to 16, each 16-kv
//    group in the order (0, 1, 8, 9, 2, 3, 10, 11, 4, 5, 12, 13, 6, 7, 14,
//    15) in which a thread's quantized scores are its A registers of p·v
//    (csrc/flash_attention_int8.cu); kv past the end are zero.  corr is
//    (b·h, SKP), zero past the end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 256;  // rows per chunk (ops/flash_attention_int8.PREP_ROWS)
constexpr int THREADS = 256;
constexpr int MAX_D = 160;

struct Src {
  const __nv_bfloat16* p;
  long long sb, sh, ss;
  int s;
};

struct Params {
  Src t[3];  // q, k, v
  int heads, d, kp, skp, nch;
  float prescale;  // f32(scale·log2 e), q's only
  float* part;     // (3, b·h, nch, 3, d): sum, max, min per channel
  int8_t* q8;
  int8_t* k8;
  int8_t* vt;
  float* corr;
  float* sqk;
  float* sv;
  float* vm;
};

__device__ __forceinline__ const __nv_bfloat16* row_ptr(const Src& s, int b, int h, int row) {
  return s.p + b * s.sb + h * s.sh + static_cast<long long>(row) * s.ss;
}

__global__ void __launch_bounds__(THREADS) stats_kernel(const Params p) {
  const int ti = blockIdx.z, bh = blockIdx.y, chunk = blockIdx.x;
  const Src& src = p.t[ti];
  const int b = bh / p.heads, h = bh - b * p.heads;
  const int nvec = p.d / 8;          // 8-channel vectors per row
  const int lanes = THREADS / nvec;  // rows in flight
  const int r0 = threadIdx.x / nvec, vec = threadIdx.x - r0 * nvec;
  const float mul = ti == 0 ? p.prescale : 1.f;

  float sum[8], mx[8], mn[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    sum[i] = 0.f;
    mx[i] = -INFINITY;
    mn[i] = INFINITY;
  }
  const int end = min(src.s, (chunk + 1) * ROWS);
  if (r0 < lanes) {
    for (int r = chunk * ROWS + r0; r < end; r += lanes) {
      const uint4 raw = *reinterpret_cast<const uint4*>(row_ptr(src, b, h, r) + vec * 8);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float x = __fmul_rn(__bfloat162float(e[i]), mul);
        sum[i] = __fadd_rn(sum[i], x);
        mx[i] = fmaxf(mx[i], x);
        mn[i] = fminf(mn[i], x);
      }
    }
  }
  __shared__ float red[THREADS * 24];
  float* mine = red + threadIdx.x * 24;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mine[i] = sum[i];
    mine[8 + i] = mx[i];
    mine[16 + i] = mn[i];
  }
  __syncthreads();
  float* out = p.part + ((static_cast<long long>(ti) * gridDim.y + bh) * p.nch + chunk) * 3 * p.d;
  for (int o = threadIdx.x; o < 3 * p.d; o += THREADS) {
    const int stat = o / p.d, c = o - stat * p.d;
    const int at = (c / 8) * 24 + stat * 8 + c % 8;
    float acc = red[at];
#pragma unroll 8
    for (int r = 1; r < lanes; ++r) {  // row lanes in order
      const float x = red[r * nvec * 24 + at];
      acc = stat == 0 ? __fadd_rn(acc, x) : (stat == 1 ? fmaxf(acc, x) : fminf(acc, x));
    }
    out[o] = acc;
  }
}

__device__ __forceinline__ int quantize(float x, float scale) {
  return max(-127, min(127, __float2int_rn(__fdiv_rn(x, scale))));
}

__global__ void __launch_bounds__(THREADS) quantize_kernel(const Params p) {
  const int ti = blockIdx.z, bh = blockIdx.y, chunk = blockIdx.x;
  const int d = p.d;
  const int b = bh / p.heads, h = bh - b * p.heads;
  __shared__ float mean[3][MAX_D];
  __shared__ float amax[3][MAX_D];
  __shared__ float scale[3][MAX_D];  // q and k: entry 0 only
  __shared__ __align__(16) int8_t stage[MAX_D * ROWS];  // v's codes, channel-major

  // fold the partials of this b·h in chunk order
  for (int o = threadIdx.x; o < 3 * d; o += THREADS) {
    const int t = o / d, c = o - t * d;
    const int n = (p.t[t].s + ROWS - 1) / ROWS;
    const float* part =
        p.part + (static_cast<long long>(t) * gridDim.y + bh) * p.nch * 3 * d + c;
    float sum = 0.f, mx = -INFINITY, mn = INFINITY;
#pragma unroll 8
    for (int ch = 0; ch < n; ++ch) {  // the loads run ahead; the sums stay in order
      sum = __fadd_rn(sum, part[ch * 3 * d]);
      mx = fmaxf(mx, part[ch * 3 * d + d]);
      mn = fminf(mn, part[ch * 3 * d + 2 * d]);
    }
    const float m = __fdiv_rn(sum, static_cast<float>(p.t[t].s));
    mean[t][c] = m;
    amax[t][c] = fmaxf(__fsub_rn(mx, m), __fsub_rn(m, mn));
  }
  __syncthreads();
  if (threadIdx.x < 2) {  // one amax per b·h for q and k (max: any order)
    float a = 0.f;
    for (int c = 0; c < d; ++c) a = fmaxf(a, amax[threadIdx.x][c]);
    scale[threadIdx.x][0] = __fdiv_rn(fmaxf(a, 1e-6f), 127.f);
  }
  for (int c = threadIdx.x; c < d; c += THREADS)
    scale[2][c] = __fdiv_rn(fmaxf(amax[2][c], 1e-6f), 127.f);
  __syncthreads();

  if (chunk == 0) {
    if (ti == 1 && threadIdx.x == 0) p.sqk[bh] = __fmul_rn(scale[0][0], scale[1][0]);
    if (ti == 2)
      for (int c = threadIdx.x; c < d; c += THREADS) {
        p.sv[bh * d + c] = __fdiv_rn(scale[2][c], 127.f);
        p.vm[bh * d + c] = mean[2][c];
      }
  }

  const Src& src = p.t[ti];
  const int row = chunk * ROWS + threadIdx.x;
  const bool in = row < src.s;
  const float mul = ti == 0 ? p.prescale : 1.f;

  if (ti < 2) {  // q or k: chunks of 16 codes, corr for k
    const float sc = scale[ti][0];
    int8_t* dst = ti == 0 ? p.q8 : p.k8;
    const int nc = p.kp / 16;  // 16-byte chunks of a row
    float corr = 0.f;
    if (in) {
      const __nv_bfloat16* x = row_ptr(src, b, h, row);
      for (int c16 = 0; c16 < nc; ++c16) {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int c0 = c16 * 16 + half * 8;
          if (c0 >= d) continue;  // d % 8 == 0: zero padding to KP
          const uint4 raw = *reinterpret_cast<const uint4*>(x + c0);
          const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float xc = __fsub_rn(__fmul_rn(__bfloat162float(e[i]), mul), mean[ti][c0 + i]);
            if (ti == 1) corr = fmaf(mean[0][c0 + i], xc, corr);
            const uint32_t code = static_cast<uint32_t>(quantize(xc, sc)) & 0xffu;
            w[half * 2 + i / 4] |= code << (8 * (i % 4));
          }
        }
        *reinterpret_cast<uint4*>(dst + (static_cast<long long>(bh) * src.s + row) * p.kp +
                                  c16 * 16) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    if (ti == 1 && row < p.skp) p.corr[static_cast<long long>(bh) * p.skp + row] = corr;
    return;
  }

  // v: codes into the stage channel-major, then vᵀ by 16-kv groups
  if (in) {
    const __nv_bfloat16* x = row_ptr(src, b, h, row);
    for (int c0 = 0; c0 < d; c0 += 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(x + c0);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xc = __fsub_rn(__bfloat162float(e[i]), mean[2][c0 + i]);
        stage[(c0 + i) * ROWS + threadIdx.x] =
            static_cast<int8_t>(quantize(xc, scale[2][c0 + i]));
      }
    }
  } else {
    for (int c = 0; c < d; ++c) stage[c * ROWS + threadIdx.x] = 0;
  }
  __syncthreads();
  const int groups = p.skp / 16;
  for (int it = threadIdx.x; it < (ROWS / 16) * d; it += THREADS) {
    const int c = it / (ROWS / 16), gl = it % (ROWS / 16);  // neighbours write neighbours
    const int g = chunk * (ROWS / 16) + gl;
    if (g >= groups) continue;
    // kv 0..15 of the group as read; position 4a + 2b + cc takes kv
    // 8b + 2a + cc: words (0, 1, 8, 9), (2, 3, 10, 11), (4, 5, 12, 13),
    // (6, 7, 14, 15)
    const uint4 in4 = *reinterpret_cast<const uint4*>(stage + c * ROWS + gl * 16);
    *reinterpret_cast<uint4*>(p.vt + (static_cast<long long>(bh) * d + c) * p.skp + g * 16) =
        make_uint4(__byte_perm(in4.x, in4.z, 0x5410), __byte_perm(in4.x, in4.z, 0x7632),
                   __byte_perm(in4.y, in4.w, 0x5410), __byte_perm(in4.y, in4.w, 0x7632));
  }
}

}  // namespace

// q, k, v: bf16 (B, H, S, d) with strides in elements, the d stride 1 and
// the others multiples of 8, 16-byte aligned (the wrapper checks); d a
// multiple of 8 up to 160.  part: f32 (3, B·H, nch, 3, d) scratch with
// nch = ceil(max(sq, sk) / 256); q8: int8 (B·H, sq, kp) and k8 (B·H, sk,
// kp) with kp = d rounded up to 32; vt: int8 (B·H, d, skp) and corr: f32
// (B·H, skp) with skp = sk rounded up to 16;
// sqk: f32 (B·H,); sv, vm: f32 (B·H, d).  Returns cudaErrorInvalidValue
// for anything else.
extern "C" int sfast_quantize_qkv_int8(
    const void* q, const void* k, const void* v, int batch, int heads, int sq, int sk, int d,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss, float prescale,
    void* part, void* q8, void* k8, void* vt, void* corr, void* sqk, void* sv, void* vm,
    void* stream) {
  if (d % 8 != 0 || d <= 0 || d > MAX_D || sq <= 0 || sk <= 0 || batch <= 0 || heads <= 0)
    return cudaErrorInvalidValue;
  Params p;
  p.t[0] = {static_cast<const __nv_bfloat16*>(q), q_sb, q_sh, q_ss, sq};
  p.t[1] = {static_cast<const __nv_bfloat16*>(k), k_sb, k_sh, k_ss, sk};
  p.t[2] = {static_cast<const __nv_bfloat16*>(v), v_sb, v_sh, v_ss, sk};
  p.heads = heads;
  p.d = d;
  p.kp = (d + 31) / 32 * 32;
  p.skp = (sk + 15) / 16 * 16;
  p.nch = ((sq > sk ? sq : sk) + ROWS - 1) / ROWS;
  p.prescale = prescale;
  p.part = static_cast<float*>(part);
  p.q8 = static_cast<int8_t*>(q8);
  p.k8 = static_cast<int8_t*>(k8);
  p.vt = static_cast<int8_t*>(vt);
  p.corr = static_cast<float*>(corr);
  p.sqk = static_cast<float*>(sqk);
  p.sv = static_cast<float*>(sv);
  p.vm = static_cast<float*>(vm);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(p.nch, batch * heads, 3);
  stats_kernel<<<grid, THREADS, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  quantize_kernel<<<grid, THREADS, 0, st>>>(p);
  return cudaGetLastError();
}
