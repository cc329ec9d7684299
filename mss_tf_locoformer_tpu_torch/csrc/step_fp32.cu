// fp32 rows of the fused FFN step (#2, #5) and attention step (#3, #4),
// and the RoPE split of the unfused route's flash attention (#6, #7); the
// fixed-order reductions of the unfused route's FFN core (#8, #9), whose
// GEMMs and column sums run in ffn_core_fp32.cu.  The attention core of #3,
// #4, #6 and #7 runs in attn_fp32.cu (3xTF32 on the tensor cores).
//
// Replace, for fp32 rows, the JAX package's Pallas kernels
//   ops/pallas/swiglu_block.py:279 _blk_forward, :456 _blk_backward,
//   ops/pallas/attention_block.py:393 _attn_forward, :626 _attn_backward_pallas
// at their fp32 itemsize (the attention steps' core in attn_fp32.cu):
// fp32 operands and fp32 sums, no rounding to a narrower type anywhere.  The
// bf16 kernels (swiglu_block.cu, attention_block.cu, flash_attention.cu)
// stay as they are; ops/cuda/step_fp32.py chains the kernels below and
// attn_fp32.cu's into the four steps, ops/cuda/unfused_fp32.py qkv_split
// and attn_fp32.cu's into the flash forward and backward, and lends reduce
// to the FFN core's chain.
//
// Design: fp32 FFMA, no tensor cores (one TF32 pass would round every
// operand to 11 bits; the 3xTF32 kernels of ffn_core_fp32.cu and
// attn_fp32.cu keep fp32's accuracy on the tensor cores, and could take
// these GEMMs too).  Each step is a short chain of launches through device
// memory rather than one fused kernel:
//   gemm_nn    out = epilogue(A @ B): A's rows are windows of a per-row
//              buffer (Win: the conv's k taps of C channels are k*C
//              consecutive floats of the row, zero outside the row), B a
//              dense weight panel; 128 x 64 tiles, 8-deep stages double-
//              buffered (the next stage loaded into registers while the
//              current one is multiplied), 8 x 4 outputs a thread.  Epilogues: store (+ bias); SwiGLU with the inner
//              dropout site (the conv); its backward (dh -> dy); the step's
//              output (bias, outer dropout site, residual).
//   gemm_tn    weight gradients: A^T B summed over positions, one fp32
//              partial per position split (no atomics), summed by reduce.
//   colsum     bias gradients: column sums per position split.
//   reduce     partials summed in a fixed order (the same bits every run).
//   norm_fwd / norm_bwd   RMSGroupNorm per (position, group); the backward
//              writes dx and per-block dgamma partials.
//   mask_rows  the outer / projection dropout site on the upstream gradient.
//   qkv_split  q, k (RoPE) and v into [R, H, Lp, DP] (head dims zero-padded
//              to DP: 32 for the steps; 16, 32 or 64 for flash attention),
//              the layout attn_fp32.cu's kernels read.
// Bound: FLOP at the fp32 rate (67 TFLOP/s) for every shipped shape.  What
// the design gives up: the intermediates (the SwiGLU output, the projected
// rows) pass through device memory, and no kernel overlaps loads with
// products.
//
// Dropout masks come from philox.cuh at the bf16 kernels' coordinates
// (ops/dropout.py): the inner site at (row, conv position, inner channel),
// the outer and projection sites at (row, position, channel); the
// probability site, at (row, head, key, query), is attn_fp32.cu's.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace f32 {

constexpr int BM = 128, BN = 64, BK = 8, NT = 256;   // GEMM tile, 8 x 4 a thread
constexpr int TM = 8, TN = 4;
constexpr int LDA = BM + 4, LDB = BN + 4;    // staged rows (k-major), 16-byte aligned
constexpr int GEMM_SMEM = 2 * BK * (LDA + LDB) * 4;
constexpr int KT = 64;                   // qkv_split's Lp: a multiple of 64 rows
constexpr int NP = 64;                   // positions per norm_bwd block

enum { EPI_STORE = 0, EPI_SWIGLU = 1, EPI_SWIGLU_BWD = 2, EPI_OUT = 3 };

// A matrix whose row m = (r, p), r = m / P, is the window of the per-row
// buffer p_ + r * rs starting at offset p * ps + shift; an element whose
// offset lies outside [0, lim) is zero.  Strides, shifts and limits are
// multiples of 4 floats and the buffer is 16-byte aligned (the wrapper
// checks), so a group of 4 columns is all in or all out and loads as one
// float4.
struct Win {
  const float* p_;
  long long rs, P, ps, shift, lim;
};

__device__ __forceinline__ const float* win_row(const Win& w, long long m, long long& off) {
  const long long r = m / w.P, p = m - r * w.P;
  off = p * w.ps + w.shift;
  return w.p_ + r * w.rs;
}

__device__ __forceinline__ float4 load4(const float* row, long long off, long long lim) {
  if (off < 0 || off >= lim) return make_float4(0.f, 0.f, 0.f, 0.f);
  return *reinterpret_cast<const float4*>(row + off);
}

struct Epi {
  float* out;
  long long ldo;
  const float* bias;  // [N] or null
  float* y;           // SwiGLU: the pre-activation out (null: not kept); its backward: y in
  const float* res;   // EPI_OUT: the residual [M, N] (null: partial-sum mode)
  long long P;        // positions per row, for the mask coordinates
  uint32_t site;
  DropParams dp;
};

__device__ __forceinline__ float sigmoidf_(float g) { return 1.f / (1.f + expf(-g)); }

__device__ __forceinline__ void mma_tile(const float* As, const float* Bs, int ty, int tx,
                                         float (&acc)[TM][TN]) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(As + kk * LDA + ty * TM);
    const float4 a1 = *reinterpret_cast<const float4*>(As + kk * LDA + ty * TM + 4);
    const float4 b4 = *reinterpret_cast<const float4*>(Bs + kk * LDB + tx * TN);
    const float av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// out[m, n] = epilogue(sum_k A(m, k) B[k, n]); K and N multiples of 4.  The
// next 8-deep stage is loaded into registers while the current one is
// multiplied from shared memory (two buffers, one barrier a stage).
template <int EPI>
__global__ void __launch_bounds__(NT) gemm_nn(Win a, long long M, int K,
                                              const float* __restrict__ B, int N, Epi e) {
  __shared__ __align__(16) float As[2][BK * LDA];
  __shared__ __align__(16) float Bs[2][BK * LDB];
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int la_r = t >> 1, la_c = (t & 1) * 4;    // A: 128 rows x 8 columns
  const int lb_r = t >> 4, lb_c = (t & 15) * 4;   // B: 8 rows x 64 columns (t < 128)
  const bool lb = t < 128;
  const long long am = m0 + la_r;
  const bool am_ok = am < M;
  long long aoff = 0;
  const float* arow = am_ok ? win_row(a, am, aoff) : a.p_;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  auto load_a = [&](int k0) {
    return am_ok && k0 + la_c < K ? load4(arow, aoff + k0 + la_c, a.lim) : zero;
  };
  auto load_b = [&](int k0) {
    return lb && k0 + lb_r < K && n0 + lb_c < N
               ? *reinterpret_cast<const float4*>(B + (long long)(k0 + lb_r) * N + n0 + lb_c)
               : zero;
  };
  auto stage = [&](int buf, float4 va, float4 vb) {
    float* as = As[buf];
    as[(la_c + 0) * LDA + la_r] = va.x;
    as[(la_c + 1) * LDA + la_r] = va.y;
    as[(la_c + 2) * LDA + la_r] = va.z;
    as[(la_c + 3) * LDA + la_r] = va.w;
    if (lb) *reinterpret_cast<float4*>(Bs[buf] + lb_r * LDB + lb_c) = vb;
  };
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  stage(0, load_a(0), load_b(0));
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    float4 va = zero, vb = zero;
    if (more) {
      va = load_a(k0 + BK);
      vb = load_b(k0 + BK);
    }
    mma_tile(As[buf], Bs[buf], ty, tx, acc);
    if (more) stage(buf ^ 1, va, vb);
    __syncthreads();
    buf ^= 1;
  }
  const int nb = n0 + tx * TN;
  if (nb >= N) return;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ty * TM + i;
    if (m >= M) continue;
    const long long r = m / e.P, p = m - r * e.P;
    const uint32_t row = e.dp.row0 + (uint32_t)r;
    if (EPI == EPI_STORE) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        e.out[m * e.ldo + nb + j] = acc[i][j] + (e.bias ? e.bias[nb + j] : 0.f);
    } else if (EPI == EPI_OUT) {
      Philox4 w;
      const bool drop = e.res && e.dp.on;
      if (drop) w = dropout_words(e.dp.seed, e.site, row, (uint32_t)p, (uint32_t)(nb >> 2), 0u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v = acc[i][j] + (e.bias ? e.bias[nb + j] : 0.f);
        if (drop) v = w.w[j] < e.dp.thr ? v * e.dp.scale : 0.f;
        if (e.res) v += e.res[m * N + nb + j];
        e.out[m * e.ldo + nb + j] = v;
      }
    } else if (EPI == EPI_SWIGLU) {
      // columns interleave (value, gate) pairs: n = 2c + {0, 1}, inner channel c
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        const int n = nb + j, c = n >> 1;
        const float v = acc[i][j] + e.bias[n], g = acc[i][j + 1] + e.bias[n + 1];
        if (e.y) {
          e.y[m * N + n] = v;
          e.y[m * N + n + 1] = g;
        }
        float h = v * (g * sigmoidf_(g));
        if (e.dp.on)
          h = dropout_keep(e.dp.seed, e.site, row, (uint32_t)p, (uint32_t)c, 0u, e.dp.thr)
                  ? h * e.dp.scale : 0.f;
        e.out[m * e.ldo + c] = h;
      }
    } else {  // EPI_SWIGLU_BWD: column c of dh -> dy's pair (2c, 2c + 1)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = nb + j;
        float dh = acc[i][j];
        if (e.dp.on)
          dh = dropout_keep(e.dp.seed, e.site, row, (uint32_t)p, (uint32_t)c, 0u, e.dp.thr)
                   ? dh * e.dp.scale : 0.f;
        const float v = e.y[m * 2 * N + 2 * c], g = e.y[m * 2 * N + 2 * c + 1];
        const float s = sigmoidf_(g);
        e.out[m * e.ldo + 2 * c] = dh * (g * s);
        e.out[m * e.ldo + 2 * c + 1] = dh * v * (s * (1.f + g * (1.f - s)));
      }
    }
  }
}

// part[s][m][n] = sum over positions q of split s of A(q, m) B(q, n); M and
// N multiples of 4.
__global__ void __launch_bounds__(NT) gemm_tn(Win a, int M, Win b, int N, long long total,
                                              long long per, float* __restrict__ part) {
  __shared__ __align__(16) float As[2][BK * LDA];
  __shared__ __align__(16) float Bs[2][BK * LDB];
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const long long q0 = (long long)blockIdx.z * per;
  const long long q1 = total < q0 + per ? total : q0 + per;
  const int la_r = t >> 5, la_c = (t & 31) * 4;   // A: 8 positions x 128 columns
  const int lb_r = t >> 4, lb_c = (t & 15) * 4;   // B: 8 positions x 64 columns (t < 128)
  const bool lb = t < 128;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  auto load_a = [&](long long qc) {
    const long long q = qc + la_r;
    if (q >= q1 || m0 + la_c >= M) return zero;
    long long off;
    const float* row = win_row(a, q, off);
    return load4(row, off + m0 + la_c, a.lim);
  };
  auto load_b = [&](long long qc) {
    const long long q = qc + lb_r;
    if (!lb || q >= q1 || n0 + lb_c >= N) return zero;
    long long off;
    const float* row = win_row(b, q, off);
    return load4(row, off + n0 + lb_c, b.lim);
  };
  auto stage = [&](int buf, float4 va, float4 vb) {
    *reinterpret_cast<float4*>(As[buf] + la_r * LDA + la_c) = va;
    if (lb) *reinterpret_cast<float4*>(Bs[buf] + lb_r * LDB + lb_c) = vb;
  };
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  stage(0, load_a(q0), load_b(q0));
  __syncthreads();
  int buf = 0;
  for (long long qc = q0; qc < q1; qc += BK) {
    const bool more = qc + BK < q1;
    float4 va = zero, vb = zero;
    if (more) {
      va = load_a(qc + BK);
      vb = load_b(qc + BK);
    }
    mma_tile(As[buf], Bs[buf], ty, tx, acc);
    if (more) stage(buf ^ 1, va, vb);
    __syncthreads();
    buf ^= 1;
  }
  const int nb = n0 + tx * TN;
  if (nb >= N) return;
  float* out = part + (long long)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m < M)
#pragma unroll
      for (int j = 0; j < TN; ++j) out[(long long)m * N + nb + j] = acc[i][j];
  }
}

// part[s][c] = sum over positions q of split s of A(q, c), c < W.
__global__ void colsum(Win a, int W, long long total, long long per, float* __restrict__ part) {
  const long long q0 = (long long)blockIdx.x * per;
  const long long q1 = total < q0 + per ? total : q0 + per;
  for (int c = threadIdx.x; c < W; c += blockDim.x) {
    float acc = 0.f;
    for (long long q = q0; q < q1; ++q) {
      long long off;
      const float* row = win_row(a, q, off);
      off += c;
      if (off >= 0 && off < a.lim) acc += row[off];
    }
    part[(long long)blockIdx.x * W + c] = acc;
  }
}

// out[g][i] = sum_{s in [g seg, (g + 1) seg) and < S} part[s][i], in order.
__global__ void reduce(const float* __restrict__ part, long long S, long long n, long long seg,
                       float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long s0 = (long long)blockIdx.y * seg;
  const long long s1 = S < s0 + seg ? S : s0 + seg;
  float acc = 0.f;
  for (long long s = s0; s < s1; ++s) acc += part[s * n + i];
  out[(long long)blockIdx.y * n + i] = acc;
}

// RMSGroupNorm per (position, group): xn = x / (rms + eps) * gamma,
// rms = sqrt(sum x^2) * dpg^-1/2 (the reference's eps placement).
__global__ void norm_fwd(const float* __restrict__ x, const float* __restrict__ gamma,
                         float* __restrict__ xn, long long npos, int C, int G, float eps) {
  const long long item = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= npos * G) return;
  const long long pos = item / G;
  const int g = (int)(item - pos * G), dpg = C / G;
  const float* s = x + pos * C + g * dpg;
  float ss = 0.f;
  for (int c = 0; c < dpg; ++c) ss = fmaf(s[c], s[c], ss);
  const float den = sqrtf(ss) * (1.f / sqrtf((float)dpg)) + eps;
  float* d = xn + pos * C + g * dpg;
  for (int c = 0; c < dpg; ++c) d[c] = s[c] / den * gamma[g * dpg + c];
}

// The norm's backward from dxn: dx (+ gres, the residual's gradient, when
// given) and per-block dgamma partials part[block][c] over NP positions.
__global__ void norm_bwd(const float* __restrict__ x, const float* __restrict__ gamma,
                         const float* __restrict__ dxn, const float* __restrict__ gres,
                         float* __restrict__ dx, float* __restrict__ part, long long npos,
                         int C, int G, float eps) {
  extern __shared__ float red[];   // [NP][C]
  const int dpg = C / G;
  const float rd = 1.f / sqrtf((float)dpg);
  const long long p0 = (long long)blockIdx.x * NP;
  for (int item = threadIdx.x; item < NP * G; item += blockDim.x) {
    const int pl = item / G, g = item % G;
    const long long pos = p0 + pl;
    float* rr = red + pl * C + g * dpg;
    if (pos >= npos) {
      for (int c = 0; c < dpg; ++c) rr[c] = 0.f;
      continue;
    }
    const long long o = pos * C + g * dpg;
    const float* xs = x + o;
    const float* ds = dxn + o;
    const float* gm = gamma + g * dpg;
    float ss = 0.f, dot = 0.f;
    for (int c = 0; c < dpg; ++c) {
      ss = fmaf(xs[c], xs[c], ss);
      dot = fmaf(ds[c] * gm[c], xs[c], dot);
    }
    const float rms = sqrtf(ss) * rd, den = rms + eps;
    // d den / d x_c = x_c rd^2 / rms
    const float coef = rms > 0.f ? dot * rd * rd / (rms * den * den) : 0.f;
    for (int c = 0; c < dpg; ++c) {
      float v = ds[c] * gm[c] / den - xs[c] * coef;
      if (gres) v += gres[o + c];
      dx[o + c] = v;
      rr[c] = ds[c] * (xs[c] / den);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float acc = 0.f;
    for (int pl = 0; pl < NP; ++pl) acc += red[pl * C + c];
    part[(long long)blockIdx.x * C + c] = acc;
  }
}

// dz = keep(row, position, channel) ? g * scale : 0 over [R, L, C].
__global__ void mask_rows(const float* __restrict__ g, float* __restrict__ dz, long long n,
                          int L, int C, uint32_t site, DropParams dp) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long pos = i / C;
  const int c = (int)(i - pos * C);
  const long long r = pos / L;
  const int p = (int)(pos - r * L);
  dz[i] = dropout_keep(dp.seed, site, dp.row0 + (uint32_t)r, (uint32_t)p, (uint32_t)c, 0u, dp.thr)
              ? g[i] * dp.scale : 0.f;
}

// qkv [R, L, 3A] -> q, k (rotated by RoPE's interleaved pairs), v
// [R, H, Lp, DP]; rows L..Lp-1 and dims D..DP-1 zero.
template <int DP>
__global__ void qkv_split(const float* __restrict__ qkv, const float* __restrict__ cs,
                          const float* __restrict__ sn, float* __restrict__ q,
                          float* __restrict__ k, float* __restrict__ v, int R, int L, int Lp,
                          int H, int D) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)R * H * Lp * (DP / 2)) return;
  const int t = (int)(idx % (DP / 2));
  const long long rl = idx / (DP / 2);
  const int l = (int)(rl % Lp);
  const long long rh = rl / Lp;
  const int h = (int)(rh % H);
  const long long r = rh / H;
  const long long o = rl * DP + 2 * t;
  if (l >= L || 2 * t >= D) {
    q[o] = q[o + 1] = k[o] = k[o + 1] = v[o] = v[o + 1] = 0.f;
    return;
  }
  const int A = H * D;
  const float* s = qkv + ((long long)r * L + l) * 3 * A + h * D + 2 * t;
  const float c = cs[l * (D / 2) + t], si = sn[l * (D / 2) + t];
  q[o] = s[0] * c - s[1] * si;
  q[o + 1] = s[1] * c + s[0] * si;
  k[o] = s[A] * c - s[A + 1] * si;
  k[o + 1] = s[A + 1] * c + s[A] * si;
  v[o] = s[2 * A];
  v[o + 1] = s[2 * A + 1];
}

inline Win win(const void* p, long long rs, long long P, long long ps, long long shift,
               long long lim) {
  Win w;
  w.p_ = (const float*)p;
  w.rs = rs;
  w.P = P;
  w.ps = ps;
  w.shift = shift;
  w.lim = lim;
  return w;
}

inline DropParams drop(unsigned seed, unsigned thr, unsigned row0, float scale, int on) {
  DropParams dp;
  dp.seed = seed;
  dp.thr = thr;
  dp.row0 = row0;
  dp.scale = scale;
  dp.on = on;
  return dp;
}

inline unsigned blocks(long long n, int per) { return (unsigned)((n + per - 1) / per); }

}  // namespace f32

using namespace f32;

// Shared memory of each launch (bytes): 0 gemm_nn / gemm_tn, 1 norm_bwd at
// width C (the attention core's: attn_fp32.cu's f32_attn_smem_bytes).
extern "C" long long step_fp32_smem_bytes(int which, int C) {
  switch (which) {
    case 0: return GEMM_SMEM;
    case 1: return (long long)NP * C * 4;
  }
  return -1;
}

#define WIN_ARGS(n) const void *n##_p, long long n##_rs, long long n##_P, long long n##_ps, \
                    long long n##_shift, long long n##_lim
#define WIN(n) win(n##_p, n##_rs, n##_P, n##_ps, n##_shift, n##_lim)

extern "C" int f32_gemm_nn(int epi, WIN_ARGS(a), long long M, int K, const void* B, int N,
                           void* out, long long ldo, const void* bias, void* y, const void* res,
                           long long P, unsigned site, unsigned seed, unsigned thr,
                           unsigned row0, float scale, int on, void* stream) {
  if (K % 4 || N % 4 || M < 1) return (int)cudaErrorInvalidValue;
  Epi e;
  e.out = (float*)out;
  e.ldo = ldo;
  e.bias = (const float*)bias;
  e.y = (float*)y;
  e.res = (const float*)res;
  e.P = P;
  e.site = site;
  e.dp = drop(seed, thr, row0, scale, on);
  const dim3 grid(blocks(M, BM), blocks(N, BN));
  const cudaStream_t st = (cudaStream_t)stream;
  const Win a = WIN(a);
  switch (epi) {
    case EPI_STORE: gemm_nn<EPI_STORE><<<grid, NT, 0, st>>>(a, M, K, (const float*)B, N, e); break;
    case EPI_SWIGLU: gemm_nn<EPI_SWIGLU><<<grid, NT, 0, st>>>(a, M, K, (const float*)B, N, e); break;
    case EPI_SWIGLU_BWD:
      gemm_nn<EPI_SWIGLU_BWD><<<grid, NT, 0, st>>>(a, M, K, (const float*)B, N, e);
      break;
    case EPI_OUT: gemm_nn<EPI_OUT><<<grid, NT, 0, st>>>(a, M, K, (const float*)B, N, e); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int f32_gemm_tn(WIN_ARGS(a), int M, WIN_ARGS(b), int N, long long total, int S,
                           void* part, void* stream) {
  if (M % 4 || N % 4 || S < 1 || S > 65535) return (int)cudaErrorInvalidValue;
  const long long per = (total + S - 1) / S;
  gemm_tn<<<dim3(blocks(M, BM), blocks(N, BN), S), NT, 0, (cudaStream_t)stream>>>(
      WIN(a), M, WIN(b), N, total, per, (float*)part);
  return (int)cudaGetLastError();
}

extern "C" int f32_colsum(WIN_ARGS(a), int W, long long total, int S, void* part, void* stream) {
  if (S < 1) return (int)cudaErrorInvalidValue;
  const long long per = (total + S - 1) / S;
  colsum<<<S, 256, 0, (cudaStream_t)stream>>>(WIN(a), W, total, per, (float*)part);
  return (int)cudaGetLastError();
}

extern "C" int f32_reduce(const void* part, long long S, long long n, long long seg, void* out,
                          void* stream) {
  if (S < 1 || seg < 1 || (S + seg - 1) / seg > 65535) return (int)cudaErrorInvalidValue;
  reduce<<<dim3(blocks(n, 256), (unsigned)((S + seg - 1) / seg)), 256, 0,
           (cudaStream_t)stream>>>((const float*)part, S, n, seg, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int f32_norm_fwd(const void* x, const void* gamma, void* xn, long long npos, int C,
                            int G, float eps, void* stream) {
  if (G < 1 || C % G) return (int)cudaErrorInvalidValue;
  norm_fwd<<<blocks(npos * G, 256), 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)gamma, (float*)xn, npos, C, G, eps);
  return (int)cudaGetLastError();
}

extern "C" int f32_norm_bwd(const void* x, const void* gamma, const void* dxn, const void* gres,
                            void* dx, void* part, long long npos, int C, int G, float eps,
                            void* stream) {
  if (G < 1 || C % G) return (int)cudaErrorInvalidValue;
  const int smem = NP * C * 4;
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(norm_bwd, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
    return (int)cudaGetLastError();
  norm_bwd<<<blocks(npos, NP), 256, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)gamma, (const float*)dxn, (const float*)gres, (float*)dx,
      (float*)part, npos, C, G, eps);
  return (int)cudaGetLastError();
}

extern "C" int f32_mask_rows(const void* g, void* dz, long long n, int L, int C, unsigned site,
                             unsigned seed, unsigned thr, unsigned row0, float scale,
                             void* stream) {
  mask_rows<<<blocks(n, 256), 256, 0, (cudaStream_t)stream>>>(
      (const float*)g, (float*)dz, n, L, C, site, drop(seed, thr, row0, scale, 1));
  return (int)cudaGetLastError();
}

template <int DP>
int launch_qkv_split(const void* qkv, const void* cs, const void* sn, void* q, void* k, void* v,
                     int R, int L, int Lp, int H, int D, cudaStream_t st) {
  qkv_split<DP><<<blocks((long long)R * H * Lp * (DP / 2), 256), 256, 0, st>>>(
      (const float*)qkv, (const float*)cs, (const float*)sn, (float*)q, (float*)k, (float*)v, R,
      L, Lp, H, D);
  return (int)cudaGetLastError();
}

// The padded head width dp selects the instantiation: 16, 32 or 64.
#define DP_DISPATCH(dp, fn, ...)                                       \
  switch (dp) {                                                        \
    case 16: return fn<16>(__VA_ARGS__);                               \
    case 32: return fn<32>(__VA_ARGS__);                               \
    case 64: return fn<64>(__VA_ARGS__);                               \
  }                                                                    \
  return (int)cudaErrorInvalidValue;

extern "C" int f32_qkv_split(const void* qkv, const void* cs, const void* sn, void* q, void* k,
                             void* v, int R, int L, int Lp, int H, int D, int dp, void* stream) {
  if (D % 2 || D > dp || Lp % KT || Lp < L) return (int)cudaErrorInvalidValue;
  DP_DISPATCH(dp, launch_qkv_split, qkv, cs, sn, q, k, v, R, L, Lp, H, D, (cudaStream_t)stream)
}
