// fp32 rows of the fused steps (#2-#5): the RMSGroupNorm pair, the dropout
// mask on an upstream gradient, the RoPE split and the fixed-order
// reductions around the GEMMs of ffn_core_fp32.cu and the attention core of
// attn_fp32.cu (both 3xTF32 on the tensor cores); the RoPE split of the
// unfused route's flash attention (#6, #7); the fixed-order reductions of
// the unfused route's FFN core (#8, #9).
//
// Replace, for fp32 rows, the JAX package's Pallas kernels
//   ops/pallas/swiglu_block.py:279 _blk_forward, :456 _blk_backward,
//   ops/pallas/attention_block.py:393 _attn_forward, :626 _attn_backward_pallas
// at their fp32 itemsize (with ffn_core_fp32.cu's GEMMs and attn_fp32.cu's
// core): fp32 operands and fp32 sums, no rounding to a narrower type
// anywhere.  The bf16 kernels (swiglu_block.cu, attention_block.cu,
// flash_attention.cu) stay as they are; ops/cuda/step_fp32.py chains the
// kernels below with the other two files' into the four steps (every GEMM
// of #2-#5 on ffn_core_fp32.cu's core_nn / core_tn),
// ops/cuda/unfused_fp32.py qkv_split and attn_fp32.cu's into the flash
// forward and backward, and lends reduce to the FFN GEMMs' chains.
//
//   norm_fwd / norm_bwd   RMSGroupNorm, a warp per position: lane l holds
//              channels 4l .. 4l + 3 as one float4 (C <= 128), so a warp
//              reads a position's row in one coalesced pass; each group's
//              sum of squares (and in the backward its dot product) is the
//              lanes' partials (fmaf in channel order) summed by shuffles:
//              a tree over the group's lanes where groups are whole float4s
//              (C / G 24 or 32 at the shipped widths: 6 or 8 lanes), else a
//              butterfly over the warp per group (a float4 straddles two
//              groups).  The reciprocal and the square root once a group,
//              as the Pallas kernels' norm.  Four positions a warp, their
//              loads issued together.  The backward writes dx (+ gres, the
//              residual's gradient) and per-block dgamma partials: each
//              lane sums its channels over its warp's positions in order,
//              the block's eight warps are summed in order (no atomics).
//   reduce     partials summed in a fixed order (the same bits every run).
//   mask_rows  the outer / projection dropout site on the upstream gradient.
//   qkv_split  q, k (RoPE) and v into [R, H, Lp, DP] (head dims zero-padded
//              to DP: 32 for the steps; 16, 32 or 64 for flash attention),
//              the layout attn_fp32.cu's kernels read.
// Bound: the bytes each kernel moves at 3.35 TB/s (norm_fwd reads x and
// writes xn; norm_bwd reads x, dxn and gres and writes dx).  What the
// design gives up: the normed rows pass through device memory between the
// norm and the GEMM that reads them (the norm applied as core_nn loads A
// would save a read and a write of them).
//
// Dropout masks come from philox.cuh at the bf16 kernels' coordinates
// (ops/dropout.py): the outer and projection sites at (row, position,
// channel); the inner site is ffn_core_fp32.cu's, the probability site
// attn_fp32.cu's.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "philox.cuh"

namespace f32 {

constexpr int KT = 64;                   // qkv_split's Lp: a multiple of 64 rows
constexpr int NW = 8;                    // warps a norm block
constexpr int NPW = 4;                   // positions a warp of a norm block
constexpr int NP = NW * NPW;             // positions a norm block (norm_bwd's partial rows)
constexpr int MAX_C = 128;               // one float4 a lane

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

// This lane's channels 4 lane + j of a row of C: their groups (-1 past C).
// Where groups are whole float4s (dpg % 4 == 0: ``seg``), a lane's channels
// are one group's, which lanes [base, base + L) hold (i = lane - base); a
// lane past C is a group of its own.
struct NormLane {
  int grp[4], i, L, base;
  bool on, seg;
  __device__ NormLane(int C, int dpg) {
    const int lane = threadIdx.x & 31;
    on = 4 * lane < C;
    seg = dpg % 4 == 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) grp[j] = on ? (4 * lane + j) / dpg : -1;
    L = on && seg ? dpg / 4 : 1;
    base = on && seg ? grp[0] * L : lane;
    i = lane - base;
  }
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void unpack(const float4 v, float (&a)[4]) {
  a[0] = v.x, a[1] = v.y, a[2] = v.z, a[3] = v.w;
}

// s[j] = the sum over channel j's group of a[c] b[c] and, with TWO, t[j]
// that of u[c] b[c] (0 past C), the same bits in every lane of the group.
// Whole-float4 groups: each lane's partial (fmaf in channel order), a tree
// into the group's first lane (at distance 16, 8, 4, 2, 1, within the
// group), broadcast from it.  Other groups: per group, each lane's partial
// of its channels there, a butterfly over the warp.  Every lane of the
// warp calls (the shuffles).
template <bool TWO>
__device__ __forceinline__ void group_sums(const NormLane& ln, int G, const float (&a)[4],
                                           const float (&u)[4], const float (&b)[4],
                                           float (&s)[4], float (&t)[4]) {
  constexpr unsigned ALL = 0xffffffffu;
  if (ln.seg) {
    float ps = 0.f, pt = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ps = fmaf(a[j], b[j], ps);
      if (TWO) pt = fmaf(u[j], b[j], pt);
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      const float ws = __shfl_down_sync(ALL, ps, o);
      const float wt = TWO ? __shfl_down_sync(ALL, pt, o) : 0.f;
      if (ln.i + o < ln.L) {
        ps += ws;
        if (TWO) pt += wt;
      }
    }
    ps = __shfl_sync(ALL, ps, ln.base);
    if (TWO) pt = __shfl_sync(ALL, pt, ln.base);
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j] = ps, t[j] = pt;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j] = t[j] = 0.f;
  for (int g = 0; g < G; ++g) {
    float ps = 0.f, pt = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (ln.grp[j] == g) {
        ps = fmaf(a[j], b[j], ps);
        if (TWO) pt = fmaf(u[j], b[j], pt);
      }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      ps += __shfl_xor_sync(ALL, ps, o);
      if (TWO) pt += __shfl_xor_sync(ALL, pt, o);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (ln.grp[j] == g) s[j] = ps, t[j] = pt;
  }
}

// Per channel j, of its group's sums: inv = 1 / (rms + eps), rms = sqrt(ss)
// dpg^-1/2 (the reference's eps placement) and, with BWD, coef = dot inv^2
// / (dpg rms), 0 at rms 0; once a lane where its channels are one group's.
template <bool BWD>
__device__ __forceinline__ void norm_terms(const NormLane& ln, const float (&ss)[4],
                                           const float (&dot)[4], int dpg, float eps,
                                           float (&inv)[4], float (&coef)[4]) {
  const float rd = 1.f / sqrtf((float)dpg);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (ln.seg && j > 0) {
      inv[j] = inv[0], coef[j] = coef[0];
      continue;
    }
    const float rms = sqrtf(ss[j]) * rd;
    inv[j] = 1.f / (rms + eps);
    coef[j] = BWD && rms > 0.f ? dot[j] * inv[j] * inv[j] / ((float)dpg * rms) : 0.f;
  }
}

// RMSGroupNorm per (position, group), as the Pallas kernels' _norm_t:
// xn = x inv gamma.  Warp w of block b takes positions (b NW + w) NPW + t,
// t < NPW.
__global__ void __launch_bounds__(NW * 32)
    norm_fwd(const float* __restrict__ x, const float* __restrict__ gamma,
             float* __restrict__ xn, long long npos, int C, int G, float eps) {
  const int lane = threadIdx.x & 31, dpg = C / G;
  const NormLane ln(C, dpg);
  const long long p0 = ((long long)blockIdx.x * NW + (threadIdx.x >> 5)) * NPW;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float gm[4];
  unpack(ln.on ? ld4(gamma + 4 * lane) : zero, gm);
  float4 v[NPW];
#pragma unroll
  for (int t = 0; t < NPW; ++t)
    v[t] = ln.on && p0 + t < npos ? ld4(x + (p0 + t) * C + 4 * lane) : zero;
#pragma unroll
  for (int t = 0; t < NPW; ++t) {
    if (p0 + t >= npos) break;   // the same for every lane of the warp
    float a[4], ss[4], none[4], inv[4];
    unpack(v[t], a);
    group_sums<false>(ln, G, a, a, a, ss, none);
    norm_terms<false>(ln, ss, none, dpg, eps, inv, none);
    if (ln.on)
      *reinterpret_cast<float4*>(xn + (p0 + t) * C + 4 * lane) = make_float4(
          a[0] * inv[0] * gm[0], a[1] * inv[1] * gm[1], a[2] * inv[2] * gm[2],
          a[3] * inv[3] * gm[3]);
  }
}

// The norm's backward from dxn, positions as norm_fwd's, as the Pallas
// kernels': dx = gamma dxn inv - x coef (+ gres, the residual's gradient,
// when given), coef from the group's dot(gamma dxn, x); dgamma partials
// part[block][c] = the sum of dxn x inv over the block's NP positions.
__global__ void __launch_bounds__(NW * 32)
    norm_bwd(const float* __restrict__ x, const float* __restrict__ gamma,
             const float* __restrict__ dxn, const float* __restrict__ gres,
             float* __restrict__ dx, float* __restrict__ part, long long npos, int C, int G,
             float eps) {
  extern __shared__ float4 red[];   // [NW][C / 4]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, dpg = C / G;
  const NormLane ln(C, dpg);
  const long long p0 = ((long long)blockIdx.x * NW + warp) * NPW;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float gm[4];
  unpack(ln.on ? ld4(gamma + 4 * lane) : zero, gm);
  float4 xv[NPW], dv[NPW], rv[NPW];
#pragma unroll
  for (int t = 0; t < NPW; ++t) {
    const bool ok = ln.on && p0 + t < npos;
    const long long o = (p0 + t) * C + 4 * lane;
    xv[t] = ok ? ld4(x + o) : zero;
    dv[t] = ok ? ld4(dxn + o) : zero;
    rv[t] = ok && gres ? ld4(gres + o) : zero;
  }
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int t = 0; t < NPW; ++t) {
    if (p0 + t >= npos) break;   // the same for every lane of the warp
    float a[4], d[4], r[4], dg[4], ss[4], dot[4], inv[4], coef[4], o[4];
    unpack(xv[t], a);
    unpack(dv[t], d);
    unpack(rv[t], r);
#pragma unroll
    for (int j = 0; j < 4; ++j) dg[j] = d[j] * gm[j];
    group_sums<true>(ln, G, a, dg, a, ss, dot);
    norm_terms<true>(ln, ss, dot, dpg, eps, inv, coef);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[j] = dg[j] * inv[j] - a[j] * coef[j] + r[j];
      acc[j] += d[j] * a[j] * inv[j];
    }
    if (ln.on)
      *reinterpret_cast<float4*>(dx + (p0 + t) * C + 4 * lane) =
          make_float4(o[0], o[1], o[2], o[3]);
  }
  if (ln.on) red[warp * (C / 4) + lane] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  __syncthreads();
  const float* rf = reinterpret_cast<const float*>(red);
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < NW; ++w) s += rf[w * C + c];
    part[(long long)blockIdx.x * C + c] = s;
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

// The norms' refusals: C whole float4s up to MAX_C, whole groups, 16-byte
// aligned rows.
inline bool norm_ok(int C, int G, std::initializer_list<const void*> ptrs) {
  if (C < 4 || C > MAX_C || C % 4 || G < 1 || C % G) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) & 15) return false;
  return true;
}

}  // namespace f32

using namespace f32;

// Shared memory of each launch (bytes): 0 norm_bwd at width C (its warps'
// dgamma partials; the GEMMs' are ffn_core_fp32.cu's core_fp32_smem_bytes,
// the attention core's attn_fp32.cu's f32_attn_smem_bytes).
extern "C" long long step_fp32_smem_bytes(int which, int C) {
  switch (which) {
    case 0: return (long long)NW * C * 4;
  }
  return -1;
}

// Positions a norm_bwd block sums its dgamma partial over.
extern "C" int step_fp32_norm_positions() { return NP; }

extern "C" int f32_reduce(const void* part, long long S, long long n, long long seg, void* out,
                          void* stream) {
  if (S < 1 || seg < 1 || (S + seg - 1) / seg > 65535) return (int)cudaErrorInvalidValue;
  reduce<<<dim3(blocks(n, 256), (unsigned)((S + seg - 1) / seg)), 256, 0,
           (cudaStream_t)stream>>>((const float*)part, S, n, seg, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int f32_norm_fwd(const void* x, const void* gamma, void* xn, long long npos, int C,
                            int G, float eps, void* stream) {
  if (!norm_ok(C, G, {x, gamma, xn})) return (int)cudaErrorInvalidValue;
  if (npos < 1) return 0;
  norm_fwd<<<blocks(npos, NP), NW * 32, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)gamma, (float*)xn, npos, C, G, eps);
  return (int)cudaGetLastError();
}

extern "C" int f32_norm_bwd(const void* x, const void* gamma, const void* dxn, const void* gres,
                            void* dx, void* part, long long npos, int C, int G, float eps,
                            void* stream) {
  if (!norm_ok(C, G, {x, gamma, dxn, gres, dx})) return (int)cudaErrorInvalidValue;
  if (npos < 1) return 0;
  norm_bwd<<<blocks(npos, NP), NW * 32, NW * C * 4, (cudaStream_t)stream>>>(
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
