// Flash attention:  o = softmax(RoPE(q) RoPE(k)^T / sqrt(D)) v  over [..., L, D]
//
// Replaces the JAX package's Pallas kernel
// ``ops/pallas/flash_attention.py::_flash_forward`` (body ``_kernel``),
// public ``flash_attention``: no mask, no dropout, the interleaved-pair RoPE
// optionally fused on q and k in fp32.  The TPU kernel's max-free "bounded
// shift" (``_bounded_shift``) exists to avoid a cross-sublane max on the TPU;
// here the softmax is the ordinary online one (running max and sum in fp32),
// which is the exact softmax that shift approximates.
//
// Shapes: q, k, v [B, H, L, D] bf16 as strided views (element strides for
// batch, head and position; unit stride in D), o likewise.  The unfused MHSA
// passes the views of its QKV product [B, L, 3, H, D] and an o buffer
// [B, L, H, D], so no transpose runs on either side.  D is even and at most
// 64; it is zero-padded to DP (a multiple of 16, the MMA depth) in shared
// memory only.  xlarge: D 16, H 16, freq path L 2049 on 690 rows, time path
// L 345 on 4098 rows.
//
// What bounds it on the H100: the two products, 4*L^2*D FLOP per (row, head)
// (2.97 TFLOP per call on the xlarge freq path against 2.9 GB of q, k, v and
// o), so tensor-core arithmetic as long as the [L, L] scores never reach
// device memory (~185 GB in fp32 on that path).  Design (FlashAttention-2's
// forward, simple first):
//   * one block per (row and head, 128 queries), one warp per 16 queries;
//   * the q tile is read once, rotated in fp32 from cos/sin tables, scaled
//     by 1/sqrt(D), rounded to bf16 and held in registers as mma.sync A
//     fragments;
//   * a loop over 64-key tiles: K (rotated) staged in shared memory as it
//     is, V staged transposed, so that every B fragment is one 4-byte load;
//     S = Q K^T on mma.sync m16n8k16 (bf16 in, fp32 accumulate) stays in
//     registers, where the online softmax runs in fp32 (each row's max and
//     sum across the four lanes that hold it; keys >= L masked), and P,
//     rounded to bf16, is already laid out as the A fragments of O += P V;
//   * the normalised output rounded once to bf16; queries >= L never stored.
// K and V tiles are re-read from L2 and re-rotated by every query tile of a
// head, and the loads are 4-byte pairs (strided views); wider loads, TMA,
// and wgmma are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NW = 8;           // warps per block, 16 queries each
constexpr int NT = NW * 32;
constexpr int BQ = NW * 16;     // queries per block
constexpr int TK = 64;          // keys per tile

struct Strides {
  long long b, h, l;
};

template <int DP>
struct Lay {
  static constexpr int LD = DP + 8;   // q [BQ, LD] and k [TK, LD] tiles, bf16
  static constexpr int LDV = TK + 8;  // v tile transposed [DP, LDV] bf16
  static constexpr size_t qt = (size_t)BQ * LD * 2;
  static constexpr size_t kt = (size_t)TK * LD * 2;
  static constexpr size_t vt = (size_t)DP * LDV * 2;
  static constexpr size_t bytes = qt + kt + vt;
};

// Positions p0 .. p0+rows-1 of one (row, head) sequence: pairs (2j, 2j+1)
// rotated by RoPE in fp32 when ``rot``, times ``mul``, rounded to bf16;
// zero for positions >= L and for dims >= D.  Stored as rows [rows, DP + 8]
// or, with ``transposed``, as columns of [DP, TK + 8].
template <int DP>
__device__ __forceinline__ void load_tile(const bf16* __restrict__ src, long long sl,
                                          int p0, int rows, int L, int D,
                                          const float* __restrict__ cosv,
                                          const float* __restrict__ sinv, bool rot,
                                          float mul, bool transposed, bf16* dst) {
  constexpr int PAIRS = DP / 2;
  const int half = D / 2;
  for (int i = threadIdx.x; i < rows * PAIRS; i += NT) {
    const int r = i / PAIRS, j = i % PAIRS;
    const int pos = p0 + r;
    float a = 0.f, c = 0.f;
    if (pos < L && j < half) {
      const __nv_bfloat162 pr = *(const __nv_bfloat162*)(src + pos * sl + 2 * j);
      const float x0 = __low2float(pr), x1 = __high2float(pr);
      a = x0;
      c = x1;
      if (rot) {
        const float cs = cosv[(size_t)pos * half + j], sn = sinv[(size_t)pos * half + j];
        a = x0 * cs - x1 * sn;
        c = x1 * cs + x0 * sn;
      }
      a *= mul;
      c *= mul;
    }
    if (transposed) {
      dst[(2 * j) * Lay<DP>::LDV + r] = __float2bfloat16(a);
      dst[(2 * j + 1) * Lay<DP>::LDV + r] = __float2bfloat16(c);
    } else {
      *(__nv_bfloat162*)(dst + r * Lay<DP>::LD + 2 * j) = __floats2bfloat162_rn(a, c);
    }
  }
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) { return *(const uint32_t*)p; }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *(const uint32_t*)&v;
}

// d[16x8] += a[16x16] b[16x8], bf16 in, fp32 accumulate.  Fragments (lane =
// 4 g + c): a = rows g, g+8 x cols 2c, 2c+1 (+8); b = k 2c, 2c+1 (+8) x
// col g; d = rows g, g+8 x cols 2c, 2c+1.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int DP>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o,
    const float* __restrict__ cosv, const float* __restrict__ sinv,
    float* __restrict__ lse, int H, int L, int D, int rope, float scale, Strides sq,
    Strides sk, Strides sv, Strides so) {
  using S = Lay<DP>;
  constexpr int LD = S::LD, LDV = S::LDV;
  constexpr int KD = DP / 16;  // k-steps of S = Q K^T
  constexpr int ND = DP / 8;   // 8-wide column tiles of O
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = (bf16*)smem;
  bf16* ks = (bf16*)(smem + S::qt);
  bf16* vt = (bf16*)(smem + S::qt + S::kt);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c = lane & 3;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = blockIdx.y * BQ;
  const bf16* qg = q + b * sq.b + h * sq.h;
  const bf16* kg = k + b * sk.b + h * sk.h;
  const bf16* vg = v + b * sv.b + h * sv.h;

  load_tile<DP>(qg, sq.l, q0, BQ, L, D, cosv, sinv, rope != 0, scale, false, qs);
  __syncthreads();
  uint32_t qf[KD][4];
  const bf16* qw = qs + warp * 16 * LD;
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    qf[kd][0] = ld32(qw + g * LD + kd * 16 + 2 * c);
    qf[kd][1] = ld32(qw + (g + 8) * LD + kd * 16 + 2 * c);
    qf[kd][2] = ld32(qw + g * LD + kd * 16 + 2 * c + 8);
    qf[kd][3] = ld32(qw + (g + 8) * LD + kd * 16 + 2 * c + 8);
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // rows g and g+8 of the warp's 16 queries: running max and (this lane's
  // part of the) sum
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
  const int n_kv = (L + TK - 1) / TK;
  for (int t = 0; t < n_kv; ++t) {
    const int j0 = t * TK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<DP>(kg, sk.l, j0, TK, L, D, cosv, sinv, rope != 0, 1.f, false, ks);
    load_tile<DP>(vg, sv.l, j0, TK, L, D, cosv, sinv, false, 1.f, true, vt);
    __syncthreads();

    // S [16, 64] = Q K^T: 8 column tiles of 8 keys
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        const bf16* kr = ks + (8 * j + g) * LD + kd * 16 + 2 * c;
        mma_bf16(sc[j], qf[kd], ld32(kr), ld32(kr + 8));
      }
    }
    // online softmax in fp32; keys >= L masked
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (j0 + 8 * j + 2 * c + e >= L) sc[j][e] = sc[j][2 + e] = -CUDART_INF_F;
        mx0 = fmaxf(mx0, sc[j][e]);
        mx1 = fmaxf(mx1, sc[j][2 + e]);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float a0 = __expf(m0 - mn0), a1 = __expf(m1 - mn1);  // finite: key j0 < L
    m0 = mn0;
    m1 = mn1;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[j][e] = __expf(sc[j][e] - mn0);
        sc[j][2 + e] = __expf(sc[j][2 + e] - mn1);
        s0 += sc[j][e];
        s1 += sc[j][2 + e];
      }
    }
    l0 = l0 * a0 + s0;
    l1 = l1 * a1 + s1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
    }
    // O += P V: P's accumulator tiles 2kk, 2kk+1 are the A fragment of keys
    // 16 kk .. 16 kk + 15
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const bf16* vr = vt + (8 * n + g) * LDV + 16 * kk + 2 * c;
        mma_bf16(acc[n], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  const float sum0 = quad_sum(l0), sum1 = quad_sum(l1);
  const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
  const int qa = q0 + warp * 16 + g, qb = qa + 8;
  if (lse != nullptr && c == 0) {  // training stash: log-sum-exp of the scaled scores
    if (qa < L) lse[(size_t)blockIdx.x * L + qa] = m0 + logf(sum0);
    if (qb < L) lse[(size_t)blockIdx.x * L + qb] = m1 + logf(sum1);
  }
  bf16* oa = o + b * so.b + h * so.h + qa * so.l;
  bf16* ob = o + b * so.b + h * so.h + qb * so.l;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = 8 * n + 2 * c;
    if (col < D) {
      if (qa < L)
        *(__nv_bfloat162*)(oa + col) = __floats2bfloat162_rn(acc[n][0] * inv0, acc[n][1] * inv0);
      if (qb < L)
        *(__nv_bfloat162*)(ob + col) = __floats2bfloat162_rn(acc[n][2] * inv1, acc[n][3] * inv1);
    }
  }
}

template <int DP>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, const float* cosv,
           const float* sinv, float* lse, int B, int H, int L, int D, int rope,
           float scale, Strides sq, Strides sk, Strides sv, Strides so, cudaStream_t st) {
  const size_t smem = Lay<DP>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(B * H), (unsigned)((L + BQ - 1) / BQ));
  flash_fwd_kernel<DP><<<grid, NT, smem, st>>>(q, k, v, o, cosv, sinv, lse, H, L, D,
                                               rope, scale, sq, sk, sv, so);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- backward
//
// Kernel #7: dq, dk, dv of o = softmax(s) v with s = (scale R(q)) R(k)^T,
// FlashAttention-2's backward in two launches with no atomics (the result
// is the same bits on every run), after a pre-pass:
//   pre:   delta[i] = sum_d dO[i, d] o[i, d]                  (fp32, per query)
//   dq:    one block per (row and head, 128 queries), a loop over 64-key
//          tiles: P = exp(S - lse) recomputed from the forward's stash,
//          dP = dO V^T, dS = P (dP - delta), dq += dS K; at the end
//          dq = scale R^T(dq), the inverse rotation on the fp32 pairs in
//          registers;
//   dkdv:  one block per (row and head, 128 keys), a loop over 64-query
//          tiles: P^T, dV += P^T dO, dP^T = V dO^T, dS^T, dK += dS^T (scale
//          R(q)); at the end dk = R^T(dk).
// Every product is mma.sync m16n8k16 (bf16 in, fp32 accumulate); P and dS
// are rounded to bf16 only as A fragments of the next product, as the
// forward rounds P.  Rotated and scaled q, rotated k are rebuilt in shared
// memory from the inputs exactly as the forward builds them, so the
// recomputed scores are the forward's.  What bounds it: the five products,
// 10 L^2 D FLOP per (row, head) (2.5x the forward's), against q, k, v, o,
// dO read and dq, dk, dv written once.

__global__ void flash_bwd_pre_kernel(const bf16* __restrict__ o,
                                     const bf16* __restrict__ dout,
                                     float* __restrict__ delta, int H, int L, int D,
                                     Strides so, Strides sd, long long n) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const long long bh = idx / L;
  const int i = (int)(idx % L), b = (int)(bh / H), h = (int)(bh % H);
  const bf16* orow = o + b * so.b + h * so.h + i * so.l;
  const bf16* drow = dout + b * sd.b + h * sd.h + i * sd.l;
  float acc = 0.f;
  for (int d = 0; d < D; ++d) acc += __bfloat162float(orow[d]) * __bfloat162float(drow[d]);
  delta[idx] = acc;
}

template <int DP>
struct BLay {
  static constexpr int LD = Lay<DP>::LD, LDV = Lay<DP>::LDV;
  static constexpr size_t own = (size_t)BQ * LD * 2;   // the block's own 128 rows
  static constexpr size_t rows = (size_t)TK * LD * 2;  // a 64-row tile
  static constexpr size_t cols = (size_t)DP * LDV * 2; // a 64-row tile transposed
  static constexpr size_t dq = own + 2 * rows + cols;            // k, v rows; k^T
  static constexpr size_t dkdv = own + 2 * rows + 2 * cols + 2 * TK * 4;
};

// The block's own 16 rows per warp as mma A fragments (rows g, g+8).
template <int DP>
__device__ __forceinline__ void own_frags(const bf16* tile, int warp, int g, int c,
                                          uint32_t (*f)[4]) {
  constexpr int LD = Lay<DP>::LD;
  const bf16* w = tile + warp * 16 * LD;
#pragma unroll
  for (int kd = 0; kd < DP / 16; ++kd) {
    f[kd][0] = ld32(w + g * LD + kd * 16 + 2 * c);
    f[kd][1] = ld32(w + (g + 8) * LD + kd * 16 + 2 * c);
    f[kd][2] = ld32(w + g * LD + kd * 16 + 2 * c + 8);
    f[kd][3] = ld32(w + (g + 8) * LD + kd * 16 + 2 * c + 8);
  }
}

// acc [16, 64] += A [16, DP] (fragments) x B^T, B's 64 rows [64, LD] in
// shared memory (keys for S, values for dP, ...).
template <int DP>
__device__ __forceinline__ void mma_rows(float (*acc)[4], uint32_t (*a)[4],
                                         const bf16* rows, int g, int c) {
  constexpr int LD = Lay<DP>::LD;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < DP / 16; ++kd) {
      const bf16* r = rows + (8 * j + g) * LD + kd * 16 + 2 * c;
      mma_bf16(acc[j], a[kd], ld32(r), ld32(r + 8));
    }
  }
}

// out [16, DP] += P [16, 64] (accumulator layout, rounded to bf16 here) x
// T, T given transposed [DP, LDV] in shared memory.
template <int DP>
__device__ __forceinline__ void mma_cols(float (*out)[4], float (*p)[4],
                                         const bf16* cols, int g, int c) {
  constexpr int LDV = Lay<DP>::LDV;
#pragma unroll
  for (int kk = 0; kk < TK / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const bf16* r = cols + (8 * n + g) * LDV + 16 * kk + 2 * c;
      mma_bf16(out[n], pa, ld32(r), ld32(r + 8));
    }
  }
}

// Store fp32 accumulator rows (g, g+8 of the warp) as bf16 pairs, times
// ``mul`` and rotated back by R^T (RoPE at -theta) when ``rot``.
template <int DP>
__device__ __forceinline__ void store_rows(float (*acc)[4], bf16* base, long long sl,
                                           int pa, int pb, int L, int D, float mul,
                                           bool rot, const float* __restrict__ cosv,
                                           const float* __restrict__ sinv, int c) {
  const int half = D / 2;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = 8 * n + 2 * c;
    if (col >= D) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int pos = r ? pb : pa;
      if (pos >= L) continue;
      float a = acc[n][2 * r] * mul, b = acc[n][2 * r + 1] * mul;
      if (rot) {
        const float cs = cosv[(size_t)pos * half + col / 2];
        const float sn = sinv[(size_t)pos * half + col / 2];
        const float a2 = a * cs + b * sn;
        b = b * cs - a * sn;
        a = a2;
      }
      *(__nv_bfloat162*)(base + pos * sl + col) = __floats2bfloat162_rn(a, b);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq,
    const float* __restrict__ cosv, const float* __restrict__ sinv, int H, int L, int D,
    int rope, float scale, Strides sq, Strides sk, Strides sv, Strides sd, Strides sdq) {
  using S = BLay<DP>;
  constexpr int KD = DP / 16, ND = DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* own = (bf16*)smem;
  bf16* ks = (bf16*)(smem + S::own);
  bf16* vs = (bf16*)(smem + S::own + S::rows);
  bf16* kt = (bf16*)(smem + S::own + 2 * S::rows);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * BQ;
  const bool rot = rope != 0;
  const bf16* kg = k + b * sk.b + h * sk.h;
  const bf16* vg = v + b * sv.b + h * sv.h;

  uint32_t qf[KD][4], df[KD][4];
  load_tile<DP>(q + b * sq.b + h * sq.h, sq.l, q0, BQ, L, D, cosv, sinv, rot, scale, false,
                own);
  __syncthreads();
  own_frags<DP>(own, warp, g, c, qf);
  __syncthreads();
  load_tile<DP>(dout + b * sd.b + h * sd.h, sd.l, q0, BQ, L, D, cosv, sinv, false, 1.f,
                false, own);
  __syncthreads();
  own_frags<DP>(own, warp, g, c, df);

  const int qa = q0 + warp * 16 + g, qb = qa + 8;
  const float* lrow = lse + (size_t)bh * L;
  const float* drow = delta + (size_t)bh * L;
  // queries >= L: lse = +inf gives P = 0, so they add nothing
  const float la = qa < L ? lrow[qa] : CUDART_INF_F, lb = qb < L ? lrow[qb] : CUDART_INF_F;
  const float da = qa < L ? drow[qa] : 0.f, db = qb < L ? drow[qb] : 0.f;

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int n_kv = (L + TK - 1) / TK;
  for (int t = 0; t < n_kv; ++t) {
    const int j0 = t * TK;
    __syncthreads();
    load_tile<DP>(kg, sk.l, j0, TK, L, D, cosv, sinv, rot, 1.f, false, ks);
    load_tile<DP>(kg, sk.l, j0, TK, L, D, cosv, sinv, rot, 1.f, true, kt);
    load_tile<DP>(vg, sv.l, j0, TK, L, D, cosv, sinv, false, 1.f, false, vs);
    __syncthreads();
    float p[8][4], dp[8][4];
    mma_rows<DP>(p, qf, ks, g, c);    // S = Q K^T
    mma_rows<DP>(dp, df, vs, g, c);   // dP = dO V^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool live = j0 + 8 * j + 2 * c + e < L;
        const float pa = live ? __expf(p[j][e] - la) : 0.f;
        const float pb = live ? __expf(p[j][2 + e] - lb) : 0.f;
        p[j][e] = pa * (dp[j][e] - da);           // dS
        p[j][2 + e] = pb * (dp[j][2 + e] - db);
      }
    mma_cols<DP>(acc, p, kt, g, c);   // dQ += dS K
  }
  store_rows<DP>(acc, dq + b * sdq.b + h * sdq.h, sdq.l, qa, qb, L, D, scale, rot, cosv,
                 sinv, c);
}

template <int DP>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
    const float* __restrict__ cosv, const float* __restrict__ sinv, int H, int L, int D,
    int rope, float scale, Strides sq, Strides sk, Strides sv, Strides sd, Strides sdk,
    Strides sdv) {
  using S = BLay<DP>;
  constexpr int KD = DP / 16, ND = DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* own = (bf16*)smem;
  bf16* qs = (bf16*)(smem + S::own);
  bf16* ds = (bf16*)(smem + S::own + S::rows);
  bf16* qt = (bf16*)(smem + S::own + 2 * S::rows);
  bf16* dt = (bf16*)(smem + S::own + 2 * S::rows + S::cols);
  float* ls = (float*)(smem + S::own + 2 * S::rows + 2 * S::cols);
  float* dl = ls + TK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int k0 = blockIdx.y * BQ;
  const bool rot = rope != 0;
  const bf16* qg = q + b * sq.b + h * sq.h;
  const bf16* dg = dout + b * sd.b + h * sd.h;
  const float* lrow = lse + (size_t)bh * L;
  const float* drow = delta + (size_t)bh * L;

  uint32_t kf[KD][4], vf[KD][4];
  load_tile<DP>(k + b * sk.b + h * sk.h, sk.l, k0, BQ, L, D, cosv, sinv, rot, 1.f, false,
                own);
  __syncthreads();
  own_frags<DP>(own, warp, g, c, kf);
  __syncthreads();
  load_tile<DP>(v + b * sv.b + h * sv.h, sv.l, k0, BQ, L, D, cosv, sinv, false, 1.f, false,
                own);
  __syncthreads();
  own_frags<DP>(own, warp, g, c, vf);

  float acck[ND][4], accv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acck[n][e] = accv[n][e] = 0.f;
  const int n_q = (L + TK - 1) / TK;
  for (int t = 0; t < n_q; ++t) {
    const int i0 = t * TK;
    __syncthreads();
    load_tile<DP>(qg, sq.l, i0, TK, L, D, cosv, sinv, rot, scale, false, qs);
    load_tile<DP>(qg, sq.l, i0, TK, L, D, cosv, sinv, rot, scale, true, qt);
    load_tile<DP>(dg, sd.l, i0, TK, L, D, cosv, sinv, false, 1.f, false, ds);
    load_tile<DP>(dg, sd.l, i0, TK, L, D, cosv, sinv, false, 1.f, true, dt);
    for (int i = threadIdx.x; i < TK; i += NT) {
      const int pos = i0 + i;
      ls[i] = pos < L ? lrow[pos] : CUDART_INF_F;   // P = 0 for queries >= L
      dl[i] = pos < L ? drow[pos] : 0.f;
    }
    __syncthreads();
    float p[8][4], dp[8][4];
    mma_rows<DP>(p, kf, qs, g, c);    // S^T = K Q^T (keys g, g+8 x 64 queries)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] = __expf(p[j][e] - ls[8 * j + 2 * c + (e & 1)]);
    mma_cols<DP>(accv, p, dt, g, c);  // dV += P^T dO
    mma_rows<DP>(dp, vf, ds, g, c);   // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] *= dp[j][e] - dl[8 * j + 2 * c + (e & 1)];
    mma_cols<DP>(acck, p, qt, g, c);  // dK += dS^T (scale R(q))
  }
  const int ka = k0 + warp * 16 + g, kb = ka + 8;
  store_rows<DP>(acck, dk + b * sdk.b + h * sdk.h, sdk.l, ka, kb, L, D, 1.f, rot, cosv,
                 sinv, c);
  store_rows<DP>(accv, dv + b * sdv.b + h * sdv.h, sdv.l, ka, kb, L, D, 1.f, false, cosv,
                 sinv, c);
}

struct BwdArgs {
  const bf16 *q, *k, *v, *o, *dout;
  const float *lse, *cosv, *sinv;
  float* delta;
  bf16 *dq, *dk, *dv;
  int B, H, L, D, rope;
  float scale;
  Strides sq, sk, sv, so, sd, sdq, sdk, sdv;
};

template <int DP>
int launch_bwd(const BwdArgs& a, cudaStream_t st) {
  const long long n = (long long)a.B * a.H * a.L;
  flash_bwd_pre_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      a.o, a.dout, a.delta, a.H, a.L, a.D, a.so, a.sd, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(a.B * a.H), (unsigned)((a.L + BQ - 1) / BQ));
  e = cudaFuncSetAttribute(flash_bwd_dq_kernel<DP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)BLay<DP>::dq);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_kernel<DP><<<grid, NT, BLay<DP>::dq, st>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dq, a.cosv, a.sinv, a.H, a.L, a.D, a.rope,
      a.scale, a.sq, a.sk, a.sv, a.sd, a.sdq);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<DP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)BLay<DP>::dkdv);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv_kernel<DP><<<grid, NT, BLay<DP>::dkdv, st>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dk, a.dv, a.cosv, a.sinv, a.H, a.L, a.D,
      a.rope, a.scale, a.sq, a.sk, a.sv, a.sd, a.sdk, a.sdv);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: [B, H, L, D] bf16 with element strides (b, h, l) each and unit
// stride in D, every stride even (pairs are read as 4-byte words); cos/sin
// [L, D/2] fp32 (read only with rope != 0); scale = 1/sqrt(D).  D even,
// 2 <= D <= 64 (the wrapper checks).  lse: null, or [B*H, L] fp32 for the
// backward (training).
extern "C" int flash_attention_forward(
    const void* q, const void* k, const void* v, void* o, const void* cosv,
    const void* sinv, void* lse, int B, int H, int L, int D, int rope, float scale,
    long long qb, long long qh, long long ql, long long kb, long long kh,
    long long kl, long long vb, long long vh, long long vl, long long ob,
    long long oh, long long ol, void* stream) {
  const Strides sq{qb, qh, ql}, sk{kb, kh, kl}, sv{vb, vh, vl}, so{ob, oh, ol};
  const cudaStream_t st = (cudaStream_t)stream;
#define FLASH_ARGS                                                                   \
  (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (const float*)cosv,      \
      (const float*)sinv, (float*)lse, B, H, L, D, rope, scale, sq, sk, sv, so, st
  const int dp = (D + 15) / 16 * 16;
  switch (dp) {
    case 16: return launch<16>(FLASH_ARGS);
    case 32: return launch<32>(FLASH_ARGS);
    case 48: return launch<48>(FLASH_ARGS);
    case 64: return launch<64>(FLASH_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_ARGS
}

// Backward (kernel #7).  q, k, v, o as the forward's; dout, dq, dk, dv
// [B, H, L, D] bf16 strided views likewise; lse [B*H, L] fp32, the
// forward's stash; delta [B*H, L] fp32 scratch.  strides: 24 element
// strides, (b, h, l) of q, k, v, o, dout, dq, dk, dv in that order.
extern "C" int flash_attention_backward(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, void* dk, void* dv, const void* cosv,
    const void* sinv, int B, int H, int L, int D, int rope, float scale,
    const long long* strides, void* stream) {
  BwdArgs a;
  a.q = (const bf16*)q;
  a.k = (const bf16*)k;
  a.v = (const bf16*)v;
  a.o = (const bf16*)o;
  a.dout = (const bf16*)dout;
  a.lse = (const float*)lse;
  a.cosv = (const float*)cosv;
  a.sinv = (const float*)sinv;
  a.delta = (float*)delta;
  a.dq = (bf16*)dq;
  a.dk = (bf16*)dk;
  a.dv = (bf16*)dv;
  a.B = B;
  a.H = H;
  a.L = L;
  a.D = D;
  a.rope = rope;
  a.scale = scale;
  Strides* s[8] = {&a.sq, &a.sk, &a.sv, &a.so, &a.sd, &a.sdq, &a.sdk, &a.sdv};
  for (int i = 0; i < 8; ++i) *s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const cudaStream_t st = (cudaStream_t)stream;
  switch ((D + 15) / 16 * 16) {
    case 16: return launch_bwd<16>(a, st);
    case 32: return launch_bwd<32>(a, st);
    case 48: return launch_bwd<48>(a, st);
    case 64: return launch_bwd<64>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
