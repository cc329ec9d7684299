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
    const float* __restrict__ cosv, const float* __restrict__ sinv, int H, int L,
    int D, int rope, float scale, Strides sq, Strides sk, Strides sv, Strides so) {
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

  const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);
  const int qa = q0 + warp * 16 + g, qb = qa + 8;
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
           const float* sinv, int B, int H, int L, int D, int rope, float scale,
           Strides sq, Strides sk, Strides sv, Strides so, cudaStream_t st) {
  const size_t smem = Lay<DP>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(B * H), (unsigned)((L + BQ - 1) / BQ));
  flash_fwd_kernel<DP><<<grid, NT, smem, st>>>(q, k, v, o, cosv, sinv, H, L, D, rope,
                                               scale, sq, sk, sv, so);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: [B, H, L, D] bf16 with element strides (b, h, l) each and unit
// stride in D, every stride even (pairs are read as 4-byte words); cos/sin
// [L, D/2] fp32 (read only with rope != 0); scale = 1/sqrt(D).  D even,
// 2 <= D <= 64 (the wrapper checks).
extern "C" int flash_attention_forward(
    const void* q, const void* k, const void* v, void* o, const void* cosv,
    const void* sinv, int B, int H, int L, int D, int rope, float scale,
    long long qb, long long qh, long long ql, long long kb, long long kh,
    long long kl, long long vb, long long vh, long long vl, long long ob,
    long long oh, long long ol, void* stream) {
  const Strides sq{qb, qh, ql}, sk{kb, kh, kl}, sv{vb, vh, vl}, so{ob, oh, ol};
  const cudaStream_t st = (cudaStream_t)stream;
#define FLASH_ARGS                                                                   \
  (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (const float*)cosv,      \
      (const float*)sinv, B, H, L, D, rope, scale, sq, sk, sv, so, st
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
