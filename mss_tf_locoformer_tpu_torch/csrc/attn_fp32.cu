// fp32 attention core on the tensor cores in three TF32 passes (3xTF32):
// the flash forward (#6) and backward (#7) at fp32, which are also the core
// of the fused attention step's fp32 rows (#3, #4).
//
// Replace, for fp32 rows, the JAX package's Pallas kernels
//   ops/pallas/flash_attention.py:207 _flash_forward, :315 _flash_backward_pallas,
// and the attention core inside
//   ops/pallas/attention_block.py:393 _attn_forward, :626 _attn_backward_pallas
// at their fp32 itemsize.  step_fp32.cu's qkv_split writes the operands as
// [R, H, Lp, DP] (q and k rotated by RoPE, rows L..Lp-1 and dims D..DP-1
// zero, Lp a multiple of 64, DP 16, 32 or 64); ops/cuda/step_fp32.py and
// ops/cuda/unfused_fp32.py call the two entry points below between their
// other launches.  Contracts: fp32 in, fp32 out; o [R, L, H D]; the natural
// log-sum-exp [R, H, L]; the backward writes dq, dk (RoPE undone) and dv
// into dqkv [R, L, 3 H D]; the probability dropout site at (row, head,
// key, query) with the undropped denominator (philox.cuh, ops/dropout.py).
//
// Design.  Every product runs on mma.sync m16n8k8 .tf32 (m16n8k4 for a head
// dim's last 4), each operand split into TF32 hi and lo halves and lo hi' +
// hi lo' + hi hi' summed in fp32 (tf32x3.cuh): fp32's accuracy at 0.41x the
// FFMA bound.  A warp owns 16 rows (32 at DP 16: two m16 tiles sharing each
// fragment of the other operand) and keeps them in registers; the other
// operand streams through a 3-stage cp.async ring of 64-row chunks in shared
// memory, rows of DP + 4 floats so that every fragment load below is free
// of bank conflicts.  The products run over the head dims rounded up to 4
// (DK: 12 = a k8 and a k4 step, 24 = three k8 steps of DP 32's four),
// instantiated for the shipped head dims; any other runs the padded width.
//   attn_fwd_tc   q' = q scale log2 e (folded once, into the A fragments);
//                 S' = q' k^T - m started in the accumulator, P = ex2(S')
//                 in the exp2 domain with flash_tile.cuh's lazy max (P taken
//                 with the old max, the exact rescale only when a lane's
//                 share of a row's tile sum leaves [0, 2^14], or the first
//                 tile's row sum falls below 1).  P stays in registers: the
//                 m16n8 accumulator holds keys 2c and 2c+1 of an 8-key tile
//                 in lane c, which P V reads as its A columns c and c + 4,
//                 with V's B rows taken in the same key order (no shuffle,
//                 no shared-memory round trip).  Each 16-key tile's P V goes
//                 into fresh accumulators and is added in fp32 into O after
//                 the rescale: the tensor cores truncate as they add, which
//                 over 2049 keys would shrink O by ~1e-5 of itself.
//   attn_dq_tc    per query: delta = dO . o (on the tensor cores, with dP's
//                 products in dP's order, so that a softmax over one key
//                 gives dS = 0 exactly), S' = q' k^T - lse log2 e, P, dP =
//                 dO v^T, dS = P (drop(dP) - delta), dQ += dS k (dS as P
//                 above); dO kept as [R, H, Lp, DP] and delta for dk/dv.
//   attn_dkdv_tc  per key: S'^T = k' q^T - lse log2 e (k' = k scale log2 e),
//                 P^T, dP^T = v dO^T, dV += drop(P)^T dO, dK += dS^T q.
// Dropout words are drawn once per 4 keys of a query (one Philox4x32-10 per
// 4 scores): in the forward and dq kernels lanes c and c ^ 1 hold the same
// 4-key group of two rows and each draws one row's, swapping halves; in the
// dk/dv kernel the 4 lanes of a key group draw one (group, query) each and
// transpose the words in two shuffles.
// Bound at the shipped shapes: the products at 3 x FLOP / 494.7 TFLOP/s
// (TF32 peak), or one exponential per score at 3.9 T/s, whichever is larger.
// What holds it (measured on an H100): instruction issue, not the tensor
// cores.  Every use of an operand splits it again (a warp per fragment it
// reads, and P and dS per score), and a split is 5 instructions against the
// 3 MMAs it feeds; cvt.rna.tf32.f32 compiles to 4 or more, so rna() rounds
// on the bit pattern in 2.  Tiles of 16 keys and, in the backward, a
// register cap for more warps a scheduler measured faster than 32-key tiles,
// one tile a warp and uncapped registers; summing the passes in separate
// accumulators (more chains of dependent MMAs) measured no faster.  What it
// gives up: mma.sync rather than wgmma, and each warp splitting the shared
// k and v (q and dO) fragments again.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <math_constants.h>
#include <stdint.h>

#include "philox.cuh"
#include "tf32x3.cuh"

// Internal linkage throughout: another build of this file loaded in the same
// process (a benchmark's parent checkout) shares no symbol with this one.
namespace af32 {
namespace {

using namespace tf32x3;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// A lane's share of a row's tile sum of P above this (a quarter of
// flash_tile.cuh's 2^16) sends the warp to the exact path.
constexpr float LANE_LIMIT = 16384.f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NW = 4;                  // warps a block
constexpr int NT = 32 * NW;
constexpr int KC = 64;                 // rows of a staged chunk (keys, or queries)
constexpr int STAGES = 3;              // the cp.async ring
constexpr int NJ = 2;                  // n8 tiles of a score tile: 16 keys (queries)

// Shared memory: per stage two chunks of KC rows of DP + 4 floats (k and v,
// or q and dO); the dk/dv kernel adds the chunk's log-sum-exp and delta.
__host__ __device__ constexpr long long fwd_smem(int dp) {
  return (long long)STAGES * 2 * KC * (dp + 4) * 4;
}
__host__ __device__ constexpr long long dkdv_smem(int dp) {
  return fwd_smem(dp) + (long long)STAGES * 2 * KC * 4;
}

// m16 tiles a warp (at DP 16 a warp's 32 rows share each k and v fragment
// between two tiles; wider rows would not fit in the registers), and the
// backward's blocks an SM (its register cap: 4 blocks at head dims 24 take
// 128 registers a thread, 3 at DP 16 with two tiles and at 32 dims 170).
template <int DP>
__host__ __device__ constexpr int warp_mt() { return DP == 16 ? 2 : 1; }
template <int DP, int DK>
__host__ __device__ constexpr int bwd_minb() { return DP == 64 ? 1 : DK == 24 ? 4 : 3; }

// An operand rounded to nearest TF32 (ties away from zero) on its bit
// pattern: half the weight of the 13 dropped bits added, then dropped.  For
// finite operands these are cvt.rna.tf32.f32's bits, in two integer
// instructions where cvt.rna takes four or more.
__device__ __forceinline__ uint32_t rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;
}

// The TF32 halves of an operand, each rounded to nearest (tf32x3::split,
// on the bit pattern).
__device__ __forceinline__ Split sp(float a) {
  const uint32_t hi = rna(a);
  return {hi, rna(a - __uint_as_float(hi))};
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(FULL, v, 1));
  return fmaxf(v, __shfl_xor_sync(FULL, v, 2));
}

// 4 bytes from ``src`` into shared memory at ``dst``; zero when !ok.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

// mma.sync m16n8k8 / m16n8k4 .tf32 (fragments as tf32x3::mma_tf32; the k4
// form: a = {A[g][c], A[g+8][c]}, b = B[c][g]).  Not volatile, so that the
// scheduler may interleave them with the splits around them.
__device__ __forceinline__ void mma8(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                     uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma4(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// The A fragments of one m16 tile over the head dims: element e of k8 step
// ks is A[g + 8 (e & 1)][8 ks + c + 4 (e >> 1)].  HOLD keeps them as TF32
// halves (one split an element); otherwise (DP 64, whose halves would not
// fit in the registers) raw, split at each use.
template <int DP, bool HOLD>
struct AFrag;

template <int DP>
struct AFrag<DP, true> {
  uint32_t hi[DP / 8][4], lo[DP / 8][4];
  __device__ __forceinline__ void set(int ks, int e, float x) {
    const Split s = sp(x);
    hi[ks][e] = s.hi;
    lo[ks][e] = s.lo;
  }
  __device__ __forceinline__ void get(int ks, uint32_t (&h)[4], uint32_t (&l)[4]) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      h[e] = hi[ks][e];
      l[e] = lo[ks][e];
    }
  }
};

template <int DP>
struct AFrag<DP, false> {
  float raw[DP / 8][4];
  __device__ __forceinline__ void set(int ks, int e, float x) { raw[ks][e] = x; }
  __device__ __forceinline__ void get(int ks, uint32_t (&h)[4], uint32_t (&l)[4]) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const Split s = sp(raw[ks][e]);
      h[e] = s.hi;
      l[e] = s.lo;
    }
  }
};

// A fragments of the 16 rows row0.. of a [rows, DP] tensor, times mul; rows
// at or past ``nrows`` read as zero.
template <int DP, bool HOLD>
__device__ __forceinline__ void load_a(AFrag<DP, HOLD>& a, const float* base, int row0,
                                       int nrows, float mul, int g, int c) {
#pragma unroll
  for (int ks = 0; ks < DP / 8; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + 8 * (e & 1);
      a.set(ks, e, row < nrows ? base[(long long)row * DP + 8 * ks + c + 4 * (e >> 1)] * mul
                               : 0.f);
    }
}

// One k step of a head-dim product: d += A B in three passes, the small
// products first (BFIRST: B's small half first, hi lo', lo hi', hi hi', the
// order A's small half first gives when A and B swap roles).
template <bool BFIRST>
__device__ __forceinline__ void step8(float (&d)[4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], Split b0, Split b1) {
  if (BFIRST) {
    mma8(d, ah, b0.lo, b1.lo);
    mma8(d, al, b0.hi, b1.hi);
  } else {
    mma8(d, al, b0.hi, b1.hi);
    mma8(d, ah, b0.lo, b1.lo);
  }
  mma8(d, ah, b0.hi, b1.hi);
}

template <bool BFIRST>
__device__ __forceinline__ void step4(float (&d)[4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], Split b) {
  if (BFIRST) {
    mma4(d, ah[0], ah[1], b.lo);
    mma4(d, al[0], al[1], b.hi);
  } else {
    mma4(d, al[0], al[1], b.hi);
    mma4(d, ah[0], ah[1], b.lo);
  }
  mma4(d, ah[0], ah[1], b.hi);
}

// s[mt] += A[mt] B^T over the first DK head dims (a multiple of 4; the rest
// are zero): B's 8 rows are staged rows n0.., and ``brow`` is this lane's,
// row n0 + g from column c.  A k8 step reads columns c and c + 4, the k4
// step of DK's last 4 (DK 12: 8 + 4) column c.
template <int DK, int DP, bool HOLD, int MT, bool BFIRST = false>
__device__ __forceinline__ void dims_product(float (&s)[MT][4], const AFrag<DP, HOLD> (&a)[MT],
                                             const float* brow) {
#pragma unroll
  for (int ks = 0; ks < DK / 8; ++ks) {
    const Split b0 = sp(brow[8 * ks]), b1 = sp(brow[8 * ks + 4]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t h[4], l[4];
      a[mt].get(ks, h, l);
      step8<BFIRST>(s[mt], h, l, b0, b1);
    }
  }
  if (DK % 8) {
    const Split b0 = sp(brow[DK - 4]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t h[4], l[4];
      a[mt].get(DK / 8, h, l);
      step4<BFIRST>(s[mt], h, l, b0);
    }
  }
}

// o[mt][nd] += P[mt] B over 8 rows (keys, or queries): P in the m16n8
// accumulator's layout (p = {P[g][2c], P[g][2c+1], P[g+8][2c], P[g+8][2c+1]})
// read as an A fragment with row 2c at column c and row 2c + 1 at column
// c + 4; B's rows 2c and 2c + 1 in the same order (``brow`` = staged row
// n0 + 2c from column g), the n8 tiles of the first DK head dims.
template <int DK, int DP, int MT>
__device__ __forceinline__ void rows_product(float (&o)[MT][DP / 8][4], const float (&p)[MT][4],
                                             const float* brow) {
  constexpr int LD = DP + 4;
  uint32_t h[MT][4], l[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float a[4] = {p[mt][0], p[mt][2], p[mt][1], p[mt][3]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const Split s = sp(a[e]);
      h[mt][e] = s.hi;
      l[mt][e] = s.lo;
    }
  }
#pragma unroll
  for (int nd = 0; nd < (DK + 7) / 8; ++nd) {
    const Split b0 = sp(brow[8 * nd]), b1 = sp(brow[8 * nd + LD]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) step8<false>(o[mt][nd], h[mt], l[mt], b0, b1);
  }
}

template <int MT, int ND>
__device__ __forceinline__ void tile_zero(float (&o)[MT][ND][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][nd][e] = 0.f;
}

// y += a tile's products, in fp32 (the tensor cores truncate as they add).
template <int MT, int ND>
__device__ __forceinline__ void tile_sum(float (&y)[MT][ND][4], const float (&o)[MT][ND][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[mt][nd][e] += o[mt][nd][e];
}

// Keep bits of this lane's four scores of an n8 tile in the accumulator's
// layout, rows = queries qi and qi + 8, columns = keys kk and kk + 1 (kk
// even): bit e keeps element e.  Lanes c and c ^ 1 share the Philox group of
// 4 keys; each draws one row's words and hands the other half to its partner.
__device__ __forceinline__ uint32_t keep_rows(const DropParams& dp, uint32_t row, uint32_t h,
                                              int kk, int qi, int c) {
  const int e = c & 1;
  const Philox4 w = dropout_words(dp.seed, SITE_ATTN_PROB, row, h, (uint32_t)(kk >> 2),
                                  (uint32_t)(qi + 8 * e));
  const uint32_t y0 = __shfl_xor_sync(FULL, e ? w.w[0] : w.w[2], 1);
  const uint32_t y1 = __shfl_xor_sync(FULL, e ? w.w[1] : w.w[3], 1);
  const uint32_t r0 = e ? y0 : w.w[0], r1 = e ? y1 : w.w[1];   // row qi
  const uint32_t r2 = e ? w.w[2] : y0, r3 = e ? w.w[3] : y1;   // row qi + 8
  return (uint32_t)(r0 < dp.thr) | (uint32_t)(r1 < dp.thr) << 1 | (uint32_t)(r2 < dp.thr) << 2 |
         (uint32_t)(r3 < dp.thr) << 3;
}

// The same for the dk/dv kernel's transposed tiles: rows = keys k0 + g and
// k0 + g + 8 (k0 a multiple of 16), columns = queries qq and qq + 1.  The 4
// lanes of one 4-key group (g = 4a + tt) draw one (group, query) each,
// element 2 rr + e = (key group a + 2 rr, query qq + e) by lane tt = 2 rr +
// e, and transpose the words in two shuffle stages so that lane tt holds
// word tt (its key's) of each.
__device__ __forceinline__ uint32_t keep_cols(const DropParams& dp, uint32_t row, uint32_t h,
                                              int k0, int qq, int g) {
  const int tt = g & 3;
  const Philox4 w = dropout_words(dp.seed, SITE_ATTN_PROB, row, h,
                                  (uint32_t)((k0 >> 2) + (g >> 2) + 2 * (tt >> 1)),
                                  (uint32_t)(qq + (tt & 1)));
  uint32_t x[4] = {w.w[0], w.w[1], w.w[2], w.w[3]};
#pragma unroll
  for (int kp = 0; kp < 4; kp += 2) {   // bit 0 of tt: lanes 4 apart
    const uint32_t recv = __shfl_xor_sync(FULL, (tt & 1) ? x[kp] : x[kp + 1], 4);
    if (tt & 1) x[kp] = recv;
    else x[kp + 1] = recv;
  }
#pragma unroll
  for (int kp = 0; kp < 2; ++kp) {      // bit 1 of tt: lanes 8 apart
    const uint32_t recv = __shfl_xor_sync(FULL, (tt & 2) ? x[kp] : x[kp + 2], 8);
    if (tt & 2) x[kp] = recv;
    else x[kp + 2] = recv;
  }
  return (uint32_t)(x[0] < dp.thr) | (uint32_t)(x[1] < dp.thr) << 1 |
         (uint32_t)(x[2] < dp.thr) << 2 | (uint32_t)(x[3] < dp.thr) << 3;
}

// Stage rows [r0, r0 + KC) of two [Lp, DP] head slices into a ring slot.
template <int DP>
__device__ __forceinline__ void stage2(float* dst, const float* a, const float* b, long long r0) {
  constexpr int LD = DP + 4, CH = KC * LD;
  for (int e = threadIdx.x; e < KC * DP / 4; e += NT) {
    const int row = e / (DP / 4), col = (e % (DP / 4)) * 4;
    const long long src = (r0 + row) * DP + col;
    cp_async16(smem_u32(dst + row * LD + col), a + src, true);
    cp_async16(smem_u32(dst + CH + row * LD + col), b + src, true);
  }
}

// ------------------------------------------------------------------ forward

// One tile of 8 NJ keys (staged rows at ks / vs, key0 the first's index)
// for a warp's MT x 16 queries (qi0 the first).
template <int DP, int DK, bool HOLD, int MT, int NJT, bool MASK>
__device__ __forceinline__ void fwd_tile(const AFrag<DP, HOLD> (&qa)[MT], const float* ks,
                                         const float* vs, int key0, int L, bool& first,
                                         float (&m)[MT][2], float (&l)[MT][2],
                                         float (&acc)[MT][DP / 8][4], const DropParams& dp,
                                         uint32_t row, uint32_t h, int qi0, int g, int c) {
  constexpr int LD = DP + 4, ND = DP / 8;
  float s[NJT][MT][4];
#pragma unroll
  for (int j = 0; j < NJT; ++j) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      s[j][mt][0] = s[j][mt][1] = -m[mt][0];   // S' = q' k^T - m
      s[j][mt][2] = s[j][mt][3] = -m[mt][1];
    }
    dims_product<DK>(s[j], qa, ks + (8 * j + g) * LD + c);
  }
  if (MASK) {
#pragma unroll
    for (int j = 0; j < NJT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (key0 + 8 * j + 2 * c + e >= L)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) s[j][mt][e] = s[j][mt][2 + e] = -CUDART_INF_F;
  }
  // P with the old max; the exact path when a lane's share of a row's tile
  // sum exceeds LANE_LIMIT (or the first tile's row sum is below 1): m moves
  // to the row's max (only up, after the first tile) and P is taken again.
  float p[NJT][MT][4], rs[MT][2];
  for (bool redo = false;; redo = true) {
    bool bad = false;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      rs[mt][0] = rs[mt][1] = 0.f;
#pragma unroll
      for (int j = 0; j < NJT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[j][mt][e] = ex2(s[j][mt][e]);
          rs[mt][e >> 1] += p[j][mt][e];
        }
      bad |= !(rs[mt][0] <= LANE_LIMIT) || !(rs[mt][1] <= LANE_LIMIT);
      if (first) {   // both sums in every lane: a shuffle waits for all 32
        const float t0 = quad_sum(rs[mt][0]), t1 = quad_sum(rs[mt][1]);
        bad |= !(t0 >= 1.f) || !(t1 >= 1.f);
      }
    }
    if (redo || !__any_sync(FULL, bad)) break;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < NJT; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[j][mt][0], s[j][mt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][mt][2], s[j][mt][3]));
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float d0 = first ? mx0 : fmaxf(mx0, 0.f), d1 = first ? mx1 : fmaxf(mx1, 0.f);
      m[mt][0] += d0;
      m[mt][1] += d1;
      const float a0 = ex2(-d0), a1 = ex2(-d1);
      l[mt][0] *= a0;
      l[mt][1] *= a1;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        acc[mt][nd][0] *= a0;
        acc[mt][nd][1] *= a0;
        acc[mt][nd][2] *= a1;
        acc[mt][nd][3] *= a1;
      }
#pragma unroll
      for (int j = 0; j < NJT; ++j) {
        s[j][mt][0] -= d0;
        s[j][mt][1] -= d0;
        s[j][mt][2] -= d1;
        s[j][mt][3] -= d1;
      }
    }
  }
  first = false;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    l[mt][0] += rs[mt][0];   // the undropped denominator
    l[mt][1] += rs[mt][1];
  }
  if (dp.on) {   // dropped numerators (the 1 / (1 - p) scale goes on O at the end)
#pragma unroll
    for (int j = 0; j < NJT; ++j)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint32_t keep = keep_rows(dp, row, h, key0 + 8 * j + 2 * c, qi0 + 16 * mt + g, c);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!((keep >> e) & 1)) p[j][mt][e] = 0.f;
      }
  }
  // O += P V, the tile's products in fresh accumulators first
  float ot[MT][ND][4];
  tile_zero(ot);
#pragma unroll
  for (int j = 0; j < NJT; ++j) rows_product<DK, DP>(ot, p[j], vs + (8 * j + 2 * c) * LD + g);
  tile_sum(acc, ot);
}

// Blocks of NW x MT x 16 queries of one (row, head), block b: query block
// b % nqb of (row, head) b / nqb.  o = drop(softmax(q k^T scale)) v with the
// undropped denominator; lse = max + log(sum) (natural log), when given.
template <int DP, int DK, int MT>
__global__ void __launch_bounds__(NT) attn_fwd_tc(const float* __restrict__ q,
                                                  const float* __restrict__ k,
                                                  const float* __restrict__ v,
                                                  float* __restrict__ o, float* __restrict__ lse,
                                                  int H, int L, int Lp, int D, int nqb,
                                                  float scale, DropParams dp) {
  constexpr bool HOLD = DP <= 32;
  constexpr int LD = DP + 4, ND = DP / 8, CH = KC * LD;
  extern __shared__ __align__(16) float sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, c = lane & 3;
  const long long rh = blockIdx.x / nqb;
  const int qb = (int)(blockIdx.x - rh * nqb);
  const int h = (int)(rh % H);
  const long long r = rh / H;
  const long long hb = rh * Lp * DP;
  const int qi0 = (qb * NW + warp) * 16 * MT;
  AFrag<DP, HOLD> qa[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) load_a(qa[mt], q + hb, qi0 + 16 * mt, Lp, scale * LOG2E, g, c);
  float m[MT][2], l[MT][2], acc[MT][ND][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nd][e] = 0.f;
  }
  const int nch = (L + KC - 1) / KC;
#pragma unroll
  for (int s0 = 0; s0 < STAGES - 1; ++s0) {
    if (s0 < nch) stage2<DP>(sm + s0 * 2 * CH, k + hb, v + hb, (long long)s0 * KC);
    cp_async_commit();
  }
  const uint32_t row = dp.row0 + (uint32_t)r;
  bool first = true;
  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // chunk ch landed; every warp is done with chunk ch - 1
    const int nx = ch + STAGES - 1;
    if (nx < nch) stage2<DP>(sm + (nx % STAGES) * 2 * CH, k + hb, v + hb, (long long)nx * KC);
    cp_async_commit();
    const float* ks = sm + (ch % STAGES) * 2 * CH;
    const float* vs = ks + CH;
    const int kt = ch * KC, nk = L - kt < KC ? L - kt : KC;
    int j0 = 0;
    for (; j0 + 8 * NJ <= nk; j0 += 8 * NJ)
      fwd_tile<DP, DK, HOLD, MT, NJ, false>(qa, ks + j0 * LD, vs + j0 * LD, kt + j0, L, first, m,
                                        l, acc, dp, row, (uint32_t)h, qi0, g, c);
    for (; j0 < nk; j0 += 8)   // the tail in 8-key tiles
      fwd_tile<DP, DK, HOLD, MT, 1, true>(qa, ks + j0 * LD, vs + j0 * LD, kt + j0, L, first, m, l,
                                      acc, dp, row, (uint32_t)h, qi0, g, c);
  }
  cp_async_wait<0>();
  const float dsc = dp.on ? dp.scale : 1.f;
  const int A = H * D;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float lt = quad_sum(l[mt][rr]);
      const int i = qi0 + 16 * mt + g + 8 * rr;
      if (i >= L) continue;
      const float inv = dsc / lt;
      float* od = o + ((long long)r * L + i) * A + h * D;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        const int col = 8 * nd + 2 * c;
        if (col < D)
          *reinterpret_cast<float2*>(od + col) =
              make_float2(acc[mt][nd][2 * rr] * inv, acc[mt][nd][2 * rr + 1] * inv);
      }
      if (lse && c == 0) lse[rh * L + i] = (m[mt][rr] + log2f(lt)) * LN2;
    }
}

// ---------------------------------------------------------------- backward

// Store the pair (x0, x1) at head-dim column col of a row of dqkv, RoPE's
// rotation at position pos undone.
__device__ __forceinline__ void store_unrope(float* dst, float x0, float x1, const float* cs,
                                             const float* sn, int pos, int col, int D) {
  const int t = col >> 1;
  const float cz = cs[pos * (D / 2) + t], sz = sn[pos * (D / 2) + t];
  *reinterpret_cast<float2*>(dst + col) = make_float2(x0 * cz + x1 * sz, x1 * cz - x0 * sz);
}

template <int DP, int DK, bool HOLD, int MT, int NJT, bool MASK>
__device__ __forceinline__ void dq_tile(const AFrag<DP, HOLD> (&qa)[MT],
                                        const AFrag<DP, HOLD> (&da)[MT], const float* ks,
                                        const float* vs, int key0, int L,
                                        const float (&lse2)[MT][2], const float (&dl)[MT][2],
                                        float (&acc)[MT][DP / 8][4], const DropParams& dp,
                                        uint32_t row, uint32_t h, int qi0, int g, int c) {
  constexpr int LD = DP + 4, ND = DP / 8;
  float s[NJT][MT][4], dpv[NJT][MT][4];
#pragma unroll
  for (int j = 0; j < NJT; ++j) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      s[j][mt][0] = s[j][mt][1] = -lse2[mt][0];
      s[j][mt][2] = s[j][mt][3] = -lse2[mt][1];
#pragma unroll
      for (int e = 0; e < 4; ++e) dpv[j][mt][e] = 0.f;
    }
    dims_product<DK>(s[j], qa, ks + (8 * j + g) * LD + c);     // S' - lse'
    dims_product<DK>(dpv[j], da, vs + (8 * j + g) * LD + c);   // dP = dO v^T
  }
  if (MASK) {
#pragma unroll
    for (int j = 0; j < NJT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (key0 + 8 * j + 2 * c + e >= L)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) s[j][mt][e] = s[j][mt][2 + e] = -CUDART_INF_F;
  }
#pragma unroll
  for (int j = 0; j < NJT; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      uint32_t keep = 0xFu;
      if (dp.on) keep = keep_rows(dp, row, h, key0 + 8 * j + 2 * c, qi0 + 16 * mt + g, c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = dpv[j][mt][e];
        if (dp.on) x = ((keep >> e) & 1) ? x * dp.scale : 0.f;
        s[j][mt][e] = ex2(s[j][mt][e]) * (x - dl[mt][e >> 1]);   // dS = P (drop(dP) - delta)
      }
    }
  float dt[MT][ND][4];
  tile_zero(dt);
#pragma unroll
  for (int j = 0; j < NJT; ++j) rows_product<DK, DP>(dt, s[j], ks + (8 * j + 2 * c) * LD + g);
  tile_sum(acc, dt);
}

// Blocks of NW x MT x 16 queries as attn_fwd_tc: delta = dO . o and dO as
// [R, H, Lp, DP] (for attn_dkdv_tc), dq = scale sum_j dS_ij k_j (rotated
// back) into dqkv.
template <int DP, int DK, int MT>
__global__ void __launch_bounds__(NT, bwd_minb<DP, DK>()) attn_dq_tc(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ o, const float* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ dop, float* __restrict__ delta, float* __restrict__ dqkv,
    const float* __restrict__ cs, const float* __restrict__ sn, int H, int L, int Lp, int D,
    int nqb, float scale, DropParams dp) {
  constexpr bool HOLD = DP <= 32;
  constexpr int LD = DP + 4, ND = DP / 8, CH = KC * LD;
  extern __shared__ __align__(16) float sm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, c = lane & 3;
  const long long rh = blockIdx.x / nqb;
  const int qb = (int)(blockIdx.x - rh * nqb);
  const int h = (int)(rh % H);
  const long long r = rh / H;
  const long long hb = rh * Lp * DP;
  const int A = H * D;
  const int qi0 = (qb * NW + warp) * 16 * MT;
  AFrag<DP, HOLD> qa[MT], da[MT];
  float lse2[MT][2], dl[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    load_a(qa[mt], q + hb, qi0 + 16 * mt, Lp, scale * LOG2E, g, c);
    float ov[DP / 8][4];   // o where dO's A fragments are
#pragma unroll
    for (int ks = 0; ks < DP / 8; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = qi0 + 16 * mt + g + 8 * (e & 1), col = 8 * ks + c + 4 * (e >> 1);
        float x = 0.f, y = 0.f;
        if (i < L && col < D) {
          const long long ro = ((long long)r * L + i) * A + h * D + col;
          x = dout[ro];
          y = o[ro];
        }
        da[mt].set(ks, e, x);
        ov[ks][e] = y;
        if (i < Lp) dop[hb + (long long)i * DP + col] = x;
      }
    // delta = dO . o as the diagonal of dO o^T, on the tensor cores with the
    // products of dP = dO v^T in their order: where o is one key's v (a
    // softmax over one key) delta is that dP to the bit, and dS is 0.  n8
    // tile t's B fragment holds o's rows 8 t + g, which this lane read.
    float dd[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) dd[t][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DK / 8; ++ks) {
      uint32_t hh[4], ll[4];
      da[mt].get(ks, hh, ll);
#pragma unroll
      for (int t = 0; t < 2; ++t)
        step8<false>(dd[t], hh, ll, sp(ov[ks][t]), sp(ov[ks][t + 2]));
    }
    if (DK % 8) {
      uint32_t hh[4], ll[4];
      da[mt].get(DK / 8, hh, ll);
#pragma unroll
      for (int t = 0; t < 2; ++t) step4<false>(dd[t], hh, ll, sp(ov[DK / 8][t]));
    }
    // row g's diagonal element is lane (g, g / 2)'s element g % 2 of tile 0,
    // row g + 8's its element 2 + g % 2 of tile 1
    const int src = (threadIdx.x & 31 & ~3) | (g >> 1);
    dl[mt][0] = __shfl_sync(FULL, (g & 1) ? dd[0][1] : dd[0][0], src);
    dl[mt][1] = __shfl_sync(FULL, (g & 1) ? dd[1][3] : dd[1][2], src);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = qi0 + 16 * mt + g + 8 * rr;
      lse2[mt][rr] = i < L ? lse[rh * L + i] * LOG2E : 0.f;
      if (i < L && c == 0) delta[rh * L + i] = dl[mt][rr];
    }
  }
  float acc[MT][ND][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nd][e] = 0.f;
  const int nch = (L + KC - 1) / KC;
#pragma unroll
  for (int s0 = 0; s0 < STAGES - 1; ++s0) {
    if (s0 < nch) stage2<DP>(sm + s0 * 2 * CH, k + hb, v + hb, (long long)s0 * KC);
    cp_async_commit();
  }
  const uint32_t row = dp.row0 + (uint32_t)r;
  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nx = ch + STAGES - 1;
    if (nx < nch) stage2<DP>(sm + (nx % STAGES) * 2 * CH, k + hb, v + hb, (long long)nx * KC);
    cp_async_commit();
    const float* ks = sm + (ch % STAGES) * 2 * CH;
    const float* vs = ks + CH;
    const int kt = ch * KC, nk = L - kt < KC ? L - kt : KC;
    int j0 = 0;
    for (; j0 + 8 * NJ <= nk; j0 += 8 * NJ)
      dq_tile<DP, DK, HOLD, MT, NJ, false>(qa, da, ks + j0 * LD, vs + j0 * LD, kt + j0, L, lse2,
                                       dl, acc, dp, row, (uint32_t)h, qi0, g, c);
    for (; j0 < nk; j0 += 8)
      dq_tile<DP, DK, HOLD, MT, 1, true>(qa, da, ks + j0 * LD, vs + j0 * LD, kt + j0, L, lse2,
                                     dl, acc, dp, row, (uint32_t)h, qi0, g, c);
  }
  cp_async_wait<0>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = qi0 + 16 * mt + g + 8 * rr;
      if (i >= L) continue;
      float* dst = dqkv + ((long long)r * L + i) * 3 * A + h * D;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        const int col = 8 * nd + 2 * c;
        if (col < D)
          store_unrope(dst, acc[mt][nd][2 * rr] * scale, acc[mt][nd][2 * rr + 1] * scale, cs, sn,
                       i, col, D);
      }
    }
}

// One tile of 8 NJ queries (staged rows of q at qs and of dO at ds, their
// log-sum-exp at ls and delta at dls, qry0 the first query's index) for a
// warp's MT x 16 keys (k0 the first).
template <int DP, int DK, bool HOLD, int MT, int NJT, bool MASK>
__device__ __forceinline__ void dkdv_tile(const AFrag<DP, HOLD> (&ka)[MT],
                                          const AFrag<DP, HOLD> (&va)[MT], const float* qs,
                                          const float* ds, const float* ls, const float* dls,
                                          int qry0, int L, float (&dk)[MT][DP / 8][4],
                                          float (&dv)[MT][DP / 8][4], const DropParams& dp,
                                          uint32_t row, uint32_t h, int k0, int g, int c) {
  constexpr int LD = DP + 4, ND = DP / 8;
  float s[NJT][MT][4], dpt[NJT][MT][4];
#pragma unroll
  for (int j = 0; j < NJT; ++j) {
    const float l0 = ls[8 * j + 2 * c] * LOG2E, l1 = ls[8 * j + 2 * c + 1] * LOG2E;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      s[j][mt][0] = s[j][mt][2] = -l0;
      s[j][mt][1] = s[j][mt][3] = -l1;
#pragma unroll
      for (int e = 0; e < 4; ++e) dpt[j][mt][e] = 0.f;
    }
    dims_product<DK>(s[j], ka, qs + (8 * j + g) * LD + c);     // S'^T - lse'
    // dP^T = v dO^T, its products in the order of the dq kernel's delta
    dims_product<DK, DP, HOLD, MT, true>(dpt[j], va, ds + (8 * j + g) * LD + c);
  }
  if (MASK) {
#pragma unroll
    for (int j = 0; j < NJT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (qry0 + 8 * j + 2 * c + e >= L)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) s[j][mt][e] = s[j][mt][2 + e] = -CUDART_INF_F;
  }
  uint32_t keep[NJT][MT];
  float pd[NJT][MT][4];
#pragma unroll
  for (int j = 0; j < NJT; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      keep[j][mt] = dp.on ? keep_cols(dp, row, h, k0 + 16 * mt, qry0 + 8 * j + 2 * c, g) : 0xFu;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][mt][e] = ex2(s[j][mt][e]);
        pd[j][mt][e] = ((keep[j][mt] >> e) & 1) ? s[j][mt][e] : 0.f;
      }
    }
  float t[MT][ND][4];
  tile_zero(t);   // dV += drop(P)^T dO (the 1 / (1 - p) scale at the end)
#pragma unroll
  for (int j = 0; j < NJT; ++j) rows_product<DK, DP>(t, pd[j], ds + (8 * j + 2 * c) * LD + g);
  tile_sum(dv, t);
#pragma unroll
  for (int j = 0; j < NJT; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = dpt[j][mt][e];
        if (dp.on) x = ((keep[j][mt] >> e) & 1) ? x * dp.scale : 0.f;
        s[j][mt][e] *= x - dls[8 * j + 2 * c + (e & 1)];   // dS^T
      }
  tile_zero(t);   // dK += dS^T q
#pragma unroll
  for (int j = 0; j < NJT; ++j) rows_product<DK, DP>(t, s[j], qs + (8 * j + 2 * c) * LD + g);
  tile_sum(dk, t);
}

// Blocks of NW x MT x 16 keys of one (row, head), block b: key block b % nkb
// of (row, head) b / nkb.  dv = sum_i drop(P_ij) do_i, dk = scale sum_i dS_ij
// q_i (rotated back) into dqkv.
template <int DP, int DK, int MT>
__global__ void __launch_bounds__(NT, bwd_minb<DP, DK>()) attn_dkdv_tc(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dop, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dqkv, const float* __restrict__ cs,
    const float* __restrict__ sn, int H, int L, int Lp, int D, int nkb, float scale,
    DropParams dp) {
  constexpr bool HOLD = DP <= 32;
  constexpr int LD = DP + 4, ND = DP / 8, CH = KC * LD;
  extern __shared__ __align__(16) float sm[];
  float* stats = sm + STAGES * 2 * CH;   // per stage: KC log-sum-exps, KC deltas
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, c = lane & 3;
  const long long rh = blockIdx.x / nkb;
  const int kb = (int)(blockIdx.x - rh * nkb);
  const int h = (int)(rh % H);
  const long long r = rh / H;
  const long long hb = rh * Lp * DP;
  const int A = H * D;
  const int k0 = (kb * NW + warp) * 16 * MT;
  AFrag<DP, HOLD> ka[MT], va[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    load_a(ka[mt], k + hb, k0 + 16 * mt, Lp, scale * LOG2E, g, c);
    load_a(va[mt], v + hb, k0 + 16 * mt, Lp, 1.f, g, c);
  }
  float dk[MT][ND][4], dv[MT][ND][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[mt][nd][e] = dv[mt][nd][e] = 0.f;
  const float* lrow = lse + rh * L;
  const float* drow = delta + rh * L;
  auto stage = [&](int ch) {
    const int slot = ch % STAGES;
    stage2<DP>(sm + slot * 2 * CH, q + hb, dop + hb, (long long)ch * KC);
    for (int e = threadIdx.x; e < 2 * KC; e += NT) {
      const int i = ch * KC + (e % KC);
      const float* src = e < KC ? lrow : drow;
      cp_async4(smem_u32(stats + slot * 2 * KC + e), i < L ? src + i : src, i < L);
    }
  };
  const int nch = (L + KC - 1) / KC;
#pragma unroll
  for (int s0 = 0; s0 < STAGES - 1; ++s0) {
    if (s0 < nch) stage(s0);
    cp_async_commit();
  }
  const uint32_t row = dp.row0 + (uint32_t)r;
  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nx = ch + STAGES - 1;
    if (nx < nch) stage(nx);
    cp_async_commit();
    const int slot = ch % STAGES;
    const float* qs = sm + slot * 2 * CH;
    const float* ds = qs + CH;
    const float* ls = stats + slot * 2 * KC;
    const float* dls = ls + KC;
    const int qt = ch * KC, nq = L - qt < KC ? L - qt : KC;
    int j0 = 0;
    for (; j0 + 8 * NJ <= nq; j0 += 8 * NJ)
      dkdv_tile<DP, DK, HOLD, MT, NJ, false>(ka, va, qs + j0 * LD, ds + j0 * LD, ls + j0, dls + j0,
                                         qt + j0, L, dk, dv, dp, row, (uint32_t)h, k0, g, c);
    for (; j0 < nq; j0 += 8)
      dkdv_tile<DP, DK, HOLD, MT, 1, true>(ka, va, qs + j0 * LD, ds + j0 * LD, ls + j0, dls + j0,
                                       qt + j0, L, dk, dv, dp, row, (uint32_t)h, k0, g, c);
  }
  cp_async_wait<0>();
  const float dsc = dp.on ? dp.scale : 1.f;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int j = k0 + 16 * mt + g + 8 * rr;
      if (j >= L) continue;
      float* dst = dqkv + ((long long)r * L + j) * 3 * A + h * D;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        const int col = 8 * nd + 2 * c;
        if (col >= D) continue;
        store_unrope(dst + A, dk[mt][nd][2 * rr] * scale, dk[mt][nd][2 * rr + 1] * scale, cs, sn,
                     j, col, D);
        *reinterpret_cast<float2*>(dst + 2 * A + col) =
            make_float2(dv[mt][nd][2 * rr] * dsc, dv[mt][nd][2 * rr + 1] * dsc);
      }
    }
}

// ------------------------------------------------------------------ launches

inline DropParams drop(unsigned seed, unsigned thr, unsigned row0, float scale, int on) {
  DropParams dp;
  dp.seed = seed;
  dp.thr = thr;
  dp.row0 = row0;
  dp.scale = scale;
  dp.on = on;
  return dp;
}

// Opt a kernel into its dynamic shared memory above the 48 KB default.
template <class K>
inline cudaError_t opt_in(K kernel, long long bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The 1-D grid of ``per``-row blocks over (row, head) x Lp rows, or 0 when
// it would not fit.
inline unsigned grid_of(int R, int H, int Lp, int per, int& nb) {
  nb = (Lp + per - 1) / per;
  const long long n = (long long)R * H * nb;
  return n > INT_MAX ? 0u : (unsigned)n;
}

template <int DP, int DK>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int R, int H,
               int L, int Lp, int D, float scale, DropParams dp, cudaStream_t st) {
  constexpr int MT = warp_mt<DP>();
  int nqb;
  const unsigned blocks = grid_of(R, H, Lp, NW * 16 * MT, nqb);
  if (!blocks) return (int)cudaErrorInvalidValue;
  const cudaError_t e = opt_in(attn_fwd_tc<DP, DK, MT>, fwd_smem(DP));
  if (e != cudaSuccess) return (int)e;
  attn_fwd_tc<DP, DK, MT><<<blocks, NT, fwd_smem(DP), st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, (float*)lse, H, L, Lp, D,
      nqb, scale, dp);
  return (int)cudaGetLastError();
}

template <int DP, int DK>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const void* lse, void* dop, void* delta, void* dqkv, const void* cs,
               const void* sn, int R, int H, int L, int Lp, int D, float scale, DropParams dp,
               cudaStream_t st) {
  constexpr int MT = warp_mt<DP>();
  int nqb, nkb;
  const unsigned qblocks = grid_of(R, H, Lp, NW * 16 * MT, nqb);
  const unsigned kblocks = grid_of(R, H, Lp, NW * 16 * MT, nkb);
  if (!qblocks || !kblocks) return (int)cudaErrorInvalidValue;
  cudaError_t e = opt_in(attn_dq_tc<DP, DK, MT>, fwd_smem(DP));
  if (e == cudaSuccess) e = opt_in(attn_dkdv_tc<DP, DK, MT>, dkdv_smem(DP));
  if (e != cudaSuccess) return (int)e;
  attn_dq_tc<DP, DK, MT><<<qblocks, NT, fwd_smem(DP), st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)o, (const float*)dout,
      (const float*)lse, (float*)dop, (float*)delta, (float*)dqkv, (const float*)cs,
      (const float*)sn, H, L, Lp, D, nqb, scale, dp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  attn_dkdv_tc<DP, DK, MT><<<kblocks, NT, dkdv_smem(DP), st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dop, (const float*)lse,
      (const float*)delta, (float*)dqkv, (const float*)cs, (const float*)sn, H, L, Lp, D, nkb,
      scale, dp);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace af32

using namespace af32;

// Shared memory of the attention launches at a padded head width dp (16, 32
// or 64), bytes: 0 attn_fwd_tc / attn_dq_tc, 1 attn_dkdv_tc.
extern "C" long long f32_attn_smem_bytes(int which, int dp) {
  if (dp != 16 && dp != 32 && dp != 64) return -1;
  return which == 0 ? fwd_smem(dp) : which == 1 ? dkdv_smem(dp) : -1;
}

// The instantiation: the padded head width dp (16, 32 or 64) and the head
// dims the products cover, DK: D rounded up to 4 for the shipped head dims
// (12, 16, 24, 32), the padded width for any other (its dims past D are
// zero, so they add nothing).
#define DK_DISPATCH(dp, D, fn, ...)                                     \
  if (dp == 16 && D == 12) return fn<16, 12>(__VA_ARGS__);               \
  if (dp == 16) return fn<16, 16>(__VA_ARGS__);                          \
  if (dp == 32 && D == 24) return fn<32, 24>(__VA_ARGS__);               \
  if (dp == 32) return fn<32, 32>(__VA_ARGS__);                          \
  if (dp == 64) return fn<64, 64>(__VA_ARGS__);                          \
  return (int)cudaErrorInvalidValue;

// q, k, v [R, H, Lp, DP] as qkv_split writes them; o [R, L, H D]; lse [R, H,
// L] or null.
extern "C" int f32_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            int R, int H, int L, int Lp, int D, int dp, float scale,
                            unsigned seed, unsigned thr, unsigned row0, float dscale, int on,
                            void* stream) {
  if (L < 1 || D < 2 || D % 2 || D > dp || Lp % KC || Lp < L) return (int)cudaErrorInvalidValue;
  DK_DISPATCH(dp, D, launch_fwd, q, k, v, o, lse, R, H, L, Lp, D, scale,
              drop(seed, thr, row0, dscale, on), (cudaStream_t)stream)
}

// The forward's operands and stash, dout [R, L, H D]; scratch dop [R, H, Lp,
// DP] and delta [R, H, L]; dqkv [R, L, 3 H D] out; the RoPE tables [L, D/2].
extern "C" int f32_attn_bwd(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const void* lse, void* dop, void* delta, void* dqkv,
                            const void* cs, const void* sn, int R, int H, int L, int Lp, int D,
                            int dp, float scale, unsigned seed, unsigned thr, unsigned row0,
                            float dscale, int on, void* stream) {
  if (L < 1 || D < 2 || D % 2 || D > dp || Lp % KC || Lp < L) return (int)cudaErrorInvalidValue;
  DK_DISPATCH(dp, D, launch_bwd, q, k, v, o, dout, lse, dop, delta, dqkv, cs, sn, R, H, L, Lp, D,
              scale, drop(seed, thr, row0, dscale, on), (cudaStream_t)stream)
}
