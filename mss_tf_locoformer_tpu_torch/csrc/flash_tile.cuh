// Register-resident attention pieces shared by the flash-attention kernels
// (#6, #7: ``flash_attention.cu``) and the attention-step kernels (#3, #4:
// ``attention_block.cu``): mma.sync m16n8k16 (bf16 in, fp32 accumulate),
// ldmatrix, cp.async, the swizzled row layout of a resident [L, DP] tensor,
// and the forward's key tile in the exp2 domain with its lazy max
// (``fwd_tile``; the design is set out at the top of flash_attention.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int SMEM_OPTIN = 232448;   // shared memory one block may opt into (H100)
// A row's tile sum of P above this sends the warp to the exact path.
constexpr float LAZY_LIMIT = 65536.f;
constexpr uint32_t ONES_BF16X2 = 0x3F803F80u;

// ------------------------------------------------------------ primitives

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *(const uint32_t*)&v;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// d[16x8] (+)= a[16x16] b[16x8], bf16 in, fp32 accumulate.  Fragments (lane =
// 4 g + c): a = rows g, g+8 x cols 2c, 2c+1 (+8); b = k 2c, 2c+1 (+8) x
// col g; d = rows g, g+8 x cols 2c, 2c+1.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b + c with c in registers of its own (no copies to start d at c)
__device__ __forceinline__ void mma_bf16_c(float* d, const uint32_t* a, uint32_t b0,
                                           uint32_t b1, const float* c) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(c[0]),
        "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// ldmatrix stays volatile: it reads shared memory, and must not move across
// the barriers that order those reads.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t movmatrix_t(uint32_t x) {
  uint32_t y;
  asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int bytes) {
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// -------------------------------------------------- resident row layout
//
// An [lp, DP] bf16 tensor in shared memory: each row is DP / 8 chunks of 16
// bytes.  With a power-of-two chunk count (DP 16, 32, 64) chunk ch of row r
// sits at chunk ch ^ ((r / (8 / NCH)) % NCH) of its row, so the 8 rows an
// ldmatrix reads cover all 32 banks; DP 48's 6 chunks take a row stride of
// 7 (odd) instead.
template <int DP>
struct Rows {
  static constexpr int NCH = DP / 8;
  static constexpr bool POW2 = (NCH & (NCH - 1)) == 0;
  static constexpr int RS = POW2 ? NCH : NCH + 1;   // row stride in chunks
  static constexpr int ROWB = RS * 16;               // row stride in bytes
  __host__ __device__ static constexpr size_t bytes(int lp) { return (size_t)lp * RS * 16; }
  __device__ __forceinline__ static int off(int r, int ch) {
    if (POW2) return (r * RS + (ch ^ ((r / (8 / NCH)) % NCH))) * 16;
    return (r * RS + ch) * 16;
  }
  // byte offset of bf16 element (r, d)
  __device__ __forceinline__ static int at(int r, int d) { return off(r, d >> 3) + (d & 7) * 2; }
  // The swizzle repeats every 8 rows, so for r0 a multiple of 8 off(r0 + x,
  // ch) = r0 ROWB + off(x, ch): each lane's ldmatrix offset is computed once.
};

// Lane offsets of the two ldmatrix.x4 patterns over a 16-row, 16-column
// block at rows r0..r0+15, columns 16 kd..: ``lo`` = matrices (rows 0-7,
// cols 0-7), (rows 8-15, cols 0-7), (rows 0-7, cols 8-15), (rows 8-15, cols
// 8-15), i.e. an A fragment (or, with .trans, B with k along the rows);
// ``hi`` = (rows 0-7, cols 0-7), (rows 0-7, cols 8-15), (rows 8-15, cols
// 0-7), (rows 8-15, cols 8-15), i.e. B fragments of two 8-row n-tiles (or,
// with .trans, an A fragment with k along the rows).
template <int DP>
__device__ __forceinline__ int lane_lo(int lane, int kd) {
  return Rows<DP>::off(((lane >> 3) & 1) * 8 + (lane & 7), 2 * kd + (lane >> 4));
}
template <int DP>
__device__ __forceinline__ int lane_hi(int lane, int kd) {
  return Rows<DP>::off((lane >> 4) * 8 + (lane & 7), 2 * kd + ((lane >> 3) & 1));
}

__host__ __device__ constexpr int pad16(int x) { return (x + 15) / 16 * 16; }

// ---------------------------------------------------------- forward tile

// One tile of NK keys (64, or 16 in the tail) for a warp's 16 queries: keys
// j0.. at byte ``ks``/``vs`` (j0's row), the lane's ldmatrix offsets beside.
// ``drop(pa, j0, lane)`` may zero dropped probabilities of P's A fragments
// after their row sums are taken and before O += P V.
template <int DP, int NK, bool MASK, class Drop>
__device__ __forceinline__ void fwd_tile(const uint32_t (&qf)[DP / 16][4], uint32_t ks,
                                         uint32_t vs, const int (&kofs)[DP / 16],
                                         const int (&vofs)[DP / 16], int j0, int L, bool first,
                                         float& m0, float& m1, float& l0, float& l1,
                                         float (&acc)[DP / 8][4], int lane,
                                         const Drop& drop) {
  constexpr int KD = DP / 16, ND = DP / 8, NJ = NK / 8, NKK = NK / 16;
  constexpr int ROWB = Rows<DP>::ROWB;
  const int c = lane & 3;
  float s[NJ][4];
  const float cm[4] = {-m0, -m0, -m1, -m1};
  // S' = Q K^T - m, the accumulator started at -m
#pragma unroll
  for (int kk = 0; kk < NKK; ++kk) {
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t b[4];   // (keys 0-7 | 8-15) x (dims 16 kd .. +7 | +8 .. +15)
      ldsm_x4(b, ks + 16 * kk * ROWB + kofs[kd]);
      if (kd == 0) {
        mma_bf16_c(s[2 * kk], qf[0], b[0], b[1], cm);
        mma_bf16_c(s[2 * kk + 1], qf[0], b[2], b[3], cm);
      } else {
        mma_bf16(s[2 * kk], qf[kd], b[0], b[1]);
        mma_bf16(s[2 * kk + 1], qf[kd], b[2], b[3]);
      }
    }
  }
  if (MASK) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (j0 + 8 * j + 2 * c + e >= L) s[j][e] = s[j][2 + e] = -CUDART_INF_F;
  }
  uint32_t pa[NKK][4];
  float rs[4];
  auto exp_sum = [&]() {   // P = ex2(S') as bf16 A fragments; row sums by MMA
#pragma unroll
    for (int kk = 0; kk < NKK; ++kk) {
      pa[kk][0] = pack_bf16(ex2(s[2 * kk][0]), ex2(s[2 * kk][1]));
      pa[kk][1] = pack_bf16(ex2(s[2 * kk][2]), ex2(s[2 * kk][3]));
      pa[kk][2] = pack_bf16(ex2(s[2 * kk + 1][0]), ex2(s[2 * kk + 1][1]));
      pa[kk][3] = pack_bf16(ex2(s[2 * kk + 1][2]), ex2(s[2 * kk + 1][3]));
    }
    rs[0] = rs[1] = rs[2] = rs[3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NKK; ++kk) mma_bf16(rs, pa[kk], ONES_BF16X2, ONES_BF16X2);
  };
  // P with the old m; when a row's tile sum leaves [1 (first tile only),
  // 2^16], the exact path moves m to the row's max and takes P again.  One
  // exp_sum in the code, so the hot path keeps its registers.
  for (bool redo = false;; redo = true) {
    exp_sum();
    if (redo || !__any_sync(0xffffffffu, !(rs[0] <= LAZY_LIMIT && rs[2] <= LAZY_LIMIT &&
                                           (!first || (rs[0] >= 1.f && rs[2] >= 1.f)))))
      break;
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float d0 = first ? mx0 : fmaxf(mx0, 0.f), d1 = first ? mx1 : fmaxf(mx1, 0.f);
    m0 += d0;
    m1 += d1;
    const float a0 = ex2(-d0), a1 = ex2(-d1);
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      s[j][0] -= d0;
      s[j][1] -= d0;
      s[j][2] -= d1;
      s[j][3] -= d1;
    }
  }
  l0 += rs[0];
  l1 += rs[2];
  drop(pa, j0, lane);   // after the sums: the denominator is the undropped sum
  // O += P V: V fragments through ldmatrix.trans
#pragma unroll
  for (int kk = 0; kk < NKK; ++kk) {
#pragma unroll
    for (int np = 0; np < ND / 2; ++np) {
      uint32_t b[4];   // (keys 0-7 | 8-15) x (dims 16 np .. +7 | +8 .. +15)
      ldsm_x4_t(b, vs + 16 * kk * ROWB + vofs[np]);
      mma_bf16(acc[2 * np], pa[kk], b[0], b[1]);
      mma_bf16(acc[2 * np + 1], pa[kk], b[2], b[3]);
    }
  }
}

// No dropout: ``fwd_tile``'s hook does nothing.
struct NoDrop {
  template <int NKK>
  __device__ __forceinline__ void operator()(uint32_t (&)[NKK][4], int, int) const {}
};

}  // namespace
