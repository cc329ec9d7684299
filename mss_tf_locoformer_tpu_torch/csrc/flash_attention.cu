// Flash attention:  o = softmax(RoPE(q) RoPE(k)^T / sqrt(D)) v  over [..., L, D]
//
// Kernel #6 (forward) replaces the JAX package's Pallas kernel
// ``ops/pallas/flash_attention.py::_flash_forward`` (``:207``, its
// ``pallas_call`` at ``:248``, body ``_kernel``); kernel #7 (backward)
// replaces ``_flash_backward_pallas`` (``:315``, ``pallas_call`` at ``:346``,
// body ``_bwd_kernel``).  Public ``flash_attention``: no mask, no dropout, the
// interleaved-pair RoPE optionally fused on q and k in fp32.  The TPU
// kernel's max-free "bounded shift" avoids a cross-sublane max on the TPU;
// here the softmax is an online one with the exact running max.
//
// Shapes: q, k, v [B, H, L, D] bf16 as strided views (element strides for
// batch, head and position; unit stride in D), o likewise.  The unfused MHSA
// passes the views of its QKV product [B, L, 3, H, D] and an o buffer
// [B, L, H, D], so no transpose runs on either side.  D is even and at most
// 64; it is zero-padded to DP (a multiple of 16, the MMA depth) in shared
// memory only.  xlarge: D 16, H 16, freq path L 2049 on 690 rows, time path
// L 345 on 4098 rows; small training: D 12, H 4, L 513 / 517 on ~8200 rows.
//
// What bounds both on the H100: the exponentials.  At D <= 16 the products
// are 4 L^2 D FLOP per (row, head) at 989 TFLOP/s, but every score needs one
// exp on the special-function units, ~3.9 T a second (16 per SM per clock):
// 11.9 ms for the 46.35 G scores of the xlarge freq path against 3.0 ms of
// products.  Each further FP32 instruction per score costs ~1/8 of an exp.
// So the design spends as few instructions per score as it can:
//   * scores in the exp2 domain: q is rotated in fp32, multiplied by
//     scale * log2(e) and rounded to bf16 once, so s = q'.k is already the
//     exponent;
//   * the running max is subtracted by the tensor cores (the accumulator of
//     S = Q K^T starts at -m) and rescaled lazily: P = ex2(s - m) is taken
//     with the old m (0 at first), its row sums come from one more MMA
//     against a ones column (the same bf16 P that O += P V sums), and only
//     when a row's tile sum exceeds 2^16 (a score more than ~16 above m, in
//     log2 units), or falls below 1 in the first tile, does the warp take
//     the exact path (max, rescale of O and l, P again).  So P <= 2^16, l >=
//     1, and nothing overflows or vanishes.  Per score the hot loop issues
//     one MUFU.EX2 and half a bf16 pack, plus the MMAs and ldmatrix loads
//     amortised over the tile;
//   * keys >= L are masked only in the tail, which runs in 16-key tiles
//     after the 64-key tiles (L 2049 = 32 x 64 + one 16-key tile).
//
// Forward (resident): one CTA per (row, head).  q, k and v are staged once
// into shared memory for all of the row's queries ([L, DP] each, 198 KB at
// L 2049: rows of DP bf16 in 16-byte chunks, XOR-swizzled so that ldmatrix
// reads them without bank conflicts) by 16-, 8- or 4-byte cp.async copies
// of the strided views (D 12's 24-byte rows take 8), then q and k are
// rotated in place.  Each warp walks its 16-query tiles over all keys with
// no further barrier; fragments come through ldmatrix (.trans for V) at
// offsets computed once per lane; S, P and O stay in mma.sync m16n8k16
// registers (bf16 in, fp32 accumulate).  The warps are chosen so that the
// query tiles fill whole rounds (33 tiles: 11 warps x 3), and where two
// CTAs' tensors fit an SM (L <= 1210 at DP 16) a CTA takes at most 11 warps
// and registers for two, so that one CTA's staging overlaps the other's
// work.  wgmma would take the products off the issue slots, but at D <= 16
// they are 20 of the ~100 instructions a warp issues per 64-key tile.
// Where the three tensors do not fit 227 KB the streaming kernel below
// re-stages 64-key tiles per 128 queries.
//
// Backward (resident, D <= 16, L <= 528): one persistent CTA per SM walks
// (row, head) pairs; the next pair's q, k, v, dO, o and log-sum-exp are
// copied in by cp.async while the current pair is computed.  Each warp owns
// up to 3 slabs of 16 keys (the warp count is chosen so that the slabs
// spread evenly: 33 slabs at L 513 = 11 warps x 3) and holds their dK and dV
// in registers; the CTA walks 16-query tiles in step.  Per (slab, tile): S^T = K Q'^T with the accumulator started at
// -lse (log2 units), P^T = ex2(S^T) once, dP^T = V dO^T started at -delta,
// dS^T = P^T dP^T, then dV += P^T dO, dK += dS^T Q' and dQ^T += K^T dS^T
// (dS^T moved to a B operand by movmatrix).  delta = rowsum(dO o) is
// computed when a pair is installed, so there is no pre-pass.  dQ's
// per-warp partials meet in shared memory, one barrier a tile, and are
// summed in warp order: no atomics, the same bits every run.  What holds it
// (measured: trimming instructions, holding K and V in registers and two
// tiles a barrier all left its time as it was): the registers a thread
// needs for dK, dV and a tile's operands leave 11 warps an SM, and each
// tile's chain of dependent MMAs and exps between barriers is longer than
// they can hide; it runs at ~5x the exp floor.  Outside that gate the
// streaming kernels (a delta pre-pass, a dq launch and a dk/dv launch)
// take the call.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

typedef __nv_bfloat16 bf16;

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int SMEM_OPTIN = 232448;   // shared memory one block may opt into (H100)
// A row's tile sum of P above this sends the warp to the exact path.
constexpr float LAZY_LIMIT = 65536.f;
constexpr uint32_t ONES_BF16X2 = 0x3F803F80u;

struct Strides {
  long long b, h, l;
};

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

// Rows 0..L-1 of one (row, head) sequence copied by cp.async, ``vec`` bytes
// at a time (16, 8 or 4: what D and the strides allow), into ``dst``.
template <int DP>
__device__ __forceinline__ void copy_rows(unsigned char* dst, const bf16* src, long long sl,
                                          int L, int D, int vec, int tid, int nt) {
  const int per_row = D * 2 / vec;
  const uint32_t base = smem_u32(dst);
  for (int i = tid; i < L * per_row; i += nt) {
    const int r = i / per_row, x = (i % per_row) * vec;   // byte in the row
    cp_async(base + Rows<DP>::off(r, x >> 4) + (x & 15),
             (const unsigned char*)(src + r * sl) + x, vec);
  }
}

// Zero what copy_rows leaves alone: dims D..DP-1 of rows < L, and rows
// L..lp-1 whole (disjoint from the copies, so no barrier between them).
template <int DP>
__device__ __forceinline__ void zero_pad(unsigned char* dst, int L, int lp, int D, int tid,
                                         int nt) {
  constexpr int PAIRS = DP / 2;
  const int half = D / 2;
  for (int i = tid; i < lp * PAIRS; i += nt) {
    const int r = i / PAIRS, j = i % PAIRS;
    if (r >= L || j >= half) *(uint32_t*)(dst + Rows<DP>::at(r, 2 * j)) = 0u;
  }
}

// Rows < L rotated in place (pairs (2j, 2j+1), fp32) when ``rot``, times
// ``mul``, rounded to bf16 once.
template <int DP>
__device__ __forceinline__ void rotate_rows(unsigned char* buf, int L, int D,
                                            const float* __restrict__ cosv,
                                            const float* __restrict__ sinv, bool rot,
                                            float mul, int tid, int nt) {
  const int half = D / 2;
  for (int i = tid; i < L * half; i += nt) {
    const int r = i / half, j = i % half;
    __nv_bfloat162* p = (__nv_bfloat162*)(buf + Rows<DP>::at(r, 2 * j));
    const float x0 = __low2float(*p), x1 = __high2float(*p);
    float a = x0, c = x1;
    if (rot) {
      const float cs = cosv[i], sn = sinv[i];   // [L, D/2] tables: i = r * half + j
      a = x0 * cs - x1 * sn;
      c = x1 * cs + x0 * sn;
    }
    *p = __floats2bfloat162_rn(a * mul, c * mul);
  }
}

// ---------------------------------------------------------------- forward

// One tile of NK keys (64, or 16 in the tail) for a warp's 16 queries: keys
// j0.. at byte ``ks``/``vs`` (j0's row), the lane's ldmatrix offsets beside.
template <int DP, int NK, bool MASK>
__device__ __forceinline__ void fwd_tile(const uint32_t (&qf)[DP / 16][4], uint32_t ks,
                                         uint32_t vs, const int (&kofs)[DP / 16],
                                         const int (&vofs)[DP / 16], int j0, int L, bool first,
                                         float& m0, float& m1, float& l0, float& l1,
                                         float (&acc)[DP / 8][4], int lane) {
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

// Forward block shapes (threads, blocks an SM): where two blocks' q, k, v
// fit an SM (3 [L, DP] <= 113 KB), at most 11 warps each and registers for
// two, so that one block's staging overlaps the other's products; else one
// block of up to 16 warps (DP <= 32) or 8.
constexpr int FWD_PAIR_NT = 352;
template <int DP>
constexpr int fwd_solo_threads() { return DP <= 32 ? 512 : 256; }

bool fwd_paired(int L, int D) {
  return D <= 16 && 3 * Rows<16>::bytes(pad16(L)) <= (size_t)SMEM_OPTIN / 2;
}

// Warps of a forward block: as many rounds of query tiles as the widest
// block needs, spread over as few warps as fill them (33 tiles: 11 warps x
// 3 rounds; 129: 15 x 9).
int fwd_warps(int L, int most) {
  const int tiles = pad16(L) / 16;
  const int rounds = (tiles + most - 1) / most;
  return (tiles + rounds - 1) / rounds;
}

template <int DP, int NT, int MINB>
__global__ void __launch_bounds__(NT, MINB) flash_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, const float* __restrict__ cosv, const float* __restrict__ sinv,
    float* __restrict__ lse, int H, int L, int D, int rope, float qmul, int vec, Strides sq,
    Strides sk, Strides sv, Strides so) {
  constexpr int KD = DP / 16, ND = DP / 8, ROWB = Rows<DP>::ROWB;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lp = pad16(L);
  unsigned char* qbuf = smem;
  unsigned char* kbuf = smem + Rows<DP>::bytes(lp);
  unsigned char* vbuf = smem + 2 * Rows<DP>::bytes(lp);
  const int tid = threadIdx.x, nt = blockDim.x, nw = nt / 32;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, c = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const bool rot = rope != 0;

  // q, k, v of the (row, head) in; q -> bf16(R(q) scale log2 e), k -> bf16(R(k))
  copy_rows<DP>(qbuf, q + b * sq.b + h * sq.h, sq.l, L, D, vec, tid, nt);
  copy_rows<DP>(kbuf, k + b * sk.b + h * sk.h, sk.l, L, D, vec, tid, nt);
  copy_rows<DP>(vbuf, v + b * sv.b + h * sv.h, sv.l, L, D, vec, tid, nt);
  cp_async_commit();
  zero_pad<DP>(qbuf, L, lp, D, tid, nt);
  zero_pad<DP>(kbuf, L, lp, D, tid, nt);
  zero_pad<DP>(vbuf, L, lp, D, tid, nt);
  cp_async_wait_all();
  __syncthreads();
  rotate_rows<DP>(qbuf, L, D, cosv, sinv, rot, qmul, tid, nt);
  if (rot) rotate_rows<DP>(kbuf, L, D, cosv, sinv, true, 1.f, tid, nt);
  __syncthreads();
  const uint32_t qs = smem_u32(qbuf), ks = smem_u32(kbuf), vs = smem_u32(vbuf);
  int qofs[KD], kofs[KD], vofs[KD];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    qofs[kd] = lane_lo<DP>(lane, kd);   // Q's A fragment
    kofs[kd] = lane_hi<DP>(lane, kd);   // K's B fragments, two 8-key n-tiles
    vofs[kd] = lane_lo<DP>(lane, kd);   // V's B fragments through .trans
  }

  for (int t = warp; t < lp / 16; t += nw) {
    const int q0 = t * 16, qa = q0 + g, qb = qa + 8;
    uint32_t qf[KD][4];
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) ldsm_x4(qf[kd], qs + q0 * ROWB + qofs[kd]);
    float acc[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    float m0 = 0.f, m1 = 0.f, l0 = 0.f, l1 = 0.f;
    int j0 = 0;
    for (; j0 + 64 <= L; j0 += 64)
      fwd_tile<DP, 64, false>(qf, ks + j0 * ROWB, vs + j0 * ROWB, kofs, vofs, j0, L, j0 == 0,
                              m0, m1, l0, l1, acc, lane);
    for (; j0 < L; j0 += 16)
      fwd_tile<DP, 16, true>(qf, ks + j0 * ROWB, vs + j0 * ROWB, kofs, vofs, j0, L, j0 == 0,
                             m0, m1, l0, l1, acc, lane);

    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    if (lse != nullptr && c == 0) {   // natural log-sum-exp of the scaled scores
      if (qa < L) lse[(size_t)bh * L + qa] = (m0 + __log2f(l0)) * LN2;
      if (qb < L) lse[(size_t)bh * L + qb] = (m1 + __log2f(l1)) * LN2;
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
}

// ------------------------------------------------ streaming (large L)
//
// Where K and V do not fit a block's shared memory: one block per (row and
// head, 128 queries), 64-key tiles of K (rotated) and V (transposed) staged
// per block, the online softmax with the exact max each tile.  The same
// exp2-domain scores and bf16 q' as the resident kernels, so the backward
// recomputes the forward's P whichever kernel ran.

constexpr int SNW = 8;          // warps per block, 16 queries each
constexpr int SNT = SNW * 32;
constexpr int BQ = SNW * 16;    // queries per block
constexpr int TK = 64;          // keys per tile

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
  for (int i = threadIdx.x; i < rows * PAIRS; i += SNT) {
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

template <int DP>
__global__ void __launch_bounds__(SNT) flash_fwd_stream_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o,
    const float* __restrict__ cosv, const float* __restrict__ sinv,
    float* __restrict__ lse, int H, int L, int D, int rope, float qmul, Strides sq,
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

  load_tile<DP>(qg, sq.l, q0, BQ, L, D, cosv, sinv, rope != 0, qmul, false, qs);
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
  // part of the) sum, exp2 domain
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
  const int n_kv = (L + TK - 1) / TK;
  for (int t = 0; t < n_kv; ++t) {
    const int j0 = t * TK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<DP>(kg, sk.l, j0, TK, L, D, cosv, sinv, rope != 0, 1.f, false, ks);
    load_tile<DP>(vg, sv.l, j0, TK, L, D, cosv, sinv, false, 1.f, true, vt);
    __syncthreads();

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
    const float a0 = ex2(m0 - mn0), a1 = ex2(m1 - mn1);  // finite: key j0 < L
    m0 = mn0;
    m1 = mn1;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[j][e] = ex2(sc[j][e] - mn0);
        sc[j][2 + e] = ex2(sc[j][2 + e] - mn1);
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
  if (lse != nullptr && c == 0) {  // natural log-sum-exp of the scaled scores
    if (qa < L) lse[(size_t)blockIdx.x * L + qa] = (m0 + __log2f(sum0)) * LN2;
    if (qb < L) lse[(size_t)blockIdx.x * L + qb] = (m1 + __log2f(sum1)) * LN2;
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

// Bytes of the resident forward's layout, or 0 where it does not fit.
size_t fwd_resident_bytes(int L, int D) {
  const int dp = (D + 15) / 16 * 16, lp = pad16(L);
  size_t bytes = 0;
  switch (dp) {
    case 16: bytes = 3 * Rows<16>::bytes(lp); break;
    case 32: bytes = 3 * Rows<32>::bytes(lp); break;
    case 48: bytes = 3 * Rows<48>::bytes(lp); break;
    case 64: bytes = 3 * Rows<64>::bytes(lp); break;
    default: return 0;
  }
  return bytes <= (size_t)SMEM_OPTIN ? bytes : 0;
}

template <int DP>
int launch_fwd(const bf16* q, const bf16* k, const bf16* v, bf16* o, const float* cosv,
               const float* sinv, float* lse, int B, int H, int L, int D, int rope,
               float scale, int vec, Strides sq, Strides sk, Strides sv, Strides so,
               cudaStream_t st) {
  const float qmul = scale * LOG2E;
  const size_t res = fwd_resident_bytes(L, D);
  if (res) {
    auto kernel = flash_fwd_kernel<DP, fwd_solo_threads<DP>(), 1>;
    int most = fwd_solo_threads<DP>() / 32;
    if constexpr (DP == 16) {
      if (fwd_paired(L, D)) {
        kernel = flash_fwd_kernel<DP, FWD_PAIR_NT, 2>;
        most = FWD_PAIR_NT / 32;
      }
    }
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)res);
    if (e != cudaSuccess) return (int)e;
    kernel<<<(unsigned)(B * H), fwd_warps(L, most) * 32, res, st>>>(
        q, k, v, o, cosv, sinv, lse, H, L, D, rope, qmul, vec, sq, sk, sv, so);
    return (int)cudaGetLastError();
  }
  const size_t smem = Lay<DP>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_stream_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(B * H), (unsigned)((L + BQ - 1) / BQ));
  flash_fwd_stream_kernel<DP><<<grid, SNT, smem, st>>>(q, k, v, o, cosv, sinv, lse, H, L, D,
                                                       rope, qmul, sq, sk, sv, so);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- backward

// Resident backward: D <= 16 (DP 16), up to BW_SLABS slabs of 16 keys per
// warp and BW_WARPS warps.
constexpr int BW_WARPS = 11;
constexpr int BW_SLABS = 3;
constexpr int BW_NT = BW_WARPS * 32;

struct BwdPlan {
  int lp, slabs, per_warp, warps;
  size_t buf, bytes;   // one pair's buffer; the whole layout (0: not resident)
};

// Layout per buffer (two: one computed, one filling): q', k, v, dO, o rows
// [lp, 16] bf16; -lse and -delta (log2 units) [lp] fp32.  Then two slots of
// per-warp dQ^T partials [BW_WARPS][16 dims][SLOT_LD] fp32, 16 queries a
// row padded to 24 so that a warp's float2 stores hit 32 banks (the slots of
// absent warps stay zero, so every sum runs over all BW_WARPS).
constexpr int SLOT_LD = 24;
constexpr int SLOT = 16 * SLOT_LD;
__host__ __device__ inline BwdPlan bwd_plan(int L, int D) {
  BwdPlan p{};
  p.lp = pad16(L);
  p.slabs = p.lp / 16;
  p.per_warp = (p.slabs + BW_WARPS - 1) / BW_WARPS;
  p.warps = (p.slabs + p.per_warp - 1) / p.per_warp;
  p.buf = 5 * Rows<16>::bytes(p.lp) + 2 * (size_t)p.lp * 4;
  const size_t bytes = 2 * p.buf + 2 * (size_t)BW_WARPS * SLOT * 4;
  p.bytes = (D <= 16 && p.per_warp <= BW_SLABS && bytes <= (size_t)SMEM_OPTIN) ? bytes : 0;
  return p;
}

struct BwdArgs {
  const bf16 *q, *k, *v, *o, *dout;
  const float *lse, *cosv, *sinv;
  float* delta;
  bf16 *dq, *dk, *dv;
  int B, H, L, D, rope, vec;
  float scale;
  Strides sq, sk, sv, so, sd, sdq, sdk, sdv;
};

struct BufPtrs {
  unsigned char *q, *k, *v, *d, *o;
  float *nlse, *ndel;
};

__device__ __forceinline__ BufPtrs buf_ptrs(unsigned char* base, const BwdPlan& p) {
  const size_t rb = Rows<16>::bytes(p.lp);
  BufPtrs b;
  b.q = base;
  b.k = base + rb;
  b.v = base + 2 * rb;
  b.d = base + 3 * rb;
  b.o = base + 4 * rb;
  b.nlse = (float*)(base + 5 * rb);
  b.ndel = b.nlse + p.lp;
  return b;
}

// Start the copies of pair bh's inputs into buffer ``bp``.
__device__ __forceinline__ void bwd_prefetch(const BwdArgs& a, const BufPtrs& bp, int bh,
                                             int tid, int nt) {
  const int b = bh / a.H, h = bh % a.H, L = a.L, D = a.D;
  copy_rows<16>(bp.q, a.q + b * a.sq.b + h * a.sq.h, a.sq.l, L, D, a.vec, tid, nt);
  copy_rows<16>(bp.k, a.k + b * a.sk.b + h * a.sk.h, a.sk.l, L, D, a.vec, tid, nt);
  copy_rows<16>(bp.v, a.v + b * a.sv.b + h * a.sv.h, a.sv.l, L, D, a.vec, tid, nt);
  copy_rows<16>(bp.d, a.dout + b * a.sd.b + h * a.sd.h, a.sd.l, L, D, a.vec, tid, nt);
  copy_rows<16>(bp.o, a.o + b * a.so.b + h * a.so.h, a.so.l, L, D, a.vec, tid, nt);
  const float* lrow = a.lse + (size_t)bh * L;
  const uint32_t ls = smem_u32(bp.nlse);
  for (int i = tid; i < L; i += nt) cp_async(ls + 4 * i, lrow + i, 4);
  cp_async_commit();
}

// Once copied: q -> bf16(R(q) scale log2 e), k -> bf16(R(k)), lse -> -lse
// log2 e, delta = -rowsum(dO o).
__device__ __forceinline__ void bwd_install(const BwdArgs& a, const BufPtrs& bp, int tid,
                                            int nt) {
  const int L = a.L, D = a.D, half = D / 2;
  const bool rot = a.rope != 0;
  rotate_rows<16>(bp.q, L, D, a.cosv, a.sinv, rot, a.scale * LOG2E, tid, nt);
  if (rot) rotate_rows<16>(bp.k, L, D, a.cosv, a.sinv, true, 1.f, tid, nt);
  for (int i = tid; i < L; i += nt) {
    float acc = 0.f;
    for (int j = 0; j < half; ++j) {
      const __nv_bfloat162 x = *(const __nv_bfloat162*)(bp.d + Rows<16>::at(i, 2 * j));
      const __nv_bfloat162 y = *(const __nv_bfloat162*)(bp.o + Rows<16>::at(i, 2 * j));
      acc += __low2float(x) * __low2float(y) + __high2float(x) * __high2float(y);
    }
    bp.ndel[i] = -acc;
    bp.nlse[i] = -bp.nlse[i] * LOG2E;
  }
}

// One 16-query tile against the warp's S slabs of 16 keys: P^T, dS^T, dV,
// dK and the warp's dQ^T partial.
template <int S>
__device__ __forceinline__ void bwd_slabs(
    const uint32_t (&qb)[4],
    const uint32_t (&ob)[4], const uint32_t (&qt4)[4], const uint32_t (&ot4)[4],
    const float (&cl)[2][4], const float (&cd)[2][4], uint32_t ks, uint32_t vs, int lo, int hi,
    int warp, int lp, int L, int g, float (&dk)[S][2][4], float (&dv)[S][2][4],
    float (&dqa)[2][4]) {
  constexpr int ROWB = Rows<16>::ROWB;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    // slabs past the last (the last warp's spare) read slab 0 and add
    // nothing: their keys fail the live test
    const int kb = (warp * S + i) * 16, kr = kb < lp ? kb : 0;
    uint32_t ka[4], va[4], kta[4];
    ldsm_x4(ka, ks + kr * ROWB + lo);     // A of S^T: rows = keys, k = dims
    ldsm_x4(va, vs + kr * ROWB + lo);     // A of dP^T
    ldsm_x4_t(kta, ks + kr * ROWB + hi);  // A of dQ^T = K^T dS^T: rows = dims
    float st[2][4], dp[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mma_bf16_c(st[j], ka, qb[2 * j], qb[2 * j + 1], cl[j]);
      mma_bf16_c(dp[j], va, ob[2 * j], ob[2 * j + 1], cd[j]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = ex2(st[j][e]);
    if (kb + 16 > L) {   // the tail slab (or a spare): keys >= L drop out
      const bool live0 = kb + g < L, live1 = kb + g + 8 < L;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        st[j][0] = live0 ? st[j][0] : 0.f;
        st[j][1] = live0 ? st[j][1] : 0.f;
        st[j][2] = live1 ? st[j][2] : 0.f;
        st[j][3] = live1 ? st[j][3] : 0.f;
      }
    }
    // P^T and dS^T = P^T (dP^T - delta) as bf16 A fragments (keys x queries)
    const uint32_t pp[4] = {pack_bf16(st[0][0], st[0][1]), pack_bf16(st[0][2], st[0][3]),
                            pack_bf16(st[1][0], st[1][1]), pack_bf16(st[1][2], st[1][3])};
    const uint32_t ps[4] = {
        pack_bf16(st[0][0] * dp[0][0], st[0][1] * dp[0][1]),
        pack_bf16(st[0][2] * dp[0][2], st[0][3] * dp[0][3]),
        pack_bf16(st[1][0] * dp[1][0], st[1][1] * dp[1][1]),
        pack_bf16(st[1][2] * dp[1][2], st[1][3] * dp[1][3])};
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      mma_bf16(dv[i][n], pp, ot4[2 * n], ot4[2 * n + 1]);
      mma_bf16(dk[i][n], ps, qt4[2 * n], qt4[2 * n + 1]);
    }
    // dS as the B operand (k = keys, n = queries): each 8x8 block moved
    const uint32_t bt[4] = {movmatrix_t(ps[0]), movmatrix_t(ps[1]), movmatrix_t(ps[2]),
                            movmatrix_t(ps[3])};
    mma_bf16(dqa[0], kta, bt[0], bt[1]);
    mma_bf16(dqa[1], kta, bt[2], bt[3]);
  }
}

template <int S>   // slabs per warp
__global__ void __launch_bounds__(BW_NT, 1) flash_bwd_resident_kernel(BwdArgs a) {
  constexpr int ROWB = Rows<16>::ROWB;
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdPlan p = bwd_plan(a.L, a.D);
  const int tid = threadIdx.x, nt = blockDim.x, nw = nt / 32;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, c = lane & 3;
  const int L = a.L, D = a.D, half = D / 2, lp = p.lp;
  const int n_pairs = a.B * a.H;
  float* slots = (float*)(smem + 2 * p.buf);   // [2][BW_WARPS][16 dims][SLOT_LD]
  const bool rot = a.rope != 0;
  const int lo = lane_lo<16>(lane, 0), hi = lane_hi<16>(lane, 0);

  // the pads stay zero (rows >= L, dims >= D), -lse stays -inf beyond L
  // and the slots of absent warps stay zero
  for (int i = nw * SLOT + tid; i < BW_WARPS * SLOT; i += nt) slots[i] = slots[BW_WARPS * SLOT + i] = 0.f;
  for (int s = 0; s < 2; ++s) {
    const BufPtrs bp = buf_ptrs(smem + s * p.buf, p);
    unsigned char* t5[5] = {bp.q, bp.k, bp.v, bp.d, bp.o};
    for (int t = 0; t < 5; ++t) zero_pad<16>(t5[t], L, lp, D, tid, nt);
    for (int i = L + tid; i < lp; i += nt) {
      bp.nlse[i] = -CUDART_INF_F;
      bp.ndel[i] = 0.f;
    }
  }
  int pair = blockIdx.x, cur = 0;
  const int n_items = 16 * half;   // (query, pair) items of a tile's dQ sum
  bwd_prefetch(a, buf_ptrs(smem, p), pair, tid, nt);
  cp_async_wait_all();
  __syncthreads();
  bwd_install(a, buf_ptrs(smem, p), tid, nt);
  __syncthreads();

  for (; pair < n_pairs; pair += gridDim.x) {
    const int next = pair + gridDim.x;
    if (next < n_pairs) bwd_prefetch(a, buf_ptrs(smem + (cur ^ 1) * p.buf, p), next, tid, nt);
    const BufPtrs bp = buf_ptrs(smem + cur * p.buf, p);
    const uint32_t qs = smem_u32(bp.q), ks = smem_u32(bp.k), vs = smem_u32(bp.v),
                   ds = smem_u32(bp.d);
    const int b = pair / a.H, h = pair % a.H;
    bf16* dqg = a.dq + b * a.sdq.b + h * a.sdq.h;

    float dk[S][2][4], dv[S][2][4];
#pragma unroll
    for (int i = 0; i < S; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[i][n][e] = dv[i][n][e] = 0.f;

    int duty = 0;   // 32 x the warp whose first lane takes item 0 this tile
    for (int qt = 0; qt < lp / 16; ++qt) {
      const int q0 = qt * 16;
      // this thread's item of the dQ sum below (query, pair), the duty
      // rotating over the warps tile by tile; its cos/sin fetched now
      const int item = tid >= duty ? tid - duty : tid - duty + nt;
      duty = duty + 32 < nt ? duty + 32 : 0;
      const int rpos = q0 + (item & 15), rj = item >> 4;
      float rcs = 1.f, rsn = 0.f;
      if (item < n_items && rpos < L && rot) {
        rcs = a.cosv[rpos * half + rj];
        rsn = a.sinv[rpos * half + rj];
      }
      // this tile's operands, shared by the warp's slabs
      uint32_t qb[4], ob[4], qt4[4], ot4[4];
      ldsm_x4(qb, qs + q0 * ROWB + hi);     // B of S^T = K Q'^T: 2 n-tiles of queries
      ldsm_x4(ob, ds + q0 * ROWB + hi);     // B of dP^T = V dO^T
      ldsm_x4_t(qt4, qs + q0 * ROWB + lo);  // B of dK += dS^T Q': k = queries
      ldsm_x4_t(ot4, ds + q0 * ROWB + lo);  // B of dV += P^T dO
      float cl[2][4], cd[2][4];   // accumulators' starts: -lse, -delta per column
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 l2 = *(const float2*)(bp.nlse + q0 + 8 * j + 2 * c);
        const float2 d2 = *(const float2*)(bp.ndel + q0 + 8 * j + 2 * c);
        cl[j][0] = cl[j][2] = l2.x;
        cl[j][1] = cl[j][3] = l2.y;
        cd[j][0] = cd[j][2] = d2.x;
        cd[j][1] = cd[j][3] = d2.y;
      }
      float dqa[2][4];   // dQ^T [16 dims, 16 queries] of this warp's slabs
#pragma unroll
      for (int j = 0; j < 2; ++j) dqa[j][0] = dqa[j][1] = dqa[j][2] = dqa[j][3] = 0.f;

      bwd_slabs<S>(qb, ob, qt4, ot4, cl, cd, ks, vs, lo, hi, warp, lp, L, g, dk, dv, dqa);
      // dQ^T partials: slot [warp][dim][query]; one barrier a tile (two slots)
      float* slot = slots + (size_t)(qt & 1) * BW_WARPS * SLOT;
      float* mine = slot + warp * SLOT;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        *(float2*)(mine + g * SLOT_LD + 8 * j + 2 * c) = make_float2(dqa[j][0], dqa[j][1]);
        *(float2*)(mine + (g + 8) * SLOT_LD + 8 * j + 2 * c) =
            make_float2(dqa[j][2], dqa[j][3]);
      }
      __syncthreads();
      // sum in warp order (neighbouring threads on neighbouring queries),
      // rotate back, store; a block of fewer threads than items loops
      for (int it = item; it < n_items; it += nt) {
        const int iq = it & 15, ij = it >> 4, ipos = q0 + iq;
        if (ipos >= L) continue;
        float cs = rcs, sn = rsn;
        if (it != item && rot) {
          cs = a.cosv[ipos * half + ij];
          sn = a.sinv[ipos * half + ij];
        }
        float x0 = 0.f, x1 = 0.f;
#pragma unroll
        for (int w = 0; w < BW_WARPS; ++w) {
          x0 += slot[w * SLOT + (2 * ij) * SLOT_LD + iq];
          x1 += slot[w * SLOT + (2 * ij + 1) * SLOT_LD + iq];
        }
        x0 *= a.scale;
        x1 *= a.scale;
        const float y0 = x0 * cs + x1 * sn;
        x1 = x1 * cs - x0 * sn;
        *(__nv_bfloat162*)(dqg + ipos * a.sdq.l + 2 * ij) = __floats2bfloat162_rn(y0, x1);
      }
    }
    // dK = R^T(ln 2 dS^T Q'), dV = P^T dO for the warp's slabs
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int slab = warp * S + i;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = 8 * n + 2 * c, j = col / 2;
        if (col >= D) continue;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int pos = slab * 16 + g + 8 * r;
          if (pos >= L) continue;
          float x0 = dk[i][n][2 * r] * LN2, x1 = dk[i][n][2 * r + 1] * LN2;
          if (rot) {
            const float cs = a.cosv[pos * half + j], sn = a.sinv[pos * half + j];
            const float y0 = x0 * cs + x1 * sn;
            x1 = x1 * cs - x0 * sn;
            x0 = y0;
          }
          *(__nv_bfloat162*)(a.dk + b * a.sdk.b + h * a.sdk.h + pos * a.sdk.l + col) =
              __floats2bfloat162_rn(x0, x1);
          *(__nv_bfloat162*)(a.dv + b * a.sdv.b + h * a.sdv.h + pos * a.sdv.l + col) =
              __floats2bfloat162_rn(dv[i][n][2 * r], dv[i][n][2 * r + 1]);
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();   // this pair's reads done, the next pair's copies landed
    if (next < n_pairs) {
      bwd_install(a, buf_ptrs(smem + (cur ^ 1) * p.buf, p), tid, nt);
      __syncthreads();
    }
    cur ^= 1;
  }
}

// Streaming backward (outside the resident gate), FlashAttention-2's in two
// launches with no atomics after a pre-pass:
//   pre:   delta[i] = sum_d dO[i, d] o[i, d]                  (fp32, per query)
//   dq:    one block per (row and head, 128 queries), a loop over 64-key
//          tiles: P = ex2(S - lse log2 e) recomputed from the forward's
//          stash, dP = dO V^T, dS = P (dP - delta), dq += dS K; at the end
//          dq = scale R^T(dq);
//   dkdv:  one block per (row and head, 128 keys), a loop over 64-query
//          tiles: P^T, dV += P^T dO, dP^T = V dO^T, dS^T, dK += dS^T q'; at
//          the end dk = R^T(ln 2 dk).

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

// acc [16, 64] = A [16, DP] (fragments) x B^T, B's 64 rows [64, LD] in
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
__global__ void __launch_bounds__(SNT) flash_bwd_dq_kernel(
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
  load_tile<DP>(q + b * sq.b + h * sq.h, sq.l, q0, BQ, L, D, cosv, sinv, rot,
                scale * LOG2E, false, own);
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
  const float la = qa < L ? lrow[qa] * LOG2E : CUDART_INF_F;
  const float lb = qb < L ? lrow[qb] * LOG2E : CUDART_INF_F;
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
    mma_rows<DP>(p, qf, ks, g, c);    // S = Q' K^T
    mma_rows<DP>(dp, df, vs, g, c);   // dP = dO V^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool live = j0 + 8 * j + 2 * c + e < L;
        const float pa = live ? ex2(p[j][e] - la) : 0.f;
        const float pb = live ? ex2(p[j][2 + e] - lb) : 0.f;
        p[j][e] = pa * (dp[j][e] - da);           // dS
        p[j][2 + e] = pb * (dp[j][2 + e] - db);
      }
    mma_cols<DP>(acc, p, kt, g, c);   // dQ += dS K
  }
  store_rows<DP>(acc, dq + b * sdq.b + h * sdq.h, sdq.l, qa, qb, L, D, scale, rot, cosv,
                 sinv, c);
}

template <int DP>
__global__ void __launch_bounds__(SNT) flash_bwd_dkdv_kernel(
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
  const float qmul = scale * LOG2E;
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
    load_tile<DP>(qg, sq.l, i0, TK, L, D, cosv, sinv, rot, qmul, false, qs);
    load_tile<DP>(qg, sq.l, i0, TK, L, D, cosv, sinv, rot, qmul, true, qt);
    load_tile<DP>(dg, sd.l, i0, TK, L, D, cosv, sinv, false, 1.f, false, ds);
    load_tile<DP>(dg, sd.l, i0, TK, L, D, cosv, sinv, false, 1.f, true, dt);
    for (int i = threadIdx.x; i < TK; i += SNT) {
      const int pos = i0 + i;
      ls[i] = pos < L ? lrow[pos] * LOG2E : CUDART_INF_F;   // P = 0 for queries >= L
      dl[i] = pos < L ? drow[pos] : 0.f;
    }
    __syncthreads();
    float p[8][4], dp[8][4];
    mma_rows<DP>(p, kf, qs, g, c);    // S^T = K Q'^T (keys g, g+8 x 64 queries)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] = ex2(p[j][e] - ls[8 * j + 2 * c + (e & 1)]);
    mma_cols<DP>(accv, p, dt, g, c);  // dV += P^T dO
    mma_rows<DP>(dp, vf, ds, g, c);   // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] *= dp[j][e] - dl[8 * j + 2 * c + (e & 1)];
    mma_cols<DP>(acck, p, qt, g, c);  // dK += dS^T q'
  }
  const int ka = k0 + warp * 16 + g, kb = ka + 8;
  store_rows<DP>(acck, dk + b * sdk.b + h * sdk.h, sdk.l, ka, kb, L, D, LN2, rot, cosv,
                 sinv, c);
  store_rows<DP>(accv, dv + b * sdv.b + h * sdv.h, sdv.l, ka, kb, L, D, 1.f, false, cosv,
                 sinv, c);
}

template <int DP>
int launch_bwd_stream(const BwdArgs& a, cudaStream_t st) {
  const long long n = (long long)a.B * a.H * a.L;
  flash_bwd_pre_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      a.o, a.dout, a.delta, a.H, a.L, a.D, a.so, a.sd, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(a.B * a.H), (unsigned)((a.L + BQ - 1) / BQ));
  e = cudaFuncSetAttribute(flash_bwd_dq_kernel<DP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)BLay<DP>::dq);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_kernel<DP><<<grid, SNT, BLay<DP>::dq, st>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dq, a.cosv, a.sinv, a.H, a.L, a.D, a.rope,
      a.scale, a.sq, a.sk, a.sv, a.sd, a.sdq);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<DP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)BLay<DP>::dkdv);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv_kernel<DP><<<grid, SNT, BLay<DP>::dkdv, st>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dk, a.dv, a.cosv, a.sinv, a.H, a.L, a.D,
      a.rope, a.scale, a.sq, a.sk, a.sv, a.sd, a.sdk, a.sdv);
  return (int)cudaGetLastError();
}

template <int S>
int launch_bwd_resident(const BwdArgs& a, const BwdPlan& p, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_resident_kernel<S>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)p.bytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  const int pairs = a.B * a.H;
  flash_bwd_resident_kernel<S><<<(unsigned)std::min(pairs, sms), p.warps * 32, p.bytes, st>>>(a);
  return (int)cudaGetLastError();
}

// The widest copy (16, 8 or 4 bytes) that D and every row's address allow.
int copy_width(int D, const void* const* ptrs, const long long* strides, int n) {
  for (int w = 16; w >= 4; w /= 2) {
    bool ok = (D * 2) % w == 0;
    for (int i = 0; i < n && ok; ++i) {
      ok = (uintptr_t)ptrs[i] % w == 0;
      for (int s = 0; s < 3; ++s) ok = ok && (strides[3 * i + s] * 2) % w == 0;
    }
    if (ok) return w;
  }
  return 4;
}

}  // namespace

// q, k, v, o: [B, H, L, D] bf16 with element strides (b, h, l) each and unit
// stride in D, every stride even (pairs are read as 4-byte words); cos/sin
// [L, D/2] fp32 (read only with rope != 0); scale = 1/sqrt(D).  D even,
// 2 <= D <= 64 (the wrapper checks).  lse: null, or [B*H, L] fp32 for the
// backward (training): the natural log-sum-exp of the scaled scores.
extern "C" int flash_attention_forward(
    const void* q, const void* k, const void* v, void* o, const void* cosv,
    const void* sinv, void* lse, int B, int H, int L, int D, int rope, float scale,
    long long qb, long long qh, long long ql, long long kb, long long kh,
    long long kl, long long vb, long long vh, long long vl, long long ob,
    long long oh, long long ol, void* stream) {
  const Strides sq{qb, qh, ql}, sk{kb, kh, kl}, sv{vb, vh, vl}, so{ob, oh, ol};
  const cudaStream_t st = (cudaStream_t)stream;
  const void* kv[2] = {k, v};
  const long long kvs[6] = {kb, kh, kl, vb, vh, vl};
  const int vec = copy_width(D, kv, kvs, 2);
#define FLASH_ARGS                                                                   \
  (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (const float*)cosv,      \
      (const float*)sinv, (float*)lse, B, H, L, D, rope, scale, vec, sq, sk, sv, so, st
  const int dp = (D + 15) / 16 * 16;
  switch (dp) {
    case 16: return launch_fwd<16>(FLASH_ARGS);
    case 32: return launch_fwd<32>(FLASH_ARGS);
    case 48: return launch_fwd<48>(FLASH_ARGS);
    case 64: return launch_fwd<64>(FLASH_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_ARGS
}

// Backward (kernel #7).  q, k, v, o as the forward's; dout, dq, dk, dv
// [B, H, L, D] bf16 strided views likewise; lse [B*H, L] fp32, the
// forward's stash; delta [B*H, L] fp32 scratch (the streaming kernels').
// strides: 24 element strides, (b, h, l) of q, k, v, o, dout, dq, dk, dv in
// that order.
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
  const void* ins[5] = {q, k, v, o, dout};
  a.vec = copy_width(D, ins, strides, 5);
  const cudaStream_t st = (cudaStream_t)stream;
  const BwdPlan p = bwd_plan(L, D);
  if (p.bytes) {
    switch (p.per_warp) {
      case 1: return launch_bwd_resident<1>(a, p, st);
      case 2: return launch_bwd_resident<2>(a, p, st);
      default: return launch_bwd_resident<3>(a, p, st);
    }
  }
  switch ((D + 15) / 16 * 16) {
    case 16: return launch_bwd_stream<16>(a, st);
    case 32: return launch_bwd_stream<32>(a, st);
    case 48: return launch_bwd_stream<48>(a, st);
    case 64: return launch_bwd_stream<64>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The layouts' shared-memory bytes, for the wrapper's gates: the resident
// forward's and the resident backward's, 0 where a call takes the streaming
// kernels instead.
extern "C" long long flash_forward_resident_bytes(int L, int D) {
  return (long long)fwd_resident_bytes(L, D);
}

extern "C" long long flash_backward_resident_bytes(int L, int D) {
  return (long long)bwd_plan(L, D).bytes;
}
