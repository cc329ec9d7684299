// Fused attention step:  out = x + OutProj(softmax(RoPE(q) RoPE(k)^T / sqrt(D)) v)
// with q, k, v = QKV(RMSGroupNorm(x)).
//
// Kernel #3 (forward) replaces the JAX package's Pallas kernel
// ``ops/pallas/attention_block.py::_attn_forward`` (``:393``, its
// ``pallas_call`` at ``:431``, body ``_attn_kernel``); kernel #4 (backward)
// replaces ``::_attn_backward_pallas`` (``:626``, ``pallas_call`` at ``:669``,
// body ``_attn_bwd_kernel``).  Public ``fused_attention_block``, with both
// reference dropout sites: on the attention probabilities (drop after
// normalising: the softmax denominator is the undropped sum) and on the
// out-projection (masks from ``philox.cuh``, survivors scaled by 1/(1-p)).
//
// Shapes: x [R, L, C] bf16 rows, attention over L within each row, H heads
// of width D = A / H, zero-padded to DP = 32 (base config: C = A = 96, H 4,
// D 24, L 1025 on the frequency path and the frames on the time path;
// BS-Locoformer: C = A = 128, D 32).
//
// What bounds it on the H100: the exponentials.  Every score needs one exp
// on the special-function units (~3.9 T a second): 5.8 G scores at base
// serving freq are 1.49 ms, against 0.67 ms of products at the bf16 peak;
// the [H, L, L] scores must never reach device memory (~23 GB in fp32
// there).  So the core is flash attention #6's register design
// (``flash_tile.cuh``): q' = bf16(R(q) scale log2 e), so that a score is
// already the exponent; the running max subtracted by the tensor cores and
// rescaled lazily; row sums by an MMA against a ones column; S, P and O in
// mma.sync m16n8k16 registers fed by ldmatrix from XOR-swizzled rows.
// Dropout costs integer work: a Philox4x32-10 draw (~55 instructions) per
// four scores, shared by the lanes that hold them; on the H100 it triples
// the core's time at base training (1.1 -> 3.7 ms at the freq path).
// Launches:
//   1. ``attn_qkv_kernel``: one block per (row, 64 positions): fp32
//      RMSGroupNorm to bf16 in shared memory, the QKV product on mma.sync
//      (the block's A fragments held for the three parts), q/k/v rounded to
//      bf16, RoPE in fp32 on q and k, q times scale log2 e, rounded once,
//      written from the registers as [R, H, Lpad, 32] bf16 (dims >= D and
//      positions >= L zero; Lpad a multiple of 64);
//   2. the core, one of:
//      ``attn_core_res_kernel``, one block per (row, head) while k and v fit
//      (2 x 64 B x L <= 227 KB: L <= 1808): they are staged once by cp.async
//      in chunks of 256 keys, each chunk's arrival counted on an mbarrier,
//      so that the warps start on the first keys while the rest land; each
//      warp walks 16-query tiles (q' fragments read from device memory)
//      over all keys with no block barrier;
//      ``attn_core_stream_kernel`` beyond that: one block per (row and head,
//      128 queries), 64-key tiles of k and v through a cp.async double
//      buffer, the same tile arithmetic (so the backward recomputes the
//      forward's P whichever ran);
//      either writes the normalised head outputs o [R, Lpad, H*32] bf16 and,
//      in training, the log-sum-exp in log2 units [R, H, Lpad] fp32;
//   3. ``attn_out_kernel``: one block per (row, 64 positions): the
//      out-projection o Wo on mma.sync (a block holds one head in launch 2,
//      so the sum over heads runs here), the out-projection dropout and the
//      residual in fp32, rounded once.  o costs 2 x 256 B a position at
//      base, ~0.2 ms of bytes at base serving freq.
// The probability mask keeps ``probability_mask``'s bits: Philox words at
// (row, head, key / 4, query); lanes 4g + c and 4g + (c ^ 1) hold the same
// four keys of queries g and g + 8, each draws the words of one query and
// one shuffle swaps the keep bits.  The ones-column MMA sums the undropped
// P; the mask zeroes P's A fragments before P V.
//
// Backward, FlashAttention-2's two score passes in the same register design
// (one (row, head)'s q', k, v, dO and o, 348 KB at L 1025, do not fit one
// block, and a one-pass kernel's per-key-block dq partials would need ~0.5
// GiB at base training), each launch owning its outputs (no atomics: the
// same bits every run):
//   4. ``attn_bwd_pre_kernel`` per (row, 64 positions): dproj = g * mask,
//      dO = dproj Wo^T per head, delta = rowsum(dO o);
//   5. ``attn_bwd_dq_reg_kernel`` per (row and head, 128 queries), 64-key
//      tiles of k and v through a cp.async double buffer: S = Q' K^T with
//      the accumulator started at -lse, P = ex2(S), dP = dO V^T, the mask
//      replayed, dS = P (mask dP / (1-p) - delta), dQ += dS K in registers;
//      dq = R^T(dQ / sqrt(D)).  Under dropout it also writes the mask it
//      drew, a 64-bit word per (row, head, 64-key tile, query): a bit a
//      score read back instead of a Philox draw (~55 integer instructions)
//      per four (0.3 GB at base training freq, freed with the call);
//   6. ``attn_bwd_dkdv_reg_kernel`` per (row and head, 128 keys), 64-query
//      tiles of q', dO, lse, delta and those mask words likewise: S^T, P^T,
//      dP^T, dS^T, dV += (mask P)^T dO, dK += dS^T Q'; dk = R^T(ln 2 dK),
//      dv = dV / (1-p).  P and dS are rounded to bf16 as the products'
//      operands; no score tile touches shared memory;
//   7. ``attn_bwd_final_kernel`` per (row, 64 positions): dxn = dqkv Wqkv
//      on mma.sync, the norm's backward, the residual; xn written for the
//      weights;
//   8. the weight gradients dWqkv = dqkv^T xn and dWo = o^T dproj as
//      deterministic split-K products (``wgrad.cuh``), dgamma from
//      per-block partials reduced in order, in segments of 64 blocks.
// Bound: two exponentials per score (the two passes) against five
// score-class products; the weight products ~42 GFLOP at base training.
#include <cuda_runtime.h>
#include <mma.h>

#include "flash_tile.cuh"
#include "hopper.cuh"
#include "philox.cuh"
#include "wgrad.cuh"

using namespace nvcuda;

namespace {

constexpr int DP = 32;  // padded head dim
constexpr int TQ = 64;  // positions per QKV / out-projection / pre / final tile
constexpr int ROWB = Rows<DP>::ROWB;   // bytes of a swizzled [*, 32] row

// ---------------------------------------------------------------- launch 1

constexpr int QKV_NT = 128;   // 4 warps, 16 positions each

// The QKV launch's tiles: rows of C bf16 as C/8 16-byte chunks at a stride
// of C/8 + 1 chunks (odd, so the 8 rows an ldmatrix reads hit 32 banks):
// the block's 64 positions of x, normalised in place, then one part (q, k
// or v: A rows, padded with zero rows to a multiple of 16, the products'
// width: A is a multiple of 8, 24 at a shard of one head of 24) of Wqkv at
// a time.
size_t qkv_bytes(int C, int A) { return (size_t)(TQ + (A + 15) / 16 * 16) * (C / 8 + 1) * 16; }

// One block per (row, 64 positions): x and the part's weights staged by
// cp.async, the fp32 RMSGroupNorm in place, y = xn W^T on mma.sync (A
// fragments held for the three parts), then from the registers: rounded
// to bf16, RoPE on q and k in fp32, q times scale log2 e, rounded once,
// stored as [R, H, Lpad, 32] (a lane holds a RoPE pair); dims >= D zero.
template <int C>
__global__ void __launch_bounds__(QKV_NT) attn_qkv_kernel(
    const bf16* __restrict__ x, const float* __restrict__ gamma,
    const bf16* __restrict__ wqkv, const float* __restrict__ cosv,
    const float* __restrict__ sinv, bf16* __restrict__ q, bf16* __restrict__ k,
    bf16* __restrict__ v, int L, int Lpad, int H, int D, int dpg, float rdpg, float eps,
    float qmul, int rope, int tiles) {
  constexpr int NCH = C / 8, RB = (NCH + 1) * 16, KC = C / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* xt = smem;
  const uint32_t xs = smem_u32(smem), ws = xs + TQ * RB;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, c = lane & 3;
  const int A = H * D, half = D / 2;
  const int row = blockIdx.x / tiles, p0 = (blockIdx.x % tiles) * TQ;
  const bf16* xr = x + (size_t)row * L * C;
  auto stage_part = [&](int part) {
    for (int i = tid; i < A * NCH; i += QKV_NT)
      cp_async(ws + (i / NCH) * RB + (i % NCH) * 16,
               wqkv + ((size_t)part * A + i / NCH) * C + 8 * (i % NCH), 16);
    cp_async_commit();
  };
  for (int i = tid; i < ((A + 15) / 16 * 16 - A) * NCH; i += QKV_NT)   // weight rows >= A
    *(uint4*)(xt + (TQ + A + i / NCH) * RB + (i % NCH) * 16) = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < TQ * NCH; i += QKV_NT) {   // rows >= L: zero
    const int r = i / NCH, ch = i % NCH;
    if (p0 + r < L)
      cp_async(xs + r * RB + ch * 16, xr + (size_t)(p0 + r) * C + 8 * ch, 16);
    else
      *(uint4*)(xt + r * RB + ch * 16) = make_uint4(0, 0, 0, 0);
  }
  stage_part(0);
  cp_async_wait_all();
  __syncthreads();
  // fp32 RMSGroupNorm per (position, group), rounded once (the arithmetic of
  // rmsgroupnorm.cuh, which the FFN step's kernels use)
  const int groups = C / dpg;
  for (int it = tid; it < TQ * groups; it += QKV_NT) {
    bf16* e = (bf16*)(xt + (it / groups) * RB) + (it % groups) * dpg;
    const float* gm = gamma + (it % groups) * dpg;
    float ss = 0.f;
    for (int j = 0; j < dpg; ++j) {
      const float t = __bfloat162float(e[j]);
      ss += t * t;
    }
    const float inv = 1.f / (sqrtf(ss) * rdpg + eps);
    for (int j = 0; j < dpg; ++j) e[j] = __float2bfloat16(__bfloat162float(e[j]) * inv * gm[j]);
  }
  __syncthreads();
  uint32_t af[KC][4];   // the warp's 16 rows as A fragments
  const int lo = (((lane >> 3) & 1) * 8 + (lane & 7)) * RB + (lane >> 4) * 16;
  const int hi = ((lane >> 4) * 8 + (lane & 7)) * RB + ((lane >> 3) & 1) * 16;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) ldsm_x4(af[kc], xs + 16 * warp * RB + lo + 32 * kc);
  for (int part = 0; part < 3; ++part) {
    if (part > 0) {   // every warp done with the previous part's weights
      __syncthreads();
      stage_part(part);
      cp_async_wait_all();
      __syncthreads();
    }
    bf16* dst = part == 0 ? q : (part == 1 ? k : v);
    const bool rot = rope && part < 2;
    const float mul = part == 0 ? qmul : 1.f;
    for (int n0 = 0; n0 < A; n0 += 64) {   // 64 outputs at a time
      float acc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (n0 + 16 * np >= A) break;
#pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          uint32_t b[4];   // (outputs 0-7 | 8-15) x (channels 16 kc .. | +8 ..)
          ldsm_x4(b, ws + (n0 + 16 * np) * RB + hi + 32 * kc);
          mma_bf16(acc[2 * np], af[kc], b[0], b[1]);
          mma_bf16(acc[2 * np + 1], af[kc], b[2], b[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int f = n0 + 8 * n + 2 * c;   // output pair (f, f + 1): one head's pair
        if (n0 + 8 * n >= A) break;
        const int h = f / D, d = f % D;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int pos = p0 + 16 * warp + g + 8 * r;
          // projections rounded to bf16 first, as the JAX kernel does
          float a0 = __bfloat162float(__float2bfloat16(acc[n][2 * r]));
          float a1 = __bfloat162float(__float2bfloat16(acc[n][2 * r + 1]));
          if (rot && pos < L) {
            const float cs = cosv[(size_t)pos * half + d / 2], sn = sinv[(size_t)pos * half + d / 2];
            const float t0 = a0 * cs - a1 * sn;
            a1 = a1 * cs + a0 * sn;
            a0 = t0;
          }
          *(__nv_bfloat162*)(dst + (((size_t)row * H + h) * Lpad + pos) * DP + d) =
              __floats2bfloat162_rn(a0 * mul, a1 * mul);
        }
      }
    }
    const int pp = (DP - D) / 2;   // head dims D..31: zero
    for (int i = tid; i < TQ * H * pp; i += QKV_NT) {
      const int r = i / (H * pp), h = (i / pp) % H;
      *(uint32_t*)(dst + (((size_t)row * H + h) * Lpad + p0 + r) * DP + D + 2 * (i % pp)) = 0u;
    }
  }
}

// ------------------------------------------------------------ primitives

__device__ __forceinline__ uint32_t ld32(const bf16* p) { return *(const uint32_t*)p; }

// Four bf16 (8 bytes, 8-byte aligned) as floats, and back.
__device__ __forceinline__ float4 ld_bf16x4(const bf16* p) {
  const uint2 u = *(const uint2*)p;
  const float2 a = __bfloat1622float2(*(const __nv_bfloat162*)&u.x);
  const float2 b = __bfloat1622float2(*(const __nv_bfloat162*)&u.y);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ uint2 pack_bf16x4(float4 v) {
  return make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

// The out-projection dropout of four channels (one Philox draw).
__device__ __forceinline__ float4 drop4(const DropParams& dp, uint32_t row, int pos, int c0,
                                        float4 v) {
  const Philox4 w = dropout_words(dp.seed, SITE_ATTN_PROJ, row, pos, c0 >> 2, 0);
  v.x = w.w[0] < dp.thr ? v.x * dp.scale : 0.f;
  v.y = w.w[1] < dp.thr ? v.y * dp.scale : 0.f;
  v.z = w.w[2] < dp.thr ? v.z * dp.scale : 0.f;
  v.w = w.w[3] < dp.thr ? v.w * dp.scale : 0.f;
  return v;
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Count this thread's cp.async copies issued so far on ``bar``: one arrival
// when they have landed (the barrier expects one from every thread).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// mma A fragments of rows r0 .. r0+15 of a [*, 32] bf16 block in device
// memory (rows g, g + 8; dims 2c, 2c + 1 and + 8 of each 16).
__device__ __forceinline__ void frag_rows(const bf16* base, int r0, int lane,
                                          uint32_t (&f)[DP / 16][4]) {
  const bf16* a = base + (size_t)(r0 + (lane >> 2)) * DP + 2 * (lane & 3);
  const bf16* b = a + 8 * DP;
#pragma unroll
  for (int kd = 0; kd < DP / 16; ++kd) {
    f[kd][0] = ld32(a + 16 * kd);
    f[kd][1] = ld32(b + 16 * kd);
    f[kd][2] = ld32(a + 16 * kd + 8);
    f[kd][3] = ld32(b + 16 * kd + 8);
  }
}

// Rows r0 .. r0+n-1 of a [*, 32] bf16 block (``src`` at row 0) copied by
// 16-byte cp.async into the swizzled rows of ``dst`` (row 0 at ``dst``).
__device__ __forceinline__ void stage_rows(uint32_t dst, const bf16* src, int r0, int n,
                                           int tid, int nt) {
  for (int i = tid; i < n * 4; i += nt) {
    const int r = r0 + (i >> 2), x = i & 3;
    cp_async(dst + Rows<DP>::off(r, x), src + (size_t)r * DP + 8 * x, 16);
  }
}

// ------------------------------------------------------- probability mask
//
// Keep bits of a lane's fragment rows g, g + 8 (queries qa, qb) over NJ
// n-tiles of 8 keys from key j0 (a multiple of 4): the key j0 + 8 j + 2c + e
// is kept in row r when bit 4 j + 2 (c & 1) + e of ``bits[r]`` is set.
// Lanes c and c ^ 1 share each group of four keys (one Philox call): lane
// c & 1 == 0 draws query qa's words, the other qb's, and one shuffle swaps.
template <int NJ>
__device__ __forceinline__ void row_keep_bits(const DropParams& dp, uint32_t row, uint32_t head,
                                              int j0, int qa, int qb, int lane,
                                              uint32_t& b0, uint32_t& b1) {
  const int c = lane & 3, h = c & 1;
  uint32_t own = 0;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const Philox4 w = dropout_words(dp.seed, SITE_ATTN_PROB, row, head,
                                    (uint32_t)(j0 >> 2) + 2 * j + (c >> 1), h ? qb : qa);
#pragma unroll
    for (int e = 0; e < 4; ++e) own |= (uint32_t)(w.w[e] < dp.thr) << (4 * j + e);
  }
  const uint32_t other = __shfl_xor_sync(0xffffffffu, own, 1);
  b0 = h ? other : own;
  b1 = h ? own : other;
}

// ``fwd_tile``'s dropout hook: zero the dropped entries of P's A fragments
// (pa[kk]: rows g, g + 8 of n-tile 2 kk, then of n-tile 2 kk + 1).
struct ProbDrop {
  DropParams dp;
  uint32_t row, head;
  int qa, qb;
  template <int NKK>
  __device__ __forceinline__ void operator()(uint32_t (&pa)[NKK][4], int j0, int lane) const {
    if (!dp.on) return;
    uint32_t b0, b1;
    row_keep_bits<2 * NKK>(dp, row, head, j0, qa, qb, lane, b0, b1);
    const int sh = 2 * (lane & 1);
#pragma unroll
    for (int kk = 0; kk < NKK; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t two = ((i & 1 ? b1 : b0) >> (4 * (2 * kk + (i >> 1)) + sh)) & 3u;
        pa[kk][i] &= (two & 1u) * 0xFFFFu | (two >> 1) * 0xFFFF0000u;
      }
  }
};

// ---------------------------------------------------------------- launch 2

// A warp's 16 queries done: o = O / l (times 1/(1-p) under dropout) into o
// [R, Lpad, H*32] and, for training, lse = m + log2 l into [R, H, Lpad];
// rows >= L are not written.
__device__ __forceinline__ void core_finish(const float (&acc)[DP / 8][4], float m0, float m1,
                                            float l0, float l1, int bh, int row, int h, int H,
                                            int qa, int qb, int L, int Lpad, float mul,
                                            bf16* __restrict__ o, float* __restrict__ lse,
                                            int c) {
  const float inv0 = mul / l0, inv1 = mul / l1;
  if (lse != nullptr && c == 0) {
    if (qa < L) lse[(size_t)bh * Lpad + qa] = m0 + __log2f(l0);
    if (qb < L) lse[(size_t)bh * Lpad + qb] = m1 + __log2f(l1);
  }
  const size_t HD = (size_t)H * DP;
  bf16* oa = o + ((size_t)row * Lpad + qa) * HD + h * DP;
  bf16* ob = oa + 8 * HD;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = 8 * n + 2 * c;
    if (qa < L)
      *(__nv_bfloat162*)(oa + col) = __floats2bfloat162_rn(acc[n][0] * inv0, acc[n][1] * inv0);
    if (qb < L)
      *(__nv_bfloat162*)(ob + col) = __floats2bfloat162_rn(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

constexpr int CORE_MAX_NT = 512;   // resident core: at most 16 warps
constexpr int CHUNK = 256;         // keys a staged chunk (a multiple of 64)
constexpr int MAX_CHUNKS = 8;

// Resident core layout: k and v [pad16(L), 32] swizzled, then the chunks'
// mbarriers; 0 where it does not fit (the streaming core takes the call).
size_t core_resident_bytes(int L) {
  const int lp = pad16(L);
  const size_t bytes = 2 * Rows<DP>::bytes(lp) + MAX_CHUNKS * 8;
  return (bytes <= (size_t)SMEM_OPTIN && (lp + CHUNK - 1) / CHUNK <= MAX_CHUNKS) ? bytes : 0;
}

// Warps of a resident block: the query tiles in as few rounds as 16 warps
// allow, spread over as few warps as fill them (65 tiles: 13 x 5).
int core_warps(int L) {
  const int tiles = pad16(L) / 16;
  const int rounds = (tiles + CORE_MAX_NT / 32 - 1) / (CORE_MAX_NT / 32);
  return (tiles + rounds - 1) / rounds;
}

__global__ void __launch_bounds__(CORE_MAX_NT, 1) attn_core_res_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, int L, int Lpad, int H, DropParams dp) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lp = pad16(L), nch = (lp + CHUNK - 1) / CHUNK;
  const uint32_t ks = smem_u32(smem), vs = ks + (uint32_t)Rows<DP>::bytes(lp);
  uint64_t* bars = (uint64_t*)(smem + 2 * Rows<DP>::bytes(lp));
  const int tid = threadIdx.x, nt = blockDim.x, nw = nt / 32;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, c = lane & 3;
  const int bh = blockIdx.x, row = bh / H, h = bh % H;
  const size_t head = (size_t)bh * Lpad * DP;

  if (tid == 0) {
    for (int i = 0; i < nch; ++i) hop::mbar_init(&bars[i], nt);
    hop::mbar_init_fence();
  }
  __syncthreads();
  // every chunk's copies in flight at once; chunk i lands on bars[i]
  for (int ch = 0; ch < nch; ++ch) {
    const int r0 = ch * CHUNK, n = min(CHUNK, lp - r0);
    stage_rows(ks, k + head, r0, n, tid, nt);
    stage_rows(vs, v + head, r0, n, tid, nt);
    cp_async_arrive(&bars[ch]);
  }
  int kofs[DP / 16], vofs[DP / 16];
#pragma unroll
  for (int kd = 0; kd < DP / 16; ++kd) {
    kofs[kd] = lane_hi<DP>(lane, kd);   // K's B fragments, two 8-key n-tiles
    vofs[kd] = lane_lo<DP>(lane, kd);   // V's B fragments through .trans
  }
  ProbDrop drop{dp, dp.row0 + row, (uint32_t)h, 0, 0};
  for (int t = warp; t < lp / 16; t += nw) {
    const int q0 = t * 16;
    drop.qa = q0 + g;
    drop.qb = q0 + g + 8;
    uint32_t qf[DP / 16][4];
    frag_rows(q + head, q0, lane, qf);
    float acc[DP / 8][4];
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    float m0 = 0.f, m1 = 0.f, l0 = 0.f, l1 = 0.f;
    int j0 = 0;
    for (; j0 + 64 <= L; j0 += 64) {
      if ((j0 & (CHUNK - 1)) == 0) hop::mbar_wait(&bars[j0 / CHUNK], 0);
      fwd_tile<DP, 64, false>(qf, ks + j0 * ROWB, vs + j0 * ROWB, kofs, vofs, j0, L, j0 == 0,
                              m0, m1, l0, l1, acc, lane, drop);
    }
    for (; j0 < L; j0 += 16) {
      if ((j0 & (CHUNK - 1)) == 0) hop::mbar_wait(&bars[j0 / CHUNK], 0);
      fwd_tile<DP, 16, true>(qf, ks + j0 * ROWB, vs + j0 * ROWB, kofs, vofs, j0, L, j0 == 0,
                             m0, m1, l0, l1, acc, lane, drop);
    }
    core_finish(acc, m0, m1, l0, l1, bh, row, h, H, q0 + g, q0 + g + 8, L, Lpad,
                dp.on ? dp.scale : 1.f, o, lse, c);
  }
}

// Streaming core (beyond the resident gate) and the backward's tiles.
constexpr int SNW = 8;              // warps a block, 16 rows each
constexpr int SNT = SNW * 32;
constexpr int SBQ = SNW * 16;       // rows (queries or keys) a block
constexpr int TILE = 64 * ROWB;     // one 64-row swizzled tile: 4 KB
constexpr size_t CORE_STREAM_BYTES = 2 * 2 * TILE;   // (k, v) x 2 stages

__global__ void __launch_bounds__(SNT) attn_core_stream_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, int L, int Lpad, int H, DropParams dp) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);   // stage s: k at base + 2 s TILE, v after it
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, c = lane & 3;
  const int bh = blockIdx.x, row = bh / H, h = bh % H;
  const int q0 = blockIdx.y * SBQ + warp * 16;
  const bool active = q0 < L;
  const size_t head = (size_t)bh * Lpad * DP;
  const int n_kv = (L + 63) / 64;
  auto stage = [&](int t) {
    const uint32_t s = base + (uint32_t)((t & 1) * 2 * TILE);
    stage_rows(s, k + head + (size_t)t * 64 * DP, 0, 64, tid, SNT);
    stage_rows(s + TILE, v + head + (size_t)t * 64 * DP, 0, 64, tid, SNT);
    cp_async_commit();
  };
  stage(0);
  int kofs[DP / 16], vofs[DP / 16];
#pragma unroll
  for (int kd = 0; kd < DP / 16; ++kd) {
    kofs[kd] = lane_hi<DP>(lane, kd);
    vofs[kd] = lane_lo<DP>(lane, kd);
  }
  uint32_t qf[DP / 16][4];
  if (active) frag_rows(q + head, q0, lane, qf);
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = 0.f, m1 = 0.f, l0 = 0.f, l1 = 0.f;
  const ProbDrop drop{dp, dp.row0 + row, (uint32_t)h, q0 + g, q0 + g + 8};
  for (int t = 0; t < n_kv; ++t) {
    if (t + 1 < n_kv) {
      stage(t + 1);
      cp_async_wait_group<1>();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    if (active) {
      const uint32_t kb = base + (uint32_t)((t & 1) * 2 * TILE), vb = kb + TILE;
      const int j0 = 64 * t;
      if (j0 + 64 <= L) {
        fwd_tile<DP, 64, false>(qf, kb, vb, kofs, vofs, j0, L, t == 0, m0, m1, l0, l1, acc,
                                lane, drop);
      } else {
        for (int j = j0; j < L; j += 16)
          fwd_tile<DP, 16, true>(qf, kb + (j - j0) * ROWB, vb + (j - j0) * ROWB, kofs, vofs, j,
                                 L, j == 0, m0, m1, l0, l1, acc, lane, drop);
      }
    }
    __syncthreads();   // every warp done with this stage before it is refilled
  }
  if (active)
    core_finish(acc, m0, m1, l0, l1, bh, row, h, H, q0 + g, q0 + g + 8, L, Lpad,
                dp.on ? dp.scale : 1.f, o, lse, c);
}

// ---------------------------------------------------------------- launch 3

constexpr int OUT_NT = 128;   // 4 warps, 16 positions each
constexpr int OUT_KC = 128;   // head dims (k) staged at a time
constexpr int OUT_RO = (OUT_KC / 8 + 1) * 16;   // o tile row stride (odd chunks)

size_t out_bytes(int C) { return (size_t)TQ * OUT_RO + (size_t)OUT_KC * (C / 8 + 1) * 16; }

// out = x + drop(o Wo) for 64 positions of a row: o [64, H*32] and Wo
// [H*32, C] staged by cp.async 128 head dims at a time (rows of odd chunk
// stride), the product on mma.sync (Wo's B fragments through
// ldmatrix.trans) into registers, then the out-projection dropout (lanes c
// and c ^ 1 share each Philox draw of four channels) and the residual in
// fp32 from the registers, rounded once.
template <int C>
__global__ void __launch_bounds__(OUT_NT) attn_out_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ o, const bf16* __restrict__ wo,
    bf16* __restrict__ out, int L, int Lpad, int H, int tiles, DropParams dp, bool res) {
  constexpr int NJ = C / 8, RW = (C / 8 + 1) * 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t os = smem_u32(smem), ws = os + TQ * OUT_RO;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, c = lane & 3;
  const int HD = H * DP;
  const int row = blockIdx.x / tiles, p0 = (blockIdx.x % tiles) * TQ;
  const int lo_o = (((lane >> 3) & 1) * 8 + (lane & 7)) * OUT_RO + (lane >> 4) * 16;
  const int lo_w = (((lane >> 3) & 1) * 8 + (lane & 7)) * RW + (lane >> 4) * 16;
  float acc[NJ][4];
#pragma unroll
  for (int n = 0; n < NJ; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int k0 = 0; k0 < HD; k0 += OUT_KC) {
    const int kw = min(OUT_KC, HD - k0);   // a multiple of 32
    if (k0 > 0) __syncthreads();   // every warp done with the previous stage
    // rows >= L of o are never written: they only reach rows not stored
    for (int i = tid; i < TQ * (kw / 8); i += OUT_NT)
      cp_async(os + (i / (kw / 8)) * OUT_RO + (i % (kw / 8)) * 16,
               o + ((size_t)row * Lpad + p0 + i / (kw / 8)) * HD + k0 + 8 * (i % (kw / 8)), 16);
    for (int i = tid; i < kw * NJ; i += OUT_NT)
      cp_async(ws + (i / NJ) * RW + (i % NJ) * 16, wo + (size_t)(k0 + i / NJ) * C + 8 * (i % NJ),
               16);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    for (int kk = 0; kk < kw / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, os + 16 * warp * OUT_RO + lo_o + 32 * kk);
#pragma unroll
      for (int np = 0; np < NJ / 2; ++np) {
        uint32_t b[4];   // (head dims 16 kk ..) x (channels 16 np .. +7 | +8 .. +15)
        ldsm_x4_t(b, ws + 16 * kk * RW + lo_w + 32 * np);
        mma_bf16(acc[2 * np], a, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
  // out-projection dropout at (position, channel): lane c & 1 draws the
  // words of row g (0) or g + 8 (1) for the channel groups 2n + c / 2
  const int hs = c & 1;
  uint64_t bits[2] = {~0ull, ~0ull};
  if (dp.on) {
    const int posh = p0 + 16 * warp + g + 8 * hs;
    uint64_t own = 0;
#pragma unroll
    for (int n = 0; n < NJ; ++n) {
      const Philox4 w = dropout_words(dp.seed, SITE_ATTN_PROJ, dp.row0 + row, posh,
                                      2 * n + (c >> 1), 0);
#pragma unroll
      for (int e = 0; e < 4; ++e) own |= (uint64_t)(w.w[e] < dp.thr) << (4 * n + e);
    }
    const uint64_t other = __shfl_xor_sync(0xffffffffu, own, 1);
    bits[0] = hs ? other : own;
    bits[1] = hs ? own : other;
  }
  const bf16* xr = x + (size_t)row * L * C;
  bf16* outr = out + (size_t)row * L * C;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = p0 + 16 * warp + g + 8 * r;
    if (pos >= L) continue;
#pragma unroll
    for (int n = 0; n < NJ; ++n) {
      const int col = 8 * n + 2 * c;
      float z0 = acc[n][2 * r], z1 = acc[n][2 * r + 1];
      if (dp.on) {
        const uint32_t two = (uint32_t)(bits[r] >> (4 * n + 2 * hs)) & 3u;
        z0 = two & 1u ? z0 * dp.scale : 0.f;
        z1 = two & 2u ? z1 * dp.scale : 0.f;
      }
      const float2 xv = res ? __bfloat1622float2(*(const __nv_bfloat162*)(xr + (size_t)pos * C + col))
                            : make_float2(0.f, 0.f);
      *(__nv_bfloat162*)(outr + (size_t)pos * C + col) = __floats2bfloat162_rn(xv.x + z0, xv.y + z1);
    }
  }
}

// ---------------------------------------------------------------- backward

constexpr int BW_NT = 128;  // the pre kernel: 4 warps, 16 positions each

// 4. dproj = g * mask / (1-p) (rows >= L zero), do = dproj Wo^T [R,H,Lpad,32],
//    D[h, q] = sum_j do[q, h, j] * o[q, h, j] (do rounded to bf16 first).
__global__ void __launch_bounds__(BW_NT) attn_bwd_pre_kernel(
    const bf16* __restrict__ g, const bf16* __restrict__ wo,
    const bf16* __restrict__ o_stash, bf16* __restrict__ dproj,
    bf16* __restrict__ dout, float* __restrict__ Dsum, int L, int Lpad, int C,
    int H, int tiles, DropParams dp) {
  const int HD = H * DP, LDC = C + 16, LDT = HD + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ps = (bf16*)smem;                                   // [64, LDC]
  float* ts = (float*)(smem + (size_t)TQ * LDC * 2);         // [64, LDT]
  const int row = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * TQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < TQ * C / 4; i += BW_NT) {   // 4 channels a thread
    const int l = i / (C / 4), c0 = (i % (C / 4)) * 4;
    const int pos = q0 + l;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (pos < L) {
      v = ld_bf16x4(g + ((size_t)row * L + pos) * C + c0);
      if (dp.on) v = drop4(dp, dp.row0 + row, pos, c0, v);
    }
    const uint2 b = pack_bf16x4(v);
    *(uint2*)(ps + l * LDC + c0) = b;
    *(uint2*)(dproj + ((size_t)row * Lpad + pos) * C + c0) = b;
  }
  __syncthreads();
  // do [16, HD] per warp = dproj [16, C] x Wo^T; Wo [HD, C]: col-major B
  for (int nj = 0; nj < HD / 16; ++nj) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kc = 0; kc < C / 16; ++kc) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(a, ps + warp * 16 * LDC + kc * 16, LDC);
      wmma::load_matrix_sync(b, wo + (size_t)nj * 16 * C + kc * 16, C);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(ts + warp * 16 * LDT + nj * 16, acc, LDT, wmma::mem_row_major);
  }
  __syncwarp();
  // the warp's 16 rows x H heads x 4 chunks of 8 dims, 16-byte stores of
  // dO; the 4 lanes of a (row, head) sum its delta by shuffles (2H passes:
  // every lane in each)
  for (int i = lane; i < 16 * H * 4; i += 32) {
    const int ch = i & 3, h = (i >> 2) % H, r = (i >> 2) / H;
    const int pos = q0 + warp * 16 + r;
    const float* tp = ts + (warp * 16 + r) * LDT + h * DP + 8 * ch;
    const float4 t0 = *(const float4*)tp, t1 = *(const float4*)(tp + 4);
    const uint4 b = make_uint4(pack_bf16(t0.x, t0.y), pack_bf16(t0.z, t0.w),
                               pack_bf16(t1.x, t1.y), pack_bf16(t1.z, t1.w));
    *(uint4*)(dout + (((size_t)row * H + h) * Lpad + pos) * DP + 8 * ch) = b;
    float d = 0.f;
    if (pos < L) {   // o rows >= L are never written (their dO is zero)
      const uint4 ov = *(const uint4*)(o_stash + ((size_t)row * Lpad + pos) * HD + h * DP + 8 * ch);
      const uint32_t bw[4] = {b.x, b.y, b.z, b.w}, ow[4] = {ov.x, ov.y, ov.z, ov.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 dv = __bfloat1622float2(*(const __nv_bfloat162*)&bw[e]);
        const float2 on = __bfloat1622float2(*(const __nv_bfloat162*)&ow[e]);
        d += dv.x * on.x + dv.y * on.y;
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    if (ch == 0) Dsum[((size_t)row * H + h) * Lpad + pos] = d;
  }
}

// Store a warp's fp32 accumulator rows (g, g + 8: positions pa, pb) of one
// head's gradient into dqkv's row block ``dst`` ([Lpad, 3A], the head's
// column already added): times ``mul``, rotated back by R^T (cos/sin
// tables: identity without RoPE), dims >= D and positions >= L dropped.
__device__ __forceinline__ void store_grad(const float (&acc)[DP / 8][4], bf16* dst, int A3,
                                           int pa, int pb, int L, int D, float mul,
                                           const float* __restrict__ cosv,
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
      const float x0 = acc[n][2 * r] * mul, x1 = acc[n][2 * r + 1] * mul;
      const float cs = cosv[(size_t)pos * half + col / 2], sn = sinv[(size_t)pos * half + col / 2];
      *(__nv_bfloat162*)(dst + (size_t)pos * A3 + col) =
          __floats2bfloat162_rn(x0 * cs + x1 * sn, x1 * cs - x0 * sn);
    }
  }
}

// 5. dq per (row and head, 128 queries): 64-key tiles of k and v through a
//    cp.async double buffer, the warp's 16 queries' q' and dO as A
//    fragments in registers, per 16 keys: S = Q' K^T - lse (log2 units, the
//    accumulator started at -lse), P = ex2(S), dP = dO V^T, dS = P (mask
//    dP / (1-p) - delta), dQ += dS K (K through ldmatrix.trans).
template <bool DROP>
__global__ void __launch_bounds__(SNT, 2) attn_bwd_dq_reg_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const float* __restrict__ cosv,
    const float* __restrict__ sinv, bf16* __restrict__ dqkv, uint64_t* __restrict__ mbits,
    int L, int Lpad, int H, int D, float qscale, DropParams dp) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);   // stage s: k at base + 2 s TILE, v after it
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, c = lane & 3;
  const int bh = blockIdx.x, row = bh / H, h = bh % H;
  const int q0 = blockIdx.y * SBQ + warp * 16, qa = q0 + g, qb = qa + 8;
  const bool active = q0 < L;
  const size_t head = (size_t)bh * Lpad * DP;
  const int n_kv = (L + 63) / 64;
  auto stage = [&](int t) {
    const uint32_t s = base + (uint32_t)((t & 1) * 2 * TILE);
    stage_rows(s, k + head + (size_t)t * 64 * DP, 0, 64, tid, SNT);
    stage_rows(s + TILE, v + head + (size_t)t * 64 * DP, 0, 64, tid, SNT);
    cp_async_commit();
  };
  stage(0);
  int bofs[DP / 16], tofs[DP / 16];
#pragma unroll
  for (int kd = 0; kd < DP / 16; ++kd) {
    bofs[kd] = lane_hi<DP>(lane, kd);   // B fragments of rows (keys): S, dP
    tofs[kd] = lane_lo<DP>(lane, kd);   // B fragments through .trans: dQ += dS K
  }
  uint32_t qf[DP / 16][4], df[DP / 16][4];
  float cl[4] = {0.f, 0.f, 0.f, 0.f}, da = 0.f, db = 0.f;
  if (active) {
    frag_rows(q + head, q0, lane, qf);
    frag_rows(dout + head, q0, lane, df);
    const float la = qa < L ? lse[(size_t)bh * Lpad + qa] : CUDART_INF_F;
    const float lb = qb < L ? lse[(size_t)bh * Lpad + qb] : CUDART_INF_F;
    cl[0] = cl[1] = -la;
    cl[2] = cl[3] = -lb;
    da = qa < L ? delta[(size_t)bh * Lpad + qa] : 0.f;
    db = qb < L ? delta[(size_t)bh * Lpad + qb] : 0.f;
  }
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int sh = 2 * (c & 1);
  for (int t = 0; t < n_kv; ++t) {
    if (t + 1 < n_kv) {
      stage(t + 1);
      cp_async_wait_group<1>();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    if (active) {
      const uint32_t kb = base + (uint32_t)((t & 1) * 2 * TILE), vb = kb + TILE;
      const int j0 = 64 * t;
      uint32_t b0 = 0, b1 = 0;
      if (DROP) {
        row_keep_bits<8>(dp, dp.row0 + row, h, j0, qa, qb, lane, b0, b1);
        // the tile's mask for the dk/dv pass, a 64-bit word per query (bit
        // = key): lanes c < 2 hold keys 8j + 0..3, lanes c ^ 2 keys 8j + 4..7
        const uint32_t o0 = __shfl_xor_sync(0xffffffffu, b0, 2);
        const uint32_t o1 = __shfl_xor_sync(0xffffffffu, b1, 2);
        if (c < 2) {
          const uint32_t lo = c ? b1 : b0, hi = c ? o1 : o0;
          uint64_t word = 0;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            word |= (uint64_t)((lo >> (4 * j)) & 0xFu) << (8 * j) |
                    (uint64_t)((hi >> (4 * j)) & 0xFu) << (8 * j + 4);
          mbits[((size_t)bh * (Lpad / 64) + t) * Lpad + (c ? qb : qa)] = word;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float s[2][4], dpv[2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) dpv[jj][0] = dpv[jj][1] = dpv[jj][2] = dpv[jj][3] = 0.f;
#pragma unroll
        for (int kd = 0; kd < DP / 16; ++kd) {
          uint32_t bk[4], bv[4];   // (keys 0-7 | 8-15) x (dims 16 kd .. +7 | +8 .. +15)
          ldsm_x4(bk, kb + 16 * kk * ROWB + bofs[kd]);
          ldsm_x4(bv, vb + 16 * kk * ROWB + bofs[kd]);
          if (kd == 0) {
            mma_bf16_c(s[0], qf[0], bk[0], bk[1], cl);
            mma_bf16_c(s[1], qf[0], bk[2], bk[3], cl);
          } else {
            mma_bf16(s[0], qf[kd], bk[0], bk[1]);
            mma_bf16(s[1], qf[kd], bk[2], bk[3]);
          }
          mma_bf16(dpv[0], df[kd], bv[0], bv[1]);
          mma_bf16(dpv[1], df[kd], bv[2], bv[3]);
        }
        float ds[2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[jj][i] = ex2(s[jj][i]);
        if (j0 + 64 > L) {   // the last tile: keys >= L drop out
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (j0 + 16 * kk + 8 * jj + 2 * c + (i & 1) >= L) s[jj][i] = 0.f;
        }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = i >> 1, e = i & 1, j = 2 * kk + jj;
            const float p = s[jj][i];
            float d = dpv[jj][i];
            if (DROP) d = ((r ? b1 : b0) >> (4 * j + sh + e)) & 1u ? d * dp.scale : 0.f;
            ds[jj][i] = p * (d - (r ? db : da));
          }
        const uint32_t pa[4] = {pack_bf16(ds[0][0], ds[0][1]), pack_bf16(ds[0][2], ds[0][3]),
                                pack_bf16(ds[1][0], ds[1][1]), pack_bf16(ds[1][2], ds[1][3])};
#pragma unroll
        for (int np = 0; np < DP / 16; ++np) {
          uint32_t b[4];   // (keys 0-15) x (dims 16 np .. +7 | +8 .. +15)
          ldsm_x4_t(b, kb + 16 * kk * ROWB + tofs[np]);
          mma_bf16(acc[2 * np], pa, b[0], b[1]);
          mma_bf16(acc[2 * np + 1], pa, b[2], b[3]);
        }
      }
    }
    __syncthreads();   // every warp done with this stage before it is refilled
  }
  if (active)
    store_grad(acc, dqkv + (size_t)row * Lpad * 3 * H * D + h * D, 3 * H * D, qa, qb, L, D,
               qscale, cosv, sinv, c);
}

// 6. dk, dv per (row and head, 128 keys): 64-query tiles of q', dO and the
//    negated log-sum-exp and delta through a cp.async double buffer, the
//    warp's 16 keys' k and v as A fragments, per 16 queries: S^T = K Q'^T -
//    lse, P^T = ex2(S^T), dP^T = V dO^T, dV += (mask P^T) dO, dS^T = P^T
//    (mask dP^T / (1-p) - delta), dK += dS^T Q' (dO, Q' through .trans).
// q', dO; -lse, delta; the mask words of the block's two key tiles
constexpr size_t DKDV_STAGE = 2 * TILE + 2 * 64 * 4 + 2 * 64 * 8;
constexpr size_t DKDV_BYTES = 2 * DKDV_STAGE;

template <bool DROP>
__global__ void __launch_bounds__(SNT, 2) attn_bwd_dkdv_reg_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const float* __restrict__ cosv,
    const float* __restrict__ sinv, bf16* __restrict__ dqkv, const uint64_t* __restrict__ mbits,
    int L, int Lpad, int H, int D, DropParams dp) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, c = lane & 3;
  const int bh = blockIdx.x, row = bh / H, h = bh % H;
  const int k0 = blockIdx.y * SBQ + warp * 16;
  const bool active = k0 < L;
  const size_t head = (size_t)bh * Lpad * DP;
  const float* lrow = lse + (size_t)bh * Lpad;
  const float* drow = delta + (size_t)bh * Lpad;
  const int n_q = (L + 63) / 64;
  auto stage = [&](int t) {
    unsigned char* s = smem + (t & 1) * DKDV_STAGE;
    const uint32_t sa = base + (uint32_t)((t & 1) * DKDV_STAGE);
    stage_rows(sa, q + head + (size_t)t * 64 * DP, 0, 64, tid, SNT);
    stage_rows(sa + TILE, dout + head + (size_t)t * 64 * DP, 0, 64, tid, SNT);
    if (DROP)   // 2 key tiles x 64 queries x 8 bytes, 16 bytes a copy
      for (int i = tid; i < 64; i += SNT) {
        const int kt = 2 * blockIdx.y + i / 32;
        if (kt < Lpad / 64)
          cp_async(sa + 2 * TILE + 512 + 8 * 2 * i,
                   mbits + ((size_t)bh * (Lpad / 64) + kt) * Lpad + 64 * t + 2 * (i % 32), 16);
      }
    cp_async_commit();
    float* nl = (float*)(s + 2 * TILE);
    for (int i = tid; i < 64; i += SNT) {   // queries >= L: P = ex2(-inf) = 0
      const int pos = 64 * t + i;
      nl[i] = pos < L ? -lrow[pos] : -CUDART_INF_F;
      nl[64 + i] = pos < L ? drow[pos] : 0.f;
    }
  };
  stage(0);
  int bofs[DP / 16], tofs[DP / 16];
#pragma unroll
  for (int kd = 0; kd < DP / 16; ++kd) {
    bofs[kd] = lane_hi<DP>(lane, kd);   // B fragments of rows (queries): S^T, dP^T
    tofs[kd] = lane_lo<DP>(lane, kd);   // B fragments through .trans: dV, dK
  }
  uint32_t kf[DP / 16][4], vf[DP / 16][4];
  if (active) {
    frag_rows(k + head, k0, lane, kf);
    frag_rows(v + head, k0, lane, vf);
  }
  float dk[DP / 8][4], dv[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  for (int t = 0; t < n_q; ++t) {
    if (t + 1 < n_q) {
      stage(t + 1);
      cp_async_wait_group<1>();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();
    if (active) {
      const uint32_t qs = base + (uint32_t)((t & 1) * DKDV_STAGE), ds = qs + TILE;
      const float* nl = (const float*)(smem + (t & 1) * DKDV_STAGE + 2 * TILE);
      const float* dl = nl + 64;
      // keep bit 4 j + 2 e + r: key g + 8 r against query 8 j + 2c + e, read
      // from the words the dq pass wrote (the warp's 16 keys lie in one
      // 64-key tile)
      uint32_t keep = 0;
      if (DROP) {
        const uint64_t* bw =
            (const uint64_t*)(smem + (t & 1) * DKDV_STAGE + 2 * TILE + 512) + 64 * (warp / 4);
        const int ko = 16 * (warp % 4) + g;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const uint64_t w = bw[8 * j + 2 * c + e];
            keep |= (uint32_t)((w >> ko) & 1u) << (4 * j + 2 * e) |
                    (uint32_t)((w >> (ko + 8)) & 1u) << (4 * j + 2 * e + 1);
          }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float cl[2][4], dcol[2][2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const float2 l2 = *(const float2*)(nl + 16 * kk + 8 * jj + 2 * c);
          const float2 d2 = *(const float2*)(dl + 16 * kk + 8 * jj + 2 * c);
          cl[jj][0] = cl[jj][2] = l2.x;
          cl[jj][1] = cl[jj][3] = l2.y;
          dcol[jj][0] = d2.x;
          dcol[jj][1] = d2.y;
        }
        float st[2][4], dpt[2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) dpt[jj][0] = dpt[jj][1] = dpt[jj][2] = dpt[jj][3] = 0.f;
#pragma unroll
        for (int kd = 0; kd < DP / 16; ++kd) {
          uint32_t bq[4], bd[4];   // (queries 0-7 | 8-15) x (dims 16 kd .. | +8 ..)
          ldsm_x4(bq, qs + 16 * kk * ROWB + bofs[kd]);
          ldsm_x4(bd, ds + 16 * kk * ROWB + bofs[kd]);
          if (kd == 0) {
            mma_bf16_c(st[0], kf[0], bq[0], bq[1], cl[0]);
            mma_bf16_c(st[1], kf[0], bq[2], bq[3], cl[1]);
          } else {
            mma_bf16(st[0], kf[kd], bq[0], bq[1]);
            mma_bf16(st[1], kf[kd], bq[2], bq[3]);
          }
          mma_bf16(dpt[0], vf[kd], bd[0], bd[1]);
          mma_bf16(dpt[1], vf[kd], bd[2], bd[3]);
        }
        float pd[2][4], dsv[2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = i >> 1, e = i & 1;
            const float p = ex2(st[jj][i]);
            float d = dpt[jj][i], pk = p;
            if (DROP) {
              const bool kept = (keep >> (4 * (2 * kk + jj) + 2 * e + r)) & 1u;
              d = kept ? d * dp.scale : 0.f;
              pk = kept ? p : 0.f;
            }
            pd[jj][i] = pk;
            dsv[jj][i] = p * (d - dcol[jj][e]);
          }
        const uint32_t pp[4] = {pack_bf16(pd[0][0], pd[0][1]), pack_bf16(pd[0][2], pd[0][3]),
                                pack_bf16(pd[1][0], pd[1][1]), pack_bf16(pd[1][2], pd[1][3])};
        const uint32_t ps[4] = {pack_bf16(dsv[0][0], dsv[0][1]), pack_bf16(dsv[0][2], dsv[0][3]),
                                pack_bf16(dsv[1][0], dsv[1][1]), pack_bf16(dsv[1][2], dsv[1][3])};
#pragma unroll
        for (int np = 0; np < DP / 16; ++np) {
          uint32_t bd[4], bq[4];   // (queries 0-15) x (dims 16 np .. +7 | +8 .. +15)
          ldsm_x4_t(bd, ds + 16 * kk * ROWB + tofs[np]);
          ldsm_x4_t(bq, qs + 16 * kk * ROWB + tofs[np]);
          mma_bf16(dv[2 * np], pp, bd[0], bd[1]);
          mma_bf16(dv[2 * np + 1], pp, bd[2], bd[3]);
          mma_bf16(dk[2 * np], ps, bq[0], bq[1]);
          mma_bf16(dk[2 * np + 1], ps, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();   // every warp done with this stage before it is refilled
  }
  if (active) {
    const int A = H * D;
    bf16* dst = dqkv + (size_t)row * Lpad * 3 * A + h * D;
    store_grad(dk, dst + A, 3 * A, k0 + g, k0 + g + 8, L, D, LN2, cosv, sinv, c);
    // dv: not rotated
    const float mul = DROP ? dp.scale : 1.f;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = 8 * n + 2 * c;
      if (col >= D) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int pos = k0 + g + 8 * r;
        if (pos < L)
          *(__nv_bfloat162*)(dst + 2 * A + (size_t)pos * 3 * A + col) =
              __floats2bfloat162_rn(dv[n][2 * r] * mul, dv[n][2 * r + 1] * mul);
      }
    }
  }
}

// x, gamma and the fp32 row's values at one channel, or four (vector loads).
template <int STEP>
__device__ __forceinline__ void load4(const bf16* x, const float* gm, const float* z,
                                      float (&xv)[4], float (&gv)[4], float (&zv)[4]) {
  if (STEP == 4) {
    const float4 a = ld_bf16x4(x), b = *(const float4*)gm, c = *(const float4*)z;
    xv[0] = a.x, xv[1] = a.y, xv[2] = a.z, xv[3] = a.w;
    gv[0] = b.x, gv[1] = b.y, gv[2] = b.z, gv[3] = b.w;
    zv[0] = c.x, zv[1] = c.y, zv[2] = c.z, zv[3] = c.w;
  } else {
    xv[0] = __bfloat162float(*x);
    gv[0] = *gm;
    zv[0] = *z;
  }
}

// 7. dxn = dqkv [64, 3A] x Wqkv [3A, C] on mma.sync (both staged by
//    cp.async 128 columns of dqkv at a time, Wqkv's B fragments through
//    ldmatrix.trans), the fp32 rows then in shared memory for the norm's
//    backward, the residual, xn out, the per-block dgamma partial.
constexpr int FIN_NT = 128;   // 4 warps, 16 positions each
constexpr int FIN_KC = 128;   // dqkv columns staged at a time

// the stages (dqkv and Wqkv rows), then the fp32 dxn rows in their place
size_t bwd_final_bytes(int C) {
  const size_t z = (size_t)TQ * (C + 4) * 4;
  const size_t st = (size_t)TQ * OUT_RO + (size_t)FIN_KC * (C / 8 + 1) * 16;
  return z > st ? z : st;
}

template <int C, int STEP>   // STEP: channels at a time in the norm's backward
__global__ void __launch_bounds__(FIN_NT) attn_bwd_final_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ g,
    const float* __restrict__ gamma, const bf16* __restrict__ wqkv,
    const bf16* __restrict__ dqkv, bf16* __restrict__ dx,
    bf16* __restrict__ xn_out, float* __restrict__ part, int L, int Lpad,
    int A, int dpg, float rdpg, float eps, int tiles, bool res) {
  constexpr int NJ = C / 8, RW = (C / 8 + 1) * 16, LDZ = C + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t qs = smem_u32(smem), ws = qs + TQ * OUT_RO;
  float* zs = (float*)smem;   // [64, LDZ], after the product
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gr = lane >> 2, lc = lane & 3;
  const int row = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * TQ;
  const int A3 = 3 * A;
  const int lo_q = (((lane >> 3) & 1) * 8 + (lane & 7)) * OUT_RO + (lane >> 4) * 16;
  const int lo_w = (((lane >> 3) & 1) * 8 + (lane & 7)) * RW + (lane >> 4) * 16;
  float acc[NJ][4];
#pragma unroll
  for (int n = 0; n < NJ; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int k0 = 0; k0 < A3; k0 += FIN_KC) {
    const int kw = min(FIN_KC, A3 - k0);   // a multiple of 8
    const int kp = (kw + 15) / 16 * 16;    // zero columns to the products' 16
    if (k0 > 0) __syncthreads();   // every warp done with the previous stage
    // per 8 tail columns j: dqkv's chunk j of every row, Wqkv's rows 8 j ..
    for (int i = tid; i < (kp - kw) / 8 * (TQ + 8 * NJ); i += FIN_NT) {
      const int u = i % (TQ + 8 * NJ), j = kw / 8 + i / (TQ + 8 * NJ), v = u - TQ;
      if (u < TQ)
        *(uint4*)(smem + u * OUT_RO + j * 16) = make_uint4(0, 0, 0, 0);
      else
        *(uint4*)(smem + TQ * OUT_RO + (8 * j + v / NJ) * RW + (v % NJ) * 16) =
            make_uint4(0, 0, 0, 0);
    }
    // dqkv rows >= L are never written: they only reach rows not used
    for (int i = tid; i < TQ * (kw / 8); i += FIN_NT)
      cp_async(qs + (i / (kw / 8)) * OUT_RO + (i % (kw / 8)) * 16,
               dqkv + ((size_t)row * Lpad + q0 + i / (kw / 8)) * A3 + k0 + 8 * (i % (kw / 8)),
               16);
    for (int i = tid; i < kw * NJ; i += FIN_NT)
      cp_async(ws + (i / NJ) * RW + (i % NJ) * 16, wqkv + (size_t)(k0 + i / NJ) * C + 8 * (i % NJ),
               16);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    for (int kk = 0; kk < kp / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, qs + 16 * warp * OUT_RO + lo_q + 32 * kk);
#pragma unroll
      for (int np = 0; np < NJ / 2; ++np) {
        uint32_t b[4];   // (dqkv columns 16 kk ..) x (channels 16 np .. +7 | +8 .. +15)
        ldsm_x4_t(b, ws + 16 * kk * RW + lo_w + 32 * np);
        mma_bf16(acc[2 * np], a, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
  __syncthreads();   // every warp done with the stages: the fp32 rows take their place
#pragma unroll
  for (int n = 0; n < NJ; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *(float2*)(zs + (16 * warp + gr + 8 * r) * LDZ + 8 * n + 2 * lc) =
          make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  __syncthreads();
  const int n_valid = min(TQ, L - q0);
  const int groups = C / dpg;
  const size_t xrow = (size_t)row * L;
  // per (position, group), STEP channels at a time (8-byte loads and stores)
  for (int item = threadIdx.x; item < n_valid * groups; item += FIN_NT) {
    const int l = item / groups, gi = item % groups;
    const size_t off = (xrow + q0 + l) * C + gi * dpg;
    const size_t xoff = ((size_t)row * Lpad + q0 + l) * C + gi * dpg;
    float* zr = zs + l * LDZ + gi * dpg;
    const float* gm = gamma + gi * dpg;
    float ss = 0.f, tsum = 0.f;
    for (int c = 0; c < dpg; c += STEP) {
      float xv[4], gv[4], zv[4];
      load4<STEP>(x + off + c, gm + c, zr + c, xv, gv, zv);
#pragma unroll
      for (int e = 0; e < STEP; ++e) {
        ss += xv[e] * xv[e];
        tsum += gv[e] * zv[e] * xv[e];
      }
    }
    const float rr = sqrtf(ss) * rdpg;
    const float inv = 1.f / (rr + eps);
    const float k2 = rr > 0.f ? tsum * inv * inv / (dpg * rr) : 0.f;
    for (int c = 0; c < dpg; c += STEP) {
      float xv[4], gv[4], zv[4], gg[4], dxv[4], xnv[4];
      load4<STEP>(x + off + c, gm + c, zr + c, xv, gv, zv);
      if (!res) {   // partial-sum mode: no identity term
        gg[0] = gg[1] = gg[2] = gg[3] = 0.f;
      } else if (STEP == 4) {
        const float4 t = ld_bf16x4(g + off + c);
        gg[0] = t.x, gg[1] = t.y, gg[2] = t.z, gg[3] = t.w;
      } else {
        gg[0] = __bfloat162float(g[off + c]);
      }
#pragma unroll
      for (int e = 0; e < STEP; ++e) {
        dxv[e] = gv[e] * zv[e] * inv - xv[e] * k2 + gg[e];
        xnv[e] = xv[e] * inv * gv[e];
        zr[c + e] = zv[e] * xv[e] * inv;
      }
      if (STEP == 4) {
        *(uint2*)(dx + off + c) = pack_bf16x4(make_float4(dxv[0], dxv[1], dxv[2], dxv[3]));
        *(uint2*)(xn_out + xoff + c) = pack_bf16x4(make_float4(xnv[0], xnv[1], xnv[2], xnv[3]));
      } else {
        dx[off + c] = __float2bfloat16(dxv[0]);
        xn_out[xoff + c] = __float2bfloat16(xnv[0]);
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += FIN_NT) {
    float sum = 0.f;
    for (int l = 0; l < n_valid; ++l) sum += zs[l * LDZ + c];
    part[(size_t)blockIdx.x * C + c] = sum;
  }
}

// Dynamic shared memory of the backward's pre launch.
size_t bwd_pre_bytes(int C, int H) {
  return (size_t)TQ * (C + 16) * 2 + (size_t)TQ * (H * DP + 4) * 4;
}

template <class K>
cudaError_t smem_attr(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// Dynamic shared memory of one launch at width C, attention width A and H
// heads: which = 0 QKV, 1 the streaming core, 2 the out-projection, 3-6 the
// backward's pre, dq, dk/dv and final launches.  The resident core's depends
// on L: attention_core_resident_bytes.  ops/cuda/attention_block.py::
// launch_bytes computes the same in Python for the block's gate;
// chip_smoke.py holds the two against each other.
extern "C" long long attention_step_smem_bytes(int C, int A, int H, int which) {
  switch (which) {
    case 0: return (long long)qkv_bytes(C, A);
    case 1: return (long long)CORE_STREAM_BYTES;
    case 2: return (long long)out_bytes(C);
    case 3: return (long long)bwd_pre_bytes(C, H);
    case 4: return (long long)(2 * 2 * TILE);
    case 5: return (long long)DKDV_BYTES;
    case 6: return (long long)bwd_final_bytes(C);
    default: return -1;
  }
}

// The resident core's shared memory at sequence length L, 0 where the
// streaming core takes the call.
extern "C" long long attention_core_resident_bytes(int L) {
  return (long long)core_resident_bytes(L);
}

static DropParams drop_params(unsigned seed, unsigned thr, unsigned row0,
                              float scale, int on) {
  DropParams dp;
  dp.seed = seed;
  dp.thr = thr;
  dp.row0 = row0;
  dp.scale = scale;
  dp.on = on;
  return dp;
}

// x, out [R, L, C] bf16; gamma [C] fp32; wqkv [3A, C] bf16 (torch Linear
// layout); wo [H*32, C] bf16 (out-projection transposed, head dims padded
// to 32 with zero rows); cos/sin [L, D/2] fp32; q/k/v [R, H, Lpad, 32] bf16
// with Lpad a multiple of 64 (kept for the backward in training: q' =
// R(q) scale log2 e); o [R, Lpad, H*32] bf16, the normalised head outputs
// (the backward's stash in training); lse [R, H, Lpad] fp32 (log2 units)
// written when not null (training).  C % 16 == 0, A % 8 == 0, D even and
// <= 32 (the wrapper checks).  Dropout: seed, keep threshold, absolute row
// of x's first row, 1/(1-p), on (0 at p = 0).  residual 0: the partial-sum
// mode (o Wo alone: no out-projection mask, no residual; the probability
// mask stays, it is per head).
extern "C" int attention_step_forward(
    const void* x, const void* gamma, const void* wqkv, const void* wo,
    const void* cosv, const void* sinv, void* q, void* k, void* v, void* out,
    void* o, void* lse, int R, int L, int Lpad, int C, int H, int D,
    int groups, float eps, int rope, unsigned seed, unsigned thr,
    unsigned row0, float scale, int on, int residual, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const DropParams dp = drop_params(seed, thr, row0, scale, on);
  // the out-projection site: not in partial-sum mode
  const DropParams dpo = drop_params(seed, thr, row0, scale, on && residual);
  const int tiles = Lpad / TQ;
  const int dpg = C / groups;
  const size_t qb = qkv_bytes(C, H * D);
  const auto qkv_kernel = C == 32   ? attn_qkv_kernel<32>
                          : C == 64 ? attn_qkv_kernel<64>
                          : C == 96 ? attn_qkv_kernel<96>
                                    : attn_qkv_kernel<128>;
  if (C % 32 != 0 || C > 128) return (int)cudaErrorInvalidValue;
  cudaError_t e = smem_attr(qkv_kernel, qb);
  if (e != cudaSuccess) return (int)e;
  qkv_kernel<<<R * tiles, QKV_NT, qb, st>>>(
      (const bf16*)x, (const float*)gamma, (const bf16*)wqkv, (const float*)cosv,
      (const float*)sinv, (bf16*)q, (bf16*)k, (bf16*)v, L, Lpad, H, D, dpg,
      1.f / sqrtf((float)dpg), eps, LOG2E / sqrtf((float)D), rope, tiles);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const size_t res = core_resident_bytes(L);
  if (res) {
    if ((e = smem_attr(attn_core_res_kernel, res)) != cudaSuccess) return (int)e;
    attn_core_res_kernel<<<R * H, core_warps(L) * 32, res, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse, L, Lpad, H, dp);
  } else {
    if ((e = smem_attr(attn_core_stream_kernel, CORE_STREAM_BYTES)) != cudaSuccess) return (int)e;
    const dim3 grid((unsigned)(R * H), (unsigned)((L + SBQ - 1) / SBQ));
    attn_core_stream_kernel<<<grid, SNT, CORE_STREAM_BYTES, st>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse, L, Lpad, H, dp);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const auto out_kernel = C == 32   ? attn_out_kernel<32>
                          : C == 64 ? attn_out_kernel<64>
                          : C == 96 ? attn_out_kernel<96>
                                    : attn_out_kernel<128>;
  if ((e = smem_attr(out_kernel, out_bytes(C))) != cudaSuccess) return (int)e;
  out_kernel<<<R * tiles, OUT_NT, out_bytes(C), st>>>(
      (const bf16*)x, (const bf16*)o, (const bf16*)wo, (bf16*)out, L, Lpad, H, tiles, dpo,
      residual != 0);
  return (int)cudaGetLastError();
}

// Backward of the attention step from the forward's stash (q', k, v, o,
// lse).  g [R, L, C] bf16 the output's cotangent; dx [R, L, C] bf16 out;
// out_qkv [3A pad 64][C] (rows < 3A: the Wqkv gradient), out_o [H*32 pad
// 64][C] (the out-projection gradient, transposed and head-padded), out_g
// [C] (dgamma) fp32.  Scratch: dproj [R, Lpad, C], dout [R, H, Lpad, 32],
// dqkv [R, Lpad, 3A], xn [R, Lpad, C] bf16; mbits [R*H, Lpad/64, Lpad]
// 64-bit (the probability mask, bit = key; null at p = 0); delta [R, H,
// Lpad], part [R*tiles pad 64][C] (rows past R*tiles zero), pmid
// [(R*tiles)/64 rounded up][C], wpart_q [S1][3A pad][C], wpart_o [S2][H*32
// pad][C] fp32.
extern "C" int attention_step_backward(
    const void* x, const void* g, const void* gamma, const void* wqkv,
    const void* wo, const void* cosv, const void* sinv, const void* q,
    const void* k, const void* v, const void* o, const void* lse,
    void* dx, void* dproj, void* dout, void* delta, void* dqkv, void* mbits, void* xn,
    void* part, void* pmid, void* wpart_q, void* wpart_o, void* out_qkv, void* out_o,
    void* out_g, int R, int L, int Lpad, int C, int H, int D, int groups,
    float eps, int S1, int S2, unsigned seed, unsigned thr, unsigned row0,
    float scale, int on, int residual, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const DropParams dp = drop_params(seed, thr, row0, scale, on);
  const DropParams dpo = drop_params(seed, thr, row0, scale, on && residual);
  const int tiles = Lpad / TQ;
  const int A = H * D, HD = H * DP;
  cudaError_t e;
  const size_t pre_smem = bwd_pre_bytes(C, H);
  if ((e = smem_attr(attn_bwd_pre_kernel, pre_smem)) != cudaSuccess) return (int)e;
  attn_bwd_pre_kernel<<<R * tiles, BW_NT, pre_smem, st>>>(
      (const bf16*)g, (const bf16*)wo, (const bf16*)o, (bf16*)dproj,
      (bf16*)dout, (float*)delta, L, Lpad, C, H, tiles, dpo);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  const dim3 grid((unsigned)(R * H), (unsigned)((L + SBQ - 1) / SBQ));
  const float qscale = 1.f / sqrtf((float)D);
#define ATTN_BWD(DROP)                                                                      \
  do {                                                                                      \
    if ((e = smem_attr(attn_bwd_dq_reg_kernel<DROP>, 2 * 2 * TILE)) != cudaSuccess)         \
      return (int)e;                                                                        \
    attn_bwd_dq_reg_kernel<DROP><<<grid, SNT, 2 * 2 * TILE, st>>>(                          \
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,                  \
        (const float*)lse, (const float*)delta, (const float*)cosv, (const float*)sinv,     \
        (bf16*)dqkv, (uint64_t*)mbits, L, Lpad, H, D, qscale, dp);                          \
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;                             \
    if ((e = smem_attr(attn_bwd_dkdv_reg_kernel<DROP>, DKDV_BYTES)) != cudaSuccess)         \
      return (int)e;                                                                        \
    attn_bwd_dkdv_reg_kernel<DROP><<<grid, SNT, DKDV_BYTES, st>>>(                          \
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,                  \
        (const float*)lse, (const float*)delta, (const float*)cosv, (const float*)sinv,     \
        (bf16*)dqkv, (const uint64_t*)mbits, L, Lpad, H, D, dp);                            \
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;                             \
  } while (0)
  if (on)
    ATTN_BWD(true);
  else
    ATTN_BWD(false);
#undef ATTN_BWD

  const size_t fin_smem = bwd_final_bytes(C);
  const int dpg = C / groups;
#define FIN_K(CC) (dpg % 4 == 0 ? attn_bwd_final_kernel<CC, 4> : attn_bwd_final_kernel<CC, 1>)
  const auto final_kernel = C == 32 ? FIN_K(32) : C == 64 ? FIN_K(64) : C == 96 ? FIN_K(96)
                                                                              : FIN_K(128);
#undef FIN_K
  if ((e = smem_attr(final_kernel, fin_smem)) != cudaSuccess) return (int)e;
  final_kernel<<<R * tiles, FIN_NT, fin_smem, st>>>(
      (const bf16*)x, (const bf16*)g, (const float*)gamma, (const bf16*)wqkv,
      (const bf16*)dqkv, (bf16*)dx, (bf16*)xn, (float*)part, L, Lpad, A, dpg,
      1.f / sqrtf((float)dpg), eps, tiles, residual != 0);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  // dWqkv [3A, C] = sum dqkv^T xn; dWo^T [H*32, C] = sum o^T dproj
  if ((e = wg::launch_wgrad((const bf16*)dqkv, L, Lpad, 3 * A, (const bf16*)xn, L,
                            Lpad, C, 0, 1, R, S1, (float*)wpart_q, nullptr, st)) !=
      cudaSuccess)
    return (int)e;
  if ((e = wg::launch_wgrad((const bf16*)o, L, Lpad, HD, (const bf16*)dproj, L,
                            Lpad, C, 0, 1, R, S2, (float*)wpart_o, nullptr, st)) !=
      cudaSuccess)
    return (int)e;
  const long long mq = (long long)wg::mtiles(3 * A) * wg::BM;
  const long long mo = (long long)wg::mtiles(HD) * wg::BM;
  if ((e = wg::launch_reduce((float*)wpart_q, (float*)out_qkv, 1, S1, mq * C, st)) !=
      cudaSuccess)
    return (int)e;
  if ((e = wg::launch_reduce((float*)wpart_o, (float*)out_o, 1, S2, mo * C, st)) !=
      cudaSuccess)
    return (int)e;
  // the blocks' dgamma partials in segments of 64 (the wrapper zeroes the
  // rows past the last block's), then the segments: each sum in a fixed order
  const int segs = (R * tiles + 63) / 64;
  if ((e = wg::launch_reduce((float*)part, (float*)pmid, segs, 64, C, st)) != cudaSuccess)
    return (int)e;
  return (int)wg::launch_reduce((float*)pmid, (float*)out_g, 1, segs, C, st);
}
