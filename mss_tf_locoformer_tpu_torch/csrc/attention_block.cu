// Fused attention step:  out = x + OutProj(softmax(RoPE(q) RoPE(k)^T / sqrt(D)) v)
// with q, k, v = QKV(RMSGroupNorm(x)).
//
// Replaces the JAX package's Pallas kernels
// ``ops/pallas/attention_block.py::_attn_forward`` (body ``_attn_kernel``)
// and ``::_attn_backward_pallas`` (body ``_attn_bwd_kernel``), public
// ``fused_attention_block``, with both reference dropout sites: on the
// attention probabilities (drop after normalising: the softmax denominator
// is the undropped sum) and on the out-projection (masks from
// ``philox.cuh``, survivors scaled by 1/(1-p)).
//
// Shapes: x [R, L, C] bf16 rows, attention over L within each row, H heads
// of width D = A / H (base config: C = A = 96, H 4, D 24; L 1025 on the
// frequency path, T frames on the time path).
//
// What bounds it on the H100: the two score-class products, 4*H*L^2*D FLOP
// per row (0.74 TFLOP per call on the base freq path with D padded to 32),
// and the softmax between them; the [H, L, L] scores must never reach device
// memory (at the freq path they would be ~23 GB in fp32).  Two launches:
//   1. ``attn_qkv_kernel``: one block per (row, 64 positions): fp32
//      RMSGroupNorm to bf16, the QKV product on wmma tensor cores, q/k/v
//      rounded to bf16, RoPE in fp32 on q and k (interleaved pairs), the
//      1/sqrt(D) scale folded into q, written to device memory as
//      [R, H, Lpad, 32] bf16 (head_dim 24 zero-padded to 32 for the MMA
//      depth; positions >= L written as zeros).
//   2. ``attn_core_kernel``: one block per (row, 64 queries), one warp per
//      16 queries, heads in turn: flash loop over 64-key tiles (K/V tiles in
//      shared memory, S = Q K^T and O += P V on wmma, online softmax with the
//      running max and sum in fp32, keys >= L masked to -inf), then each
//      warp's normalised O for all heads feeds the out-projection
//      [16, H*32] x [H*32, C] on wmma, the residual is added in fp32 and
//      rounded once, and queries >= L are never stored.
// Writing q/k/v to device memory costs 3 x R x H x Lpad x 64 bytes per call;
// keeping them on chip (and wgmma/TMA) is later work.  In training the
// forward also keeps, for the backward, q/k/v themselves (post-RoPE, q
// scaled), the normalised head outputs o [R, Lpad, H*32] bf16 (the
// out-projection's input) and the per-query log-sum-exp [R, H, Lpad] fp32.
//
// Backward: the FlashAttention-2 backward with dropout around the fused
// step, in launches that each own their outputs (no atomics):
//   3. ``attn_bwd_pre_kernel`` per (row, 64 positions): dproj = g * mask,
//      do = dproj Wo^T per head, D = rowsum(do * o);
//   4. ``attn_bwd_dq_kernel`` per (row, 64 queries): P recomputed from q, k
//      and the log-sum-exp, the probability mask replayed,
//      dS = P * (mask * (do v^T) / (1-p) - D), dq = dS k / sqrt(D_head)
//      looped over key tiles, rotated back by RoPE^-1;
//   5. ``attn_bwd_dkdv_kernel`` per (row, 64 keys): the same recompute looped
//      over query tiles, dv = (mask * P / (1-p))^T do, dk = dS^T q,
//      rotated back; dq, dk, dv written as dqkv [R, Lpad, 3A] bf16;
//   6. ``attn_bwd_final_kernel`` per (row, 64 positions): dxn = dqkv Wqkv,
//      the norm's backward, the residual; xn written for the weights;
//   7. the weight gradients dWqkv = dqkv^T xn and dWo = o^T dproj as
//      deterministic split-K products (``wgrad.cuh``), dgamma from
//      per-block partials reduced in order.
// Bound: five score-class products (S twice, dP twice, dq/dk/dv) of
// 2*L^2*D_head FLOP each per (row, head) -- compute-bound.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>

#include "philox.cuh"
#include "rmsgroupnorm.cuh"
#include "wgrad.cuh"

using namespace nvcuda;

namespace {

constexpr int DP = 32;  // padded head dim
constexpr int TQ = 64;  // positions per tile (queries, keys, QKV rows)

// ---------------------------------------------------------------- launch 1

constexpr int QKV_NT = 256;

struct QkvLay {
  int LDX, LDW, LDY;
  size_t xs, ws, ys;
  __host__ __device__ QkvLay(int C, int A)
      : LDX(C + 16), LDW(C + 8), LDY(A + 4),
        xs((size_t)TQ * (C + 16) * 2), ws((size_t)A * (C + 8) * 2),
        ys((size_t)TQ * (A + 4) * 4) {}
  __host__ __device__ size_t bytes() const { return xs + ws + ys; }
};

__global__ void __launch_bounds__(QKV_NT) attn_qkv_kernel(
    const bf16* __restrict__ x, const float* __restrict__ gamma,
    const bf16* __restrict__ wqkv, const float* __restrict__ cosv,
    const float* __restrict__ sinv, bf16* __restrict__ q,
    bf16* __restrict__ k, bf16* __restrict__ v, int L, int Lpad, int C,
    int H, int D, int dpg, float rdpg, float eps, float scale, int rope,
    int tiles) {
  const int A = H * D;
  const QkvLay S(C, A);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = (bf16*)smem;
  bf16* ws = (bf16*)(smem + S.xs);
  float* ys = (float*)(smem + S.xs + S.ws);

  const int row = blockIdx.x / tiles;
  const int l0 = (blockIdx.x % tiles) * TQ;
  const int warp = threadIdx.x / 32;
  const bf16* xr = x + (size_t)row * L * C;
  rmsgroupnorm_rows(xr, L, l0, TQ, gamma, C, dpg, rdpg, eps, xs, S.LDX);

  const int half = D / 2;
  for (int part = 0; part < 3; ++part) {
    __syncthreads();  // xs ready; previous part done with ws / ys
    const bf16* wg = wqkv + (size_t)part * A * C;
    const int vr = C / 8;
    for (int i = threadIdx.x; i < A * vr; i += QKV_NT) {
      const int r = i / vr, c8 = i % vr;
      *(uint4*)(ws + r * S.LDW + c8 * 8) = *(const uint4*)(wg + (size_t)r * C + c8 * 8);
    }
    __syncthreads();
    // y [64, A] = xn [64, C] x W_part^T; W rows are outputs: a col-major B
    const int mi = warp % 4;
    for (int nj = warp / 4; nj < A / 16; nj += QKV_NT / 128) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kc = 0; kc < C / 16; ++kc) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, xs + mi * 16 * S.LDX + kc * 16, S.LDX);
        wmma::load_matrix_sync(b, ws + nj * 16 * S.LDW + kc * 16, S.LDW);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(ys + mi * 16 * S.LDY + nj * 16, acc, S.LDY,
                              wmma::mem_row_major);
    }
    __syncthreads();
    bf16* dst = part == 0 ? q : (part == 1 ? k : v);
    const bool rot = rope && part < 2;
    const float sc = part == 0 ? scale : 1.f;
    for (int i = threadIdx.x; i < TQ * H * (DP / 2); i += QKV_NT) {
      const int l = i / (H * (DP / 2));
      const int h = (i / (DP / 2)) % H;
      const int j = i % (DP / 2);  // pair index
      const int pos = l0 + l;
      float r0 = 0.f, r1 = 0.f;
      if (pos < L && j < half) {
        // projections rounded to bf16 first, as the JAX kernel does
        const float v0 = __bfloat162float(__float2bfloat16(ys[l * S.LDY + h * D + 2 * j]));
        const float v1 = __bfloat162float(__float2bfloat16(ys[l * S.LDY + h * D + 2 * j + 1]));
        r0 = v0;
        r1 = v1;
        if (rot) {
          const float c = cosv[(size_t)pos * half + j], s = sinv[(size_t)pos * half + j];
          r0 = v0 * c - v1 * s;
          r1 = v1 * c + v0 * s;
        }
        r0 *= sc;
        r1 *= sc;
      }
      *(__nv_bfloat162*)(dst + (((size_t)row * H + h) * Lpad + pos) * DP + 2 * j) =
          __floats2bfloat162_rn(r0, r1);
    }
  }
}

// ---------------------------------------------------------------- launch 2

constexpr int CORE_NW = 4;  // warps per block, 16 queries each
constexpr int CORE_NT = CORE_NW * 32;
constexpr int LDK = DP + 8;    // K / V tiles, bf16
constexpr int LDS = TQ + 4;    // scores, fp32
constexpr int LDP = TQ + 16;   // probabilities, bf16 (wmma A operand)
constexpr int LDO = DP + 4;    // O and P V, fp32

struct CoreLay {
  int LDOA, LDZ;
  size_t kv, warp, oall;
  __host__ __device__ CoreLay(int C, int H)
      : LDOA(H * DP + 16), LDZ(C + 4), kv((size_t)TQ * LDK * 2),
        warp(0), oall((size_t)TQ * (H * DP + 16) * 2) {
    const size_t work = (size_t)16 * LDS * 4 + (size_t)16 * LDP * 2 +
                        2 * (size_t)16 * LDO * 4;
    const size_t stage = (size_t)16 * (C + 4) * 4;  // out-projection staging
    warp = work > stage ? work : stage;
    warp = (warp + 127) / 128 * 128;
  }
  __host__ __device__ size_t bytes() const { return 2 * kv + CORE_NW * warp + oall; }
};

__global__ void __launch_bounds__(CORE_NT) attn_core_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ q,
    const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ wo, bf16* __restrict__ out, int L, int Lpad,
    int C, int H, int tiles, DropParams dp, bf16* __restrict__ o_stash,
    float* __restrict__ lse) {
  const CoreLay S(C, H);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = (bf16*)smem;
  bf16* vs = (bf16*)(smem + S.kv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned char* wbase = smem + 2 * S.kv + warp * S.warp;
  float* sw = (float*)wbase;                              // [16, LDS]
  bf16* pw = (bf16*)(wbase + 16 * LDS * 4);               // [16, LDP]
  float* ow = (float*)(wbase + 16 * LDS * 4 + 16 * LDP * 2);  // [16, LDO]
  float* tw = ow + 16 * LDO;                              // [16, LDO]
  bf16* oall = (bf16*)(smem + 2 * S.kv + CORE_NW * S.warp);   // [64, LDOA]

  const int row = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * TQ;
  const int n_kv = (L + TQ - 1) / TQ;
  const int r = lane >> 1, half = lane & 1;  // softmax: 2 lanes per query row
  const int qpos = q0 + warp * 16 + r;       // this lane's query

  for (int h = 0; h < H; ++h) {
    const size_t head = ((size_t)row * H + h) * Lpad;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[DP / 16];
#pragma unroll
    for (int kd = 0; kd < DP / 16; ++kd)
      wmma::load_matrix_sync(qf[kd], q + (head + q0 + warp * 16) * DP + kd * 16, DP);
    for (int i = lane; i < 16 * LDO; i += 32) ow[i] = 0.f;
    float m_run = -CUDART_INF_F, l_run = 0.f;

    for (int t = 0; t < n_kv; ++t) {
      const int j0 = t * TQ;
      __syncthreads();  // every warp done with the previous K/V tile
      for (int i = threadIdx.x; i < TQ * (DP / 8); i += CORE_NT) {
        const int kr = i / (DP / 8), c8 = i % (DP / 8);
        const size_t g = (head + j0 + kr) * DP + c8 * 8;
        *(uint4*)(ks + kr * LDK + c8 * 8) = *(const uint4*)(k + g);
        *(uint4*)(vs + kr * LDK + c8 * 8) = *(const uint4*)(v + g);
      }
      __syncthreads();

      // S [16, 64] = Q [16, 32] x K^T; K rows are keys: a col-major B
#pragma unroll
      for (int nf = 0; nf < TQ / 16; ++nf) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
        wmma::fill_fragment(s, 0.f);
#pragma unroll
        for (int kd = 0; kd < DP / 16; ++kd) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
          wmma::load_matrix_sync(kb, ks + nf * 16 * LDK + kd * 16, LDK);
          wmma::mma_sync(s, qf[kd], kb, s);
        }
        wmma::store_matrix_sync(sw + nf * 16, s, LDS, wmma::mem_row_major);
      }
      __syncwarp();

      // online softmax, fp32; lanes 2r and 2r+1 share query row r
      float mx = -CUDART_INF_F;
      for (int c = half * 32; c < half * 32 + 32; ++c)
        if (j0 + c < L) mx = fmaxf(mx, sw[r * LDS + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m_run, mx);  // finite: key j0 < L is live
      const float alpha = __expf(m_run - m_new);
      // the undropped p sums into the denominator; dropped p feed P V
      float sum = 0.f;
      for (int c = half * 32; c < half * 32 + 32; c += 4) {
        Philox4 w;
        if (dp.on) w = dropout_words(dp.seed, SITE_ATTN_PROB, dp.row0 + row, h, (j0 + c) >> 2, qpos);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = (j0 + c + e < L) ? __expf(sw[r * LDS + c + e] - m_new) : 0.f;
          sum += p;
          pw[r * LDP + c + e] = __float2bfloat16(dp.on && w.w[e] >= dp.thr ? 0.f : p);
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      l_run = l_run * alpha + sum;
      m_run = m_new;
      __syncwarp();

      // P V [16, 32]
#pragma unroll
      for (int df = 0; df < DP / 16; ++df) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
        wmma::fill_fragment(o, 0.f);
#pragma unroll
        for (int kk = 0; kk < TQ / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
          wmma::load_matrix_sync(pa, pw + kk * 16, LDP);
          wmma::load_matrix_sync(vb, vs + kk * 16 * LDK + df * 16, LDK);
          wmma::mma_sync(o, pa, vb, o);
        }
        wmma::store_matrix_sync(tw + df * 16, o, LDO, wmma::mem_row_major);
      }
      __syncwarp();
      for (int c = half * 16; c < half * 16 + 16; ++c)
        ow[r * LDO + c] = ow[r * LDO + c] * alpha + tw[r * LDO + c];
      __syncwarp();
    }

    // this head's normalised output into the warp's rows of O_all
    if (lse != nullptr && half == 0) lse[((size_t)row * H + h) * Lpad + qpos] = m_run + logf(l_run);
    const float inv = (dp.on ? dp.scale : 1.f) / l_run;
    for (int c = half * 16; c < half * 16 + 16; ++c)
      oall[(warp * 16 + r) * S.LDOA + h * DP + c] = __float2bfloat16(ow[r * LDO + c] * inv);
    __syncwarp();
  }

  // out-projection of the warp's 16 queries: [16, H*32] x Wo [H*32, C]
  float* zw = (float*)wbase;  // the warp's work area is free now
  for (int nj = 0; nj < C / 16; ++nj) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> z;
    wmma::fill_fragment(z, 0.f);
    for (int kk = 0; kk < H * DP / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, oall + warp * 16 * S.LDOA + kk * 16, S.LDOA);
      wmma::load_matrix_sync(b, wo + (size_t)kk * 16 * C + nj * 16, C);
      wmma::mma_sync(z, a, b, z);
    }
    wmma::store_matrix_sync(zw + nj * 16, z, S.LDZ, wmma::mem_row_major);
  }
  __syncwarp();
  if (o_stash != nullptr) {
    const int HD = H * DP;
    for (int i = lane; i < 16 * HD / 8; i += 32) {
      const int l = i / (HD / 8), v = i % (HD / 8);
      *(uint4*)(o_stash + ((size_t)row * Lpad + q0 + warp * 16 + l) * HD + v * 8) =
          *(const uint4*)(oall + (warp * 16 + l) * S.LDOA + v * 8);
    }
  }
  // residual + out-projection dropout (position, channel); 4 channels per draw
  const bf16* xr = x + (size_t)row * L * C;
  bf16* outr = out + (size_t)row * L * C;
  for (int i = lane; i < 16 * C / 4; i += 32) {
    const int l = i / (C / 4), c0 = (i % (C / 4)) * 4;
    const int pos = q0 + warp * 16 + l;
    if (pos >= L) break;
    Philox4 w;
    if (dp.on) w = dropout_words(dp.seed, SITE_ATTN_PROJ, dp.row0 + row, pos, c0 >> 2, 0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const size_t off = (size_t)pos * C + c0 + e;
      float z = zw[l * S.LDZ + c0 + e];
      if (dp.on) z = w.w[e] < dp.thr ? z * dp.scale : 0.f;
      outr[off] = __float2bfloat16(__bfloat162float(xr[off]) + z);
    }
  }
}

// ---------------------------------------------------------------- backward

constexpr int BW_NW = 4;  // warps per block in launches 3-5, 16 rows each
constexpr int BW_NT = BW_NW * 32;

// 3. dproj = g * mask / (1-p) (rows >= L zero), do = dproj Wo^T [R,H,Lpad,32],
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

  for (int i = threadIdx.x; i < TQ * C / 4; i += BW_NT) {
    const int l = i / (C / 4), c0 = (i % (C / 4)) * 4;
    const int pos = q0 + l;
    Philox4 w;
    if (pos < L && dp.on) w = dropout_words(dp.seed, SITE_ATTN_PROJ, dp.row0 + row, pos, c0 >> 2, 0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = 0.f;
      if (pos < L) {
        v = __bfloat162float(g[((size_t)row * L + pos) * C + c0 + e]);
        if (dp.on) v = w.w[e] < dp.thr ? v * dp.scale : 0.f;
      }
      const bf16 b = __float2bfloat16(v);
      ps[l * LDC + c0 + e] = b;
      dproj[((size_t)row * Lpad + pos) * C + c0 + e] = b;
    }
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
  // lane pairs: query row r = lane / 2, heads h = lane % 2, +2, ...
  const int r = lane >> 1;
  const int pos = q0 + warp * 16 + r;
  for (int h = lane & 1; h < H; h += 2) {
    float d = 0.f;
    const size_t orow = ((size_t)row * Lpad + pos) * HD + h * DP;
    bf16* dst = dout + (((size_t)row * H + h) * Lpad + pos) * DP;
    for (int j = 0; j < DP; ++j) {
      const bf16 b = __float2bfloat16(ts[(warp * 16 + r) * LDT + h * DP + j]);
      dst[j] = b;
      d += __bfloat162float(b) * __bfloat162float(o_stash[orow + j]);
    }
    Dsum[((size_t)row * H + h) * Lpad + pos] = d;
  }
}

// Per-warp work areas of launches 4 and 5.
constexpr int BW_WARP_BYTES =
    2 * 16 * LDS * 4 + 2 * 16 * LDP * 2 + 16 * LDO * 4;

__device__ __forceinline__ void rope_back_store(
    const float* tw, int r, int half, int pos, int L, float scale, int D,
    const float* __restrict__ cosv, const float* __restrict__ sinv,
    bf16* __restrict__ dst) {
  // lanes 2r and 2r+1 share row r: pairs half*8 .. half*8+7
  if (pos >= L) return;
  for (int jp = half * 8; jp < half * 8 + 8; ++jp) {
    if (jp >= D / 2) break;
    const float d0 = tw[r * LDO + 2 * jp] * scale, d1 = tw[r * LDO + 2 * jp + 1] * scale;
    const float c = cosv[(size_t)pos * (D / 2) + jp], s = sinv[(size_t)pos * (D / 2) + jp];
    dst[2 * jp] = __float2bfloat16(d0 * c + d1 * s);
    dst[2 * jp + 1] = __float2bfloat16(d1 * c - d0 * s);
  }
}

// 4. dq per (row, 64 queries), looped over key tiles, heads in turn.
__global__ void __launch_bounds__(BW_NT) attn_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ Dsum,
    const float* __restrict__ cosv, const float* __restrict__ sinv,
    bf16* __restrict__ dqkv, int L, int Lpad, int H, int D, float qscale,
    int tiles, DropParams dp) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = (bf16*)smem;
  bf16* vs = ks + TQ * LDK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned char* wb = smem + 2 * TQ * LDK * 2 + warp * BW_WARP_BYTES;
  float* sw = (float*)wb;                  // S [16, LDS]
  float* dpw = sw + 16 * LDS;              // dP [16, LDS]
  bf16* dsw = (bf16*)(dpw + 16 * LDS);     // dS [16, LDP]
  float* tw = (float*)(dsw + 2 * 16 * LDP);  // dq [16, LDO]
  const int row = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * TQ;
  const int n_kv = (L + TQ - 1) / TQ;
  const int r = lane >> 1, half = lane & 1;
  const int qpos = q0 + warp * 16 + r;
  const int A = H * D;

  for (int h = 0; h < H; ++h) {
    const size_t head = ((size_t)row * H + h) * Lpad;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[DP / 16], df[DP / 16];
#pragma unroll
    for (int kd = 0; kd < DP / 16; ++kd) {
      wmma::load_matrix_sync(qf[kd], q + (head + q0 + warp * 16) * DP + kd * 16, DP);
      wmma::load_matrix_sync(df[kd], dout + (head + q0 + warp * 16) * DP + kd * 16, DP);
    }
    const float lse_r = lse[head + qpos], d_r = Dsum[head + qpos];
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[DP / 16];
#pragma unroll
    for (int df_ = 0; df_ < DP / 16; ++df_) wmma::fill_fragment(acc[df_], 0.f);

    for (int t = 0; t < n_kv; ++t) {
      const int j0 = t * TQ;
      __syncthreads();
      for (int i = threadIdx.x; i < TQ * (DP / 8); i += BW_NT) {
        const int kr = i / (DP / 8), c8 = i % (DP / 8);
        const size_t gi = (head + j0 + kr) * DP + c8 * 8;
        *(uint4*)(ks + kr * LDK + c8 * 8) = *(const uint4*)(k + gi);
        *(uint4*)(vs + kr * LDK + c8 * 8) = *(const uint4*)(v + gi);
      }
      __syncthreads();
#pragma unroll
      for (int nf = 0; nf < TQ / 16; ++nf) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> s, dpf;
        wmma::fill_fragment(s, 0.f);
        wmma::fill_fragment(dpf, 0.f);
#pragma unroll
        for (int kd = 0; kd < DP / 16; ++kd) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb, vb;
          wmma::load_matrix_sync(kb, ks + nf * 16 * LDK + kd * 16, LDK);
          wmma::load_matrix_sync(vb, vs + nf * 16 * LDK + kd * 16, LDK);
          wmma::mma_sync(s, qf[kd], kb, s);
          wmma::mma_sync(dpf, df[kd], vb, dpf);
        }
        wmma::store_matrix_sync(sw + nf * 16, s, LDS, wmma::mem_row_major);
        wmma::store_matrix_sync(dpw + nf * 16, dpf, LDS, wmma::mem_row_major);
      }
      __syncwarp();
      for (int c = half * 32; c < half * 32 + 32; c += 4) {
        Philox4 w;
        if (dp.on) w = dropout_words(dp.seed, SITE_ATTN_PROB, dp.row0 + row, h, (j0 + c) >> 2, qpos);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float ds = 0.f;
          if (j0 + c + e < L && qpos < L) {
            const float p = __expf(sw[r * LDS + c + e] - lse_r);
            float dpv = dpw[r * LDS + c + e];
            if (dp.on) dpv = w.w[e] < dp.thr ? dpv * dp.scale : 0.f;
            ds = p * (dpv - d_r);
          }
          dsw[r * LDP + c + e] = __float2bfloat16(ds);
        }
      }
      __syncwarp();
#pragma unroll
      for (int df_ = 0; df_ < DP / 16; ++df_) {
#pragma unroll
        for (int kk = 0; kk < TQ / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(a, dsw + kk * 16, LDP);
          wmma::load_matrix_sync(b, ks + kk * 16 * LDK + df_ * 16, LDK);
          wmma::mma_sync(acc[df_], a, b, acc[df_]);
        }
      }
    }
#pragma unroll
    for (int df_ = 0; df_ < DP / 16; ++df_)
      wmma::store_matrix_sync(tw + df_ * 16, acc[df_], LDO, wmma::mem_row_major);
    __syncwarp();
    rope_back_store(tw, r, half, qpos, L, qscale, D, cosv, sinv,
                    dqkv + ((size_t)row * Lpad + qpos) * 3 * A + h * D);
    __syncwarp();
  }
}

// 5. dk, dv per (row, 64 keys), looped over query tiles, heads in turn.
//    Lane l holds keys 4*(l%4) .. +3 and queries 8*(l/4) .. +7 of the warp's
//    [16 keys, 64 queries] tile: one Philox draw per (query, 4 keys).
__global__ void __launch_bounds__(BW_NT) attn_bwd_dkdv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ Dsum,
    const float* __restrict__ cosv, const float* __restrict__ sinv,
    bf16* __restrict__ dqkv, int L, int Lpad, int H, int D, int tiles,
    DropParams dp) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = (bf16*)smem;
  bf16* dos = qs + TQ * LDK;
  float* lse_s = (float*)(dos + TQ * LDK);
  float* d_s = lse_s + TQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  unsigned char* wb = (unsigned char*)(d_s + TQ) + warp * BW_WARP_BYTES;
  float* sw = (float*)wb;                  // S^T [16 keys, LDS]
  float* dpw = sw + 16 * LDS;              // dP^T
  bf16* pdw = (bf16*)(dpw + 16 * LDS);     // dropped P^T, bf16 [16, LDP]
  bf16* dsw = pdw + 16 * LDP;              // dS^T, bf16 [16, LDP]
  float* tw = (float*)(dsw + 16 * LDP);    // dk / dv staging [16, LDO]
  const int row = blockIdx.x / tiles;
  const int k0 = (blockIdx.x % tiles) * TQ + warp * 16;
  const int n_q = (L + TQ - 1) / TQ;
  const int kg = lane & 3, qb = lane >> 2;
  const int A = H * D;

  for (int h = 0; h < H; ++h) {
    const size_t head = ((size_t)row * H + h) * Lpad;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> kf[DP / 16], vf[DP / 16];
#pragma unroll
    for (int kd = 0; kd < DP / 16; ++kd) {
      wmma::load_matrix_sync(kf[kd], k + (head + k0) * DP + kd * 16, DP);
      wmma::load_matrix_sync(vf[kd], v + (head + k0) * DP + kd * 16, DP);
    }
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk[DP / 16], dv[DP / 16];
#pragma unroll
    for (int d = 0; d < DP / 16; ++d) {
      wmma::fill_fragment(dk[d], 0.f);
      wmma::fill_fragment(dv[d], 0.f);
    }
    for (int t = 0; t < n_q; ++t) {
      const int i0 = t * TQ;
      __syncthreads();
      for (int i = threadIdx.x; i < TQ * (DP / 8); i += BW_NT) {
        const int qr = i / (DP / 8), c8 = i % (DP / 8);
        const size_t gi = (head + i0 + qr) * DP + c8 * 8;
        *(uint4*)(qs + qr * LDK + c8 * 8) = *(const uint4*)(q + gi);
        *(uint4*)(dos + qr * LDK + c8 * 8) = *(const uint4*)(dout + gi);
      }
      for (int i = threadIdx.x; i < TQ; i += BW_NT) {
        lse_s[i] = lse[head + i0 + i];
        d_s[i] = Dsum[head + i0 + i];
      }
      __syncthreads();
#pragma unroll
      for (int nf = 0; nf < TQ / 16; ++nf) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> s, dpf;
        wmma::fill_fragment(s, 0.f);
        wmma::fill_fragment(dpf, 0.f);
#pragma unroll
        for (int kd = 0; kd < DP / 16; ++kd) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> qb_, db;
          wmma::load_matrix_sync(qb_, qs + nf * 16 * LDK + kd * 16, LDK);
          wmma::load_matrix_sync(db, dos + nf * 16 * LDK + kd * 16, LDK);
          wmma::mma_sync(s, kf[kd], qb_, s);
          wmma::mma_sync(dpf, vf[kd], db, dpf);
        }
        wmma::store_matrix_sync(sw + nf * 16, s, LDS, wmma::mem_row_major);
        wmma::store_matrix_sync(dpw + nf * 16, dpf, LDS, wmma::mem_row_major);
      }
      __syncwarp();
      for (int qq = 0; qq < 8; ++qq) {
        const int ql = qb * 8 + qq, qpos = i0 + ql;
        Philox4 w;
        if (dp.on) w = dropout_words(dp.seed, SITE_ATTN_PROB, dp.row0 + row, h, (k0 + 4 * kg) >> 2, qpos);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kr = 4 * kg + e;
          float pd = 0.f, ds = 0.f;
          if (k0 + kr < L && qpos < L) {
            const float p = __expf(sw[kr * LDS + ql] - lse_s[ql]);
            float dpv = dpw[kr * LDS + ql];
            pd = p;
            if (dp.on) {
              const float m = w.w[e] < dp.thr ? dp.scale : 0.f;
              dpv *= m;
              pd *= m;
            }
            ds = p * (dpv - d_s[ql]);
          }
          pdw[kr * LDP + ql] = __float2bfloat16(pd);
          dsw[kr * LDP + ql] = __float2bfloat16(ds);
        }
      }
      __syncwarp();
#pragma unroll
      for (int d = 0; d < DP / 16; ++d) {
#pragma unroll
        for (int kk = 0; kk < TQ / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ap, as;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bdo, bq;
          wmma::load_matrix_sync(ap, pdw + kk * 16, LDP);
          wmma::load_matrix_sync(as, dsw + kk * 16, LDP);
          wmma::load_matrix_sync(bdo, dos + kk * 16 * LDK + d * 16, LDK);
          wmma::load_matrix_sync(bq, qs + kk * 16 * LDK + d * 16, LDK);
          wmma::mma_sync(dv[d], ap, bdo, dv[d]);
          wmma::mma_sync(dk[d], as, bq, dk[d]);
        }
      }
    }
    const int r = lane >> 1, half = lane & 1;
    const int kpos = k0 + r;
    bf16* base = dqkv + ((size_t)row * Lpad + kpos) * 3 * A + h * D;
#pragma unroll
    for (int d = 0; d < DP / 16; ++d)
      wmma::store_matrix_sync(tw + d * 16, dk[d], LDO, wmma::mem_row_major);
    __syncwarp();
    rope_back_store(tw, r, half, kpos, L, 1.f, D, cosv, sinv, base + A);
    __syncwarp();
#pragma unroll
    for (int d = 0; d < DP / 16; ++d)
      wmma::store_matrix_sync(tw + d * 16, dv[d], LDO, wmma::mem_row_major);
    __syncwarp();
    if (kpos < L)
      for (int j = half * 16; j < half * 16 + 16 && j < D; ++j)
        base[2 * A + j] = __float2bfloat16(tw[r * LDO + j]);
    __syncwarp();
  }
}

// 6. dxn = dqkv [64, 3A] x Wqkv [3A, C], norm backward, residual, xn out,
//    per-block dgamma partial.
constexpr int FIN_NT = 256;

__global__ void __launch_bounds__(FIN_NT) attn_bwd_final_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ g,
    const float* __restrict__ gamma, const bf16* __restrict__ wqkv,
    const bf16* __restrict__ dqkv, bf16* __restrict__ dx,
    bf16* __restrict__ xn_out, float* __restrict__ part, int L, int Lpad,
    int C, int A, int dpg, float rdpg, float eps, int tiles) {
  const int A3 = 3 * A, LDW = C + 8, LDQ = A3 + 16, LDZ = C + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ws = (bf16*)smem;                                        // [3A, LDW]
  bf16* qs = ws + (size_t)A3 * LDW;                              // [64, LDQ]
  float* zs = (float*)(qs + (size_t)TQ * LDQ);                   // [64, LDZ]
  const int row = blockIdx.x / tiles;
  const int q0 = (blockIdx.x % tiles) * TQ;
  const int warp = threadIdx.x / 32;

  for (int i = threadIdx.x; i < A3 * (C / 8); i += FIN_NT) {
    const int rr = i / (C / 8), c8 = i % (C / 8);
    *(uint4*)(ws + rr * LDW + c8 * 8) = *(const uint4*)(wqkv + (size_t)rr * C + c8 * 8);
  }
  for (int i = threadIdx.x; i < TQ * (A3 / 8); i += FIN_NT) {
    const int l = i / (A3 / 8), c8 = i % (A3 / 8);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + l < L) val = *(const uint4*)(dqkv + ((size_t)row * Lpad + q0 + l) * A3 + c8 * 8);
    *(uint4*)(qs + l * LDQ + c8 * 8) = val;
  }
  __syncthreads();
  const int zm = warp % 4;
  for (int nj = warp / 4; nj < C / 16; nj += FIN_NT / 128) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int ka = 0; ka < A3 / 16; ++ka) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, qs + zm * 16 * LDQ + ka * 16, LDQ);
      wmma::load_matrix_sync(b, ws + ka * 16 * LDW + nj * 16, LDW);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(zs + zm * 16 * LDZ + nj * 16, acc, LDZ, wmma::mem_row_major);
  }
  __syncthreads();
  const int n_valid = min(TQ, L - q0);
  const int groups = C / dpg;
  const size_t xrow = (size_t)row * L;
  for (int item = threadIdx.x; item < n_valid * groups; item += FIN_NT) {
    const int l = item / groups, gi = item % groups;
    const size_t off = (xrow + q0 + l) * C + gi * dpg;
    float ss = 0.f, tsum = 0.f;
    for (int c = 0; c < dpg; ++c) {
      const float xv = __bfloat162float(x[off + c]);
      ss += xv * xv;
      tsum += gamma[gi * dpg + c] * zs[l * LDZ + gi * dpg + c] * xv;
    }
    const float rr = sqrtf(ss) * rdpg;
    const float inv = 1.f / (rr + eps);
    const float k2 = rr > 0.f ? tsum * inv * inv / (dpg * rr) : 0.f;
    for (int c = 0; c < dpg; ++c) {
      const int cc = gi * dpg + c;
      const float xv = __bfloat162float(x[off + c]);
      const float dxn = zs[l * LDZ + cc];
      dx[off + c] = __float2bfloat16(gamma[cc] * dxn * inv - xv * k2 +
                                     __bfloat162float(g[off + c]));
      xn_out[((size_t)row * Lpad + q0 + l) * C + cc] = __float2bfloat16(xv * inv * gamma[cc]);
      zs[l * LDZ + cc] = dxn * xv * inv;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += FIN_NT) {
    float acc = 0.f;
    for (int l = 0; l < n_valid; ++l) acc += zs[l * LDZ + c];
    part[(size_t)blockIdx.x * C + c] = acc;
  }
}

// Dynamic shared memory of the backward launches 3-6.
size_t bwd_pre_bytes(int C, int H) {
  return (size_t)TQ * (C + 16) * 2 + (size_t)TQ * (H * DP + 4) * 4;
}
size_t bwd_dq_bytes() { return (size_t)2 * TQ * LDK * 2 + (size_t)BW_NW * BW_WARP_BYTES; }
size_t bwd_dkdv_bytes() { return bwd_dq_bytes() + (size_t)2 * TQ * 4; }
size_t bwd_final_bytes(int C, int A) {
  return (size_t)3 * A * (C + 8) * 2 + (size_t)TQ * (3 * A + 16) * 2 + (size_t)TQ * (C + 4) * 4;
}

}  // namespace

// Dynamic shared memory of one launch at width C, attention width A and H
// heads: which = 0 QKV, 1 core, 2-5 the backward's pre, dq, dk/dv and final
// launches.  ops/cuda/attention_block.py::launch_bytes computes the same in
// Python for the block's gate; chip_smoke.py holds the two against each other.
extern "C" long long attention_step_smem_bytes(int C, int A, int H, int which) {
  switch (which) {
    case 0: return (long long)QkvLay(C, A).bytes();
    case 1: return (long long)CoreLay(C, H).bytes();
    case 2: return (long long)bwd_pre_bytes(C, H);
    case 3: return (long long)bwd_dq_bytes();
    case 4: return (long long)bwd_dkdv_bytes();
    case 5: return (long long)bwd_final_bytes(C, A);
    default: return -1;
  }
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
// with Lpad a multiple of 64 (kept for the backward in training).  o_stash
// [R, Lpad, H*32] bf16 and lse [R, H, Lpad] fp32 are written when not null
// (training).  C % 16 == 0, A % 16 == 0, D even and <= 32 (the wrapper
// checks).  Dropout: seed, keep threshold, absolute row of x's first row,
// 1/(1-p), on (0 at p = 0).
extern "C" int attention_step_forward(
    const void* x, const void* gamma, const void* wqkv, const void* wo,
    const void* cosv, const void* sinv, void* q, void* k, void* v, void* out,
    void* o_stash, void* lse, int R, int L, int Lpad, int C, int H, int D,
    int groups, float eps, int rope, unsigned seed, unsigned thr,
    unsigned row0, float scale, int on, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const DropParams dp = drop_params(seed, thr, row0, scale, on);
  const int tiles = Lpad / TQ;
  const int dpg = C / groups;
  const QkvLay ql(C, H * D);
  cudaError_t e = cudaFuncSetAttribute(
      attn_qkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ql.bytes());
  if (e != cudaSuccess) return (int)e;
  attn_qkv_kernel<<<R * tiles, QKV_NT, ql.bytes(), st>>>(
      (const bf16*)x, (const float*)gamma, (const bf16*)wqkv,
      (const float*)cosv, (const float*)sinv, (bf16*)q, (bf16*)k, (bf16*)v, L,
      Lpad, C, H, D, dpg, 1.f / sqrtf((float)dpg), eps,
      1.f / sqrtf((float)D), rope, tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const CoreLay cl(C, H);
  e = cudaFuncSetAttribute(attn_core_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cl.bytes());
  if (e != cudaSuccess) return (int)e;
  attn_core_kernel<<<R * tiles, CORE_NT, cl.bytes(), st>>>(
      (const bf16*)x, (const bf16*)q, (const bf16*)k, (const bf16*)v,
      (const bf16*)wo, (bf16*)out, L, Lpad, C, H, tiles, dp, (bf16*)o_stash,
      (float*)lse);
  return (int)cudaGetLastError();
}

// Backward of the attention step from the forward's stash.  g [R, L, C]
// bf16 the output's cotangent; dx [R, L, C] bf16 out; out_qkv [3A pad 64][C]
// (rows < 3A: the Wqkv gradient), out_o [H*32 pad 64][C] (the out-projection
// gradient, transposed and head-padded), out_g [C] (dgamma) fp32.
// Scratch: dproj [R, Lpad, C], dout [R, H, Lpad, 32], dqkv [R, Lpad, 3A],
// xn [R, Lpad, C] bf16; Dsum [R, H, Lpad], part [R*tiles][C],
// wpart_q [S1][3A pad][C], wpart_o [S2][H*32 pad][C] fp32.
extern "C" int attention_step_backward(
    const void* x, const void* g, const void* gamma, const void* wqkv,
    const void* wo, const void* cosv, const void* sinv, const void* q,
    const void* k, const void* v, const void* o_stash, const void* lse,
    void* dx, void* dproj, void* dout, void* Dsum, void* dqkv, void* xn,
    void* part, void* wpart_q, void* wpart_o, void* out_qkv, void* out_o,
    void* out_g, int R, int L, int Lpad, int C, int H, int D, int groups,
    float eps, int S1, int S2, unsigned seed, unsigned thr, unsigned row0,
    float scale, int on, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const DropParams dp = drop_params(seed, thr, row0, scale, on);
  const int tiles = Lpad / TQ;
  const int A = H * D, HD = H * DP;
  cudaError_t e;
  const size_t pre_smem = bwd_pre_bytes(C, H);
  if ((e = cudaFuncSetAttribute(attn_bwd_pre_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)pre_smem)) != cudaSuccess)
    return (int)e;
  attn_bwd_pre_kernel<<<R * tiles, BW_NT, pre_smem, st>>>(
      (const bf16*)g, (const bf16*)wo, (const bf16*)o_stash, (bf16*)dproj,
      (bf16*)dout, (float*)Dsum, L, Lpad, C, H, tiles, dp);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  const size_t dq_smem = bwd_dq_bytes();
  if ((e = cudaFuncSetAttribute(attn_bwd_dq_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)dq_smem)) != cudaSuccess)
    return (int)e;
  attn_bwd_dq_kernel<<<R * tiles, BW_NT, dq_smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)Dsum, (const float*)cosv,
      (const float*)sinv, (bf16*)dqkv, L, Lpad, H, D, 1.f / sqrtf((float)D),
      tiles, dp);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  const size_t kv_smem = bwd_dkdv_bytes();
  if ((e = cudaFuncSetAttribute(attn_bwd_dkdv_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)kv_smem)) != cudaSuccess)
    return (int)e;
  attn_bwd_dkdv_kernel<<<R * tiles, BW_NT, kv_smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)Dsum, (const float*)cosv,
      (const float*)sinv, (bf16*)dqkv, L, Lpad, H, D, tiles, dp);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  const size_t fin_smem = bwd_final_bytes(C, A);
  if ((e = cudaFuncSetAttribute(attn_bwd_final_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)fin_smem)) != cudaSuccess)
    return (int)e;
  const int dpg = C / groups;
  attn_bwd_final_kernel<<<R * tiles, FIN_NT, fin_smem, st>>>(
      (const bf16*)x, (const bf16*)g, (const float*)gamma, (const bf16*)wqkv,
      (const bf16*)dqkv, (bf16*)dx, (bf16*)xn, (float*)part, L, Lpad, C, A,
      dpg, 1.f / sqrtf((float)dpg), eps, tiles);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  // dWqkv [3A, C] = sum dqkv^T xn; dWo^T [H*32, C] = sum o^T dproj
  if ((e = wg::launch_wgrad((const bf16*)dqkv, L, Lpad, 3 * A, (const bf16*)xn, L,
                            Lpad, C, 0, 1, R, S1, (float*)wpart_q, nullptr, st)) !=
      cudaSuccess)
    return (int)e;
  if ((e = wg::launch_wgrad((const bf16*)o_stash, L, Lpad, HD, (const bf16*)dproj, L,
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
  return (int)wg::launch_reduce((float*)part, (float*)out_g, 1, R * tiles, C, st);
}
