// Fused attention step:  out = x + OutProj(softmax(RoPE(q) RoPE(k)^T / sqrt(D)) v)
// with q, k, v = QKV(RMSGroupNorm(x)).
//
// Replaces the JAX package's Pallas kernel
// ``ops/pallas/attention_block.py::_attn_forward`` (body ``_attn_kernel``),
// public ``fused_attention_block``, forward at dropout 0 (inference).
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
// keeping them on chip (and wgmma/TMA) is later work.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>

#include "rmsgroupnorm.cuh"

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
    int C, int H, int tiles) {
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
      float sum = 0.f;
      for (int c = half * 32; c < half * 32 + 32; ++c) {
        const float p = (j0 + c < L) ? __expf(sw[r * LDS + c] - m_new) : 0.f;
        sum += p;
        pw[r * LDP + c] = __float2bfloat16(p);
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
    const float inv = 1.f / l_run;
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
  const bf16* xr = x + (size_t)row * L * C;
  bf16* outr = out + (size_t)row * L * C;
  for (int i = lane; i < 16 * C; i += 32) {
    const int l = i / C, c = i % C;
    const int pos = q0 + warp * 16 + l;
    if (pos >= L) break;
    const size_t off = (size_t)pos * C + c;
    outr[off] = __float2bfloat16(__bfloat162float(xr[off]) + zw[l * S.LDZ + c]);
  }
}

}  // namespace

// x, out [R, L, C] bf16; gamma [C] fp32; wqkv [3A, C] bf16 (torch Linear
// layout); wo [H*32, C] bf16 (out-projection transposed, head dims padded
// to 32 with zero rows); cos/sin [L, D/2] fp32; q/k/v scratch
// [R, H, Lpad, 32] bf16 with Lpad a multiple of 64.  C % 16 == 0,
// A % 16 == 0, D even and <= 32 (the wrapper checks).
extern "C" int attention_step_forward(
    const void* x, const void* gamma, const void* wqkv, const void* wo,
    const void* cosv, const void* sinv, void* q, void* k, void* v, void* out,
    int R, int L, int Lpad, int C, int H, int D, int groups, float eps,
    int rope, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
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
      (const bf16*)wo, (bf16*)out, L, Lpad, C, H, tiles);
  return (int)cudaGetLastError();
}
