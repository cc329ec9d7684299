// Fused macaron FFN step:  out = x + Deconv1d(SwiGLU(Conv1d(RMSGroupNorm(x))))
//
// Replaces the JAX package's Pallas kernels
// ``ops/pallas/swiglu_block.py::_blk_forward`` (body ``_blk_kernel``) and
// ``::_blk_backward`` (body ``_blk_bwd_kernel``), public
// ``fused_norm_ffn_residual``, with both reference dropout sites: the inner
// one on the SwiGLU output and the outer one after the crop (masks from
// ``philox.cuh``, survivors scaled by 1/(1-p)).
//
// Shapes: x [R, L, C] bf16 rows; Conv1d(C -> 2I, k, stride 1) on the normed
// rows zero-padded by k-1 on both sides (so the conv has L+k-1 outputs, every
// one of them live: the conv bias reaches the padded ends), value/gate split
// h = y[:I] * silu(y[I:]), ConvTranspose1d(I -> C, k), crop [k-1, k-1+L).
// For an output position l the taps need h[l .. l+k-1], which need normed x
// at [l-k+1, l+k-1]: a halo of k-1 rows on each side.
//
// What bounds it on the H100: the two products, 2*L*k*C*2I + 2*L*I*k*C
// FLOP per row (1.25 TFLOP per call on the base freq path, R 1380 x L 1025,
// C 96, I 384, k 4), against only 2 bytes x C read and written per position
// -- tensor-core arithmetic, provided the [L, 2I] intermediate never goes to
// device memory.  The design keeps it on chip:
//   * one block per (row, tile of 64 conv outputs) -> 64-k+1 outputs stored;
//   * prologue: the tile's x rows plus halo are normed in fp32 and rounded to
//     bf16 into shared memory (the zero padding is applied to the NORMED rows);
//   * the inner dimension runs in chunks of 32 value + 32 gate channels: the
//     chunk's conv panel and deconv panel are staged in shared memory, the conv
//     is k shifted [64, C] x [C, 64] wmma products (bf16 in, fp32 accumulate),
//     SwiGLU in fp32 gives a bf16 [64, 32] h tile in shared memory, and the
//     deconv's k shifted [64, 32] x [32, C] products accumulate into fp32
//     fragments that stay in registers across all chunks;
//   * epilogue: residual add in fp32, one rounding to bf16, ragged tail masked.
// Weights are re-read from L2 by every block (about 1 MB per block); making
// that traffic smaller (several tiles per block, TMA, wgmma) is later work.
//
// Backward (``ffn_bwd_dx_kernel``, then the split-K weight products of
// ``wgrad.cuh``): recompute per tile with no stash, as the TPU kernel does.
// The same (row, 64 conv outputs) tiles recompute the norm, the conv and
// the SwiGLU chunk by chunk, replay both masks, and run the three adjoint
// products on wmma: dh = dz (+) Wd^T over the k taps, dy through the gate,
// dxn += dy (+) Wc^T held in registers across chunks, then the norm's
// backward (the eps-on-rms quirk: dx = g*dxn/(r+eps) - x*sum(g*dxn*x) /
// ((r+eps)^2*dpg*r), the second term taken as 0 at r = 0) and the residual.
// Unlike the TPU kernel, which sums the weight gradients over its in-order
// grid, each tile writes the bf16 operands of those sums -- dy [L+k-1, 2I],
// the dropped SwiGLU output [L+k-1, I], xn and dz [L, C] -- once to
// scratch, and the weight gradients are two deterministic split-K products
// over all positions (``wgrad.cuh``).  dgamma and the deconv bias are
// per-block partial sums reduced in order.  Bound: ~2x the forward's FLOP
// (recompute, three adjoint products, two weight products), plus the
// scratch traffic (~2.5 KB per position at the base config).
#include <cuda_runtime.h>
#include <mma.h>

#include "philox.cuh"
#include "rmsgroupnorm.cuh"
#include "wgrad.cuh"

using namespace nvcuda;

namespace {

constexpr int M = 64;         // conv outputs (h rows) per tile
constexpr int ROWS = M + 16;  // shared rows for normed x and h (halo + zeros)
constexpr int IC = 32;        // inner channels per chunk (value and gate each)
constexpr int NW = 8;         // warps per block
constexpr int NT = NW * 32;

// Row strides (elements).  wmma needs 32-byte aligned fragment pointers; the
// A operands start at any row, so their strides are multiples of 16 bf16.
template <int C>
struct Lay {
  static constexpr int LDX = C + 16;      // normed x, bf16
  static constexpr int LDH = IC + 16;     // h, bf16
  static constexpr int LDY = 2 * IC + 4;  // conv output, fp32
  static constexpr int LDW = 2 * IC + 8;  // conv panel, bf16
  static constexpr int LDD = C + 8;       // deconv panel, bf16
  static constexpr int LDZ = C + 4;       // output staging, fp32
  __host__ __device__ static size_t wc_bytes(int K) {
    const size_t w = (size_t)K * C * LDW * 2, z = (size_t)M * LDZ * 4;
    return w > z ? w : z;                 // the output staging reuses it
  }
  __host__ __device__ static size_t bytes(int K) {
    return (size_t)ROWS * LDX * 2 + (size_t)ROWS * LDH * 2 + (size_t)M * LDY * 4 +
           wc_bytes(K) + (size_t)K * IC * LDD * 2 + 2 * IC * 4;
  }
};

template <int C>
__global__ void __launch_bounds__(NT) ffn_step_kernel(
    const bf16* __restrict__ x, const float* __restrict__ gamma,
    const bf16* __restrict__ wc, const float* __restrict__ bc,
    const bf16* __restrict__ wd, const float* __restrict__ bd,
    bf16* __restrict__ out, int L, int I, int K, int dpg, float rdpg,
    float eps, int tiles, DropParams dp) {
  using S = Lay<C>;
  constexpr int NZ = C / 32;  // output fragments (16 x 16) per warp
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = (bf16*)smem;
  bf16* hs = xs + ROWS * S::LDX;
  float* ys = (float*)(hs + ROWS * S::LDH);
  bf16* wcs = (bf16*)(ys + M * S::LDY);
  bf16* wds = (bf16*)((unsigned char*)wcs + S::wc_bytes(K));
  float* bcs = (float*)(wds + K * IC * S::LDD);

  const int row = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int lt = M - (K - 1);  // outputs stored per tile
  const int l0 = tile * lt;
  const int warp = threadIdx.x / 32;
  const bf16* xr = x + (size_t)row * L * C;

  // shared row p <-> position l0 - (K-1) + p
  rmsgroupnorm_rows(xr, L, l0 - (K - 1), ROWS, gamma, C, dpg, rdpg, eps, xs,
                    S::LDX);
  // h rows >= M feed only outputs that are never stored: keep them zero
  for (int i = threadIdx.x; i < (ROWS - M) * S::LDH; i += NT)
    hs[M * S::LDH + i] = __float2bfloat16(0.f);

  const int zm = warp % 4, zn0 = (warp / 4) * NZ;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> zacc[NZ];
#pragma unroll
  for (int q = 0; q < NZ; ++q) wmma::fill_fragment(zacc[q], 0.f);

  const int ym = warp % 4, yn = warp / 4;  // value cols yn*16, gate IC + yn*16
  const int n_chunks = I / IC;
  for (int ch = 0; ch < n_chunks; ++ch) {
    __syncthreads();  // previous chunk done with the panels and h
    const bf16* wcg = wc + (size_t)ch * K * C * 2 * IC;
    constexpr int VW = 2 * IC / 8;  // 16-byte vectors per conv panel row
    for (int i = threadIdx.x; i < K * C * VW; i += NT) {
      const int r = i / VW, v = i % VW;
      *(uint4*)(wcs + r * S::LDW + v * 8) =
          *(const uint4*)(wcg + (size_t)r * 2 * IC + v * 8);
    }
    const bf16* wdg = wd + (size_t)ch * K * IC * C;
    constexpr int VD = C / 8;
    for (int i = threadIdx.x; i < K * IC * VD; i += NT) {
      const int r = i / VD, v = i % VD;
      *(uint4*)(wds + r * S::LDD + v * 8) =
          *(const uint4*)(wdg + (size_t)r * C + v * 8);
    }
    if (threadIdx.x < 2 * IC) bcs[threadIdx.x] = bc[ch * 2 * IC + threadIdx.x];
    __syncthreads();

    // conv: y[m, col] = sum_t sum_c xn[m + t, c] * W[t*C + c, col]
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> yv, yg;
      wmma::fill_fragment(yv, 0.f);
      wmma::fill_fragment(yg, 0.f);
      for (int t = 0; t < K; ++t) {
#pragma unroll
        for (int kc = 0; kc < C / 16; ++kc) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv, bg;
          wmma::load_matrix_sync(a, xs + (ym * 16 + t) * S::LDX + kc * 16, S::LDX);
          const bf16* wrow = wcs + (t * C + kc * 16) * S::LDW;
          wmma::load_matrix_sync(bv, wrow + yn * 16, S::LDW);
          wmma::load_matrix_sync(bg, wrow + IC + yn * 16, S::LDW);
          wmma::mma_sync(yv, a, bv, yv);
          wmma::mma_sync(yg, a, bg, yg);
        }
      }
      wmma::store_matrix_sync(ys + ym * 16 * S::LDY + yn * 16, yv, S::LDY,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(ys + ym * 16 * S::LDY + IC + yn * 16, yg, S::LDY,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // SwiGLU in fp32, inner dropout (conv position l0 + m, inner channel),
    // h rounded to bf16 for the deconv product; 4 channels per Philox draw
    for (int i = threadIdx.x; i < M * IC / 4; i += NT) {
      const int m = i / (IC / 4), c0 = (i % (IC / 4)) * 4;
      Philox4 w;
      if (dp.on)
        w = dropout_words(dp.seed, SITE_FFN_INNER, dp.row0 + row, l0 + m,
                          (ch * IC + c0) >> 2, 0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + e;
        const float v = ys[m * S::LDY + c] + bcs[c];
        const float g = ys[m * S::LDY + IC + c] + bcs[IC + c];
        float h = v * (g / (1.f + __expf(-g)));
        if (dp.on) h = w.w[e] < dp.thr ? h * dp.scale : 0.f;
        hs[m * S::LDH + c] = __float2bfloat16(h);
      }
    }
    __syncthreads();

    // deconv + crop: z[l, c] += sum_t sum_i h[l + K-1 - t, i] * Wd[t, i, c]
    for (int t = 0; t < K; ++t) {
#pragma unroll
      for (int ki = 0; ki < IC / 16; ++ki) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, hs + (zm * 16 + K - 1 - t) * S::LDH + ki * 16,
                               S::LDH);
#pragma unroll
        for (int q = 0; q < NZ; ++q) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
          wmma::load_matrix_sync(b, wds + (t * IC + ki * 16) * S::LDD + (zn0 + q) * 16,
                                 S::LDD);
          wmma::mma_sync(zacc[q], a, b, zacc[q]);
        }
      }
    }
  }

  __syncthreads();  // every warp is done with the conv panel: reuse it
  float* zs = (float*)wcs;
#pragma unroll
  for (int q = 0; q < NZ; ++q)
    wmma::store_matrix_sync(zs + zm * 16 * S::LDZ + (zn0 + q) * 16, zacc[q],
                            S::LDZ, wmma::mem_row_major);
  __syncthreads();

  // residual + outer dropout (position, channel); 4 channels per draw
  bf16* outr = out + (size_t)row * L * C;
  const int n_out = min(lt, L - l0) * (C / 4);
  for (int i = threadIdx.x; i < n_out; i += NT) {
    const int l = i / (C / 4), c0 = (i % (C / 4)) * 4;
    Philox4 w;
    if (dp.on) w = dropout_words(dp.seed, SITE_FFN_OUTER, dp.row0 + row, l0 + l, c0 >> 2, 0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + e;
      const size_t off = (size_t)(l0 + l) * C + c;
      float z = zs[l * S::LDZ + c] + bd[c];
      if (dp.on) z = w.w[e] < dp.thr ? z * dp.scale : 0.f;
      outr[off] = __float2bfloat16(__bfloat162float(xr[off]) + z);
    }
  }
}

template <int C>
int launch(const bf16* x, const float* gamma, const bf16* wc, const float* bc,
           const bf16* wd, const float* bd, bf16* out, int R, int L, int I,
           int K, int groups, float eps, DropParams dp, cudaStream_t stream) {
  const int dpg = C / groups;
  const int lt = M - (K - 1);
  const int tiles = (L + lt - 1) / lt;
  const size_t smem = Lay<C>::bytes(K);
  cudaError_t e = cudaFuncSetAttribute(
      ffn_step_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  ffn_step_kernel<C><<<R * tiles, NT, smem, stream>>>(
      x, gamma, wc, bc, wd, bd, out, L, I, K, dpg, 1.f / sqrtf((float)dpg), eps,
      tiles, dp);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- backward

template <int C>
struct BLay {
  static constexpr int LDX = C + 16;      // normed x and dz rows, bf16
  static constexpr int LDW = 2 * IC + 8;  // conv panel, bf16
  static constexpr int LDD = C + 8;       // deconv panel, bf16
  static constexpr int LDY = 2 * IC + 4;  // conv output, fp32
  static constexpr int LDH = IC + 4;      // dh, fp32
  static constexpr int LDG = 2 * IC + 16; // dy (value | gate), bf16
  static constexpr int LDZ = C + 4;       // dxn staging, fp32
  __host__ __device__ static size_t wc_bytes(int K) {
    const size_t w = (size_t)K * C * LDW * 2, z = (size_t)M * LDZ * 4;
    return w > z ? w : z;
  }
  __host__ __device__ static size_t bytes(int K) {
    return 2 * (size_t)ROWS * LDX * 2 + (size_t)M * LDY * 4 + (size_t)M * LDH * 4 +
           (size_t)ROWS * LDG * 2 + wc_bytes(K) + (size_t)K * IC * LDD * 2 + 2 * IC * 4;
  }
};

// One block per (row, tile of 64 conv outputs j = l0 .. l0+63), l0 = tile*lt;
// it stores dx for positions [l0, l0 + lt) and is the one tile that writes
// the scratch rows j in [l0, l0 + lt) (the last tile: every j < L+k-1).
template <int C>
__global__ void __launch_bounds__(NT) ffn_bwd_dx_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ gin,
    const float* __restrict__ gamma, const bf16* __restrict__ wc,
    const float* __restrict__ bc, const bf16* __restrict__ wd,
    bf16* __restrict__ dx, bf16* __restrict__ xn_out, bf16* __restrict__ dz_out,
    bf16* __restrict__ dy_out, bf16* __restrict__ hd_out,
    float* __restrict__ part, int L, int I, int K, int dpg, float rdpg,
    float eps, int tiles, DropParams dp) {
  using S = BLay<C>;
  constexpr int NZ = C / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = (bf16*)smem;
  bf16* dzs = xs + ROWS * S::LDX;
  float* ys = (float*)(dzs + ROWS * S::LDX);
  float* dhs = ys + M * S::LDY;
  bf16* dys = (bf16*)(dhs + M * S::LDH);
  bf16* wcs = dys + ROWS * S::LDG;
  bf16* wds = (bf16*)((unsigned char*)wcs + S::wc_bytes(K));
  float* bcs = (float*)(wds + K * IC * S::LDD);

  const int row = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int lt = M - (K - 1);
  const int l0 = tile * lt;
  const int Lt = L + K - 1;  // conv outputs
  const int warp = threadIdx.x / 32;
  const size_t rowoff = (size_t)row * L * C;
  const bf16* xr = x + rowoff;
  const bf16* gr = gin + rowoff;

  // shared row p <-> position l0 - (K-1) + p, for xn and for dz
  rmsgroupnorm_rows(xr, L, l0 - (K - 1), ROWS, gamma, C, dpg, rdpg, eps, xs, S::LDX);
  for (int i = threadIdx.x; i < ROWS * (C / 4); i += NT) {
    const int p = i / (C / 4), c0 = (i % (C / 4)) * 4;
    const int pos = l0 - (K - 1) + p;
    Philox4 w;
    const bool live = pos >= 0 && pos < L;
    if (live && dp.on) w = dropout_words(dp.seed, SITE_FFN_OUTER, dp.row0 + row, pos, c0 >> 2, 0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = 0.f;
      if (live) {
        v = __bfloat162float(gr[(size_t)pos * C + c0 + e]);
        if (dp.on) v = w.w[e] < dp.thr ? v * dp.scale : 0.f;
      }
      dzs[p * S::LDX + c0 + e] = __float2bfloat16(v);
    }
  }
  // dy rows >= M feed only dxn rows that are never stored: keep them zero
  for (int i = threadIdx.x; i < (ROWS - M) * S::LDG; i += NT)
    dys[M * S::LDG + i] = __float2bfloat16(0.f);

  const int zm = warp % 4, zn0 = (warp / 4) * NZ;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dxacc[NZ];
#pragma unroll
  for (int q = 0; q < NZ; ++q) wmma::fill_fragment(dxacc[q], 0.f);

  const int ym = warp % 4, yn = warp / 4;
  const size_t scr = (size_t)row * Lt;
  for (int ch = 0; ch < I / IC; ++ch) {
    __syncthreads();
    const bf16* wcg = wc + (size_t)ch * K * C * 2 * IC;
    constexpr int VW = 2 * IC / 8;
    for (int i = threadIdx.x; i < K * C * VW; i += NT) {
      const int r = i / VW, v = i % VW;
      *(uint4*)(wcs + r * S::LDW + v * 8) = *(const uint4*)(wcg + (size_t)r * 2 * IC + v * 8);
    }
    const bf16* wdg = wd + (size_t)ch * K * IC * C;
    constexpr int VD = C / 8;
    for (int i = threadIdx.x; i < K * IC * VD; i += NT) {
      const int r = i / VD, v = i % VD;
      *(uint4*)(wds + r * S::LDD + v * 8) = *(const uint4*)(wdg + (size_t)r * C + v * 8);
    }
    if (threadIdx.x < 2 * IC) bcs[threadIdx.x] = bc[ch * 2 * IC + threadIdx.x];
    __syncthreads();

    // recompute the conv: y[m, col] = sum_t sum_c xn[m + t, c] * W[t*C + c, col]
    // and the deconv adjoint: dh[m, i] = sum_t sum_c dz[m + t, c] * Wd[t, i, c]
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> yv, yg, dh;
      wmma::fill_fragment(yv, 0.f);
      wmma::fill_fragment(yg, 0.f);
      wmma::fill_fragment(dh, 0.f);
      for (int t = 0; t < K; ++t) {
#pragma unroll
        for (int kc = 0; kc < C / 16; ++kc) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a, az;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv, bg;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bd;
          wmma::load_matrix_sync(a, xs + (ym * 16 + t) * S::LDX + kc * 16, S::LDX);
          const bf16* wrow = wcs + (t * C + kc * 16) * S::LDW;
          wmma::load_matrix_sync(bv, wrow + yn * 16, S::LDW);
          wmma::load_matrix_sync(bg, wrow + IC + yn * 16, S::LDW);
          wmma::mma_sync(yv, a, bv, yv);
          wmma::mma_sync(yg, a, bg, yg);
          wmma::load_matrix_sync(az, dzs + (ym * 16 + t) * S::LDX + kc * 16, S::LDX);
          // Wd^T: element (c, i) at wds[(t*IC + i)*LDD + c] -- col-major
          wmma::load_matrix_sync(bd, wds + (t * IC + yn * 16) * S::LDD + kc * 16, S::LDD);
          wmma::mma_sync(dh, az, bd, dh);
        }
      }
      wmma::store_matrix_sync(ys + ym * 16 * S::LDY + yn * 16, yv, S::LDY, wmma::mem_row_major);
      wmma::store_matrix_sync(ys + ym * 16 * S::LDY + IC + yn * 16, yg, S::LDY,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(dhs + ym * 16 * S::LDH + yn * 16, dh, S::LDH, wmma::mem_row_major);
    }
    __syncthreads();

    // through the inner mask and the SwiGLU, fp32; 4 channels per draw
    for (int i = threadIdx.x; i < M * IC / 4; i += NT) {
      const int m = i / (IC / 4), c0 = (i % (IC / 4)) * 4;
      const int j = l0 + m;
      const bool live = j < Lt;
      const bool own = live && (m < lt || tile == tiles - 1);
      Philox4 w;
      if (dp.on) w = dropout_words(dp.seed, SITE_FFN_INNER, dp.row0 + row, j, (ch * IC + c0) >> 2, 0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + e;
        const float v = ys[m * S::LDY + c] + bcs[c];
        const float g = ys[m * S::LDY + IC + c] + bcs[IC + c];
        const float sig = 1.f / (1.f + __expf(-g));
        const float silu = g * sig;
        float s = 1.f;
        if (dp.on) s = w.w[e] < dp.thr ? dp.scale : 0.f;
        float dv = 0.f, dg = 0.f, hd = 0.f;
        if (live) {
          const float dhm = dhs[m * S::LDH + c] * s;
          dv = dhm * silu;
          dg = dhm * v * sig * (1.f + g * (1.f - sig));
          hd = v * silu * s;
        }
        const bf16 dvb = __float2bfloat16(dv), dgb = __float2bfloat16(dg);
        dys[m * S::LDG + c] = dvb;
        dys[m * S::LDG + IC + c] = dgb;
        if (own) {
          bf16* dyr = dy_out + (scr + j) * 2 * I;
          dyr[ch * IC + c] = dvb;
          dyr[I + ch * IC + c] = dgb;
          hd_out[(scr + j) * I + ch * IC + c] = __float2bfloat16(hd);
        }
      }
    }
    __syncthreads();

    // conv adjoint: dxn[l, c] += sum_t sum_o dy[l + K-1 - t, o] * W[t*C + c, o]
    for (int t = 0; t < K; ++t) {
#pragma unroll
      for (int ko = 0; ko < 2 * IC / 16; ++ko) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, dys + (zm * 16 + K - 1 - t) * S::LDG + ko * 16, S::LDG);
#pragma unroll
        for (int q = 0; q < NZ; ++q) {
          // W_t^T: element (o, c) at wcs[(t*C + c)*LDW + o] -- col-major
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
          wmma::load_matrix_sync(b, wcs + (t * C + (zn0 + q) * 16) * S::LDW + ko * 16, S::LDW);
          wmma::mma_sync(dxacc[q], a, b, dxacc[q]);
        }
      }
    }
  }

  __syncthreads();
  float* zs = (float*)wcs;
#pragma unroll
  for (int q = 0; q < NZ; ++q)
    wmma::store_matrix_sync(zs + zm * 16 * S::LDZ + (zn0 + q) * 16, dxacc[q], S::LDZ,
                            wmma::mem_row_major);
  __syncthreads();

  // norm backward per (position, group), residual added; xn and dz out
  const int n_valid = min(lt, L - l0);
  const int groups = C / dpg;
  for (int item = threadIdx.x; item < n_valid * groups; item += NT) {
    const int l = item / groups, gidx = item % groups;
    const size_t off = (size_t)(l0 + l) * C + gidx * dpg;
    float ss = 0.f, tsum = 0.f;
    for (int c = 0; c < dpg; ++c) {
      const float xv = __bfloat162float(xr[off + c]);
      ss += xv * xv;
      tsum += gamma[gidx * dpg + c] * zs[l * S::LDZ + gidx * dpg + c] * xv;
    }
    const float r = sqrtf(ss) * rdpg;
    const float inv = 1.f / (r + eps);
    const float k2 = r > 0.f ? tsum * inv * inv / (dpg * r) : 0.f;
    for (int c = 0; c < dpg; ++c) {
      const int cc = gidx * dpg + c;
      const float xv = __bfloat162float(xr[off + c]);
      const float dxn = zs[l * S::LDZ + cc];
      const float v = gamma[cc] * dxn * inv - xv * k2 + __bfloat162float(gr[off + c]);
      dx[rowoff + off + c] = __float2bfloat16(v);
      zs[l * S::LDZ + cc] = dxn * xv * inv;  // dgamma summand
      xn_out[rowoff + off + c] = xs[(l + K - 1) * S::LDX + cc];
      dz_out[rowoff + off + c] = dzs[(l + K - 1) * S::LDX + cc];
    }
  }
  __syncthreads();
  // per-block partials: dgamma [C], then the deconv bias (sum of dz) [C]
  for (int c = threadIdx.x; c < 2 * C; c += NT) {
    float acc = 0.f;
    if (c < C) {
      for (int l = 0; l < n_valid; ++l) acc += zs[l * S::LDZ + c];
    } else {
      for (int l = 0; l < n_valid; ++l) acc += __bfloat162float(dzs[(l + K - 1) * S::LDX + c - C]);
    }
    part[(size_t)blockIdx.x * 2 * C + c] = acc;
  }
}

template <int C>
int launch_bwd(const bf16* x, const bf16* g, const float* gamma, const bf16* wc,
               const float* bc, const bf16* wd, bf16* dx, bf16* xn, bf16* dz,
               bf16* dy, bf16* hd, float* part, float* wpart_c, float* colsum_c,
               float* wpart_d, float* out_c, float* out_cb, float* out_d,
               float* out_gb, int R, int L, int I, int K, int groups, float eps,
               int S1, int S2, DropParams dp, cudaStream_t st) {
  const int dpg = C / groups;
  const int lt = M - (K - 1);
  const int tiles = (L + lt - 1) / lt;
  const int Lt = L + K - 1;
  const size_t smem = BLay<C>::bytes(K);
  cudaError_t e = cudaFuncSetAttribute(
      ffn_bwd_dx_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  ffn_bwd_dx_kernel<C><<<R * tiles, NT, smem, st>>>(
      x, g, gamma, wc, bc, wd, dx, xn, dz, dy, hd, part, L, I, K, dpg,
      1.f / sqrtf((float)dpg), eps, tiles, dp);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  // dconv_w[t][o, c] = sum dy[j, o] xn[j + t - (K-1), c]; dconv_b = sum dy
  if ((e = wg::launch_wgrad(dy, Lt, Lt, 2 * I, xn, L, L, C, -(K - 1), K, R, S1,
                            wpart_c, colsum_c, st)) != cudaSuccess)
    return (int)e;
  // ddeconv_w[t][i, c] = sum hd[j, i] dz[j + t - (K-1), c]
  if ((e = wg::launch_wgrad(hd, Lt, Lt, I, dz, L, L, C, -(K - 1), K, R, S2,
                            wpart_d, nullptr, st)) != cudaSuccess)
    return (int)e;
  const long long mc = (long long)wg::mtiles(2 * I) * wg::BM;
  const long long md = (long long)wg::mtiles(I) * wg::BM;
  if ((e = wg::launch_reduce(wpart_c, out_c, K, S1, mc * C, st)) != cudaSuccess) return (int)e;
  if ((e = wg::launch_reduce(colsum_c, out_cb, 1, S1, mc, st)) != cudaSuccess) return (int)e;
  if ((e = wg::launch_reduce(wpart_d, out_d, K, S2, md * C, st)) != cudaSuccess) return (int)e;
  return (int)wg::launch_reduce(part, out_gb, 1, R * tiles, 2 * C, st);
}

}  // namespace

#define FFN_SWITCH(C, CASE)        \
  switch (C) {                     \
    CASE(32)                       \
    CASE(64)                       \
    CASE(96)                       \
    CASE(128)                      \
    default:                       \
      return (int)cudaErrorInvalidValue; \
  }

// Dynamic shared memory of the forward (Lay<C>) and, with training, the
// larger of it and the backward's (BLay<C>) at width C and K taps; 0 for a
// width with no instantiation.  ops/cuda/swiglu_block.py::step_bytes computes
// the same in Python for the block's gate; chip_smoke.py holds the two
// against each other.
extern "C" long long ffn_step_smem_bytes(int C, int K, int training) {
#define FFN_BYTES_CASE(CC)                                              \
  case CC: {                                                            \
    const size_t f = Lay<CC>::bytes(K), b = BLay<CC>::bytes(K);         \
    return (long long)(training && b > f ? b : f);                      \
  }
  switch (C) {
    FFN_BYTES_CASE(32)
    FFN_BYTES_CASE(64)
    FFN_BYTES_CASE(96)
    FFN_BYTES_CASE(128)
    default:
      return 0;
  }
#undef FFN_BYTES_CASE
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

// x, out [R, L, C] bf16; gamma [C] fp32; wc [I/32][K*C][64] bf16 (per chunk:
// rows tap-major t*C + c, columns 32 value then 32 gate channels); bc [I/32][64]
// fp32; wd [I/32][K][32][C] bf16; bd [C] fp32.  C in {32, 64, 96, 128},
// I % 32 == 0, 2 <= K <= 8 (the wrapper checks).  Dropout: seed, the keep
// threshold, the absolute row of x's first row, 1/(1-p), on (0 at p = 0).
extern "C" int ffn_step_forward(const void* x, const void* gamma, const void* wc,
                                const void* bc, const void* wd, const void* bd,
                                void* out, int R, int L, int C, int I, int K,
                                int groups, float eps, unsigned seed,
                                unsigned thr, unsigned row0, float scale,
                                int on, void* stream) {
  const DropParams dp = drop_params(seed, thr, row0, scale, on);
#define FFN_CASE(CC)                                                          \
  case CC:                                                                    \
    return launch<CC>((const bf16*)x, (const float*)gamma, (const bf16*)wc,   \
                      (const float*)bc, (const bf16*)wd, (const float*)bd,    \
                      (bf16*)out, R, L, I, K, groups, eps, dp,                \
                      (cudaStream_t)stream);
  FFN_SWITCH(C, FFN_CASE)
#undef FFN_CASE
}

// Backward.  Inputs as the forward's, g [R, L, C] bf16 the output's
// cotangent.  Outputs: dx [R, L, C] bf16; out_c [K][2I pad 64][C] fp32 (the
// conv weight gradient, tap-major), out_cb [2I pad 64] (conv bias),
// out_d [K][I pad 64][C] (deconv weight), out_gb [2C] (dgamma, then the
// deconv bias).  Scratch: xn, dz [R, L, C] and dy [R, L+K-1, 2I],
// hd [R, L+K-1, I] bf16; part [R*tiles][2C], wpart_c [K][S1][2I pad][C],
// colsum_c [S1][2I pad], wpart_d [K][S2][I pad][C] fp32.
extern "C" int ffn_step_backward(
    const void* x, const void* g, const void* gamma, const void* wc,
    const void* bc, const void* wd, void* dx, void* xn, void* dz, void* dy,
    void* hd, void* part, void* wpart_c, void* colsum_c, void* wpart_d,
    void* out_c, void* out_cb, void* out_d, void* out_gb, int R, int L, int C,
    int I, int K, int groups, float eps, int S1, int S2, unsigned seed,
    unsigned thr, unsigned row0, float scale, int on, void* stream) {
  const DropParams dp = drop_params(seed, thr, row0, scale, on);
#define FFN_BWD_CASE(CC)                                                           \
  case CC:                                                                         \
    return launch_bwd<CC>(                                                         \
        (const bf16*)x, (const bf16*)g, (const float*)gamma, (const bf16*)wc,      \
        (const float*)bc, (const bf16*)wd, (bf16*)dx, (bf16*)xn, (bf16*)dz,        \
        (bf16*)dy, (bf16*)hd, (float*)part, (float*)wpart_c, (float*)colsum_c,     \
        (float*)wpart_d, (float*)out_c, (float*)out_cb, (float*)out_d,             \
        (float*)out_gb, R, L, I, K, groups, eps, S1, S2, dp, (cudaStream_t)stream);
  FFN_SWITCH(C, FFN_BWD_CASE)
#undef FFN_BWD_CASE
}
