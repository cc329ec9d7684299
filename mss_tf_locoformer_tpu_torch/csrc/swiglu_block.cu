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
// device memory -- and the weights (885 KB at C 96, I 384, k 4), which every
// block streams from L2.  Two routes, by width:
//
// Hopper route, C 96 and 128 (``stp`` below: the base config, and
// BS-Locoformer, medium and the speech configs), on wgmma, bulk copies and
// mbarrier rings (``hopper.cuh``, ``ffn_wg.cuh``: the FFN core's pieces):
//   * the rows laid end to end as one sequence of padded rows (``Flat``:
//     each row with its 2(k-1) zero positions), cut into tiles of 128 conv
//     positions, one block each: a tile packs the end of a row and the start
//     of the next, so short rows (BS-Locoformer's 62 bands) and ragged row
//     ends cost only their padding; two consumer warpgroups of 64 positions,
//     128-(k-1) outputs a tile; thread 0 also streams the weights;
//   * prologue: the tile's x rows plus the k-1 halo come in as 16-byte loads
//     (every load of a thread issued before its stores) into the swizzled A
//     tile (two 64-channel atom columns; at C 96 the second is half used),
//     are normed per position in fp32 (groups of C/num_groups channels, a
//     multiple of 8, times gamma) and rounded once to bf16 in place;
//     padding rows are zero after the norm (the conv's padding);
//   * the weights stream through a ring of stages of 256 C bytes, laid out
//     by the wrapper (``wg_step_panels``) in the swizzled order wgmma reads:
//     per 64-channel chunk and tap the conv's [C k][128 n] (64 value, 64
//     gate channels; B "MN-major", so C needs no whole 64-channel atoms: it
//     is the k extent), then per pair of taps the deconv's [2][C n][64 k];
//     the dx kernel reads the conv's stages again as [C n][128 k] for the
//     conv's adjoint, and the deconv's as [C k][64 n] for dh;
//   * forward per chunk: the conv, k taps x C/16 products m64n128k16 with A
//     at the tap's row offset (a swizzled descriptor may start at any row);
//     SwiGLU in fp32 on the accumulators with the inner mask (the fast
//     divide: a full-precision one cost a quarter of the kernel), h rounded
//     to bf16 into one swizzled tile; the deconv, k products of [128 x 64]
//     x [64 x C] (m64n96 / m64n128), accumulating in registers across
//     chunks;
//   * epilogue: deconv bias, outer mask and residual (x re-read) in fp32,
//     one rounding, padding positions skipped;
//   * backward (``ffn_step_dx_wg_kernel`` per row group, then the FFN core's
//     weight-gradient GEMM, ``ffn_wg.cuh``): the dx kernel recomputes norm,
//     conv and SwiGLU chunk by chunk, replays both masks, takes dh = dz (+)
//     Wd^T over the taps, dyvg through the gate and dxn += dyvg (+) Wc^T in
//     registers across chunks, then the norm's backward (the eps-on-rms
//     quirk: dx = g*dxn/(r+eps) - x*sum(g*dxn*x)/((r+eps)^2*dpg*r), the
//     second term 0 at r = 0) and the residual; it writes the GEMM's bf16
//     operands -- xn and dz with their zero padding, dyvg and the dropped h,
//     all as the group's flat padded rows -- to a scratch bounded by row
//     groups, and dgamma and deconv-bias partials per block.  The GEMM takes
//     its C-side boxes as taps of 128 channels (at C 96 the map reads zeros
//     past 96).  All sums are fp32 partials reduced in a fixed order: no
//     atomics.
// Measured on the card (PERF.md §6; per-warp cycle shares at base
// serving): SwiGLU ~32%, the products' waits ~40%, the weight stream's
// waits ~11%, the prologue ~10%: the chunk's phases run one after another.
//
// Partial-sum mode (``residual`` 0 at the C entry points; the tensor-
// parallel step, ``parallel/tp_fused.py``, over a shard of the inner
// channels): the forward writes Deconv1d(drop_inner(SwiGLU(...))) alone --
// no outer mask, no residual; the caller passes a zero deconv bias -- and
// the backward takes dz = g (no outer mask), leaves the identity out of dx
// and the deconv bias's gradient at zero (the caller adds the bias after
// the sum over shards, where autograd gives it its gradient).  The inner
// mask stays: it is per inner channel.
//
// wmma route, C 32 and 64 (the first kernels, below): one block per (row,
// tile of 64 conv outputs); the tile's normed rows in shared memory; the
// inner dimension in chunks of 32 value + 32 gate channels whose conv and
// deconv panels every block stages synchronously; wmma m16n16k16 products;
// the backward recomputes per tile, writes dy, h, xn and dz for all
// positions, and takes the weight gradients as split-K products
// (``wgrad.cuh``).
#include <cuda_runtime.h>
#include <mma.h>

#include "ffn_wg.cuh"
#include "hopper.cuh"
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
    float eps, int tiles, DropParams dp, bool res) {
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

  // residual + outer dropout (position, channel); 4 channels per draw.
  // Partial-sum mode (!res): the deconv output alone (the caller passes a
  // zero bias and applies the outer site and the residual to the sum)
  bf16* outr = out + (size_t)row * L * C;
  const int n_out = min(lt, L - l0) * (C / 4);
  const bool outer = dp.on && res;
  for (int i = threadIdx.x; i < n_out; i += NT) {
    const int l = i / (C / 4), c0 = (i % (C / 4)) * 4;
    Philox4 w;
    if (outer) w = dropout_words(dp.seed, SITE_FFN_OUTER, dp.row0 + row, l0 + l, c0 >> 2, 0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + e;
      const size_t off = (size_t)(l0 + l) * C + c;
      float z = zs[l * S::LDZ + c] + bd[c];
      if (outer) z = w.w[e] < dp.thr ? z * dp.scale : 0.f;
      outr[off] = __float2bfloat16((res ? __bfloat162float(xr[off]) : 0.f) + z);
    }
  }
}

template <int C>
int launch(const bf16* x, const float* gamma, const bf16* wc, const float* bc,
           const bf16* wd, const float* bd, bf16* out, int R, int L, int I,
           int K, int groups, float eps, DropParams dp, bool res, cudaStream_t stream) {
  const int dpg = C / groups;
  const int lt = M - (K - 1);
  const int tiles = (L + lt - 1) / lt;
  const size_t smem = Lay<C>::bytes(K);
  cudaError_t e = cudaFuncSetAttribute(
      ffn_step_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  ffn_step_kernel<C><<<R * tiles, NT, smem, stream>>>(
      x, gamma, wc, bc, wd, bd, out, L, I, K, dpg, 1.f / sqrtf((float)dpg), eps,
      tiles, dp, res);
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
    float eps, int tiles, DropParams dp, bool res) {
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
    const bool outer = live && dp.on && res;   // dz = g in partial-sum mode
    if (outer) w = dropout_words(dp.seed, SITE_FFN_OUTER, dp.row0 + row, pos, c0 >> 2, 0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = 0.f;
      if (live) {
        v = __bfloat162float(gr[(size_t)pos * C + c0 + e]);
        if (outer) v = w.w[e] < dp.thr ? v * dp.scale : 0.f;
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

  // norm backward per (position, group), residual added (not in partial-
  // sum mode); xn and dz out
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
      const float v = gamma[cc] * dxn * inv - xv * k2 + (res ? __bfloat162float(gr[off + c]) : 0.f);
      dx[rowoff + off + c] = __float2bfloat16(v);
      zs[l * S::LDZ + cc] = dxn * xv * inv;  // dgamma summand
      xn_out[rowoff + off + c] = xs[(l + K - 1) * S::LDX + cc];
      dz_out[rowoff + off + c] = dzs[(l + K - 1) * S::LDX + cc];
    }
  }
  __syncthreads();
  // per-block partials: dgamma [C], then the deconv bias (sum of dz) [C],
  // zero in partial-sum mode (the caller's bias after the sum takes it)
  for (int c = threadIdx.x; c < 2 * C; c += NT) {
    float acc = 0.f;
    if (c < C) {
      for (int l = 0; l < n_valid; ++l) acc += zs[l * S::LDZ + c];
    } else if (res) {
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
               int S1, int S2, DropParams dp, bool res, cudaStream_t st) {
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
      1.f / sqrtf((float)dpg), eps, tiles, dp, res);
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

// ---------------------------------------------------------- Hopper route

namespace stp {

using namespace wgk;

constexpr int SICH = 64;   // inner channels per chunk (value and gate each)

// Byte offset of the 16-byte chunk j (channels 8j .. 8j+7) of row p in a
// tile of 64-channel atom columns (128-byte swizzle).
__device__ __forceinline__ int sw_off(int p, int j) {
  return (j / 8) * XCOL + p * 128 + (((j % 8) ^ (p % 8)) * 16);
}

// Forward: ring of stages of 256 C bytes | normed tile (two atom columns) |
// h [XR][64] | barriers.
template <int C>
struct FLay {
  static constexpr int SB = 256 * C;
  static constexpr int XS = 2 * XCOL;
  static constexpr int HS = XCOL;
  static constexpr int FIXED = 1024 + XS + HS;
  static constexpr int NS = ring_stages(FIXED, SB);
  static constexpr int BYTES = FIXED + NS * SB + (2 * NS + 1) * 8;
};

// dx kernel: ring | normed tile | dz tile | dyvg [XR][128] (two atom
// columns: value, gate) | barriers.  After the last chunk the ring holds the
// fp32 dxn rows [128][C + 4] for the norm's backward.
template <int C>
struct DLay {
  static constexpr int SB = 256 * C;
  static constexpr int FIXED = 1024 + 6 * XCOL;
  static constexpr int NS = ring_stages(FIXED, SB);
  static constexpr int BYTES = FIXED + NS * SB + (2 * NS + 1) * 8;
  static_assert(NS * SB >= MT * (C + 4) * 4, "the ring must hold the dxn rows");
};

// The R rows as one sequence of padded rows: flat position P = r Lin + j
// (Lin = L + 2(k-1)) holds position j - (k-1) of row r, and zero padding
// outside [k-1, k-1+L) and past the last row.  Tiles run over this
// sequence, so a tile packs the end of one row and the start of the next
// with their halos between them, and only 2(k-1) positions a row are
// computed for nothing: no near-empty last tile per row.  A conv output q
// of row r (flat r Lin + q) reads only its own row for q < L + k - 1, and
// the stored outputs read only those.
struct Flat {
  int R, L, Lin, K;   // R Lin < 2^31 (the launchers check)
  // Row and position of flat position P (the position may be padding).
  __device__ __forceinline__ int row(int P) const { return (int)((unsigned)P / (unsigned)Lin); }
  __device__ __forceinline__ int pos(int P) const { return P - row(P) * Lin - (K - 1); }
  // The index r L + pos of P's position in the [R, L] rows, or -1 for padding.
  __device__ __forceinline__ int src(int P) const {
    if ((unsigned)P >= (unsigned)(R * Lin)) return -1;
    const int r = row(P), ps = P - r * Lin - (K - 1);
    return ps >= 0 && ps < L ? r * L + ps : -1;
  }
};

// The 16-byte chunks (8 channels) of a tile's XR rows, each thread's issued
// as loads before any is stored: one load latency per tile, not one per
// chunk.
template <int C>
__host__ __device__ constexpr int tile_steps() { return (XR * (C / 8) + NTH - 1) / NTH; }

// Rows p < XR of a tile hold flat positions P0 + p of x [R, L, C]: x in
// 16-byte loads into the swizzled tile, the inverse RMS per (row, group)
// into ``inv`` (0 for padding; at most 16 groups of a multiple of 8
// channels) and gamma into ``gs`` (16-byte aligned), then x * inv * gamma
// rounded to bf16 in place.  Leaves the tile ready for wgmma (proxy fence)
// after the caller's barrier.
template <int C>
__device__ __forceinline__ void norm_tile(unsigned char* xt, float* inv, float* gs,
                                          const bf16* __restrict__ x, const Flat& f, int P0,
                                          const float* __restrict__ gamma, int dpg, float rdpg,
                                          float eps) {
  constexpr int NJ = C / 8, IT = tile_steps<C>();
  const int groups = C / dpg, cpg = dpg / 8;   // a group is whole 16-byte chunks
  uint4 v[IT];
#pragma unroll
  for (int u = 0; u < IT; ++u) {
    const int i = threadIdx.x + u * NTH;
    v[u] = make_uint4(0, 0, 0, 0);
    if (i < XR * NJ) {
      const int o = f.src(P0 + i / NJ);
      if (o >= 0) v[u] = __ldg((const uint4*)(x + (size_t)o * C + 8 * (i % NJ)));
    }
  }
  if (threadIdx.x < C) gs[threadIdx.x] = __ldg(gamma + threadIdx.x);
#pragma unroll
  for (int u = 0; u < IT; ++u) {
    const int i = threadIdx.x + u * NTH;
    if (i < XR * NJ) *(uint4*)(xt + sw_off(i / NJ, i % NJ)) = v[u];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < XR * groups; i += NTH) {
    const int p = i / groups, g = i % groups;
    float ss = 0.f;
    for (int jj = g * cpg; jj < (g + 1) * cpg; ++jj) {
      const uint4 v = *(const uint4*)(xt + sw_off(p, jj));
      const bf16* e = (const bf16*)&v;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float t = __bfloat162float(e[q]);
        ss += t * t;
      }
    }
    inv[i] = f.src(P0 + p) >= 0 ? 1.f / (sqrtf(ss) * rdpg + eps) : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < XR * NJ; i += NTH) {
    const int p = i / NJ, j = i % NJ;
    uint4* a = (uint4*)(xt + sw_off(p, j));
    uint4 v = *a;
    bf16* e = (bf16*)&v;
    const float s = inv[p * groups + j / cpg];
    const float4 g0 = *(const float4*)(gs + 8 * j), g1 = *(const float4*)(gs + 8 * j + 4);
    const float gm[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
    for (int q = 0; q < 8; ++q) e[q] = __float2bfloat16(__bfloat162float(e[q]) * s * gm[q]);
    *a = v;
  }
  fence_proxy_async();
}

// The conv of one chunk into y [m64 x (64 value | 64 gate)]: per tap one
// stage [C k][128 n] (MN-major, n-blocks of 64 at C*128 bytes), A the
// normed tile from row ``row0`` + t.
template <int C, int NS>
__device__ __forceinline__ void conv_chunk(float* y, uint32_t xt, int row0, int K,
                                           const Ring<NS>& ring, int& s, int& pending, int lane) {
  for (int t = 0; t < K; ++t) {
    const uint32_t sb = ring.wait(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk)
      wgmma_ss_kt_n128(y, tile_desc(xt, row0 + t, kk), desc_sw128(sb + kk * 2048, C * 128, 1024),
                       t || kk);
    wgmma_commit();
    ring.retire(s, pending, lane);
  }
}

// acc [m64 x C] += A[m64 x 16] B[16 x C], B K-major with C rows.
template <int C>
__device__ __forceinline__ void mma_nc(float* acc, uint64_t da, uint64_t db) {
  if constexpr (C == 96)
    wgmma_ss_n96(acc, da, db, 1);
  else
    wgmma_ss_n128(acc, da, db, 1);
}

template <int C>
__global__ void __launch_bounds__(NTH, 1) ffn_step_wg_kernel(
    const bf16* __restrict__ x, const float* __restrict__ gamma, const bf16* __restrict__ panels,
    const float* __restrict__ bc, const float* __restrict__ bd, bf16* __restrict__ out, Flat f,
    int nch, int dpg, float rdpg, float eps, DropParams dp, bool res) {
  using Y = FLay<C>;
  extern __shared__ __align__(1024) unsigned char smraw[];
  unsigned char* sm = aligned_smem(smraw);
  unsigned char* xs = sm + Y::NS * Y::SB;
  unsigned char* hs = xs + Y::XS;
  uint64_t* full = (uint64_t*)(hs + Y::HS);
  uint64_t* empty = full + Y::NS;
  uint64_t* xbar = empty + Y::NS;

  const int K = f.K;
  const int lt = MT - (K - 1);
  // tile row m <-> flat conv output (and staged row) Q0 + m; output row l
  // <-> flat position Q0 + l + k - 1
  const int Q0 = blockIdx.x * lt;
  const int K2 = (K + 1) / 2;
  const int tid = threadIdx.x;
  const Ring<Y::NS> ring{sm, full, empty, Y::SB, (const unsigned char*)panels,
                         (long long)nch * (K + K2)};
  prologue<Y::NS>(full, empty, xbar);
  for (int i = tid; i < (XR - MT) * 8; i += NTH)   // h rows past the tile: zeros
    *(uint4*)(hs + MT * 128 + i * 16) = make_uint4(0, 0, 0, 0);
  __syncthreads();
  if (tid == 0) ring.start();
  // the inverse RMS and gamma live in the h tile's rows until the first chunk
  norm_tile<C>(xs, (float*)hs, (float*)(hs + 12288), x, f, Q0, gamma, dpg, rdpg, eps);
  __syncthreads();

  const int cw = tid / 128, w = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, c = lane & 3;
  const int rbase = 64 * cw + 16 * w;
  const uint32_t xt = smem_u32(xs);
  int qrow[2], qpos[2];   // (row, conv position) of this thread's two tile rows
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int q = Q0 + rbase + g + 8 * hr;
    qrow[hr] = f.row(q);
    qpos[hr] = q - qrow[hr] * f.Lin;
  }
  float z[C / 2];
#pragma unroll
  for (int i = 0; i < C / 2; ++i) z[i] = 0.f;
  int s = 0, pending = -1;
  for (int ch = 0; ch < nch; ++ch) {
    float y[64];
    conv_chunk<C, Y::NS>(y, xt, 64 * cw, K, ring, s, pending, lane);
    ring.drain(pending, lane);   // y, and the previous chunk's deconv (it read h)
    fence_regs<64>(y);
    // one h tile: warpgroup 0's deconv reads rows 64 .. 64 + k-2 of warpgroup
    // 1's, so warpgroup 1 overwrites them once warpgroup 0 has drained
    if (ch > 0) {
      if (cw == 0)
        named_arrive(2, 256);
      else
        named_sync(2, 256);
    }
    // SwiGLU in fp32 with the inner mask; bf16 h rows, swizzled
    unsigned char* hb = hs;
    const float* bch = bc + ch * 2 * SICH;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = rbase + g + 8 * hr;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cl = 8 * j + 2 * c;
        Philox4 wd;
        if (dp.on)
          wd = dropout_words(dp.seed, SITE_FFN_INNER, dp.row0 + qrow[hr], qpos[hr],
                             (ch * SICH + cl) >> 2, 0);
        float h[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = y[4 * j + 2 * hr + e] + __ldg(bch + cl + e);
          const float gt = y[4 * (j + 8) + 2 * hr + e] + __ldg(bch + SICH + cl + e);
          h[e] = v * gt * sigmoid(gt);
          if (dp.on) h[e] = wd.w[(cl + e) & 3] < dp.thr ? h[e] * dp.scale : 0.f;
        }
        *(__nv_bfloat162*)(hb + m * 128 + ((j ^ (m % 8)) * 16) + 4 * c) =
            __floats2bfloat162_rn(h[0], h[1]);
      }
    }
    fence_proxy_async();   // the deconv reads h through the async proxy
    named_sync(1, 256);    // h rows of both warpgroups (the deconv's halo crosses them)
    // the deconv, z[l] += sum_t h[l + k-1 - t] Wd_t: per pair of taps one
    // stage [2][C n][64 k]
    const uint32_t ht = smem_u32(hb);
    for (int tp = 0; tp < K2; ++tp) {
      const uint32_t sb = ring.wait(s);
      wgmma_fence();
#pragma unroll
      for (int tt = 0; tt < 2; ++tt) {
        const int t = 2 * tp + tt;
        if (t < K) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            mma_nc<C>(z, kdesc(ht + (64 * cw + K - 1 - t) * 128 + kk * 32),
                      kdesc(sb + tt * C * 128 + kk * 32));
        }
      }
      wgmma_commit();
      ring.retire(s, pending, lane);
    }
  }
  ring.drain(pending, lane);
  fence_regs<C / 2>(z);
  // deconv bias, outer mask (position, channel) and residual, one rounding;
  // the residual rows' loads issued first.  Partial-sum mode (!res): the
  // deconv output alone (the caller passes a zero bias and applies the
  // outer site and the residual to the sum over shards)
  int so[2];
  __nv_bfloat162 xv[2][C / 8];
  const bool outer = dp.on && res;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int l = rbase + g + 8 * hr;
    so[hr] = l < lt ? f.src(Q0 + l + K - 1) : -1;
#pragma unroll
    for (int j = 0; j < C / 8; ++j)
      xv[hr][j] = res && so[hr] >= 0
                      ? *(const __nv_bfloat162*)(x + (size_t)so[hr] * C + 8 * j + 2 * c)
                      : __floats2bfloat162_rn(0.f, 0.f);
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (so[hr] < 0) continue;
    const int P = Q0 + rbase + g + 8 * hr + K - 1;
    const int r = f.row(P), o = f.pos(P);
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      const int col = 8 * j + 2 * c;
      float v0 = z[4 * j + 2 * hr] + __ldg(bd + col);
      float v1 = z[4 * j + 2 * hr + 1] + __ldg(bd + col + 1);
      if (outer) {
        const Philox4 wd = dropout_words(dp.seed, SITE_FFN_OUTER, dp.row0 + r, o, col >> 2, 0);
        v0 = wd.w[col & 3] < dp.thr ? v0 * dp.scale : 0.f;
        v1 = wd.w[(col + 1) & 3] < dp.thr ? v1 * dp.scale : 0.f;
      }
      const float2 xf = __bfloat1622float2(xv[hr][j]);
      *(__nv_bfloat162*)(out + (size_t)so[hr] * C + col) = __floats2bfloat162_rn(xf.x + v0, xf.y + v1);
    }
  }
}

// One block per tile of 128 flat conv positions Q0 .. Q0 + 127 of the row
// group (``Flat``).  It stores dx for the flat positions [Q0 + k-1, Q0 +
// k-1 + lt) that are outputs, and is the one block that writes the scratch
// rows [Q0, Q0 + lt) (the last tile: to the group's end, fewer than 128):
// xn and dz with their zero padding, dyvg and the dropped h (zero at conv
// positions >= L + k - 1 of a row).
template <int C>
__global__ void __launch_bounds__(NTH, 1) ffn_step_dx_wg_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ gin, const float* __restrict__ gamma,
    const bf16* __restrict__ panels, const float* __restrict__ bc, bf16* __restrict__ dx,
    bf16* __restrict__ sxn, bf16* __restrict__ sdz, bf16* __restrict__ sy, bf16* __restrict__ sh,
    float* __restrict__ part, Flat f, int nch, int dpg, float rdpg, float eps, DropParams dp,
    bool res) {
  using Y = DLay<C>;
  constexpr int NJ = C / 8;
  constexpr int LDZ = C + 4;
  extern __shared__ __align__(1024) unsigned char smraw[];
  unsigned char* sm = aligned_smem(smraw);
  unsigned char* xs = sm + Y::NS * Y::SB;
  unsigned char* zs = xs + 2 * XCOL;
  unsigned char* ys = zs + 2 * XCOL;
  uint64_t* full = (uint64_t*)(ys + 2 * XCOL);
  uint64_t* empty = full + Y::NS;
  uint64_t* xbar = empty + Y::NS;

  const int K = f.K;
  const int lt = MT - (K - 1);
  const int Q0 = blockIdx.x * lt;
  const int l1 = f.L + K - 1;
  const int own = blockIdx.x == gridDim.x - 1 ? f.R * f.Lin - Q0 : lt;   // scratch rows
  const int Ip = nch * SICH;
  const int K2 = (K + 1) / 2;
  const int tid = threadIdx.x;
  // per chunk: the conv's K stages, the deconv's K2 (dh), the conv's again (dx)
  const Ring<Y::NS> ring{sm, full, empty, Y::SB, (const unsigned char*)panels,
                         (long long)nch * (2 * K + K2), 2 * K + K2, K + K2};
  prologue<Y::NS>(full, empty, xbar);
  for (int i = tid; i < 2 * (XR - MT) * 8; i += NTH)   // dyvg rows past the tile: zeros
    *(uint4*)(ys + (i / ((XR - MT) * 8)) * XCOL + (MT + (i / 8) % (XR - MT)) * 128 +
              (i % 8) * 16) = make_uint4(0, 0, 0, 0);
  __syncthreads();
  if (tid == 0) ring.start();
  // the inverse RMS and gamma live in the dyvg tile's rows until the first chunk
  norm_tile<C>(xs, (float*)ys, (float*)(ys + 12288), x, f, Q0, gamma, dpg, rdpg, eps);
  // dz = g x outer mask x 1/(1-p), rounded to bf16, zero for padding (dz =
  // g in partial-sum mode)
  {
    constexpr int IT = tile_steps<C>();
    uint4 v[IT];
#pragma unroll
    for (int u = 0; u < IT; ++u) {
      const int i = tid + u * NTH;
      v[u] = make_uint4(0, 0, 0, 0);
      if (i < XR * NJ) {
        const int o = f.src(Q0 + i / NJ);
        if (o >= 0) v[u] = __ldg((const uint4*)(gin + (size_t)o * C + 8 * (i % NJ)));
      }
    }
#pragma unroll
    for (int u = 0; u < IT; ++u) {
      const int i = tid + u * NTH;
      if (i >= XR * NJ) continue;
      const int p = i / NJ, j = i % NJ;
      if (dp.on && res && f.src(Q0 + p) >= 0) {
        const int r = f.row(Q0 + p), pos = f.pos(Q0 + p);
        const Philox4 w0 = dropout_words(dp.seed, SITE_FFN_OUTER, dp.row0 + r, pos, 2 * j, 0);
        const Philox4 w1 = dropout_words(dp.seed, SITE_FFN_OUTER, dp.row0 + r, pos, 2 * j + 1, 0);
        bf16* e = (bf16*)&v[u];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const bool keep = (q < 4 ? w0.w[q] : w1.w[q - 4]) < dp.thr;
          e[q] = __float2bfloat16(keep ? __bfloat162float(e[q]) * dp.scale : 0.f);
        }
      }
      *(uint4*)(zs + sw_off(p, j)) = v[u];
    }
  }
  fence_proxy_async();
  __syncthreads();
  // the GEMM's C-side operands: xn and dz of the owned flat positions
  for (int i = tid; i < own * NJ; i += NTH) {
    const int m = i / NJ, j = i % NJ;
    const size_t off = (size_t)(Q0 + m) * C + 8 * j;
    *(uint4*)(sxn + off) = *(const uint4*)(xs + sw_off(m, j));
    *(uint4*)(sdz + off) = *(const uint4*)(zs + sw_off(m, j));
  }

  const int cw = tid / 128, w = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, c = lane & 3;
  const int rbase = 64 * cw + 16 * w;
  const uint32_t xt = smem_u32(xs), zt = smem_u32(zs), yt = smem_u32(ys);
  int qrow[2], qpos[2];   // (row, conv position) of this thread's two tile rows
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int q = Q0 + rbase + g + 8 * hr;
    qrow[hr] = f.row(q);
    qpos[hr] = q - qrow[hr] * f.Lin;
  }
  float acc[C / 2];
#pragma unroll
  for (int i = 0; i < C / 2; ++i) acc[i] = 0.f;
  int s = 0, pending = -1;
  for (int ch = 0; ch < nch; ++ch) {
    // the conv again, and dh [m64 x 64 inner] = sum_t dz[m + t] Wd_t^T:
    // per pair of taps one stage [2][C k][64 n]
    float y[64], dh[32];
    conv_chunk<C, Y::NS>(y, xt, 64 * cw, K, ring, s, pending, lane);
    for (int tp = 0; tp < K2; ++tp) {
      const uint32_t sb = ring.wait(s);
      wgmma_fence();
#pragma unroll
      for (int tt = 0; tt < 2; ++tt) {
        const int t = 2 * tp + tt;
        if (t < K) {
#pragma unroll
          for (int kk = 0; kk < C / 16; ++kk)
            wgmma_ss_kt_n64(dh, tile_desc(zt, 64 * cw + t, kk),
                            desc_sw128(sb + tt * C * 128 + kk * 2048, C * 128, 1024),
                            tp || tt || kk);
        }
      }
      wgmma_commit();
      ring.retire(s, pending, lane);
    }
    ring.drain(pending, lane);   // also the previous chunk's dx products, which read dyvg
    fence_regs<64>(y);
    fence_regs<32>(dh);
    named_sync(1, 256);   // both warpgroups are done with the previous dyvg
    // SwiGLU backward in fp32 through the inner mask: dyvg (bf16, swizzled)
    // into shared memory, the dropped h straight to the scratch (owned rows)
    const float* bch = bc + ch * 2 * SICH;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = rbase + g + 8 * hr;
      const bool live = qrow[hr] < f.R && qpos[hr] < l1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cl = 8 * j + 2 * c;
        Philox4 wd;
        if (dp.on && live)
          wd = dropout_words(dp.seed, SITE_FFN_INNER, dp.row0 + qrow[hr], qpos[hr],
                             (ch * SICH + cl) >> 2, 0);
        float dv[2] = {0.f, 0.f}, dg[2] = {0.f, 0.f}, hv[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (live) {
            float sc = 1.f;
            if (dp.on) sc = wd.w[(cl + e) & 3] < dp.thr ? dp.scale : 0.f;
            const float v = y[4 * j + 2 * hr + e] + __ldg(bch + cl + e);
            const float gt = y[4 * (j + 8) + 2 * hr + e] + __ldg(bch + SICH + cl + e);
            swiglu_bwd(v, gt, dh[4 * j + 2 * hr + e], sc, dv[e], dg[e]);
            hv[e] = v * gt * sigmoid(gt) * sc;
          }
        }
        unsigned char* yr = ys + m * 128 + ((j ^ (m % 8)) * 16) + 4 * c;
        *(__nv_bfloat162*)yr = __floats2bfloat162_rn(dv[0], dv[1]);
        *(__nv_bfloat162*)(yr + XCOL) = __floats2bfloat162_rn(dg[0], dg[1]);
        if (m < own)
          *(__nv_bfloat162*)(sh + (size_t)(Q0 + m) * Ip + ch * SICH + cl) =
              __floats2bfloat162_rn(hv[0], hv[1]);
      }
    }
    fence_proxy_async();   // the products read dyvg through the async proxy
    named_sync(1, 256);    // dyvg rows of both warpgroups
    // the owned rows of dyvg to the scratch, 16 bytes a thread-step
    for (int i = tid; i < own * 16; i += NTH) {
      const int m = i / 16, j = i % 16;
      *(uint4*)(sy + (size_t)(Q0 + m) * 2 * Ip + ch * 2 * SICH + 8 * j) =
          *(const uint4*)(ys + sw_off(m, j));
    }
    // dxn[l] += sum_t dyvg[l + k-1 - t] Wc_t^T: the conv's stage of tap t
    // read as [C n][128 k]
    for (int t = 0; t < K; ++t) {
      const uint32_t sb = ring.wait(s);
      wgmma_fence();
#pragma unroll
      for (int ko = 0; ko < 8; ++ko)
        mma_nc<C>(acc, kdesc(yt + (ko / 4) * XCOL + (64 * cw + K - 1 - t) * 128 + (ko % 4) * 32),
                  kdesc(sb + (ko / 4) * C * 128 + (ko % 4) * 32));
      wgmma_commit();
      ring.retire(s, pending, lane);
    }
  }
  ring.drain(pending, lane);
  fence_regs<C / 2>(acc);
  __syncthreads();   // every warp is done with the ring: it holds dxn now
  float* zsm = (float*)sm;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int m = rbase + g + 8 * hr;
#pragma unroll
    for (int j = 0; j < C / 8; ++j)
      *(float2*)(zsm + m * LDZ + 8 * j + 2 * c) = make_float2(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
  }
  __syncthreads();
  // the norm's backward per (output, group), the residual added (not in
  // partial-sum mode); output row l is flat position Q0 + l + k - 1
  // (padding: no output)
  const int groups = C / dpg;
  for (int item = tid; item < lt * groups; item += NTH) {
    const int l = item / groups, gi = item % groups;
    const int so = f.src(Q0 + l + K - 1);
    if (so < 0) {
      for (int cc = 0; cc < dpg; ++cc) zsm[l * LDZ + gi * dpg + cc] = 0.f;
      continue;
    }
    const size_t off = (size_t)so * C + gi * dpg;
    float ss = 0.f, tsum = 0.f;
    for (int cc = 0; cc < dpg; ++cc) {
      const float xv = __bfloat162float(x[off + cc]);
      ss += xv * xv;
      tsum += __ldg(gamma + gi * dpg + cc) * zsm[l * LDZ + gi * dpg + cc] * xv;
    }
    const float r = sqrtf(ss) * rdpg;
    const float inv = 1.f / (r + eps);
    const float k2 = r > 0.f ? tsum * inv * inv / (dpg * r) : 0.f;
    for (int cc = 0; cc < dpg; ++cc) {
      const int col = gi * dpg + cc;
      const float xv = __bfloat162float(x[off + cc]);
      const float dxn = zsm[l * LDZ + col];
      dx[off + cc] =
          __float2bfloat16(__ldg(gamma + col) * dxn * inv - xv * k2 +
                           (res ? __bfloat162float(gin[off + cc]) : 0.f));
      zsm[l * LDZ + col] = dxn * xv * inv;   // dgamma summand
    }
  }
  __syncthreads();
  // per-block partials over the outputs: dgamma [C] (padding rows hold 0),
  // then the deconv bias (sum of dz: its padding rows are zero) [C], zero
  // in partial-sum mode (the caller's bias after the sum takes it)
  for (int col = tid; col < 2 * C; col += NTH) {
    float a = 0.f;
    if (col < C) {
      for (int l = 0; l < lt; ++l) a += zsm[l * LDZ + col];
    } else if (res) {
      const int cc = col - C;
      for (int l = 0; l < lt; ++l)
        a += __bfloat162float(*(const bf16*)(zs + sw_off(l + K - 1, cc / 8) + (cc % 8) * 2));
    }
    part[(size_t)blockIdx.x * 2 * C + col] = a;
  }
}

// Tiles over the flat positions of R rows: their outputs k-1 .. R Lin - 1.
inline int flat_tiles(const Flat& f) {
  const int lt = MT - (f.K - 1);
  return (int)(((long long)f.R * f.Lin - (f.K - 1) + lt - 1) / lt);
}

template <int C>
int launch_fwd(const bf16* x, const float* gamma, const bf16* panels, const float* bc,
               const float* bd, bf16* out, int R, int L, int Ip, int K, int groups, float eps,
               DropParams dp, bool res, cudaStream_t st) {
  const int dpg = C / groups;
  const Flat f{R, L, L + 2 * (K - 1), K};
  const int smem = FLay<C>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(ffn_step_wg_kernel<C>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  ffn_step_wg_kernel<C><<<flat_tiles(f), NTH, smem, st>>>(
      x, gamma, panels, bc, bd, out, f, Ip / SICH, dpg, 1.f / sqrtf((float)dpg), eps, dp, res);
  return (int)cudaGetLastError();
}

// The GEMM's C side is taps of CG channels: C rounded up to 128.
constexpr int CG = 128;
// Blocks' dgamma / deconv-bias partials summed per segment of PSEG first.
constexpr int PSEG = 64;

template <int C>
int launch_bwd(const bf16* x, const bf16* g, const float* gamma, const bf16* panels,
               const float* bc, bf16* dx, bf16* sxn, bf16* sdz, bf16* sy, bf16* sh, float* part,
               float* pmid, float* wpart, float* bpart, float* out_w, float* out_b,
               float* out_gb, int R, int L, int Ip, int K, int groups, float eps, int Rg, int S,
               DropParams dp, bool res, cudaStream_t st) {
  const int dpg = C / groups;
  const int Lin = L + 2 * (K - 1);
  const int smem = DLay<C>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(ffn_step_dx_wg_kernel<C>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if ((e = gemm_attr()) != cudaSuccess) return (int)e;
  int blocks = 0;   // the blocks of the earlier groups: their partials come first
  for (int r0 = 0; r0 < R; r0 += Rg) {
    const int rows = R - r0 < Rg ? R - r0 : Rg;
    DropParams dpr = dp;
    dpr.row0 = dp.row0 + r0;
    const size_t off = (size_t)r0 * L * C;
    const Flat f{rows, L, Lin, K};
    ffn_step_dx_wg_kernel<C><<<flat_tiles(f), NTH, smem, st>>>(
        x + off, g + off, gamma, panels, bc, dx + off, sxn, sdz, sy, sh,
        part + (size_t)blocks * 2 * C, f, Ip / SICH, dpg, 1.f / sqrtf((float)dpg), eps, dpr,
        res);
    blocks += flat_tiles(f);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    // maps over this group's rows only: boxes past them read zeros
    const long long Q = (long long)rows * Lin;
    CUtensorMap ax, ag;
    if ((e = make_map_2d(&ax, sxn, Q, C, C)) != cudaSuccess) return (int)e;
    if ((e = make_map_2d(&ag, sdz, Q, C, C)) != cudaSuccess) return (int)e;
    if ((e = gemm_group(ax, ag, sy, sh, Q, CG, Ip, K, S, wpart, bpart, 0, r0 > 0, st)) !=
        cudaSuccess)
      return (int)e;
  }
  if ((e = wg::launch_reduce(wpart, out_w, 1, S, (long long)K * CG * 3 * Ip, st)) != cudaSuccess)
    return (int)e;
  if ((e = wg::launch_reduce(bpart, out_b, 1, S, 2LL * Ip, st)) != cudaSuccess) return (int)e;
  // the blocks' partials in segments of PSEG (the wrapper zeroes the rows
  // past the last block's), then the segments, each sum in a fixed order
  const int segs = (blocks + PSEG - 1) / PSEG;
  if ((e = wg::launch_reduce(part, pmid, segs, PSEG, 2 * C, st)) != cudaSuccess) return (int)e;
  return (int)wg::launch_reduce(pmid, out_gb, 1, segs, 2 * C, st);
}

}  // namespace stp

}  // namespace

#define FFN_SWITCH(C, CASE)        \
  switch (C) {                     \
    CASE(32)                       \
    CASE(64)                       \
    default:                       \
      return (int)cudaErrorInvalidValue; \
  }

// Dynamic shared memory of the forward and, with training, the largest of
// it and the backward's kernels at width C and K taps: the Hopper route's
// (stp::FLay, stp::DLay, the GEMM) at C 96 and 128, else Lay<C> and
// BLay<C>; 0 for a width with no instantiation.
// ops/cuda/swiglu_block.py::step_bytes computes the same in Python for the
// block's gate; the card tests hold the two against each other.
extern "C" long long ffn_step_smem_bytes(int C, int K, int training) {
#define FFN_WG_BYTES_CASE(CC)                                                       \
  case CC: {                                                                        \
    long long b = stp::FLay<CC>::BYTES;                                             \
    if (training) {                                                                 \
      if (stp::DLay<CC>::BYTES > b) b = stp::DLay<CC>::BYTES;                       \
      if (wgk::GEMM_BYTES > b) b = wgk::GEMM_BYTES;                                 \
    }                                                                               \
    return b;                                                                       \
  }
#define FFN_BYTES_CASE(CC)                                              \
  case CC: {                                                            \
    const size_t f = Lay<CC>::bytes(K), b = BLay<CC>::bytes(K);         \
    return (long long)(training && b > f ? b : f);                      \
  }
  switch (C) {
    FFN_BYTES_CASE(32)
    FFN_BYTES_CASE(64)
    FFN_WG_BYTES_CASE(96)
    FFN_WG_BYTES_CASE(128)
    default:
      return 0;
  }
#undef FFN_BYTES_CASE
#undef FFN_WG_BYTES_CASE
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

// The mma.sync route (C 32, 64).  x, out [R, L, C] bf16; gamma [C] fp32;
// wc [I/32][K*C][64] bf16 (per chunk: rows tap-major t*C + c, columns 32
// value then 32 gate channels); bc [I/32][64] fp32; wd [I/32][K][32][C]
// bf16; bd [C] fp32.  I % 32 == 0, 2 <= K <= 8 (the wrapper checks).
// Dropout: seed, the keep threshold, the absolute row of x's first row,
// 1/(1-p), on (0 at p = 0).  residual 0: the partial-sum mode (below).
extern "C" int ffn_step_forward(const void* x, const void* gamma, const void* wc,
                                const void* bc, const void* wd, const void* bd,
                                void* out, int R, int L, int C, int I, int K,
                                int groups, float eps, unsigned seed,
                                unsigned thr, unsigned row0, float scale,
                                int on, int residual, void* stream) {
  const DropParams dp = drop_params(seed, thr, row0, scale, on);
#define FFN_CASE(CC)                                                          \
  case CC:                                                                    \
    return launch<CC>((const bf16*)x, (const float*)gamma, (const bf16*)wc,   \
                      (const float*)bc, (const bf16*)wd, (const float*)bd,    \
                      (bf16*)out, R, L, I, K, groups, eps, dp, residual != 0, \
                      (cudaStream_t)stream);
  FFN_SWITCH(C, FFN_CASE)
#undef FFN_CASE
}

// Backward of the mma.sync route.  Inputs as the forward's, g [R, L, C]
// bf16 the output's cotangent.  Outputs: dx [R, L, C] bf16; out_c [K][2I
// pad 64][C] fp32 (the conv weight gradient, tap-major), out_cb [2I pad 64]
// (conv bias), out_d [K][I pad 64][C] (deconv weight), out_gb [2C]
// (dgamma, then the deconv bias).  Scratch: xn, dz [R, L, C] and dy [R,
// L+K-1, 2I], hd [R, L+K-1, I] bf16; part [R*tiles][2C], wpart_c
// [K][S1][2I pad][C], colsum_c [S1][2I pad], wpart_d [K][S2][I pad][C] fp32.
extern "C" int ffn_step_backward(
    const void* x, const void* g, const void* gamma, const void* wc,
    const void* bc, const void* wd, void* dx, void* xn, void* dz, void* dy,
    void* hd, void* part, void* wpart_c, void* colsum_c, void* wpart_d,
    void* out_c, void* out_cb, void* out_d, void* out_gb, int R, int L, int C,
    int I, int K, int groups, float eps, int S1, int S2, unsigned seed,
    unsigned thr, unsigned row0, float scale, int on, int residual, void* stream) {
  const DropParams dp = drop_params(seed, thr, row0, scale, on);
#define FFN_BWD_CASE(CC)                                                           \
  case CC:                                                                         \
    return launch_bwd<CC>(                                                         \
        (const bf16*)x, (const bf16*)g, (const float*)gamma, (const bf16*)wc,      \
        (const float*)bc, (const bf16*)wd, (bf16*)dx, (bf16*)xn, (bf16*)dz,        \
        (bf16*)dy, (bf16*)hd, (float*)part, (float*)wpart_c, (float*)colsum_c,     \
        (float*)wpart_d, (float*)out_c, (float*)out_cb, (float*)out_d,             \
        (float*)out_gb, R, L, I, K, groups, eps, S1, S2, dp, residual != 0,            \
        (cudaStream_t)stream);
  FFN_SWITCH(C, FFN_BWD_CASE)
#undef FFN_BWD_CASE
}

// The Hopper route's forward (#2) at C 96 or 128.  x, out [R, L, C] bf16;
// gamma [C] fp32; panels: per 64-channel chunk K + ceil(K/2) stages of 256 C
// bytes (ops/cuda/swiglu_block.py::wg_step_panels): per tap the conv's [C
// k][128 n] (64 value, then 64 gate channels), then per pair of taps the
// deconv's [2][C n][64 k], each 128-byte swizzled; bc [Ip/64][128] fp32;
// bd [C] fp32.  Ip (the padded inner width) % 64 == 0, 2 <= K <= 8, at
// most 16 groups of a multiple of 8 channels, R (L + 2(K-1)) < 2^31.
extern "C" int ffn_step_wg_forward(const void* x, const void* gamma, const void* panels,
                                   const void* bc, const void* bd, void* out, int R, int L,
                                   int C, int Ip, int K, int groups, float eps, unsigned seed,
                                   unsigned thr, unsigned row0, float scale, int on,
                                   int residual, void* stream) {
  if (Ip % 64 || Ip < 64 || K < 2 || K > 8 || R < 1 || L < 1 || groups < 1 || groups > 16 ||
      C % groups || (C / groups) % 8 || (long long)R * (L + 2 * (K - 1)) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const DropParams dp = drop_params(seed, thr, row0, scale, on);
  const cudaStream_t st = (cudaStream_t)stream;
#define WG_FWD(CC)                                                                           \
  return stp::launch_fwd<CC>((const bf16*)x, (const float*)gamma, (const bf16*)panels,       \
                             (const float*)bc, (const float*)bd, (bf16*)out, R, L, Ip, K,    \
                             groups, eps, dp, residual != 0, st);
  if (C == 96) WG_FWD(96)
  if (C == 128) WG_FWD(128)
#undef WG_FWD
  return (int)cudaErrorInvalidValue;
}

// The Hopper route's backward (#5) at C 96 or 128, in row groups of Rg
// rows.  x, g (the output's cotangent), dx [R, L, C] bf16; gamma, panels,
// bc as the forward's.  Scratch (bf16, Lin = L + 2(K-1)): sxn, sdz [Rg,
// Lin, C], sy [Rg, Lin, 2 Ip], sh [Rg, Lin, Ip]; fp32: part [the dx
// blocks of every group, rounded up to 64][2C] (the rows past the last
// block's zero), pmid [that / 64][2C], wpart [S][K 128][3 Ip], bpart [S][2
// Ip].  Out: out_w [K 128][3 Ip] (rows
// t*128 + c; dWc in columns [0, 2 Ip), chunk-major: 64 value then 64 gate;
// dWd^T in [2 Ip, 3 Ip)), out_b [2 Ip] (conv bias, same order), out_gb
// [2C] (dgamma, then the deconv bias).
extern "C" int ffn_step_wg_backward(const void* x, const void* g, const void* gamma,
                                    const void* panels, const void* bc, void* dx, void* sxn,
                                    void* sdz, void* sy, void* sh, void* part, void* pmid,
                                    void* wpart, void* bpart, void* out_w, void* out_b,
                                    void* out_gb, int R,
                                    int L, int C, int Ip, int K, int groups, float eps, int Rg,
                                    int S, unsigned seed, unsigned thr, unsigned row0,
                                    float scale, int on, int residual, void* stream) {
  if (Ip % 64 || Ip < 64 || K < 2 || K > 8 || R < 1 || L < 1 || Rg < 1 || S < 1 ||
      groups < 1 || groups > 16 || C % groups || (C / groups) % 8 ||
      (long long)Rg * (L + 2 * (K - 1)) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const DropParams dp = drop_params(seed, thr, row0, scale, on);
  const cudaStream_t st = (cudaStream_t)stream;
#define WG_BWD(CC)                                                                           \
  return stp::launch_bwd<CC>((const bf16*)x, (const bf16*)g, (const float*)gamma,            \
                             (const bf16*)panels, (const float*)bc, (bf16*)dx, (bf16*)sxn,   \
                             (bf16*)sdz, (bf16*)sy, (bf16*)sh, (float*)part, (float*)pmid,   \
                             (float*)wpart, (float*)bpart, (float*)out_w, (float*)out_b,     \
                             (float*)out_gb, R, L, Ip, K, groups, eps, Rg, S, dp,           \
                             residual != 0, st);
  if (C == 96) WG_BWD(96)
  if (C == 128) WG_BWD(128)
#undef WG_BWD
  return (int)cudaErrorInvalidValue;
}
