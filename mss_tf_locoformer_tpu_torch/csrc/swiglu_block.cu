// Fused macaron FFN step:  out = x + Deconv1d(SwiGLU(Conv1d(RMSGroupNorm(x))))
//
// Replaces the JAX package's Pallas kernel
// ``ops/pallas/swiglu_block.py::_blk_forward`` (body ``_blk_kernel``), public
// ``fused_norm_ffn_residual``, forward at dropout 0 (inference).
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
#include <cuda_runtime.h>
#include <mma.h>

#include "rmsgroupnorm.cuh"

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
    float eps, int tiles) {
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

    // SwiGLU in fp32, h rounded to bf16 for the deconv product
    for (int i = threadIdx.x; i < M * IC; i += NT) {
      const int m = i / IC, c = i % IC;
      const float v = ys[m * S::LDY + c] + bcs[c];
      const float g = ys[m * S::LDY + IC + c] + bcs[IC + c];
      hs[m * S::LDH + c] = __float2bfloat16(v * (g / (1.f + __expf(-g))));
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

  bf16* outr = out + (size_t)row * L * C;
  const int n_out = min(lt, L - l0) * C;
  for (int i = threadIdx.x; i < n_out; i += NT) {
    const int l = i / C, c = i % C;
    const size_t off = (size_t)(l0 + l) * C + c;
    const float v = __bfloat162float(xr[off]) + zs[l * S::LDZ + c] + bd[c];
    outr[off] = __float2bfloat16(v);
  }
}

template <int C>
int launch(const bf16* x, const float* gamma, const bf16* wc, const float* bc,
           const bf16* wd, const float* bd, bf16* out, int R, int L, int I,
           int K, int groups, float eps, cudaStream_t stream) {
  const int dpg = C / groups;
  const int lt = M - (K - 1);
  const int tiles = (L + lt - 1) / lt;
  const size_t smem = Lay<C>::bytes(K);
  cudaError_t e = cudaFuncSetAttribute(
      ffn_step_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  ffn_step_kernel<C><<<R * tiles, NT, smem, stream>>>(
      x, gamma, wc, bc, wd, bd, out, L, I, K, dpg, 1.f / sqrtf((float)dpg), eps,
      tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out [R, L, C] bf16; gamma [C] fp32; wc [I/32][K*C][64] bf16 (per chunk:
// rows tap-major t*C + c, columns 32 value then 32 gate channels); bc [I/32][64]
// fp32; wd [I/32][K][32][C] bf16; bd [C] fp32.  C in {32, 64, 96, 128},
// I % 32 == 0, 2 <= K <= 8 (the wrapper checks).
extern "C" int ffn_step_forward(const void* x, const void* gamma, const void* wc,
                                const void* bc, const void* wd, const void* bd,
                                void* out, int R, int L, int C, int I, int K,
                                int groups, float eps, void* stream) {
#define FFN_CASE(CC)                                                          \
  case CC:                                                                    \
    return launch<CC>((const bf16*)x, (const float*)gamma, (const bf16*)wc,   \
                      (const float*)bc, (const bf16*)wd, (const float*)bd,    \
                      (bf16*)out, R, L, I, K, groups, eps, (cudaStream_t)stream);
  switch (C) {
    FFN_CASE(32)
    FFN_CASE(64)
    FFN_CASE(96)
    FFN_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FFN_CASE
}
