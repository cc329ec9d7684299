// FFN core:  z = ConvTranspose1d(drop(SwiGLU(Conv1d(x)))) + bias  on pre-padded rows
//
// Replaces the JAX package's Pallas kernel
// ``ops/pallas/swiglu_ffn.py::_forward`` (body ``_kernel``), public
// ``swiglu_conv_deconv``: no norm, no residual, no outer dropout (the caller
// crops and applies those).  The inner dropout site is the one the FFN-step
// kernel uses (``SITE_FFN_INNER`` of ``philox.cuh``, keyed by absolute row,
// conv position and inner channel), so the two routes draw the same masks.
//
// Shapes: x [R, Lin, C] bf16, rows already zero-padded by k-1 on each side
// (Lin = L + 2(k-1)); Conv1d(C -> 2I, k, stride 1, no padding) gives l1 =
// Lin - k + 1 conv outputs, h = y[:I] * silu(y[I:]), and the stride-1
// ConvTranspose1d(I -> C, k) gives the full length Lin back, plus its bias.
// C a multiple of 16 up to 256, I a multiple of 32, 2 <= k <= 8.  xlarge:
// C 256, I 1024, k 4, on the time path [4098, 351, 256] and the freq path
// [690, 2055, 256].
//
// What bounds it on the H100: the two products, 6*k*C*I FLOP per conv
// position (6.29 MFLOP at xlarge, 8.9 TFLOP per call on either path) against
// 4 bytes x C read and written per position: tensor-core arithmetic, as long
// as the [Lin, 2I] intermediate (2048 wide at xlarge) never goes to device
// memory.  The design is the FFN-step kernel's (``swiglu_block.cu``) without
// the norm prologue, the residual and the outer site, re-laid out so that
// C = 256 fits a block's shared memory, on mma.sync m16n8k16 (bf16 in, fp32
// accumulate) with ldmatrix fragment loads:
//   * one block per (row, tile of 64 conv outputs) -> 64-k+1 outputs stored;
//   * the tile's x rows plus a k-1 halo are staged in shared memory as they
//     are (zero outside [0, Lin));
//   * the inner dimension runs in chunks of 64 value + 64 gate channels (I
//     zero-padded to a multiple of 64 by the wrapper); the conv runs tap by
//     tap, each tap's [C, 128] panel staged alone (70 KB at C 256, where the
//     FFN-step kernel's all-taps panel takes 147 KB); each warp computes 32
//     conv outputs x 16 inner channels, their value AND gate columns, so
//     SwiGLU runs in fp32 on the accumulators in registers (conv positions
//     outside [0, l1) give h = 0) and only the bf16 [64, 64] h tile goes to
//     shared memory;
//   * the deconv runs tap by tap too, each tap's [64, C] panel staged alone,
//     into fp32 accumulators that stay in registers across all chunks, each
//     warp 32 rows x every fourth 8-wide column tile (8 tiles at C 256);
//   * epilogue: bias in fp32, one rounding to bf16, straight from the
//     accumulators to device memory; the ragged tail masked.
// Row strides are 8 bf16 past a multiple of 64 bytes, so that the eight
// 16-byte rows of every ldmatrix fall in distinct banks.  C is a template
// parameter (every multiple of 16 up to 256), so the loops over C unroll.
// 157,696 bytes of shared memory at C 256 whatever k; weights are re-read
// from L2 by every block (~6 MB per block at xlarge); several tiles per
// block, TMA and wgmma are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int M = 64;         // conv outputs (h rows) per tile
constexpr int ROWS = M + 16;  // staged x rows and h rows (halo, zeros)
constexpr int IC = 64;        // inner channels per chunk (value and gate each)
constexpr int NW = 8;         // warps per block: 2 row halves x 4 column quarters
constexpr int NT = NW * 32;

struct CoreLay {
  int LDX, LDH, LDW, LDD;
  size_t xs, hs, wc, wd, bc;
  __host__ __device__ explicit CoreLay(int C)
      : LDX(C + 8), LDH(IC + 8), LDW(2 * IC + 8), LDD(C + 8),
        xs((size_t)ROWS * (C + 8) * 2), hs((size_t)ROWS * (IC + 8) * 2),
        wc((size_t)C * (2 * IC + 8) * 2), wd((size_t)IC * (C + 8) * 2),
        bc((size_t)2 * IC * 4) {}
  __host__ __device__ size_t bytes() const { return xs + hs + wc + wd + bc; }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// A fragment of m16n8k16 (rows 0-15 x k 0-15 of a row-major tile whose row
// r starts at base + r * ld): lane l supplies row l % 16, column (l / 16) * 8.
__device__ __forceinline__ void ld_a(uint32_t* a, const bf16* base, int ld, int lane) {
  const uint32_t addr = smem_addr(base + (lane % 16) * ld + (lane / 16) * 8);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr));
}

// B fragments of two adjacent 8-wide column tiles (k 0-15) from a row-major
// [k][n] tile: b[0], b[1] for columns 0-7, b[2], b[3] for columns 8-15.
__device__ __forceinline__ void ld_b2(uint32_t* b, const bf16* base, int ld, int lane) {
  const uint32_t addr = smem_addr(base + (lane % 16) * ld + (lane / 16) * 8);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3]) : "r"(addr));
}

// B fragment of one 8-wide column tile (k 0-15) from a row-major [k][n] tile.
__device__ __forceinline__ void ld_b1(uint32_t* b, const bf16* base, int ld, int lane) {
  const uint32_t addr = smem_addr(base + (lane % 16) * ld);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1]) : "r"(addr));
}

// d[16x8] += a[16x16] b[16x8]; lane 4g + c holds d rows g, g+8 x cols 2c, 2c+1.
__device__ __forceinline__ void mma(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int C>
__global__ void __launch_bounds__(NT) ffn_core_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ wc,
    const float* __restrict__ bc, const bf16* __restrict__ wd,
    const float* __restrict__ bd, bf16* __restrict__ out, int Lin, int I, int K,
    int tiles, DropParams dp) {
  constexpr int N8 = C / 8;             // 8-wide column tiles of the output
  constexpr int NQ = (N8 + 3) / 4;      // of them per warp column quarter
  const CoreLay S(C);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = (bf16*)smem;
  bf16* hs = (bf16*)(smem + S.xs);
  bf16* wcs = (bf16*)(smem + S.xs + S.hs);
  bf16* wds = (bf16*)(smem + S.xs + S.hs + S.wc);
  float* bcs = (float*)(smem + S.xs + S.hs + S.wc + S.wd);

  const int row = blockIdx.x / tiles;
  const int lt = M - (K - 1);       // outputs stored per tile
  const int j0 = (blockIdx.x % tiles) * lt;
  const int p0 = j0 - (K - 1);      // conv position of h row 0 = x position of xs row 0
  const int l1 = Lin - K + 1;       // conv outputs
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c = lane & 3;
  const int wr = warp / 4, wq = warp % 4;  // 32-row half, column quarter
  const bf16* xr = x + (size_t)row * Lin * C;

  constexpr int VC = C / 8;         // 16-byte vectors per x row
  for (int i = threadIdx.x; i < ROWS * VC; i += NT) {
    const int r = i / VC, c8 = i % VC;
    const int pos = p0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (pos >= 0 && pos < Lin) val = *(const uint4*)(xr + (size_t)pos * C + c8 * 8);
    *(uint4*)(xs + r * S.LDX + c8 * 8) = val;
  }
  // h rows >= M feed only outputs that are never stored: keep them zero
  for (int i = threadIdx.x; i < (ROWS - M) * S.LDH; i += NT)
    hs[M * S.LDH + i] = __float2bfloat16(0.f);

  float z[2][NQ][4];                // deconv accumulators: rows wr*32 + 16i, tiles wq + 4q
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int q = 0; q < NQ; ++q) z[i][q][0] = z[i][q][1] = z[i][q][2] = z[i][q][3] = 0.f;

  const int n_chunks = I / IC;
  for (int ch = 0; ch < n_chunks; ++ch) {
    // conv, tap by tap: y[m, col] = sum_t sum_c x[m + t, c] * W[t][c, col];
    // the warp's tile: rows wr*32 .. +32 x inner channels wq*16 .. +16, as
    // value columns (yv) and gate columns (yg)
    float yv[2][2][4], yg[2][2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) yv[i][j][e] = yg[i][j][e] = 0.f;
    for (int t = 0; t < K; ++t) {
      __syncthreads();  // every warp is done with the previous panel (and h)
      const bf16* wg = wc + ((size_t)ch * K + t) * C * 2 * IC;
      constexpr int VW = 2 * IC / 8;
      for (int i = threadIdx.x; i < C * VW; i += NT) {
        const int r = i / VW, c8 = i % VW;
        *(uint4*)(wcs + r * S.LDW + c8 * 8) = *(const uint4*)(wg + (size_t)r * 2 * IC + c8 * 8);
      }
      if (t == 0 && threadIdx.x < 2 * IC) bcs[threadIdx.x] = bc[ch * 2 * IC + threadIdx.x];
      __syncthreads();
#pragma unroll
      for (int kc = 0; kc < C / 16; ++kc) {
        uint32_t a[2][4], bv[4], bg[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ld_a(a[i], xs + (wr * 32 + 16 * i + t) * S.LDX + kc * 16, S.LDX, lane);
        ld_b2(bv, wcs + kc * 16 * S.LDW + wq * 16, S.LDW, lane);
        ld_b2(bg, wcs + kc * 16 * S.LDW + IC + wq * 16, S.LDW, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            mma(yv[i][j], a[i], bv + 2 * j);
            mma(yg[i][j], a[i], bg + 2 * j);
          }
      }
    }

    // SwiGLU in fp32 on the accumulators, h = 0 off [0, l1), inner dropout
    // (conv position, inner channel), h rounded to bf16 into shared memory
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int m = wr * 32 + 16 * i + g + 8 * hr;
        const int p = p0 + m;
        const bool live = p >= 0 && p < l1;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int cl = wq * 16 + 8 * j + 2 * c;   // channel within the chunk
          float h[2];
          Philox4 w;
          if (dp.on && live)
            w = dropout_words(dp.seed, SITE_FFN_INNER, dp.row0 + row, p, (ch * IC + cl) >> 2, 0);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            h[e] = 0.f;
            if (live) {
              const float v = yv[i][j][2 * hr + e] + bcs[cl + e];
              const float gt = yg[i][j][2 * hr + e] + bcs[IC + cl + e];
              h[e] = v * (gt / (1.f + __expf(-gt)));
              if (dp.on) h[e] = w.w[(cl + e) & 3] < dp.thr ? h[e] * dp.scale : 0.f;
            }
          }
          *(__nv_bfloat162*)(hs + m * S.LDH + cl) = __floats2bfloat162_rn(h[0], h[1]);
        }
      }

    // deconv, tap by tap: z[l, c] += sum_i h[l + K-1 - t, i] * Wd[t][i, c]
    for (int t = 0; t < K; ++t) {
      __syncthreads();  // h ready / every warp is done with the previous panel
      const bf16* wg = wd + ((size_t)ch * K + t) * IC * C;
      for (int i = threadIdx.x; i < IC * VC; i += NT) {
        const int r = i / VC, c8 = i % VC;
        *(uint4*)(wds + r * S.LDD + c8 * 8) = *(const uint4*)(wg + (size_t)r * C + c8 * 8);
      }
      __syncthreads();
#pragma unroll
      for (int ki = 0; ki < IC / 16; ++ki) {
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ld_a(a[i], hs + (wr * 32 + 16 * i + K - 1 - t) * S.LDH + ki * 16, S.LDH, lane);
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int nt = wq + 4 * q;
          if (nt < N8) {
            uint32_t b[2];
            ld_b1(b, wds + ki * 16 * S.LDD + nt * 8, S.LDD, lane);
#pragma unroll
            for (int i = 0; i < 2; ++i) mma(z[i][q], a[i], b);
          }
        }
      }
    }
  }

  // epilogue: bias in fp32, one rounding, pairs of channels straight to
  // device memory; rows past the tile's stored outputs or Lin skipped
  bf16* outr = out + (size_t)row * Lin * C;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int l = wr * 32 + 16 * i + g + 8 * hr, pos = j0 + l;
      if (l < lt && pos < Lin) {
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int nt = wq + 4 * q;
          if (nt < N8) {
            const int col = nt * 8 + 2 * c;
            *(__nv_bfloat162*)(outr + (size_t)pos * C + col) = __floats2bfloat162_rn(
                z[i][q][2 * hr] + bd[col], z[i][q][2 * hr + 1] + bd[col + 1]);
          }
        }
      }
    }
}

template <int C>
int launch(const bf16* x, const bf16* wc, const float* bc, const bf16* wd,
           const float* bd, bf16* out, int R, int Lin, int I, int K, DropParams dp,
           cudaStream_t st) {
  const int lt = M - (K - 1);
  const int tiles = (Lin + lt - 1) / lt;
  const size_t smem = CoreLay(C).bytes();
  cudaError_t e = cudaFuncSetAttribute(
      ffn_core_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  ffn_core_kernel<C><<<R * tiles, NT, smem, st>>>(x, wc, bc, wd, bd, out, Lin, I, K,
                                                  tiles, dp);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared-memory bytes of the kernel at width C (any k);
// ops/cuda/swiglu_ffn.py::core_bytes computes the same.
extern "C" long long swiglu_ffn_smem_bytes(int C) { return (long long)CoreLay(C).bytes(); }

// x, out [R, Lin, C] bf16; wc [I/64][K][C][128] bf16 (per chunk and tap: rows
// c, columns 64 value then 64 gate channels); bc [I/64][128] fp32;
// wd [I/64][K][64][C] bf16; bd [C] fp32.  C % 16 == 0, C <= 256, I % 64 == 0
// (the wrapper zero-pads), 2 <= K <= 8.  Dropout: seed, the keep threshold,
// the absolute row of x's first row, 1/(1-p), on (0 at p = 0).
extern "C" int swiglu_ffn_forward(const void* x, const void* wc, const void* bc,
                                  const void* wd, const void* bd, void* out, int R,
                                  int Lin, int C, int I, int K, unsigned seed,
                                  unsigned thr, unsigned row0, float scale, int on,
                                  void* stream) {
  if (I % IC || I < IC || K < 2 || K > 8 || Lin < K) return (int)cudaErrorInvalidValue;
  DropParams dp;
  dp.seed = seed;
  dp.thr = thr;
  dp.row0 = row0;
  dp.scale = scale;
  dp.on = on;
#define CORE_CASE(CC)                                                                \
  case CC:                                                                           \
    return launch<CC>((const bf16*)x, (const bf16*)wc, (const float*)bc,             \
                      (const bf16*)wd, (const float*)bd, (bf16*)out, R, Lin, I, K, dp, \
                      (cudaStream_t)stream);
  switch (C) {
    CORE_CASE(16) CORE_CASE(32) CORE_CASE(48) CORE_CASE(64)
    CORE_CASE(80) CORE_CASE(96) CORE_CASE(112) CORE_CASE(128)
    CORE_CASE(144) CORE_CASE(160) CORE_CASE(176) CORE_CASE(192)
    CORE_CASE(208) CORE_CASE(224) CORE_CASE(240) CORE_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef CORE_CASE
}
