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
// These mma.sync kernels serve the widths other than 128 and 256 (the
// small config's C 48); C 128 and 256 (xlarge) take the Hopper route at the
// end of this file.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "philox.cuh"
#include "wgrad.cuh"

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

// ---------------------------------------------------------------- backward
//
// Kernel #9 (the JAX package's ``_backward_pallas``, body ``_bwd_kernel``):
// dx and the weight gradients of the FFN core, recomputing conv -> SwiGLU on
// chip from x (no stash, as the forward keeps none) and replaying the inner
// dropout mask from (seed, absolute row, conv position, inner channel).
// With g the cotangent of the full-length output, per conv position p:
//   y = sum_t x[p + t] Wc_t,  dh = sum_t g[p + t] Wd_t^T   (through the mask)
//   dyv = dh silu(yg),  dyg = dh yv sig (1 + yg (1 - sig))
//   dx[j] = sum_t dyvg[j - t] Wc_t^T
//   dWc_t += x[p + t]^T dyvg[p],  dWd_t += h[p]^T g[p + t],  dbc += dyvg[p]
// The [L, 2I] intermediates never reach device memory.  Two kernels:
//   * dx: the forward's layout with the SwiGLU backward in place of the
//     SwiGLU: one block per (row, 64 conv positions); per 64-channel inner
//     chunk, conv and dh tap by tap (each tap's Wc [C, 128] and Wd [64, C]
//     panels staged alone), dyvg in registers -> bf16 in shared memory,
//     then dx += dyvg Wc_t^T tap by tap (the Wc panels staged again) into
//     fp32 accumulators held across chunks;
//   * weights: one block per (8 inner channels, split of the (row, 64-
//     position) units, group of <= 4 taps); it stages its channels' panels
//     of every tap once, then per unit recomputes y and dh for its 8
//     channels (the taps split between two warp halves and summed in shared
//     memory), the SwiGLU backward in fp32, and accumulates x^T dyvg and
//     g^T h for its taps in registers across all its units (positions are
//     the contraction: ldmatrix.trans gives x^T and g^T as A fragments);
//     fp32 partials per split, summed in a fixed order by
//     ``wg::reduce_kernel`` -- deterministic, no atomics (wgrad.cuh's split-K
//     pattern, with the operands recomputed rather than read back).
// What bounds it: 16 k C I FLOP per conv position for the work the
// gradients need (recomputed conv, dh, dx, both weight products; 16.8 MFLOP
// per position at xlarge) against x and g read and dx written once: tensor-
// core arithmetic.  This design spends 24 k C I (the weights kernel
// recomputes conv and dh), and re-reads x and g tiles once per 8-channel
// block, mostly from L2.

// B fragments of two adjacent 8-wide column tiles (k 0-15) from a tile
// stored [n][k] row-major (the transpose of what ld_b2 reads).
__device__ __forceinline__ void ld_bt2(uint32_t* b, const bf16* base, int ld, int lane) {
  const uint32_t addr =
      smem_addr(base + ((lane / 16) * 8 + lane % 8) * ld + ((lane / 8) % 2) * 8);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3]) : "r"(addr));
}

// B fragment of one 8-wide column tile (k 0-15) from a [n][k] tile.
__device__ __forceinline__ void ld_bt1(uint32_t* b, const bf16* base, int ld, int lane) {
  const uint32_t addr = smem_addr(base + (lane % 8) * ld + ((lane / 8) % 2) * 8);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1]) : "r"(addr));
}

// A fragment (rows m 0-15 x k 0-15) of the transpose of a tile stored
// [k][m] row-major: A[m][k] = T[k][m].
__device__ __forceinline__ void ld_at(uint32_t* a, const bf16* base, int ld, int lane) {
  const uint32_t addr =
      smem_addr(base + ((lane / 16) * 8 + lane % 8) * ld + ((lane / 8) % 2) * 8);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(addr));
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + __expf(-v)); }

// Rows [p0, p0 + ROWS) of a [Lin, C] row into shared memory (zero outside).
template <int C>
__device__ __forceinline__ void stage_rows(const bf16* __restrict__ src, int p0, int Lin,
                                           bf16* dst, int ld) {
  constexpr int VC = C / 8;
  for (int i = threadIdx.x; i < ROWS * VC; i += NT) {
    const int r = i / VC, c8 = i % VC;
    const int pos = p0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (pos >= 0 && pos < Lin) val = *(const uint4*)(src + (size_t)pos * C + c8 * 8);
    *(uint4*)(dst + r * ld + c8 * 8) = val;
  }
}

// One panel [rows][cols] (cols % 8 == 0) from device memory into shared
// memory rows of stride ld.
__device__ __forceinline__ void stage_panel(const bf16* __restrict__ src, int rows, int cols,
                                            bf16* dst, int ld) {
  const int vw = cols / 8;
  for (int i = threadIdx.x; i < rows * vw; i += NT) {
    const int r = i / vw, c8 = i % vw;
    *(uint4*)(dst + r * ld + c8 * 8) = *(const uint4*)(src + (size_t)r * cols + c8 * 8);
  }
}

// The SwiGLU backward of one element: (dyv, dyg) from the conv outputs
// (biases added), dh and the keep scale s (1 without dropout, 0 dropped).
__device__ __forceinline__ void swiglu_bwd(float v, float gt, float dh, float s, float& dv,
                                           float& dg) {
  const float sig = sigmoid(gt);
  const float dhm = dh * s;
  dv = dhm * gt * sig;
  dg = dhm * v * sig * (1.f + gt * (1.f - sig));
}

struct DxLay {
  int LDX, LDW, LDD, LDY;
  size_t xs, gs, wc, wd, ys, bc;
  __host__ __device__ explicit DxLay(int C)
      : LDX(C + 8), LDW(2 * IC + 8), LDD(C + 8), LDY(2 * IC + 8),
        xs((size_t)ROWS * (C + 8) * 2), gs((size_t)ROWS * (C + 8) * 2),
        wc((size_t)C * (2 * IC + 8) * 2), wd((size_t)IC * (C + 8) * 2),
        ys((size_t)ROWS * (2 * IC + 8) * 2), bc((size_t)2 * IC * 4) {}
  __host__ __device__ size_t bytes() const { return xs + gs + wc + wd + ys + bc; }
};

template <int C>
__global__ void __launch_bounds__(NT) ffn_core_bwd_dx_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ gz, const bf16* __restrict__ wc,
    const float* __restrict__ bc, const bf16* __restrict__ wd, bf16* __restrict__ dx,
    int Lin, int I, int K, int tiles, DropParams dp) {
  constexpr int N8 = C / 8, NQ = (N8 + 3) / 4;
  const DxLay S(C);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = (bf16*)smem;
  bf16* gs = (bf16*)(smem + S.xs);
  bf16* wcs = (bf16*)(smem + S.xs + S.gs);
  bf16* wds = (bf16*)(smem + S.xs + S.gs + S.wc);
  bf16* ys = (bf16*)(smem + S.xs + S.gs + S.wc + S.wd);
  float* bcs = (float*)(smem + S.xs + S.gs + S.wc + S.wd + S.ys);

  const int row = blockIdx.x / tiles;
  const int lt = M - (K - 1);
  const int j0 = (blockIdx.x % tiles) * lt;
  const int p0 = j0 - (K - 1);
  const int l1 = Lin - K + 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c = lane & 3;
  const int wr = warp / 4, wq = warp % 4;
  stage_rows<C>(x + (size_t)row * Lin * C, p0, Lin, xs, S.LDX);
  stage_rows<C>(gz + (size_t)row * Lin * C, p0, Lin, gs, S.LDX);
  for (int i = threadIdx.x; i < (ROWS - M) * S.LDY; i += NT)
    ys[M * S.LDY + i] = __float2bfloat16(0.f);

  float acc[2][NQ][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int q = 0; q < NQ; ++q) acc[i][q][0] = acc[i][q][1] = acc[i][q][2] = acc[i][q][3] = 0.f;

  for (int ch = 0; ch < I / IC; ++ch) {
    float yv[2][2][4], yg[2][2][4], dh[2][2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) yv[i][j][e] = yg[i][j][e] = dh[i][j][e] = 0.f;
    // conv and the deconv's adjoint, tap by tap
    for (int t = 0; t < K; ++t) {
      __syncthreads();
      stage_panel(wc + ((size_t)ch * K + t) * C * 2 * IC, C, 2 * IC, wcs, S.LDW);
      stage_panel(wd + ((size_t)ch * K + t) * IC * C, IC, C, wds, S.LDD);
      if (t == 0 && threadIdx.x < 2 * IC) bcs[threadIdx.x] = bc[ch * 2 * IC + threadIdx.x];
      __syncthreads();
#pragma unroll
      for (int kc = 0; kc < C / 16; ++kc) {
        uint32_t a[2][4], ag[2][4], bv[4], bg[4], bd[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          ld_a(a[i], xs + (wr * 32 + 16 * i + t) * S.LDX + kc * 16, S.LDX, lane);
          ld_a(ag[i], gs + (wr * 32 + 16 * i + t) * S.LDX + kc * 16, S.LDX, lane);
        }
        ld_b2(bv, wcs + kc * 16 * S.LDW + wq * 16, S.LDW, lane);
        ld_b2(bg, wcs + kc * 16 * S.LDW + IC + wq * 16, S.LDW, lane);
        ld_bt2(bd, wds + wq * 16 * S.LDD + kc * 16, S.LDD, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            mma(yv[i][j], a[i], bv + 2 * j);
            mma(yg[i][j], a[i], bg + 2 * j);
            mma(dh[i][j], ag[i], bd + 2 * j);
          }
      }
    }
    // SwiGLU backward in fp32 on the accumulators, through the inner mask;
    // dyvg = 0 off [0, l1); bf16 into shared memory
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int m = wr * 32 + 16 * i + g + 8 * hr;
        const int p = p0 + m;
        const bool live = p >= 0 && p < l1;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int cl = wq * 16 + 8 * j + 2 * c;
          Philox4 w;
          if (dp.on && live)
            w = dropout_words(dp.seed, SITE_FFN_INNER, dp.row0 + row, p, (ch * IC + cl) >> 2, 0);
          float dv[2] = {0.f, 0.f}, dg[2] = {0.f, 0.f};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (live) {
              float s = 1.f;
              if (dp.on) s = w.w[(cl + e) & 3] < dp.thr ? dp.scale : 0.f;
              swiglu_bwd(yv[i][j][2 * hr + e] + bcs[cl + e],
                         yg[i][j][2 * hr + e] + bcs[IC + cl + e], dh[i][j][2 * hr + e], s,
                         dv[e], dg[e]);
            }
          }
          *(__nv_bfloat162*)(ys + m * S.LDY + cl) = __floats2bfloat162_rn(dv[0], dv[1]);
          *(__nv_bfloat162*)(ys + m * S.LDY + IC + cl) = __floats2bfloat162_rn(dg[0], dg[1]);
        }
      }
    // dx[l] += sum_t dyvg[l + K-1 - t] Wc_t^T, tap by tap
    for (int t = 0; t < K; ++t) {
      __syncthreads();  // dyvg ready / every warp is done with the previous panel
      stage_panel(wc + ((size_t)ch * K + t) * C * 2 * IC, C, 2 * IC, wcs, S.LDW);
      __syncthreads();
#pragma unroll
      for (int ko = 0; ko < 2 * IC / 16; ++ko) {
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ld_a(a[i], ys + (wr * 32 + 16 * i + K - 1 - t) * S.LDY + ko * 16, S.LDY, lane);
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int nt = wq + 4 * q;
          if (nt < N8) {
            uint32_t b[2];
            ld_bt1(b, wcs + nt * 8 * S.LDW + ko * 16, S.LDW, lane);
#pragma unroll
            for (int i = 0; i < 2; ++i) mma(acc[i][q], a[i], b);
          }
        }
      }
    }
  }

  bf16* dxr = dx + (size_t)row * Lin * C;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int l = wr * 32 + 16 * i + g + 8 * hr, pos = j0 + l;
      if (l < lt && pos < Lin) {
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int nt = wq + 4 * q;
          if (nt < N8)
            *(__nv_bfloat162*)(dxr + (size_t)pos * C + nt * 8 + 2 * c) =
                __floats2bfloat162_rn(acc[i][q][2 * hr], acc[i][q][2 * hr + 1]);
        }
      }
    }
}

constexpr int WIC = 8;   // inner channels per weight-gradient block
constexpr int TG = 4;    // taps per weight-gradient block
constexpr int LDY8 = 2 * WIC + 8;   // dyvg rows [64][16] (48-byte stride)

struct WLay {
  int LDX, LDD;
  size_t xs, gs, wc, wd, red, ys, hs, bc;
  __host__ __device__ WLay(int C, int K)
      : LDX(C + 8), LDD(C + 8), xs((size_t)ROWS * (C + 8) * 2),
        gs((size_t)ROWS * (C + 8) * 2), wc((size_t)K * C * LDY8 * 2),
        wd((size_t)K * WIC * (C + 8) * 2), red((size_t)2 * M * 3 * WIC * 4),
        ys((size_t)M * LDY8 * 2), hs((size_t)M * WIC * 2), bc((size_t)2 * WIC * 4) {}
  __host__ __device__ size_t bytes() const { return xs + gs + wc + wd + red + ys + hs + bc; }
};

template <int C>
__global__ void __launch_bounds__(NT) ffn_core_bwd_w_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ gz, const bf16* __restrict__ wc8,
    const float* __restrict__ bc8, const bf16* __restrict__ wd8, float* __restrict__ part_c,
    float* __restrict__ part_d, float* __restrict__ part_b, int Lin, int K, int tiles_w,
    long long units, long long per_split, DropParams dp) {
  constexpr int MT = C / 16;          // 16-row tiles of the gradients' C axis
  constexpr int RW = 3 * WIC;         // red row: yv 8, yg 8, dh 8
  const WLay S(C, K);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = (bf16*)smem;
  bf16* gs = (bf16*)(smem + S.xs);
  bf16* wcs = (bf16*)(smem + S.xs + S.gs);
  bf16* wds = (bf16*)(smem + S.xs + S.gs + S.wc);
  float* red = (float*)(smem + S.xs + S.gs + S.wc + S.wd);
  bf16* ys = (bf16*)(smem + S.xs + S.gs + S.wc + S.wd + S.red);
  bf16* hs = (bf16*)(smem + S.xs + S.gs + S.wc + S.wd + S.red + S.ys);
  float* bcs = (float*)(smem + S.xs + S.gs + S.wc + S.wd + S.red + S.ys + S.hs);

  const int cw = blockIdx.x, s = blockIdx.y, t0 = blockIdx.z * TG;
  const int ncw = gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c = lane & 3;
  const int rm = warp % 4, half = warp / 4;
  const int l1 = Lin - K + 1;

  // this block's 8 channels, every tap: Wc [K*C][16] (8 value, 8 gate), Wd [K*8][C]
  for (int i = threadIdx.x; i < K * C * 2; i += NT) {
    const int r = i / 2, c8 = i % 2;
    *(uint4*)(wcs + r * LDY8 + c8 * 8) =
        *(const uint4*)(wc8 + ((size_t)cw * K * C + r) * 2 * WIC + c8 * 8);
  }
  stage_panel(wd8 + (size_t)cw * K * WIC * C, K * WIC, C, wds, S.LDD);
  if (threadIdx.x < 2 * WIC) bcs[threadIdx.x] = bc8[cw * 2 * WIC + threadIdx.x];

  float accc[TG][2][2][4], accd[TG][2][4];
#pragma unroll
  for (int tt = 0; tt < TG; ++tt)
#pragma unroll
    for (int sl = 0; sl < 2; ++sl)
#pragma unroll
      for (int e = 0; e < 4; ++e) accc[tt][sl][0][e] = accc[tt][sl][1][e] = accd[tt][sl][e] = 0.f;
  float csv = 0.f, csg = 0.f;   // column sums of dyv, dyg for channel threadIdx.x % 8
  const int jc = threadIdx.x % WIC;

  const long long u0 = (long long)s * per_split;
  const long long u1 = units < u0 + per_split ? units : u0 + per_split;
  for (long long u = u0; u < u1; ++u) {
    const int row = (int)(u / tiles_w), p0 = (int)(u % tiles_w) * M;
    __syncthreads();  // the previous unit is done with xs, gs, ys, hs
    stage_rows<C>(x + (size_t)row * Lin * C, p0, Lin, xs, S.LDX);
    stage_rows<C>(gz + (size_t)row * Lin * C, p0, Lin, gs, S.LDX);
    __syncthreads();
    // y (value, gate) and dh for rows rm*16.. +16, the taps of parity `half`
    float yv[4] = {0.f, 0.f, 0.f, 0.f}, yg[4] = {0.f, 0.f, 0.f, 0.f},
          dh[4] = {0.f, 0.f, 0.f, 0.f};
    for (int t = half; t < K; t += 2) {
#pragma unroll
      for (int kc = 0; kc < MT; ++kc) {
        uint32_t a[4], ag[4], bvg[4], bd[2];
        ld_a(a, xs + (rm * 16 + t) * S.LDX + kc * 16, S.LDX, lane);
        ld_a(ag, gs + (rm * 16 + t) * S.LDX + kc * 16, S.LDX, lane);
        ld_b2(bvg, wcs + (t * C + kc * 16) * LDY8, LDY8, lane);
        ld_bt1(bd, wds + t * WIC * S.LDD + kc * 16, S.LDD, lane);
        mma(yv, a, bvg);
        mma(yg, a, bvg + 2);
        mma(dh, ag, bd);
      }
    }
    float* rd = red + half * M * RW;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float* r = rd + (rm * 16 + g + 8 * hr) * RW + 2 * c;
      r[0] = yv[2 * hr];
      r[1] = yv[2 * hr + 1];
      r[WIC] = yg[2 * hr];
      r[WIC + 1] = yg[2 * hr + 1];
      r[2 * WIC] = dh[2 * hr];
      r[2 * WIC + 1] = dh[2 * hr + 1];
    }
    __syncthreads();
    // SwiGLU backward per (position, channel): dyvg and the dropped h
    for (int m = threadIdx.x / WIC; m < M; m += NT / WIC) {
      const int p = p0 + m;
      const float* r0 = red + m * RW + jc;
      const float* r1 = r0 + M * RW;
      float dv = 0.f, dg = 0.f, hv = 0.f;
      if (p < l1) {
        const float v = r0[0] + r1[0] + bcs[jc];
        const float gt = r0[WIC] + r1[WIC] + bcs[WIC + jc];
        float sc = 1.f;
        if (dp.on) {
          const int ic = cw * WIC + jc;
          sc = dropout_words(dp.seed, SITE_FFN_INNER, dp.row0 + row, p, ic >> 2, 0).w[ic & 3]
                       < dp.thr ? dp.scale : 0.f;
        }
        swiglu_bwd(v, gt, r0[2 * WIC] + r1[2 * WIC], sc, dv, dg);
        hv = v * gt * sigmoid(gt) * sc;
        csv += dv;
        csg += dg;
      }
      ys[m * LDY8 + jc] = __float2bfloat16(dv);
      ys[m * LDY8 + WIC + jc] = __float2bfloat16(dg);
      hs[m * WIC + jc] = __float2bfloat16(hv);
    }
    __syncthreads();
    // dWc_t[c, o] += sum_m x[m + t, c] dyvg[m, o];  dWd_t^T[c, i] += sum_m g[m + t, c] h[m, i]
#pragma unroll
    for (int kk = 0; kk < M / 16; ++kk) {
      uint32_t by[4], bh[2];
      ld_b2(by, ys + kk * 16 * LDY8, LDY8, lane);
      ld_b1(bh, hs + kk * 16 * WIC, WIC, lane);
#pragma unroll
      for (int tt = 0; tt < TG; ++tt) {
        const int t = t0 + tt;
        if (t < K) {
#pragma unroll
          for (int sl = 0; sl < 2; ++sl) {
            const int mt = warp + 8 * sl;
            if (mt < MT) {
              uint32_t ax[4], agt[4];
              ld_at(ax, xs + (kk * 16 + t) * S.LDX + mt * 16, S.LDX, lane);
              ld_at(agt, gs + (kk * 16 + t) * S.LDX + mt * 16, S.LDX, lane);
              mma(accc[tt][sl][0], ax, by);
              mma(accc[tt][sl][1], ax, by + 2);
              mma(accd[tt][sl], agt, bh);
            }
          }
        }
      }
    }
  }

  // partials of this split: part_c [S][K][ncw][C][16], part_d [S][K][ncw][C][8]
  const int K_ = K;
#pragma unroll
  for (int tt = 0; tt < TG; ++tt) {
    const int t = t0 + tt;
    if (t < K_) {
#pragma unroll
      for (int sl = 0; sl < 2; ++sl) {
        const int mt = warp + 8 * sl;
        if (mt < MT) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int cc = mt * 16 + g + 8 * hr;
            const size_t base = (((size_t)s * K_ + t) * ncw + cw) * C + cc;
            float* pc = part_c + base * 2 * WIC;
            float* pd = part_d + base * WIC;
            pc[2 * c] = accc[tt][sl][0][2 * hr];
            pc[2 * c + 1] = accc[tt][sl][0][2 * hr + 1];
            pc[WIC + 2 * c] = accc[tt][sl][1][2 * hr];
            pc[WIC + 2 * c + 1] = accc[tt][sl][1][2 * hr + 1];
            pd[2 * c] = accd[tt][sl][2 * hr];
            pd[2 * c + 1] = accd[tt][sl][2 * hr + 1];
          }
        }
      }
    }
  }
  // conv-bias partials [S][ncw][16] from the first tap group, summed over
  // the 32 threads of each channel in a fixed order
  if (blockIdx.z == 0) {
    __syncthreads();
    red[2 * threadIdx.x] = csv;
    red[2 * threadIdx.x + 1] = csg;
    __syncthreads();
    if (threadIdx.x < 2 * WIC) {
      const int j = threadIdx.x % WIC, which = threadIdx.x / WIC;
      float acc = 0.f;
      for (int k = 0; k < NT / WIC; ++k) acc += red[2 * (k * WIC + j) + which];
      part_b[((size_t)s * ncw + cw) * 2 * WIC + which * WIC + j] = acc;
    }
  }
}

template <int C>
int launch_bwd(const bf16* x, const bf16* gz, const bf16* wc, const float* bc,
               const bf16* wd, const bf16* wc8, const float* bc8, const bf16* wd8,
               bf16* dx, float* part_c, float* part_d, float* part_b, float* out_c,
               float* out_d, float* out_b, int R, int Lin, int I, int I8, int K, int Sp,
               DropParams dp, cudaStream_t st) {
  const int lt = M - (K - 1);
  const int tiles = (Lin + lt - 1) / lt;
  size_t smem = DxLay(C).bytes();
  cudaError_t e = cudaFuncSetAttribute(ffn_core_bwd_dx_kernel<C>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  ffn_core_bwd_dx_kernel<C><<<R * tiles, NT, smem, st>>>(x, gz, wc, bc, wd, dx, Lin, I, K,
                                                         tiles, dp);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int l1 = Lin - K + 1;
  const int tiles_w = (l1 + M - 1) / M;
  const long long units = (long long)R * tiles_w;
  const long long per = (units + Sp - 1) / Sp;
  const int ncw = I8 / WIC;
  smem = WLay(C, K).bytes();
  e = cudaFuncSetAttribute(ffn_core_bwd_w_kernel<C>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)ncw, (unsigned)Sp, (unsigned)((K + TG - 1) / TG));
  ffn_core_bwd_w_kernel<C><<<grid, NT, smem, st>>>(x, gz, wc8, bc8, wd8, part_c, part_d,
                                                   part_b, Lin, K, tiles_w, units, per, dp);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const long long per_c = (long long)K * ncw * C * 2 * WIC;
  if ((e = wg::launch_reduce(part_c, out_c, 1, Sp, per_c, st)) != cudaSuccess) return (int)e;
  if ((e = wg::launch_reduce(part_d, out_d, 1, Sp, per_c / 2, st)) != cudaSuccess) return (int)e;
  return (int)wg::launch_reduce(part_b, out_b, 1, Sp, (long long)ncw * 2 * WIC, st);
}


// ============================================================ Hopper route
//
// The redesign of #8 and #9 for C 128 and 256 (``wg`` below; the kernels
// above serve the other widths).  What held the kernels above: every block
// staged each weight panel synchronously with all its threads, so the
// tensor cores idled through 128 exposed panel loads per block, and the
// products ran on mma.sync at ~17% of the bf16 peak; #9's weight kernel
// recomputed conv and dh for 8 channels at a time (1.5x the FLOP) and
// re-staged x and the cotangent once per 8-channel block.
//
// Design, on wgmma, bulk copies and mbarriers (``hopper.cuh``):
//   * 256 threads: two warpgroups, 64 conv positions each (128 positions a
//     block: half the weight stream per position of the 64-row tiles); one
//     thread also issues every copy.  No producer warp: a ninth warp would
//     cap a thread at 168 registers (three warps on one of the SM's four
//     register files), and the accumulators of C 256 take 160-176;
//   * the x (and cotangent) tile, with its k-1 halo, arrives as C/64 TMA
//     boxes of 136 rows x 128 bytes, 128-byte swizzled;
//   * the weights stream through a ring of ``NS`` stages (16 KB forward, 64
//     C bytes in the dx kernel), in the order the consumers use them; the
//     wrapper lays every stage out in device memory already in the 128-
//     byte-swizzled K-major order wgmma reads, so each stage is one bulk
//     copy, ordered by a full and an empty mbarrier;
//   * the tap shift: a tap reads x rows at offset t (the deconv and dx read
//     h / dyvg at k-1-t).  The swizzle follows the shared-memory address, so
//     a descriptor may start at any row of a swizzled tile (measured on the
//     card): every product reads A (x, h, the cotangent, dyvg) from shared
//     memory, and one stage's products stay in flight while the next
//     stage's issue;
//   * the inner dimension runs in chunks, 64 value + 64 gate channels in
//     the forward (the conv m64n128, 64 registers; h in whole 128-byte
//     rows), 32 + 32 in the dx kernel (its dh and dx accumulators leave no
//     room for more); the deconv's or dx's accumulators (m64 x C, 128
//     registers at C 256) stay in registers across chunks, the SwiGLU
//     (backward) runs in fp32 on the conv's, and h / dyvg go to shared
//     memory in bf16 once (the halo rows cross the two warpgroups: a named
//     barrier per chunk);
//   * #9's weight gradients are GEMMs over positions (``wgrad_gemm_kernel``):
//     the dx kernel also writes dyvg [q, 2I] and the dropped h [q, I] to a
//     scratch with x's row stride Lin (zeros at conv positions >= l1), so
//     that a flat position q pairs dyvg[q] with x[q + t] and h[q] with
//     g[q + t] and never crosses a row: each tap's offset is a coordinate of
//     the copy.  dWc [kC, 2I] = sum_q x[q + t]^T dyvg[q] and dWd^T [kC, I] =
//     sum_q g[q + t]^T h[q], both operands read MN-major from TMA boxes,
//     split over positions into fp32 partials summed in a fixed order: no
//     atomics, the same bits on every run.  The scratch is bounded (the
//     wrapper runs the backward in row groups); the partials accumulate
//     across groups in stream order.
// What bounds them: the products (6 k C I FLOP a position forward, 16 k C I
// backward) against the weights, which every block still streams from L2
// (6.3 MB a block forward at xlarge, 74 GB a call; 10.5 MB a block in the dx
// kernel).  Measured on the card (PERF.md §6): the stream, the products
// and the per-chunk epilogues overlap little; sharing the stream across a
// 2-block cluster (multicast) made the forward slower, not faster.
namespace wgk {

using namespace hop;

constexpr int MT = 128;        // conv positions per block
constexpr int XR = MT + 8;     // staged rows: tile, halo (k-1 <= 7), zeros
constexpr int ICH = 32;        // inner channels per dx-kernel chunk (value and gate each)
constexpr int NTH = 256;    // two warpgroups
constexpr int NTH_G = 288;  // the GEMM: two warpgroups and a producer warp
constexpr int SMEM_MAX = 232448;
constexpr int MAX_STAGES = 8;

__host__ __device__ constexpr int ring_stages(int fixed, int sb) {
  int n = MAX_STAGES;
  while (n > 2 && fixed + n * sb + (2 * n + 1) * 8 > SMEM_MAX) --n;
  return n;
}

// The x (and cotangent) tile: XR rows from conv position p0 on, as C/64
// atom columns of XR rows x 128 bytes (128-byte swizzle, by address), one
// TMA box each.  A tap's rows start anywhere: the swizzle follows the
// address, so a descriptor may start at any row of a column.
constexpr int XCOL = XR * 128;

// Forward: ring | x tile | h [2][XR][64] (swizzled) | barriers; +1 KB of
// slack to align the ring and the tiles to 1024 bytes.  Its chunks are 64
// value + 64 gate channels (``FICH``), its stages [128 n][64 k] (16 KB).
constexpr int FICH = 64;
template <int C>
struct FwdLay {
  static constexpr int SB = 128 * 64 * 2;
  static constexpr int XS = (C / 64) * XCOL;
  static constexpr int HS = 2 * XCOL;
  static constexpr int FIXED = 1024 + XS + HS;
  static constexpr int NS = ring_stages(FIXED, SB);
  static constexpr int BYTES = FIXED + NS * SB + (2 * NS + 1) * 8;
};

// dx: ring | x tile | cotangent tile | dyvg [XR][64] (one swizzled atom
// column) | barriers.
template <int C>
struct DxLay {
  static constexpr int SB = 64 * C;
  static constexpr int XS = (C / 64) * XCOL;
  static constexpr int YS = XCOL;
  static constexpr int FIXED = 1024 + 2 * XS + YS;
  static constexpr int NS = ring_stages(FIXED, SB);
  static constexpr int BYTES = FIXED + NS * SB + (2 * NS + 1) * 8;
};

// The weight-gradient GEMM: stages of two A boxes and four B boxes (64 x 64
// bf16 each) | barriers.
constexpr int GSB = 6 * 8192;
constexpr int GNS = 4;
constexpr int GEMM_BYTES = 1024 + GNS * GSB + (2 * GNS) * 8;

__device__ __forceinline__ uint64_t kdesc(uint32_t addr) { return desc_sw128(addr, 16, 1024); }

// The k16 step kc (16 channels) of rows ``row`` .. row + 63 of a tile.
__device__ __forceinline__ uint64_t tile_desc(uint32_t tile, int row, int kc) {
  return kdesc(tile + (kc / 4) * XCOL + row * 128 + (kc % 4) * 32);
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// The tile of flat rows [r0, r0 + XR) of a [rows, C] tensor map: C/64 boxes.
template <int C>
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map, int r0,
                                          uint64_t* bar) {
#pragma unroll
  for (int a = 0; a < C / 64; ++a) tma_g2s_2d(dst + a * XCOL, map, 64 * a, r0, bar);
}

// The ring of weight stages.  Stage ``s`` (counted from 0 over the block's
// life) sits in slot s % NS, its n-th use with n = s / NS; each of the 8
// warps releases it (lane 0) once its products are done.  ``retire`` leaves
// a stage's products in flight while the next stage's issue, and releases
// the stage before it; ``drain`` waits for all.  Thread 0 is also the
// producer: it fills the first NS stages up front and, on releasing stage
// s, refills the slot of stage s - LAG with stage s - LAG + NS once both
// warpgroups are done with it (LAG stages of slack, so that it rarely waits).
template <int NS>
struct Ring {
  static constexpr int LAG = NS >= 8 ? 2 : 1;
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  int sb;
  const unsigned char* src;
  long long total;
  __device__ __forceinline__ void fill(long long s) const {
    const int slot = (int)(s % NS);
    if (s >= NS) mbar_wait(&empty[slot], (uint32_t)((s / NS - 1) & 1));
    mbar_arrive_expect(&full[slot], sb);
    bulk_g2s(base + slot * sb, src + s * sb, sb, &full[slot]);
  }
  __device__ __forceinline__ void start() const {
    for (long long s = 0; s < NS && s < total; ++s) fill(s);
  }
  __device__ __forceinline__ uint32_t wait(int s) const {
    mbar_wait(&full[s % NS], (s / NS) & 1);
    return smem_u32(base + (s % NS) * sb);
  }
  __device__ __forceinline__ void release(int s, int lane) const {
    if (lane == 0) mbar_arrive(&empty[s % NS]);
    if (threadIdx.x == 0 && s >= LAG && s - LAG + NS < total) fill(s - LAG + NS);
  }
  __device__ __forceinline__ void retire(int& s, int& pending, int lane) const {
    wgmma_wait<1>();
    if (pending >= 0) release(pending, lane);
    pending = s++;
  }
  __device__ __forceinline__ void drain(int& pending, int lane) const {
    wgmma_wait<0>();
    if (pending >= 0) release(pending, lane);
    pending = -1;
  }
};

// One tap of a dx-kernel product over C into acc [m64 x N] from tile rows
// ``row`` on: ``halves`` stages of [N n][C/halves k] (the conv: two of
// [64][C/2]; the deconv's adjoint: one of [32][C]); ``first`` overwrites
// acc.
template <int C, int N, int NS>
__device__ __forceinline__ void tap_products(float* acc, uint32_t tile, int row, bool first,
                                             const Ring<NS>& ring, int& s, int& pending,
                                             int lane) {
  constexpr int HALVES = N == 64 ? 2 : 1;
  constexpr int KS = C / 16 / HALVES;     // k16 steps per stage
#pragma unroll
  for (int h = 0; h < HALVES; ++h) {
    const uint32_t sb = ring.wait(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint64_t da = tile_desc(tile, row, h * KS + kk);
      const uint64_t db = kdesc(sb + (kk / 4) * (N * 128) + (kk % 4) * 32);
      if constexpr (N == 64)
        wgmma_ss_n64(acc, da, db, !first || h || kk);
      else
        wgmma_ss_n32(acc, da, db, !first || h || kk);
    }
    wgmma_commit();
    ring.retire(s, pending, lane);
  }
}

// Writes acc [m64 x C] (+ bias) as bf16 rows j0 + l of out, l < lt.
template <int C>
__device__ __forceinline__ void store_rows(const float* acc, const float* __restrict__ bias,
                                           bf16* outr, int j0, int lt, int Lin, int rbase,
                                           int lane) {
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int l = rbase + g + 8 * hr, pos = j0 + l;
    if (l < lt && pos < Lin) {
#pragma unroll
      for (int b = 0; b < C / 64; ++b)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * b + 8 * j + 2 * c;
          float v0 = acc[32 * b + 4 * j + 2 * hr], v1 = acc[32 * b + 4 * j + 2 * hr + 1];
          if (bias) {
            v0 += bias[col];
            v1 += bias[col + 1];
          }
          *(__nv_bfloat162*)(outr + (size_t)pos * C + col) = __floats2bfloat162_rn(v0, v1);
        }
    }
  }
}

// Barriers, the tile loads (rows outside the row: the neighbours' zero
// padding, or zeros past the tensor; either way they feed only conv
// positions outside [0, l1), whose h and dyvg are set to 0) and the first
// stages.
template <int NS>
__device__ __forceinline__ void prologue(uint64_t* full, uint64_t* empty, uint64_t* xbar) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);
    }
    mbar_init(xbar, 1);
    mbar_init_fence();
  }
}

template <int C>
__global__ void __launch_bounds__(NTH, 1) ffn_core_wg_kernel(
    const __grid_constant__ CUtensorMap mx, const bf16* __restrict__ panels,
    const float* __restrict__ bc, const float* __restrict__ bd, bf16* __restrict__ out, int Lin,
    int nch, int K, int tiles, DropParams dp) {
  using L = FwdLay<C>;
  extern __shared__ __align__(1024) unsigned char smraw[];
  unsigned char* sm = aligned_smem(smraw);
  unsigned char* xs = sm + L::NS * L::SB;
  unsigned char* hs = xs + L::XS;
  uint64_t* full = (uint64_t*)(hs + L::HS);
  uint64_t* empty = full + L::NS;
  uint64_t* xbar = empty + L::NS;

  const int row = blockIdx.x / tiles;
  const int lt = MT - (K - 1);
  const int j0 = (blockIdx.x % tiles) * lt;
  const int p0 = j0 - (K - 1);
  const int l1 = Lin - K + 1;
  const int tid = threadIdx.x;
  const int spc = K * (C / 64 + C / 128);   // stages per chunk
  const Ring<L::NS> ring{sm, full, empty, L::SB, (const unsigned char*)panels,
                         (long long)nch * spc};
  prologue<L::NS>(full, empty, xbar);
  for (int i = tid; i < 2 * (XR - MT) * 8; i += NTH)   // h rows past the tile: zeros
    *(uint4*)(hs + (i / ((XR - MT) * 8)) * XCOL + (MT + (i / 8) % (XR - MT)) * 128 +
              (i % 8) * 16) = make_uint4(0, 0, 0, 0);
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect(xbar, L::XS);
    load_tile<C>(xs, &mx, row * Lin + p0, xbar);
    ring.start();
  }
  const int cw = tid / 128, w = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, c = lane & 3;
  const int rbase = 64 * cw + 16 * w;
  const uint32_t xt = smem_u32(xs);
  mbar_wait(xbar, 0);

  float z[C / 2];
#pragma unroll
  for (int i = 0; i < C / 2; ++i) z[i] = 0.f;
  int s = 0, pending = -1;
  for (int ch = 0; ch < nch; ++ch) {
    // the conv, y [m64 x (64 value | 64 gate)]: per tap C/64 stages [128 n][64 k]
    float y[64];
    for (int t = 0; t < K; ++t) {
#pragma unroll
      for (int kq = 0; kq < C / 64; ++kq) {
        const uint32_t sb = ring.wait(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n128(y, tile_desc(xt, 64 * cw + t, kq * 4 + kk), kdesc(sb + kk * 32),
                        t || kq || kk);
        wgmma_commit();
        ring.retire(s, pending, lane);
      }
    }
    ring.drain(pending, lane);   // y, and the previous chunk's deconv (it read h)
    fence_regs<64>(y);
    // SwiGLU in fp32, h = 0 off [0, l1), the inner mask; bf16 h rows,
    // swizzled (value channel cl in 16-byte chunk j of its row)
    unsigned char* hb = hs + (ch & 1) * XCOL;
    const float* bch = bc + ch * 2 * FICH;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = rbase + g + 8 * hr, p = p0 + m;
      const bool live = p >= 0 && p < l1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cl = 8 * j + 2 * c;
        Philox4 wd;
        if (dp.on && live)
          wd = dropout_words(dp.seed, SITE_FFN_INNER, dp.row0 + row, p, (ch * FICH + cl) >> 2, 0);
        float h[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          h[e] = 0.f;
          if (live) {
            const float v = y[4 * j + 2 * hr + e] + __ldg(bch + cl + e);
            const float gt = y[4 * (j + 8) + 2 * hr + e] + __ldg(bch + FICH + cl + e);
            h[e] = v * (gt / (1.f + __expf(-gt)));
            if (dp.on) h[e] = wd.w[(cl + e) & 3] < dp.thr ? h[e] * dp.scale : 0.f;
          }
        }
        *(__nv_bfloat162*)(hb + m * 128 + ((j ^ (m % 8)) * 16) + 4 * c) =
            __floats2bfloat162_rn(h[0], h[1]);
      }
    }
    fence_proxy_async();   // the deconv reads h through the async proxy
    named_sync(1, 256);    // h rows of both warpgroups (the deconv's halo crosses them)
    // the deconv, z[l] += sum_t h[l + k-1 - t] Wd_t: per tap C/128 stages
    // [128 n (output channels)][64 k (inner)]
    const uint32_t ht = smem_u32(hb);
    for (int t = 0; t < K; ++t) {
#pragma unroll
      for (int nq = 0; nq < C / 128; ++nq) {
        const uint32_t sb = ring.wait(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n128(z + nq * 64, kdesc(ht + (64 * cw + K - 1 - t) * 128 + kk * 32),
                        kdesc(sb + kk * 32), 1);
        wgmma_commit();
        ring.retire(s, pending, lane);
      }
    }
  }
  ring.drain(pending, lane);
  fence_regs<C / 2>(z);
  store_rows<C>(z, bd, out + (size_t)row * Lin * C, j0, lt, Lin, rbase, lane);
}

template <int C>
__global__ void __launch_bounds__(NTH, 1) ffn_bwd_dx_wg_kernel(
    const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mg,
    const bf16* __restrict__ panels, const float* __restrict__ bc, bf16* __restrict__ dx,
    bf16* __restrict__ sy, bf16* __restrict__ sh, int r0, int Lin, int nch, int K, int tiles,
    DropParams dp) {
  using L = DxLay<C>;
  extern __shared__ __align__(1024) unsigned char smraw[];
  unsigned char* sm = aligned_smem(smraw);
  unsigned char* xs = sm + L::NS * L::SB;
  unsigned char* gs = xs + L::XS;
  unsigned char* ys = gs + L::XS;
  uint64_t* full = (uint64_t*)(ys + L::YS);
  uint64_t* empty = full + L::NS;
  uint64_t* xbar = empty + L::NS;

  const int row = blockIdx.x / tiles;       // within the group
  const int lt = MT - (K - 1);
  const int j0 = (blockIdx.x % tiles) * lt;
  const int p0 = j0 - (K - 1);
  const int l1 = Lin - K + 1;
  const int Ip = nch * ICH;
  const int tid = threadIdx.x;
  const Ring<L::NS> ring{sm, full, empty, L::SB, (const unsigned char*)panels,
                         (long long)nch * 5 * K};
  prologue<L::NS>(full, empty, xbar);
  for (int i = tid; i < (XR - MT) * 8; i += NTH)   // dyvg rows past the tile: zeros
    *(uint4*)(ys + (MT + i / 8) * 128 + (i % 8) * 16) = make_uint4(0, 0, 0, 0);
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect(xbar, 2 * L::XS);
    load_tile<C>(xs, &mx, (r0 + row) * Lin + p0, xbar);
    load_tile<C>(gs, &mg, (r0 + row) * Lin + p0, xbar);
    ring.start();
  }
  const int cw = tid / 128, w = (tid % 128) / 32, lane = tid % 32;
  const int g = lane >> 2, c = lane & 3;
  const int rbase = 64 * cw + 16 * w;
  const uint32_t xt = smem_u32(xs), gtile = smem_u32(gs), yt = smem_u32(ys);
  mbar_wait(xbar, 0);

  float acc[C / 2];
#pragma unroll
  for (int i = 0; i < C / 2; ++i) acc[i] = 0.f;
  int s = 0, pending = -1;
  for (int ch = 0; ch < nch; ++ch) {
    // conv (y) and the deconv's adjoint (dh [m64 x 32 inner]), tap by tap
    float y[32], dh[16];
    for (int t = 0; t < K; ++t) {
      tap_products<C, 64, L::NS>(y, xt, 64 * cw + t, t == 0, ring, s, pending, lane);
      tap_products<C, 32, L::NS>(dh, gtile, 64 * cw + t, t == 0, ring, s, pending, lane);
    }
    ring.drain(pending, lane);   // also the previous chunk's dx products, which read dyvg
    fence_regs<32>(y);
    fence_regs<16>(dh);
    named_sync(1, 256);   // both warpgroups are done with the previous dyvg
    // SwiGLU backward in fp32 through the inner mask: dyvg (bf16, swizzled)
    // into shared memory, the dropped h straight to the scratch (owned rows)
    const float* bch = bc + ch * 2 * ICH;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = rbase + g + 8 * hr, p = p0 + m;
      const bool live = p >= 0 && p < l1;
      const bool own = m >= K - 1 && p < Lin;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = 8 * j + 2 * c;
        Philox4 wd;
        if (dp.on && live)
          wd = dropout_words(dp.seed, SITE_FFN_INNER, dp.row0 + row, p, (ch * ICH + cl) >> 2, 0);
        float dv[2] = {0.f, 0.f}, dg[2] = {0.f, 0.f}, hv[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (live) {
            float sc = 1.f;
            if (dp.on) sc = wd.w[(cl + e) & 3] < dp.thr ? dp.scale : 0.f;
            const float v = y[4 * j + 2 * hr + e] + __ldg(bch + cl + e);
            const float gt = y[4 * (j + 4) + 2 * hr + e] + __ldg(bch + ICH + cl + e);
            swiglu_bwd(v, gt, dh[4 * j + 2 * hr + e], sc, dv[e], dg[e]);
            hv[e] = v * gt * sigmoid(gt) * sc;
          }
        }
        // dyvg row m: value channel cl in 16-byte chunk j, gate in chunk j + 4
        unsigned char* yr = ys + m * 128 + (2 * c) * 2;
        *(__nv_bfloat162*)(yr + ((j ^ (m % 8)) * 16)) = __floats2bfloat162_rn(dv[0], dv[1]);
        *(__nv_bfloat162*)(yr + (((j + 4) ^ (m % 8)) * 16)) = __floats2bfloat162_rn(dg[0], dg[1]);
        if (own)
          *(__nv_bfloat162*)(sh + ((size_t)row * Lin + p) * Ip + ch * ICH + cl) =
              __floats2bfloat162_rn(hv[0], hv[1]);
      }
    }
    fence_proxy_async();   // the products read dyvg through the async proxy
    named_sync(1, 256);    // dyvg rows of both warpgroups
    // the owned rows of dyvg to the scratch, 16 bytes a thread-step
    for (int i = tid; i < lt * 8; i += NTH) {
      const int m = K - 1 + i / 8, p = p0 + m;
      if (p < Lin)
        *(uint4*)(sy + ((size_t)row * Lin + p) * 2 * Ip + ch * 2 * ICH + (i % 8) * 8) =
            *(const uint4*)(ys + m * 128 + (((i % 8) ^ (m % 8)) * 16));
    }
    // dx[l] += sum_t dyvg[l + k-1 - t] Wc_t^T: per tap two stages [C/2 n][64 k]
    for (int t = 0; t < K; ++t) {
#pragma unroll
      for (int nh = 0; nh < 2; ++nh) {
        const uint32_t sb = ring.wait(s);
        wgmma_fence();
#pragma unroll
        for (int ko = 0; ko < 4; ++ko) {
          const uint64_t da = kdesc(yt + (64 * cw + K - 1 - t) * 128 + ko * 32);
          if constexpr (C == 256)
            wgmma_ss_n128(acc + nh * 64, da, kdesc(sb + ko * 32), 1);
          else
            wgmma_ss_n64(acc + nh * 32, da, kdesc(sb + ko * 32), 1);
        }
        wgmma_commit();
        ring.retire(s, pending, lane);
      }
    }
  }
  ring.drain(pending, lane);
  fence_regs<C / 2>(acc);
  store_rows<C>(acc, nullptr, dx + (size_t)row * Lin * C, j0, lt, Lin, rbase, lane);
}

// Weight gradients of one row group: part[s][m][col] (+)= sum over the
// split's positions q of A[q + t][c] B[q][col], m = t C + c, for
//   cols [0, 2Ip):   A = x (map ax), B = dyvg (map by);
//   cols [2Ip, 3Ip): A = the cotangent (map ag), B = h (map bh);
// one block per (128 m x 256 col tile, split), two warpgroups of 64 m and a
// producer warp (its 163 registers fit nine warps), the boxes by TMA into 4
// stages; the conv bias's partials (the
// column sums of dyvg) from the blocks of m tile 0.  ``xrow0`` is the flat
// position of the group's first row in x and the cotangent.
__global__ void __launch_bounds__(NTH_G, 1) ffn_wgrad_gemm_kernel(
    const __grid_constant__ CUtensorMap ax, const __grid_constant__ CUtensorMap ag,
    const __grid_constant__ CUtensorMap by, const __grid_constant__ CUtensorMap bh,
    float* __restrict__ part, float* __restrict__ part_b, int C, int Ip, int n1, int n2,
    long long Q, long long per, int xrow0, int accumulate) {
  extern __shared__ __align__(1024) unsigned char smraw[];
  unsigned char* sm = aligned_smem(smraw);
  uint64_t* full = (uint64_t*)(sm + GNS * GSB);
  uint64_t* empty = full + GNS;
  const int nt_all = n1 + n2;
  const int mt = blockIdx.x / nt_all, nt = blockIdx.x % nt_all, split = blockIdx.y;
  const bool first = nt < n1;     // dWc (x, dyvg) or dWd^T (cotangent, h)
  const int col0 = first ? nt * 256 : (nt - n1) * 256;
  const int ncols = first ? 2 * Ip : Ip;
  const long long q0 = (long long)split * per;
  const long long q1 = Q < q0 + per ? Q : q0 + per;
  const int steps = (int)((q1 - q0 + 63) / 64);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < GNS; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (tid >= 256) {   // the producer warp: step i's boxes once step i - GNS is done
    if (tid == 256) {
      const CUtensorMap* am = first ? &ax : &ag;
      const CUtensorMap* bm = first ? &by : &bh;
      prefetch_map(am);
      prefetch_map(bm);
      for (int i = 0; i < steps; ++i) {
        const int slot = i % GNS;
        if (i >= GNS) mbar_wait(&empty[slot], (uint32_t)((i / GNS - 1) & 1));
        mbar_arrive_expect(&full[slot], GSB);
        unsigned char* st = sm + slot * GSB;
        const int q = (int)(q0 + 64LL * i);
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int m = mt * 128 + 64 * a;
          tma_g2s_2d(st + a * 8192, am, m % C, xrow0 + q + m / C, &full[slot]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          tma_g2s_2d(st + (2 + j) * 8192, bm, col0 + 64 * j, q, &full[slot]);
      }
    }
    return;
  }
  const int cw = tid / 128, w = (tid % 128) / 32, lane = tid % 32;
  const bool sums = first && mt == 0;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float csum = 0.f;
  for (int i = 0; i < steps; ++i) {
    const int slot = i % GNS;
    mbar_wait(&full[slot], (uint32_t)((i / GNS) & 1));
    unsigned char* st = sm + slot * GSB;
    const uint32_t sa = smem_u32(st + cw * 8192), sb = smem_u32(st + 2 * 8192);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_tt_n256(acc, desc_sw128(sa + kk * 2048, 8192, 1024),
                       desc_sw128(sb + kk * 2048, 8192, 1024), 1);
    wgmma_commit();
    if (sums) {   // column tid of the B tile, rows 0..63 (swizzled chunks)
      const bf16* bt = (const bf16*)(st + (2 + tid / 64) * 8192);
      const int nn = tid % 64;
#pragma unroll 8
      for (int k = 0; k < 64; ++k)
        csum += __bfloat162float(bt[k * 64 + (((nn / 8) ^ (k % 8)) * 8) + nn % 8]);
    }
    wgmma_wait<1>();
    if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % GNS]);
  }
  wgmma_wait<0>();
  fence_regs<128>(acc);
  // partials [S][K C][3 Ip]: this tile's rows and columns
  const int g = lane >> 2, c = lane & 3;
  const int pc0 = (first ? 0 : 2 * Ip) + col0;
  const size_t ld = (size_t)3 * Ip;
  float* pr = part + (size_t)split * (size_t)(gridDim.x / nt_all) * 128 * ld;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int m = mt * 128 + 64 * cw + 16 * w + g + 8 * hr;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = col0 + 8 * j + 2 * c;
      if (col < ncols) {
        float2* dst = (float2*)(pr + (size_t)m * ld + pc0 + 8 * j + 2 * c);
        float2 v = make_float2(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
        if (accumulate) {
          const float2 o = *dst;
          v.x += o.x;
          v.y += o.y;
        }
        *dst = v;
      }
    }
  }
  if (sums && col0 + tid < ncols) {
    float* b = part_b + (size_t)split * 2 * Ip + col0 + tid;
    *b = accumulate ? *b + csum : csum;
  }
}

template <int C>
int launch_fwd(const bf16* x, const bf16* panels, const float* bc, const float* bd, bf16* out,
               int R, int Lin, int Ip, int K, DropParams dp, cudaStream_t st) {
  const int lt = MT - (K - 1);
  const int tiles = (Lin + lt - 1) / lt;
  const int smem = FwdLay<C>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(ffn_core_wg_kernel<C>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap mx;
  if ((e = make_map_2d(&mx, x, (uint64_t)R * Lin, C, C, XR)) != cudaSuccess) return (int)e;
  ffn_core_wg_kernel<C><<<R * tiles, NTH, smem, st>>>(mx, panels, bc, bd, out, Lin, Ip / FICH,
                                                      K, tiles, dp);
  return (int)cudaGetLastError();
}

template <int C>
int launch_bwd(const bf16* x, const bf16* gz, const bf16* panels, const float* bc, bf16* dx,
               bf16* sy, bf16* sh, float* part, float* part_b, float* out_w, float* out_b, int R,
               int Lin, int Ip, int K, int Rg, int S, DropParams dp, cudaStream_t st) {
  const int lt = MT - (K - 1);
  const int tiles = (Lin + lt - 1) / lt;
  int smem = DxLay<C>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(ffn_bwd_dx_wg_kernel<C>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(ffn_wgrad_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           GEMM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const int n1 = (2 * Ip + 255) / 256, n2 = (Ip + 255) / 256;
  const int mtiles = K * C / 128;
  CUtensorMap ax, ag, by, bh, tx, tg;
  if ((e = make_map_2d(&ax, x, (uint64_t)R * Lin, C, C)) != cudaSuccess) return (int)e;
  if ((e = make_map_2d(&ag, gz, (uint64_t)R * Lin, C, C)) != cudaSuccess) return (int)e;
  if ((e = make_map_2d(&tx, x, (uint64_t)R * Lin, C, C, XR)) != cudaSuccess) return (int)e;
  if ((e = make_map_2d(&tg, gz, (uint64_t)R * Lin, C, C, XR)) != cudaSuccess) return (int)e;
  for (int r0 = 0; r0 < R; r0 += Rg) {
    const int rows = R - r0 < Rg ? R - r0 : Rg;
    DropParams dpg = dp;
    dpg.row0 = dp.row0 + r0;
    const size_t off = (size_t)r0 * Lin * C;
    ffn_bwd_dx_wg_kernel<C><<<rows * tiles, NTH, smem, st>>>(
        tx, tg, panels, bc, dx + off, sy, sh, r0, Lin, Ip / ICH, K, tiles, dpg);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    const long long Q = (long long)rows * Lin;
    const long long per = ((Q + S - 1) / S + 63) / 64 * 64;
    if ((e = make_map_2d(&by, sy, Q, 2 * Ip, 2 * Ip)) != cudaSuccess) return (int)e;
    if ((e = make_map_2d(&bh, sh, Q, Ip, Ip)) != cudaSuccess) return (int)e;
    const dim3 grid((unsigned)(mtiles * (n1 + n2)), (unsigned)S);
    ffn_wgrad_gemm_kernel<<<grid, NTH_G, GEMM_BYTES, st>>>(ax, ag, by, bh, part, part_b, C, Ip, n1,
                                                         n2, Q, per, r0 * Lin, r0 > 0);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  if ((e = wg::launch_reduce(part, out_w, 1, S, (long long)K * C * 3 * Ip, st)) != cudaSuccess)
    return (int)e;
  return (int)wg::launch_reduce(part_b, out_b, 1, S, 2LL * Ip, st);
}

}  // namespace wgk

}  // namespace

static DropParams drop_params(unsigned seed, unsigned thr, unsigned row0, float scale, int on) {
  DropParams dp;
  dp.seed = seed;
  dp.thr = thr;
  dp.row0 = row0;
  dp.scale = scale;
  dp.on = on;
  return dp;
}

// Shared-memory bytes of the kernel at width C (any k);
// ops/cuda/swiglu_ffn.py::core_bytes computes the same.
extern "C" long long swiglu_ffn_smem_bytes(int C) { return (long long)CoreLay(C).bytes(); }

// x, out [R, Lin, C] bf16; wc [I/64][K][C][128] bf16 (per chunk and tap: rows
// c, columns 64 value then 64 gate channels); bc [I/64][128] fp32;
// wd [I/64][K][64][C] bf16; bd [C] fp32.  C % 16 == 0, C <= 256, C not 128
// or 256 (those take swiglu_ffn_wg_forward), I % 64 == 0 (the wrapper
// zero-pads), 2 <= K <= 8.  Dropout: seed, the keep threshold,
// the absolute row of x's first row, 1/(1-p), on (0 at p = 0).
extern "C" int swiglu_ffn_forward(const void* x, const void* wc, const void* bc,
                                  const void* wd, const void* bd, void* out, int R,
                                  int Lin, int C, int I, int K, unsigned seed,
                                  unsigned thr, unsigned row0, float scale, int on,
                                  void* stream) {
  if (I % IC || I < IC || K < 2 || K > 8 || Lin < K) return (int)cudaErrorInvalidValue;
  const DropParams dp = drop_params(seed, thr, row0, scale, on);
#define CORE_CASE(CC)                                                                \
  case CC:                                                                           \
    return launch<CC>((const bf16*)x, (const bf16*)wc, (const float*)bc,             \
                      (const bf16*)wd, (const float*)bd, (bf16*)out, R, Lin, I, K, dp, \
                      (cudaStream_t)stream);
  switch (C) {
    CORE_CASE(16) CORE_CASE(32) CORE_CASE(48) CORE_CASE(64)
    CORE_CASE(80) CORE_CASE(96) CORE_CASE(112) CORE_CASE(144)
    CORE_CASE(160) CORE_CASE(176) CORE_CASE(192) CORE_CASE(208)
    CORE_CASE(224) CORE_CASE(240)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef CORE_CASE
}

// Shared-memory bytes of the backward's two kernels at width C and K taps:
// which = 0 the dx kernel, 1 the weight-gradient kernel
// (ops/cuda/swiglu_ffn.py::backward_bytes computes the same).
extern "C" long long swiglu_ffn_bwd_smem_bytes(int C, int K, int which) {
  return (long long)(which ? WLay(C, K).bytes() : DxLay(C).bytes());
}

// Backward (kernel #9) at the widths of swiglu_ffn_forward.  x [R, Lin, C]
// and gz (the cotangent of the output) [R, Lin, C] bf16; the forward's
// panels wc, bc, wd (I padded to 64) and the
// same weights chunked by 8 inner channels: wc8 [I8/8][K][C][16] bf16 (8
// value then 8 gate), bc8 [I8/8][16] fp32, wd8 [I8/8][K][8][C] bf16.
// Outputs: dx [R, Lin, C] bf16; out_c [K][I8/8][C][16], out_d [K][I8/8][C][8],
// out_b [I8/8][16] fp32.  Scratch: part_c [S][...out_c], part_d, part_b.
extern "C" int swiglu_ffn_backward(const void* x, const void* gz, const void* wc,
                                   const void* bc, const void* wd, const void* wc8,
                                   const void* bc8, const void* wd8, void* dx, void* part_c,
                                   void* part_d, void* part_b, void* out_c, void* out_d,
                                   void* out_b, int R, int Lin, int C, int I, int I8, int K,
                                   int S, unsigned seed, unsigned thr, unsigned row0,
                                   float scale, int on, void* stream) {
  if (I % IC || I < IC || I8 % WIC || K < 2 || K > 8 || Lin < K || S < 1)
    return (int)cudaErrorInvalidValue;
  const DropParams dp = drop_params(seed, thr, row0, scale, on);
#define BWD_CASE(CC)                                                                      \
  case CC:                                                                                \
    return launch_bwd<CC>((const bf16*)x, (const bf16*)gz, (const bf16*)wc,               \
                          (const float*)bc, (const bf16*)wd, (const bf16*)wc8,            \
                          (const float*)bc8, (const bf16*)wd8, (bf16*)dx, (float*)part_c, \
                          (float*)part_d, (float*)part_b, (float*)out_c, (float*)out_d,   \
                          (float*)out_b, R, Lin, I, I8, K, S, dp, (cudaStream_t)stream);
  switch (C) {
    BWD_CASE(16) BWD_CASE(32) BWD_CASE(48) BWD_CASE(64)
    BWD_CASE(80) BWD_CASE(96) BWD_CASE(112) BWD_CASE(144)
    BWD_CASE(160) BWD_CASE(176) BWD_CASE(192) BWD_CASE(208)
    BWD_CASE(224) BWD_CASE(240)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef BWD_CASE
}

// ------------------------------------------------------------ Hopper route

// Shared-memory bytes of the Hopper route's kernels at width C (128 or
// 256): which = 0 the forward, 1 the backward's dx kernel, 2 its weight-
// gradient GEMM (ops/cuda/swiglu_ffn.py::wg_bytes computes the same).
extern "C" long long swiglu_ffn_wg_smem_bytes(int C, int which) {
  if (which == 2) return wgk::GEMM_BYTES;
  if (C == 128) return which ? wgk::DxLay<128>::BYTES : wgk::FwdLay<128>::BYTES;
  if (C == 256) return which ? wgk::DxLay<256>::BYTES : wgk::FwdLay<256>::BYTES;
  return -1;
}

// Forward (kernel #8) at C 128 or 256.  x, out [R, Lin, C] bf16; panels: per
// 64-channel chunk K (C/64 + C/128) stages [128 n][64 k] (16 KB), each
// 128-byte swizzled K-major: per tap the conv's C/64 (n = 64 value then 64
// gate channels, k = 64 of C), then per tap the deconv's C/128 (n = 128
// output channels, k = the chunk's 64) (ops/cuda/swiglu_ffn.py::
// wg_forward_panels); bc [Ip/64][128] fp32 (64 value, 64 gate); bd [C] fp32.
// Ip (the padded inner width) % 64 == 0.
extern "C" int swiglu_ffn_wg_forward(const void* x, const void* panels, const void* bc,
                                     const void* bd, void* out, int R, int Lin, int C, int Ip,
                                     int K, unsigned seed, unsigned thr, unsigned row0,
                                     float scale, int on, void* stream) {
  if (Ip % 64 || Ip < 64 || K < 2 || K > 8 || Lin < K || R < 1)
    return (int)cudaErrorInvalidValue;
  const DropParams dp = drop_params(seed, thr, row0, scale, on);
  const cudaStream_t st = (cudaStream_t)stream;
  if (C == 128)
    return wgk::launch_fwd<128>((const bf16*)x, (const bf16*)panels, (const float*)bc,
                                (const float*)bd, (bf16*)out, R, Lin, Ip, K, dp, st);
  if (C == 256)
    return wgk::launch_fwd<256>((const bf16*)x, (const bf16*)panels, (const float*)bc,
                                (const float*)bd, (bf16*)out, R, Lin, Ip, K, dp, st);
  return (int)cudaErrorInvalidValue;
}

// Backward (kernel #9) at C 128 or 256, in row groups of Rg rows.  x, gz
// (the output's cotangent), dx [R, Lin, C] bf16; panels: per chunk, per tap
// its two conv stages and its dh stage [32][C], then per tap its two dx
// stages [C/2][64] (ops/cuda/swiglu_ffn.py::wg_backward_panels); bc as the
// forward's.  Scratch: sy [Rg, Lin, 2 Ip], sh [Rg, Lin, Ip] bf16; part [S][K
// C][3 Ip], part_b [S][2 Ip] fp32.  Out: out_w [K C][3 Ip] (dWc in columns
// [0, 2 Ip), chunk-major: 32 value then 32 gate; dWd^T in [2 Ip, 3 Ip)),
// out_b [2 Ip] fp32.
extern "C" int swiglu_ffn_wg_backward(const void* x, const void* gz, const void* panels,
                                      const void* bc, void* dx, void* sy, void* sh, void* part,
                                      void* part_b, void* out_w, void* out_b, int R, int Lin,
                                      int C, int Ip, int K, int Rg, int S, unsigned seed,
                                      unsigned thr, unsigned row0, float scale, int on,
                                      void* stream) {
  if (Ip % 64 || Ip < 64 || K < 2 || K > 8 || Lin < K || R < 1 || Rg < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  const DropParams dp = drop_params(seed, thr, row0, scale, on);
  const cudaStream_t st = (cudaStream_t)stream;
#define WG_BWD(CC)                                                                            \
  return wgk::launch_bwd<CC>((const bf16*)x, (const bf16*)gz, (const bf16*)panels,            \
                             (const float*)bc, (bf16*)dx, (bf16*)sy, (bf16*)sh, (float*)part, \
                             (float*)part_b, (float*)out_w, (float*)out_b, R, Lin, Ip, K, Rg, \
                             S, dp, st);
  if (C == 128) WG_BWD(128)
  if (C == 256) WG_BWD(256)
#undef WG_BWD
  return (int)cudaErrorInvalidValue;
}
