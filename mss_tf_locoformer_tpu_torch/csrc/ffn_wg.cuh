// The Hopper FFN kernels' shared pieces, on ``hopper.cuh``: the tile and
// ring layout, the ring of weight stages, the SwiGLU backward of one element
// and the weight-gradient GEMM.  Used by the FFN core (``swiglu_ffn.cu``,
// #8 and #9) and the FFN step (``swiglu_block.cu``, #2 and #5).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

// The fast divide (2 ulp; 0 once 1 + e^-v overflows, sigmoid's limit): a
// full-precision division here was a quarter of the FFN step's forward.
__device__ __forceinline__ float sigmoid(float v) { return __fdividef(1.f, 1.f + __expf(-v)); }

// The SwiGLU backward of one element: (dyv, dyg) from the conv outputs
// (biases added), dh and the keep scale s (1 without dropout, 0 dropped).
__device__ __forceinline__ void swiglu_bwd(float v, float gt, float dh, float s, float& dv,
                                           float& dg) {
  const float sig = sigmoid(gt);
  const float dhm = dh * s;
  dv = dhm * gt * sig;
  dg = dhm * v * sig * (1.f + gt * (1.f - sig));
}

namespace wgk {

using namespace hop;

constexpr int MT = 128;        // conv positions per block
constexpr int XR = MT + 8;     // staged rows: tile, halo (k-1 <= 7), zeros
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
  // The stream may repeat stages: per ``spc`` stages of the stream (a
  // chunk), stage i is the chunk's panel stage i (i < spp) or i - spp.
  int spc = 1, spp = 1;
  __device__ __forceinline__ void fill(long long s) const {
    const int slot = (int)(s % NS);
    if (s >= NS) mbar_wait(&empty[slot], (uint32_t)((s / NS - 1) & 1));
    mbar_arrive_expect(&full[slot], sb);
    const int i = (int)(s % spc);
    const long long p = (s / spc) * spp + (i < spp ? i : i - spp);
    bulk_g2s(base + slot * sb, src + p * sb, sb, &full[slot]);
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

// Thread 0 initialises the ring's barriers (a full and an empty one a
// slot) and the tile barrier ``xbar``; the caller syncs before their use.
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

// The GEMM's shared memory, set once before its launches.
inline cudaError_t gemm_attr() {
  return cudaFuncSetAttribute(ffn_wgrad_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              GEMM_BYTES);
}

// The GEMM over one row group of Q flat positions: A boxes from the maps ax
// and ag (m = t Cg + c: taps of Cg channels, Cg a multiple of 128; a map
// narrower than Cg reads zeros past its width), B from the scratch dyvg sy
// [Q, 2 Ip] and h sh [Q, Ip]; S position splits of whole 64-position steps;
// partials [S][K Cg][3 Ip] and part_b [S][2 Ip], accumulated onto when
// ``accumulate``.
inline cudaError_t gemm_group(const CUtensorMap& ax, const CUtensorMap& ag, const bf16* sy,
                              const bf16* sh, long long Q, int Cg, int Ip, int K, int S,
                              float* part, float* part_b, int xrow0, int accumulate,
                              cudaStream_t st) {
  const int n1 = (2 * Ip + 255) / 256, n2 = (Ip + 255) / 256;
  const long long per = ((Q + S - 1) / S + 63) / 64 * 64;
  CUtensorMap by, bh;
  cudaError_t e;
  if ((e = make_map_2d(&by, sy, Q, 2 * Ip, 2 * Ip)) != cudaSuccess) return e;
  if ((e = make_map_2d(&bh, sh, Q, Ip, Ip)) != cudaSuccess) return e;
  const dim3 grid((unsigned)(K * Cg / 128 * (n1 + n2)), (unsigned)S);
  ffn_wgrad_gemm_kernel<<<grid, NTH_G, GEMM_BYTES, st>>>(ax, ag, by, bh, part, part_b, Cg, Ip,
                                                       n1, n2, Q, per, xrow0, accumulate);
  return cudaGetLastError();
}

}  // namespace wgk

}  // namespace
