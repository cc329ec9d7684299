// Weight gradients as deterministic split-K products over positions, shared
// by the FFN-step and attention-step backward kernels.
//
// The TPU kernels accumulate their weight gradients in scratch across a
// grid that runs in order.  On Hopper blocks run in no order, so the sums
// over the ~5e5 positions of a call go in two launches, with no atomics
// (the result is the same bits on every run):
//
//   wgrad_kernel:   dW[t][m, n] = sum_r sum_{j < La} A[r, j, m] * B[r, j + shift0 + t, n]
//                   (B rows outside [0, Lb) are zero), one block per
//                   (64-wide tile of m, split s of the positions, tap t),
//                   bf16 wmma products with fp32 accumulation, each block
//                   writing its fp32 partial [64, NN] to scratch; optionally
//                   the column sums of A (a bias gradient) for tap 0;
//   reduce_kernel:  the partials summed over s in a fixed order.
//
// A and B are bf16 [R, *, M] / [R, *, NN] with row strides (positions per r)
// a_stride and b_stride; NN is 32, 64, 96 or 128 (a whole tile row).
// Bound: the two operands read once per m tile (bytes) against 2*M*NN*N
// FLOP -- for the base config the FLOP dominate.
#pragma once

#include <cuda_bf16.h>
#include <mma.h>

namespace wg {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;   // m per block
constexpr int KP = 32;   // positions per staged chunk
constexpr int NT = 256;  // 8 warps
constexpr int LDA = BM + 8;

template <int NN>
__global__ void __launch_bounds__(NT) wgrad_kernel(
    const bf16* __restrict__ A, int La, int a_stride, int M,
    const bf16* __restrict__ B, int Lb, int b_stride, int shift0, int R,
    int S, long long per_split, float* __restrict__ partial,
    float* __restrict__ colsum) {
  using namespace nvcuda;
  constexpr int LDB = NN + 8;
  constexpr int NF = NN / 32;  // output fragments per warp
  __shared__ __align__(128) bf16 As[KP * LDA];
  __shared__ __align__(128) bf16 Bs[KP * LDB];

  const int mt = blockIdx.x, s = blockIdx.y, t = blockIdx.z;
  const int m0 = mt * BM;
  const int shift = shift0 + t;
  const long long N = (long long)R * La;
  const long long n0 = (long long)s * per_split;
  const long long n1 = N < n0 + per_split ? N : n0 + per_split;
  const int warp = threadIdx.x / 32;
  const int mf = warp % 4, nh = warp / 4;
  const bool sums = colsum != nullptr && t == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int q = 0; q < NF; ++q) wmma::fill_fragment(acc[q], 0.f);
  float csum = 0.f;

  for (long long c0 = n0; c0 < n1; c0 += KP) {
    __syncthreads();
    // stage A [KP, 64] and B [KP, NN], 8 bf16 (16 bytes) per thread-step
    for (int i = threadIdx.x; i < KP * (BM / 8); i += NT) {
      const int p = i / (BM / 8), v = i % (BM / 8);
      const long long n = c0 + p;
      uint4 val = make_uint4(0, 0, 0, 0);
      const int m = m0 + v * 8;
      if (n < n1 && m < M) {
        const long long r = n / La, j = n % La;
        val = *(const uint4*)(A + (r * a_stride + j) * M + m);
      }
      *(uint4*)(As + p * LDA + v * 8) = val;
    }
    for (int i = threadIdx.x; i < KP * (NN / 8); i += NT) {
      const int p = i / (NN / 8), v = i % (NN / 8);
      const long long n = c0 + p;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (n < n1) {
        const long long r = n / La, jb = n % La + shift;
        if (jb >= 0 && jb < Lb) val = *(const uint4*)(B + (r * b_stride + jb) * NN + v * 8);
      }
      *(uint4*)(Bs + p * LDB + v * 8) = val;
    }
    __syncthreads();
    if (sums && threadIdx.x < BM) {
      for (int p = 0; p < KP; ++p) csum += __bfloat162float(As[p * LDA + threadIdx.x]);
    }
#pragma unroll
    for (int kk = 0; kk < KP / 16; ++kk) {
      // A^T: element (m, p) sits at As[p * LDA + m] -- a col-major operand
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
      wmma::load_matrix_sync(a, As + kk * 16 * LDA + mf * 16, LDA);
#pragma unroll
      for (int q = 0; q < NF; ++q) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, Bs + kk * 16 * LDB + nh * (NN / 2) + q * 16, LDB);
        wmma::mma_sync(acc[q], a, b, acc[q]);
      }
    }
  }
  const int mpad = gridDim.x * BM;
  float* out = partial + (((size_t)t * S + s) * mpad + m0) * NN;
#pragma unroll
  for (int q = 0; q < NF; ++q)
    wmma::store_matrix_sync(out + mf * 16 * NN + nh * (NN / 2) + q * 16, acc[q], NN,
                            wmma::mem_row_major);
  if (sums && threadIdx.x < BM) colsum[(size_t)s * mpad + m0 + threadIdx.x] = csum;
}

// out[g][i] = sum_{s < S} part[g][s][i], in order of s.
__global__ void reduce_kernel(const float* __restrict__ part,
                              float* __restrict__ out, int G, int S, long long E) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)G * E) return;
  const long long g = idx / E, i = idx % E;
  const float* p = part + (size_t)g * S * E + i;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += p[(size_t)s * E];
  out[idx] = acc;
}

inline int mtiles(int M) { return (M + BM - 1) / BM; }

inline long long per_split(long long N, int S) {
  const long long per = (N + S - 1) / S;
  return (per + KP - 1) / KP * KP;
}

// Launches wgrad_kernel<NN> into ``partial`` [taps][S][mtiles*64][NN] (and
// ``colsum`` [S][mtiles*64] when not null).  The caller picks S (the
// wrappers' ``wgrad_splits``) and allocates the scratch.
inline cudaError_t launch_wgrad(const bf16* A, int La, int a_stride, int M,
                                const bf16* B, int Lb, int b_stride, int NN,
                                int shift0, int taps, int R, int S,
                                float* partial, float* colsum, cudaStream_t st) {
  const long long N = (long long)R * La;
  const long long per = per_split(N, S);
  dim3 grid(mtiles(M), S, taps);
#define WG_CASE(K)                                                                  \
  case K:                                                                           \
    wgrad_kernel<K><<<grid, NT, 0, st>>>(A, La, a_stride, M, B, Lb, b_stride,      \
                                         shift0, R, S, per, partial, colsum);      \
    break;
  switch (NN) {
    WG_CASE(32)
    WG_CASE(64)
    WG_CASE(96)
    WG_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef WG_CASE
  return cudaGetLastError();
}

inline cudaError_t launch_reduce(const float* part, float* out, int G, int S,
                                 long long E, cudaStream_t st) {
  const long long n = (long long)G * E;
  reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(part, out, G, S, E);
  return cudaGetLastError();
}

}  // namespace wg
