// STFT as a window-folded real DFT, fp32, frames read in place.
//
// Replaces the JAX package's Pallas kernel
// ``ops/pallas/stft_kernel.py::_frames_spectrum`` (body ``_fwd_kernel``),
// public ``stft_pallas``.
//
//   out[b, f, n] = sum_k xpad[b, n*hop + k] * W[k, f],
//   W[k, f] = w[k] * exp(-2 pi i k f / n_fft)   (periodic Hann w)
//
// i.e. a [N, n_fft] x [n_fft, F] product per signal, done twice (re, im).
// At the serving shape (B 2, N 690, n_fft 2048, F 1025) that is 11.6 GFLOP
// of fp32 FMAs on 11 MB of input: bound by fp32 arithmetic (this card's
// tensor cores have no full-fp32 mode, and bf16 or TF32 inputs would cost the
// transform's fp32 accuracy).  The design is a plain shared-memory-tiled
// SGEMM: 64 frames x 64 bins per block, 4 x 4 outputs (re and im) per thread,
// frames gathered straight from the padded signal (the frames tensor never
// exists), and stores coalesced along frames, the fastest axis of the
// [B, F, N] complex output.
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;   // frames per block
constexpr int BN = 64;   // bins per block
constexpr int BK = 16;   // samples per k-step
constexpr int NT = 256;  // threads: 16 (frames) x 16 (bins), 4 x 4 each

__global__ void __launch_bounds__(NT) stft_kernel(
    const float* __restrict__ xpad, const float* __restrict__ wre,
    const float* __restrict__ wim, float2* __restrict__ out, int Tp,
    int n_fft, int hop, int n_frames, int n_bins) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Br[BK][BN];
  __shared__ float Bi[BK][BN];

  const int b = blockIdx.z;
  const int n0 = blockIdx.x * BM;
  const int f0 = blockIdx.y * BN;
  const int tn = threadIdx.x % 16;  // frames tn + 16*i
  const int tf = threadIdx.x / 16;  // bins   tf + 16*j
  const float* sig = xpad + (size_t)b * Tp;

  float acc_r[4][4], acc_i[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_r[i][j] = acc_i[i][j] = 0.f;

  for (int k0 = 0; k0 < n_fft; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += NT) {
      const int m = e / BK, kk = e % BK;
      const int n = n0 + m, k = k0 + kk;
      As[kk][m] = (n < n_frames && k < n_fft) ? sig[(size_t)n * hop + k] : 0.f;
    }
    for (int e = threadIdx.x; e < BK * BN; e += NT) {
      const int kk = e / BN, j = e % BN;
      const int k = k0 + kk, f = f0 + j;
      const bool ok = k < n_fft && f < n_bins;
      Br[kk][j] = ok ? wre[(size_t)k * n_bins + f] : 0.f;
      Bi[kk][j] = ok ? wim[(size_t)k * n_bins + f] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], br[4], bi[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][tn + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        br[j] = Br[kk][tf + 16 * j];
        bi[j] = Bi[kk][tf + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc_r[i][j] = fmaf(a[i], br[j], acc_r[i][j]);
          acc_i[i][j] = fmaf(a[i], bi[j], acc_i[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int f = f0 + tf + 16 * j;
    if (f >= n_bins) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + tn + 16 * i;
      if (n < n_frames)
        out[((size_t)b * n_bins + f) * n_frames + n] =
            make_float2(acc_r[i][j], acc_i[i][j]);
    }
  }
}

}  // namespace

// xpad [B, Tp] fp32 (reflect-padded signal), wre/wim [n_fft, n_bins] fp32,
// out [B, n_bins, n_frames] complex64 (interleaved re/im).
extern "C" int stft_forward(const void* xpad, const void* wre, const void* wim,
                            void* out, int B, int Tp, int n_fft, int hop,
                            int n_frames, int n_bins, void* stream) {
  dim3 grid((n_frames + BM - 1) / BM, (n_bins + BN - 1) / BN, B);
  stft_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)xpad, (const float*)wre, (const float*)wim, (float2*)out,
      Tp, n_fft, hop, n_frames, n_bins);
  return (int)cudaGetLastError();
}
