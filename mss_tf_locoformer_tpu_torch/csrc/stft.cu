// STFT as a window-folded real DFT, fp32, frames read in place; and the
// iSTFT's windowed inverse real DFT (its frames), fp32, spectrum read in place.
//
// ---- forward ---------------------------------------------------------------
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

// ---- inverse ---------------------------------------------------------------
//
// Replaces the JAX package's Pallas kernel
// ``ops/pallas/stft_kernel.py::_windowed_frames`` (body ``_inv_kernel``),
// public ``istft_pallas``; the overlap-add, the window envelope and the crop
// stay outside, as the JAX wrapper leaves them to XLA.
//
//   frames[r, n, k] = sum_{j < 2F} X[r, n, j] * T[j, k]
//   X[r, n, 2f + c] = (re, im)[c] of spec[r, f, n]   (complex64 [R, F, N])
//   T[2f, k]     =  a_f cos(2 pi f k / n_fft) w[k] / n_fft
//   T[2f + 1, k] = -a_f sin(2 pi f k / n_fft) w[k] / n_fft
//
// with a_f = 1 at DC and Nyquist and 2 between (the Hermitian weights), so
// each frame is irfft(spec[r, :, n]) * w; real and imaginary parts share one
// accumulator over K = 2F.  The [F, N] -> [N, F] transpose is folded into the
// tile loads (each (re, im) pair is one 8-byte load, coalesced along frames),
// so no padded or transposed copy of the spectrum is made; the ragged K tail
// (F = 1025 = 64 * 16 + 1 at n_fft 2048) is zero-filled.  The TPU kernel asks
// for fp32 accuracy (Precision.HIGHEST), so the products are fp32 FMAs: at
// the BS-Locoformer engine batch (R 16, N 690, n_fft 2048) that is 9.3e10
// FLOP against 181 MB moved, bound by this card's fp32 rate (no TF32: its
// 10-bit mantissa would cost the transform's accuracy).  A plain shared-
// memory-tiled SGEMM: 64 frames x 64 samples per block, K steps of 16 (8 bins
// x re/im), 4 frames x 4 consecutive samples per thread, float4 table loads
// and float4 stores along samples, the fastest axis of [R, N, n_fft].

constexpr int IBM = 64;  // frames per block
constexpr int IBN = 64;  // frame samples per block
constexpr int IBK = 16;  // table rows per k-step: 8 bins x (re, im)

__global__ void __launch_bounds__(NT) istft_frames_kernel(
    const float2* __restrict__ spec, const float* __restrict__ table,
    float* __restrict__ frames, int n_bins, int n_frames, int n_fft) {
  __shared__ float As[IBK][IBM];
  __shared__ __align__(16) float Bs[IBK][IBN];

  const int r = blockIdx.z;
  const int n0 = blockIdx.x * IBM;
  const int s0 = blockIdx.y * IBN;
  const int ts = threadIdx.x % 16;  // samples s0 + 4*ts .. +3
  const int tn = threadIdx.x / 16;  // frames  n0 + tn + 16*i
  const float2* x = spec + (size_t)r * n_bins * n_frames;
  const int K = 2 * n_bins;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += IBK) {
    const int f0 = k0 / 2;
    for (int e = threadIdx.x; e < (IBK / 2) * IBM; e += NT) {
      const int fl = e / IBM, m = e % IBM;
      const int f = f0 + fl, n = n0 + m;
      const float2 v = (f < n_bins && n < n_frames) ? x[(size_t)f * n_frames + n]
                                                    : make_float2(0.f, 0.f);
      As[2 * fl][m] = v.x;
      As[2 * fl + 1][m] = v.y;
    }
    {
      const int row = threadIdx.x / 16, c4 = threadIdx.x % 16;  // NT = 16 x 16
      const int j = k0 + row, s = s0 + 4 * c4;
      const float4 v = (j < K && s < n_fft)
                           ? *(const float4*)(table + (size_t)j * n_fft + s)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      *(float4*)&Bs[row][4 * c4] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < IBK; ++kk) {
      const float4 b = *(const float4*)&Bs[kk][4 * ts];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = As[kk][tn + 16 * i];
        acc[i][0] = fmaf(a, b.x, acc[i][0]);
        acc[i][1] = fmaf(a, b.y, acc[i][1]);
        acc[i][2] = fmaf(a, b.z, acc[i][2]);
        acc[i][3] = fmaf(a, b.w, acc[i][3]);
      }
    }
    __syncthreads();
  }

  const int s = s0 + 4 * ts;
  if (s >= n_fft) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + tn + 16 * i;
    if (n < n_frames)
      *(float4*)(frames + ((size_t)r * n_frames + n) * n_fft + s) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
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

// spec [R, n_bins, n_frames] complex64 (interleaved re/im), table
// [2 n_bins, n_fft] fp32 (rows re/im interleaved per bin), frames
// [R, n_frames, n_fft] fp32; n_fft a multiple of 4 (float4 rows).
extern "C" int istft_frames(const void* spec, const void* table, void* frames, int R,
                            int n_bins, int n_frames, int n_fft, void* stream) {
  dim3 grid((n_frames + IBM - 1) / IBM, (n_fft + IBN - 1) / IBN, R);
  istft_frames_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float2*)spec, (const float*)table, (float*)frames, n_bins, n_frames, n_fft);
  return (int)cudaGetLastError();
}
