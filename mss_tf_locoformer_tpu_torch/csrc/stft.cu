// The STFT (#1) and the iSTFT's windowed frames (#10) as FFTs in shared
// memory, fp32, for power-of-two n_fft from 128 to 4096; and the iSTFT's
// overlap-add.
//
// Replaces the JAX package's Pallas kernels
// ``ops/pallas/stft_kernel.py::_frames_spectrum`` (body ``_fwd_kernel``,
// public ``stft_pallas``) and ``::_windowed_frames`` (body ``_inv_kernel``,
// public ``istft_pallas``); the overlap-add kernel does what ``istft_pallas``
// leaves to XLA after its kernel (the OLA, the window envelope, the crop).
//
// Bound.  Each function is bound by its bytes on this card: at the base
// serving shape (B 2, N 690, n_fft 2048) #1 reads 2.8 MB of audio and writes
// 11.3 MB of spectrum (4.2 us at 3.35 TB/s) against an FFT's 5 n log2 n FLOP
// per frame (0.2 us at the fp32 67 TFLOP/s); #10 at R 16 reads 90 MB and
// writes 90 MB.  A DFT product does ~75x the FFT's arithmetic and cannot
// reach that bound, so both kernels run an FFT (``fft.cuh``).
//
// Design.  A real frame of n_fft = 2M samples is packed as M complex values
// (even samples real, odd imaginary), transformed by one complex FFT of M
// points and split into the M + 1 bins with the post-twiddle
// W_N^k = exp(-2 pi i k / N) (the inverse undoes the split first, then runs
// the same forward FFT on the conjugate).  One block takes G = 8 consecutive
// frames of one signal (8 complex values of a bin row are a 64-byte store
// along frames, the fastest axis of the [.., F, N] spectrum):
//   * #1 loads the signal span its frames cover once into shared memory
//     (reflect padding computed from the index: no padded copy); the FFT's
//     first stage reads it windowed and packed, and the split runs on the
//     way out, which stores each bin row's G frames;
//   * #10 reads an [F, G] tile of the spectrum as it lies (along frames, or
//     along bins for torch.stft's transposed view: no copy), bins k and
//     M - k together, undoing the split on the way in (the imaginary parts
//     of DC and Nyquist dropped, as irfft does); the FFT's last stage writes
//     each frame along samples with the window and 1/n_fft applied;
//   * the overlap-add gathers, for each output sample, the ceil(n_fft / hop)
//     frames that cover it and divides by their summed squared window (by 1
//     where that is <= 1e-11), cropped or zero-padded to ``length``: one
//     thread per sample, no atomics, deterministic.
// Twiddles, split factors and the window come from one fp32 table built in
// float64 on the host (``ops/cuda/stft_kernel.py::fft_tables``):
//   [tw: M complex, per stage (fft.cuh)][split: M complex W_N^k][window: N floats].
// Global loads are unrolled so that each thread keeps several in flight.
// Shared memory is passed over once per FFT stage and once more by #1's
// store: the packing, the split and #10's output cost no pass of their own.
#include <cuda_runtime.h>

#include "fft.cuh"

namespace {

constexpr int kSmemOptIn = 232448;  // what one block may opt into on an H100

template <int LOG2N>
struct Plan {
  static constexpr int N = 1 << LOG2N, LOG2M = LOG2N - 1, M = N / 2;
  static constexpr int G = 8;                          // frames per block
  static constexpr int LD = fft::frame_stride(M);      // float2 per frame
  static constexpr int UNITS = G * M / 8;
  // at most 2 units (16 complex values in registers) a thread, 64 registers
  static constexpr int NT = UNITS / 2 > 256 ? UNITS / 2 : (UNITS < 256 ? UNITS : 256);
  static constexpr int U = UNITS / NT;
  static constexpr int MIN_BLOCKS = 1024 / NT;
  static_assert(U * NT == UNITS && U <= 2 && NT <= 1024, "fft plan");
};

// The first stage's input: point j of frame g is samples (2j, 2j + 1) of
// the span, windowed.
struct SpanLoad {
  const float* span;
  const float2* win2;
  int hop;
  __device__ __forceinline__ float2 operator()(int g, int j) const {
    const float2 w = win2[j];
    const float* s = span + g * hop + 2 * j;
    return make_float2(w.x * s[0], w.y * s[1]);
  }
};

template <int LOG2N>
__global__ void __launch_bounds__(Plan<LOG2N>::NT, Plan<LOG2N>::MIN_BLOCKS)
stft_fft_kernel(const float* __restrict__ audio, const float* __restrict__ tables,
                float2* __restrict__ out, int T, int hop, int n_frames) {
  using P = Plan<LOG2N>;
  constexpr int N = P::N, M = P::M, G = P::G, LD = P::LD, NT = P::NT;
  extern __shared__ float2 smem[];
  float2* tw = smem;
  float2* buf = tw + M;
  float* span = reinterpret_cast<float*>(buf + G * LD);
  const float2* table = reinterpret_cast<const float2*>(tables);
  const float2* split = table + M;
  const float2* win2 = table + 2 * M;   // (w[2j], w[2j + 1])

  const int b = blockIdx.y, n0 = blockIdx.x * G;
  const float* x = audio + (size_t)b * T;
  for (int i = threadIdx.x; i < M; i += NT) tw[i] = table[i];
  // the span of the reflect-padded signal that frames n0 .. n0 + G - 1 cover
  const int span_len = (G - 1) * hop + N, t0 = n0 * hop - N / 2;
#pragma unroll 4
  for (int s = threadIdx.x; s < span_len; s += NT) {
    int t = t0 + s;
    float v = 0.f;                    // past the padded end: frames >= n_frames
    if (t < T + N / 2) {
      t = t < 0 ? -t : t;
      t = t >= T ? 2 * (T - 1) - t : t;
      v = x[t];
    }
    span[s] = v;
  }
  __syncthreads();
  fft::forward<P::LOG2M, NT, P::U>(buf, LD, tw, SpanLoad{span, win2, hop},
                                   fft::ToBuf{buf, LD});
  // split Z (the packed frame's FFT) into bins on the way out, G frames of
  // a bin at a time: X[f] = Xe + W^f Xo, Xe = (Z[f] + conj Z[M-f]) / 2,
  // Xo = -i (Z[f] - conj Z[M-f]) / 2; X[0], X[M] = Re Z[0] +- Im Z[0]
#pragma unroll 4
  for (int e = threadIdx.x; e < (M + 1) * G; e += NT) {
    const int f = e / G, g = e % G, n = n0 + g;
    if (n >= n_frames) continue;
    const float2* z = buf + g * LD;
    float2 v;
    if (f == 0 || f == M) {
      const float2 z0 = z[0];
      v = make_float2(f == 0 ? z0.x + z0.y : z0.x - z0.y, 0.f);
    } else {
      const float2 zf = z[fft::sk(f)], zc = fft::conj(z[fft::sk(M - f)]);
      const float2 xe = fft::scale(fft::cadd(zf, zc), 0.5f);
      const float2 xo = fft::mul_neg_i(fft::scale(fft::csub(zf, zc), 0.5f));
      v = fft::cadd(xe, fft::cmul(split[f], xo));
    }
    out[((size_t)b * (M + 1) + f) * n_frames + n] = v;
  }
}

// The last stage's output: samples (2m, 2m + 1) of frame n0 + g are
// conj(y[m]) / N, windowed.
template <int M>
struct FrameStore {
  float2* frames;   // frame n0 of this spectrum
  const float2* win2;
  int rows;         // frames of this block that exist
  __device__ __forceinline__ void operator()(int g, int m, float2 y) const {
    constexpr float inv_n = 0.5f / M;   // a power of two: exact
    if (g < rows) {
      const float2 w = win2[m];
      frames[(size_t)g * M + m] = make_float2(y.x * w.x * inv_n, -y.y * w.y * inv_n);
    }
  }
};

template <int LOG2N>
__global__ void __launch_bounds__(Plan<LOG2N>::NT, Plan<LOG2N>::MIN_BLOCKS)
istft_fft_kernel(const float2* __restrict__ spec, const float* __restrict__ tables,
                 float2* __restrict__ frames, int n_frames, long long sr, long long sf,
                 long long sn) {
  using P = Plan<LOG2N>;
  constexpr int M = P::M, G = P::G, LD = P::LD, NT = P::NT, K = M / 2 + 1;
  extern __shared__ float2 smem[];
  float2* tw = smem;
  float2* buf = tw + M;
  const float2* table = reinterpret_cast<const float2*>(tables);
  const float2* split = table + M;
  const float2* win2 = table + 2 * M;

  const int r = blockIdx.y, n0 = blockIdx.x * G;
  const float2* x = spec + r * sr;
  for (int i = threadIdx.x; i < M; i += NT) tw[i] = table[i];
  // read bins k and M - k of a frame and undo the split on the way in:
  // Z[k] = A + i conj(W^k) B and Z[M - k] = conj(A - i conj(W^k) B),
  // A = X[k] + conj X[M-k], B = X[k] - conj X[M-k] (twice the packed
  // frame's spectrum), stored conjugated so that the forward FFT inverts it.
  // The spectrum is strided (sr, sf, sn): neighbouring threads take
  // neighbouring frames where frames are contiguous (8 frames of a bin, 64
  // bytes), else neighbouring bins of a frame (torch.stft's transposed view).
  const bool along_frames = sn == 1;
#pragma unroll 4
  for (int e = threadIdx.x; e < K * G; e += NT) {
    const int k = along_frames ? e / G : e % K, g = along_frames ? e % G : e / K;
    const int n = n0 + g;
    float2* z = buf + g * LD;
    float2 xk = make_float2(0.f, 0.f), xm = xk;
    if (n < n_frames) {
      xk = x[k * sf + n * sn];
      xm = x[(M - k) * sf + n * sn];
    }
    if (k == 0) {   // irfft drops the imaginary parts of DC and Nyquist
      z[0] = make_float2(xk.x + xm.x, xm.x - xk.x);
      continue;
    }
    const float2 xc = fft::conj(xm);
    const float2 a = fft::cadd(xk, xc);
    const float2 c = fft::mul_i(fft::cmul(fft::conj(split[k]), fft::csub(xk, xc)));
    z[fft::sk(k)] = fft::conj(fft::cadd(a, c));
    z[fft::sk(M - k)] = fft::csub(a, c);
  }
  __syncthreads();
  fft::forward<P::LOG2M, NT, P::U>(
      buf, LD, tw, fft::FromBuf{buf, LD},
      FrameStore<M>{frames + ((size_t)r * n_frames + n0) * M, win2, n_frames - n0});
}

constexpr int OLA_NT = 256;

__global__ void __launch_bounds__(OLA_NT) overlap_add_kernel(
    const float* __restrict__ frames, const float* __restrict__ window,
    float* __restrict__ out, int n_frames, int n_fft, int hop, int length) {
  const int r = blockIdx.y, t = blockIdx.x * OLA_NT + threadIdx.x;
  if (t >= length) return;
  const int q = t + n_fft / 2;   // position in the un-cropped signal
  const int n_hi = min(n_frames - 1, q / hop);
  const int n_lo = q < n_fft ? 0 : (q - n_fft) / hop + 1;
  const float* f = frames + (size_t)r * n_frames * n_fft;
  float y = 0.f, env = 0.f;
  for (int n = n_lo; n <= n_hi; ++n) {   // empty past the end: zero padding
    const int j = q - n * hop;
    const float w = window[j];
    y += f[(size_t)n * n_fft + j];
    env += w * w;
  }
  out[(size_t)r * length + t] = y / (env > 1e-11f ? env : 1.f);
}

// Shared memory of one block: the twiddles, G frames (fft::frame_stride) and,
// for #1, the signal span the G frames cover.
int stft_bytes(int log2n, int hop, bool inverse) {
  const int n = 1 << log2n, m = n / 2, g = 8;
  return 8 * m + 8 * g * fft::frame_stride(m) + (inverse ? 0 : 4 * ((g - 1) * hop + n));
}

template <typename K>
int set_smem(K kernel, int bytes) {
  if (bytes > kSmemOptIn) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int LOG2N>
int launch_stft(const float* audio, const float* tables, float2* out, int B, int T,
                int hop, int n_frames, cudaStream_t stream) {
  using P = Plan<LOG2N>;
  const int bytes = stft_bytes(LOG2N, hop, false);
  if (int rc = set_smem(stft_fft_kernel<LOG2N>, bytes)) return rc;
  dim3 grid((n_frames + P::G - 1) / P::G, B);
  stft_fft_kernel<LOG2N><<<grid, P::NT, bytes, stream>>>(audio, tables, out, T, hop, n_frames);
  return (int)cudaGetLastError();
}

template <int LOG2N>
int launch_istft(const float2* spec, const float* tables, float2* frames, int R,
                 int n_frames, const long long* strides, cudaStream_t stream) {
  using P = Plan<LOG2N>;
  const int bytes = stft_bytes(LOG2N, 0, true);
  if (int rc = set_smem(istft_fft_kernel<LOG2N>, bytes)) return rc;
  dim3 grid((n_frames + P::G - 1) / P::G, R);
  istft_fft_kernel<LOG2N><<<grid, P::NT, bytes, stream>>>(spec, tables, frames, n_frames,
                                                          strides[0], strides[1], strides[2]);
  return (int)cudaGetLastError();
}

int log2_of(int n_fft) {
  for (int l = 7; l <= 12; ++l)
    if (n_fft == 1 << l) return l;
  return 0;
}

}  // namespace

// audio [B, T] fp32, tables (see above), out [B, n_fft/2 + 1, n_frames]
// complex64 (interleaved re/im); T > n_fft / 2.  A hop whose block
// (stft_bytes) exceeds the card's shared memory returns cudaErrorInvalidValue.
extern "C" int stft_forward(const void* audio, const void* tables, void* out, int B,
                            int T, int n_fft, int hop, int n_frames, void* stream) {
  const float* a = (const float*)audio;
  const float* tb = (const float*)tables;
  float2* o = (float2*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (log2_of(n_fft)) {
    case 7: return launch_stft<7>(a, tb, o, B, T, hop, n_frames, s);
    case 8: return launch_stft<8>(a, tb, o, B, T, hop, n_frames, s);
    case 9: return launch_stft<9>(a, tb, o, B, T, hop, n_frames, s);
    case 10: return launch_stft<10>(a, tb, o, B, T, hop, n_frames, s);
    case 11: return launch_stft<11>(a, tb, o, B, T, hop, n_frames, s);
    case 12: return launch_stft<12>(a, tb, o, B, T, hop, n_frames, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// spec [R, n_fft/2 + 1, n_frames] complex64 at the complex strides
// (sr, sf, sn), frames [R, n_frames, n_fft] fp32.
extern "C" int istft_frames(const void* spec, const void* tables, void* frames, int R,
                            int n_fft, int n_frames, long long sr, long long sf,
                            long long sn, void* stream) {
  const float2* x = (const float2*)spec;
  const long long st[3] = {sr, sf, sn};
  const float* tb = (const float*)tables;
  float2* o = (float2*)frames;
  cudaStream_t s = (cudaStream_t)stream;
  switch (log2_of(n_fft)) {
    case 7: return launch_istft<7>(x, tb, o, R, n_frames, st, s);
    case 8: return launch_istft<8>(x, tb, o, R, n_frames, st, s);
    case 9: return launch_istft<9>(x, tb, o, R, n_frames, st, s);
    case 10: return launch_istft<10>(x, tb, o, R, n_frames, st, s);
    case 11: return launch_istft<11>(x, tb, o, R, n_frames, st, s);
    case 12: return launch_istft<12>(x, tb, o, R, n_frames, st, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// frames [R, n_frames, n_fft] fp32 (windowed), window [n_fft] fp32,
// out [R, length] fp32: torch.istft's overlap-add, envelope and centre crop.
extern "C" int istft_overlap_add(const void* frames, const void* window, void* out, int R,
                                 int n_frames, int n_fft, int hop, int length,
                                 void* stream) {
  dim3 grid((length + OLA_NT - 1) / OLA_NT, R);
  overlap_add_kernel<<<grid, OLA_NT, 0, (cudaStream_t)stream>>>(
      (const float*)frames, (const float*)window, (float*)out, n_frames, n_fft, hop, length);
  return (int)cudaGetLastError();
}
