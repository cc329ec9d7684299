// A complex fp32 FFT of M = 2^LOG2M points on G frames held in shared
// memory: the core of the STFT (#1) and the iSTFT frames (#10) in stft.cu.
//
// Stockham auto-sort, in place: one radix-2 or radix-4 stage first when LOG2M
// is not a multiple of 3, then radix-8 stages (4 passes over shared memory at
// M 1024 and 2048).  A stage that has sub-transforms of P points done reads
// x[i + r M/R] (r < R), multiplies by W_{RP}^{r k} (k = i mod P), runs a DFT
// of R points and writes y[(i - k) R + k + r P]; after the last stage the
// frame is in natural order.  ``ops/cuda/stft_kernel.py::fft_stages`` is the
// same plan in Python, and tests/test_torch_fft_plan.py runs it on the CPU.
//
// Each thread owns U units of 8 points per stage (one radix-8 butterfly, two
// radix-4 or four radix-2 ones) and holds them in registers between a
// stage's reads and its writes, so the stage needs no second buffer: G frames
// in shared memory, frame g at buf + g * ld, point j at sk(j), one float2 of
// padding every 16 points, which spreads the early stages' strided writes
// over the banks.  U * NT = G * M / 8.  The first stage reads through the
// caller's loader and the last writes through its store, so that packing a
// frame and storing the result cost no pass of their own.
//
// Twiddles come from a table built in float64 on the host and rounded to
// fp32 (no __sinf/__cosf: their error would use up the callers' 1e-4
// tolerance), laid out per stage so that neighbouring threads read
// neighbouring entries: the radix-8 stage after P > 1 points holds
// W_{8P}^{rk} at tw[P - P1 + (r - 1) P + k], r = 1..7, k < P, where P1 is the
// first such P (2 or 4 after a first radix-2 or radix-4 stage, else 8); M
// entries in all (``ops/cuda/stft_kernel.py::fft_tables_np``).
#pragma once
#include <cuda_runtime.h>

namespace fft {

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 conj(float2 a) { return make_float2(a.x, -a.y); }
__device__ __forceinline__ float2 scale(float2 a, float s) {
  return make_float2(a.x * s, a.y * s);
}
__device__ __forceinline__ float2 mul_neg_i(float2 a) { return make_float2(a.y, -a.x); }
__device__ __forceinline__ float2 mul_i(float2 a) { return make_float2(-a.y, a.x); }

// shared-memory index of point j of a frame
__device__ __forceinline__ int sk(int j) { return j + (j >> 4); }
// float2 a frame takes: points 0..M (the STFT keeps its Nyquist bin at M);
// the + 2 keeps 8 frames' rows apart by an even, non-multiple-of-16 stride
__host__ __device__ constexpr int frame_stride(int m) { return m + m / 16 + 2; }

// y = DFT_4(a), in place
__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2, float2& a3) {
  const float2 b0 = cadd(a0, a2), b1 = csub(a0, a2);
  const float2 b2 = cadd(a1, a3), b3 = mul_neg_i(csub(a1, a3));
  a0 = cadd(b0, b2);
  a1 = cadd(b1, b3);
  a2 = csub(b0, b2);
  a3 = csub(b1, b3);
}

// y = DFT_8(a), in place: even outputs are DFT_4(a_r + a_{r+4}), odd ones
// DFT_4((a_r - a_{r+4}) W_8^r)
__device__ __forceinline__ void dft8(float2* a) {
  constexpr float h = 0.70710678118654752f;
  float2 b[4], c[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    b[r] = cadd(a[r], a[r + 4]);
    c[r] = csub(a[r], a[r + 4]);
  }
  c[1] = make_float2(h * (c[1].x + c[1].y), h * (c[1].y - c[1].x));
  c[2] = mul_neg_i(c[2]);
  c[3] = make_float2(h * (c[3].y - c[3].x), -h * (c[3].x + c[3].y));
  dft4(b[0], b[1], b[2], b[3]);
  dft4(c[0], c[1], c[2], c[3]);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    a[2 * r] = b[r];
    a[2 * r + 1] = c[r];
  }
}

// Point j of frame g in shared memory.
struct FromBuf {
  const float2* buf;
  int ld;
  __device__ __forceinline__ float2 operator()(int g, int j) const {
    return buf[g * ld + sk(j)];
  }
};
struct ToBuf {
  float2* buf;
  int ld;
  __device__ __forceinline__ void operator()(int g, int j, float2 v) const {
    buf[g * ld + sk(j)] = v;
  }
};

// One stage of radix R after sub-transforms of P points (R 2 or 4 only as
// the first stage, P 1): reads point j of frame g as load(g, j), writes it
// as store(g, j, v).  The caller has synchronised the block before it; it
// returns synchronised.
template <int LOG2M, int R, int P, int NT, int U, class Load, class Store>
__device__ __forceinline__ void stage(const float2* tw, Load load, Store store) {
  constexpr int M = 1 << LOG2M, Q = M / 8;   // units per frame
  constexpr int P1 = LOG2M % 3 == 1 ? 2 : (LOG2M % 3 == 2 ? 4 : 8);
  static_assert(R == 8 || P == 1, "radix 2 and 4 run first");
  float2 v[U][8];
#pragma unroll
  for (int t = 0; t < U; ++t) {
    const int e = threadIdx.x + t * NT;
    const int u = e & (Q - 1), g = e >> (LOG2M - 3);
    if constexpr (R == 8) {
#pragma unroll
      for (int r = 0; r < 8; ++r) v[t][r] = load(g, u + r * Q);
      if constexpr (P > 1) {
        const float2* w = tw + P - P1 + (u & (P - 1));
#pragma unroll
        for (int r = 1; r < 8; ++r) v[t][r] = cmul(v[t][r], w[(r - 1) * P]);
      }
      dft8(v[t]);
    } else {
      // butterflies i = u + h Q, each on x[i + r M / R]
#pragma unroll
      for (int h = 0; h < 8 / R; ++h)
#pragma unroll
        for (int r = 0; r < R; ++r) v[t][h * R + r] = load(g, u + h * Q + r * (M / R));
#pragma unroll
      for (int h = 0; h < 8 / R; ++h) {
        float2* a = v[t] + h * R;
        if constexpr (R == 4) {
          dft4(a[0], a[1], a[2], a[3]);
        } else {
          const float2 a0 = a[0];
          a[0] = cadd(a0, a[1]);
          a[1] = csub(a0, a[1]);
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < U; ++t) {
    const int e = threadIdx.x + t * NT;
    const int u = e & (Q - 1), g = e >> (LOG2M - 3);
    if constexpr (R == 8) {
      const int k = u & (P - 1), j = (u - k) * 8 + k;
#pragma unroll
      for (int r = 0; r < 8; ++r) store(g, j + r * P, v[t][r]);
    } else {
#pragma unroll
      for (int h = 0; h < 8 / R; ++h)
#pragma unroll
        for (int r = 0; r < R; ++r) store(g, (u + h * Q) * R + r, v[t][h * R + r]);
    }
  }
  __syncthreads();
}

template <int LOG2M, int P, int NT, int U, class Store>
__device__ __forceinline__ void radix8_from(float2* buf, int ld, const float2* tw, Store last) {
  if constexpr (8 * P == (1 << LOG2M)) {
    stage<LOG2M, 8, P, NT, U>(tw, FromBuf{buf, ld}, last);
  } else {
    stage<LOG2M, 8, P, NT, U>(tw, FromBuf{buf, ld}, ToBuf{buf, ld});
    radix8_from<LOG2M, 8 * P, NT, U>(buf, ld, tw, last);
  }
}

// Forward (W = exp(-2 pi i / M)), un-normalised, of every frame: the first
// stage reads the input as first(g, j), the last one writes the output as
// last(g, j, v) (its writes run along j: y[u + r M/8]); in between the frames
// live in buf.
template <int LOG2M, int NT, int U, class Load, class Store>
__device__ __forceinline__ void forward(float2* buf, int ld, const float2* tw, Load first,
                                        Store last) {
  constexpr int R = LOG2M % 3 == 1 ? 2 : (LOG2M % 3 == 2 ? 4 : 8);
  stage<LOG2M, R, 1, NT, U>(tw, first, ToBuf{buf, ld});
  radix8_from<LOG2M, R, NT, U>(buf, ld, tw, last);
}

}  // namespace fft
