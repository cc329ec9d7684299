// fp32 RMSGroupNorm of bf16 rows into shared memory, shared by the FFN-step
// and attention-step kernels.
//
// Per position, channels split into groups of ``dpg``:
//     rms = sqrt(sum_g x^2) * dpg^-1/2,   xn = x / (rms + eps) * gamma
// (eps added to the RMS, not the variance: the reference's quirk, kept by
// the JAX package's ``nn/norms.py::RMSGroupNorm``), rounded once to bf16.
#pragma once

#include <cuda_bf16.h>

typedef __nv_bfloat16 bf16;

// Shared-memory row p holds position pos0 + p of the sequence ``xr`` [L, C];
// positions outside [0, L) become zero rows (zero padding in normed space).
__device__ __forceinline__ void rmsgroupnorm_rows(
    const bf16* __restrict__ xr, int L, int pos0, int n_rows,
    const float* __restrict__ gamma, int C, int dpg, float rdpg, float eps,
    bf16* dst, int ld) {
  const int groups = C / dpg;
  for (int item = threadIdx.x; item < n_rows * groups; item += blockDim.x) {
    const int p = item / groups, g = item % groups;
    const int pos = pos0 + p;
    bf16* d = dst + p * ld + g * dpg;
    if (pos < 0 || pos >= L) {
      for (int c = 0; c < dpg; ++c) d[c] = __float2bfloat16(0.f);
      continue;
    }
    const bf16* s = xr + (size_t)pos * C + g * dpg;
    float ss = 0.f;
    for (int c = 0; c < dpg; ++c) {
      const float v = __bfloat162float(s[c]);
      ss += v * v;
    }
    const float inv = 1.f / (sqrtf(ss) * rdpg + eps);
    for (int c = 0; c < dpg; ++c)
      d[c] = __float2bfloat16(__bfloat162float(s[c]) * inv * gamma[g * dpg + c]);
  }
}
