// Dropout keep masks on the card:  out[i] = philox(seed, site; row, a, b >> 2, c)[b & 3] < thr
//
// The plain version is ``ops/dropout.py::keep_mask`` (the same Philox4x32-10
// in torch integer arithmetic, bit-identical).  The JAX package draws these
// masks with ``jax.random.bernoulli`` inside XLA (``ops/attention.py:52``,
// ``nn/ffn.py``, ``nn/attention.py``), not in a Pallas kernel; the port needs
// a kernel because the torch version costs ~220 int64 elementwise passes per
// mask element, and the unfused route's training step draws ~10^11 of them
// at the xlarge config (attention probabilities [R, H, L, L] at L 2049).
//
// Shapes: a contiguous bool mask of up to 4 dims; each of the four counter
// words (row, a, b, c) is a constant or a table (int64, values < 2^32)
// indexed by one axis of the mask.  One block per index of the leading
// axes; each thread writes 4 consecutive elements of the last axis and
// reuses its Philox draw while (row, a, b >> 2, c) stays the same, so a
// mask whose last axis is b costs about one draw per 4 elements.
// What bounds it: the integer work of the draws (~100 32-bit operations
// each) against one byte written per element.
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

struct MaskArgs {
  long long size[4];
  const long long* tab[4];  // per word: table over axis[w], or null
  long long cst[4];         // per word: the constant when tab[w] is null
  int axis[4];
  int ndim;
  uint32_t seed, site, thr;
  long long n;
};

// One block per index of the leading axes (the counter words that depend on
// them computed once); threads along the last axis, 4 consecutive elements
// each.
__global__ void keep_mask_kernel(bool* __restrict__ out, MaskArgs a) {
  const int last = a.ndim - 1;
  const long long n_last = a.size[last];
  long long idx[4] = {0, 0, 0, 0}, rem = blockIdx.x;
  for (int d = last - 1; d >= 0; --d) {
    idx[d] = rem % a.size[d];
    rem /= a.size[d];
  }
  uint32_t lead[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    lead[j] = (uint32_t)(a.tab[j] == nullptr ? a.cst[j]
                         : a.axis[j] == last ? 0 : a.tab[j][idx[a.axis[j]]]);
  bool* row = out + (long long)blockIdx.x * n_last;
  for (long long i0 = (long long)threadIdx.x * 4; i0 < n_last; i0 += (long long)blockDim.x * 4) {
    uint32_t prev[4] = {0u, 0u, 0u, 0u};
    bool have = false;
    Philox4 w;
    for (long long i = i0; i < i0 + 4 && i < n_last; ++i) {
      uint32_t ctr[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ctr[j] = (a.tab[j] != nullptr && a.axis[j] == last) ? (uint32_t)a.tab[j][i] : lead[j];
      const uint32_t lane = ctr[2] & 3u;
      ctr[2] >>= 2;
      if (!have || ctr[0] != prev[0] || ctr[1] != prev[1] || ctr[2] != prev[2] ||
          ctr[3] != prev[3]) {
        w = philox4x32_10(ctr[0], ctr[1], ctr[2], ctr[3], a.seed, a.site);
#pragma unroll
        for (int j = 0; j < 4; ++j) prev[j] = ctr[j];
        have = true;
      }
      row[i] = w.w[lane] < a.thr;
    }
  }
}

}  // namespace

// out: contiguous bool [size[0], ..., size[ndim-1]] (ndim <= 4).  For each
// counter word j (row, a, b, c): tab[j] an int64 table indexed by axis[j],
// or null and the constant cst[j].  thr the keep threshold (word < thr).
extern "C" int dropout_keep_mask(void* out, int ndim, const long long* size,
                                 const void* tab0, const void* tab1, const void* tab2,
                                 const void* tab3, const int* axis, const long long* cst,
                                 unsigned seed, unsigned site, unsigned thr, void* stream) {
  if (ndim < 1 || ndim > 4) return (int)cudaErrorInvalidValue;
  MaskArgs a;
  a.ndim = ndim;
  a.n = 1;
  for (int d = 0; d < 4; ++d) {
    a.size[d] = d < ndim ? size[d] : 1;
    a.n *= a.size[d];
  }
  const void* tabs[4] = {tab0, tab1, tab2, tab3};
  for (int j = 0; j < 4; ++j) {
    a.tab[j] = (const long long*)tabs[j];
    a.axis[j] = axis[j];
    a.cst[j] = cst[j];
  }
  a.seed = seed;
  a.site = site;
  a.thr = thr;
  if (a.n == 0) return 0;
  const long long blocks = a.n / a.size[ndim - 1];
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  keep_mask_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>((bool*)out, a);
  return (int)cudaGetLastError();
}
