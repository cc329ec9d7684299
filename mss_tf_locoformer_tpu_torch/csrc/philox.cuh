// Counter-based dropout masks (Philox4x32-10), shared by the FFN-step and
// attention-step kernels.  ``ops/dropout.py::keep_mask`` computes the same
// bits in plain PyTorch integer arithmetic; the constants below are the ones
// it uses (Random123's Philox4x32 multipliers and Weyl key increments).
//
// A mask element is addressed by (seed, site, row, a, b, c):
//   key     = (seed, site)
//   counter = (row, a, b >> 2, c)
//   word    = b & 3 of the four 32-bit outputs
//   keep    = word < thr,  thr = round((1 - p) * 2^32)
// ``row`` is the ABSOLUTE row of the call (the caller's row offset added),
// so a call on rows [r0, r1) draws the same masks as those rows of a full
// call, and a backward regenerates its forward's masks without storing them.
// Four consecutive ``b`` share one Philox evaluation: kernels give each lane
// runs of four consecutive ``b`` where they can.
#pragma once

#include <stdint.h>

#define PHILOX_M0 0xD2511F53u
#define PHILOX_M1 0xCD9E8D57u
#define PHILOX_W0 0x9E3779B9u
#define PHILOX_W1 0xBB67AE85u

// Dropout sites (the key's second word): one per reference dropout site.
#define SITE_FFN_INNER 1u   // FFN: SwiGLU output [row, conv position, inner channel]
#define SITE_FFN_OUTER 2u   // FFN: cropped deconv output [row, position, channel]
#define SITE_ATTN_PROB 3u   // attention probabilities [row, head, key, query] (b = key)
#define SITE_ATTN_PROJ 4u   // attention out-projection [row, position, channel]

struct Philox4 {
  uint32_t w[4];
};

__device__ __forceinline__ Philox4 philox4x32_10(uint32_t c0, uint32_t c1,
                                                 uint32_t c2, uint32_t c3,
                                                 uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) {
      k0 += PHILOX_W0;
      k1 += PHILOX_W1;
    }
    const uint32_t lo0 = PHILOX_M0 * c0, hi0 = __umulhi(PHILOX_M0, c0);
    const uint32_t lo1 = PHILOX_M1 * c2, hi1 = __umulhi(PHILOX_M1, c2);
    const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0;
    c1 = lo1;
    c2 = n2;
    c3 = lo0;
  }
  Philox4 r;
  r.w[0] = c0;
  r.w[1] = c1;
  r.w[2] = c2;
  r.w[3] = c3;
  return r;
}

// The four words of the group holding b = 4*b4 .. 4*b4+3.
__device__ __forceinline__ Philox4 dropout_words(uint32_t seed, uint32_t site,
                                                 uint32_t row, uint32_t a,
                                                 uint32_t b4, uint32_t c) {
  return philox4x32_10(row, a, b4, c, seed, site);
}

__device__ __forceinline__ bool dropout_keep(uint32_t seed, uint32_t site,
                                             uint32_t row, uint32_t a,
                                             uint32_t b, uint32_t c,
                                             uint32_t thr) {
  return dropout_words(seed, site, row, a, b >> 2, c).w[b & 3] < thr;
}

// Dropout parameters as the kernels take them: ``on`` is 0 at p = 0 (every
// element kept, no scale), ``scale`` = 1/(1-p).
struct DropParams {
  uint32_t seed, thr, row0;
  float scale;
  int on;
};
