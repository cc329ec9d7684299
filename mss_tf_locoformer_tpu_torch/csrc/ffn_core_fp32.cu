// fp32 rows of the FFN GEMMs on the tensor cores in 3xTF32 (tf32x3.cuh):
// those of the unfused route's FFN core, #8 (forward) and #9 (backward), and
// those of the fused FFN step, #2 (forward) and #5 (backward).
//
// Replace, for fp32 rows, the JAX package's Pallas kernels
//   ops/pallas/swiglu_ffn.py:221 _forward (pallas_call :244, body _kernel :153),
//   ops/pallas/swiglu_ffn.py:363 _backward_pallas (pallas_call :398, body
//   _bwd_kernel :286),
//   ops/pallas/swiglu_block.py:279 _blk_forward, :456 _blk_backward
// at their fp32 itemsize.  ops/cuda/unfused_fp32.py (#8, #9) and
// ops/cuda/step_fp32.py (#2, #5) chain them per row group (the conv with the
// SwiGLU epilogue and the deconv; in the backward the conv again, dh, dx,
// the two weight products and the bias gradients' column sums), with
// step_fp32.cu's norms, outer mask and fixed-order reductions around them;
// the FFMA GEMMs of step_fp32.cu (gemm_nn, gemm_tn) run in no FFN.
//
// Design: every product is fp32 to within FFMA's error but runs on the tensor
// cores: each operand splits into TF32 hi and lo halves (rounded to nearest)
// and lo hi' + hi lo' + hi hi' accumulates in fp32 (tf32x3.cuh).  The tensor
// cores truncate as they add, which over a long sum biases every output
// toward zero (by ~7e-5 of itself at #9's dx, K 8192, measured on an H100);
// so a stage's products (4 k8 steps x 3
// passes) go into an accumulator that is added, rounded, into a running fp32
// sum after each stage, which keeps the error at FFMA's (~1e-6).  Bound:
// three times the FLOP at the dense TF32 peak (494.7 TFLOP/s), 0.41x the
// FFMA bound.
//   core_nn    out = epilogue(A B), one kernel for the conv, the deconv, dh
//              and dx.  A's rows are windows of a per-row buffer (Win: the
//              conv's k taps of C channels are k C consecutive floats of the
//              pre-padded row, zero outside the row; the deconv's and dx's
//              windows start k - 1 positions early), so A is K-major as it
//              lies in memory: an implicit im2col, 32 floats of k a stage.
//              B is a weight panel laid out K-major ([N][K]) and split into
//              hi and lo once, when the panels are made.  The products run on
//              wgmma.mma_async m64nNk8 .tf32, which takes B only K-major from
//              shared memory (no transpose) and A from shared memory or from
//              registers: A is read into registers as the fragments (one
//              read and one split per element, no hi/lo tiles), B's hi and lo
//              tiles by descriptor.  128 x BN tiles (BN 128; 96 at N 96, the
//              base config's width; 64 where N is narrow), two consumer
//              warpgroups of 64 rows, a 4-stage cp.async ring (three stages
//              in flight), 128-byte swizzled rows.
//              Epilogues: store (+ bias); SwiGLU with the inner dropout site
//              at (row, conv position, inner channel), the pre-activation kept
//              for the backward; the SwiGLU backward (dh -> dy); the FFN
//              step's output, res + drop_outer(acc + bias) with the outer site
//              at (row, position, channel), or with no residual the partial
//              sum alone.  Value and gate columns stay interleaved (2i,
//              2i + 1), so a pair is one thread's.
//   core_tn    weight gradients, part[s] = A^T B over the positions of
//              split s: both operands are position-major (the positions are
//              the sum), so neither is K-major, and the products run on
//              mma.sync m16n8k8 .tf32 with fragments read from shared memory
//              and split in registers (one split per fragment element a
//              warp reads).  A wgmma version that split and transposed the
//              tiles into K-major ones in shared memory ran 1.27x slower at
//              xlarge (its stores and selects).  128 x 128 tiles, 8 warps of
//              64 x 32, 32 positions a stage, 3-stage cp.async ring.  One fp32
//              partial per position split, no atomics: the wrapper sums them
//              in a fixed order, so reruns give the same bits.
//   core_colsum  the bias gradients' column sums per position split, 64
//              float4 columns a block and 4 position lanes summed in order.
// What it gives up: the SwiGLU output h, the pre-activation y and dy still
// pass through device memory between the GEMMs (~80 GB at #9's xlarge
// training shape, a few percent of its time at the TF32 rate), and each
// stage's wgmma products are waited for before the next stage's are issued.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "philox.cuh"
#include "tf32x3.cuh"

// Internal linkage throughout: another build of this file loaded in the same
// process (a benchmark's parent checkout) shares no symbol with this one.
namespace fc32 {
namespace {

using namespace tf32x3;

constexpr int NT = 256;                  // threads: two warpgroups / 8 warps
constexpr int BM = 128;                  // rows of a tile (both kernels)
constexpr int BK = 32;                   // k (core_nn) or positions (core_tn) a stage
constexpr int STAGES = 3;                // core_tn's ring
constexpr int ROWB = BK * 4;             // bytes of a swizzled row: 32 floats
constexpr int TN_LD = BM + 8;            // core_tn's staged rows (floats): conflict-free fragments
constexpr int TN_STAGE = 2 * BK * TN_LD * 4;

// core_nn's shared memory at tile width BN: per stage the A tile (128 rows)
// and the B hi and lo tiles (BN rows) of 128-byte rows, four stages, and
// 1 KB to align the ring to the swizzle's atoms (at BN 64, 96 and 128 every
// tile starts on a 1 KB boundary).
constexpr int NN_STAGES = 4;
__host__ __device__ constexpr int nn_stage(int bn) { return BM * ROWB + 2 * bn * ROWB; }
__host__ __device__ constexpr int nn_smem(int bn) { return NN_STAGES * nn_stage(bn) + 1024; }
constexpr int TN_SMEM = STAGES * TN_STAGE;

enum { EPI_STORE = 0, EPI_SWIGLU = 1, EPI_SWIGLU_BWD = 2, EPI_OUT = 3 };

// A matrix whose row m = (r, p), r = m / P, is the window of the per-row
// buffer p_ + r * rs starting at offset p * ps + shift; an element whose
// offset lies outside [0, lim) is zero.  Strides, shifts and limits are
// multiples of 4 floats and the buffer is 16-byte aligned (the wrapper
// checks), so a 16-byte chunk is all in or all out (step_fp32.cu's Win).
struct Win {
  const float* p_;
  long long rs, P, ps, shift, lim;
};

struct Epi {
  float* out;
  long long ldo;
  const float* bias;  // [N] or null
  float* y;           // SwiGLU: the pre-activation out (null: not kept); its backward: y in
  const float* res;   // EPI_OUT: the residual [M, N] (null: the partial sum alone)
  long long P;        // positions per row, for the mask coordinates
  uint32_t site;
  DropParams dp;
};

__device__ __forceinline__ float sigmoidf_(float g) { return 1.f / (1.f + expf(-g)); }

// Byte offset of 16-byte chunk c of row r in a 128-byte swizzled tile.
__device__ __forceinline__ uint32_t sw(int r, int c) { return r * ROWB + ((c ^ (r & 7)) << 4); }

// Dropout words of core_nn's epilogues.  A quad of lanes (c = lane % 4)
// holds columns 8j + 2c, 8j + 2c + 1 of each 8-column slab j at two rows
// (h = 0, 1: the row's (absolute row, position) in row[h], pos[h]); a
// Philox group covers 4 consecutive mask channels, so a quad needs four
// groups for a slab pair (SwiGLU: one channel a lane) or for one slab (the
// other epilogues: a channel pair a lane).  Each lane draws one of them and
// the quad exchanges words, so no group is drawn twice.  Every lane of the
// warp must call (the shuffles).
__device__ __forceinline__ uint32_t sel4(const Philox4& d, int i) {
  return (i & 2) ? ((i & 1) ? d.w[3] : d.w[2]) : ((i & 1) ? d.w[1] : d.w[0]);
}

// SwiGLU: lane c's channel in slab j0 + s is 4 (b0 + s) + c.  Lane c draws
// group b0 + (c >> 1) at row c & 1; w[s][h] = word c of group b0 + s at
// row h (in round t lane c reads lane c ^ t's draw, which sends the word
// its reader needs).
__device__ __forceinline__ void quad_channel_words(uint32_t seed, uint32_t site,
                                                   const uint32_t (&row)[2],
                                                   const uint32_t (&pos)[2], uint32_t b0, int c,
                                                   uint32_t (&w)[2][2]) {
  const Philox4 d = dropout_words(seed, site, (c & 1) ? row[1] : row[0],
                                  (c & 1) ? pos[1] : pos[0], b0 + (c >> 1), 0u);
  uint32_t got[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const uint32_t mine = sel4(d, c ^ t);
    got[t] = t ? __shfl_xor_sync(0xffffffffu, mine, t) : mine;
  }
  // the draw of (slab s, row h) came from lane 2s + h, in round (2s + h) ^ c
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = (2 * s + h) ^ c;
      w[s][h] = (t & 2) ? ((t & 1) ? got[3] : got[2]) : ((t & 1) ? got[1] : got[0]);
    }
}

// Channel pairs: lane c's pair 8j + 2c, + 1 lies in group b0 + (c >> 1),
// words 2 (c & 1) and 2 (c & 1) + 1.  Lane c draws that group at row c & 1
// and swaps the other row's two words with lane c ^ 1; w[h] = this lane's
// two words at row h.
__device__ __forceinline__ void quad_pair_words(uint32_t seed, uint32_t site,
                                                const uint32_t (&row)[2],
                                                const uint32_t (&pos)[2], uint32_t b0, int c,
                                                uint32_t (&w)[2][2]) {
  const bool odd = c & 1;
  const Philox4 d = dropout_words(seed, site, odd ? row[1] : row[0], odd ? pos[1] : pos[0],
                                  b0 + (c >> 1), 0u);
  const uint32_t own0 = odd ? d.w[2] : d.w[0], own1 = odd ? d.w[3] : d.w[1];
  const uint32_t oth0 = __shfl_xor_sync(0xffffffffu, odd ? d.w[0] : d.w[2], 1);
  const uint32_t oth1 = __shfl_xor_sync(0xffffffffu, odd ? d.w[1] : d.w[3], 1);
  w[0][0] = odd ? oth0 : own0;
  w[0][1] = odd ? oth1 : own1;
  w[1][0] = odd ? own0 : oth0;
  w[1][1] = odd ? own1 : oth1;
}

// out[m, n] = epilogue(sum_k A(m, k) B[n, k]) for m < M, n < N; K and N
// multiples of 4.  Block b: N tile b % ntn (the fastest, so the blocks of one
// row tile run together and share its A rows in L2), row tile b / ntn.
template <int EPI, int BN>
__global__ void __launch_bounds__(NT, 1)
    core_nn(Win a, long long M, int K, const float* __restrict__ bhi,
            const float* __restrict__ blo, int N, int ntn, Epi e) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (hop::smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - hop::smem_u32(smem_raw));
  constexpr int STAGE = nn_stage(BN);
  constexpr int B_HI = BM * ROWB, B_LO = B_HI + BN * ROWB;
  const int t = threadIdx.x, wg = t >> 7, warp = (t >> 5) & 3, lane = t & 31;
  const int n0 = (int)(blockIdx.x % ntn) * BN;
  const long long m0 = (long long)(blockIdx.x / ntn) * BM;
  const int KT = (K + BK - 1) / BK;
  // this thread's A chunks: rows t/8 + 32j, chunk t%8 of every stage
  const int ch = t & 7, r8 = t >> 3;
  const float* arow[4];
  long long aoff[4];
  bool aok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const long long m = m0 + r8 + 32 * j;
    aok[j] = m < M;
    const long long r = aok[j] ? m / a.P : 0, p = aok[j] ? m - r * a.P : 0;
    arow[j] = a.p_ + r * a.rs;
    aoff[j] = p * a.ps + a.shift + ch * 4;
  }
  auto load = [&](int st, int kt) {
    const uint32_t s = base + st * STAGE;
    const int k = kt * BK + ch * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long off = aoff[j] + kt * BK;
      const bool ok = aok[j] && k < K && off >= 0 && off < a.lim;
      cp_async16(s + sw(r8 + 32 * j, ch), ok ? arow[j] + off : a.p_, ok);
    }
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) {
      const int n = n0 + r8 + 32 * j;
      const bool ok = n < N && k < K;
      const long long o = ok ? (long long)n * K + k : 0;
      cp_async16(s + B_HI + sw(r8 + 32 * j, ch), bhi + o, ok);
      cp_async16(s + B_LO + sw(r8 + 32 * j, ch), blo + o, ok);
    }
  };
  // this lane's A fragment rows (ar, ar + 8 of the tile); the tensor cores
  // sum a stage (4 k8 steps x 3 passes) into acc, truncating as they add,
  // and sum takes each stage's total in fp32, rounded
  const int fg = lane >> 2, fc = lane & 3, ar = wg * 64 + warp * 16 + fg;
  float acc[BN / 2], sum[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = sum[i] = 0.f;
#pragma unroll
  for (int s = 0; s < NN_STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    // stage kt landed for every thread, and every warpgroup is done with
    // stage kt - 1, whose buffer takes stage kt + 3
    cp_async_wait<NN_STAGES - 2>();
    hop::fence_proxy_async();
    __syncthreads();
    if (kt + NN_STAGES - 1 < KT) load((kt + NN_STAGES - 1) % NN_STAGES, kt + NN_STAGES - 1);
    cp_async_commit();
    const uint32_t s = base + (kt % NN_STAGES) * STAGE;
    const unsigned char* sa = gbase + (kt % NN_STAGES) * STAGE;
    // A's fragments read once and split in registers: rows ar, ar + 8 at k
    // 8 kk + c (chunk 2 kk) and 8 kk + c + 4 (chunk 2 kk + 1), 32 banks
    uint32_t ah[BK / 8][4], al[BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const float v[4] = {*(const float*)(sa + sw(ar, 2 * kk) + fc * 4),
                          *(const float*)(sa + sw(ar + 8, 2 * kk) + fc * 4),
                          *(const float*)(sa + sw(ar, 2 * kk + 1) + fc * 4),
                          *(const float*)(sa + sw(ar + 8, 2 * kk + 1) + fc * 4)};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const Split x = split(v[q]);
        ah[kk][q] = x.hi;
        al[kk][q] = x.lo;
      }
    }
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
      wgmma_rs_3x<BN>(acc, ah[kk], al[kk], hop::desc_sw128(s + B_HI + kk * 32, 16, 1024),
                      hop::desc_sw128(s + B_LO + kk * 32, 16, 1024), kk > 0);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs<BN / 2>(acc);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sum[i] += acc[i];
  }
  // sum[4j + 2h + e] = D[16 warp + g + 8h][8j + 2c + e] of this warpgroup's rows
  const int g = lane >> 2, c = lane & 3;
  long long mr[2];
  uint32_t row[2], pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mr[h] = m0 + wg * 64 + warp * 16 + g + 8 * h;
    const long long r = mr[h] / e.P;
    row[h] = e.dp.row0 + (uint32_t)r;
    pos[h] = (uint32_t)(mr[h] - r * e.P);
  }
  // a mask is drawn by every lane or by none (the quads exchange words)
  const bool drop = EPI != EPI_STORE && e.dp.on && (EPI != EPI_OUT || e.res);
  uint32_t wch[2][2] = {}, wpr[2][2] = {};   // quad_channel_words' and quad_pair_words'
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * c;
    if (drop && EPI == EPI_SWIGLU && j % 2 == 0)
      quad_channel_words(e.dp.seed, e.site, row, pos, (uint32_t)((n0 >> 3) + j), c, wch);
    if (drop && EPI != EPI_SWIGLU)
      quad_pair_words(e.dp.seed, e.site, row, pos, (uint32_t)((n0 + 8 * j) >> 2), c, wpr);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = mr[h];
      if (m >= M || n >= N) continue;
      const float a0 = sum[4 * j + 2 * h], a1 = sum[4 * j + 2 * h + 1];
      if (EPI == EPI_STORE) {
        const float b0 = e.bias ? e.bias[n] : 0.f, b1 = e.bias ? e.bias[n + 1] : 0.f;
        *reinterpret_cast<float2*>(e.out + m * e.ldo + n) = make_float2(a0 + b0, a1 + b1);
      } else if (EPI == EPI_OUT) {
        // out = res + drop_outer(acc + bias) at (row, position, channel)
        float v0 = a0, v1 = a1;
        if (e.res) {
          if (e.bias) v0 += e.bias[n], v1 += e.bias[n + 1];
          if (drop) {
            v0 = wpr[h][0] < e.dp.thr ? v0 * e.dp.scale : 0.f;
            v1 = wpr[h][1] < e.dp.thr ? v1 * e.dp.scale : 0.f;
          }
          const float2 rv = *reinterpret_cast<const float2*>(e.res + m * N + n);
          v0 += rv.x;
          v1 += rv.y;
        }
        *reinterpret_cast<float2*>(e.out + m * e.ldo + n) = make_float2(v0, v1);
      } else if (EPI == EPI_SWIGLU) {
        // columns interleave (value, gate): n = 2i, n + 1 of inner channel i
        const float v = a0 + e.bias[n], gt = a1 + e.bias[n + 1];
        if (e.y) *reinterpret_cast<float2*>(e.y + m * N + n) = make_float2(v, gt);
        float hv = v * (gt * sigmoidf_(gt));
        if (drop) hv = wch[j % 2][h] < e.dp.thr ? hv * e.dp.scale : 0.f;
        e.out[m * e.ldo + (n >> 1)] = hv;
      } else {   // EPI_SWIGLU_BWD: columns i = n, n + 1 of dh -> dy's pairs (2i, 2i + 1)
        const float dhs[2] = {a0, a1};
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int i = n + q;
          float dh = dhs[q];
          if (drop) dh = wpr[h][q] < e.dp.thr ? dh * e.dp.scale : 0.f;
          const float2 vg = *reinterpret_cast<const float2*>(e.y + m * 2 * N + 2 * i);
          const float sg = sigmoidf_(vg.y);
          *reinterpret_cast<float2*>(e.out + m * e.ldo + 2 * i) =
              make_float2(dh * (vg.y * sg), dh * vg.x * (sg * (1.f + vg.y * (1.f - sg))));
        }
      }
    }
  }
}

// part[s][m][n] = sum over positions q of split s of A(q, m) B(q, n); M and
// N multiples of 4.  Block (b, s): tile b (N tile b % ntn, M tile b / ntn).
__global__ void __launch_bounds__(NT, 1)
    core_tn(Win a, int M, Win b, int N, int ntn, long long total, long long per,
            float* __restrict__ part) {
  extern __shared__ __align__(16) float tsm[];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int m0 = (int)(blockIdx.x / ntn) * BM, n0 = (int)(blockIdx.x % ntn) * BM;
  const long long q0 = (long long)blockIdx.y * per;
  const long long q1 = total < q0 + per ? total : q0 + per;
  const int KT = q1 > q0 ? (int)((q1 - q0 + BK - 1) / BK) : 0;
  // this thread's position (t / 8 of each stage) and chunks t%8 + 8j of it;
  // A and B share the position, so one (row, position) pair walks both
  const int qi = t >> 3, c8 = t & 7;
  long long q = q0 + qi;
  long long ra = q / a.P, pa = q - ra * a.P, rb = q / b.P, pb = q - rb * b.P;
  auto load = [&](int st) {
    float* as = tsm + st * (TN_STAGE / 4);
    float* bs = as + BK * TN_LD;
    const bool qok = q < q1;
    const float* arow = a.p_ + ra * a.rs;
    const float* brow = b.p_ + rb * b.rs;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cc = c8 + 8 * j;   // chunk of 4 columns
      const long long oa = pa * a.ps + a.shift + m0 + 4 * cc;
      const bool oka = qok && m0 + 4 * cc < M && oa >= 0 && oa < a.lim;
      cp_async16(hop::smem_u32(as + qi * TN_LD + 4 * cc), oka ? arow + oa : a.p_, oka);
      const long long ob = pb * b.ps + b.shift + n0 + 4 * cc;
      const bool okb = qok && n0 + 4 * cc < N && ob >= 0 && ob < b.lim;
      cp_async16(hop::smem_u32(bs + qi * TN_LD + 4 * cc), okb ? brow + ob : b.p_, okb);
    }
    // the next stage's position, 32 on
    q += BK;
    pa += BK;
    while (pa >= a.P) pa -= a.P, ++ra;
    pb += BK;
    while (pb >= b.P) pb -= b.P, ++rb;
  };
  // a stage's products in acc (the tensor cores truncate as they add), the
  // stages' totals in sum (fp32, rounded)
  float acc[4][4][4], sum[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = sum[i][j][v] = 0.f;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32, g = lane >> 2, c = lane & 3;
  if (KT > 0) load(0);
  cp_async_commit();
  if (KT > 1) load(1);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<1>();
    __syncthreads();   // stage kt landed for every thread; stage kt - 1 read by every warp
    if (kt + 2 < KT) load((kt + 2) % STAGES);
    cp_async_commit();
    const float* as = tsm + (kt % STAGES) * (TN_STAGE / 4);
    const float* bs = as + BK * TN_LD;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      const float* a0 = as + (kk + c) * TN_LD + wm + g;
      const float* b0 = bs + (kk + c) * TN_LD + wn + g;
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const Split s0 = split(b0[8 * j]), s1 = split(b0[4 * TN_LD + 8 * j]);
        bh[j][0] = s0.hi, bl[j][0] = s0.lo, bh[j][1] = s1.hi, bl[j][1] = s1.lo;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* ai = a0 + 16 * i;
        const Split x0 = split(ai[0]), x1 = split(ai[8]), x2 = split(ai[4 * TN_LD]),
                    x3 = split(ai[4 * TN_LD + 8]);
        const uint32_t ah[4] = {x0.hi, x1.hi, x2.hi, x3.hi}, al[4] = {x0.lo, x1.lo, x2.lo, x3.lo};
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_3x(acc[i][j], ah, al, bh[j], bl[j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) sum[i][j][v] += acc[i][j][v], acc[i][j][v] = 0.f;
  }
  float* out = part + (long long)blockIdx.y * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + 16 * i + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + 8 * j + 2 * c;
        if (n < N)
          *reinterpret_cast<float2*>(out + (long long)m * N + n) =
              make_float2(sum[i][j][2 * h], sum[i][j][2 * h + 1]);
      }
    }
}

// part[s][c] = sum over positions q of split s of A(q, c), c < W (a multiple
// of 4): CL float4 columns a block, RL = 256 / CL position lanes each
// summing every RL-th position, then the lanes summed in order (the same
// bits every run).
constexpr int CS_CL = 64;

__global__ void __launch_bounds__(NT)
    core_colsum(Win a, int W, long long total, long long per, float* __restrict__ part) {
  __shared__ float4 red[NT];
  const int w4 = W / 4, cl = w4 < CS_CL ? w4 : CS_CL, rl = NT / cl;
  const int t = threadIdx.x, lc = t % cl, lr = t / cl;
  const int c4 = blockIdx.x * cl + lc;
  const long long q0 = (long long)blockIdx.y * per;
  const long long q1 = total < q0 + per ? total : q0 + per;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (lr < rl && c4 < w4) {
    long long q = q0 + lr, r = q / a.P, p = q - r * a.P;
    for (; q < q1; q += rl) {
      const long long off = p * a.ps + a.shift + 4 * c4;
      if (off >= 0 && off < a.lim) {
        const float4 v = *reinterpret_cast<const float4*>(a.p_ + r * a.rs + off);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      p += rl;
      while (p >= a.P) p -= a.P, ++r;
    }
  }
  red[t] = acc;
  __syncthreads();
  if (lr == 0 && c4 < w4) {
    for (int i = 1; i < rl; ++i) {
      const float4 v = red[i * cl + lc];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    *reinterpret_cast<float4*>(part + (long long)blockIdx.y * W + 4 * c4) = acc;
  }
}

inline Win win(const void* p, long long rs, long long P, long long ps, long long shift,
               long long lim) {
  Win w;
  w.p_ = (const float*)p;
  w.rs = rs;
  w.P = P;
  w.ps = ps;
  w.shift = shift;
  w.lim = lim;
  return w;
}

// The tile width of core_nn at N: 96 at N 96 (no padded column), 64 where
// it pads fewer columns than 128 (N = 32, 48, 192), else 128.  A function of
// N alone, so a row's outputs do not depend on the row group it runs in (nor
// on the tile: each output's sum runs over K in the same stages).
inline int nn_tile(int N) {
  if (N == 96) return 96;
  const int p128 = (N + 127) / 128 * 128, p64 = (N + 63) / 64 * 64;
  return p64 < p128 ? 64 : 128;
}

template <int EPI, int BN>
int launch_nn(const Win& a, long long M, int K, const float* bhi, const float* blo, int N,
              const Epi& e, cudaStream_t st) {
  // the opt-in above 48 KB (for the current device: set at every call)
  const cudaError_t rc = cudaFuncSetAttribute(
      core_nn<EPI, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, nn_smem(BN));
  if (rc != cudaSuccess) return (int)rc;
  const int ntn = (N + BN - 1) / BN;
  const long long blocks = ntn * ((M + BM - 1) / BM);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  core_nn<EPI, BN><<<(unsigned)blocks, NT, nn_smem(BN), st>>>(a, M, K, bhi, blo, N, ntn, e);
  return (int)cudaGetLastError();
}

template <int EPI>
int launch_nn_bn(const Win& a, long long M, int K, const float* bhi, const float* blo, int N,
                 const Epi& e, cudaStream_t st) {
  switch (nn_tile(N)) {
    case 64: return launch_nn<EPI, 64>(a, M, K, bhi, blo, N, e, st);
    case 96: return launch_nn<EPI, 96>(a, M, K, bhi, blo, N, e, st);
  }
  return launch_nn<EPI, 128>(a, M, K, bhi, blo, N, e, st);
}

}  // namespace
}  // namespace fc32

using namespace fc32;

// Shared memory of each launch (bytes): 0 core_nn at tile width 128, 1 at
// 64, 2 core_tn, 3 core_nn at 96.
extern "C" long long core_fp32_smem_bytes(int which) {
  switch (which) {
    case 0: return nn_smem(128);
    case 1: return nn_smem(64);
    case 2: return TN_SMEM;
    case 3: return nn_smem(96);
  }
  return -1;
}

#define WIN_ARGS(n) const void *n##_p, long long n##_rs, long long n##_P, long long n##_ps, \
                    long long n##_shift, long long n##_lim
#define WIN(n) win(n##_p, n##_rs, n##_P, n##_ps, n##_shift, n##_lim)

extern "C" int core_fp32_nn(int epi, WIN_ARGS(a), long long M, int K, const void* bhi,
                            const void* blo, int N, void* out, long long ldo, const void* bias,
                            void* y, const void* res, long long P, unsigned site, unsigned seed, unsigned thr,
                            unsigned row0, float scale, int on, void* stream) {
  if (K % 4 || N % 4 || K < 4 || N < 4 || M < 1 || P < 1) return (int)cudaErrorInvalidValue;
  Epi e;
  e.out = (float*)out;
  e.ldo = ldo;
  e.bias = (const float*)bias;
  e.y = (float*)y;
  e.res = (const float*)res;
  e.P = P;
  e.site = site;
  e.dp.seed = seed;
  e.dp.thr = thr;
  e.dp.row0 = row0;
  e.dp.scale = scale;
  e.dp.on = on;
  const Win a = WIN(a);
  const cudaStream_t st = (cudaStream_t)stream;
  const float *hi = (const float*)bhi, *lo = (const float*)blo;
  switch (epi) {
    case EPI_STORE: return launch_nn_bn<EPI_STORE>(a, M, K, hi, lo, N, e, st);
    case EPI_SWIGLU: return launch_nn_bn<EPI_SWIGLU>(a, M, K, hi, lo, N, e, st);
    case EPI_SWIGLU_BWD: return launch_nn_bn<EPI_SWIGLU_BWD>(a, M, K, hi, lo, N, e, st);
    case EPI_OUT: return launch_nn_bn<EPI_OUT>(a, M, K, hi, lo, N, e, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int core_fp32_tn(WIN_ARGS(a), int M, WIN_ARGS(b), int N, long long total, int S,
                            void* part, void* stream) {
  if (M % 4 || N % 4 || M < 4 || N < 4 || S < 1 || S > 65535 || a_P < 1 || b_P < 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t rc =
      cudaFuncSetAttribute(core_tn, cudaFuncAttributeMaxDynamicSharedMemorySize, TN_SMEM);
  if (rc != cudaSuccess) return (int)rc;
  const int ntn = (N + BM - 1) / BM;
  const long long per = (total + S - 1) / S;
  core_tn<<<dim3(ntn * ((M + BM - 1) / BM), S), NT, TN_SMEM, (cudaStream_t)stream>>>(
      WIN(a), M, WIN(b), N, ntn, total, per, (float*)part);
  return (int)cudaGetLastError();
}

extern "C" int core_fp32_colsum(WIN_ARGS(a), int W, long long total, int S, void* part,
                                void* stream) {
  if (W % 4 || W < 4 || S < 1 || S > 65535 || a_P < 1) return (int)cudaErrorInvalidValue;
  const int w4 = W / 4, cl = w4 < CS_CL ? w4 : CS_CL;
  const long long per = (total + S - 1) / S;
  core_colsum<<<dim3((w4 + cl - 1) / cl, S), NT, 0, (cudaStream_t)stream>>>(WIN(a), W, total,
                                                                            per, (float*)part);
  return (int)cudaGetLastError();
}
