// fp32 products on the tensor cores in three TF32 passes (3xTF32).
//
// An fp32 operand a splits as a = hi + lo, hi = tf32(a) and lo = tf32(a - hi),
// each rounded to nearest, ties away from zero (cvt.rna's rounding, done on
// the bit pattern: a TF32 instruction given raw fp32 bits ignores their low
// 13 bits, which truncates).  hi keeps 11 significant
// bits, lo the next 11, so hi + lo is a to within 2^-21 of |a|.  A product
// a b is then lo_a hi_b + hi_a lo_b + hi_a hi_b accumulated in fp32, the
// small terms first; the lo_a lo_b term (2^-22 of |a b|) is dropped.  Over
// a sum of K products the error stays near fp32 FFMA's.
//
// Two instructions take the split operands:
//   * wgmma.mma_async m64nNk8 .tf32 with A in registers (split there) and B
//     K-major in shared memory (TF32 wgmma has no transpose), 128-byte
//     swizzled rows of 32 floats (the same byte geometry as hopper.cuh's bf16
//     tiles: a k8 step is +32 bytes on the descriptor's start address);
//   * mma.sync m16n8k8 .tf32 (row.col): both fragments in registers, for
//     operands whose shared-memory layout is not K-major.
// Plus the 16-byte cp.async with zero fill that stages their tiles.
#pragma once

#include <stdint.h>

namespace tf32x3 {

// a rounded to nearest TF32 (ties away from zero), as fp32 bits: half the
// weight of the 13 dropped bits added to the bit pattern, then dropped.  For
// finite operands these are cvt.rna.tf32.f32's bits, in two integer
// instructions where cvt.rna compiles to four or more (the kernels that split
// their operands in registers issue more splits than products).
__device__ __forceinline__ uint32_t to_tf32(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;
}

struct Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ Split split(float a) {
  const uint32_t hi = to_tf32(a);
  return {hi, to_tf32(a - __uint_as_float(hi))};
}

// ------------------------------------------------------------------ cp.async

// 16 bytes from ``src`` into shared memory at ``dst``; zeros when !ok (no
// byte of ``src`` is read then).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------------ mma.sync

// d[16 x 8] += a[16 x 8] b[8 x 8], TF32 operands, fp32 sums.  Lane l (g = l/4,
// c = l%4) holds a = {A[g][c], A[g+8][c], A[g][c+4], A[g+8][c+4]},
// b = {B[c][g], B[c+4][g]}, d = {D[g][2c], D[g][2c+1], D[g+8][2c], D[g+8][2c+1]}.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The three passes of one fragment pair, the small products first.
__device__ __forceinline__ void mma_3x(float (&d)[4], const uint32_t (&ahi)[4],
                                       const uint32_t (&alo)[4], const uint32_t (&bhi)[2],
                                       const uint32_t (&blo)[2]) {
  mma_tf32(d, alo, bhi);
  mma_tf32(d, ahi, blo);
  mma_tf32(d, ahi, bhi);
}

// ------------------------------------------------------------------- wgmma

// d[64 x 128] (+)= A[64 x 8] B[8 x 128], A from registers (lane l of warp w
// of the warpgroup: a = {A[16w + g][c], A[16w + g + 8][c], A[16w + g][c + 4],
// A[16w + g + 8][c + 4]}, g = l / 4, c = l % 4), B K-major in shared memory;
// scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t (&a)[4], uint64_t desc_b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d[64 x 96] (+)= A[64 x 8] B[8 x 96], A from registers (lane l of warp w
// of the warpgroup: a = {A[16w + g][c], A[16w + g + 8][c], A[16w + g][c + 4],
// A[16w + g + 8][c + 4]}, g = l / 4, c = l % 4), B K-major in shared memory;
// scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_n96(float* d, const uint32_t (&a)[4], uint64_t desc_b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d[64 x 64] (+)= A[64 x 8] B[8 x 64], A from registers (lane l of warp w
// of the warpgroup: a = {A[16w + g][c], A[16w + g + 8][c], A[16w + g][c + 4],
// A[16w + g + 8][c + 4]}, g = l / 4, c = l % 4), B K-major in shared memory;
// scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t (&a)[4], uint64_t desc_b,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// The three passes of one k8 step with A's halves in registers.
template <int BN>
__device__ __forceinline__ void wgmma_rs_3x(float* d, const uint32_t (&ahi)[4],
                                            const uint32_t (&alo)[4], uint64_t bhi, uint64_t blo,
                                            bool accumulate) {
  if constexpr (BN == 128) {
    wgmma_rs_n128(d, alo, bhi, accumulate);
    wgmma_rs_n128(d, ahi, blo, 1);
    wgmma_rs_n128(d, ahi, bhi, 1);
  } else if constexpr (BN == 96) {
    wgmma_rs_n96(d, alo, bhi, accumulate);
    wgmma_rs_n96(d, ahi, blo, 1);
    wgmma_rs_n96(d, ahi, bhi, 1);
  } else {
    wgmma_rs_n64(d, alo, bhi, accumulate);
    wgmma_rs_n64(d, ahi, blo, 1);
    wgmma_rs_n64(d, ahi, bhi, 1);
  }
}

}  // namespace tf32x3
