// Shared pieces of the port's Hopper (sm_90a) attention kernels that use
// wgmma and TMA (online_cell.cuh, the cell of flash_online_bf16.cu and
// flash_variants.cu; fixed_cell.cuh, of flash_prepacked.cu and
// flash_fixed_max.cu; tf32x3_cell.cuh, of flash_online.cu and
// flash_fixed_max_hd.cu; flash_pv8.cu) and of the attention
// prologue (attn_prologue.cu): shared-memory matrix descriptors, the wgmma
// instructions they issue with their fences, the exact s32 -> f32 move and
// the tf32 rounding their operands take, the mbarrier ring, TMA tile loads,
// thread-block cluster barriers and distributed shared memory (with K4's
// wide kernels' score exchange and cluster plan), and the host-side
// tensor-map encoding.
//
// Layouts. A tile is brought into shared memory by one TMA load of a 3-D
// box {row bytes, rows, 1} out of a [heads, rows, row bytes] tensor, with the
// hardware's 128-, 64- or 32-byte swizzle (rows of that many bytes); the
// wgmma descriptor names the same swizzle. Every tile starts on a 1024-byte
// boundary, so the swizzle pattern is the one the descriptor assumes. Rows
// past the tensor's end arrive as zeros (TMA's out-of-bounds fill), so the
// wrappers need not pad; so do the columns of a box wider than the tensor's
// rows (a head dim rounded up to a swizzle row).
//   K-major operand (the reduction dimension contiguous in a row):
//     8-row groups are SBO = 8 * row bytes apart; one k step of 32 bytes
//     (16 bf16 or 32 int8) advances the start address by 32 bytes. A row
//     wider than 128 bytes is cut into panels of 128-byte rows, one TMA box
//     each, and a k step past the first panel starts in the next.
//   MN-major operand (bf16 only; wgmma's transpose bit): rows are the
//     reduction dimension, and the other dimension is cut into panels of
//     W / 2 bf16 per W-byte row (W the swizzle: 128, 64 or 32); 8-row
//     groups are SBO = 8 * W bytes apart, one k step of 16 rows advances
//     the start address by 16 * W bytes, and LBO is the stride between
//     panels (unused with one panel). At width 128 with W = 128 (K^T as the
//     B operand of Q K^T, two TMA boxes of 64 columns one above the other)
//     LBO = 64 rows * 128 bytes = 8192.
// Accumulator fragments (f32 or s32) of an m64nN wgmma: thread t of the
// warpgroup (warp w = t / 32, lane l) holds d[4j + e] at row 16w + l/4 +
// 8 (e / 2), column 8j + 2 (l % 4) + e % 2. The A fragment from registers
// of an m64nNk16 bf16 wgmma holds rows 16w + l/4 (+8) and k 2 (l % 4) + {0,
// 1} (+8): for 16-bit types the accumulator of one product is, chunk pair by
// chunk pair, the A operand of the next. For int8 (k32) it holds k 4 (l %
// 4) + {0..3} (+16). For tf32 (k8, one value a register) a0..a3 hold (row,
// k) = (l/4, l%4), (l/4 + 8, l%4), (l/4, l%4 + 4), (l/4 + 8, l%4 + 4): the
// accumulator chunk j of one product is the A operand of a k step of the next
// as (d[4j], d[4j + 2], d[4j + 1], d[4j + 3]) when B's k order inside every
// group of 8 is [0, 2, 4, 6, 1, 3, 5, 7] (tf32x3_cell.cuh). tf32 takes both
// operands K-major (no transpose bit), 8 values (32 bytes) a k step.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- wgmma shared-memory descriptors ----

enum Swizzle : uint64_t { kSw128 = 1, kSw64 = 2, kSw32 = 3 };

// bytes of the swizzle row that holds `bytes` of a row (a panel: 128 at
// most), and that row's swizzle as a descriptor and as a tensor map name it
__host__ __device__ constexpr int swizzle_row(int bytes) {
  return bytes <= 32 ? 32 : bytes <= 64 ? 64 : 128;
}
__host__ __device__ constexpr Swizzle desc_swizzle(int row) {
  return row == 32 ? kSw32 : row == 64 ? kSw64 : kSw128;
}
constexpr CUtensorMapSwizzle map_swizzle(int row) {
  return row == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                   : row == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
}

// start address, leading / stride byte offsets (16-byte units), swizzle mode
__device__ __forceinline__ uint64_t make_desc(const void* smem, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes, Swizzle swz) {
  const uint64_t addr = smem_u32(smem);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32 | (uint64_t)swz << 62;
}

// the descriptor's start address moved by `bytes` (a multiple of 16)
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

// 2^x as one SFU instruction, results below 2^-126 flushed to zero. exp2f
// without fast math is the same instruction plus a range fix for those
// results (a compare and two multiplies a call), which the callers here do
// not need: K6 rounds 127 * p to an integer, and K4's p that small add
// nothing a bf16 output can hold.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 1.5 * 2^23: an integer n with |n| < 2^22 sits in its float's low mantissa
// bits, so int <-> float moves run on the FMA and integer units rather than
// the conversion unit (16 results a clock an SM, as slow as the SFU)
constexpr float kMagicF = 12582912.0f;
constexpr uint32_t kMagicI = 0x4B400000u;

// (float)x, exactly, for |x| < 2^22 (an s32 sum of int8 products: |x| <= 127
// * 127 * 128)
__device__ __forceinline__ float exact_f32(int x) {
  return __fsub_rn(__uint_as_float(kMagicI + static_cast<uint32_t>(x)), kMagicF);
}

// x rounded to tf32 (a 10-bit mantissa), to nearest with ties away from
// zero: the rounding of cvt.rna.tf32.f32, with the low 13 bits zero, so the
// tensor cores read the value whatever they do with those bits. Done on the
// integer units (an add and an and on the bits: a carry out of the mantissa
// rounds the exponent up, as it should) rather than by the conversion
// instruction, which would share the SFU's issue rate with exp2.
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// ---- wgmma fences ----

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
// A fragments read by an asynchronous wgmma: fenced after its wait, so the
// compiler keeps their registers until the hardware has read them
template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// ---- wgmma instructions (A and B from shared memory: _ss; A from registers: _rs) ----
// bf16: scale-a 1, scale-b 1; _ss A K-major, B K-major or, with kTransB = 1,
// MN-major; _rs_bf16_vt B MN-major (the transpose bit). s8 and tf32: both
// operands K-major (the only form for 8-bit and 32-bit types); tf32 with
// scale-a 1, scale-b 1.

// kTransB: B MN-major (wgmma's transpose bit) instead of K-major
template <int kTransB = 0>
__device__ __forceinline__ void wgmma_m64n128k16_ss_bf16(float (&d)[64], uint64_t da,
                                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB));
}

__device__ __forceinline__ void wgmma_m64n128k32_ss_s8(int (&d)[64], uint64_t da, uint64_t db,
                                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Register-A wgmma of width N (the head dim of P V: 16 to 128 in steps of
// 16; wgmma_rs_bf16_vt also 160, 192, 224 and 256), one specialization a
// width: wgmma_rs_s8<N> (s8, B K-major) and wgmma_rs_bf16_vt<N> (bf16, B
// MN-major). d holds this thread's N / 2 accumulators, a the 4 A registers.
// Inline asm numbers its operands, so the macros below spell out each
// width's list: the accumulators %0 .. %(N/2 - 1), then a, the B descriptor
// and scale-d.
template <int N>
__device__ void wgmma_rs_s8(int (&d)[N / 2], const uint32_t (&a)[4], uint64_t db, int scale_d);
template <int N>
__device__ void wgmma_rs_bf16_vt(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                 int scale_d);
template <int N>
__device__ void wgmma_rs_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                              int scale_d);

#define HOPPER_R(x) "+r"(x)
#define HOPPER_F(x) "+f"(x)
#define HOPPER_D8(C, i) C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), \
    C(d[i + 4]), C(d[i + 5]), C(d[i + 6]), C(d[i + 7])
#define HOPPER_D8x1(C) HOPPER_D8(C, 0)
#define HOPPER_D8x2(C) HOPPER_D8x1(C), HOPPER_D8(C, 8)
#define HOPPER_D8x3(C) HOPPER_D8x2(C), HOPPER_D8(C, 16)
#define HOPPER_D8x4(C) HOPPER_D8x3(C), HOPPER_D8(C, 24)
#define HOPPER_D8x5(C) HOPPER_D8x4(C), HOPPER_D8(C, 32)
#define HOPPER_D8x6(C) HOPPER_D8x5(C), HOPPER_D8(C, 40)
#define HOPPER_D8x7(C) HOPPER_D8x6(C), HOPPER_D8(C, 48)
#define HOPPER_D8x8(C) HOPPER_D8x7(C), HOPPER_D8(C, 56)
#define HOPPER_D8x10(C) HOPPER_D8x8(C), HOPPER_D8(C, 64), HOPPER_D8(C, 72)
#define HOPPER_D8x12(C) HOPPER_D8x10(C), HOPPER_D8(C, 80), HOPPER_D8(C, 88)
#define HOPPER_D8x14(C) HOPPER_D8x12(C), HOPPER_D8(C, 96), HOPPER_D8(C, 104)
#define HOPPER_D8x16(C) HOPPER_D8x14(C), HOPPER_D8(C, 112), HOPPER_D8(C, 120)
#define HOPPER_S8x1 "%0, %1, %2, %3, %4, %5, %6, %7"
#define HOPPER_S8x2 HOPPER_S8x1 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define HOPPER_S8x3 HOPPER_S8x2 ", %16, %17, %18, %19, %20, %21, %22, %23"
#define HOPPER_S8x4 HOPPER_S8x3 ", %24, %25, %26, %27, %28, %29, %30, %31"
#define HOPPER_S8x5 HOPPER_S8x4 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define HOPPER_S8x6 HOPPER_S8x5 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define HOPPER_S8x7 HOPPER_S8x6 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define HOPPER_S8x8 HOPPER_S8x7 ", %56, %57, %58, %59, %60, %61, %62, %63"
#define HOPPER_S8x10 HOPPER_S8x8 ", %64, %65, %66, %67, %68, %69, %70, %71" \
    ", %72, %73, %74, %75, %76, %77, %78, %79"
#define HOPPER_S8x12 HOPPER_S8x10 ", %80, %81, %82, %83, %84, %85, %86, %87" \
    ", %88, %89, %90, %91, %92, %93, %94, %95"
#define HOPPER_S8x14 HOPPER_S8x12 ", %96, %97, %98, %99, %100, %101, %102, %103" \
    ", %104, %105, %106, %107, %108, %109, %110, %111"
#define HOPPER_S8x16 HOPPER_S8x14 ", %112, %113, %114, %115, %116, %117, %118, %119" \
    ", %120, %121, %122, %123, %124, %125, %126, %127"
// X(N, accumulator list, its operand string, "{a}, desc", "scale-d")
#define HOPPER_RS_WIDTHS(X)                                                 \
  X(16, HOPPER_D8x1, HOPPER_S8x1, "{%8, %9, %10, %11}, %12", "%13")        \
  X(32, HOPPER_D8x2, HOPPER_S8x2, "{%16, %17, %18, %19}, %20", "%21")      \
  X(48, HOPPER_D8x3, HOPPER_S8x3, "{%24, %25, %26, %27}, %28", "%29")      \
  X(64, HOPPER_D8x4, HOPPER_S8x4, "{%32, %33, %34, %35}, %36", "%37")      \
  X(80, HOPPER_D8x5, HOPPER_S8x5, "{%40, %41, %42, %43}, %44", "%45")      \
  X(96, HOPPER_D8x6, HOPPER_S8x6, "{%48, %49, %50, %51}, %52", "%53")      \
  X(112, HOPPER_D8x7, HOPPER_S8x7, "{%56, %57, %58, %59}, %60", "%61")      \
  X(128, HOPPER_D8x8, HOPPER_S8x8, "{%64, %65, %66, %67}, %68", "%69")
// the widths above 128 (P V of K4 bf16 at head dims 160 to 256)
#define HOPPER_RS_WIDE_WIDTHS(X)                                            \
  X(160, HOPPER_D8x10, HOPPER_S8x10, "{%80, %81, %82, %83}, %84", "%85")    \
  X(192, HOPPER_D8x12, HOPPER_S8x12, "{%96, %97, %98, %99}, %100", "%101")  \
  X(224, HOPPER_D8x14, HOPPER_S8x14, "{%112, %113, %114, %115}, %116", "%117") \
  X(256, HOPPER_D8x16, HOPPER_S8x16, "{%128, %129, %130, %131}, %132", "%133")
#define HOPPER_RS(NAME, T, C, N, INSTR, TAIL, D, S, AB, P)                   \
  template <>                                                               \
  __device__ __forceinline__ void NAME<N>(T(&d)[N / 2], const uint32_t(&a)[4], \
                                          uint64_t db, int scale_d) {       \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n" INSTR " {" S "}, " AB \
                 ", p" TAIL ";\n}\n"                                        \
                 : D(C)                                                     \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d)); \
  }
#define HOPPER_RS_S8(N, D, S, AB, P)                                        \
  HOPPER_RS(wgmma_rs_s8, int, HOPPER_R, N,                                  \
            "wgmma.mma_async.sync.aligned.m64n" #N "k32.s32.s8.s8", "", D, S, AB, P)
#define HOPPER_RS_BF16_VT(N, D, S, AB, P)                                   \
  HOPPER_RS(wgmma_rs_bf16_vt, float, HOPPER_F, N,                           \
            "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16", ", 1, 1, 1", D, S, \
            AB, P)
#define HOPPER_RS_TF32(N, D, S, AB, P)                                      \
  HOPPER_RS(wgmma_rs_tf32, float, HOPPER_F, N,                              \
            "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32", ", 1, 1", D, S, AB, P)
HOPPER_RS_WIDTHS(HOPPER_RS_S8)
HOPPER_RS_WIDTHS(HOPPER_RS_BF16_VT)
HOPPER_RS_WIDTHS(HOPPER_RS_TF32)
HOPPER_RS_WIDE_WIDTHS(HOPPER_RS_BF16_VT)

// Shared-memory A and B of width N (16 to 128 in steps of 16), both
// K-major: wgmma_ss_tf32<N> (one k step of 8 tf32), wgmma_ss_s8<N> (32
// int8) and wgmma_ss_bf16<N> (16 bf16). The same operand lists as above,
// the A and B descriptors in place of a.
template <int N>
__device__ void wgmma_ss_tf32(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);
template <int N>
__device__ void wgmma_ss_s8(int (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);
template <int N>
__device__ void wgmma_ss_bf16(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);
#define HOPPER_SS_WIDTHS(X)                                                 \
  X(16, HOPPER_D8x1, HOPPER_S8x1, "%8, %9", "%10")                          \
  X(32, HOPPER_D8x2, HOPPER_S8x2, "%16, %17", "%18")                        \
  X(48, HOPPER_D8x3, HOPPER_S8x3, "%24, %25", "%26")                        \
  X(64, HOPPER_D8x4, HOPPER_S8x4, "%32, %33", "%34")                        \
  X(80, HOPPER_D8x5, HOPPER_S8x5, "%40, %41", "%42")                        \
  X(96, HOPPER_D8x6, HOPPER_S8x6, "%48, %49", "%50")                        \
  X(112, HOPPER_D8x7, HOPPER_S8x7, "%56, %57", "%58")                       \
  X(128, HOPPER_D8x8, HOPPER_S8x8, "%64, %65", "%66")
#define HOPPER_SS(NAME, T, C, N, INSTR, TAIL, D, S, AB, P)                   \
  template <>                                                               \
  __device__ __forceinline__ void NAME<N>(T(&d)[N / 2], uint64_t da, uint64_t db, \
                                          int scale_d) {                    \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " P ", 0;\n" INSTR " {" S "}, " AB \
                 ", p" TAIL ";\n}\n"                                        \
                 : D(C)                                                     \
                 : "l"(da), "l"(db), "r"(scale_d));                         \
  }
#define HOPPER_SS_TF32(N, D, S, AB, P)                                      \
  HOPPER_SS(wgmma_ss_tf32, float, HOPPER_F, N,                              \
            "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32", ", 1, 1", D, S, AB, P)
#define HOPPER_SS_S8(N, D, S, AB, P)                                        \
  HOPPER_SS(wgmma_ss_s8, int, HOPPER_R, N,                                  \
            "wgmma.mma_async.sync.aligned.m64n" #N "k32.s32.s8.s8", "", D, S, AB, P)
#define HOPPER_SS_BF16(N, D, S, AB, P)                                      \
  HOPPER_SS(wgmma_ss_bf16, float, HOPPER_F, N,                              \
            "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16", ", 1, 1, 0, 0", D, S, \
            AB, P)
HOPPER_SS_WIDTHS(HOPPER_SS_TF32)
HOPPER_SS_WIDTHS(HOPPER_SS_S8)
HOPPER_SS_WIDTHS(HOPPER_SS_BF16)

// ---- mbarriers ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// one arrival that also announces `bytes` of TMA traffic for this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra LAB_WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// A ring of `Stages` slots: full[s] completes when slot s's tiles have
// landed (one producer arrival plus the TMA bytes), empty[s] when every
// consumer thread has finished reading it. Item i lives in slot i % Stages,
// in phase (i / Stages) & 1 of both barriers.
template <int Stages>
struct Ring {
  uint64_t full[Stages];
  uint64_t empty[Stages];

  __device__ void init(uint32_t consumers) {
#pragma unroll
    for (int s = 0; s < Stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumers);
    }
  }
  // producer: slot of item i, once its previous occupant has been read;
  // announces `bytes` of TMA traffic on its full barrier
  __device__ int acquire(int i, uint32_t bytes) {
    const int s = i % Stages;
    if (i >= Stages) mbar_wait(&empty[s], ((i / Stages) - 1) & 1);
    mbar_expect_tx(&full[s], bytes);
    return s;
  }
  // consumer: slot of item i, once its tiles have landed
  __device__ int wait_full(int i) {
    const int s = i % Stages;
    mbar_wait(&full[s], (i / Stages) & 1);
    return s;
  }
  __device__ void release(int i) { mbar_arrive(&empty[i % Stages]); }
};

// ---- TMA ----

// box {c0, c1, c2} of the tensor map into shared memory, completion on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Register reallocation between warpgroups (sm_90a): every thread of a
// warpgroup executes it, N is 24 to 256 in steps of 8. dec gives the
// warpgroup's registers above N back to the CTA's pool; inc waits until the
// pool holds enough and takes them. A producer warpgroup that only issues
// TMA loads gives its registers to the consumers this way.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// generic-proxy writes to shared memory made visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier over `threads` threads (a warpgroup) with its own id (1..15)
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- thread-block clusters ----
// Every thread of every CTA of the cluster arrives, then waits; the arrive
// releases the thread's earlier writes (shared memory included) and the wait
// acquires every other thread's. A split pair lets a CTA work between the
// two. Not .aligned: a warp need not be converged where it calls them.

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
// an arrival that orders nothing: for a CTA whose remote reads have returned
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
// the address of `p` (this CTA's shared memory) in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t cluster_map(const void* p, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_u32(p)), "r"(rank));
  return out;
}
// a float from distributed shared memory (an address from cluster_map)
__device__ __forceinline__ float cluster_load(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}
// four floats (16-byte aligned) from distributed shared memory
__device__ __forceinline__ float4 cluster_load4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}
// one arrival on the mbarrier `bar` (this CTA's address of it) in CTA
// `rank` of the cluster, releasing the thread's earlier writes to the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t rank) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
                   cluster_map(bar, rank))
               : "memory");
}
// mbar_wait that acquires what the arrivals of other CTAs released
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "LAB_WAIT_CLUSTER:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra LAB_WAIT_CLUSTER;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// four floats into distributed shared memory (an address from cluster_map)
// with st.async: their 16 bytes count towards the transaction count of the
// mbarrier at `bar` (cluster_map of a barrier in the same CTA), as a TMA
// load's do; the writer does not wait
__device__ __forceinline__ void st_async4(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// ---- scores summed over a cluster (K4's wide kernels) ----
// The CTAs of a cluster split the head dim of one q tile; each holds, in the
// f32 accumulator fragments of its consumer warps, its part of S for a kv
// tile (kF floats a thread). sum() gives every CTA the same S, bit for bit,
// in place of its part: S = part_0 + part_1 + ... + part_(n-1), added in rank
// order in every CTA, through distributed shared memory (DSMEM), one barrier
// a tile parity and warp, the parts double-buffered by tile parity. Two
// forms, timed alone by bench/dsmem_probe.py (a pair exchanging 32 KB a CTA
// and tile: 0.90 us pushed, 1.67 us pulled, on an H100 at 700 W; PERF.md):
//   * push (n = 2): each thread writes its part into the other CTA's slot
//     with st.async, whose bytes complete that CTA's barrier (lane 0 arms its
//     own with the bytes it expects), and adds the part it received from its
//     own shared memory;
//   * pull (any n): each thread publishes its part in its own CTA's shared
//     memory, lanes 0 .. n - 1 of its warp announce it on the warp barrier of
//     CTA 0 .. n - 1 (one arrival each, released to the cluster), and once
//     its barrier has n arrivals each thread reads its counterparts' parts
//     (same warp, same lane) from the other CTAs.
// Either way a CTA writes tile t + 2's part into a buffer only after every
// CTA has sent or announced tile t + 1's, which each does after reading tile
// t's: one barrier a tile and warp suffices. The caller keeps every CTA of
// the cluster alive until the others' last reads and writes are done (a
// cluster barrier before it exits).
template <int kWarps, int kF>
struct ScoreExchange {
  static constexpr int kGroups = kF / 4;
  float4 part[2][kWarps][kGroups][32];  // [tile parity][warp][4-float group][lane]
  uint64_t ready[2][kWarps];

  // the arrivals a warp barrier takes a tile: sum()'s form for n CTAs
  static __device__ uint32_t arrivals(int n) { return n == 2 ? 1 : n; }
  __device__ void init(uint32_t count) {
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mbar_init(&ready[p][w], count);
  }

  // S of kv tile `tile` in place of this thread's part in s, over the n CTAs
  // of the cluster (this one `rank`); every thread of the warp calls it
  __device__ __forceinline__ void sum(float (&s)[kF], int tile, int n, int rank, int warp,
                                      int lane) {
    if (n == 2)
      push(s, tile, rank, warp, lane);
    else
      pull(s, tile, n, rank, warp, lane);
  }

  // the pair's form (barriers of 1 arrival)
  __device__ __forceinline__ void push(float (&s)[kF], int tile, int rank, int warp, int lane) {
    const int par = tile & 1;
    float4* mine = &part[par][warp][0][lane];
    if (lane == 0) mbar_expect_tx(&ready[par][warp], kGroups * 32 * 16);
    const uint32_t dst = cluster_map(mine, rank ^ 1);
    const uint32_t bar = cluster_map(&ready[par][warp], rank ^ 1);
#pragma unroll
    for (int j = 0; j < kGroups; ++j)
      st_async4(dst + 512 * j, make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]),
                bar);
    mbar_wait(&ready[par][warp], (tile >> 1) & 1);
    // part_0 + part_1: f32 addition commutes, so both CTAs hold the same bits
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const float4 t = mine[32 * j];
      s[4 * j] = __fadd_rn(s[4 * j], t.x);
      s[4 * j + 1] = __fadd_rn(s[4 * j + 1], t.y);
      s[4 * j + 2] = __fadd_rn(s[4 * j + 2], t.z);
      s[4 * j + 3] = __fadd_rn(s[4 * j + 3], t.w);
    }
  }

  // any n (barriers of n arrivals); its own part read back from shared memory
  __device__ __forceinline__ void pull(float (&s)[kF], int tile, int n, int rank, int warp,
                                       int lane) {
    const int par = tile & 1;
    float4* mine = &part[par][warp][0][lane];
#pragma unroll
    for (int j = 0; j < kGroups; ++j)
      mine[32 * j] = make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
    __syncwarp();
    if (lane < n) mbar_arrive_cluster(&ready[par][warp], lane);
    mbar_wait_cluster(&ready[par][warp], (tile >> 1) & 1);
    for (int r = 0; r < n; ++r) {
      float4 t[kGroups];
      if (r == rank) {
#pragma unroll
        for (int j = 0; j < kGroups; ++j) t[j] = mine[32 * j];
      } else {
        const uint32_t base = cluster_map(mine, r);
#pragma unroll
        for (int j = 0; j < kGroups; ++j) t[j] = cluster_load4(base + 512 * j);
      }
#pragma unroll
      for (int j = 0; j < kGroups; ++j) {
        s[4 * j] = r == 0 ? t[j].x : __fadd_rn(s[4 * j], t[j].x);
        s[4 * j + 1] = r == 0 ? t[j].y : __fadd_rn(s[4 * j + 1], t[j].y);
        s[4 * j + 2] = r == 0 ? t[j].z : __fadd_rn(s[4 * j + 2], t[j].z);
        s[4 * j + 3] = r == 0 ? t[j].w : __fadd_rn(s[4 * j + 3], t[j].w);
      }
    }
  }
};

// The cluster plan of K4's wide kernels (ops/flash_attention.py::_wide_plan
// mirrors it): a width of `units` units (64 columns, or 32 for K4 f32 at
// 160-256) over CTAs of at most `top` units each. n CTAs a cluster (at most
// kWideCluster, the portable size) split the head dim of a q tile for S;
// `groups` clusters along the grid's y axis each compute S so and split the
// output columns, n * groups CTAs in all. Part i of `parts` takes units
// [start, start + count).
constexpr int kWideCluster = 8;
__host__ __device__ inline int wide_cluster(int units, int top) {
  const int n = (units + top - 1) / top;
  return n < kWideCluster ? n : kWideCluster;
}
__host__ __device__ inline int wide_groups(int units, int top) {
  const int per = wide_cluster(units, top) * top;
  return (units + per - 1) / per;
}
__host__ __device__ inline int part_start(int units, int parts, int i) {
  const int base = units / parts, extra = units % parts;
  return i * base + (i < extra ? i : extra);
}
__host__ __device__ inline int part_count(int units, int parts, int i) {
  return units / parts + (i < units % parts ? 1 : 0);
}

// ---- host: tensor maps ----

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function; the library links only
// the runtime, so it is looked up once through the runtime's entry-point
// query
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A map of a 3-D tensor of `type` with dims {d0, d1, d2} (d0 contiguous) and
// byte strides {s1, s2} of dims 1 and 2 (multiples of 16), read in boxes of
// {box0, box1, 1} with `swizzle`; elements past the ends read as zeros.
// Returns false where cuTensorMapEncodeTiled refuses it.
inline bool make_map_3d_strided(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                                uint64_t d0, uint64_t d1, uint64_t d2, uint64_t s1,
                                uint64_t s2, uint32_t box0, uint32_t box1,
                                CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(base) % 16) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {s1, s2};
  const cuuint32_t box[3] = {box0, box1, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(base), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A map of a contiguous [heads, rows, row_elems] tensor of `type`, read in
// boxes of {box_elems, box_rows, 1} with `swizzle`.
inline bool make_map_3d(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                        int elem_bytes, uint64_t row_elems, uint64_t rows, uint64_t heads,
                        uint32_t box_elems, uint32_t box_rows, CUtensorMapSwizzle swizzle) {
  return make_map_3d_strided(map, base, type, row_elems, rows, heads, row_elems * elem_bytes,
                             rows * row_elems * elem_bytes, box_elems, box_rows, swizzle);
}

}  // namespace hopper
