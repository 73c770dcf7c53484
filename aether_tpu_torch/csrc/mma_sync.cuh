// The mma.sync pieces of the simple attention kernels at the head dims
// other than 64 (mma_cell.cuh: K2 and K4 bf16 at those head dims), written
// by hand for Hopper (sm_90a).
//
// Warp-level tensor-core products of 16 q rows against 8 columns:
//   * m16n8k32 s8 x s8 -> s32 (int8 QK^T) and m16n8k16
//     bf16 x bf16 -> f32 (bf16 QK^T and P V);
//   * the m16n8 accumulator layout (c0, c1 at row gid, columns 2 tig, + 1;
//     c2, c3 at row gid + 8; gid = lane / 4, tig = lane % 4) is the A
//     operand layout of the next product, so p goes from registers into P V
//     without touching shared memory;
//   * B fragments come from shared memory through ldmatrix (ldmatrix.trans
//     for a row-major bf16 v); shared-memory rows are padded by 16 bytes
//     (an odd number of 16-byte units a row), so the 8 rows one ldmatrix
//     reads fall in distinct banks;
//   * an int8 product's K is the head dim rounded up to 32: the padding
//     columns are zero in shared memory (k) and in registers (q).
// It replaces no TPU kernel by itself: it holds what those kernels share.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace mma_sync {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf162_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragments of a warp's 16 rows of a row-major [rows, D] matrix of
// kBytes-byte elements (int8 or bf16), rows gid and gid + 8 of `row0`'s 16;
// the int8 product's padding columns are zeros, and so are rows at or past
// `rows` when kGuard (a caller whose rows fill its tiles passes false).
// kSteps: k steps of 32 bytes (32 int8 or 16 bf16 a step).
template <int D, int kBytes, int kSteps, bool kGuard = true>
__device__ __forceinline__ void load_a(uint32_t (&qa)[kSteps][4], const uint8_t* base, int row0,
                                       int rows, int gid, int tig) {
  const bool r0 = !kGuard || row0 + gid < rows, r1 = !kGuard || row0 + gid + 8 < rows;
  const uint8_t* p0 = base + (int64_t)(row0 + gid) * D * kBytes;
  const uint8_t* p1 = p0 + 8 * D * kBytes;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int off = s * 32 + tig * 4;
    const bool lo = off < D * kBytes, hi = off + 16 < D * kBytes;
    qa[s][0] = r0 && lo ? *reinterpret_cast<const uint32_t*>(p0 + off) : 0u;
    qa[s][1] = r1 && lo ? *reinterpret_cast<const uint32_t*>(p1 + off) : 0u;
    qa[s][2] = r0 && hi ? *reinterpret_cast<const uint32_t*>(p0 + off + 16) : 0u;
    qa[s][3] = r1 && hi ? *reinterpret_cast<const uint32_t*>(p1 + off + 16) : 0u;
  }
}

// `n` rows of `row_bytes` bytes (a multiple of 16) from device memory at
// `src` (row stride row_bytes) into shared memory at `dst` (row stride
// `stride`), by `threads` threads in 16-byte chunks; when kGuard, rows at or
// past `valid` are written as zeros.
template <bool kGuard = true>
__device__ __forceinline__ void load_rows(uint8_t* dst, int stride, const uint8_t* src,
                                          int row_bytes, int n, int valid, int tid,
                                          int threads) {
  const int chunks = row_bytes / 16;
  for (int i = tid; i < n * chunks; i += threads) {
    const int r = i / chunks, c = i % chunks;
    *reinterpret_cast<int4*>(dst + r * stride + c * 16) =
        !kGuard || r < valid
            ? *reinterpret_cast<const int4*>(src + (int64_t)r * row_bytes + c * 16)
            : make_int4(0, 0, 0, 0);
  }
}

// The sum of v over the 4 lanes that share a row (lanes xor 1, 2).
__device__ __forceinline__ float row_sum4(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

__device__ __forceinline__ float row_max4(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}

}  // namespace mma_sync
}  // namespace
