// K3: fixed-shift flash attention, written by hand for Hopper (sm_90a).
//
// Replaces aether_tpu/ops/flash_attention.py::_flash_kernel_fixed_max (the
// Pallas TPU kernel launched by flash_attention(fixed_max=True)): the
// attention of the unfused DiT path (AETHER_ATTN_FUSED=0) and the per-stripe
// cell of the ring merge (unnormalized, with a shared score bound).
// Non-causal, head_dim 64, in the log2 domain, one shift and one scale per
// head group g (the wrapper computes both over the whole sequence):
//   s   = f32(int32(q8 . k8^T)) * scale_g           (kInt8: int8 q/k)
//   s   = f32(q . k^T), q carrying sm_scale*log2e   (!kInt8: bf16 q/k)
//   p   = exp2(s - shift_g), 0 at columns >= kv_len
//   out = sum_j bf16(p_j) v_j / sum_j bf16(p_j)     (denominator 0 -> 1)
//   unnormalized: out = bf16(sum_j bf16(p_j) v_j) and l = sum_j bf16(p_j)
// The TPU kernel excluded padded and kv_valid-tail columns through zeroed
// [v | 1 | 0] rows; a zero k row alone would still give p = 2^-shift != 0,
// so this kernel masks the columns instead. Sq may differ from Skv (a
// sequence-parallel q stripe against the full K/V).
//
// What bounds it on an H100: matrix-unit work and exp2. The CFG pair at the
// 41x480x720 window (2 x 48 heads x 15076 tokens) is 5.6e12 flops (half
// QK^T, half PV) and 2.2e10 exp2 per call. The fixed shift means no running
// max and no rescale: every kv tile is an independent sum. The design, K2's
// (csrc/flash_prepacked.cu):
//   * grid (q tiles of 64 rows, B*H); 4 warps, 16 q rows each; each CTA loops
//     over the kv tiles of 64 columns up to kv_len;
//   * QK^T on mma.sync m16n8k32 s8 x s8 -> s32 (int8), or m16n8k16
//     bf16 x bf16 -> f32 (bf16, exact products), q fragments held in
//     registers for the whole loop, k fragments from shared memory with
//     ldmatrix;
//   * the m16n8 accumulator layout equals the bf16 A-operand layout of
//     m16n8k16, so p goes from registers straight into the PV mma.sync
//     (bf16 x bf16 -> f32); v fragments come from shared memory with
//     ldmatrix.trans.
// wgmma, TMA and warp specialisation are later work; this is the simple form.
// Compiled without --use_fast_math so exp2f and the division stay accurate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;
constexpr int kBM = 64;            // q rows per CTA
constexpr int kBN = 64;            // kv columns per tile
constexpr int kWarps = 4;
constexpr int kRowBytes = 144;     // bytes per k/v row in shared memory (128 + 16 pad)
constexpr int kVStride = kRowBytes / 2;  // bf16 per v row
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf162_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// 64 rows of `bytes_per_row` bytes from device memory into shared memory
// rows of kRowBytes, in 16-byte chunks
__device__ __forceinline__ void load_rows(uint8_t* dst, const uint8_t* __restrict__ src,
                                          int bytes_per_row, int tid) {
  const int chunks = bytes_per_row / 16;
  for (int i = tid; i < 64 * chunks; i += kWarps * 32) {
    const int r = i / chunks, c = i % chunks;
    *reinterpret_cast<int4*>(dst + r * kRowBytes + c * 16) =
        *reinterpret_cast<const int4*>(src + (int64_t)r * bytes_per_row + c * 16);
  }
}

// kInt8: q/k are int8 [BH, rows, 64]; else bf16 [BH, rows, 64]
template <bool kInt8>
__global__ void __launch_bounds__(kWarps * 32)
flash_fixed_max_kernel(const void* __restrict__ q, const void* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const float* __restrict__ shift, const float* __restrict__ scale,
                       __nv_bfloat16* __restrict__ out, float* __restrict__ l_out,
                       int sq, int skv, int kv_len, int hper) {
  __shared__ __align__(16) uint8_t ks[kBN * kRowBytes];
  __shared__ __align__(16) __nv_bfloat16 vs[kBN * kVStride];

  const int bh = blockIdx.y;
  const int g = bh / hper;
  const int q0 = blockIdx.x * kBM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int mi = lane / 8, mr = lane % 8;  // ldmatrix: matrix index, row within it
  const float m = shift[g];
  const float sc = scale[g];
  constexpr int kQBytes = kInt8 ? 1 : 2;

  // q fragments for this warp's 16 rows (A operand, row-major): int8
  // m16n8k32 in 2 k steps, or bf16 m16n8k16 in 4 k steps; 4 registers each
  const uint8_t* qrow = static_cast<const uint8_t*>(q) +
                        ((int64_t)bh * sq + q0 + warp * 16 + gid) * kD * kQBytes;
  constexpr int kSteps = kInt8 ? 2 : 4;
  constexpr int kStepBytes = 32;  // 32 int8 or 16 bf16
  uint32_t qa[kSteps][4];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const uint8_t* p0 = qrow + s * kStepBytes + tig * 4;
    qa[s][0] = *reinterpret_cast<const uint32_t*>(p0);
    qa[s][1] = *reinterpret_cast<const uint32_t*>(p0 + 8 * kD * kQBytes);
    qa[s][2] = *reinterpret_cast<const uint32_t*>(p0 + 16);
    qa[s][3] = *reinterpret_cast<const uint32_t*>(p0 + 8 * kD * kQBytes + 16);
  }

  float o[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
  float l0 = 0.0f, l1 = 0.0f;  // this thread's share of rows gid and gid + 8

  const int kv_end = ((kv_len + kBN - 1) / kBN) * kBN;  // later tiles are all masked
  const uint8_t* kbase = static_cast<const uint8_t*>(k) + (int64_t)bh * skv * kD * kQBytes;
  const uint8_t* vbase = reinterpret_cast<const uint8_t*>(v + (int64_t)bh * skv * kD);

  for (int kv0 = 0; kv0 < kv_end; kv0 += kBN) {
    __syncthreads();  // the previous tile is consumed
    load_rows(ks, kbase + (int64_t)kv0 * kD * kQBytes, kD * kQBytes, tid);
    load_rows(reinterpret_cast<uint8_t*>(vs), vbase + (int64_t)kv0 * kD * 2, kD * 2, tid);
    __syncthreads();

    // s = q . k^T over 8 column tiles of 8
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const uint8_t* krow = ks + (nt * 8 + mr) * kRowBytes;
      if constexpr (kInt8) {
        // one ldmatrix.x4 gives both k steps' B fragments (16 int8 = 8 b16)
        uint32_t kb[4];
        ldmatrix_x4(kb, krow + mi * 16);
        int acc[4] = {0, 0, 0, 0};
        mma_s8(acc, qa[0], kb[0], kb[1]);
        mma_s8(acc, qa[1], kb[2], kb[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) s[nt][j] = __fmul_rn((float)acc[j], sc);
      } else {
        // two ldmatrix.x4 give the 4 k steps' B fragments (8 bf16 a matrix row)
        uint32_t kb[2][4];
        ldmatrix_x4(kb[0], krow + mi * 16);
        ldmatrix_x4(kb[1], krow + 64 + mi * 16);
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
        mma_bf16(s[nt], qa[0], kb[0][0], kb[0][1]);
        mma_bf16(s[nt], qa[1], kb[0][2], kb[0][3]);
        mma_bf16(s[nt], qa[2], kb[1][0], kb[1][1]);
        mma_bf16(s[nt], qa[3], kb[1][2], kb[1][3]);
      }
    }

    // p = exp2(s - m) rounded to bf16, packed as the PV mma's A operand
    const bool tail = kv0 + kBN > kv_len;
    uint32_t pa[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = kv0 + nt * 8 + tig * 2;
      float p0 = exp2f(__fsub_rn(s[nt][0], m));
      float p1 = exp2f(__fsub_rn(s[nt][1], m));
      float p2 = exp2f(__fsub_rn(s[nt][2], m));
      float p3 = exp2f(__fsub_rn(s[nt][3], m));
      if (tail) {
        if (col >= kv_len) p0 = p2 = 0.0f;
        if (col + 1 >= kv_len) p1 = p3 = 0.0f;
      }
      const __nv_bfloat162 lo = __floats2bfloat162_rn(p0, p1);  // row gid
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p2, p3);  // row gid + 8
      l0 += __low2float(lo) + __high2float(lo);
      l1 += __low2float(hi) + __high2float(hi);
      pa[nt / 2][(nt % 2) * 2 + 0] = bf162_bits(lo);
      pa[nt / 2][(nt % 2) * 2 + 1] = bf162_bits(hi);
    }

    // out += p . v over 4 k chunks of 16 and 8 output tiles of 8
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int dt = 0; dt < 8; dt += 2) {
        uint32_t vb[4];
        // matrices: (k 0-7, dt), (k 8-15, dt), (k 0-7, dt+1), (k 8-15, dt+1)
        ldmatrix_x4_trans(vb, vs + (kc * 16 + (mi & 1) * 8 + mr) * kVStride +
                                  (dt + (mi >> 1)) * 8);
        mma_bf16(o[dt], pa[kc], vb[0], vb[1]);
        mma_bf16(o[dt + 1], pa[kc], vb[2], vb[3]);
      }
    }
  }

  l0 += __shfl_xor_sync(kFull, l0, 1);
  l0 += __shfl_xor_sync(kFull, l0, 2);
  l1 += __shfl_xor_sync(kFull, l1, 1);
  l1 += __shfl_xor_sync(kFull, l1, 2);
  const int row = q0 + warp * 16 + gid;
  float inv0 = 1.0f, inv1 = 1.0f;
  if (l_out != nullptr) {  // unnormalized: the raw numerator and l
    if (tig == 0) {
      l_out[(int64_t)bh * sq + row] = l0;
      l_out[(int64_t)bh * sq + row + 8] = l1;
    }
  } else {
    inv0 = l0 <= 0.0f ? 1.0f : __fdiv_rn(1.0f, l0);
    inv1 = l1 <= 0.0f ? 1.0f : __fdiv_rn(1.0f, l1);
  }
  __nv_bfloat16* orow = out + ((int64_t)bh * sq + row) * kD;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int col = dt * 8 + tig * 2;
    *reinterpret_cast<__nv_bfloat162*>(orow + col) =
        __floats2bfloat162_rn(__fmul_rn(o[dt][0], inv0), __fmul_rn(o[dt][1], inv0));
    *reinterpret_cast<__nv_bfloat162*>(orow + 8 * kD + col) =
        __floats2bfloat162_rn(__fmul_rn(o[dt][2], inv1), __fmul_rn(o[dt][3], inv1));
  }
}

}  // namespace

// q, k: [BH, sq | skv, 64] int8 (qk_int8) or bf16; v: [BH, skv, 64] bf16;
// shift, scale: [BH / hper] f32; out: [BH, sq, 64] bf16; l_out: [BH, sq] f32
// or null (normalized). sq and skv multiples of 64, rows past the data zero,
// 0 < kv_len <= skv.
extern "C" int aether_flash_fixed_max(const void* q, const void* k, const void* v,
                                      const void* shift, const void* scale, void* out,
                                      void* l_out, int BH, int sq, int skv, int kv_len,
                                      int hper, int qk_int8, void* stream) {
  if (sq % kBM || skv % kBN || kv_len <= 0 || kv_len > skv || hper <= 0 || BH % hper)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(sq / kBM, BH);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* vv = static_cast<const __nv_bfloat16*>(v);
  auto* sh = static_cast<const float*>(shift);
  auto* sc = static_cast<const float*>(scale);
  auto* o = static_cast<__nv_bfloat16*>(out);
  auto* l = static_cast<float*>(l_out);
  if (qk_int8)
    flash_fixed_max_kernel<true><<<grid, kWarps * 32, 0, st>>>(q, k, vv, sh, sc, o, l, sq,
                                                               skv, kv_len, hper);
  else
    flash_fixed_max_kernel<false><<<grid, kWarps * 32, 0, st>>>(q, k, vv, sh, sc, o, l, sq,
                                                                skv, kv_len, hper);
  return static_cast<int>(cudaGetLastError());
}
