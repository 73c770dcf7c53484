// K6: full-int8 flash attention with an integer running max, written by hand
// for Hopper (sm_90a).
//
// Replaces aether_tpu/ops/flash_attention.py::_flash_kernel_pv8 (the Pallas
// TPU kernel launched by flash_attention(fixed_max=True, qk_int8=True,
// pv_int8=True); the DiT's attention at AETHER_ATTN_PV8=1). Non-causal,
// head_dim 64, in the log2 domain; q, k and v are int8 with one scale per
// head group g. Per span of `span` kv columns (the TPU kernel's kv block,
// _pick_block(Skv, 1024)):
//   s   = f32(int32(q8 . k8^T)) * scale_g, + (-1e9) at columns >= kv_len
//   m'  = max(m, ceil(rowmax s)),  m starting at -1e9
//   p8  = rint(127 * exp2(s - m'))                   (0..127)
//   acc = acc * exp2(m - m') + f32(int32(p8 . v8))   (exp2 of an integer: exact)
//   l   = l * exp2(m - m') + f32(127 * int32(sum p8))
//   out = acc / l * vscale_g                          (l = 0 -> divide by 1)
// The TPU kernel rounded p8 against the running max of its whole 1024-column
// block. A kernel that moves the max every 64 columns would round
// differently, so each span is swept twice: the first sweep takes the row
// max over the span, the second recomputes s and runs p8 . v8. Within a
// span every product and sum is an integer below 2^24 (127 * 127 * 1024),
// so the int32 accumulators and their f32 conversion are exact and the
// kernel computes the TPU kernel's function up to exp2f's last bit.
//
// What bounds it on an H100: the two sweeps make QK^T twice (int8, half the
// bf16 work each) and PV once (int8), 7.7e12 int8 ops per call at the CFG
// pair's 2 x 48 heads x 15076 tokens, and 2.2e10 exp2. The design:
//   * grid (q tiles of 64 rows, B*H); 4 warps, 16 q rows each; q fragments
//     in registers, k fragments from shared memory with ldmatrix (K2's QK^T);
//   * mma.sync m16n8k32 s8 x s8 -> s32 for both products. The s32
//     accumulator of QK^T gives a thread columns 2t, 2t+1, 8+2t, 9+2t (and
//     +16) of each 32-column chunk, while the s8 A operand of the PV mma
//     wants k = 4t..4t+3 (and +16). Instead of moving p8 through shared
//     memory, the wrapper writes v8 transposed ([BH, 64, Skv], the B operand
//     needs k-contiguous rows) with the kv order inside each 32-column chunk
//     permuted to the thread's order (ops/flash_attention.py::_pv8_v_layout);
//     the sum over k is unchanged;
//   * the span's PV sums stay in s32 registers and fold into the f32
//     accumulator once per span; tiles and spans wholly past kv_len are
//     skipped (they change nothing: alpha = 1, p8 = 0).
// wgmma, TMA and one-sweep spans kept in shared memory are later work.
// Compiled without --use_fast_math so exp2f and the division stay accurate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;
constexpr int kBM = 64;            // q rows per CTA
constexpr int kBN = 64;            // kv columns per tile
constexpr int kWarps = 4;
constexpr int kStride = 80;        // bytes per k / v^T row in shared memory (64 + 16 pad)
constexpr float kNeg = -1e9f;      // padding bias and initial max (the TPU kernel's)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
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

// 64 rows x 64 bytes from device memory (row pitch `pitch` bytes) into
// shared memory rows of kStride bytes
__device__ __forceinline__ void load_tile(int8_t* dst, const int8_t* __restrict__ src,
                                          int64_t pitch, int tid) {
#pragma unroll
  for (int i = tid; i < 64 * 4; i += kWarps * 32) {
    const int r = i / 4, c = i % 4;
    *reinterpret_cast<int4*>(dst + r * kStride + c * 16) =
        *reinterpret_cast<const int4*>(src + r * pitch + c * 16);
  }
}

// scores of this warp's 16 rows against the 64 k rows in shared memory:
// s[nt][0..1] row gid, columns nt*8 + 2*tig + {0, 1}; s[nt][2..3] row gid+8
__device__ __forceinline__ void scores(float (&s)[8][4], const uint32_t (&qa)[2][4],
                                       const int8_t* ks, int kv0, int kv_len, float sc,
                                       int lane) {
  const int mi = lane / 8, mr = lane % 8, tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    uint32_t kb[4];
    ldmatrix_x4(kb, ks + (nt * 8 + mr) * kStride + mi * 16);
    int acc[4] = {0, 0, 0, 0};
    mma_s8(acc, qa[0], kb[0], kb[1]);
    mma_s8(acc, qa[1], kb[2], kb[3]);
    const int col = kv0 + nt * 8 + tig * 2;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float x = __fmul_rn((float)acc[j], sc);
      if (col + (j & 1) >= kv_len) x = __fadd_rn(x, kNeg);
      s[nt][j] = x;
    }
  }
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) |
         ((uint32_t)(c & 0xff) << 16) | ((uint32_t)(d & 0xff) << 24);
}

template <typename T> __device__ __forceinline__ void store2(T* p, float a, float b);
template <> __device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a,
                                                                 float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
flash_pv8_kernel(const int8_t* __restrict__ q8, const int8_t* __restrict__ k8,
                 const int8_t* __restrict__ v8t, const float* __restrict__ scale,
                 const float* __restrict__ vscale, T* __restrict__ out, int sq, int skv,
                 int kv_len, int hper, int span) {
  __shared__ __align__(16) int8_t ks[kBN * kStride];
  __shared__ __align__(16) int8_t vts[kD * kStride];

  const int bh = blockIdx.y;
  const int g = bh / hper;
  const int q0 = blockIdx.x * kBM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int mi = lane / 8, mr = lane % 8;
  const float sc = scale[g];

  // q fragments (m16n8k32 A, row-major) for this warp's 16 rows, both k steps
  const int8_t* qrow = q8 + ((int64_t)bh * sq + q0 + warp * 16 + gid) * kD;
  uint32_t qa[2][4];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    qa[s][0] = *reinterpret_cast<const uint32_t*>(qrow + s * 32 + tig * 4);
    qa[s][1] = *reinterpret_cast<const uint32_t*>(qrow + 8 * kD + s * 32 + tig * 4);
    qa[s][2] = *reinterpret_cast<const uint32_t*>(qrow + s * 32 + 16 + tig * 4);
    qa[s][3] = *reinterpret_cast<const uint32_t*>(qrow + 8 * kD + s * 32 + 16 + tig * 4);
  }

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  float m0 = kNeg, m1 = kNeg;  // running max of rows gid and gid + 8
  float l0 = 0.0f, l1 = 0.0f;

  const int8_t* kbase = k8 + (int64_t)bh * skv * kD;
  const int8_t* vbase = v8t + (int64_t)bh * kD * skv;
  const int tile_end = ((kv_len + kBN - 1) / kBN) * kBN;  // later tiles are all masked

  for (int span0 = 0; span0 < tile_end; span0 += span) {
    const int end = min(span0 + span, tile_end);

    // sweep 1: the row max of s over the span
    float mx0 = -INFINITY, mx1 = -INFINITY;
    for (int kv0 = span0; kv0 < end; kv0 += kBN) {
      __syncthreads();  // the previous tile is consumed
      load_tile(ks, kbase + (int64_t)kv0 * kD, kD, tid);
      __syncthreads();
      float s[8][4];
      scores(s, qa, ks, kv0, kv_len, sc, lane);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
    const float mn0 = fmaxf(m0, ceilf(mx0)), mn1 = fmaxf(m1, ceilf(mx1));
    const float alpha0 = exp2f(__fsub_rn(m0, mn0)), alpha1 = exp2f(__fsub_rn(m1, mn1));
    m0 = mn0;
    m1 = mn1;

    // sweep 2: p8 = rint(127 exp2(s - m)), p8 . v8 in s32 over the span
    int pv[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) pv[i][0] = pv[i][1] = pv[i][2] = pv[i][3] = 0;
    int ls0 = 0, ls1 = 0;
    for (int kv0 = span0; kv0 < end; kv0 += kBN) {
      __syncthreads();
      load_tile(ks, kbase + (int64_t)kv0 * kD, kD, tid);
      load_tile(vts, vbase + kv0, skv, tid);  // 64 output columns x 64 kv
      __syncthreads();
      float s[8][4];
      scores(s, qa, ks, kv0, kv_len, sc, lane);
      int p8[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = exp2f(__fsub_rn(s[nt][j], (j < 2) ? m0 : m1));
          p8[nt][j] = (int)rintf(__fmul_rn(p, 127.0f));
        }
        ls0 += p8[nt][0] + p8[nt][1];
        ls1 += p8[nt][2] + p8[nt][3];
      }
      // A fragments of the two 32-column chunks, in v8t's permuted k order:
      // logical k 4t..4t+3 = columns 2t, 2t+1 of tiles 4c and 4c+1, and
      // k 16+4t.. = the same of tiles 4c+2 and 4c+3
      uint32_t pa[2][4];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int t = 4 * c;
        pa[c][0] = pack4(p8[t][0], p8[t][1], p8[t + 1][0], p8[t + 1][1]);
        pa[c][1] = pack4(p8[t][2], p8[t][3], p8[t + 1][2], p8[t + 1][3]);
        pa[c][2] = pack4(p8[t + 2][0], p8[t + 2][1], p8[t + 3][0], p8[t + 3][1]);
        pa[c][3] = pack4(p8[t + 2][2], p8[t + 2][3], p8[t + 3][2], p8[t + 3][3]);
      }
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        uint32_t vb[4];  // (k 0-15, k 16-31) of chunk 0, then of chunk 1
        ldmatrix_x4(vb, vts + (dt * 8 + mr) * kStride + mi * 16);
        mma_s8(pv[dt], pa[0], vb[0], vb[1]);
        mma_s8(pv[dt], pa[1], vb[2], vb[3]);
      }
    }
    ls0 += __shfl_xor_sync(kFull, ls0, 1);
    ls0 += __shfl_xor_sync(kFull, ls0, 2);
    ls1 += __shfl_xor_sync(kFull, ls1, 1);
    ls1 += __shfl_xor_sync(kFull, ls1, 2);
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      acc[dt][0] = __fadd_rn(__fmul_rn(acc[dt][0], alpha0), (float)pv[dt][0]);
      acc[dt][1] = __fadd_rn(__fmul_rn(acc[dt][1], alpha0), (float)pv[dt][1]);
      acc[dt][2] = __fadd_rn(__fmul_rn(acc[dt][2], alpha1), (float)pv[dt][2]);
      acc[dt][3] = __fadd_rn(__fmul_rn(acc[dt][3], alpha1), (float)pv[dt][3]);
    }
    l0 = __fadd_rn(__fmul_rn(l0, alpha0), (float)(127 * ls0));
    l1 = __fadd_rn(__fmul_rn(l1, alpha1), (float)(127 * ls1));
  }

  const float vs = vscale[g];
  const float inv0 = l0 <= 0.0f ? 1.0f : __fdiv_rn(1.0f, l0);
  const float inv1 = l1 <= 0.0f ? 1.0f : __fdiv_rn(1.0f, l1);
  T* orow = out + ((int64_t)bh * sq + q0 + warp * 16 + gid) * kD;
#pragma unroll
  for (int dt = 0; dt < 8; ++dt) {
    const int col = dt * 8 + tig * 2;
    store2<T>(orow + col, __fmul_rn(__fmul_rn(acc[dt][0], inv0), vs),
              __fmul_rn(__fmul_rn(acc[dt][1], inv0), vs));
    store2<T>(orow + 8 * kD + col, __fmul_rn(__fmul_rn(acc[dt][2], inv1), vs),
              __fmul_rn(__fmul_rn(acc[dt][3], inv1), vs));
  }
}

template <typename T>
int launch(const void* q8, const void* k8, const void* v8t, const void* scale,
           const void* vscale, void* out, int BH, int sq, int skv, int kv_len, int hper,
           int span, cudaStream_t stream) {
  dim3 grid(sq / kBM, BH);
  flash_pv8_kernel<T><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const int8_t*>(q8), static_cast<const int8_t*>(k8),
      static_cast<const int8_t*>(v8t), static_cast<const float*>(scale),
      static_cast<const float*>(vscale), static_cast<T*>(out), sq, skv, kv_len, hper, span);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q8, k8: [BH, sq | skv, 64] int8; v8t: [BH, 64, skv] int8 in
// _pv8_v_layout's order; scale, vscale: [BH / hper] f32; out: [BH, sq, 64] of
// float (dtype 0) or bf16 (dtype 1). sq a multiple of 64, span a multiple of
// 64 dividing skv, rows past the data zero, 0 < kv_len <= skv.
extern "C" int aether_flash_pv8(const void* q8, const void* k8, const void* v8t,
                                const void* scale, const void* vscale, void* out, int BH,
                                int sq, int skv, int kv_len, int hper, int span, int dtype,
                                void* stream) {
  if (sq % kBM || span <= 0 || span % kBN || skv % span || kv_len <= 0 || kv_len > skv ||
      hper <= 0 || BH % hper)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q8, k8, v8t, scale, vscale, out, BH, sq, skv, kv_len, hper, span, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q8, k8, v8t, scale, vscale, out, BH, sq, skv, kv_len, hper,
                                 span, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
