// K7, K8, K9: the online-softmax flash-attention tuning variants, written by
// hand for Hopper (sm_90a). One source, compile-time switches.
//
// Replaces three Pallas TPU kernels that run only from the benchmark scripts:
//   K7 scripts/bench_flash_variants.py::_kernel_v2   (flash_v2)
//   K8 scripts/bench_flash_multihead.py::_kernel     (flash_mh)
//   K9 scripts/bench_flash_bisect.py::_kernel        (flash_x)
// All three are the same non-causal online softmax over q pre-scaled in the
// wrapper (sm_scale, times log2(e) for the base-2 variants), head_dim 64:
//   s   = q . k^T                              (bf16 products, f32 sums)
//   s   = -0.7 * f32max  where column >= kv_end   (kMask: every tile, or only
//                                                 the tiles holding padding;
//                                                 none for padfix)
//   m'  = max(m, rowmax s),  alpha = e(m - m'),  p = e(s - m')
//   acc = alpha * acc + bf16(p) . v
//   l   = alpha * l + sum p                    (f32 p: only PV sees bf16(p))
//   l  -= pad * e(-m)                          (padfix: the zero pad keys gave
//                                               score 0 and added e(-m) each)
//   out = bf16(acc / l), l == 0 (K7) or l <= 0 (K8, K9) divides by 1
// e is exp2 (kExp2) or exp (K9's fold and padfix_exp). K arrives as rows
// [BH, S, 64] or pre-transposed [BH, 64, S] (kKt, K7's kt=True). K8's hper
// heads per grid cell become hper heads per CTA, walked in turn.
//
// The TPU kernels' block_q and block_k decide only the padding (the wrapper
// reproduces the JAX seq_pad arithmetic) and where the mask falls; the kernel
// uses its own 64 x 64 tiles. The running max then moves every 64 columns
// instead of every block_k, which changes p's bf16 rounding at the ulp level
// only. Every row's first tile holds real columns (kv_end > 0), so the
// running max is finite from the first tile on; tiles wholly past kv_end
// change nothing (alpha = 1, p = 0) and are skipped.
//
// What bounds it on an H100: matrix-unit work and the exponentials. One call
// at (1, 48, 15076, 64) is 2.8e12 bf16 flops (2.8 ms at 989 TFLOP/s) and
// 1.1e10 exponentials; it moves 0.37 GB (0.11 ms). The design, K3's
// (csrc/flash_fixed_max.cu) with a running max:
//   * grid (q tiles of 64 rows, B*H / hper); 4 warps, 16 q rows each; each
//     CTA loops over the kv tiles of 64 columns, so nothing is reduced
//     across CTAs;
//   * QK^T on mma.sync m16n8k16 bf16 x bf16 -> f32, q fragments held in
//     registers for the whole loop; k fragments from shared memory with
//     ldmatrix (rows) or ldmatrix.trans (k^T, the same tile transposed);
//   * the m16n8 accumulator layout equals the bf16 A-operand layout of
//     m16n8k16, so p goes from registers straight into the PV mma.sync; v
//     fragments come from shared memory with ldmatrix.trans;
//   * the row max and sum combine across the 4 threads of a row with two
//     shuffles; m, l and the accumulator stay in f32 registers.
// cp.async or TMA pipelining and wgmma are later work; this is the simple form.
// Compiled without --use_fast_math so exp2f, expf and the division stay accurate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;
constexpr int kBM = 64;                  // q rows per CTA
constexpr int kBN = 64;                  // kv columns per tile
constexpr int kWarps = 4;
constexpr int kRowBytes = 144;           // bytes per 64-bf16 shared row (128 + 16 pad)
constexpr int kStride = kRowBytes / 2;   // bf16 per shared row
constexpr float kNegInf = -0.7f * 3.40282347e38f;  // the TPU kernels' mask value
constexpr unsigned kFull = 0xffffffffu;

enum MaskMode { kMaskAll = 0, kMaskTail = 1, kMaskNone = 2 };

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

template <bool kExp2>
__device__ __forceinline__ float expo(float x) {
  return kExp2 ? exp2f(x) : expf(x);
}

// 64 rows of 128 bytes (source rows `src_stride` bytes apart) into shared
// rows of kRowBytes, in 16-byte chunks
__device__ __forceinline__ void load_tile(uint8_t* dst, const uint8_t* __restrict__ src,
                                          int64_t src_stride, int tid) {
#pragma unroll
  for (int i = tid; i < 64 * 8; i += kWarps * 32) {
    const int r = i / 8, c = i % 8;
    *reinterpret_cast<int4*>(dst + r * kRowBytes + c * 16) =
        *reinterpret_cast<const int4*>(src + r * src_stride + c * 16);
  }
}

// q, v, out: [BH, rows, 64] bf16; k: [BH, rows, 64] or, kKt, [BH, 64, rows]
template <bool kExp2, int kMask, bool kKt>
__global__ void __launch_bounds__(kWarps * 32)
flash_variants_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                      int rows, int kv_end, int pad, int hper, int guard_le) {
  __shared__ __align__(16) uint8_t ks[kBN * kRowBytes];  // k [col][d] or k^T [d][col]
  __shared__ __align__(16) __nv_bfloat16 vs[kBN * kStride];

  const int q0 = blockIdx.x * kBM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int mi = lane / 8, mr = lane % 8;  // ldmatrix: matrix index, row within it
  const int n_tiles = (kv_end + kBN - 1) / kBN;

  for (int hh = 0; hh < hper; ++hh) {
    const int bh = blockIdx.y * hper + hh;

    // q fragments for this warp's 16 rows (m16n8k16 A, row-major), 4 k steps
    const __nv_bfloat16* qrow = q + ((int64_t)bh * rows + q0 + warp * 16 + gid) * kD;
    uint32_t qa[4][4];
#pragma unroll
    for (int st = 0; st < 4; ++st) {
      const __nv_bfloat16* p0 = qrow + st * 16 + tig * 2;
      qa[st][0] = *reinterpret_cast<const uint32_t*>(p0);
      qa[st][1] = *reinterpret_cast<const uint32_t*>(p0 + 8 * kD);
      qa[st][2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
      qa[st][3] = *reinterpret_cast<const uint32_t*>(p0 + 8 * kD + 8);
    }

    float o[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
    // rows gid and gid + 8: running max (quad-uniform) and this thread's
    // share of the running sum
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

    const __nv_bfloat16* kbase = k + (int64_t)bh * rows * kD;
    const __nv_bfloat16* vbase = v + (int64_t)bh * rows * kD;

    for (int t = 0; t < n_tiles; ++t) {
      const int kv0 = t * kBN;
      __syncthreads();  // the previous tile (or head) is consumed
      if (kKt)
        load_tile(ks, reinterpret_cast<const uint8_t*>(kbase + kv0), (int64_t)rows * 2, tid);
      else
        load_tile(ks, reinterpret_cast<const uint8_t*>(kbase + (int64_t)kv0 * kD), kD * 2, tid);
      load_tile(reinterpret_cast<uint8_t*>(vs),
                reinterpret_cast<const uint8_t*>(vbase + (int64_t)kv0 * kD), kD * 2, tid);
      __syncthreads();

      // s = q . k^T over 8 column tiles of 8
      float s[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
      if (kKt) {
        // k^T rows are d: the B fragments of a k step are 8x8 blocks of
        // (d, column), transposed on load
#pragma unroll
        for (int st = 0; st < 4; ++st) {
#pragma unroll
          for (int nt = 0; nt < 8; nt += 2) {
            uint32_t kb[4];
            // matrices: (d 0-7, nt), (d 8-15, nt), (d 0-7, nt+1), (d 8-15, nt+1)
            ldmatrix_x4_trans(kb, ks + (st * 16 + (mi & 1) * 8 + mr) * kRowBytes +
                                      (nt + (mi >> 1)) * 16);
            mma_bf16(s[nt], qa[st], kb[0], kb[1]);
            mma_bf16(s[nt + 1], qa[st], kb[2], kb[3]);
          }
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          // two ldmatrix.x4 give the 4 k steps' B fragments (8 bf16 a matrix row)
          const uint8_t* krow = ks + (nt * 8 + mr) * kRowBytes;
          uint32_t kb[2][4];
          ldmatrix_x4(kb[0], krow + mi * 16);
          ldmatrix_x4(kb[1], krow + 64 + mi * 16);
          mma_bf16(s[nt], qa[0], kb[0][0], kb[0][1]);
          mma_bf16(s[nt], qa[1], kb[0][2], kb[0][3]);
          mma_bf16(s[nt], qa[2], kb[1][0], kb[1][1]);
          mma_bf16(s[nt], qa[3], kb[1][2], kb[1][3]);
        }
      }

      // the mask: every tile, or only a tile that reaches past kv_end
      if (kMask == kMaskAll || kv0 + kBN > kv_end) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int col = kv0 + nt * 8 + tig * 2;
          if (col >= kv_end) s[nt][0] = s[nt][2] = kNegInf;
          if (col + 1 >= kv_end) s[nt][1] = s[nt][3] = kNegInf;
        }
      }

      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float a0 = expo<kExp2>(__fsub_rn(m0, mn0));  // 0 on the first tile
      const float a1 = expo<kExp2>(__fsub_rn(m1, mn1));
      m0 = mn0;
      m1 = mn1;

      // p = e(s - m'), summed in f32 and rounded to bf16 as the PV mma's A operand
      uint32_t pa[4][4];
      float ls0 = 0.0f, ls1 = 0.0f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float p0 = expo<kExp2>(__fsub_rn(s[nt][0], mn0));
        const float p1 = expo<kExp2>(__fsub_rn(s[nt][1], mn0));
        const float p2 = expo<kExp2>(__fsub_rn(s[nt][2], mn1));
        const float p3 = expo<kExp2>(__fsub_rn(s[nt][3], mn1));
        ls0 = __fadd_rn(ls0, __fadd_rn(p0, p1));
        ls1 = __fadd_rn(ls1, __fadd_rn(p2, p3));
        pa[nt / 2][(nt % 2) * 2 + 0] = bf162_bits(__floats2bfloat162_rn(p0, p1));  // row gid
        pa[nt / 2][(nt % 2) * 2 + 1] = bf162_bits(__floats2bfloat162_rn(p2, p3));  // gid + 8
      }
      l0 = __fadd_rn(__fmul_rn(a0, l0), ls0);
      l1 = __fadd_rn(__fmul_rn(a1, l1), ls1);
#pragma unroll
      for (int dt = 0; dt < 8; ++dt) {
        o[dt][0] = __fmul_rn(o[dt][0], a0);
        o[dt][1] = __fmul_rn(o[dt][1], a0);
        o[dt][2] = __fmul_rn(o[dt][2], a1);
        o[dt][3] = __fmul_rn(o[dt][3], a1);
      }

      // out += p . v over 4 k chunks of 16 and 8 output tiles of 8
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
        for (int dt = 0; dt < 8; dt += 2) {
          uint32_t vb[4];
          // matrices: (k 0-7, dt), (k 8-15, dt), (k 0-7, dt+1), (k 8-15, dt+1)
          ldmatrix_x4_trans(vb, vs + (kc * 16 + (mi & 1) * 8 + mr) * kStride +
                                    (dt + (mi >> 1)) * 8);
          mma_bf16(o[dt], pa[kc], vb[0], vb[1]);
          mma_bf16(o[dt + 1], pa[kc], vb[2], vb[3]);
        }
      }
    }

    l0 = __fadd_rn(l0, __shfl_xor_sync(kFull, l0, 1));
    l0 = __fadd_rn(l0, __shfl_xor_sync(kFull, l0, 2));
    l1 = __fadd_rn(l1, __shfl_xor_sync(kFull, l1, 1));
    l1 = __fadd_rn(l1, __shfl_xor_sync(kFull, l1, 2));
    if (pad > 0) {  // padfix: the pad keys' mass, e(0 - m) each, leaves l
      l0 = __fsub_rn(l0, __fmul_rn((float)pad, expo<kExp2>(-m0)));
      l1 = __fsub_rn(l1, __fmul_rn((float)pad, expo<kExp2>(-m1)));
    }
    const bool one0 = guard_le ? l0 <= 0.0f : l0 == 0.0f;
    const bool one1 = guard_le ? l1 <= 0.0f : l1 == 0.0f;
    const float inv0 = one0 ? 1.0f : __fdiv_rn(1.0f, l0);
    const float inv1 = one1 ? 1.0f : __fdiv_rn(1.0f, l1);
    __nv_bfloat16* orow = out + ((int64_t)bh * rows + q0 + warp * 16 + gid) * kD;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      const int col = dt * 8 + tig * 2;
      *reinterpret_cast<__nv_bfloat162*>(orow + col) =
          __floats2bfloat162_rn(__fmul_rn(o[dt][0], inv0), __fmul_rn(o[dt][1], inv0));
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * kD + col) =
          __floats2bfloat162_rn(__fmul_rn(o[dt][2], inv1), __fmul_rn(o[dt][3], inv1));
    }
  }
}

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* out;
  int BH, rows, kv_end, pad, hper, guard_le;
  cudaStream_t stream;
};

template <bool kExp2, int kMask, bool kKt>
int launch(const Args& a) {
  dim3 grid(a.rows / kBM, a.BH / a.hper);
  flash_variants_kernel<kExp2, kMask, kKt><<<grid, kWarps * 32, 0, a.stream>>>(
      a.q, a.k, a.v, a.out, a.rows, a.kv_end, a.pad, a.hper, a.guard_le);
  return static_cast<int>(cudaGetLastError());
}

template <bool kExp2, int kMask>
int launch_layout(const Args& a, int kt) {
  return kt ? launch<kExp2, kMask, true>(a) : launch<kExp2, kMask, false>(a);
}

template <bool kExp2>
int launch_mask(const Args& a, int mask, int kt) {
  if (mask == kMaskAll) return launch_layout<kExp2, kMaskAll>(a, kt);
  if (mask == kMaskTail) return launch_layout<kExp2, kMaskTail>(a, kt);
  return launch_layout<kExp2, kMaskNone>(a, kt);
}

}  // namespace

// q (pre-scaled), v, out: [BH, rows, 64] bf16; k: [BH, rows, 64], or its
// transpose [BH, 64, rows] (kt). rows a multiple of 64, rows past the data
// zero; columns >= kv_end are masked (kv_end is the true length for the
// masking variants, the padded length for padfix); pad > 0 subtracts the pad
// keys' mass (padfix). use_exp2: exp2 or exp; mask: 0 every tile, 1 the
// tiles holding padding, 2 none; guard_le: l <= 0 (or l == 0) divides by 1.
extern "C" int aether_flash_variants(const void* q, const void* k, const void* v,
                                     void* out, int BH, int rows, int kv_end, int pad,
                                     int hper, int use_exp2, int mask, int kt,
                                     int guard_le, void* stream) {
  if (rows <= 0 || rows % kBM || kv_end <= 0 || kv_end > rows || pad < 0 || hper <= 0 ||
      BH % hper || mask < kMaskAll || mask > kMaskNone)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
         static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
         BH, rows, kv_end, pad, hper, guard_le, static_cast<cudaStream_t>(stream)};
  return use_exp2 ? launch_mask<true>(a, mask, kt) : launch_mask<false>(a, mask, kt);
}
