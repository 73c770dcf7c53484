// K6 at the head dims other than 64: full-int8 flash attention with an
// integer running max for head_dim 16, 32, 48, 80, 96 and 112, written by
// hand for Hopper (sm_90a) on mma.sync.
//
// Replaces aether_tpu/ops/flash_attention.py::_flash_kernel_pv8 (:259, the
// Pallas TPU kernel launched by flash_attention(fixed_max=True, qk_int8=True,
// pv_int8=True); the DiT's attention at AETHER_ATTN_PV8=1) at those head
// dims; head_dim 64 keeps flash_pv8.cu (wgmma). The function is
// flash_pv8.cu's: non-causal, in the log2 domain, q, k and v int8 with one
// scale per head group g; per span of `span` kv columns (the TPU kernel's kv
// block, _pick_block(Skv, 1024)):
//   s   = f32(int32(q8 . k8^T)) * scale_g, + (-1e9) at columns >= kv_len
//   m'  = max(m, ceil(rowmax s)),  m starting at -1e9
//   p8  = rint(127 * exp2(s - m'))                   (0..127)
//   acc = acc * exp2(m - m') + f32(int32(p8 . v8))   (exp2 of an integer: exact)
//   l   = l * exp2(m - m') + f32(127 * int32(sum p8))
//   out = acc / l * vscale_g                          (l = 0 -> divide by 1)
// The running max moves once a span, as in the TPU kernel, so each span is
// swept twice: the first sweep takes the row max over the span, the second
// recomputes s and runs p8 . v8. Within a span every product and sum is an
// integer below 2^24 (127 * 127 * 1024), so the int32 accumulators and their
// f32 conversion are exact, and the kernel computes the plain version's
// function up to exp2f's last bit.
//
// What bounds it on an H100: at 48 heads x 15076 tokens the two sweeps make
// QK^T twice and PV once, 6.5e10 x D int8 operations (0.53 ms at D 16, 3.7
// ms at D 112 at 1979 TOP/s), and 1.1e10 exp2 (2.61 ms on the SFU at 16 a
// clock an SM and 1980 MHz): the SFU binds below D 80, the products above.
// mma.sync reaches a fraction of the tensor cores' rate. The design,
// the simple form (mma_sync.cuh's pieces):
//   * a CTA of 4 warps holds 64 q rows (16 a warp), the q8 fragments in
//     registers for the whole walk; kv tiles of 64 columns (a span is a
//     multiple of 128) through shared memory; grid (q tiles, B*H);
//   * S = Q8 K8^T on mma.sync m16n8k32 s8, K padded to 32 with zero
//     columns; P8 V8 on m16n8k32 s8 with p8 from the S accumulators in
//     registers: v8 comes transposed ([BH, D, Skv]) with the kv order inside
//     every 32-column chunk permuted to the order in which a thread holds
//     p8 (ops/flash_attention.py::_pv8_v_layout), so each A fragment is four
//     of a thread's own p8 bytes and each B fragment one ldmatrix;
//   * sweep 1 takes its max over the integers (s rises with them) and
//     converts once; the span's PV sums stay in s32 registers and fold into
//     the f32 accumulator once a span; tiles and spans wholly past kv_len
//     are skipped (alpha = 1, p8 = 0).
// Compiled without --use_fast_math so exp2f and the division stay accurate.

#include <limits.h>
#include <math.h>

#include "mma_sync.cuh"

namespace {

using namespace mma_sync;

constexpr int kBM = 64;   // q rows a CTA
constexpr int kBN = 64;   // kv columns a tile
constexpr int kWarps = 4;
constexpr float kNeg = -1e9f;  // padding bias and initial max (the TPU kernel's)

struct Params {
  const int8_t* q;    // [BH, sq, D]
  const int8_t* k;    // [BH, skv, D]
  const int8_t* vt;   // [BH, D, skv], _pv8_v_layout's order
  const float* scale; // [G]
  const float* vscale;
  void* out;          // [BH, sq, D] f32 or bf16
  int sq, skv, kv_len, hper, span;
};

template <typename T> __device__ __forceinline__ void store2(T* p, float a, float b);
template <> __device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a,
                                                                 float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// the low bytes of a, b, c, d packed into one word, a lowest
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (static_cast<uint32_t>(a) & 0xffu) | ((static_cast<uint32_t>(b) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c) & 0xffu) << 16) | (static_cast<uint32_t>(d) << 24);
}

template <int D, typename T>
__global__ void __launch_bounds__(kWarps * 32) pv8_hd_kernel(const Params p) {
  static_assert(D % 16 == 0 && D < 128, "head_dim: a multiple of 16 below 128");
  constexpr int kKWidth = (D + 31) / 32 * 32;  // the QK^T product's K
  constexpr int kSteps = kKWidth / 32;
  constexpr int kKStride = kKWidth + 16;       // bytes a k row in shared memory
  constexpr int kVStride = kBN + 16;           // bytes a v8^T row (one output column)
  constexpr int kDT = D / 8;                   // output tiles of 8 columns
  __shared__ __align__(16) uint8_t ks[kBN * kKStride];
  __shared__ __align__(16) uint8_t vts[D * kVStride];

  const int bh = blockIdx.y;
  const int g = bh / p.hper;
  const int q0 = blockIdx.x * kBM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int mi = lane / 8, mr = lane % 8;

  if (kKWidth != D) {  // the product's padding columns of k: zeros
    for (int r = tid; r < kBN; r += kWarps * 32)
      *reinterpret_cast<uint4*>(ks + r * kKStride + D) = make_uint4(0, 0, 0, 0);
  }
  const float sc = p.scale[g];
  uint32_t qa[kSteps][4];
  load_a<D, 1, kSteps, false>(qa, reinterpret_cast<const uint8_t*>(p.q) + (int64_t)bh * p.sq * D,
                              q0 + warp * 16, p.sq, gid, tig);

  float acc[kDT][4];
#pragma unroll
  for (int i = 0; i < kDT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  float m0 = kNeg, m1 = kNeg;  // running max of rows gid and gid + 8
  float l0 = 0.0f, l1 = 0.0f;

  const int tile_end = (p.kv_len + kBN - 1) / kBN * kBN;  // later tiles are all masked
  const uint8_t* kbase = reinterpret_cast<const uint8_t*>(p.k) + (int64_t)bh * p.skv * D;
  const uint8_t* vbase = reinterpret_cast<const uint8_t*>(p.vt) + (int64_t)bh * D * p.skv;

  // int32 q8 . k8^T of the k tile in shared memory (this thread's fragments)
  auto qk = [&](int (&s)[8][4]) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0;
      const uint8_t* krow = ks + (nt * 8 + mr) * kKStride + (mi & 1) * 16;
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        uint32_t kb[2];
        ldmatrix_x2(kb, krow + st * 32);
        mma_s8(s[nt], qa[st], kb[0], kb[1]);
      }
    }
  };

  for (int span0 = 0; span0 < tile_end; span0 += p.span) {
    const int end = min(span0 + p.span, tile_end);

    // sweep 1: the row max of s over the span. s = f32(int) * sc with sc >
    // 0 rises with the integer, so the max is taken over the integers of
    // the valid columns and converted once; a masked column scores exactly
    // -1e9 (its k row is zero)
    int mi0 = INT_MIN, mi1 = INT_MIN;
    for (int kv0 = span0; kv0 < end; kv0 += kBN) {
      __syncthreads();
      load_rows<false>(ks, kKStride, kbase + (int64_t)kv0 * D, D, kBN, 0, tid, kWarps * 32);
      __syncthreads();
      int s[8][4];
      qk(s);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = kv0 + nt * 8 + tig * 2;
        if (col < p.kv_len) {
          mi0 = max(mi0, s[nt][0]);
          mi1 = max(mi1, s[nt][2]);
        }
        if (col + 1 < p.kv_len) {
          mi0 = max(mi0, s[nt][1]);
          mi1 = max(mi1, s[nt][3]);
        }
      }
    }
    float mx0 = mi0 == INT_MIN ? -INFINITY : __fmul_rn((float)mi0, sc);
    float mx1 = mi1 == INT_MIN ? -INFINITY : __fmul_rn((float)mi1, sc);
    if (span0 + p.span > p.kv_len) {  // the span holds masked columns
      mx0 = fmaxf(mx0, kNeg);
      mx1 = fmaxf(mx1, kNeg);
    }
    mx0 = row_max4(mx0);
    mx1 = row_max4(mx1);
    const float mn0 = fmaxf(m0, ceilf(mx0)), mn1 = fmaxf(m1, ceilf(mx1));
    const float alpha0 = exp2f(__fsub_rn(m0, mn0)), alpha1 = exp2f(__fsub_rn(m1, mn1));
    m0 = mn0;
    m1 = mn1;

    // sweep 2: p8 = rint(127 exp2(s - m)), p8 . v8 in s32 over the span
    int pv[kDT][4];
#pragma unroll
    for (int i = 0; i < kDT; ++i) pv[i][0] = pv[i][1] = pv[i][2] = pv[i][3] = 0;
    int ls0 = 0, ls1 = 0;  // row sums of p8 (rows gid, gid + 8)
    for (int kv0 = span0; kv0 < end; kv0 += kBN) {
      __syncthreads();
      load_rows<false>(ks, kKStride, kbase + (int64_t)kv0 * D, D, kBN, 0, tid, kWarps * 32);
      for (int i = tid; i < D * (kBN / 16); i += kWarps * 32) {  // v8^T: D rows of 64 bytes
        const int r = i / (kBN / 16), c = i % (kBN / 16);
        *reinterpret_cast<int4*>(vts + r * kVStride + c * 16) =
            *reinterpret_cast<const int4*>(vbase + (int64_t)r * p.skv + kv0 + c * 16);
      }
      __syncthreads();
      int s[8][4];
      qk(s);
      const bool tail = kv0 + kBN > p.kv_len;
      int p8[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = kv0 + nt * 8 + tig * 2;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = __fmul_rn((float)s[nt][e], sc);
          if (tail && col + (e % 2) >= p.kv_len) x = __fadd_rn(x, kNeg);
          const float pr = exp2f(__fsub_rn(x, e < 2 ? m0 : m1));
          p8[nt][e] = static_cast<int>(rintf(__fmul_rn(pr, 127.0f)));
        }
        ls0 += p8[nt][0] + p8[nt][1];
        ls1 += p8[nt][2] + p8[nt][3];
      }
      // A fragments of each 32-column chunk kc: logical k 4 tig + j (j < 4)
      // is column 8 (j / 2) + 2 tig + j % 2 of the chunk (_pv8_v_layout)
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        const int n = 4 * kc;
        uint32_t pa[4];
        pa[0] = pack4(p8[n][0], p8[n][1], p8[n + 1][0], p8[n + 1][1]);
        pa[1] = pack4(p8[n][2], p8[n][3], p8[n + 1][2], p8[n + 1][3]);
        pa[2] = pack4(p8[n + 2][0], p8[n + 2][1], p8[n + 3][0], p8[n + 3][1]);
        pa[3] = pack4(p8[n + 2][2], p8[n + 2][3], p8[n + 3][2], p8[n + 3][3]);
#pragma unroll
        for (int dt = 0; dt < kDT; ++dt) {
          uint32_t vb[2];
          ldmatrix_x2(vb, vts + (dt * 8 + mr) * kVStride + kc * 32 + (mi & 1) * 16);
          mma_s8(pv[dt], pa, vb[0], vb[1]);
        }
      }
    }
    ls0 += __shfl_xor_sync(kFull, ls0, 1);
    ls0 += __shfl_xor_sync(kFull, ls0, 2);
    ls1 += __shfl_xor_sync(kFull, ls1, 1);
    ls1 += __shfl_xor_sync(kFull, ls1, 2);
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      acc[dt][0] = __fadd_rn(__fmul_rn(acc[dt][0], alpha0), (float)pv[dt][0]);
      acc[dt][1] = __fadd_rn(__fmul_rn(acc[dt][1], alpha0), (float)pv[dt][1]);
      acc[dt][2] = __fadd_rn(__fmul_rn(acc[dt][2], alpha1), (float)pv[dt][2]);
      acc[dt][3] = __fadd_rn(__fmul_rn(acc[dt][3], alpha1), (float)pv[dt][3]);
    }
    l0 = __fadd_rn(__fmul_rn(l0, alpha0), (float)(127 * ls0));
    l1 = __fadd_rn(__fmul_rn(l1, alpha1), (float)(127 * ls1));
  }

  const float vs = p.vscale[g];
  const float inv0 = l0 <= 0.0f ? 1.0f : __fdiv_rn(1.0f, l0);
  const float inv1 = l1 <= 0.0f ? 1.0f : __fdiv_rn(1.0f, l1);
  const int row = q0 + warp * 16 + gid;
  T* obase = static_cast<T*>(p.out) + (int64_t)bh * p.sq * D;
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt) {
    const int col = dt * 8 + tig * 2;
    if (row < p.sq)
      store2<T>(obase + (int64_t)row * D + col, __fmul_rn(__fmul_rn(acc[dt][0], inv0), vs),
                __fmul_rn(__fmul_rn(acc[dt][1], inv0), vs));
    if (row + 8 < p.sq)
      store2<T>(obase + (int64_t)(row + 8) * D + col,
                __fmul_rn(__fmul_rn(acc[dt][2], inv1), vs),
                __fmul_rn(__fmul_rn(acc[dt][3], inv1), vs));
  }
}

template <int D>
int launch(const Params& p, int BH, int dtype, cudaStream_t st) {
  const dim3 grid((p.sq + kBM - 1) / kBM, BH);
  if (dtype == 0)
    pv8_hd_kernel<D, float><<<grid, kWarps * 32, 0, st>>>(p);
  else
    pv8_hd_kernel<D, __nv_bfloat16><<<grid, kWarps * 32, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q8: [BH, sq, D] int8; k8: [BH, skv, D] int8; v8t: [BH, D, skv] int8 in
// _pv8_v_layout's order; scale, vscale: [BH / hper] f32; out: [BH, sq, D] of
// float (dtype 0) or bf16 (dtype 1). All contiguous and 16-byte aligned; sq
// a multiple of 64, span a multiple of 128 dividing skv, rows past the data
// zero, 0 < kv_len <= skv; D one of 16, 32, 48, 80, 96, 112. Returns a
// cudaError_t.
extern "C" int aether_flash_pv8_hd(const void* q8, const void* k8, const void* v8t,
                                   const void* scale, const void* vscale, void* out, int BH,
                                   int sq, int skv, int kv_len, int hper, int span, int dtype,
                                   int D, void* stream) {
  if (BH <= 0 || BH > 65535 || sq <= 0 || sq % kBM || span <= 0 || span % 128 ||
      skv % span || kv_len <= 0 || kv_len > skv || hper <= 0 || BH % hper ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = static_cast<const int8_t*>(q8);
  p.k = static_cast<const int8_t*>(k8);
  p.vt = static_cast<const int8_t*>(v8t);
  p.scale = static_cast<const float*>(scale);
  p.vscale = static_cast<const float*>(vscale);
  p.out = out;
  p.sq = sq;
  p.skv = skv;
  p.kv_len = kv_len;
  p.hper = hper;
  p.span = span;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(p, BH, dtype, st);
    case 32: return launch<32>(p, BH, dtype, st);
    case 48: return launch<48>(p, BH, dtype, st);
    case 80: return launch<80>(p, BH, dtype, st);
    case 96: return launch<96>(p, BH, dtype, st);
    case 112: return launch<112>(p, BH, dtype, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
