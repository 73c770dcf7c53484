// The simple attention cell on mma.sync, written by hand for Hopper
// (sm_90a): one kernel template over the head dim, the QK^T type and a mode,
// shared by K2 (flash_prepacked_hd.cu) and K4 in bf16 (flash_online_hd.cu)
// at the head dims other than 64.
//
// Replaces, at head_dim 16-112 in steps of 16 other than 64 (K4 also 128),
// two Pallas TPU kernels of aether_tpu/ops/flash_attention.py, in the log2
// domain, non-causal, bf16 v and output, for head group g = bh / hper:
//   kPrepacked  _flash_kernel_prepacked (:812), K2 over the prologue's
//               operands: s = f32(int32(q8 . k8^T)) * qsc[g, row / block] *
//               ksc[g, col / block] (int8) or q . k^T (bf16 q carrying the
//               fold); p = exp2(s - m_g), m_g = max_t qn[g, t] * max_t kn[g,
//               t] taken here (0 under noshift, or under noshift = auto when
//               every group's m is below 96);
//   kOnline     _flash_kernel (:69), K4 in bf16: q = bf16(q * fold) here,
//               columns >= kv_len scored -0.7 * f32max, a running max a row,
//               alpha = exp2(m - m'), p = exp2(s - m'); l sums bf16(p)
//               (round_l: the "mxu" denominator, the TPU's ones column) or
//               p ("vpu", which the JAX wrapper forces at head_dim >= 128).
// kPrepacked: out = sum_j bf16(p_j) v_j / sum_j bf16(p_j), p = 0 at columns
// >= kv_len, a denominator <= 0 divides by 1.
//
// What bounds it on an H100: at the main path's 48 heads x 15076 tokens
// every mode makes 1.1e10 exp2 (2.61 ms on the SFU at 16 a clock an SM and
// 1980 MHz), and 4 * 48 * 15076^2 * D operations (bf16: 4.94 ms at D 112,
// 5.65 at 128 on the 989-TFLOP/s tensor cores); below D 64 the SFU binds,
// above it the products. mma.sync reaches about a quarter of the tensor
// cores' rate, so this form sits well above its bound; the wgmma + TMA cell
// online_cell.cuh is built around 64-element rows and keeps head_dim 64, and
// fixed_cell.cuh takes K3's head dims, not yet K2's. The design, the simple
// form:
//   * a CTA of 4 warps holds 64 q rows (16 a warp) and walks every kv tile
//     of 64 columns up to kv_len; tiles wholly past it add nothing and are
//     skipped; grid (q tiles, B*H);
//   * QK^T on m16n8k32 s8 or m16n8k16 bf16 with the q fragments in
//     registers for the whole walk, k's from shared memory; p stays in
//     registers as the A operand of P V (m16n8k16 bf16, v by
//     ldmatrix.trans) -- mma_sync.cuh's pieces;
//   * kPrepacked keeps no running max: a tile's p is final when it is
//     made; kOnline reduces a tile's row max over the 4 lanes that share a
//     row and rescales its accumulators and l by exp2(m - m');
//   * rows past the q and kv lengths load as zeros and stores past sq are
//     dropped, so no wrapper pads.
// The scale and the shift are applied unfused, f32(s) * scale then - shift,
// as the plain versions round them. Built without --use_fast_math so exp2f
// and the division stay accurate.

#pragma once

#include <math.h>

#include "mma_sync.cuh"

namespace {
namespace mma_cell {

using namespace mma_sync;

constexpr int kBM = 64;  // q rows a CTA
constexpr int kBN = 64;  // kv columns a tile
constexpr int kWarps = 4;
constexpr float kNoShiftBelow = 96.0f;
constexpr float kNegInf = -0.7f * 3.40282347e38f;  // the TPU kernel's mask
enum NoShift { kKeep = 0, kDrop = 1, kAuto = 2 };
enum Mode { kPrepacked = 0, kOnline = 1 };

struct Params {
  const void* q;  // [BH, sq, D] int8 or bf16
  const void* k;  // [BH, skv, D] int8 or bf16
  const __nv_bfloat16* v;  // [BH, skv, D]
  __nv_bfloat16* out;      // [BH, sq, D]
  const float* qsc;        // kPrepacked: [G, n_tiles] scales and norm maxima
  const float* ksc;
  const float* qn;
  const float* kn;
  float fold;              // kOnline: q = bf16(q * fold)
  int sq, skv, kv_len, hper;
  int block, n_tiles, groups, noshift;  // kPrepacked
  int round_l;                          // kOnline
};

__device__ __forceinline__ float group_bound(const Params& p, int g) {
  float mq = p.qn[g * p.n_tiles], mk = p.kn[g * p.n_tiles];
  for (int t = 1; t < p.n_tiles; ++t) {
    mq = fmaxf(mq, p.qn[g * p.n_tiles + t]);
    mk = fmaxf(mk, p.kn[g * p.n_tiles + t]);
  }
  return __fmul_rn(mq, mk);
}

// K2: the shift of head group g, by one warp (every warp takes the same)
__device__ float group_shift(const Params& p, int g, int lane) {
  if (p.noshift == kDrop) return 0.0f;
  const float bound = group_bound(p, g);
  if (p.noshift == kKeep) return bound;
  float top = -INFINITY;
  for (int h = lane; h < p.groups; h += 32) top = fmaxf(top, group_bound(p, h));
#pragma unroll
  for (int o = 16; o > 0; o /= 2) top = fmaxf(top, __shfl_xor_sync(kFull, top, o));
  return top < kNoShiftBelow ? 0.0f : bound;
}

// bf16(x * fold) of both halves of a packed bf16 pair
__device__ __forceinline__ uint32_t fold_bf16x2(uint32_t x, float fold) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&x);
  return bf162_bits(__floats2bfloat162_rn(__fmul_rn(__low2float(v), fold),
                                          __fmul_rn(__high2float(v), fold)));
}

// D: head_dim, a multiple of 16 up to 128; kInt8: int8 q/k, else bf16
template <int D, bool kInt8, int kMode>
__global__ void __launch_bounds__(kWarps * 32) cell_kernel(const Params p) {
  static_assert(D % 16 == 0 && D <= 128, "head_dim: a multiple of 16 up to 128");
  static_assert(!(kInt8 && kMode == kOnline), "K4 takes bf16 q/k");
  constexpr int kQBytes = kInt8 ? 1 : 2;
  constexpr int kKWidth = kInt8 ? (D + 31) / 32 * 32 : D;  // the product's K
  constexpr int kSteps = kInt8 ? kKWidth / 32 : D / 16;    // mma k steps
  constexpr int kKStride = kKWidth * kQBytes + 16;         // bytes a k row in shared memory
  constexpr int kVStride = D + 8;                          // bf16 a v row in shared memory
  constexpr int kDT = D / 8;                               // output tiles of 8 columns
  // K2's rows fill its tiles (s_pad is a multiple of 128): no row guards
  constexpr bool kGuard = kMode != kPrepacked;
  __shared__ __align__(16) uint8_t ks[kBN * kKStride];
  __shared__ __align__(16) __nv_bfloat16 vs[kBN * kVStride];

  const int bh = blockIdx.y;
  const int g = bh / p.hper;
  const int q0 = blockIdx.x * kBM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int mi = lane / 8, mr = lane % 8;  // ldmatrix: matrix index, row within it

  if (kInt8 && kKWidth != D) {  // the product's padding columns of k: zeros
    for (int r = tid; r < kBN; r += kWarps * 32)
      *reinterpret_cast<uint4*>(ks + r * kKStride + D) = make_uint4(0, 0, 0, 0);
  }
  float shift = 0.0f, q_scale = 1.0f;
  if (kMode == kPrepacked) {
    shift = group_shift(p, g, lane);
    if (kInt8) q_scale = p.qsc[g * p.n_tiles + q0 / p.block];
  }

  // q fragments of this warp's 16 rows (A operand, row-major)
  uint32_t qa[kSteps][4];
  load_a<D, kQBytes, kSteps, kGuard>(qa, static_cast<const uint8_t*>(p.q) +
                                     (int64_t)bh * p.sq * D * kQBytes,
                             q0 + warp * 16, p.sq, gid, tig);
  if (kMode == kOnline) {
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
#pragma unroll
      for (int j = 0; j < 4; ++j) qa[s][j] = fold_bf16x2(qa[s][j], p.fold);
  }

  float o[kDT][4];
#pragma unroll
  for (int i = 0; i < kDT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
  float l0 = 0.0f, l1 = 0.0f;  // this thread's share of rows gid and gid + 8
  float m0 = -INFINITY, m1 = -INFINITY;  // kOnline: the running max of both rows

  const int kv_end = (p.kv_len + kBN - 1) / kBN * kBN;  // later tiles add nothing
  const uint8_t* kbase = static_cast<const uint8_t*>(p.k) + (int64_t)bh * p.skv * D * kQBytes;
  const uint8_t* vbase =
      reinterpret_cast<const uint8_t*>(p.v + (int64_t)bh * p.skv * D);

  for (int kv0 = 0; kv0 < kv_end; kv0 += kBN) {
    __syncthreads();  // the previous tile is consumed
    load_rows<kGuard>(ks, kKStride, kbase + (int64_t)kv0 * D * kQBytes, D * kQBytes, kBN,
                      p.skv - kv0, tid, kWarps * 32);
    load_rows<kGuard>(reinterpret_cast<uint8_t*>(vs), kVStride * 2,
                      vbase + (int64_t)kv0 * D * 2, D * 2, kBN, p.skv - kv0, tid, kWarps * 32);
    __syncthreads();

    const float sc = kInt8 ? __fmul_rn(q_scale, p.ksc[g * p.n_tiles + kv0 / p.block]) : 1.0f;

    // s = q . k^T over 8 column tiles of 8; each k step's B fragments are
    // two 8x8 matrices of 16 bytes a row
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const uint8_t* krow = ks + (nt * 8 + mr) * kKStride + (mi & 1) * 16;
      if constexpr (kInt8) {
        int acc[4] = {0, 0, 0, 0};
#pragma unroll
        for (int st = 0; st < kSteps; ++st) {
          uint32_t kb[2];
          ldmatrix_x2(kb, krow + st * 32);
          mma_s8(acc, qa[st], kb[0], kb[1]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) s[nt][j] = __fmul_rn((float)acc[j], sc);
      } else {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
#pragma unroll
        for (int st = 0; st < kSteps; ++st) {
          uint32_t kb[2];
          ldmatrix_x2(kb, krow + st * 32);
          mma_bf16(s[nt], qa[st], kb[0], kb[1]);
        }
      }
    }

    const bool tail = kv0 + kBN > p.kv_len;
    if (kMode == kOnline) {
      // the running max of rows gid and gid + 8 over this tile
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = kv0 + nt * 8 + tig * 2;
        if (tail) {
          if (col >= p.kv_len) s[nt][0] = s[nt][2] = kNegInf;
          if (col + 1 >= p.kv_len) s[nt][1] = s[nt][3] = kNegInf;
        }
        mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
      }
      const float mn0 = fmaxf(m0, row_max4(mx0)), mn1 = fmaxf(m1, row_max4(mx1));
      const float alpha0 = exp2f(__fsub_rn(m0, mn0)), alpha1 = exp2f(__fsub_rn(m1, mn1));
      m0 = mn0;
      m1 = mn1;
      l0 = __fmul_rn(l0, alpha0);
      l1 = __fmul_rn(l1, alpha1);
#pragma unroll
      for (int i = 0; i < kDT; ++i) {
        o[i][0] = __fmul_rn(o[i][0], alpha0);
        o[i][1] = __fmul_rn(o[i][1], alpha0);
        o[i][2] = __fmul_rn(o[i][2], alpha1);
        o[i][3] = __fmul_rn(o[i][3], alpha1);
      }
    }

    // p = exp2(s - shift) rounded to bf16, packed as the P V mma's A operand
    uint32_t pa[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = kv0 + nt * 8 + tig * 2;
      const float sh0 = kMode == kOnline ? m0 : shift, sh1 = kMode == kOnline ? m1 : shift;
      float p0 = exp2f(__fsub_rn(s[nt][0], sh0));
      float p1 = exp2f(__fsub_rn(s[nt][1], sh0));
      float p2 = exp2f(__fsub_rn(s[nt][2], sh1));
      float p3 = exp2f(__fsub_rn(s[nt][3], sh1));
      if (kMode != kOnline && tail) {  // the online mode scored them kNegInf: p = 0
        if (col >= p.kv_len) p0 = p2 = 0.0f;
        if (col + 1 >= p.kv_len) p1 = p3 = 0.0f;
      }
      const __nv_bfloat162 lo = __floats2bfloat162_rn(p0, p1);  // row gid
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p2, p3);  // row gid + 8
      if (kMode == kOnline && !p.round_l) {
        l0 += p0 + p1;
        l1 += p2 + p3;
      } else {
        l0 += __low2float(lo) + __high2float(lo);
        l1 += __low2float(hi) + __high2float(hi);
      }
      pa[nt / 2][(nt % 2) * 2 + 0] = bf162_bits(lo);
      pa[nt / 2][(nt % 2) * 2 + 1] = bf162_bits(hi);
    }

    // out += p . v over 4 k chunks of 16 and the head_dim / 8 output tiles
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int dt = 0; dt < kDT; dt += 2) {
        uint32_t vb[4];
        // matrices: (k 0-7, dt), (k 8-15, dt), (k 0-7, dt+1), (k 8-15, dt+1)
        ldmatrix_x4_trans(vb, vs + (kc * 16 + (mi & 1) * 8 + mr) * kVStride +
                                  (dt + (mi >> 1)) * 8);
        mma_bf16(o[dt], pa[kc], vb[0], vb[1]);
        mma_bf16(o[dt + 1], pa[kc], vb[2], vb[3]);
      }
    }
  }

  l0 = row_sum4(l0);
  l1 = row_sum4(l1);
  const int row = q0 + warp * 16 + gid;
  const float inv0 = l0 <= 0.0f ? 1.0f : __fdiv_rn(1.0f, l0);
  const float inv1 = l1 <= 0.0f ? 1.0f : __fdiv_rn(1.0f, l1);
  __nv_bfloat16* orow = p.out + ((int64_t)bh * p.sq + row) * D;
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt) {
    const int col = dt * 8 + tig * 2;
    if (row < p.sq)
      *reinterpret_cast<__nv_bfloat162*>(orow + col) =
          __floats2bfloat162_rn(__fmul_rn(o[dt][0], inv0), __fmul_rn(o[dt][1], inv0));
    if (row + 8 < p.sq)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * D + col) =
          __floats2bfloat162_rn(__fmul_rn(o[dt][2], inv1), __fmul_rn(o[dt][3], inv1));
  }
}

// One launch of an instance, grid (q tiles of 64 rows, BH). Returns a
// cudaError_t.
template <int D, bool kInt8, int kMode>
int launch(const Params& p, int BH, cudaStream_t st) {
  const dim3 grid((p.sq + kBM - 1) / kBM, BH);
  cell_kernel<D, kInt8, kMode><<<grid, kWarps * 32, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The instance for a head dim given at run time: D one of 16, 32, 48, 80,
// 96, 112 (and 128 for kOnline); any other returns cudaErrorInvalidValue.
template <bool kInt8, int kMode>
int launch_dim(const Params& p, int BH, int D, cudaStream_t st) {
  switch (D) {
    case 16: return launch<16, kInt8, kMode>(p, BH, st);
    case 32: return launch<32, kInt8, kMode>(p, BH, st);
    case 48: return launch<48, kInt8, kMode>(p, BH, st);
    case 80: return launch<80, kInt8, kMode>(p, BH, st);
    case 96: return launch<96, kInt8, kMode>(p, BH, st);
    case 112: return launch<112, kInt8, kMode>(p, BH, st);
    case 128:
      if constexpr (kMode == kOnline) return launch<128, kInt8, kMode>(p, BH, st);
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace mma_cell
}  // namespace
