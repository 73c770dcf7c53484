// The f32 attention cell on the tensor cores, as split TF32 (3xTF32) wgmma
// with TMA, written by hand for Hopper (sm_90a): one kernel template over
// the head dim D (16 to 128 in steps of 16), the q/k type and a mode, shared
// by K4 in f32 (flash_online.cu) and K3 in f32 (flash_fixed_max_hd.cu, 16
// to 128). Above 128 K4 in f32 runs flash_online_wide.cu, a cluster of CTAs
// a q tile, each this cell's <128> plan on a slice of the head dim (pv and
// fold below are shared with it).
//
// Replaces two Pallas TPU kernels of aether_tpu/ops/flash_attention.py for
// f32 v, non-causal, in the log2 domain, head group g = bh / hper:
//   kOnline  _flash_kernel (:69), K4 in f32 (the training forward), q
//            carrying sm_scale * log2(e) from the wrapper:
//              s = q . k^T,  -0.7 * f32max at columns >= kv_len
//              m' = max(m, rowmax s), alpha = exp2(m - m'), p = exp2(s - m')
//              acc = alpha acc + p . v,  l = alpha l + sum p
//              out = acc / l, l <= 0 divides by 1
//            (p rounded to f32 v is p itself, so "mxu" and "vpu" are one sum);
//   kFixed   _flash_kernel_fixed_max (:151), K3 in f32 (the unfused request
//            in an f32 pipeline and its ring merge), one scale and one shift
//            a group from the wrapper:
//              s = f32(int32(q8 . k8^T)) * scale_g (int8 codes, kQK8) or q . k^T
//              p = exp2(s - shift_g), 0 at columns >= kv_len
//              out = sum p v / sum p (<= 0 -> 1), or unnormalized (the ring
//              merge): out = sum p v, l = sum p.
//
// The products. A TF32 tensor-core product keeps a 10-bit mantissa, too few
// for f32 attention in one pass. Split every f32 operand x into x_hi =
// tf32(x) and x_lo = tf32(x - x_hi) (round to nearest, ties away from zero;
// |x - x_hi - x_lo| <= 2^-22 |x|) and keep three of the four products:
//   S   = Q_hi K_hi^T + Q_hi K_lo^T + Q_lo K_hi^T        (kQK8: one exact s8
//         product of the codes instead)
//   acc = alpha acc + P_hi V_hi + P_hi V_lo + P_lo V_hi
// each in f32 on the tensor core; the dropped lo . lo term is about 2^-22 of
// the product, near f32's own rounding. The wrapper splits q, k and v
// (ops/flash_attention.py::_tf32_operands); the cell splits p in registers
// (tf32_rna in hopper.cuh). Every operand the tensor cores read has its low
// 13 bits zero, so how the hardware treats those bits does not matter, and
// no product anywhere is a single TF32 pass. This is the arithmetic of
// PyTorch's own f32 memory-efficient attention (CUTLASS's
// OpMultiplyAddFastF32).
//
// What bounds it on an H100: three TF32 products of QK^T and three of PV at
// 495 TFLOP/s, 3 * 4 * 48 * 15076^2 * D flops at the main path's 48 heads x
// 15076 tokens: 0.2645 ms x D (16.93 ms at D 64, 33.85 at 128), against
// 0.651 ms x D for one f32 product on the FMA units; below D 16 the exp2 a
// score on the SFU, 2.61 ms. The design (online_cell.cuh's shape, with the
// operands of each product doubled):
//   * a CTA takes 128 q rows: two consumer warpgroups of 64 rows and a
//     producer warpgroup that hands its registers to them (setmaxnreg: 24
//     for it, 240 a consumer thread); grid (q tiles, B*H);
//   * Q_hi (or the q codes) stays in shared memory for the whole kv loop and
//     Q_lo in registers as the A fragments of its product (D / 2 a thread);
//     the producer keeps K_hi, K_lo, V^T_hi and V^T_lo tiles of kBN kv rows
//     in a ring of kStages slots by TMA (mbarriers), so no load waits on the
//     math; rows past the tensors' ends and columns past D arrive as zeros,
//     and stores past sq are dropped, so the wrapper pads only V^T's kv
//     columns to a multiple of 8 (TMA's 16-byte row stride);
//   * S is 3 D / 8 k steps of wgmma m64n<kBN>k8 tf32 (two from shared
//     memory, one with Q_lo from registers); P stays in registers: the f32
//     accumulator fragment of S is split into P_hi and P_lo, which are the
//     register A operands of P V (wgmma m64n<D>k8 tf32). tf32 wgmma reads B
//     only K-major, so V comes as V^T ([BH, D, skv8], kv contiguous), and
//     since a thread holds S columns 2c, 2c + 1 of every group of 8 while
//     the A fragment of a k step wants columns c, c + 4, V^T's kv columns
//     are written in each group of 8 in the order [0, 2, 4, 6, 1, 3, 5, 7]
//     (ops/flash_attention.py::_tf32_vt): no shuffle. A tile's P V stays in
//     flight while the next tile's Q K^T is issued; while one warpgroup runs
//     its softmax the other's products run;
//   * the tile plan of each D (Plan below): kBN 64 up to D 64 and 32 above,
//     where a consumer thread holds D / 2 f32 of the output, D / 2 (D / 4 at
//     128) of a tile's P V (the promotion below), D / 2 of Q_lo and 3 kBN / 2
//     of S, P_hi and P_lo (192 registers at 64 and 96, 216 at 112, 208 at
//     128, before addresses);
//     q and k rows are 4 D bytes (1 for codes) rounded up to a
//     swizzle row, in 128-byte panels; V^T rows are kBN floats in 128-byte
//     panels of 32; kStages as many as fit in the 227 KB a block may take,
//     at most 4 (2 at D 112-128: Q_hi 64 KB + 2 x 60-64 KB);
//   * the tensor cores add into an f32 accumulator with less than f32's
//     rounding, and the loss grows with the number of additions: P V kept
//     on the tensor core over 15076 keys read a mean error of 1e-4 of the
//     output, in proportion to the kv length, against 1e-6 for PyTorch's f32
//     attention (PERF.md, section 6). So each tile's P V starts in fresh
//     registers and the output takes it in on the FMA units, o = alpha o +
//     P V, one FMA an element where the rescale took one multiply (1e-6
//     then, as PyTorch's). Up to D 112 the whole P V of a tile stays in
//     flight while the next tile's Q K^T is issued (D / 2 registers). At 128
//     that spilled, so there it is two wgmma chains over the two 64-row
//     halves of V^T (Plan::kHalves) into one accumulator of D / 4: the first
//     half is waited for and folded at once, the second stays in flight
//     across the next Q K^T;
//   * tiles wholly past kv_len are skipped (they change nothing) and only
//     the tile that crosses it is masked.
//
// Compiled without --use_fast_math so exp2f and the division stay accurate.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

// internal linkage: each source that includes the cell builds its own
// instances, as a kernel in one source would be
namespace {
namespace tf32x3_cell {

using namespace hopper;

constexpr float kNegInf = -0.7f * 3.40282347e38f;  // the TPU kernel's mask
constexpr unsigned kFull = 0xffffffffu;
enum Mode { kFixed = 1, kOnline = 2 };

// The tile plan of head dim D (the note above); kQK8: q and k are int8 codes
template <int D, bool kQK8>
struct Plan {
  static_assert(D % 16 == 0 && D >= 16 && D <= 128, "head_dim: 16 to 128 in steps of 16");
  static constexpr int kBN = D <= 64 ? 64 : 32;  // kv rows a tile
  static constexpr int kBM = 128;                // two consumer warpgroups of 64 q rows
  static constexpr int kConsumers = 256;
  static constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
  static constexpr int kProducerRegs = 24, kConsumerRegs = 240;
  // each tile's P V accumulates on the tensor core in fresh registers and
  // the output takes it in on the FMA units (the note above): in one chain
  // of width D, or at 128 in two of width 64 so that D / 4 registers hold it
  static constexpr int kHalves = D == 128 ? 2 : 1;
  static constexpr int kPV = D / kHalves;
  static_assert(128 * kProducerRegs + kConsumers * kConsumerRegs <=
                    kThreads * ((65536 / kThreads) & ~7),
                "setmaxnreg asks for more registers than the CTA starts with");
  // q and k (K-major): panels of kRow-byte rows, k steps of 32 bytes (8 tf32
  // or 32 int8)
  static constexpr int kEl = kQK8 ? 1 : 4;
  static constexpr int kRow = swizzle_row(D * kEl);
  static constexpr int kPanels = (D * kEl + 127) / 128;
  static constexpr int kSteps = (D * kEl + 31) / 32;
  static constexpr int kQTile = kBM * kRow * kPanels;  // bytes of Q_hi or the q codes
  static constexpr int kKTile = kBN * kRow * kPanels;  // of K_hi, K_lo or the k codes
  static constexpr int kKTiles = kQK8 ? 1 : 2;
  // V^T (K-major, kv contiguous): D rows of kBN floats, panels of 32 (128 bytes)
  static constexpr int kVPanels = kBN / 32;
  static constexpr int kVTile = D * kBN * 4;  // bytes of V^T_hi or V^T_lo
  static constexpr int kStage = kKTiles * kKTile + 2 * kVTile;
  // as many stages as fit beside q, the barriers and the 1024-byte alignment
  // in the 227 KB a block may take, at most 4
  static constexpr int kFit = (232448 - 2048 - kQTile) / kStage;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static_assert(kStages >= 2, "two ring stages must fit");
};

template <int D, bool kQK8>
struct Smem {
  using P = Plan<D, kQK8>;
  uint8_t q[P::kQTile];
  uint8_t k[P::kStages][P::kKTiles][P::kKTile];  // K_hi, K_lo (or the k codes)
  uint8_t v[P::kStages][2][P::kVTile];           // V^T_hi, V^T_lo
  Ring<P::kStages> ring;
  uint64_t q_full;
};

struct Params {
  const float* q_lo;   // [BH, sq, D] (f32 q/k)
  float* out;          // [BH, sq, D]
  float* l;            // kFixed: [BH, sq] (unnormalized) or null
  const float* shift;  // kFixed: [G]
  const float* scale;  // kFixed, int8 q/k: [G]
  int sq, kv_len, hper;
};

// d = P_hi V_hi + P_hi V_lo + P_lo V_hi over the kBN / 8 k steps of one
// tile, output columns kCol .. kCol + N - 1 (V^T rows, 128 bytes each in a
// panel of D rows), issued into fresh registers and committed, not waited for
template <int D, int N, int kCol, int kBN>
__device__ __forceinline__ void pv(float (&d)[N / 2], const uint32_t (&phi)[kBN / 8][4],
                                   const uint32_t (&plo)[kBN / 8][4], uint64_t vhi,
                                   uint64_t vlo) {
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBN / 8; ++kk) {
    const uint32_t off = (kk / 4) * D * 128 + kCol * 128 + 32 * (kk % 4);
    wgmma_rs_tf32<N>(d, phi[kk], desc_add(vhi, off), kk > 0);
    wgmma_rs_tf32<N>(d, phi[kk], desc_add(vlo, off), 1);
    wgmma_rs_tf32<N>(d, plo[kk], desc_add(vhi, off), 1);
  }
  wgmma_commit();
}

// o = alpha o + ot on output columns kCol .. kCol + N - 1, alpha0 for rows
// row (elements 0, 1 of each group of 4), alpha1 for rows row + 8: one
// tile's P V taken in on the FMA units
template <int D, int N, int kCol>
__device__ __forceinline__ void fold(float (&o)[D / 2], const float (&ot)[N / 2], float alpha0,
                                     float alpha1) {
  constexpr int o0 = kCol / 2;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    o[o0 + 4 * j] = __fmaf_rn(o[o0 + 4 * j], alpha0, ot[4 * j]);
    o[o0 + 4 * j + 1] = __fmaf_rn(o[o0 + 4 * j + 1], alpha0, ot[4 * j + 1]);
    o[o0 + 4 * j + 2] = __fmaf_rn(o[o0 + 4 * j + 2], alpha1, ot[4 * j + 2]);
    o[o0 + 4 * j + 3] = __fmaf_rn(o[o0 + 4 * j + 3], alpha1, ot[4 * j + 3]);
  }
}

template <int D, bool kQK8, int kMode>
__global__ void __launch_bounds__(Plan<D, kQK8>::kThreads, 1)
cell_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap khi_map,
            const __grid_constant__ CUtensorMap klo_map,
            const __grid_constant__ CUtensorMap vhi_map,
            const __grid_constant__ CUtensorMap vlo_map, const Params prm) {
  static_assert(!(kQK8 && kMode == kOnline), "K4 takes f32 q/k");
  using P = Plan<D, kQK8>;
  using Acc = std::conditional_t<kQK8, int, float>;  // S: s32 or f32 sums
  constexpr int kBM = P::kBM, kBN = P::kBN, kRow = P::kRow, kPV = P::kPV;
  constexpr int kLast = (P::kHalves - 1) * kPV;  // the first column of the half in flight
  extern __shared__ uint8_t smem_raw[];
  Smem<D, kQK8>& sm = *reinterpret_cast<Smem<D, kQK8>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int q0 = blockIdx.x * kBM, bh = blockIdx.y;
  const int n_tiles = (prm.kv_len + kBN - 1) / kBN;  // later tiles change nothing

  if (threadIdx.x == 0) {
    sm.ring.init(P::kConsumers);
    mbar_init(&sm.q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= P::kConsumers) {
    // ---- producer: one thread issues every TMA load ----
    setmaxnreg_dec<P::kProducerRegs>();
    if (threadIdx.x == P::kConsumers) {
      constexpr int kRowEls = kRow / P::kEl;  // q / k elements a panel row
      mbar_expect_tx(&sm.q_full, P::kQTile);
      for (int p = 0; p < P::kPanels; ++p)
        tma_load_3d(sm.q + p * kBM * kRow, &qmap, &sm.q_full, p * kRowEls, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = sm.ring.acquire(t, P::kStage);
        for (int h = 0; h < P::kKTiles; ++h)
          for (int p = 0; p < P::kPanels; ++p)
            tma_load_3d(sm.k[s][h] + p * kBN * kRow, h ? &klo_map : &khi_map, &sm.ring.full[s],
                        p * kRowEls, t * kBN, bh);
        for (int h = 0; h < 2; ++h)
          for (int p = 0; p < P::kVPanels; ++p)
            tma_load_3d(sm.v[s][h] + p * D * 128, h ? &vlo_map : &vhi_map, &sm.ring.full[s],
                        t * kBN + 32 * p, 0, bh);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns q rows q0 + 64 wg .. + 63 ----
  setmaxnreg_inc<P::kConsumerRegs>();
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int lane = tid % 32, warp = t / 32;
  const int c = lane % 4;
  const int row = q0 + wg * 64 + warp * 16 + lane / 4;  // and row + 8
  const int g = bh / prm.hper;
  const float shift = kMode == kFixed ? prm.shift[g] : 0.0f;
  const float sc = kQK8 ? prm.scale[g] : 1.0f;

  // Q_lo as the A fragments of Q_lo K_hi^T: k step st holds columns 8 st + c
  // and 8 st + c + 4 of rows row and row + 8 (rows past sq: zeros)
  uint32_t qlo[kQK8 ? 1 : D / 8][4];
  if constexpr (!kQK8) {
    const float* q_lo = prm.q_lo + (int64_t)bh * prm.sq * D;
#pragma unroll
    for (int st = 0; st < D / 8; ++st)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row + 8 * (e % 2), col = 8 * st + c + 4 * (e / 2);
        qlo[st][e] = r < prm.sq ? __float_as_uint(__ldg(q_lo + (int64_t)r * D + col)) : 0u;
      }
  }
  constexpr Swizzle swz = desc_swizzle(kRow);
  const uint64_t qdesc = make_desc(sm.q + wg * 64 * kRow, 16, 8 * kRow, swz);  // panel 0
  mbar_wait(&sm.q_full, 0);

  float o[D / 2];  // the output, summed on the FMA units
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  // the P V of the tile in flight (its last half), on the tensor core, and
  // the alpha of that tile, with which o takes it in: o = alpha o + ot
  float ot[kPV / 2];
  float fold0 = 1.0f, fold1 = 1.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;  // rows row, row + 8
  // P_hi and P_lo as the A fragments of P V. Tile it's P V stays in flight
  // while tile it + 1's Q K^T is issued; one wait covers both.
  uint32_t phi[kBN / 8][4], plo[kBN / 8][4];

  for (int it = 0; it < n_tiles; ++it) {
    const int s = sm.ring.wait_full(it);
    const int kv0 = it * kBN;

    // ---- S = Q K^T, k step st at byte 32 st of the row, in panel 32 st / kRow
    Acc acc[kBN / 2];
    const uint64_t khi = make_desc(sm.k[s][0], 16, 8 * kRow, swz);
    wgmma_fence();
    if constexpr (kQK8) {
#pragma unroll
      for (int st = 0; st < P::kSteps; ++st) {
        const int panel = 32 * st / kRow, col = 32 * st % kRow;
        wgmma_ss_s8<kBN>(acc, desc_add(qdesc, panel * kBM * kRow + col),
                         desc_add(khi, panel * kBN * kRow + col), st > 0);
      }
    } else {
      const uint64_t klo = make_desc(sm.k[s][1], 16, 8 * kRow, swz);
#pragma unroll
      for (int st = 0; st < P::kSteps; ++st) {
        const int panel = 32 * st / kRow, col = 32 * st % kRow;
        const uint32_t qa = panel * kBM * kRow + col, kb = panel * kBN * kRow + col;
        wgmma_ss_tf32<kBN>(acc, desc_add(qdesc, qa), desc_add(khi, kb), st > 0);
        wgmma_ss_tf32<kBN>(acc, desc_add(qdesc, qa), desc_add(klo, kb), 1);
        wgmma_rs_tf32<kBN>(acc, qlo[st], desc_add(khi, kb), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(o);
    fence_regs(phi);
    fence_regs(plo);
    if constexpr (!kQK8) fence_regs(qlo);
    if (it > 0) sm.ring.release(it - 1);  // its P V has completed
    fence_regs(ot);
    if (it > 0) fold<D, kPV, kLast>(o, ot, fold0, fold1);

    // ---- the scores, their shift (the running max, or the group's) ----
    float sv[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      if constexpr (kQK8)
        sv[i] = __fmul_rn(exact_f32(acc[i]), sc);
      else
        sv[i] = acc[i];
    }
    const bool tail = kv0 + kBN > prm.kv_len;
    float sub0 = shift, sub1 = shift, alpha0 = 1.0f, alpha1 = 1.0f;
    if constexpr (kMode == kOnline) {
      if (tail) {
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i)
          if (kv0 + 8 * (i / 4) + 2 * c + (i % 2) >= prm.kv_len) sv[i] = kNegInf;
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sv[4 * j], sv[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sv[4 * j + 2], sv[4 * j + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
      sub0 = fmaxf(m0, mx0);
      sub1 = fmaxf(m1, mx1);
      alpha0 = exp2f(__fsub_rn(m0, sub0));  // 0 on the first tile
      alpha1 = exp2f(__fsub_rn(m1, sub1));
      m0 = sub0;
      m1 = sub1;
    }

    // ---- p, its row sums, and P_hi / P_lo as the A fragments of k step j:
    // (row, c), (row + 8, c), (row, c + 4), (row + 8, c + 4) are the
    // accumulator's elements 0, 2, 1, 3 (V^T's kv order) ----
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(__fsub_rn(sv[4 * j + e], e < 2 ? sub0 : sub1));
        if (kMode == kFixed && tail && kv0 + 8 * j + 2 * c + (e % 2) >= prm.kv_len) p[e] = 0.0f;
      }
      sum0 = __fadd_rn(__fadd_rn(sum0, p[0]), p[1]);
      sum1 = __fadd_rn(__fadd_rn(sum1, p[2]), p[3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = p[e == 1 ? 2 : e == 2 ? 1 : e];
        const float hi = tf32_rna(x);
        phi[j][e] = __float_as_uint(hi);
        plo[j][e] = __float_as_uint(tf32_rna(__fsub_rn(x, hi)));
      }
    }
    l0 = __fadd_rn(__fmul_rn(alpha0, l0), sum0);
    l1 = __fadd_rn(__fmul_rn(alpha1, l1), sum1);

    // ---- P V: k step kk is kv 8 kk .. + 7, 32 bytes into panel kk / 4;
    // into fresh registers, which o takes in with this tile's alpha: the
    // first half (kHalves 2) at once, the last at the next fold
    const uint64_t vhi = make_desc(sm.v[s][0], 16, 8 * 128, kSw128);
    const uint64_t vlo = make_desc(sm.v[s][1], 16, 8 * 128, kSw128);
    fold0 = alpha0;
    fold1 = alpha1;
    if constexpr (kLast > 0) {
      pv<D, kPV, 0, kBN>(ot, phi, plo, vhi, vlo);
      wgmma_wait<0>();
      fence_regs(ot);
      fence_regs(phi);
      fence_regs(plo);
      fold<D, kPV, 0>(o, ot, alpha0, alpha1);
    }
    pv<D, kPV, kLast, kBN>(ot, phi, plo, vhi, vlo);
  }
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(phi);
  fence_regs(plo);
  fence_regs(ot);
  if (n_tiles > 0) fold<D, kPV, kLast>(o, ot, fold0, fold1);

  l0 = __fadd_rn(l0, __shfl_xor_sync(kFull, l0, 1));
  l0 = __fadd_rn(l0, __shfl_xor_sync(kFull, l0, 2));
  l1 = __fadd_rn(l1, __shfl_xor_sync(kFull, l1, 1));
  l1 = __fadd_rn(l1, __shfl_xor_sync(kFull, l1, 2));
  float inv0 = 1.0f, inv1 = 1.0f;
  if (kMode == kFixed && prm.l != nullptr) {  // unnormalized: the raw numerator and l
    if (c == 0) {
      if (row < prm.sq) prm.l[(int64_t)bh * prm.sq + row] = l0;
      if (row + 8 < prm.sq) prm.l[(int64_t)bh * prm.sq + row + 8] = l1;
    }
  } else {
    inv0 = l0 <= 0.0f ? 1.0f : __fdiv_rn(1.0f, l0);
    inv1 = l1 <= 0.0f ? 1.0f : __fdiv_rn(1.0f, l1);
  }
  float* obase = prm.out + (int64_t)bh * prm.sq * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * c;
    if (row < prm.sq)
      *reinterpret_cast<float2*>(obase + (int64_t)row * D + col) =
          make_float2(__fmul_rn(o[4 * j], inv0), __fmul_rn(o[4 * j + 1], inv0));
    if (row + 8 < prm.sq)
      *reinterpret_cast<float2*>(obase + (int64_t)(row + 8) * D + col) =
          make_float2(__fmul_rn(o[4 * j + 2], inv1), __fmul_rn(o[4 * j + 3], inv1));
  }
}

// One launch of an instance on q_hi [BH, sq, D] and k_hi, k_lo [BH, skv, D]
// (f32, or the int8 codes in q_hi and k_hi), vt_hi and vt_lo [BH, D, skv8]
// f32 (skv8: skv rounded up to 8), all contiguous and 16-byte aligned; grid
// (q tiles, BH). Returns a cudaError_t: cudaErrorInvalidValue where
// cuTensorMapEncodeTiled refuses a map.
template <int D, bool kQK8, int kMode>
int launch(const void* q_hi, const void* k_hi, const void* k_lo, const void* vt_hi,
           const void* vt_lo, int BH, int skv, Params prm, cudaStream_t stream) {
  using P = Plan<D, kQK8>;
  const CUtensorMapDataType qk_type =
      kQK8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  constexpr int el = P::kEl, box = P::kRow / P::kEl;
  const int skv8 = (skv + 7) / 8 * 8;
  CUtensorMap qmap, khi_map, klo_map, vhi_map, vlo_map;
  if (!make_map_3d(&qmap, q_hi, qk_type, el, D, prm.sq, BH, box, P::kBM,
                   map_swizzle(P::kRow)) ||
      !make_map_3d(&khi_map, k_hi, qk_type, el, D, skv, BH, box, P::kBN,
                   map_swizzle(P::kRow)) ||
      !make_map_3d(&klo_map, kQK8 ? k_hi : k_lo, qk_type, el, D, skv, BH, box, P::kBN,
                   map_swizzle(P::kRow)) ||
      !make_map_3d(&vhi_map, vt_hi, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, skv8, D, BH, 32, D,
                   CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_3d(&vlo_map, vt_lo, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, skv8, D, BH, 32, D,
                   CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  // + 1024 so the tiles can start on a 1024-byte boundary
  constexpr int kSmem = sizeof(Smem<D, kQK8>) + 1024;
  auto kernel = cell_kernel<D, kQK8, kMode>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((prm.sq + P::kBM - 1) / P::kBM, BH);
  kernel<<<grid, P::kThreads, kSmem, stream>>>(qmap, khi_map, klo_map, vhi_map, vlo_map, prm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tf32x3_cell
}  // namespace
