// The fixed-shift attention cell on wgmma with TMA, written by hand for
// Hopper (sm_90a): one kernel template over the head dim D and two
// compile-time switches, shared by K2 (flash_prepacked.cu) and K3
// (flash_fixed_max.cu), both at D 16 to 128 in steps of 16. A head dim
// between two of them runs the next one up: its wrappers hand the cell q, k
// and v with `cols` real columns (TMA fills the columns past them with
// zeros, which change no score and no sum) and take the first `cols`
// columns of the output.
//
// Replaces the body of two Pallas TPU kernels of
// aether_tpu/ops/flash_attention.py that compute one function:
// _flash_kernel_prepacked (K2, flash_attention_prepacked) and
// _flash_kernel_fixed_max (K3, flash_attention(fixed_max=True)).
// Non-causal, bf16 v and output, in the log2 domain, for head group g =
// bh / hper:
//   s   = f32(int32(q8 . k8^T)) * scale            (kQK8: int8 q and k)
//   s   = f32(q . k^T), q carrying the fold         (!kQK8: bf16 q and k)
//   p   = exp2(s - shift_g), 0 at columns >= kv_len
//   out = sum bf16(p) v / sum bf16(p)               (denominator <= 0 -> 1)
//   unnormalized (l != null): out = bf16(sum bf16(p) v), l = sum bf16(p) in f32
//   (both sums accumulated in f32 on the tensor core)
// The switches:
//   kQK8        q and k are int8 (D bytes a row, K6's layout); otherwise
//               bf16 (2 D bytes). v is bf16;
//   kTileScale  K2: the int8 scale is per (q tile, kv tile) of `block`
//               tokens, qsc[g, row / block] * ksc[g, col / block], and the
//               shift is max_t qn[g, t] * max_t kn[g, t], taken here by the
//               producer warp (0 when noshift holds, or when it is auto and
//               every group's bound is below 96). `block` is a multiple of
//               128, so a 64-row warpgroup (at kBM 128 and 192 alike) and a
//               128-column kv tile each lie in one block. K3: one scale and
//               one shift per group, from its wrapper (the JAX wrapper's
//               preparation).
//
// What bounds it on an H100 (the attention at its main-path shapes, 15076
// valid tokens, 48 heads; bound = the largest of bytes / 3.35 TB/s,
// operations / the peak of their type and one exp2 a score / the SFU's 16
// a clock an SM at 1980 MHz), at D 64: K2 int8 2.61 ms (SFU) and float
// 2.82 ms (operations) at batch 1; K3 int8 5.22 ms (SFU) and bf16 5.65 ms
// (operations) at the CFG pair's batch 2; at batch 1 and D 112 the
// operations bind, 3.71 ms (int8 QK^T) and 4.94 (bf16), the SFU's 2.61 below
// D 80. The tensor cores and the SFU have to run side by side, and every
// score's other instructions share the SFU's issue slots. The design is K4
// bf16's (online_cell.cuh, FlashAttention-3's shape) without the online
// max:
//   * a CTA takes 64 x kWG q rows: kWG consumer warpgroups of 64 rows and
//     one producer warp that keeps K and V tiles of 128 kv rows in a ring of
//     kStages shared-memory slots by TMA (mbarriers); rows past the tensors'
//     ends arrive as zeros, so no wrapper pads, and stores past sq are
//     dropped;
//   * the plan of each D (Plan below): kWG 3 up to D 64; above it a
//     consumer thread holds 64 of S, D / 2 f32 of the output, 32 packed
//     bf16(p) and 4 row sums, 156 registers at D 112 before addresses.
//     Registers are shared out by SM sub-partition, a quarter of the warps
//     on each, so 13 warps leave a thread 128 and 9 leave it 168: kWG is 2
//     above D 64 (ptxas -v, as time_hd_cells.py prints it: 105-127
//     registers at D 16-64, 147-166 at 80-112, no spill). At D 128 (the
//     head dims 113-127 of the JAX kernels, run here padded) a thread holds
//     164 before addresses, more than 168 leave room for: there the
//     producer is a whole warpgroup that gives its registers to the
//     consumers (setmaxnreg: 24 for it, 240 a consumer thread), as
//     online_cell.cuh does above D 64. q and k
//     rows are D bytes (int8) or 2 D (bf16) rounded up to a swizzle row (32,
//     64 or 128 bytes; TMA fills the columns past D with zeros), in 128-byte
//     panels above 128 (bf16 at D 80-112: two panels). V is MN-major in
//     panels of the widest swizzle row whose columns divide D (64 columns at
//     D 64, 32 at 32 and 96, 16 at 16, 48, 80 and 112), so no wgmma reads a
//     panel in part. kStages is 4 where 4 fit in shared memory, else 3 (bf16
//     QK^T at D 80-112: q 32 KB + 3 x (32 KB K + 20-28 KB V) of 227 KB).
//     Every K and V tile is read by each q tile of its head from L2: at D
//     112 and 128-row CTAs that is 38 GB a call at 48 heads x 15076 tokens,
//     about the products' time at L2's rate;
//   * S = Q K^T is ceil(D * bytes / 32) k steps of wgmma m64n128k32 s8 (kQK8)
//     or m64n128k16 bf16 from shared memory; bf16(p) stays in registers as
//     the A operand of P V (wgmma m64nDk16, V through the transpose bit); a
//     tile's P V stays in flight while the next tile's Q K^T is issued;
//   * the shift is fixed, so there is no row max, no shuffle and no rescale
//     of the output: each tile's p is final when it is made;
//   * the SFU is left to exp2 alone: int8 scores move to f32 on the FMA and
//     integer units (exact_f32, the 1.5 * 2^23 trick of K6; I2F runs on the
//     conversion unit at the SFU's rate), and p is one ex2.approx (exp2_ftz:
//     a p below 2^-126 counts as 0, which bf16(p) . v cannot see);
//   * l = sum bf16(p) runs on the tensor core beside P V, a wgmma m64n8k16
//     of the same bf16(p) fragments against a tile of ones, so a score costs
//     no unpack and add; K2's int8 scale is read once a kv tile, its
//     quantization block counted on without a division: the issue slots
//     bind before the SFU does (scripts/time_fixed_cell.py on an NVIDIA H100
//     80GB HBM3 at 700 W: K2 int8 6.59-6.71 -> 6.07-6.16 ms, float
//     6.72-6.81 -> 6.02-6.10; rounding p to bf16 with integer adds instead
//     of the conversion instruction read 6.98-7.14, slower);
//   * only the tile that crosses kv_len is masked (p = 0, not a large
//     negative score: there is no max to protect), and tiles wholly past it
//     add nothing and are skipped.
// The scale and the shift are applied unfused, f32(s) * scale then - shift,
// as the plain versions round them. Built without --use_fast_math so the
// division stays accurate.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

// internal linkage: each source that includes the cell builds its own
// instances, as a kernel in one source would be
namespace {
namespace fixed_cell {

using namespace hopper;

constexpr int kBN = 128;                    // kv rows per tile
constexpr float kNoShiftBelow = 96.0f;      // auto noshift: every bound below this
constexpr unsigned kFull = 0xffffffffu;

enum NoShift { kKeep = 0, kDrop = 1, kAuto = 2 };

// The tile plan of head dim D (the note above). At D 64 it is the plan the
// cell had before it took other head dims.
template <int D, bool kQK8>
struct Plan {
  static_assert(D % 16 == 0 && D >= 16 && D <= 128, "head_dim: 16 to 128 in steps of 16");
  static constexpr int kEl = kQK8 ? 1 : 2;          // bytes of a q or k element
  static constexpr int kWG = D <= 64 ? 3 : 2;       // consumer warpgroups, 64 q rows each
  static constexpr int kBM = 64 * kWG;              // q rows per CTA
  static constexpr int kConsumers = 128 * kWG;
  // the producer: a warp, or at D 128 a warpgroup that hands its registers on
  static constexpr bool kProducerWG = D == 128;
  static constexpr int kThreads = kConsumers + (kProducerWG ? 128 : 32);
  static constexpr int kProducerRegs = 24, kConsumerRegs = 240;
  static_assert(!kProducerWG || 128 * kProducerRegs + kConsumers * kConsumerRegs <=
                                    kThreads * ((65536 / kThreads) & ~7),
                "setmaxnreg asks for more registers than the CTA starts with");
  // q and k (K-major): panels of kRow-byte rows, k steps of 32 bytes
  static constexpr int kRow = swizzle_row(D * kEl);
  static constexpr int kPanels = (D * kEl + 127) / 128;
  static constexpr int kSteps = (D * kEl + 31) / 32;
  // v (MN-major): panels of kVCols columns, kVRow bytes a row
  static constexpr int kVCols = D % 64 == 0 ? 64 : D % 32 == 0 ? 32 : 16;
  static constexpr int kVRow = 2 * kVCols;
  static constexpr int kVPanels = D / kVCols;
  static constexpr int kQTile = kBM * kRow * kPanels;  // bytes
  static constexpr int kKTile = kBN * kRow * kPanels;
  static constexpr int kVTile = kBN * 2 * D;
  // 4 stages where they fit beside q, the ones, the barriers and the
  // 1024-byte alignment, in the 227 KB a block may take; else 3
  static constexpr int kStages =
      kQTile + 4 * (kKTile + kVTile) + 3 * 1024 <= 232448 ? 4 : 3;
};

template <int D, bool kQK8>
struct Smem {
  using P = Plan<D, kQK8>;
  uint8_t q[P::kQTile];
  uint8_t k[P::kStages][P::kKTile];
  uint8_t v[P::kStages][P::kVTile];  // bf16
  uint32_t ones[256];  // bf16 1.0 pairs: the B operand of the row sums
  Ring<P::kStages> ring;
  uint64_t q_full;
  float shift;  // kTileScale: the head group's shift, made by the producer warp
};

struct Params {
  __nv_bfloat16* out;  // [BH, sq, D]
  float* l;            // [BH, sq]: unnormalized; null: normalized
  int sq, kv_len, hper;
  // !kTileScale (K3): [G] the shift and the int8 scores' scale
  const float* shift;
  const float* scale;
  // kTileScale (K2): [G, n_blocks] scales (qsc carries the fold) and norm
  // maxima of `block`-token tiles; noshift one of NoShift
  const float* qsc;
  const float* ksc;
  const float* qn;
  const float* kn;
  int block, n_blocks, noshift;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// K2's bound of head group g, max_t qn[g, t] * max_t kn[g, t], by one thread
__device__ __forceinline__ float group_bound(const Params& p, int g) {
  const float* qn = p.qn + g * p.n_blocks;
  const float* kn = p.kn + g * p.n_blocks;
  float mq = qn[0], mk = kn[0];
#pragma unroll 4
  for (int t = 1; t < p.n_blocks; ++t) {
    mq = fmaxf(mq, qn[t]);
    mk = fmaxf(mk, kn[t]);
  }
  return __fmul_rn(mq, mk);
}

// K2's shift of head group g, by one warp: the bound, or 0 when noshift
// drops it (kAuto: when every one of the `groups` bounds is below 96)
__device__ float tile_shift(const Params& p, int g, int groups, int lane) {
  if (p.noshift == kDrop) return 0.0f;
  const float bound = group_bound(p, g);
  if (p.noshift == kKeep) return bound;
  float top = -INFINITY;
  for (int h = lane; h < groups; h += 32) top = fmaxf(top, group_bound(p, h));
#pragma unroll
  for (int o = 16; o > 0; o /= 2) top = fmaxf(top, __shfl_xor_sync(kFull, top, o));
  return top < kNoShiftBelow ? 0.0f : bound;
}

// S = Q K^T of one tile into this thread's accumulator fragment, completed
// (the wait also covers the previous tile's P V): kSteps k steps of 32 bytes
// (32 int8 or 16 bf16), step st at byte 32 st of the row, in panel 32 st /
// kRow.
template <int D, bool kQK8, typename Acc>
__device__ __forceinline__ void qk(Acc (&acc)[64], const uint8_t* qs, const uint8_t* ks) {
  using P = Plan<D, kQK8>;
  constexpr Swizzle swz = desc_swizzle(P::kRow);
  const uint64_t qd = make_desc(qs, 16, 8 * P::kRow, swz), kd = make_desc(ks, 16, 8 * P::kRow, swz);
  wgmma_fence();
#pragma unroll
  for (int st = 0; st < P::kSteps; ++st) {
    const int panel = 32 * st / P::kRow, col = 32 * st % P::kRow;
    const uint64_t a = desc_add(qd, panel * P::kBM * P::kRow + col);
    const uint64_t b = desc_add(kd, panel * kBN * P::kRow + col);
    if constexpr (kQK8)
      wgmma_m64n128k32_ss_s8(acc, a, b, st > 0);
    else
      wgmma_m64n128k16_ss_bf16(acc, a, b, st > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

__device__ __forceinline__ float score(int x, float sc) { return __fmul_rn(exact_f32(x), sc); }
__device__ __forceinline__ float score(float x, float) { return x; }

// bf16(p) of one tile packed as the A fragments of P V (k step kk takes
// accumulator chunks 2kk and 2kk + 1: rows r and r + 8, columns 8j + 2c,
// + 1). kTail: columns at or past kv_len get p = 0.
template <bool kTail, typename Acc>
__device__ __forceinline__ void p_tile(uint32_t (&pa)[kBN / 16][4], const Acc (&acc)[64],
                                       float sc, float shift, int kv0, int kv_len, int c) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      p[e] = exp2_ftz(__fsub_rn(score(acc[4 * j + e], sc), shift));
      if (kTail && kv0 + 8 * j + 2 * c + (e % 2) >= kv_len) p[e] = 0.0f;
    }
    pa[j / 2][(j % 2) * 2] = pack_bf16(p[0], p[1]);
    pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
  }
}

// D[64 x 8] += A[64 x 16] B[16 x 8], A (bf16(p)) from registers, B K-major
// from shared memory. With B all ones every column of D is the running sum
// of A's rows: l on the tensor core, in f32, and no unpack and add a score.
__device__ __forceinline__ void wgmma_m64n8k16_rs_bf16(float (&d)[4], const uint32_t (&a)[4],
                                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

template <int D, bool kQK8, bool kTileScale>
__global__ void __launch_bounds__(Plan<D, kQK8>::kThreads, 1)
cell_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap, const Params prm) {
  using Acc = std::conditional_t<kQK8, int, float>;  // S: s32 or f32 sums
  using P = Plan<D, kQK8>;
  constexpr int kBM = P::kBM, kConsumers = P::kConsumers;
  extern __shared__ uint8_t smem_raw[];
  Smem<D, kQK8>& sm = *reinterpret_cast<Smem<D, kQK8>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int q0 = blockIdx.x * kBM, bh = blockIdx.y, g = bh / prm.hper;
  const int n_tiles = (prm.kv_len + kBN - 1) / kBN;  // later tiles add nothing

  if (threadIdx.x == 0) {
    sm.ring.init(kConsumers);
    mbar_init(&sm.q_full, 1);
    mbar_init_fence();
  }
  if (threadIdx.x < 256) {
    sm.ones[threadIdx.x] = 0x3F803F80u;
    fence_proxy_async();
  }
  // the shift by the producer's first warp
  if (kTileScale && threadIdx.x >= kConsumers && (!P::kProducerWG || threadIdx.x < kConsumers + 32)) {
    const float s = tile_shift(prm, g, gridDim.y / prm.hper, threadIdx.x % 32);
    if (threadIdx.x == kConsumers) sm.shift = s;
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer: one thread issues every TMA load ----
    if constexpr (P::kProducerWG) setmaxnreg_dec<P::kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      constexpr int kRowEls = P::kRow / P::kEl;  // q / k elements a panel row
      mbar_expect_tx(&sm.q_full, P::kQTile);
      for (int p = 0; p < P::kPanels; ++p)
        tma_load_3d(sm.q + p * kBM * P::kRow, &qmap, &sm.q_full, p * kRowEls, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = sm.ring.acquire(t, P::kKTile + P::kVTile);
        for (int p = 0; p < P::kPanels; ++p)
          tma_load_3d(sm.k[s] + p * kBN * P::kRow, &kmap, &sm.ring.full[s], p * kRowEls,
                      t * kBN, bh);
        for (int p = 0; p < P::kVPanels; ++p)
          tma_load_3d(sm.v[s] + p * kBN * P::kVRow, &vmap, &sm.ring.full[s], p * P::kVCols,
                      t * kBN, bh);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns q rows q0 + 64 wg .. + 63 ----
  if constexpr (P::kProducerWG) setmaxnreg_inc<P::kConsumerRegs>();
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int lane = tid % 32, warp = t / 32;
  const int c = lane % 4;
  float shift, qs = 1.0f;  // qs: the int8 scale's q factor (K3: the whole scale)
  if (kTileScale) {
    shift = sm.shift;
    // a 64-row warpgroup lies in one quantization block (block % 128 == 0);
    // one wholly past sq reads the last block's scale and stores nothing
    if (kQK8)
      qs = prm.qsc[g * prm.n_blocks + min((q0 + 64 * wg) / prm.block, prm.n_blocks - 1)];
  } else {
    shift = prm.shift[g];
    if (kQK8) qs = prm.scale[g];
  }
  const uint8_t* qtile = sm.q + wg * 64 * P::kRow;  // in panel 0
  mbar_wait(&sm.q_full, 0);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  // the row sums of bf16(p): rows r (lsum[0]) and r + 8 (lsum[2]), each in
  // two columns. A K-major B of 8 rows without swizzle: every address the
  // descriptor reaches holds ones, so one descriptor serves every k step.
  float lsum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const uint64_t ones_desc = make_desc(sm.ones, 128, 256, Swizzle(0));
  // bf16(p) as the A fragments of P V. Tile it's P V stays in flight while
  // tile it + 1's Q K^T is issued; the wait in qk covers both.
  uint32_t pa[kBN / 16][4];
  // K2: the quantization block of kv tile it, kb, counted on without a
  // division (a 128-column kv tile lies in one block)
  const int tiles_per_block = kTileScale ? prm.block / kBN : 1;
  int kb = 0, kb_end = tiles_per_block;

  for (int it = 0; it < n_tiles; ++it) {
    const int s = sm.ring.wait_full(it);
    const int kv0 = it * kBN;
    if (it == kb_end) {
      ++kb;
      kb_end += tiles_per_block;
    }
    const float sc = kQK8 && kTileScale ? __fmul_rn(qs, prm.ksc[g * prm.n_blocks + kb]) : qs;
    Acc acc[64];
    qk<D, kQK8>(acc, qtile, sm.k[s]);
    fence_regs(o);
    fence_regs(lsum);
    fence_regs(pa);
    if (it > 0) sm.ring.release(it - 1);  // its P V has completed

    if (kv0 + kBN > prm.kv_len)
      p_tile<true>(pa, acc, sc, shift, kv0, prm.kv_len, c);
    else
      p_tile<false>(pa, acc, sc, shift, kv0, prm.kv_len, c);

    // MN-major: LBO the panel stride, SBO 8 rows, a k step 16 rows
    const uint64_t vdesc =
        make_desc(sm.v[s], kBN * P::kVRow, 8 * P::kVRow, desc_swizzle(P::kVRow));
    fence_regs(o);
    fence_regs(lsum);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      wgmma_rs_bf16_vt<D>(o, pa[kk], desc_add(vdesc, 16 * P::kVRow * kk), 1);
      wgmma_m64n8k16_rs_bf16(lsum, pa[kk], ones_desc);
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(lsum);
  fence_regs(pa);

  const float l0 = lsum[0], l1 = lsum[2];
  const int row = q0 + wg * 64 + warp * 16 + lane / 4;
  float inv0 = 1.0f, inv1 = 1.0f;
  if (prm.l != nullptr) {  // unnormalized: the raw numerator and l
    if (c == 0) {
      if (row < prm.sq) prm.l[(int64_t)bh * prm.sq + row] = l0;
      if (row + 8 < prm.sq) prm.l[(int64_t)bh * prm.sq + row + 8] = l1;
    }
  } else {
    inv0 = l0 <= 0.0f ? 1.0f : __fdiv_rn(1.0f, l0);
    inv1 = l1 <= 0.0f ? 1.0f : __fdiv_rn(1.0f, l1);
  }
  __nv_bfloat16* obase = prm.out + (int64_t)bh * prm.sq * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * c;
    if (row < prm.sq)
      *reinterpret_cast<uint32_t*>(obase + (int64_t)row * D + col) =
          pack_bf16(__fmul_rn(o[4 * j], inv0), __fmul_rn(o[4 * j + 1], inv0));
    if (row + 8 < prm.sq)
      *reinterpret_cast<uint32_t*>(obase + (int64_t)(row + 8) * D + col) =
          pack_bf16(__fmul_rn(o[4 * j + 2], inv1), __fmul_rn(o[4 * j + 3], inv1));
  }
}

// One launch of an instance on q [BH, sq, cols], k and v [BH, skv, cols] (q
// and k int8 or bf16 by kQK8, v bf16; rows `ld` elements apart, 0 < cols <=
// D <= ld, starts and row strides 16-byte aligned: at cols = ld = D
// contiguous), the output [BH, sq, D]; grid (q tiles, BH). The maps read
// `cols` columns and TMA fills the rest of each row's D with zeros. Returns a
// cudaError_t: cudaErrorInvalidValue where cuTensorMapEncodeTiled refuses a
// map.
template <int D, bool kQK8, bool kTileScale>
int launch(const void* q, const void* k, const void* v, int BH, int skv, int cols, int ld,
           Params prm, cudaStream_t stream) {
  using P = Plan<D, kQK8>;
  if (cols <= 0 || cols > D || ld < cols) return static_cast<int>(cudaErrorInvalidValue);
  const CUtensorMapDataType qk_type =
      kQK8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr int el = P::kEl, box = P::kRow / P::kEl;
  const uint64_t row = ld, q_head = (uint64_t)prm.sq * ld, kv_head = (uint64_t)skv * ld;
  CUtensorMap qmap, kmap, vmap;
  if (!make_map_3d_strided(&qmap, q, qk_type, cols, prm.sq, BH, row * el, q_head * el, box,
                           P::kBM, map_swizzle(P::kRow)) ||
      !make_map_3d_strided(&kmap, k, qk_type, cols, skv, BH, row * el, kv_head * el, box, kBN,
                           map_swizzle(P::kRow)) ||
      !make_map_3d_strided(&vmap, v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, cols, skv, BH, row * 2,
                           kv_head * 2, P::kVCols, kBN, map_swizzle(P::kVRow)))
    return static_cast<int>(cudaErrorInvalidValue);
  // + 1024 so the tiles can start on a 1024-byte boundary
  constexpr int kSmem = sizeof(Smem<D, kQK8>) + 1024;
  auto kernel = cell_kernel<D, kQK8, kTileScale>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((prm.sq + P::kBM - 1) / P::kBM, BH);
  kernel<<<grid, P::kThreads, kSmem, stream>>>(qmap, kmap, vmap, prm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fixed_cell
}  // namespace
