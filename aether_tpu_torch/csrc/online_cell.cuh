// The online-softmax attention cell on wgmma with TMA, written by hand for
// Hopper (sm_90a): one kernel template over the head dim D and compile-time
// switches, shared by K4 in bf16 (flash_online_bf16.cu, D 16 to 128 in
// steps of 16 and 160 to 256 in steps of 32) and the tuning variants K7-K9
// (flash_variants.cu, D 64).
// Non-causal, bf16 q/k/v and output:
//   q   = bf16(q * qscale)                      (here, in shared memory)
//   s   = q . k^T                               (f32 sums of bf16 products)
//   s   = -0.7 * f32max  where column >= kv_end (every tile, or only the tile
//                                                that crosses kv_end)
//   m'  = max(m, rowmax s),  alpha = e(m - m'),  p = e(s - m')
//   acc = alpha * acc + bf16(p) . v
//   l   = alpha * l + sum bf16(p)   (round_l)  or  + sum p  (!round_l)
//   l  -= pad * e(-m)                           (padfix)
//   out = bf16(acc / l), l <= 0 divides by 1
// The switches:
//   kExp2   e is 2^x (q folded with log2(e)); otherwise e^x, computed as one
//           ex2.approx of fma(s, log2 e, -m log2 e), the same form for alpha;
//   kMask   kMaskTail: only the tile that crosses kv_end is masked;
//           kMaskAll: every tile (the same function; what masking costs);
//           kMaskPadfix: as kMaskTail with kv_end = the padded length, and
//           the final l drops the `pad` zero keys' mass, pad * e(-m), with the
//           accurate exp2f / expf once a row;
//   kKt     K arrives transposed, [BH, 64, k_row] (k_row a multiple of 8, so
//           TMA's 16-byte row stride holds): its tile is the B operand of
//           Q K^T in MN-major form, two TMA boxes of 64 columns;
//   kHeads  a persistent grid: each CTA walks (head group, q tile) items of
//           `hper` heads in turn, the TMA ring running on across heads with
//           no drain and q double-buffered. The items of the last, partial
//           round are split by head over every CTA, so no SM idles for more
//           than one head-tile while others finish (PERF.md reckons the
//           tail of a plain grid for each hper of the sweep).
// Without kHeads the grid is (q tiles, B*H), one head-tile a CTA. kKt and
// kHeads are built at D 64 only: K7 and K8 reach no other head dim.
//
// The design (FlashAttention-3's shape): a CTA takes 64 x kWG q rows, kWG
// consumer warpgroups of 64 rows and a producer. The producer keeps K and V
// tiles of kBN kv rows in a ring of kStages shared-memory slots by TMA
// (mbarriers); rows past the tensors' ends arrive as zeros, so no wrapper
// pads (padfix's pad keys are that zero fill and score exactly 0, as
// zero-padded keys do), and stores past sq are dropped. S = Q K^T is D / 16
// k steps of wgmma m64n<kBN>k16 from shared memory; the softmax runs on the
// f32 accumulator fragment in registers; bf16(p) becomes the A operand of P
// V (wgmma m64nDk16) in registers, V the B operand through wgmma's transpose
// bit. A tile's P V stays in flight while the next tile's Q K^T is issued.
// p is one SFU instruction (exp2_ftz: p below 2^-126 counts as 0, which a
// bf16 output cannot see); tiles wholly past kv_end change nothing and are
// skipped. The plan of each D (Plan below; fixed_cell.cuh's, with the
// online max):
//   * kWG 3 up to D 64 with a producer warp (D 64 keeps the plan K4 and
//     K7-K9 were timed with). Above D 64 a consumer thread holds 64
//     f32 of S, D / 2 of the output, 32 packed bf16(p) and the rows' m and
//     l: 156 registers at D 112 and 164 at 128 before addresses, at the
//     168 that 9 warps leave a thread. So kWG is 2 there and the producer is
//     a whole warpgroup that gives its registers to the consumers
//     (setmaxnreg: 24 for it, 240 a consumer thread; flash_pv8.cu's plan);
//   * kBN, the kv rows of a tile, is 128 up to D 128. Above, a consumer
//     thread would hold D / 2 f32 of the output, 64 of S and 32 packed
//     bf16(p): 224 registers at D 256 before addresses, of its 240; so kBN
//     is 64 there (FlashAttention-3 narrows its kv tile at 256 too): D / 2
//     + 32 + 16 + 4, 132 at 160 to 180 at 256. P V stays one wgmma
//     m64nDk16 chain (N <= 256);
//   * q and k rows are 2 D bytes rounded up to a swizzle row (32, 64 or
//     128 bytes; TMA fills the columns past D with zeros), in 128-byte
//     panels above 128 (D 80-128: two panels; 160-192 three, 224-256
//     four). V is MN-major in panels of the widest swizzle row whose
//     columns divide D (64 columns at 64, 128, 192 and 256, 32 at 32, 96,
//     160 and 224, 16 at 16, 48, 80 and 112), so no wgmma reads a panel in
//     part;
//   * kStages is as many K + V slots as fit beside q in the 227 KB a block
//     may take, at most 4 (3 at D 64, its timed plan): 4 at 16-48, and at
//     160 (q 48 KB + 4 x (24 KB K + 20 KB V)); 3 at 80-128 (q 32 KB + 3 x
//     (32 KB K + 20-32 KB V)) and at 192 (q 48 KB + 3 x (24 + 24 KB)); 2 at
//     224 and 256 (q 64 KB + 2 x (32 KB K + 28-32 KB V)).
// Built without --use_fast_math so exp2f, expf (alpha, the padfix term) and
// the division stay accurate.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

// internal linkage: each source that includes the cell builds its own
// instances, as a kernel in one source would be
namespace {
namespace online_cell {

using namespace hopper;

constexpr float kNegInf = -0.7f * 3.40282347e38f;  // the TPU kernels' mask
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

enum Mask { kMaskAll = 0, kMaskTail = 1, kMaskPadfix = 2 };

// The tile plan of head dim D (the note above); kQBufs q buffers (kHeads: 2)
template <int D, int kQBufs = 1>
struct Plan {
  static_assert(D % 16 == 0 && D >= 16 && D <= 256, "head_dim: 16 to 256 in steps of 16");
  static constexpr int kBN = D <= 128 ? 128 : 64;   // kv rows a tile
  static constexpr int kWG = D <= 64 ? 3 : 2;       // consumer warpgroups, 64 q rows each
  static constexpr int kBM = 64 * kWG;              // q rows per CTA
  static constexpr int kConsumers = 128 * kWG;
  // the producer: a warp, or a warpgroup that hands its registers on
  static constexpr bool kProducerWG = D > 64;
  static constexpr int kThreads = kConsumers + (kProducerWG ? 128 : 32);
  static constexpr int kProducerRegs = 24, kConsumerRegs = 240;
  static_assert(!kProducerWG || 128 * kProducerRegs + kConsumers * kConsumerRegs <=
                                    kThreads * ((65536 / kThreads) & ~7),
                "setmaxnreg asks for more registers than the CTA starts with");
  // q and k (K-major): panels of kRow-byte rows, k steps of 16 bf16
  static constexpr int kRow = swizzle_row(2 * D);
  static constexpr int kPanels = (2 * D + 127) / 128;
  static constexpr int kSteps = D / 16;
  // v (MN-major): panels of kVCols columns, kVRow bytes a row
  static constexpr int kVCols = D % 64 == 0 ? 64 : D % 32 == 0 ? 32 : 16;
  static constexpr int kVRow = 2 * kVCols;
  static constexpr int kVPanels = D / kVCols;
  static constexpr int kQTile = kBM * kRow * kPanels;  // bytes
  static constexpr int kKTile = kBN * kRow * kPanels;
  static constexpr int kVTile = kBN * 2 * D;
  // as many stages as fit beside q, the barriers and the 1024-byte alignment
  // in the 227 KB a block may take, at most 4; 3 at D 64 (above)
  static constexpr int kFit = (232448 - 2 * 1024 - kQBufs * kQTile) / (kKTile + kVTile);
  static constexpr int kStages = D == 64 ? 3 : kFit < 4 ? kFit : 4;
  static_assert(kStages >= 2, "two ring stages must fit");
};

template <int D, int kQBufs>
struct Smem {
  using P = Plan<D, kQBufs>;
  uint8_t q[kQBufs][P::kQTile];
  uint8_t k[P::kStages][P::kKTile];  // K rows, or K^T as two 64-column boxes
  uint8_t v[P::kStages][P::kVTile];
  Ring<P::kStages> ring;
  uint64_t q_full[kQBufs];
  uint64_t q_empty[kQBufs];  // kHeads: every consumer has read the q buffer
};

struct Params {
  __nv_bfloat16* out;  // [BH, sq, D]
  int sq, kv_end, round_l, pad;
  float qscale;
  // kHeads: hper heads an item, q tiles a head, full rounds of gridDim.x
  // items, and the items left for the last round
  int hper, q_tiles, rounds, left;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// head-tiles this CTA walks: whole items in the full rounds, then single
// heads of the last round's items, dealt out over every CTA
template <bool kHeads>
__device__ __forceinline__ int work_count(const Params& p) {
  if (!kHeads) return 1;
  const int left = p.left * p.hper, c = blockIdx.x;
  return p.rounds * p.hper + (c < left ? (left - 1 - c) / gridDim.x + 1 : 0);
}

// the q tile and head of this CTA's w-th head-tile; an item is (head group,
// q tile), q tiles fastest, so the CTAs of one round share K and V in L2.
// The last round's head-tiles are dealt q tiles fastest too: the CTAs that
// run together take one head of consecutive items
template <int kBM, bool kHeads>
__device__ __forceinline__ void work_at(const Params& p, int w, int& q0, int& bh) {
  if (!kHeads) {
    q0 = blockIdx.x * kBM;
    bh = blockIdx.y;
    return;
  }
  const int full = p.rounds * p.hper;
  int item, hh;
  if (w < full) {
    item = blockIdx.x + (w / p.hper) * gridDim.x;
    hh = w % p.hper;
  } else {
    const int u = blockIdx.x + (w - full) * gridDim.x;
    item = p.rounds * gridDim.x + u % p.left;
    hh = u / p.left;
  }
  q0 = (item % p.q_tiles) * kBM;
  bh = (item / p.q_tiles) * p.hper + hh;
}

template <int D, bool kExp2, int kMask, bool kKt, bool kHeads>
__global__ void __launch_bounds__(Plan<D, kHeads ? 2 : 1>::kThreads, 1)
cell_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap, const Params prm) {
  static_assert(D == 64 || (!kKt && !kHeads), "K^T and the heads walk: head_dim 64 only");
  constexpr int kQBufs = kHeads ? 2 : 1;
  using P = Plan<D, kQBufs>;
  constexpr int kBM = P::kBM, kBN = P::kBN, kConsumers = P::kConsumers, kRow = P::kRow;
  extern __shared__ uint8_t smem_raw[];
  Smem<D, kQBufs>& sm = *reinterpret_cast<Smem<D, kQBufs>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int n_tiles = (prm.kv_end + kBN - 1) / kBN;  // later tiles change nothing
  const int n_work = work_count<kHeads>(prm);

  if (threadIdx.x == 0) {
    sm.ring.init(kConsumers);
#pragma unroll
    for (int b = 0; b < kQBufs; ++b) {
      mbar_init(&sm.q_full[b], 1);
      if (kHeads) mbar_init(&sm.q_empty[b], kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer: one thread issues every TMA load ----
    if constexpr (P::kProducerWG) setmaxnreg_dec<P::kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      for (int w = 0, i = 0; w < n_work; ++w) {
        int q0, bh;
        work_at<kBM, kHeads>(prm, w, q0, bh);
        const int b = w % kQBufs;
        if (kHeads && w >= kQBufs) mbar_wait(&sm.q_empty[b], (w / kQBufs - 1) & 1);
        mbar_expect_tx(&sm.q_full[b], P::kQTile);
        for (int p = 0; p < P::kPanels; ++p)
          tma_load_3d(sm.q[b] + p * kBM * kRow, &qmap, &sm.q_full[b], p * kRow / 2, q0, bh);
        for (int t = 0; t < n_tiles; ++t, ++i) {
          const int s = sm.ring.acquire(i, P::kKTile + P::kVTile);
          if (kKt) {
            tma_load_3d(sm.k[s], &kmap, &sm.ring.full[s], t * kBN, 0, bh);
            tma_load_3d(sm.k[s] + 64 * 2 * D, &kmap, &sm.ring.full[s], t * kBN + 64, 0, bh);
          } else {
            for (int p = 0; p < P::kPanels; ++p)
              tma_load_3d(sm.k[s] + p * kBN * kRow, &kmap, &sm.ring.full[s], p * kRow / 2,
                          t * kBN, bh);
          }
          for (int p = 0; p < P::kVPanels; ++p)
            tma_load_3d(sm.v[s] + p * kBN * P::kVRow, &vmap, &sm.ring.full[s], p * P::kVCols,
                        t * kBN, bh);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns q rows q0 + 64 wg .. + 63 ----
  if constexpr (P::kProducerWG) setmaxnreg_inc<P::kConsumerRegs>();
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int lane = tid % 32, warp = t / 32;
  const int c = lane % 4;
  constexpr Swizzle swz = desc_swizzle(kRow);

  for (int w = 0, base = 0; w < n_work; ++w, base += n_tiles) {
    int q0, bh;
    work_at<kBM, kHeads>(prm, w, q0, bh);
    const int b = w % kQBufs;
    uint8_t* qs = sm.q[b] + wg * 64 * kRow;  // in panel 0

    // q * qscale rounded to bf16, in place (elementwise, so the swizzle is
    // moot; the zero fill past D stays zero)
    mbar_wait(&sm.q_full[b], (w / kQBufs) & 1);
#pragma unroll
    for (int p = 0; p < P::kPanels; ++p) {
#pragma unroll
      for (int i = 0; i < 64 * kRow / 16 / 128; ++i) {
        uint4* ptr = reinterpret_cast<uint4*>(qs + p * kBM * kRow) + t + 128 * i;
        uint4 raw = *ptr;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(h[j]);
          h[j] = __floats2bfloat162_rn(__fmul_rn(f.x, prm.qscale), __fmul_rn(f.y, prm.qscale));
        }
        *ptr = raw;
      }
    }
    fence_proxy_async();
    named_sync(1 + wg, 128);

    const uint64_t qdesc = make_desc(qs, 16, 8 * kRow, swz);
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;  // rows r, r + 8
    // bf16(p) as the A fragments of P V (k step kk takes accumulator chunks
    // 2kk and 2kk + 1). Tile it's P V stays in flight while tile it + 1's
    // Q K^T is issued; one wait covers both.
    uint32_t pa[kBN / 16][4];

    for (int it = 0; it < n_tiles; ++it) {
      const int s = sm.ring.wait_full(base + it);
      // K rows: K-major, panels of kRow bytes; K^T: MN-major, its two
      // 64-column boxes LBO apart. V: MN-major, its panels LBO apart.
      const uint64_t kdesc = kKt ? make_desc(sm.k[s], 8192, 1024, kSw128)
                                 : make_desc(sm.k[s], 16, 8 * kRow, swz);
      const uint64_t vdesc =
          make_desc(sm.v[s], kBN * P::kVRow, 8 * P::kVRow, desc_swizzle(P::kVRow));

      float acc[kBN / 2];
      wgmma_fence();
#pragma unroll
      for (int st = 0; st < P::kSteps; ++st) {
        const int panel = 32 * st / kRow, col = 32 * st % kRow;
        if constexpr (kBN == 128)
          wgmma_m64n128k16_ss_bf16<kKt ? 1 : 0>(
              acc, desc_add(qdesc, panel * kBM * kRow + col),
              desc_add(kdesc, kKt ? 2048 * st : panel * kBN * kRow + col), st > 0);
        else
          wgmma_ss_bf16<kBN>(acc, desc_add(qdesc, panel * kBM * kRow + col),
                             desc_add(kdesc, panel * kBN * kRow + col), st > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(o);
      fence_regs(pa);
      if (it > 0) sm.ring.release(base + it - 1);  // its P V has completed

      const int kv0 = it * kBN;
      if (kMask == kMaskAll || kv0 + kBN > prm.kv_end) {
#pragma unroll
        for (int i = 0; i < kBN / 2; ++i)
          if (kv0 + 8 * (i / 4) + 2 * c + (i % 2) >= prm.kv_end) acc[i] = kNegInf;
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(acc[4 * j], acc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(acc[4 * j + 2], acc[4 * j + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      // e(x - mn) = 2^(x - mn) or 2^(x log2e - mn log2e); a masked score
      // times log2e overflows to -inf and gives 0, as it should
      const float nb0 = kExp2 ? 0.0f : __fmul_rn(mn0, -kLog2e);
      const float nb1 = kExp2 ? 0.0f : __fmul_rn(mn1, -kLog2e);
      const float alpha0 = kExp2 ? exp2f(__fsub_rn(m0, mn0))  // 0 on the first tile
                                 : exp2f(__fmaf_rn(m0, kLog2e, nb0));
      const float alpha1 = kExp2 ? exp2f(__fsub_rn(m1, mn1))
                                 : exp2f(__fmaf_rn(m1, kLog2e, nb1));
      m0 = mn0;
      m1 = mn1;

      // p, its bf16 rounding packed into pa, and the row sums
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        float p0, p1, p2, p3;
        if (kExp2) {
          p0 = exp2_ftz(__fsub_rn(acc[4 * j], mn0));
          p1 = exp2_ftz(__fsub_rn(acc[4 * j + 1], mn0));
          p2 = exp2_ftz(__fsub_rn(acc[4 * j + 2], mn1));
          p3 = exp2_ftz(__fsub_rn(acc[4 * j + 3], mn1));
        } else {
          p0 = exp2_ftz(__fmaf_rn(acc[4 * j], kLog2e, nb0));
          p1 = exp2_ftz(__fmaf_rn(acc[4 * j + 1], kLog2e, nb0));
          p2 = exp2_ftz(__fmaf_rn(acc[4 * j + 2], kLog2e, nb1));
          p3 = exp2_ftz(__fmaf_rn(acc[4 * j + 3], kLog2e, nb1));
        }
        const __nv_bfloat162 b01 = __floats2bfloat162_rn(p0, p1);
        const __nv_bfloat162 b23 = __floats2bfloat162_rn(p2, p3);
        pa[j / 2][(j % 2) * 2] = *reinterpret_cast<const uint32_t*>(&b01);
        pa[j / 2][(j % 2) * 2 + 1] = *reinterpret_cast<const uint32_t*>(&b23);
        if (prm.round_l) {
          const float2 f01 = __bfloat1622float2(b01), f23 = __bfloat1622float2(b23);
          sum0 = __fadd_rn(__fadd_rn(sum0, f01.x), f01.y);
          sum1 = __fadd_rn(__fadd_rn(sum1, f23.x), f23.y);
        } else {
          sum0 = __fadd_rn(__fadd_rn(sum0, p0), p1);
          sum1 = __fadd_rn(__fadd_rn(sum1, p2), p3);
        }
      }
      l0 = __fadd_rn(__fmul_rn(alpha0, l0), sum0);
      l1 = __fadd_rn(__fmul_rn(alpha1, l1), sum1);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] = __fmul_rn(o[4 * j], alpha0);
        o[4 * j + 1] = __fmul_rn(o[4 * j + 1], alpha0);
        o[4 * j + 2] = __fmul_rn(o[4 * j + 2], alpha1);
        o[4 * j + 3] = __fmul_rn(o[4 * j + 3], alpha1);
      }

      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_rs_bf16_vt<D>(o, pa[kk], desc_add(vdesc, 16 * P::kVRow * kk), 1);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    if (kHeads) {  // the last tile's slot and the q buffer go back to the producer
      sm.ring.release(base + n_tiles - 1);
      mbar_arrive(&sm.q_empty[b]);
    }

    l0 = __fadd_rn(l0, __shfl_xor_sync(kFull, l0, 1));
    l0 = __fadd_rn(l0, __shfl_xor_sync(kFull, l0, 2));
    l1 = __fadd_rn(l1, __shfl_xor_sync(kFull, l1, 1));
    l1 = __fadd_rn(l1, __shfl_xor_sync(kFull, l1, 2));
    if (kMask == kMaskPadfix && prm.pad > 0) {
      // the pad keys scored 0 and added e(0 - m) each; m >= 0 with them in
      const float pad = static_cast<float>(prm.pad);
      l0 = __fsub_rn(l0, __fmul_rn(pad, kExp2 ? exp2f(-m0) : expf(-m0)));
      l1 = __fsub_rn(l1, __fmul_rn(pad, kExp2 ? exp2f(-m1) : expf(-m1)));
    }
    const float inv0 = l0 <= 0.0f ? 1.0f : __fdiv_rn(1.0f, l0);
    const float inv1 = l1 <= 0.0f ? 1.0f : __fdiv_rn(1.0f, l1);
    const int row = q0 + wg * 64 + warp * 16 + lane / 4;
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
}

// The q map of a [BH, sq, D] bf16 tensor in kBM-row boxes of one panel row;
// a K map of [BH, rows, D] in kBN-row boxes of one panel row; a V map of
// [BH, rows, D] in kBN-row boxes of kVCols columns; a K^T map of [BH, 64,
// k_row] in 64 x 64 boxes (D 64). Each returns false where
// cuTensorMapEncodeTiled refuses it.
template <int D>
bool q_map(CUtensorMap* map, const void* q, int BH, int sq) {
  using P = Plan<D>;
  return make_map_3d(map, q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, D, sq, BH, P::kRow / 2,
                     P::kBM, map_swizzle(P::kRow));
}
template <int D>
bool k_map(CUtensorMap* map, const void* k, int BH, int rows) {
  using P = Plan<D>;
  return make_map_3d(map, k, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, D, rows, BH, P::kRow / 2,
                     P::kBN, map_swizzle(P::kRow));
}
template <int D>
bool v_map(CUtensorMap* map, const void* v, int BH, int rows) {
  using P = Plan<D>;
  return make_map_3d(map, v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, D, rows, BH, P::kVCols,
                     P::kBN, map_swizzle(P::kVRow));
}
inline bool kt_map(CUtensorMap* map, const void* kt, int BH, int k_row) {
  return make_map_3d(map, kt, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, k_row, 64, BH, 64, 64,
                     CU_TENSOR_MAP_SWIZZLE_128B);
}

// One launch of an instance. Without kHeads the grid is (q tiles, BH); with
// it, min(SMs, head-tiles) CTAs and prm's walk filled in here.
template <int D, bool kExp2, int kMask, bool kKt, bool kHeads>
int launch(const CUtensorMap& qmap, const CUtensorMap& kmap, const CUtensorMap& vmap,
           Params prm, int BH, cudaStream_t stream) {
  using P = Plan<D, kHeads ? 2 : 1>;
  // + 1024 so the tiles can start on a 1024-byte boundary
  constexpr int kSmem = sizeof(Smem<D, kHeads ? 2 : 1>) + 1024;
  auto kernel = cell_kernel<D, kExp2, kMask, kKt, kHeads>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  prm.q_tiles = (prm.sq + P::kBM - 1) / P::kBM;
  dim3 grid(prm.q_tiles, BH);
  if (kHeads) {
    int dev = 0, sms = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return static_cast<int>(err);
    const int items = BH / prm.hper * prm.q_tiles;
    const int ctas = items * prm.hper < sms ? items * prm.hper : sms;
    prm.rounds = items / ctas;
    prm.left = items - prm.rounds * ctas;
    grid = dim3(ctas);
  }
  kernel<<<grid, P::kThreads, kSmem, stream>>>(qmap, kmap, vmap, prm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace online_cell
}  // namespace
