// K4 in f32 above head_dim 128: online-softmax flash attention on the
// tensor cores as split TF32 (3xTF32) wgmma with TMA, written by hand for
// Hopper (sm_90a), one kernel for every width dp (the head dim rounded up by
// the wrapper to a multiple of 32 up to 256 and of 64 above, zero columns
// past it) read at run time. flash_online.cu (tf32x3_cell.cuh) runs the head
// dims up to 128; flash_online_wide_bf16.cu is the bf16 form of this kernel
// above 256.
//
// Replaces aether_tpu/ops/flash_attention.py::_flash_kernel (:69, the
// Pallas TPU kernel launched by flash_attention(fixed_max=False)) for f32
// q/k/v at head_dim > 128 (the JAX wrapper's "vpu" route, :538-548, no upper
// limit): the training forward (flash_train) and the f32 DiT at such head
// dims. Non-causal, in the log2 domain, q pre-scaled by sm_scale * log2(e)
// in the wrapper, as tf32x3_cell.cuh's kOnline:
//   s   = q . k^T                              (3xTF32 products, f32 sums)
//   s   = -0.7 * f32max  where column >= kv_len
//   m'  = max(m, rowmax s),  alpha = exp2(m - m'),  p = exp2(s - m')
//   acc = alpha * acc + p . v                  (3xTF32; acc on the FMA units)
//   l   = alpha * l + sum p
//   out = acc / l, a zero l divides by 1
// The products are tf32x3_cell.cuh's (its note): every f32 operand split
// into x_hi = tf32(x) and x_lo = tf32(x - x_hi) by the wrapper (q, k, v^T)
// or here (p), and hi.hi + hi.lo + lo.hi kept, about 2^-22 of a product
// from f32; each tile's P V starts in fresh registers on the tensor core and
// the output takes it in on the FMA units, o = alpha o + P V (the loss of
// the tensor cores' accumulation grows with every addition).
//
// What bounds it on an H100: at (1, 48 heads, 15076 tokens, D) one call is
// three TF32 products of 4.4e10 x D flops, 0.2645 ms x D at 495 TFLOP/s
// (42.3 ms at 160, 67.7 at 256, 84.6 at 320, 135.4 at 512). The cell's plan
// stops at 128: Q_hi of 128 rows is 64 KB there and Q_lo a register fragment
// of D / 2 a thread, the output D / 2 more. So a q tile's head dim is split
// and S computed once:
//   * a thread-block cluster of n CTAs takes a q tile of 128 rows (the
//     grid's y axis, ops/flash_attention.py::_wide_plan and wide_cluster in
//     hopper.cuh): CTA r owns a slice of the head dim, at most kC = 128
//     columns, the units of the width dealt out evenly, 32 columns a unit up
//     to 256 (a pair: 160 96 + 64, 192 96 + 96, 224 128 + 96, 256 128 +
//     128) and 64 above (320: 128 + 128 + 64, 512: 4 x 128, n up to 8 at
//     1024); a CTA has two consumer warpgroups of 64 q rows and a producer
//     warpgroup that hands its registers to them (setmaxnreg: 24 / 240);
//   * each CTA is tf32x3_cell.cuh's kOnline plan at 128 on its slice: Q_hi
//     stays in shared memory (up to 64 KB) and Q_lo in registers (up to 64
//     a thread) for the whole kv loop; K_hi and K_lo of the slice, and the
//     slice's rows of V^T, come in 32-row kv tiles by TMA (128-byte
//     swizzle) through rings of kStages slots; the CTA's part of S is 3 x
//     (slice / 8) k steps of wgmma m64n32k8 tf32 on the tensor core (at most
//     128 columns, as many products as the cell's at 128, whose
//     accumulation that keeps to f32 accuracy);
//   * the rings (kPair; each form the faster on its widths on the card,
//     PERF.md section 6): a pair keeps K and V in rings of their own, a K
//     slot free as soon as its S has completed, a tile before the V slot of
//     the same tile, whose P V is still in flight, so the next K loads start
//     early; wider clusters keep a tile's K and V in one slot. Either loads
//     only its slice's V^T rows, in 32-row boxes (kChunked: one box of 128
//     rows, as the boxes' loop spilled its producer's 24 registers);
//   * the parts meet through distributed shared memory (ScoreExchange in
//     hopper.cuh: a pair pushes its part into the other CTA with st.async,
//     more CTAs pull the other ranks' parts) and are added in rank order on
//     the FMA units, so every CTA holds the same S, bit for bit;
//   * P stays in registers, split into P_hi and P_lo as the A operands of P
//     V (tf32x3_cell.cuh's kv order of V^T: no shuffle), in chains into fresh
//     registers folded into the output on the FMA units: 64 output columns
//     one chain, 96 a chain of 32 and one of 64, 128 two of 64; the last
//     chain (64 columns) stays in flight across the next tile's part of S,
//     and the two warpgroups, on rows of their own, run each other's
//     products under their softmax (the cell's <128> plan); a consumer
//     thread holds 64 f32 of output, 64 of Q_lo, 32 of a chain, 32 of P_hi
//     and P_lo and 16 of S. Two orders that meant to hide the exchange read
//     far slower on the card and are not used: the warpgroups taking turns
//     to issue S (named barriers), and the last chain issued behind the next
//     tile's S so that it runs under the exchange;
//   * above 8 slices (dp > 1024) clusters along y each compute S so and
//     split the output columns between their CTAs evenly, each CTA's slice
//     then wider than 128: it sums S in chunks of at most 128 columns (the
//     kChunked instance), Q_hi and Q_lo loaded again for each chunk of each
//     kv tile, the chunks added on the FMA units;
//   * rows past the tensors' ends and V^T rows past dp arrive as zeros
//     (TMA), stores past the slice or sq are dropped, tiles wholly past
//     kv_len are skipped and only the last is masked.
// The products are the function's, once; L2 gives each CTA its slice of K
// and V a tile: a pair reads K and V once for 128 q rows (~0.35 TB a call
// at 256, half of a 64-row CTA's). The exchange moves 16 KB a CTA and
// 32-row tile through DSMEM: a pair's push, 0.90 us an exchange alone in
// bench/dsmem_probe.py on an H100 at 700 W (PERF.md section 6), runs beside
// the other warpgroup's products; above two CTAs, pulled from the n - 1
// other ranks one at a time (2.6 us a tile alone at n = 3, 3.6 at n = 4).
// Shared memory: Q_hi 64 KB + K 2 x 32 + V 2 x 32 + the exchange 2 x 16 =
// 224 KB of the 227 a block may take.
// Compiled without --use_fast_math so exp2f and the division stay accurate.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3_cell.cuh"


namespace {
namespace wide_f32 {

using namespace hopper;
using tf32x3_cell::fold;
using tf32x3_cell::kNegInf;
using tf32x3_cell::pv;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBM = 128;     // q rows a CTA: two consumer warpgroups of 64
constexpr int kBN = 32;      // kv rows a tile
constexpr int kPanel = 32;   // head-dim columns of a Q or K panel, rows of a V^T box (128 bytes)
constexpr int kC = 128;      // head-dim columns of a chunk of S, and of the output, at most
constexpr int kPanels = kC / kPanel, kSteps = kC / 8;
constexpr int kPV = 64;      // output columns of the P V chain left in flight
constexpr int kConsumers = 256, kThreads = kConsumers + 128;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
static_assert(128 * kProducerRegs + kConsumers * kConsumerRegs <=
                  kThreads * ((65536 / kThreads) & ~7),
              "setmaxnreg asks for more registers than the CTA starts with");
constexpr int kQPanel = kBM * 128;      // bytes of a Q_hi panel
constexpr int kKPanel = kBN * 128;      // of a K_hi or K_lo panel
constexpr int kVBox = kPanel * kBN * 4; // of a box of 32 V^T rows
constexpr int kVTile = kC * kBN * 4;    // of a tile of V^T_hi or V^T_lo (kC rows)
constexpr int kStages = 2;              // ring slots
constexpr int kPairTop = 256;           // the widest plan of a pair (kPair)

// head-dim columns of a unit of the plan: 32 for a pair (dp <= kPairTop),
// else 64 (ops/flash_attention.py::_wide_plan)
__host__ __device__ constexpr int slice_unit(bool pair) { return pair ? 32 : 64; }

struct Smem {
  uint8_t q[kPanels][kQPanel];                   // Q_hi's chunk: 64 KB
  uint8_t k[kStages][2][kPanels][kKPanel];       // K_hi, K_lo
  uint8_t v[kStages][2][kVTile];                 // V^T_hi, V^T_lo
  ScoreExchange<kConsumers / 32, kBN / 2> x;
  Ring<1> qr;        // Q_hi: loaded once, or chunk by chunk where the slice is wider
  // a chunk's K_hi and K_lo and, unless kPair, the tile's V^T rows with its
  // last chunk: free once the next chunk's S (and so its P V) has completed;
  // with kPair only K, free once its own S has completed
  Ring<kStages> kr;
  Ring<kStages> vr;  // kPair: a tile's V^T rows, free once its P V has completed
};
// + 1024 so the tiles can start on a 1024-byte boundary
constexpr int kSmem = sizeof(Smem) + 1024;
static_assert(kSmem <= 232448, "the tiles must fit in the 227 KB a block may take");

struct Params {
  const float* q_lo;   // [BH, sq, dp]
  float* out;          // [BH, sq, dp]
  int sq, kv_len, dp;  // dp: the width, a multiple of the unit
  int cluster, ctas;   // CTAs a cluster, and along the grid's y axis
};

// kChunked: the slice wider than kC (dp > 8 x kC), S summed over it in chunks
// of kC columns, Q_hi and Q_lo loaded again for every chunk of every kv tile;
// else Q_hi stays in shared memory and Q_lo in registers for the whole kv loop.
// kPair: a pair of CTAs at 160-256, slices in 32-column units (64, 96 or
// 128 columns), K and V in rings of their own; else slices in 64-column
// units (64 or 128), a tile's K and V in one ring slot (each ring form the
// faster on its widths on the card, PERF.md section 6)
template <bool kChunked, bool kPair>
__global__ void __launch_bounds__(kThreads, 1)
wide_kernel(const __grid_constant__ CUtensorMap qhi_map, const __grid_constant__ CUtensorMap khi_map,
            const __grid_constant__ CUtensorMap klo_map, const __grid_constant__ CUtensorMap vhi_map,
            const __grid_constant__ CUtensorMap vlo_map, const Params prm) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int q0 = blockIdx.x * kBM, bh = blockIdx.z;
  const int n_tiles = (prm.kv_len + kBN - 1) / kBN;  // later tiles change nothing
  const int n = prm.cluster, rank = static_cast<int>(cluster_ctarank());
  // this CTA's slice of S's head dim, in chunks of at most kC columns, and
  // its output columns (64, 96 or 128)
  static_assert(!(kChunked && kPair), "a pair's slices fit in kC columns");
  constexpr int unit = slice_unit(kPair);
  const int units = prm.dp / unit;
  const int s0 = part_start(units, n, rank) * unit;
  const int s_cols = part_count(units, n, rank) * unit;
  const int chunks = kChunked ? (s_cols + kC - 1) / kC : 1;
  const int o0 = part_start(units, prm.ctas, blockIdx.y) * unit;
  const int o_cols = part_count(units, prm.ctas, blockIdx.y) * unit;

  if (threadIdx.x == 0) {
    sm.qr.init(kConsumers);
    sm.kr.init(kConsumers);
    sm.vr.init(kConsumers);
    sm.x.init(sm.x.arrivals(n));
    mbar_init_fence();
  }
  // every barrier of the cluster is initialized before any CTA arrives on one
  cluster_arrive();
  cluster_wait();

  if (threadIdx.x >= kConsumers) {
    // ---- producer: one thread issues every TMA load: for each kv tile and
    // chunk, Q_hi's chunk (once, unless kChunked), K_hi's and K_lo's, then
    // the tile's V^T rows of the output slice ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      const int boxes = o_cols / kPanel;
      for (int t = 0, i = 0; t < n_tiles; ++t) {
        int s = 0;
        for (int ch = 0; ch < chunks; ++ch, ++i) {
          const int c0 = s0 + ch * kC, panels = min(kC, s_cols - ch * kC) / kPanel;
          if (kChunked || i == 0) {
            sm.qr.acquire(i, panels * kQPanel);
            for (int p = 0; p < panels; ++p)
              tma_load_3d(sm.q[p], &qhi_map, &sm.qr.full[0], c0 + p * kPanel, q0, bh);
          }
          // one ring (not kPair): V^T with the tile's last chunk (kChunked:
          // one box of kC rows, which keeps the producer's 24 registers
          // from spilling)
          const bool v_here = !kPair && ch == chunks - 1;
          const int v_bytes = kChunked ? 2 * kVTile : 2 * boxes * kVBox;
          s = sm.kr.acquire(i, 2 * panels * kKPanel + (v_here ? v_bytes : 0));
          for (int p = 0; p < panels; ++p) {
            tma_load_3d(sm.k[s][0][p], &khi_map, &sm.kr.full[s], c0 + p * kPanel, t * kBN, bh);
            tma_load_3d(sm.k[s][1][p], &klo_map, &sm.kr.full[s], c0 + p * kPanel, t * kBN, bh);
          }
          if (kChunked && v_here) {
            tma_load_3d(sm.v[s][0], &vhi_map, &sm.kr.full[s], t * kBN, o0, bh);
            tma_load_3d(sm.v[s][1], &vlo_map, &sm.kr.full[s], t * kBN, o0, bh);
          }
        }
        if (kChunked) continue;
        // the tile's V^T rows of the output slice, in 32-row boxes: in the V
        // ring (kPair) or in the slot of its last chunk
        if (kPair) s = sm.vr.acquire(t, 2 * boxes * kVBox);
        uint64_t* bar = kPair ? &sm.vr.full[s] : &sm.kr.full[s];
        for (int b = 0; b < boxes; ++b) {
          tma_load_3d(sm.v[s][0] + b * kVBox, &vhi_map, bar, t * kBN, o0 + b * kPanel, bh);
          tma_load_3d(sm.v[s][1] + b * kVBox, &vlo_map, bar, t * kBN, o0 + b * kPanel, bh);
        }
      }
    }
    cluster_arrive();  // no CTA leaves while another may read its shared memory
    cluster_wait();
    return;
  }

  // ---- consumers: warpgroup wg owns q rows q0 + 64 wg .. + 63 ----
  setmaxnreg_inc<kConsumerRegs>();
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int lane = tid % 32, warp = t / 32;
  const int c = lane % 4;
  const int row = q0 + wg * 64 + warp * 16 + lane / 4;  // and row + 8
  const uint64_t qdesc = make_desc(sm.q[0] + wg * 64 * 128, 16, 8 * 128, kSw128);

  // Q_lo of a chunk as the A fragments of Q_lo K_hi^T: k step st holds
  // columns 8 st + c and 8 st + c + 4 of rows row and row + 8 (rows past sq
  // and steps past the chunk: zeros)
  uint32_t qlo[kSteps][4];
  auto load_qlo = [&](int c0, int steps) {
    const float* q_lo = prm.q_lo + (int64_t)bh * prm.sq * prm.dp + c0;
#pragma unroll
    for (int st = 0; st < kSteps; ++st)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row + 8 * (e % 2), col = 8 * st + c + 4 * (e / 2);
        qlo[st][e] = r < prm.sq && st < steps
                         ? __float_as_uint(__ldg(q_lo + (int64_t)r * prm.dp + col))
                         : 0u;
      }
  };
  if (!kChunked) load_qlo(s0, s_cols / 8);

  float o[kC / 2];  // output columns o0 .., summed on the FMA units
#pragma unroll
  for (int i = 0; i < kC / 2; ++i) o[i] = 0.0f;
  // the last P V chain of the tile in flight (kPV columns, the slice's
  // last), on the tensor core, and the alpha of that tile, with which o
  // takes it in
  float ot[kPV / 2];
  float fold0 = 1.0f, fold1 = 1.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;  // rows row, row + 8
  // P_hi and P_lo as the A fragments of P V
  uint32_t phi[kBN / 8][4], plo[kBN / 8][4];
  auto fold_last = [&]() {
    if (o_cols == 128)
      fold<kC, kPV, 64>(o, ot, fold0, fold1);
    else if (kPair && o_cols == 96)
      fold<kC, kPV, 32>(o, ot, fold0, fold1);
    else
      fold<kC, kPV, 0>(o, ot, fold0, fold1);
  };

  for (int it = 0, i = 0; it < n_tiles; ++it) {
    // ---- this CTA's part of S = Q_hi K_hi^T + Q_hi K_lo^T + Q_lo K_hi^T,
    // on the tensor core a chunk at a time, the chunks added on the FMA units
    float sv[kBN / 2];
    int s = 0;  // the slot of the tile's last chunk
    for (int ch = 0; ch < chunks; ++ch, ++i) {
      const int steps = min(kC, s_cols - ch * kC) / 8;
      if (kChunked) {
        load_qlo(s0 + ch * kC, steps);
        sm.qr.wait_full(i);
      } else if (i == 0) {
        sm.qr.wait_full(0);
      }
      s = sm.kr.wait_full(i);
      float acc[kBN / 2];
      const uint64_t khi = make_desc(sm.k[s][0][0], 16, 8 * 128, kSw128);
      const uint64_t klo = make_desc(sm.k[s][1][0], 16, 8 * 128, kSw128);
      wgmma_fence();
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        if (st < steps) {  // a chunk of 64 or 96 columns takes fewer steps
          const uint32_t qa = (st / 4) * kQPanel + 32 * (st % 4);
          const uint32_t kb = (st / 4) * kKPanel + 32 * (st % 4);
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
      fence_regs(qlo);
      fence_regs(ot);
      if (kPair)
        sm.kr.release(i);  // its S has completed
      else if (i > 0)
        sm.kr.release(i - 1);  // its S and, where it held V^T, its P V have completed
      if (kChunked) sm.qr.release(i);
      if (!kChunked && it > 0) {  // the previous tile's last P V chain has completed
        if (kPair) sm.vr.release(it - 1);
        fold_last();
      }
#pragma unroll
      for (int j = 0; j < kBN / 2; ++j) sv[j] = ch == 0 ? acc[j] : __fadd_rn(sv[j], acc[j]);
    }

    // ---- S over the cluster, the same bits in every CTA ----
    sm.x.sum(sv, it, n, rank, tid / 32, lane);

    // ---- the running max, masked past kv_len ----
    const int kv0 = it * kBN;
    if (kv0 + kBN > prm.kv_len) {
#pragma unroll
      for (int j = 0; j < kBN / 2; ++j)
        if (kv0 + 8 * (j / 4) + 2 * c + (j % 2) >= prm.kv_len) sv[j] = kNegInf;
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
    const float sub0 = fmaxf(m0, mx0), sub1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(__fsub_rn(m0, sub0));  // 0 on the first tile
    const float alpha1 = exp2f(__fsub_rn(m1, sub1));
    m0 = sub0;
    m1 = sub1;

    // ---- p, its row sums, and P_hi / P_lo as the A fragments of k step j:
    // the accumulator's elements 0, 2, 1, 3 (V^T's kv order) ----
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      float pr[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) pr[e] = exp2f(__fsub_rn(sv[4 * j + e], e < 2 ? sub0 : sub1));
      sum0 = __fadd_rn(__fadd_rn(sum0, pr[0]), pr[1]);
      sum1 = __fadd_rn(__fadd_rn(sum1, pr[2]), pr[3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = pr[e == 1 ? 2 : e == 2 ? 1 : e];
        const float hi = tf32_rna(x);
        phi[j][e] = __float_as_uint(hi);
        plo[j][e] = __float_as_uint(tf32_rna(__fsub_rn(x, hi)));
      }
    }
    l0 = __fadd_rn(__fmul_rn(alpha0, l0), sum0);
    l1 = __fadd_rn(__fmul_rn(alpha1, l1), sum1);

    // ---- P V over this CTA's rows of V^T, in chains into fresh registers:
    // a first chain (64 columns of 128, 32 of 96) folded into o at once, the
    // last (kPV columns) left in flight across the next tile's S and folded
    // after it (with kChunked, at once) ----
    if (kPair) s = sm.vr.wait_full(it);
    const uint64_t vhi = make_desc(sm.v[s][0], 16, 8 * 128, kSw128);
    const uint64_t vlo = make_desc(sm.v[s][1], 16, 8 * 128, kSw128);
    fold0 = alpha0;
    fold1 = alpha1;
    if (o_cols == 128) {
      pv<kC, kPV, 0, kBN>(ot, phi, plo, vhi, vlo);
      wgmma_wait<0>();
      fence_regs(ot);
      fence_regs(phi);
      fence_regs(plo);
      fold<kC, kPV, 0>(o, ot, alpha0, alpha1);
      pv<kC, kPV, 64, kBN>(ot, phi, plo, vhi, vlo);
    } else if (kPair && o_cols == 96) {
      float oh[16];
      pv<kC, 32, 0, kBN>(oh, phi, plo, vhi, vlo);
      wgmma_wait<0>();
      fence_regs(oh);
      fence_regs(phi);
      fence_regs(plo);
      fold<kC, 32, 0>(o, oh, alpha0, alpha1);
      pv<kC, kPV, 32, kBN>(ot, phi, plo, vhi, vlo);
    } else {
      pv<kC, kPV, 0, kBN>(ot, phi, plo, vhi, vlo);
    }
    if (kChunked) {
      wgmma_wait<0>();
      fence_regs(ot);
      fence_regs(phi);
      fence_regs(plo);
      fold_last();
    }
  }
  if (!kChunked) {
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(phi);
    fence_regs(plo);
    fence_regs(ot);
    if (n_tiles > 0) fold_last();
  }

  l0 = __fadd_rn(l0, __shfl_xor_sync(kFull, l0, 1));
  l0 = __fadd_rn(l0, __shfl_xor_sync(kFull, l0, 2));
  l1 = __fadd_rn(l1, __shfl_xor_sync(kFull, l1, 1));
  l1 = __fadd_rn(l1, __shfl_xor_sync(kFull, l1, 2));
  const float inv0 = l0 <= 0.0f ? 1.0f : __fdiv_rn(1.0f, l0);
  const float inv1 = l1 <= 0.0f ? 1.0f : __fdiv_rn(1.0f, l1);
  float* obase = prm.out + (int64_t)bh * prm.sq * prm.dp + o0;
#pragma unroll
  for (int j = 0; j < kC / 8; ++j) {
    const int col = 8 * j + 2 * c;
    if (col < o_cols) {
      if (row < prm.sq)
        *reinterpret_cast<float2*>(obase + (int64_t)row * prm.dp + col) =
            make_float2(__fmul_rn(o[4 * j], inv0), __fmul_rn(o[4 * j + 1], inv0));
      if (row + 8 < prm.sq)
        *reinterpret_cast<float2*>(obase + (int64_t)(row + 8) * prm.dp + col) =
            make_float2(__fmul_rn(o[4 * j + 2], inv1), __fmul_rn(o[4 * j + 3], inv1));
    }
  }
  cluster_arrive();  // this CTA's reads of the others' shared memory are done
  cluster_wait();
}

}  // namespace wide_f32
}  // namespace

// q_hi, q_lo (q carrying sm_scale * log2(e), split), out: [BH, sq, dp] f32;
// k_hi, k_lo: [BH, skv, dp] f32, rows at or past kv_len zero; vt_hi, vt_lo:
// [BH, dp, skv rounded up to 8] f32, v transposed, split and kv-permuted
// (ops/flash_attention.py::_tf32_operands); all contiguous and 16-byte
// aligned, dp a multiple of 32 above 128 up to 256 and of 64 above (the head
// dim rounded up; the columns past it zero), any lengths. cluster, groups:
// the wrapper's _wide_plan (CTAs a cluster, clusters along y), checked
// against hopper.cuh's wide_cluster / wide_groups over slice_unit columns a
// unit. Returns a cudaError_t.
extern "C" int aether_flash_online_wide(const void* q_hi, const void* q_lo, const void* k_hi,
                                        const void* k_lo, const void* vt_hi, const void* vt_lo,
                                        void* out, int BH, int sq, int skv, int kv_len, int dp,
                                        int cluster, int groups, void* stream) {
  using namespace wide_f32;
  const bool pair = dp <= kPairTop;
  const int unit = slice_unit(pair), units = dp / unit, top = kC / unit;
  if (BH <= 0 || BH > 65535 || sq <= 0 || skv <= 0 || kv_len < 0 || kv_len > skv ||
      dp <= kC || dp % unit || cluster != wide_cluster(units, top) ||
      groups != wide_groups(units, top) || cluster * groups > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const int skv8 = (skv + 7) / 8 * 8;
  const uint32_t v_rows = groups == 1 ? kPanel : kC;  // of a V^T box: kChunked takes kC
  CUtensorMap qhi_map, khi_map, klo_map, vhi_map, vlo_map;
  if (!make_map_3d(&qhi_map, q_hi, f32, 4, dp, sq, BH, kPanel, kBM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_3d(&khi_map, k_hi, f32, 4, dp, skv, BH, kPanel, kBN, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_3d(&klo_map, k_lo, f32, 4, dp, skv, BH, kPanel, kBN, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_3d(&vhi_map, vt_hi, f32, 4, skv8, dp, BH, kBN, v_rows,
                   CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_3d(&vlo_map, vt_lo, f32, 4, skv8, dp, BH, kBN, v_rows,
                   CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  Params prm{};
  prm.q_lo = static_cast<const float*>(q_lo);
  prm.out = static_cast<float*>(out);
  prm.sq = sq;
  prm.kv_len = kv_len;
  prm.dp = dp;
  prm.cluster = cluster;
  prm.ctas = cluster * groups;
  // each CTA's slice within kC columns where one cluster spans the width
  void (*fn)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, Params) =
      pair ? wide_kernel<false, true>
           : groups == 1 ? wide_kernel<false, false> : wide_kernel<true, false>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((sq + kBM - 1) / kBM, cluster * groups, BH);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fn, qhi_map, khi_map, klo_map, vhi_map, vlo_map, prm);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
