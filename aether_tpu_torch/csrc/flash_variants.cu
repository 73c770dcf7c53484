// K7, K8, K9: the online-softmax flash-attention tuning variants, written by
// hand for Hopper (sm_90a), as head_dim-64 instances of the wgmma + TMA cell
// of online_cell.cuh (K4 in bf16 is another, at every head dim).
//
// Replaces three Pallas TPU kernels that run only from the benchmark scripts:
//   K7 scripts/bench_flash_variants.py::_kernel_v2   (flash_v2)
//   K8 scripts/bench_flash_multihead.py::_kernel     (flash_mh)
//   K9 scripts/bench_flash_bisect.py::_kernel        (flash_x)
// All three are the non-causal online softmax over q folded with a scale and
// rounded to bf16, head_dim 64; the cell folds q itself (qscale), the same
// rounding as the JAX wrappers' (q.f32 * scale).bf16. They differ in five
// switches, each a template argument of the cell:
//   exp2 or exp          K9's fold and padfix_exp take exp, the rest exp2;
//   mask every tile, or  K7's mask_last_only=False, K8 and K9's fold / fold2
//   the one that         mask every tile; K7's default masks the tile that
//   crosses kv_end       crosses kv_end (the same function);
//   padfix               K9's padfix modes: nothing below kv_end = seq_pad is
//                        masked; the pad keys [seq, seq_pad) are TMA's zero
//                        fill past the unpadded k and v, score exactly 0, and
//                        the final l drops pad * e(-m);
//   K^T                  K7's kt=True hands K as [BH, 64, k_row], the B
//                        operand of Q K^T in MN-major form;
//   hper heads a CTA     K8: a persistent grid whose CTAs walk (head group,
//                        q tile) items of hper heads in turn, the ring running
//                        on across heads.
// The TPU kernels' block_q and block_k decide only the padding (the wrapper
// keeps the JAX seq_pad arithmetic and hands the cell kv_end and pad) and
// where the mask falls; the cell walks its own 128-column tiles with a
// running max, which moves p's bf16 rounding at the ulp level only. The JAX
// guards l == 0 (K7) and l <= 0 (K8, K9) differ only where l < 0, which only
// padfix reaches, so every instance divides by 1 at l <= 0.
//
// What bounds it on an H100: at (1, 48, 15076, 64) one call is 2.8e12 bf16
// flops (2.8 ms at 989 TFLOP/s) and 1.1e10 exponentials on the SFU (2.6 ms);
// it moves 0.37 GB (0.11 ms). The cell runs the tensor cores and the SFU side
// by side (three consumer warpgroups, TMA ring, P V in flight under the next
// Q K^T), as K4 in bf16 does; the switches add a select a score (every-tile
// mask), an fma a score (exp), or up to 2% more columns (padfix).

#include "online_cell.cuh"

// q, v, out: [BH, sq | skv | sq, 64] bf16, unpadded and contiguous; k the
// same as v, or (k_row > 0) its transpose [BH, 64, k_row] with k_row a
// multiple of 8 at least skv, columns past skv zero. Columns at or past
// kv_end are masked (kv_end = seq for the masking variants; the padded length
// for padfix, mask 2, whose pad > 0 zero keys past skv leave l at the end).
// qscale is folded into q here. use_exp2: exp2 or exp; mask: 0 every tile,
// 1 the tile crossing kv_end, 2 padfix; hper: 0 for one head a CTA on a
// (q tiles, BH) grid, or the heads a CTA walks in turn (K8). Only the switch
// combinations the three wrappers reach are built; the others return
// cudaErrorInvalidValue.
extern "C" int aether_flash_variants(const void* q, const void* k, const void* v, void* out,
                                     int BH, int sq, int skv, int kv_end, int pad, int hper,
                                     int use_exp2, int mask, int k_row, float qscale,
                                     void* stream) {
  using namespace online_cell;
  if (BH <= 0 || BH > 65535 || sq <= 0 || skv <= 0 || kv_end <= 0 || pad < 0 || hper < 0 ||
      (hper > 0 && BH % hper) || mask < kMaskAll || mask > kMaskPadfix ||
      (pad > 0 && mask != kMaskPadfix) || k_row < 0 || (k_row > 0 && (k_row % 8 || k_row < skv)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool kt = k_row > 0;
  CUtensorMap qm, km, vm;
  if (!q_map<64>(&qm, q, BH, sq) ||
      !(kt ? kt_map(&km, k, BH, k_row) : k_map<64>(&km, k, BH, skv)) ||
      !v_map<64>(&vm, v, BH, skv))
    return static_cast<int>(cudaErrorInvalidValue);
  Params prm{};
  prm.out = static_cast<__nv_bfloat16*>(out);
  prm.sq = sq;
  prm.kv_end = kv_end;
  prm.pad = pad;
  prm.qscale = qscale;
  prm.hper = hper;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hper > 0)  // K8
    return use_exp2 && mask == kMaskAll && !kt
               ? launch<64, true, kMaskAll, false, true>(qm, km, vm, prm, BH, st)
               : static_cast<int>(cudaErrorInvalidValue);
  if (use_exp2) {
    if (mask == kMaskTail)  // K7 (also K4's instance), K7 kt
      return kt ? launch<64, true, kMaskTail, true, false>(qm, km, vm, prm, BH, st)
                : launch<64, true, kMaskTail, false, false>(qm, km, vm, prm, BH, st);
    if (mask == kMaskAll)  // K7 mask_last_only=False, K9 fold2
      return kt ? launch<64, true, kMaskAll, true, false>(qm, km, vm, prm, BH, st)
                : launch<64, true, kMaskAll, false, false>(qm, km, vm, prm, BH, st);
    if (!kt)  // K9 padfix
      return launch<64, true, kMaskPadfix, false, false>(qm, km, vm, prm, BH, st);
  } else if (!kt) {
    if (mask == kMaskAll)  // K9 fold
      return launch<64, false, kMaskAll, false, false>(qm, km, vm, prm, BH, st);
    if (mask == kMaskPadfix)  // K9 padfix_exp
      return launch<64, false, kMaskPadfix, false, false>(qm, km, vm, prm, BH, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
