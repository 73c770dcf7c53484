// K3: fixed-shift flash attention on wgmma with TMA, written by hand for
// Hopper (sm_90a), as the instances <D, int8 or bf16 QK^T, one scale a
// group> of the cell in fixed_cell.cuh (K2 is its other instance), at head
// dims 16 to 128 in steps of 16 with bf16 v; a head dim between them runs
// the next instance up on operands its wrapper pads with zero columns.
//
// Replaces aether_tpu/ops/flash_attention.py::_flash_kernel_fixed_max (:151,
// the Pallas TPU kernel launched by flash_attention(fixed_max=True)): the
// attention of the unfused DiT path (AETHER_ATTN_FUSED=0) and the per-stripe
// cell of the ring merge (unnormalized, with a shared score bound).
// Non-causal, in the log2 domain, one shift and one scale per head group g
// (the wrapper computes both over the whole sequence, as the JAX wrapper
// does):
//   s   = f32(int32(q8 . k8^T)) * scale_g           (int8 q/k)
//   s   = f32(q . k^T), q carrying sm_scale*log2e   (bf16 q/k)
//   p   = exp2(s - shift_g), 0 at columns >= kv_len
//   out = sum_j bf16(p_j) v_j / sum_j bf16(p_j)     (denominator <= 0 -> 1)
//   unnormalized: out = bf16(sum_j bf16(p_j) v_j) and l = sum_j bf16(p_j)
// The TPU kernel excluded padded and kv_valid-tail columns through zeroed
// [v | 1 | 0] rows; a zero k row alone would still give p = 2^-shift != 0,
// so the cell masks the columns instead. Sq may differ from Skv (a
// sequence-parallel q stripe against the full K/V). K3 in f32 is
// flash_fixed_max_hd.cu's.
//
// What bounds it on an H100: at the CFG pair's 2 x 48 heads x 15076 tokens
// and D 64 one call is 5.6e12 operations (int8 QK^T and bf16 PV: 4.2 ms;
// both bf16: 5.65 ms at 989 TFLOP/s) and 2.2e10 exp2 (5.22 ms on the SFU at
// 16 a clock an SM and 1980 MHz), so int8 is bound by the SFU at 5.22 ms
// and bf16 by operations at 5.65; at batch 1 the SFU's 2.61 ms binds below
// D 80 and the operations above (D 112: 3.71 ms int8 QK^T, 4.94 bf16). What
// the design does about it (the cell's note has the whole of it, and each
// head dim's tile plan): wgmma for both products with P kept in registers
// between them, a TMA ring so that no load waits on the math, three
// consumer warpgroups (two above D 64) so the tensor cores and the SFU run
// side by side, one ex2.approx a score and the int8 scores' conversion off
// the conversion unit, and no online max or rescale: the shift is fixed.
// Rows past sq or skv and columns past D are TMA's zero fill; the wrapper
// pads nothing.

#include "fixed_cell.cuh"

// q, k: [BH, sq | skv, D] int8 (qk_int8) or bf16 carrying the fold; v:
// [BH, skv, D] bf16, rows at or past kv_len zero (any finite values do);
// all contiguous and 16-byte aligned, any lengths; D one of 16, 32, 48, 64,
// 80, 96, 112, 128. shift, scale: [G = BH / hper] f32; out: [BH, sq, D] bf16;
// l_out: [BH, sq] f32 or null (normalized). 0 <= kv_len <= skv. Returns a
// cudaError_t.
extern "C" int aether_flash_fixed_max(const void* q, const void* k, const void* v,
                                      const void* shift, const void* scale, void* out,
                                      void* l_out, int BH, int sq, int skv, int kv_len,
                                      int hper, int qk_int8, int D, void* stream) {
  using namespace fixed_cell;
  if (BH <= 0 || BH > 65535 || sq <= 0 || skv <= 0 || kv_len < 0 || kv_len > skv ||
      hper <= 0 || BH % hper)
    return static_cast<int>(cudaErrorInvalidValue);
  Params prm{};
  prm.out = static_cast<__nv_bfloat16*>(out);
  prm.l = static_cast<float*>(l_out);
  prm.sq = sq;
  prm.kv_len = kv_len;
  prm.hper = hper;
  prm.shift = static_cast<const float*>(shift);
  prm.scale = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
#define AETHER_K3_CASE(d)                                                   \
    case d:                                                                 \
      return qk_int8 ? launch<d, true, false>(q, k, v, BH, skv, d, d, prm, st)  \
                     : launch<d, false, false>(q, k, v, BH, skv, d, d, prm, st);
    AETHER_K3_CASE(16) AETHER_K3_CASE(32) AETHER_K3_CASE(48) AETHER_K3_CASE(64)
    AETHER_K3_CASE(80) AETHER_K3_CASE(96) AETHER_K3_CASE(112) AETHER_K3_CASE(128)
#undef AETHER_K3_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
