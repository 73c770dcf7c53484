// K2: fixed-max flash attention over the prologue's operands on wgmma with
// TMA, written by hand for Hopper (sm_90a), as the instances <D, int8 or
// bf16 QK^T, per-tile scales> of the cell in fixed_cell.cuh (K3 is its other
// instance), at head_dim D = 16 to 128 in steps of 16; a head dim between
// them runs the next instance up on q, k and v read `cols` columns wide
// (the prologue writes them D wide with zero columns past its head dim).
//
// Replaces aether_tpu/ops/flash_attention.py::_flash_kernel_prepacked (:812,
// the Pallas TPU kernel launched by flash_attention_prepacked), both its
// branches (qk_int8, :845-855), with its noshift. Non-causal attention, in
// the log2 domain:
//   s   = f32(int32(q8 . k8^T)) * (qsc[g, row/block] * ksc[g, col/block])   (int8)
//   s   = f32(q . k^T), bf16 q carrying the fold      (float: AETHER_ATTN_QK8=0)
//   p   = exp2(s - m_g),  m_g = max_t qn[g, t] * max_t kn[g, t]
//         (m_g = 0 under noshift, or under noshift=None when every group's
//         m is below 96)
//   out = sum_j bf16(p_j) v_j / sum_j bf16(p_j)     (denominator <= 0 -> 1)
// Columns >= s_valid are masked out of numerator and denominator alike (the
// TPU kernel did that through zeroed [v | 1] rows; a zero k row alone would
// still give p = 2^-m != 0).
//
// What bounds it on an H100: at the 48-head 15360-token shape with 15076
// valid tokens and D 64 one call is 2.8e12 operations (half int8 QK^T, half
// bf16 PV: 2.12 ms; the float branch, all bf16: 2.82 ms at 989 TFLOP/s) and
// 1.1e10 exp2 (2.61 ms on the SFU at 16 a clock an SM and 1980 MHz): int8 is
// bound by the SFU at 2.61 ms, the float branch by operations at 2.82; at D
// 112 the operations bind, 3.71 ms (int8 QK^T) and 4.94 (float), the SFU
// below D 80. What the design does about it (the cell's note has the whole
// of it, and each head dim's tile plan): wgmma for both products with P
// kept in registers between them, a TMA ring so that no load waits on the
// math, three consumer warpgroups (two above D 64) so the tensor cores and
// the SFU run side by side, one ex2.approx a score and the int8 scores'
// conversion off the conversion unit, and no online max or rescale: the
// shift is fixed. The scale of a 64-row warpgroup and a 128-column kv tile
// is one scalar, because the 1024-token (in general: multiple of 128)
// quantization tile contains both at 128- and 192-row CTAs alike; the shift
// is taken by the producer warp from the [G, T] norm maxima. int8 rows at D
// 16 are 16 bytes, TMA's least row stride, in 32-byte boxes zero-filled past
// D.

#include "fixed_cell.cuh"

// q, k: [BH, s_pad, cols] int8 (qk_int8) or bf16, q carrying the fold; v:
// [BH, s_pad, cols] bf16; their rows ld elements apart (cols <= D <= ld),
// starts and row strides 16-byte aligned; out: [BH, s_pad, D] bf16,
// contiguous; D one of 16, 32, 48, 64, 80, 96, 112, 128. qsc, ksc, qn,
// kn: [BH / hper, n_blocks] f32 over tiles of `block` tokens, a multiple of
// 128 with block * n_blocks = s_pad. 0 <= s_valid <= s_pad. noshift: 0 keep
// the shift, 1 drop it, 2 drop it when every group's bound is below 96.
extern "C" int aether_flash_prepacked(const void* q, const void* k, const void* v,
                                      const void* qsc, const void* ksc,
                                      const void* qn, const void* kn, void* out,
                                      int BH, int s_pad, int s_valid, int hper,
                                      int block, int n_blocks, int qk_int8, int noshift,
                                      int D, int cols, int ld, void* stream) {
  using namespace fixed_cell;
  if (BH <= 0 || BH > 65535 || s_pad <= 0 || s_valid < 0 || s_valid > s_pad || hper <= 0 ||
      BH % hper || block <= 0 || block % kBN || block * n_blocks != s_pad || noshift < kKeep ||
      noshift > kAuto)
    return static_cast<int>(cudaErrorInvalidValue);
  Params prm{};
  prm.out = static_cast<__nv_bfloat16*>(out);
  prm.sq = s_pad;
  prm.kv_len = s_valid;
  prm.hper = hper;
  prm.qsc = static_cast<const float*>(qsc);
  prm.ksc = static_cast<const float*>(ksc);
  prm.qn = static_cast<const float*>(qn);
  prm.kn = static_cast<const float*>(kn);
  prm.block = block;
  prm.n_blocks = n_blocks;
  prm.noshift = noshift;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
#define AETHER_K2_CASE(d)                                                   \
    case d:                                                                 \
      return qk_int8 ? launch<d, true, true>(q, k, v, BH, s_pad, cols, ld, prm, st)   \
                     : launch<d, false, true>(q, k, v, BH, s_pad, cols, ld, prm, st);
    AETHER_K2_CASE(16) AETHER_K2_CASE(32) AETHER_K2_CASE(48) AETHER_K2_CASE(64)
    AETHER_K2_CASE(80) AETHER_K2_CASE(96) AETHER_K2_CASE(112) AETHER_K2_CASE(128)
#undef AETHER_K2_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
