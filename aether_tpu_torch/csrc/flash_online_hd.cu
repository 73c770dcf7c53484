// K4 at the head dims other than 64: online-softmax flash attention for
// head_dim 16 to 128 in steps of 16 other than 64, in bf16 and in f32,
// written by hand for Hopper (sm_90a).
//
// Replaces aether_tpu/ops/flash_attention.py::_flash_kernel (:69, the Pallas
// TPU kernel launched by flash_attention(fixed_max=False)) at those head dims:
//   * bf16, the instances <D, bf16, kOnline> of mma_cell.cuh (mma.sync): the
//     DiT's attention at AETHER_ATTN_FIXED_MAX=0, and at head_dim 128 at the
//     default settings, where the JAX wrapper turns the fixed max off and
//     forces the "vpu" denominator (sum of unrounded p); below 128 "mxu"
//     (round_l: sum of p rounded to bf16, the TPU's ones column) or "vpu";
//   * f32, the instances <D, f32, kOnline> of fma_cell.cuh (FMA on the CUDA
//     cores): the forward of the training path (flash_train), where both
//     denominators are one sum.
// The function is flash_online.cu's and flash_online_bf16.cu's: non-causal,
// in the log2 domain, columns >= kv_len scored -0.7 * f32max, a running max
// a row, alpha = exp2(m - m'), p = exp2(s - m'), out = acc / l with a zero
// l dividing by 1. Head_dim 64 keeps those two kernels.
//
// What bounds it on an H100, at the main path's 48 heads x 15076 tokens:
// bf16 by the SFU's 1.1e10 exp2 (2.61 ms) below D 64 and by bf16
// operations above it (4.94 ms at D 112, 5.65 at 128); f32 by FMA
// operations, 0.651 ms x D. The cells' notes say what their designs do
// about it; this is their simple form.

#include "fma_cell.cuh"
#include "mma_cell.cuh"

// q, out: [BH, sq, D] bf16, q not yet folded (the kernel rounds bf16(q *
// fold)); k, v: [BH, skv, D] bf16, rows at or past kv_len zero; all
// contiguous and 16-byte aligned, any lengths; D one of 16, 32, 48, 80, 96,
// 112, 128. round_l: the "mxu" denominator. Returns a cudaError_t.
extern "C" int aether_flash_online_bf16_hd(const void* q, const void* k, const void* v,
                                           void* out, int BH, int sq, int skv, int kv_len,
                                           int round_l, float fold, int D, void* stream) {
  using namespace mma_cell;
  if (BH <= 0 || BH > 65535 || sq <= 0 || skv <= 0 || kv_len < 0 || kv_len > skv)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = q;
  p.k = k;
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.sq = sq;
  p.skv = skv;
  p.kv_len = kv_len;
  p.hper = 1;
  p.fold = fold;
  p.round_l = round_l;
  return launch_dim<false, kOnline>(p, BH, D, static_cast<cudaStream_t>(stream));
}

// q (carrying sm_scale * log2(e)), out: [BH, sq, D] f32; k, v: [BH, skv, D]
// f32, rows at or past kv_len zero; all contiguous and 16-byte aligned, any
// lengths; D one of 16, 32, 48, 80, 96, 112, 128. Returns a cudaError_t.
extern "C" int aether_flash_online_f32_hd(const void* q, const void* k, const void* v,
                                          void* out, int BH, int sq, int skv, int kv_len, int D,
                                          void* stream) {
  using namespace fma_cell;
  if (BH <= 0 || BH > 65535 || sq <= 0 || skv <= 0 || kv_len < 0 || kv_len > skv)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = q;
  p.k = k;
  p.v = static_cast<const float*>(v);
  p.out = static_cast<float*>(out);
  p.sq = sq;
  p.skv = skv;
  p.kv_len = kv_len;
  p.hper = 1;
  return launch_dim<false, kOnline, 128>(p, BH, D, static_cast<cudaStream_t>(stream));
}
