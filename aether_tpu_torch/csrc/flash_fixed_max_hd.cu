// K3 in f32: fixed-shift flash attention with f32 v on the tensor cores as
// split TF32 (3xTF32) wgmma with TMA, written by hand for Hopper (sm_90a):
// the instances <D, int8 or f32 q/k, kFixed> of tf32x3_cell.cuh.
//
// Replaces aether_tpu/ops/flash_attention.py::_flash_kernel_fixed_max (:151,
// the Pallas TPU kernel launched by flash_attention(fixed_max=True)) where v
// is f32, at every head dim the JAX kernel takes below 128, 64 included (an
// f32 pipeline's request, DiT.forward(fixed_max=True, fused_qkv=False) in
// f32, and its ring merge; instances at 16 to 128 in steps of 16, a head dim
// between them running the next one up on operands its wrapper pads with
// zero columns): P V in 3xTF32, as the TPU kernel keeps p in v's
// dtype, and QK^T in 3xTF32 (f32 q/k) or as one exact s8 product of the
// codes (qk_int8). K3 with bf16 v is flash_fixed_max.cu's. Non-causal, in
// the log2 domain, one shift and one scale per head group g (the wrapper
// computes both over the whole sequence, as the JAX wrapper does):
//   s   = f32(int32(q8 . k8^T)) * scale_g           (int8 q/k)
//   s   = q . k^T, q carrying sm_scale*log2e        (f32 q/k)
//   p   = exp2(s - shift_g), 0 at columns >= kv_len
//   out = sum_j p_j v_j / sum_j p_j                 (a denominator <= 0
//         divides by 1)
//   unnormalized: out = sum_j p_j v_j, l = sum_j p_j
// Sq may differ from Skv (a sequence-parallel q stripe against the full
// K/V); rows past either length load as zeros.
//
// What bounds it on an H100, at the main path's 48 heads x 15076 tokens:
// the split products on the tensor cores, 0.2645 ms x D with f32 q/k (16.93
// ms at 64) and 0.1323 ms x D plus the s8 product's 0.0111 ms x D with int8
// q/k, against the SFU's 2.61 ms of exp2. The cell's note says what its
// design does about it.

#include "tf32x3_cell.cuh"

// q_hi, q_lo, k_hi, k_lo: [BH, sq | skv, D] f32, q carrying the fold, split
// (qk_int8: the int8 codes in q_hi and k_hi, q_lo and k_lo unused); vt_hi,
// vt_lo: [BH, D, skv rounded up to 8] f32, v transposed, split and
// kv-permuted (ops/flash_attention.py::_tf32_operands); rows of k and v at
// or past kv_len zero; all contiguous and 16-byte aligned, any lengths; D one
// of 16, 32, 48, 64, 80, 96, 112, 128. shift, scale: [G = BH / hper] f32; out
// [BH, sq, D] f32; l_out: [BH, sq] f32 or null (normalized). 0 <= kv_len <=
// skv. Returns a cudaError_t.
extern "C" int aether_flash_fixed_max_f32(const void* q_hi, const void* q_lo, const void* k_hi,
                                          const void* k_lo, const void* vt_hi,
                                          const void* vt_lo, const void* shift,
                                          const void* scale, void* out, void* l_out, int BH,
                                          int sq, int skv, int kv_len, int hper, int qk_int8,
                                          int D, void* stream) {
  using namespace tf32x3_cell;
  if (BH <= 0 || BH > 65535 || sq <= 0 || skv <= 0 || kv_len < 0 || kv_len > skv ||
      hper <= 0 || BH % hper)
    return static_cast<int>(cudaErrorInvalidValue);
  Params prm{};
  prm.q_lo = static_cast<const float*>(q_lo);
  prm.out = static_cast<float*>(out);
  prm.l = static_cast<float*>(l_out);
  prm.shift = static_cast<const float*>(shift);
  prm.scale = static_cast<const float*>(scale);
  prm.sq = sq;
  prm.kv_len = kv_len;
  prm.hper = hper;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
#define AETHER_K3_CASE(d)                                                               \
    case d:                                                                             \
      return qk_int8                                                                    \
                 ? launch<d, true, kFixed>(q_hi, k_hi, k_lo, vt_hi, vt_lo, BH, skv, prm, st) \
                 : launch<d, false, kFixed>(q_hi, k_hi, k_lo, vt_hi, vt_lo, BH, skv, prm, st);
    AETHER_K3_CASE(16) AETHER_K3_CASE(32) AETHER_K3_CASE(48) AETHER_K3_CASE(64)
    AETHER_K3_CASE(80) AETHER_K3_CASE(96) AETHER_K3_CASE(112) AETHER_K3_CASE(128)
#undef AETHER_K3_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
