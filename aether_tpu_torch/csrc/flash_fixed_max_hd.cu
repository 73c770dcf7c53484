// K3 in f32: fixed-shift flash attention with f32 q/k/v, written by hand for
// Hopper (sm_90a).
//
// Replaces aether_tpu/ops/flash_attention.py::_flash_kernel_fixed_max (:151,
// the Pallas TPU kernel launched by flash_attention(fixed_max=True)) where v
// is f32, at every head dim the JAX kernel takes below 128, 64 included (an
// f32 pipeline's request, DiT.forward(fixed_max=True, fused_qkv=False) in
// f32): the instances <D, int8 or f32 q/k, kFixed> of fma_cell.cuh, both
// products in f32 on the FMA units, as the TPU kernel keeps p in v's dtype.
// K3 with bf16 v is flash_fixed_max.cu's (the wgmma + TMA cell). Non-causal,
// in the log2 domain, one shift and one scale per head group g (the wrapper
// computes both over the whole sequence, as the JAX wrapper does):
//   s   = f32(int32(q8 . k8^T)) * scale_g           (int8 q/k)
//   s   = q . k^T, q carrying sm_scale*log2e        (f32 q/k)
//   p   = exp2(s - shift_g), 0 at columns >= kv_len
//   out = sum_j p_j v_j / sum_j p_j                 (a denominator <= 0
//         divides by 1)
//   unnormalized: out = sum_j p_j v_j, l = sum_j p_j
// Sq may differ from Skv (a sequence-parallel q stripe against the full
// K/V); rows past either length load as zeros, so the wrapper pads nothing.
//
// What bounds it on an H100, at the main path's 48 heads x 15076 tokens:
// FMA operations, 0.651 ms x D (41.7 ms at 64). The cell's note says what
// its design does about it; this is its simple form.

#include "fma_cell.cuh"

// q, k [BH, sq | skv, D] int8 (qk_int8) or f32 carrying the fold; v [BH,
// skv, D] f32, rows at or past kv_len zero; all contiguous and 16-byte
// aligned, any lengths; D one of 16, 32, 48, 64, 80, 96, 112. shift, scale:
// [G = BH / hper] f32; out [BH, sq, D] f32; l_out: [BH, sq] f32 or null
// (normalized). 0 <= kv_len <= skv. Returns a cudaError_t.
extern "C" int aether_flash_fixed_max_f32(const void* q, const void* k, const void* v,
                                          const void* shift, const void* scale, void* out,
                                          void* l_out, int BH, int sq, int skv, int kv_len,
                                          int hper, int qk_int8, int D, void* stream) {
  using namespace fma_cell;
  if (BH <= 0 || BH > 65535 || sq <= 0 || skv <= 0 || kv_len < 0 || kv_len > skv ||
      hper <= 0 || BH % hper)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = q;
  p.k = k;
  p.v = static_cast<const float*>(v);
  p.out = static_cast<float*>(out);
  p.l = static_cast<float*>(l_out);
  p.shift = static_cast<const float*>(shift);
  p.scale = static_cast<const float*>(scale);
  p.sq = sq;
  p.skv = skv;
  p.kv_len = kv_len;
  p.hper = hper;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return qk_int8 ? launch_dim<true, kFixed, 112>(p, BH, D, st)
                 : launch_dim<false, kFixed, 112>(p, BH, D, st);
}
