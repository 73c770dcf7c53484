// K4 in f32 at the head dims other than 64: online-softmax flash attention
// for head_dim 16 to 128 in steps of 16 other than 64, written by hand for
// Hopper (sm_90a), as the instances <D, f32, kOnline> of fma_cell.cuh (FMA
// on the CUDA cores).
//
// Replaces aether_tpu/ops/flash_attention.py::_flash_kernel (:69, the Pallas
// TPU kernel launched by flash_attention(fixed_max=False)) in f32 at those
// head dims: the forward of the training path (flash_train), where both
// denominators are one sum (p rounded to f32 v is p). The function is
// flash_online.cu's: non-causal, in the log2 domain, columns >= kv_len scored
// -0.7 * f32max, a running max a row, alpha = exp2(m - m'), p = exp2(s - m'),
// out = acc / l with a zero l dividing by 1. Head_dim 64 keeps
// flash_online.cu; K4 in bf16 is flash_online_bf16.cu's at every head dim.
//
// What bounds it on an H100, at the main path's 48 heads x 15076 tokens: f32
// FMA operations, 0.651 ms x D. The cell's note says what its design does
// about it.

#include "fma_cell.cuh"

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
