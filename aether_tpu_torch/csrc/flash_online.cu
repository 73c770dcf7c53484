// K4 in f32: online-softmax flash attention on the tensor cores as split
// TF32 (3xTF32) wgmma with TMA, written by hand for Hopper (sm_90a), at
// head_dim D = 16 to 128 in steps of 16, the instances <D, f32 q/k, kOnline>
// of tf32x3_cell.cuh's cell_kernel; above 128 csrc/flash_online_wide.cu (a
// pair of CTAs a q tile up to 256). The bf16 form is csrc/flash_online_bf16.cu.
//
// Replaces aether_tpu/ops/flash_attention.py::_flash_kernel (:69, the Pallas
// TPU kernel launched by flash_attention(fixed_max=False)) for f32 q/k/v:
// the forward of the training path (flash_train), at head_dim 64 and, at
// the other head dims, in the tiny trainer and the f32 DiTs (above 128 the
// JAX wrapper's "vpu" route, the only one it takes there). Non-causal, in
// the log2 domain, q pre-scaled by sm_scale * log2(e) in the wrapper:
//   s   = q . k^T                              (3xTF32 products, f32 sums)
//   s   = -0.7 * f32max  where column >= kv_len
//   m'  = max(m, rowmax s),  alpha = exp2(m - m'),  p = exp2(s - m')
//   acc = alpha * acc + p . v                  (3xTF32)
//   l   = alpha * l + sum p
//   out = acc / l, a zero l divides by 1
// (p rounded to v's dtype is p itself in f32, so both of the TPU kernel's
// denominators are the same sum here.) The kernel computes the TPU kernel's
// function up to the order of sums, the kv tiling (64 or 32 columns here,
// 1024 there) and the split products' last bits (about 2^-22 of a product).
//
// What bounds it on an H100: at the training shape (48 heads x 15076
// tokens) one call is 4 * 48 * 15076^2 * D flops of f32-accurate products,
// three TF32 products each: 0.2645 ms x D at 495 TFLOP/s (16.93 ms at D 64,
// 33.85 at 128), and 1.1e10 exp2 (2.61 ms on the SFU). The
// FMA units that this kernel used before (one f32 product, 67 TFLOP/s)
// could not go below 0.651 ms x D. What the design does about it is the
// cell's note: both products on wgmma with p kept in registers between
// them, a TMA ring of K_hi, K_lo, V^T_hi and V^T_lo tiles, two consumer
// warpgroups beside a producer warpgroup, no padding in device memory.

#include "tf32x3_cell.cuh"

// q_hi, q_lo (q carrying sm_scale * log2(e), split), out: [BH, sq, D] f32;
// k_hi, k_lo: [BH, skv, D] f32, rows at or past kv_len zero; vt_hi, vt_lo:
// [BH, D, skv rounded up to 8] f32, v transposed, split and kv-permuted
// (ops/flash_attention.py::_tf32_operands); all contiguous and 16-byte
// aligned, any lengths; D one of 16, 32, 48, 64, 80, 96, 112, 128. Returns
// a cudaError_t.
extern "C" int aether_flash_online(const void* q_hi, const void* q_lo, const void* k_hi,
                                   const void* k_lo, const void* vt_hi, const void* vt_lo,
                                   void* out, int BH, int sq, int skv, int kv_len, int D,
                                   void* stream) {
  using namespace tf32x3_cell;
  if (BH <= 0 || BH > 65535 || sq <= 0 || skv <= 0 || kv_len < 0 || kv_len > skv)
    return static_cast<int>(cudaErrorInvalidValue);
  Params prm{};
  prm.q_lo = static_cast<const float*>(q_lo);
  prm.out = static_cast<float*>(out);
  prm.sq = sq;
  prm.kv_len = kv_len;
  prm.hper = 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
#define AETHER_K4_CASE(d) \
    case d: return launch<d, false, kOnline>(q_hi, k_hi, k_lo, vt_hi, vt_lo, BH, skv, prm, st);
    AETHER_K4_CASE(16) AETHER_K4_CASE(32) AETHER_K4_CASE(48) AETHER_K4_CASE(64)
    AETHER_K4_CASE(80) AETHER_K4_CASE(96) AETHER_K4_CASE(112) AETHER_K4_CASE(128)
#undef AETHER_K4_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
