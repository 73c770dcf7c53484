// K2 at the head dims other than 64: fixed-max flash attention over the
// prologue's operands for head_dim 16, 32, 48, 80, 96 and 112, written by
// hand for Hopper (sm_90a) on mma.sync, as the instances <D, int8 or bf16
// QK^T, kPrepacked> of the cell in mma_cell.cuh (K4 bf16 at these head
// dims is its other instance).
//
// Replaces aether_tpu/ops/flash_attention.py::_flash_kernel_prepacked (:812)
// at those head dims, both its branches (qk_int8, :845-855), with its noshift.
// The function is flash_prepacked.cu's (non-causal, in the log2 domain):
//   s   = f32(int32(q8 . k8^T)) * (qsc[g, row/block] * ksc[g, col/block])   (int8)
//   s   = f32(q . k^T), bf16 q carrying the fold      (float: AETHER_ATTN_QK8=0)
//   p   = exp2(s - m_g),  m_g = max_t qn[g, t] * max_t kn[g, t]
//         (m_g = 0 under noshift, or under noshift=None when every group's
//         m is below 96)
//   out = sum_j bf16(p_j) v_j / sum_j bf16(p_j)     (denominator <= 0 -> 1)
// with columns >= s_valid masked out of numerator and denominator alike.
//
// What bounds it on an H100 and what the design does about it: the cell's
// note (mma_cell.cuh). This is the simple form; head_dim 64, the shipped
// models' width, keeps the wgmma + TMA cell of fixed_cell.cuh. The shift
// is fixed, so there is no running max: each warp takes it from the [G, T]
// norm maxima at the start.

#include "mma_cell.cuh"

// q, k: [BH, s_pad, D] int8 (qk_int8) or bf16, q carrying the fold; v, out:
// [BH, s_pad, D] bf16; all contiguous and 16-byte aligned; D one of 16, 32,
// 48, 80, 96, 112. qsc, ksc, qn, kn: [BH / hper, n_blocks] f32 over tiles of
// `block` tokens, a multiple of 128 with block * n_blocks = s_pad.
// 0 < s_valid <= s_pad. noshift: 0 keep the shift, 1 drop it, 2 drop it
// when every group's bound is below 96. Returns a cudaError_t.
extern "C" int aether_flash_prepacked_hd(const void* q, const void* k, const void* v,
                                         const void* qsc, const void* ksc, const void* qn,
                                         const void* kn, void* out, int BH, int s_pad,
                                         int s_valid, int hper, int block, int n_blocks,
                                         int qk_int8, int noshift, int D, void* stream) {
  using namespace mma_cell;
  if (BH <= 0 || BH > 65535 || s_pad <= 0 || s_valid <= 0 || s_valid > s_pad || hper <= 0 ||
      BH % hper || block <= 0 || block % 128 || block * n_blocks != s_pad || noshift < kKeep ||
      noshift > kAuto)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.q = q;
  p.k = k;
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.qsc = static_cast<const float*>(qsc);
  p.ksc = static_cast<const float*>(ksc);
  p.qn = static_cast<const float*>(qn);
  p.kn = static_cast<const float*>(kn);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.sq = p.skv = s_pad;
  p.kv_len = s_valid;
  p.hper = hper;
  p.block = block;
  p.n_tiles = n_blocks;
  p.groups = BH / hper;
  p.noshift = noshift;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return qk_int8 ? launch_dim<true, kPrepacked>(p, BH, D, st)
                 : launch_dim<false, kPrepacked>(p, BH, D, st);
}
