// K4 in bf16: online-softmax flash attention on wgmma with TMA, written by
// hand for Hopper (sm_90a).
//
// Replaces the bf16 form of aether_tpu/ops/flash_attention.py::_flash_kernel
// (the Pallas TPU kernel launched by flash_attention(fixed_max=False)): the
// DiT's attention at AETHER_ATTN_FIXED_MAX=0 and the bench entry points'
// baseline. csrc/flash_online.cu keeps the f32 form (training). Non-causal,
// head_dim 64, in the log2 domain:
//   q   = bf16(q * c),  c = sm_scale * log2(e)     (here, in shared memory)
//   s   = q . k^T                                  (f32 sums of bf16 products)
//   s   = -0.7 * f32max  where column >= kv_len
//   m'  = max(m, rowmax s),  alpha = exp2(m - m'),  p = exp2(s - m')
//   acc = alpha * acc + bf16(p) . v
//   l   = alpha * l + sum bf16(p)   (round_l: the TPU's ones column of the PV
//                                    matmul summed p rounded to bf16)
//       = alpha * l + sum p         (!round_l: the TPU's separate l)
//   out = bf16(acc / l), a zero l divides by 1
// bf16 products are exact in f32, so this is the TPU kernel's function up to
// the order of sums and the kv tiling (128 columns here, 1024 there), which
// moves the running max and with it the rounding of p.
//
// What bounds it on an H100: at (1, 48 heads, 15076 tokens, 64) one call is
// 2.8e12 bf16 flops (2.8 ms at 989 TFLOP/s) and 1.1e10 exp2 on the SFU (16
// a clock an SM: 2.6 ms at 1.98 GHz); both sit near 2.8 ms, so the tensor
// cores and the SFU have to run side by side. K and V also come from L2 once
// per CTA: 48 x 15076 x 256 bytes per 192 q rows, about 14 GB a call. The
// design is the cell of online_cell.cuh (FlashAttention-3's shape at
// head_dim 64), in its instance <exp2, tail mask, K rows, one head a CTA>:
//   * a CTA takes 192 q rows: three consumer warpgroups of 64 rows each and
//     one producer warp; grid (q tiles, B*H). Three warpgroups rather than
//     two cut the L2 traffic by a third and give each scheduler three warps
//     to interleave;
//   * the producer keeps K and V tiles of 128 kv rows in a ring of
//     shared-memory slots by TMA, so loads run ahead of the math; rows past
//     the sequence arrive as zeros, so the wrapper pads nothing;
//   * Q K^T and P V on wgmma, P from the S accumulator in registers, a
//     tile's P V in flight while the next Q K^T issues; while one warpgroup
//     runs its softmax (SFU) the others' wgmma run;
//   * p = exp2_ftz (one SFU instruction); tiles wholly past kv_len are
//     skipped and only the last is masked.

#include "online_cell.cuh"

// q, out: [BH, sq, 64] bf16; k, v: [BH, skv, 64] bf16; all contiguous and
// 16-byte aligned, rows of k and v at or past kv_len finite (the wrapper
// zeroes them). qscale: the sm_scale * log2(e) fold, applied here as
// bf16(q * qscale). No padding: TMA reads rows past the ends as zeros and
// rows past sq are not written.
extern "C" int aether_flash_online_bf16(const void* q, const void* k, const void* v, void* out,
                                        int BH, int sq, int skv, int kv_len, int round_l,
                                        float qscale, void* stream) {
  using namespace online_cell;
  if (BH <= 0 || sq <= 0 || skv <= 0 || kv_len < 0 || kv_len > skv || BH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qmap, kmap, vmap;
  if (!q_map(&qmap, q, BH, sq) || !kv_map(&kmap, k, BH, skv) || !kv_map(&vmap, v, BH, skv))
    return static_cast<int>(cudaErrorInvalidValue);
  Params prm{};
  prm.out = static_cast<__nv_bfloat16*>(out);
  prm.sq = sq;
  prm.kv_end = kv_len;
  prm.round_l = round_l;
  prm.qscale = qscale;
  return launch<true, kMaskTail, false, false>(qmap, kmap, vmap, prm, BH,
                                                static_cast<cudaStream_t>(stream));
}
