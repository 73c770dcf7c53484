// K4 in bf16: online-softmax flash attention on wgmma with TMA, written by
// hand for Hopper (sm_90a), at head_dim D = 16 to 128 in steps of 16 and 160
// to 256 in steps of 32 (one instance a head dim).
//
// Replaces the bf16 form of aether_tpu/ops/flash_attention.py::_flash_kernel
// (:69, the Pallas TPU kernel launched by flash_attention(fixed_max=False)):
// the DiT's attention at AETHER_ATTN_FIXED_MAX=0, at head_dim 128 and above
// at the default settings (the JAX wrapper turns the fixed max off there and
// forces the "vpu" denominator), and the bench entry points' baseline.
// csrc/flash_online.cu (tf32x3_cell.cuh's 3xTF32 instances) is the f32 form
// (training). Non-causal, in the log2 domain:
//   q   = bf16(q * c),  c = sm_scale * log2(e)     (here, in shared memory)
//   s   = q . k^T                                  (f32 sums of bf16 products)
//   s   = -0.7 * f32max  where column >= kv_len
//   m'  = max(m, rowmax s),  alpha = exp2(m - m'),  p = exp2(s - m')
//   acc = alpha * acc + bf16(p) . v
//   l   = alpha * l + sum bf16(p)   (round_l, "mxu": the TPU's ones column of
//                                    the PV matmul summed p rounded to bf16)
//       = alpha * l + sum p         (!round_l, "vpu": the TPU's separate l)
//   out = bf16(acc / l), a zero l divides by 1
// bf16 products are exact in f32, so this is the TPU kernel's function up to
// the order of sums and the kv tiling (128 columns here, 64 above D 128,
// 1024 there), which moves the running max and with it the rounding of p.
//
// What bounds it on an H100: at (1, 48 heads, 15076 tokens, D) one call is
// 4.4e10 x D bf16 flops (2.8 ms at D 64, 4.94 at 112, 5.65 at 128 and 11.3
// at 256 on the 989-TFLOP/s tensor cores) and 1.1e10 exp2 on the SFU (16 a
// clock an SM: 2.61 ms at 1.98 GHz): the SFU binds below D 80, the products
// above, and near D 64 both sit close, so the tensor cores and the SFU have
// to run side by side. K and V also come from L2 once per CTA: 48 x 15076 x
// 4 D bytes per 64 kWG q rows, 14 GB a call at D 64, 44 GB at 128 and 87 GB
// at 256. The design is the cell of online_cell.cuh in its instance <D,
// exp2, tail mask, K rows, one head a CTA> (its note has the tile plan of
// each D):
//   * a CTA takes 64 x kWG q rows: kWG consumer warpgroups of 64 rows each
//     (3 up to D 64, which cuts the L2 traffic by a third against two; 2
//     above, for registers) and a producer warp, or above D 64 a producer
//     warpgroup that hands its registers to the consumers; grid (q tiles,
//     B*H);
//   * the producer keeps K and V tiles of 128 kv rows (64 above D 128) in a
//     ring of shared-memory slots by TMA, so loads run ahead of the math;
//     rows past the sequence and columns past D arrive as zeros, so the
//     wrapper pads nothing;
//   * Q K^T and P V on wgmma, P from the S accumulator in registers, a
//     tile's P V in flight while the next Q K^T issues; while one warpgroup
//     runs its softmax (SFU) the others' wgmma run;
//   * p = exp2_ftz (one SFU instruction); tiles wholly past kv_len are
//     skipped and only the last is masked.

#include "online_cell.cuh"

namespace {

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, online_cell::Params prm, int BH,
                int skv, cudaStream_t stream) {
  using namespace online_cell;
  CUtensorMap qmap, kmap, vmap;
  if (!q_map<D>(&qmap, q, BH, prm.sq) || !k_map<D>(&kmap, k, BH, skv) ||
      !v_map<D>(&vmap, v, BH, skv))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<D, true, kMaskTail, false, false>(qmap, kmap, vmap, prm, BH, stream);
}

}  // namespace

// q, out: [BH, sq, D] bf16; k, v: [BH, skv, D] bf16; all contiguous and
// 16-byte aligned, rows of k and v at or past kv_len finite (the wrapper
// zeroes them); D one of 16, 32, 48, 64, 80, 96, 112, 128, 160, 192, 224,
// 256. round_l: the "mxu" denominator. qscale: the sm_scale * log2(e) fold,
// applied here as bf16(q * qscale). No padding: TMA reads rows past the ends as zeros and
// rows past sq are not written. Returns a cudaError_t.
extern "C" int aether_flash_online_bf16(const void* q, const void* k, const void* v, void* out,
                                        int BH, int sq, int skv, int kv_len, int round_l,
                                        float qscale, int D, void* stream) {
  using namespace online_cell;
  if (BH <= 0 || sq <= 0 || skv <= 0 || kv_len < 0 || kv_len > skv || BH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params prm{};
  prm.out = static_cast<__nv_bfloat16*>(out);
  prm.sq = sq;
  prm.kv_end = kv_len;
  prm.round_l = round_l;
  prm.qscale = qscale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
#define AETHER_K4_CASE(d) \
    case d: return launch_bf16<d>(q, k, v, prm, BH, skv, st);
    AETHER_K4_CASE(16) AETHER_K4_CASE(32) AETHER_K4_CASE(48) AETHER_K4_CASE(64)
    AETHER_K4_CASE(80) AETHER_K4_CASE(96) AETHER_K4_CASE(112) AETHER_K4_CASE(128)
    AETHER_K4_CASE(160) AETHER_K4_CASE(192) AETHER_K4_CASE(224) AETHER_K4_CASE(256)
#undef AETHER_K4_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
