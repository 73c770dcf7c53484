// K4 in f32 above head_dim 256: online-softmax flash attention on the
// tensor cores as split TF32 (3xTF32) wgmma with TMA, written by hand for
// Hopper (sm_90a), one kernel for every head dim, the width dp (the head dim
// rounded up to a multiple of 64 by the wrapper, zero columns past it) a
// run-time argument. flash_online.cu (tf32x3_cell.cuh) runs the head dims
// up to 256; flash_online_wide_bf16.cu is the bf16 form of this kernel.
//
// Replaces aether_tpu/ops/flash_attention.py::_flash_kernel (:69, the
// Pallas TPU kernel launched by flash_attention(fixed_max=False)) for f32
// q/k/v at head_dim > 256 (the JAX wrapper's "vpu" route, :538-548, no upper
// limit): the training forward (flash_train) and the f32 DiT at such head
// dims. Non-causal, in the log2 domain, q pre-scaled by sm_scale * log2(e)
// in the wrapper, as tf32x3_cell.cuh's kOnline:
//   s   = q . k^T                              (3xTF32 products, f32 sums)
//   s   = -0.7 * f32max  where column >= kv_len
//   m'  = max(m, rowmax s),  alpha = exp2(m - m'),  p = exp2(s - m')
//   acc = alpha * acc + p . v                  (3xTF32; acc on the FMA units)
//   l   = alpha * l + sum p
//   out = acc / l, a zero l divides by 1
// The products are tf32x3_cell.cuh's (its note): every f32 operand split
// into x_hi = tf32(x) and x_lo = tf32(x - x_hi) by the wrapper (q, k, v^T)
// or here (p), and hi.hi + hi.lo + lo.hi kept, about 2^-22 of a product
// from f32; each tile's P V starts in fresh registers on the tensor core and
// the output takes it in on the FMA units, o = alpha o + P V (the loss of
// the tensor cores' accumulation grows with every addition).
//
// What bounds it on an H100: at (1, 48 heads, 15076 tokens, D) one call is
// three TF32 products of 4.4e10 x D flops, 0.2645 ms x D at 495 TFLOP/s
// (84.6 ms at 320, 135.4 at 512). tf32x3_cell.cuh's plans stop at 256:
// Q_hi of 64 rows is 64 KB there and Q_lo a register fragment of D / 4 a
// thread. The design here takes every D with one tile plan:
//   * the grid is (q tiles of 128 rows, output column blocks of kC = 128,
//     B*H); a CTA has two consumer warpgroups of 64 q rows and a producer
//     warpgroup that hands its registers to them (setmaxnreg: 24 / 240);
//   * S = Q K^T of a 64-row kv tile streams the head dim through shared
//     memory: the producer brings Q_hi, Q_lo, K_hi and K_lo in panels of 32
//     columns (128-byte rows, 128-byte swizzle) into a ring of kQKStages
//     slots by TMA; a panel is four k8 steps of three wgmma m64n64k8 tf32,
//     all operands from shared memory, one panel in flight while the next
//     is waited for. The tensor cores sum kFold panels (128 columns, as many
//     products as the cell's at 128) into fresh registers and S takes each
//     group in on the FMA units: kept on the tensor-core accumulator over the
//     whole head dim, S lost accuracy with D (the first form read a max error
//     of 2.7e-6 at 512 over 15076 keys against the plain version, 1.0e-6 at
//     320; PERF.md section 6);
//   * P stays in registers, split into P_hi and P_lo as the A operands of P
//     V (tf32x3_cell.cuh's kv order of V^T: no shuffle); V^T holds only this
//     CTA's kC rows (two 32-column kv panels of kC 128-byte rows a tile, one
//     slot), in two chains of 64 output columns, each waited for and folded
//     into the output in turn (tf32x3_cell.cuh's <128> plan, its second
//     chain not carried across the next tile's S, where S's sum needs the
//     registers);
//   * a consumer thread holds the kC / 2 = 64 f32 of its output, 32 of S's
//     sum and 32 of a group's, and between S and P V 32 of a chain's P V
//     and 64 of P_hi and P_lo, whatever D is; kC is 128, not 256, because
//     the output twice as wide would not fit in its 240 registers beside S
//     and P;
//   * rows past the tensors' ends and V^T rows past dp arrive as zeros
//     (TMA), stores past sq or dp are dropped, tiles wholly past kv_len are
//     skipped and only the last is masked.
// Each column block computes S again: the work is dp / kC times S plus P V,
// 2.5x the function's at 512 and at 320 (three blocks, the last half used).
// Q_hi and Q_lo are read from L2 once a kv tile, twice K's bytes.
// Compiled without --use_fast_math so exp2f and the division stay accurate.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3_cell.cuh"

namespace {
namespace wide_f32 {

using namespace hopper;
using tf32x3_cell::fold;
using tf32x3_cell::kNegInf;
using tf32x3_cell::pv;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBM = 128;     // q rows a CTA: two consumer warpgroups of 64
constexpr int kBN = 64;      // kv rows a tile
constexpr int kPanel = 32;   // head-dim columns of a Q or K panel (128 bytes)
constexpr int kC = 128;      // output columns a CTA
constexpr int kPV = 64;      // output columns of one P V chain
constexpr int kFold = 4;     // Q K^T panels the tensor cores sum before S takes them in
constexpr int kConsumers = 256, kThreads = kConsumers + 128;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
static_assert(128 * kProducerRegs + kConsumers * kConsumerRegs <=
                  kThreads * ((65536 / kThreads) & ~7),
              "setmaxnreg asks for more registers than the CTA starts with");
constexpr int kQPanel = kBM * 128;      // bytes of a Q_hi or Q_lo panel
constexpr int kKPanel = kBN * 128;      // of a K_hi or K_lo panel
constexpr int kVPanel = kC * 128;       // of 32 kv columns of V^T_hi or V^T_lo
constexpr int kVTile = kBN / 32 * kVPanel;
constexpr int kQKStages = 3, kVStages = 1;

struct Smem {
  uint8_t q[kQKStages][2][kQPanel];  // Q_hi, Q_lo
  uint8_t k[kQKStages][2][kKPanel];  // K_hi, K_lo
  uint8_t v[kVStages][2][kVTile];    // V^T_hi, V^T_lo
  Ring<kQKStages> qk;
  Ring<kVStages> vr;
};
// + 1024 so the tiles can start on a 1024-byte boundary
constexpr int kSmem = sizeof(Smem) + 1024;
static_assert(kSmem <= 232448, "the rings must fit in the 227 KB a block may take");

struct Params {
  float* out;          // [BH, sq, dp]
  int sq, kv_len, dp;  // dp: the width, a multiple of 64
};

__global__ void __launch_bounds__(kThreads, 1)
wide_kernel(const __grid_constant__ CUtensorMap qhi_map, const __grid_constant__ CUtensorMap qlo_map,
            const __grid_constant__ CUtensorMap khi_map, const __grid_constant__ CUtensorMap klo_map,
            const __grid_constant__ CUtensorMap vhi_map, const __grid_constant__ CUtensorMap vlo_map,
            const Params prm) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int q0 = blockIdx.x * kBM, c0 = blockIdx.y * kC, bh = blockIdx.z;
  const int n_tiles = (prm.kv_len + kBN - 1) / kBN;  // later tiles change nothing
  const int panels = prm.dp / kPanel;

  if (threadIdx.x == 0) {
    sm.qk.init(kConsumers);
    sm.vr.init(kConsumers);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer: one thread issues every TMA load; for each kv tile the
    // Q and K panels in head-dim order, then the tile's V^T rows ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      for (int t = 0, i = 0; t < n_tiles; ++t) {
        for (int p = 0; p < panels; ++p, ++i) {
          const int s = sm.qk.acquire(i, 2 * (kQPanel + kKPanel));
          tma_load_3d(sm.q[s][0], &qhi_map, &sm.qk.full[s], p * kPanel, q0, bh);
          tma_load_3d(sm.q[s][1], &qlo_map, &sm.qk.full[s], p * kPanel, q0, bh);
          tma_load_3d(sm.k[s][0], &khi_map, &sm.qk.full[s], p * kPanel, t * kBN, bh);
          tma_load_3d(sm.k[s][1], &klo_map, &sm.qk.full[s], p * kPanel, t * kBN, bh);
        }
        const int s = sm.vr.acquire(t, 2 * kVTile);
        for (int h = 0; h < 2; ++h)
          for (int j = 0; j < kBN / 32; ++j)
            tma_load_3d(sm.v[s][h] + j * kVPanel, h ? &vlo_map : &vhi_map, &sm.vr.full[s],
                        t * kBN + 32 * j, c0, bh);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns q rows q0 + 64 wg .. + 63 ----
  setmaxnreg_inc<kConsumerRegs>();
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int lane = tid % 32, warp = t / 32;
  const int c = lane % 4;
  const int row = q0 + wg * 64 + warp * 16 + lane / 4;  // and row + 8

  float o[kC / 2];  // output columns c0 .. c0 + kC - 1, summed on the FMA units
#pragma unroll
  for (int i = 0; i < kC / 2; ++i) o[i] = 0.0f;
  float ot[kPV / 2];  // one chain's P V, on the tensor core
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;  // rows row, row + 8
  uint32_t phi[kBN / 8][4], plo[kBN / 8][4];

  for (int it = 0, i = 0; it < n_tiles; ++it) {
    // ---- S = Q_hi K_hi^T + Q_hi K_lo^T + Q_lo K_hi^T, a panel at a time,
    // kFold panels on the tensor core into acc, each group added into sv on
    // the FMA units ----
    float acc[kBN / 2], sv[kBN / 2];
    for (int p = 0; p < panels; ++p, ++i) {
      const int s = sm.qk.wait_full(i);
      const uint64_t qhi = make_desc(sm.q[s][0] + wg * 64 * 128, 16, 8 * 128, kSw128);
      const uint64_t qlo = make_desc(sm.q[s][1] + wg * 64 * 128, 16, 8 * 128, kSw128);
      const uint64_t khi = make_desc(sm.k[s][0], 16, 8 * 128, kSw128);
      const uint64_t klo = make_desc(sm.k[s][1], 16, 8 * 128, kSw128);
      wgmma_fence();
#pragma unroll
      for (int st = 0; st < kPanel / 8; ++st) {
        const uint32_t off = 32 * st;
        wgmma_ss_tf32<kBN>(acc, desc_add(qhi, off), desc_add(khi, off),
                           p % kFold > 0 || st > 0);
        wgmma_ss_tf32<kBN>(acc, desc_add(qhi, off), desc_add(klo, off), 1);
        wgmma_ss_tf32<kBN>(acc, desc_add(qlo, off), desc_add(khi, off), 1);
      }
      wgmma_commit();
      // the panel before this one has been read
      wgmma_wait<1>();
      if (p > 0) sm.qk.release(i - 1);
      if (p % kFold == kFold - 1 || p == panels - 1) {  // the group is done
        wgmma_wait<0>();
        fence_regs(acc);
#pragma unroll
        for (int j = 0; j < kBN / 2; ++j) sv[j] = p < kFold ? acc[j] : __fadd_rn(sv[j], acc[j]);
      }
    }
    fence_regs(o);
    sm.qk.release(i - 1);

    // ---- the running max, masked past kv_len ----
    const int kv0 = it * kBN;
    if (kv0 + kBN > prm.kv_len) {
#pragma unroll
      for (int j = 0; j < kBN / 2; ++j)
        if (kv0 + 8 * (j / 4) + 2 * c + (j % 2) >= prm.kv_len) sv[j] = kNegInf;
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sv[4 * j], sv[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sv[4 * j + 2], sv[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
    const float sub0 = fmaxf(m0, mx0), sub1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(__fsub_rn(m0, sub0));  // 0 on the first tile
    const float alpha1 = exp2f(__fsub_rn(m1, sub1));
    m0 = sub0;
    m1 = sub1;

    // ---- p, its row sums, and P_hi / P_lo as the A fragments of k step j:
    // the accumulator's elements 0, 2, 1, 3 (V^T's kv order) ----
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      float pr[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) pr[e] = exp2f(__fsub_rn(sv[4 * j + e], e < 2 ? sub0 : sub1));
      sum0 = __fadd_rn(__fadd_rn(sum0, pr[0]), pr[1]);
      sum1 = __fadd_rn(__fadd_rn(sum1, pr[2]), pr[3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = pr[e == 1 ? 2 : e == 2 ? 1 : e];
        const float hi = tf32_rna(x);
        phi[j][e] = __float_as_uint(hi);
        plo[j][e] = __float_as_uint(tf32_rna(__fsub_rn(x, hi)));
      }
    }
    l0 = __fadd_rn(__fmul_rn(alpha0, l0), sum0);
    l1 = __fadd_rn(__fmul_rn(alpha1, l1), sum1);

    // ---- P V over this CTA's kC rows of V^T, in two chains of kPV output
    // columns into fresh registers, each folded into o in turn ----
    const int vs = sm.vr.wait_full(it);
    const uint64_t vhi = make_desc(sm.v[vs][0], 16, 8 * 128, kSw128);
    const uint64_t vlo = make_desc(sm.v[vs][1], 16, 8 * 128, kSw128);
    pv<kC, kPV, 0, kBN>(ot, phi, plo, vhi, vlo);
    wgmma_wait<0>();
    fence_regs(ot);
    fence_regs(phi);
    fence_regs(plo);
    fold<kC, kPV, 0>(o, ot, alpha0, alpha1);
    pv<kC, kPV, 1, kBN>(ot, phi, plo, vhi, vlo);
    wgmma_wait<0>();
    fence_regs(ot);
    fence_regs(phi);
    fence_regs(plo);
    fold<kC, kPV, 1>(o, ot, alpha0, alpha1);
    sm.vr.release(it);
  }

  l0 = __fadd_rn(l0, __shfl_xor_sync(kFull, l0, 1));
  l0 = __fadd_rn(l0, __shfl_xor_sync(kFull, l0, 2));
  l1 = __fadd_rn(l1, __shfl_xor_sync(kFull, l1, 1));
  l1 = __fadd_rn(l1, __shfl_xor_sync(kFull, l1, 2));
  const float inv0 = l0 <= 0.0f ? 1.0f : __fdiv_rn(1.0f, l0);
  const float inv1 = l1 <= 0.0f ? 1.0f : __fdiv_rn(1.0f, l1);
  float* obase = prm.out + (int64_t)bh * prm.sq * prm.dp + c0;
#pragma unroll
  for (int j = 0; j < kC / 8; ++j) {
    const int col = 8 * j + 2 * c;
    if (c0 + col < prm.dp) {
      if (row < prm.sq)
        *reinterpret_cast<float2*>(obase + (int64_t)row * prm.dp + col) =
            make_float2(__fmul_rn(o[4 * j], inv0), __fmul_rn(o[4 * j + 1], inv0));
      if (row + 8 < prm.sq)
        *reinterpret_cast<float2*>(obase + (int64_t)(row + 8) * prm.dp + col) =
            make_float2(__fmul_rn(o[4 * j + 2], inv1), __fmul_rn(o[4 * j + 3], inv1));
    }
  }
}

}  // namespace wide_f32
}  // namespace

// q_hi, q_lo (q carrying sm_scale * log2(e), split), out: [BH, sq, dp] f32;
// k_hi, k_lo: [BH, skv, dp] f32, rows at or past kv_len zero; vt_hi, vt_lo:
// [BH, dp, skv rounded up to 8] f32, v transposed, split and kv-permuted
// (ops/flash_attention.py::_tf32_operands); all contiguous and 16-byte
// aligned, dp a multiple of 64 (the head dim rounded up; the columns past it
// zero), any lengths. Returns a cudaError_t.
extern "C" int aether_flash_online_wide(const void* q_hi, const void* q_lo, const void* k_hi,
                                        const void* k_lo, const void* vt_hi, const void* vt_lo,
                                        void* out, int BH, int sq, int skv, int kv_len, int dp,
                                        void* stream) {
  using namespace wide_f32;
  if (BH <= 0 || BH > 65535 || sq <= 0 || skv <= 0 || kv_len < 0 || kv_len > skv ||
      dp <= 0 || dp % 64 || (dp + kC - 1) / kC > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const int skv8 = (skv + 7) / 8 * 8;
  CUtensorMap qhi_map, qlo_map, khi_map, klo_map, vhi_map, vlo_map;
  if (!make_map_3d(&qhi_map, q_hi, f32, 4, dp, sq, BH, kPanel, kBM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_3d(&qlo_map, q_lo, f32, 4, dp, sq, BH, kPanel, kBM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_3d(&khi_map, k_hi, f32, 4, dp, skv, BH, kPanel, kBN, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_3d(&klo_map, k_lo, f32, 4, dp, skv, BH, kPanel, kBN, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_3d(&vhi_map, vt_hi, f32, 4, skv8, dp, BH, 32, kC, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_3d(&vlo_map, vt_lo, f32, 4, skv8, dp, BH, 32, kC, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  Params prm{};
  prm.out = static_cast<float*>(out);
  prm.sq = sq;
  prm.kv_len = kv_len;
  prm.dp = dp;
  cudaError_t err =
      cudaFuncSetAttribute(wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBM - 1) / kBM, (dp + kC - 1) / kC, BH);
  wide_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      qhi_map, qlo_map, khi_map, klo_map, vhi_map, vlo_map, prm);
  return static_cast<int>(cudaGetLastError());
}
