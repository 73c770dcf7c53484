// K4 in bf16 above head_dim 256: online-softmax flash attention on wgmma
// with TMA, written by hand for Hopper (sm_90a), one kernel for every head
// dim, the width dp (the head dim rounded up to a multiple of 64 by the
// wrapper, zero columns past it) a run-time argument. flash_online_bf16.cu
// (online_cell.cuh) runs the head dims up to 256; flash_online_wide.cu is
// the f32 form of this kernel.
//
// Replaces the bf16 form of aether_tpu/ops/flash_attention.py::_flash_kernel
// (:69, the Pallas TPU kernel launched by flash_attention(fixed_max=False))
// at head_dim > 256, where the JAX wrapper takes it with the "vpu"
// denominator (:538-548, no upper limit) and the JAX DiT sends any head_dim
// >= 128 (dit.py:819-825). Non-causal, in the log2 domain:
//   q   = bf16(q * c),  c = sm_scale * log2(e)     (here, in shared memory)
//   s   = q . k^T                                  (f32 sums of bf16 products)
//   s   = -0.7 * f32max  where column >= kv_len
//   m'  = max(m, rowmax s),  alpha = exp2(m - m'),  p = exp2(s - m')
//   acc = alpha * acc + bf16(p) . v
//   l   = alpha * l + sum p                        ("vpu": unrounded p)
//   out = bf16(acc / l), a zero l divides by 1
// bf16 products are exact in f32, so this is the TPU kernel's function up to
// the order of sums and the kv tiling (64 columns here, 1024 there), which
// moves the running max and with it the rounding of p.
//
// What bounds it on an H100: at (1, 48 heads, 15076 tokens, D) one call is
// 4.4e10 x D bf16 flops, 0.04412 ms x D on the 989-TFLOP/s tensor cores
// (14.1 ms at 320, 22.6 at 512), and 1.1e10 exp2 (2.61 ms on the SFU): the
// products bind. online_cell.cuh's plan stops at 256 (its note): a consumer
// thread holds Q's product and the whole output row block, D / 2 f32, and
// wgmma's N is at most 256; Q of one CTA alone is 64 KB at 256. The design
// here takes every D with one tile plan:
//   * the grid is (q tiles of 128 rows, output column blocks of kC = 256,
//     B*H); a CTA has two consumer warpgroups of 64 q rows and a producer
//     warpgroup that hands its registers to them (setmaxnreg: 24 for it, 240
//     a consumer thread);
//   * S = Q K^T of a 64-row kv tile streams the head dim through shared
//     memory: the producer brings Q and K in panels of 64 columns (128-byte
//     rows, 128-byte swizzle) into a ring of kQKStages slots by TMA, each
//     warpgroup rounds its 64 rows of the Q panel to bf16(q * c) in place and
//     adds the panel's four k16 steps of wgmma m64n64k16 into S, one panel in
//     flight while the next is waited for;
//   * the softmax runs on S in registers as online_cell does; P V takes
//     bf16(p) as the register A operand and only this CTA's kC columns of V
//     (four 64-column MN-major panels, a ring of kVStages slots) as B: one
//     wgmma m64n256k16 chain a k16 step, in flight while the next tile's
//     first Q K^T panel issues;
//   * a consumer thread holds the kC / 2 = 128 f32 of its output, 32 of S
//     and 16 packed bf16(p), as online_cell<256> does, whatever D is;
//   * rows past the tensors' ends arrive as zeros (TMA), V panels past dp
//     are not loaded (their output columns are not stored), stores past sq
//     are dropped, tiles wholly past kv_len are skipped (they change
//     nothing) and only the last is masked.
// Each column block computes S again: the work is dp / kC times S plus P V,
// 1.5x the function's at 512, 1.8x at 320 (its second block holds 64 of
// 256 columns). Q is read from L2 once a kv tile, twice K's bytes; TMA
// multicast of K and V over a cluster of column blocks, and Q resident
// where it fits, are the ways to cut both (PERF.md section 7).
// Built without --use_fast_math so exp2f and the division stay accurate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {
namespace wide_bf16 {

using namespace hopper;

constexpr float kNegInf = -0.7f * 3.40282347e38f;  // the TPU kernel's mask
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBM = 128;     // q rows a CTA: two consumer warpgroups of 64
constexpr int kBN = 64;      // kv rows a tile
constexpr int kPanel = 64;   // head-dim columns of a Q or K panel (128 bytes)
constexpr int kC = 256;      // output columns a CTA
constexpr int kConsumers = 256, kThreads = kConsumers + 128;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
static_assert(128 * kProducerRegs + kConsumers * kConsumerRegs <=
                  kThreads * ((65536 / kThreads) & ~7),
              "setmaxnreg asks for more registers than the CTA starts with");
constexpr int kQPanel = kBM * 128;     // bytes of a Q panel
constexpr int kKPanel = kBN * 128;     // of a K panel
constexpr int kVPanel = kBN * 128;     // of a 64-column V panel
constexpr int kVTile = kC / 64 * kVPanel;
constexpr int kQKStages = 5, kVStages = 3;

struct Smem {
  uint8_t q[kQKStages][kQPanel];
  uint8_t k[kQKStages][kKPanel];
  uint8_t v[kVStages][kVTile];
  Ring<kQKStages> qk;
  Ring<kVStages> vr;
};
// + 1024 so the tiles can start on a 1024-byte boundary
constexpr int kSmem = sizeof(Smem) + 1024;
static_assert(kSmem <= 232448, "the rings must fit in the 227 KB a block may take");

struct Params {
  __nv_bfloat16* out;  // [BH, sq, dp]
  int sq, kv_len, dp;  // dp: the width, a multiple of 64
  float qscale;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void __launch_bounds__(kThreads, 1)
wide_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap, const Params prm) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int q0 = blockIdx.x * kBM, c0 = blockIdx.y * kC, bh = blockIdx.z;
  const int n_tiles = (prm.kv_len + kBN - 1) / kBN;  // later tiles change nothing
  const int panels = prm.dp / kPanel;
  // V panels of this column block inside dp (the last block may hold fewer)
  const int v_panels = min(kC / 64, (prm.dp - c0) / 64);

  if (threadIdx.x == 0) {
    sm.qk.init(kConsumers);
    sm.vr.init(kConsumers);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer: one thread issues every TMA load; for each kv tile the
    // Q and K panels in head-dim order, then the tile's V columns ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      for (int t = 0, i = 0; t < n_tiles; ++t) {
        for (int p = 0; p < panels; ++p, ++i) {
          const int s = sm.qk.acquire(i, kQPanel + kKPanel);
          tma_load_3d(sm.q[s], &qmap, &sm.qk.full[s], p * kPanel, q0, bh);
          tma_load_3d(sm.k[s], &kmap, &sm.qk.full[s], p * kPanel, t * kBN, bh);
        }
        const int s = sm.vr.acquire(t, v_panels * kVPanel);
        for (int j = 0; j < v_panels; ++j)
          tma_load_3d(sm.v[s] + j * kVPanel, &vmap, &sm.vr.full[s], c0 + 64 * j, t * kBN, bh);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns q rows q0 + 64 wg .. + 63 ----
  setmaxnreg_inc<kConsumerRegs>();
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int lane = tid % 32, warp = t / 32;
  const int c = lane % 4;

  float o[kC / 2];  // output columns c0 .. c0 + kC - 1 of rows r, r + 8
#pragma unroll
  for (int i = 0; i < kC / 2; ++i) o[i] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  // bf16(p) as the A fragments of P V (k step kk takes accumulator chunks
  // 2kk and 2kk + 1)
  uint32_t pa[kBN / 16][4];

  for (int it = 0, i = 0; it < n_tiles; ++it) {
    // ---- S = Q K^T over the head dim, a 64-column panel at a time ----
    float acc[kBN / 2];
    for (int p = 0; p < panels; ++p, ++i) {
      const int s = sm.qk.wait_full(i);
      uint8_t* qs = sm.q[s] + wg * 64 * 128;
      // this warpgroup's rows of the panel as bf16(q * qscale), in place
      // (elementwise, so the swizzle is moot; the zero columns stay zero)
#pragma unroll
      for (int e = 0; e < 64 * 128 / 16 / 128; ++e) {
        uint4* ptr = reinterpret_cast<uint4*>(qs) + t + 128 * e;
        uint4 raw = *ptr;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(h[j]);
          h[j] = __floats2bfloat162_rn(__fmul_rn(f.x, prm.qscale), __fmul_rn(f.y, prm.qscale));
        }
        *ptr = raw;
      }
      fence_proxy_async();
      named_sync(1 + wg, 128);
      const uint64_t qdesc = make_desc(qs, 16, 8 * 128, kSw128);
      const uint64_t kdesc = make_desc(sm.k[s], 16, 8 * 128, kSw128);
      wgmma_fence();
#pragma unroll
      for (int st = 0; st < kPanel / 16; ++st)
        wgmma_ss_bf16<kBN>(acc, desc_add(qdesc, 32 * st), desc_add(kdesc, 32 * st),
                           p > 0 || st > 0);
      wgmma_commit();
      // the panel before this one has been read (and, at the first panel of
      // a tile, the previous tile's P V has completed)
      wgmma_wait<1>();
      if (p > 0)
        sm.qk.release(i - 1);
      else if (it > 0)
        sm.vr.release(it - 1);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(o);
    fence_regs(pa);
    sm.qk.release(i - 1);

    // ---- the online softmax (online_cell's, "vpu") ----
    const int kv0 = it * kBN;
    if (kv0 + kBN > prm.kv_len) {
#pragma unroll
      for (int j = 0; j < kBN / 2; ++j)
        if (kv0 + 8 * (j / 4) + 2 * c + (j % 2) >= prm.kv_len) acc[j] = kNegInf;
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(acc[4 * j], acc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(acc[4 * j + 2], acc[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(__fsub_rn(m0, mn0));  // 0 on the first tile
    const float alpha1 = exp2f(__fsub_rn(m1, mn1));
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const float p0 = exp2_ftz(__fsub_rn(acc[4 * j], mn0));
      const float p1 = exp2_ftz(__fsub_rn(acc[4 * j + 1], mn0));
      const float p2 = exp2_ftz(__fsub_rn(acc[4 * j + 2], mn1));
      const float p3 = exp2_ftz(__fsub_rn(acc[4 * j + 3], mn1));
      pa[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
      sum0 = __fadd_rn(__fadd_rn(sum0, p0), p1);
      sum1 = __fadd_rn(__fadd_rn(sum1, p2), p3);
    }
    l0 = __fadd_rn(__fmul_rn(alpha0, l0), sum0);
    l1 = __fadd_rn(__fmul_rn(alpha1, l1), sum1);
#pragma unroll
    for (int j = 0; j < kC / 8; ++j) {
      o[4 * j] = __fmul_rn(o[4 * j], alpha0);
      o[4 * j + 1] = __fmul_rn(o[4 * j + 1], alpha0);
      o[4 * j + 2] = __fmul_rn(o[4 * j + 2], alpha1);
      o[4 * j + 3] = __fmul_rn(o[4 * j + 3], alpha1);
    }

    // ---- P V over this CTA's columns: V MN-major, its panels LBO apart ----
    const int vs = sm.vr.wait_full(it);
    const uint64_t vdesc = make_desc(sm.v[vs], kVPanel, 8 * 128, kSw128);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      wgmma_rs_bf16_vt<kC>(o, pa[kk], desc_add(vdesc, 16 * 128 * kk), 1);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(pa);

  l0 = __fadd_rn(l0, __shfl_xor_sync(kFull, l0, 1));
  l0 = __fadd_rn(l0, __shfl_xor_sync(kFull, l0, 2));
  l1 = __fadd_rn(l1, __shfl_xor_sync(kFull, l1, 1));
  l1 = __fadd_rn(l1, __shfl_xor_sync(kFull, l1, 2));
  const float inv0 = l0 <= 0.0f ? 1.0f : __fdiv_rn(1.0f, l0);
  const float inv1 = l1 <= 0.0f ? 1.0f : __fdiv_rn(1.0f, l1);
  const int row = q0 + wg * 64 + warp * 16 + lane / 4;
  __nv_bfloat16* obase = prm.out + (int64_t)bh * prm.sq * prm.dp + c0;
#pragma unroll
  for (int j = 0; j < kC / 8; ++j) {
    const int col = 8 * j + 2 * c;
    if (col < 64 * v_panels) {
      if (row < prm.sq)
        *reinterpret_cast<uint32_t*>(obase + (int64_t)row * prm.dp + col) =
            pack_bf16(__fmul_rn(o[4 * j], inv0), __fmul_rn(o[4 * j + 1], inv0));
      if (row + 8 < prm.sq)
        *reinterpret_cast<uint32_t*>(obase + (int64_t)(row + 8) * prm.dp + col) =
            pack_bf16(__fmul_rn(o[4 * j + 2], inv1), __fmul_rn(o[4 * j + 3], inv1));
    }
  }
}

}  // namespace wide_bf16
}  // namespace

// q, out: [BH, sq, dp] bf16; k, v: [BH, skv, dp] bf16; all contiguous and
// 16-byte aligned, dp a multiple of 64 (the head dim rounded up; the columns
// past it zero), rows of k and v at or past kv_len finite (the wrapper zeroes
// them). qscale: the sm_scale * log2(e) fold of the true head dim, applied
// here as bf16(q * qscale); the "vpu" denominator. No padding of rows: TMA
// reads rows past the ends as zeros and rows past sq are not written.
// Returns a cudaError_t.
extern "C" int aether_flash_online_wide_bf16(const void* q, const void* k, const void* v,
                                             void* out, int BH, int sq, int skv, int kv_len,
                                             float qscale, int dp, void* stream) {
  using namespace wide_bf16;
  if (BH <= 0 || BH > 65535 || sq <= 0 || skv <= 0 || kv_len < 0 || kv_len > skv ||
      dp <= 0 || dp % 64 || (dp + kC - 1) / kC > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qmap, kmap, vmap;
  if (!make_map_3d(&qmap, q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, dp, sq, BH, kPanel, kBM,
                   CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_3d(&kmap, k, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, dp, skv, BH, kPanel, kBN,
                   CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_3d(&vmap, v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, dp, skv, BH, 64, kBN,
                   CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  Params prm{};
  prm.out = static_cast<__nv_bfloat16*>(out);
  prm.sq = sq;
  prm.kv_len = kv_len;
  prm.dp = dp;
  prm.qscale = qscale;
  cudaError_t err =
      cudaFuncSetAttribute(wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBM - 1) / kBM, (dp + kC - 1) / kC, BH);
  wide_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(qmap, kmap, vmap,
                                                                            prm);
  return static_cast<int>(cudaGetLastError());
}
