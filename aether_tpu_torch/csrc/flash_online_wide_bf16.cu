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
// wgmma's N is at most 256. The first form of this kernel cut the
// output into blocks of 256 columns, a CTA each, and each block summed the
// whole S again (1.5x the function's products at 512, 1.8x at 320) while
// reading Q from L2 every kv tile (twice K's bytes, ~0.61 TB a call at 512):
// it ran at L2's rate, 21.6-24.0% of its bound. The plan here computes S
// once a q tile:
//   * a thread-block cluster of n CTAs takes a q tile of 128 rows (the
//     grid's y axis, ops/flash_attention.py::_wide_plan and wide_cluster in
//     hopper.cuh): CTA r owns a slice of the head dim, at most kC = 256
//     columns, the dp / 64 units dealt out evenly (320: 192 + 128, 512:
//     256 + 256, n up to 8 at 2048); a CTA has two consumer warpgroups of 64
//     q rows and a producer warpgroup that hands its registers to them
//     (setmaxnreg: 40 for it, 232 a consumer thread);
//   * Q's slice stays in shared memory for the whole kv loop (64 KB at 256),
//     rounded to bf16(q * c) once; K's slice of a 64-row kv tile streams in
//     64-column panels (128-byte rows, 128-byte swizzle) through a ring of
//     kKStages slots, each panel four k16 steps of wgmma m64n64k16 into the
//     CTA's part of S;
//   * the parts meet through distributed shared memory (ScoreExchange in
//     hopper.cuh): a pair (320-512) pushes its 32 KB to the other CTA with
//     st.async, larger clusters pull the others' parts; each CTA adds the
//     parts in rank order, so every CTA holds the same S, bit for bit, and
//     runs the same softmax (online_cell's) on it;
//   * P V takes bf16(p) as the register A operand and the slice's columns of
//     V (64-column MN-major panels, a ring of kVStages slots) as B: one wgmma
//     chain of the slice's width (64 to 256) a k16 step, in flight while the
//     next tile's first Q K^T panel issues; a consumer thread holds at most
//     128 f32 of output, 32 of S and 16 packed bf16(p);
//   * above 8 slices (dp > 2048) clusters along y each compute S so, Q's
//     slice then wider than 256 and streamed panel by panel through the Q
//     slots, and split the output columns between their CTAs evenly;
//   * rows past the tensors' ends arrive as zeros (TMA), stores past sq are
//     dropped, tiles wholly past kv_len are skipped (they change nothing)
//     and only the last is masked.
// The products are the function's, once; L2 gives each CTA K's and V's
// slices a tile (~0.17 TB a call at 512). The exchange moves 32 KB a CTA
// and tile through DSMEM (~85 GB a call at 512): pushed, 0.90 us a tile
// alone and 18.8 ms a call at the main grid (~4.7 TB/s over the card) by
// bench/dsmem_probe.py on an H100 at 700 W (PERF.md section 6). It waits
// between S and the softmax; issuing the previous tile's P V, or the next
// tile's part of S, under it read slower on the card (PERF.md section 6).
// Shared memory: Q 64 KB + K 4 x 8 + V 2 x 32 + the exchange 2 x 32 = 224
// KB of the 227 a block may take.
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
constexpr int kPanel = 64;   // head-dim columns of a Q, K or V panel (128 bytes)
constexpr int kC = 256;      // head-dim columns of a CTA's slice, at most
constexpr int kUnits = kC / kPanel;
constexpr int kConsumers = 256, kThreads = kConsumers + 128;
// the producer's loops spill at 24 registers; the consumers fit in 232
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(128 * kProducerRegs + kConsumers * kConsumerRegs <=
                  kThreads * ((65536 / kThreads) & ~7),
              "setmaxnreg asks for more registers than the CTA starts with");
constexpr int kQPanel = kBM * 128;     // bytes of a Q panel
constexpr int kKPanel = kBN * 128;     // of a K panel
constexpr int kVPanel = kBN * 128;     // of a V panel
constexpr int kVTile = kUnits * kVPanel;
constexpr int kQSlots = kUnits, kKStages = 4, kVStages = 2;

struct Smem {
  uint8_t q[kQSlots][kQPanel];  // Q's slice, or a ring of its panels above 256
  uint8_t k[kKStages][kKPanel];
  uint8_t v[kVStages][kVTile];
  ScoreExchange<kConsumers / 32, kBN / 2> x;
  Ring<kQSlots> qr;  // Q's slice (item 0, never released) or its streamed panels
  Ring<kKStages> kr;
  Ring<kVStages> vr;
};
// + 1024 so the tiles can start on a 1024-byte boundary
constexpr int kSmem = sizeof(Smem) + 1024;
static_assert(kSmem <= 232448, "the tiles must fit in the 227 KB a block may take");

struct Params {
  __nv_bfloat16* out;  // [BH, sq, dp]
  int sq, kv_len, dp;  // dp: the width, a multiple of 64
  int cluster, ctas;   // CTAs a cluster, and along the grid's y axis
  float qscale;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// a warpgroup's 64 rows of a Q panel (thread t of 128) as bf16(q * qscale),
// in place (elementwise, so the swizzle is moot; the zero columns stay zero)
__device__ __forceinline__ void round_q(uint8_t* rows, int t, float qscale) {
#pragma unroll
  for (int e = 0; e < 64 * 128 / 16 / 128; ++e) {
    uint4* ptr = reinterpret_cast<uint4*>(rows) + t + 128 * e;
    uint4 raw = *ptr;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      h[j] = __floats2bfloat162_rn(__fmul_rn(f.x, qscale), __fmul_rn(f.y, qscale));
    }
    *ptr = raw;
  }
}

// o[0 .. N / 2) += bf16(p) V over the N columns of the slice's V panels
// (MN-major, LBO one panel), one k16 step a tile's 16 kv rows
template <int N>
__device__ __forceinline__ void pv_chain(float (&o)[kC / 2], const uint32_t (&pa)[kBN / 16][4],
                                         uint64_t vdesc) {
  float(&d)[N / 2] = *reinterpret_cast<float(*)[N / 2]>(&o);
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
    wgmma_rs_bf16_vt<N>(d, pa[kk], desc_add(vdesc, 16 * 128 * kk), 1);
}

// issues o += bf16(p) V over the slice's o_units V panels at v, one chain of
// the slice's width, committed and not waited for
__device__ __forceinline__ void pv(float (&o)[kC / 2], const uint32_t (&pa)[kBN / 16][4],
                                   const uint8_t* v, int o_units) {
  const uint64_t vdesc = make_desc(v, kVPanel, 8 * 128, kSw128);
  fence_regs(o);
  wgmma_fence();
  switch (o_units) {
    case 1: pv_chain<64>(o, pa, vdesc); break;
    case 2: pv_chain<128>(o, pa, vdesc); break;
    case 3: pv_chain<192>(o, pa, vdesc); break;
    default: pv_chain<256>(o, pa, vdesc); break;
  }
  wgmma_commit();
}

// kStream: Q's slice wider than the Q slots (dp > 8 x kC), its panels
// streamed every kv tile; else resident for the whole kv loop
template <bool kStream>
__global__ void __launch_bounds__(kThreads, 1)
wide_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap, const Params prm) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int q0 = blockIdx.x * kBM, bh = blockIdx.z;
  const int n_tiles = (prm.kv_len + kBN - 1) / kBN;  // later tiles change nothing
  const int n = prm.cluster, rank = static_cast<int>(cluster_ctarank());
  // this CTA's units of the head dim: its slice of S, and its output columns
  const int units = prm.dp / kPanel;
  const int s0 = part_start(units, n, rank), s_units = part_count(units, n, rank);
  const int o0 = part_start(units, prm.ctas, blockIdx.y);
  const int o_units = part_count(units, prm.ctas, blockIdx.y);

  if (threadIdx.x == 0) {
    sm.qr.init(kConsumers);
    sm.kr.init(kConsumers);
    sm.vr.init(kConsumers);
    sm.x.init(sm.x.arrivals(n));
    mbar_init_fence();
  }
  // every barrier of the cluster is initialized before any CTA arrives on one
  cluster_arrive();
  cluster_wait();

  if (threadIdx.x >= kConsumers) {
    // ---- producer: one thread issues every TMA load: Q's slice, then for
    // each kv tile K's panels in head-dim order (and Q's, when they
    // stream), then the tile's V columns ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      if (!kStream) {
        sm.qr.acquire(0, s_units * kQPanel);
        for (int p = 0; p < s_units; ++p)
          tma_load_3d(sm.q[p], &qmap, &sm.qr.full[0], (s0 + p) * kPanel, q0, bh);
      }
      for (int t = 0, i = 0; t < n_tiles; ++t) {
        for (int p = 0; p < s_units; ++p, ++i) {
          if (kStream) {
            const int s = sm.qr.acquire(i, kQPanel);
            tma_load_3d(sm.q[s], &qmap, &sm.qr.full[s], (s0 + p) * kPanel, q0, bh);
          }
          const int s = sm.kr.acquire(i, kKPanel);
          tma_load_3d(sm.k[s], &kmap, &sm.kr.full[s], (s0 + p) * kPanel, t * kBN, bh);
        }
        const int s = sm.vr.acquire(t, o_units * kVPanel);
        for (int j = 0; j < o_units; ++j)
          tma_load_3d(sm.v[s] + j * kVPanel, &vmap, &sm.vr.full[s], (o0 + j) * kPanel, t * kBN,
                      bh);
      }
    }
    cluster_arrive();  // no CTA leaves while another may read its shared memory
    cluster_wait();
    return;
  }

  // ---- consumers: warpgroup wg owns q rows q0 + 64 wg .. + 63 ----
  setmaxnreg_inc<kConsumerRegs>();
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int lane = tid % 32, warp = t / 32;
  const int c = lane % 4;
  if (!kStream) {
    sm.qr.wait_full(0);
    for (int p = 0; p < s_units; ++p) round_q(sm.q[p] + wg * 64 * 128, t, prm.qscale);
    fence_proxy_async();
    named_sync(1 + wg, 128);
  }

  float o[kC / 2];  // output columns 64 o0 .. of rows r, r + 8
#pragma unroll
  for (int i = 0; i < kC / 2; ++i) o[i] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  // bf16(p) as the A fragments of P V (k step kk takes accumulator chunks
  // 2kk and 2kk + 1)
  uint32_t pa[kBN / 16][4];

  for (int it = 0, i = 0; it < n_tiles; ++it) {
    // ---- this CTA's part of S = Q K^T, a 64-column panel at a time ----
    float sv[kBN / 2];
    for (int p = 0; p < s_units; ++p, ++i) {
      uint8_t* qs;
      if (kStream) {
        qs = sm.q[sm.qr.wait_full(i)] + wg * 64 * 128;
        round_q(qs, t, prm.qscale);
        fence_proxy_async();
        named_sync(1 + wg, 128);
      } else {
        qs = sm.q[p] + wg * 64 * 128;
      }
      const int ks = sm.kr.wait_full(i);
      const uint64_t qdesc = make_desc(qs, 16, 8 * 128, kSw128);
      const uint64_t kdesc = make_desc(sm.k[ks], 16, 8 * 128, kSw128);
      wgmma_fence();
#pragma unroll
      for (int st = 0; st < kPanel / 16; ++st)
        wgmma_ss_bf16<kBN>(sv, desc_add(qdesc, 32 * st), desc_add(kdesc, 32 * st),
                           p > 0 || st > 0);
      wgmma_commit();
      // the panel before this one has been read (and, at the first panel of
      // a tile, the previous tile's P V has completed)
      wgmma_wait<1>();
      if (p > 0) {
        sm.kr.release(i - 1);
        if (kStream) sm.qr.release(i - 1);
      } else if (it > 0) {
        sm.vr.release(it - 1);
      }
    }
    wgmma_wait<0>();
    fence_regs(sv);
    fence_regs(o);
    fence_regs(pa);
    sm.kr.release(i - 1);
    if (kStream) sm.qr.release(i - 1);

    // ---- S over the cluster, the same bits in every CTA ----
    sm.x.sum(sv, it, n, rank, tid / 32, lane);

    // ---- the online softmax (online_cell's, "vpu") ----
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
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(__fsub_rn(m0, mn0));  // 0 on the first tile
    const float alpha1 = exp2f(__fsub_rn(m1, mn1));
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const float p0 = exp2_ftz(__fsub_rn(sv[4 * j], mn0));
      const float p1 = exp2_ftz(__fsub_rn(sv[4 * j + 1], mn0));
      const float p2 = exp2_ftz(__fsub_rn(sv[4 * j + 2], mn1));
      const float p3 = exp2_ftz(__fsub_rn(sv[4 * j + 3], mn1));
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

    // ---- P V over this CTA's columns, in flight while the next tile's
    // first Q K^T panel issues ----
    pv(o, pa, sm.v[sm.vr.wait_full(it)], o_units);
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
  __nv_bfloat16* obase = prm.out + (int64_t)bh * prm.sq * prm.dp + o0 * kPanel;
#pragma unroll
  for (int j = 0; j < kC / 8; ++j) {
    const int col = 8 * j + 2 * c;
    if (col < kPanel * o_units) {
      if (row < prm.sq)
        *reinterpret_cast<uint32_t*>(obase + (int64_t)row * prm.dp + col) =
            pack_bf16(__fmul_rn(o[4 * j], inv0), __fmul_rn(o[4 * j + 1], inv0));
      if (row + 8 < prm.sq)
        *reinterpret_cast<uint32_t*>(obase + (int64_t)(row + 8) * prm.dp + col) =
            pack_bf16(__fmul_rn(o[4 * j + 2], inv1), __fmul_rn(o[4 * j + 3], inv1));
    }
  }
  cluster_arrive();  // this CTA's reads of the others' shared memory are done
  cluster_wait();
}

}  // namespace wide_bf16
}  // namespace

// q, out: [BH, sq, dp] bf16; k, v: [BH, skv, dp] bf16; all contiguous and
// 16-byte aligned, dp a multiple of 64 above 256 (the head dim rounded up;
// the columns past it zero), rows of k and v at or past kv_len finite (the
// wrapper zeroes them). qscale: the sm_scale * log2(e) fold of the true head
// dim, applied here as bf16(q * qscale); the "vpu" denominator. cluster,
// groups: the wrapper's _wide_plan (CTAs a cluster, clusters along y),
// checked against hopper.cuh's wide_cluster / wide_groups. No padding of
// rows: TMA reads rows past the ends as zeros and rows past sq are not
// written. Returns a cudaError_t.
extern "C" int aether_flash_online_wide_bf16(const void* q, const void* k, const void* v,
                                             void* out, int BH, int sq, int skv, int kv_len,
                                             float qscale, int dp, int cluster, int groups,
                                             void* stream) {
  using namespace wide_bf16;
  const int units = dp / kPanel;
  if (BH <= 0 || BH > 65535 || sq <= 0 || skv <= 0 || kv_len < 0 || kv_len > skv ||
      dp <= kC || dp % kPanel || cluster != wide_cluster(units, kUnits) ||
      groups != wide_groups(units, kUnits) || cluster * groups > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qmap, kmap, vmap;
  if (!make_map_3d(&qmap, q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, dp, sq, BH, kPanel, kBM,
                   CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_3d(&kmap, k, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, dp, skv, BH, kPanel, kBN,
                   CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_3d(&vmap, v, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, dp, skv, BH, kPanel, kBN,
                   CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  Params prm{};
  prm.out = static_cast<__nv_bfloat16*>(out);
  prm.sq = sq;
  prm.kv_len = kv_len;
  prm.dp = dp;
  prm.cluster = cluster;
  prm.ctas = cluster * groups;
  prm.qscale = qscale;
  // Q's slice stays where it fits in the Q slots: within one cluster's reach
  void (*fn)(CUtensorMap, CUtensorMap, CUtensorMap, Params) =
      groups == 1 ? wide_kernel<false> : wide_kernel<true>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((sq + kBM - 1) / kBM, cluster * groups, BH);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fn, qmap, kmap, vmap, prm);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
