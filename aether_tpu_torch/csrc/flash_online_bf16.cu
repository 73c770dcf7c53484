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
// design (FlashAttention-3's shape at head_dim 64):
//   * a CTA takes 192 q rows: three consumer warpgroups of 64 rows each and
//     one producer warp; grid (q tiles, B*H). Three warpgroups rather than
//     two cut the L2 traffic by a third and give each scheduler three warps
//     to interleave;
//   * the producer keeps K and V tiles of 128 kv rows x 64 in a ring of
//     kStages shared-memory slots by TMA (128-byte swizzle, mbarriers), so
//     loads run ahead of the math; rows past the sequence arrive as zeros,
//     so the wrapper pads nothing;
//   * S = Q K^T is wgmma m64n128k16 with Q and K from shared memory
//     (K-major); the softmax runs on the f32 accumulator fragment in
//     registers; bf16(p) becomes the A operand of P V in registers, and V is
//     the B operand from shared memory through wgmma's transpose bit. A
//     tile's P V stays in flight while the next tile's Q K^T is issued;
//   * while one warpgroup runs its softmax (SFU) the others' wgmma run;
//   * p = exp2_ftz (one SFU instruction; p below 2^-126 counts as 0, which a
//     bf16 output cannot see); tiles wholly past kv_len are skipped and only
//     the last is masked.
// Compiled without --use_fast_math so exp2f (alpha) and the division stay
// accurate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kD = 64;
constexpr int kWG = 3;                      // consumer warpgroups, 64 q rows each
constexpr int kBM = 64 * kWG;               // q rows per CTA
constexpr int kBN = 128;                    // kv rows per tile
constexpr int kStages = 3;
constexpr int kConsumers = 128 * kWG;
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr int kTileBytes = kBN * kD * 2;    // 16 KB, one K or V tile
constexpr int kQBytes = kBM * kD * 2;         // 24 KB
constexpr float kNegInf = -0.7f * 3.40282347e38f;  // the TPU kernel's mask
constexpr unsigned kFull = 0xffffffffu;

struct Smem {
  __nv_bfloat16 q[kBM * kD];
  __nv_bfloat16 k[kStages][kBN * kD];
  __nv_bfloat16 v[kStages][kBN * kD];
  Ring<kStages> ring;
  uint64_t q_full;
};
// + 1024 so the tiles can start on a 1024-byte boundary
constexpr int kSmemBytes = sizeof(Smem) + 1024;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void __launch_bounds__(kThreads, 1)
flash_online_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         __nv_bfloat16* __restrict__ out, int sq, int kv_len, int round_l,
                         float qscale) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBM;
  const int n_tiles = (kv_len + kBN - 1) / kBN;  // later tiles change nothing

  if (threadIdx.x == 0) {
    sm.ring.init(kConsumers);
    mbar_init(&sm.q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer: one thread issues every TMA load ----
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(&sm.q_full, kQBytes);
      tma_load_3d(sm.q, &qmap, &sm.q_full, 0, q0, bh);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = sm.ring.acquire(i, 2 * kTileBytes);
        tma_load_3d(sm.k[s], &kmap, &sm.ring.full[s], 0, i * kBN, bh);
        tma_load_3d(sm.v[s], &vmap, &sm.ring.full[s], 0, i * kBN, bh);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns q rows q0 + 64 wg .. + 63 ----
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int lane = tid % 32, warp = t / 32;
  const int c = lane % 4;
  __nv_bfloat16* qs = sm.q + wg * 64 * kD;

  // q * c rounded to bf16, in place (elementwise, so the swizzle is moot)
  mbar_wait(&sm.q_full, 0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint4* p = reinterpret_cast<uint4*>(qs) + t + 128 * i;
    uint4 raw = *p;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      h[j] = __floats2bfloat162_rn(__fmul_rn(f.x, qscale), __fmul_rn(f.y, qscale));
    }
    *p = raw;
  }
  fence_proxy_async();
  named_sync(1 + wg, 128);

  const uint64_t qdesc = make_desc(qs, 16, 1024, kSw128);
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;  // rows r, r + 8
  // bf16(p) as the A fragments of P V (k step kk takes accumulator chunks
  // 2kk and 2kk + 1). Tile it's P V stays in flight while tile it + 1's
  // Q K^T is issued; one wait covers both.
  uint32_t pa[kBN / 16][4];

  for (int it = 0; it < n_tiles; ++it) {
    const int s = sm.ring.wait_full(it);
    const uint64_t kdesc = make_desc(sm.k[s], 16, 1024, kSw128);
    const uint64_t vdesc = make_desc(sm.v[s], 8192, 1024, kSw128);

    float acc[64];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_m64n128k16_ss_bf16(acc, desc_add(qdesc, 32 * kk), desc_add(kdesc, 32 * kk),
                               kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(o);
    fence_regs(pa);
    if (it > 0) sm.ring.release(it - 1);  // its P V has completed

    const int kv0 = it * kBN;
    if (kv0 + kBN > kv_len) {
#pragma unroll
      for (int i = 0; i < 64; ++i)
        if (kv0 + 8 * (i / 4) + 2 * c + (i % 2) >= kv_len) acc[i] = kNegInf;
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
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

    // p, its bf16 rounding packed into pa, and the row sums
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float p0 = exp2_ftz(__fsub_rn(acc[4 * j], mn0));
      const float p1 = exp2_ftz(__fsub_rn(acc[4 * j + 1], mn0));
      const float p2 = exp2_ftz(__fsub_rn(acc[4 * j + 2], mn1));
      const float p3 = exp2_ftz(__fsub_rn(acc[4 * j + 3], mn1));
      const __nv_bfloat162 b01 = __floats2bfloat162_rn(p0, p1);
      const __nv_bfloat162 b23 = __floats2bfloat162_rn(p2, p3);
      pa[j / 2][(j % 2) * 2] = *reinterpret_cast<const uint32_t*>(&b01);
      pa[j / 2][(j % 2) * 2 + 1] = *reinterpret_cast<const uint32_t*>(&b23);
      if (round_l) {
        const float2 f01 = __bfloat1622float2(b01), f23 = __bfloat1622float2(b23);
        sum0 = __fadd_rn(__fadd_rn(sum0, f01.x), f01.y);
        sum1 = __fadd_rn(__fadd_rn(sum1, f23.x), f23.y);
      } else {
        sum0 = __fadd_rn(__fadd_rn(sum0, p0), p1);
        sum1 = __fadd_rn(__fadd_rn(sum1, p2), p3);
      }
    }
    l0 = __fadd_rn(__fmul_rn(alpha0, l0), sum0);
    l1 = __fadd_rn(__fmul_rn(alpha1, l1), sum1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[4 * j] = __fmul_rn(o[4 * j], alpha0);
      o[4 * j + 1] = __fmul_rn(o[4 * j + 1], alpha0);
      o[4 * j + 2] = __fmul_rn(o[4 * j + 2], alpha1);
      o[4 * j + 3] = __fmul_rn(o[4 * j + 3], alpha1);
    }

    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      wgmma_m64n64k16_rs_bf16_vt(o, pa[kk], desc_add(vdesc, 2048 * kk), 1);
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
  __nv_bfloat16* obase = out + (int64_t)bh * sq * kD;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * c;
    if (row < sq)
      *reinterpret_cast<uint32_t*>(obase + (int64_t)row * kD + col) =
          pack_bf16(__fmul_rn(o[4 * j], inv0), __fmul_rn(o[4 * j + 1], inv0));
    if (row + 8 < sq)
      *reinterpret_cast<uint32_t*>(obase + (int64_t)(row + 8) * kD + col) =
          pack_bf16(__fmul_rn(o[4 * j + 2], inv1), __fmul_rn(o[4 * j + 3], inv1));
  }
}

}  // namespace

// q, out: [BH, sq, 64] bf16; k, v: [BH, skv, 64] bf16; all contiguous and
// 16-byte aligned, rows of k and v at or past kv_len finite (the wrapper
// zeroes them). qscale: the sm_scale * log2(e) fold, applied here as
// bf16(q * qscale). No padding: TMA reads rows past the ends as zeros and
// rows past sq are not written.
extern "C" int aether_flash_online_bf16(const void* q, const void* k, const void* v, void* out,
                                        int BH, int sq, int skv, int kv_len, int round_l,
                                        float qscale, void* stream) {
  if (BH <= 0 || sq <= 0 || skv <= 0 || kv_len < 0 || kv_len > skv || BH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qmap, kmap, vmap;
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!make_map_3d(&qmap, q, bf16, 2, kD, sq, BH, kD, kBM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_3d(&kmap, k, bf16, 2, kD, skv, BH, kD, kBN, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_3d(&vmap, v, bf16, 2, kD, skv, BH, kD, kBN, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_online_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + kBM - 1) / kBM, BH);
  flash_online_bf16_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out), sq, kv_len, round_l, qscale);
  return static_cast<int>(cudaGetLastError());
}
