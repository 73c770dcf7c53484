// K6: full-int8 flash attention with an integer running max, on wgmma with
// TMA, written by hand for Hopper (sm_90a), at head_dim D = 16 to 128 in
// steps of 16 (one instance a head dim; a head dim between them runs the
// next one up on operands its wrapper pads with zero columns, which change
// no score and no sum; 128 takes the JAX kernel's 113-127).
//
// Replaces aether_tpu/ops/flash_attention.py::_flash_kernel_pv8 (:259, the
// Pallas TPU kernel launched by flash_attention(fixed_max=True,
// qk_int8=True, pv_int8=True); the DiT's attention at AETHER_ATTN_PV8=1).
// Non-causal, in the log2 domain; q, k and v are int8 with one scale per
// head group g. Per span of `span` kv columns (the TPU kernel's kv block,
// _pick_block(Skv, 1024)):
//   s   = f32(int32(q8 . k8^T)) * scale_g, + (-1e9) at columns >= kv_len
//   m'  = max(m, ceil(rowmax s)),  m starting at -1e9
//   p8  = rint(127 * exp2(s - m'))                   (0..127)
//   acc = acc * exp2(m - m') + f32(int32(p8 . v8))   (exp2 of an integer: exact)
//   l   = l * exp2(m - m') + f32(127 * int32(sum p8))
//   out = acc / l * vscale_g                          (l = 0 -> divide by 1)
// The TPU kernel rounded p8 against the running max of its whole 1024-column
// block. A kernel that moves the max every tile would round differently, so
// each span is swept twice: the first sweep takes the row max over the span,
// the second recomputes s and runs p8 . v8. (One sweep would have to keep the
// span's scores: 64 rows x 1024 x 4 bytes = 256 KB of s32 a warpgroup, more
// than shared memory, and 21-bit values do not fit 16 bits.) Within a span
// every product and sum is an integer below 2^24 (127 * 127 * 1024), so the
// int32 accumulators and their f32 conversion are exact and the kernel
// computes the TPU kernel's function up to exp2f's last bit.
//
// What bounds it on an H100: at the CFG pair's 2 x 48 heads x 15076 tokens
// and D 64, the two sweeps make QK^T twice and PV once, 8.4e12 int8 ops (4.2
// ms at 1979 TOP/s), and 2.2e10 exp2 on the SFU (16 a clock an SM: 5.2 ms at
// 1.98 GHz), so the SFU binds; around each exp2 a score needs about eight
// more instructions (the dequantization, the max subtraction, the rounding
// to p8), which share its issue slots. At batch 1 the operations are 6.5e10
// x D (3.7 ms at D 112) against the SFU's 2.61 ms: the SFU binds below D 80,
// the products above. The design:
//   * a CTA takes 64 x kWG q rows: kWG consumer warpgroups of 64 rows and
//     a producer; grid (q tiles, B*H). kWG is 3 up to D 64 (three rather
//     than two cut the L2 traffic of the K and V^T tiles by a third) and 2
//     above it. A consumer thread holds 64 s32 of S, D / 2 s32 of the span's
//     P V, D / 2 f32 of the output and 16 packed p8, 192 registers at D 112
//     before addresses. Registers are shared out by SM sub-partition, a
//     quarter of the warps on each: with one producer warp, 3 warpgroups
//     leave a thread 128 registers and 2 leave it 168 (ptxas -v, as
//     time_hd_cells.py prints it: no spill at D 16; 32-432 bytes at 32-112,
//     164 at 64). So at D 32, 48 and 80-112 the producer is a whole
//     warpgroup that gives its registers to the consumers (setmaxnreg: 24
//     for it, 160 a consumer thread at kWG 3, 240 at kWG 2; the CTA starts
//     with 128 or 168 a thread, 512 or 384 threads, and inc waits until dec
//     has freed enough, so the two must not ask for more than that; no
//     spill); D 16 and 64 keep the producer warp (D 64: the kernel as it
//     was before it took other head dims);
//   * the producer walks the same sequence of kv tiles of 128 columns as the
//     consumers (per span: the K tiles of sweep 1, then K and V^T of sweep
//     2) and keeps them in flight in a ring of kStages slots by TMA; q8 and
//     k8 rows are the head dim rounded up to a swizzle row (32 bytes at D 16
//     and 32, 64 at 48 and 64, 128 above; TMA fills the columns past D with
//     zeros, nothing is padded in device memory), v8^T rows 128 bytes;
//   * S = Q8 K8^T is ceil(D / 32) k steps of wgmma m64n128k32 s8 with both
//     operands from shared memory; P8 V8 is wgmma m64nDk32 s8 with p8 from
//     registers, in flight while the next tile's Q K^T is issued. For 8-bit
//     types wgmma takes both operands K-major, so v8 comes transposed ([BH,
//     D, Skv]) with the kv order inside every 32-column chunk permuted to the
//     order in which a thread holds p8 (the s32 accumulator of QK^T;
//     ops/flash_attention.py::_pv8_v_layout; it does not depend on D);
//   * the SFU is left to exp2 alone: int <-> float moves use the 1.5 * 2^23
//     trick on the FMA and integer units (the conversion unit, which
//     I2F, rintf and F2I would take, is as slow as the SFU),
//     exp2 is one SFU instruction (exp2_ftz: p8 of a p below 2^-126 is 0
//     either way), sweep 1 takes its max over the integers (s rises with
//     them) and converts once, and the row sums of p8 are dp4a byte sums of
//     the packed A fragments;
//   * the span's PV sums stay in s32 registers and fold into the f32
//     accumulator once per span; tiles and spans wholly past kv_len are
//     skipped (they change nothing: alpha = 1, p8 = 0) and only the last
//     tile takes the mask.
// Compiled without --use_fast_math so exp2f (alpha) and the division stay
// accurate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBN = 128;                    // kv columns per tile
constexpr int kStages = 4;
constexpr float kNeg = -1e9f;               // padding bias and initial max (the TPU kernel's)
constexpr unsigned kFull = 0xffffffffu;

// The tile plan of head dim D (the note above)
template <int D>
struct Plan {
  static_assert(D % 16 == 0 && D >= 16 && D <= 128, "head_dim: 16 to 128 in steps of 16");
  static constexpr int kWG = D <= 64 ? 3 : 2;       // consumer warpgroups, 64 q rows each
  static constexpr int kBM = 64 * kWG;              // q rows per CTA
  static constexpr int kConsumers = 128 * kWG;
  // the producer: a warp, or a warpgroup that hands its registers on
  static constexpr bool kProducerWG = D != 16 && D != 64;
  static constexpr int kThreads = kConsumers + (kProducerWG ? 128 : 32);
  static constexpr int kProducerRegs = 24, kConsumerRegs = kWG == 3 ? 160 : 240;
  static_assert(!kProducerWG || 128 * kProducerRegs + kConsumers * kConsumerRegs <=
                                    kThreads * ((65536 / kThreads) & ~7),
                "setmaxnreg asks for more registers than the CTA starts with");
  static constexpr int kRow = D <= 32 ? 32 : D <= 64 ? 64 : 128;  // bytes of a q8 / k8 row
  static constexpr int kSteps = (D + 31) / 32;      // k steps of Q K^T
  static constexpr Swizzle kSwz = kRow == 32 ? kSw32 : kRow == 64 ? kSw64 : kSw128;
  static constexpr CUtensorMapSwizzle kMapSwz =
      kRow == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                 : kRow == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  static constexpr int kKTile = kBN * kRow;         // bytes of a K tile
  static constexpr int kVTile = D * kBN;            // bytes of a V^T tile
};

template <int D>
struct Smem {
  using P = Plan<D>;
  int8_t q[P::kBM * P::kRow];
  int8_t k[kStages][P::kKTile];   // 128 kv rows x kRow bytes
  int8_t vt[kStages][P::kVTile];  // D output columns x 128 kv bytes
  Ring<kStages> ring;
  uint64_t q_full;
};

// the low bytes of a, b, c, d packed into one word, a lowest
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

template <typename T> __device__ __forceinline__ void store2(T* p, float a, float b);
template <> __device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a,
                                                                 float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// p8 of one tile packed as the A fragments of P8 V8 (logical k 4c..4c+3 of
// 32-column chunk kk = columns 2c, 2c+1 of accumulator chunks 4kk and
// 4kk+1; k 16+4c.. = the same of chunks 4kk+2 and 4kk+3: v8t's permuted
// order). p8 = rint(127 p) is the low byte of kMagicF + 127 p (round to
// nearest even at unit spacing, as rintf); the products and sums stay
// unfused, as the plain version rounds them. Tail: columns >= kv_len get
// the -1e9 bias.
template <bool kTail>
__device__ __forceinline__ void p8_tile(uint32_t (&pa)[4][4], const int (&acc)[64], float sc,
                                        float m0, float m1, int kv0, int kv_len, int c) {
  uint32_t b[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    float x = __fmul_rn(exact_f32(acc[i]), sc);
    if (kTail && kv0 + 8 * (i / 4) + 2 * c + (i % 2) >= kv_len) x = __fadd_rn(x, kNeg);
    const float p = exp2_ftz(__fsub_rn(x, (i % 4) < 2 ? m0 : m1));
    b[i] = __float_as_uint(__fadd_rn(__fmul_rn(p, 127.0f), kMagicF));
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int j = 16 * kk;
    pa[kk][0] = pack4(b[j], b[j + 1], b[j + 4], b[j + 5]);
    pa[kk][1] = pack4(b[j + 2], b[j + 3], b[j + 6], b[j + 7]);
    pa[kk][2] = pack4(b[j + 8], b[j + 9], b[j + 12], b[j + 13]);
    pa[kk][3] = pack4(b[j + 10], b[j + 11], b[j + 14], b[j + 15]);
  }
}

// int32 q8 . k8^T of one tile (this thread's accumulator fragment)
template <int D>
__device__ __forceinline__ void qk(int (&acc)[64], int8_t* ks, uint64_t qdesc) {
  using P = Plan<D>;
  const uint64_t kdesc = make_desc(ks, 16, 8 * P::kRow, P::kSwz);
  wgmma_fence();
#pragma unroll
  for (int st = 0; st < P::kSteps; ++st)
    wgmma_m64n128k32_ss_s8(acc, desc_add(qdesc, 32 * st), desc_add(kdesc, 32 * st), st > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

template <int D, typename T>
__global__ void __launch_bounds__(Plan<D>::kThreads, 1)
flash_pv8_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const float* __restrict__ scale,
                 const float* __restrict__ vscale, T* __restrict__ out, int sq, int kv_len,
                 int hper, int span) {
  using P = Plan<D>;
  constexpr int kBM = P::kBM, kConsumers = P::kConsumers;
  extern __shared__ uint8_t smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBM;
  const int tile_end = ((kv_len + kBN - 1) / kBN) * kBN;  // later tiles are all masked

  if (threadIdx.x == 0) {
    sm.ring.init(kConsumers);
    mbar_init(&sm.q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer: the consumers' sequence of tiles, sweep by sweep ----
    if constexpr (P::kProducerWG) setmaxnreg_dec<P::kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(&sm.q_full, kBM * P::kRow);
      tma_load_3d(sm.q, &qmap, &sm.q_full, 0, q0, bh);
      int item = 0;
      for (int span0 = 0; span0 < tile_end; span0 += span) {
        const int end = min(span0 + span, tile_end);
        for (int kv0 = span0; kv0 < end; kv0 += kBN, ++item) {
          const int s = sm.ring.acquire(item, P::kKTile);
          tma_load_3d(sm.k[s], &kmap, &sm.ring.full[s], 0, kv0, bh);
        }
        for (int kv0 = span0; kv0 < end; kv0 += kBN, ++item) {
          const int s = sm.ring.acquire(item, P::kKTile + P::kVTile);
          tma_load_3d(sm.k[s], &kmap, &sm.ring.full[s], 0, kv0, bh);
          tma_load_3d(sm.vt[s], &vmap, &sm.ring.full[s], kv0, 0, bh);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns q rows q0 + 64 wg .. + 63 ----
  if constexpr (P::kProducerWG) setmaxnreg_inc<P::kConsumerRegs>();
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int lane = tid % 32, warp = t / 32;
  const int c = lane % 4;
  const int g = bh / hper;
  const float sc = scale[g];
  mbar_wait(&sm.q_full, 0);
  const uint64_t qdesc = make_desc(sm.q + wg * 64 * P::kRow, 16, 8 * P::kRow, P::kSwz);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float m0 = kNeg, m1 = kNeg;  // running max of rows r and r + 8
  float l0 = 0.0f, l1 = 0.0f;
  int item = 0;

  for (int span0 = 0; span0 < tile_end; span0 += span) {
    const int end = min(span0 + span, tile_end);

    // sweep 1: the row max of s over the span. s = f32(int) * sc with sc >
    // 0 rises with the integer, so the max is taken over the integers of
    // the valid columns and converted once; a masked column scores exactly
    // -1e9 (its k row is zero)
    int mi0 = INT_MIN, mi1 = INT_MIN;
    for (int kv0 = span0; kv0 < end; kv0 += kBN, ++item) {
      const int s = sm.ring.wait_full(item);
      int acc[64];
      qk<D>(acc, sm.k[s], qdesc);
      sm.ring.release(item);
      if (kv0 + kBN > kv_len) {
#pragma unroll
        for (int i = 0; i < 64; ++i)
          if (kv0 + 8 * (i / 4) + 2 * c + (i % 2) >= kv_len) acc[i] = INT_MIN;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        mi0 = max(mi0, max(acc[4 * j], acc[4 * j + 1]));
        mi1 = max(mi1, max(acc[4 * j + 2], acc[4 * j + 3]));
      }
    }
    float mx0 = mi0 == INT_MIN ? -INFINITY : __fmul_rn(exact_f32(mi0), sc);
    float mx1 = mi1 == INT_MIN ? -INFINITY : __fmul_rn(exact_f32(mi1), sc);
    if (end > kv_len) {
      mx0 = fmaxf(mx0, kNeg);
      mx1 = fmaxf(mx1, kNeg);
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
    const float mn0 = fmaxf(m0, ceilf(mx0)), mn1 = fmaxf(m1, ceilf(mx1));
    const float alpha0 = exp2f(__fsub_rn(m0, mn0)), alpha1 = exp2f(__fsub_rn(m1, mn1));
    m0 = mn0;
    m1 = mn1;

    // sweep 2: p8 = rint(127 exp2(s - m)), p8 . v8 in s32 over the span
    int pv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) pv[i] = 0;
    uint32_t ls0 = 0, ls1 = 0;  // row sums of p8 (rows r, r + 8)
    // a tile's P8 V8 stays in flight while the next tile's Q K^T is issued;
    // one wait (in qk) covers both
    uint32_t pa[4][4];
    for (int kv0 = span0; kv0 < end; kv0 += kBN, ++item) {
      const int s = sm.ring.wait_full(item);
      int acc[64];
      qk<D>(acc, sm.k[s], qdesc);
      fence_regs(pv);
      fence_regs(pa);
      if (kv0 > span0) sm.ring.release(item - 1);  // its P8 V8 has completed
      if (kv0 + kBN > kv_len)
        p8_tile<true>(pa, acc, sc, m0, m1, kv0, kv_len, c);
      else
        p8_tile<false>(pa, acc, sc, m0, m1, kv0, kv_len, c);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // byte sums of the packed p8
        ls0 = __dp4a(pa[kk][0], 0x01010101u, __dp4a(pa[kk][2], 0x01010101u, ls0));
        ls1 = __dp4a(pa[kk][1], 0x01010101u, __dp4a(pa[kk][3], 0x01010101u, ls1));
      }
      const uint64_t vdesc = make_desc(sm.vt[s], 16, 1024, kSw128);
      fence_regs(pv);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_s8<D>(pv, pa[kk], desc_add(vdesc, 32 * kk), 1);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(pv);
    fence_regs(pa);
    sm.ring.release(item - 1);
    ls0 += __shfl_xor_sync(kFull, ls0, 1);
    ls0 += __shfl_xor_sync(kFull, ls0, 2);
    ls1 += __shfl_xor_sync(kFull, ls1, 1);
    ls1 += __shfl_xor_sync(kFull, ls1, 2);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j] = __fadd_rn(__fmul_rn(acc[4 * j], alpha0), (float)pv[4 * j]);
      acc[4 * j + 1] = __fadd_rn(__fmul_rn(acc[4 * j + 1], alpha0), (float)pv[4 * j + 1]);
      acc[4 * j + 2] = __fadd_rn(__fmul_rn(acc[4 * j + 2], alpha1), (float)pv[4 * j + 2]);
      acc[4 * j + 3] = __fadd_rn(__fmul_rn(acc[4 * j + 3], alpha1), (float)pv[4 * j + 3]);
    }
    l0 = __fadd_rn(__fmul_rn(l0, alpha0), (float)(127 * static_cast<int>(ls0)));
    l1 = __fadd_rn(__fmul_rn(l1, alpha1), (float)(127 * static_cast<int>(ls1)));
  }

  const float vs = vscale[g];
  const float inv0 = l0 <= 0.0f ? 1.0f : __fdiv_rn(1.0f, l0);
  const float inv1 = l1 <= 0.0f ? 1.0f : __fdiv_rn(1.0f, l1);
  const int row = q0 + wg * 64 + warp * 16 + lane / 4;
  T* obase = out + (int64_t)bh * sq * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * c;
    if (row < sq)
      store2<T>(obase + (int64_t)row * D + col, __fmul_rn(__fmul_rn(acc[4 * j], inv0), vs),
                __fmul_rn(__fmul_rn(acc[4 * j + 1], inv0), vs));
    if (row + 8 < sq)
      store2<T>(obase + (int64_t)(row + 8) * D + col,
                __fmul_rn(__fmul_rn(acc[4 * j + 2], inv1), vs),
                __fmul_rn(__fmul_rn(acc[4 * j + 3], inv1), vs));
  }
}

// One launch of the instance <D, T> (q8, k8 and v8t checked by the caller),
// grid (q tiles, BH). Returns a cudaError_t: cudaErrorInvalidValue where
// cuTensorMapEncodeTiled refuses a map.
template <int D, typename T>
int launch(const void* q8, const void* k8, const void* v8t, const void* scale,
           const void* vscale, void* out, int BH, int sq, int skv, int kv_len, int hper,
           int span, cudaStream_t stream) {
  using P = Plan<D>;
  CUtensorMap qmap, kmap, vmap;
  const CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  if (!make_map_3d(&qmap, q8, u8, 1, D, sq, BH, P::kRow, P::kBM, P::kMapSwz) ||
      !make_map_3d(&kmap, k8, u8, 1, D, skv, BH, P::kRow, kBN, P::kMapSwz) ||
      !make_map_3d(&vmap, v8t, u8, 1, skv, D, BH, kBN, D, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kSmem = sizeof(Smem<D>) + 1024;  // + 1024: tiles on 1024-byte boundaries
  auto kernel = flash_pv8_kernel<D, T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + P::kBM - 1) / P::kBM, BH);
  kernel<<<grid, P::kThreads, kSmem, stream>>>(
      qmap, kmap, vmap, static_cast<const float*>(scale), static_cast<const float*>(vscale),
      static_cast<T*>(out), sq, kv_len, hper, span);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(int D, const void* q8, const void* k8, const void* v8t, const void* scale,
               const void* vscale, void* out, int BH, int sq, int skv, int kv_len, int hper,
               int span, cudaStream_t st) {
  switch (D) {
#define AETHER_PV8_CASE(d) \
    case d: return launch<d, T>(q8, k8, v8t, scale, vscale, out, BH, sq, skv, kv_len, hper, span, st);
    AETHER_PV8_CASE(16) AETHER_PV8_CASE(32) AETHER_PV8_CASE(48) AETHER_PV8_CASE(64)
    AETHER_PV8_CASE(80) AETHER_PV8_CASE(96) AETHER_PV8_CASE(112) AETHER_PV8_CASE(128)
#undef AETHER_PV8_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q8, k8: [BH, sq | skv, D] int8; v8t: [BH, D, skv] int8 in _pv8_v_layout's
// order; scale, vscale: [BH / hper] f32; out: [BH, sq, D] of float (dtype 0)
// or bf16 (dtype 1). All contiguous and 16-byte aligned; sq a multiple of
// 64, span a multiple of 128 dividing skv, rows past the data zero,
// 0 < kv_len <= skv; D one of 16, 32, 48, 64, 80, 96, 112, 128. Returns a
// cudaError_t.
extern "C" int aether_flash_pv8(const void* q8, const void* k8, const void* v8t,
                                const void* scale, const void* vscale, void* out, int BH,
                                int sq, int skv, int kv_len, int hper, int span, int dtype,
                                int D, void* stream) {
  if (sq <= 0 || sq % 64 || span <= 0 || span % kBN || skv % span || kv_len <= 0 ||
      kv_len > skv || hper <= 0 || BH <= 0 || BH % hper || BH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dim<float>(D, q8, k8, v8t, scale, vscale, out, BH, sq, skv, kv_len, hper,
                             span, st);
  if (dtype == 1)
    return launch_dim<__nv_bfloat16>(D, q8, k8, v8t, scale, vscale, out, BH, sq, skv, kv_len,
                                     hper, span, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
