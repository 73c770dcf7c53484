// K1: the fused QKV attention prologue, hand-written for Hopper (sm_90a).
//
// Replaces aether_tpu/ops/attn_prologue.py::_prologue_kernel (the Pallas TPU
// kernel launched by qkv_prologue). For every (head group g x token tile t)
// quantization cell it computes, per row and head:
//   shifted single-pass LayerNorm over head_dim (eps, affine), the moments
//   in double as the plain PyTorch version takes them
//   -> interleaved-pair RoPE (rows past the table use cos = sin = 0)
//   -> rows >= s_valid zeroed
//   -> symmetric int8 quantization with ONE absmax/127 scale per cell
//      (quantize), or bf16 z * fold for q and bf16 z for k (!quantize, the
//      AETHER_ATTN_QK8=0 branch of the TPU kernel, attn_prologue.py:150-151),
// plus the per-cell max row L2 norm, and copies v (rows >= s_valid zeroed).
// The cell is (hper heads) x (block tokens) exactly as _pick_pad_and_block
// chose it: that is a numerics choice, independent of the CUDA tile.
//
// What bounds it on an H100: bytes. It must read q, k and v in bf16 and write
// int8 (or bf16) q/k and bf16 v: 472 MB at the 48-head 15360-token shape with
// int8 codes, 0.14 ms at 3.35 TB/s, against ~30 flops an element of q and k.
// The design reads every element of the projection from device memory once,
// in one launch:
//   * A cell of one tensor (hper heads x block rows, 512 KB at 4 x 1024) is
//     more than an SM's shared memory, so it is spread over a thread-block
//     cluster of block / 128 CTAs (8 at block 1024, the portable maximum).
//     Each CTA brings its 128 rows x hper heads into shared memory with one
//     TMA box a head (64 elements x 128 rows, the 128-byte swizzle), read in
//     place from the fused [B, S_in, 3*H*64] projection through its row and
//     batch strides; a head group that straddles two batch elements is just
//     boxes at other coordinates, and rows past S_in arrive as TMA's zeros.
//   * Each CTA computes z for its rows, its absmax and its largest row norm,
//     and publishes the two in its shared memory. After a cluster barrier
//     one warp reads every rank's pair through distributed shared memory
//     (mapa) and takes the maxima: the same in every CTA, with no atomics
//     and no scratch buffer. Each CTA then quantizes its own rows from the
//     copy it holds, recomputing z with the same instructions from the same
//     inputs and the same stored (mean, 1/sqrt(var + eps)), so the z that is
//     quantized is bit for bit the z whose absmax was reduced and no code
//     leaves [-127, 127]. A second cluster barrier (arrived at once the
//     remote reads are done, waited on before exit) keeps every CTA's shared
//     memory alive while another may still read it.
//   * Eight lanes own a (row, head), one 16-byte chunk (8 columns) each: the
//     moments are three shuffle levels, the RoPE partner sits in the same
//     lane, and a quarter-warp reads one row's eight chunks, which the
//     swizzle spreads over all banks. A thread keeps its 8 columns of gamma
//     and beta in registers, and the RoPE row of its token once for all hper
//     heads: 80 registers and 69 KB of shared memory, so that three CTAs
//     (24 warps) share an SM. The arithmetic, not the bytes, sets the pace
//     at that occupancy: two CTAs an SM ran 1.3x slower, and a persistent
//     grid of one 512-thread CTA an SM with double-buffered boxes 1.3x
//     slower too (PERF.md, section 6).
//   * int8 codes are rint(z * r) rounded in the FMA pipe (+ 1.5 * 2^23, round
//     to nearest even as rintf) and packed from the low byte of the float's
//     bits, off the conversion unit.
//   * Jobs are (tensor, cell, rank): q and k cells reduce independently; v
//     jobs copy their box to the head-major output, zeroing rows >= s_valid,
//     and reduce nothing. CTAs whose rows all lie at or past s_valid load
//     nothing.
// Compiled without --use_fast_math: sqrtf, division and the RoPE products must
// stay IEEE so that both passes and the plain PyTorch version agree.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kD = 64;                     // head_dim handled by this kernel
constexpr int kRows = 128;                 // token rows of one CTA: one TMA box a head
constexpr int kThreads = 256;              // 32 rows x 8 lanes at a time
constexpr int kLanes = 8;                  // lanes a (row, head), 8 columns each
constexpr int kRowsAtOnce = kThreads / kLanes;
constexpr int kMaxHeads = 4;               // hper
constexpr int kMaxCluster = 8;             // the portable cluster size
constexpr int kBoxBytes = kRows * kD * 2;  // one head's bf16 box, 16 KB
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* gamma[2];  // q / k LayerNorm scale, [D]
  const float* beta[2];   // q / k LayerNorm bias, [D]
  const float* cos;       // [rope_rows, D] or null
  const float* sin;
  int rope_rows;
  int H, s_pad, s_valid, hper, cluster;
  float eps;
  float fold[2];          // what q / k are multiplied by in the float branch
  float scale[2];         // absmax -> qsc / ksc: fold / 127, 1 / 127
  void* out[2];           // q, k: int8 (quantize) or bf16, [B*H, s_pad, D]
  __nv_bfloat16* v;       // [B*H, s_pad, D]
  float* sc[2];           // qsc, ksc [G, T]
  float* nrm[2];          // qn, kn [G, T]
};

// Shared memory after the hper boxes (1024-byte aligned, first) and the
// per-(head, row) (mean, inv) pairs of the row statistics.
struct Tail {
  uint64_t bar;                // the boxes' TMA completion
  float pub[2];                // this CTA's absmax and largest row |z|^2, for the cluster
  float cell[2];               // the cell's
  float red[2][kThreads / 32];
};

constexpr int smem_bytes_for(int hper) {
  return 1024 + hper * (kBoxBytes + kRows * (int)sizeof(float2)) + (int)sizeof(Tail);
}

// the 8 bf16 inputs of chunk `part` (columns 8 part .. 8 part + 7) of row r
// of a swizzled box
__device__ __forceinline__ void load_x(const uint8_t* box, int r, int part, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(box + r * 128 + ((part ^ (r & 7)) << 4));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    x[2 * e] = __uint_as_float(w[e] << 16);
    x[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
  }
}

// column 0 of row r of a swizzled box
__device__ __forceinline__ float first_x(const uint8_t* box, int r) {
  const uint16_t u = *reinterpret_cast<const uint16_t*>(box + r * 128 + ((r & 7) << 4));
  return __uint_as_float(static_cast<uint32_t>(u) << 16);
}

// y = x - x[0] for the lane's 8 columns
__device__ __forceinline__ void shifted(const uint8_t* box, int r, int part, float (&y)[8]) {
  load_x(box, r, part, y);
  const float c = first_x(box, r);
#pragma unroll
  for (int i = 0; i < 8; ++i) y[i] = __fsub_rn(y[i], c);
}

// (mean, 1 / sqrt(var + eps)) of the row over its eight lanes, the moments
// in double and rounded to f32 as the plain version rounds them. The
// butterfly gives all eight lanes the same bits (each level adds a pair).
// Warp-collective: the whole warp calls it.
__device__ __forceinline__ float2 moments(const float (&y)[8], float eps) {
  // pairwise, so that the dependent chain is three adds deep, not eight; d * d
  // is exact in double, so the fma rounds as add(mul) would
  double p1[4], p2[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const double d0 = y[2 * i], d1 = y[2 * i + 1];
    p1[i] = __dadd_rn(d0, d1);
    p2[i] = __fma_rn(d1, d1, __dmul_rn(d0, d0));
  }
  double s1 = __dadd_rn(__dadd_rn(p1[0], p1[1]), __dadd_rn(p1[2], p1[3]));
  double s2 = __dadd_rn(__dadd_rn(p2[0], p2[1]), __dadd_rn(p2[2], p2[3]));
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) {
    s1 = __dadd_rn(s1, __shfl_xor_sync(kFull, s1, o));
    s2 = __dadd_rn(s2, __shfl_xor_sync(kFull, s2, o));
  }
  const double m1 = __dmul_rn(s1, 1.0 / kD);
  const float mean = __double2float_rn(m1);
  const float var =
      __double2float_rn(fmax(__dsub_rn(__dmul_rn(s2, 1.0 / kD), __dmul_rn(m1, m1)), 0.0));
  // the correctly rounded reciprocal is the correctly rounded 1 / x
  return make_float2(mean, __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps))));
}

enum Rope { kNoRope = 0, kRopeRow = 1, kPastTable = 2 };

// z in place of y: ((y - mean) * inv) * gamma + beta, then the pair rotation
// (z @ R)[2i] = -z[2i+1], (z @ R)[2i+1] = z[2i] against the row's tables
__device__ __forceinline__ void normalize(float (&y)[8], float2 mi, const float (&g)[8],
                                          const float (&b)[8], int rope, const float (&cs)[8],
                                          const float (&sn)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    y[i] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(y[i], mi.x), mi.y), g[i]), b[i]);
  if (rope == kRopeRow) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float z0 = y[2 * p], z1 = y[2 * p + 1];
      y[2 * p] = __fadd_rn(__fmul_rn(z0, cs[2 * p]), __fmul_rn(-z1, sn[2 * p]));
      y[2 * p + 1] = __fadd_rn(__fmul_rn(z1, cs[2 * p + 1]), __fmul_rn(z0, sn[2 * p + 1]));
    }
  } else if (rope == kPastTable) {  // the TPU wrapper zero-pads the tables
#pragma unroll
    for (int i = 0; i < 8; ++i) y[i] = 0.0f;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&dst)[8]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p) + i);
    dst[4 * i] = f.x;
    dst[4 * i + 1] = f.y;
    dst[4 * i + 2] = f.z;
    dst[4 * i + 3] = f.w;
  }
}

// which RoPE case `row` is in, with its 8 columns of the tables loaded
__device__ __forceinline__ int rope_row(const Args& a, int row, int part, float (&cs)[8],
                                        float (&sn)[8]) {
  if (a.cos == nullptr) return kNoRope;
  if (row >= a.rope_rows) return kPastTable;
  load8(a.cos + (int64_t)row * kD + 8 * part, cs);
  load8(a.sin + (int64_t)row * kD + 8 * part, sn);
  return kRopeRow;
}

// v: the box copied to [B*H, s_pad, D], rows >= s_valid zeroed
__device__ __forceinline__ void copy_v(const Args& a, const uint8_t* xs, int g, int row0) {
  const int chunks = a.hper * kRows * 8;  // 16-byte chunks
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    const int j = c / (kRows * 8), r = (c / 8) % kRows, ch = c % 8;
    const int row = row0 + r, bh = g * a.hper + j;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (row < a.s_valid)
      u = *reinterpret_cast<const uint4*>(xs + j * kBoxBytes + r * 128 + ((ch ^ (r & 7)) << 4));
    *reinterpret_cast<uint4*>(a.v + ((int64_t)bh * a.s_pad + row) * kD + 8 * ch) = u;
  }
}

// the low byte of the bits of rint(v) + 1.5 * 2^23 is rint(v) as an int8 for
// |v| <= 127: v * r rounded as jnp.rint / rintf (to nearest, ties to even)
__device__ __forceinline__ uint32_t code_bits(float z, float r) {
  return __float_as_uint(__fadd_rn(__fmul_rn(z, r), 12582912.0f));
}

// the lane's 8 outputs of one (row, head): int8 codes rint(z * r), or bf16 z * f
template <bool kQuantize>
__device__ __forceinline__ void store_row(void* out, int64_t elem, const float (&z)[8],
                                          float rf) {
  if (kQuantize) {
    uint32_t w[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const uint32_t lo = __byte_perm(code_bits(z[4 * e], rf), code_bits(z[4 * e + 1], rf), 0x0040);
      const uint32_t hi =
          __byte_perm(code_bits(z[4 * e + 2], rf), code_bits(z[4 * e + 3], rf), 0x0040);
      w[e] = __byte_perm(lo, hi, 0x5410);
    }
    *reinterpret_cast<uint2*>(static_cast<int8_t*>(out) + elem) = make_uint2(w[0], w[1]);
  } else {
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 h =
          __floats2bfloat162_rn(__fmul_rn(z[2 * e], rf), __fmul_rn(z[2 * e + 1], rf));
      w[e] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + elem) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Grid (s_pad / 128, 3 * G): blockIdx.x is the CTA's 128-row slice (a
// cluster of `cluster` consecutive slices is one token tile), blockIdx.y / 3
// the head group and blockIdx.y % 3 the tensor (q, k, v).
template <bool kQuantize>
__global__ void __launch_bounds__(kThreads, 3)
prologue_kernel(const __grid_constant__ CUtensorMap xq, const __grid_constant__ CUtensorMap xk,
                const __grid_constant__ CUtensorMap xv, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  // the boxes on a 1024-byte boundary (the swizzle's period); an offset from
  // smem_raw, so that the compiler keeps shared-memory loads
  uint8_t* xs = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  float2* stats = reinterpret_cast<float2*>(xs + a.hper * kBoxBytes);  // [hper][kRows]
  Tail& tl = *reinterpret_cast<Tail*>(xs + a.hper * (kBoxBytes + kRows * (int)sizeof(float2)));
  const int tensor = blockIdx.y % 3, g = blockIdx.y / 3;
  const int row0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const bool loads = row0 < a.s_valid;
  const CUtensorMap* map = tensor == 0 ? &xq : tensor == 1 ? &xk : &xv;

  if (tid == 0) {
    mbar_init(&tl.bar, 1);
    mbar_init_fence();
    if (loads) {
      mbar_expect_tx(&tl.bar, a.hper * kBoxBytes);
      for (int j = 0; j < a.hper; ++j) {
        const int bh = g * a.hper + j;
        tma_load_3d(xs + j * kBoxBytes, map, &tl.bar, (bh % a.H) * kD, row0, bh / a.H);
      }
    }
  }
  __syncthreads();  // the barrier is initialised before anyone waits on it
  if (tensor == 2) {
    if (loads) mbar_wait(&tl.bar, 0);
    copy_v(a, xs, g, row0);
    return;
  }

  // ---- q or k: eight lanes a row, 32 rows at a time ----
  const int part = tid % kLanes, rsub = tid / kLanes, lane = tid & 31;
  float gm[8], bt[8], cs[8], sn[8];
  load8(a.gamma[tensor] + 8 * part, gm);
  load8(a.beta[tensor] + 8 * part, bt);
  float amax = 0.0f, n2max = 0.0f;
  if (loads) mbar_wait(&tl.bar, 0);
#pragma unroll 1
  for (int i = 0; i < kRows / kRowsAtOnce; ++i) {
    const int r = rsub + kRowsAtOnce * i, row = row0 + r;
    // rows only grow with i; the warp's four rows go on together while its
    // first is valid (the shuffles take the whole warp), the rest add nothing
    if (row0 + kRowsAtOnce * i + (tid / 32) * (32 / kLanes) >= a.s_valid) break;
    const bool valid = row < a.s_valid;
    const int rope = rope_row(a, row, part, cs, sn);
#pragma unroll 1
    for (int j = 0; j < a.hper; ++j) {
      float z[8];
      shifted(xs + j * kBoxBytes, r, part, z);
      const float2 mi = moments(z, a.eps);
      if (part == 0) stats[j * kRows + r] = mi;
      normalize(z, mi, gm, bt, rope, cs, sn);
      float n2p[2] = {0.0f, 0.0f};
      float am = 0.0f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        am = fmaxf(am, fabsf(z[e]));
        n2p[e % 2] = __fmaf_rn(z[e], z[e], n2p[e % 2]);
      }
      if (valid) amax = fmaxf(amax, am);
      float n2 = __fadd_rn(n2p[0], n2p[1]);
#pragma unroll
      for (int o = 1; o < kLanes; o <<= 1) n2 = __fadd_rn(n2, __shfl_xor_sync(kFull, n2, o));
      if (valid) n2max = fmaxf(n2max, n2);
    }
  }
  // non-negative floats order like their bit patterns
  const unsigned am = __reduce_max_sync(kFull, __float_as_uint(amax));
  const unsigned nm = __reduce_max_sync(kFull, __float_as_uint(n2max));
  if (lane == 0) {
    tl.red[0][tid / 32] = __uint_as_float(am);
    tl.red[1][tid / 32] = __uint_as_float(nm);
  }
  __syncthreads();
  if (tid < 2) {
    float m = 0.0f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) m = fmaxf(m, tl.red[tid][w]);
    tl.pub[tid] = m;
  }
  cluster_arrive();  // publishes pub to the cluster
  cluster_wait();
  if (tid < 32) {  // one warp takes the maxima over the cluster's ranks
    float m0 = 0.0f, m1 = 0.0f;
    if (lane < a.cluster) {
      m0 = cluster_load(cluster_map(&tl.pub[0], lane));
      m1 = cluster_load(cluster_map(&tl.pub[1], lane));
    }
    m0 = __uint_as_float(__reduce_max_sync(kFull, __float_as_uint(m0)));
    m1 = __uint_as_float(__reduce_max_sync(kFull, __float_as_uint(m1)));
    if (lane == 0) {
      tl.cell[0] = m0;
      tl.cell[1] = m1;
      if (cluster_ctarank() == 0) {  // one CTA of the cell writes its stats
        const int cell = g * (gridDim.x / a.cluster) + blockIdx.x / a.cluster;
        a.sc[tensor][cell] = __fmul_rn(m0, a.scale[tensor]);
        a.nrm[tensor][cell] = __fmul_rn(__fsqrt_rn(m1), a.fold[tensor]);
      }
    }
  }
  __syncthreads();
  cluster_arrive_relaxed();  // this CTA is done reading the others' shared memory

  const float amax_c = tl.cell[0];
  float rf = a.fold[tensor];
  if (kQuantize) rf = amax_c > 0.0f ? __fdiv_rn(127.0f, fmaxf(amax_c, 1e-30f)) : 0.0f;
#pragma unroll 1
  for (int i = 0; i < kRows / kRowsAtOnce; ++i) {
    const int r = rsub + kRowsAtOnce * i, row = row0 + r;
    const bool valid = row < a.s_valid;
    const int rope = valid ? rope_row(a, row, part, cs, sn) : kNoRope;
#pragma unroll 1
    for (int j = 0; j < a.hper; ++j) {
      float z[8];
      if (valid) {
        shifted(xs + j * kBoxBytes, r, part, z);
        normalize(z, stats[j * kRows + r], gm, bt, rope, cs, sn);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) z[e] = 0.0f;
      }
      const int bh = g * a.hper + j;
      store_row<kQuantize>(a.out[tensor], ((int64_t)bh * a.s_pad + row) * kD + 8 * part, z, rf);
    }
  }
  cluster_wait();  // no CTA leaves while another may read its shared memory
}

template <bool kQuantize>
int configure(int smem_bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      prologue_kernel<kQuantize>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes));
}

cudaLaunchConfig_t launch_config(dim3 grid, int cluster, int smem_bytes, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the wrapper's _launch_plan mirrors kRows and smem_bytes_for; a plan that
// drifted from them is refused here
bool plan_ok(int hper, int block, int cluster, int smem_bytes) {
  return hper >= 1 && hper <= kMaxHeads && block > 0 && block % kRows == 0 &&
         cluster == block / kRows && cluster <= kMaxCluster &&
         smem_bytes == smem_bytes_for(hper);
}

}  // namespace

// xq, xk, xv: bf16 [B, S_in, H*64] views sharing the element strides
// (stride_b, stride_s), last axis contiguous, bases and byte strides 16-byte
// aligned (TMA). The launch plan (cluster = block / 128 CTAs of 128 rows,
// smem_bytes of dynamic shared memory) comes from the wrapper's _launch_plan
// and is checked here. Returns a cudaError_t.
extern "C" int aether_qkv_prologue(
    const void* xq, const void* xk, const void* xv, int stride_b, int stride_s,
    const void* gq, const void* bq, const void* gk, const void* bk,
    const void* rope_cos, const void* rope_sin, int rope_rows,
    int B, int S_in, int H, int s_pad, int s_valid, int block, int hper, int quantize,
    float eps, float fold, float fold127, float inv127,
    void* qo, void* ko, void* v, void* qsc, void* qn, void* ksc, void* kn,
    int cluster, int smem_bytes, void* stream) {
  if (B <= 0 || H <= 0 || (B * H) % (hper > 0 ? hper : 1) || s_valid <= 0 || s_valid > S_in ||
      s_pad % (block > 0 ? block : 1) || !plan_ok(hper, block, cluster, smem_bytes) ||
      3 * (B * H / hper) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[3];
  const void* bases[3] = {xq, xk, xv};
  for (int t = 0; t < 3; ++t) {
    if (!make_map_3d_strided(&maps[t], bases[t], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                             (uint64_t)H * kD, S_in, B, (uint64_t)stride_s * 2,
                             (uint64_t)stride_b * 2, kD, kRows, CU_TENSOR_MAP_SWIZZLE_128B))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.gamma[0] = static_cast<const float*>(gq);
  a.beta[0] = static_cast<const float*>(bq);
  a.gamma[1] = static_cast<const float*>(gk);
  a.beta[1] = static_cast<const float*>(bk);
  a.cos = static_cast<const float*>(rope_cos);
  a.sin = static_cast<const float*>(rope_sin);
  a.rope_rows = rope_rows;
  a.H = H;
  a.s_pad = s_pad;
  a.s_valid = s_valid;
  a.hper = hper;
  a.cluster = cluster;
  a.eps = eps;
  a.fold[0] = fold;
  a.fold[1] = 1.0f;
  a.scale[0] = fold127;
  a.scale[1] = inv127;
  a.out[0] = qo;
  a.out[1] = ko;
  a.v = static_cast<__nv_bfloat16*>(v);
  a.sc[0] = static_cast<float*>(qsc);
  a.sc[1] = static_cast<float*>(ksc);
  a.nrm[0] = static_cast<float*>(qn);
  a.nrm[1] = static_cast<float*>(kn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = quantize ? configure<true>(smem_bytes) : configure<false>(smem_bytes);
  if (rc != 0) return rc;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config(dim3(s_pad / kRows, 3 * (B * H / hper), 1), cluster, smem_bytes, s, attr);
  cudaError_t err = quantize
      ? cudaLaunchKernelEx(&cfg, prologue_kernel<true>, maps[0], maps[1], maps[2], a)
      : cudaLaunchKernelEx(&cfg, prologue_kernel<false>, maps[0], maps[1], maps[2], a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// cudaOccupancyMaxActiveClusters for the plan: how many clusters of
// `cluster` CTAs with `smem_bytes` each the card holds at once, into
// *clusters (an int). Returns a cudaError_t.
extern "C" int aether_qkv_prologue_occupancy(int cluster, int smem_bytes, int quantize,
                                             void* clusters) {
  if (cluster < 1 || cluster > kMaxCluster || smem_bytes < smem_bytes_for(1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = quantize ? configure<true>(smem_bytes) : configure<false>(smem_bytes);
  if (rc != 0) return rc;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(dim3(cluster, 3, 1), cluster, smem_bytes, 0, attr);
  int* n = static_cast<int*>(clusters);
  return static_cast<int>(quantize
      ? cudaOccupancyMaxActiveClusters(n, prologue_kernel<true>, &cfg)
      : cudaOccupancyMaxActiveClusters(n, prologue_kernel<false>, &cfg));
}
