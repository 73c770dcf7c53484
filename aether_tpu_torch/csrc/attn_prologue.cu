// K1: the fused QKV attention prologue, hand-written for Hopper (sm_90a), at
// every even head_dim below 128: one kernel template over the width W of its
// boxes and outputs (16 to 128 in steps of 16). W = D runs D = 16 to 112 in
// steps of 16; a head dim between them (and 114 to 126) runs the instance of
// the next width up with the true D a runtime argument (kRagged, below).
//
// Replaces aether_tpu/ops/attn_prologue.py::_prologue_kernel (the Pallas TPU
// kernel launched by qkv_prologue; it takes every head_dim below 128). For
// every (head group g x token tile t) quantization cell it computes, per row
// and head:
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
// int8 codes at D 64, 0.14 ms at 3.35 TB/s, against ~30 flops an element of
// q and k. The design reads every element of the projection from device
// memory once, in one launch:
//   * A cell of one tensor (hper heads x block rows, 512 KB at 4 x 1024 x 64)
//     is more than an SM's shared memory, so it is spread over a
//     thread-block cluster of block / kRows CTAs (8 at block 1024 and 128
//     rows a CTA, the portable maximum; 4 at 256 rows; 16 at 64 rows, a
//     non-portable size). Each CTA brings its kRows rows x hper heads into shared memory with
//     one TMA box a head (D elements x kRows rows), read in place from the
//     fused [B, S_in, 3*H*D] projection through its row and batch strides; a
//     head group that straddles two batch elements is just boxes at other
//     coordinates, and rows past S_in arrive as TMA's zeros. At D 64 a box
//     row is 128 bytes and takes the 128-byte swizzle; at the other D the
//     rows lie packed (2 D bytes apart), which the lanes below read without
//     bank conflicts.
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
//   * kLanes lanes own a (row, head), kCols columns each (Split below): at
//     16, 32 and 64 one 16-byte chunk (8 columns) a lane, D / 8 lanes; at 48,
//     80, 96 and 112 eight lanes of D / 8 columns. The moments and row norms
//     are log2(kLanes) shuffle levels, the RoPE partner (an even column and
//     the next) sits in the same lane, and a warp reads 32 / kLanes whole
//     consecutive rows. A thread keeps its kCols columns of gamma and beta in
//     registers, and the RoPE row of its token once for all hper heads. At
//     D 64 that is 80 registers and 69 KB of shared memory, so that three
//     CTAs (24 warps) share an SM; the arithmetic, not the bytes, sets the
//     pace at that occupancy: two CTAs an SM ran 1.3x slower, and a
//     persistent grid of one 512-thread CTA an SM with double-buffered boxes
//     1.3x slower too (PERF.md, section 6). The rows a CTA are chosen per D
//     by measurement (rows_built, the wrapper's _launch_plan): 256 at 16 and
//     32, where a CTA's boxes are small and its fixed costs (the TMA round
//     trip, two cluster barriers) want more rows (10% faster at 16, 3% at
//     32); 64 at 112, where hper boxes of 128 rows leave one CTA an SM and
//     two of 64 rows in clusters of 16 read 14% faster (at 80 and 96, two
//     CTAs an SM of 128 rows beat 64-row ones by 8-9%).
//   * The moments sum each lane's columns in adjacent pairs, the pairs as a
//     tree whose first half is a power of two, then the lanes' butterfly; in
//     double every such sum of shifted bf16 inputs is exact, so the order
//     matches the plain version's. The mean and variance are correctly
//     rounded quotients by D (div_by: a multiply at a power of two, else
//     three double operations in place of a division subroutine).
//   * int8 codes are rint(z * r) rounded in the FMA pipe (+ 1.5 * 2^23, round
//     to nearest even as rintf) and packed from the low byte of the float's
//     bits, off the conversion unit. At 80 and 112 pass 2 stages a row's
//     outputs over its box row and the CTA writes them out in 16-byte
//     chunks; at 80 and 96 each step of the passes takes two heads, and
//     each box has its own TMA barrier (Tune). At 64 the kernel runs the
//     instructions of the head_dim-64 kernel it grew from: its outputs are
//     bit-identical to that kernel's and its time unchanged.
//   * What binds it (PERF.md, section 6): the latency of its arithmetic at
//     two or three CTAs an SM, 44-63% of the bytes bound at 16-112 on the
//     card; at 80-112 shared memory (hper boxes) or registers (124-128 a
//     thread) leave two CTAs an SM.
//   * Jobs are (tensor, cell, rank): q and k cells reduce independently; v
//     jobs copy their box to the head-major output, zeroing rows >= s_valid,
//     and reduce nothing. CTAs whose rows all lie at or past s_valid load
//     nothing.
//   * Head dims that are no multiple of 16 (kRagged: the instance of width
//     W, the next multiple of 16, with the true D, even, a runtime
//     argument). A box is still W columns wide, read from column h * hs of
//     the projection (hs = D in the fused projection; a box must start on a
//     16-byte boundary, so at a D that is no multiple of 8 the wrapper hands
//     the kernel a copy with each head's columns hs = D rounded up to 8
//     apart): its columns past D are the next head's (or TMA's zeros past
//     the last head). So y is 0 there, and gamma, beta and the
//     RoPE tables (D columns) read as 0 past D: z is exactly 0 there, adds
//     nothing to the moments, the absmax or the row norms, and codes or
//     writes as 0, so q and k come out W wide with zero columns past D,
//     which K2 reads as they are; v's columns past D are zeroed in the copy.
//     The moments divide by the runtime D correctly rounded, as div_by does
//     for a compile-time D: the product with the host's RN(1 / D) and one
//     fma correction (div_rt). The parameters and tables load in pairs (D is
//     even, so no pair straddles it). W 128 (D 114 to 126) is built only in
//     this form, with 64-row CTAs in clusters of up to 16 as at 112 and
//     sixteen lanes a row of 8 columns each. At D = W the ragged form gives
//     the exact instances' bits but reads 3-9.5% slower on the card
//     (PERF.md, section 6), so the widths keep their exact instances.
// Compiled without --use_fast_math: sqrtf, division and the RoPE products must
// stay IEEE so that both passes and the plain PyTorch version agree.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 256;
constexpr int kMaxHeads = 4;               // hper
constexpr int kMaxCluster = 8;             // the portable cluster size
constexpr int kMaxClusterNonPortable = 16;  // Hopper's largest
constexpr unsigned kFull = 0xffffffffu;

// How the lanes split a (row, head) of head dim D, and how a box lies in
// shared memory
template <int D>
struct Split {
  static_assert(D % 16 == 0 && D >= 16 && D <= 128, "width: 16 to 128 in steps of 16");
  static constexpr bool kPow2 = (D & (D - 1)) == 0;
  static constexpr int kLanes = kPow2 ? D / 8 : 8;  // lanes a (row, head)
  static constexpr int kCols = D / kLanes;          // columns a lane: 8, or 6 10 12 14
  static constexpr int kRowsAtOnce = kThreads / kLanes;
  static constexpr bool kSwizzle = D == 64;         // one 128-byte row a box row
  // bytes a vector load or store of a lane's columns takes: 16, 8 or 4 (bf16)
  static constexpr int kVec = kCols % 8 == 0 ? 16 : kCols % 4 == 0 ? 8 : 4;
};

// What the card measured best at each head dim, each against the step before
// in one call (PERF.md, section 6):
//   kHeadsAStep: two heads a step of the passes at 80 and 96, so that two
//     heads' chains interleave (1-2.4% faster; at 112 4-7% slower under the
//     128-register cap, at 32 and 48 no faster, at 16 a 4-byte spill; 64
//     keeps its one-head loop);
//   kStaged: at 80 and 112 (10 and 14 columns a lane: five or seven 2-byte
//     int8 or 4-byte bf16 stores a row, each spread over a warp's rows) pass
//     2 writes each row's outputs over the box row it has read, and the CTA
//     copies its rows out in 16-byte chunks of one contiguous range a head
//     (2-3% faster at 80, 9% at 112; 2-6% slower at 48);
//   kBarEach: at 80 and 96 a TMA barrier a box, so that pass 1 starts on the
//     first head while the others land (2-3% faster; 1-5% slower at 16-48
//     and 112); one barrier for all the boxes elsewhere.
template <int D>
struct Tune {
  static constexpr int kHeadsAStep = D == 80 || D == 96 ? 2 : 1;
  static constexpr bool kStaged = D == 80 || D == 112;
  static constexpr bool kBarEach = D == 80 || D == 96;
};

struct Args {
  const float* gamma[2];  // q / k LayerNorm scale, [D]
  const float* beta[2];   // q / k LayerNorm bias, [D]
  const float* cos;       // [rope_rows, D] or null
  const float* sin;
  int rope_rows;
  int H, s_pad, s_valid, hper, cluster;
  int dt;                 // the head dim: the width D, or less (kRagged)
  double inv_dt;          // kRagged: 1 / dt correctly rounded
  int hs;                 // kRagged: elements from one head's first column to the next's
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
  uint64_t bar[kMaxHeads];     // each box's TMA completion (or the first, all boxes')
  float pub[2];                // this CTA's absmax and largest row |z|^2, for the cluster
  float cell[2];               // the cell's
  float red[2][kThreads / 32];
};

__host__ __device__ constexpr int box_bytes(int d, int rows) { return rows * d * 2; }

__host__ __device__ constexpr int smem_bytes_for(int d, int rows, int hper) {
  return 1024 + hper * (box_bytes(d, rows) + rows * (int)sizeof(float2)) + (int)sizeof(Tail);
}

// CTAs that share an SM by shared memory at hper 4 (each also reserves
// 1 KB), at most 3, and 2 for 64-row CTAs (80-112 need more than 85
// registers a thread): the launch bounds' minimum
__host__ __device__ constexpr int blocks_per_sm(int d, int rows) {
  const int fit = 233472 / (smem_bytes_for(d, rows, kMaxHeads) + 1024);
  const int most = rows == 64 ? 2 : 3;
  return fit < 1 ? 1 : fit > most ? most : fit;
}

// byte `byte` of row r of a box: the 128-byte swizzle at D 64, packed rows
// elsewhere
template <int D>
__device__ __forceinline__ int box_at(int r, int byte) {
  if constexpr (Split<D>::kSwizzle)
    return r * 128 + ((((byte >> 4) ^ (r & 7))) << 4) + (byte & 15);
  else
    return r * 2 * D + byte;
}

// two bf16 in a 32-bit word as two floats
__device__ __forceinline__ void unpack2(uint32_t w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

// the lane's kCols bf16 inputs of row r of a box (columns kCols part ..)
template <int D>
__device__ __forceinline__ void load_x(const uint8_t* box, int r, int part,
                                       float (&x)[Split<D>::kCols]) {
  using S = Split<D>;
  constexpr int kBytes = 2 * S::kCols;
  const int b0 = kBytes * part;
#pragma unroll
  for (int c = 0; c < kBytes / S::kVec; ++c) {
    const uint8_t* p = box + box_at<D>(r, b0 + S::kVec * c);
    constexpr int kW = S::kVec / 4;  // 32-bit words a load
    uint32_t w[kW];
    if constexpr (kW == 4) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
    } else if constexpr (kW == 2) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      w[0] = u.x, w[1] = u.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    }
#pragma unroll
    for (int e = 0; e < kW; ++e) unpack2(w[e], x[2 * (kW * c + e)], x[2 * (kW * c + e) + 1]);
  }
}

// column 0 of row r of a box
template <int D>
__device__ __forceinline__ float first_x(const uint8_t* box, int r) {
  const uint16_t u = *reinterpret_cast<const uint16_t*>(box + box_at<D>(r, 0));
  return __uint_as_float(static_cast<uint32_t>(u) << 16);
}

// y = x - x[0] for the lane's columns; kRagged: 0 at the columns past dt
template <int D, bool kRagged>
__device__ __forceinline__ void shifted(const uint8_t* box, int r, int part, int dt,
                                        float (&y)[Split<D>::kCols]) {
  constexpr int C = Split<D>::kCols;
  load_x<D>(box, r, part, y);
  const float c = first_x<D>(box, r);
#pragma unroll
  for (int i = 0; i < C; ++i) {
    if constexpr (kRagged)
      y[i] = C * part + i < dt ? __fsub_rn(y[i], c) : 0.0f;
    else
      y[i] = __fsub_rn(y[i], c);
  }
}

// n without its factors of two
__host__ __device__ constexpr int odd_part(int n) { return n % 2 ? n : odd_part(n / 2); }

// s / D correctly rounded, as the plain version's mean divides. D = 2^k b
// with b odd: / 2^k is exact, and / b is q = RN(s y) with y = RN(1 / b),
// corrected by the exact remainder s - q b (an fma): q + (s - q b) y rounds
// to the correctly rounded quotient when y is correctly rounded and q is
// within an ulp (Markstein's theorem). Three double operations where
// __ddiv_rn takes a subroutine; at b = 1 the multiply alone.
template <int D>
__device__ __forceinline__ double div_by(double s) {
  constexpr int b = odd_part(D);
  const double t = __dmul_rn(s, 1.0 / (D / b));
  if constexpr (b == 1) {
    return t;
  } else {
    constexpr double y = 1.0 / b;
    const double q = __dmul_rn(t, y);
    return __fma_rn(__fma_rn(-q, (double)b, t), y, q);
  }
}

// s / d correctly rounded for a runtime d, from y = RN(1 / d): div_by's
// correction (Markstein's theorem; a power of two in d scales q, r and y
// exactly, so the odd part needs no separate step here)
__device__ __forceinline__ double div_rt(double s, double d, double y) {
  const double q = __dmul_rn(s, y);
  return __fma_rn(__fma_rn(-q, d, s), y, q);
}

// the largest power of two below n (n >= 2)
__host__ __device__ constexpr int pow2_below(int n) {
  int p = 1;
  while (2 * p < n) p *= 2;
  return p;
}

// the sum of v[kLo .. kLo + kN) as a tree: the first pow2_below(kN) terms
// and the rest, each the same way (at 4 terms ((0 + 1) + (2 + 3)))
template <int kLo, int kN, int M>
__device__ __forceinline__ double tree_sum(const double (&v)[M]) {
  if constexpr (kN == 1) {
    return v[kLo];
  } else {
    constexpr int h = pow2_below(kN);
    return __dadd_rn(tree_sum<kLo, h>(v), tree_sum<kLo + h, kN - h>(v));
  }
}

// (mean, 1 / sqrt(var + eps)) of the row over its kLanes lanes, the moments
// in double and rounded to f32 as the plain version rounds them. The
// butterfly gives all the row's lanes the same bits (each level adds a
// pair). Warp-collective: the whole warp calls it.
template <int D, bool kRagged>
__device__ __forceinline__ float2 moments(const float (&y)[Split<D>::kCols], float eps, int dt,
                                          double inv_dt) {
  using S = Split<D>;
  constexpr int kPairs = S::kCols / 2;
  // adjacent pairs, then a tree over them, so that the dependent chain is
  // short; d * d is exact in double, so the fma rounds as add(mul) would
  double p1[kPairs], p2[kPairs];
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const double d0 = y[2 * i], d1 = y[2 * i + 1];
    p1[i] = __dadd_rn(d0, d1);
    p2[i] = __fma_rn(d1, d1, __dmul_rn(d0, d0));
  }
  double s1 = tree_sum<0, kPairs>(p1);
  double s2 = tree_sum<0, kPairs>(p2);
#pragma unroll
  for (int o = 1; o < S::kLanes; o <<= 1) {
    s1 = __dadd_rn(s1, __shfl_xor_sync(kFull, s1, o));
    s2 = __dadd_rn(s2, __shfl_xor_sync(kFull, s2, o));
  }
  double m1, m2;
  if constexpr (kRagged) {
    m1 = div_rt(s1, (double)dt, inv_dt);
    m2 = div_rt(s2, (double)dt, inv_dt);
  } else {
    m1 = div_by<D>(s1);
    m2 = div_by<D>(s2);
  }
  const float mean = __double2float_rn(m1);
  const float var = __double2float_rn(fmax(__dsub_rn(m2, __dmul_rn(m1, m1)), 0.0));
  // the correctly rounded reciprocal is the correctly rounded 1 / x
  return make_float2(mean, __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps))));
}

enum Rope { kNoRope = 0, kRopeRow = 1, kPastTable = 2 };

// z in place of y: ((y - mean) * inv) * gamma + beta, then the pair rotation
// (z @ R)[2i] = -z[2i+1], (z @ R)[2i+1] = z[2i] against the row's tables
template <int C>
__device__ __forceinline__ void normalize(float (&y)[C], float2 mi, const float (&g)[C],
                                          const float (&b)[C], int rope, const float (&cs)[C],
                                          const float (&sn)[C]) {
#pragma unroll
  for (int i = 0; i < C; ++i)
    y[i] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(y[i], mi.x), mi.y), g[i]), b[i]);
  if (rope == kRopeRow) {
#pragma unroll
    for (int p = 0; p < C / 2; ++p) {
      const float z0 = y[2 * p], z1 = y[2 * p + 1];
      y[2 * p] = __fadd_rn(__fmul_rn(z0, cs[2 * p]), __fmul_rn(-z1, sn[2 * p]));
      y[2 * p + 1] = __fadd_rn(__fmul_rn(z1, cs[2 * p + 1]), __fmul_rn(z0, sn[2 * p + 1]));
    }
  } else if (rope == kPastTable) {  // the TPU wrapper zero-pads the tables
#pragma unroll
    for (int i = 0; i < C; ++i) y[i] = 0.0f;
  }
}

// C floats from p (16-byte aligned where C % 4 == 0, else 8-byte)
template <int C>
__device__ __forceinline__ void load_f32(const float* p, float (&dst)[C]) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int i = 0; i < C / 4; ++i) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p) + i);
      dst[4 * i] = f.x;
      dst[4 * i + 1] = f.y;
      dst[4 * i + 2] = f.z;
      dst[4 * i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < C / 2; ++i) {
      const float2 f = __ldg(reinterpret_cast<const float2*>(p) + i);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
}

// C floats of a row of n from column col0 on, 0 past n (kRagged's loads): in
// pairs, as col0 and n are even and p 8-byte aligned
template <int C>
__device__ __forceinline__ void load_cols(const float* p, int col0, int n, float (&dst)[C]) {
#pragma unroll
  for (int i = 0; i < C / 2; ++i) {
    const float2 f = col0 + 2 * i < n ? __ldg(reinterpret_cast<const float2*>(p + col0) + i)
                                      : make_float2(0.0f, 0.0f);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// which RoPE case `row` is in, with the lane's columns of the tables loaded
// (tables of dt columns)
template <int D, bool kRagged>
__device__ __forceinline__ int rope_row(const Args& a, int row, int part,
                                        float (&cs)[Split<D>::kCols],
                                        float (&sn)[Split<D>::kCols]) {
  constexpr int C = Split<D>::kCols;
  if (a.cos == nullptr) return kNoRope;
  if (row >= a.rope_rows) return kPastTable;
  if constexpr (kRagged) {
    load_cols<C>(a.cos + (int64_t)row * a.dt, C * part, a.dt, cs);
    load_cols<C>(a.sin + (int64_t)row * a.dt, C * part, a.dt, sn);
  } else {
    load_f32<C>(a.cos + (int64_t)row * D + C * part, cs);
    load_f32<C>(a.sin + (int64_t)row * D + C * part, sn);
  }
  return kRopeRow;
}

// v: the boxes copied to [B*H, s_pad, D], rows >= s_valid zeroed (kRagged:
// and the columns past dt)
template <int D, int kRows, bool kRagged>
__device__ __forceinline__ void copy_v(const Args& a, const uint8_t* xs, int g, int row0) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  const int chunks = a.hper * kRows * kChunks;
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    const int j = c / (kRows * kChunks), r = (c / kChunks) % kRows, ch = c % kChunks;
    const int row = row0 + r, bh = g * a.hper + j;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (row < a.s_valid) {
      u = *reinterpret_cast<const uint4*>(xs + j * box_bytes(D, kRows) + box_at<D>(r, 16 * ch));
      if constexpr (kRagged) {  // dt is even: a word's two columns lie on one side of it
        const int col = 8 * ch;
        if (col + 2 > a.dt) u.x = 0;
        if (col + 4 > a.dt) u.y = 0;
        if (col + 6 > a.dt) u.z = 0;
        if (col + 8 > a.dt) u.w = 0;
      }
    }
    *reinterpret_cast<uint4*>(a.v + ((int64_t)bh * a.s_pad + row) * D + 8 * ch) = u;
  }
}

// the low byte of the bits of rint(v) + 1.5 * 2^23 is rint(v) as an int8 for
// |v| <= 127: v * r rounded as jnp.rint / rintf (to nearest, ties to even)
__device__ __forceinline__ uint32_t code_bits(float z, float r) {
  return __float_as_uint(__fadd_rn(__fmul_rn(z, r), 12582912.0f));
}

// the codes of z[i], z[i + 1] in the low two bytes
template <int C>
__device__ __forceinline__ uint32_t code_pair(const float (&z)[C], int i, float r) {
  return __byte_perm(code_bits(z[i], r), code_bits(z[i + 1], r), 0x0040);
}

// the bf16 of z[i] * f, z[i + 1] * f in one word
template <int C>
__device__ __forceinline__ uint32_t bf16_pair(const float (&z)[C], int i, float f) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(__fmul_rn(z[i], f), __fmul_rn(z[i + 1], f));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// the lane's C outputs of one (row, head) at element `elem` (a multiple of
// C): int8 codes rint(z * r), or bf16 z * f
template <bool kQuantize, int C>
__device__ __forceinline__ void store_row(void* out, int64_t elem, const float (&z)[C], float rf) {
  if (kQuantize) {
    int8_t* o = static_cast<int8_t*>(out) + elem;
    if constexpr (C % 8 == 0) {
      uint32_t w[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        w[e] = __byte_perm(code_pair(z, 4 * e, rf), code_pair(z, 4 * e + 2, rf), 0x5410);
      *reinterpret_cast<uint2*>(o) = make_uint2(w[0], w[1]);
    } else if constexpr (C % 4 == 0) {
#pragma unroll
      for (int e = 0; e < C / 4; ++e)
        reinterpret_cast<uint32_t*>(o)[e] =
            __byte_perm(code_pair(z, 4 * e, rf), code_pair(z, 4 * e + 2, rf), 0x5410);
    } else {
#pragma unroll
      for (int e = 0; e < C / 2; ++e)
        reinterpret_cast<uint16_t*>(o)[e] = static_cast<uint16_t>(code_pair(z, 2 * e, rf));
    }
  } else {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + elem;
    if constexpr (C % 8 == 0) {
      *reinterpret_cast<uint4*>(o) = make_uint4(bf16_pair(z, 0, rf), bf16_pair(z, 2, rf),
                                                bf16_pair(z, 4, rf), bf16_pair(z, 6, rf));
    } else if constexpr (C % 4 == 0) {
#pragma unroll
      for (int e = 0; e < C / 4; ++e)
        reinterpret_cast<uint2*>(o)[e] =
            make_uint2(bf16_pair(z, 4 * e, rf), bf16_pair(z, 4 * e + 2, rf));
    } else {
#pragma unroll
      for (int e = 0; e < C / 2; ++e)
        reinterpret_cast<uint32_t*>(o)[e] = bf16_pair(z, 2 * e, rf);
    }
  }
}

// Pass 1 over the kN heads j .. j + kN - 1 of box row r (first waiting on
// their boxes' barriers, where bars is given): z of the lane's columns, the
// row statistics (stored by the row's first lane), and the lane's largest
// |z| and row |z|^2 of valid rows. kN 2 gives the scheduler
// two independent chains of loads, double moments and shuffles.
template <int D, int kRows, int kN, bool kRagged>
__device__ __forceinline__ void stats_heads(const uint8_t* xs, float2* stats, uint64_t* bars,
                                            int j, int r, int part, bool valid, float eps,
                                            int dt, double inv_dt, int rope,
                                            const float (&gm)[Split<D>::kCols],
                                            const float (&bt)[Split<D>::kCols],
                                            const float (&cs)[Split<D>::kCols],
                                            const float (&sn)[Split<D>::kCols], float& amax,
                                            float& n2max) {
  constexpr int C = Split<D>::kCols;
  float z[kN][C];
  float2 mi[kN];
  if (bars != nullptr) {  // the boxes' first reads wait for their TMA
#pragma unroll
    for (int h = 0; h < kN; ++h) mbar_wait(&bars[j + h], 0);
  }
#pragma unroll
  for (int h = 0; h < kN; ++h)
    shifted<D, kRagged>(xs + (j + h) * box_bytes(D, kRows), r, part, dt, z[h]);
#pragma unroll
  for (int h = 0; h < kN; ++h) mi[h] = moments<D, kRagged>(z[h], eps, dt, inv_dt);
#pragma unroll
  for (int h = 0; h < kN; ++h) {
    if (part == 0) stats[(j + h) * kRows + r] = mi[h];
    normalize<C>(z[h], mi[h], gm, bt, rope, cs, sn);
    // |z|^2 of the lane: even and odd columns in two fma chains, then
    // their sum and the lanes' butterfly
    float n2p[2] = {0.0f, 0.0f};
    float am = 0.0f;
#pragma unroll
    for (int e = 0; e < C; ++e) {
      am = fmaxf(am, fabsf(z[h][e]));
      n2p[e % 2] = __fmaf_rn(z[h][e], z[h][e], n2p[e % 2]);
    }
    if (valid) amax = fmaxf(amax, am);
    float n2 = __fadd_rn(n2p[0], n2p[1]);
#pragma unroll
    for (int o = 1; o < Split<D>::kLanes; o <<= 1)
      n2 = __fadd_rn(n2, __shfl_xor_sync(kFull, n2, o));
    if (valid) n2max = fmaxf(n2max, n2);
  }
}

// Pass 2 over the kN heads j .. of box row r: z recomputed from the box and
// the stored statistics (zeros past s_valid), written out (or staged over
// the box row)
template <int D, int kRows, int kN, bool kQuantize, bool kRagged>
__device__ __forceinline__ void write_heads(const Args& a, uint8_t* xs,
                                            const float2* stats, int tensor, int g, int j,
                                            int r, int row, int part, bool valid, int rope,
                                            const float (&gm)[Split<D>::kCols],
                                            const float (&bt)[Split<D>::kCols],
                                            const float (&cs)[Split<D>::kCols],
                                            const float (&sn)[Split<D>::kCols], float rf) {
  constexpr int C = Split<D>::kCols;
  float z[kN][C];
#pragma unroll
  for (int h = 0; h < kN; ++h) {
    if (valid) {
      shifted<D, kRagged>(xs + (j + h) * box_bytes(D, kRows), r, part, a.dt, z[h]);
      normalize<C>(z[h], stats[(j + h) * kRows + r], gm, bt, rope, cs, sn);
    } else {
#pragma unroll
      for (int e = 0; e < C; ++e) z[h][e] = 0.0f;
    }
  }
  if constexpr (Tune<D>::kStaged) {
    __syncwarp();  // the row's lanes have read the box row (a row is one warp's)
#pragma unroll
    for (int h = 0; h < kN; ++h)
      store_row<kQuantize, C>(xs + (j + h) * box_bytes(D, kRows) + r * 2 * D, C * part, z[h],
                              rf);
  } else {
#pragma unroll
    for (int h = 0; h < kN; ++h) {
      const int bh = g * a.hper + j + h;
      store_row<kQuantize, C>(a.out[tensor], ((int64_t)bh * a.s_pad + row) * D + C * part,
                              z[h], rf);
    }
  }
}

// the staged rows of every head copied out: a head's kRows rows of q or k are
// one contiguous range of the output, D (int8) or 2 D (bf16) bytes a row
template <int D, int kRows, bool kQuantize>
__device__ __forceinline__ void copy_out(const Args& a, const uint8_t* xs, int tensor, int g,
                                         int row0) {
  constexpr int kBytes = kQuantize ? D : 2 * D;  // a row's outputs
  constexpr int kChunks = kBytes / 16;
  uint8_t* out = static_cast<uint8_t*>(a.out[tensor]);
  const int chunks = a.hper * kRows * kChunks;
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    const int j = c / (kRows * kChunks), r = (c / kChunks) % kRows, ch = c % kChunks;
    const int64_t bh = g * a.hper + j;
    *reinterpret_cast<uint4*>(out + (bh * a.s_pad + row0 + r) * kBytes + 16 * ch) =
        *reinterpret_cast<const uint4*>(xs + j * box_bytes(D, kRows) + r * 2 * D + 16 * ch);
  }
}

// Grid (s_pad / kRows, 3 * G): blockIdx.x is the CTA's kRows-row slice (a
// cluster of `cluster` consecutive slices is one token tile), blockIdx.y / 3
// the head group and blockIdx.y % 3 the tensor (q, k, v). D is the width of
// the boxes and outputs; kRagged: the head dim a.dt is less (the note above).
template <int D, int kRows, bool kQuantize, bool kRagged>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(D, kRows))
prologue_kernel(const __grid_constant__ CUtensorMap xq, const __grid_constant__ CUtensorMap xk,
                const __grid_constant__ CUtensorMap xv, const Args a) {
  using S = Split<D>;
  constexpr int C = S::kCols, kLanes = S::kLanes, kRowsAtOnce = S::kRowsAtOnce;
  constexpr int kBoxBytes = box_bytes(D, kRows);
  constexpr int kPair = Tune<D>::kHeadsAStep;
  static_assert(kRows % kRowsAtOnce == 0, "a CTA's rows in whole steps");
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

  constexpr bool kBarEach = Tune<D>::kBarEach;
  const int n_bars = kBarEach ? a.hper : 1;
  if (tid == 0) {
    for (int j = 0; j < n_bars; ++j) mbar_init(&tl.bar[j], 1);
    mbar_init_fence();
    if (loads) {
      if (!kBarEach) mbar_expect_tx(&tl.bar[0], a.hper * kBoxBytes);
      for (int j = 0; j < a.hper; ++j) {
        const int bh = g * a.hper + j;
        if (kBarEach) mbar_expect_tx(&tl.bar[j], kBoxBytes);
        tma_load_3d(xs + j * kBoxBytes, map, &tl.bar[kBarEach ? j : 0],
                    (bh % a.H) * (kRagged ? a.hs : D), row0, bh / a.H);
      }
    }
  }
  __syncthreads();  // the barriers are initialised before anyone waits on them
  if (tensor == 2) {
    if (loads)
      for (int j = 0; j < n_bars; ++j) mbar_wait(&tl.bar[j], 0);
    copy_v<D, kRows, kRagged>(a, xs, g, row0);
    return;
  }

  // ---- q or k: kLanes lanes a row, kRowsAtOnce rows at a time ----
  const int part = tid % kLanes, rsub = tid / kLanes, lane = tid & 31;
  float gm[C], bt[C], cs[C], sn[C];
  if constexpr (kRagged) {
    load_cols<C>(a.gamma[tensor], C * part, a.dt, gm);
    load_cols<C>(a.beta[tensor], C * part, a.dt, bt);
  } else {
    load_f32<C>(a.gamma[tensor] + C * part, gm);
    load_f32<C>(a.beta[tensor] + C * part, bt);
  }
  float amax = 0.0f, n2max = 0.0f;
  if (!kBarEach && loads) mbar_wait(&tl.bar[0], 0);
#pragma unroll 1
  for (int i = 0; i < kRows / kRowsAtOnce; ++i) {
    const int r = rsub + kRowsAtOnce * i, row = row0 + r;
    // rows only grow with i; the warp's rows go on together while its first
    // is valid (the shuffles take the whole warp), the rest add nothing. A
    // warp that stops here reads no box, in this pass or the next.
    if (row0 + kRowsAtOnce * i + (tid / 32) * (32 / kLanes) >= a.s_valid) break;
    const bool valid = row < a.s_valid;
    const int rope = rope_row<D, kRagged>(a, row, part, cs, sn);
    // the first rows wait for each box as they reach it
    uint64_t* bars = kBarEach && i == 0 ? tl.bar : nullptr;
    int j = 0;
#pragma unroll 1
    for (; j + kPair <= a.hper; j += kPair)
      stats_heads<D, kRows, kPair, kRagged>(xs, stats, bars, j, r, part, valid, a.eps, a.dt,
                                            a.inv_dt, rope, gm, bt, cs, sn, amax, n2max);
    if constexpr (kPair > 1) {
      if (j < a.hper)
        stats_heads<D, kRows, 1, kRagged>(xs, stats, bars, j, r, part, valid, a.eps, a.dt,
                                          a.inv_dt, rope, gm, bt, cs, sn, amax, n2max);
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
    const int rope = valid ? rope_row<D, kRagged>(a, row, part, cs, sn) : kNoRope;
    int j = 0;
#pragma unroll 1
    for (; j + kPair <= a.hper; j += kPair)
      write_heads<D, kRows, kPair, kQuantize, kRagged>(a, xs, stats, tensor, g, j, r, row, part,
                                                       valid, rope, gm, bt, cs, sn, rf);
    if constexpr (kPair > 1) {
      if (j < a.hper)
        write_heads<D, kRows, 1, kQuantize, kRagged>(a, xs, stats, tensor, g, j, r, row, part,
                                                     valid, rope, gm, bt, cs, sn, rf);
    }
  }
  if constexpr (Tune<D>::kStaged) {
    __syncthreads();  // every row staged
    copy_out<D, kRows, kQuantize>(a, xs, tensor, g, row0);
  }
  cluster_wait();  // no CTA leaves while another may read its shared memory
}

// The rows a CTA holds at width D that this library builds, as the
// wrapper's _launch_plan takes them: 256 at 16 and 32 (clusters up to 4;
// 128 where the token tile is no multiple of 256), 128 at 48 to 96, 64 at
// 112 and 128 (clusters up to 16)
__host__ __device__ constexpr bool rows_built(int d, int rows) {
  return (rows == 128 && d <= 96) || (rows == 256 && d <= 32) || (rows == 64 && d >= 112);
}

// the width of head dim d's instance: d at 16 to 112 in steps of 16, the
// next multiple of 16 at any other even d below 128, else 0 (none)
__host__ __device__ constexpr int width_of(int d) {
  if (d >= 16 && d <= 112 && d % 16 == 0) return d;
  return d >= 2 && d <= 126 && d % 2 == 0 ? (d + 15) / 16 * 16 : 0;
}

__host__ __device__ constexpr int max_cluster(int rows) {
  return rows == 64 ? kMaxClusterNonPortable : kMaxCluster * 128 / rows;
}

typedef void (*KernelFn)(CUtensorMap, CUtensorMap, CUtensorMap, Args);

template <int D, int kRows, bool kRagged>
KernelFn instance(int quantize) {
  return quantize ? prologue_kernel<D, kRows, true, kRagged>
                  : prologue_kernel<D, kRows, false, kRagged>;
}

template <int D, int kRows>
KernelFn kernel_for(int quantize, bool ragged) {
  return ragged ? instance<D, kRows, true>(quantize) : instance<D, kRows, false>(quantize);
}

// the instance of (width D, rows, quantize, ragged), or null; width 128 is
// built ragged only (the JAX kernel takes head dims below 128)
KernelFn pick(int d, int rows, int quantize, bool ragged) {
  if (rows == 256) {
    switch (d) {
      case 16: return kernel_for<16, 256>(quantize, ragged);
      case 32: return kernel_for<32, 256>(quantize, ragged);
      default: return nullptr;
    }
  }
  if (rows == 128) {
    switch (d) {
      case 16: return kernel_for<16, 128>(quantize, ragged);
      case 32: return kernel_for<32, 128>(quantize, ragged);
      case 48: return kernel_for<48, 128>(quantize, ragged);
      case 64: return kernel_for<64, 128>(quantize, ragged);
      case 80: return kernel_for<80, 128>(quantize, ragged);
      case 96: return kernel_for<96, 128>(quantize, ragged);
      default: return nullptr;
    }
  }
  if (rows != 64) return nullptr;
  if (d == 112) return kernel_for<112, 64>(quantize, ragged);
  return d == 128 && ragged ? instance<128, 64, true>(quantize) : nullptr;
}

// The instance's attributes, once a device: the most shared memory a plan of
// it takes (hper 4) and, at 64 rows, the non-portable cluster size. They
// persist, and setting them at every launch cost host time that the small
// head dims' launches (0.07 ms at 16) could not hide.
int configure(KernelFn fn, int d, int rows, int quantize, bool ragged) {
  // a bit a device (the first 32), by width, rows, quantize and ragged
  static std::atomic<uint32_t> done[8][3][2][2];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::atomic<uint32_t>& flags =
      done[d / 16 - 1][rows == 64 ? 0 : rows == 128 ? 1 : 2][quantize != 0][ragged];
  const uint32_t bit = dev < 32 ? 1u << dev : 0u;
  if (bit != 0 && (flags.load(std::memory_order_acquire) & bit)) return 0;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes_for(d, rows, kMaxHeads));
  if (err == cudaSuccess && max_cluster(rows) > kMaxCluster)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) flags.fetch_or(bit, std::memory_order_release);
  return static_cast<int>(err);
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

// the wrapper's _launch_plan mirrors rows_built and smem_bytes_for; a plan
// that drifted from them is refused here
bool plan_ok(int d, int rows, int hper, int block, int cluster, int smem_bytes) {
  return rows_built(d, rows) && hper >= 1 && hper <= kMaxHeads && block > 0 &&
         block % rows == 0 && cluster == block / rows && cluster <= max_cluster(rows) &&
         smem_bytes == smem_bytes_for(d, rows, hper);
}

}  // namespace

// xq, xk, xv: bf16 [B, S_in, H*hs] views sharing the element strides
// (stride_b, stride_s), last axis contiguous, bases and byte strides 16-byte
// aligned (TMA), head h in columns h * hs .. h * hs + D - 1 (hs = D, or
// below the width D rounded up to a multiple of 8: every box starts
// 16-byte aligned); D even, 2 to 126 (gamma, beta: [D]; the RoPE
// tables [rope_rows, D]). q, k and v are written W = width_of(D) wide ([B*H,
// s_pad, W], zero past D). The launch plan (cluster = block / rows CTAs of
// `rows` rows, smem_bytes of dynamic shared memory, by W) comes from the
// wrapper's _launch_plan and is checked here. Returns a cudaError_t.
extern "C" int aether_qkv_prologue(
    const void* xq, const void* xk, const void* xv, int stride_b, int stride_s,
    const void* gq, const void* bq, const void* gk, const void* bk,
    const void* rope_cos, const void* rope_sin, int rope_rows,
    int B, int S_in, int H, int D, int hs, int s_pad, int s_valid, int block, int hper,
    int quantize,
    float eps, float fold, float fold127, float inv127,
    void* qo, void* ko, void* v, void* qsc, void* qn, void* ksc, void* kn,
    int rows, int cluster, int smem_bytes, void* stream) {
  const int W = width_of(D);
  const bool ragged = W != D;
  if (W == 0 || (ragged ? hs < D || hs % 8 : hs != D) || B <= 0 || H <= 0 ||
      (B * H) % (hper > 0 ? hper : 1) || s_valid <= 0 ||
      s_valid > S_in || s_pad % (block > 0 ? block : 1) ||
      !plan_ok(W, rows, hper, block, cluster, smem_bytes) || 3 * (B * H / hper) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const KernelFn fn = pick(W, rows, quantize, ragged);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[3];
  const void* bases[3] = {xq, xk, xv};
  for (int t = 0; t < 3; ++t) {
    if (!make_map_3d_strided(&maps[t], bases[t], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                             (uint64_t)H * hs, S_in, B, (uint64_t)stride_s * 2,
                             (uint64_t)stride_b * 2, W, rows,
                             W == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE))
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
  a.dt = D;
  a.inv_dt = 1.0 / D;
  a.hs = hs;
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
  const int rc = configure(fn, W, rows, quantize, ragged);
  if (rc != 0) return rc;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config(dim3(s_pad / rows, 3 * (B * H / hper), 1), cluster, smem_bytes, s, attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, fn, maps[0], maps[1], maps[2], a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// cudaOccupancyMaxActiveClusters for the plan: how many clusters of
// `cluster` CTAs of (head dim D, rows) with `smem_bytes` each the card holds
// at once, into *clusters (an int). Returns a cudaError_t.
extern "C" int aether_qkv_prologue_occupancy(int D, int rows, int cluster, int smem_bytes,
                                             int quantize, void* clusters) {
  const int W = width_of(D);
  const KernelFn fn = W == 0 ? nullptr : pick(W, rows, quantize, W != D);
  if (fn == nullptr || cluster < 1 || cluster > max_cluster(rows) ||
      smem_bytes < smem_bytes_for(W, rows, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = configure(fn, W, rows, quantize, W != D);
  if (rc != 0) return rc;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(dim3(cluster, 3, 1), cluster, smem_bytes, 0, attr);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(static_cast<int*>(clusters), fn, &cfg));
}
