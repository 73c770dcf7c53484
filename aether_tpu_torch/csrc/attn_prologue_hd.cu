// K1 at the head dims other than 64: the fused QKV attention prologue for
// head_dim 16, 32, 48, 80, 96 and 112, written by hand for Hopper (sm_90a).
//
// Replaces aether_tpu/ops/attn_prologue.py::_prologue_kernel at those head
// dims (the Pallas kernel packs v's ones column at lane head_dim of a
// 128-lane tile, so it takes every head_dim below 128). The function is
// attn_prologue.cu's, the same arithmetic for every row and head:
//   shifted single-pass LayerNorm over head_dim (eps, affine), the moments
//   in double as the plain PyTorch version takes them
//   -> interleaved-pair RoPE (rows past the table rotate to zero)
//   -> rows >= s_valid zeroed
//   -> symmetric int8 quantization with ONE absmax/127 scale per (hper heads
//      x block tokens) cell (quantize), or bf16 z * fold for q and bf16 z for
//      k (the AETHER_ATTN_QK8=0 branch),
// plus the per-cell max row L2 norm, and copies v (rows >= s_valid zeroed).
//
// This is the simple form; head_dim 64, the shipped models' width, keeps
// attn_prologue.cu's one-pass cluster kernel. Two passes over the inputs,
// each a grid of (s_pad / 128, B*H, tensors) CTAs of 128 threads, 32 rows at
// a time and 4 lanes a row (head_dim / 4 columns a lane, read from the fused
// [B, S_in, 3*H*D] projection through its strides):
//   1. q and k: z of every row, the CTA's absmax and largest row |z|^2 of
//      the valid rows, and one atomicMax a CTA into the cell's slot of a
//      zeroed scratch (non-negative floats order like their bits);
//   2. q and k again: z recomputed with the same instructions from the same
//      inputs, so it is bit for bit the z whose maxima pass 1 took, and
//      quantized by the cell's scale (no code leaves [-127, 127]); the CTA
//      at the cell's first row and head writes its stats; v is copied.
// The moments sum a lane's columns in order and then add the four lanes'
// sums in a butterfly, which gives all four the same bits. What bounds it
// is bytes: q and k are read twice. Compiled without --use_fast_math:
// sqrt, division and the RoPE products stay IEEE.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kLanes = 4;                       // lanes a (row, head)
constexpr int kRowsAtOnce = kThreads / kLanes;  // 32
constexpr int kRows = 128;                      // rows a CTA
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const __nv_bfloat16* x[3];  // q, k, v projections: [B, S_in, H*D] views
  int64_t stride_b, stride_s;
  const float* gamma[2];
  const float* beta[2];
  const float* cos;  // [rope_rows, D] or null
  const float* sin;
  int rope_rows;
  int H, s_pad, s_valid, hper, block, n_tiles;
  float eps;
  float fold[2];
  float scale[2];
  void* out[2];           // q, k: int8 or bf16 [B*H, s_pad, D]
  __nv_bfloat16* v;       // [B*H, s_pad, D]
  float* sc[2];           // qsc, ksc [G, T]
  float* nrm[2];          // qn, kn [G, T]
  unsigned* cell;         // [2 tensors][2: absmax, row |z|^2][G*T], zeroed
};

enum Rope { kNoRope = 0, kRopeRow = 1, kPastTable = 2 };

// the lane's columns of row `row` of head bh, as f32
template <int D>
__device__ __forceinline__ void load_row(const Args& a, int tensor, int bh, int row, int lane4,
                                         float (&x)[D / kLanes]) {
  constexpr int kCols = D / kLanes;
  const int b = bh / a.H, h = bh % a.H;
  const __nv_bfloat16* p =
      a.x[tensor] + b * a.stride_b + (int64_t)row * a.stride_s + h * D + lane4 * kCols;
#pragma unroll
  for (int c = 0; c < kCols / 4; ++c) {
    const uint2 u = *reinterpret_cast<const uint2*>(p + 4 * c);
    x[4 * c] = __uint_as_float(u.x << 16);
    x[4 * c + 1] = __uint_as_float(u.x & 0xffff0000u);
    x[4 * c + 2] = __uint_as_float(u.y << 16);
    x[4 * c + 3] = __uint_as_float(u.y & 0xffff0000u);
  }
}

// the lane's columns of the LayerNorm scale (g) and bias (b) of `tensor`
template <int D>
__device__ __forceinline__ void load_affine(const Args& a, int tensor, int lane4,
                                            float (&g)[D / kLanes], float (&b)[D / kLanes]) {
#pragma unroll
  for (int i = 0; i < D / kLanes; ++i) {
    g[i] = __ldg(a.gamma[tensor] + lane4 * (D / kLanes) + i);
    b[i] = __ldg(a.beta[tensor] + lane4 * (D / kLanes) + i);
  }
}

// z of the lane's columns: shifted moments in double, normalize, affine
// (the lane's g and b), RoPE. Warp-collective (the four lanes of each row
// exchange sums).
template <int D>
__device__ __forceinline__ void row_z(const Args& a, int tensor, int bh, int row, int lane4,
                                      const float (&g)[D / kLanes], const float (&b)[D / kLanes],
                                      float (&z)[D / kLanes]) {
  constexpr int kCols = D / kLanes;
  load_row<D>(a, tensor, bh, row, lane4, z);
  const float first = __shfl_sync(kFull, z[0], (threadIdx.x & 31) & ~(kLanes - 1));
  double s1 = 0.0, s2 = 0.0;
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    z[i] = __fsub_rn(z[i], first);
    const double d = z[i];
    s1 = __dadd_rn(s1, d);
    s2 = __fma_rn(d, d, s2);
  }
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) {
    s1 = __dadd_rn(s1, __shfl_xor_sync(kFull, s1, o));
    s2 = __dadd_rn(s2, __shfl_xor_sync(kFull, s2, o));
  }
  const double m1 = __ddiv_rn(s1, (double)D);
  const float mean = __double2float_rn(m1);
  const float var =
      __double2float_rn(fmax(__dsub_rn(__ddiv_rn(s2, (double)D), __dmul_rn(m1, m1)), 0.0));
  const float inv = __frcp_rn(__fsqrt_rn(__fadd_rn(var, a.eps)));
  const int col0 = lane4 * kCols;
  int rope = kNoRope;
  if (a.cos != nullptr) rope = row < a.rope_rows ? kRopeRow : kPastTable;
#pragma unroll
  for (int i = 0; i < kCols; ++i)
    z[i] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(z[i], mean), inv), g[i]), b[i]);
  if (rope == kRopeRow) {
    const float* cs = a.cos + (int64_t)row * D + col0;
    const float* sn = a.sin + (int64_t)row * D + col0;
#pragma unroll
    for (int p = 0; p < kCols / 2; ++p) {
      const float z0 = z[2 * p], z1 = z[2 * p + 1];
      z[2 * p] = __fadd_rn(__fmul_rn(z0, __ldg(cs + 2 * p)), __fmul_rn(-z1, __ldg(sn + 2 * p)));
      z[2 * p + 1] =
          __fadd_rn(__fmul_rn(z1, __ldg(cs + 2 * p + 1)), __fmul_rn(z0, __ldg(sn + 2 * p + 1)));
    }
  } else if (rope == kPastTable) {
#pragma unroll
    for (int i = 0; i < kCols; ++i) z[i] = 0.0f;
  }
}

__device__ __forceinline__ int cell_of(const Args& a, int bh, int row) {
  return (bh / a.hper) * a.n_tiles + row / a.block;
}

// pass 1: the cell maxima of q (blockIdx.z 0) and k (1)
template <int D>
__global__ void __launch_bounds__(kThreads) stats_kernel(const Args a) {
  constexpr int kCols = D / kLanes;
  __shared__ float red[2][kThreads / 32];
  const int tensor = blockIdx.z, bh = blockIdx.y, row0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, lane4 = tid % kLanes, rsub = tid / kLanes;
  float g[kCols], b[kCols];
  load_affine<D>(a, tensor, lane4, g, b);
  float amax = 0.0f, n2max = 0.0f;
#pragma unroll 1
  for (int i = 0; i < kRows / kRowsAtOnce; ++i) {
    // the warp's 8 rows go on together while its first is valid
    if (row0 + kRowsAtOnce * i + (tid / 32) * (32 / kLanes) >= a.s_valid) break;
    const int row = row0 + rsub + kRowsAtOnce * i;
    const bool valid = row < a.s_valid;
    float z[kCols];
    row_z<D>(a, tensor, bh, valid ? row : row0, lane4, g, b, z);
    float n2 = 0.0f;
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      if (valid) amax = fmaxf(amax, fabsf(z[e]));
      n2 = __fmaf_rn(z[e], z[e], n2);
    }
#pragma unroll
    for (int o = 1; o < kLanes; o <<= 1) n2 = __fadd_rn(n2, __shfl_xor_sync(kFull, n2, o));
    if (valid) n2max = fmaxf(n2max, n2);
  }
  const unsigned am = __reduce_max_sync(kFull, __float_as_uint(amax));
  const unsigned nm = __reduce_max_sync(kFull, __float_as_uint(n2max));
  if (tid % 32 == 0) {
    red[0][tid / 32] = __uint_as_float(am);
    red[1][tid / 32] = __uint_as_float(nm);
  }
  __syncthreads();
  if (tid < 2) {
    float m = 0.0f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) m = fmaxf(m, red[tid][w]);
    const int n = gridDim.y / a.hper * a.n_tiles;
    atomicMax(a.cell + (tensor * 2 + tid) * n + cell_of(a, bh, row0), __float_as_uint(m));
  }
}

__device__ __forceinline__ uint32_t code_bits(float z, float r) {
  return __float_as_uint(__fadd_rn(__fmul_rn(z, r), 12582912.0f));
}

// pass 2: q (0) and k (1) written from the cell maxima; v (2) copied
template <int D, bool kQuantize>
__global__ void __launch_bounds__(kThreads) write_kernel(const Args a) {
  constexpr int kCols = D / kLanes;
  const int tensor = blockIdx.z, bh = blockIdx.y, row0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, lane4 = tid % kLanes, rsub = tid / kLanes;
  if (tensor == 2) {
#pragma unroll 1
    for (int i = 0; i < kRows / kRowsAtOnce; ++i) {
      const int row = row0 + rsub + kRowsAtOnce * i;
      uint2 u[kCols / 4];
      if (row < a.s_valid) {
        const int b = bh / a.H, h = bh % a.H;
        const __nv_bfloat16* p =
            a.x[2] + b * a.stride_b + (int64_t)row * a.stride_s + h * D + lane4 * kCols;
#pragma unroll
        for (int c = 0; c < kCols / 4; ++c) u[c] = *reinterpret_cast<const uint2*>(p + 4 * c);
      } else {
#pragma unroll
        for (int c = 0; c < kCols / 4; ++c) u[c] = make_uint2(0, 0);
      }
      __nv_bfloat16* dst = a.v + ((int64_t)bh * a.s_pad + row) * D + lane4 * kCols;
#pragma unroll
      for (int c = 0; c < kCols / 4; ++c) *reinterpret_cast<uint2*>(dst + 4 * c) = u[c];
    }
    return;
  }
  const int n = gridDim.y / a.hper * a.n_tiles;
  const int cell = cell_of(a, bh, row0);
  const float amax_c = __uint_as_float(a.cell[(tensor * 2) * n + cell]);
  if (tid == 0 && bh % a.hper == 0 && row0 % a.block == 0) {
    a.sc[tensor][cell] = __fmul_rn(amax_c, a.scale[tensor]);
    a.nrm[tensor][cell] =
        __fmul_rn(__fsqrt_rn(__uint_as_float(a.cell[(tensor * 2 + 1) * n + cell])),
                  a.fold[tensor]);
  }
  float rf = a.fold[tensor];
  if (kQuantize) rf = amax_c > 0.0f ? __fdiv_rn(127.0f, fmaxf(amax_c, 1e-30f)) : 0.0f;
  float g[kCols], b[kCols];
  load_affine<D>(a, tensor, lane4, g, b);
#pragma unroll 1
  for (int i = 0; i < kRows / kRowsAtOnce; ++i) {
    const int row = row0 + rsub + kRowsAtOnce * i;
    // warp-uniform: the shuffles of row_z take the whole warp
    const bool any = row0 + kRowsAtOnce * i + (tid / 32) * (32 / kLanes) < a.s_valid;
    const bool valid = row < a.s_valid;
    float z[kCols];
    if (any) row_z<D>(a, tensor, bh, valid ? row : row0, lane4, g, b, z);
    if (!valid) {
#pragma unroll
      for (int e = 0; e < kCols; ++e) z[e] = 0.0f;
    }
    const int64_t elem = ((int64_t)bh * a.s_pad + row) * D + lane4 * kCols;
    if (kQuantize) {
#pragma unroll
      for (int c = 0; c < kCols / 4; ++c) {
        const uint32_t lo = __byte_perm(code_bits(z[4 * c], rf), code_bits(z[4 * c + 1], rf), 0x0040);
        const uint32_t hi =
            __byte_perm(code_bits(z[4 * c + 2], rf), code_bits(z[4 * c + 3], rf), 0x0040);
        *reinterpret_cast<uint32_t*>(static_cast<int8_t*>(a.out[tensor]) + elem + 4 * c) =
            __byte_perm(lo, hi, 0x5410);
      }
    } else {
#pragma unroll
      for (int c = 0; c < kCols / 4; ++c) {
        const __nv_bfloat162 h0 =
            __floats2bfloat162_rn(__fmul_rn(z[4 * c], rf), __fmul_rn(z[4 * c + 1], rf));
        const __nv_bfloat162 h1 =
            __floats2bfloat162_rn(__fmul_rn(z[4 * c + 2], rf), __fmul_rn(z[4 * c + 3], rf));
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(a.out[tensor]) + elem + 4 * c) =
            make_uint2(*reinterpret_cast<const uint32_t*>(&h0),
                       *reinterpret_cast<const uint32_t*>(&h1));
      }
    }
  }
}

template <int D>
int launch(const Args& a, int BH, int quantize, cudaStream_t st) {
  const dim3 threads(kThreads);
  stats_kernel<D><<<dim3(a.s_pad / kRows, BH, 2), threads, 0, st>>>(a);
  if (quantize)
    write_kernel<D, true><<<dim3(a.s_pad / kRows, BH, 3), threads, 0, st>>>(a);
  else
    write_kernel<D, false><<<dim3(a.s_pad / kRows, BH, 3), threads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xq, xk, xv: bf16 [B, S_in, H*D] views sharing the element strides
// (stride_b, stride_s), last axis contiguous, bases 16-byte aligned and
// strides multiples of 8 elements; D one of 16, 32, 48, 80, 96, 112. block
// (a multiple of 128) and hper as _pick_pad_and_block / _heads_per_cell
// chose them; cell: 4 * G * T zeroed 32-bit words. Returns a cudaError_t.
extern "C" int aether_qkv_prologue_hd(
    const void* xq, const void* xk, const void* xv, int stride_b, int stride_s,
    const void* gq, const void* bq, const void* gk, const void* bk,
    const void* rope_cos, const void* rope_sin, int rope_rows,
    int B, int S_in, int H, int D, int s_pad, int s_valid, int block, int hper, int quantize,
    float eps, float fold, float fold127, float inv127,
    void* qo, void* ko, void* v, void* qsc, void* qn, void* ksc, void* kn, void* cell,
    void* stream) {
  if (B <= 0 || H <= 0 || hper <= 0 || (B * H) % hper || B * H > 65535 || s_valid <= 0 ||
      s_valid > S_in || block <= 0 || block % kRows || s_pad % block || stride_s % 8 ||
      stride_b % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x[0] = static_cast<const __nv_bfloat16*>(xq);
  a.x[1] = static_cast<const __nv_bfloat16*>(xk);
  a.x[2] = static_cast<const __nv_bfloat16*>(xv);
  a.stride_b = stride_b;
  a.stride_s = stride_s;
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
  a.block = block;
  a.n_tiles = s_pad / block;
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
  a.cell = static_cast<unsigned*>(cell);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int BH = B * H;
  switch (D) {
    case 16: return launch<16>(a, BH, quantize, st);
    case 32: return launch<32>(a, BH, quantize, st);
    case 48: return launch<48>(a, BH, quantize, st);
    case 80: return launch<80>(a, BH, quantize, st);
    case 96: return launch<96>(a, BH, quantize, st);
    case 112: return launch<112>(a, BH, quantize, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
