// K1: the fused QKV attention prologue, hand-written for Hopper (sm_90a).
//
// Replaces aether_tpu/ops/attn_prologue.py::_prologue_kernel (the Pallas TPU
// kernel launched by qkv_prologue). For every (head group g x token tile t)
// quantization cell it computes, per row and head:
//   shifted single-pass LayerNorm over head_dim (eps, affine)
//   -> interleaved-pair RoPE (rows past the table use cos = sin = 0)
//   -> rows >= s_valid zeroed
//   -> symmetric int8 quantization with ONE absmax/127 scale per cell
//      (quantize), or bf16 z * fold for q and bf16 z for k (!quantize, the
//      AETHER_ATTN_QK8=0 branch of the TPU kernel, attn_prologue.py:150-151),
// plus the per-cell max row L2 norm, and copies v (rows >= s_valid zeroed).
// The cell is (hper heads) x (block tokens) exactly as _pick_pad_and_block
// chose it: that is a numerics choice, independent of the CUDA tile.
//
// What bounds it on an H100: bytes. It reads q, k (twice) and v in bf16 and
// writes int8 q/k and bf16 v, about 0.75 GB at the 48-head 15360-token shape,
// with ~30 flops per element. The design keeps it one read per pass:
//   * it reads the fused [B, S, 3*H*D] projection output in place through its
//     row stride (the head-major transpose of the TPU wrapper is gone);
//   * one warp owns one (row, head): lane l holds the interleaved pair
//     (2l, 2l+1), so the RoPE partner is in the same register pair and the
//     LayerNorm moments are two warp shuffles trees;
//   * a cell's absmax must be known before any of its elements is quantized,
//     and a cell spans many CTAs. Pass 1 computes z and reduces absmax and the
//     squared row norm per CTA, then combines CTAs with atomicMax on the int
//     bits of the non-negative floats (exact and order-free). Pass 2 recomputes
//     z with the same device function, bit for bit, and writes rintf(z*127/amax)
//     (round half to even, like jnp.rint) plus the plain v copy.
// The float branch keeps both passes (the stats give K2 its shift) and takes
// the LayerNorm moments in double, as the plain PyTorch version does: with
// bf16 outputs, whose spacing shrinks with |z|, an f32 mean's rounding would
// move the last bit of values near 0.
// Compiled without --use_fast_math: sqrtf, division and the RoPE products must
// stay IEEE so both passes and the plain PyTorch version agree.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;          // head_dim handled by this kernel
constexpr int kWarps = 8;       // warps per CTA
constexpr int kRows = 32;       // token rows per CTA (divides every block)
constexpr unsigned kFull = 0xffffffffu;

struct PrologueArgs {
  const __nv_bfloat16* x[3];    // q, k, v projections, [B, S_in, H*D] views
  int stride_b, stride_s;       // element strides of those views
  const float* gamma[2];        // q / k LayerNorm scale, [D]
  const float* beta[2];         // q / k LayerNorm bias, [D]
  const float* cos;             // [rope_rows, D] or null
  const float* sin;
  int rope_rows;
  int H, s_pad, s_valid, block, hper, n_tiles, chunks;
  float eps, fold, fold127, inv127;
  void* qo;                     // int8 (quantize) or bf16, [B*H, s_pad, D]
  void* ko;
  __nv_bfloat16* v;             // [B*H, s_pad, D]
  float* qsc;
  float* qn;
  float* ksc;
  float* kn;                    // [G, T]
  unsigned* scratch;            // [G, T, 4]: amax_q, nrm2_q, amax_k, nrm2_k
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum_d(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __dadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// z for the lane's pair (2*lane, 2*lane + 1) of tensor `which` (0 = q, 1 = k)
// at (b, row, h). Warp-collective; the caller guarantees row < s_valid.
// kF64: the moments in double, rounded to f32 (the float branch).
template <bool kF64>
__device__ __forceinline__ float2 prologue_z(const PrologueArgs& a, int which,
                                             int b, int h, int row, int lane) {
  const __nv_bfloat16* p = a.x[which] + (int64_t)b * a.stride_b +
                           (int64_t)row * a.stride_s + h * kD + 2 * lane;
  const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(p);
  const float x0 = __low2float(xv), x1 = __high2float(xv);
  const float c = __shfl_sync(kFull, x0, 0);  // the row's first element
  const float y0 = __fsub_rn(x0, c), y1 = __fsub_rn(x1, c);
  float mean, var;
  if (kF64) {
    const double d0 = y0, d1 = y1;
    const double s1 = warp_sum_d(__dadd_rn(d0, d1));
    const double s2 = warp_sum_d(__dadd_rn(__dmul_rn(d0, d0), __dmul_rn(d1, d1)));
    const double m1 = __dmul_rn(s1, 1.0 / kD);
    mean = __double2float_rn(m1);
    var = __double2float_rn(fmax(__dsub_rn(__dmul_rn(s2, 1.0 / kD), __dmul_rn(m1, m1)), 0.0));
  } else {
    const float s1 = warp_sum(__fadd_rn(y0, y1));
    const float s2 = warp_sum(__fadd_rn(__fmul_rn(y0, y0), __fmul_rn(y1, y1)));
    mean = __fmul_rn(s1, 1.0f / kD);
    var = fmaxf(__fsub_rn(__fmul_rn(s2, 1.0f / kD), __fmul_rn(mean, mean)), 0.0f);
  }
  const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, a.eps)));
  const float* g = a.gamma[which];
  const float* bb = a.beta[which];
  float z0 = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(y0, mean), inv), g[2 * lane]),
                       bb[2 * lane]);
  float z1 = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(y1, mean), inv), g[2 * lane + 1]),
                       bb[2 * lane + 1]);
  if (a.cos != nullptr) {
    if (row < a.rope_rows) {
      const float* cr = a.cos + (int64_t)row * kD + 2 * lane;
      const float* sr = a.sin + (int64_t)row * kD + 2 * lane;
      // (z @ R)[2i] = -z[2i+1], (z @ R)[2i+1] = z[2i]
      const float r0 = __fadd_rn(__fmul_rn(z0, cr[0]), __fmul_rn(-z1, sr[0]));
      const float r1 = __fadd_rn(__fmul_rn(z1, cr[1]), __fmul_rn(z0, sr[1]));
      z0 = r0;
      z1 = r1;
    } else {  // the TPU wrapper zero-pads the tables past their length
      z0 = 0.0f;
      z1 = 0.0f;
    }
  }
  return make_float2(z0, z1);
}

struct Cell {
  int cell, chunk, g, t, row0;
};

__device__ __forceinline__ Cell cell_of(const PrologueArgs& a) {
  Cell c;
  c.cell = blockIdx.x / a.chunks;
  c.chunk = blockIdx.x % a.chunks;
  c.g = c.cell / a.n_tiles;
  c.t = c.cell % a.n_tiles;
  c.row0 = c.t * a.block + c.chunk * kRows;
  return c;
}

template <bool kQuantize>
__global__ void __launch_bounds__(kWarps * 32) prologue_stats(PrologueArgs a) {
  const Cell c = cell_of(a);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float amax[2] = {0.0f, 0.0f}, nrm2[2] = {0.0f, 0.0f};
  const int items = kRows * a.hper;
  for (int it = warp; it < items; it += kWarps) {
    const int row = c.row0 + it / a.hper;
    if (row >= a.s_valid) break;  // rows only grow with it: the rest are zero
    const int bh = c.g * a.hper + it % a.hper;
    const int b = bh / a.H, h = bh % a.H;
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const float2 z = prologue_z<!kQuantize>(a, w, b, h, row, lane);
      const float am = warp_max(fmaxf(fabsf(z.x), fabsf(z.y)));
      const float n2 = warp_sum(__fadd_rn(__fmul_rn(z.x, z.x), __fmul_rn(z.y, z.y)));
      amax[w] = fmaxf(amax[w], am);
      nrm2[w] = fmaxf(nrm2[w], n2);
    }
  }
  __shared__ float red[4][kWarps];
  if (lane == 0) {
    red[0][warp] = amax[0];
    red[1][warp] = nrm2[0];
    red[2][warp] = amax[1];
    red[3][warp] = nrm2[1];
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    float m = 0.0f;
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, red[threadIdx.x][w]);
    // non-negative floats order like their unsigned bit patterns
    atomicMax(a.scratch + c.cell * 4 + threadIdx.x, __float_as_uint(m));
  }
}

template <bool kQuantize>
__global__ void __launch_bounds__(kWarps * 32) prologue_write(PrologueArgs a) {
  const Cell c = cell_of(a);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned* st = a.scratch + c.cell * 4;
  const float amax_q = __uint_as_float(st[0]);
  const float amax_k = __uint_as_float(st[2]);
  const float r_q = amax_q > 0.0f ? __fdiv_rn(127.0f, fmaxf(amax_q, 1e-30f)) : 0.0f;
  const float r_k = amax_k > 0.0f ? __fdiv_rn(127.0f, fmaxf(amax_k, 1e-30f)) : 0.0f;
  const int items = kRows * a.hper;
  for (int it = warp; it < items; it += kWarps) {
    const int row = c.row0 + it / a.hper;
    const int bh = c.g * a.hper + it % a.hper;
    const int b = bh / a.H, h = bh % a.H;
    const int64_t o = ((int64_t)bh * a.s_pad + row) * kD + 2 * lane;
    const bool valid = row < a.s_valid;  // warp-uniform
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      float2 z = make_float2(0.0f, 0.0f);
      if (valid) z = prologue_z<!kQuantize>(a, w, b, h, row, lane);
      void* dst = w == 0 ? a.qo : a.ko;
      if (kQuantize) {
        const float r = w == 0 ? r_q : r_k;
        char2 q;
        q.x = (signed char)__float2int_rn(rintf(__fmul_rn(z.x, r)));
        q.y = (signed char)__float2int_rn(rintf(__fmul_rn(z.y, r)));
        *reinterpret_cast<char2*>(static_cast<int8_t*>(dst) + o) = q;
      } else {  // q carries the softmax fold, k is z itself
        const float f = w == 0 ? a.fold : 1.0f;
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(dst) + o) =
            __floats2bfloat162_rn(__fmul_rn(z.x, f), __fmul_rn(z.y, f));
      }
    }
    __nv_bfloat162 vv = __floats2bfloat162_rn(0.0f, 0.0f);
    if (valid) {
      vv = *reinterpret_cast<const __nv_bfloat162*>(
          a.x[2] + (int64_t)b * a.stride_b + (int64_t)row * a.stride_s + h * kD +
          2 * lane);
    }
    *reinterpret_cast<__nv_bfloat162*>(a.v + o) = vv;
  }
  if (c.chunk == 0 && threadIdx.x == 0) {
    a.qsc[c.cell] = __fmul_rn(amax_q, a.fold127);
    a.qn[c.cell] = __fmul_rn(__fsqrt_rn(__uint_as_float(st[1])), a.fold);
    a.ksc[c.cell] = __fmul_rn(amax_k, a.inv127);
    a.kn[c.cell] = __fsqrt_rn(__uint_as_float(st[3]));
  }
}

}  // namespace

extern "C" int aether_qkv_prologue(
    const void* xq, const void* xk, const void* xv, int stride_b, int stride_s,
    const void* gq, const void* bq, const void* gk, const void* bk,
    const void* rope_cos, const void* rope_sin, int rope_rows,
    int B, int S_in, int H, int s_pad, int s_valid, int block, int hper, int quantize,
    float eps, float fold, float fold127, float inv127,
    void* qo, void* ko, void* v, void* qsc, void* qn, void* ksc, void* kn,
    void* scratch, void* stream) {
  (void)S_in;  // the wrapper guarantees s_valid <= S_in
  PrologueArgs a;
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
  a.block = block;
  a.hper = hper;
  a.n_tiles = s_pad / block;
  a.chunks = block / kRows;
  a.eps = eps;
  a.fold = fold;
  a.fold127 = fold127;
  a.inv127 = inv127;
  a.qo = qo;
  a.ko = ko;
  a.v = static_cast<__nv_bfloat16*>(v);
  a.qsc = static_cast<float*>(qsc);
  a.qn = static_cast<float*>(qn);
  a.ksc = static_cast<float*>(ksc);
  a.kn = static_cast<float*>(kn);
  a.scratch = static_cast<unsigned*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int groups = B * H / hper;
  const int grid = groups * a.n_tiles * a.chunks;
  cudaMemsetAsync(scratch, 0, sizeof(unsigned) * 4 * groups * a.n_tiles, s);
  if (quantize) {
    prologue_stats<true><<<grid, kWarps * 32, 0, s>>>(a);
    prologue_write<true><<<grid, kWarps * 32, 0, s>>>(a);
  } else {
    prologue_stats<false><<<grid, kWarps * 32, 0, s>>>(a);
    prologue_write<false><<<grid, kWarps * 32, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
