// The f32 attention cell on the CUDA cores' FMA, written by hand for Hopper
// (sm_90a): one kernel template over the head dim, the q/k type and a mode,
// shared by K4 in f32 at the head dims other than 64 (flash_online_hd.cu)
// and K3 in f32 at every head dim it takes (flash_fixed_max_hd.cu). It is
// flash_online.cu's kernel made a template: head_dim 16-128 in steps of 16,
// q and k read as f32 or as int8 codes, and the fixed shift of K3 beside
// the online max of K4.
//
// Replaces two Pallas TPU kernels of aether_tpu/ops/flash_attention.py for
// f32 v, non-causal, in the log2 domain, head group g = bh / hper:
//   kOnline  _flash_kernel (:69), K4 in f32 (the training forward), q
//            carrying sm_scale * log2(e) from the wrapper:
//              s = q . k^T,  -0.7 * f32max at columns >= kv_len
//              m' = max(m, rowmax s), alpha = exp2(m - m'), p = exp2(s - m')
//              acc = alpha acc + p . v,  l = alpha l + sum p
//            (p rounded to f32 v is p itself, so "mxu" and "vpu" are one sum);
//   kFixed   _flash_kernel_fixed_max (:151), K3 in f32 (the unfused request
//            in an f32 pipeline, DiT.forward(fixed_max=True,
//            fused_qkv=False) in f32), one scale and one shift a group from
//            the wrapper:
//              s = f32(q8 . k8^T) * scale_g (int8 codes: the sum of their
//                  products is an integer below 2^24, exact in f32) or q . k^T
//              p = exp2(s - shift_g), 0 at columns >= kv_len
//              out = sum p v / sum p (<= 0 -> 1), or unnormalized (the ring
//              merge): out = sum p v, l = sum p.
// Both products are f32: the TPU kernel keeps p in v's dtype, and a TF32
// tensor-core product (10-bit mantissa) would not hold the f32 result.
//
// What bounds it on an H100: arithmetic on the FMA units. At the main
// path's 48 heads x 15076 tokens one call is 4 * 48 * 15076^2 * D flops,
// 0.651 ms x D at 67 TFLOP/s (41.7 ms at D 64), against 1.1e10 exp2 (2.6 ms
// on the SFU). The design keeps the FMA units fed from shared memory:
//   * grid (q tiles of 64 rows, B*H), 128 threads; each CTA loops over kv
//     tiles of 64 columns, so nothing is reduced across CTAs; tiles wholly
//     past kv_len are skipped (they change nothing: alpha = 1, p = 0);
//   * q, k, v tiles in shared memory as f32 (int8 codes converted as they
//     load), rows padded to D + 4 floats, and p to 68, so the
//     column-strided reads are conflict-free; 3 * 64 * (D + 4) * 4 + 17 KB
//     a CTA (119 KB at D 128, opted in above 48 KB);
//   * each thread owns a 4-row x 8-column micro-tile of s, and 4 rows x
//     D / 8 output columns in pairs (2 tc + 16 i): every shared-memory load
//     feeds 8 or 16 FMAs, and a row's max and sum combine across its 8
//     threads with three shuffles;
//   * rows past the q and kv lengths load as zeros and stores past sq are
//     dropped, so no wrapper pads.
// Compiled without --use_fast_math so exp2f and the division stay accurate.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {
namespace fma_cell {

constexpr int kBM = 64;       // q rows per CTA
constexpr int kBN = 64;       // kv columns per tile
constexpr int kThreads = 128;
constexpr int kPStride = kBN + 4;  // floats a p row in shared memory
constexpr float kNegInf = -0.7f * 3.40282347e38f;  // the TPU kernel's mask
constexpr unsigned kFull = 0xffffffffu;
enum Mode { kFixed = 1, kOnline = 2 };

struct Params {
  const void* q;      // [BH, sq, D] f32 or int8
  const void* k;      // [BH, skv, D] f32 or int8
  const float* v;     // [BH, skv, D]
  float* out;         // [BH, sq, D]
  float* l;           // kFixed: [BH, sq] (unnormalized) or null
  const float* shift; // kFixed: [G]
  const float* scale; // kFixed, int8 q/k: [G]
  int sq, skv, kv_len, hper;
};

template <int D>
constexpr int smem_bytes() {
  return (3 * kBM * (D + 4) + kBM * kPStride) * static_cast<int>(sizeof(float));
}

// rows [r0, r0 + 64) of a [rows, D] matrix of f32 (or int8 codes, made f32)
// into shared memory (row stride D + 4); rows at or past `rows` as zeros
template <int D, bool kI8>
__device__ __forceinline__ void load_tile(float* dst, const void* src, int r0, int rows,
                                          int tid) {
  constexpr int kChunks = D / 4;  // 4 values a chunk
  for (int i = tid; i < 64 * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r0 + r < rows) {
      const int64_t off = (int64_t)(r0 + r) * D + c;
      if constexpr (kI8) {
        const char4 b = *reinterpret_cast<const char4*>(static_cast<const int8_t*>(src) + off);
        x = make_float4(b.x, b.y, b.z, b.w);
      } else {
        x = *reinterpret_cast<const float4*>(static_cast<const float*>(src) + off);
      }
    }
    *reinterpret_cast<float4*>(dst + r * (D + 4) + c) = x;
  }
}

// kI8: q and k are int8 codes (kFixed only)
template <int D, bool kI8, int kMode>
__global__ void __launch_bounds__(kThreads) cell_kernel(const Params p) {
  static_assert(D % 16 == 0 && D <= 128, "head_dim: a multiple of 16 up to 128");
  static_assert(!(kI8 && kMode == kOnline), "K4 takes f32 q/k");
  constexpr int kStride = D + 4;  // floats a q, k or v row in shared memory
  constexpr int kPairs = D / 16;  // output column pairs a thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + kBM * kStride;
  float* vs = ks + kBN * kStride;
  float* ps = vs + kBN * kStride;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // rows tr*4 .. tr*4+3; s columns tc + 8i; output columns 2 tc + 16 i, + 1.
  // The 8 threads of a row group are lanes xor 1, 2, 4.
  const int tr = warp * 4 + (lane >> 3);
  const int tc = lane & 7;
  const int g = bh / p.hper;
  const float shift = kMode == kFixed ? p.shift[g] : 0.0f;
  const float sc = kI8 ? p.scale[g] : 1.0f;

  constexpr int kEl = kI8 ? 1 : 4;  // bytes a q or k value
  load_tile<D, kI8>(qs, static_cast<const uint8_t*>(p.q) + (int64_t)bh * p.sq * D * kEl, q0,
                    p.sq, tid);

  float o[4][2 * kPairs], m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.0f;
#pragma unroll
    for (int j = 0; j < 2 * kPairs; ++j) o[a][j] = 0.0f;
  }

  const uint8_t* kbase = static_cast<const uint8_t*>(p.k) + (int64_t)bh * p.skv * D * kEl;
  const float* vbase = p.v + (int64_t)bh * p.skv * D;
  const int kv_end = ((p.kv_len + kBN - 1) / kBN) * kBN;

  for (int kv0 = 0; kv0 < kv_end; kv0 += kBN) {
    __syncthreads();  // the previous tile's k, v and p are consumed
    load_tile<D, kI8>(ks, kbase, kv0, p.skv, tid);
    load_tile<D, false>(vs, vbase, kv0, p.skv, tid);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int i = 0; i < 8; ++i) s[a][i] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], kb[8];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        qa[a] = *reinterpret_cast<const float4*>(qs + (tr * 4 + a) * kStride + d);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        kb[i] = *reinterpret_cast<const float4*>(ks + (tc + 8 * i) * kStride + d);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s[a][i] = fmaf(qa[a].x, kb[i].x, s[a][i]);
          s[a][i] = fmaf(qa[a].y, kb[i].y, s[a][i]);
          s[a][i] = fmaf(qa[a].z, kb[i].z, s[a][i]);
          s[a][i] = fmaf(qa[a].w, kb[i].w, s[a][i]);
        }
    }

    const bool tail = kv0 + kBN > p.kv_len;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float alpha = 1.0f, sub = shift;
      if (kMode == kOnline) {
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (tail && kv0 + tc + 8 * i >= p.kv_len) s[a][i] = kNegInf;
          mx = fmaxf(mx, s[a][i]);
        }
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 4));
        const float m_next = fmaxf(m[a], mx);
        alpha = exp2f(__fsub_rn(m[a], m_next));  // 0 on the first tile
        m[a] = sub = m_next;
      }
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float x = kI8 ? __fmul_rn(s[a][i], sc) : s[a][i];
        float pr = exp2f(__fsub_rn(x, sub));
        if (kMode == kFixed && tail && kv0 + tc + 8 * i >= p.kv_len) pr = 0.0f;
        sum = __fadd_rn(sum, pr);
        ps[(tr * 4 + a) * kPStride + tc + 8 * i] = pr;
      }
      l[a] = __fadd_rn(__fmul_rn(alpha, l[a]), sum);
      if (kMode == kOnline) {
#pragma unroll
        for (int j = 0; j < 2 * kPairs; ++j) o[a][j] = __fmul_rn(o[a][j], alpha);
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < kBN; c += 4) {
      float4 pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        pa[a] = *reinterpret_cast<const float4*>(ps + (tr * 4 + a) * kPStride + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = vs + (c + cc) * kStride + 2 * tc;
        float2 vv[kPairs];
#pragma unroll
        for (int i = 0; i < kPairs; ++i) vv[i] = *reinterpret_cast<const float2*>(vrow + 16 * i);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float pr = cc == 0 ? pa[a].x : cc == 1 ? pa[a].y : cc == 2 ? pa[a].z : pa[a].w;
#pragma unroll
          for (int i = 0; i < kPairs; ++i) {
            o[a][2 * i] = fmaf(pr, vv[i].x, o[a][2 * i]);
            o[a][2 * i + 1] = fmaf(pr, vv[i].y, o[a][2 * i + 1]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float la = l[a];
    la = __fadd_rn(la, __shfl_xor_sync(kFull, la, 1));
    la = __fadd_rn(la, __shfl_xor_sync(kFull, la, 2));
    la = __fadd_rn(la, __shfl_xor_sync(kFull, la, 4));
    const int row = q0 + tr * 4 + a;
    float inv = 1.0f;
    if (kMode == kFixed && p.l != nullptr) {  // unnormalized: the raw numerator and l
      if (tc == 0 && row < p.sq) p.l[(int64_t)bh * p.sq + row] = la;
    } else {
      inv = la <= 0.0f ? 1.0f : __fdiv_rn(1.0f, la);
    }
    if (row < p.sq) {
      float* orow = p.out + ((int64_t)bh * p.sq + row) * D + 2 * tc;
#pragma unroll
      for (int i = 0; i < kPairs; ++i)
        *reinterpret_cast<float2*>(orow + 16 * i) =
            make_float2(__fmul_rn(o[a][2 * i], inv), __fmul_rn(o[a][2 * i + 1], inv));
    }
  }
}

// One launch of an instance, grid (q tiles of 64 rows, BH). Returns a
// cudaError_t.
template <int D, bool kI8, int kMode>
int launch(const Params& p, int BH, cudaStream_t st) {
  constexpr int kSmem = smem_bytes<D>();
  auto kernel = cell_kernel<D, kI8, kMode>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.sq + kBM - 1) / kBM, BH);
  kernel<<<grid, kThreads, kSmem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The instance for a head dim given at run time: a multiple of 16 from 16
// to `kMax` (kOnline: not 64, flash_online.cu's); any other returns
// cudaErrorInvalidValue.
template <bool kI8, int kMode, int kMax>
int launch_dim(const Params& p, int BH, int D, cudaStream_t st) {
  if (D > kMax) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 16: return launch<16, kI8, kMode>(p, BH, st);
    case 32: return launch<32, kI8, kMode>(p, BH, st);
    case 48: return launch<48, kI8, kMode>(p, BH, st);
    case 64:
      if constexpr (kMode == kFixed) return launch<64, kI8, kMode>(p, BH, st);
      return static_cast<int>(cudaErrorInvalidValue);
    case 80: return launch<80, kI8, kMode>(p, BH, st);
    case 96: return launch<96, kI8, kMode>(p, BH, st);
    case 112: return launch<112, kI8, kMode>(p, BH, st);
    case 128:
      if constexpr (kMax >= 128) return launch<128, kI8, kMode>(p, BH, st);
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace fma_cell
}  // namespace
