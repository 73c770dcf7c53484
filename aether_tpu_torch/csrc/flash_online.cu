// K4 in f32: online-softmax flash attention, written by hand for Hopper
// (sm_90a). This file holds the f32 form only; the bf16 form is
// csrc/flash_online_bf16.cu (wgmma and TMA).
//
// Replaces aether_tpu/ops/flash_attention.py::_flash_kernel (the Pallas TPU
// kernel launched by flash_attention(fixed_max=False)) for f32 q/k/v: the
// forward of the training path. Non-causal attention, head_dim 64, in the
// log2 domain, q pre-scaled by sm_scale * log2(e) in the wrapper:
//   s   = q . k^T                              (f32 products and sums)
//   s   = -0.7 * f32max  where column >= kv_len
//   m'  = max(m, rowmax s),  alpha = exp2(m - m'),  p = exp2(s - m')
//   acc = alpha * acc + p . v
//   l   = alpha * l + sum p
//   out = acc / l, a zero l divides by 1
// (p rounded to v's dtype is p itself in f32, so both of the TPU kernel's
// denominators are the same sum here.) The kernel computes the TPU kernel's
// function up to the order of sums and the kv tiling (64 columns here, 1024
// there).
//
// What bounds it on an H100: arithmetic. One call at the training shape
// (48 heads x 15076 tokens) is 2.8e12 flops and 1.1e10 exp2. The training
// path runs it in f32, whose accuracy a TF32 tensor-core product (10-bit
// mantissa) would not keep, so both products run as f32 FMA on the CUDA
// cores (67 TFLOP/s peak, >= 42 ms per call); exp2 on the SFU is ~3 ms. The
// design keeps the FMA units fed from shared memory:
//   * grid (q tiles of 64 rows, B*H), 128 threads; each CTA loops over kv
//     tiles of 64 columns, so nothing is reduced across CTAs;
//   * q, k, v and p tiles live in shared memory as f32, rows padded to 68
//     floats so the column-strided reads are conflict-free; 68 KB a CTA,
//     three CTAs an SM;
//   * each thread owns a 4-row x 8-column micro-tile of s and of the output:
//     every 16-byte shared-memory load feeds 8 or 16 FMAs, and a row's
//     max and sum combine across its 8 threads with three shuffles;
//   * columns past kv_len are masked only in the last tile, and tiles wholly
//     past kv_len are skipped (they change nothing: alpha = 1, p = 0).
// Compiled without --use_fast_math so exp2f and the division stay accurate.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;
constexpr int kBM = 64;                 // q rows per CTA
constexpr int kBN = 64;                 // kv columns per tile
constexpr int kThreads = 128;
constexpr int kStride = kD + 4;         // floats per shared-memory row
constexpr int kSmemBytes = 4 * 64 * kStride * sizeof(float);
constexpr float kNegInf = -0.7f * 3.40282347e38f;  // the TPU kernel's mask
constexpr unsigned kFull = 0xffffffffu;

// 64 rows x 64 floats (row stride 64) from device memory into shared
// memory (row stride kStride), in 16-byte chunks
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int tid) {
  constexpr int kChunks = kD / 4;  // chunks per row
#pragma unroll
  for (int i = tid; i < 64 * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    *reinterpret_cast<float4*>(dst + r * kStride + c) =
        *reinterpret_cast<const float4*>(src + (int64_t)r * kD + c);
  }
}

__global__ void __launch_bounds__(kThreads)
flash_online_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out, int sq, int skv,
                    int kv_len) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + kBM * kStride;
  float* vs = ks + kBN * kStride;
  float* ps = vs + kBN * kStride;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // rows tr*4 .. tr*4+3; s columns tc + 8i; output columns tc*4 + j and
  // 32 + tc*4 + j. The 8 threads of a row group are lanes xor 1, 2, 4.
  const int tr = warp * 4 + (lane >> 3);
  const int tc = lane & 7;

  load_tile(qs, q + ((int64_t)bh * sq + q0) * kD, tid);

  float o[4][8], m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) o[a][j] = 0.0f;
  }

  const float* kbase = k + (int64_t)bh * skv * kD;
  const float* vbase = v + (int64_t)bh * skv * kD;
  const int kv_end = ((kv_len + kBN - 1) / kBN) * kBN;

  for (int kv0 = 0; kv0 < kv_end; kv0 += kBN) {
    __syncthreads();  // the previous tile's k, v and p are consumed
    load_tile(ks, kbase + (int64_t)kv0 * kD, tid);
    load_tile(vs, vbase + (int64_t)kv0 * kD, tid);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int i = 0; i < 8; ++i) s[a][i] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < kD; d += 4) {
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

    const bool tail = kv0 + kBN > kv_len;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (tail && kv0 + tc + 8 * i >= kv_len) s[a][i] = kNegInf;
        mx = fmaxf(mx, s[a][i]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 4));
      const float m_next = fmaxf(m[a], mx);
      const float alpha = exp2f(__fsub_rn(m[a], m_next));  // 0 on the first tile
      m[a] = m_next;
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p = exp2f(__fsub_rn(s[a][i], m_next));
        sum = __fadd_rn(sum, p);
        ps[(tr * 4 + a) * kStride + tc + 8 * i] = p;
      }
      l[a] = __fadd_rn(__fmul_rn(alpha, l[a]), sum);
#pragma unroll
      for (int j = 0; j < 8; ++j) o[a][j] = __fmul_rn(o[a][j], alpha);
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < kBN; c += 4) {
      float4 pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        pa[a] = *reinterpret_cast<const float4*>(ps + (tr * 4 + a) * kStride + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float4 v0 = *reinterpret_cast<const float4*>(vs + (c + cc) * kStride + tc * 4);
        const float4 v1 =
            *reinterpret_cast<const float4*>(vs + (c + cc) * kStride + 32 + tc * 4);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float p = cc == 0 ? pa[a].x : cc == 1 ? pa[a].y : cc == 2 ? pa[a].z : pa[a].w;
          o[a][0] = fmaf(p, v0.x, o[a][0]);
          o[a][1] = fmaf(p, v0.y, o[a][1]);
          o[a][2] = fmaf(p, v0.z, o[a][2]);
          o[a][3] = fmaf(p, v0.w, o[a][3]);
          o[a][4] = fmaf(p, v1.x, o[a][4]);
          o[a][5] = fmaf(p, v1.y, o[a][5]);
          o[a][6] = fmaf(p, v1.z, o[a][6]);
          o[a][7] = fmaf(p, v1.w, o[a][7]);
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
    const float inv = la <= 0.0f ? 1.0f : __fdiv_rn(1.0f, la);
    float* orow = out + ((int64_t)bh * sq + q0 + tr * 4 + a) * kD;
    *reinterpret_cast<float4*>(orow + tc * 4) =
        make_float4(__fmul_rn(o[a][0], inv), __fmul_rn(o[a][1], inv),
                    __fmul_rn(o[a][2], inv), __fmul_rn(o[a][3], inv));
    *reinterpret_cast<float4*>(orow + 32 + tc * 4) =
        make_float4(__fmul_rn(o[a][4], inv), __fmul_rn(o[a][5], inv),
                    __fmul_rn(o[a][6], inv), __fmul_rn(o[a][7], inv));
  }
}

}  // namespace

// q, k, v, out: [BH, sq or skv, 64] float, sq and skv multiples of 64,
// kv_len <= skv; q carries sm_scale * log2(e).
extern "C" int aether_flash_online(const void* q, const void* k, const void* v,
                                   void* out, int BH, int sq, int skv, int kv_len,
                                   void* stream) {
  if (sq % kBM || skv % kBN || kv_len < 0 || kv_len > skv)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_online_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(sq / kBM, BH);
  flash_online_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), sq, skv, kv_len);
  return static_cast<int>(cudaGetLastError());
}
