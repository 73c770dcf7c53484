// K4: online-softmax flash attention, written by hand for Hopper (sm_90a).
//
// Replaces aether_tpu/ops/flash_attention.py::_flash_kernel (the Pallas TPU
// kernel launched by flash_attention(fixed_max=False)): the forward of the
// training path and the attention at AETHER_ATTN_FIXED_MAX=0. Non-causal
// attention, head_dim 64, in the log2 domain, q pre-scaled by
// sm_scale * log2(e) in the wrapper; T is the input type (float or bf16):
//   s   = q . k^T                              (f32 products and sums)
//   s   = -0.7 * f32max  where column >= kv_len
//   m'  = max(m, rowmax s),  alpha = exp2(m - m'),  p = exp2(s - m')
//   acc = alpha * acc + T(p) . v
//   l   = alpha * l + sum T(p)   (round_l: the TPU's ones column of the PV
//                                 matmul summed p rounded to v's dtype)
//       = alpha * l + sum p      (!round_l: the TPU's separate l)
//   out = T(acc / l), a zero l divides by 1
// T(p) is p itself for float. bf16 products are exact in f32, so the bf16
// kernel computes the TPU kernel's function exactly up to the order of sums
// and the kv tiling (64 columns here, 1024 there), which moves the running
// max and with it the rounding of p.
//
// What bounds it on an H100: arithmetic. One call at the training shape
// (48 heads x 15076 tokens) is 2.8e12 flops and 1.1e10 exp2. The training
// path runs it in f32, whose accuracy a TF32 tensor-core product (10-bit
// mantissa) would not keep, so both products run as f32 FMA on the CUDA
// cores (67 TFLOP/s peak, >= 42 ms per call); exp2 on the SFU is ~3 ms. The
// design keeps the FMA units fed from shared memory:
//   * grid (q tiles of 64 rows, B*H), 128 threads; each CTA loops over kv
//     tiles of 64 columns, so nothing is reduced across CTAs;
//   * q, k, v and p tiles live in shared memory as f32 (bf16 converted once
//     on load), rows padded to 68 floats so the column-strided reads are
//     conflict-free; 68 KB a CTA, three CTAs an SM;
//   * each thread owns a 4-row x 8-column micro-tile of s and of the output:
//     every 16-byte shared-memory load feeds 8 or 16 FMAs, and a row's
//     max and sum combine across its 8 threads with three shuffles;
//   * columns past kv_len are masked only in the last tile, and tiles wholly
//     past kv_len are skipped (they change nothing: alpha = 1, p = 0).
// bf16 on the tensor cores (mma.sync, as K2), cp.async or TMA pipelining and
// wgmma are later work; this is the simple form.
// Compiled without --use_fast_math so exp2f and the division stay accurate.

#include <cuda_bf16.h>
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

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x rounded to T and back (the identity for float)
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T> __device__ __forceinline__ void store4(T* p, float a, float b,
                                                            float c, float d);
template <> __device__ __forceinline__ void store4<float>(float* p, float a, float b,
                                                         float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
template <> __device__ __forceinline__ void store4<__nv_bfloat16>(
    __nv_bfloat16* p, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 bits;
  bits.x = *reinterpret_cast<uint32_t*>(&lo);
  bits.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = bits;
}

// 64 rows x 64 of T (row stride 64) from device memory into f32 shared
// memory (row stride kStride), in 16-byte chunks
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int tid) {
  constexpr int kPer = 16 / sizeof(T);  // elements per chunk
  constexpr int kChunks = kD / kPer;    // chunks per row
#pragma unroll
  for (int i = tid; i < 64 * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kPer;
    const int4 raw = *reinterpret_cast<const int4*>(src + (int64_t)r * kD + c);
    const T* e = reinterpret_cast<const T*>(&raw);
    float* d = dst + r * kStride + c;
#pragma unroll
    for (int j = 0; j < kPer; j += 4)
      *reinterpret_cast<float4*>(d + j) =
          make_float4(to_f<T>(e[j]), to_f<T>(e[j + 1]), to_f<T>(e[j + 2]), to_f<T>(e[j + 3]));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_online_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out, int sq, int skv,
                    int kv_len, int round_l) {
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

  load_tile<T>(qs, q + ((int64_t)bh * sq + q0) * kD, tid);

  float o[4][8], m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) o[a][j] = 0.0f;
  }

  const T* kbase = k + (int64_t)bh * skv * kD;
  const T* vbase = v + (int64_t)bh * skv * kD;
  const int kv_end = ((kv_len + kBN - 1) / kBN) * kBN;

  for (int kv0 = 0; kv0 < kv_end; kv0 += kBN) {
    __syncthreads();  // the previous tile's k, v and p are consumed
    load_tile<T>(ks, kbase + (int64_t)kv0 * kD, tid);
    load_tile<T>(vs, vbase + (int64_t)kv0 * kD, tid);
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
        const float pr = round_to<T>(p);
        sum = __fadd_rn(sum, round_l ? pr : p);
        ps[(tr * 4 + a) * kStride + tc + 8 * i] = pr;
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
    T* orow = out + ((int64_t)bh * sq + q0 + tr * 4 + a) * kD;
    store4<T>(orow + tc * 4, __fmul_rn(o[a][0], inv), __fmul_rn(o[a][1], inv),
              __fmul_rn(o[a][2], inv), __fmul_rn(o[a][3], inv));
    store4<T>(orow + 32 + tc * 4, __fmul_rn(o[a][4], inv), __fmul_rn(o[a][5], inv),
              __fmul_rn(o[a][6], inv), __fmul_rn(o[a][7], inv));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int BH, int sq,
           int skv, int kv_len, int round_l, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_online_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(sq / kBM, BH);
  flash_online_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), sq, skv, kv_len, round_l);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out: [BH, sq or skv, 64] of float (dtype 0) or bf16 (dtype 1),
// sq and skv multiples of 64, kv_len <= skv; q carries sm_scale * log2(e).
extern "C" int aether_flash_online(const void* q, const void* k, const void* v,
                                   void* out, int BH, int sq, int skv, int kv_len,
                                   int dtype, int round_l, void* stream) {
  if (sq % kBM || skv % kBN || kv_len < 0 || kv_len > skv)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, out, BH, sq, skv, kv_len, round_l, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, BH, sq, skv, kv_len, round_l, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
