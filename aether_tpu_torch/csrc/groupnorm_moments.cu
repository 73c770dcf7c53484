// K5: GroupNorm moments, written by hand for Hopper (sm_90a) in CUDA C++.
//
// Replaces aether_tpu/ops/groupnorm.py::_moments_kernel (the Pallas TPU
// kernel launched by groupnorm_moments). For every (batch b, channel c):
//   m1[b, c] = mean over (T, H, W) of (x - c0[b, c])
//   m2[b, c] = mean over (T, H, W) of (x - c0[b, c])^2
// with x in f32, bf16 or f16, every product and sum in f32, and the two
// [B, C] f32 outputs. c0 is the caller's per-channel shift (the group's first
// voxel), which bounds the cancellation of m2 - m1^2 for large-mean groups.
//
// Route: CUDA C++, the rule for this port, although a pure reduction would
// qualify for Triton: it shares the ctypes build of the other kernels, and
// the deterministic two-pass combine below is a few lines here.
//
// What bounds it on an H100: bytes. The 480p decode stage's input, (2, 128,
// 9, 256, 720) bf16, is 849 MB, read once; the arithmetic (4 flops an
// element) is nothing next to it, so the floor is 849 MB / 3.35 TB/s ~ 0.25
// ms. The plain PyTorch version writes and reads two full-size f32 copies
// (x - c0 and its square) besides: ~5x the bytes. The design reads each
// element exactly once and writes only partial sums:
//   * two layouts, both read in place: rows (NCTHW contiguous, each (b, c)
//     one row of T*H*W elements) and channels-last (NTHWC, [B, T*H*W, C]),
//     since cuDNN may hand either to the VAE's norms;
//   * pass 1 cuts every reduction into `splits` chunks so ~1000 CTAs of 256
//     threads cover the card; each thread loads 16 bytes at a time (8 bf16,
//     4 f32) where the chunk is 16-byte aligned, keeps its sums in
//     registers, and the CTA combines them through warp shuffles and shared
//     memory in a fixed tree; one partial (s1, s2) per (b, split, c) goes out;
//   * pass 2 adds each (b, c)'s partials in split order, in double, and
//     divides by T*H*W.
// No atomics: the result depends only on the shape, the layout and the
// input's 16-byte alignment, so two launches on the same input are
// bit-identical.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}

// elements of T in one 16-byte load
template <typename T> struct Vec { static constexpr int n = 16 / sizeof(T); };

// V consecutive elements at p as f32: one 16-byte load when V is a whole
// vector (p must then be 16-byte aligned), else V scalar loads
template <typename T, int V>
__device__ __forceinline__ void load(const T* __restrict__ p, float* out) {
  if constexpr (V == Vec<T>::n) {
    uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = to_f<T>(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = to_f<T>(p[i]);
  }
}

__device__ __forceinline__ void accumulate(float x, float shift, float& s1, float& s2) {
  const float y = x - shift;
  s1 += y;
  s2 = fmaf(y, y, s2);
}

// Sum of v over the CTA in a fixed order; the result is valid in thread 0.
__device__ __forceinline__ float cta_sum(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // scratch may still be read from a previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += scratch[w];
  }
  return total;
}

// Pass 1, rows layout: grid (splits, B*C). CTA (s, row) reduces elements
// [s*chunk, min((s+1)*chunk, n)) of row `row`.
template <typename T>
__global__ void __launch_bounds__(kThreads)
moments_rows(const T* __restrict__ x, const float* __restrict__ c0,
             float* __restrict__ p1, float* __restrict__ p2, long long n,
             long long chunk, int splits, int channels) {
  constexpr int V = Vec<T>::n;
  __shared__ float scratch[kWarps];
  const int split = blockIdx.x;
  const long long row = blockIdx.y;
  const long long begin = split * chunk;
  const long long len = min(begin + chunk, n) - begin;
  const T* __restrict__ p = x + row * n + begin;
  const float shift = c0[row];
  float s1 = 0.f, s2 = 0.f;
  long long done = 0;
  if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {  // the same for the whole CTA
    const long long nvec = len / V;
#pragma unroll 4
    for (long long i = threadIdx.x; i < nvec; i += kThreads) {
      float v[V];
      load<T, V>(p + i * V, v);
#pragma unroll
      for (int j = 0; j < V; ++j) accumulate(v[j], shift, s1, s2);
    }
    done = nvec * V;
  }
  for (long long i = done + threadIdx.x; i < len; i += kThreads)
    accumulate(to_f<T>(p[i]), shift, s1, s2);
  s1 = cta_sum(s1, scratch);
  s2 = cta_sum(s2, scratch);
  if (threadIdx.x == 0) {
    const long long b = row / channels, c = row % channels;
    const long long at = (b * splits + split) * channels + c;
    p1[at] = s1;
    p2[at] = s2;
  }
}

// Pass 1, channels-last layout: grid (splits, channel tiles, B). Thread t
// owns V consecutive channels (vector g = tile * g_tile + t % g_tile) and
// walks positions begin + t / g_tile, stepping rows_per = 256 / g_tile.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
moments_channels_last(const T* __restrict__ x, const float* __restrict__ c0,
                      float* __restrict__ p1, float* __restrict__ p2, long long n,
                      long long chunk, int splits, int channels, int g_tile) {
  __shared__ float sums[kThreads][2 * V];
  const int split = blockIdx.x, b = blockIdx.z;
  const int groups = channels / V;
  const int rows_per = kThreads / g_tile;
  const int gl = threadIdx.x % g_tile, ro = threadIdx.x / g_tile;
  const int g = blockIdx.y * g_tile + gl;
  const bool active = ro < rows_per && g < groups;
  float s1[V], s2[V], shift[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s1[j] = s2[j] = shift[j] = 0.f;
  if (active) {
    const long long begin = split * chunk;
    const long long end = min(begin + chunk, n);
#pragma unroll
    for (int j = 0; j < V; ++j) shift[j] = c0[(long long)b * channels + g * V + j];
    const T* __restrict__ base = x + (long long)b * n * channels + (long long)g * V;
#pragma unroll 4
    for (long long r = begin + ro; r < end; r += rows_per) {
      float v[V];
      load<T, V>(base + r * channels, v);
#pragma unroll
      for (int j = 0; j < V; ++j) accumulate(v[j], shift[j], s1[j], s2[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    sums[threadIdx.x][j] = s1[j];
    sums[threadIdx.x][V + j] = s2[j];
  }
  __syncthreads();
  if (ro == 0 && g < groups) {
    for (int r = 1; r < rows_per; ++r) {  // fixed order
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s1[j] += sums[r * g_tile + gl][j];
        s2[j] += sums[r * g_tile + gl][V + j];
      }
    }
    const long long at = ((long long)b * splits + split) * channels + (long long)g * V;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      p1[at + j] = s1[j];
      p2[at + j] = s2[j];
    }
  }
}

// Pass 2: one thread per (b, c) adds its `splits` partials in order.
__global__ void moments_finish(const float* __restrict__ p1, const float* __restrict__ p2,
                               float* __restrict__ m1, float* __restrict__ m2, int batch,
                               int channels, int splits, long long n) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)batch * channels) return;
  const long long b = idx / channels, c = idx % channels;
  double a = 0.0, q = 0.0;
  for (int s = 0; s < splits; ++s) {
    const long long at = (b * splits + s) * channels + c;
    a += p1[at];
    q += p2[at];
  }
  m1[idx] = static_cast<float>(a / static_cast<double>(n));
  m2[idx] = static_cast<float>(q / static_cast<double>(n));
}

template <typename T>
int launch(const void* x, const float* c0, float* p1, float* p2, float* m1, float* m2,
           int batch, int channels, long long n, int channels_last, int splits,
           long long chunk, int vec, int g_tile, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  if (!channels_last) {
    moments_rows<T><<<dim3(splits, batch * channels), kThreads, 0, st>>>(
        xt, c0, p1, p2, n, chunk, splits, channels);
  } else {
    const int groups = channels / vec;
    const dim3 grid(splits, (groups + g_tile - 1) / g_tile, batch);
    if (vec == Vec<T>::n)
      moments_channels_last<T, Vec<T>::n><<<grid, kThreads, 0, st>>>(
          xt, c0, p1, p2, n, chunk, splits, channels, g_tile);
    else
      moments_channels_last<T, 1><<<grid, kThreads, 0, st>>>(
          xt, c0, p1, p2, n, chunk, splits, channels, g_tile);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = batch * channels;
  moments_finish<<<(rows + 255) / 256, 256, 0, st>>>(p1, p2, m1, m2, batch, channels,
                                                     splits, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [B, C, n] (channels_last 0) or [B, n, C] (channels_last 1), dtype 0 f32,
// 1 bf16, 2 f16; c0, m1, m2: [B, C] f32; p1, p2: [B, splits, C] f32 scratch.
// vec (channels-last only): channels per thread, 1 or a 16-byte vector;
// g_tile: channel vectors per CTA, dividing 256. Returns cudaGetLastError().
extern "C" int aether_groupnorm_moments(const void* x, const float* c0, float* p1,
                                        float* p2, float* m1, float* m2, int batch,
                                        int channels, long long n, int channels_last,
                                        int splits, long long chunk, int vec, int g_tile,
                                        int dtype, void* stream) {
  if (batch < 1 || channels < 1 || n < 1 || splits < 1 || chunk < 1 ||
      (long long)splits * chunk < n || (long long)(splits - 1) * chunk >= n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (channels_last && (vec < 1 || channels % vec || g_tile < 1 || g_tile > kThreads ||
                        kThreads % g_tile))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, c0, p1, p2, m1, m2, batch, channels, n, channels_last, splits,
                         chunk, vec, g_tile, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, c0, p1, p2, m1, m2, batch, channels, n, channels_last,
                                 splits, chunk, vec, g_tile, st);
  if (dtype == 2)
    return launch<__half>(x, c0, p1, p2, m1, m2, batch, channels, n, channels_last, splits,
                          chunk, vec, g_tile, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
