// The score exchange of K4's wide kernels alone (hopper.cuh's
// ScoreExchange), on an H100: clusters of n CTAs of 384 threads (two consumer
// warpgroups and an idle producer warpgroup, as the kernels have) with the
// kernels' 224 KB of shared memory (one CTA an SM), each running `tiles`
// exchanges of a 128 x 64 f32 part of S, with no product around them, in the
// kernels' forms (pushed for n = 2, pulled above) or pulled at every n.
// Built and timed by dsmem_probe.py.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 384, kConsumers = 256, kSmem = 224 * 1024;

using Exchange = ScoreExchange<8, 32>;

// kPull: pulled at every n, a pair too; else sum()'s form
template <bool kPull>
__global__ void __launch_bounds__(kThreads, 1) probe_kernel(float* out, int* bad, int tiles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  Exchange& x = *reinterpret_cast<Exchange*>(base);
  const int n = static_cast<int>(gridDim.y);  // the grid's y axis is one cluster
  const int rank = static_cast<int>(cluster_ctarank());
  if (threadIdx.x == 0) {
    x.init(kPull ? n : x.arrivals(n));
    mbar_init_fence();
  }
  cluster_arrive();
  cluster_wait();
  if (threadIdx.x < kConsumers) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    float s[32], total = 0.0f;
    int wrong = 0;
    for (int t = 0; t < tiles; ++t) {
      // small integers: every sum is exact, so the expected S is known
#pragma unroll
      for (int j = 0; j < 32; ++j)
        s[j] = static_cast<float>((t + j + threadIdx.x) % 64 + 128 * rank);
      if (kPull)
        x.pull(s, t, n, rank, warp, lane);
      else
        x.sum(s, t, n, rank, warp, lane);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float want =
            static_cast<float>(n * ((t + j + threadIdx.x) % 64) + 64 * n * (n - 1));
        wrong |= s[j] != want;
        total += s[j];
      }
    }
    out[((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * kConsumers +
        threadIdx.x] = total;
    if (wrong) atomicAdd(bad, 1);
  }
  cluster_arrive();  // no CTA leaves while another may read or write its shared memory
  cluster_wait();
}

}  // namespace

// pull: 1 to pull at every n; grid (q_tiles, n, heads) in clusters
// of (1, n, 1); out: f32 [q_tiles * n * heads * 256]; bad: int, counts
// threads whose sums were wrong. Returns a cudaError_t.
extern "C" int aether_dsmem_probe(void* out, void* bad, int pull, int q_tiles, int n,
                                  int heads, int tiles, void* stream) {
  if (n < 1 || n > kWideCluster || q_tiles < 1 || heads < 1 || tiles < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  void (*fn)(float*, int*, int) = pull ? probe_kernel<true> : probe_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(q_tiles, n, heads);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = n;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fn, static_cast<float*>(out), static_cast<int*>(bad), tiles);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
