// The whole stock-trend query as one kernel for Hopper (sm_90a), bound
// through a plain C interface (ctypes; see ../build.py).  It replaces the
// Pallas TPU kernel of src/repro/kernels/fused_query.py (_kernel):
//
//   fused_trend  diff[t] = mean_w1(t) - mean_w2(t), uptrend[t] = diff > 0,
//                each mean a trailing window over x[t-w+1 .. t] divided by
//                min(t+1, w), ticks before 0 counting as 0, w1 < w2.
//
// The TPU kernel takes the timeline as rows ("stripes") of width W = w2 and
// forms every trailing sum of up to W ticks from a prefix scan of the
// current stripe and a suffix scan of the one before it:
//   t = kW + j:  s_w(t) = P_k[j] - P_k[j-w]                  (j >= w)
//                s_w(t) = P_k[j] + S_{k-1}[W - (w-1-j)]      (j <  w)
// so no partial sum spans more than one stripe, and the f32 error of a
// window sum is bounded by W ticks' content, not by the stream position.
// Here one block owns S = max(1, 1024 / W) consecutive stripes of outputs.
// Its warps scan those stripes and the one before them (prefix and suffix,
// by warp shuffles, 32 ticks at a time with a carry) into shared memory,
// once; then every thread forms both window sums of its outputs from
// shared memory, divides, subtracts and writes diff and uptrend.
//
// Bound: bytes.  One f32 read per tick and one f32 plus one byte written;
// the kernel reads each tick twice (prefix and suffix pass) and the block's
// leading stripe a third time, through L2.  A handful of f32 operations per
// tick is far under the card's f32 rate.
//
// Every exported function launches on the given stream, allocates nothing
// and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FT_THREADS = 256;
constexpr int FT_WARPS = FT_THREADS / 32;
constexpr int FT_TILE = 1024;  // outputs per block, rounded to stripes
constexpr int FT_MAX_SMEM = 232448;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_inclusive_scan(float v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

// trailing w-sum at lane j of local stripe r >= 1 (the Pallas body's wsum)
__device__ __forceinline__ float window_sum(const float* pre,
                                           const float* suf, int W, int r,
                                           int j, int w) {
  float s = pre[r * W + j];
  if (j >= w) s -= pre[r * W + j - w];
  const int need = w - 1 - j;
  return need > 0 ? s + suf[(r - 1) * W + (W - need)] : s;
}

__global__ void __launch_bounds__(FT_THREADS)
fused_trend_kernel(const float* __restrict__ x, float* __restrict__ diff,
                   unsigned char* __restrict__ up, long long T, int w1,
                   int W, int S) {
  extern __shared__ float smem[];
  float* pre = smem;                 // (S + 1) x W prefix sums
  float* suf = smem + (S + 1) * W;   // (S + 1) x W suffix sums
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  // local stripe 0 is the stripe before the block's first (zeros at t < 0)
  const long long stripe0 = (long long)blockIdx.x * S - 1;
  for (int r = warp; r <= S; r += FT_WARPS) {
    const long long g0 = (stripe0 + r) * W;
    float carry = 0.0f;
    for (int c = 0; c < W; c += 32) {
      const int j = c + lane;
      const long long t = g0 + j;
      float v = (j < W && t >= 0 && t < T) ? x[t] : 0.0f;
      v = warp_inclusive_scan(v, lane) + carry;
      if (j < W) pre[r * W + j] = v;
      carry = __shfl_sync(FULL, v, 31);
    }
    carry = 0.0f;
    for (int c = W - 1; c >= 0; c -= 32) {  // lane l holds index c - l
      const int j = c - lane;
      const long long t = g0 + j;
      float v = (j >= 0 && t >= 0 && t < T) ? x[t] : 0.0f;
      v = warp_inclusive_scan(v, lane) + carry;
      if (j >= 0) suf[r * W + j] = v;
      carry = __shfl_sync(FULL, v, 31);
    }
  }
  __syncthreads();
  const int tile = S * W;
  const long long start = (long long)blockIdx.x * tile;
  for (int i = threadIdx.x; i < tile; i += FT_THREADS) {
    const long long pos = start + i;
    if (pos >= T) break;
    const int r = 1 + i / W, j = i % W;
    const float s1 = window_sum(pre, suf, W, r, j, w1);
    const float s2 = window_sum(pre, suf, W, r, j, W);
    const float c1 = (float)(pos + 1 < w1 ? pos + 1 : w1);
    const float c2 = (float)(pos + 1 < W ? pos + 1 : W);
    const float d = s1 / c1 - s2 / c2;
    diff[pos] = d;
    up[pos] = d > 0.0f;
  }
}

int stripes_per_block(int W) { return W >= FT_TILE ? 1 : FT_TILE / W; }

size_t smem_bytes(int W) {
  return 2 * (size_t)(stripes_per_block(W) + 1) * W * sizeof(float);
}

}  // namespace

extern "C" {

// Largest w2 whose two stripes of prefix and suffix sums fit shared memory.
long long ft_max_window() { return FT_MAX_SMEM / (4 * (long long)sizeof(float)); }

// x: (T,) f32; diff: (T,) f32; up: (T,) bool bytes; 1 <= w1 < w2.
int ft_fused_trend(const void* x, void* diff, void* up, long long T, int w1,
                   int w2, void* stream) {
  if (w1 < 1 || w2 <= w1 || w2 > ft_max_window())
    return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaSuccess;
  const int S = stripes_per_block(w2);
  const size_t smem = smem_bytes(w2);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_trend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long tile = (long long)S * w2;
  const long long blocks = (T + tile - 1) / tile;
  fused_trend_kernel<<<(unsigned)blocks, FT_THREADS, smem,
                       (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<float*>(diff),
      static_cast<unsigned char*>(up), T, w1, w2, S);
  return (int)cudaGetLastError();
}

}  // extern "C"
