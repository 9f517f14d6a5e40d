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
//
// Here one block owns the outputs [o0, o0 + span), span = S W for S =
// FT_TILE / W whole stripes (one stripe of W when W > FT_TILE;
// fused_query.trend_plan).  It stages x over [o0 - W, o0 + span) in shared
// memory once, with 16-byte loads of the range's aligned cover
// (stage.cuh), so every tick is read from device memory once per
// block and the stripe before the block once more.  Two segmented sums
// over tiles of FT_TILE ticks, 8 consecutive ticks a thread, form the
// suffix sums of the stripes [o0 - W, o0 + span - W) into a second array
// (right to left) and the prefix sums of [o0, o0 + span) in place (left to
// right), each tile's carry taken from the one before it.  A stripe's
// heads follow from the offset % W, as one bit mask per thread; the sums
// run in registers, then as a warp shuffle scan of (sum, head seen) pairs,
// then one warp scans the warp totals.  The staged range is padded with
// zeros to whole tiles, so no tick is checked against its range.  Once a
// tile's prefix sums are in, every thread forms both window sums of its 8
// outputs (its own prefix sums from registers, the rest from shared
// memory), multiplies by 1 / count, subtracts, and stores diff as two
// float4 and uptrend as two 4-byte words where the outputs are aligned.
// (A product with 1 / count rounds at most an ulp of each mean away from
// the Pallas body's quotient, far inside the stripe formulation's bound.)
//
// Bound: bytes.  One f32 read per tick and one f32 plus one byte written;
// a handful of f32 operations per tick is far under the card's f32 rate.
//
// The exported function launches on the given stream, allocates nothing
// and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "stage.cuh"

namespace {

constexpr int FT_THREADS = 256;
constexpr int FT_TILE = 2048;  // ticks one block scan covers
constexpr int FT_ITEMS = FT_TILE / FT_THREADS;  // consecutive ticks a thread
constexpr int FT_WARPS = FT_THREADS / 32;
constexpr int FT_SMEM_OPTIN = 232448;  // shared memory a block may use
constexpr int FT_STATIC_BYTES = 1024;  // kept for the static arrays
constexpr int FT_BLOCKS_PER_SM = 6;    // occupancy the kernel asks for

// Ticks of the scanned range: span rounded up to whole tiles.
__host__ __device__ constexpr int scan_len(int span) {
  return (span + FT_TILE - 1) / FT_TILE * FT_TILE;
}

// Segment heads among a thread's FT_ITEMS ticks, bit q for tick q, the
// first tick at stripe offset `off`: stripe starts (forward) or stripe
// ends (REV, whose scan runs right to left).
template <bool REV>
__device__ __forceinline__ unsigned stripe_heads(int off, int W) {
  if (W >= FT_ITEMS) {  // at most one head, FT_ITEMS ticks apart or more
    const int q = REV ? W - 1 - off : (W - off) % W;
    return q < FT_ITEMS ? 1u << q : 0u;
  }
  unsigned m = 0;
#pragma unroll
  for (int q = 0; q < FT_ITEMS; ++q) {
    if (off == (REV ? W - 1 : 0)) m |= 1u << q;
    off = off + 1 == W ? 0 : off + 1;
  }
  return m;
}

// Segmented sum, in scan order, of one tile: thread t holds ticks [FT_ITEMS
// t, FT_ITEMS t + FT_ITEMS) of it in v (physical order) with their segment
// heads in m (stripe_heads).  Forward sums run left to right from each
// stripe's start (prefix sums), REV right to left from each stripe's end
// (suffix sums).  Within a thread the sums run in registers, across the
// warp by a shuffle scan of (sum, head seen) pairs, across warps by one
// warp scanning the warp totals; `carry` is added to every tick of the
// stripe that runs into the tile.  wt, wf, wp: FT_WARPS words of shared
// scratch each, free again only after the caller's next barrier.
template <bool REV>
__device__ void seg_sum(float (&v)[FT_ITEMS], unsigned m, float carry,
                        float* wt, int* wf, float* wp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (!REV) {
#pragma unroll
    for (int q = 1; q < FT_ITEMS; ++q)
      if (!(m >> q & 1)) v[q] += v[q - 1];
  } else {
#pragma unroll
    for (int q = FT_ITEMS - 2; q >= 0; --q)
      if (!(m >> q & 1)) v[q] += v[q + 1];
  }
  // warp scan in scan order: lanes up (forward) or down (REV)
  float agg = REV ? v[0] : v[FT_ITEMS - 1];
  int flag = m != 0;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = REV ? __shfl_down_sync(FULL, agg, d)
                        : __shfl_up_sync(FULL, agg, d);
    const int of = REV ? __shfl_down_sync(FULL, flag, d)
                       : __shfl_up_sync(FULL, flag, d);
    if (REV ? lane + d < 32 : lane >= d) {
      if (!flag) agg = o + agg;
      flag |= of;
    }
  }
  const float ex = REV ? __shfl_down_sync(FULL, agg, 1)
                       : __shfl_up_sync(FULL, agg, 1);
  const int exf = REV ? __shfl_down_sync(FULL, flag, 1)
                      : __shfl_up_sync(FULL, flag, 1);
  if (lane == (REV ? 0 : 31)) {
    wt[warp] = agg;
    wf[warp] = flag;
  }
  __syncthreads();
  if (warp == 0) {  // lane l: the l-th warp in scan order
    const int w = REV ? FT_WARPS - 1 - lane : lane;
    float t = lane < FT_WARPS ? wt[w] : 0.0f;
    int f = lane < FT_WARPS ? wf[w] : 0;
    if (lane == 0 && !f) t = carry + t;
#pragma unroll
    for (int d = 1; d < FT_WARPS; d <<= 1) {
      const float o = __shfl_up_sync(FULL, t, d);
      const int of = __shfl_up_sync(FULL, f, d);
      if (lane >= d) {
        if (!f) t = o + t;
        f |= of;
      }
    }
    const float before = __shfl_up_sync(FULL, t, 1);
    if (lane < FT_WARPS) wp[w] = lane == 0 ? carry : before;
  }
  __syncthreads();
  // what precedes this thread in its stripe, added to its ticks before
  // its first head in scan order
  const bool first = lane == (REV ? 31 : 0);
  const float p = first ? wp[warp] : exf ? ex : wp[warp] + ex;
  if (!REV) {
    const int h = m ? __ffs(m) - 1 : FT_ITEMS;
#pragma unroll
    for (int q = 0; q < FT_ITEMS; ++q)
      if (q < h) v[q] = p + v[q];
  } else {
    const int h = m ? 31 - __clz(m) : -1;
#pragma unroll
    for (int q = 0; q < FT_ITEMS; ++q)
      if (q > h) v[q] = p + v[q];
  }
}

// Writes diff and uptrend for the outputs e0 .. e0 + FT_ITEMS - 1 (those
// below n_out) of a block: prefix sums P[e] in p (registers) and at
// buf[pad(W + e)], suffix sums S at suf.  A trailing w-sum at e (stripe
// offset j) is P[e] - P[e - w] (j >= w) or P[e] + S[e + W - w + 1]
// (j < w - 1), else P[e] (the Pallas body's wsum); the means multiply by
// 1 / count, r1 and r2 past the first w2 ticks.  Two float4 and two
// 4-byte stores where the outputs line up (`wide`).
__device__ __forceinline__ void write_outputs(
    const float (&p)[FT_ITEMS], const float* buf, const float* suf,
    float* diff, unsigned char* up, long long o0, int e0, int n_out, int w1,
    int W, float r1, float r2, bool head, bool wide) {
  int j = e0 % W;
  float d[FT_ITEMS];
#pragma unroll
  for (int q = 0; q < FT_ITEMS; ++q, j = j + 1 == W ? 0 : j + 1) {
    const int e = e0 + q;
    if (e >= n_out) break;
    float s1 = j >= w1 ? p[q] - buf[pad(W + e - w1)] : p[q];
    if (j < w1 - 1) s1 = s1 + suf[pad(e + W - w1 + 1)];
    const float s2 = j < W - 1 ? p[q] + suf[pad(e + 1)] : p[q];
    float q1 = r1, q2 = r2;
    if (head) {
      q1 = 1.0f / (float)min(e + 1, w1);
      q2 = 1.0f / (float)min(e + 1, W);
    }
    d[q] = s1 * q1 - s2 * q2;
  }
  if (wide && e0 + FT_ITEMS <= n_out) {
    float4* dv = reinterpret_cast<float4*>(diff + o0 + e0);
    uchar4* uv = reinterpret_cast<uchar4*>(up + o0 + e0);
#pragma unroll
    for (int k = 0; k < FT_ITEMS / 4; ++k) {
      dv[k] = make_float4(d[4 * k], d[4 * k + 1], d[4 * k + 2], d[4 * k + 3]);
      uv[k] = make_uchar4(d[4 * k] > 0.0f, d[4 * k + 1] > 0.0f,
                          d[4 * k + 2] > 0.0f, d[4 * k + 3] > 0.0f);
    }
  } else {
#pragma unroll
    for (int q = 0; q < FT_ITEMS; ++q) {
      if (e0 + q < n_out) {
        diff[o0 + e0 + q] = d[q];
        up[o0 + e0 + q] = d[q] > 0.0f;
      }
    }
  }
}

// Dynamic shared memory: buf, x over [o0 - W, o0 - W + L + W) (ticks
// outside [0, T) as zeros; L = scan_len(span)), the prefix sums written
// over its [W, W + L) | suf, the suffix sums of buf's [0, L).  Tick e of
// a tile sits at buf[pad(base + e)]; with base a multiple of FT_TILE a
// thread's FT_ITEMS ticks lie in one 32-word row, one pad word after it,
// so their addresses are one register and an offset.  diff is 16-byte
// and up 4-byte aligned (checked at launch).
__global__ void __launch_bounds__(FT_THREADS, FT_BLOCKS_PER_SM)
fused_trend_kernel(const float* __restrict__ x, float* __restrict__ diff,
                   unsigned char* __restrict__ up, long long T, int w1,
                   int W, int span) {
  extern __shared__ __align__(16) float smem[];
  const int L = scan_len(span);
  float* buf = smem;
  float* suf = smem + padded(L + W);
  __shared__ float wt[FT_WARPS], wp[FT_WARPS];
  __shared__ int wf[FT_WARPS];
  const int tid = threadIdx.x;
  const long long o0 = (long long)blockIdx.x * span;
  const int n_out = (int)min((long long)span, T - o0);
  const int i0 = FT_ITEMS * tid;  // this thread's first tick in a tile
  const int row = i0 + (i0 >> 5);  // its padded index

  // stage [o0 - W, o0 + n_out); zeros before tick 0 and after it
  const long long ps = o0 > W ? o0 - W : 0;
  const int skip = (int)(ps - (o0 - W));
  const int staged = W + n_out;
  stage(x + ps, staged - skip, buf, skip);
  for (int i = tid; i < skip; i += FT_THREADS) buf[pad(i)] = 0.0f;
  for (int i = staged + tid; i < L + W; i += FT_THREADS) buf[pad(i)] = 0.0f;
  __syncthreads();

  // suffix sums of buf's [0, L), tile by tile right to left; a stripe
  // ends at every multiple of W (span is one), so the ticks past span
  // never reach the ones before it
  float carry = 0.0f;
  for (int base = L - FT_TILE; base >= 0; base -= FT_TILE) {
    const float* src = buf + pad(base) + row;
    float v[FT_ITEMS];
#pragma unroll
    for (int q = 0; q < FT_ITEMS; ++q) v[q] = src[q];
    const unsigned m = stripe_heads<true>((base + i0) % W, W);
    seg_sum<true>(v, m, carry, wt, wf, wp);
    float* dst = suf + pad(base) + row;
#pragma unroll
    for (int q = 0; q < FT_ITEMS; ++q) dst[q] = v[q];
    __syncthreads();
    carry = suf[pad(base)];
  }
  // prefix sums of the block's stripes, buf's [W, W + L) in place, tile by
  // tile left to right; each tile's outputs once its sums are in
  const float r1 = 1.0f / (float)w1, r2 = 1.0f / (float)W;
  const bool head = o0 < W;  // counts below the windows
  const bool wide = (o0 & 3) == 0;
  carry = 0.0f;
  for (int base = 0; base < n_out; base += FT_TILE) {
    float v[FT_ITEMS];
#pragma unroll
    for (int q = 0; q < FT_ITEMS; ++q) v[q] = buf[pad(W + base + i0 + q)];
    const unsigned m = stripe_heads<false>((base + i0) % W, W);
    seg_sum<false>(v, m, carry, wt, wf, wp);
#pragma unroll
    for (int q = 0; q < FT_ITEMS; ++q) buf[pad(W + base + i0 + q)] = v[q];
    __syncthreads();
    carry = buf[pad(W + base + FT_TILE - 1)];
    if (base + i0 < n_out)
      write_outputs(v, buf, suf, diff, up, o0, base + i0, n_out, w1, W, r1,
                    r2, head, wide);
  }
}

// Dynamic shared memory for stripes of W with `span` outputs a block.
long long smem_bytes(long long W, long long span) {
  const int L = scan_len((int)span);
  return (long long)sizeof(float) * (padded(L + (int)W) + padded(L));
}

}  // namespace

extern "C" {

// The tile the wrapper's launch plan is built on.
int ft_tile() { return FT_TILE; }

// Largest w2 whose block (the stripe before, one stripe of outputs and its
// suffix sums) fits shared memory.
long long ft_max_window() {
  const long long avail = FT_SMEM_OPTIN - FT_STATIC_BYTES;
  long long w = avail / (3 * (long long)sizeof(float));
  while (smem_bytes(w, w) > avail) --w;
  return w;
}

// x: (T,) f32, unit stride, any alignment; diff: (T,) f32, 16-byte
// aligned; up: (T,) bool bytes, 4-byte aligned; 1 <= w1 < w2.  span,
// blocks, smem: the wrapper's launch plan (fused_query.trend_plan),
// checked here.
int ft_fused_trend(const void* x, void* diff, void* up, long long T, int w1,
                   int w2, int span, long long blocks, long long smem,
                   int device, void* stream) {
  static bool done[16] = {};
  const long long W = w2;
  if (w1 < 1 || w2 <= w1 || T <= 0 || span < W || span % W ||
      (span > FT_TILE && span != W) || blocks <= 0 ||
      blocks > 0x7fffffffLL || blocks * span < T ||
      (blocks - 1) * span >= T || smem < smem_bytes(W, span) ||
      smem > FT_SMEM_OPTIN - FT_STATIC_BYTES ||
      reinterpret_cast<uintptr_t>(diff) % 16 ||
      reinterpret_cast<uintptr_t>(up) % 4)
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (smem > 48 * 1024 && !(device < 16 && done[device])) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_trend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        FT_SMEM_OPTIN - FT_STATIC_BYTES);
    if (e != cudaSuccess) return (int)e;
    if (device < 16) done[device] = true;
  }
  fused_trend_kernel<<<(unsigned)blocks, FT_THREADS, (size_t)smem,
                       (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<float*>(diff),
      static_cast<unsigned char*>(up), T, w1, w2, span);
  return (int)cudaGetLastError();
}

}  // extern "C"
