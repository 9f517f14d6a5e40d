// Window-reduction kernels for Hopper (sm_90a), bound through a plain C
// interface (ctypes; see ../build.py).  They replace the two Pallas TPU
// kernels of src/repro/kernels/window_reduce.py:
//
//   prefix_scan    <- _prefix_scan_kernel (inclusive f32 prefix sum, VMEM
//                     carry across a sequential grid)
//   sliding_assoc  <- _vanherk_kernel (Van Herk / Gil-Werman W-window
//                     associative reduce over a striped timeline)
//
// Both are bound by bytes: one read of the input and one write of the
// output per element, O(1) combines per element.  Neither has a grid that
// runs in order, so the TPU's cross-step carries become:
//
//   prefix_scan: one launch, each element read once and written once.
//   Rows up to PS_TILE elements: one block per row stages the row in
//   shared memory (16-byte loads of its aligned cover), scans it with 16
//   elements a thread in registers, and stores it with 16-byte stores.
//   Longer rows: tiles of PS_TILE elements; each publishes its total in a
//   64-bit status word (value and ready flag stored together) as soon as
//   it has scanned, then sums its predecessors' totals in an order fixed
//   by their index (no decoupled look-back that stops at whichever
//   inclusive prefix happens to be ready, whose f32 bits would depend on
//   timing).  The regime and the tile follow from T alone
//   (window_reduce.prefix_plan), so a row's bits depend on its values.
//
//   sliding_assoc: out[t] = combine(suffix of stripe k-1 after offset j,
//   prefix of stripe k up to j) for t = kW + j, stripes of width W from
//   the row's start.  Prefixes and suffixes are segmented scans whose
//   segment heads follow from the offset alone (offset % W), so no flags
//   move between threads.  Two regimes, chosen from (T, W) only:
//
//   * short rows (T <= SHORT_T): a block stages its contiguous range of
//     rows in shared memory once, with 16-byte loads of the range's
//     16-byte-aligned cover, and one warp owns one row: a backward pass
//     over the row's whole stripes writes the suffixes to the warp's
//     shared scratch, a forward pass forms the prefixes and writes the
//     outputs.  Both walk 32-tick chunks, lanes on neighbouring ticks,
//     SR_CH chunks at a time whose shuffle scans run side by side; only
//     the carry goes from chunk to chunk.  No block barrier inside the
//     scans.  The previous stripe is read from shared memory.
//   * long rows, W < LTILE: one block per (row, group of S = LTILE / W
//     stripes).  The block stages x over [o0 - W, o0 + S*W) in shared
//     memory once (16-byte loads; the previous stripe comes from there,
//     not from a second global read), then scans its one tile backward
//     and then forward: 8 ticks a thread, shuffle scans within a warp,
//     one warp scanning the 8 warp totals, warps with no tick in range
//     skipping their scans.
//   * long rows, W >= LTILE (one stripe per block, off the main path): the
//     block walks the stripe in tiles, carrying the prefix left to right
//     and the previous stripe's suffix from a first pass of tile totals,
//     with the next tile pair in flight (cp.async, two slots) while the
//     current one is scanned.  It reads the previous stripe twice.
//
//   A row's bits depend on its values, T, W and op alone: the regime and
//   every order of association follow from (T, W) and the offset within
//   the row, never from the row count, the row's index or its neighbours
//   in the block.  The sparse body relies on it: it launches the same
//   units compacted to other row positions and must reproduce the dense
//   body bit for bit.
//
//   No tensor cores: a scan by MMA would run in TF32 and lose the add
//   path's error bound (one window's content, never a prefix difference),
//   and max and min have no MMA form.
//
// Every exported function launches on the given stream, allocates nothing
// and returns cudaGetLastError() so the caller can raise on a refused
// launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_guard.cuh"
#include "stage.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

enum Op { OP_ADD = 0, OP_MAX = 1, OP_MIN = 2 };

template <int OP>
struct Combine;

template <>
struct Combine<OP_ADD> {
  __device__ static float identity() { return 0.0f; }
  __device__ static float apply(float a, float b) { return a + b; }
};

// max/min propagate NaN like torch.maximum / jnp.maximum
template <>
struct Combine<OP_MAX> {
  __device__ static float identity() { return -INFINITY; }
  __device__ static float apply(float a, float b) {
    return (a > b || a != a) ? a : b;
  }
};

template <>
struct Combine<OP_MIN> {
  __device__ static float identity() { return INFINITY; }
  __device__ static float apply(float a, float b) {
    return (a < b || a != a) ? a : b;
  }
};

// Scratch a block needs for the cross-warp step of a reduction.
struct WarpScratch {
  float val[WARPS];
};

// Combine of one value per thread across the block; the result is
// returned to every thread.
template <int OP>
__device__ float block_reduce(float v, WarpScratch& ws) {
  using C = Combine<OP>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = C::apply(v, __shfl_xor_sync(FULL, v, d));
  if (lane == 0) ws.val[warp] = v;
  __syncthreads();
  float r = ws.val[0];
  for (int w = 1; w < WARPS; ++w) r = C::apply(r, ws.val[w]);
  __syncthreads();
  return r;
}

// ---------------------------------------------------------------------------
// prefix_scan
// ---------------------------------------------------------------------------

constexpr int PS_ITEMS = 16;     // elements a thread scans, in registers
constexpr int PS_THREADS = 512;  // largest block: a long row's tile
constexpr int PS_TILE = PS_ITEMS * PS_THREADS;  // longest short row
constexpr unsigned long long PS_READY = 1ull << 32;  // status: total set

enum PrefixRegime { PS_SHORT = 0, PS_LONG = 1 };

// A tile's status word: the f32 bits of its total in the low half, the
// ready flag in the high half, stored and loaded as one 64-bit word.
__device__ __forceinline__ void store_status(unsigned long long* p,
                                             float total) {
  const unsigned long long v = PS_READY | __float_as_uint(total);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ float wait_status(const unsigned long long* p) {
  unsigned long long v;
  do {
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
                 : "=l"(v)
                 : "l"(p)
                 : "memory");
  } while (!(v & PS_READY));
  return __uint_as_float((unsigned)v);
}

// The sum of the totals of tiles [0, n) of a row (n >= 1), to every lane of
// the calling warp: lane l waits for tiles l, l + 32, ..., each group of
// 32 is summed by a fixed butterfly, and the group sums are added in index
// order.  The bits follow from the totals alone.
__device__ float predecessors_sum(const unsigned long long* st, int n) {
  const int lane = threadIdx.x & 31;
  float c = 0.0f;
  for (int g = 0; g < n; g += 32) {
    float v = g + lane < n ? wait_status(st + g + lane) : 0.0f;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
    c += v;
  }
  return c;
}

// Inclusive sum, in place, of the n <= blockDim.x * PS_ITEMS values at
// buf[pad(k)]: thread t scans [PS_ITEMS t, PS_ITEMS t + PS_ITEMS) in
// registers, a warp shuffle scan adds the threads' totals and one warp
// scans the warp totals.  Returns the sum of all n to every thread.  The
// order of association follows from blockDim.x alone.
__device__ float scan_tile_sum(float* buf, int n, float* wsum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  float v[PS_ITEMS];
#pragma unroll
  for (int q = 0; q < PS_ITEMS; ++q) {
    const int k = tid * PS_ITEMS + q;
    v[q] = k < n ? buf[pad(k)] : 0.0f;
  }
#pragma unroll
  for (int q = 1; q < PS_ITEMS; ++q) v[q] += v[q - 1];
  float agg = v[PS_ITEMS - 1];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_up_sync(FULL, agg, d);
    if (lane >= d) agg = o + agg;
  }
  const float texcl = __shfl_up_sync(FULL, agg, 1);
  if (lane == 31) wsum[warp] = agg;
  __syncthreads();
  if (warp == 0) {  // wsum[32 + w]: inclusive sum of warps 0 .. w
    float t = lane < nwarps ? wsum[lane] : 0.0f;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float o = __shfl_up_sync(FULL, t, d);
      if (lane >= d) t = o + t;
    }
    wsum[32 + lane] = t;
  }
  __syncthreads();
  if (lane > 0 || warp > 0) {
    const float p = lane == 0   ? wsum[31 + warp]
                    : warp == 0 ? texcl
                                : wsum[31 + warp] + texcl;
#pragma unroll
    for (int q = 0; q < PS_ITEMS; ++q) v[q] = p + v[q];
  }
#pragma unroll
  for (int q = 0; q < PS_ITEMS; ++q) {
    const int k = tid * PS_ITEMS + q;
    if (k < n) buf[pad(k)] = v[q];
  }
  __syncthreads();
  return wsum[31 + nwarps];
}

// Writes buf[pad(k)] (+ carry when `add`) to dst[k], k < n: 16-byte
// stores on the aligned words, single floats at the ragged ends.
__device__ void store_tile(float* dst, int n, const float* buf, float carry,
                           bool add) {
  const int lead = (int)((reinterpret_cast<uintptr_t>(dst) >> 2) & 3);
  float4* w = reinterpret_cast<float4*>(dst - lead);
  const int nw = (lead + n + 3) >> 2;
  for (int i = threadIdx.x; i < nw; i += blockDim.x) {
    const int k0 = 4 * i - lead;
    float r[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = min(max(k0 + c, 0), n - 1);
      r[c] = add ? buf[pad(k)] + carry : buf[pad(k)];
    }
    if (k0 >= 0 && k0 + 4 <= n) {
      w[i] = make_float4(r[0], r[1], r[2], r[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (k0 + c >= 0 && k0 + c < n) dst[k0 + c] = r[c];
    }
  }
}

// One launch.  PS_SHORT: block b scans row b whole (T <= blockDim.x *
// PS_ITEMS).  PS_LONG: a block takes the next tile index from the counter
// status[0] (so every tile it waits on belongs to a block already
// running), stages and scans its PS_TILE elements, publishes their total
// in status[1 + tile index] before it waits on anything, then forms its
// carry from the totals of the tiles to its left in its row
// (predecessors_sum, in a fixed order of association).  So the carry's
// bits follow from the row's values and T alone, never from the blocks'
// timing, and a tile waits only for its predecessors' loads and sums,
// never for a chain of carries.
template <typename In, int REGIME>
__global__ void __launch_bounds__(PS_THREADS)
prefix_scan_kernel(const In* __restrict__ x, float* __restrict__ out,
                   long long T, int tiles,
                   unsigned long long* __restrict__ status) {
  extern __shared__ __align__(16) float buf[];
  __shared__ float wsum[64];
  __shared__ long long tile_id;
  __shared__ float carry_s;
  long long id = blockIdx.x;
  if (REGIME == PS_LONG) {
    if (threadIdx.x == 0) tile_id = (long long)atomicAdd(status, 1ull);
    __syncthreads();
    id = tile_id;
  }
  const long long row = id / tiles;
  const int tile = (int)(id % tiles);
  const long long t0 = (long long)tile * PS_TILE;
  const int n = (int)min(T - t0, (long long)PS_TILE);
  stage(x + row * T + t0, n, buf, 0);
  __syncthreads();
  const float total = scan_tile_sum(buf, n, wsum);
  float carry = 0.0f;
  if (REGIME == PS_LONG) {
    unsigned long long* st = status + 1 + row * tiles;
    if (threadIdx.x == 0 && tile + 1 < tiles) store_status(st + tile, total);
    if (tile > 0) {
      if (threadIdx.x < 32) {
        const float c = predecessors_sum(st, tile);
        if (threadIdx.x == 0) carry_s = c;
      }
      __syncthreads();
      carry = carry_s;
    }
  }
  store_tile(out + row * T + t0, n, buf, carry, tile > 0);
}

size_t prefix_smem(int threads) {
  return sizeof(float) * (size_t)padded(threads * PS_ITEMS);
}

// The launch plan comes from the wrapper (window_reduce.prefix_plan);
// here it is checked against what the kernel needs.  The long regime
// clears its counter and status words on the stream first.
template <typename In>
int launch_prefix(const In* x, float* out, void* scratch, long long rows,
                  long long T, int regime, long long blocks, int threads,
                  long long tiles, long long smem, cudaStream_t stream) {
  if (rows <= 0 || T <= 0 || blocks <= 0 || blocks > 0x7fffffffLL ||
      threads < 32 || threads % 32 || threads > PS_THREADS ||
      smem < (long long)prefix_smem(threads) || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  unsigned long long* status = static_cast<unsigned long long*>(scratch);
  if (regime == PS_SHORT) {
    if (T > (long long)threads * PS_ITEMS || tiles != 1 || blocks != rows)
      return (int)cudaErrorInvalidValue;
    prefix_scan_kernel<In, PS_SHORT><<<(unsigned)blocks, threads,
                                       (size_t)smem, stream>>>(
        x, out, T, 1, nullptr);
  } else if (regime == PS_LONG) {
    if (threads != PS_THREADS || tiles != (T + PS_TILE - 1) / PS_TILE ||
        blocks != rows * tiles || status == nullptr)
      return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaMemsetAsync(
        status, 0, sizeof(unsigned long long) * (size_t)(1 + blocks), stream);
    if (e != cudaSuccess) return (int)e;
    prefix_scan_kernel<In, PS_LONG><<<(unsigned)blocks, threads,
                                      (size_t)smem, stream>>>(
        x, out, T, (int)tiles, status);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// sliding_assoc (Van Herk / Gil-Werman)
// ---------------------------------------------------------------------------

constexpr int SHORT_T = 1024;        // longest row of the short regime
constexpr int SR_CH = 4;             // short regime: chunks scanned at once
constexpr int LTILE = 2048;          // long regime: ticks per block tile
constexpr int LT_ITEMS = LTILE / THREADS;
constexpr int LONG_BLOCKS_PER_SM = 8;  // occupancy the long kernel asks for
// static shared memory of the W >= LTILE kernel (two slots of two tiles)
constexpr int STRIPE_STATIC_BYTES = 4 * padded(LTILE) * 4 + 1024;
constexpr int SMEM_OPTIN = 232448;   // shared memory a block may use

enum Regime { SHORT = 0, LONG = 1, STRIPE = 2 };

// combine(earlier, later) in scan order; a backward scan runs right to
// left, so its "earlier" element lies to the right and the physical order
// (left operand first) is kept.
template <int OP, bool REV>
__device__ __forceinline__ float comb(float earlier, float later) {
  return REV ? Combine<OP>::apply(later, earlier)
             : Combine<OP>::apply(earlier, later);
}

// --- short rows: one warp per row -----------------------------------------

// One group of N chunks of 32 ticks of a row in shared memory, scanned
// side by side (lanes on neighbouring ticks, shuffles, stripe heads from
// the offset); only the carry goes from chunk to chunk.  `off` is the
// stripe offset of this lane's tick in the group's first chunk and
// advances to the next group's.

// Chunks in the next group when `left` remain: SR_CH, or all of them when
// one more would be left alone (129 ticks: one group of 5, not 4 and 1).
__device__ __forceinline__ int group_size(int left) {
  return left == SR_CH + 1 ? left : min(SR_CH, left);
}

// Backward: chunks c0, c0 - 32, ...; sb[p] = combine(x[p .. end of p's
// stripe]) for p < nbs (whole stripes only).
template <int OP, int N>
__device__ __forceinline__ void short_backward(const float* xs, float* sb,
                                               int c0, int nbs, int W,
                                               int m32, int& off,
                                               float& carry) {
  using C = Combine<OP>;
  const int lane = threadIdx.x & 31;
  float v[N];
  int rem[N], reach[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int pos = c0 - 32 * k + lane;
    v[k] = pos < nbs ? xs[pos] : C::identity();
    rem[k] = W - 1 - off;  // ticks after pos in its stripe
    reach[k] = min(rem[k], 31 - lane);
    off -= m32;
    if (off < 0) off += W;
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float w = __shfl_down_sync(FULL, v[k], d);
      if (reach[k] >= d) v[k] = C::apply(v[k], w);
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int pos = c0 - 32 * k + lane;
    if (rem[k] > 31 - lane) v[k] = C::apply(v[k], carry);  // stripe runs on
    carry = __shfl_sync(FULL, v[k], 0);
    if (pos < nbs) sb[pos] = v[k];
  }
}

// Forward: chunks c0, c0 + 32, ...; out[pos] = combine(suffix of the
// previous stripe after pos's offset, prefix of pos's stripe to pos).
template <int OP, int N>
__device__ __forceinline__ void short_forward(const float* xs,
                                              const float* sb, float* o,
                                              int c0, int T, int W, int m32,
                                              int& off, float& carry) {
  using C = Combine<OP>;
  const int lane = threadIdx.x & 31;
  const float ident = C::identity();
  float v[N];
  int j[N], reach[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int pos = c0 + 32 * k + lane;
    v[k] = pos < T ? xs[pos] : ident;
    j[k] = off;  // ticks before pos in its stripe
    reach[k] = min(off, lane);
    off += m32;
    if (off >= W) off -= W;
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float w = __shfl_up_sync(FULL, v[k], d);
      if (reach[k] >= d) v[k] = C::apply(w, v[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int pos = c0 + 32 * k + lane;
    if (j[k] > lane) v[k] = C::apply(carry, v[k]);  // stripe began before
    carry = __shfl_sync(FULL, v[k], 31);
    if (pos < T) {
      const float b = (j[k] == W - 1 || pos < W) ? ident : sb[pos - W + 1];
      o[pos] = C::apply(b, v[k]);
    }
  }
}

// Dynamic shared memory: the block's rows [stage_len floats] | one row of
// suffix scratch per warp.  Rows per block rpb = warps * rows per warp.
template <int OP>
__global__ void __launch_bounds__(THREADS)
sliding_short_kernel(const float* __restrict__ x, float* __restrict__ out,
                     long long rows, int T, int W, int rpb) {
  using C = Combine<OP>;
  extern __shared__ __align__(16) float smem[];
  const float ident = C::identity();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const long long r0 = (long long)blockIdx.x * rpb;
  const int nr = (int)min((long long)rpb, rows - r0);

  // Stage floats [r0*T, (r0+nr)*T) from the 16-byte word that holds the
  // first; the cover's words are whole, so no load leaves the allocation's
  // pages.
  const float* gp = x + r0 * T;
  const int lead = (int)((reinterpret_cast<uintptr_t>(gp) >> 2) & 3);
  const float4* src = reinterpret_cast<const float4*>(gp - lead);
  float4* dst = reinterpret_cast<float4*>(smem);
  const int n4 = (lead + nr * T + 3) >> 2;
#pragma unroll 4
  for (int i = tid; i < n4; i += blockDim.x) dst[i] = __ldg(src + i);
  __syncthreads();
  const int stage_len = ((rpb * T + 3) & ~3) + 4;
  float* sb = smem + stage_len + warp * T;
  const int nbs = (T / W) * W;  // ticks in whole stripes: their suffixes

  const int m32 = 32 % W;  // stripe offset step from one chunk to the next
  for (int r = warp; r < nr; r += warps) {
    const float* xs = smem + lead + r * T;
    float* o = out + (r0 + r) * T;
    // backward: sb[p] = combine(x[p .. end of p's stripe]), right to left
    float carry = ident;
    const int top = (nbs - 1) & ~31;  // first chunk (negative: none)
    int off = top >= 0 ? (top + lane) % W : 0;
    for (int c0 = top; c0 >= 0;) {
      const int n = group_size(c0 / 32 + 1);
      switch (n) {
#define BWD(N) short_backward<OP, N>(xs, sb, c0, nbs, W, m32, off, carry)
        case 1: BWD(1); break;
        case 2: BWD(2); break;
        case 3: BWD(3); break;
        case SR_CH + 1: BWD(SR_CH + 1); break;
        default: BWD(SR_CH);
#undef BWD
      }
      c0 -= 32 * n;
    }
    __syncwarp();
    // forward: prefix of each stripe, combined with the suffix of the
    // stripe before it strictly after the same offset
    carry = ident;
    off = lane % W;
    for (int c0 = 0; c0 < T;) {
      const int n = group_size((T - c0 + 31) / 32);
      switch (n) {
#define FWD(N) short_forward<OP, N>(xs, sb, o, c0, T, W, m32, off, carry)
        case 1: FWD(1); break;
        case 2: FWD(2); break;
        case 3: FWD(3); break;
        case SR_CH + 1: FWD(SR_CH + 1); break;
        default: FWD(SR_CH);
#undef FWD
      }
      c0 += 32 * n;
    }
    __syncwarp();
  }
}

// --- long rows: block tiles of LTILE ticks --------------------------------

// One segmented scan of a tile of LTILE ticks held at buf[pad(base + e)],
// e in [0, LTILE).  Tick e sits at stripe offset (off0 + e) % W; ticks
// outside [lo, hi) count as the identity.  Forward scans left to right,
// REV right to left.  Thread t holds the scan-order items [8t, 8t + 8).
// local() scans within threads and warps and leaves each warp's total in
// wtot; after a barrier one warp runs warp_prefix(); after another,
// finish() adds what lies before each thread.  `carry` (given to
// warp_prefix) is combined into every tick whose stripe begins before the
// tile (forward) or ends after it (REV).
template <int OP, bool REV>
struct TileScan {
  float v[LT_ITEMS];
  float texcl;   // inclusive value of the previous thread in the warp
  int back0;     // stripe ticks before item 0 in scan order
  bool idle;     // the warp's ticks all lie outside [lo, hi)

  // stripe ticks before scan-order item i (within its stripe)
  __device__ static int back_of(int i, int off0, int W) {
    if (!REV) return (off0 + i) % W;
    return W - 1 - (off0 + LTILE - 1 - i) % W;
  }

  __device__ void local(const float* buf, int base, int off0, int W, int lo,
                        int hi, float* wtot) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const float ident = Combine<OP>::identity();
    back0 = back_of(tid * LT_ITEMS, off0, W);
    // A warp with no tick in [lo, hi) holds identities and skips its scans
    // (no tick that counts reaches one outside the range in scan order).
    const int i0 = warp * 32 * LT_ITEMS, i1 = i0 + 32 * LT_ITEMS - 1;
    idle = REV ? (LTILE - 1 - i0 < lo || LTILE - 1 - i1 >= hi)
               : (i1 < lo || i0 >= hi);
    if (idle) {
#pragma unroll
      for (int q = 0; q < LT_ITEMS; ++q) v[q] = ident;
      if (lane == 31) wtot[warp] = ident;
      return;
    }
    int back = back0;
#pragma unroll
    for (int q = 0; q < LT_ITEMS; ++q) {
      const int i = tid * LT_ITEMS + q;
      const int e = REV ? LTILE - 1 - i : i;
      const float a = (e >= lo && e < hi) ? buf[pad(base + e)] : ident;
      v[q] = (q > 0 && back > 0) ? comb<OP, REV>(v[q - 1], a) : a;
      if (++back == W) back = 0;
    }
    // warp scan of the threads' totals; a thread takes the total d threads
    // back when its last item's stripe reaches that far
    const int bl = back_of(tid * LT_ITEMS + LT_ITEMS - 1, off0, W);
    float agg = v[LT_ITEMS - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float o = __shfl_up_sync(FULL, agg, d);
      if (lane >= d && bl >= LT_ITEMS * d) agg = comb<OP, REV>(o, agg);
    }
    texcl = __shfl_up_sync(FULL, agg, 1);
    if (lane == 31) wtot[warp] = agg;
  }

  // One warp: wpre[w] = what precedes warp w in its stripe (carry
  // included where the stripe reaches before the tile).
  __device__ static void warp_prefix(const float* wtot, float* wpre,
                                     int off0, int W, float carry) {
    const int lane = threadIdx.x & 31;
    constexpr int SPAN = 32 * LT_ITEMS;
    float t = lane < WARPS ? wtot[lane] : Combine<OP>::identity();
    const int bw = back_of(lane * SPAN + SPAN - 1, off0, W);
#pragma unroll
    for (int d = 1; d < WARPS; d <<= 1) {
      const float o = __shfl_up_sync(FULL, t, d);
      if (lane >= d && bw >= SPAN * d) t = comb<OP, REV>(o, t);
    }
    if (bw > lane * SPAN + SPAN - 1) t = comb<OP, REV>(carry, t);
    const float prev = __shfl_up_sync(FULL, t, 1);
    if (lane < WARPS) wpre[lane] = lane == 0 ? carry : prev;
  }

  __device__ void finish(const float* wpre, int W) {
    if (idle) return;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int in_warp = lane * LT_ITEMS;  // scan-order index in the warp
    int back = back0;
#pragma unroll
    for (int q = 0; q < LT_ITEMS; ++q) {
      if (back > q) {  // the stripe began before this thread
        float p;
        if (lane > 0) {
          p = texcl;
          if (back > in_warp + q) p = comb<OP, REV>(wpre[warp], p);
        } else {
          p = wpre[warp];
        }
        v[q] = comb<OP, REV>(p, v[q]);
      }
      if (++back == W) back = 0;
    }
  }
};

// W < LTILE: one block per (row, group of S stripes), one tile each.  The
// backward scan (previous stripes) runs first and leaves its suffixes in
// sb; then the forward scan, so that one scan's items are live at a time.
template <int OP>
__global__ void __launch_bounds__(THREADS, LONG_BLOCKS_PER_SM)
sliding_long_kernel(const float* __restrict__ x, float* __restrict__ out,
                    long long T, int W, int S, long long groups) {
  using C = Combine<OP>;
  __shared__ float buf[padded(2 * LTILE)];  // x over [o0 - W, o0 + n_out)
  __shared__ float sb[padded(LTILE)];       // suffixes of [o0 - W, ...)
  __shared__ float wt[WARPS], wp[WARPS];
  const float ident = C::identity();
  const int tid = threadIdx.x;
  const long long row = blockIdx.x / groups;
  const long long g = blockIdx.x % groups;
  const float* xr = x + row * T;
  float* outr = out + row * T;
  const int span = S * W;
  const long long o0 = g * span;
  const long long left = T - o0;          // outputs that exist
  const int n_out = left < span ? (int)left : span;

  // Stage positions [o0 - W, o0 + n_out) at buf[pad(p - o0 + W)]: 16-byte
  // loads of the cover of the part inside the row, identities before it.
  const long long p0 = o0 - W;
  const long long ps = p0 > 0 ? p0 : 0;
  const float* gp = xr + ps;
  const int lead = (int)((reinterpret_cast<uintptr_t>(gp) >> 2) & 3);
  const float4* src = reinterpret_cast<const float4*>(gp - lead);
  const int n_in = (int)(o0 + n_out - ps);
  const int n4 = (lead + n_in + 3) >> 2;
  for (int i = tid; i < n4; i += THREADS) {
    const float4 w = __ldg(src + i);
    const float vals[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = 4 * i + c - lead;  // position ps + k
      if (k >= 0 && k < n_in) buf[pad((int)(ps - p0) + k)] = vals[c];
    }
  }
  for (int i = tid; i < ps - p0; i += THREADS) buf[pad(i)] = ident;
  __syncthreads();

  {  // previous stripes: only suffixes at [o0 - W + 1, o0 - W + n_out) are
     // read, all within whole stripes ending by o0 - W + span
    TileScan<OP, true> bw;
    bw.local(buf, 0, 0, W, 0, n_out + W - 1 < span ? n_out + W - 1 : span,
             wt);
    __syncthreads();
    if (tid < 32) TileScan<OP, true>::warp_prefix(wt, wp, 0, W, ident);
    __syncthreads();
    bw.finish(wp, W);
#pragma unroll
    for (int q = 0; q < LT_ITEMS; ++q)
      sb[pad(LTILE - 1 - (tid * LT_ITEMS + q))] = bw.v[q];
  }
  TileScan<OP, false> fw;  // this group's stripes: [o0, o0 + n_out)
  fw.local(buf, W, 0, W, 0, n_out, wt);
  __syncthreads();
  if (tid < 32) TileScan<OP, false>::warp_prefix(wt, wp, 0, W, ident);
  __syncthreads();
  fw.finish(wp, W);
  // out[o0 + e] = combine(suffix of the stripe before after offset j,
  // prefix to j); staged in buf (read by no one now), stored coalesced
  if (tid * LT_ITEMS < n_out) {
    int j = (tid * LT_ITEMS) % W;
#pragma unroll
    for (int q = 0; q < LT_ITEMS; ++q) {
      const int e = tid * LT_ITEMS + q;
      const bool none = j == W - 1 || o0 + e < W;
      buf[pad(e)] = C::apply(none || e + 1 >= span ? ident : sb[pad(e + 1)],
                             fw.v[q]);
      if (++j == W) j = 0;
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < LT_ITEMS; ++q) {
    const int i = q * THREADS + tid;
    if (i < n_out) outr[o0 + i] = buf[pad(i)];
  }
}

// --- W >= LTILE: one block per (row, stripe), tiles walked in order -------

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Dynamic shared memory: carry_r[nt], the previous stripe's combine of the
// tiles right of each tile (pass 1).  Pass 2 holds two slots of (this
// stripe's tile, the previous stripe's tile): the next pair is copied in
// (cp.async, filled with zeros out of range and masked by the scans) while
// the current pair is scanned.
template <int OP>
__global__ void __launch_bounds__(THREADS)
sliding_stripe_kernel(const float* __restrict__ x, float* __restrict__ out,
                      long long T, int W, long long stripes) {
  using C = Combine<OP>;
  extern __shared__ float carry_r[];
  __shared__ float cur[2][padded(LTILE)], prv[2][padded(LTILE)];
  __shared__ float wt[2][WARPS], wp[2][WARPS];
  __shared__ float carry_f_s;
  __shared__ WarpScratch ws;
  const float ident = C::identity();
  const int tid = threadIdx.x;
  const long long row = blockIdx.x / stripes;
  const long long o0 = (blockIdx.x % stripes) * (long long)W;
  const float* xr = x + row * T;
  float* outr = out + row * T;
  const int nt = (W + LTILE - 1) / LTILE;
  const long long left = T - o0;
  const int n_out = left < W ? (int)left : W;
  const int nt_out = (n_out + LTILE - 1) / LTILE;

  // pass 1: carry_r[t] = combine of the previous stripe's tiles t+1 ..
  float run = ident;
  for (int t = nt - 1; t >= 0; --t) {
    float acc = ident;
    if (o0 > 0) {
#pragma unroll
      for (int q = 0; q < LT_ITEMS; ++q) {
        const int rel = t * LTILE + q * THREADS + tid;
        if (rel < W) acc = C::apply(acc, xr[o0 - W + rel]);
      }
    }
    const float tot = block_reduce<OP>(acc, ws);
    if (tid == 0) carry_r[t] = run;
    run = C::apply(tot, run);
  }

  auto issue = [&](int t, int slot) {
#pragma unroll
    for (int q = 0; q < LT_ITEMS; ++q) {
      const int i = q * THREADS + tid;
      const int rel = t * LTILE + i;
      const long long pos = o0 + rel;
      const bool in_c = rel < W && pos < T;
      const bool in_p = rel < W && pos - W >= 0 && pos - W < T;
      cp_async4(&cur[slot][pad(i)], in_c ? xr + pos : xr, in_c);
      cp_async4(&prv[slot][pad(i)], in_p ? xr + pos - W : xr, in_p);
    }
    cp_async_commit();
  };

  issue(0, 0);
  float carry_f = ident;
  for (int t = 0; t < nt_out; ++t) {
    const int slot = t & 1;
    const int base = t * LTILE;
    if (t + 1 < nt_out) issue(t + 1, slot ^ 1);
    else cp_async_commit();  // empty group: the wait below stays exact
    cp_async_wait_one();
    __syncthreads();
    const long long lim_c = min((long long)W, T - o0) - base;
    const int hi_c = (int)min(lim_c, (long long)LTILE);
    const int hi_p = min(W - base, LTILE);
    const long long lo_p = W - o0 - base;  // previous stripe before tick 0
    const int lo = (int)max(0LL, min(lo_p, (long long)LTILE));
    TileScan<OP, false> fw;
    TileScan<OP, true> bw;
    fw.local(cur[slot], 0, base, W, 0, hi_c, wt[0]);
    bw.local(prv[slot], 0, base, W, lo, hi_p, wt[1]);
    __syncthreads();
    if (tid < 32)
      TileScan<OP, false>::warp_prefix(wt[0], wp[0], base, W, carry_f);
    else if (tid < 64)
      TileScan<OP, true>::warp_prefix(wt[1], wp[1], base, W, carry_r[t]);
    __syncthreads();
    fw.finish(wp[0], W);
    bw.finish(wp[1], W);
#pragma unroll
    for (int q = 0; q < LT_ITEMS; ++q)
      prv[slot][pad(LTILE - 1 - (tid * LT_ITEMS + q))] = bw.v[q];
    if (tid == THREADS - 1) carry_f_s = fw.v[LT_ITEMS - 1];
    __syncthreads();
    carry_f = carry_f_s;
#pragma unroll
    for (int q = 0; q < LT_ITEMS; ++q) {
      const int e = tid * LT_ITEMS + q;
      const int rel = base + e;
      const long long pos = o0 + rel;
      if (rel < W && pos < T) {
        const float b = rel == W - 1       ? ident
                        : e + 1 < LTILE    ? prv[slot][pad(e + 1)]
                                           : carry_r[t];
        outr[pos] = C::apply(b, fw.v[q]);
      }
    }
    __syncthreads();  // the slot is refilled by the next iteration's issue
  }
}

// Launch attributes are set once per kernel and device.
template <typename K>
cudaError_t allow_dynamic_smem(K kernel, int bytes, bool* done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 16 && done[dev])) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess && dev < 16) done[dev] = true;
  return e;
}

// The launch plan comes from the wrapper (window_reduce.sliding_plan);
// here it is only checked against what each kernel needs.
template <int OP>
int launch_sliding(const float* x, float* out, long long rows, long long T,
                   int W, int regime, long long blocks, int threads,
                   long long param, long long smem, cudaStream_t stream) {
  if (rows <= 0 || blocks <= 0 || blocks > 0x7fffffffLL || W < 2)
    return (int)cudaErrorInvalidValue;
  if (regime == SHORT) {
    const long long rpb = param;
    const long long need =
        4 * (((rpb * T + 3) & ~3LL) + 4 + (threads / 32) * T);
    if (T > SHORT_T || threads % 32 || threads > THREADS ||
        rpb < threads / 32 || blocks * rpb < rows || smem < need ||
        smem > 48 * 1024)
      return (int)cudaErrorInvalidValue;
    sliding_short_kernel<OP><<<(unsigned)blocks, threads, (size_t)smem,
                               stream>>>(x, out, rows, (int)T, W, (int)rpb);
  } else if (regime == LONG) {
    const long long groups = blocks / rows;
    const long long S = param;
    if (W >= LTILE || S < 1 || S * W > LTILE || groups * rows != blocks ||
        groups * S * W < T || threads != THREADS)
      return (int)cudaErrorInvalidValue;
    sliding_long_kernel<OP><<<(unsigned)blocks, THREADS, 0, stream>>>(
        x, out, T, W, (int)S, groups);
  } else if (regime == STRIPE) {
    static bool done[16] = {};
    const long long stripes = blocks / rows;
    const long long nt = (W + LTILE - 1) / LTILE;
    if (W < LTILE || stripes * rows != blocks || stripes * W < T ||
        threads != THREADS || smem < 4 * nt ||
        smem > SMEM_OPTIN - STRIPE_STATIC_BYTES)
      return (int)cudaErrorInvalidValue;
    cudaError_t e = allow_dynamic_smem(
        sliding_stripe_kernel<OP>, SMEM_OPTIN - STRIPE_STATIC_BYTES, done);
    if (e != cudaSuccess) return (int)e;
    sliding_stripe_kernel<OP><<<(unsigned)blocks, THREADS, (size_t)smem,
                                stream>>>(x, out, T, W, stripes);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int wr_prefix_tile() { return PS_TILE; }

// Largest W the sliding kernel takes: the W >= LTILE kernel keeps one
// carry per tile of a stripe in shared memory.
long long wr_max_window() {
  return (long long)((SMEM_OPTIN - STRIPE_STATIC_BYTES) / sizeof(float)) *
         LTILE;
}

// The constants the wrapper's launch plan is built on.
int wr_short_t() { return SHORT_T; }
int wr_long_tile() { return LTILE; }

// x: (rows, T) f32 (bf16 = 0) or bf16 (bf16 = 1), contiguous rows at any
// alignment; out: (rows, T) f32; scratch: 1 + blocks int64 words for the
// long regime (cleared here), else unused.  regime, blocks, threads,
// tiles, smem: the wrapper's launch plan (window_reduce.prefix_plan).
int wr_prefix_scan(const void* x, void* out, void* scratch, long long rows,
                   long long T, int bf16, int regime, long long blocks,
                   int threads, long long tiles, long long smem, int device,
                   void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_prefix(static_cast<const __nv_bfloat16*>(x), o, scratch,
                         rows, T, regime, blocks, threads, tiles, smem, s);
  return launch_prefix(static_cast<const float*>(x), o, scratch, rows, T,
                       regime, blocks, threads, tiles, smem, s);
}

// x, out: (rows, T) f32 contiguous; op: 0 add, 1 max, 2 min; W >= 2.
// regime, blocks, threads, param, smem: the wrapper's launch plan
// (window_reduce.sliding_plan), checked before the launch.
int wr_sliding_assoc_f32(const void* x, void* out, long long rows,
                         long long T, int W, int op, int regime,
                         long long blocks, int threads, long long param,
                         long long smem, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  const float* xi = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case OP_ADD:
      return launch_sliding<OP_ADD>(xi, o, rows, T, W, regime, blocks,
                                    threads, param, smem, s);
    case OP_MAX:
      return launch_sliding<OP_MAX>(xi, o, rows, T, W, regime, blocks,
                                    threads, param, smem, s);
    case OP_MIN:
      return launch_sliding<OP_MIN>(xi, o, rows, T, W, regime, blocks,
                                    threads, param, smem, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
