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
//   prefix_scan: two launches.  tile_sums writes one f32 total per
//   (row, 1024-element tile); scan re-reads its tile, adds the sum of the
//   totals to its left as the carry, and scans the tile in registers and
//   shared memory.  Every (row, tile) block is independent, so a long row
//   spreads over all SMs instead of one.
//
//   sliding_assoc: one block per (row, group of S stripes of width W).
//   out[t] = combine(suffix of stripe k-1 from j+1, prefix of stripe k to j)
//   for t = kW + j.  The block walks its stripes in 1024-element tiles: a
//   segmented forward scan of the current stripes (carry to the right) and a
//   segmented backward scan of the previous stripes, whose carry from the
//   right comes from a first pass that totals each tile.  Nothing of width
//   W is held in shared memory, so any W works; for W < 1024 several
//   stripes share one tile and the first pass is skipped.  Identity padding
//   on the left and the ragged right edge are masked on load: the input is
//   read in place, never through a padded copy.
//
// Every exported function launches on the given stream, allocates nothing
// and returns cudaGetLastError() so the caller can raise on a refused
// launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;
constexpr int TILE = THREADS * ITEMS;  // elements per tile
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Scratch a block needs for the cross-warp step of a scan or reduction.
struct WarpScratch {
  float val[WARPS];
  int flag[WARPS];
};

// Segment heads for the scans below (logical index i of the tile).
struct NoHeads {
  __device__ bool operator()(int) const { return false; }
};

// Forward: a new stripe starts where the region offset is a multiple of W.
struct StripeStarts {
  int base, W;
  __device__ bool operator()(int i) const { return (base + i) % W == 0; }
};

// Backward: logical i is physical TILE-1-i; a segment (scanning right to
// left) starts at the last element of a stripe.
struct StripeEnds {
  int base, W;
  __device__ bool operator()(int i) const {
    return (base + TILE - 1 - i) % W == W - 1;
  }
};

// Inclusive segmented scan of one tile held in shared memory, in place.
// Logical element i is buf[i] (forward) or buf[TILE-1-i] (REVERSE).
// `carry` is combined into every element before the first segment head.
// Thread t owns logical elements [t*ITEMS, (t+1)*ITEMS).
template <int OP, bool REVERSE, typename Heads>
__device__ void seg_scan_tile(float* buf, Heads heads, float carry,
                              WarpScratch& ws) {
  using C = Combine<OP>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float v[ITEMS];
  bool h[ITEMS];
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const int i = tid * ITEMS + q;
    v[q] = buf[REVERSE ? TILE - 1 - i : i];
    h[q] = heads(i);
  }
  // thread-local inclusive scan
  bool any = h[0];
#pragma unroll
  for (int q = 1; q < ITEMS; ++q) {
    if (h[q]) {
      any = true;
    } else {
      v[q] = C::apply(v[q - 1], v[q]);
    }
  }
  // warp inclusive scan of the (head seen, value) pairs of each thread
  float sv = v[ITEMS - 1];
  int sf = any ? 1 : 0;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float ov = __shfl_up_sync(FULL, sv, d);
    const int of = __shfl_up_sync(FULL, sf, d);
    if (lane >= d) {
      if (!sf) sv = C::apply(ov, sv);
      sf |= of;
    }
  }
  // exclusive value within the warp
  const float ev = __shfl_up_sync(FULL, sv, 1);
  const int ef = __shfl_up_sync(FULL, sf, 1);
  if (lane == 31) {
    ws.val[warp] = sv;
    ws.flag[warp] = sf;
  }
  __syncthreads();
  if (tid == 0) {  // exclusive prefix of each warp, seeded with the carry
    float run = carry;
    for (int w = 0; w < WARPS; ++w) {
      const float wv = ws.val[w];
      const int wf = ws.flag[w];
      ws.val[w] = run;
      run = wf ? wv : C::apply(run, wv);
    }
  }
  __syncthreads();
  const float wp = ws.val[warp];
  const float pre = (lane == 0) ? wp : (ef ? ev : C::apply(wp, ev));
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    if (h[q]) break;
    v[q] = C::apply(pre, v[q]);
  }
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const int i = tid * ITEMS + q;
    buf[REVERSE ? TILE - 1 - i : i] = v[q];
  }
  __syncthreads();
}

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

template <typename In>
__global__ void __launch_bounds__(THREADS)
tile_sums_kernel(const In* __restrict__ x, float* __restrict__ sums,
                 long long T, int nt) {
  __shared__ WarpScratch ws;
  const long long row = blockIdx.x / nt;
  const int t = blockIdx.x % nt;
  const In* xr = x + row * T;
  const long long base = (long long)t * TILE;
  float acc = 0.0f;
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const long long pos = base + q * THREADS + threadIdx.x;
    if (pos < T) acc += to_f32(xr[pos]);
  }
  const float total = block_reduce<OP_ADD>(acc, ws);
  if (threadIdx.x == 0) sums[row * nt + t] = total;
}

template <typename In>
__global__ void __launch_bounds__(THREADS)
prefix_scan_kernel(const In* __restrict__ x, const float* __restrict__ sums,
                   float* __restrict__ out, long long T, int nt) {
  __shared__ float buf[TILE];
  __shared__ WarpScratch ws;
  const long long row = blockIdx.x / nt;
  const int t = blockIdx.x % nt;
  const In* xr = x + row * T;
  float* outr = out + row * T;
  const long long base = (long long)t * TILE;
  // carry: total of every tile to the left of this one
  float acc = 0.0f;
  for (int k = threadIdx.x; k < t; k += THREADS) acc += sums[row * nt + k];
  const float carry = block_reduce<OP_ADD>(acc, ws);
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const int i = q * THREADS + threadIdx.x;
    const long long pos = base + i;
    buf[i] = pos < T ? to_f32(xr[pos]) : 0.0f;
  }
  __syncthreads();
  seg_scan_tile<OP_ADD, false>(buf, NoHeads{}, carry, ws);
#pragma unroll
  for (int q = 0; q < ITEMS; ++q) {
    const int i = q * THREADS + threadIdx.x;
    const long long pos = base + i;
    if (pos < T) outr[pos] = buf[i];
  }
}

// ---------------------------------------------------------------------------
// sliding_assoc (Van Herk / Gil-Werman)
// ---------------------------------------------------------------------------

// Dynamic shared memory: cur[TILE] | prv[TILE] | carry_r[nt]
template <int OP>
__global__ void __launch_bounds__(THREADS)
sliding_assoc_kernel(const float* __restrict__ x, float* __restrict__ out,
                     long long T, int W, int S, long long groups) {
  using C = Combine<OP>;
  extern __shared__ float smem[];
  float* cur = smem;
  float* prv = smem + TILE;
  float* carry_r = smem + 2 * TILE;
  __shared__ WarpScratch ws;

  const long long row = blockIdx.x / groups;
  const long long g = blockIdx.x % groups;
  const float* xr = x + row * T;
  float* outr = out + row * T;
  const long long o0 = g * (long long)S * W;  // first output (stripe start)
  const int span = S * W;                     // region: S whole stripes
  const int nt = (span + TILE - 1) / TILE;
  const long long left = T - o0;              // outputs that exist
  const int n_out = left < span ? (int)left : span;
  const int nt_out = (n_out + TILE - 1) / TILE;
  const float ident = C::identity();

  // Pass 1 (only when a stripe spans several tiles, i.e. S == 1): total
  // each tile of the previous stripe, then turn the totals into the carry
  // from the right of each tile: carry_r[t] = combine(tot[t+1 .. nt-1]).
  if (nt > 1) {
    for (int t = 0; t < nt; ++t) {
      float acc = ident;
#pragma unroll
      for (int q = 0; q < ITEMS; ++q) {
        const int rel = t * TILE + q * THREADS + threadIdx.x;
        const long long pp = o0 + rel - W;
        if (rel < span && pp >= 0 && pp < T) acc = C::apply(acc, xr[pp]);
      }
      const float tot = block_reduce<OP>(acc, ws);
      if (threadIdx.x == 0) carry_r[t] = tot;
    }
    if (threadIdx.x == 0) {
      float run = ident;
      for (int t = nt - 1; t >= 0; --t) {
        const float tv = carry_r[t];
        carry_r[t] = run;
        run = C::apply(tv, run);
      }
    }
  } else if (threadIdx.x == 0) {
    carry_r[0] = ident;
  }
  __syncthreads();

  // Pass 2: left to right over the output tiles.
  float carry_f = ident;
  for (int t = 0; t < nt_out; ++t) {
    const int base = t * TILE;
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      const int i = q * THREADS + threadIdx.x;
      const int rel = base + i;
      const long long pos = o0 + rel;
      const long long pp = pos - W;
      const bool in = rel < span;
      cur[i] = (in && pos < T) ? xr[pos] : ident;
      prv[i] = (in && pp >= 0 && pp < T) ? xr[pp] : ident;
    }
    __syncthreads();
    seg_scan_tile<OP, false>(cur, StripeStarts{base, W}, carry_f, ws);
    seg_scan_tile<OP, true>(prv, StripeEnds{base, W}, carry_r[t], ws);
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      const int i = q * THREADS + threadIdx.x;
      const int rel = base + i;
      const long long pos = o0 + rel;
      if (rel < span && pos < T) {
        // suffix of the previous stripe strictly after offset j
        float b;
        if (rel % W == W - 1) {
          b = ident;
        } else if (i + 1 < TILE) {
          b = prv[i + 1];
        } else {
          b = carry_r[t];
        }
        outr[pos] = C::apply(b, cur[i]);
      }
    }
    carry_f = cur[TILE - 1];
    __syncthreads();
  }
}

template <int OP>
int launch_sliding(const float* x, float* out, long long rows, long long T,
                   int W, cudaStream_t stream) {
  const int S = W >= TILE ? 1 : TILE / W;
  const long long stripes = (T + W - 1) / W;
  const long long groups = (stripes + S - 1) / S;
  const int nt = (S * W + TILE - 1) / TILE;
  const size_t smem = (size_t)(2 * TILE + nt) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sliding_assoc_kernel<OP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sliding_assoc_kernel<OP><<<(unsigned)(rows * groups), THREADS, smem,
                             stream>>>(x, out, T, W, S, groups);
  return (int)cudaGetLastError();
}

template <typename In>
int launch_prefix(const In* x, float* sums, float* out, long long rows,
                  long long T, cudaStream_t stream) {
  const int nt = (int)((T + TILE - 1) / TILE);
  const unsigned blocks = (unsigned)(rows * nt);
  tile_sums_kernel<In><<<blocks, THREADS, 0, stream>>>(x, sums, T, nt);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  prefix_scan_kernel<In><<<blocks, THREADS, 0, stream>>>(x, sums, out, T, nt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int wr_tile() { return TILE; }

// Largest W the sliding kernel takes: its per-tile carries must fit the
// 227 KB of shared memory a block may use.
long long wr_max_window() {
  return (long long)((232448 / sizeof(float)) - 2 * TILE) * TILE;
}

// x: (rows, T) f32 or bf16, contiguous; sums: rows * ceil(T/TILE) f32
// scratch; out: (rows, T) f32.
int wr_prefix_scan_f32(const void* x, void* sums, void* out, long long rows,
                       long long T, void* stream) {
  return launch_prefix<float>(static_cast<const float*>(x),
                              static_cast<float*>(sums),
                              static_cast<float*>(out), rows, T,
                              static_cast<cudaStream_t>(stream));
}

int wr_prefix_scan_bf16(const void* x, void* sums, void* out, long long rows,
                        long long T, void* stream) {
  return launch_prefix<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(x), static_cast<float*>(sums),
      static_cast<float*>(out), rows, T, static_cast<cudaStream_t>(stream));
}

// x, out: (rows, T) f32 contiguous; op: 0 add, 1 max, 2 min; W >= 1.
int wr_sliding_assoc_f32(const void* x, void* out, long long rows,
                         long long T, int W, int op, void* stream) {
  const float* xi = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case OP_ADD: return launch_sliding<OP_ADD>(xi, o, rows, T, W, s);
    case OP_MAX: return launch_sliding<OP_MAX>(xi, o, rows, T, W, s);
    case OP_MIN: return launch_sliding<OP_MIN>(xi, o, rows, T, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
