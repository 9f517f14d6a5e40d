// Fused change detection for sparse execution on Hopper (sm_90a), bound
// through a plain C interface (ctypes; see ../build.py).  It replaces the
// Pallas TPU kernel of src/repro/kernels/sparse_compact.py (_kernel,
// _seg_dirty_pallas):
//
//   seg_dirty  one flag per (key, segment) unit: segment k of key q is
//              dirty iff some tick t in [a0 + k*step, a0 + k*step + width),
//              with 1 <= t <= T-1, differs from tick t-1 in any row.
//
// The TPU kernel walks one segment per grid step over a padded copy of
// each source's channel matrix, stacked per dtype.  Here every row is read
// in place through its own pointer, key stride and dtype, passed by value
// as a table of 3 words per row (see Row), so nothing is padded, stacked
// or cast on the host: a grid of any dtype the port's grids carry (f32,
// f16, bf16, f64, int64, int32, int16, int8, uint8, bool) is read as it
// lies.  Each thread compares 4 or 8 neighbouring ticks of each row with
// the tick before them (vector loads of 4 ticks, or 2 for 8-byte types,
// where the row's alignment allows, scalar loads elsewhere; every row's
// loads in flight together), and the group that
// owns a unit stops at the first round with a difference.  Two regimes,
// by the unit's width (the result is exact, so the choice is free; the
// wrapper's seg_dirty_plan makes it):
//
//   * long units (wider than 256 ticks: the single-stream runner's
//     segments): one block of 256 threads per unit, 1024 ticks a round,
//     early exit block-wide with __syncthreads_or.  256 units fill the
//     card as 256 blocks where 256 warps left most SMs idle.
//   * short units (the keyed runner's 64-193 ticks, tens of thousands of
//     them): one warp per unit, 256 ticks a round (one round for every
//     short unit), exit with __any_sync.
//
// The comparison is by value, as the reference's `!=`: NaN != NaN makes a
// tick dirty and -0.0 == 0.0 keeps it clean (do not build with fast math).
// Floats are compared as floats: f16 and bf16 widen exactly to f32 in
// registers first, f64 stays f64.  Integers and bool compare by their bits,
// which for them is the value: int64 keeps all 64 (no cast through f32).
//
// Bound: bytes.  A unit reads its width+1 ticks of every row once (units
// of one key overlap by their dilation, which L1/L2 absorb); it writes one
// byte.  Early exit reads less on dirty segments.  No tensor cores: there
// is no product to form.
//
// Every exported function launches on the given stream, allocates nothing
// and returns cudaGetLastError().
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "device_guard.cuh"

namespace {

constexpr int SD_THREADS = 256;
constexpr int SD_WARPS = SD_THREADS / 32;
constexpr int SD_MAX_ROWS = 16;
constexpr unsigned FULL = 0xffffffffu;

// Row dtype codes, as the wrapper's _DTYPES: integer types of one width
// share a code (their bits are their value).
enum Dtype {
  DT_F32 = 0, DT_I32 = 1, DT_U8 = 2, DT_F16 = 3, DT_BF16 = 4, DT_F64 = 5,
  DT_I64 = 6, DT_I16 = 7
};

// One row as the wrapper packs it: 3 int64 words (pointer to key 0, tick
// 0; elements between keys; dtype code).
struct Row {
  const void* ptr;
  long long kstride;
  long long dtype;
};

struct Rows {
  Row r[SD_MAX_ROWS];
};

// How a stored element becomes the value compared: itself, or a 16-bit
// float widened (exactly) to f32.
template <typename Raw>
struct AsIs {
  static __device__ __forceinline__ Raw get(Raw r) { return r; }
};
struct F16 {
  static __device__ __forceinline__ float get(uint16_t r) {
    return __half2float(__ushort_as_half(r));
  }
};
struct BF16 {
  static __device__ __forceinline__ float get(uint16_t r) {
    return __uint_as_float((unsigned)r << 16);
  }
};

// Does any of ticks [t0, t0 + n) differ from the tick before it?  t0 >= 1.
// Vec is one aligned load of sizeof(Vec) / sizeof(Raw) ticks (4, or 2 for
// 8-byte types); ITEMS is a multiple of that.
template <int ITEMS, typename Raw, typename Vec, typename Get>
__device__ __forceinline__ int row_changes(const Raw* p, long long t0,
                                           int n) {
  constexpr int VT = sizeof(Vec) / sizeof(Raw);
  auto prev = Get::get(p[t0 - 1]);
  int d = 0;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p + t0);
  if (n == ITEMS && addr % sizeof(Vec) == 0) {
#pragma unroll
    for (int c = 0; c < ITEMS / VT; ++c) {
      const Vec w = reinterpret_cast<const Vec*>(p + t0)[c];
      Raw v[VT];
      memcpy(v, &w, sizeof(Vec));
#pragma unroll
      for (int j = 0; j < VT; ++j) {
        const auto cur = Get::get(v[j]);
        d |= cur != prev;
        prev = cur;
      }
    }
    return d;
  }
  for (int i = 0; i < n; ++i) {
    const auto cur = Get::get(p[t0 + i]);
    d |= cur != prev;
    prev = cur;
  }
  return d;
}

// One row's ticks [t0, t0 + n) of key `key`, by the row's dtype code.
template <int ITEMS>
__device__ __forceinline__ int row_dirty(const Row& row, long long key,
                                         long long t0, int n) {
  const long long off = key * row.kstride;
  switch (row.dtype) {
    case DT_F32:
      return row_changes<ITEMS, float, float4, AsIs<float>>(
          static_cast<const float*>(row.ptr) + off, t0, n);
    case DT_I32:
      return row_changes<ITEMS, int32_t, int4, AsIs<int32_t>>(
          static_cast<const int32_t*>(row.ptr) + off, t0, n);
    case DT_U8:
      return row_changes<ITEMS, uint8_t, uint32_t, AsIs<uint8_t>>(
          static_cast<const uint8_t*>(row.ptr) + off, t0, n);
    case DT_F16:
      return row_changes<ITEMS, uint16_t, uint2, F16>(
          static_cast<const uint16_t*>(row.ptr) + off, t0, n);
    case DT_BF16:
      return row_changes<ITEMS, uint16_t, uint2, BF16>(
          static_cast<const uint16_t*>(row.ptr) + off, t0, n);
    case DT_F64:
      return row_changes<ITEMS, double, double2, AsIs<double>>(
          static_cast<const double*>(row.ptr) + off, t0, n);
    case DT_I64:
      return row_changes<ITEMS, long long, longlong2, AsIs<long long>>(
          static_cast<const long long*>(row.ptr) + off, t0, n);
    default:  // DT_I16
      return row_changes<ITEMS, uint16_t, uint2, AsIs<uint16_t>>(
          static_cast<const uint16_t*>(row.ptr) + off, t0, n);
  }
}

// GROUP threads own one unit: 32 (a warp) or SD_THREADS (the block).  A
// thread compares ITEMS neighbouring ticks a round: 8 in a warp (256 ticks,
// a short unit in one round), 4 in a block (1024 ticks).
template <int GROUP>
__global__ void __launch_bounds__(SD_THREADS)
seg_dirty_kernel(Rows rows, int n_rows, long long n_units, int n_segs,
                 long long a0, long long step, long long width, long long T,
                 unsigned char* out, int accumulate) {
  const long long unit =
      GROUP == 32 ? (long long)blockIdx.x * SD_WARPS + threadIdx.x / 32
                  : (long long)blockIdx.x;
  const int g = GROUP == 32 ? threadIdx.x & 31 : threadIdx.x;
  constexpr int ITEMS = GROUP == 32 ? 8 : 4;
  if (GROUP == 32 && unit >= n_units) return;  // whole warps leave together
  const long long key = unit / n_segs;
  const long long k = unit % n_segs;
  const long long lo = a0 + k * step;
  const long long t_first = lo > 1 ? lo : 1;
  const long long hi = lo + width - 1;
  const long long t_last = hi < T - 1 ? hi : T - 1;
  int dirty = 0;
  for (long long base = t_first; base <= t_last;
       base += (long long)GROUP * ITEMS) {
    const long long t0 = base + (long long)g * ITEMS;
    int d = 0;
    if (t0 <= t_last) {
      const int n = (int)min((long long)ITEMS, t_last - t0 + 1);
      // every row's loads go out before any compare waits on them
#pragma unroll 2
      for (int i = 0; i < n_rows; ++i)
        d |= row_dirty<ITEMS>(rows.r[i], key, t0, n);
    }
    dirty = GROUP == 32 ? __any_sync(FULL, d) : __syncthreads_or(d);
    if (dirty) break;
  }
  if (g == 0)
    out[unit] = (unsigned char)(dirty | (accumulate ? (out[unit] != 0) : 0));
}

}  // namespace

extern "C" {

int sd_max_rows() { return SD_MAX_ROWS; }
int sd_threads() { return SD_THREADS; }

// table: n_rows x 3 int64 words (see Row); out: (keys, n_segs) uint8,
// written (accumulate = 0) or OR-ed into.  group, blocks: the wrapper's
// plan (sparse_compact.seg_dirty_plan): 32 threads per unit in blocks of
// SD_THREADS, or a block of SD_THREADS per unit.
int sd_seg_dirty(const long long* table, int n_rows, long long keys,
                 int n_segs, long long a0, long long step, long long width,
                 long long T, void* out, int accumulate, int group,
                 long long blocks, int device, void* stream) {
  if (n_rows < 1 || n_rows > SD_MAX_ROWS) return (int)cudaErrorInvalidValue;
  const long long n_units = keys * n_segs;
  if (n_units == 0) return (int)cudaSuccess;
  const long long per_block = group == 32 ? SD_WARPS : 1;
  if ((group != 32 && group != SD_THREADS) || blocks * per_block < n_units ||
      blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Rows rows;
  for (int i = 0; i < n_rows; ++i) {
    rows.r[i].ptr = reinterpret_cast<const void*>(table[3 * i]);
    rows.r[i].kstride = table[3 * i + 1];
    rows.r[i].dtype = table[3 * i + 2];
  }
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  unsigned char* o = static_cast<unsigned char*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group == 32)
    seg_dirty_kernel<32><<<(unsigned)blocks, SD_THREADS, 0, s>>>(
        rows, n_rows, n_units, n_segs, a0, step, width, T, o, accumulate);
  else
    seg_dirty_kernel<SD_THREADS><<<(unsigned)blocks, SD_THREADS, 0, s>>>(
        rows, n_rows, n_units, n_segs, a0, step, width, T, o, accumulate);
  return (int)cudaGetLastError();
}

}  // extern "C"
