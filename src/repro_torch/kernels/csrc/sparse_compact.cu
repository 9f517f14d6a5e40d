// Fused change detection for sparse execution on Hopper (sm_90a), bound
// through a plain C interface (ctypes; see ../build.py).  It replaces the
// Pallas TPU kernel of src/repro/kernels/sparse_compact.py (_kernel,
// _seg_dirty_pallas):
//
//   seg_dirty  one flag per (key, segment): segment k of key q is dirty iff
//              some tick t in [a0 + k*step, a0 + k*step + width), with
//              1 <= t <= T-1, differs from tick t-1 in any row.
//
// The TPU kernel walks one segment per grid step over a padded copy of
// each source's channel matrix, stacked per dtype.  Here one warp owns one
// (key, segment) unit and reads every row in place through its own
// pointer, key stride and dtype (f32, int32, or bool bytes), so nothing is
// padded, stacked or cast: the wrapper passes a grid's value leaves and its
// validity mask as they lie.  The warp walks its ticks 32 at a time, lanes
// on neighbouring ticks (coalesced), compares each row's tick with the one
// before it, and stops at the first difference (__any_sync).
//
// The comparison is by value, as the reference's `!=`: NaN != NaN makes a
// tick dirty and -0.0 == 0.0 keeps it clean (do not build with fast math).
//
// Bound: bytes.  A unit reads its width+1 ticks of every row once (units
// of one key overlap by their dilation, which L1/L2 absorb); it writes one
// byte.  Early exit reads less on dirty segments.
//
// Every exported function launches on the given stream, allocates nothing
// and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SD_THREADS = 256;
constexpr int SD_WARPS = SD_THREADS / 32;
constexpr int SD_MAX_ROWS = 16;
constexpr unsigned FULL = 0xffffffffu;

enum Dtype { DT_F32 = 0, DT_I32 = 1, DT_U8 = 2 };

struct Row {
  const void* ptr;     // element (key 0, tick 0) of this row
  long long kstride;   // elements between keys
  int dtype;
  int pad;
};

struct Rows {
  Row r[SD_MAX_ROWS];
};

template <typename T>
__device__ __forceinline__ int differs(const Row& row, long long key,
                                       long long t) {
  const T* p = static_cast<const T*>(row.ptr) + key * row.kstride;
  return p[t] != p[t - 1];
}

__global__ void __launch_bounds__(SD_THREADS)
seg_dirty_kernel(Rows rows, int n_rows, long long n_units, int n_segs,
                 long long a0, long long step, long long width, long long T,
                 unsigned char* out, int accumulate) {
  const long long unit =
      (long long)blockIdx.x * SD_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (unit >= n_units) return;  // whole warps leave together
  const long long key = unit / n_segs;
  const long long k = unit % n_segs;
  const long long lo = a0 + k * step;
  const long long t_first = lo > 1 ? lo : 1;
  const long long hi = lo + width - 1;
  const long long t_last = hi < T - 1 ? hi : T - 1;
  int dirty = 0;
  for (long long base = t_first; base <= t_last && !dirty; base += 32) {
    const long long t = base + lane;
    int d = 0;
    if (t <= t_last) {
      for (int i = 0; i < n_rows && !d; ++i) {
        const Row& row = rows.r[i];
        if (row.dtype == DT_F32)
          d = differs<float>(row, key, t);
        else if (row.dtype == DT_I32)
          d = differs<int32_t>(row, key, t);
        else
          d = differs<uint8_t>(row, key, t);
      }
    }
    dirty = __any_sync(FULL, d);
  }
  if (lane == 0)
    out[unit] = (unsigned char)(dirty | (accumulate ? (out[unit] != 0) : 0));
}

}  // namespace

extern "C" {

int sd_max_rows() { return SD_MAX_ROWS; }

// ptrs/kstrides/dtypes: n_rows host arrays describing the rows (see Row);
// out: (keys, n_segs) uint8, written (accumulate = 0) or OR-ed into.
int sd_seg_dirty(const void* const* ptrs, const long long* kstrides,
                 const int* dtypes, int n_rows, long long keys, int n_segs,
                 long long a0, long long step, long long width, long long T,
                 void* out, int accumulate, void* stream) {
  if (n_rows < 1 || n_rows > SD_MAX_ROWS) return (int)cudaErrorInvalidValue;
  Rows rows = {};
  for (int i = 0; i < n_rows; ++i) {
    rows.r[i].ptr = ptrs[i];
    rows.r[i].kstride = kstrides[i];
    rows.r[i].dtype = dtypes[i];
  }
  const long long n_units = keys * n_segs;
  if (n_units == 0) return (int)cudaSuccess;
  const long long blocks = (n_units + SD_WARPS - 1) / SD_WARPS;
  seg_dirty_kernel<<<(unsigned)blocks, SD_THREADS, 0,
                     (cudaStream_t)stream>>>(
      rows, n_rows, n_units, n_segs, a0, step, width, T,
      static_cast<unsigned char*>(out), accumulate);
  return (int)cudaGetLastError();
}

}  // extern "C"
