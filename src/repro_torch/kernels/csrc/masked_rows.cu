// The masked channel rows every window kernel reads, written in one pass
// for Hopper (sm_90a), bound through a plain C interface (ctypes; see
// ../build.py).  It replaces no TPU kernel: the Pallas wrappers of
// src/repro/kernels/ops.py build these rows with a where, a cast and a
// concatenation that XLA fuses into the kernel's input; PyTorch runs each
// as a pass of its own over device memory.  Here one launch reads each of
// the C f32 channels once and the bool validity once and writes the
// contiguous (C + 1, R, T) f32 buffer that window_reduce.sliding_assoc
// (or prefix_scan) then reads:
//
//   out[c, r, t] = valid[r, t] ? x_c[r, t] : fill   (c < C)
//   out[C, r, t] = valid[r, t] ? on : off
//
// with fill 0 / -inf / +inf and (on, off) = (1, 0), or (-1, -0) for min,
// whose any-valid row rides through the min combine.  The select moves
// bits (NaN payloads and signed zeros stay as they are), so the buffer is
// bit for bit what torch.where / .float() / torch.cat make.
//
// Bound by bytes: 4C + 1 read and 4(C + 1) written per key-tick, no
// arithmetic.  The grid is (tiles of MR_TILE ticks, rows), each thread
// owning MR_ITEMS ticks of a row, so enough loads are in flight to cover
// the latency of device memory.  Two forms, chosen by the wrapper from the
// pointers and strides it sees (window_reduce.masked_plan):
//
//   * vector: every row of every input starts 16-byte aligned (4-byte for
//     the validity) and T % 4 == 0; a thread loads a float4 of each
//     channel and a uchar4 of the validity and stores float4s.  Inputs
//     laid out as one contiguous run arrive as a single row of R * T
//     ticks, so a T that is not a multiple of 4 still takes this form.
//   * scalar: any row stride and alignment; a thread's ticks lie
//     MR_THREADS apart, so each load and store of a warp is coalesced.
//
// A launch takes 1 to MR_MAX_CH channels (the widest reduction, kurtosis,
// has 4).  Every exported function launches on the given stream,
// allocates nothing and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int MR_THREADS = 256;
constexpr int MR_ITEMS = 4;                     // ticks a thread owns
constexpr int MR_TILE = MR_THREADS * MR_ITEMS;  // ticks of a row a block
constexpr int MR_MAX_CH = 4;                    // channels a launch
constexpr int MR_MAX_GRID_Y = 65535;

enum Op { OP_ADD = 0, OP_MAX = 1, OP_MIN = 2 };

struct Args {
  const float* x[MR_MAX_CH];  // channel c's row 0
  long long xs[MR_MAX_CH];    // channel c's row stride, floats
  const uint8_t* v;           // validity's row 0
  long long vs;               // validity's row stride, bytes
  float* out;                 // first channel of this launch, row 0
  float* vout;                // the validity channel, row 0
  long long plane;            // floats between output channels (R * T)
  long long R, T;             // rows and ticks a row, as launched
  float fill, on, off;
};

template <int C, bool VEC>
__global__ void __launch_bounds__(MR_THREADS) masked_rows_kernel(Args a) {
  const long long t0 = (long long)blockIdx.x * MR_TILE;
  for (long long r = blockIdx.y; r < a.R; r += gridDim.y) {
    const uint8_t* v = a.v + r * a.vs;
    float* o = a.out + r * a.T;
    float* vo = a.vout + r * a.T;
    if (VEC) {
      const long long t = t0 + MR_ITEMS * threadIdx.x;
      if (t >= a.T) continue;
      const uchar4 m = __ldg(reinterpret_cast<const uchar4*>(v + t));
      float4 xv[C];
#pragma unroll
      for (int c = 0; c < C; ++c)
        xv[c] = __ldg(reinterpret_cast<const float4*>(a.x[c] + r * a.xs[c] +
                                                      t));
#pragma unroll
      for (int c = 0; c < C; ++c)
        *reinterpret_cast<float4*>(o + c * a.plane + t) = make_float4(
            m.x ? xv[c].x : a.fill, m.y ? xv[c].y : a.fill,
            m.z ? xv[c].z : a.fill, m.w ? xv[c].w : a.fill);
      *reinterpret_cast<float4*>(vo + t) =
          make_float4(m.x ? a.on : a.off, m.y ? a.on : a.off,
                      m.z ? a.on : a.off, m.w ? a.on : a.off);
    } else {
      uint8_t m[MR_ITEMS];
      float xv[C][MR_ITEMS];
#pragma unroll
      for (int k = 0; k < MR_ITEMS; ++k) {
        const long long t = t0 + k * MR_THREADS + threadIdx.x;
        if (t < a.T) {
          m[k] = __ldg(v + t);
#pragma unroll
          for (int c = 0; c < C; ++c)
            xv[c][k] = __ldg(a.x[c] + r * a.xs[c] + t);
        }
      }
#pragma unroll
      for (int k = 0; k < MR_ITEMS; ++k) {
        const long long t = t0 + k * MR_THREADS + threadIdx.x;
        if (t < a.T) {
#pragma unroll
          for (int c = 0; c < C; ++c)
            o[c * a.plane + t] = m[k] ? xv[c][k] : a.fill;
          vo[t] = m[k] ? a.on : a.off;
        }
      }
    }
  }
}

template <int C>
cudaError_t launch(const Args& a, int vec, dim3 grid, cudaStream_t s) {
  if (vec)
    masked_rows_kernel<C, true><<<grid, MR_THREADS, 0, s>>>(a);
  else
    masked_rows_kernel<C, false><<<grid, MR_THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The constants the wrapper's launch plan is built on.
int mr_tile() { return MR_TILE; }
int mr_max_channels() { return MR_MAX_CH; }

// x: C pointers to row 0 of each f32 channel, xs: their row strides in
// floats (each row's ticks contiguous); v: row 0 of the bool validity, vs:
// its row stride in bytes; out: C channels of rows, `plane` floats apart,
// vout: the validity channel, both with rows of T.  op: 0 add, 1 max,
// 2 min.  vec, blocks_x, blocks_y: the wrapper's launch plan
// (window_reduce.masked_plan), whose vector form the pointers and strides
// must allow.
int mr_masked_rows(const void* const* x, const long long* xs, int C,
                   const void* v, long long vs, void* out, void* vout,
                   long long plane, long long R, long long T, int op, int vec,
                   long long blocks_x, int blocks_y, int device,
                   void* stream) {
  if (C < 1 || C > MR_MAX_CH || op < OP_ADD || op > OP_MIN || blocks_y < 1 ||
      blocks_y > MR_MAX_GRID_Y)
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  Args a;
  for (int c = 0; c < C; ++c) {
    a.x[c] = static_cast<const float*>(x[c]);
    a.xs[c] = xs[c];
  }
  for (int c = C; c < MR_MAX_CH; ++c) {
    a.x[c] = nullptr;
    a.xs[c] = 0;
  }
  a.v = static_cast<const uint8_t*>(v);
  a.vs = vs;
  a.out = static_cast<float*>(out);
  a.vout = static_cast<float*>(vout);
  a.plane = plane;
  a.R = R;
  a.T = T;
  a.fill = op == OP_ADD ? 0.0f : (op == OP_MAX ? -INFINITY : INFINITY);
  a.on = op == OP_MIN ? -1.0f : 1.0f;
  a.off = op == OP_MIN ? -0.0f : 0.0f;
  const dim3 grid((unsigned)blocks_x, (unsigned)blocks_y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return (int)launch<1>(a, vec, grid, s);
    case 2: return (int)launch<2>(a, vec, grid, s);
    case 3: return (int)launch<3>(a, vec, grid, s);
    default: return (int)launch<4>(a, vec, grid, s);
  }
}

}  // extern "C"
