// Shared by the kernel sources: the padded shared-memory layout of a
// staged tile and the staging itself (16-byte loads of a range's aligned
// cover), as prefix_scan and sliding_assoc (window_reduce.cu) and
// fused_trend (fused_query.cu) use them.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

// Shared-memory index of tick e of a tile: one pad word per 32 words, so
// the 8 consecutive ticks of each thread fall on distinct banks.
__device__ __forceinline__ int pad(int e) { return e + (e >> 5); }
__host__ __device__ constexpr int padded(int n) { return n + (n >> 5) + 1; }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Stages src[0, n) (any alignment) as f32 at buf[pad(dst0 + k)], by the
// whole block: 16-byte loads of the cover of [src, src + n), whose words
// are whole, so no load leaves the allocation's pages.
template <typename In>
__device__ __forceinline__ void stage(const In* src, int n, float* buf,
                                      int dst0) {
  constexpr int V = 16 / sizeof(In);
  const int lead =
      (int)((reinterpret_cast<uintptr_t>(src) / sizeof(In)) % V);
  const uint4* words = reinterpret_cast<const uint4*>(src - lead);
  const int nw = (lead + n + V - 1) / V;
  for (int i = threadIdx.x; i < nw; i += blockDim.x) {
    const uint4 u = __ldg(words + i);
    In vals[V];
    memcpy(vals, &u, sizeof(u));
#pragma unroll
    for (int c = 0; c < V; ++c) {
      const int k = V * i + c - lead;
      if (k >= 0 && k < n) buf[pad(dst0 + k)] = to_f32(vals[c]);
    }
  }
}

}  // namespace
