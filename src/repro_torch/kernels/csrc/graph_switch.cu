// The sparse chunk step as one CUDA graph that picks its compaction bucket
// on the device (sm_90a), bound through a plain C interface (ctypes; see
// ../build.py and ../../engine/capture.py).
//
// The reference picks the bucket inside its jitted step: searchsorted of
// the dirty-unit count over the capacity ladder, then lax.switch over one
// compacted body per capacity (src/repro/engine/runner.py, the fused sparse
// step).  No TPU kernel is replaced here: this is the runner's control
// flow, which a CUDA graph can only express with conditional nodes.
//
// PyTorch captures the step's three parts as graphs of their own (kept,
// not instantiated): the prefix (change detection, the mask, the count),
// one body per capacity, and the suffix (hold fill, outputs, the state
// written in place).  gs_compose builds one graph from them:
//
//   prefix -> pick_bucket_kernel -> IF(b == 0){body 0} ... IF(b == n-1)
//          {body n-1} -> suffix
//
// pick_bucket_kernel reads the count the prefix left on the device, finds
// its bucket (the first capacity >= count, the last one past the end, as
// core/sparse.bucket_capacity) and sets one conditional handle per body:
// exactly one body runs, and nothing is read on the host.  The IF nodes
// are used rather than one SWITCH node, which needs CUDA 12.8's driver.
//
// Bound: the pick is one thread reading 4 + 8·n bytes, on the path of
// every sparse chunk; what it saves is the host read of the count and the
// host's wait for it.
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int GS_MAX_BODIES = 32;

struct Handles {
  cudaGraphConditionalHandle h[GS_MAX_BODIES];
};

__global__ void pick_bucket_kernel(Handles hs, int n, const int* count,
                                   const long long* caps) {
  const long long c = *count;
  int b = 0;
  while (b < n - 1 && caps[b] < c) ++b;
  for (int i = 0; i < n; ++i) cudaGraphSetConditional(hs.h[i], i == b);
}

}  // namespace

extern "C" {

int gs_max_bodies() { return GS_MAX_BODIES; }

// prefix, bodies[n], suffix: graphs captured by PyTorch (cudaGraph_t, each
// cloned into the result); count: int32 on the device; caps: n int64
// capacities on the device, ascending.  Writes the instantiated graph to
// *exec and uploads it on `stream` (so its first launch does not pay for
// the upload).  Nothing is launched.
int gs_compose(void* prefix, void** bodies, int n, void* suffix,
               const void* count, const void* caps, int device, void* stream,
               void** exec) {
  if (n < 1 || n > GS_MAX_BODIES || exec == nullptr)
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaGraph_t g = nullptr;
  cudaError_t e = cudaGraphCreate(&g, 0);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNode_t pre = nullptr, pick = nullptr, suf = nullptr;
  cudaGraphNode_t ifs[GS_MAX_BODIES];
  Handles hs{};
  e = cudaGraphAddChildGraphNode(&pre, g, nullptr, 0,
                                 static_cast<cudaGraph_t>(prefix));
  for (int i = 0; e == cudaSuccess && i < n; ++i)
    e = cudaGraphConditionalHandleCreate(&hs.h[i], g, 0, 0);
  if (e == cudaSuccess) {
    const int* cnt = static_cast<const int*>(count);
    const long long* cp = static_cast<const long long*>(caps);
    void* args[] = {&hs, &n, &cnt, &cp};
    cudaKernelNodeParams kp = {};
    kp.func = reinterpret_cast<void*>(pick_bucket_kernel);
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(1);
    kp.kernelParams = args;
    e = cudaGraphAddKernelNode(&pick, g, &pre, 1, &kp);
  }
  for (int i = 0; e == cudaSuccess && i < n; ++i) {
    cudaGraphNodeParams cp = {};
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = hs.h[i];
    cp.conditional.type = cudaGraphCondTypeIf;
    cp.conditional.size = 1;
    e = cudaGraphAddNode(&ifs[i], g, &pick, 1, &cp);
    if (e == cudaSuccess) {
      cudaGraphNode_t child = nullptr;
      e = cudaGraphAddChildGraphNode(&child, cp.conditional.phGraph_out[0],
                                     nullptr, 0,
                                     static_cast<cudaGraph_t>(bodies[i]));
    }
  }
  if (e == cudaSuccess)
    e = cudaGraphAddChildGraphNode(&suf, g, ifs, n,
                                   static_cast<cudaGraph_t>(suffix));
  cudaGraphExec_t x = nullptr;
  if (e == cudaSuccess) e = cudaGraphInstantiate(&x, g, 0);
  cudaGraphDestroy(g);
  if (e != cudaSuccess) return (int)e;
  e = cudaGraphUpload(x, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGraphExecDestroy(x);
    return (int)e;
  }
  *exec = x;
  return (int)cudaSuccess;
}

int gs_launch(void* exec, int device, void* stream) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  cudaError_t e = cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                                  static_cast<cudaStream_t>(stream));
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

int gs_destroy(void* exec) {
  return (int)cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
}

}  // extern "C"
