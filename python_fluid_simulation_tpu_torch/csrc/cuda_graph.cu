// The device-side exit of a captured CG loop: a conditional WHILE node in
// the CUDA graph being captured, and the one-thread kernel that tests the
// loop's exit and sets the node's condition.
//
// Replaces no TPU kernel.  In the JAX package the generic CG
// (python_fluid_simulation_tpu/solvers/cg.py::cg) is a lax.while_loop
// inside the jitted step, so its exit test never leaves the device.  The
// port's eager loop (solvers/cg.py) reads the test on the host each
// iteration; under stream capture the same loop body becomes the body of
// a WHILE node (CUDA 12.4 and later) and this kernel is its test:
//
//   loop while  res >= thresh  and  k < max_iter  and  delta != 0
//
// `pfs_while_begin` makes the node's condition handle in the graph being
// captured on `stream`, launches the first test there (k as it is), adds
// the WHILE node after it and starts capturing the node's body on
// `body_stream` (a second stream: the first one stays in its own
// capture).  The caller records the body on `body_stream`, writing the
// carried tensors in place, and closes it with `pfs_while_end`, whose test
// adds one to k first.  The launches run nothing while they are captured;
// the graph runs them on every replay.
//
// What bounds it: one thread, four scalar loads and a store an iteration,
// latency only (the body's kernels dwarf it).

#include <cuda_runtime.h>

namespace {

__global__ void while_test_kernel(cudaGraphConditionalHandle handle, int* k, const float* res,
                                  const float* thresh, const float* delta, int max_iter, int step) {
  const int kk = *k + step;
  if (step) *k = kk;
  const bool go = (*res >= *thresh) && (kk < max_iter) && (*delta != 0.f);
  cudaGraphSetConditional(handle, go ? 1u : 0u);
}

}  // namespace

extern "C" int pfs_while_begin(void* stream, void* body_stream, void* k, const void* res,
                               const void* thresh, const void* delta, int max_iter,
                               unsigned long long* handle_out) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t e = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return (int)e;
  if (status != cudaStreamCaptureStatusActive) return (int)cudaErrorIllegalState;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return (int)e;
  while_test_kernel<<<1, 1, 0, s>>>(handle, static_cast<int*>(k), static_cast<const float*>(res),
                                    static_cast<const float*>(thresh), static_cast<const float*>(delta),
                                    max_iter, 0);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the dependencies now end at the first test
  e = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body_stream), params.conditional.phGraph_out[0],
                                    nullptr, nullptr, 0, cudaStreamCaptureModeThreadLocal);
  if (e != cudaSuccess) return (int)e;
  *handle_out = handle;
  return 0;
}

// Ends the body begun by pfs_while_begin (`handle` as it wrote it): with
// `test` set, the body's last node is the test (k + 1 first) and
// `body_nodes` receives the nodes of the body (the test among them);
// without it (the body failed while it was recorded) the capture is only
// closed.
extern "C" int pfs_while_end(void* body_stream, const unsigned long long* handle, void* k, const void* res,
                             const void* thresh, const void* delta, int max_iter, int test,
                             unsigned long long* body_nodes) {
  cudaStream_t s = static_cast<cudaStream_t>(body_stream);
  cudaError_t launch = cudaSuccess;
  if (test) {
    while_test_kernel<<<1, 1, 0, s>>>(static_cast<cudaGraphConditionalHandle>(*handle), static_cast<int*>(k),
                                      static_cast<const float*>(res), static_cast<const float*>(thresh),
                                      static_cast<const float*>(delta), max_iter, 1);
    launch = cudaGetLastError();
  }
  cudaGraph_t body = nullptr;  // the node's own body graph: not ours to destroy
  cudaError_t e = cudaStreamEndCapture(s, &body);
  if (launch == cudaSuccess && e == cudaSuccess && test) {
    size_t n = 0;
    e = cudaGraphGetNodes(body, nullptr, &n);
    *body_nodes = n;
  }
  return (int)(launch != cudaSuccess ? launch : e);
}

// The top-level nodes of the graph being captured on `stream` so far (a
// WHILE node counts once, its body apart).
extern "C" int pfs_capture_nodes(void* stream, unsigned long long* count) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  cudaError_t e = cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status, nullptr, &graph, nullptr,
                                           nullptr);
  if (e != cudaSuccess) return (int)e;
  if (status != cudaStreamCaptureStatusActive) return (int)cudaErrorIllegalState;
  size_t n = 0;
  e = cudaGraphGetNodes(graph, nullptr, &n);
  *count = n;
  return (int)e;
}
