// CUDA graph conditional (IF) nodes under stream capture, for Hopper
// (sm_90a): the port's counterpart of the reference's device-side
// control of the bounce loop, `jax.lax.cond` and `jax.lax.while_loop`
// (moonshine_tpu/integrator/path.py:706-711 and :802-823 there).
//
// Not a port of a TPU kernel: the reference's control is XLA's, not a
// Pallas kernel. integrator/graphs.py captures each bounce-loop step as a
// CUDA graph; a branch that the device chooses (the live prefix's width,
// whether the looped form runs another segment) becomes an IF node whose
// body the capture records on a second stream. torch has no binding for
// this on every version the port runs on, so it is done here, as the
// runtime's stream-capture API does it:
//
//   msn_if_begin(stream, child, a..., b..., log)
//     on `stream`, which is capturing: a conditional handle in the graph
//     it captures into; one launch of `set_if_kernel`, which, when the
//     graph runs, sets the handle to whether term a holds and term b
//     holds (b's `sel` null: a alone), and where it does adds one to
//     *log (null: none), the count of the body's runs that the launch
//     counts read; an IF node after it, which `stream` then captures
//     after; and `child` (not capturing) made to capture into the node's
//     body graph. A term is (sel, bytes, op, value): *sel, a bool (bytes
//     1) or an int64 (bytes 8) on the device, compared with value by op
//     (0: ==, 1: >, 2: <).
//   msn_if_end(child)
//     ends the body's capture.
//
// One thread: the predicate is a scalar, and a guard of the looped form
// costs this one launch. A body may hold kernels, memsets,
// device-to-device copies and nested IF nodes (begun on `child` with
// another child stream): what CUDA allows in a conditional body. Needs
// a CUDA 12.4 runtime and driver; an older one fails here with its
// error, and the caller raises.

#include <cuda_runtime.h>

namespace {

__device__ bool holds(const void* sel, int bytes, int op, long long value) {
  const long long v =
      bytes == 1 ? static_cast<long long>(
                       *static_cast<const unsigned char*>(sel))
                 : *static_cast<const long long*>(sel);
  return op == 0 ? v == value : (op == 1 ? v > value : v < value);
}

__global__ void set_if_kernel(cudaGraphConditionalHandle handle,
                              const void* a, int a_bytes, int a_op,
                              long long a_value, const void* b, int b_bytes,
                              int b_op, long long b_value, long long* log) {
  const bool go = holds(a, a_bytes, a_op, a_value) &&
                  (b == nullptr || holds(b, b_bytes, b_op, b_value));
  if (go && log != nullptr) *log += 1;
  cudaGraphSetConditional(handle, go ? 1u : 0u);
}

cudaError_t capture_info(cudaStream_t s, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* n) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph,
                                             deps, nullptr, n);
#else
  cudaError_t err =
      cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps, n);
#endif
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive
             ? cudaSuccess
             : cudaErrorIllegalState;
}

}  // namespace

extern "C" {

// the runtime's and the driver's versions (12040 = 12.4)
int msn_cond_versions(int* runtime, int* driver) {
  cudaError_t err = cudaRuntimeGetVersion(runtime);
  if (err != cudaSuccess) return err;
  return cudaDriverGetVersion(driver);
}

// a stream for bodies: non-blocking, so that it never joins the legacy
// default stream's order
int msn_cond_stream(void** out) {
  cudaStream_t s;
  cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *out = s;
  return err;
}

int msn_if_begin(void* stream, void* child, const void* a, int a_bytes,
                 int a_op, long long a_value, const void* b, int b_bytes,
                 int b_op, long long b_value, long long* log) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n;
  cudaError_t err = capture_info(s, &graph, &deps, &n);
  if (err != cudaSuccess) return err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_if_kernel<<<1, 1, 0, s>>>(handle, a, a_bytes, a_op, a_value, b,
                                b_bytes, b_op, b_value, log);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = capture_info(s, &graph, &deps, &n);  // now after the kernel
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(
      s, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, n, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(child), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, cudaStreamCaptureModeThreadLocal);
}

int msn_if_end(void* child) {
  cudaGraph_t body;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(child), &body);
}

const char* msn_cond_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
