// CUDA graph conditional nodes under stream capture, for Hopper (sm_90a):
// the port's counterpart of the reference's device-side control of the
// bounce loop, `jax.lax.cond` and `jax.lax.while_loop`
// (moonshine_tpu/integrator/path.py:706-711 and :802-823 there).
//
// Not a port of a TPU kernel: the reference's control is XLA's, not a
// Pallas kernel. integrator/graphs.py captures each bounce-loop step as a
// CUDA graph; a branch that the device chooses (the live prefix's width,
// whether the looped form runs another segment) becomes a conditional
// node whose bodies the capture records on a second stream. torch has no
// binding for this on every version the port runs on, so it is done
// here, as the runtime's stream-capture API does it:
//
//   msn_cond_begin(stream, kind, a..., b..., a_values, b_values, n, log,
//                  bodies)
//     on `stream`, which is capturing: a conditional handle in the graph
//     it captures into; one launch of `set_case_kernel`, which, when the
//     graph runs, finds the first case i < n whose terms hold (term a
//     with a_values[i], term b with b_values[i]; b's `sel` null: a
//     alone), adds one to log[i] (log null: none), the count of body i's
//     runs that the launch counts read, and sets the handle: to i, or n
//     where no case holds, for a SWITCH node (kind 1: n bodies, and a
//     value past them runs none); to whether case 0 holds for an IF node
//     (kind 0, n = 1); the node after it, which `stream` then captures
//     after; its body graphs written to bodies[0..n).
//   msn_guard(stream, handle)
//     a handle in the graph `stream` captures into, reset to 0 at every
//     launch of that graph (cudaGraphCondAssignDefault).
//   msn_if_on(stream, handle, body)
//     an IF node on that handle, whose value a kernel set earlier in the
//     graph or in a body of one of its nodes (`msn_tail`), or nothing set
//     (0: the node runs no body); its body graph written to *body.
//   msn_tail(stream, counter, handle, set, a..., b..., log)
//     one launch of `tail_kernel`: *counter += 1, then, with `set`, the
//     handle set to whether both terms hold (against a_value, b_value),
//     and where they do one added to *log. The looped form's segment
//     ends with it: it counts the segment and sets the next segment's
//     guard from the live count the segment made, so the next guard
//     needs no set launch of its own; a segment that does not run leaves
//     that guard at its default 0, and every later one with it, as the
//     while_loop stops.
//   msn_body_begin(child, body) / msn_body_end(child)
//     `child` (not capturing) made to capture into a body graph, and
//     that capture ended.
//
// A term is (sel, bytes, op): *sel, a bool (bytes 1) or an int64 (bytes
// 8) on the device, compared with a case's value by op (0: ==, 1: >, 2:
// <). One thread a set kernel: the predicate is a scalar. A body may hold
// kernels, memsets, device-to-device copies and nested conditional nodes
// (begun on `child` with another child stream): what CUDA allows in a
// conditional body. A kernel inside a body sets the handle of a node of
// an enclosing graph, as the CUDA programming guide's while loop sets its
// own node's from its body. SWITCH nodes need the CUDA 12.8 runtime and
// driver; integrator/graphs.py raises below that.

#include <cuda_runtime.h>

#if CUDART_VERSION < 12080
#error "graph_cond.cu needs CUDA 12.8 (conditional SWITCH nodes)"
#endif

namespace {

constexpr int kMaxCases = 8;  // a switch's bodies, at most

struct Cases {
  long long a[kMaxCases];
  long long b[kMaxCases];
};

__device__ long long load(const void* sel, int bytes) {
  return bytes == 1 ? static_cast<long long>(
                          *static_cast<const unsigned char*>(sel))
                    : *static_cast<const long long*>(sel);
}

__device__ bool holds(long long v, int op, long long value) {
  return op == 0 ? v == value : (op == 1 ? v > value : v < value);
}

__global__ void set_case_kernel(cudaGraphConditionalHandle handle, int kind,
                                const void* a, int a_bytes, int a_op,
                                const void* b, int b_bytes, int b_op,
                                Cases cases, int n, long long* log) {
  const long long va = load(a, a_bytes);
  const long long vb = b == nullptr ? 0 : load(b, b_bytes);
  int i = 0;
  while (i < n && !(holds(va, a_op, cases.a[i]) &&
                    (b == nullptr || holds(vb, b_op, cases.b[i])))) {
    ++i;
  }
  if (i < n && log != nullptr) log[i] += 1;
  cudaGraphSetConditional(handle, kind == 1 ? static_cast<unsigned>(i)
                                            : (i < n ? 1u : 0u));
}

__global__ void tail_kernel(long long* counter,
                            cudaGraphConditionalHandle handle, int set,
                            const void* a, int a_bytes, int a_op,
                            long long a_value, const void* b, int b_bytes,
                            int b_op, long long b_value, long long* log) {
  *counter += 1;
  if (!set) return;
  const bool go =
      holds(load(a, a_bytes), a_op, a_value) &&
      (b == nullptr || holds(load(b, b_bytes), b_op, b_value));
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

// A conditional node of `type` on `handle` after what `s` captured last;
// `s` then captures after it, and its body graphs go to bodies[0..size).
cudaError_t add_node(cudaStream_t s, cudaGraphConditionalHandle handle,
                     cudaGraphConditionalNodeType type, int size,
                     void** bodies) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n;
  cudaError_t err = capture_info(s, &graph, &deps, &n);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = type;
  params.conditional.size = size;
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
  for (int i = 0; i < size; ++i) bodies[i] = params.conditional.phGraph_out[i];
  return cudaSuccess;
}

}  // namespace

extern "C" {

// the runtime's and the driver's versions (12080 = 12.8)
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

int msn_cond_begin(void* stream, int kind, const void* a, int a_bytes,
                   int a_op, const void* b, int b_bytes, int b_op,
                   const long long* a_values, const long long* b_values,
                   int n, long long* log, void** bodies) {
  if (n < 1 || n > kMaxCases || (kind == 0 && n != 1) || kind < 0 ||
      kind > 1) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t nd;
  cudaError_t err = capture_info(s, &graph, &deps, &nd);
  if (err != cudaSuccess) return err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  Cases cases = {};
  for (int i = 0; i < n; ++i) {
    cases.a[i] = a_values[i];
    cases.b[i] = b_values[i];
  }
  set_case_kernel<<<1, 1, 0, s>>>(handle, kind, a, a_bytes, a_op, b,
                                  b_bytes, b_op, cases, n, log);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return add_node(s, handle,
                  kind == 1 ? cudaGraphCondTypeSwitch : cudaGraphCondTypeIf,
                  n, bodies);
}

int msn_guard(void* stream, unsigned long long* handle) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n;
  cudaError_t err =
      capture_info(static_cast<cudaStream_t>(stream), &graph, &deps, &n);
  if (err != cudaSuccess) return err;
  cudaGraphConditionalHandle h;
  err = cudaGraphConditionalHandleCreate(&h, graph, 0,
                                         cudaGraphCondAssignDefault);
  *handle = h;
  return err;
}

int msn_if_on(void* stream, unsigned long long handle, void** body) {
  return add_node(static_cast<cudaStream_t>(stream), handle,
                  cudaGraphCondTypeIf, 1, body);
}

int msn_tail(void* stream, long long* counter, unsigned long long handle,
             int set, const void* a, int a_bytes, int a_op,
             long long a_value, const void* b, int b_bytes, int b_op,
             long long b_value, long long* log) {
  tail_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      counter, handle, set, a, a_bytes, a_op, a_value, b, b_bytes, b_op,
      b_value, log);
  return cudaGetLastError();
}

int msn_body_begin(void* child, void* body) {
  return cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(child), static_cast<cudaGraph_t>(body),
      nullptr, nullptr, 0, cudaStreamCaptureModeThreadLocal);
}

int msn_body_end(void* child) {
  cudaGraph_t body;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(child), &body);
}

const char* msn_cond_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
