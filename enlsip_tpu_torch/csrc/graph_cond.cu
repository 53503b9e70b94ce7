// Conditional nodes (IF, WHILE) in a CUDA graph that PyTorch is capturing.
//
// Counterpart of the device-side control flow of the JAX package's
// jitted solve: lax.cond / lax.switch / lax.while_loop / lax.fori_loop
// inside enlsip_tpu/core/driver.py::_solve_full_jit and
// enlsip_tpu/parallel/batch.py::_solve_batched_jit.  This file holds no
// TPU kernel's counterpart; it is the executor's plumbing
// (enlsip_tpu_torch/_graph.py).
//
// How a body is captured.  While `stream` is capturing into graph G,
// cg_begin
//   1. creates a conditional handle in G,
//   2. enqueues on `stream` a one-thread kernel that reads a 0-d flag
//      (one byte, 0 or 1) from device memory and sets the handle (with
//      no flag, the handle takes the value 1 at every launch of the
//      graph instead: the root body, which always runs),
//   3. adds a conditional node (IF or WHILE, one body) to G after every
//      node the capture has so far,
//   4. starts capturing `child` into the node's body.
// The caller then enqueues the body's work on `child`; a WHILE body ends
// with cg_set on `child`, which sets the handle again from the flag the
// body recomputed (the loop runs again while it is 1).  cg_end ends the
// child's capture.
//
// Bodies nest on ONE stream.  When `child` is `stream` itself (a body
// inside a body), step 4 first ends the stream's capture into G, and
// cg_end, after ending the body's capture, resumes the capture into G
// with the new node as its only dependency.  So every body of a graph,
// at every depth, is captured on the same stream, in the order the
// graph runs it, and PyTorch's caching allocator, which hands a freed
// block out again only on the stream it was freed on, reuses the blocks
// of one body in the next (enlsip_tpu_torch/_graph.py says why that is
// safe).  When `child` is another stream (the root body, under
// PyTorch's own capture of the graph), the node becomes the capture's
// only dependency and `stream` goes on capturing into G.
//
// The kernel that sets the handle is one thread and one byte read.
// Nothing is allocated and nothing waits.
//
// Span stamps (enlsip_tpu_torch/utils/profiling.py).  cg_stamp enqueues a
// one-thread kernel that takes the next slot of a ring in device memory
// with a 64-bit atomicAdd on the ring's head (slot = count mod capacity)
// and writes (site code, payload, %globaltimer ns) there.  Captured, it
// runs where the replay reaches it, so a graph's spans are timed on the
// card's clock; inside a conditional body it runs only when the body
// runs.  The payload is an int read from device memory when the stamp
// runs (a step count), or none.

#include <cuda_runtime.h>

namespace {

__global__ void set_conditional(cudaGraphConditionalHandle handle,
                                const unsigned char* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

__global__ void noop() {}

cudaError_t capture_info(cudaStream_t stream, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* ndeps) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph,
                                             deps, nullptr, ndeps);
#else
  cudaError_t err =
      cudaStreamGetCaptureInfo(stream, &status, nullptr, graph, deps, ndeps);
#endif
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureImplicit;
  return cudaSuccess;
}

}  // namespace

// ring: (1 + capacity) x 2 words; word 0 of row 0 counts the stamps taken,
// row 1 + k holds event k: word 0 = site code (low 32 bits) and payload
// (high 32 bits), word 1 = %globaltimer.
extern "C" __global__ void enlsip_span_stamp(unsigned long long* ring,
                                             unsigned long long capacity,
                                             int code, const int* payload) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  unsigned long long k = atomicAdd(ring, 1ULL) % capacity;
  int p = payload != nullptr ? *payload : (int)0x80000000;
  unsigned long long* e = ring + 2 * (1 + k);
  e[0] = (unsigned long long)(unsigned int)code |
         ((unsigned long long)(unsigned int)p << 32);
  e[1] = t;
}

// kind 0: IF, kind 1: WHILE.  `flag` is a device byte, or null for a
// handle that is 1 at every launch.  On success *handle_out holds the
// node's handle (for cg_set) and `child` is capturing the body; when
// `child` is `stream`, *graph_out and *node_out hold the graph whose
// capture was suspended and the node after which cg_end resumes it
// (both null otherwise).
extern "C" int cg_begin(void* stream, void* child, int kind, const void* flag,
                        unsigned long long* handle_out, void** graph_out,
                        void** node_out) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  *graph_out = nullptr;
  *node_out = nullptr;
  cudaError_t err = capture_info(st, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphConditionalHandle handle;
  if (flag == nullptr) {
    err = cudaGraphConditionalHandleCreate(&handle, graph, 1,
                                           cudaGraphCondAssignDefault);
    if (err != cudaSuccess) return (int)err;
  } else {
    err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
    if (err != cudaSuccess) return (int)err;
    set_conditional<<<1, 1, 0, st>>>(handle, (const unsigned char*)flag);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = capture_info(st, &graph, &deps, &ndeps);
    if (err != cudaSuccess) return (int)err;
  }

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type =
      kind == 1 ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, ndeps, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
#endif
  if (err != cudaSuccess) return (int)err;
  if ((cudaStream_t)child == st) {
    cudaGraph_t suspended;
    err = cudaStreamEndCapture(st, &suspended);
    if (err != cudaSuccess) return (int)err;
    *graph_out = (void*)suspended;
    *node_out = (void*)node;
  } else {
#if CUDART_VERSION >= 13000
    err = cudaStreamUpdateCaptureDependencies(
        st, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
    err = cudaStreamUpdateCaptureDependencies(
        st, &node, 1, cudaStreamSetCaptureDependencies);
#endif
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaStreamBeginCaptureToGraph((cudaStream_t)child,
                                      params.conditional.phGraph_out[0],
                                      nullptr, nullptr, 0,
                                      cudaStreamCaptureModeThreadLocal);
  if (err != cudaSuccess) return (int)err;
  *handle_out = (unsigned long long)handle;
  return 0;
}

// Set `handle` from the device byte `flag`, in stream order on `stream`
// (the last node of a WHILE body).
extern "C" int cg_set(void* stream, unsigned long long handle,
                      const void* flag) {
  set_conditional<<<1, 1, 0, (cudaStream_t)stream>>>(
      (cudaGraphConditionalHandle)handle, (const unsigned char*)flag);
  return (int)cudaGetLastError();
}

// End the body's capture on `child`, then, when `graph` is not null,
// resume capturing `child` into `graph` after `node` (cg_begin's
// *graph_out and *node_out).  A body that captured nothing gets one empty
// kernel: a conditional node's body may not be empty.
extern "C" int cg_end(void* child, void* graph, void* node) {
  cudaStream_t st = (cudaStream_t)child;
  cudaGraph_t body_graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t err = capture_info(st, &body_graph, &deps, &ndeps);
  if (err != cudaSuccess) return (int)err;
  if (ndeps == 0) {
    noop<<<1, 1, 0, st>>>();
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  cudaGraph_t body;
  err = cudaStreamEndCapture(st, &body);
  if (err != cudaSuccess || graph == nullptr) return (int)err;
  cudaGraphNode_t after = (cudaGraphNode_t)node;
  return (int)cudaStreamBeginCaptureToGraph(st, (cudaGraph_t)graph, &after,
                                            nullptr, 1,
                                            cudaStreamCaptureModeThreadLocal);
}

// One span stamp on `stream` (see the head of the file).
extern "C" int cg_stamp(void* stream, void* ring, unsigned long long capacity,
                        int code, const void* payload) {
  enlsip_span_stamp<<<1, 1, 0, (cudaStream_t)stream>>>(
      (unsigned long long*)ring, capacity, code, (const int*)payload);
  return (int)cudaGetLastError();
}

extern "C" int cg_runtime_version() { return CUDART_VERSION; }

extern "C" int cg_driver_version() {
  int v = 0;
  cudaDriverGetVersion(&v);
  return v;
}

extern "C" const char* cg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
