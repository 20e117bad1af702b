// Where a stream capture stands, for the capture-time stage labels of
// ``utils/observe.py``.
//
// A stream capture records its operations, in order, into one graph; the
// capture of ``models/_graph.py`` runs on one stream, so the graph is a
// chain and a replay runs its nodes in capture order. A span notes, at its
// enter and exit, the capture's last node (``capture_tail``, constant
// time); once the body is captured, ``capture_positions`` walks the chain
// back once and turns each noted node into its position in it, the count
// of nodes captured up to it. CUDA allows every operation on the
// capturing graph but its destruction and node removal while the capture
// is in progress; these read only.
//
// Plain C interface, bound with ctypes (``utils/observe.py``).

#include <cuda_runtime.h>

#include <unordered_map>
#include <vector>

namespace {

cudaError_t capture_info(cudaStream_t stream, cudaStreamCaptureStatus* status,
                         cudaGraph_t* graph, const cudaGraphNode_t** deps, size_t* ndeps) {
#if CUDART_VERSION >= 13000
  return cudaStreamGetCaptureInfo(stream, status, nullptr, graph, deps, nullptr, ndeps);
#else
  return cudaStreamGetCaptureInfo(stream, status, nullptr, graph, deps, ndeps);
#endif
}

cudaError_t node_dependencies(cudaGraphNode_t node, cudaGraphNode_t* deps, size_t* n) {
#if CUDART_VERSION >= 13000
  return cudaGraphNodeGetDependencies(node, deps, nullptr, n);
#else
  return cudaGraphNodeGetDependencies(node, deps, n);
#endif
}

}  // namespace

extern "C" {

// The node the stream's capture would make its next node depend on, in
// *node: the last node captured (the last of them where there are
// several), NULL where the stream captures nothing or no node yet.
// Returns a cudaError_t.
int capture_tail(void* stream, void** node) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  *node = nullptr;
  cudaError_t err = capture_info(static_cast<cudaStream_t>(stream), &status, &graph, &deps,
                                 &ndeps);
  if (err == cudaSuccess && status == cudaStreamCaptureStatusActive && ndeps > 0) {
    *node = deps[ndeps - 1];
  }
  return err;
}

// For each of the n nodes ``marks`` of the graph the stream is capturing
// into, its position in the chain (the count of nodes up to and including
// it), 0 for NULL, -1 for a node off the chain, in ``out``; the graph's
// node count in *total. The chain is walked back from the capture's tail,
// a dependency at a time, and ends at a node with no dependency or more
// than one. Where it is not the whole graph, capture order is not replay
// order, and every mark reads -1. Returns a cudaError_t
// (cudaErrorIllegalState where the stream captures nothing).
int capture_positions(void* stream, void* const* marks, long long n, long long* out,
                      unsigned long long* total) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0, count = 0;
  *total = 0;
  cudaError_t err = capture_info(static_cast<cudaStream_t>(stream), &status, &graph, &deps,
                                 &ndeps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorIllegalState;
  if ((err = cudaGraphGetNodes(graph, nullptr, &count)) != cudaSuccess) return err;
  std::vector<cudaGraphNode_t> chain;
  chain.reserve(count);
  cudaGraphNode_t node = ndeps == 1 ? deps[0] : nullptr;
  while (node != nullptr) {
    chain.push_back(node);
    cudaGraphNode_t before[2];
    size_t nbefore = 2;
    if ((err = node_dependencies(node, before, &nbefore)) != cudaSuccess) return err;
    node = nbefore == 1 ? before[0] : nullptr;
  }
  bool whole = chain.size() == count;
  std::unordered_map<cudaGraphNode_t, long long> position;
  position.reserve(chain.size());
  for (size_t k = 0; k < chain.size(); ++k) {
    position[chain[k]] = whole ? static_cast<long long>(count - k) : -1;
  }
  for (long long i = 0; i < n; ++i) {
    if (marks[i] == nullptr) {
      out[i] = 0;
    } else {
      auto found = position.find(static_cast<cudaGraphNode_t>(marks[i]));
      out[i] = found == position.end() ? -1 : found->second;
    }
  }
  *total = count;
  return cudaSuccess;
}

const char* capture_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
