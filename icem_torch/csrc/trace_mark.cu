// Phase markers of the port's trace (icem_torch/runtime/metrics.py).
//
// A marker is one kernel of one thread: it stamps (phase id, %globaltimer)
// into a device ring at a slot it takes with one atomic add. The markers go
// into every captured control step; a graph keeps them as disabled kernel
// nodes, which run as empty nodes, until tracing turns them on:
//
// - trace_mark launches a marker on a stream and, when the stream is being
//   captured, hands back the graph node the launch made;
// - trace_set_markers enables or disables those nodes in an instantiated
//   graph (cudaGraphNodeSetEnabled): no recapture, no new instantiation;
// - trace_read copies the ring's head and its stamps to the host,
//   trace_reset empties the ring.
//
// The ring holds kTraceRing stamps; a marker past its end stamps nothing and
// still advances the head, so the reader sees the overflow.

#include <cuda_runtime.h>

namespace {

constexpr unsigned long long kTraceRing = 1ull << 16;

__device__ unsigned long long g_trace_head;
__device__ long long g_trace_ring[2 * kTraceRing];  // (phase id, ns) pairs

__global__ void trace_mark_kernel(int phase) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const unsigned long long slot = atomicAdd(&g_trace_head, 1ull);
  if (slot < kTraceRing) {
    g_trace_ring[2 * slot] = phase;
    g_trace_ring[2 * slot + 1] = static_cast<long long>(now);
  }
}

}  // namespace

extern "C" long long trace_ring_capacity() { return static_cast<long long>(kTraceRing); }

extern "C" int trace_mark(int phase, void* stream, void** node) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  trace_mark_kernel<<<1, 1, 0, s>>>(phase);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  *node = nullptr;
  cudaStreamCaptureStatus status;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, nullptr, &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the launch just captured is the stream's one dependency
  if (status == cudaStreamCaptureStatusActive && n_deps == 1) *node = deps[0];
  return 0;
}

extern "C" int trace_set_markers(void* exec, void* const* nodes, int n, int enable) {
  for (int i = 0; i < n; ++i) {
    const cudaError_t err = cudaGraphNodeSetEnabled(
        static_cast<cudaGraphExec_t>(exec), static_cast<cudaGraphNode_t>(nodes[i]),
        enable ? 1u : 0u);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

extern "C" int trace_read(unsigned long long* head, long long* out, long long capacity) {
  cudaError_t err = cudaMemcpyFromSymbol(head, g_trace_head, sizeof(*head));
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned long long n = *head < kTraceRing ? *head : kTraceRing;
  if (n > static_cast<unsigned long long>(capacity)) n = static_cast<unsigned long long>(capacity);
  if (n > 0) err = cudaMemcpyFromSymbol(out, g_trace_ring, 2 * n * sizeof(long long));
  return static_cast<int>(err);
}

extern "C" int trace_reset() {
  const unsigned long long zero = 0;
  return static_cast<int>(cudaMemcpyToSymbol(g_trace_head, &zero, sizeof(zero)));
}
