// Deterministic sorted segment sum for the BA depth-block reduction, for
// Hopper.
//
// Replaces the TPU kernel dpvo_tpu/ba/segsum_pallas.py:_make_kernel
// (launched by segment_sum_sorted at :68; call site ba/solver.py:209-218):
// out[s, :] = sum of payload[e, :] over the edges e whose dense depth id
// kd[e] == s, for s in [0, Md). The payload rows [E, K = 6W+2] carry the
// pose-depth coupling E, the depth Hessian C and the gradient u.
//
// What bounds it on an H100: memory. It reads the payload once
// (E x K x 4 bytes, 19 MB at E = 49152, K = 98) and writes Md x K floats;
// the adds are negligible.
//
// Design: no atomics, so the sums are bitwise reproducible. ``order`` is
// the stable argsort of ``kd`` (the host ships it, as for the TPU
// kernel), so the edges of segment s are the contiguous run
// order[lo_s .. hi_s) of the sorted id sequence. One block per output
// row finds lo_s and hi_s by binary search over kd[order[.]], then each
// thread sums one column over the run in sorted order, reading the
// payload rows through the permutation (the gather is fused: the
// payload is never permuted in memory). A row of K floats is contiguous,
// so each edge row is one coalesced read. Ids outside [0, Md) are
// dropped.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ int lower_bound(const int* __restrict__ kd, const int* __restrict__ order,
                                           int E, int target) {
  int lo = 0, hi = E;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (kd[order[mid]] < target)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
segsum_kernel(const float* __restrict__ payload, const int* __restrict__ kd,
              const int* __restrict__ order, float* __restrict__ out, int E, int K) {
  __shared__ int run[2];
  const int s = blockIdx.x;
  if (threadIdx.x < 2) run[threadIdx.x] = lower_bound(kd, order, E, s + threadIdx.x);
  __syncthreads();
  const int lo = run[0], hi = run[1];
  for (int k = threadIdx.x; k < K; k += kThreads) {
    float acc = 0.f;
    for (int i = lo; i < hi; ++i) acc += payload[(size_t)order[i] * K + k];
    out[(size_t)s * K + k] = acc;
  }
}

}  // namespace

extern "C" int dpvo_segment_sum(const void* payload, const void* kd, const void* order, void* out,
                                int E, int K, int Md, void* stream) {
  if (Md > 0) {
    segsum_kernel<<<Md, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)payload, (const int*)kd, (const int*)order, (float*)out, E, K);
  }
  return (int)cudaGetLastError();
}
