// Deterministic sorted segment sum, for Hopper: the BA depth-block
// reduction and SoftAgg's grouped sums.
//
// Replaces the TPU kernel dpvo_tpu/ba/segsum_pallas.py:_make_kernel
// (launched by segment_sum_sorted at :68; call site ba/solver.py:209-218):
// out[s, :] = sum of payload[e, :] over the edges e whose id kd[e] == s,
// for s in [0, Md), in f32. The payload is f32 (BA: rows [E, K = 6W+2] of
// the pose-depth coupling, the depth Hessian and the gradient) or bf16
// (SoftAgg: [E, 2 * DIM] rows of the module dtype, as the JAX one-hot
// matmul takes them); a bf16 value converts to f32 exactly, so both are
// one function. Ids outside [0, Md) are dropped.
//
// What bounds it on an H100: memory. It reads the payload once (19 MB
// for BA at E = 49152, K = 98 f32; 63 MB for SoftAgg at E = 40960, K = 768
// bf16) and writes Md x K floats; the adds are negligible. Its runs are
// short (~15-20 rows per depth variable, 96 per frame pair), and most of
// SoftAgg's 2048 pair segments are empty, so the latency of finding a run
// and of the first loads matters as much as the bytes.
//
// Design. ``order`` is the stable argsort of ``kd`` (the host ships it, as
// for the TPU kernel), so the edges of segment s are the contiguous run of
// the sorted id sequence kd[order[.]] equal to s. One warp per segment,
// four segments per block, no block barrier:
// - the warp finds the run's start by a 32-way search: each round its
//   lanes probe 32 points of the interval at once (4 rounds at E = 49152,
//   where a binary search takes 16 dependent steps); the round's probes
//   include the interval's last point, so the trailing empty segments
//   (ids past the largest) finish in one round;
// - it then walks the run 32 sorted positions at a time: one coalesced
//   load of order[], then every lane's kd[order[.]] and, without waiting
//   for them, the payload rows of the chunk in groups of U = 8 rows, each
//   row a coalesced load of 16, 8, 4 or 2-byte vectors (the widest that
//   the row length and the pointer's alignment allow); a ballot of
//   kd == s says how many of the chunk's rows belong to the run (they
//   come first, the ids being sorted), and only those are added;
// - each lane owns a fixed set of columns and adds its rows strictly in
//   sorted order, one after another, with plain f32 adds (no atomics, no
//   tree, no FMA): the sums are bitwise reproducible and equal to the
//   sequential sums of the plain version (index_add_ on the CPU).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // segments per block
constexpr int kU = 8;      // payload rows whose loads are in flight together

template <int BYTES> struct Raw;
template <> struct Raw<2> { using T = unsigned short; };
template <> struct Raw<4> { using T = unsigned int; };
template <> struct Raw<8> { using T = uint2; };
template <> struct Raw<16> { using T = uint4; };

// the V payload values of a loaded vector, as f32 (exact for bf16)
template <typename T, int V>
__device__ __forceinline__ void to_f32(const typename Raw<V * (int)sizeof(T)>::T& r,
                                       float (&x)[V]) {
  if constexpr (sizeof(T) == 4) {
    const float* f = reinterpret_cast<const float*>(&r);
#pragma unroll
    for (int i = 0; i < V; ++i) x[i] = f[i];
  } else {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(&r);
#pragma unroll
    for (int i = 0; i < V; ++i) x[i] = __uint_as_float((unsigned int)h[i] << 16);
  }
}

// first position i in [0, E] with kd[order[i]] >= s (the sorted ids are
// non-decreasing); all lanes return it
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ kd,
                                                const int* __restrict__ order, int E, int s,
                                                int lane) {
  int lo = 0, hi = E;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int len = hi - lo;
    // probes lo + ceil-spaced points up to hi - 1, clamped to [lo, hi)
    const int q = lo + max((int)(((long long)(lane + 1) * len) >> 5) - 1, 0);
    const bool below = kd[order[q]] < s;
    const unsigned m = __ballot_sync(0xffffffffu, below);
    const int c = __popc(m);  // the probes below s are a prefix
    const int q_last = __shfl_sync(0xffffffffu, q, c > 0 ? c - 1 : 0);
    const int q_next = __shfl_sync(0xffffffffu, q, c < 32 ? c : 31);
    if (c == 32) {
      lo = hi;
    } else {
      if (c > 0) lo = q_last + 1;
      hi = q_next;
    }
  }
  return lo;
}

// T payload type, V values per vector load, J vectors per lane per pass
template <typename T, int V, int J>
__global__ void __launch_bounds__(32 * kWarps)
segsum_kernel(const T* __restrict__ payload, const int* __restrict__ kd,
              const int* __restrict__ order, float* __restrict__ out, int E, int K, int Md) {
  using R = typename Raw<V * (int)sizeof(T)>::T;
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= Md) return;
  const int lo = warp_lower_bound(kd, order, E, s, lane);
  const int NV = K / V;  // vectors per row
  for (int v0 = 0; v0 < NV; v0 += 32 * J) {  // column passes
    float acc[J][V];
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int i = 0; i < V; ++i) acc[j][i] = 0.f;
    for (int base = lo; base < E; base += 32) {
      const int i = base + lane;
      const int e = i < E ? order[i] : 0;
      const int k = i < E ? kd[e] : s + 1;
      const int rows = min(E - base, 32);  // rows that exist in this chunk
      int n = -1;                          // of which the run's (after the ballot)
      for (int r = 0; r < rows; r += kU) {
        const int lim = n < 0 ? rows : n;  // rows worth loading
        R buf[kU][J];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int er = __shfl_sync(0xffffffffu, e, (r + u) & 31);
          const R* row = reinterpret_cast<const R*>(payload + (size_t)er * K);
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const int c = v0 + lane + 32 * j;
            if (r + u < lim && c < NV) buf[u][j] = row[c];
          }
        }
        if (n < 0) n = __popc(__ballot_sync(0xffffffffu, k == s));
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          if (r + u < n) {
#pragma unroll
            for (int j = 0; j < J; ++j) {
              if (v0 + lane + 32 * j < NV) {
                float x[V];
                to_f32<T, V>(buf[u][j], x);
#pragma unroll
                for (int q = 0; q < V; ++q) acc[j][q] = __fadd_rn(acc[j][q], x[q]);
              }
            }
          }
        }
        if (r + kU >= n) break;  // the run ends in this group
      }
      if (n < 32) break;  // the run ends in this chunk
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = v0 + lane + 32 * j;
      if (c < NV) {
        float* o = out + (size_t)s * K + (size_t)c * V;
        if constexpr (V % 4 == 0) {
#pragma unroll
          for (int q = 0; q < V; q += 4)
            *reinterpret_cast<float4*>(o + q) =
                make_float4(acc[j][q], acc[j][q + 1], acc[j][q + 2], acc[j][q + 3]);
        } else if constexpr (V == 2) {
          *reinterpret_cast<float2*>(o) = make_float2(acc[j][0], acc[j][1]);
        } else {
          o[0] = acc[j][0];
        }
      }
    }
  }
}

template <typename T, int V, int J>
int run(const void* payload, const void* kd, const void* order, void* out, int E, int K, int Md,
        cudaStream_t stream) {
  segsum_kernel<T, V, J><<<(Md + kWarps - 1) / kWarps, 32 * kWarps, 0, stream>>>(
      (const T*)payload, (const int*)kd, (const int*)order, (float*)out, E, K, Md);
  return (int)cudaGetLastError();
}

// J: enough vectors per lane to cover the row in one pass, up to 4
template <typename T, int V>
int launch_v(const void* payload, const void* kd, const void* order, void* out, int E, int K,
             int Md, cudaStream_t stream) {
  const int NV = K / V;
  if (NV <= 32) return run<T, V, 1>(payload, kd, order, out, E, K, Md, stream);
  if (NV <= 64) return run<T, V, 2>(payload, kd, order, out, E, K, Md, stream);
  if (NV <= 96) return run<T, V, 3>(payload, kd, order, out, E, K, Md, stream);
  return run<T, V, 4>(payload, kd, order, out, E, K, Md, stream);  // passes beyond 128
}

// the widest vector (V values) that divides the row and fits the pointers'
// alignment: 16 bytes of bf16 or f32 payload where it can
template <typename T>
int launch(const void* payload, const void* kd, const void* order, void* out, int E, int K,
           int Md, cudaStream_t stream) {
  const auto fits = [&](int v) {
    return K % v == 0 && (uintptr_t)payload % (v * sizeof(T)) == 0 &&
           (uintptr_t)out % (4 * (v < 4 ? v : 4)) == 0;
  };
  if constexpr (sizeof(T) == 2) {
    if (fits(8)) return launch_v<T, 8>(payload, kd, order, out, E, K, Md, stream);
  }
  if (fits(4)) return launch_v<T, 4>(payload, kd, order, out, E, K, Md, stream);
  if (fits(2)) return launch_v<T, 2>(payload, kd, order, out, E, K, Md, stream);
  return launch_v<T, 1>(payload, kd, order, out, E, K, Md, stream);
}

}  // namespace

// is_bf16: payload bf16 (else f32); out f32 [Md, K]
extern "C" int dpvo_segment_sum(const void* payload, const void* kd, const void* order, void* out,
                                int E, int K, int Md, int is_bf16, void* stream) {
  if (Md <= 0 || K <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch<__nv_bfloat16>(payload, kd, order, out, E, K, Md, st)
                 : launch<float>(payload, kd, order, out, E, K, Md, st);
}
