// Deterministic sorted segment sum, for Hopper: the BA depth-block
// reduction, SoftAgg's grouped sums and the global BA's seven reductions.
//
// Replaces the TPU kernel dpvo_tpu/ba/segsum_pallas.py:_make_kernel
// (launched by segment_sum_sorted at :68; call site ba/solver.py:209-218):
// out[s, :] = sum of payload[e, :] over the edges e whose id kd[e] == s,
// for s in [0, Md), in f32. The payload is f32 (BA: rows [E, K = 6W+2] of
// the pose-depth coupling, the depth Hessian and the gradient; the global
// BA: K = 2, 6 and 36) or bf16 (SoftAgg: [E, 2 * DIM] rows of the module
// dtype, as the JAX one-hot matmul takes them); a bf16 value converts to
// f32 exactly, so both are one function. Ids outside [0, Md) are dropped.
//
// Summation order (ba/segsum.py states it for the plain version too): a
// segment's rows, in sorted order, are cut into pieces of `chunk` rows
// counted from the run's first row; each piece is summed row after row
// from 0.0f with plain f32 adds (no atomics, no tree, no FMA), and the
// pieces' sums are added in piece order. A run of at most `chunk` rows is
// the sequential sum, bit for bit what index_add_ gives on the CPU.
//
// What bounds it on an H100: memory. It reads the payload once (19 MB
// for BA at E = 49152, K = 98 f32; 63 MB for SoftAgg at E = 40960, K = 768
// bf16; ~0.45 GB for a global-BA iteration, most of it the [KP, 36] kpair
// products) and writes Md x K floats; the adds are negligible. BA's and
// SoftAgg's runs are short (~15-20 rows per depth variable, 96 per frame
// pair), so the latency of finding a run and of the first loads matters as
// much as the bytes; the global BA's runs are thousands of rows long, and
// there a walk of the whole run by one warp left the card idle.
//
// Design. ``order`` is the stable argsort of ``kd`` (the host ships it, as
// for the TPU kernel), so the edges of segment s are the contiguous run of
// the sorted id sequence kd[order[.]] equal to s. One launch, one warp per
// work item, four items per block, no block barrier; the first blocks take
// the tiles' items, the rest the segments' (a role by block, a branch the
// compiler sees to be uniform: with the roles split by warp, the segments'
// walk ran markedly slower on an H100, short runs included). Items:
// - one per tile of `chunk` sorted positions: the tile's continuation
//   piece, the piece p >= 1 of a run that starts in the tile. At most one
//   starts there, that of the segment holding the tile's first position
//   (the piece's run covers the `chunk` positions before its start). Two
//   probes around the tile's start rule most tiles out in one round of
//   loads; otherwise the warp finds the run's start and sums the piece into
//   the partial row of its tile;
// - one per segment: its first piece, written to out[s] (zeros for an
//   empty segment). A run of at most `chunk` rows ends there.
// A long run's pieces arrive on an integer counter of the tile where the
// run starts (at most one long run starts in a tile): each piece adds 1,
// the piece that reaches the run's end adds n << 32 + 1 (it knows the
// count n), and the warp whose add completes the count (low word == high
// word) adds out[s] and the partial rows in piece order, writes out[s] and
// zeroes the counter for the next launch. Which warp that is varies; the
// sum does not.
// Finding a run's start: a 32-way search, each round's lanes probing 32
// points of the interval at once (4 rounds at E = 49152, where a binary
// search takes 16 dependent steps); the probes include the interval's last
// point, so the trailing empty segments finish in one round.
// Walking a piece: 32 sorted positions at a time, one coalesced load of
// order[], then every lane's kd[order[.]] and, without waiting for them,
// the payload rows, each a coalesced load of 16, 8, 4 or 2-byte vectors
// (the widest that the row length and the pointer's alignment allow); a
// ballot of kd == s says how many of the rows belong to the run (they come
// first, the ids being sorted). Rows of NV <= 16 vectors (the global BA's
// K = 2, 6 and 36) leave most lanes idle, so P = 32 / NV row groups of
// lanes load P rows at once and the column's owner lane takes them in
// order by shuffle: more rows in flight per warp, the same order of adds;
// a segment's first 32 rows take one row a step, as its run may be short.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // work items per block
constexpr int kU = 8;      // payload rows whose loads are in flight together (P = 1)
constexpr unsigned kAll = 0xffffffffu;

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

// a loaded vector from lane src
template <typename R>
__device__ __forceinline__ R shfl_raw(const R& r, int src) {
  if constexpr (sizeof(R) == 2) {
    return (R)__shfl_sync(kAll, (unsigned)r, src);
  } else {
    R out;
    const unsigned* a = reinterpret_cast<const unsigned*>(&r);
    unsigned* b = reinterpret_cast<unsigned*>(&out);
#pragma unroll
    for (int w = 0; w < (int)(sizeof(R) / 4); ++w) b[w] = __shfl_sync(kAll, a[w], src);
    return out;
  }
}

// V f32 values to o, and from o through L2 (another warp wrote them)
template <int V>
__device__ __forceinline__ void store_f32(float* o, const float (&a)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int q = 0; q < V; q += 4)
      *reinterpret_cast<float4*>(o + q) = make_float4(a[q], a[q + 1], a[q + 2], a[q + 3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(o) = make_float2(a[0], a[1]);
  } else {
    o[0] = a[0];
  }
}

template <int V>
__device__ __forceinline__ void load_f32_cg(const float* o, float (&a)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int q = 0; q < V; q += 4) {
      const float4 f = __ldcg(reinterpret_cast<const float4*>(o + q));
      a[q] = f.x, a[q + 1] = f.y, a[q + 2] = f.z, a[q + 3] = f.w;
    }
  } else if constexpr (V == 2) {
    const float2 f = __ldcg(reinterpret_cast<const float2*>(o));
    a[0] = f.x, a[1] = f.y;
  } else {
    a[0] = __ldcg(o);
  }
}

// first position i in [lo, hi] with kd[order[i]] >= s, given that the ids
// before lo are below s and that hi == E or its id is at least s (the
// sorted ids are non-decreasing); all lanes return it
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ kd,
                                                const int* __restrict__ order, int lo, int hi,
                                                int s, int lane) {
  while (lo < hi) {
    const int len = hi - lo;
    // probes lo + ceil-spaced points up to hi - 1, clamped to [lo, hi)
    const int q = lo + max((int)(((long long)(lane + 1) * len) >> 5) - 1, 0);
    const bool below = kd[order[q]] < s;
    const unsigned m = __ballot_sync(kAll, below);
    const int c = __popc(m);  // the probes below s are a prefix
    const int q_last = __shfl_sync(kAll, q, c > 0 ? c - 1 : 0);
    const int q_next = __shfl_sync(kAll, q, c < 32 ? c : 31);
    if (c == 32) {
      lo = hi;
    } else {
      if (c > 0) lo = q_last + 1;
      hi = q_next;
    }
  }
  return lo;
}

// Adds, in sorted order, the rows of segment s among the 32 sorted
// positions from base (those before limit; the run may end sooner) to this
// lane's columns of column pass v0; returns the number of rows added (32:
// the run may go on). P row groups of NV lanes (P > 1: one pass, J == 1);
// the columns' owners are the lanes of group 0, lane c owning column c
// whatever P is.
template <typename T, int V, int J, int P>
__device__ __forceinline__ int sum_chunk(const T* __restrict__ payload,
                                         const int* __restrict__ kd,
                                         const int* __restrict__ order, int K, int NV, int v0,
                                         int base, int limit, int s, int lane,
                                         float (&acc)[J][V]) {
  using R = typename Raw<V * (int)sizeof(T)>::T;
  constexpr int U = P == 1 ? kU : (32 + P - 1) / P;  // loads per lane, U * P >= 32 rows
  const int grp = P == 1 ? 0 : lane / NV;
  const int col = lane - grp * NV;
  const int i = base + lane;
  const int e = i < limit ? order[i] : 0;
  const int k = i < limit ? kd[e] : -1;    // s >= 0
  const int rows = min(limit - base, 32);  // rows that exist in this chunk
  int n = -1;                              // of which the run's (after the ballot)
  for (int r = 0; r < rows; r += U * P) {
    const int lim = n < 0 ? rows : n;  // rows worth loading
    R buf[U][J];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int ri = r + u * P + grp;
      const int er = __shfl_sync(kAll, e, ri & 31);
      const R* row = reinterpret_cast<const R*>(payload + (size_t)er * K);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = v0 + col + 32 * j;
        if (grp < P && ri < lim && c < NV) buf[u][j] = row[c];
      }
    }
    if (n < 0) n = __popc(__ballot_sync(kAll, k == s));
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if constexpr (P == 1) {
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
      } else {
#pragma unroll
        for (int g = 0; g < P; ++g) {
          if (r + u * P + g < n) {  // warp-uniform
            const R v = shfl_raw(buf[u][0], g * NV + col);
            if (grp == 0) {
              float x[V];
              to_f32<T, V>(v, x);
#pragma unroll
              for (int q = 0; q < V; ++q) acc[0][q] = __fadd_rn(acc[0][q], x[q]);
            }
          }
        }
      }
    }
    if (r + U * P >= n) break;  // the run ends in this group
  }
  return n;
}

// The rows of segment s at sorted positions [start, limit), the run may
// end sooner, added in order to this lane's columns of pass v0; returns
// the number of rows added. A segment's first chunk takes P = 1 (its run
// may be a few rows: P row groups would load 32), a chunk after a full one
// P row groups (kPackFirst: the first chunk too)
template <typename T, int V, int J, int P, bool kPackFirst>
__device__ __forceinline__ int sum_piece(const T* __restrict__ payload,
                                         const int* __restrict__ kd,
                                         const int* __restrict__ order, int K, int NV, int v0,
                                         int start, int limit, int s, int lane,
                                         float (&acc)[J][V]) {
  int taken = 0;
  for (int base = start; base < limit; base += 32) {
    const int n = kPackFirst || base != start
                      ? sum_chunk<T, V, J, P>(payload, kd, order, K, NV, v0, base, limit, s,
                                              lane, acc)
                      : sum_chunk<T, V, J, 1>(payload, kd, order, K, NV, v0, base, limit, s,
                                              lane, acc);
    taken += n;
    if (n < 32) break;  // the run ends in this chunk
  }
  return taken;
}

// sum_piece over every column pass, each pass's sums stored to dst (a row
// of K floats); returns the rows summed
template <typename T, int V, int J, int P, bool kPackFirst>
__device__ __forceinline__ int sum_piece_to(const T* __restrict__ payload,
                                            const int* __restrict__ kd,
                                            const int* __restrict__ order, float* dst, int K,
                                            int NV, int start, int limit, int s, int lane) {
  const int grp = P == 1 ? 0 : lane / NV;
  const int col = lane - grp * NV;
  int taken = 0;
  for (int v0 = 0; v0 < NV; v0 += 32 * J) {  // column passes
    float acc[J][V];
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int q = 0; q < V; ++q) acc[j][q] = 0.f;
    taken = sum_piece<T, V, J, P, kPackFirst>(payload, kd, order, K, NV, v0, start, limit, s,
                                             lane, acc);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = v0 + col + 32 * j;
      if (grp == 0 && c < NV) store_f32<V>(dst + (size_t)c * V, acc[j]);
    }
  }
  return taken;
}

// A long run's piece, summed into dst (out[s] for piece 0, else its tile's
// partial row): counts it in on the counter of the run's first tile, and
// the warp that completes the count writes out[s] = ((piece 0 + piece 1)
// + piece 2) + ... and zeroes the counter
template <int V, int J, int P>
__device__ __noinline__ void finish_long_run(float* __restrict__ out,
                                             const float* __restrict__ partials,
                                             unsigned long long* arrivals, int s, int lo,
                                             int piece, bool more, int K, int NV, int chunk,
                                             int lane) {
  const int grp = P == 1 ? 0 : lane / NV;
  const int col = lane - grp * NV;
  // each piece adds 1; the piece that reaches the run's end, n << 32 + 1
  const unsigned long long add = more ? 1ull : ((unsigned long long)(piece + 1) << 32) + 1ull;
  unsigned long long* counter = arrivals + lo / chunk;
  __threadfence();
  __syncwarp();
  unsigned long long now = 0;
  if (lane == 0) now = atomicAdd(counter, add) + add;
  now = __shfl_sync(kAll, now, 0);
  const unsigned n = (unsigned)(now >> 32);
  if (n == 0 || (unsigned)now != n) return;  // pieces still out
  __threadfence();
  if (lane == 0) *counter = 0ull;
  float* o = out + (size_t)s * K;
  const float* part = partials + (size_t)(lo / chunk) * K;  // piece p's row: part + p * K
  for (int v0 = 0; v0 < NV; v0 += 32 * J) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = v0 + col + 32 * j;
      if (grp != 0 || c >= NV) continue;
      float a[V];
      load_f32_cg<V>(o + (size_t)c * V, a);
      for (int p = 1; p < (int)n; p += 8) {
        float x[8][V];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (p + u < (int)n) load_f32_cg<V>(part + (size_t)(p + u) * K + (size_t)c * V, x[u]);
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (p + u < (int)n)
#pragma unroll
            for (int q = 0; q < V; ++q) a[q] = __fadd_rn(a[q], x[u][q]);
      }
      store_f32<V>(o + (size_t)c * V, a);
    }
  }
}

// Tile `tile`'s continuation piece, if one starts there: the piece p >= 1
// of the run holding the tile's first position, summed into the tile's
// partial row, then counted in
template <typename T, int V, int J, int P>
__device__ __noinline__ void continuation_piece(const T* __restrict__ payload,
                                                const int* __restrict__ kd,
                                                const int* __restrict__ order,
                                                float* __restrict__ out,
                                                float* __restrict__ partials,
                                                unsigned long long* arrivals, int E, int K,
                                                int Md, int chunk, int tile, int lane) {
  const int p0 = tile * chunk;
  if (p0 == 0) return;
  // a continuation piece's run holds p0 - 1, p0 and one of the probes
  // p0 - 1 -+ chunk / 2 (the one on the side of the piece's start)
  const int probe = lane == 0 ? p0 - 1 : lane == 1 ? p0 : lane == 2 ? p0 - 1 - chunk / 2
                                                                    : p0 - 1 + chunk / 2;
  const int id = lane < 4 && probe >= 0 && probe < E ? kd[order[probe]] : -1;
  const int s = __shfl_sync(kAll, id, 1);
  if (s < 0 || s >= Md || __shfl_sync(kAll, id, 0) != s ||
      (__shfl_sync(kAll, id, 2) != s && __shfl_sync(kAll, id, 3) != s))
    return;
  const int lo = warp_lower_bound(kd, order, 0, p0 - 1, s, lane);
  const int start = lo + (p0 - lo + chunk - 1) / chunk * chunk;  // in this tile
  const int limit = min(start + chunk, E);
  const int taken = sum_piece_to<T, V, J, P, true>(
      payload, kd, order, partials + (size_t)tile * K, K, K / V, start, limit, s, lane);
  if (taken == 0) return;  // the run ends before the piece would start
  // only a full piece can go on
  const bool more = taken == chunk && limit < E && kd[order[limit]] == s;
  finish_long_run<V, J, P>(out, partials, arrivals, s, lo, (start - lo) / chunk, more, K, K / V,
                           chunk, lane);
}

// T payload type, V values per vector load, J vectors per lane per pass,
// P row groups per warp. Blocks [0, tile_blocks): the tiles' continuation
// pieces; then a warp per segment: its first piece
template <typename T, int V, int J, int P>
__global__ void __launch_bounds__(32 * kWarps)
segsum_kernel(const T* __restrict__ payload, const int* __restrict__ kd,
              const int* __restrict__ order, float* __restrict__ out,
              float* __restrict__ partials, unsigned long long* arrivals, int E, int K, int Md,
              int chunk, int tiles, int tile_blocks) {
  const int lane = threadIdx.x & 31;
  if ((int)blockIdx.x < tile_blocks) {
    const int tile = blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (tile < tiles)
      continuation_piece<T, V, J, P>(payload, kd, order, out, partials, arrivals, E, K, Md,
                                     chunk, tile, lane);
    return;
  }
  const int s = (blockIdx.x - tile_blocks) * kWarps + (threadIdx.x >> 5);
  if (s >= Md) return;
  const int lo = warp_lower_bound(kd, order, 0, E, s, lane);
  const int limit = min(lo + chunk, E);
  const int taken = sum_piece_to<T, V, J, P, false>(
      payload, kd, order, out + (size_t)s * K, K, K / V, lo, limit, s, lane);
  // a run of at most chunk rows ends here: out[s] is its sum
  if (taken == chunk && limit < E && kd[order[limit]] == s)
    finish_long_run<V, J, P>(out, partials, arrivals, s, lo, 0, true, K, K / V, chunk, lane);
}

struct Args {
  const void* payload;
  const int* kd;
  const int* order;
  float* out;
  float* partials;
  unsigned long long* arrivals;
  int E, K, Md, chunk;
  cudaStream_t stream;
};

template <typename T, int V, int J, int P>
int run(const Args& a) {
  const int tiles = (a.E + a.chunk - 1) / a.chunk;
  const int tile_blocks = (tiles + kWarps - 1) / kWarps;
  const long long blocks = (long long)tile_blocks + (a.Md + kWarps - 1) / kWarps;
  segsum_kernel<T, V, J, P><<<(unsigned)blocks, 32 * kWarps, 0, a.stream>>>(
      (const T*)a.payload, a.kd, a.order, a.out, a.partials, a.arrivals, a.E, a.K, a.Md, a.chunk,
      tiles, tile_blocks);
  return (int)cudaGetLastError();
}

// J: enough vectors per lane to cover the row in one pass, up to 4; rows of
// at most 16 vectors: P = 32 / NV row groups (8 at most)
template <typename T, int V>
int launch_v(const Args& a) {
  const int NV = a.K / V;
  if (NV <= 4) return run<T, V, 1, 8>(a);
  if (NV <= 8) return run<T, V, 1, 4>(a);
  if (NV <= 10) return run<T, V, 1, 3>(a);
  if (NV <= 16) return run<T, V, 1, 2>(a);
  if (NV <= 32) return run<T, V, 1, 1>(a);
  if (NV <= 64) return run<T, V, 2, 1>(a);
  if (NV <= 96) return run<T, V, 3, 1>(a);
  return run<T, V, 4, 1>(a);  // passes beyond 128
}

// the widest vector (V values) that divides the row and fits the pointers'
// alignment: 16 bytes of bf16 or f32 payload where it can
template <typename T>
int launch(const Args& a) {
  const auto fits = [&](int v) {
    return a.K % v == 0 && (uintptr_t)a.payload % (v * sizeof(T)) == 0 &&
           (uintptr_t)a.out % (4 * (v < 4 ? v : 4)) == 0 &&
           (uintptr_t)a.partials % (4 * (v < 4 ? v : 4)) == 0;
  };
  if constexpr (sizeof(T) == 2) {
    if (fits(8)) return launch_v<T, 8>(a);
  }
  if (fits(4)) return launch_v<T, 4>(a);
  if (fits(2)) return launch_v<T, 2>(a);
  return launch_v<T, 1>(a);
}

}  // namespace

// is_bf16: payload bf16 (else f32); out f32 [Md, K]; partials f32 with room
// for ceil(E / chunk) rows of K; arrivals ceil(E / chunk) zeroed int64
// counters (left zeroed); chunk the rows of a piece (ba/segsum.CHUNK)
extern "C" int dpvo_segment_sum(const void* payload, const void* kd, const void* order, void* out,
                                void* partials, void* arrivals, int E, int K, int Md, int chunk,
                                int is_bf16, void* stream) {
  if (Md <= 0 || K <= 0) return (int)cudaGetLastError();
  const Args a{payload, (const int*)kd, (const int*)order, (float*)out, (float*)partials,
               (unsigned long long*)arrivals, E, K, Md, chunk, (cudaStream_t)stream};
  return is_bf16 ? launch<__nv_bfloat16>(a) : launch<float>(a);
}
