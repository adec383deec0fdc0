// Backward pass of the two-level patch correlation (exact windows) for
// Hopper: the gradients of the patch features (per edge, reduced into the
// gmap rows afterwards by the sorted segment sum) and of both feature maps.
//
// Replaces no TPU kernel: the JAX package trains through XLA's autodiff
// of dpvo_tpu/ops/corr.py:corr_features_xla (:287), and the port computes
// that function's forward with corr.cu, which has no gradient of its own.
// It computes dpvo_tpu_torch/ops/corr.py:corr_backward_plain: the map
// gradients bit for bit as that function computes them on the CPU, the
// patch gradients up to f32 summation order.
//
// Per edge e, level l (coords / 1, / 4), patch pixel p (9), window
// position (i, j) in 8 x 8 around (y0 - 3, x0 - 3):
//   G[l][p][i][j] = 0 + tap00 + tap01 + tap10 + tap11 (in that order),
//                   tap_ab = (wy_a * wx_b) * g[e, p, l*64 + (i-a)*8 + (j-b)]
//                   for the taps with i - a, j - b < 7;
//   d f1[e][c][p] = sum_l sum_ij G * fmap_l[jj, y, x, c]
//   d fmap_l[jj, y, x, c] = sum over (e, p) ascending of G * f1[e][c][p]
// Edges with valid == 0 (or ii1 / jj1 out of range) write d f1 = 0 and add
// nothing; so does a pixel with non-finite coordinates.
//
// Two kernels, no atomics: every output is a fixed function of the inputs.
//
// corr_bwd_f1_kernel, one block of 192 threads per edge: spreads g over
// each pixel's window into shared memory (G, 2 x 9 x 64 floats) and writes,
// per (level, pixel), the window (corner and bilinear fractions) and, per
// level, the union of the windows clipped to the map, for the map kernel.
// Then d f1: bf16 features with C = 128 (the training path) stage the
// union of the 9 windows (at most kUS x kUS positions, off the map zero) in
// shared memory once per level, and each thread takes a channel pair and
// a third of the pixels: per pixel 64 positions at compile-time offsets, one
// 4-byte shared read and two FMAs each (walking the union and testing all 9
// windows at each position took 1.74 ms against 0.70 at the training shape
// on an H100); a union beyond kUS x kUS (pixels spread apart) reads its windows
// from global memory in the same mapping. f32 features and other C walk
// each pixel's window from global memory, one channel a thread.
//
// corr_bwd_map_kernel, one block of 256 threads per (level, frame slot,
// kTY x kTX tile of the map, slab of 128 channels): the block owns its
// tile and keeps it in registers (thread: one tile row, two channels, kTX
// columns), so the maps need no zero fill, no atomics and no cast pass:
// each position is written once, in the map's dtype. It walks the edges
// of its slot in jj1_order (a stable sort: ascending edge id): a ballot
// keeps, in order, the edges whose union overlaps the tile, then the
// pixels of those edges whose window overlaps it (per window, not the
// union, which for a spread patch covers tiles no window touches); for
// kBatch such (edge, pixel) items at a time it stages G (recomputed from g
// and the fractions) and f1 in shared memory, and each thread adds G * f1
// into the tile positions its row shares with the window (a switch on the
// window's column offset keeps the register indices static). Each add is
// acc = acc + (G * f1), product rounded first (__fmul_rn / __fadd_rn: no
// contraction into an FMA), from +0.0, in ascending (edge, pixel) order:
// the order and roundings of corr_backward_plain's index_add_ on the CPU,
// so the maps are bit for bit its maps (zero contributions, which the
// plain version adds where a window leaves the map, do not change an f32
// sum that starts from +0.0). One rounding to the map's dtype at the end.
// The kernel is bound by latency, so occupancy decides its time: it is
// held to 64 registers a thread so that 4 blocks share an SM: at the
// training shape it took 1.14 ms at 80 registers (3 blocks), 1.45 at 92
// (2 blocks) and 0.99 at 64 (PERF.md, row 8).
//
// What bounds it on an H100: the bytes the function must move (g, the
// features, coordinates and indices read once, the three gradients
// written once; ~0.2 GB at the training shape in bf16, ~0.06 ms at 3.35
// TB/s, chip_smoke.py's bound). Neither kernel is near it: each does ~2.7
// G multiply-adds (9 x 64 positions x C per edge and level), the map
// kernel's unfused to keep the plain version's roundings, on the CUDA
// cores, and the instructions around them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRadius = 3;
constexpr int kD = 8;                // window side (2r + 2)
constexpr int kOut = 7;              // bilinear output side (2r + 1)
constexpr int kP2 = 9;               // patch pixels
constexpr int kBlock = 2 * kD * kD;  // one pixel's 8 x 8 block per level in g: 128 values
constexpr int kOff = -32768;         // the corner of a window that adds nothing

constexpr int kGroups = 3;                          // pixel groups of the staged path
constexpr int kThreads = 64 * kGroups;              // a group: 64 threads, a channel pair each
constexpr int kPix = (kP2 + kGroups - 1) / kGroups;  // pixels a thread takes
constexpr int kUS = 12;                             // the staged union's side (positions)
constexpr int kC = 128;  // channels of the staged path (every shipped FDIM)

constexpr int kTY = 4, kTX = 16;            // the map kernel's tile: rows x columns
constexpr int kSlab = 128;                  // channels a map block owns
constexpr int kPairs = kSlab / 2;           // a thread takes two adjacent channels
constexpr int kMapThreads = kTY * kPairs;   // one tile row and one channel pair a thread
constexpr int kBatch = 32;                  // overlapping items staged at once
constexpr int kGroup = kMapThreads / kP2;   // edges whose pixels are tested at once

template <typename T> struct is_bf16 { static constexpr bool value = false; };
template <> struct is_bf16<__nv_bfloat16> { static constexpr bool value = true; };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

struct Window {
  float fx, fy;  // bilinear fractions
  int x0, y0;    // window corner (floor - r)
  bool fin;      // finite coordinates
};

// pixel p of edge e at level l, as corr_backward_plain computes it
__device__ __forceinline__ Window window(const float* __restrict__ coords, int e, int p, int l,
                                         int H, int W) {
  const float s = l ? 0.25f : 1.f;
  const float x = __fmul_rn(coords[((size_t)e * kP2 + p) * 2], s);
  const float y = __fmul_rn(coords[((size_t)e * kP2 + p) * 2 + 1], s);
  Window w;
  w.fin = isfinite(x) && isfinite(y);
  const float xf = floorf(fminf(fmaxf(w.fin ? x : 0.f, -64.f), (float)W + 64.f));
  const float yf = floorf(fminf(fmaxf(w.fin ? y : 0.f, -64.f), (float)H + 64.f));
  w.fx = __fsub_rn(x, xf);
  w.fy = __fsub_rn(y, yf);
  w.x0 = (int)xf - kRadius;
  w.y0 = (int)yf - kRadius;
  return w;
}

// G at window position (i, j): the plain version's four tap adds, in its order
template <typename TG>
__device__ __forceinline__ float spread(const TG* __restrict__ gp, float fx, float fy, int i,
                                        int j) {
  float acc = 0.f;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int u = i - a;
    if (u < 0 || u >= kOut) continue;
    const float wy = a ? fy : __fsub_rn(1.f, fy);
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int v = j - b;
      if (v < 0 || v >= kOut) continue;
      const float wx = b ? fx : __fsub_rn(1.f, fx);
      acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(wy, wx), to_f(gp[u * kD + v])));
    }
  }
  return acc;
}

template <typename TF, typename TG>
__global__ void __launch_bounds__(kThreads, 1)
corr_bwd_f1_kernel(const TG* __restrict__ g, const TF* __restrict__ fmap1,
                   const TF* __restrict__ fmap2, const float* __restrict__ coords,
                   const int* __restrict__ ii1, const int* __restrict__ jj1,
                   const bool* __restrict__ valid, float* __restrict__ df1,
                   int4* __restrict__ wins, short4* __restrict__ boxes, int Np, int mem, int C,
                   int H1, int W1, int H2, int W2) {
  __shared__ __align__(16) float G[2][kP2][kD * kD];
  __shared__ int sy[2][kP2], sx[2][kP2];  // window corners; kOff: a non-finite pixel
  __shared__ int ubox[2][4];              // union of the windows: y lo, y hi, x lo, x hi
  __shared__ __align__(16) uint32_t stage[kUS * kUS * (kC / 2)];  // one level's union, bf16 pairs
  const int e = blockIdx.x;
  const int tid = threadIdx.x;
  float* d1 = df1 + (size_t)e * C * kP2;
  const int row = ii1[e], fr = jj1[e];
  if (!valid[e] || row < 0 || row >= Np || fr < 0 || fr >= mem) {
    for (int k = tid; k < C * kP2; k += kThreads) d1[k] = 0.f;
    if (tid < 2 * kP2) wins[(size_t)e * 2 * kP2 + tid] = make_int4(kOff, kOff, 0, 0);
    if (tid < 2) boxes[(size_t)e * 2 + tid] = make_short4(32767, -32768, 32767, -32768);
    return;
  }

  // spread g over the windows: G[l][p][i][j]; each (level, pixel)'s window for the map kernel
  for (int k = tid; k < 2 * kP2 * kD * kD; k += kThreads) {
    const int l = k / (kP2 * kD * kD);
    const int p = (k / (kD * kD)) % kP2;
    const int i = (k / kD) % kD, j = k % kD;
    const int H = l ? H2 : H1, W = l ? W2 : W1;
    const Window w = window(coords, e, p, l, H, W);
    const int yy = w.y0 + i, xx = w.x0 + j;
    const bool ok = w.fin && yy >= 0 && yy < H && xx >= 0 && xx < W;
    G[l][p][i * kD + j] =
        ok ? spread(g + ((size_t)e * kP2 + p) * kBlock + l * kD * kD, w.fx, w.fy, i, j) : 0.f;
    if (i == 0 && j == 0) {
      // a non-finite pixel's corner lies off the map: it reads and adds nothing
      sy[l][p] = w.fin ? w.y0 : kOff;
      sx[l][p] = w.fin ? w.x0 : kOff;
      wins[((size_t)e * 2 + l) * kP2 + p] =
          w.fin ? make_int4(w.x0, w.y0, __float_as_int(w.fx), __float_as_int(w.fy))
                : make_int4(kOff, kOff, 0, 0);
    }
  }
  __syncthreads();
  if (tid < 2) {
    const int l = tid;
    const int H = l ? H2 : H1, W = l ? W2 : W1;
    int ylo = 1 << 30, yhi = -(1 << 30), xlo = 1 << 30, xhi = -(1 << 30);
    for (int p = 0; p < kP2; ++p) {
      if (sy[l][p] == kOff) continue;  // non-finite pixel
      ylo = min(ylo, sy[l][p]);
      yhi = max(yhi, sy[l][p] + kD - 1);
      xlo = min(xlo, sx[l][p]);
      xhi = max(xhi, sx[l][p] + kD - 1);
    }
    ubox[l][0] = ylo;
    ubox[l][1] = yhi;
    ubox[l][2] = xlo;
    ubox[l][3] = xhi;
    const int cy0 = max(ylo, 0), cy1 = min(yhi, H - 1), cx0 = max(xlo, 0), cx1 = min(xhi, W - 1);
    boxes[(size_t)e * 2 + l] = (cy0 <= cy1 && cx0 <= cx1)
        ? make_short4(cy0, cy1, cx0, cx1) : make_short4(32767, -32768, 32767, -32768);
  }
  __syncthreads();

  if (is_bf16<TF>::value && C == kC) {
    // a channel pair and the pixels p = grp, grp + kGroups, ... a thread
    const int cp = tid % (kC / 2), grp = tid / (kC / 2);
    float a0[kPix], a1[kPix];
#pragma unroll
    for (int q = 0; q < kPix; ++q) a0[q] = a1[q] = 0.f;
    for (int l = 0; l < 2; ++l) {
      const int H = l ? H2 : H1, W = l ? W2 : W1;
      const uint32_t* fm =
          reinterpret_cast<const uint32_t*>((l ? fmap2 : fmap1) + (size_t)fr * H * W * kC);
      const int ylo = ubox[l][0], yhi = ubox[l][1], xlo = ubox[l][2], xhi = ubox[l][3];
      if (ylo > yhi) continue;  // no finite pixel
      const int uh = yhi - ylo + 1, uw = xhi - xlo + 1;
      const bool staged = uh <= kUS && uw <= kUS;
      if (staged) {
        for (int k = tid; k < uh * uw * (kC / 8); k += kThreads) {
          const int pos = k / (kC / 8), part = k % (kC / 8);
          const int yy = ylo + pos / uw, xx = xlo + pos % uw;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (yy >= 0 && yy < H && xx >= 0 && xx < W)
            v = *reinterpret_cast<const uint4*>(fm + ((size_t)yy * W + xx) * (kC / 2) + part * 4);
          *reinterpret_cast<uint4*>(stage + ((yy - ylo) * kUS + (xx - xlo)) * (kC / 2) +
                                    part * 4) = v;
        }
        __syncthreads();
      }
#pragma unroll
      for (int q = 0; q < kPix; ++q) {
        const int p = grp + kGroups * q;
        if (p >= kP2 || sy[l][p] == kOff) continue;
        const float* Gp = G[l][p];
        if (staged) {
          const uint32_t* sp = stage + ((sy[l][p] - ylo) * kUS + (sx[l][p] - xlo)) * (kC / 2) + cp;
#pragma unroll
          for (int i = 0; i < kD; ++i) {
            const float4 ga = *reinterpret_cast<const float4*>(Gp + i * kD);
            const float4 gb = *reinterpret_cast<const float4*>(Gp + i * kD + 4);
            const float gr[kD] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
#pragma unroll
            for (int j = 0; j < kD; ++j) {
              const uint32_t u = sp[(i * kUS + j) * (kC / 2)];
              a0[q] = fmaf(gr[j], __uint_as_float(u << 16), a0[q]);
              a1[q] = fmaf(gr[j], __uint_as_float(u & 0xffff0000u), a1[q]);
            }
          }
        } else {
          for (int i = 0; i < kD; ++i) {
            const int y = sy[l][p] + i;
            if (y < 0 || y >= H) continue;
            for (int j = 0; j < kD; ++j) {
              const int x = sx[l][p] + j;
              if (x < 0 || x >= W) continue;
              const uint32_t u = fm[((size_t)y * W + x) * (kC / 2) + cp];
              a0[q] = fmaf(Gp[i * kD + j], __uint_as_float(u << 16), a0[q]);
              a1[q] = fmaf(Gp[i * kD + j], __uint_as_float(u & 0xffff0000u), a1[q]);
            }
          }
        }
      }
      if (staged) __syncthreads();  // the next level rewrites the stage
    }
#pragma unroll
    for (int q = 0; q < kPix; ++q) {
      const int p = grp + kGroups * q;
      if (p >= kP2) continue;
      d1[(2 * cp) * kP2 + p] = a0[q];
      d1[(2 * cp + 1) * kP2 + p] = a1[q];
    }
    return;
  }

  for (int c = tid; c < C; c += kThreads) {
    float acc[kP2];
#pragma unroll
    for (int p = 0; p < kP2; ++p) acc[p] = 0.f;
    for (int l = 0; l < 2; ++l) {
      const int H = l ? H2 : H1, W = l ? W2 : W1;
      const TF* fm = (l ? fmap2 : fmap1) + (size_t)fr * H * W * C + c;
#pragma unroll 1
      for (int p = 0; p < kP2; ++p) {
        if (sy[l][p] == kOff) continue;
        for (int i = 0; i < kD; ++i) {
          const int y = sy[l][p] + i;
          if (y < 0 || y >= H) continue;
          for (int j = 0; j < kD; ++j) {
            const int x = sx[l][p] + j;
            if (x < 0 || x >= W) continue;
            acc[p] += G[l][p][i * kD + j] * to_f(fm[((size_t)y * W + x) * C]);
          }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kP2; ++p) d1[c * kP2 + p] = acc[p];
  }
}

// acc[k] += G row value at column k - DX times f, for the columns the
// window (8 wide, DX columns right of the tile's first) shares with the
// tile, for two channels
template <int DX>
__device__ __forceinline__ void add_row_at(float (&a0)[kTX], float (&a1)[kTX],
                                           const float (&gr)[kD], float f0, float f1) {
#pragma unroll
  for (int k = 0; k < kTX; ++k) {
    const int j = k - DX;
    if (j >= 0 && j < kD) {
      a0[k] = __fadd_rn(a0[k], __fmul_rn(gr[j], f0));
      a1[k] = __fadd_rn(a1[k], __fmul_rn(gr[j], f1));
    }
  }
}

__device__ __forceinline__ void add_row(float (&a0)[kTX], float (&a1)[kTX], const float (&gr)[kD],
                                        float f0, float f1, int dx) {
  static_assert(kTX == 16 && kD == 8, "the switch lists the offsets -7 ... 15");
  switch (dx) {
#define DPVO_ROW(d) \
  case d:           \
    add_row_at<d>(a0, a1, gr, f0, f1); \
    break;
    DPVO_ROW(-7) DPVO_ROW(-6) DPVO_ROW(-5) DPVO_ROW(-4) DPVO_ROW(-3) DPVO_ROW(-2) DPVO_ROW(-1)
    DPVO_ROW(0) DPVO_ROW(1) DPVO_ROW(2) DPVO_ROW(3) DPVO_ROW(4) DPVO_ROW(5) DPVO_ROW(6)
    DPVO_ROW(7) DPVO_ROW(8) DPVO_ROW(9) DPVO_ROW(10) DPVO_ROW(11) DPVO_ROW(12) DPVO_ROW(13)
    DPVO_ROW(14) DPVO_ROW(15)
#undef DPVO_ROW
    default:
      break;
  }
}

// Block-wide ordered compaction: the number of threads with hit set, and
// (in pos) this thread's rank among them in thread order.
__device__ __forceinline__ int compact(bool hit, int* s_warp, int& pos) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned m = __ballot_sync(0xffffffffu, hit);
  if (lane == 0) s_warp[warp] = __popc(m);
  __syncthreads();
  int off = 0, n = 0;
#pragma unroll
  for (int w = 0; w < kMapThreads / 32; ++w) {
    const int v = s_warp[w];
    off += w < warp ? v : 0;
    n += v;
  }
  pos = off + __popc(m & ((1u << lane) - 1u));
  return n;
}

template <typename TF, typename TG>
__global__ void __launch_bounds__(kMapThreads, 4)
corr_bwd_map_kernel(const TG* __restrict__ g, const TF* __restrict__ gmap,
                    const int* __restrict__ ii1, const int* __restrict__ jj1_order,
                    const int* __restrict__ starts, const int4* __restrict__ wins,
                    const short4* __restrict__ boxes, TF* __restrict__ dfm1,
                    TF* __restrict__ dfm2, int mem, int C, int H1, int W1, int H2, int W2) {
  __shared__ int s_edge[kMapThreads];  // a chunk's edges whose union overlaps the tile
  __shared__ int s_e[kMapThreads];     // their (edge, pixel) items whose window does: edge,
  __shared__ int s_p[kMapThreads];     // pixel,
  __shared__ int s_row[kMapThreads];   // gmap row,
  __shared__ int4 s_w[kMapThreads];    // window (x0, y0, fx, fy)
  __shared__ int s_warp[kMapThreads / 32];
  __shared__ __align__(16) float s_G[kBatch][kD * kD];
  __shared__ float2 s_f1[kBatch][kPairs];

  // block -> (level, slot, tile); level 2's tiles first: each overlaps ~16x
  // the windows of a level-1 tile, so they start in the first wave
  const int th1 = (H1 + kTY - 1) / kTY, tw1 = (W1 + kTX - 1) / kTX;
  const int th2 = (H2 + kTY - 1) / kTY, tw2 = (W2 + kTX - 1) / kTX;
  int b = blockIdx.x, l;
  if (b < mem * th2 * tw2) {
    l = 1;
  } else {
    l = 0;
    b -= mem * th2 * tw2;
  }
  const int nt = l ? th2 * tw2 : th1 * tw1, tw = l ? tw2 : tw1;
  const int H = l ? H2 : H1, W = l ? W2 : W1;
  const int f = b / nt, t = b % nt;
  const int ty0 = (t / tw) * kTY, tx0 = (t % tw) * kTX;
  const int ty1 = min(ty0 + kTY, H) - 1, tx1 = min(tx0 + kTX, W) - 1;  // inclusive, on the map
  const int tid = threadIdx.x;
  const int r = tid / kPairs, cp = tid % kPairs, c = blockIdx.y * kSlab + 2 * cp;

  float a0[kTX], a1[kTX];
#pragma unroll
  for (int k = 0; k < kTX; ++k) a0[k] = a1[k] = 0.f;

  const int beg = starts[f], nedge = starts[f + 1] - beg;
  for (int k0 = 0; k0 < nedge; k0 += kMapThreads) {
    // the edges whose union overlaps the tile, in order
    bool hit = false;
    int e = 0, pos;
    if (k0 + tid < nedge) {
      e = jj1_order[beg + k0 + tid];
      const short4 bx = boxes[(size_t)e * 2 + l];
      hit = bx.x <= ty1 && bx.y >= ty0 && bx.z <= tx1 && bx.w >= tx0;
    }
    const int ne = compact(hit, s_warp, pos);
    if (hit) s_edge[pos] = e;
    __syncthreads();
    for (int g0 = 0; g0 < ne; g0 += kGroup) {
      // their pixels whose window overlaps the tile, in (edge, pixel) order
      const int ng = min(kGroup, ne - g0);
      bool on = false;
      int p = 0, row = 0;
      int4 w = make_int4(kOff, kOff, 0, 0);
      if (tid < ng * kP2) {
        e = s_edge[g0 + tid / kP2];
        p = tid % kP2;
        w = wins[((size_t)e * 2 + l) * kP2 + p];
        row = ii1[e];
        on = w.y <= ty1 && w.y + kD > ty0 && w.x <= tx1 && w.x + kD > tx0;
      }
      const int n = compact(on, s_warp, pos);
      if (on) {
        s_e[pos] = e;
        s_p[pos] = p;
        s_row[pos] = row;
        s_w[pos] = w;
      }
      __syncthreads();
      for (int b0 = 0; b0 < n; b0 += kBatch) {
        const int nb = min(kBatch, n - b0);
        for (int k = tid; k < nb * kD * kD; k += kMapThreads) {
          const int q = k / (kD * kD), ij = k % (kD * kD);
          const int4 wq = s_w[b0 + q];
          s_G[q][ij] = spread(g + ((size_t)s_e[b0 + q] * kP2 + s_p[b0 + q]) * kBlock +
                                  l * kD * kD,
                              __int_as_float(wq.z), __int_as_float(wq.w), ij / kD, ij % kD);
        }
        for (int k = tid; k < nb * kPairs; k += kMapThreads) {
          const int q = k / kPairs, cc = blockIdx.y * kSlab + 2 * (k % kPairs);
          const TF* gp = gmap + ((size_t)s_row[b0 + q] * C + cc) * kP2 + s_p[b0 + q];
          s_f1[q][k % kPairs] = cc < C ? make_float2(to_f(gp[0]), to_f(gp[kP2]))
                                       : make_float2(0.f, 0.f);
        }
        __syncthreads();
        if (c < C) {
          for (int q = 0; q < nb; ++q) {
            const int4 wq = s_w[b0 + q];
            const int i = ty0 + r - wq.y;  // this thread's row in the window
            if (i < 0 || i >= kD) continue;
            const float4 ga = *reinterpret_cast<const float4*>(&s_G[q][i * kD]);
            const float4 gb = *reinterpret_cast<const float4*>(&s_G[q][i * kD + 4]);
            const float gr[kD] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
            const float2 fq = s_f1[q][cp];
            add_row(a0, a1, gr, fq.x, fq.y, wq.x - tx0);
          }
        }
        __syncthreads();
      }
    }
  }

  const int y = ty0 + r;
  if (c < C && y < H) {
    TF* out = (l ? dfm2 : dfm1) + (((size_t)f * H + y) * W + tx0) * C + c;
#pragma unroll
    for (int k = 0; k < kTX; ++k)
      if (tx0 + k < W) store2(out + (size_t)k * C, a0[k], a1[k]);
  }
}

template <typename TF, typename TG>
int launch_f1(const void* g, const void* fmap1, const void* fmap2, const void* coords,
              const void* ii1, const void* jj1, const void* valid, void* df1, void* wins,
              void* boxes, int E, int Np, int mem, int C, int H1, int W1, int H2, int W2,
              cudaStream_t stream) {
  corr_bwd_f1_kernel<TF, TG><<<E, kThreads, 0, stream>>>(
      (const TG*)g, (const TF*)fmap1, (const TF*)fmap2, (const float*)coords, (const int*)ii1,
      (const int*)jj1, (const bool*)valid, (float*)df1, (int4*)wins, (short4*)boxes, Np, mem, C,
      H1, W1, H2, W2);
  return (int)cudaGetLastError();
}

template <typename TF, typename TG>
int launch_maps(const void* g, const void* gmap, const void* ii1, const void* jj1_order,
                const void* starts, const void* wins, const void* boxes, void* dfm1, void* dfm2,
                int mem, int C, int H1, int W1, int H2, int W2, cudaStream_t stream) {
  const int tiles = ((H1 + kTY - 1) / kTY) * ((W1 + kTX - 1) / kTX)
                    + ((H2 + kTY - 1) / kTY) * ((W2 + kTX - 1) / kTX);
  const dim3 grid(mem * tiles, (C + kSlab - 1) / kSlab);
  corr_bwd_map_kernel<TF, TG><<<grid, kMapThreads, 0, stream>>>(
      (const TG*)g, (const TF*)gmap, (const int*)ii1, (const int*)jj1_order, (const int*)starts,
      (const int4*)wins, (const short4*)boxes, (TF*)dfm1, (TF*)dfm2, mem, C, H1, W1, H2, W2);
  return (int)cudaGetLastError();
}

}  // namespace

// g [E, 9, 128] (bf16 or f32: g_bf16); fmap1 [mem, H1, W1, C], fmap2 [mem, H2, W2, C] (bf16 or
// f32: feat_bf16); coords [E, 9, 2] f32 at level-1 scale; ii1, jj1 int32, valid bool [E]. Writes
// df1 [E, C, 9] f32 and, for dpvo_corr_backward_maps, wins [E, 2, 9] int4 (x0, y0, fx, fy bits;
// x0 = y0 = -32768 where a pixel adds nothing) and boxes [E, 2] short4 (the union of the windows
// clipped to the map: y lo, y hi, x lo, x hi; empty where the edge adds nothing).
extern "C" int dpvo_corr_backward(const void* g, const void* fmap1, const void* fmap2,
                                  const void* coords, const void* ii1, const void* jj1,
                                  const void* valid, void* df1, void* wins, void* boxes, int E,
                                  int Np, int mem, int C, int H1, int W1, int H2, int W2,
                                  int feat_bf16, int g_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (E <= 0) return (int)cudaGetLastError();
  if (C <= 0) return (int)cudaErrorInvalidValue;
  if (feat_bf16 && g_bf16)
    return launch_f1<__nv_bfloat16, __nv_bfloat16>(g, fmap1, fmap2, coords, ii1, jj1, valid, df1,
                                                   wins, boxes, E, Np, mem, C, H1, W1, H2, W2, s);
  if (feat_bf16)
    return launch_f1<__nv_bfloat16, float>(g, fmap1, fmap2, coords, ii1, jj1, valid, df1, wins,
                                           boxes, E, Np, mem, C, H1, W1, H2, W2, s);
  if (g_bf16)
    return launch_f1<float, __nv_bfloat16>(g, fmap1, fmap2, coords, ii1, jj1, valid, df1, wins,
                                           boxes, E, Np, mem, C, H1, W1, H2, W2, s);
  return launch_f1<float, float>(g, fmap1, fmap2, coords, ii1, jj1, valid, df1, wins, boxes, E,
                                 Np, mem, C, H1, W1, H2, W2, s);
}

// g and ii1 as above; gmap [Np, C, 3, 3]; jj1_order [E] int32, a stable argsort of jj1; starts
// [mem + 1] int32, slot f's edges at jj1_order[starts[f] : starts[f + 1]]; wins and boxes from
// dpvo_corr_backward. Writes all of dfm1 / dfm2 (the maps' shapes and dtype). C even.
extern "C" int dpvo_corr_backward_maps(const void* g, const void* gmap, const void* ii1,
                                       const void* jj1_order, const void* starts,
                                       const void* wins, const void* boxes, void* dfm1,
                                       void* dfm2, int mem, int C, int H1, int W1, int H2, int W2,
                                       int feat_bf16, int g_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (mem <= 0 || C <= 0 || C % 2 || H1 <= 0 || W1 <= 0 || H2 <= 0 || W2 <= 0)
    return (int)cudaErrorInvalidValue;
  if (feat_bf16 && g_bf16)
    return launch_maps<__nv_bfloat16, __nv_bfloat16>(g, gmap, ii1, jj1_order, starts, wins, boxes,
                                                     dfm1, dfm2, mem, C, H1, W1, H2, W2, s);
  if (feat_bf16)
    return launch_maps<__nv_bfloat16, float>(g, gmap, ii1, jj1_order, starts, wins, boxes, dfm1,
                                             dfm2, mem, C, H1, W1, H2, W2, s);
  if (g_bf16)
    return launch_maps<float, __nv_bfloat16>(g, gmap, ii1, jj1_order, starts, wins, boxes, dfm1,
                                             dfm2, mem, C, H1, W1, H2, W2, s);
  return launch_maps<float, float>(g, gmap, ii1, jj1_order, starts, wins, boxes, dfm1, dfm2, mem,
                                   C, H1, W1, H2, W2, s);
}
