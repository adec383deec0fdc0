// Two-level sparse patch correlation for Hopper: exact per-pixel windows
// (CORR_IMPL auto / xla) or v4's clamped ones (CORR_IMPL pallas_fused).
//
// Replaces the TPU kernel dpvo_tpu/ops/corr_pallas.py:_make_kernel_v4
// (built at :714, launched by _corr_features_v4 at :949, entry point
// corr_features_pallas_fused). With clamp == 0 it computes the exact
// reference altcorr semantics: every patch pixel's (2r+2)^2 window
// around its own reprojected position, zero outside the image, both
// pyramid levels (level 2 at coords / 4), then the 2x2 bilinear
// reduction to (2r+1)^2. With clamp == 1 it takes v4's windows
// (corr_pallas.py:_level_coeffs): each pixel's window corner clamped into
// the 16 x 24 superwindow anchored 3 px before the centre pixel's corner
// (x aligned down to 8), and pixels whose own window cannot touch the
// image masked to zero; the integer arithmetic is JAX's (saturating
// float-to-int, wrapping int32). Either way it equals
// dpvo_tpu_torch/ops/corr.py:corr_features_plain (same clamp flag) up to
// f32 summation order before the bf16 store; v4 itself also rounds its
// bilinear coefficients to bf16.
//
// Output: the canonical layout out[e, p, l*64 + u*8 + v] (bf16), p the
// patch pixel, l the level, (u, v) = (dy, dx) with the last row and
// column of each 8x8 block zero; edges with valid == 0 (or an index out
// of range) are written as zeros.
//
// What bounds it on an H100: bytes through L2, and latency. Per edge and
// level it stages the union of its 9 pixels' 8x8 windows: ~10-11 rows of
// 12 positions at level 1 and ~9 rows of 9 at level 2 for a real patch
// (pixels 1 px apart), C = 128 bf16 channels each, ~53 KB per edge, ~2.0
// GB per call at the steady state's 37k edges, nearly all of it from L2;
// only the ~22 live frames' maps are distinct bytes (~0.07 ms at 3.35
// TB/s, the bound chip_smoke.py reports). The loads alone and the dots
// and epilogue alone each take most of the kernel's time (PERF.md). The
// dots, 2 x 9 x 64 x C MACs per edge (~11 GFLOP per call), are tens of
// microseconds of tensor-core work.
//
// Design of the bf16 kernel (the main path's dtype), corr_tile_kernel:
// - Work items are (edge, level). A persistent grid, two blocks per SM,
//   walks the edges in index order with a stride of the grid. (Visiting
//   them grouped by frame, for the L2, lost: the on-device argsort costs
//   more than the locality gains, PERF.md.)
// - Warp specialization. One producer warp makes each item's geometry
//   (window corners, union, branch) and loads the item's union window into
//   its level's stage with TMA: one tiled row box per union row (12
//   positions wide at level 1, 9 at level 2) from the NHWC map, issued by
//   one lane per row; rows off the map are zeroed by the warp, positions
//   off its sides zero-filled by the TMA, so no padded map exists. A
//   level-0 item also brings its edge's patch row with one bulk copy. Full
//   and empty mbarriers hand each stage between the producer and the
//   consumers; the producer runs one item ahead.
// - Eight consumer warps compute the raw dots on the tensor cores,
//   mma.sync m16n8k16 (bf16 in, f32 accumulate): A is the 9 patch rows
//   padded to 16 (in registers, once per edge), B 8 union positions at a
//   time, two tiles side by side per warp, even and odd k-steps in
//   separate accumulators. The fused bilinear epilogue gathers each
//   pixel's 8 x 8 window from the union's dot grid, one thread per output
//   row of 8 values. wgmma would need 64-row tiles and waste 55 of 64
//   rows; the kernel is bound by bytes and latency, so mma.sync is the
//   right tool.
// - An item whose union does not fit its stage (pixels spread apart by
//   depth or rotation; rare on the 480x640 main path, PERF.md) takes the
//   per-pixel branch in the same kernel: each consumer warp computes
//   window rows of 8 positions straight from global memory on the CUDA
//   cores. Both branches compute exact windows; the choice is geometry
//   alone (ops/corr_cuda.py:union_tile_levels).
// - It is built for C = 128, the FDIM of every shipped configuration: a
//   stage row is then a multiple of 128 bytes at both levels, as the TMA's
//   shared-memory destinations require (at C = 32 a level-2 row is 576).
// The per-pixel kernel, corr_pixel_kernel, computes every item by the
// per-pixel branch, one 256-thread block per edge: it serves f32 (the tiny
// configurations) and bf16 at a C other than 128, chosen by dtype and C.
// Accumulation is f32 everywhere, with no atomics: a result does not
// depend on the order or on the run.
//
// Later work: the producer and the consumers now wait on each other for a
// similar share of an item; a deeper pipeline needs smaller stages (row
// boxes as wide as each union, not the level's widest) to fit two blocks
// per SM. The per-pixel branch costs several times a staged item.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kRadius = 3;
constexpr int kD = 2 * kRadius + 2;  // 8
constexpr int kP2 = 9;               // 3x3 patch pixels
constexpr int kOutW = 2 * kD * kD;   // 128 canonical values per pixel
constexpr int kRS3 = 16, kCS3 = 24;  // v4's superwindow (clamp mode)
constexpr int kThreads = 256;        // per-pixel kernel
constexpr int kTileC = 128;          // tile kernel: channels
constexpr int kKSteps = kTileC / 16; // its mma k-steps per position
constexpr int kConsumerWarps = 8;    // its consumer warps, then one producer warp
constexpr int kTileThreads = 32 * (kConsumerWarps + 1);
constexpr int kBoxW1 = 12, kBoxW2 = 9;  // union row width loaded per level (TMA box)
// Items alternate levels, so stage 0 holds level-1 unions (up to 11 rows of
// 12 positions) and stage 1 level-2 ones (up to 10 rows of 9)
constexpr int kStages = 2;
constexpr int kStagePos1 = 132, kStagePos2 = 90;
constexpr int kRawStride = 136;      // a pixel's row of raw dots: whole tiles of 8
constexpr int kPatchSlots = kStages / 2 + 1;  // patch rows (edges in flight per block)

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  float4 a = *reinterpret_cast<const float4*>(p);
  float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }

// int32 arithmetic that wraps as JAX's does (signed overflow is undefined in C++)
__device__ __forceinline__ int wrap_add(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// a pixel's window corner floor(x, y) - r at level lvl (coords (x, y) at
// level-1 scale), and its fractions
__device__ __forceinline__ void pixel_corner(float x, float y, int lvl, int& sx, int& sy,
                                             float& fx, float& fy) {
  if (lvl == 1) {
    x = x / 4.0f;
    y = y / 4.0f;
  }
  // float-to-int saturates and maps NaN to 0 on the card, as in JAX
  sx = wrap_add(__float2int_rd(x), -kRadius);
  sy = wrap_add(__float2int_rd(y), -kRadius);
  fx = x - floorf(x);
  fy = y - floorf(y);
}

// the window corner the dots use and the pixel's mask: the corner itself,
// or (clamp) v4's corner clamped into the superwindow of the centre
// pixel's corner (csx, csy)
__device__ __forceinline__ void pixel_base(int sx, int sy, int csx, int csy, int H, int W,
                                           int clamp, int& bx, int& by, float& keep) {
  if (clamp) {
    const int Wa = (W + 7) / 8 * 8;
    const int syc = clampi(wrap_add(csy, -3), -16, H);
    const int sxc = (clampi(wrap_add(csx, -3), -16, Wa) + 16) / 8 * 8 - 16;
    bx = sxc + clampi(wrap_add(sx, -sxc), 0, kCS3 - 9);
    by = syc + clampi(wrap_add(sy, -syc), 0, kRS3 - 9);
    keep = (sy >= -kD && sy <= H && sx >= -kD && sx <= W) ? 1.f : 0.f;
  } else {
    bx = sx;
    by = sy;
    keep = 1.f;
  }
}

// The per-pixel branch: raw[p*64 + dy*8 + dx] = f1[:, p] . map[by[p] + dy,
// bx[p] + dx] (zero outside the H x W map), f1 the patch row [C][9]. Each
// warp takes window rows of 8 positions: 8 groups of 4 lanes, one group
// per window column; the 4 lanes of a group split the C channels in
// interleaved 8-channel chunks (16-byte loads), so one warp reads the
// row's 8 neighbouring feature vectors as one contiguous span, and the
// group sums with two shuffles.
template <typename T, typename F>
__device__ __forceinline__ void window_dots(const F* f1, const T* map, int H, int W, int C,
                                            const int* bx, const int* by, float* raw, int warp,
                                            int nwarps, int lane) {
  const int gx = lane >> 2;  // window column handled by this lane group
  const int q = lane & 3;    // channel interleave within the group
  const int nchunk = C >> 3;
  for (int task = warp; task < kP2 * kD; task += nwarps) {
    const int p = task / kD, dy = task % kD;
    const int y = wrap_add(by[p], dy);
    const int x = wrap_add(bx[p], gx);
    float acc = 0.f;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const T* src = map + ((size_t)y * W + x) * C;
      for (int j = q; j < nchunk; j += 4) {
        float v[8];
        load8(src + j * 8, v);
#pragma unroll
        for (int k = 0; k < 8; ++k) acc = fmaf(v[k], to_f32(f1[(j * 8 + k) * kP2 + p]), acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (q == 0) raw[p * kD * kD + dy * kD + gx] = acc;
  }
}

// 2x2 bilinear reduction at (u, v) of a dot grid c with row stride rs
__device__ __forceinline__ float bilinear(const float* c, int rs, int u, int v, float fx,
                                          float fy) {
  return (1.f - fy) * (1.f - fx) * c[u * rs + v] + (1.f - fy) * fx * c[u * rs + v + 1] +
         fy * (1.f - fx) * c[(u + 1) * rs + v] + fy * fx * c[(u + 1) * rs + v + 1];
}

// ---------------------------------------------------------- per-pixel ----

template <typename T>
__global__ void __launch_bounds__(kThreads)
corr_pixel_kernel(const T* __restrict__ gmap, const T* __restrict__ fmap1,
                  const T* __restrict__ fmap2, const float* __restrict__ coords,
                  const int* __restrict__ ii1, const int* __restrict__ jj1,
                  const uint8_t* __restrict__ valid, __nv_bfloat16* __restrict__ out, int Np,
                  int mem, int C, int H1, int W1, int H2, int W2, int clamp) {
  extern __shared__ float smem[];
  float* f1 = smem;              // [C][9] patch features (gmap row layout)
  float* raw = f1 + C * kP2;     // [2][9][8][8] raw window dots
  __shared__ int corner[2][kP2][2];   // floor(coords) - r (x, y) per level/pixel
  __shared__ int bx[2][kP2], by[2][kP2];
  __shared__ float frac[2][kP2][2];   // fractional (x, y)
  __shared__ float keep[2][kP2];      // pixel mask (clamp mode; else 1)

  const int e = blockIdx.x;
  const int tid = threadIdx.x;
  __nv_bfloat16* o = out + (size_t)e * kP2 * kOutW;
  const int ii = ii1[e];
  const int jj = jj1[e];
  if (!valid[e] || ii < 0 || ii >= Np || jj < 0 || jj >= mem) {
    for (int i = tid; i < kP2 * kOutW; i += kThreads) o[i] = __float2bfloat16_rn(0.f);
    return;
  }

  const T* g = gmap + (size_t)ii * C * kP2;
  for (int i = tid; i < C * kP2; i += kThreads) f1[i] = to_f32(g[i]);
  if (tid < 2 * kP2) {
    const int lvl = tid / kP2, p = tid % kP2;
    pixel_corner(coords[((size_t)e * kP2 + p) * 2], coords[((size_t)e * kP2 + p) * 2 + 1], lvl,
                 corner[lvl][p][0], corner[lvl][p][1], frac[lvl][p][0], frac[lvl][p][1]);
  }
  __syncthreads();
  if (tid < 2 * kP2) {
    const int lvl = tid / kP2, p = tid % kP2;
    pixel_base(corner[lvl][p][0], corner[lvl][p][1], corner[lvl][kP2 / 2][0],
               corner[lvl][kP2 / 2][1], lvl ? H2 : H1, lvl ? W2 : W1, clamp, bx[lvl][p],
               by[lvl][p], keep[lvl][p]);
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  window_dots(f1, fmap1 + (size_t)jj * H1 * W1 * C, H1, W1, C, bx[0], by[0], raw, warp,
              kThreads / 32, lane);
  window_dots(f1, fmap2 + (size_t)jj * H2 * W2 * C, H2, W2, C, bx[1], by[1],
              raw + kP2 * kD * kD, warp, kThreads / 32, lane);
  __syncthreads();

  for (int i = tid; i < kP2 * kOutW; i += kThreads) {
    const int p = i / kOutW, r = i % kOutW;
    const int lvl = r / (kD * kD), u = (r / kD) % kD, v = r % kD;
    float val = 0.f;
    if (u < kD - 1 && v < kD - 1) {
      val = bilinear(raw + (lvl * kP2 + p) * kD * kD, kD, u, v, frac[lvl][p][0],
                     frac[lvl][p][1]);
      val *= keep[lvl][p];
    }
    o[i] = __float2bfloat16_rn(val);
  }
}

// ---------------------------------------------------- bf16 tile, C = 128 ----

// The tensor-map encoder of the driver API, reached through the runtime
// (no link against libcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}
// one box [1][1][box width][C] of a [mem][H][W][C] map at (slot, y, x, 0)
__device__ __forceinline__ void tma_load_row(void* dst, const CUtensorMap* map, int x, int y,
                                             int slot, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(x), "r"(y), "r"(slot),
      "r"(smem_addr(bar))
      : "memory");
}

// a contiguous copy of bytes (a multiple of 16) from global to shared memory
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// the consumer warps' own barrier (the producer warp does not take part)
__device__ __forceinline__ void consumer_barrier() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerWarps * 32) : "memory");
}
// c += a b on the tensor cores: m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// one work item: an edge at one level
struct Item {
  int e;              // the edge, and its output row
  int mode;           // 0: zeros, 1: union tile, 2: per-pixel windows
  int jj;             // map slot
  int uh;             // the union's rows (mode 1)
  int bx[kP2], by[kP2];
  int off[kP2];       // raw offset of pixel p's window corner
  float fx[kP2], fy[kP2], keep[kP2];
};

__global__ void __launch_bounds__(kTileThreads, 2)
corr_tile_kernel(const __grid_constant__ CUtensorMap tmap1,
                 const __grid_constant__ CUtensorMap tmap2, const __nv_bfloat16* __restrict__ gmap,
                 const __nv_bfloat16* __restrict__ fmap1, const __nv_bfloat16* __restrict__ fmap2,
                 const float* __restrict__ coords, const int* __restrict__ ii1,
                 const int* __restrict__ jj1, const uint8_t* __restrict__ valid,
                 __nv_bfloat16* __restrict__ out, int E, int Np, int mem, int H1, int W1, int H2,
                 int W2, int clamp) {
  constexpr int C = kTileC;
  constexpr int kPatch = C * kP2;  // a gmap row, layout [C][9]
  extern __shared__ __align__(128) unsigned char tile_smem[];
  // union windows [kStagePos1 + kStagePos2][C] (rows of the level's box
  // width), [kPatchSlots][C][9] patch rows, [2][9][kRawStride] raw dots
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(tile_smem);
  __nv_bfloat16* patches = stages + (kStagePos1 + kStagePos2) * C;
  float* raws = reinterpret_cast<float*>(patches + kPatchSlots * kPatch);
  __shared__ Item items[kStages];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = gridDim.x;
  const int nitems = 2 * ((E - (int)blockIdx.x + G - 1) / G);
  if (nitems == 0) return;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---- the producer warp: item i's geometry, patch row and loads into
    // stage i % kStages, once the consumers have released it ----
    // the inputs of edge e (lane p < 9: pixel p's coords), as raw loads;
    // nothing here waits for them. An edge's loads go out one edge ahead
    // of their use.
    struct EdgeIn {
      int e, ii, jj, ok;
      float x, y;
    };
    auto fetch = [&](int e) {
      EdgeIn in = {e, 0, 0, 0, 0.f, 0.f};
      if (e >= 0) {
        in.ii = ii1[e];
        in.jj = jj1[e];
        in.ok = valid[e];
        if (lane < kP2) {
          in.x = coords[((size_t)e * kP2 + lane) * 2];
          in.y = coords[((size_t)e * kP2 + lane) * 2 + 1];
        }
      }
      return in;
    };
    auto edge_id = [&](int m) {  // the block's m-th edge (-1 past the end)
      const int k = blockIdx.x + G * m;
      return k < E ? k : -1;
    };
    EdgeIn cur = fetch(edge_id(0)), nxt = fetch(edge_id(1));
    for (int i = 0; i < nitems; ++i) {
      const int s = i % kStages, lvl = i & 1;
      if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
      if (i > 0 && !lvl) {  // item i starts the block's edge m
        cur = nxt;
        nxt = fetch(edge_id((i >> 1) + 1));
      }
      // the geometry
      Item& it = items[s];
      const int H = lvl ? H2 : H1, W = lvl ? W2 : W1, bw = lvl ? kBoxW2 : kBoxW1;
      const int cap = lvl ? kStagePos2 : kStagePos1;
      int sx = 0, sy = 0, bx = 0, by = 0;
      float fx = 0.f, fy = 0.f, keep = 0.f;
      if (lane < kP2) pixel_corner(cur.x, cur.y, lvl, sx, sy, fx, fy);
      const int csx = __shfl_sync(0xffffffffu, sx, kP2 / 2);
      const int csy = __shfl_sync(0xffffffffu, sy, kP2 / 2);
      if (lane < kP2) pixel_base(sx, sy, csx, csy, H, W, clamp, bx, by, keep);
      const int x0 = __reduce_min_sync(0xffffffffu, lane < kP2 ? bx : INT_MAX);
      const int x1 = __reduce_max_sync(0xffffffffu, lane < kP2 ? bx : INT_MIN);
      const int y0 = __reduce_min_sync(0xffffffffu, lane < kP2 ? by : INT_MAX);
      const int y1 = __reduce_max_sync(0xffffffffu, lane < kP2 ? by : INT_MIN);
      // the union, (x1 - x0 + 8) x (y1 - y0 + 8), in one row box per row
      const long long uw = (long long)x1 - x0 + kD, uh = (long long)y1 - y0 + kD;
      const bool tile = uw <= bw && uh * bw <= cap;
      const bool ok = cur.ok && cur.ii >= 0 && cur.ii < Np && cur.jj >= 0 && cur.jj < mem;
      const int mode = !ok ? 0 : tile ? 1 : 2;
      // rows inside the map, whose boxes touch it, go by TMA; the rest are zeroed
      const bool xin = mode == 1 && x0 < W && (long long)x0 + bw > 0;
      const int r0 = xin ? (int)max(0LL, -(long long)y0) : 0;
      const int r1 = xin ? (int)max((long long)r0, min(uh, (long long)H - y0)) : 0;
      if (lane < kP2) {
        it.bx[lane] = bx;
        it.by[lane] = by;
        it.fx[lane] = fx;
        it.fy[lane] = fy;
        it.keep[lane] = keep;
        it.off[lane] = tile ? lane * kRawStride + (by - y0) * bw + (bx - x0) : lane * kD * kD;
      }
      if (lane == 0) {
        it.e = cur.e;
        it.mode = mode;
        it.jj = cur.jj;
        it.uh = tile ? (int)uh : 0;
      }
      __nv_bfloat16* st = stages + lvl * kStagePos1 * C;
      if (mode == 1) {
        const int per = bw * C / 8, nz = ((int)uh - (r1 - r0)) * per;
        for (int z = lane; z < nz; z += 32) {
          const int zr = z / per, r = zr < r0 ? zr : zr + (r1 - r0);
          reinterpret_cast<uint4*>(st + r * bw * C)[z - zr * per] = make_uint4(0, 0, 0, 0);
        }
      }
      __threadfence_block();
      __syncwarp();
      // A level-0 item also brings its edge's patch row, as it lies in gmap
      // ([C][9]); its slot's last readers (edge m - kPatchSlots) are done,
      // as item i - kStages is. The arrive releases the warp's writes
      // above; the copies' bytes complete the phase.
      const bool patch = !lvl && cur.e >= 0 && cur.ii >= 0 && cur.ii < Np;
      if (lane == 0) {
        mbar_expect_tx(&full[s], (uint32_t)(((r1 - r0) * bw * C + (patch ? kPatch : 0)) *
                                            sizeof(__nv_bfloat16)));
        if (patch)
          bulk_load(patches + ((i >> 1) % kPatchSlots) * kPatch, gmap + (size_t)cur.ii * kPatch,
                    kPatch * sizeof(__nv_bfloat16), &full[s]);
      }
      // one row box per lane
      if (lane >= r0 && lane < r1)
        tma_load_row(st + lane * bw * C, lvl ? &tmap2 : &tmap1, x0, y0 + lane, cur.jj, &full[s]);
    }
    return;
  }

  // ---- the consumer warps: item i's raw dots, then its half of the
  // canonical rows ----
  const int gq = lane >> 2, t = lane & 3;
  uint32_t a[kKSteps][4];
  int a_edge = -1;
  for (int i = 0; i < nitems; ++i) {
    const int s = i % kStages, lvl = i & 1;
    mbar_wait(&full[s], (i / kStages) & 1);
    const Item& it = items[s];
    const __nv_bfloat16* pr = patches + ((i >> 1) % kPatchSlots) * kPatch;
    float* raw = raws + (i & 1) * kP2 * kRawStride;
    const int mode = it.mode;
    if (mode == 1) {
      // the A fragments (the 9 patch rows, rows 9..15 zero, in the channel
      // order of csrc/corr_pallas.cu: lane t's 16-byte chunk 4j + t of a
      // position serves the k-steps 2j and 2j + 1), once per edge, from
      // the [C][9] patch row
      if (a_edge != (i >> 1)) {
        a_edge = i >> 1;
        auto pair = [&](int row, int c) {  // channels c, c + 1 of patch row `row`
          return row < kP2 ? pack_bf16(pr[c * kP2 + row], pr[(c + 1) * kP2 + row]) : 0u;
        };
#pragma unroll
        for (int ks = 0; ks < kKSteps; ++ks) {
          const int c0 = 32 * (ks >> 1) + 8 * t + 4 * (ks & 1);
          a[ks][0] = pair(gq, c0);
          a[ks][1] = pair(gq + 8, c0);
          a[ks][2] = pair(gq, c0 + 2);
          a[ks][3] = pair(gq + 8, c0 + 2);
        }
      }
      // tiles of 8 positions, two side by side per warp; a tile past the
      // union reads the stage's first rows, whose results are dropped
      const __nv_bfloat16* st = stages + lvl * kStagePos1 * C;
      const int ntiles = (it.uh * (lvl ? kBoxW2 : kBoxW1) + 7) >> 3;
      for (int t0 = warp; t0 < ntiles; t0 += 2 * kConsumerWarps) {
        const int t1 = t0 + kConsumerWarps;
        const bool two = t1 < ntiles;
        // even and odd k-steps in separate accumulators: four independent
        // chains of mma per warp
        float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
        float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
        const __nv_bfloat16* b0 = st + (t0 * 8 + gq) * C + 8 * t;
        const __nv_bfloat16* b1 = st + ((two ? t1 : t0) * 8 + gq) * C + 8 * t;
#pragma unroll
        for (int j = 0; j < kKSteps / 2; ++j) {
          const uint4 v0 = *reinterpret_cast<const uint4*>(b0 + 32 * j);
          const uint4 v1 = *reinterpret_cast<const uint4*>(b1 + 32 * j);
          const uint32_t e0[2] = {v0.x, v0.y}, o0[2] = {v0.z, v0.w};
          const uint32_t e1[2] = {v1.x, v1.y}, o1[2] = {v1.z, v1.w};
          mma_bf16(c0, a[2 * j], e0);
          mma_bf16(c1, a[2 * j], e1);
          mma_bf16(d0, a[2 * j + 1], o0);
          mma_bf16(d1, a[2 * j + 1], o1);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) c0[q] += d0[q], c1[q] += d1[q];
        // c[0..1]: pixel gq, positions tile*8 + 2t, +1; c[2..3]: pixel gq + 8
        if (gq < kP2) {
          *reinterpret_cast<float2*>(raw + gq * kRawStride + t0 * 8 + 2 * t) =
              make_float2(c0[0], c0[1]);
          if (two)
            *reinterpret_cast<float2*>(raw + gq * kRawStride + t1 * 8 + 2 * t) =
                make_float2(c1[0], c1[1]);
        }
        if (gq == 0) {
          *reinterpret_cast<float2*>(raw + 8 * kRawStride + t0 * 8 + 2 * t) =
              make_float2(c0[2], c0[3]);
          if (two)
            *reinterpret_cast<float2*>(raw + 8 * kRawStride + t1 * 8 + 2 * t) =
                make_float2(c1[2], c1[3]);
        }
      }
    } else if (mode == 2) {
      const int H = lvl ? H2 : H1, W = lvl ? W2 : W1;
      window_dots(pr, (lvl ? fmap2 : fmap1) + (size_t)it.jj * H * W * C, H, W, C, it.bx, it.by,
                  raw, warp, kConsumerWarps, lane);
    }
    consumer_barrier();  // raw complete; raw's other half was read before it
    // threads 0..71: one row (p, u) of the item's half of the canonical
    // rows, 8 values (the last zero), one 16-byte store
    if (tid < kP2 * kD) {
      const int p = tid >> 3, u = tid & 7;
      const int rs = mode == 1 ? (lvl ? kBoxW2 : kBoxW1) : kD;
      float val[kD] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (mode != 0 && u < kD - 1) {
        const float* c = raw + it.off[p] + u * rs;
        const float fx = it.fx[p], fy = it.fy[p], keep = it.keep[p];
#pragma unroll
        for (int v = 0; v < kD - 1; ++v) val[v] = bilinear(c, rs, 0, v, fx, fy) * keep;
      }
      const uint4 o = make_uint4(pack_bf16x2(val[0], val[1]), pack_bf16x2(val[2], val[3]),
                                 pack_bf16x2(val[4], val[5]), pack_bf16x2(val[6], val[7]));
      *reinterpret_cast<uint4*>(out + ((size_t)it.e * kP2 + p) * kOutW + lvl * kD * kD +
                                u * kD) = o;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // the stage, its geometry and patch row are free
  }
}

template <typename T>
int launch_pixel(const void* gmap, const void* fmap1, const void* fmap2, const void* coords,
                 const void* ii1, const void* jj1, const void* valid, void* out, int E, int Np,
                 int mem, int C, int H1, int W1, int H2, int W2, int clamp, cudaStream_t stream) {
  const size_t shmem = (size_t)(C * kP2 + 2 * kP2 * kD * kD) * sizeof(float);
  if (shmem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(corr_pixel_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  if (E > 0) {
    corr_pixel_kernel<T><<<E, kThreads, shmem, stream>>>(
        (const T*)gmap, (const T*)fmap1, (const T*)fmap2, (const float*)coords, (const int*)ii1,
        (const int*)jj1, (const uint8_t*)valid, (__nv_bfloat16*)out, Np, mem, C, H1, W1, H2, W2,
        clamp);
  }
  return (int)cudaGetLastError();
}

// a tensor map of a [mem][H][W][C] bf16 map whose box is one row of bw
// positions; out-of-range elements read as zero
int encode_map(CUtensorMap* tmap, const void* fmap, int mem, int H, int W, int C, int bw) {
  static EncodeTiledFn encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
    if (err != cudaSuccess) return (int)err;
    if (q != cudaDriverEntryPointSuccess || !fn) return (int)cudaErrorNotSupported;
    encode = (EncodeTiledFn)fn;
  }
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)mem};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {(cuuint32_t)C, (cuuint32_t)bw, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  CUresult r = encode(tmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(fmap), dims,
                      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

int launch_tile(const void* gmap, const void* fmap1, const void* fmap2, const void* coords,
                const void* ii1, const void* jj1, const void* valid, void* out, int E, int Np,
                int mem, int H1, int W1, int H2, int W2, int clamp, cudaStream_t stream) {
  constexpr int C = kTileC;
  // 71,232 bytes: two blocks of 288 threads fit an SM
  const size_t shmem =
      (size_t)((kStagePos1 + kStagePos2) * C + kPatchSlots * C * kP2) * sizeof(__nv_bfloat16) +
      (size_t)2 * kP2 * kRawStride * sizeof(float);
  if (E <= 0) return (int)cudaGetLastError();
  CUtensorMap tmap1, tmap2;
  int err = encode_map(&tmap1, fmap1, mem, H1, W1, C, kBoxW1);
  if (!err) err = encode_map(&tmap2, fmap2, mem, H2, W2, C, kBoxW2);
  if (err) return err;
  auto kernel = corr_tile_kernel;
  cudaError_t cerr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
  if (cerr == cudaSuccess)
    cerr = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                (int)cudaSharedmemCarveoutMaxShared);
  int dev = 0, sms = 0, per_sm = 0;
  if (cerr == cudaSuccess) cerr = cudaGetDevice(&dev);
  if (cerr == cudaSuccess) cerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (cerr == cudaSuccess)
    cerr = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTileThreads, shmem);
  if (cerr != cudaSuccess) return (int)cerr;
  const int fit = (per_sm > 0 ? per_sm : 1) * sms;
  const int grid = E < fit ? E : fit;
  kernel<<<grid, kTileThreads, shmem, stream>>>(
      tmap1, tmap2, (const __nv_bfloat16*)gmap, (const __nv_bfloat16*)fmap1,
      (const __nv_bfloat16*)fmap2, (const float*)coords, (const int*)ii1, (const int*)jj1,
      (const uint8_t*)valid, (__nv_bfloat16*)out, E, Np, mem, H1, W1, H2, W2, clamp);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 at C = 128: the tile kernel; f32, or bf16 at another C (a multiple
// of 8): the per-pixel kernel
extern "C" int dpvo_corr_features(const void* gmap, const void* fmap1, const void* fmap2,
                                  const void* coords, const void* ii1, const void* jj1,
                                  const void* valid, void* out, int E, int Np, int mem, int C,
                                  int H1, int W1, int H2, int W2, int is_bf16, int clamp,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (C <= 0 || C % 8) return (int)cudaErrorInvalidValue;
  if (is_bf16 && C == kTileC)
    return launch_tile(gmap, fmap1, fmap2, coords, ii1, jj1, valid, out, E, Np, mem, H1, W1, H2,
                       W2, clamp, s);
  if (is_bf16)
    return launch_pixel<__nv_bfloat16>(gmap, fmap1, fmap2, coords, ii1, jj1, valid, out, E, Np,
                                       mem, C, H1, W1, H2, W2, clamp, s);
  return launch_pixel<float>(gmap, fmap1, fmap2, coords, ii1, jj1, valid, out, E, Np, mem, C, H1,
                             W1, H2, W2, clamp, s);
}
