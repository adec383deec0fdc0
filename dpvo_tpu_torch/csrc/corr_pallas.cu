// The correlation kernels behind CORR_IMPL = pallas, pallas_sw and
// pallas_dma, for Hopper (wrappers: dpvo_tpu_torch/ops/corr_pallas.py).
//
// Replaces four TPU kernels of dpvo_tpu/ops/corr_pallas.py:
//   A    _make_kernel     (pallas_call at :188, _corr_level)    dpvo_corr_window
//   B    _make_kernel_sw  (pallas_call at :336, _corr_level_sw) dpvo_corr_sw_fused
//   C+D  _make_kernel_v3  (pallas_call at :620, _corr_level_v3) and
//        _make_epi_kernel (pallas_call at :552, _epi_pallas)    dpvo_corr_v3_fused
//
// The dots are what the TPU kernels compute: per edge e (edges sorted by
// the caller; the order does not change any value), bf16 dot products of
// the patch features f1[e, p, :] (p < 9) with frame feature vectors of
// slot jj[e], accumulated in f32 and rounded once to bf16. Out-of-image
// positions read zero (the TPU's zero-bordered frame cache; here the reads
// are bounds-checked, no padded copy is made). Invalid edges (and a jj out
// of range) are written as zeros. The window corners come from torch,
// computed exactly as the JAX code computes them.
//   A:   out[e, p, u*8 + v]  = f1[e,p] . map[jj, sy[e,p] + u, sx[e,p] + v]
//        (each pixel's exact 8x8 window; the TPU emits an 8-aligned 8x16
//        strip per pixel, a sublane rule, from which XLA selects the same
//        values: the port emits the window itself)
//   B:   level_sw's output [E, 9, 64]: the dots of the 14 x 32 superwindow
//        s at (syc, sxc), then per pixel its 8 x 8 window of s at (dy, dxw)
//        (dy in [0, 6], dxw in [0, 24], as sw_inputs clamps them) and the
//        2x2 bilinear o = ((w00 a + w01 b) + w10 c) + w11 d in f32, the
//        weights ((1 - dyf) (1 - dxf)) vf and so on, each product and sum
//        rounded as torch's separate ops round them (no FMA contraction);
//        the last row and column zero, one round to bf16.
//   C+D: level_v3's output [E, 9, 64]: C's dots over the 16 x 24
//        superwindow s at (syc, sxc), then D, the v3 epilogue, per pixel:
//        9 row taps (the row one-hot merged with the y-bilinear; each
//        product and each running sum rounded to bf16, as the TPU's bf16
//        scratch tmp_r is) and 17 column taps (the column one-hot, 8-
//        alignment remainder included, merged with the x-bilinear and the
//        pixel mask; f32 accumulation), of which the kept 7 x 7 outputs
//        (last row and column zero).
//
// The fact the fused kernels rest on. B's bilinear reads only each pixel's
// 8 x 8 window (tests/test_torch_corr_impls.py::
// test_sw_window_is_the_live_region). Of D's taps only a = dy, dy + 1 and
// b = dxw, dxw + 1 carry weight (dy in [0, 7], dxw in [0, 15], as the
// wrapper's v3_inputs clamps them); the others add +-0, which changes no
// value where s is finite (at most the sign of a zero). So the kept output
// (r, c) of pixel p reads s only at rows dy + r, dy + r + 1 and columns
// dxw + c, dxw + c + 1: the pixel's own 8 x 8 window at (syc + dy, sxc +
// dxw). tests/test_torch_corr_impls.py::test_v3_window_is_the_live_region
// shows it on the plain versions.
//
// What bounds A, B and C+D on an H100. Per (edge, level) 9 x 64 outputs, 2 x
// 9 x 64 x C operations (C = 128: ~11 GFLOP a call at the steady state's
// 37k edges, ~11 us on the bf16 tensor cores); the bytes their function
// needs are the frames the edges touch, the patch rows, the per-edge
// inputs and the [E, 9, 64] bf16 output (~0.07 ms at 3.35 TB/s,
// chip_smoke.py's bounds). What they move in fact is each item's union
// window through L2: ~12.8 tiles of 8 positions x C x 2 bytes, ~2 GB a
// call at C = 128, and that sets their time. On one H100
// (scripts/corr_union_probe.py, PERF.md) the time grows with C as those
// bytes do (0.23 -> 0.39 ms a call for A from C = 64 to 128: ~6.4 TB/s at
// the margin), and the part no tile count removes (geometry, patch rows,
// epilogue, launch) is ~0.1 ms.
//
// Design of A, B and C+D (the kernels before them computed A's 9 pixels'
// windows as 72 tiles of 8 positions, keeping one row of each 16-row tile,
// C's whole 16 x 24 superwindow as 48 tiles, written to memory for a
// second kernel, D, to read back, and B's whole 14 x 32 superwindow as 56
// tiles, written to memory for torch's selection and bilinear):
// - One warp per (edge, level) item, four items per 128-thread block, no
//   block barrier. The warp loads the edge's 9 patch rows into registers
//   once as mma A fragments (rows 9..15 zero).
// - Lanes 0..8 read the 9 pixel windows' corners (A: sy, sx; B, C+D: syc
//   + dy, sxc + dxw) and the warp reduces them to the union rectangle,
//   uh x uw positions. The dots of the union's positions are computed
//   once: tiles of 8 consecutive positions of the row-major union (~13
//   tiles at level 1 and ~11 at level 2 for pixels 1 px apart, against 72
//   and 48), mma.sync m16n8k16 (bf16 in, f32 accumulate; wgmma's 64-row
//   tiles would waste 55 of 64 rows). Each lane reads its position's 16
//   bytes per 32 channels straight from the NHWC map, two tiles ahead of
//   the mma (three register buffers), so loads stay in flight.
// - Each tile is rounded to bf16 into the warp's dot grid in shared memory,
//   [9][kGridPitch] (6.5 KB; the pitch makes the tile stores conflict-
//   free), holding a union of up to kGridPos = 352 positions (44 tiles).
//   The epilogue reads each pixel's window from the grid: A copies it (one
//   16-byte store per window row), B applies level_sw's bilinear and C+D
//   D's live taps, each with its reference's rounding points (__fmul_rn /
//   __fadd_rn; C+D a bf16 round after every row tap), and write the kept 7
//   x 7 (one 16-byte store per output row).
// - A union larger than the grid (A's pixels spread apart by depth or
//   rotation; B's, up to 14 x 32 positions, when its windows spread over
//   more than 25 columns at 14 rows; C+D's, at most 15 x 23 = 345, always
//   fits) takes the per-pixel branch of the same warp: per pixel and
//   window row one tile of 8 positions, of which only the pixel's row is
//   kept, into the grid with pitch 8. The choice is geometry alone
//   (ops/corr_pallas.py:window_union applies the rule).
// - Block count: E / 4 blocks per launch (one per item before), one launch
//   per level as the level functions call them. No block barrier and 26 KB
//   of static shared memory per block; the registers (the A fragments and
//   three B tiles) bound the warps an SM holds at C >= 128 (113 registers
//   a thread), and shared memory with them below: a grid that holds B's
//   whole superwindow (448 positions, 32 KB a block) measured 13% slower
//   at C = 32 and no faster at C = 128 (PERF.md). A persistent grid or
//   both levels in one block would save only what the fixed part holds
//   (~0.1 ms a call), not the L2 reads, which are the rest, so the kernel
//   stays one warp per item.
// Each dot is the chain of mma accumulations of mma_tile (the channel
// order above, k-steps in order, one bf16 round), whichever 8 positions
// share its tile, and the epilogues round where their references round:
// A's windows, B's and C+D's outputs equal those of the kernels before
// them (per-pixel tiles for A; the full superwindow, then torch's
// bilinear for B or D for C+D) value for value (scripts/corr_digest.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int kP2 = 9;  // patch pixels
constexpr int kWin = 8;  // a pixel's window is kWin x kWin
constexpr int kRS = 14, kCS = 32;    // the sw superwindow (B)
constexpr int kRS3 = 16, kCS3 = 24;  // the v3 superwindow (C+D)
constexpr int kItemWarps = 4;        // items (one warp each) per block
constexpr int kGridPos = 352;        // union positions a warp's dot grid holds
constexpr int kGridPitch = 360;      // its row pitch (bf16): conflict-free tile stores
constexpr unsigned kFull = 0xffffffffu;

// int32 arithmetic that wraps as JAX's does (signed overflow is undefined in C++)
__device__ __forceinline__ int wrap_add(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// Channel order. A dot product may visit its channels in any order, so
// k-step ks of a 32-channel chunk gives lane t (= lane % 4) the channels
// 32 (ks / 2) + 8t + 4 (ks % 2) + {0, 1} as its logical k = 2t, 2t+1 and
// + {2, 3} as k = 2t+8, 2t+9. Lane t then finds the B operands of two
// k-steps in one 16-byte load (channels 8t .. 8t+7 of the chunk), and the
// A fragments are loaded in the same order.

// the edge's 9 patch rows as mma A fragments (rows 9..15 zero), for k-step
// ks: a[0..3] as the m16n8k16 layout wants them
__device__ __forceinline__ void load_a(const __nv_bfloat16* f1e, int C, int ks, int lane,
                                       uint32_t* a) {
  const int g = lane >> 2, t = lane & 3;
  const int c0 = 32 * (ks >> 1) + 8 * t + 4 * (ks & 1);
  a[0] = g < kP2 ? *reinterpret_cast<const uint32_t*>(f1e + g * C + c0) : 0u;
  a[2] = g < kP2 ? *reinterpret_cast<const uint32_t*>(f1e + g * C + c0 + 2) : 0u;
  a[1] = g + 8 < kP2 ? *reinterpret_cast<const uint32_t*>(f1e + (g + 8) * C + c0) : 0u;
  a[3] = g + 8 < kP2 ? *reinterpret_cast<const uint32_t*>(f1e + (g + 8) * C + c0 + 2) : 0u;
}

// the A fragments of all KS = C / 16 k-steps (registers: KS is a
// template argument, so the array is never indexed at run time)
template <int KS>
__device__ __forceinline__ void load_a_all(const __nv_bfloat16* f1e, int lane,
                                           uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) load_a(f1e, KS * 16, ks, lane, a[ks]);
}

// one lane's B operands of a tile: its position's C channels, 16 bytes per
// 32-channel chunk (zero for a position outside the H x W map)
template <int KS>
struct BTile {
  uint4 v[KS / 2];
};

template <int KS>
__device__ __forceinline__ void load_b(const __nv_bfloat16* frame, int H, int W, int y, int x,
                                       int t, BTile<KS>& b) {
  static_assert(KS % 2 == 0, "channels come in chunks of 32");
  constexpr int C = KS * 16;
  const bool in = y >= 0 && y < H && x >= 0 && x < W;
  const uint4* src = reinterpret_cast<const uint4*>(
      frame + ((size_t)(in ? y : 0) * W + (in ? x : 0)) * C + 8 * t);
#pragma unroll
  for (int j = 0; j < KS / 2; ++j) b.v[j] = in ? src[4 * j] : make_uint4(0, 0, 0, 0);
}

// the dots of the 16 A rows with a tile's 8 positions: one chain of KS
// mma accumulations in k-step order. c[0..1]: row g, positions 2t, 2t+1;
// c[2..3]: row g + 8.
template <int KS>
__device__ __forceinline__ void mma_tile(const uint32_t (&a)[KS][4], const BTile<KS>& b,
                                         float* c) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
#pragma unroll
  for (int j = 0; j < KS / 2; ++j) {
    const uint32_t bb[2][2] = {{b.v[j].x, b.v[j].y}, {b.v[j].z, b.v[j].w}};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t* ak = a[2 * j + h];
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
          : "r"(ak[0]), "r"(ak[1]), "r"(ak[2]), "r"(ak[3]), "r"(bb[h][0]), "r"(bb[h][1]));
    }
  }
}

__device__ __forceinline__ void store2(__nv_bfloat16* dst, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// ------------------------------------------------- kernels A, B, C+D ----

struct UnionArgs {
  const __nv_bfloat16* f1;    // [E, 9, C] patch rows
  const __nv_bfloat16* fmap;  // [mem, H, W, C]
  const int* jj;              // [E]
  const uint8_t* valid;       // [E]
  const int* y;               // A: sy [E, 9]; B, C+D: syc [E]
  const int* x;               // A: sx [E, 9]; B, C+D: sxc [E]
  const int* dy;              // B, C+D: [E, 9] window offsets in the superwindow
  const int* dxw;
  const float* dyf;           // B, C+D: [E, 9] bilinear fractions and pixel mask
  const float* dxf;
  const float* vf;
  __nv_bfloat16* out;         // [E, 9, 64]
  int E, mem, H, W;
};

// what an item writes from its dot grid: A each pixel's raw window, B
// level_sw's bilinear, C+D the v3 epilogue
enum class Epi { kWindow, kSw, kV3 };

// (k == a) * (1 - f) + (k == a - 1) * f, as the JAX expression rounds it
__device__ __forceinline__ float merged_tap(int k, int a, float f) {
  return __fadd_rn(__fmul_rn(k == a ? 1.f : 0.f, __fsub_rn(1.f, f)),
                   __fmul_rn(k == a - 1 ? 1.f : 0.f, f));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One (edge, level) item per warp; grid: the warp's [9][kGridPitch] dot grid.
template <Epi kEpi, int KS>
__device__ __forceinline__ void union_item(const UnionArgs& A, __nv_bfloat16* grid) {
  constexpr bool kSuper = kEpi != Epi::kWindow;  // corners from (syc, sxc) + (dy, dxw)
  // the window offsets' ranges in the superwindow (sw_inputs, v3_inputs)
  constexpr int kDyMax = kEpi == Epi::kSw ? kRS - kWin : kRS3 - kWin - 1;
  constexpr int kDxMax = kEpi == Epi::kSw ? kCS - kWin : kCS3 - kWin - 1;
  constexpr int C = KS * 16;
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * kItemWarps + (threadIdx.x >> 5);
  if (e >= A.E) return;
  uint4* o = reinterpret_cast<uint4*>(A.out + (size_t)e * kP2 * kWin * kWin);
  const int jf = A.jj[e];
  if (!A.valid[e] || jf < 0 || jf >= A.mem) {
    for (int i = lane; i < kP2 * kWin; i += 32) o[i] = make_uint4(0, 0, 0, 0);
    return;
  }
  const int g = lane >> 2, t = lane & 3;

  // pixel `lane`'s window corner (lanes < 9), then the union of the 9
  // windows, uh x uw positions at (y0, x0)
  int wy = 0, wx = 0;
  float fy = 0.f, fx = 0.f, v = 0.f;
  if (lane < kP2) {
    const int i = e * kP2 + lane;
    if constexpr (kSuper) {
      // dy, dxw lie in these ranges (the wrapper's inputs clamp them); the
      // clamp here keeps any other input inside the superwindow
      wy = wrap_add(A.y[e], clampi(A.dy[i], 0, kDyMax));
      wx = wrap_add(A.x[e], clampi(A.dxw[i], 0, kDxMax));
      fy = A.dyf[i];
      fx = A.dxf[i];
      v = A.vf[i];
    } else {
      wy = A.y[i];
      wx = A.x[i];
    }
  }
  const int y0 = __reduce_min_sync(kFull, lane < kP2 ? wy : INT_MAX);
  const int y1 = __reduce_max_sync(kFull, lane < kP2 ? wy : INT_MIN);
  const int x0 = __reduce_min_sync(kFull, lane < kP2 ? wx : INT_MAX);
  const int x1 = __reduce_max_sync(kFull, lane < kP2 ? wx : INT_MIN);
  const long long upos = ((long long)y1 - y0 + kWin) * ((long long)x1 - x0 + kWin);
  const bool fits = upos <= kGridPos;  // else the per-pixel branch
  const int pitch = fits ? x1 - x0 + kWin : kWin;
  const int npos = fits ? (int)upos : 0;
  const int ntiles = fits ? (npos + 7) >> 3 : kP2 * kWin;
  const __nv_bfloat16* frame = A.fmap + (size_t)jf * A.H * A.W * C;

  // this lane's position in tile k: union position k * 8 + g (past the
  // union: off the map, zero), or window row k % 8, column g of pixel k / 8
  auto fetch = [&](int k, BTile<KS>& b) {
    if (k >= ntiles) return;
    int y, x;
    if (fits) {
      const int n = k * 8 + g;
      y = n < npos ? wrap_add(y0, n / pitch) : -1;
      x = wrap_add(x0, n % pitch);
    } else {
      y = wrap_add(__shfl_sync(kFull, wy, k >> 3), k & 7);
      x = wrap_add(__shfl_sync(kFull, wx, k >> 3), g);
    }
    load_b<KS>(frame, A.H, A.W, y, x, t, b);
  };
  uint32_t a[KS][4];
  auto step = [&](int k, const BTile<KS>& b) {
    if (k >= ntiles) return;
    float c[4];
    mma_tile<KS>(a, b, c);
    if (fits) {
      store2(grid + g * kGridPitch + k * 8 + 2 * t, c[0], c[1]);
      if (g == 0) store2(grid + 8 * kGridPitch + k * 8 + 2 * t, c[2], c[3]);
    } else {
      const int p = k >> 3, u = k & 7;
      if (g == p) store2(grid + p * kGridPitch + u * kWin + 2 * t, c[0], c[1]);
      if (g + 8 == p) store2(grid + p * kGridPitch + u * kWin + 2 * t, c[2], c[3]);
    }
  };
  // two tiles' loads in flight ahead of the mma
  BTile<KS> b0, b1, b2;
  fetch(0, b0);
  fetch(1, b1);
  load_a_all<KS>(A.f1 + (size_t)e * kP2 * C, lane, a);
  for (int k = 0; k < ntiles; k += 3) {
    fetch(k + 2, b2);
    step(k, b0);
    fetch(k + 3, b0);
    step(k + 1, b1);
    fetch(k + 4, b1);
    step(k + 2, b2);
  }
  __syncwarp();

  // epilogue: row i of the output, i = p * 8 + r, from pixel p's window in
  // the grid at offset off (pitch `pitch`)
  const int off = fits ? (wy - y0) * pitch + (wx - x0) : 0;
#pragma unroll
  for (int i0 = 0; i0 < kP2 * kWin; i0 += 32) {
    const int i = i0 + lane, p = min(i >> 3, kP2 - 1), r = i & 7;
    const __nv_bfloat16* w = grid + p * kGridPitch + __shfl_sync(kFull, off, p) + r * pitch;
    if constexpr (kEpi == Epi::kWindow) {
      if (i < kP2 * kWin)
        o[i] = make_uint4(pack2(w[0], w[1]), pack2(w[2], w[3]), pack2(w[4], w[5]),
                          pack2(w[6], w[7]));
      continue;
    }
    const float pfy = __shfl_sync(kFull, fy, p), pfx = __shfl_sync(kFull, fx, p);
    const float pv = __shfl_sync(kFull, v, p);
    if (i >= kP2 * kWin) continue;
    float val[kWin];
    val[kWin - 1] = 0.f;
    if (r == kWin - 1) {
      o[i] = make_uint4(0, 0, 0, 0);  // the last output row is zero
      continue;
    }
    if constexpr (kEpi == Epi::kSw) {
      // level_sw: o = ((w00 a + w01 b) + w10 c) + w11 d over window rows r
      // (a, b) and r + 1 (c, d), columns c and c + 1, f32, each product
      // and sum rounded as torch's separate ops round them (no FMA), the
      // weights as _bilinear_weights forms them
      const float oy = __fsub_rn(1.f, pfy), ox = __fsub_rn(1.f, pfx);
      const float w00 = __fmul_rn(__fmul_rn(oy, ox), pv);
      const float w01 = __fmul_rn(__fmul_rn(oy, pfx), pv);
      const float w10 = __fmul_rn(__fmul_rn(pfy, ox), pv);
      const float w11 = __fmul_rn(__fmul_rn(pfy, pfx), pv);
      float top[kWin], bot[kWin];
#pragma unroll
      for (int c = 0; c < kWin; ++c) {
        top[c] = __bfloat162float(w[c]);
        bot[c] = __bfloat162float(w[pitch + c]);
      }
#pragma unroll
      for (int c = 0; c < kWin - 1; ++c) {
        float acc = __fadd_rn(__fmul_rn(w00, top[c]), __fmul_rn(w01, top[c + 1]));
        acc = __fadd_rn(acc, __fmul_rn(w10, bot[c]));
        val[c] = __fadd_rn(acc, __fmul_rn(w11, bot[c + 1]));
      }
    } else {
      // D's row stage at columns dxw .. dxw + 7 of output row r: the live
      // taps a = dy (window row r) and a = dy + 1 (row r + 1), each product
      // and running sum rounded to bf16 (merged_tap(k, a) depends only on
      // k == a and k == a - 1)
      const float ta0 = merged_tap(0, 0, pfy), ta1 = merged_tap(0, 1, pfy);
      float tmp[kWin];
#pragma unroll
      for (int c = 0; c < kWin; ++c) {
        float acc = 0.f;
        acc = bf16_round(__fadd_rn(acc, bf16_round(__fmul_rn(ta0, __bfloat162float(w[c])))));
        acc = bf16_round(
            __fadd_rn(acc, bf16_round(__fmul_rn(ta1, __bfloat162float(w[pitch + c])))));
        tmp[c] = acc;
      }
      // the column stage: the live taps b = dxw and b = dxw + 1, in that
      // order, f32; outputs 0..6 kept, 7 zero
      const float w0 = __fmul_rn(merged_tap(0, 0, pfx), pv);
      const float w1 = __fmul_rn(merged_tap(0, 1, pfx), pv);
#pragma unroll
      for (int c = 0; c < kWin - 1; ++c) {
        float acc = 0.f;
        acc = __fadd_rn(acc, __fmul_rn(w0, tmp[c]));
        acc = __fadd_rn(acc, __fmul_rn(w1, tmp[c + 1]));
        val[c] = acc;
      }
    }
    uint32_t q[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(val[2 * h], val[2 * h + 1]);
      q[h] = *reinterpret_cast<const uint32_t*>(&b);
    }
    o[i] = make_uint4(q[0], q[1], q[2], q[3]);
  }
}

// three kernels of one body, so that a profile names them apart
template <int KS>
__global__ void __launch_bounds__(32 * kItemWarps) window_union_kernel(const UnionArgs args) {
  __shared__ __align__(16) __nv_bfloat16 grids[kItemWarps][kP2 * kGridPitch];
  union_item<Epi::kWindow, KS>(args, grids[threadIdx.x >> 5]);
}

template <int KS>
__global__ void __launch_bounds__(32 * kItemWarps) sw_fused_kernel(const UnionArgs args) {
  __shared__ __align__(16) __nv_bfloat16 grids[kItemWarps][kP2 * kGridPitch];
  union_item<Epi::kSw, KS>(args, grids[threadIdx.x >> 5]);
}

template <int KS>
__global__ void __launch_bounds__(32 * kItemWarps) v3_fused_kernel(const UnionArgs args) {
  __shared__ __align__(16) __nv_bfloat16 grids[kItemWarps][kP2 * kGridPitch];
  union_item<Epi::kV3, KS>(args, grids[threadIdx.x >> 5]);
}

// calls f(std::integral_constant<int, KS>) for the channel counts the port
// meets (FDIM 32 to 256: KS = C / 16 k-steps)
template <class F>
int by_channels(int C, F&& f) {
  switch (C) {
    case 32: return f(std::integral_constant<int, 2>{});
    case 64: return f(std::integral_constant<int, 4>{});
    case 128: return f(std::integral_constant<int, 8>{});
    case 256: return f(std::integral_constant<int, 16>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

template <class Kernel>
int launch_union(Kernel kernel, const UnionArgs& a, void* stream) {
  if (a.E > 0)
    kernel<<<(a.E + kItemWarps - 1) / kItemWarps, 32 * kItemWarps, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dpvo_corr_window(const void* f1, const void* fmap, const void* jj,
                                const void* valid, const void* sy, const void* sx, void* out,
                                int E, int mem, int H, int W, int C, void* stream) {
  const UnionArgs a = {(const __nv_bfloat16*)f1, (const __nv_bfloat16*)fmap, (const int*)jj,
                       (const uint8_t*)valid, (const int*)sy, (const int*)sx, nullptr, nullptr,
                       nullptr, nullptr, nullptr, (__nv_bfloat16*)out, E, mem, H, W};
  return by_channels(C, [&](auto ks) {
    return launch_union(window_union_kernel<decltype(ks)::value>, a, stream);
  });
}

// B and C+D's arguments: the superwindow corner (syc, sxc) [E], the
// pixels' window offsets (dy, dxw) and bilinear terms (dyf, dxf, vf) [E, 9]
static UnionArgs superwindow_args(const void* f1, const void* fmap, const void* jj,
                                  const void* valid, const void* syc, const void* sxc,
                                  const void* dy, const void* dxw, const void* dyf,
                                  const void* dxf, const void* vf, void* out, int E, int mem,
                                  int H, int W) {
  return {(const __nv_bfloat16*)f1, (const __nv_bfloat16*)fmap, (const int*)jj,
          (const uint8_t*)valid, (const int*)syc, (const int*)sxc, (const int*)dy,
          (const int*)dxw, (const float*)dyf, (const float*)dxf, (const float*)vf,
          (__nv_bfloat16*)out, E, mem, H, W};
}

extern "C" int dpvo_corr_sw_fused(const void* f1, const void* fmap, const void* jj,
                                  const void* valid, const void* syc, const void* sxc,
                                  const void* dy, const void* dxw, const void* dyf,
                                  const void* dxf, const void* vf, void* out, int E, int mem,
                                  int H, int W, int C, void* stream) {
  const UnionArgs a = superwindow_args(f1, fmap, jj, valid, syc, sxc, dy, dxw, dyf, dxf, vf, out,
                                       E, mem, H, W);
  return by_channels(C, [&](auto ks) {
    return launch_union(sw_fused_kernel<decltype(ks)::value>, a, stream);
  });
}

extern "C" int dpvo_corr_v3_fused(const void* f1, const void* fmap, const void* jj,
                                  const void* valid, const void* syc, const void* sxc,
                                  const void* dy, const void* dxw, const void* dyf,
                                  const void* dxf, const void* vf, void* out, int E, int mem,
                                  int H, int W, int C, void* stream) {
  const UnionArgs a = superwindow_args(f1, fmap, jj, valid, syc, sxc, dy, dxw, dyf, dxf, vf, out,
                                       E, mem, H, W);
  return by_channels(C, [&](auto ks) {
    return launch_union(v3_fused_kernel<decltype(ks)::value>, a, stream);
  });
}
