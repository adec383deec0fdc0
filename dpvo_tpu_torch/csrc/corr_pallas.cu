// The correlation kernels behind CORR_IMPL = pallas, pallas_sw and
// pallas_dma, for Hopper (wrappers: dpvo_tpu_torch/ops/corr_pallas.py).
//
// Replaces four TPU kernels of dpvo_tpu/ops/corr_pallas.py:
//   A  _make_kernel     (pallas_call at :188, _corr_level)    dpvo_corr_window
//   B  _make_kernel_sw  (pallas_call at :336, _corr_level_sw) dpvo_corr_superwindow_sw
//   C  _make_kernel_v3  (pallas_call at :620, _corr_level_v3) dpvo_corr_superwindow_v3
//   D  _make_epi_kernel (pallas_call at :552, _epi_pallas)    dpvo_corr_epilogue_v3
//
// A, B and C compute what the TPU kernels compute: per edge e (edges
// sorted by the caller; the order does not change any value), bf16 dot
// products of the patch features f1[e, p, :] (p < 9) with frame feature
// vectors of slot jj[e], accumulated in f32 and rounded once to bf16.
// Out-of-image positions read zero (the TPU's zero-bordered frame cache;
// here the reads are bounds-checked, no padded copy is made). Invalid
// edges are written as zeros (the TPU zero-fills them too). The window
// corners come from torch, computed exactly as the JAX code computes them.
//   A: out[e, p, u*8 + v]    = f1[e,p] . map[jj, sy[e,p] + u, sx[e,p] + v]
//      (each pixel's exact 8x8 window; the TPU emits an 8-aligned 8x16
//      strip per pixel, a sublane rule, from which XLA selects the same
//      values: the port emits the window itself)
//   B: out[e, p, r*32 + c]   = f1[e,p] . map[jj, syc[e] + r, sxc[e] + c]  (14 x 32)
//   C: out[e, p, r*24 + c]   = the same over a 16 x 24 superwindow
// D is the v3 epilogue: per pixel 9 row taps (the row one-hot merged with
// the y-bilinear; each product and each running sum rounded to bf16, as
// the TPU's bf16 scratch tmp_r is) and 17 column taps (the column one-hot,
// 8-alignment remainder included, merged with the x-bilinear and the pixel
// mask; f32 accumulation), giving [E, 9, 168] bf16. Its arithmetic avoids
// contraction into FMAs (__fmul_rn / __fadd_rn), so it matches the plain
// version bit for bit.
//
// What bounds them on an H100. A, B and C: per edge and level 9 x N x C
// MACs (N = 64, 448, 384 positions; C = 128), 11 to 77 GFLOP per call at
// the steady state's 37k edges: on the bf16 tensor cores that is tens of
// microseconds, below the bytes. The bytes are the output (E x 9 x N bf16:
// 0.6 GB per call for B), the frames the edges touch and the patch rows;
// so memory bounds them (measured: 1.1 ms per call against 0.07-0.23 ms;
// the loads of one edge's window rows are short and scattered). D: it
// reads C's output (0.26 GB per level) and writes 40% of that, so its
// bound is memory, but the design below is bound by its instructions.
//
// Design of A, B and C: one 128-thread block (4 warps) per edge. The
// dots run on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
// accumulate): the A operand is the edge's 9 patch rows padded to 16
// (loaded once per warp into registers, 4 x C/16 registers), the B
// operand is 8 neighbouring frame positions of one window or superwindow
// row, read straight from the NHWC map, where a position's C channels are
// contiguous, which is the operand's column layout: with the channel
// order below, each lane reads 16 bytes per 32 channels. One tile is 8
// positions x 16 rows; a warp walks tiles. For A only row p of a tile is
// kept (pixel p's own window), 9x more tensor-core work than needed,
// which still costs less than the loads. D: one 256-thread block per
// edge; the row stage goes to shared memory, then each thread sums 17
// column taps for its outputs. D evaluates all 9 + 17 taps, as the TPU
// kernel does, though only 2 + 2 carry weight: it is bound by those
// instructions, not by its bytes.
//
// Later work (not needed for correctness): stage the superwindow in
// shared memory with TMA and share it between the warps, fuse D into C so
// the raw superwindow never reaches device memory, and let D evaluate only
// its live taps where the input is finite.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kP2 = 9;  // patch pixels
constexpr int kTileThreads = 128;

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

// dots of the 16 A rows with the 8 positions (y, x0 + n), n < 8, of map
// slot `frame` [H, W, C = KS * 16]; out-of-image positions are zero.
// c[0..1]: row g, positions 2t, 2t+1; c[2..3]: row g + 8.
template <int KS>
__device__ __forceinline__ void tile_dots(const uint32_t (&a)[KS][4],
                                          const __nv_bfloat16* frame, int H, int W, int y,
                                          int x0, int lane, float* c) {
  static_assert(KS % 2 == 0, "channels come in chunks of 32");
  constexpr int C = KS * 16;
  const int g = lane >> 2, t = lane & 3;
  const int x = x0 + g;  // this lane's B column (position)
  const bool in = y >= 0 && y < H && x >= 0 && x < W;
  const __nv_bfloat16* src = frame + ((size_t)(in ? y : 0) * W + (in ? x : 0)) * C + 8 * t;
  c[0] = c[1] = c[2] = c[3] = 0.f;
#pragma unroll
  for (int j = 0; j < KS / 2; ++j) {
    const uint4 v = in ? *reinterpret_cast<const uint4*>(src + 32 * j) : make_uint4(0, 0, 0, 0);
    const uint32_t b[2][2] = {{v.x, v.y}, {v.z, v.w}};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t* ak = a[2 * j + h];
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
          : "r"(ak[0]), "r"(ak[1]), "r"(ak[2]), "r"(ak[3]), "r"(b[h][0]), "r"(b[h][1]));
    }
  }
}

__device__ __forceinline__ void store2(__nv_bfloat16* dst, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
}

__device__ __forceinline__ void zero_fill(__nv_bfloat16* o, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) o[i] = __float2bfloat16_rn(0.f);
}

// kernel A: per pixel p and window row u, one tile of 8 positions; only
// row p of the tile is stored
template <int KS>
__global__ void __launch_bounds__(kTileThreads)
window_kernel(const __nv_bfloat16* __restrict__ f1, const __nv_bfloat16* __restrict__ fmap,
              const int* __restrict__ jj, const uint8_t* __restrict__ valid,
              const int* __restrict__ sy, const int* __restrict__ sx,
              __nv_bfloat16* __restrict__ out, int mem, int H, int W) {
  constexpr int C = KS * 16;
  const int e = blockIdx.x;
  __nv_bfloat16* o = out + (size_t)e * kP2 * 64;
  const int j = jj[e];
  if (!valid[e] || j < 0 || j >= mem) {
    zero_fill(o, kP2 * 64);
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  uint32_t a[KS][4];
  load_a_all<KS>(f1 + (size_t)e * kP2 * C, lane, a);
  const __nv_bfloat16* frame = fmap + (size_t)j * H * W * C;
  for (int task = warp; task < kP2 * 8; task += kTileThreads / 32) {
    const int p = task >> 3, u = task & 7;
    float c[4];
    tile_dots<KS>(a, frame, H, W, sy[e * kP2 + p] + u, sx[e * kP2 + p], lane, c);
    if (g == p) store2(o + p * 64 + u * 8 + 2 * t, c[0], c[1]);
    if (g + 8 == p) store2(o + p * 64 + u * 8 + 2 * t, c[2], c[3]);
  }
}

// kernels B and C: the R x CW superwindow at (syc, sxc), tiles of 8
// columns, all 9 rows stored
template <int R, int CW, int KS>
__global__ void __launch_bounds__(kTileThreads)
superwindow_kernel(const __nv_bfloat16* __restrict__ f1, const __nv_bfloat16* __restrict__ fmap,
                   const int* __restrict__ jj, const uint8_t* __restrict__ valid,
                   const int* __restrict__ syc, const int* __restrict__ sxc,
                   __nv_bfloat16* __restrict__ out, int mem, int H, int W) {
  static_assert(CW % 8 == 0, "superwindow columns come in tiles of 8");
  constexpr int C = KS * 16;
  constexpr int N = R * CW;
  const int e = blockIdx.x;
  __nv_bfloat16* o = out + (size_t)e * kP2 * N;
  const int j = jj[e];
  if (!valid[e] || j < 0 || j >= mem) {
    zero_fill(o, kP2 * N);
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  uint32_t a[KS][4];
  load_a_all<KS>(f1 + (size_t)e * kP2 * C, lane, a);
  const __nv_bfloat16* frame = fmap + (size_t)j * H * W * C;
  const int y0 = syc[e], x0 = sxc[e];
  for (int task = warp; task < R * (CW / 8); task += kTileThreads / 32) {
    const int r = task / (CW / 8), n0 = (task % (CW / 8)) * 8;
    float c[4];
    tile_dots<KS>(a, frame, H, W, y0 + r, x0 + n0, lane, c);
    store2(o + g * N + r * CW + n0 + 2 * t, c[0], c[1]);
    if (g == 0) store2(o + 8 * N + r * CW + n0 + 2 * t, c[2], c[3]);
  }
}

// kernel D
constexpr int kCS3 = 24, kSW3 = 16 * kCS3, kW7 = 7 * kCS3, kTmpW = kW7 + 24;
constexpr int kEpiThreads = 256;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// (k == a) * (1 - f) + (k == a - 1) * f, as the JAX expression rounds it
__device__ __forceinline__ float merged_tap(int k, int a, float f) {
  return __fadd_rn(__fmul_rn(k == a ? 1.f : 0.f, __fsub_rn(1.f, f)),
                   __fmul_rn(k == a - 1 ? 1.f : 0.f, f));
}

__global__ void __launch_bounds__(kEpiThreads)
epilogue_kernel(const __nv_bfloat16* __restrict__ s, const int* __restrict__ dy,
                const int* __restrict__ dxw, const float* __restrict__ dyf,
                const float* __restrict__ dxf, const float* __restrict__ vf,
                __nv_bfloat16* __restrict__ out) {
  __shared__ float tmp[kP2][kTmpW];
  const int e = blockIdx.x;
  const __nv_bfloat16* se = s + (size_t)e * kP2 * kSW3;
  for (int i = threadIdx.x; i < kP2 * kTmpW; i += kEpiThreads) {
    const int p = i / kTmpW, m = i % kTmpW;
    float acc = 0.f;
    if (m < kW7) {
      const int d = dy[e * kP2 + p];
      const float f = dyf[e * kP2 + p];
      for (int a = 0; a < 9; ++a) {
        const float term = bf16_round(__fmul_rn(merged_tap(d, a, f),
                                                __bfloat162float(se[p * kSW3 + a * kCS3 + m])));
        acc = bf16_round(__fadd_rn(acc, term));
      }
    }
    tmp[p][m] = acc;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kP2 * kW7; i += kEpiThreads) {
    const int p = i / kW7, k = i % kW7;
    const int d = dxw[e * kP2 + p];
    const float f = dxf[e * kP2 + p], v = vf[e * kP2 + p];
    float acc = 0.f;
    for (int b = 0; b < 17; ++b)
      acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(merged_tap(d, b, f), v), tmp[p][k + b]));
    out[((size_t)e * kP2 + p) * kW7 + k] = __float2bfloat16_rn(acc);
  }
}

// launches kernel<KS> for the channel counts the port meets (FDIM 32 to 256)
template <template <int> class K>
int launch_by_channels(int C, int E, const void* f1, const void* fmap, const void* jj,
                       const void* valid, const void* y, const void* x, void* out, int mem,
                       int H, int W, void* stream) {
  switch (C) {
    case 32: return K<2>::run(E, f1, fmap, jj, valid, y, x, out, mem, H, W, stream);
    case 64: return K<4>::run(E, f1, fmap, jj, valid, y, x, out, mem, H, W, stream);
    case 128: return K<8>::run(E, f1, fmap, jj, valid, y, x, out, mem, H, W, stream);
    case 256: return K<16>::run(E, f1, fmap, jj, valid, y, x, out, mem, H, W, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

#define TILE_KERNEL_ARGS                                                                    \
  (const __nv_bfloat16*)f1, (const __nv_bfloat16*)fmap, (const int*)jj,                    \
      (const uint8_t*)valid, (const int*)y, (const int*)x, (__nv_bfloat16*)out, mem, H, W

template <int KS>
struct Window {
  static int run(int E, const void* f1, const void* fmap, const void* jj, const void* valid,
                 const void* y, const void* x, void* out, int mem, int H, int W, void* stream) {
    if (E > 0) window_kernel<KS><<<E, kTileThreads, 0, (cudaStream_t)stream>>>(TILE_KERNEL_ARGS);
    return (int)cudaGetLastError();
  }
};

template <int R, int CW>
struct Superwindow {
  template <int KS>
  struct K {
    static int run(int E, const void* f1, const void* fmap, const void* jj, const void* valid,
                   const void* y, const void* x, void* out, int mem, int H, int W,
                   void* stream) {
      if (E > 0)
        superwindow_kernel<R, CW, KS><<<E, kTileThreads, 0, (cudaStream_t)stream>>>(
            TILE_KERNEL_ARGS);
      return (int)cudaGetLastError();
    }
  };
};

}  // namespace

extern "C" int dpvo_corr_window(const void* f1, const void* fmap, const void* jj,
                                const void* valid, const void* sy, const void* sx, void* out,
                                int E, int mem, int H, int W, int C, void* stream) {
  return launch_by_channels<Window>(C, E, f1, fmap, jj, valid, sy, sx, out, mem, H, W, stream);
}

extern "C" int dpvo_corr_superwindow_sw(const void* f1, const void* fmap, const void* jj,
                                        const void* valid, const void* syc, const void* sxc,
                                        void* out, int E, int mem, int H, int W, int C,
                                        void* stream) {
  return launch_by_channels<Superwindow<14, 32>::K>(C, E, f1, fmap, jj, valid, syc, sxc, out,
                                                   mem, H, W, stream);
}

extern "C" int dpvo_corr_superwindow_v3(const void* f1, const void* fmap, const void* jj,
                                        const void* valid, const void* syc, const void* sxc,
                                        void* out, int E, int mem, int H, int W, int C,
                                        void* stream) {
  return launch_by_channels<Superwindow<16, 24>::K>(C, E, f1, fmap, jj, valid, syc, sxc, out,
                                                   mem, H, W, stream);
}

extern "C" int dpvo_corr_epilogue_v3(const void* s, const void* dy, const void* dxw,
                                     const void* dyf, const void* dxf, const void* vf, void* out,
                                     int E, void* stream) {
  if (E > 0)
    epilogue_kernel<<<E, kEpiThreads, 0, (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)s, (const int*)dy, (const int*)dxw, (const float*)dyf,
        (const float*)dxf, (const float*)vf, (__nv_bfloat16*)out);
  return (int)cudaGetLastError();
}
