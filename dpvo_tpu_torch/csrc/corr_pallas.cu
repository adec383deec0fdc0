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
// mask; f32 accumulation), giving [E, 9, 168] bf16. Only 2 + 2 of those
// taps carry weight, and the kernel evaluates only those, with the same
// rounding points; its arithmetic avoids contraction into FMAs (__fmul_rn /
// __fadd_rn), so it matches the plain version (all 26 taps) value for
// value wherever s is finite (the dead taps add +-0).
//
// What bounds them on an H100. A, B and C: per edge and level 9 x N x C
// MACs (N = 64, 448, 384 positions; C = 128), 11 to 77 GFLOP per call at
// the steady state's 37k edges: on the bf16 tensor cores that is tens of
// microseconds, below the bytes. The bytes are the output (E x 9 x N bf16:
// 0.6 GB per call for B), the frames the edges touch and the patch rows;
// so memory bounds them (measured: 1.1 ms per call against 0.07-0.23 ms;
// the loads of one edge's window rows are short and scattered). D: its
// function needs half of C's output (0.28 GB per level at 40960 rows)
// and writes 0.12 GB, so memory bounds it: per pixel the 384 live bytes of
// its 768-byte row of s, five per-pixel inputs and 336 output bytes.
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
// which still costs less than the loads. D: one warp per (edge, pixel),
// eight per block, no block barrier; 16-byte loads of the two live rows,
// the row stage in registers, the shift by dxw by shuffles, 16-byte stores
// (see epilogue_kernel).
//
// Later work (not needed for correctness): stage the superwindow in
// shared memory with TMA and share it between the warps, and fuse D into C
// so the raw superwindow never reaches device memory.

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
constexpr int kCS3 = 24, kSW3 = 16 * kCS3, kW7 = 7 * kCS3;
constexpr int kEpiWarps = 8;  // pixels per block, one warp each

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// (k == a) * (1 - f) + (k == a - 1) * f, as the JAX expression rounds it
__device__ __forceinline__ float merged_tap(int k, int a, float f) {
  return __fadd_rn(__fmul_rn(k == a ? 1.f : 0.f, __fsub_rn(1.f, f)),
                   __fmul_rn(k == a - 1 ? 1.f : 0.f, f));
}

// the 8 bf16 values of a 16-byte vector, as f32 (exact)
__device__ __forceinline__ void unpack8(const uint4& v, float (&x)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// the column stage of 8 outputs k0 + j from the 16 row-stage values t[i] =
// tmp[k0 + 8q + i], where dxw = 8q + R: the live taps b = dxw (t[j + R])
// and b = dxw + 1 (t[j + R + 1]), in that order, as the f32 sum over all
// 17 taps adds them; the dead taps would add +-0
template <int R>
__device__ __forceinline__ uint4 column_taps(const float (&t)[16], float w0, float w1, bool l0,
                                             bool l1) {
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float acc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * i + h;
      acc[h] = 0.f;
      if (l0) acc[h] = __fadd_rn(acc[h], __fmul_rn(w0, t[j + R]));
      if (l1) acc[h] = __fadd_rn(acc[h], __fmul_rn(w1, t[j + R + 1]));
    }
    const __nv_bfloat162 b = __floats2bfloat162_rn(acc[0], acc[1]);
    o[i] = *reinterpret_cast<const uint32_t*>(&b);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// One warp per (edge, pixel). Of the 9 row taps (a) and 17 column taps (b)
// that _make_epi_kernel evaluates, merged_tap is nonzero only at a = dy,
// dy + 1 and b = dxw, dxw + 1; the others add +-0 to a running sum, which
// for finite s changes no value (at most the sign of a zero). So a lane L <
// 21 reads chunk L (8 values, 16 bytes) of the two live rows of s: the
// pixel's 384 live bytes of 768. It computes row-stage values 8L .. 8L + 7
// with the same bf16 rounds; lanes 21-23 stand for the stage's zero columns
// 168-191. The column stage takes the two stage chunks that its 8 outputs
// reach by shuffles and writes them as one 16-byte store.
__global__ void __launch_bounds__(32 * kEpiWarps)
epilogue_kernel(const __nv_bfloat16* __restrict__ s, const int* __restrict__ dy,
                const int* __restrict__ dxw, const float* __restrict__ dyf,
                const float* __restrict__ dxf, const float* __restrict__ vf,
                __nv_bfloat16* __restrict__ out, int n_pix) {
  const int lane = threadIdx.x & 31;
  const int P = blockIdx.x * kEpiWarps + (threadIdx.x >> 5);
  if (P >= n_pix) return;
  const int d = dy[P], c = dxw[P];
  const float fy = dyf[P], fx = dxf[P], v = vf[P];
  // row stage
  const bool la0 = d >= 0 && d < 9, la1 = d + 1 >= 0 && d + 1 < 9;
  const float ta0 = merged_tap(d, d, fy), ta1 = merged_tap(d, d + 1, fy);
  uint32_t tw[4] = {0u, 0u, 0u, 0u};  // row-stage chunk `lane`, bf16 pairs
  if (lane < kW7 / 8) {
    const __nv_bfloat16* sp = s + (size_t)P * kSW3 + 8 * lane;
    const uint4 zero = make_uint4(0, 0, 0, 0);
    const uint4 r0 = la0 ? *reinterpret_cast<const uint4*>(sp + d * kCS3) : zero;
    const uint4 r1 = la1 ? *reinterpret_cast<const uint4*>(sp + (d + 1) * kCS3) : zero;
    float x0[8], x1[8];
    unpack8(r0, x0);
    unpack8(r1, x1);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float t[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * i + h;
        float acc = 0.f;
        if (la0) acc = bf16_round(__fadd_rn(acc, bf16_round(__fmul_rn(ta0, x0[j]))));
        if (la1) acc = bf16_round(__fadd_rn(acc, bf16_round(__fmul_rn(ta1, x1[j]))));
        t[h] = acc;
      }
      // both bf16-exact: their high halves are the bf16 values
      tw[i] = (__float_as_uint(t[0]) >> 16) | (__float_as_uint(t[1]) & 0xffff0000u);
    }
  }
  // column stage: outputs 8 lane .. 8 lane + 7 read stage chunks lane + q
  // and lane + q + 1 (dxw = 8q + R, q = floor(dxw / 8))
  const int q = c >> 3, R = c & 7;
  const bool l0 = c >= 0 && c < 17, l1 = c + 1 >= 0 && c + 1 < 17;
  const float w0 = __fmul_rn(merged_tap(c, c, fx), v);
  const float w1 = __fmul_rn(merged_tap(c, c + 1, fx), v);
  float t[16];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int src = (lane + q + h) & 31;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t w = __shfl_sync(0xffffffffu, tw[i], src);
      t[8 * h + 2 * i] = __uint_as_float(w << 16);
      t[8 * h + 2 * i + 1] = __uint_as_float(w & 0xffff0000u);
    }
  }
  if (lane >= kW7 / 8) return;
  uint4 o;
  switch (R) {  // the same for the whole warp
    case 0: o = column_taps<0>(t, w0, w1, l0, l1); break;
    case 1: o = column_taps<1>(t, w0, w1, l0, l1); break;
    case 2: o = column_taps<2>(t, w0, w1, l0, l1); break;
    case 3: o = column_taps<3>(t, w0, w1, l0, l1); break;
    case 4: o = column_taps<4>(t, w0, w1, l0, l1); break;
    case 5: o = column_taps<5>(t, w0, w1, l0, l1); break;
    case 6: o = column_taps<6>(t, w0, w1, l0, l1); break;
    default: o = column_taps<7>(t, w0, w1, l0, l1); break;
  }
  *reinterpret_cast<uint4*>(out + (size_t)P * kW7 + 8 * lane) = o;
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
  const int n_pix = E * kP2;
  if (n_pix > 0)
    epilogue_kernel<<<(n_pix + kEpiWarps - 1) / kEpiWarps, 32 * kEpiWarps, 0,
                      (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)s, (const int*)dy, (const int*)dxw, (const float*)dyf,
        (const float*)dxf, (const float*)vf, (__nv_bfloat16*)out, n_pix);
  return (int)cudaGetLastError();
}
