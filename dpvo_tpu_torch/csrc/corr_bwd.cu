// Backward pass of the two-level patch correlation (exact windows) for
// Hopper: the gradients of the patch features (per edge, reduced into the
// gmap rows afterwards by the sorted segment sum) and of both feature maps.
//
// Replaces no TPU kernel: the JAX package trains through XLA's autodiff
// of dpvo_tpu/ops/corr.py:corr_features_xla (:287), and the port computes
// that function's forward with corr.cu, which has no gradient of its own.
// It equals dpvo_tpu_torch/ops/corr.py:corr_backward_plain up to f32
// summation order (see that function for the arithmetic).
//
// Per edge e, level l (coords / 1, / 4), patch pixel p (9), window
// position (i, j) in 8 x 8 around (y0 - 3, x0 - 3):
//   G[l][p][i][j] = sum of the bilinear taps of g[e, p, l*64 + u*8 + v]
//                   landing on (i, j) (u, v < 7), zero off the image;
//   d f1[e][c][p] = sum_l sum_ij G * fmap_l[jj, y, x, c]
//   d fmap_l[jj, y, x, c] += sum_p G * f1[p][c]      (f32 atomics)
// Edges with valid == 0 write d f1 = 0 and add nothing; so does a pixel
// with non-finite coordinates.
//
// What bounds it on an H100: the d fmap scatter. Each (edge, level) adds
// into ~100 window positions of C floats; E = 18000 edges at the training
// shape give ~0.5 G f32 adds through L2 atomics and ~1 GB of feature reads
// (mostly from L1/L2: neighbouring edges of a frame share windows), where
// the bytes it must move (g, the features, the f32 gradient buffers, each
// once) are ~0.36 GB, ~0.11 ms at 3.35 TB/s (chip_smoke.py's bound).
//
// Design (the simple right one; a deterministic or faster design is a
// later item): one block of 128 threads per edge, both levels. The block
// spreads g over each pixel's window into shared memory (G, 2 x 9 x 64
// floats), then each thread takes one channel c at a time:
// - where the union of the 9 pixels' windows, clipped to the image, holds
//   at most kUnionMax positions (a real patch: ~10 x 10), the thread walks
//   the union once: per position one feature read, the taps of every
//   pixel whose window covers it, and one atomicAdd for all 9 pixels;
// - else (pixels spread apart) it walks each pixel's 64 positions.
// scripts/corr_bwd_walks.py times each walk alone on the training traffic
// and on spread patches, and sets kUnionMax between them (PERF.md).
// Consecutive threads take consecutive channels, so each position's reads
// and atomics are coalesced rows of C values. d f1 accumulates in
// registers in a fixed order (deterministic); the d fmap atomics make the
// last bits of two runs differ.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRadius = 3;
constexpr int kD = 8;        // window side (2r + 2)
constexpr int kOut = 7;      // bilinear output side (2r + 1)
constexpr int kP2 = 9;       // patch pixels
constexpr int kThreads = 128;
constexpr int kUnionMax = 256;
constexpr int kBlock = 2 * kD * kD;  // one pixel's 8 x 8 block per level in g: 128 values

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename TF, typename TG>
__global__ void __launch_bounds__(kThreads)
corr_bwd_kernel(const TG* __restrict__ g, const TF* __restrict__ gmap,
                const TF* __restrict__ fmap1, const TF* __restrict__ fmap2,
                const float* __restrict__ coords, const int* __restrict__ ii1,
                const int* __restrict__ jj1, const bool* __restrict__ valid,
                float* __restrict__ df1, float* __restrict__ dfm1, float* __restrict__ dfm2,
                int E, int Np, int mem, int C, int H1, int W1, int H2, int W2) {
  __shared__ float G[2][kP2][kD * kD];
  __shared__ int sy[2][kP2], sx[2][kP2];  // window corners (y0 - 3, x0 - 3), clamped
  __shared__ int box[2][4];               // clipped union: y lo, y hi, x lo, x hi (inclusive)
  const int e = blockIdx.x;
  const int tid = threadIdx.x;
  float* d1 = df1 + (size_t)e * C * kP2;
  const int row = ii1[e], fr = jj1[e];
  if (!valid[e] || row < 0 || row >= Np || fr < 0 || fr >= mem) {
    for (int k = tid; k < C * kP2; k += kThreads) d1[k] = 0.f;
    return;
  }

  // spread g over the windows: G[l][p][i][j]
  for (int k = tid; k < 2 * kP2 * kD * kD; k += kThreads) {
    const int l = k / (kP2 * kD * kD);
    const int p = (k / (kD * kD)) % kP2;
    const int i = (k / kD) % kD, j = k % kD;
    const int H = l ? H2 : H1, W = l ? W2 : W1;
    const float s = l ? 0.25f : 1.f;
    const float x = coords[((size_t)e * kP2 + p) * 2] * s;
    const float y = coords[((size_t)e * kP2 + p) * 2 + 1] * s;
    const bool fin = isfinite(x) && isfinite(y);
    const float xf = floorf(fminf(fmaxf(fin ? x : 0.f, -64.f), W + 64.f));
    const float yf = floorf(fminf(fmaxf(fin ? y : 0.f, -64.f), H + 64.f));
    const float fx = x - xf, fy = y - yf;
    const int x0 = (int)xf - kRadius, y0 = (int)yf - kRadius;
    const TG* gp = g + ((size_t)e * kP2 + p) * kBlock + l * kD * kD;
    float acc = 0.f;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int u = i - a;
      if (u < 0 || u >= kOut) continue;
      const float wy = a ? fy : 1.f - fy;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int v = j - b;
        if (v < 0 || v >= kOut) continue;
        acc += wy * (b ? fx : 1.f - fx) * to_f(gp[u * kD + v]);
      }
    }
    const int yy = y0 + i, xx = x0 + j;
    const bool ok = fin && yy >= 0 && yy < H && xx >= 0 && xx < W;
    G[l][p][i * kD + j] = ok ? acc : 0.f;
    if (i == 0 && j == 0) {
      // a non-finite pixel's corner lies off the map: it reads and adds nothing
      sy[l][p] = fin ? y0 : -1000;
      sx[l][p] = fin ? x0 : -1000;
    }
  }
  __syncthreads();
  if (tid < 2) {
    const int l = tid;
    const int H = l ? H2 : H1, W = l ? W2 : W1;
    int ylo = 1 << 30, yhi = -(1 << 30), xlo = 1 << 30, xhi = -(1 << 30);
    for (int p = 0; p < kP2; ++p) {
      if (sy[l][p] == -1000) continue;  // non-finite pixel
      ylo = min(ylo, sy[l][p]);
      yhi = max(yhi, sy[l][p] + kD - 1);
      xlo = min(xlo, sx[l][p]);
      xhi = max(xhi, sx[l][p] + kD - 1);
    }
    box[l][0] = max(ylo, 0);
    box[l][1] = min(yhi, H - 1);
    box[l][2] = max(xlo, 0);
    box[l][3] = min(xhi, W - 1);
  }
  __syncthreads();

  for (int c = tid; c < C; c += kThreads) {
    float f1[kP2], acc[kP2];
#pragma unroll
    for (int p = 0; p < kP2; ++p) {
      f1[p] = to_f(gmap[((size_t)row * C + c) * kP2 + p]);
      acc[p] = 0.f;
    }
    for (int l = 0; l < 2; ++l) {
      const int H = l ? H2 : H1, W = l ? W2 : W1;
      const TF* fm = (l ? fmap2 : fmap1) + (size_t)fr * H * W * C + c;
      float* dfm = (l ? dfm2 : dfm1) + (size_t)fr * H * W * C + c;
      const int ylo = box[l][0], yhi = box[l][1], xlo = box[l][2], xhi = box[l][3];
      if (ylo > yhi || xlo > xhi) continue;  // every window off the map
      if ((yhi - ylo + 1) * (xhi - xlo + 1) <= kUnionMax) {
        for (int y = ylo; y <= yhi; ++y) {
          for (int x = xlo; x <= xhi; ++x) {
            const float f = to_f(fm[((size_t)y * W + x) * C]);
            float add = 0.f;
            bool any = false;
#pragma unroll
            for (int p = 0; p < kP2; ++p) {
              const int i = y - sy[l][p], j = x - sx[l][p];
              if (i >= 0 && i < kD && j >= 0 && j < kD) {
                const float gv = G[l][p][i * kD + j];
                acc[p] += gv * f;
                add += gv * f1[p];
                any = true;
              }
            }
            if (any) atomicAdd(dfm + ((size_t)y * W + x) * C, add);
          }
        }
      } else {
#pragma unroll 1
        for (int p = 0; p < kP2; ++p) {
          for (int i = 0; i < kD; ++i) {
            const int y = sy[l][p] + i;
            if (y < 0 || y >= H) continue;
            for (int j = 0; j < kD; ++j) {
              const int x = sx[l][p] + j;
              if (x < 0 || x >= W) continue;
              const float gv = G[l][p][i * kD + j];
              const size_t off = ((size_t)y * W + x) * C;
              acc[p] += gv * to_f(fm[off]);
              atomicAdd(dfm + off, gv * f1[p]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kP2; ++p) d1[c * kP2 + p] = acc[p];
  }
}

template <typename TF, typename TG>
int launch(const void* g, const void* gmap, const void* fmap1, const void* fmap2,
           const void* coords, const void* ii1, const void* jj1, const void* valid, void* df1,
           void* dfm1, void* dfm2, int E, int Np, int mem, int C, int H1, int W1, int H2, int W2,
           cudaStream_t stream) {
  corr_bwd_kernel<TF, TG><<<E, kThreads, 0, stream>>>(
      (const TG*)g, (const TF*)gmap, (const TF*)fmap1, (const TF*)fmap2, (const float*)coords,
      (const int*)ii1, (const int*)jj1, (const bool*)valid, (float*)df1, (float*)dfm1,
      (float*)dfm2, E, Np, mem, C, H1, W1, H2, W2);
  return (int)cudaGetLastError();
}

}  // namespace

// g [E, 9, 128] (bf16 or f32: g_bf16); gmap [Np, C, 3, 3], fmap1 [mem, H1, W1, C], fmap2
// [mem, H2, W2, C] (bf16 or f32: feat_bf16); coords [E, 9, 2] f32 at level-1 scale; ii1, jj1
// int32, valid bool [E]. Writes df1 [E, C, 9] f32 and adds into dfm1 / dfm2 (f32, the maps'
// shapes, zeroed by the caller).
extern "C" int dpvo_corr_backward(const void* g, const void* gmap, const void* fmap1,
                                  const void* fmap2, const void* coords, const void* ii1,
                                  const void* jj1, const void* valid, void* df1, void* dfm1,
                                  void* dfm2, int E, int Np, int mem, int C, int H1, int W1,
                                  int H2, int W2, int feat_bf16, int g_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (E <= 0) return (int)cudaGetLastError();
  if (C <= 0) return (int)cudaErrorInvalidValue;
  if (feat_bf16 && g_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(g, gmap, fmap1, fmap2, coords, ii1, jj1, valid,
                                                df1, dfm1, dfm2, E, Np, mem, C, H1, W1, H2, W2, s);
  if (feat_bf16)
    return launch<__nv_bfloat16, float>(g, gmap, fmap1, fmap2, coords, ii1, jj1, valid, df1,
                                        dfm1, dfm2, E, Np, mem, C, H1, W1, H2, W2, s);
  if (g_bf16)
    return launch<float, __nv_bfloat16>(g, gmap, fmap1, fmap2, coords, ii1, jj1, valid, df1,
                                        dfm1, dfm2, E, Np, mem, C, H1, W1, H2, W2, s);
  return launch<float, float>(g, gmap, fmap1, fmap2, coords, ii1, jj1, valid, df1, dfm1, dfm2, E,
                              Np, mem, C, H1, W1, H2, W2, s);
}
