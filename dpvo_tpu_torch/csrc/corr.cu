// Two-level sparse patch correlation, exact per-pixel windows, for Hopper.
//
// Replaces the TPU kernel dpvo_tpu/ops/corr_pallas.py:_make_kernel_v4
// (built at :714, launched by _corr_features_v4 at :949, entry point
// corr_features_pallas_fused). Unlike v4 it computes the exact
// reference altcorr semantics: every patch pixel's (2r+2)^2 window
// around its own reprojected position, zero outside the image, both
// pyramid levels (level 2 at coords / 4), then the 2x2 bilinear
// reduction to (2r+1)^2. It equals v4 wherever v4's +-3 px window clamp
// does not bite, and dpvo_tpu_torch/ops/corr.py:corr_features_plain
// everywhere (up to f32 summation order before the bf16 store).
//
// Output: the canonical layout out[e, p, l*64 + u*8 + v] (bf16), p the
// patch pixel, l the level, (u, v) = (dy, dx) with the last row and
// column of each 8x8 block zero; edges with valid == 0 (or an index out
// of range) are written as zeros.
//
// What bounds it on an H100: memory. Per edge it reads 2 x 9 x 64 feature
// vectors of C channels (the windows overlap heavily, so most of that
// comes from L1/L2) and does 2 x 9 x 64 x C MACs: ~11 GFLOP at the
// steady-state 37k edges, far under the card's rate, while the distinct
// frame features it touches (~22 frames x 5 MB bf16) set a floor of
// ~30 us at 3.35 TB/s.
//
// Design: one 256-thread block per edge. The edge's 9 x C patch features
// are staged in shared memory as f32. Each warp computes one window row
// (8 positions) of one pixel and level at a time: 8 groups of 4 lanes,
// one group per window column; the 4 lanes of a group split the C
// channels in interleaved 8-channel chunks (16-byte loads of bf16), so
// one warp reads the row's 8 neighbouring feature vectors as one
// contiguous span, and the group sums with two shuffles. The raw 8x8
// dot grids go to shared memory; the bilinear epilogue writes the
// canonical row directly. Accumulation is f32.
//
// Later work (not needed for correctness): stage the union window of the
// 9 pixels in shared memory once, process edges in target-frame order
// (corr_sort_order) for L2 reuse, and use tensor cores for the dots.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRadius = 3;
constexpr int kD = 2 * kRadius + 2;  // 8
constexpr int kP2 = 9;               // 3x3 patch pixels
constexpr int kOutW = 2 * kD * kD;   // 128 canonical values per pixel
constexpr int kThreads = 256;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
corr_kernel(const T* __restrict__ gmap, const T* __restrict__ fmap1,
            const T* __restrict__ fmap2, const float* __restrict__ coords,
            const int* __restrict__ ii1, const int* __restrict__ jj1,
            const uint8_t* __restrict__ valid, __nv_bfloat16* __restrict__ out,
            int Np, int mem, int C, int H1, int W1, int H2, int W2) {
  extern __shared__ float smem[];
  float* f1 = smem;              // [C][9] patch features (gmap row layout)
  float* raw = f1 + C * kP2;     // [2][9][8][8] raw window dots
  __shared__ int base[2][kP2][2];     // window corner (x, y) per level/pixel
  __shared__ float frac[2][kP2][2];   // fractional (x, y)

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
    float x = coords[((size_t)e * kP2 + p) * 2 + 0];
    float y = coords[((size_t)e * kP2 + p) * 2 + 1];
    if (lvl == 1) {
      x = x / 4.0f;
      y = y / 4.0f;
    }
    const float x0 = floorf(x), y0 = floorf(y);
    base[lvl][p][0] = (int)x0 - kRadius;
    base[lvl][p][1] = (int)y0 - kRadius;
    frac[lvl][p][0] = x - x0;
    frac[lvl][p][1] = y - y0;
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int gx = lane >> 2;  // window column handled by this lane group
  const int q = lane & 3;    // channel interleave within the group
  const int nchunk = C >> 3;
  for (int task = warp; task < 2 * kP2 * kD; task += kThreads / 32) {
    const int lvl = task / (kP2 * kD);
    const int p = (task / kD) % kP2;
    const int dy = task % kD;
    const int H = lvl ? H2 : H1, W = lvl ? W2 : W1;
    const int y = base[lvl][p][1] + dy;
    const int x = base[lvl][p][0] + gx;
    float acc = 0.f;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const T* src = (lvl ? fmap2 : fmap1) + (((size_t)jj * H + y) * W + x) * C;
      for (int j = q; j < nchunk; j += 4) {
        float v[8];
        load8(src + j * 8, v);
#pragma unroll
        for (int k = 0; k < 8; ++k) acc = fmaf(v[k], f1[(j * 8 + k) * kP2 + p], acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (q == 0) raw[((lvl * kP2 + p) * kD + dy) * kD + gx] = acc;
  }
  __syncthreads();

  for (int i = tid; i < kP2 * kOutW; i += kThreads) {
    const int p = i / kOutW, r = i % kOutW;
    const int lvl = r / (kD * kD), u = (r / kD) % kD, v = r % kD;
    float val = 0.f;
    if (u < kD - 1 && v < kD - 1) {
      const float fx = frac[lvl][p][0], fy = frac[lvl][p][1];
      const float* c = raw + (lvl * kP2 + p) * kD * kD;
      val = (1.f - fy) * (1.f - fx) * c[u * kD + v] + (1.f - fy) * fx * c[u * kD + v + 1] +
            fy * (1.f - fx) * c[(u + 1) * kD + v] + fy * fx * c[(u + 1) * kD + v + 1];
    }
    o[i] = __float2bfloat16_rn(val);
  }
}

template <typename T>
int launch(const void* gmap, const void* fmap1, const void* fmap2, const void* coords,
           const void* ii1, const void* jj1, const void* valid, void* out, int E, int Np,
           int mem, int C, int H1, int W1, int H2, int W2, cudaStream_t stream) {
  const size_t shmem = (size_t)(C * kP2 + 2 * kP2 * kD * kD) * sizeof(float);
  if (shmem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(corr_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  if (E > 0) {
    corr_kernel<T><<<E, kThreads, shmem, stream>>>(
        (const T*)gmap, (const T*)fmap1, (const T*)fmap2, (const float*)coords,
        (const int*)ii1, (const int*)jj1, (const uint8_t*)valid, (__nv_bfloat16*)out, Np, mem, C,
        H1, W1, H2, W2);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dpvo_corr_features(const void* gmap, const void* fmap1, const void* fmap2,
                                  const void* coords, const void* ii1, const void* jj1,
                                  const void* valid, void* out, int E, int Np, int mem, int C,
                                  int H1, int W1, int H2, int W2, int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(gmap, fmap1, fmap2, coords, ii1, jj1, valid, out, E, Np, mem, C,
                                 H1, W1, H2, W2, s);
  return launch<float>(gmap, fmap1, fmap2, coords, ii1, jj1, valid, out, E, Np, mem, C, H1, W1,
                       H2, W2, s);
}
