// Dense damped-SPD solve S x = y by a Cholesky factorization S = L L^T and
// two triangular solves, in one warp group, for Hopper.
//
// Replaces the TPU kernel dpvo_tpu/ba/spd_solve.py:_gj_kernel (launched by
// _spd_solve_impl at :81; call site ba/solver.py:251-256): the
// sliding-window BA pose system, n = 6 * W_OPT_MAX <= 96, f32. The TPU
// kernel eliminates Gauss-Jordan style; this one factorizes, which is
// about 6x less work (n^3/3 + 2n^2, ~0.31 MFLOP at n = 96, against
// 2n^2(n+1)) and the same solution for a symmetric positive definite S.
// It reads the lower triangle of S only (S is symmetric). The same kernel
// serves the backward pass (the adjoint of a symmetric solve is another
// solve, see ba/spd_solve.py).
//
// Unlike Gauss-Jordan, which divides by whatever pivot it meets, the
// factorization takes 1/sqrt of each pivot: an S that is not positive
// definite (a pivot <= 0), or a NaN in it, gives a non-finite x, which
// ba/solver.py:schur_solve turns into a zero update. BA never produces
// such an S: it is damped (S_ii += 1e-4 S_ii + ep, ep = 1).
//
// What bounds it on an H100: latency. Its bytes (37 KB) take 0.01 us at
// 3.35 TB/s and its operations 0.6 us at one SM's f32 rate, but its n
// factorization steps form a dependency chain (each pivot waits for the
// previous update), and so do the 2n steps of the two triangular solves.
// The time is the chain's length times the latency of one step.
//
// Design: one block of 128 threads (one warp group). Thread (ty, tx) =
// (tid / 8, tid % 8) holds the 6 x 12 elements S[ty + 16a][tx + 8b] in
// registers (the loops over them unrolled, the step loop split by
// register column, so never indexed at run time). Step k: the 16
// threads holding column k publish it to shared memory (two buffers, so
// one barrier a step), one named barrier (bar.sync 1, 128), then each
// thread scales its rows' and columns' entries of the column by
// 1/sqrt(pivot) and applies the rank-1 update to its elements of the
// trailing lower triangle; a warp skips the blocks of its registers that
// lie above the diagonal or left of column k. L's column k and the
// pivot's 1/sqrt go to shared memory. Then one warp solves L z = y and
// L^T x = z with 3 rows per lane in registers, each step's unknown
// broadcast by a shuffle. No index is divided at run time.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 96;
constexpr int kThreads = 128;
constexpr int kRowsPer = kMaxN / 16;  // rows a thread holds: ty + 16a
constexpr int kColsPer = kMaxN / 8;   // columns a thread holds: tx + 8b
constexpr int kLd = kMaxN + 1;        // L's row stride (no bank conflicts down a column)

__device__ __forceinline__ void group_barrier() { asm volatile("bar.sync 1, 128;\n" ::: "memory"); }

__global__ void __launch_bounds__(kThreads)
cholesky_solve_kernel(const float* __restrict__ S, const float* __restrict__ y,
                      float* __restrict__ x, int n) {
  __shared__ float L[kMaxN * kLd];  // L[i][k] for i > k
  __shared__ float col[2][kMaxN];   // column k of the updated matrix
  __shared__ float rdiag[kMaxN];    // 1 / sqrt(pivot k)
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7, warp = tid >> 5, lane = tid & 31;
  // the warp's largest row in register row a is 16a + 4 warp + 3
  const int wrow = 4 * warp + 3;

  float a[kRowsPer][kColsPer];
#pragma unroll
  for (int r = 0; r < kRowsPer; ++r)
#pragma unroll
    for (int c = 0; c < kColsPer; ++c) {
      const int i = ty + 16 * r, j = tx + 8 * c;
      a[r][c] = (i < n && j < n) ? S[i * n + j] : 0.f;
    }

  // Step k = 8 cb + kk. The register column that holds column k is cb,
  // a constant of each unrolled copy of the loop body, so the registers
  // are never indexed at run time (a run-time index would move them to
  // local memory), and the columns left of cb are skipped at compile time.
#pragma unroll
  for (int cb = 0; cb < kColsPer; ++cb) {
    for (int kk = 0; kk < 8; ++kk) {
      const int k = 8 * cb + kk;
      if (k >= n) break;
      float* ck = col[k & 1];
      if (tx == kk) {
#pragma unroll
        for (int r = 0; r < kRowsPer; ++r) ck[ty + 16 * r] = a[r][cb];
      }
      group_barrier();
      const float rk = rsqrtf(ck[k]);
      if (tid > k && tid < n) L[tid * kLd + k] = ck[tid] * rk;
      if (tid == 0) rdiag[k] = rk;
      float li[kRowsPer], lj[kColsPer];
#pragma unroll
      for (int r = 0; r < kRowsPer; ++r) li[r] = ck[ty + 16 * r] * rk;
#pragma unroll
      for (int c = cb; c < kColsPer; ++c) lj[c] = ck[tx + 8 * c] * rk;
      // a[i][j] -= l_i l_j on i >= j > k; an element outside that range
      // is never read again, so a block that holds some is updated whole
#pragma unroll
      for (int r = 0; r < kRowsPer; ++r) {
        if (16 * r + wrow <= k) continue;
#pragma unroll
        for (int c = cb; c < kColsPer; ++c) {
          if (8 * c > 16 * r + wrow) continue;
          a[r][c] = fmaf(-li[r], lj[c], a[r][c]);
        }
      }
    }
  }
  group_barrier();

  if (warp == 0) {
    float z[3];  // rows lane, lane + 32, lane + 64
#pragma unroll
    for (int m = 0; m < 3; ++m) z[m] = lane + 32 * m < n ? y[lane + 32 * m] : 0.f;
    // L z = y: step k = 32 m + kk, m unrolled so z[m] is a register
#pragma unroll
    for (int m = 0; m < 3; ++m)
      for (int kk = 0; kk < 32 && 32 * m + kk < n; ++kk) {
        const int k = 32 * m + kk;
        const float zk = __shfl_sync(0xffffffffu, z[m], kk) * rdiag[k];
#pragma unroll
        for (int mm = 0; mm < 3; ++mm) {
          const int i = lane + 32 * mm;
          if (i > k && i < n) z[mm] = fmaf(-L[i * kLd + k], zk, z[mm]);
          if (i == k) z[mm] = zk;
        }
      }
    // L^T x = z
#pragma unroll
    for (int m = 2; m >= 0; --m)
      for (int kk = 31; kk >= 0; --kk) {
        const int k = 32 * m + kk;
        if (k >= n) continue;
        const float xk = __shfl_sync(0xffffffffu, z[m], kk) * rdiag[k];
#pragma unroll
        for (int mm = 0; mm < 3; ++mm) {
          const int i = lane + 32 * mm;
          if (i < k) z[mm] = fmaf(-L[k * kLd + i], xk, z[mm]);
          if (i == k) z[mm] = xk;
        }
      }
#pragma unroll
    for (int m = 0; m < 3; ++m)
      if (lane + 32 * m < n) x[lane + 32 * m] = z[m];
  }
}

}  // namespace

extern "C" int dpvo_spd_solve(const void* S, const void* y, void* x, int n, void* stream) {
  if (n < 0 || n > kMaxN) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    cholesky_solve_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)S, (const float*)y, (float*)x, n);
  }
  return (int)cudaGetLastError();
}
