// Dense damped-SPD solve S x = y by Gauss-Jordan without pivoting, in one
// thread block, for Hopper.
//
// Replaces the TPU kernel dpvo_tpu/ba/spd_solve.py:_gj_kernel (launched by
// _spd_solve_impl at :81; call site ba/solver.py:251-256): the
// sliding-window BA pose system, n = 6 * W_OPT_MAX = 96, f32. S is damped
// SPD by construction (S_ii += lm * S_ii + ep), so elimination without
// pivoting is stable. The same kernel serves the backward pass (the
// adjoint of a symmetric solve is another solve, see ba/spd_solve.py).
//
// What bounds it on an H100: neither bytes (37 KB) nor operations
// (~n^3 = 0.9 MFLOP); it is latency: n elimination sweeps, each two
// block-wide barriers apart, on one SM.
//
// Design: the augmented system [S | y] (n x (n+1) f32, 37 KB at n = 96)
// lives in shared memory of one 1024-thread block. Sweep k first copies
// pivot row k and the column factors A[i][k] / A[k][k] (zero on row k)
// to shared vectors, then every thread updates its elements with one
// multiply-subtract, as the TPU kernel's rank-1 update does. After the
// last sweep the system is diagonal and x_i = A[i][n] / A[i][i].

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
gj_kernel(const float* __restrict__ S, const float* __restrict__ y, float* __restrict__ x, int n) {
  extern __shared__ float smem[];
  const int ld = n + 1;
  float* A = smem;              // [n][n+1]
  float* fac = A + n * ld;      // [n]
  float* rowk = fac + n;        // [n+1]
  const int tid = threadIdx.x;
  for (int i = tid; i < n * ld; i += kThreads) {
    const int r = i / ld, c = i % ld;
    A[i] = c < n ? S[r * n + c] : y[r];
  }
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    const float inv = 1.0f / A[k * ld + k];
    for (int i = tid; i < n; i += kThreads) fac[i] = (i == k) ? 0.f : A[i * ld + k] * inv;
    for (int j = tid; j < ld; j += kThreads) rowk[j] = A[k * ld + j];
    __syncthreads();
    for (int i = tid; i < n * ld; i += kThreads) A[i] -= fac[i / ld] * rowk[i % ld];
    __syncthreads();
  }
  for (int i = tid; i < n; i += kThreads) x[i] = A[i * ld + n] / A[i * ld + i];
}

}  // namespace

extern "C" int dpvo_spd_solve(const void* S, const void* y, void* x, int n, void* stream) {
  const size_t shmem = (size_t)(n * (n + 1) + n + n + 1) * sizeof(float);
  if (shmem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(gj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  if (n > 0) {
    gj_kernel<<<1, kThreads, shmem, (cudaStream_t)stream>>>((const float*)S, (const float*)y,
                                                           (float*)x, n);
  }
  return (int)cudaGetLastError();
}
