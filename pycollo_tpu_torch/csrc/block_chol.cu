// Batched small-block Cholesky factor + triangular inverse for Hopper.
//
// Replaces the Pallas TPU kernel ``_chol_inv_kernel`` / ``batched_chol_inv``
// of ``pycollo_tpu/ops/block_chol.py``.  For a stack of symmetric positive
// definite matrices A = L L^T (B, n, n), n <= 48, f32, it writes L^{-1}
// (B, n, n) f32: lower-triangular, exact zeros above the diagonal.  An
// instance that is not positive definite produces NaN (a negative pivot
// under IEEE sqrtf) or a zero pivot (inf reciprocal) in that instance only;
// the caller detects it from the reciprocal of the diagonal.
//
// What bounds it on an H100: on the interior-point main path the kernel sees
// 1536 matrices of 37 x 37 per call, about 8.4 MB read and 8.4 MB written,
// and ~n^3/2 flops per matrix.  Neither bytes nor flops bound it: the
// n-step recurrences of the factorization and of the substitution are
// sequential, so the kernel is bound by their latency.
//
// Design: one warp per matrix, four warps per block, the matrix in shared
// memory (at most 48 * 48 * 4 B = 9.2 KB per warp).  1536 matrices give 1536
// warps, enough to fill all 132 SMs.  The factorization runs column by
// column (left-looking Crout), with the lanes over the rows at and below the
// diagonal.  The inverse runs column by column too: the columns of L^{-1}
// are independent, so each lane forward-substitutes its own column and
// stores it transposed into the upper triangle of the shared tile, which
// the factorization never reads.  No lane reads another lane's value in that
// phase, so it needs no synchronisation.  The ragged edge of the batch is
// masked by the warp index; no padding is needed.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (see ``pycollo_tpu_torch/ops/_build.py``).  Not with
// --use_fast_math: the NaN-on-non-PD contract and the f32 accuracy rely on
// IEEE sqrtf and division.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxN = 48;
constexpr int kWarp = 32;
// Rows (or columns) a lane owns: ceil(kMaxN / kWarp).
constexpr int kPerLane = (kMaxN + kWarp - 1) / kWarp;

__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
chol_inv_kernel(const float* __restrict__ A, float* __restrict__ out,
                int B, int n) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const long long b = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
  if (b >= B) return;  // ragged edge: whole warps only, no block barrier below

  const int nn = n * n;
  float* S = smem + warp * (nn + n);  // the n x n tile, row-major
  float* dinv = S + nn;               // reciprocal pivots 1 / L[j][j]
  const float* Ab = A + b * nn;
  float* Ob = out + b * nn;

  for (int e = lane; e < nn; e += kWarp) S[e] = Ab[e];
  __syncwarp();

  // Cholesky, column j: s_i = A[i][j] - sum_{k<j} L[i][k] L[j][k], i >= j.
  for (int j = 0; j < n; ++j) {
    float s[kPerLane];
#pragma unroll
    for (int r = 0; r < kPerLane; ++r) {
      const int i = j + lane + kWarp * r;
      s[r] = 0.0f;
      if (i < n) {
        float acc = S[i * n + j];
        for (int k = 0; k < j; ++k) acc -= S[i * n + k] * S[j * n + k];
        s[r] = acc;
      }
    }
    if (lane == 0) {
      const float d = sqrtf(s[0]);  // NaN for a negative pivot
      S[j * n + j] = d;
      dinv[j] = 1.0f / d;
    }
    __syncwarp();
    const float dj = dinv[j];
#pragma unroll
    for (int r = 0; r < kPerLane; ++r) {
      const int i = j + lane + kWarp * r;
      if (i > j && i < n) S[i * n + j] = s[r] * dj;
    }
    __syncwarp();
  }

  // L^{-1}, column c per lane: X[c][c] = dinv[c],
  // X[i][c] = -dinv[i] * sum_{k=c}^{i-1} L[i][k] X[k][c], stored at S[c][i].
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    const int c = lane + kWarp * r;
    if (c < n) {
      const float xc = dinv[c];
      for (int i = c + 1; i < n; ++i) {
        float acc = S[i * n + c] * xc;
        for (int k = c + 1; k < i; ++k) acc += S[i * n + k] * S[c * n + k];
        S[c * n + i] = -acc * dinv[i];
      }
    }
  }
  __syncwarp();

  for (int e = lane; e < nn; e += kWarp) {
    const int i = e / n;
    const int j = e - i * n;
    Ob[e] = (i > j) ? S[j * n + i] : ((i == j) ? dinv[i] : 0.0f);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  A and out are device pointers
// to contiguous (B, n, n) f32 stacks; the launch goes on ``stream`` and is
// not synchronised.  Returns cudaGetLastError() after the launch (0 on
// success); invalid sizes return cudaErrorInvalidValue without a launch.
extern "C" int pycollo_chol_inv_f32(const float* A, float* out, int B, int n,
                                    void* stream) {
  if (B < 0 || n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const size_t shmem = sizeof(float) * kWarpsPerBlock * (n * n + n);
  chol_inv_kernel<<<blocks, kWarpsPerBlock * kWarp, shmem,
                    static_cast<cudaStream_t>(stream)>>>(A, out, B, n);
  return static_cast<int>(cudaGetLastError());
}
