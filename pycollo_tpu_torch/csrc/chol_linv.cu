// Batched Cholesky factor + triangular inverse for Hopper, one block per matrix.
//
// Replaces the Pallas TPU kernel ``_chol_inv_kernel`` / ``batched_chol_inv``
// of ``pycollo_tpu/ops/block_chol.py:63-150``.  For a contiguous stack of
// symmetric positive definite matrices A = L L^T (B, n, n), n <= 160, f32,
// it writes L^{-1} (B, n, n): lower-triangular, exact zeros above the
// diagonal; and, when ``diag`` is not null, diag(L) (B, n).  Only the lower
// triangle of A is read.  An instance that is not positive definite gives
// NaN (a negative pivot under IEEE sqrtf) or inf (a zero pivot) in that
// instance only.
//
// What bounds it on an H100: on the interior-point main path one call
// factors the whole condensed matrix of the default cart-pole mesh,
// (1536, 148, 148): 67.7 MB in (the lower triangle) and 134.6 MB out, 60 us
// at 3.35 TB/s, and 2 n^3 / 3 flops per matrix, 3.3 GFLOP, 50 us at 67
// TFLOP/s in f32.  The refined mesh's four diagonal blocks of 628 are
// (1536, 157, 157): 227.6 MB, 68 us.  So bytes bound it, if the sequential
// depth of the factorization can be hidden.
//
// Design: the whole matrix lives in shared memory (np x (np + 4) floats,
// np = n rounded up to 8; with its scratch at most 112 KB, at n = 160, so
// two blocks share an SM's 228 KB), padded with the identity to np so that
// every panel is 8 wide.  The row pitch
// np + 4 is 4 mod 8 words, so eight consecutive rows read as float4 hit 32
// distinct banks.  The factorization is right-looking and blocked with
// panels of 8: the 8 x 8 diagonal block is factored by one warp (each lane
// the whole block in registers, with no shuffles on the chain of sqrtf and
// division), each thread then solves one row of the panel below it, and the
// trailing update is register-tiled: each thread owns 4 x 4 tiles of the
// lower triangle and reads the panel, stored transposed, as float4.  Warp 0
// updates and factors the next diagonal block while the other warps update
// the rest (a look-ahead of one panel), so a panel step costs two barriers
// and the sequential depth is np / 8 steps, not n column steps each with a
// j-long dependent chain as in the warp-per-matrix design.  The inverse is
// formed in place the same way, left to right by panels of 8 (right-looking
// forward substitution of L X = I): a thread per column solves the panel's
// block row, then the rows below take the panel's update in register-tiled
// 4 x 4 tiles spread over all threads.  The load keeps four rows per warp
// in flight.  No tensor cores: TF32 keeps about three digits, and the
// mixed-precision solver needs full f32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (see ``pycollo_tpu_torch/ops/_build.py``).  Not with
// --use_fast_math: the NaN-on-non-PD contract and the f32 accuracy rely on
// IEEE sqrtf and division.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 160;
constexpr int kPanel = 8;
constexpr int kWarp = 32;

__host__ __device__ constexpr int padded(int n) {
  return (n + kPanel - 1) / kPanel * kPanel;
}

// Floats of dynamic shared memory: the tile, the transposed panel, the
// reciprocal pivots, the pivots and the inverse of one diagonal block.
__host__ __device__ constexpr int smem_floats(int np) {
  return np * (np + 4) + kPanel * np + 2 * np + kPanel * kPanel;
}

// Warp-wide: factors the updated diagonal block at (base, base) of S in
// place (lower part), and writes the pivots and their reciprocals.  Every
// lane reads the whole block and factors it in registers, so a column costs
// one sqrtf and one division on the critical path and no shuffles; lane r
// writes row r.  Every lane of the warp must call it.
__device__ __forceinline__ void factor_diag_block(float* S, int pitch,
                                                  float* dinv, float* dL,
                                                  int base, int lane) {
  __syncwarp();
  float a[kPanel][kPanel];
#pragma unroll
  for (int i = 0; i < kPanel; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) a[i][j] = S[(base + i) * pitch + base + j];
  }
#pragma unroll
  for (int j = 0; j < kPanel; ++j) {
    const float d = sqrtf(a[j][j]);
    const float di = 1.0f / d;
    a[j][j] = d;
#pragma unroll
    for (int i = j + 1; i < kPanel; ++i) a[i][j] *= di;
#pragma unroll
    for (int i = j + 1; i < kPanel; ++i) {
#pragma unroll
      for (int l = j + 1; l <= i; ++l) a[i][l] -= a[i][j] * a[l][j];
    }
    if (lane == 0) {
      dinv[base + j] = di;
      dL[base + j] = d;
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kPanel; ++i) {
    if (lane == i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) S[(base + i) * pitch + base + j] = a[i][j];
    }
  }
}

// One thread block of kThreads >= np threads per matrix: thread i owns row
// i in the row-wise phases.
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
chol_linv_kernel(const float* __restrict__ A, float* __restrict__ out,
                 float* __restrict__ diag, int n) {
  extern __shared__ __align__(16) float smem[];
  const int np = padded(n);
  const int pitch = np + 4;
  float* S = smem;                 // np x pitch, row-major
  float* Pt = S + np * pitch;      // kPanel x np: the panel, transposed
  float* dinv = Pt + kPanel * np;  // 1 / L[i][i]
  float* dL = dinv + np;           // L[i][i]
  float* Xd = dL + np;             // kPanel x kPanel: inverse of a diagonal block
  constexpr int kWarps = kThreads / kWarp;
  const int tid = threadIdx.x;
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  const long long b = blockIdx.x;
  const long long nn = static_cast<long long>(n) * n;

  // Load the lower triangle, zeros above it, the identity on the padding.
  // A warp per row, coalesced; each warp keeps kLoadRows rows of loads in
  // flight before it stores them.
  {
    constexpr int kLoadRows = 4;
    constexpr int kLoadCols = (kMaxN + kWarp - 1) / kWarp;
    const float* Ab = A + b * nn;
    for (int i0 = warp * kLoadRows; i0 < np; i0 += kWarps * kLoadRows) {
      float v[kLoadRows][kLoadCols];
#pragma unroll
      for (int r = 0; r < kLoadRows; ++r) {
        const int i = i0 + r;
#pragma unroll
        for (int c = 0; c < kLoadCols; ++c) {
          const int j = lane + kWarp * c;
          v[r][c] = (i < n && j <= i)
                        ? __ldg(Ab + static_cast<long long>(i) * n + j)
                        : (i == j ? 1.0f : 0.0f);
        }
      }
#pragma unroll
      for (int r = 0; r < kLoadRows; ++r) {
        const int i = i0 + r;
#pragma unroll
        for (int c = 0; c < kLoadCols; ++c) {
          const int j = lane + kWarp * c;
          if (i < np && j < np) S[i * pitch + j] = v[r][c];
        }
      }
    }
  }
  __syncthreads();

  if (warp == 0) factor_diag_block(S, pitch, dinv, dL, 0, lane);
  __syncthreads();

  // Cholesky.  Invariant at the top of a step: the diagonal block at k0 is
  // factored; the rows below it hold A minus all earlier panels' updates.
  for (int k0 = 0; k0 < np; k0 += kPanel) {
    const int r0 = k0 + kPanel;
    if (tid >= r0 && tid < np) {
      // Panel row: L[i][k0:r0] = A'[i][k0:r0] L_kk^{-T}.
      float* row = S + tid * pitch + k0;
      const float4 lo = *reinterpret_cast<const float4*>(row);
      const float4 hi = *reinterpret_cast<const float4*>(row + 4);
      float x[kPanel] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int c = 0; c < kPanel; ++c) {
        float s = x[c];
        const float* lc = S + (k0 + c) * pitch + k0;
#pragma unroll
        for (int k = 0; k < c; ++k) s -= x[k] * lc[k];
        x[c] = s * dinv[k0 + c];
      }
      *reinterpret_cast<float4*>(row) = make_float4(x[0], x[1], x[2], x[3]);
      *reinterpret_cast<float4*>(row + 4) = make_float4(x[4], x[5], x[6], x[7]);
#pragma unroll
      for (int c = 0; c < kPanel; ++c) Pt[c * np + tid] = x[c];
    }
    __syncthreads();
    if (r0 >= np) break;

    if (warp == 0) {
      // Look-ahead: update the next diagonal block (lane r its row r),
      // then factor it.
      if (lane < kPanel) {
        const int i = r0 + lane;
        float a[kPanel];
#pragma unroll
        for (int c = 0; c < kPanel; ++c) a[c] = S[i * pitch + r0 + c];
#pragma unroll
        for (int k = 0; k < kPanel; ++k) {
          const float pik = Pt[k * np + i];
          const float* pk = Pt + k * np + r0;
#pragma unroll
          for (int c = 0; c < kPanel; ++c) a[c] -= pik * pk[c];
        }
#pragma unroll
        for (int c = 0; c < kPanel; ++c) {
          if (c <= lane) S[i * pitch + r0 + c] = a[c];
        }
      }
      factor_diag_block(S, pitch, dinv, dL, r0, lane);
    } else {
      // Trailing update of the lower triangle of [r0, np)^2 in 4 x 4 tiles,
      // numbered row by row; tiles 0..2 form the next diagonal block.
      const int mt = (np - r0) / 4;
      const int tiles = mt * (mt + 1) / 2;
      for (int t = 3 + tid - kWarp; t < tiles; t += kThreads - kWarp) {
        int ti = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
        while (ti * (ti + 1) / 2 > t) --ti;
        while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
        const int tj = t - ti * (ti + 1) / 2;
        const int i0 = r0 + 4 * ti;
        const int j0 = r0 + 4 * tj;
        float acc[4][4] = {};
#pragma unroll
        for (int k = 0; k < kPanel; ++k) {
          const float4 p = *reinterpret_cast<const float4*>(Pt + k * np + i0);
          const float4 q = *reinterpret_cast<const float4*>(Pt + k * np + j0);
          const float pi[4] = {p.x, p.y, p.z, p.w};
          const float qj[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] += pi[r] * qj[c];
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float4* dst = reinterpret_cast<float4*>(S + (i0 + r) * pitch + j0);
          float4 s = *dst;
          // On a diagonal tile only the lower part is written: the zeros
          // above the diagonal stay exact.
          const bool diag_tile = ti == tj;
          if (!diag_tile || r >= 0) s.x -= acc[r][0];
          if (!diag_tile || r >= 1) s.y -= acc[r][1];
          if (!diag_tile || r >= 2) s.z -= acc[r][2];
          if (!diag_tile || r >= 3) s.w -= acc[r][3];
          *dst = s;
        }
      }
    }
    __syncthreads();
  }

  // In-place inverse X = L^{-1}, left to right by panels of 8 (right-looking
  // forward substitution).  Invariant at the top of the step for panel j0:
  // rows above j0 hold X; rows >= j0 hold R = I - L_{:, <j0} X_{<j0, :} in
  // the columns left of j0 and L from column j0 on.
  for (int j0 = 0; j0 < np; j0 += kPanel) {
    const int r0 = j0 + kPanel;
    if (tid < r0) {
      // Column c of the panel's block row: X[j0:r0][c] = L_jj^{-1} R[j0:r0][c],
      // where R is the identity in the diagonal block.  Left of it in place;
      // the diagonal block's inverse goes to Xd, as L_jj is still read.
      const int c = tid;
      float x[kPanel];
#pragma unroll
      for (int r = 0; r < kPanel; ++r) {
        float s = c < j0 ? S[(j0 + r) * pitch + c] : (c - j0 == r ? 1.0f : 0.0f);
        const float* lr = S + (j0 + r) * pitch + j0;
#pragma unroll
        for (int k = 0; k < r; ++k) s -= lr[k] * x[k];
        x[r] = s * dinv[j0 + r];
      }
      if (c < j0) {
#pragma unroll
        for (int r = 0; r < kPanel; ++r) S[(j0 + r) * pitch + c] = x[r];
      } else {
#pragma unroll
        for (int r = 0; r < kPanel; ++r) Xd[r * kPanel + c - j0] = x[r];
      }
    } else if (tid < np) {
      // The panel of L below the diagonal block, transposed.
      const float* row = S + tid * pitch + j0;
      const float4 lo = *reinterpret_cast<const float4*>(row);
      const float4 hi = *reinterpret_cast<const float4*>(row + 4);
      const float x[kPanel] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int k = 0; k < kPanel; ++k) Pt[k * np + tid] = x[k];
    }
    __syncthreads();
    if (tid >= j0 && tid < r0) {
      const float* xr = Xd + (tid - j0) * kPanel;
      float* row = S + tid * pitch + j0;
      *reinterpret_cast<float4*>(row) = make_float4(xr[0], xr[1], xr[2], xr[3]);
      *reinterpret_cast<float4*>(row + 4) = make_float4(xr[4], xr[5], xr[6], xr[7]);
    }
    // R[i][c] -= L[i][j0:r0] X[j0:r0][c] for rows i >= r0 and columns
    // c < r0, in 4 x 4 tiles; in the panel's own columns R starts at 0 and
    // overwrites L (read from Pt), and X_jj is read from Xd.
    const int tile_cols = r0 / 4;
    const int tiles = (np - r0) / 4 * tile_cols;
    for (int t = tid; t < tiles; t += kThreads) {
      const int ti = t / tile_cols;
      const int c0 = 4 * (t - ti * tile_cols);
      const int i0 = r0 + 4 * ti;
      const bool left = c0 < j0;
      float acc[4][4] = {};
#pragma unroll
      for (int k = 0; k < kPanel; ++k) {
        const float4 p = *reinterpret_cast<const float4*>(Pt + k * np + i0);
        const float4 q = *reinterpret_cast<const float4*>(
            left ? S + (j0 + k) * pitch + c0 : Xd + k * kPanel + c0 - j0);
        const float pi[4] = {p.x, p.y, p.z, p.w};
        const float qc[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] += pi[r] * qc[c];
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float4* dst = reinterpret_cast<float4*>(S + (i0 + r) * pitch + c0);
        const float4 s = left ? *dst : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        *dst = make_float4(s.x - acc[r][0], s.y - acc[r][1], s.z - acc[r][2],
                           s.w - acc[r][3]);
      }
    }
    __syncthreads();
  }

  // Store X (zeros above the diagonal included), a warp per row, coalesced.
  {
    float* Ob = out + b * nn;
    for (int i = warp; i < n; i += kWarps) {
      const float* row = S + i * pitch;
      for (int j = lane; j < n; j += kWarp) {
        Ob[static_cast<long long>(i) * n + j] = row[j];
      }
    }
    if (diag != nullptr) {
      for (int i = tid; i < n; i += kThreads) diag[b * n + i] = dL[i];
    }
  }
}

template <int kThreads>
int launch(const float* A, float* out, float* diag, int B, int n,
           cudaStream_t stream) {
  const size_t shmem = sizeof(float) * smem_floats(padded(n));
  // Above 48 KB a block may use dynamic shared memory only once the kernel
  // is allowed to; the attribute is set once per device.
  constexpr int kMaxDevices = 64;
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices && !raised[dev]) {
    const size_t most = sizeof(float) * smem_floats(padded(kMaxN));
    err = cudaFuncSetAttribute(chol_linv_kernel<kThreads>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(most));
    if (err != cudaSuccess) return static_cast<int>(err);
    raised[dev] = true;
  }
  chol_linv_kernel<kThreads><<<B, kThreads, shmem, stream>>>(A, out, diag, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes).  A, out and diag (nullable) are
// device pointers to a contiguous (B, n, n) f32 stack, its (B, n, n) output
// and a (B, n) output; the launch goes on ``stream`` and is not
// synchronised.  Returns cudaGetLastError() after the launch (0 on success);
// invalid sizes return cudaErrorInvalidValue without a launch.
extern "C" int pycollo_chol_linv_f32(const float* A, float* out, float* diag,
                                     int B, int n, void* stream) {
  if (B < 0 || n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int np = padded(n);
  if (np <= 64) return launch<64>(A, out, diag, B, n, s);
  if (np <= 128) return launch<128>(A, out, diag, B, n, s);
  return launch<256>(A, out, diag, B, n, s);
}
