// Block-Thomas solve of a symmetric block-tridiagonal system in one launch.
//
// Replaces the XLA lax.scan of msf_loam_tpu/slam/posegraph.py:475-541
// (solve_block_tridiag / solve_block_tridiag_multi; not a Pallas kernel):
// for D (N,6,6), U (N-1,6,6) and B (N,6,m) it returns X (N,6,m) with
// tridiag(U^T, D, U) X = B, by the recurrence the JAX scans run:
//   forward   L = solve(Dt[i-1], U[i-1])^T,
//             Dt[i] = D[i] - L U[i-1],  Bt[i] = B[i] - L Bt[i-1]
//             (Dt[0] = D[0], Bt[0] = B[0]);
//   backward  X[N-1] = solve(Dt[N-1], Bt[N-1]),
//             X[i] = solve(Dt[i], Bt[i] - U[i] X[i+1]).
// Each 6x6 solve is Gaussian elimination with partial pivoting: the pivot
// is the first maximal |entry| of its column (NaN counts as maximal, as
// torch.argmax has it), every multiplier and every back-substitution step
// divides (never multiplies by a reciprocal), and each 6-term block product
// is summed k = 0..5 as separate multiplies and adds. Built with
// -fmad=false, so every float is rounded as the plain PyTorch version in
// ops/block_tridiag.py rounds it: the two are bit-equal.
//
// What bounds it on the H100: the chain of 2N dependent 6x6 steps, not
// bytes (~22 MB at N = 8192, m = 49: about 6.5 us at 3.35 TB/s) or
// arithmetic. Step i of the forward sweep needs Dt[i-1] factorised, and
// step i of the backward sweep needs X[i+1]. So the whole solve is one
// thread block:
//   * forward, per step: warp 0 factorises Dt[i-1] in shared memory (one
//     lane per entry of the trailing block, the row permutation held in
//     every lane's registers, no row is moved) and stores the factor
//     (eliminated rows, multipliers, permutation) to a scratch tensor;
//     six threads solve for the six columns of Y = Dt[i-1]^-1 U[i-1]; then
//     the block computes [Dt[i] | Bt[i]] = [D[i] | B[i]] - Y^T [U[i-1] |
//     Bt[i-1]], one thread per entry of the 6 x (6+m) step, Bt kept in a
//     ping-pong pair of shared buffers and written to the scratch tensor;
//   * backward: column c of X depends only on column c of X[i+1] and the
//     stored factor of Dt[i], so thread c walks i = N-1 .. 0 alone, with
//     X[i+1] in registers and no barrier at all.
// Both right-hand-side groups of the Woodbury loop solve ([rhs | W], m =
// 1 + 6L) share one launch and one factorisation per step. A parallel
// scheme (cyclic reduction) would change the numerics; it is left out.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kFac = 72;   // floats a step's factor takes: rows | multipliers

__device__ __forceinline__ bool pivot_better(float v, float best) {
  return !isnan(best) && (isnan(v) || v > best);
}

// Gaussian elimination with partial pivoting of the 6x6 in sA (physical row
// order), by warp 0. On return sA holds the eliminated rows, sF[r*6+k] the
// multiplier of physical row r at step k, sPerm the pivot order (logical row
// i is physical row sPerm[i]); the same go to fac_out / piv_out.
__device__ void factor_warp(float* sA, float* sF, int* sPerm, float* fac_out,
                            int* piv_out) {
  const int lane = threadIdx.x;
  int perm[6] = {0, 1, 2, 3, 4, 5};
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int bi = k;
    float best = fabsf(sA[perm[k] * 6 + k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float v = fabsf(sA[perm[i] * 6 + k]);
      if (pivot_better(v, best)) {
        best = v;
        bi = i;
      }
    }
    const int t = perm[k];
    perm[k] = perm[bi];
    perm[bi] = t;
    const int pk = perm[k];
    const float piv = sA[pk * 6 + k];
    // rows below the pivot (logical k+1..5) x columns k..5: column k takes
    // the multiplier, columns j > k the update. Reads (column k, pivot row)
    // and writes (other rows, columns > k) never meet within a step.
    const int cols = 6 - k;
    if (lane < (5 - k) * cols) {
      const int pr = perm[k + 1 + lane / cols];
      const int j = k + lane % cols;
      const float f = sA[pr * 6 + k] / piv;
      if (j == k) {
        sF[pr * 6 + k] = f;
      } else {
        const float prod = f * sA[pk * 6 + j];
        sA[pr * 6 + j] = sA[pr * 6 + j] - prod;
      }
    }
    __syncwarp();
  }
  if (lane < 6) {
    sPerm[lane] = perm[lane];
    piv_out[lane] = perm[lane];
  }
  for (int e = lane; e < 36; e += 32) {
    fac_out[e] = sA[e];
    fac_out[36 + e] = sF[e];
  }
}

// Solve one right-hand-side column r (physical row order on entry) with a
// stored factor: forward elimination with the multipliers in pivot order,
// then back substitution. Returns the solution in r.
__device__ __forceinline__ void apply_factor(const float* A, const float* F,
                                             const int* perm, float r[6]) {
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) y[i] = r[perm[i]];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float prod = F[perm[i] * 6 + k] * y[k];
      y[i] = y[i] - prod;
    }
  }
#pragma unroll
  for (int k = 5; k >= 0; --k) {
    y[k] = y[k] / A[perm[k] * 6 + k];
#pragma unroll
    for (int i = 0; i < k; ++i) {
      const float prod = A[perm[i] * 6 + k] * y[k];
      y[i] = y[i] - prod;
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) r[i] = y[i];
}

int threads_for(int m) {
  int t = 6 * (6 + m);
  t = (t + 31) / 32 * 32;
  if (t < 64) t = 64;
  if (t > 1024) t = 1024;
  return t;
}

size_t smem_for(int m) {
  return (size_t)(4 * 36 + 2 * 6 * m) * sizeof(float) + 8 * sizeof(int);
}

__global__ void block_tridiag_kernel(const float* __restrict__ D,
                                     const float* __restrict__ U,
                                     const float* __restrict__ B,
                                     float* __restrict__ X, float* work,
                                     int* piv, int N, int m) {
  extern __shared__ float sh[];
  float* sA = sh;            // Dt being factorised, then the next Dt
  float* sF = sA + 36;       // multipliers
  float* sU = sF + 36;       // U[i-1]
  float* sY = sU + 36;       // Dt[i-1]^-1 U[i-1]
  float* cur = sY + 36;      // Bt[i-1]
  float* nxt = cur + 6 * m;  // Bt[i]
  int* sPerm = reinterpret_cast<int*>(nxt + 6 * m);
  const int tid = threadIdx.x, T = blockDim.x, W = 6 + m;
  const size_t sm = (size_t)6 * m;
  float* fac = work;                   // N x 72
  float* bt = work + (size_t)N * kFac;  // N x 6 x m

  // ---- forward sweep
  for (int e = tid; e < 36; e += T) sA[e] = D[e];
  for (int e = tid; e < 6 * m; e += T) {
    const float v = B[e];
    cur[e] = v;
    bt[e] = v;
  }
  __syncthreads();
  for (int i = 1; i < N; ++i) {
    for (int e = tid; e < 36; e += T) sU[e] = U[(size_t)(i - 1) * 36 + e];
    if (tid < 32)
      factor_warp(sA, sF, sPerm, fac + (size_t)(i - 1) * kFac,
                  piv + (size_t)(i - 1) * 6);
    __syncthreads();
    if (tid < 6) {
      float r[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) r[k] = sU[k * 6 + tid];
      int perm[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) perm[k] = sPerm[k];
      apply_factor(sA, sF, perm, r);
#pragma unroll
      for (int k = 0; k < 6; ++k) sY[k * 6 + tid] = r[k];
    }
    __syncthreads();
    const float* Di = D + (size_t)i * 36;
    const float* Bi = B + (size_t)i * sm;
    for (int e = tid; e < 6 * W; e += T) {
      const int r = e / W, c = e % W;
      float C[6];
      if (c < 6) {
#pragma unroll
        for (int k = 0; k < 6; ++k) C[k] = sU[k * 6 + c];
      } else {
#pragma unroll
        for (int k = 0; k < 6; ++k) C[k] = cur[k * m + c - 6];
      }
      float acc = sY[r] * C[0];
#pragma unroll
      for (int k = 1; k < 6; ++k) {
        const float prod = sY[k * 6 + r] * C[k];
        acc = acc + prod;
      }
      if (c < 6) {
        sA[r * 6 + c] = Di[r * 6 + c] - acc;
      } else {
        const float v = Bi[r * m + c - 6] - acc;
        nxt[r * m + c - 6] = v;
        bt[(size_t)i * sm + r * m + c - 6] = v;
      }
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  if (tid < 32)
    factor_warp(sA, sF, sPerm, fac + (size_t)(N - 1) * kFac,
                piv + (size_t)(N - 1) * 6);
  __syncthreads();  // the scratch writes are visible to the whole block

  // ---- backward sweep: one thread per right-hand-side column
  for (int c = tid; c < m; c += T) {
    float x[6];
    for (int i = N - 1; i >= 0; --i) {
      const float* f = fac + (size_t)i * kFac;
      const int* p = piv + (size_t)i * 6;
      const float* bti = bt + (size_t)i * sm;
      float r[6];
      if (i == N - 1) {
#pragma unroll
        for (int row = 0; row < 6; ++row) r[row] = bti[row * m + c];
      } else {
        const float* Ui = U + (size_t)i * 36;
#pragma unroll
        for (int row = 0; row < 6; ++row) {
          float acc = Ui[row * 6] * x[0];
#pragma unroll
          for (int k = 1; k < 6; ++k) {
            const float prod = Ui[row * 6 + k] * x[k];
            acc = acc + prod;
          }
          r[row] = bti[row * m + c] - acc;
        }
      }
      int perm[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) perm[k] = p[k];
      apply_factor(f, f + 36, perm, r);
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        x[k] = r[k];
        X[(size_t)i * sm + k * m + c] = r[k];
      }
    }
  }
}

}  // namespace

extern "C" {

// X (N,6,m) from D (N,6,6), U (N-1,6,6), B (N,6,m); work holds N*(72+6m)
// floats and piv N*6 ints of scratch. Returns the CUDA error of the launch.
int block_tridiag_launch(const float* D, const float* U, const float* B,
                         float* X, float* work, int* piv, int N, int m,
                         cudaStream_t stream) {
  if (N < 1 || m < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_for(m);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        block_tridiag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  block_tridiag_kernel<<<1, threads_for(m), smem, stream>>>(D, U, B, X, work,
                                                            piv, N, m);
  return (int)cudaGetLastError();
}

// Threads, dynamic shared memory bytes, registers and local bytes per
// thread of the launch for m right-hand sides.
int block_tridiag_geometry(int m, int* threads, int* smem, int* regs,
                           int* local_bytes) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, block_tridiag_kernel);
  if (e != cudaSuccess) return (int)e;
  *threads = threads_for(m);
  *smem = (int)smem_for(m);
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

}  // extern "C"
