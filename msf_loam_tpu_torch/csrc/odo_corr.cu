// Fused scan-to-scan correspondence reductions, one warp per query.
//
// Replaces the Pallas TPU kernel msf_loam_tpu/ops/odo_corr.py
// (odo_corr_pallas, body _odo_corr_kernel). Per query q against the whole
// reference cloud, with exact float32 direct distances
// d2 = (rx-qx)^2 + (ry-qy)^2 + (rz-qz)^2 (never |q|^2+|r|^2-2q.r):
//   * a: the global nearest neighbour (min, FIRST argmin) and its ring;
//   * c: the nearest point whose ring differs from ring_a by
//        0 < |dr| <= nearby (3e38 and index M when there is none);
//   * for K > 0, the (min, first argmin, ring) of each of K contiguous
//     M/K bins (the odometry plane-support candidate pool).
// The (N, M) distance matrix never reaches memory.
//
// What bounds it on the H100: the distance arithmetic and its reductions,
// 2 passes x N x M (6.3 M distance evaluations for the plane call at
// N=384, M=8192), not bytes (the ~130 KB reference cloud and the query
// list are read once from memory). The design stages the reference cloud
// as x/y/z/ring planes in dynamic shared memory (16 B x M, 128 KB at
// M = 8192), so every block reads it from memory or L2 once; each warp
// owns one query, each lane strides the planes, and warp shuffles reduce
// (min, first index) pairs. Bins are contiguous and a multiple of 32 long,
// so each bin's minimum is one warp reduction at the bin's end. Pass 2
// recomputes distances instead of storing them.
//
// Compiled with -fmad=false so d2 is rounded exactly as the plain PyTorch
// version rounds it: indices, rings and d2 match it bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;           // 8 queries per block
constexpr float kInf = 3.0e38f;         // odo_corr.py _INF

__device__ __forceinline__ void warp_argmin(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (ov < v || (ov == v && oi < i)) { v = ov; i = oi; }
  }
}

__device__ __forceinline__ float dist2(float rx, float ry, float rz, float qx,
                                       float qy, float qz) {
  const float dx = rx - qx, dy = ry - qy, dz = rz - qz;
  return dx * dx + dy * dy + dz * dz;
}

__global__ void __launch_bounds__(kThreads)
odo_corr_kernel(const float* __restrict__ q, const float* __restrict__ ref,
                int N, int M, int K, float nearby, float* __restrict__ a_d2,
                int* __restrict__ a_idx, int* __restrict__ a_ring,
                float* __restrict__ c_d2, int* __restrict__ c_idx,
                float* __restrict__ cand_d2, int* __restrict__ cand_idx,
                int* __restrict__ cand_ring) {
  extern __shared__ float planes[];        // rx | ry | rz | ring, M each
  const float* rx = planes;
  const float* ry = planes + M;
  const float* rz = planes + 2 * M;
  const float* rr = planes + 3 * M;
  for (int i = threadIdx.x; i < 4 * M; i += blockDim.x) planes[i] = ref[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (n >= N) return;                       // warp-uniform
  const float qx = q[3 * n], qy = q[3 * n + 1], qz = q[3 * n + 2];

  // pass 1: global nearest (+ per-bin minima)
  float av = kInf;
  int ai = M;
  const int nbins = K > 0 ? K : 1;
  const int B = M / nbins;
  for (int b = 0; b < nbins; ++b) {
    float bv = kInf;
    int bi = M;
    for (int w = b * B + lane; w < (b + 1) * B; w += 32) {
      const float d2 = dist2(rx[w], ry[w], rz[w], qx, qy, qz);
      if (d2 < bv) { bv = d2; bi = w; }   // lanes see rising w: first min
    }
    if (K > 0) {
      float v = bv;
      int i = bi;
      warp_argmin(v, i);
      if (lane == 0) {
        cand_d2[(size_t)n * K + b] = v;
        cand_idx[(size_t)n * K + b] = i;
        cand_ring[(size_t)n * K + b] = (int)rr[i];
      }
    }
    if (bv < av || (bv == av && bi < ai)) { av = bv; ai = bi; }
  }
  warp_argmin(av, ai);
  const float ring_a = rr[ai];

  // pass 2: nearest on a different nearby ring (recomputed distances)
  float cv = kInf;
  int ci = M;
  for (int w = lane; w < M; w += 32) {
    const float dr = fabsf(rr[w] - ring_a);
    if (dr > 0.0f && dr <= nearby) {
      const float d2 = dist2(rx[w], ry[w], rz[w], qx, qy, qz);
      if (d2 < cv) { cv = d2; ci = w; }
    }
  }
  warp_argmin(cv, ci);
  if (lane == 0) {
    a_d2[n] = av;
    a_idx[n] = ai;
    a_ring[n] = (int)ring_a;
    c_d2[n] = cv;
    c_idx[n] = ci;
  }
}

}  // namespace

// q: (N, 3) f32; ref: (4, M) f32 planes [x | y | z | ring] with masked and
// padded points already at the 1e9 / 1e6 sentinels; M a multiple of 32*K
// (of 32 when K = 0). Returns the CUDA error of the launch (0 = ok).
extern "C" int odo_corr_launch(const float* q, const float* ref, int N, int M,
                               int K, float nearby, float* a_d2, int* a_idx,
                               int* a_ring, float* c_d2, int* c_idx,
                               float* cand_d2, int* cand_idx, int* cand_ring,
                               void* stream) {
  if (N <= 0) return 0;
  if (M <= 0 || M % (32 * (K > 0 ? K : 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)4 * M * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      odo_corr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int per_block = kThreads / 32;
  const int blocks = (N + per_block - 1) / per_block;
  odo_corr_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      q, ref, N, M, K, nearby, a_d2, a_idx, a_ring, c_d2, c_idx, cand_d2,
      cand_idx, cand_ring);
  return (int)cudaGetLastError();
}
