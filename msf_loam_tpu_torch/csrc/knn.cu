// Brute-force k nearest neighbours of (Q, 3) queries among (M, 3) masked
// reference points: ascending (d2, idx), k <= 16.
//
// Replaces the Pallas TPU kernel msf_loam_tpu/ops/pallas_knn.py
// (knn_pallas, body _knn_kernel). Per (query, ref) pair, with exact float32
// direct distances summed in the reference's order,
//   d2 = min(((pen + dx^2) + dy^2) + dz^2, 3e38),  d = q - r,
// where pen is 0 for a valid ref and 3e38 for a masked one. The result is
// the k smallest d2 with ties broken by the lowest ref index; a slot that no
// valid ref fills is (3e38, -1). A masked ref (d2 = 3e38) never enters: a
// candidate is taken only when strictly below the current k-th distance.
//
// What bounds it on the H100: operations. Q x M distance evaluations of
// about 8 float operations each (2.1 GFLOP at Q = 4096, M = 65536: 0.032 ms
// at 67 TFLOP/s float32), against ~1.2 MB of bytes (0.0004 ms at
// 3.35 TB/s). The (Q, M) distance matrix never reaches memory.
//
// Design (simple first): one thread per query keeps its top-k as a sorted
// list in registers (k a template parameter, fully unrolled insertion).
// A block of 128 queries stages the refs in shared memory 1024 at a time as
// x, y, z and pen planes (16 KB), so each ref is read from memory once per
// block. To fill the card at Q = 4096 (32 query blocks for 132 SMs) the ref
// axis is split into S contiguous ranges, one block per (query block,
// range); each writes its range's sorted top-k, and a second small kernel
// merges the S lists per query in range order (earlier ranges hold lower
// indices, so the strict insertion keeps the lowest-index tie rule) and
// writes the sentinels.
//
// Compiled with -fmad=false so d2 is rounded exactly as the plain PyTorch
// version rounds it: d2 bit-equal and indices equal.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 1024;
constexpr float kInf = 3.0e38f;          // pallas_knn.py _INF

template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], float d,
                                       int i) {
  if (!(d < bd[K - 1])) return;
  bd[K - 1] = d;
  bi[K - 1] = i;
#pragma unroll
  for (int t = K - 1; t > 0; --t) {
    if (bd[t] < bd[t - 1]) {
      const float td = bd[t];
      bd[t] = bd[t - 1];
      bd[t - 1] = td;
      const int ti = bi[t];
      bi[t] = bi[t - 1];
      bi[t - 1] = ti;
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_partial_kernel(const float* __restrict__ q, const float* __restrict__ ref,
                   const uint8_t* __restrict__ mask, int Q, int M,
                   int range_len, float* __restrict__ part_d,
                   int* __restrict__ part_i) {
  __shared__ float sx[kChunk], sy[kChunk], sz[kChunk], sp[kChunk];
  const int S = gridDim.y;
  const int s = blockIdx.y;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const int lo = s * range_len;
  const int hi = min(M, lo + range_len);
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (n < Q) {
    qx = q[3 * n];
    qy = q[3 * n + 1];
    qz = q[3 * n + 2];
  }
  float bd[K];
  int bi[K];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    bd[t] = kInf;
    bi[t] = -1;
  }
  for (int base = lo; base < hi; base += kChunk) {
    const int len = min(kChunk, hi - base);
    __syncthreads();
    for (int j = threadIdx.x; j < len; j += kThreads) {
      const int m = base + j;
      sx[j] = ref[3 * m];
      sy[j] = ref[3 * m + 1];
      sz[j] = ref[3 * m + 2];
      sp[j] = mask[m] ? 0.0f : kInf;
    }
    __syncthreads();
    if (n < Q) {
      for (int j = 0; j < len; ++j) {
        const float dx = qx - sx[j];
        const float dy = qy - sy[j];
        const float dz = qz - sz[j];
        float d = sp[j] + dx * dx;
        d = d + dy * dy;
        d = d + dz * dz;
        d = fminf(d, kInf);
        insert<K>(bd, bi, d, base + j);
      }
    }
  }
  if (n < Q) {
    const size_t off = ((size_t)n * S + s) * K;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      part_d[off + t] = bd[t];
      part_i[off + t] = bi[t];
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_merge_kernel(const float* __restrict__ part_d,
                 const int* __restrict__ part_i, int Q, int S,
                 float* __restrict__ out_d, int* __restrict__ out_i) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= Q) return;
  float bd[K];
  int bi[K];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    bd[t] = kInf;
    bi[t] = -1;
  }
  for (int s = 0; s < S; ++s) {
    const size_t off = ((size_t)n * S + s) * K;
    for (int t = 0; t < K; ++t) {
      const float d = part_d[off + t];
      if (!(d < bd[K - 1])) break;       // the range's list is ascending
      insert<K>(bd, bi, d, part_i[off + t]);
    }
  }
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const bool empty = bd[t] >= kInf * 0.5f;
    out_d[(size_t)n * K + t] = empty ? kInf : bd[t];
    out_i[(size_t)n * K + t] = empty ? -1 : bi[t];
  }
}

template <int K>
int launch(const float* q, const float* ref, const uint8_t* mask, int Q,
           int M, int S, int range_len, float* part_d, int* part_i,
           float* out_d, int* out_i, cudaStream_t stream) {
  const dim3 grid((Q + kThreads - 1) / kThreads, S);
  knn_partial_kernel<K><<<grid, kThreads, 0, stream>>>(q, ref, mask, Q, M,
                                                       range_len, part_d,
                                                       part_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  knn_merge_kernel<K><<<(Q + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      part_d, part_i, Q, S, out_d, out_i);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (Q, 3) f32; ref: (M, 3) f32; mask: (M,) bool as bytes; S ranges of
// range_len refs (S * range_len >= M); part_d / part_i: (Q, S, k) scratch;
// out_d / out_i: (Q, k). Returns the CUDA error of the launches (0 = ok).
extern "C" int knn_launch(const float* q, const float* ref,
                          const uint8_t* mask, int Q, int M, int k, int S,
                          int range_len, float* part_d, int* part_i,
                          float* out_d, int* out_i, void* stream) {
  if (Q <= 0) return 0;
  if (M < 0 || S <= 0 || (long long)S * range_len < M)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (k) {
#define KNN_CASE(KK) \
  case KK:           \
    return launch<KK>(q, ref, mask, Q, M, S, range_len, part_d, part_i, \
                      out_d, out_i, st);
    KNN_CASE(1) KNN_CASE(2) KNN_CASE(3) KNN_CASE(4) KNN_CASE(5) KNN_CASE(6)
    KNN_CASE(7) KNN_CASE(8) KNN_CASE(9) KNN_CASE(10) KNN_CASE(11)
    KNN_CASE(12) KNN_CASE(13) KNN_CASE(14) KNN_CASE(15) KNN_CASE(16)
#undef KNN_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
