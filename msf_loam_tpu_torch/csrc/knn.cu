// Brute-force k nearest neighbours of (Q, 3) queries among (M, 3) masked
// reference points: ascending (d2, idx), k <= 16, one launch.
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
// What bounds it on the H100: instruction issue. Q x M pair evaluations
// (2.7e8 at Q = 4096, M = 65536) against ~1.2 MB of bytes (0.0004 ms at
// 3.35 TB/s). Compiled with -fmad=false (a multiply-add would round d2
// differently from the plain version), the plain distance and its compare
// are 9 float instructions a pair: 0.072 ms at 132 SMs x 128 lanes x
// 1.98 GHz, beside 0.032 ms for 8 flops a pair at 67 TFLOP/s.
//
// The design feeds the float pipe with fewer instructions a pair:
//   * A filter in three multiply-adds. Refs are staged in shared memory
//     as one float4 each, (x, y, z, W = |r|^2 (1 - 2^-19)), read from
//     memory 16 bytes a load (three float4s hold four refs), so one
//     broadcast 16-byte shared load serves a pair. A pair first computes
//     f = W - 2 q.r (3 multiply-adds) and compares it with a per-query
//     threshold F that bounds f for every ref whose exact d2 is at most the
//     current k-th distance (the bound is worked out at filter_thr). Only a
//     ref that passes has its exact d2 computed the plain version's way,
//     (dx^2 + dy^2) + dz^2 with no multiply-add (0 + dx^2 is dx^2, so the
//     plain version's pen add of a valid ref changes nothing), and goes
//     through the strict insertion, so d2 is bit-equal and a masked ref
//     (staged with W = +inf, never passing) never enters.
//   * No branch a pair. Each lane tests 32 refs into one bit mask per
//     query, then inserts its hits in index order.
//   * A bound first. Split over many ranges, every range's list would
//     fill up from its own first refs, and most pairs would insert. Phase 1
//     scans the first 64 refs of every range and merges the lists, giving
//     T, the k-th distance of that sample. Phase 2 starts every list full
//     of (next float after T, -1): a ref enters only when d2 <= T; at least
//     k refs do (the sample's), and every entry of the answer does, so the
//     placeholders never reach it (T = 3e38 when the sample holds fewer
//     than k valid refs: the plain rule).
//   * Lists of exactly k entries (one kernel per list length 2, 4, 5, 8,
//     16, a shorter k padded with -inf placeholders in front), so the k-th
//     distance sits at a fixed register; each thread keeps R = 2 queries.
//   * One launch over a thread-block cluster. A cluster of 8 blocks holds
//     one tile of 64 queries; block `rank` scans the rank-th eighth of the
//     refs, each of its 4 warps one contiguous range of it in index order
//     with the strict-`<` insertion, so each list keeps the lowest index
//     among equal distances. Lists then merge in index order: warp 1 into
//     warp 0 and 3 into 2, then 2 into 0 (through shared memory), then
//     across the cluster in a tree, rank r + s into rank r for s = 1, 2, 4,
//     each sender storing its lists into the receiver's shared memory
//     (distributed shared memory, double-buffered over the rounds), one
//     cluster barrier a round. A merge inserts the later (higher-index)
//     list into the earlier one with the strict `<`, so ties keep the
//     lowest index. Rank 0 broadcasts T after phase 1 and writes the
//     result and the sentinels after phase 2. A tree rather than 7 lists
//     into rank 0: every block of the launch would reserve that room.
//   At Q = 4096, M = 65536: 64 tiles x 8 ranks = 512 blocks of 128
//   threads, all resident at once.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;               // the in-block merge tree is 2 levels
constexpr int kThreads = 32 * kWarps;
constexpr int kRanks = 8;               // blocks per cluster (portable)
constexpr int kR = 2;                   // queries a thread
constexpr int kStage = 256;             // refs a warp stages at a time
constexpr int kSample = 64;             // refs a warp scans in phase 1
constexpr int kMaxK = 16;
constexpr float kInf = 3.0e38f;         // pallas_knn.py _INF

// List length for k (k <= KT; one kernel per KT).
__host__ __device__ constexpr int list_len(int k) {
  return k <= 2 ? 2 : (k <= 4 ? 4 : (k == 5 ? 5 : (k <= 8 ? 8 : 16)));
}

template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], float d,
                                       int i) {
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

// One warp's lists in shared memory, lane fastest (no bank conflicts).
template <int KT, int R>
struct Lists {
  float d[R][KT][32];
  int i[R][KT][32];
};

template <int KT, int R>
__device__ __forceinline__ void put(Lists<KT, R>* L, const float (&bd)[R][KT],
                                    const int (&bi)[R][KT], int lane) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      L->d[r][t][lane] = bd[r][t];
      L->i[r][t][lane] = bi[r][t];
    }
}

// Insert a later (higher-index) sorted list into the registers' lists
// (its first KT - k entries are the -inf placeholders).
template <int KT, int R>
__device__ __forceinline__ void merge_from(const Lists<KT, R>* L, int k,
                                           float (&bd)[R][KT],
                                           int (&bi)[R][KT], int lane) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      if (t < KT - k) continue;
      const float d = L->d[r][t][lane];
      if (!(d < bd[r][KT - 1])) break;  // the list is ascending
      insert<KT>(bd[r], bi[r], d, L->i[r][t][lane]);
    }
}

// Stage refs [base, base + len) of a warp's segment as float4s (x, y, z,
// W) with W = |r|^2 (1 - 2^-19) (the filter's term below; -inf where
// |r|^2 is not finite, so such a ref always reaches the exact test), a
// masked ref and the padding up to the next multiple of 32 as (0, 0, 0,
// +inf), which the filter never passes.
__device__ __forceinline__ void stage_refs(float4* st, const float* ref,
                                           const uint8_t* mask, int base,
                                           int len, int vec, int lane) {
  const int groups = (len + 31) / 32 * 8;           // four refs a group
  for (int g = lane; g < groups; g += 32) {
    const int m0 = base + 4 * g;                    // a multiple of 4
    float v[12];
    bool ok[4];
    if (vec && 4 * g + 4 <= len) {
      const float4* src = reinterpret_cast<const float4*>(ref) + 3 * (m0 / 4);
      const float4 a = __ldg(src), b = __ldg(src + 1), c = __ldg(src + 2);
      const uchar4 mk = __ldg(reinterpret_cast<const uchar4*>(mask + m0));
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
      v[8] = c.x; v[9] = c.y; v[10] = c.z; v[11] = c.w;
      ok[0] = mk.x != 0; ok[1] = mk.y != 0;
      ok[2] = mk.z != 0; ok[3] = mk.w != 0;
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int m = m0 + t;
        ok[t] = 4 * g + t < len && mask[m] != 0;
        v[3 * t] = ok[t] ? ref[3 * (size_t)m] : 0.0f;
        v[3 * t + 1] = ok[t] ? ref[3 * (size_t)m + 1] : 0.0f;
        v[3 * t + 2] = ok[t] ? ref[3 * (size_t)m + 2] : 0.0f;
      }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float x = v[3 * t], y = v[3 * t + 1], z = v[3 * t + 2];
      const float w = (x * x + y * y + z * z) * (1.0f - 0x1p-19f);
      st[4 * g + t] = ok[t] ? make_float4(x, y, z, isfinite(w) ? w : -INFINITY)
                            : make_float4(0.0f, 0.0f, 0.0f, INFINITY);
    }
  }
}

// The plain version's d2, rounded as it rounds it (no multiply-add).
__device__ __forceinline__ float dist2(float4 p, float qx, float qy,
                                       float qz) {
  const float dx = qx - p.x, dy = qy - p.y, dz = qz - p.z;
  const float d = dx * dx + dy * dy;
  return d + dz * dz;
}

// The filter: f = W - 2 q.r in three multiply-adds, tested against
// F(thr, s) with s = |q|^2 (1 - 2^-19). For any ref with dist2 <= thr,
// f <= F: f is |q - r|^2 - |q|^2 - 2^-19 |r|^2 up to 8 ulp of
// |q|^2 + |r|^2, which the 2^-19 shifts (32 ulp) cover together with the
// rounding of W and s; dist2 is within 3 ulp of |q - r|^2; and F adds 16
// ulp of thr, 16 ulp of thr + s (its subtraction's rounding) and FLT_MIN
// (subnormals). A NaN f (infinite coordinates) counts as a pass.
__device__ __forceinline__ float filter_thr(float thr, float s) {
  const float t = thr * (1.0f + 0x1p-20f);
  return (t - s) + 0x1p-20f * (t + s) + 1.17549435e-38f;
}

// Scan staged refs [0, len) (global index base + j) in index order, 32 at a
// time: each ref first passes the filter against the k-th distance as it
// stood before the chunk, into one bit mask per query (no branch a pair:
// 3 multiply-adds, a compare, a select); then each lane recomputes its
// hits' exact d2 and inserts them in index order. A stale k-th distance is
// an upper bound, so a ref the filter drops would not have entered.
template <int KT, int R>
__device__ __forceinline__ void scan(const float4* st, int len, int base,
                                     const float (&qx)[R],
                                     const float (&qy)[R],
                                     const float (&qz)[R],
                                     const float (&qs)[R],
                                     float (&bd)[R][KT], int (&bi)[R][KT]) {
  for (int j0 = 0; j0 < len; j0 += 32) {
    float thr[R];
    unsigned hit[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      thr[r] = filter_thr(bd[r][KT - 1], qs[r]);
      hit[r] = 0u;
    }
#pragma unroll 1
    for (int s8 = 0; s8 < 32; s8 += 8) {   // 8 refs unrolled: registers
      unsigned sub[R];
#pragma unroll
      for (int r = 0; r < R; ++r) sub[r] = 0u;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float4 p = st[j0 + s8 + u];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float f = __fmaf_rn(
              -2.0f * qz[r], p.z,
              __fmaf_rn(-2.0f * qy[r], p.y, __fmaf_rn(-2.0f * qx[r], p.x, p.w)));
          if (!(f > thr[r])) sub[r] |= 1u << u;
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) hit[r] |= sub[r] << s8;
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      while (hit[r]) {
        const int u = __ffs(hit[r]) - 1;
        hit[r] &= hit[r] - 1u;
        const float4 p = st[j0 + u];
        const float d = dist2(p, qx[r], qy[r], qz[r]);
        if (p.w != INFINITY && d < bd[r][KT - 1])   // +inf W: masked
          insert<KT>(bd[r], bi[r], d, base + j0 + u);
      }
  }
}

// Merge the 4 warps' lists into warp 0's, then the blocks' lists into
// rank 0's (see the note at the head of the file); `round` counts the
// cluster rounds for the double buffer.
template <int KT, int R>
__device__ __forceinline__ void merge_all(float4* stage, Lists<KT, R>* recv,
                                          cg::cluster_group& cluster, int C,
                                          int rank, int warp, int lane, int k,
                                          int& round, float (&bd)[R][KT],
                                          int (&bi)[R][KT]) {
  __syncthreads();                      // every warp is done with the stage
  Lists<KT, R>* wl = reinterpret_cast<Lists<KT, R>*>(stage);
  if (warp & 1) put<KT, R>(&wl[warp >> 1], bd, bi, lane);
  __syncthreads();
  if (!(warp & 1)) merge_from<KT, R>(&wl[warp >> 1], k, bd, bi, lane);
  __syncthreads();
  if (warp == 2) put<KT, R>(&wl[0], bd, bi, lane);
  __syncthreads();
  if (warp == 0) merge_from<KT, R>(&wl[0], k, bd, bi, lane);
  for (int s = 1; s < C; s <<= 1, ++round) {
    if (warp == 0 && (rank & (2 * s - 1)) == s)
      put<KT, R>(cluster.map_shared_rank(&recv[round & 1], rank - s), bd, bi,
                 lane);
    cluster.sync();
    if (warp == 0 && (rank & (2 * s - 1)) == 0 && rank + s < C)
      merge_from<KT, R>(&recv[round & 1], k, bd, bi, lane);
  }
}

template <int KT, int R>
__global__ void __launch_bounds__(kThreads, 4)
knn_kernel(const float* __restrict__ q, const float* __restrict__ ref,
           const uint8_t* __restrict__ mask, int Q, int M, int k, int seg,
           int vec, float* __restrict__ out_d, int* __restrict__ out_i) {
  // staging (16 KB); during a merge it holds two warps' lists
  __shared__ __align__(16) float4 stage[kWarps * kStage];
  __shared__ Lists<KT, R> recv[2];      // cluster rounds, double-buffered
  __shared__ float bound[R][32];        // phase 1's k-th distances
  static_assert(2 * sizeof(Lists<KT, R>) <= sizeof(stage), "lists fit");
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  // this block has started: others may store into its shared memory once
  // every block of the cluster has arrived here (the wait is after phase
  // 1's scan)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.y * 32 * R;

  float qx[R], qy[R], qz[R], qs[R];
  float bd[R][KT];
  int bi[R][KT];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int n = q0 + 32 * r + lane;
    qx[r] = qy[r] = qz[r] = 0.0f;
    if (n < Q) {
      qx[r] = q[3 * n];
      qy[r] = q[3 * n + 1];
      qz[r] = q[3 * n + 2];
    }
    qs[r] = (qx[r] * qx[r] + qy[r] * qy[r] + qz[r] * qz[r]) * (1.0f - 0x1p-19f);
#pragma unroll
    for (int t = 0; t < KT; ++t) {   // k entries after KT - k placeholders
      bd[r][t] = t < KT - k ? -INFINITY : kInf;
      bi[r][t] = -1;
    }
  }

  // this warp's segment [lo, hi) of the refs, in index order
  const int lo = (rank * kWarps + warp) * seg;
  const int hi = min(M, lo + seg);
  float4* st = stage + warp * kStage;

  // phase 1: the k-th distance T among the first kSample refs of every
  // segment, merged over the cluster
  const int len1 = max(0, min(kSample, hi - lo));
  stage_refs(st, ref, mask, lo, len1, vec, lane);
  __syncwarp();
  scan<KT, R>(st, len1, lo, qx, qy, qz, qs, bd, bi);
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  int round = 0;
  merge_all<KT, R>(stage, recv, cluster, C, rank, warp, lane, k, round, bd,
                   bi);
  if (rank == 0 && warp == 0)
    for (int c = 0; c < C; ++c) {
      float* o = cluster.map_shared_rank(&bound[0][0], c);
#pragma unroll
      for (int r = 0; r < R; ++r) o[32 * r + lane] = bd[r][KT - 1];
    }
  cluster.sync();

  // phase 2: every ref, each list starting full of (T', -1), T' the float
  // after T, so a ref enters only when d <= T. Where T < 3e38, at least k
  // refs have d <= T (phase 1 found them) and every entry of the answer
  // does, so the sentinels never reach it; else the rule is the plain
  // strict one from 3e38.
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float T = bound[r][lane];
    const float Tp = T < kInf ? nextafterf(T, INFINITY) : kInf;
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      bd[r][t] = t < KT - k ? -INFINITY : Tp;
      bi[r][t] = -1;
    }
  }
  for (int base = lo; base < hi; base += kStage) {
    const int len = min(kStage, hi - base);
    stage_refs(st, ref, mask, base, len, vec, lane);
    __syncwarp();
    scan<KT, R>(st, len, base, qx, qy, qz, qs, bd, bi);
    __syncwarp();
  }
  merge_all<KT, R>(stage, recv, cluster, C, rank, warp, lane, k, round, bd,
                   bi);
  if (rank == 0 && warp == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int n = q0 + 32 * r + lane;
      if (n >= Q) continue;
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        if (t < KT - k) continue;
        const bool empty = bi[r][t] < 0 || bd[r][t] >= kInf * 0.5f;
        const size_t o = (size_t)n * k + t - (KT - k);
        out_d[o] = empty ? kInf : bd[r][t];
        out_i[o] = empty ? -1 : bi[r][t];
      }
    }
  }
}

#define KNN_KERNEL(KT) knn_kernel<KT, kR>
#define KNN_ALL(X) X(2) X(4) X(5) X(8) X(16)

cudaLaunchConfig_t config(int Q, cudaLaunchAttribute* attr,
                          cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kRanks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  const int tile = 32 * kR;
  cfg.gridDim = dim3(kRanks, (Q + tile - 1) / tile, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int KT>
int launch(const float* q, const float* ref, const uint8_t* mask, int Q,
           int M, int k, int seg, float* out_d, int* out_i,
           cudaStream_t stream) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(Q, &attr, stream);
  const int vec = ((uintptr_t)ref & 15) == 0 && ((uintptr_t)mask & 3) == 0;
  cudaError_t e = cudaLaunchKernelEx(&cfg, KNN_KERNEL(KT), q, ref, mask, Q, M,
                                     k, seg, vec, out_d, out_i);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int KT>
int geometry(int Q, int* out) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(Q, &attr, 0);
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, KNN_KERNEL(KT));
  int clusters = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(&clusters, KNN_KERNEL(KT), &cfg);
  if (e != cudaSuccess) return (int)e;
  const int v[9] = {kRanks, (int)(cfg.gridDim.x * cfg.gridDim.y), kThreads,
                    kR, (int)fa.sharedSizeBytes, fa.numRegs,
                    (int)fa.localSizeBytes, clusters, KT};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

}  // namespace

// q: (Q, 3) f32; ref: (M, 3) f32; mask: (M,) bool as bytes; each of the
// 8 x 4 warps of a cluster scans `seg` refs (a multiple of 4, 32 seg >=
// M), and a thread keeps R queries (checked against the kernel's own);
// out_d / out_i: (Q, k). Returns the CUDA error of the launch (0 = ok).
extern "C" int knn_launch(const float* q, const float* ref,
                          const uint8_t* mask, int Q, int M, int k, int seg,
                          int R, float* out_d, int* out_i, void* stream) {
  if (Q <= 0) return 0;
  if (M < 0 || k < 1 || k > kMaxK || R != kR || seg <= 0 ||
      seg % 4 != 0 || (long long)seg * kRanks * kWarps < M ||
      (Q + 32 * R - 1) / (32 * R) > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (list_len(k)) {
#define KNN_CASE(KT) \
  case KT:           \
    return launch<KT>(q, ref, mask, Q, M, k, seg, out_d, out_i, st);
    KNN_ALL(KNN_CASE)
#undef KNN_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Geometry of one launch (for reports): out = [blocks per cluster, blocks,
// threads, queries a thread, static shared bytes, registers a thread,
// local (spill) bytes a thread, clusters resident at once, list length].
extern "C" int knn_geometry(int Q, int k, int* out) {
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  switch (list_len(k)) {
#define KNN_CASE(KT) \
  case KT:           \
    return geometry<KT>(Q, out);
    KNN_ALL(KNN_CASE)
#undef KNN_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
