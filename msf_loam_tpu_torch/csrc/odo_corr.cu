// Fused scan-to-scan correspondence reductions over a thread-block cluster.
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
// What bounds it on the H100: latency and occupancy, not bytes or
// arithmetic. The frame's calls are small (N = 192-1536 queries, M =
// 1920-8192 points, 0.4-13 M distance evaluations per pass), so a design
// that gives each block the whole cloud fills 24-48 of 132 SMs and spends
// its time staging 128 KB and on dependent reductions.
//
// The design: the grid is (reference slice) x (query tile). One cluster of
// C = 16 blocks holds one tile of 32 queries and all C slices of the
// cloud; a slice is K/C whole bins (K > 0; one bin at K = 16) or M/C
// points (K = 0). Each block stages only its slice into shared
// memory as (x, y, z, ring) float4s with 16-byte loads (8 KB at the
// 16-ring plane call, so several blocks share an SM). Each lane holds one
// query in registers; each of the 8 warps scans 1/8 of the slice in index
// order with a strict `<` (its first argmin, no shuffles), reading each
// point as a shared-memory broadcast. Pass 1's per-warp minima merge in
// warp order into the bin candidates and the slice minimum, which the
// block pushes into every block of the cluster with distributed
// shared-memory stores (stores do not wait; no block reads another's
// shared memory). After a cluster barrier every block merges the C slice
// minima of its queries in slice order (the global first argmin, so a and
// ring_a), then scans its own slice for the nearest point on a nearby
// different ring and pushes that partial to rank 0; after a second
// barrier rank 0 merges the C partials in slice order and writes c. One
// launch per call.
//
// Lanes: a batch of B independent (queries, cloud) problems of one shape
// (the batched pipeline's lanes) runs in the same launch, lane b in
// blockIdx.z with its own offsets into every input and output; a lane's
// blocks never read another lane's data, so each lane's result is the
// single-lane result.
//
// Every merge takes the lower index on a tie, and the kernel is compiled
// with -fmad=false so d2 is rounded exactly as the plain PyTorch version
// rounds it: indices, rings and d2 match it bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;               // queries per cluster, one per lane
constexpr int kMaxCluster = 16;
constexpr int kMaxDevices = 64;
constexpr float kInf = 3.0e38f;         // odo_corr.py _INF

struct Shared {
  float pv[kWarps][kTile];              // per-warp partial minima
  int pi[kWarps][kTile];
  float sv[kMaxCluster][kTile];         // pass 1: every slice's minimum,
  int si[kMaxCluster][kTile];           //   pushed here by its block
  float sr[kMaxCluster][kTile];
  float cv[kMaxCluster][kTile];         // pass 2: every slice's partner
  int ci[kMaxCluster][kTile];           //   (used on rank 0)
  float ring_a[kTile];
};

__device__ __forceinline__ float dist2(float4 p, float qx, float qy,
                                       float qz) {
  const float dx = p.x - qx, dy = p.y - qy, dz = p.z - qz;
  return dx * dx + dy * dy + dz * dz;
}

__global__ void __launch_bounds__(kThreads)
odo_corr_kernel(const float* __restrict__ q, const float* __restrict__ ref,
                int N, int M, int K, int bins_per_block, float nearby,
                float* __restrict__ a_d2, int* __restrict__ a_idx,
                int* __restrict__ a_ring, float* __restrict__ c_d2,
                int* __restrict__ c_idx, float* __restrict__ cand_d2,
                int* __restrict__ cand_idx, int* __restrict__ cand_ring) {
  extern __shared__ float4 slice[];     // (x, y, z, ring) of this slice
  __shared__ Shared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int L = M / C;
  const int s0 = rank * L;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  {  // this block's lane of the batch
    const size_t b = blockIdx.z;
    q += b * N * 3;
    ref += b * 4 * M;
    a_d2 += b * N;
    a_idx += b * N;
    a_ring += b * N;
    c_d2 += b * N;
    c_idx += b * N;
    cand_d2 += b * N * K;
    cand_idx += b * N * K;
    cand_ring += b * N * K;
  }
  // this block has started: others may write its shared memory once every
  // block of the cluster has arrived here (the wait is after pass 1)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");

  const float4* gx = reinterpret_cast<const float4*>(ref + s0);
  const float4* gy = reinterpret_cast<const float4*>(ref + M + s0);
  const float4* gz = reinterpret_cast<const float4*>(ref + 2 * M + s0);
  const float4* gr = reinterpret_cast<const float4*>(ref + 3 * M + s0);
  for (int i = tid; i < L / 4; i += kThreads) {
    const float4 x = gx[i], y = gy[i], z = gz[i], r = gr[i];
    slice[4 * i] = make_float4(x.x, y.x, z.x, r.x);
    slice[4 * i + 1] = make_float4(x.y, y.y, z.y, r.y);
    slice[4 * i + 2] = make_float4(x.z, y.z, z.z, r.z);
    slice[4 * i + 3] = make_float4(x.w, y.w, z.w, r.w);
  }
  const int n = blockIdx.y * kTile + lane;
  const bool live = n < N;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (live) {
    qx = q[3 * n];
    qy = q[3 * n + 1];
    qz = q[3 * n + 2];
  }
  __syncthreads();

  // pass 1: this warp's segment of the slice, first argmin
  const int seg = L / kWarps;
  const int lo = warp * seg;
  float bv = INFINITY;
  int bi = lo;
#pragma unroll 4
  for (int j = lo; j < lo + seg; ++j) {
    const float d2 = dist2(slice[j], qx, qy, qz);
    if (d2 < bv) { bv = d2; bi = j; }
  }
  sh.pv[warp][lane] = bv;
  sh.pi[warp][lane] = bi;
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  if (warp == 0) {
    const int nb = K > 0 ? bins_per_block : 1;
    const int wpb = kWarps / nb;
    float mv = INFINITY;
    int mi = 0;
    for (int b = 0; b < nb; ++b) {
      float v = sh.pv[b * wpb][lane];
      int i = sh.pi[b * wpb][lane];
      for (int w = b * wpb + 1; w < (b + 1) * wpb; ++w) {
        const float ov = sh.pv[w][lane];
        if (ov < v) { v = ov; i = sh.pi[w][lane]; }
      }
      if (K > 0 && live) {
        const size_t o = (size_t)n * K + rank * nb + b;
        cand_d2[o] = v;
        cand_idx[o] = s0 + i;
        cand_ring[o] = (int)slice[i].w;
      }
      if (b == 0 || v < mv) { mv = v; mi = i; }
    }
    // push this slice's minimum into every block of the cluster
    const float mr = slice[mi].w;
    for (int c = 0; c < C; ++c) {
      Shared* o = cluster.map_shared_rank(&sh, c);
      o->sv[rank][lane] = mv;
      o->si[rank][lane] = s0 + mi;
      o->sr[rank][lane] = mr;
    }
  }
  cluster.sync();

  // the global first argmin from the C slice minima, in slice order
  if (warp == 0) {
    float av = sh.sv[0][lane], ar = sh.sr[0][lane];
    int ai = sh.si[0][lane];
    for (int c = 1; c < C; ++c) {
      const float v = sh.sv[c][lane];
      if (v < av) { av = v; ai = sh.si[c][lane]; ar = sh.sr[c][lane]; }
    }
    sh.ring_a[lane] = ar;
    if (rank == 0 && live) {
      a_d2[n] = av;
      a_idx[n] = ai;
      a_ring[n] = (int)ar;
    }
  }
  __syncthreads();

  // pass 2: nearest on a different nearby ring within this segment
  const float ra = sh.ring_a[lane];
  float cv = kInf;
  int ci = M;
#pragma unroll 4
  for (int j = lo; j < lo + seg; ++j) {
    const float4 p = slice[j];
    const float dr = fabsf(p.w - ra);
    if (dr > 0.0f && dr <= nearby) {
      const float d2 = dist2(p, qx, qy, qz);
      if (d2 < cv) { cv = d2; ci = s0 + j; }
    }
  }
  sh.pv[warp][lane] = cv;
  sh.pi[warp][lane] = ci;
  __syncthreads();
  if (warp == 0) {
    float v = sh.pv[0][lane];
    int i = sh.pi[0][lane];
    for (int w = 1; w < kWarps; ++w) {
      const float ov = sh.pv[w][lane];
      if (ov < v) { v = ov; i = sh.pi[w][lane]; }
    }
    Shared* o = cluster.map_shared_rank(&sh, 0);
    o->cv[rank][lane] = v;
    o->ci[rank][lane] = i;
  }
  cluster.sync();   // after it no block touches another's shared memory
  if (rank == 0 && warp == 0 && live) {
    float v = sh.cv[0][lane];
    int i = sh.ci[0][lane];
    for (int c = 1; c < C; ++c) {
      const float ov = sh.cv[c][lane];
      if (ov < v) { v = ov; i = sh.ci[c][lane]; }
    }
    c_d2[n] = v;
    c_idx[n] = i;
  }
}

struct DeviceSetup {
  std::once_flag once;
  int err = 0;
};
DeviceSetup g_setup[kMaxDevices];

// Once per process and device: allow the largest dynamic shared memory and
// clusters of 16 blocks (above the portable 8; Hopper schedules them).
int setup() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  DeviceSetup& s = g_setup[dev];
  std::call_once(s.once, [&s, dev] {
    int optin = 0;
    cudaFuncAttributes fa;
    cudaError_t e = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, odo_corr_kernel);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(odo_corr_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)fa.sharedSizeBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(odo_corr_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    s.err = (int)e;
  });
  return s.err;
}

// Blocks per cluster: K = 0 cuts M into 16 slices; K > 0 gives each block
// K/C whole bins, with the 8 warps split evenly over them (0 when no
// cluster size fits).
int cluster_size(int K) {
  if (K == 0) return kMaxCluster;
  for (int c = K < kMaxCluster ? K : kMaxCluster; c > 0; --c)
    if (K % c == 0 && kWarps % (K / c) == 0) return c;
  return 0;
}

}  // namespace

// q: (B, N, 3) f32; ref: (B, 4, M) f32 planes [x | y | z | ring], 16-byte
// aligned, with masked and padded points already at the 1e9 / 1e6
// sentinels; M a multiple of 128*K (of 128 when K = 0); outputs (B, N) and
// (B, N, K). Returns the CUDA error of the launch (0 = ok).
extern "C" int odo_corr_launch(const float* q, const float* ref, int B,
                               int N, int M, int K, float nearby,
                               float* a_d2, int* a_idx, int* a_ring,
                               float* c_d2, int* c_idx, float* cand_d2,
                               int* cand_idx, int* cand_ring, void* stream) {
  if (N <= 0 || B <= 0) return 0;
  const int err = setup();
  if (err != 0) return err;
  const int C = cluster_size(K);
  const int tiles = (N + kTile - 1) / kTile;
  if (C == 0 || K < 0 || M <= 0 || M % (8 * C) != 0 || tiles > 65535 ||
      B > 65535 || (K > 0 && M % K != 0) || ((uintptr_t)ref & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(C, tiles, B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)(M / C) * sizeof(float4);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const int bins_per_block = K > 0 ? K / C : 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, odo_corr_kernel, q, ref, N, M, K,
                                     bins_per_block, nearby, a_d2, a_idx,
                                     a_ring, c_d2, c_idx, cand_d2, cand_idx,
                                     cand_ring);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Blocks per cluster, blocks in the grid and dynamic shared memory bytes of
// one launch at these sizes (for reports).
extern "C" int odo_corr_geometry(int B, int N, int M, int K, int* cluster,
                                 int* blocks, int* smem) {
  const int C = cluster_size(K);
  if (C == 0) return (int)cudaErrorInvalidValue;
  *cluster = C;
  *blocks = B * C * ((N + kTile - 1) / kTile);
  *smem = (int)((M / C) * sizeof(float4));
  return 0;
}
