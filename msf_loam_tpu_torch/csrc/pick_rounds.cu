// All greedy LOAM feature-pick rounds of one scan, one thread-block cluster
// per ring row, as a walk over each sector's columns sorted once per score
// plane.
//
// Replaces the Pallas TPU kernel msf_loam_tpu/ops/pick_rounds.py
// (pick_rounds_pallas, body _pick_kernel/_round). Per ring row it runs the
// sharp phase (n_sharp rounds, one pick per sector), the less-sharp phase
// (n_rest_rounds rounds of rest_T picks per sector) and, after writing the
// suppression plane the less-flat mask reads, the flat phase (n_flat
// rounds, one pick per sector, on the negated flat score). Each round:
//   * per sector, rest_T / 1 iterated masked argmaxes (ties go to the
//     lowest index, as lax.top_k and the Pallas min-index reduction do);
//   * a pairwise dominance test among the round's picks: q drops p when
//     0 < |i_q - i_p| <= nsup with an unbroken gap chain (cb0 equal) and q
//     scores higher (or equal with a lower index);
//   * suppression of +-nsup gap-chain neighbours of every kept pick,
//     carried across rounds and phases.
//
// What bounds it on the H100: latency and serial dependence, not bytes (a
// row is ~21 B x W). Run as iterated argmaxes, each of the 24 dependent
// picks per sector scans the row again; what no design removes is the
// chain of dependent rounds (9 with the default config), each a few
// block barriers long.
//
// The design rests on an invariant of the rounds: availability is rebuilt
// from the score and the suppression at every round, so the T argmaxes of
// sector s in a round are exactly the first T unsuppressed columns of s in
// (score descending, column ascending) order whose score is > -0.5e18, and
// a slot with no such column is -1. Suppression only grows, so within a
// phase the first unsuppressed position of that order never moves back.
//
// So each column becomes one 64-bit key per score plane (sector |
// order-preserving score bits, -0.0 taken as +0.0 so the order is the
// float `>` | column; invalid columns get sector 1023), and a cluster of
// min(S, 8) blocks per row sorts the planes up front: block b compacts the
// valid keys of sectors b, b + 8, ... in column order (a block prefix sum)
// and sorts each sector's run with a bitonic sort whose stages run in
// registers, then across lanes by shuffles, then across warps through
// shared memory in a conflict-free layout; a run gets 2, 4 or 8 keys per
// thread, so that as many warps as possible share it. The sector ids need
// not be contiguous. The blocks exchange their run lengths and store their
// sorted runs into block 0 through distributed shared memory, in sector
// order.
// Block 0 then runs the rounds. A round gives each sector a warp that reads
// 32 sorted entries from the sector's cursor, tests the suppression with
// one ballot, takes the first T free entries by popcount and moves on only
// when a window runs out; the cursor then stands at the first free entry.
// The dominance test looks, for each pick, only at the 2 * nsup columns
// around it through a column -> pick map, over (pick, offset) pairs in
// parallel; the suppression update runs over (pick, offset) pairs too (it
// only sets flags). No index past the row is ever read.
//
// Floats are only compared, never combined, so results are bit-equal to
// the plain PyTorch version (msf_loam_tpu_torch/ops/pick_rounds.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

using u64 = unsigned long long;

constexpr int kPerThread = 8;          // row columns per thread
constexpr int kMinKeys = 32 * kPerThread;
constexpr int kMaxKeys = 4096;         // W <= 4096: at most 512 threads
constexpr int kMaxPicks = 256;         // S * T of one round
constexpr int kMaxSectors = 64;
constexpr int kMaxCluster = 8;         // blocks per row (portable)
constexpr int kMaxDevices = 64;
constexpr float kBig = 1.0e18f;        // pick_rounds.py _BIG
constexpr int kColBits = 22;
constexpr int kSecShift = 54;
constexpr u64 kColMask = (1ull << kColBits) - 1;
constexpr u64 kNoSector = 1023;        // invalid columns sort after all

struct RoundBuf {
  int fi[kMaxPicks];
  float fv[kMaxPicks];
  int fok[kMaxPicks];
  int fcb[kMaxPicks];
  int dom[kMaxPicks];
};

struct Shared {
  RoundBuf rb;
  int cnt[2][kMaxSectors];             // valid columns per sector and plane
  int lo[2][kMaxSectors];              // sector runs of each sorted plane
  int hi[2][kMaxSectors];
  int cur[kMaxSectors];                // per-sector cursor of the phase
  int2 warp_sums[kMaxKeys / kPerThread / 32];
};

// Ascending key order = sector, then score descending, then column.
__device__ __forceinline__ u64 make_key(float v, int sec, int S, int col) {
  if (!(v > -0.5f * kBig) || sec < 0 || sec >= S)
    return (kNoSector << kSecShift) | (u64)col;
  unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);   // ascending in v
  return ((u64)sec << kSecShift) | ((u64)(~u) << kColBits) | (u64)col;
}

__device__ __forceinline__ float key_score(u64 key) {
  const unsigned u = ~(unsigned)(key >> kColBits);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ void cas(u64& a, u64& b, bool up) {
  if ((a > b) == up) {
    const u64 t = a;
    a = b;
    b = t;
  }
}

__device__ __forceinline__ u64 select_side(u64 mine, u64 other,
                                           bool take_min) {
  return take_min ? (other < mine ? other : mine)
                  : (other > mine ? other : mine);
}

// One compare-exchange stage with the partner J apart inside the thread.
template <int E, int J>
__device__ __forceinline__ void stage_in_thread(u64 (&a)[E], u64 (&b)[E],
                                                int base, int k) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if ((e & J) == 0) {
      const bool up = ((base + e) & k) == 0;
      cas(a[e], a[e + J], up);
      cas(b[e], b[e + J], up);
    }
  }
}

// One stage with the partner in another warp, through shared memory. Key
// e of thread t sits at buf[e * nta + t] (nta active threads), so a warp's
// accesses are consecutive words (no bank conflicts); the partner of key
// E t + e is key e of thread t ^ (j / E). Inactive threads only pass the
// barriers.
template <int E>
__device__ __forceinline__ void stage_across_warps(u64 (&x)[E], u64* buf,
                                                   int base, int j, int k,
                                                   int nta) {
  const int tid = threadIdx.x;
  const bool active = tid < nta;
  if (active) {
#pragma unroll
    for (int e = 0; e < E; ++e) buf[e * nta + tid] = x[e];
  }
  __syncthreads();
  if (active) {
    const int partner = tid ^ (j / E);
    const bool lower = (base & j) == 0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const bool up = ((base + e) & k) == 0;
      x[e] = select_side(x[e], buf[e * nta + partner], lower == up);
    }
  }
  __syncthreads();
}

// Sorts both key planes ascending. Thread t < n / E holds keys
// [E t, E t + E) of each; n is a power of two and n / E a multiple of 32;
// `buf` holds n keys. The other threads of the block only pass the
// barriers.
template <int E>
__device__ __forceinline__ void bitonic_sort2(u64 (&a)[E], u64 (&b)[E],
                                              u64* buf, int n) {
  const int tid = threadIdx.x;
  const int base = tid * E, nta = n / E;
  const bool active = tid < nta;
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= 32 * E) {                          // across warps
        stage_across_warps<E>(a, buf, base, j, k, nta);
        stage_across_warps<E>(b, buf, base, j, k, nta);
      } else if (!active) {
      } else if (j < E) {                         // inside the thread
        if constexpr (E > 4) {
          if (j == 4) {
            stage_in_thread<E, 4>(a, b, base, k);
            continue;
          }
        }
        if constexpr (E > 2) {
          if (j == 2) {
            stage_in_thread<E, 2>(a, b, base, k);
            continue;
          }
        }
        stage_in_thread<E, 1>(a, b, base, k);
      } else {                                    // across lanes
        const int lj = j / E;
        const bool lower = (tid & lj) == 0;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const bool take_min = lower == (((base + e) & k) == 0);
          const u64 oa = __shfl_xor_sync(0xffffffffu, a[e], lj);
          const u64 ob = __shfl_xor_sync(0xffffffffu, b[e], lj);
          a[e] = select_side(a[e], oa, take_min);
          b[e] = select_side(b[e], ob, take_min);
        }
      }
    }
  }
}

// Block-wide exclusive prefix sums of two per-thread counts (column order
// = thread order); returns the two block totals.
__device__ int2 block_scan2(int& x, int& y, int2* warp_sums) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int ix = x, iy = y;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int ux = __shfl_up_sync(0xffffffffu, ix, o);
    const int uy = __shfl_up_sync(0xffffffffu, iy, o);
    if (lane >= o) { ix += ux; iy += uy; }
  }
  if (lane == 31) warp_sums[warp] = make_int2(ix, iy);
  __syncthreads();
  int2 before = make_int2(0, 0), total = make_int2(0, 0);
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    const int2 v = warp_sums[w];
    if (w < warp) { before.x += v.x; before.y += v.y; }
    total.x += v.x;
    total.y += v.y;
  }
  __syncthreads();
  x = before.x + ix - x;
  y = before.y + iy - y;
  return total;
}

// Valid columns of sector s among this thread's 8 keys.
__device__ __forceinline__ int count_sector(const u64 (&k)[kPerThread],
                                            int s) {
  int n = 0;
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) n += (k[e] >> kSecShift) == (u64)s;
  return n;
}

// This thread's E keys of sector s's run of one plane: the block writes
// the run in column order (pos: this thread's offset in it) into buf,
// padded with ~0 to n keys.
template <int E>
__device__ __forceinline__ void load_run(const u64 (&k)[kPerThread], int s,
                                         int pos, int count, int n,
                                         u64* buf, u64 (&x)[E]) {
  const int tid = threadIdx.x, nt = blockDim.x;
#pragma unroll
  for (int e = 0; e < kPerThread; ++e)
    if ((k[e] >> kSecShift) == (u64)s) buf[pos++] = k[e];
  for (int i = count + tid; i < n; i += nt) buf[i] = ~0ull;
  __syncthreads();
#pragma unroll
  for (int e = 0; e < E; ++e) x[e] = tid * E < n ? buf[tid * E + e] : ~0ull;
  __syncthreads();
}

// Sorts sector s's runs of both planes (nc and nf valid keys, padded to n)
// with E keys per thread and stores them at home_c + oc / home_f + of.
template <int E>
__device__ __forceinline__ void sort_runs(const u64 (&kc)[kPerThread],
                                          const u64 (&kf)[kPerThread], int s,
                                          int pc, int pf, int nc, int nf,
                                          int n, u64* buf, u64* home_c,
                                          u64* home_f) {
  u64 a[E], b[E];
  load_run<E>(kc, s, pc, nc, n, buf, a);
  load_run<E>(kf, s, pf, nf, n, buf, b);
  bitonic_sort2<E>(a, b, buf, n);
  const int base = threadIdx.x * E;
  if (base < n) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (base + e < nc) home_c[base + e] = a[e];
      if (base + e < nf) home_f[base + e] = b[e];
    }
  }
}

__device__ void pick_round(const u64* ord, const int* hi, int* cur,
                           const int* cb0, unsigned char* sup, short* pmap,
                           RoundBuf& rb, int W, int S, int T, int nsup,
                           int* picks, int slot0, int r, int R) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, nwarps = nt >> 5;
  // the first T free entries of each sector from its cursor, by ballots
  for (int s = warp; s < S; s += nwarps) {
    const int end = hi[s];
    int pos = cur[s], got = 0, first = end;
    while (got < T && pos < end) {
      const int j = pos + lane;
      u64 key = 0;
      bool free = false;
      if (j < end) {
        key = ord[j];
        free = !sup[key & kColMask];
      }
      const unsigned m = __ballot_sync(0xffffffffu, free);
      if (m && first == end) first = pos + __ffs(m) - 1;
      const int t = got + __popc(m & ((1u << lane) - 1u));
      if (free && t < T) {
        const int col = (int)(key & kColMask);
        const int p = s * T + t;
        rb.fi[p] = col;
        rb.fv[p] = key_score(key);
        rb.fok[p] = 1;
        rb.fcb[p] = cb0[col];
        rb.dom[p] = 0;
        pmap[col] = (short)p;
      }
      got += __popc(m);
      pos += 32;
    }
    for (int t = got + lane; t < T; t += 32) {   // fewer than T valid
      rb.fi[s * T + t] = -1;
      rb.fok[s * T + t] = 0;
    }
    if (lane == 0) cur[s] = first;
  }
  __syncthreads();
  // dominance: a pick meets only the picks within +-nsup columns, found
  // through the column -> pick map; each pick has 2^lg >= 2 nsup + 1
  // (pick, offset) pairs, one per thread, offset o standing for column
  // fi - nsup + o
  const int ST = S * T;
  const int lg = 32 - __clz(2 * nsup), slots = 1 << lg;
  for (int x = tid; x < ST * slots; x += nt) {
    const int p = x >> lg, o = x & (slots - 1);
    if (o > 2 * nsup || o == nsup || !rb.fok[p]) continue;
    const int fip = rb.fi[p];
    const int w = fip - nsup + o;
    if (w < 0 || w >= W) continue;
    const int q = pmap[w];
    if (q >= 0 && rb.fcb[q] == rb.fcb[p] &&
        (rb.fv[q] > rb.fv[p] || (rb.fv[q] == rb.fv[p] && w < fip)))
      rb.dom[p] = 1;
  }
  __syncthreads();
  // output, suppression of the kept picks' gap-chain windows, map cleared
  for (int x = tid; x < ST * slots; x += nt) {
    const int p = x >> lg, o = x & (slots - 1);
    if (o > 2 * nsup) continue;
    const bool keep = rb.fok[p] && !rb.dom[p];
    const int fip = rb.fi[p];
    if (o == 0) {
      picks[((size_t)(slot0 + p % T) * R + r) * S + p / T] = keep ? fip : -1;
      if (rb.fok[p]) pmap[fip] = -1;
    }
    const int w = fip - nsup + o;
    if (keep && w >= 0 && w < W && cb0[w] == rb.fcb[p]) sup[w] = 1;
  }
  __syncthreads();
}

// One cluster of C blocks per ring row. Block b sorts sectors b, b + C, ...
// of both score planes and stores them into block 0, which runs the rounds.
__global__ void __launch_bounds__(kMaxKeys / kPerThread)
pick_rounds_kernel(const float* __restrict__ score_c,
                   const float* __restrict__ score_f,
                   const int* __restrict__ sector_g,
                   const int* __restrict__ cb0_g, int* __restrict__ picks,
                   unsigned char* __restrict__ sup_out, int R, int W, int S,
                   int nsup, int n_sharp, int n_rest_rounds, int rest_T,
                   int n_flat) {
  extern __shared__ u64 smem[];
  const int nkeys = blockDim.x * kPerThread;      // >= W, a power of two
  u64* ord_c = smem;                              // sorted planes (block 0)
  u64* ord_f = ord_c + W;
  u64* buf = ord_f + W;                           // runs being sorted here
  int* cb0 = reinterpret_cast<int*>(buf + nkeys);
  short* pmap = reinterpret_cast<short*>(cb0 + W);
  unsigned char* sup = reinterpret_cast<unsigned char*>(pmap + W);
  __shared__ Shared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int r = blockIdx.y, tid = threadIdx.x, nt = blockDim.x;
  const size_t row = (size_t)r * W;
  // block 0's shared memory is written by the others once all have started
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");

  // this thread's 8 columns as keys of both planes (invalid ones ~0)
  const int w0 = tid * kPerThread;
  u64 kc[kPerThread], kf[kPerThread];
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int w = w0 + e;
    kc[e] = kf[e] = ~0ull;
    if (w < W) {
      const int sec = sector_g[row + w];
      kc[e] = make_key(score_c[row + w], sec, S, w);
      kf[e] = make_key(score_f[row + w], sec, S, w);
    }
  }
  if (rank == 0) {
    for (int w = tid; w < W; w += nt) {
      cb0[w] = cb0_g[row + w];
      pmap[w] = -1;
      sup[w] = 0;
    }
  }
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");

  // every sector's valid-column counts, from the block that sorts it, to
  // every block of the cluster
  for (int s = rank; s < S; s += C) {
    int nc = count_sector(kc, s), nf = count_sector(kf, s);
    const int2 tot = block_scan2(nc, nf, sh.warp_sums);
    if (tid < C) {
      Shared* o = cluster.map_shared_rank(&sh, tid);
      o->cnt[0][s] = tot.x;
      o->cnt[1][s] = tot.y;
    }
  }
  cluster.sync();
  for (int s = tid; s < S; s += nt) {    // each sector's run in block 0
    int oc = 0, of = 0;
    for (int z = 0; z < s; ++z) {
      oc += sh.cnt[0][z];
      of += sh.cnt[1][z];
    }
    sh.lo[0][s] = sh.cur[s] = oc;
    sh.hi[0][s] = oc + sh.cnt[0][s];
    sh.lo[1][s] = of;
    sh.hi[1][s] = of + sh.cnt[1][s];
  }
  __syncthreads();
  // sort each of this block's sectors and store its runs into block 0,
  // with 2, 4 or 8 keys per thread so that the most threads share a run
  u64* home_c = cluster.map_shared_rank(ord_c, 0);
  u64* home_f = cluster.map_shared_rank(ord_f, 0);
  for (int s = rank; s < S; s += C) {
    int pc = count_sector(kc, s), pf = count_sector(kf, s);
    const int2 tot = block_scan2(pc, pf, sh.warp_sums);
    int n = 64;
    while (n < tot.x || n < tot.y) n <<= 1;
    u64* hc = home_c + sh.lo[0][s];
    u64* hf = home_f + sh.lo[1][s];
    if (n <= 2 * nt)
      sort_runs<2>(kc, kf, s, pc, pf, tot.x, tot.y, n, buf, hc, hf);
    else if (n <= 4 * nt)
      sort_runs<4>(kc, kf, s, pc, pf, tot.x, tot.y, n, buf, hc, hf);
    else
      sort_runs<8>(kc, kf, s, pc, pf, tot.x, tot.y, n, buf, hc, hf);
    __syncthreads();
  }
  cluster.sync();   // block 0 holds both sorted planes; the others are done
  if (rank != 0) return;

  int slot = 0;
  for (int i = 0; i < n_sharp; ++i, slot += 1)
    pick_round(ord_c, sh.hi[0], sh.cur, cb0, sup, pmap, sh.rb, W, S, 1, nsup,
               picks, slot, r, R);
  for (int i = 0; i < n_rest_rounds; ++i, slot += rest_T)
    pick_round(ord_c, sh.hi[0], sh.cur, cb0, sup, pmap, sh.rb, W, S, rest_T,
               nsup, picks, slot, r, R);
  // the less-flat mask reads the suppression after the corner phases
  for (int w = tid; w < W; w += nt) sup_out[row + w] = sup[w];
  for (int s = tid; s < S; s += nt) sh.cur[s] = sh.lo[1][s];
  __syncthreads();
  for (int i = 0; i < n_flat; ++i, slot += 1)
    pick_round(ord_f, sh.hi[1], sh.cur, cb0, sup, pmap, sh.rb, W, S, 1, nsup,
               picks, slot, r, R);
}

// Threads per block (8 keys each, >= 32) for rows of W columns, and the
// block's dynamic shared memory.
int threads_for(int W) {
  int n = kMinKeys;
  while (n < W) n <<= 1;
  return n / kPerThread;
}

size_t smem_for(int W) {
  return (size_t)(2 * W + threads_for(W) * kPerThread) * sizeof(u64) +
         (size_t)W * (sizeof(int) + sizeof(short) + 1);
}

struct DeviceSetup {
  std::once_flag once;
  int err = 0;
};
DeviceSetup g_setup[kMaxDevices];

// Once per process and device: allow the largest dynamic shared memory.
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
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, pick_rounds_kernel);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(pick_rounds_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)fa.sharedSizeBytes);
    s.err = (int)e;
  });
  return s.err;
}

}  // namespace

// picks: (n_sharp + n_rest_rounds * rest_T + n_flat, R, S) int32;
// sup_out: (R, W) bool; W <= 4096, S <= 64, nsup <= W,
// S * max(rest_T, 1) <= 256.
// Returns the CUDA error of the launch (0 = ok).
extern "C" int pick_rounds_launch(const float* score_c, const float* score_f,
                                  const int* sector, const int* cb0,
                                  int* picks, unsigned char* sup_out, int R,
                                  int W, int S, int nsup, int n_sharp,
                                  int n_rest_rounds, int rest_T, int n_flat,
                                  void* stream) {
  if (R <= 0) return 0;
  if (W <= 0 || W > kMaxKeys || S <= 0 || S > kMaxSectors || R > 65535 ||
      rest_T <= 0 || nsup < 0 || nsup > W ||
      S * (rest_T > 1 ? rest_T : 1) > kMaxPicks)
    return (int)cudaErrorInvalidValue;
  const int err = setup();
  if (err != 0) return err;
  const int C = S < kMaxCluster ? S : kMaxCluster;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(C, R, 1);
  cfg.blockDim = dim3(threads_for(W), 1, 1);
  cfg.dynamicSmemBytes = smem_for(W);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, pick_rounds_kernel, score_c, score_f, sector, cb0, picks, sup_out,
      R, W, S, nsup, n_sharp, n_rest_rounds, rest_T, n_flat);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Blocks per cluster (one cluster per row), threads per block and dynamic
// shared memory bytes of a launch (for reports).
extern "C" int pick_rounds_geometry(int W, int S, int* cluster, int* threads,
                                    int* smem) {
  if (W <= 0 || W > kMaxKeys || S <= 0 || S > kMaxSectors)
    return (int)cudaErrorInvalidValue;
  *cluster = S < kMaxCluster ? S : kMaxCluster;
  *threads = threads_for(W);
  *smem = (int)smem_for(W);
  return 0;
}
