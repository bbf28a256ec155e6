// All greedy LOAM feature-pick rounds of one scan, one block per ring row.
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
// What bounds it on the H100: latency and serial dependence, not bytes.
// One row moves ~21 B x W (about 0.6 MB for 16 x 2048) but runs
// 2 + 3 x 6 + 4 = 24 dependent argmaxes per sector. The design keeps the
// whole row (scores, sector ids, gap prefix, availability, suppression)
// in shared memory, gives each sector its own warp so the sectors' argmaxes
// run side by side (warp-shuffle reductions, no block barrier per pick),
// and applies suppression only around the <= S*T kept picks instead of
// sweeping the row once per pick.
//
// Floats are only compared, never combined, so results are bit-equal to
// the plain PyTorch version (msf_loam_tpu_torch/ops/pick_rounds.py).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPicks = 256;   // S * T of one round; <= kThreads
constexpr float kBig = 1.0e18f;  // pick_rounds.py _BIG

struct RoundBuf {
  int fi[kMaxPicks];
  float fv[kMaxPicks];
  int fok[kMaxPicks];
  int fcb[kMaxPicks];
  int keep[kMaxPicks];
};

__device__ void pick_round(const float* score, float* avail, const int* sector,
                           const int* cb0, unsigned char* sup, RoundBuf& rb,
                           int W, int S, int T, int nsup, int* picks,
                           int slot0, int r, int R) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const float neg_inf = __int_as_float(0xff800000);
  for (int w = tid; w < W; w += blockDim.x) avail[w] = sup[w] ? -kBig : score[w];
  __syncthreads();
  for (int s = warp; s < S; s += nwarps) {
    for (int t = 0; t < T; ++t) {
      float bv = neg_inf;
      int bi = W;
      for (int w = lane; w < W; w += 32) {
        const float v = (sector[w] == s) ? avail[w] : -kBig;
        if (v > bv) { bv = v; bi = w; }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
      }
      const int p = s * T + t;
      const bool ok = bv > -0.5f * kBig;
      if (lane == 0) {
        rb.fi[p] = bi;
        rb.fv[p] = bv;
        rb.fok[p] = ok;
        rb.fcb[p] = cb0[bi];
        if (ok) avail[bi] = -kBig;   // consumed: only ever inside sector s
      }
      __syncwarp();
    }
  }
  __syncthreads();
  const int ST = S * T;
  if (tid < ST) {
    const int fip = rb.fi[tid], cbp = rb.fcb[tid];
    const float fvp = rb.fv[tid];
    bool dom = false;
    for (int q = 0; q < ST; ++q) {
      const int d = abs(rb.fi[q] - fip);
      const bool near = d > 0 && d <= nsup;
      const bool better = rb.fv[q] > fvp || (rb.fv[q] == fvp && rb.fi[q] < fip);
      dom = dom || (near && rb.fcb[q] == cbp && better && rb.fok[q]);
    }
    rb.keep[tid] = rb.fok[tid] && !dom;
  }
  __syncthreads();
  for (int p = 0; p < ST; ++p) {
    if (!rb.keep[p]) continue;            // block-uniform (shared read)
    const int fip = rb.fi[p], cbp = rb.fcb[p];
    for (int j = tid; j <= 2 * nsup; j += blockDim.x) {
      const int w = fip - nsup + j;
      if (w >= 0 && w < W && cb0[w] == cbp) sup[w] = 1;
    }
  }
  if (tid < ST) {
    const int s = tid / T, t = tid % T;
    picks[((size_t)(slot0 + t) * R + r) * S + s] = rb.keep[tid] ? rb.fi[tid] : -1;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
pick_rounds_kernel(const float* __restrict__ score_c,
                   const float* __restrict__ score_f,
                   const int* __restrict__ sector_g,
                   const int* __restrict__ cb0_g, int* __restrict__ picks,
                   unsigned char* __restrict__ sup_out, int R, int W, int S,
                   int nsup, int n_sharp, int n_rest_rounds, int rest_T,
                   int n_flat) {
  extern __shared__ float smem[];
  float* sc = smem;
  float* sf = sc + W;
  float* avail = sf + W;
  int* sector = reinterpret_cast<int*>(avail + W);
  int* cb0 = sector + W;
  unsigned char* sup = reinterpret_cast<unsigned char*>(cb0 + W);
  __shared__ RoundBuf rb;

  const int r = blockIdx.x;
  const size_t row = (size_t)r * W;
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    sc[w] = score_c[row + w];
    sf[w] = score_f[row + w];
    sector[w] = sector_g[row + w];
    cb0[w] = cb0_g[row + w];
    sup[w] = 0;
  }
  __syncthreads();

  int slot = 0;
  for (int i = 0; i < n_sharp; ++i, slot += 1)
    pick_round(sc, avail, sector, cb0, sup, rb, W, S, 1, nsup, picks, slot, r, R);
  for (int i = 0; i < n_rest_rounds; ++i, slot += rest_T)
    pick_round(sc, avail, sector, cb0, sup, rb, W, S, rest_T, nsup, picks, slot, r, R);
  // the less-flat mask reads the suppression after the corner phases
  for (int w = threadIdx.x; w < W; w += blockDim.x) sup_out[row + w] = sup[w];
  for (int i = 0; i < n_flat; ++i, slot += 1)
    pick_round(sf, avail, sector, cb0, sup, rb, W, S, 1, nsup, picks, slot, r, R);
}

}  // namespace

// picks: (n_sharp + n_rest_rounds * rest_T + n_flat, R, S) int32;
// sup_out: (R, W) bool. Returns the CUDA error of the launch (0 = ok).
extern "C" int pick_rounds_launch(const float* score_c, const float* score_f,
                                  const int* sector, const int* cb0,
                                  int* picks, unsigned char* sup_out, int R,
                                  int W, int S, int nsup, int n_sharp,
                                  int n_rest_rounds, int rest_T, int n_flat,
                                  void* stream) {
  if (S * (rest_T > 1 ? rest_T : 1) > kMaxPicks || 2 * nsup + 1 > kThreads)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)W * (5 * 4 + 1);
  cudaError_t err = cudaFuncSetAttribute(
      pick_rounds_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  pick_rounds_kernel<<<R, kThreads, smem, (cudaStream_t)stream>>>(
      score_c, score_f, sector, cb0, picks, sup_out, R, W, S, nsup, n_sharp,
      n_rest_rounds, rest_T, n_flat);
  return (int)cudaGetLastError();
}
