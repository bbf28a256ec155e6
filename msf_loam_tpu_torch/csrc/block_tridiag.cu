// Segmented Schur-condensation solve of a symmetric block-tridiagonal system,
// in one cooperative launch.
//
// Replaces msf_loam_tpu/slam/posegraph.py:475 solve_block_tridiag and :513
// solve_block_tridiag_multi (XLA lax.scan sweeps; no Pallas kernel): for D
// (N,6,6), U (N-1,6,6) and B (N,6,m) it returns X (N,6,m) with
// tridiag(U^T, D, U) X = B. It follows the decomposition of the JAX
// package's parallel/distributed_ba.py (_condense_chain, _sharded_solve_body,
// _backsub_chain), with segments in place of devices:
//
//   1. The N blocks are cut into P contiguous segments of L blocks (the last
//      one holds the rest, 2..L+1 blocks; N = 1 is one segment of one).
//   2. Condense (one thread block a segment, all segments at once): each
//      segment eliminates its interior blocks k = 1..Ls-2 onto its first and
//      last block with the recurrence of _condense_chain,
//        Z = Skk^-1 [S0k^T | U_k | bk],
//        S00 -= S0k Z1,  S0k <- -(S0k Z2),  b0 -= S0k z3,
//        Skk <- D[k+1] - U_k^T Z2,  bk <- B[k+1] - U_k^T z3,
//      and keeps each step's residues (the factor of Skk, S0k, bk) in
//      scratch for step 4.
//   3. Separator (block 0, between two grid barriers): the 2P endpoint
//      blocks form a block-tridiagonal system (diagonal S00, See; the
//      off-diagonals alternate between the condensed S0e and the coupling U
//      between segments), solved by the block-Thomas recurrence
//        forward   Y = Dt[i-1]^-1 Ug[i-1],
//                  [Dt[i] | Bt[i]] = [Dg[i] | bg[i]] - Y^T [Ug[i-1] | Bt[i-1]],
//        backward  x[i] = Dt[i]^-1 (Bt[i] - Ug[i] x[i+1]).
//   4. Back-substitute (all segments at once): x_k = Skk^-1 (bk - S0k^T x0 -
//      U_k x_{k+1}) for k = Ls-2 .. 1, from the stored residues.
//
// Each 6x6 solve is Gaussian elimination with partial pivoting: the pivot is
// the first maximal |entry| of its column (NaN counts as maximal, as
// torch.argmax has it), step k swaps rows k and p[k] and keeps its
// multipliers in that step's row order, every multiplier and every
// back-substitution step divides (never multiplies by a reciprocal), and
// each 6-term product is summed k = 0..5 as separate multiplies and adds.
// Built with -fmad=false, so every float is rounded as the plain PyTorch
// version in ops/block_tridiag.py rounds it: the two are bit-equal.
//
// What bounds it on the H100: not bytes (~22 MB at N = 8192, m = 49: ~6.5 us
// at 3.35 TB/s) nor arithmetic, but the chain of dependent 6x6 steps:
// (L-2) condensation steps, 2P-1 + 2P separator steps and (L-2)
// back-substitution steps, about 2L + 4P (507 at N = 8192, L = 128, P = 64,
// against the 2N = 16384 of one sequential sweep), each costing one step's
// latency (~1.7 us on the H100; a condensation step's chain is the 6x6
// factorisation, one column's solve and its product, with 5 + 6 divisions
// in sequence). What the design does about that:
//   * every thread of a block factorises the step's 6x6 itself, in
//     registers, fully unrolled: no lane waits for another to factorise,
//     and the only barrier of a condensation step is the one that
//     publishes the next Skk;
//   * row swaps with a pivot known only at run time are selects on every
//     candidate row (swap_in, swap_rows): written as a conditional swap,
//     the compiler merged the branches into one store at a computed index
//     and moved the column to local memory (a sixth of the solve's time);
//   * the 12 + m right-hand-side columns of a step are spread over the
//     block's threads, one column a thread up to 244 columns;
//   * the next step's small operands (U, D) are staged into shared memory
//     one step ahead, and each thread prefetches the next step's
//     right-hand-side column into registers, so no global load waits on
//     the chain; the step's factor is stored by the block's last thread,
//     which holds no column on the chain;
//   * the back-substitution phases need one barrier a step only to stage
//     the next step's factor; each column walks its blocks alone.
// The IEEE divisions set the time's dependence on the data: a build with
// approximate division runs every Gauss-Newton system of a KITTI-size
// fusion in the same ~0.65 ms, the exact one takes 0.88-1.66 ms
// (scripts/block_tridiag_probe.py; neither flushing subnormals nor
// guarding zero dividends changes it).
// The wrapper sizes the grid to min(P, co-resident blocks): blocks loop
// over segments when P exceeds what the card holds at once.
//
// Split launches for a solve whose separator chain is solved elsewhere (the
// distributed solve of parallel/distributed_ba.py, where the chain is
// gathered across ranks between the phases): block_tridiag_condense runs
// phase 1 alone and leaves the chain in scratch, block_tridiag_backsub
// writes the solved endpoints into X and runs phase 3 alone. Both run the
// same device code as the one-launch path, one block a segment, with no
// grid barrier.
//
// One launch: cudaLaunchCooperativeKernel and two
// cooperative_groups::this_grid().sync() barriers. Under CUDA 12.8 the grid
// barrier compiles into this shared library without -rdc (relocatable device
// code); kernels.py builds every source with the same flags.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 256;

// Scratch offsets of one solve, in floats (work) and ints (piv).
struct Layout {
  long long fac, s0k, bk, sep_d, sep_u, sep_b, sep_fac, floats;
  long long piv, sep_piv, ints;
  int steps;  // interior-step slots a segment: its longest segment less 2
  int nsep;   // separator blocks: 2 a segment (1 when N = 1)
};

Layout make_layout(int N, int m, int L, int P) {
  Layout o;
  const int last = N - (P - 1) * L;
  const int longest = last > L ? last : L;
  o.steps = (P == 1 ? N : longest) - 2;
  if (o.steps < 0) o.steps = 0;
  o.nsep = N == 1 ? 1 : 2 * P;
  const long long pk = (long long)P * o.steps, sm = 6LL * m, ns = o.nsep;
  o.fac = 0;
  o.s0k = o.fac + pk * 36;
  o.bk = o.s0k + pk * 36;
  o.sep_d = o.bk + pk * sm;
  o.sep_u = o.sep_d + ns * 36;
  o.sep_b = o.sep_u + ns * 36;
  o.sep_fac = o.sep_b + ns * sm;
  o.floats = o.sep_fac + ns * 36;
  o.piv = 0;
  o.sep_piv = pk * 6;
  o.ints = o.sep_piv + ns * 6;
  return o;
}

struct Params {
  const float* D;
  const float* U;
  const float* B;
  float* X;
  float* work;
  int* piv;
  int N, m, L, P;
  Layout lay;
};

int threads_for(int m) {
  int t = (12 + m + 31) / 32 * 32;
  return t > kMaxThreads ? kMaxThreads : t;
}

size_t smem_for(int m) {
  return (size_t)(324 + 12 * m) * sizeof(float) + 12 * sizeof(int);
}

__device__ __forceinline__ bool pivot_better(float v, float best) {
  return !isnan(best) && (isnan(v) || v > best);
}

__device__ __forceinline__ void load66(const float* s, float a[6][6]) {
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) a[i][j] = s[i * 6 + j];
}

// Row swaps with a pivot row known only at run time, written as selects on
// every candidate row: a conditional swap inside the unrolled loop lets the
// compiler merge the branches into one store at a computed index, which
// moves the whole array to local memory.
__device__ __forceinline__ void swap_in(float y[6], int k, int p) {
  const float yk = y[k];
  float nk = yk;
#pragma unroll
  for (int i = k + 1; i < 6; ++i) {
    const bool s = p == i;
    const float yi = y[i];
    nk = s ? yi : nk;
    y[i] = s ? yk : yi;
  }
  y[k] = nk;
}

// Column j of rows k and p of a swapped (the same selects as swap_in).
__device__ __forceinline__ void swap_rows(float a[6][6], int j, int k,
                                          int p) {
  const float ak = a[k][j];
  float nk = ak;
#pragma unroll
  for (int i = k + 1; i < 6; ++i) {
    const bool s = p == i;
    const float ai = a[i][j];
    nk = s ? ai : nk;
    a[i][j] = s ? ak : ai;
  }
  a[k][j] = nk;
}

// One level of the pivot search's tree: entry i takes entry i + W where that
// one is better, for the first n entries.
template <int W>
__device__ __forceinline__ void tree_level(float bv[6], int bx[6], int n) {
#pragma unroll
  for (int i = 0; i + W < 6; i += 2 * W) {
    const bool s = i + W < n && pivot_better(bv[i + W], bv[i]);
    bv[i] = s ? bv[i + W] : bv[i];
    bx[i] = s ? bx[i + W] : bx[i];
  }
}

// LU with partial pivoting of a 6x6 in registers. Step k swaps rows k and
// p[k] in columns k..5 and leaves its multipliers at a[i][k], i > k, in the
// row order of that step; a[i][j], i <= j, ends as the upper factor.
__device__ __forceinline__ void factor6(float a[6][6], int p[6]) {
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    // first maximal |a[i][k]|, i >= k, by a tree of pairwise picks (the
    // lower rows always on the left): the scan's answer in 3 levels, not 5
    float bv[6];
    int bx[6];
#pragma unroll
    for (int i = k; i < 6; ++i) {
      bv[i - k] = fabsf(a[i][k]);
      bx[i - k] = i;
    }
    tree_level<1>(bv, bx, 6 - k);
    tree_level<2>(bv, bx, 6 - k);
    tree_level<4>(bv, bx, 6 - k);
    const int bi = bx[0];
    p[k] = bi;
#pragma unroll
    for (int j = k; j < 6; ++j) swap_rows(a, j, k, bi);
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float f = a[i][k] / a[k][k];
      a[i][k] = f;
#pragma unroll
      for (int j = k + 1; j < 6; ++j) {
        const float prod = f * a[k][j];
        a[i][j] = a[i][j] - prod;
      }
    }
  }
}

// y <- A^-1 y for the factor of factor6: the swaps and multipliers in step
// order, then back substitution by divisions.
__device__ __forceinline__ void apply6(const float a[6][6], const int p[6],
                                       float y[6]) {
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    swap_in(y, k, p[k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float prod = a[i][k] * y[k];
      y[i] = y[i] - prod;
    }
  }
#pragma unroll
  for (int k = 5; k >= 0; --k) {
    y[k] = y[k] / a[k][k];
#pragma unroll
    for (int i = 0; i < k; ++i) {
      const float prod = a[i][k] * y[k];
      y[i] = y[i] - prod;
    }
  }
}

// t = M z (row-major M) and t = M^T z, each summed k = 0..5.
__device__ __forceinline__ void mat_vec(const float* M, const float z[6],
                                        float t[6]) {
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    float acc = M[r * 6] * z[0];
#pragma unroll
    for (int k = 1; k < 6; ++k) {
      const float prod = M[r * 6 + k] * z[k];
      acc = acc + prod;
    }
    t[r] = acc;
  }
}

__device__ __forceinline__ void mat_t_vec(const float* M, const float z[6],
                                          float t[6]) {
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    float acc = M[r] * z[0];
#pragma unroll
    for (int k = 1; k < 6; ++k) {
      const float prod = M[k * 6 + r] * z[k];
      acc = acc + prod;
    }
    t[r] = acc;
  }
}

__device__ __forceinline__ void store_factor(const float a[6][6],
                                             const int p[6], float* fac,
                                             int* piv) {
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    piv[i] = p[i];
#pragma unroll
    for (int j = 0; j < 6; ++j) fac[i * 6 + j] = a[i][j];
  }
}

__device__ __forceinline__ void seg_range(const Params& q, int s, int& start,
                                          int& len) {
  start = s * q.L;
  len = s == q.P - 1 ? q.N - start : q.L;
}

// Row of X that separator block i stands for.
__device__ __forceinline__ int sep_row(const Params& q, int i) {
  if (q.lay.nsep == 1) return 0;
  int start, len;
  seg_range(q, i >> 1, start, len);
  return (i & 1) ? start + len - 1 : start;
}

struct Smem {
  float* s00;  // 36: S00 (condense); Y (separator)
  float* s0k;  // 2 x 36: S0k (condense); staged factor (backward phases)
  float* skk;  // 2 x 36: Skk (condense), Dt (separator); staged S0k residue
  float* su;   // 2 x 36: the step's U, staged
  float* sd;   // 2 x 36: the next block's D, staged
  float* sb0;  // 6m: b0 (condense), Bt (separator); x (backward phases)
  float* sbk;  // 6m: bk (condense); x0 (back-substitution)
  int* spiv;   // 2 x 6: staged pivots (backward phases)
};

__device__ Smem carve(float* sh, int m) {
  Smem s;
  s.s00 = sh;
  s.s0k = s.s00 + 36;
  s.skk = s.s0k + 72;
  s.su = s.skk + 72;
  s.sd = s.su + 72;
  s.sb0 = s.sd + 72;
  s.sbk = s.sb0 + 6 * m;
  s.spiv = reinterpret_cast<int*>(s.sbk + 6 * m);
  return s;
}

// ---- phase 1: condense segment s onto its first and last block
__device__ __forceinline__ void condense(const Params& q, int s, const Smem& sm) {
  const int tid = threadIdx.x, T = blockDim.x, m = q.m;
  const size_t bs = (size_t)6 * m;
  const Layout& o = q.lay;
  int start, len;
  seg_range(q, s, start, len);
  float* sep_d = q.work + o.sep_d;
  float* sep_u = q.work + o.sep_u;
  float* sep_b = q.work + o.sep_b;
  if (len == 1) {  // N = 1: the separator is the system itself
    for (int e = tid; e < 36; e += T) sep_d[e] = q.D[e];
    for (int e = tid; e < 6 * m; e += T) sep_b[e] = q.B[e];
    return;
  }
  for (int e = tid; e < 36; e += T) {
    sm.s00[e] = q.D[(size_t)start * 36 + e];
    sm.s0k[e] = q.U[(size_t)start * 36 + e];
    sm.skk[e] = q.D[(size_t)(start + 1) * 36 + e];
    if (len > 2) {
      sm.su[e] = q.U[(size_t)(start + 1) * 36 + e];
      sm.sd[e] = q.D[(size_t)(start + 2) * 36 + e];
    }
  }
  for (int e = tid; e < 6 * m; e += T) {
    sm.sb0[e] = q.B[(size_t)start * bs + e];
    sm.sbk[e] = q.B[(size_t)(start + 1) * bs + e];
  }
  // this thread's first right-hand-side column, prefetched a step ahead
  const int c0 = tid - 12;
  const bool own_b = c0 >= 0 && c0 < m;
  float bn[6];
  if (own_b && len > 2) {
#pragma unroll
    for (int r = 0; r < 6; ++r)
      bn[r] = q.B[(size_t)(start + 2) * bs + r * m + c0];
  }
  __syncthreads();
  int cur = 0;
  for (int k = 1; k <= len - 2; ++k) {
    const int g = start + k, nxt = cur ^ 1;
    const bool more = k + 1 <= len - 2;
    const size_t slot = (size_t)s * o.steps + (k - 1);
    float pre[3];
#pragma unroll
    for (int h = 0; h < 3; ++h) {
      const int e = tid + h * T;
      if (more && e < 72)
        pre[h] = e < 36 ? q.U[(size_t)(g + 1) * 36 + e]
                        : q.D[(size_t)(g + 2) * 36 + e - 36];
    }
    float bn_next[6];
    if (own_b && more) {
#pragma unroll
      for (int r = 0; r < 6; ++r)
        bn_next[r] = q.B[(size_t)(g + 2) * bs + r * m + c0];
    }
    const float* S0k = sm.s0k + cur * 36;
    const float* Uk = sm.su + cur * 36;
    const float* Dn = sm.sd + cur * 36;
    float a[6][6];
    int p[6];
    load66(sm.skk + cur * 36, a);
    factor6(a, p);
    if (tid == T - 1)  // the last thread holds no column on the chain
      store_factor(a, p, q.work + o.fac + slot * 36,
                               q.piv + o.piv + slot * 6);
    for (int e = tid; e < 36; e += T) q.work[o.s0k + slot * 36 + e] = S0k[e];
    for (int j = tid; j < 12 + m; j += T) {
      const int c = j - 12;
      float z[6], t[6];
      if (j < 6) {
#pragma unroll
        for (int r = 0; r < 6; ++r) z[r] = S0k[j * 6 + r];
      } else if (j < 12) {
#pragma unroll
        for (int r = 0; r < 6; ++r) z[r] = Uk[r * 6 + j - 6];
      } else {
        float* res = q.work + o.bk + slot * bs;
#pragma unroll
        for (int r = 0; r < 6; ++r) {
          z[r] = sm.sbk[r * m + c];
          res[r * m + c] = z[r];
        }
      }
      apply6(a, p, z);
      mat_vec(S0k, z, t);
      if (j < 6) {
#pragma unroll
        for (int r = 0; r < 6; ++r) sm.s00[r * 6 + j] = sm.s00[r * 6 + j] - t[r];
        continue;
      }
      if (j < 12) {
#pragma unroll
        for (int r = 0; r < 6; ++r) sm.s0k[nxt * 36 + r * 6 + j - 6] = -t[r];
      } else {
#pragma unroll
        for (int r = 0; r < 6; ++r) sm.sb0[r * m + c] = sm.sb0[r * m + c] - t[r];
      }
      mat_t_vec(Uk, z, t);
      if (j < 12) {
#pragma unroll
        for (int r = 0; r < 6; ++r)
          sm.skk[nxt * 36 + r * 6 + j - 6] = Dn[r * 6 + j - 6] - t[r];
      } else {
        float b[6];
        if (c == c0) {
#pragma unroll
          for (int r = 0; r < 6; ++r) b[r] = bn[r];
        } else {
#pragma unroll
          for (int r = 0; r < 6; ++r)
            b[r] = q.B[(size_t)(g + 1) * bs + r * m + c];
        }
#pragma unroll
        for (int r = 0; r < 6; ++r) sm.sbk[r * m + c] = b[r] - t[r];
      }
    }
#pragma unroll
    for (int h = 0; h < 3; ++h) {
      const int e = tid + h * T;
      if (more && e < 72) {
        if (e < 36)
          sm.su[nxt * 36 + e] = pre[h];
        else
          sm.sd[nxt * 36 + e - 36] = pre[h];
      }
    }
    if (own_b && more) {
#pragma unroll
      for (int r = 0; r < 6; ++r) bn[r] = bn_next[r];
    }
    __syncthreads();
    cur = nxt;
  }
  for (int e = tid; e < 36; e += T) {
    sep_d[(size_t)(2 * s) * 36 + e] = sm.s00[e];
    sep_d[(size_t)(2 * s + 1) * 36 + e] = sm.skk[cur * 36 + e];
    sep_u[(size_t)(2 * s) * 36 + e] = sm.s0k[cur * 36 + e];
    if (s < q.P - 1)
      sep_u[(size_t)(2 * s + 1) * 36 + e] =
          q.U[(size_t)(start + len - 1) * 36 + e];
  }
  for (int e = tid; e < 6 * m; e += T) {
    sep_b[(size_t)(2 * s) * bs + e] = sm.sb0[e];
    sep_b[(size_t)(2 * s + 1) * bs + e] = sm.sbk[e];
  }
  __syncthreads();  // shared memory is reused by the next segment
}

// Element e of separator block i's staged operands: its factor, Ug[i],
// its pivots (as float bits).
__device__ __forceinline__ float sep_fetch(const float* fac, const float* u,
                                           const int* piv, int i, int e) {
  if (e < 36) return fac[(size_t)i * 36 + e];
  if (e < 72) return u[(size_t)i * 36 + e - 36];
  return __int_as_float(piv[(size_t)i * 6 + e - 72]);
}

// Element e of interior step k's staged operands: the factor of Skk, the
// S0k residue, U_k, the pivots (as float bits).
__device__ __forceinline__ float bs_fetch(const float* fac, const float* s0k,
                                          const float* u, const int* piv,
                                          int k, int e) {
  if (e < 36) return fac[(size_t)(k - 1) * 36 + e];
  if (e < 72) return s0k[(size_t)(k - 1) * 36 + e - 36];
  if (e < 108) return u[(size_t)k * 36 + e - 72];
  return __int_as_float(piv[(size_t)(k - 1) * 6 + e - 108]);
}

// ---- phase 2: block-Thomas over the separator blocks (block 0 only)
__device__ __forceinline__ void separator(const Params& q, const Smem& sm) {
  const int tid = threadIdx.x, T = blockDim.x, m = q.m;
  const size_t bs = (size_t)6 * m;
  const Layout& o = q.lay;
  const int n = o.nsep;
  const float* sep_d = q.work + o.sep_d;
  const float* sep_u = q.work + o.sep_u;
  float* sep_b = q.work + o.sep_b;
  float* sep_fac = q.work + o.sep_fac;
  int* sep_piv = q.piv + o.sep_piv;
  float* bt = sm.sb0;
  for (int e = tid; e < 36; e += T) {
    sm.skk[e] = sep_d[e];
    if (n > 1) {
      sm.su[e] = sep_u[e];
      sm.sd[e] = sep_d[36 + e];
    }
  }
  for (int e = tid; e < 6 * m; e += T) bt[e] = sep_b[e];
  const int c0 = tid - 6;
  const bool own_b = c0 >= 0 && c0 < m;
  float bn[6];
  if (own_b && n > 1) {
#pragma unroll
    for (int r = 0; r < 6; ++r) bn[r] = sep_b[bs + r * m + c0];
  }
  __syncthreads();
  int cur = 0;
  for (int i = 1; i < n; ++i) {
    const int nxt = cur ^ 1;
    const bool more = i + 1 < n;
    float pre[3];
#pragma unroll
    for (int h = 0; h < 3; ++h) {
      const int e = tid + h * T;
      if (more && e < 72)
        pre[h] = e < 36 ? sep_u[(size_t)i * 36 + e]
                        : sep_d[(size_t)(i + 1) * 36 + e - 36];
    }
    float bn_next[6];
    if (own_b && more) {
#pragma unroll
      for (int r = 0; r < 6; ++r)
        bn_next[r] = sep_b[(size_t)(i + 1) * bs + r * m + c0];
    }
    const float* Ug = sm.su + cur * 36;
    const float* Dg = sm.sd + cur * 36;
    float a[6][6];
    int p[6];
    load66(sm.skk + cur * 36, a);
    factor6(a, p);
    if (tid == T - 1)
      store_factor(a, p, sep_fac + (size_t)(i - 1) * 36,
                   sep_piv + (size_t)(i - 1) * 6);
    if (tid < 6) {
      float y[6];
#pragma unroll
      for (int r = 0; r < 6; ++r) y[r] = Ug[r * 6 + tid];
      apply6(a, p, y);
#pragma unroll
      for (int r = 0; r < 6; ++r) sm.s00[r * 6 + tid] = y[r];
    }
    __syncthreads();
    const float* Y = sm.s00;
    for (int j = tid; j < 6 + m; j += T) {
      const int c = j - 6;
      float col[6], t[6];
      if (j < 6) {
#pragma unroll
        for (int r = 0; r < 6; ++r) col[r] = Ug[r * 6 + j];
      } else {
#pragma unroll
        for (int r = 0; r < 6; ++r) col[r] = bt[r * m + c];
      }
      mat_t_vec(Y, col, t);
      if (j < 6) {
#pragma unroll
        for (int r = 0; r < 6; ++r)
          sm.skk[nxt * 36 + r * 6 + j] = Dg[r * 6 + j] - t[r];
      } else {
        float* bi = sep_b + (size_t)i * bs;
        float b[6];
        if (c == c0) {
#pragma unroll
          for (int r = 0; r < 6; ++r) b[r] = bn[r];
        } else {
#pragma unroll
          for (int r = 0; r < 6; ++r) b[r] = bi[r * m + c];
        }
#pragma unroll
        for (int r = 0; r < 6; ++r) {
          const float v = b[r] - t[r];
          bt[r * m + c] = v;
          bi[r * m + c] = v;
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 3; ++h) {
      const int e = tid + h * T;
      if (more && e < 72) {
        if (e < 36)
          sm.su[nxt * 36 + e] = pre[h];
        else
          sm.sd[nxt * 36 + e - 36] = pre[h];
      }
    }
    if (own_b && more) {
#pragma unroll
      for (int r = 0; r < 6; ++r) bn[r] = bn_next[r];
    }
    __syncthreads();
    cur = nxt;
  }
  {
    float a[6][6];
    int p[6];
    load66(sm.skk + cur * 36, a);
    factor6(a, p);
    if (tid == 0)
      store_factor(a, p, sep_fac + (size_t)(n - 1) * 36,
                   sep_piv + (size_t)(n - 1) * 6);
  }
  // backward: stage block i's factor, Ug[i] and pivots one step ahead
  __syncthreads();  // block 0's own scratch writes are visible to it
  for (int e = tid; e < 78; e += T) {
    const float v = sep_fetch(sep_fac, sep_u, sep_piv, n - 1, e);
    if (e < 36)
      sm.s0k[e] = v;
    else if (e < 72)
      sm.su[e - 36] = v;
    else
      sm.spiv[e - 72] = __float_as_int(v);
  }
  __syncthreads();
  float* xs = sm.sb0;  // each column's x[i+1], private to its thread
  cur = 0;
  for (int i = n - 1; i >= 0; --i) {
    const int nxt = cur ^ 1;
    const bool more = i > 0;
    float pre[3];
#pragma unroll
    for (int h = 0; h < 3; ++h) {
      const int e = tid + h * T;
      if (more && e < 78) pre[h] = sep_fetch(sep_fac, sep_u, sep_piv, i - 1, e);
    }
    float a[6][6];
    int p[6];
    load66(sm.s0k + cur * 36, a);
#pragma unroll
    for (int r = 0; r < 6; ++r) p[r] = sm.spiv[cur * 6 + r];
    const float* Ug = sm.su + cur * 36;  // Ug[i], read only for i < n-1
    const int row = sep_row(q, i);
    for (int c = tid; c < m; c += T) {
      float y[6];
#pragma unroll
      for (int r = 0; r < 6; ++r) y[r] = sep_b[(size_t)i * bs + r * m + c];
      if (i < n - 1) {
        float x[6], t[6];
#pragma unroll
        for (int r = 0; r < 6; ++r) x[r] = xs[r * m + c];
        mat_vec(Ug, x, t);
#pragma unroll
        for (int r = 0; r < 6; ++r) y[r] = y[r] - t[r];
      }
      apply6(a, p, y);
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        xs[r * m + c] = y[r];
        q.X[(size_t)row * bs + r * m + c] = y[r];
      }
    }
#pragma unroll
    for (int h = 0; h < 3; ++h) {
      const int e = tid + h * T;
      if (more && e < 78) {
        if (e < 36)
          sm.s0k[nxt * 36 + e] = pre[h];
        else if (e < 72)
          sm.su[nxt * 36 + e - 36] = pre[h];
        else
          sm.spiv[nxt * 6 + e - 72] = __float_as_int(pre[h]);
      }
    }
    __syncthreads();
    cur = nxt;
  }
}

// ---- phase 3: back-substitute segment s's interior from x0 and xe
__device__ __forceinline__ void back_substitute(const Params& q, int s, const Smem& sm) {
  const int tid = threadIdx.x, T = blockDim.x, m = q.m;
  const size_t bs = (size_t)6 * m;
  const Layout& o = q.lay;
  int start, len;
  seg_range(q, s, start, len);
  if (len <= 2) return;
  const size_t slot0 = (size_t)s * o.steps;
  const float* fac = q.work + o.fac + slot0 * 36;
  const float* s0k = q.work + o.s0k + slot0 * 36;
  const float* Useg = q.U + (size_t)start * 36;
  const int* piv = q.piv + o.piv + slot0 * 6;
  for (int e = tid; e < 114; e += T) {
    const float v = bs_fetch(fac, s0k, Useg, piv, len - 2, e);
    if (e < 36)
      sm.s0k[e] = v;
    else if (e < 72)
      sm.skk[e - 36] = v;
    else if (e < 108)
      sm.su[e - 72] = v;
    else
      sm.spiv[e - 108] = __float_as_int(v);
  }
  float* xs = sm.sb0;  // x_{k+1} of each column, private to its thread
  float* x0s = sm.sbk;
  for (int c = tid; c < m; c += T) {
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      x0s[r * m + c] = q.X[(size_t)start * bs + r * m + c];
      xs[r * m + c] = q.X[(size_t)(start + len - 1) * bs + r * m + c];
    }
  }
  const bool own = tid < m;
  float bk[6];
  if (own) {
#pragma unroll
    for (int r = 0; r < 6; ++r)
      bk[r] = q.work[o.bk + (slot0 + len - 3) * bs + r * m + tid];
  }
  __syncthreads();
  int cur = 0;
  for (int k = len - 2; k >= 1; --k) {
    const int nxt = cur ^ 1;
    const bool more = k > 1;
    const size_t slot = slot0 + (k - 1);
    float pre[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int e = tid + h * T;
      if (more && e < 114) pre[h] = bs_fetch(fac, s0k, Useg, piv, k - 1, e);
    }
    float bk_next[6];
    if (own && more) {
#pragma unroll
      for (int r = 0; r < 6; ++r)
        bk_next[r] = q.work[o.bk + (slot - 1) * bs + r * m + tid];
    }
    float a[6][6];
    int p[6];
    load66(sm.s0k + cur * 36, a);
#pragma unroll
    for (int r = 0; r < 6; ++r) p[r] = sm.spiv[cur * 6 + r];
    const float* S0k = sm.skk + cur * 36;
    const float* Uk = sm.su + cur * 36;
    for (int c = tid; c < m; c += T) {
      float y[6], x[6], t[6];
      if (c == tid) {
#pragma unroll
        for (int r = 0; r < 6; ++r) y[r] = bk[r];
      } else {
#pragma unroll
        for (int r = 0; r < 6; ++r)
          y[r] = q.work[o.bk + slot * bs + r * m + c];
      }
#pragma unroll
      for (int r = 0; r < 6; ++r) x[r] = x0s[r * m + c];
      mat_t_vec(S0k, x, t);
#pragma unroll
      for (int r = 0; r < 6; ++r) y[r] = y[r] - t[r];
#pragma unroll
      for (int r = 0; r < 6; ++r) x[r] = xs[r * m + c];
      mat_vec(Uk, x, t);
#pragma unroll
      for (int r = 0; r < 6; ++r) y[r] = y[r] - t[r];
      apply6(a, p, y);
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        xs[r * m + c] = y[r];
        q.X[(size_t)(start + k) * bs + r * m + c] = y[r];
      }
    }
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int e = tid + h * T;
      if (more && e < 114) {
        if (e < 36)
          sm.s0k[nxt * 36 + e] = pre[h];
        else if (e < 72)
          sm.skk[nxt * 36 + e - 36] = pre[h];
        else if (e < 108)
          sm.su[nxt * 36 + e - 72] = pre[h];
        else
          sm.spiv[nxt * 6 + e - 108] = __float_as_int(pre[h]);
      }
    }
    if (own && more) {
#pragma unroll
      for (int r = 0; r < 6; ++r) bk[r] = bk_next[r];
    }
    __syncthreads();
    cur = nxt;
  }
}

__global__ void __launch_bounds__(kMaxThreads)
    block_tridiag_kernel(Params q) {
  extern __shared__ __align__(16) float sh[];
  const Smem sm = carve(sh, q.m);
  cg::grid_group grid = cg::this_grid();
  for (int s = blockIdx.x; s < q.P; s += gridDim.x) condense(q, s, sm);
  grid.sync();
  if (blockIdx.x == 0) separator(q, sm);
  grid.sync();
  for (int s = blockIdx.x; s < q.P; s += gridDim.x) back_substitute(q, s, sm);
}

__global__ void __launch_bounds__(kMaxThreads)
    block_tridiag_condense_kernel(Params q) {
  extern __shared__ __align__(16) float sh[];
  const Smem sm = carve(sh, q.m);
  condense(q, blockIdx.x, sm);
}

// xg (2P, 6, m): segment s's solved first and last block at 2s, 2s + 1.
__global__ void __launch_bounds__(kMaxThreads)
    block_tridiag_backsub_kernel(Params q, const float* xg) {
  extern __shared__ __align__(16) float sh[];
  const Smem sm = carve(sh, q.m);
  const int s = blockIdx.x;
  int start, len;
  seg_range(q, s, start, len);
  const size_t bs = (size_t)6 * q.m;
  for (int e = threadIdx.x; e < 6 * q.m; e += blockDim.x) {
    q.X[(size_t)start * bs + e] = xg[(size_t)(2 * s) * bs + e];
    q.X[(size_t)(start + len - 1) * bs + e] = xg[(size_t)(2 * s + 1) * bs + e];
  }
  __syncthreads();
  back_substitute(q, s, sm);
}

// Blocks the card holds at once for this launch shape (0 if none fits).
int resident_blocks(int m, int* per_sm, int* sms) {
  const size_t smem = smem_for(m);
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(block_tridiag_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return -(int)e;
  }
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  int coop = 0;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return -(int)e;
  if (!coop) return -(int)cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -(int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, block_tridiag_kernel, threads_for(m), smem);
  if (e != cudaSuccess) return -(int)e;
  return *per_sm * *sms;
}

Params split_params(const float* D, const float* U, const float* B,
                           float* X, float* work, int* piv, int N, int m,
                           int L, int P) {
  Params q;
  q.D = D;
  q.U = U;
  q.B = B;
  q.X = X;
  q.work = work;
  q.piv = piv;
  q.N = N;
  q.m = m;
  q.L = L;
  q.P = P;
  q.lay = make_layout(N, m, L, P);
  return q;
}

cudaError_t allow_smem(const void* fn, int m) {
  const size_t smem = smem_for(m);
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

extern "C" {

// Floats and ints of scratch one solve takes (work, piv).
int block_tridiag_scratch(int N, int m, int L, int P, long long* floats,
                          long long* ints) {
  if (N < 1 || m < 1 || P < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const Layout o = make_layout(N, m, L, P);
  *floats = o.floats;
  *ints = o.ints;
  return 0;
}

// X (N,6,m) from D (N,6,6), U (N-1,6,6), B (N,6,m) in P segments of L
// blocks (the last holds the rest); work and piv hold the scratch of
// block_tridiag_scratch. One cooperative launch of min(P, co-resident)
// blocks. Returns the CUDA error of the launch (cudaErrorCooperativeLaunch-
// TooLarge when not even one block fits).
int block_tridiag_launch(const float* D, const float* U, const float* B,
                         float* X, float* work, int* piv, int N, int m, int L,
                         int P, cudaStream_t stream) {
  if (N < 1 || m < 1 || P < 1 || L < 1) return (int)cudaErrorInvalidValue;
  int per_sm = 0, sms = 0;
  const int cap = resident_blocks(m, &per_sm, &sms);
  if (cap < 0) return -cap;
  if (cap == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  Params q;
  q.D = D;
  q.U = U;
  q.B = B;
  q.X = X;
  q.work = work;
  q.piv = piv;
  q.N = N;
  q.m = m;
  q.L = L;
  q.P = P;
  q.lay = make_layout(N, m, L, P);
  const int grid = P < cap ? P : cap;
  void* args[] = {&q};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)block_tridiag_kernel, dim3(grid), dim3(threads_for(m)),
      args, smem_for(m), stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Phase 1 alone (N >= 2): the separator chain is left in work at the
// offsets of block_tridiag_sep_offsets, the residues beside it. One launch
// of P blocks.
int block_tridiag_condense_launch(const float* D, const float* U,
                                  const float* B, float* work, int* piv,
                                  int N, int m, int L, int P,
                                  cudaStream_t stream) {
  if (N < 2 || m < 1 || P < 1 || L < 2) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem((const void*)block_tridiag_condense_kernel, m);
  if (e != cudaSuccess) return (int)e;
  const Params q = split_params(D, U, B, nullptr, work, piv, N, m, L, P);
  block_tridiag_condense_kernel<<<P, threads_for(m), smem_for(m), stream>>>(q);
  return (int)cudaGetLastError();
}

// Phase 3 alone: X (N,6,m) from the solved separator blocks xg (2P,6,m) and
// the scratch of block_tridiag_condense_launch. One launch of P blocks.
int block_tridiag_backsub_launch(const float* U, const float* xg, float* X,
                                 float* work, int* piv, int N, int m, int L,
                                 int P, cudaStream_t stream) {
  if (N < 2 || m < 1 || P < 1 || L < 2) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem((const void*)block_tridiag_backsub_kernel, m);
  if (e != cudaSuccess) return (int)e;
  const Params q = split_params(nullptr, U, nullptr, X, work, piv, N, m, L, P);
  block_tridiag_backsub_kernel<<<P, threads_for(m), smem_for(m), stream>>>(
      q, xg);
  return (int)cudaGetLastError();
}

// Float offsets in work of the separator chain's diagonal blocks, couplings
// and right-hand sides.
int block_tridiag_sep_offsets(int N, int m, int L, int P, long long* sep_d,
                              long long* sep_u, long long* sep_b) {
  if (N < 1 || m < 1 || P < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const Layout o = make_layout(N, m, L, P);
  *sep_d = o.sep_d;
  *sep_u = o.sep_u;
  *sep_b = o.sep_b;
  return 0;
}

// The launch for m right-hand sides in P segments: grid blocks, threads,
// dynamic shared memory bytes, registers and local bytes per thread, and the
// blocks an SM holds at once.
int block_tridiag_geometry(int m, int P, int* blocks, int* threads, int* smem,
                           int* regs, int* local_bytes, int* per_sm) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, block_tridiag_kernel);
  if (e != cudaSuccess) return (int)e;
  int sms = 0;
  const int cap = resident_blocks(m, per_sm, &sms);
  if (cap < 0) return -cap;
  *blocks = P < cap ? P : cap;
  *threads = threads_for(m);
  *smem = (int)smem_for(m);
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

}  // extern "C"
