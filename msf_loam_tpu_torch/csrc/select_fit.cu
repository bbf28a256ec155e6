// Fused k-NN selection + line / plane fit over gathered candidates: one
// group of G lanes per query, one launch for one or two problems.
//
// Replaces the Pallas TPU kernel msf_loam_tpu/ops/select_fit.py
// (select_fit_pallas, body _select_fit_core with _eig3, _eigvec, _moments,
// _plane_fit; both its planar (3, N, C) and rows (N, 3C) entries). Per
// query over C candidates (invalid ones carry coordinates >= 1e9):
//   * the k ascending squared distances within the strict radius r2s,
//     every element equal to the running minimum consumed at once;
//   * 0/1 k-NN weights (d2 <= k-th distance), query-relative weighted
//     centred moments, and the closed-form 3x3 eigensolve (Newton steps
//     for cos(acos(r)/3), as the Pallas kernel, not an arccos);
//   * mode 0 "line": largest eigenvector, eigenvalue-ratio gate;
//     mode 1 "plane": smallest eigenvector, max-residual and
//     conditioning gates;
//     mode 2 "plane2": the strict plane fit, else a wide fit over every
//     candidate within r2w with the near-set admission check.
//
// What bounds it on the H100: latency, not bytes. The work is one read of
// 12 B x C per query (12.6 MB at the plane2 call, N = 4096, C = 256: 3.8 us
// at 3.35 TB/s) and a few hundred flops per in-radius candidate, but each
// query is a chain of dependent steps: the read, k group minima, two
// moment reductions, a 3x3 eigensolve (8 Newton steps, each with a
// division), a residual maximum. The call's time is the
// length of one query's chain plus the instructions of all queries over
// the SMs (PERF.md has the H100 times).
//
// The design shortens the chain and cuts the instructions:
//   * Lane groups sized to C: G = 8 lanes a query for C <= 8 (the
//     odometry call: 4 queries a warp, 3-level reductions), else 16 lanes
//     with P = C / 16 candidates a lane (16 at the mapping calls' C = 256).
//     The per-query work that does not scale with C (the eigensolve, the
//     broadcasts) is shared by 16 lanes, not 32, so a warp carries two
//     queries' fixed work in one instruction stream. Every shuffle stays
//     inside its group.
//   * One read, compacted. A group reads its query's candidates once, all
//     loads first (16 bytes a lane: four consecutive candidates per
//     coordinate), then compacts the ones within the largest radius the
//     mode uses (no other has a weight or a distance below 3e38) into
//     shared memory, query-relative and in index order, with warp ballots.
//     Every later pass (minima, moments, residuals) runs over the
//     compacted slots only, a few per lane instead of P.
//   * A shorter eigensolve. The plain version's divisions and square
//     roots (the longest dependent segment) become reciprocal square
//     roots, multiplies and a fast Newton quotient (see eig3).
//   * Transposed butterflies. The moment sums of a fit are reduced
//     together: each level halves the number of values a lane carries
//     (a reduce-scatter), then one broadcast shuffle per value.
//   * Interleaved fits. In plane2 the wide weights (d2 <= r2w) do not
//     depend on the k-th distance, so the strict and the wide fit share
//     each pass and each reduction (8 first, 12 second moments, 3 maxima);
//     the group's lower half then solves the strict 3x3 and its upper half
//     the wide one with the same instructions, and the halves swap results.
//   * One launch for two problems. A launch takes two problem
//     descriptors (pointers, strides, N, C, k, mode, gates, radii); the
//     queries of the problem with more work (N C) fill the first blocks,
//     the other's follow, so every block (and every branch on the mode)
//     serves one problem, and the long blocks start first (at the mapping
//     pair, plane2's; the short line blocks fill in behind them). The
//     mapping round's line and plane2 calls are one launch. Blocks of 128
//     threads, at most 128 registers: the pair's 640 blocks are resident
//     at once.
//
// Summation order. A lane adds its compacted candidates lane, lane + G,
// ... in order, then the group adds lane partials pairwise with xor
// distances 1, 2, 4, ...: another order than the plain PyTorch version's,
// so centres, normals and gate values agree with it to float32 rounding,
// not bit for bit. The minima are exact, so d2 is bit-equal.

#include <cuda_runtime.h>
#include <stdint.h>

// One problem of a launch. The layout is ops/select_fit.py's _Problem.
// Candidates of query n, coordinate a, index c at ca[n * row_stride + c]:
// rows layout (N, 3C) passes cx = base, cy = base + C, cz = base + 2C,
// row_stride = 3C; planar (3, N, C) passes the three planes, stride C.
struct SelectFitProblem {
  const float* q;
  const float* cx;
  const float* cy;
  const float* cz;
  long long row_stride;
  int N, C, k, mode, min_count, min_wide;
  float eig_ratio, tol, cond_frac, r2s, r2w;
  float* d2k;
  float* cen;
  float* nrm;
  unsigned char* valid;
};

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 4;      // resident per SM at <= 128 registers
constexpr int kMaxC = 256;
constexpr int kMaxK = 32;
constexpr float kInf = 3.0e38f;   // select_fit.py _INF
constexpr unsigned kFull = 0xffffffffu;

struct Launch {
  SelectFitProblem p[2];
  int first;                      // the problem served first (more work)
  int blocks0;                    // its blocks; the rest serve the other
  int vec[2];                     // 16-byte loads allowed
};

struct Add {
  __device__ float operator()(float a, float b) const { return a + b; }
};
struct Max {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

// p ? a : b as one selp: keeps the compiler from turning a select between
// two elements of a register array into an indexed local-memory load
__device__ __forceinline__ float sel(bool p, float a, float b) {
  float r;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %3, 0;\n\t"
      "selp.f32 %0, %1, %2, q;\n\t}"
      : "=f"(r) : "f"(a), "f"(b), "r"((int)p));
  return r;
}

template <int G>
__device__ __forceinline__ float group_min(float v) {
#pragma unroll
  for (int o = 1; o < G; o <<= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Low lane bits of the lanes that hold value m after the scatter phase of
// group_reduce<N, G> (S = N / min(N, G) values a lane).
template <int N, int L>
__device__ __forceinline__ constexpr int holder(int m) {
  int rem = m - m % (N / L), b = 0, half = N / 2;
  for (int t = 0; (1 << t) < L; ++t, half >>= 1)
    if (rem >= half) {
      rem -= half;
      b |= 1 << t;
    }
  return b;
}

// All-reduce of N values (a power of two) over the G lanes of a group,
// every lane receiving the first U results. Level o = 1, 2, ... pairs lanes
// l and l ^ o; while a lane carries more than one value it keeps half of
// them (the upper half where bit o is set) and sends the other half
// (reduce-scatter), then single values are combined, then each result is
// broadcast from a lane that holds it.
template <int N, int G, int U = N, class Op>
__device__ __forceinline__ void group_reduce(float (&v)[N], float (&out)[N],
                                             int li, int lane, Op op) {
  constexpr int L = N < G ? N : G;
  constexpr int S = N / L;
#pragma unroll
  for (int t = 0; (1 << t) < L; ++t) {
    const int o = 1 << t, h = (N >> t) / 2;
    const bool upper = (li & o) != 0;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float keep = sel(upper, v[i + h], v[i]);
      const float send = sel(upper, v[i], v[i + h]);
      v[i] = op(keep, __shfl_xor_sync(kFull, send, o));
    }
  }
#pragma unroll
  for (int o = L; o < G; o <<= 1)
#pragma unroll
    for (int i = 0; i < S; ++i) v[i] = op(v[i], __shfl_xor_sync(kFull, v[i], o));
  const int base = lane & ~(G - 1);
#pragma unroll
  for (int m = 0; m < U; ++m)          // the first U results (the rest pad)
    out[m] = __shfl_sync(kFull, v[m % S], base + holder<N, L>(m));
}

struct Moments {
  float cnt, mx, my, mz;
  float sxx, syy, szz, sxy, sxz, syz;
};

// eigenvalues, descending (select_fit.py _eig3). The plain version's
// square root and divisions become one reciprocal square root (1 / p, and
// p from it) and multiplies (by 1 / p, 1 / 3, 1 / 6), and the Newton
// step's quotient a fast division (2 ulp; the iteration corrects it): a
// few ulp from the plain version, a much shorter dependent chain.
__device__ __forceinline__ void eig3(const Moments& m, float& w0, float& w1,
                                     float& w2) {
  const float sxx = m.sxx, syy = m.syy, szz = m.szz;
  const float sxy = m.sxy, sxz = m.sxz, syz = m.syz;
  const float p1 = sxy * sxy + sxz * sxz + syz * syz;
  const float qm = (sxx + syy + szz) * (1.0f / 3.0f);
  const float ax = sxx - qm, ay = syy - qm, az = szz - qm;
  const float p2 = ax * ax + ay * ay + az * az + 2.0f * p1;
  const float p6 = fmaxf(p2 * (1.0f / 6.0f), 1e-30f);
  const float ip = rsqrtf(p6);         // 1 / p
  const float p = p6 * ip;
  const float b00 = ax * ip, b11 = ay * ip, b22 = az * ip;
  const float b01 = sxy * ip, b02 = sxz * ip, b12 = syz * ip;
  const float detb = b00 * (b11 * b22 - b12 * b12) - b01 * (b01 * b22 - b12 * b02)
                     + b02 * (b01 * b12 - b11 * b02);
  const float r = fminf(fmaxf(detb / 2.0f, -1.0f), 1.0f);
  float c = 1.0f;
#pragma unroll
  for (int it = 0; it < 8; ++it) {
    c = c - __fdividef(4.0f * c * c * c - 3.0f * c - r,
                       fmaxf(12.0f * c * c - 3.0f, 1e-6f));
    c = fminf(fmaxf(c, 0.5f), 1.0f);
  }
  const float s = sqrtf(fmaxf(1.0f - c * c, 0.0f));
  w0 = qm + 2.0f * p * c;
  w2 = qm + 2.0f * p * (-0.5f * c - 0.8660254037844386f * s);
  w1 = 3.0f * qm - w0 - w2;
  if (p1 < 1e-12f) {   // near-diagonal: the sorted diagonal
    const float d0 = fmaxf(fmaxf(sxx, syy), szz);
    const float d2 = fminf(fminf(sxx, syy), szz);
    w0 = d0;
    w1 = sxx + syy + szz - d0 - d2;
    w2 = d2;
  }
}

// unit eigenvector of the eigenvalue other than wj, wk (select_fit.py
// _eigvec; one reciprocal square root of the squared norm, then
// multiplies)
__device__ __forceinline__ void eigvec(const Moments& m, float wj, float wk,
                                       float& vx, float& vy, float& vz) {
  const float a[3][3] = {{m.sxx - wj, m.sxy, m.sxz},
                         {m.sxy, m.syy - wj, m.syz},
                         {m.sxz, m.syz, m.szz - wj}};
  const float b[3][3] = {{m.sxx - wk, m.sxy, m.sxz},
                         {m.sxy, m.syy - wk, m.syz},
                         {m.sxz, m.syz, m.szz - wk}};
  float mm[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      mm[i][j] = a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j];
  const float n0 = mm[0][0] * mm[0][0] + mm[1][0] * mm[1][0] + mm[2][0] * mm[2][0];
  const float n1 = mm[0][1] * mm[0][1] + mm[1][1] * mm[1][1] + mm[2][1] * mm[2][1];
  const float n2 = mm[0][2] * mm[0][2] + mm[1][2] * mm[1][2] + mm[2][2] * mm[2][2];
  const bool pick0 = n0 >= n1 && n0 >= n2;
  const bool pick1 = !pick0 && n1 >= n2;
  const float v0 = pick0 ? mm[0][0] : (pick1 ? mm[0][1] : mm[0][2]);
  const float v1 = pick0 ? mm[1][0] : (pick1 ? mm[1][1] : mm[1][2]);
  const float v2 = pick0 ? mm[2][0] : (pick1 ? mm[2][1] : mm[2][2]);
  const float nrm2 = v0 * v0 + v1 * v1 + v2 * v2;
  const bool ok = nrm2 > 1e-40f;         // (1e-60 is 0 in float32)
  const float in = rsqrtf(nrm2);         // 1 / |v| where ok
  vx = ok ? v0 * in : 1.0f;
  vy = ok ? v1 * in : 0.0f;
  vz = ok ? v2 * in : 0.0f;
}

// Means from the reduced first moments [cnt, sx, sy, sz].
// (register arrays are indexed with constants only: O is a template
// argument, so nothing spills to local memory)
template <int O, int N>
__device__ __forceinline__ void set_means(Moments& m, const float (&s)[N]) {
  m.cnt = s[O];
  const float cd = 1.0f / fmaxf(m.cnt, 1.0f);
  m.mx = s[O + 1] * cd;
  m.my = s[O + 2] * cd;
  m.mz = s[O + 3] * cd;
}

template <int O, int N>
__device__ __forceinline__ void set_second(Moments& m, const float (&s)[N]) {
  m.sxx = s[O];
  m.syy = s[O + 1];
  m.szz = s[O + 2];
  m.sxy = s[O + 3];
  m.sxz = s[O + 4];
  m.syz = s[O + 5];
}

// (w * u) * v with w = 1 (a zero weight adds nothing and is skipped)
template <int O, int N>
__device__ __forceinline__ void add_second(float (&a)[N], float rx, float ry,
                                           float rz) {
  a[O] += rx * rx;
  a[O + 1] += ry * ry;
  a[O + 2] += rz * rz;
  a[O + 3] += rx * ry;
  a[O + 4] += rx * rz;
  a[O + 5] += ry * rz;
}

// One query per group of G lanes; sx / sy / sz: the group's shared rows
// for its compacted candidates (room for G P).
template <int G, int P, int MODE>
__device__ __forceinline__ void fit(const SelectFitProblem& pr, int vec,
                                    int n, bool live, int li, int lane,
                                    float* sx, float* sy, float* sz) {
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    qx = pr.q[3 * n];
    qy = pr.q[3 * n + 1];
    qz = pr.q[3 * n + 2];
  }
  const int C = live ? pr.C : 0;
  const float r2s = pr.r2s, r2w = pr.r2w;
  const float rA = MODE == 2 ? fmaxf(r2s, r2w) : r2s;

  // one read, compacted: the candidates within the largest radius the
  // mode uses (no other has a weight or a distance below 3e38) go,
  // query-relative and in index order, into the group's shared rows.
  // Aligned rows are read 16 bytes a lane (4 consecutive candidates).
  const unsigned gmask = G == 32 ? kFull : ((1u << G) - 1u) << (lane & ~(G - 1));
  const unsigned below = (1u << lane) - 1u;
  const size_t row = (size_t)n * pr.row_stride;
  int nA = 0;
  if (vec) {
    // every load first (one memory round trip), then the compaction
    constexpr int NQ = (P + 3) / 4;
    float4 X[NQ], Y[NQ], Z[NQ];
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int c0 = 4 * (li + G * j);
      X[j] = Y[j] = Z[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c0 < C) {
        X[j] = __ldg(reinterpret_cast<const float4*>(pr.cx + row + c0));
        Y[j] = __ldg(reinterpret_cast<const float4*>(pr.cy + row + c0));
        Z[j] = __ldg(reinterpret_cast<const float4*>(pr.cz + row + c0));
      }
    }
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      if (4 * G * j >= pr.C) break;    // uniform over the block
      const int c0 = 4 * (li + G * j);
      const float xs[4] = {X[j].x, X[j].y, X[j].z, X[j].w};
      const float ys[4] = {Y[j].x, Y[j].y, Y[j].z, Y[j].w};
      const float zs[4] = {Z[j].x, Z[j].y, Z[j].z, Z[j].w};
      float d[3][4];
      bool in[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        d[0][t] = xs[t] - qx;
        d[1][t] = ys[t] - qy;
        d[2][t] = zs[t] - qz;
        in[t] = c0 < C && d[0][t] * d[0][t] + d[1][t] * d[1][t]
                              + d[2][t] * d[2][t] <= rA;
      }
      int pos = nA, tot = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const unsigned b = __ballot_sync(kFull, in[t]) & gmask;
        pos += __popc(b & below);
        tot += __popc(b);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (in[t]) {
          sx[pos] = d[0][t];
          sy[pos] = d[1][t];
          sz[pos] = d[2][t];
          ++pos;
        }
      nA += tot;
    }
  } else {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (G * j >= pr.C) break;        // uniform over the block
      const int c = li + G * j;
      float dx = 0.f, dy = 0.f, dz = 0.f;
      bool in = false;
      if (c < C) {
        dx = __ldg(pr.cx + row + c) - qx;
        dy = __ldg(pr.cy + row + c) - qy;
        dz = __ldg(pr.cz + row + c) - qz;
        in = dx * dx + dy * dy + dz * dz <= rA;
      }
      const unsigned b = __ballot_sync(kFull, in) & gmask;
      if (in) {
        const int pos = nA + __popc(b & below);
        sx[pos] = dx;
        sy[pos] = dy;
        sz[pos] = dz;
      }
      nA += __popc(b);
    }
  }
  __syncwarp();
  // compacted slots a lane (uniform over the warp): entry i = li + G j
  const int Pg = (nA + G - 1) / G;
  const int Pw = G == 32 ? Pg : __reduce_max_sync(kFull, (unsigned)Pg);

  // distances: the strict-radius set (running minima) and the wide set
  float cur[P];
  unsigned inr = 0u, inw = 0u;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    cur[j] = kInf;
    const int i = li + G * j;
    if (j < Pw && i < nA) {
      const float dx = sx[i], dy = sy[i], dz = sz[i];
      const float d2 = dx * dx + dy * dy + dz * dz;
      const bool s = d2 <= r2s;
      if (s) cur[j] = d2;
      if (s && d2 < kInf * 0.5f) inr |= 1u << j;
      if (MODE == 2 && d2 <= r2w) inw |= 1u << j;
    }
  }

  // k sequential minima; every element equal to the minimum goes (marked
  // +inf: consumed); the consumed in-radius elements are the k-NN set
  for (int i = 0; i < pr.k; ++i) {
    float v = kInf;
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (j < Pw) v = fminf(v, cur[j]);
    v = group_min<G>(v);
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (j < Pw) cur[j] = cur[j] <= v ? INFINITY : cur[j];
    if (live && li == 0) pr.d2k[(size_t)n * pr.k + i] = v;
  }
  unsigned wk = 0u;
#pragma unroll
  for (int j = 0; j < P; ++j)
    if (cur[j] == INFINITY) wk |= 1u << j;
  wk &= inr;

  // first moments, strict [0, 4) and (plane2) wide [4, 8), one reduction
  constexpr int NF = MODE == 2 ? 8 : 4;
  float a[NF], s[NF];
#pragma unroll
  for (int i = 0; i < NF; ++i) a[i] = 0.f;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int i = li + G * j;
    if (j < Pw && i < nA) {
      const float dx = sx[i], dy = sy[i], dz = sz[i];
      if ((wk >> j) & 1u) {            // w * u is u or 0: add u or skip
        a[0] += 1.0f;
        a[1] += dx;
        a[2] += dy;
        a[3] += dz;
      }
      if constexpr (MODE == 2) {
        if ((inw >> j) & 1u) {
          a[4] += 1.0f;
          a[5] += dx;
          a[6] += dy;
          a[7] += dz;
        }
      }
    }
  }
  group_reduce<NF, G>(a, s, li, lane, Add());
  Moments m, mw;
  set_means<0>(m, s);
  if constexpr (MODE == 2) set_means<4>(mw, s);

  // second moments, strict [0, 6) and (plane2) wide [6, 12), one reduction
  constexpr int NS = MODE == 2 ? 16 : 8;
  float b[NS], t[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) b[i] = 0.f;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int i = li + G * j;
    if (j < Pw && i < nA) {
      const float dx = sx[i], dy = sy[i], dz = sz[i];
      if ((wk >> j) & 1u) add_second<0>(b, dx - m.mx, dy - m.my, dz - m.mz);
      if constexpr (MODE == 2) {
        if ((inw >> j) & 1u)
          add_second<6>(b, dx - mw.mx, dy - mw.my, dz - mw.mz);
      }
    }
  }
  group_reduce<NS, G, MODE == 2 ? 12 : 6>(b, t, li, lane, Add());
  set_second<0>(m, t);
  if constexpr (MODE == 2) set_second<6>(mw, t);

  float e0, e1, e2, nx, ny, nz;
  bool valid;
  if (MODE == 0) {                     // line: largest eigenvector
    eig3(m, e0, e1, e2);
    eigvec(m, e1, e2, nx, ny, nz);
    valid = m.cnt >= (float)pr.min_count && e0 > pr.eig_ratio * e1;
  } else {                             // plane: smallest eigenvector
    // plane2: the upper half of the group solves the wide fit with the
    // same instructions, then the halves swap their results
    const bool wide_lane = MODE == 2 && li >= G / 2;
    const Moments f = wide_lane ? mw : m;
    eig3(f, e0, e1, e2);
    eigvec(f, e0, e1, nx, ny, nz);
    float v0 = 0.f, v1 = 0.f, wx = 0.f, wy = 0.f, wz = 0.f;
    if (MODE == 2) {
      const float o0 = __shfl_xor_sync(kFull, e0, G / 2);
      const float o1 = __shfl_xor_sync(kFull, e1, G / 2);
      const float ox = __shfl_xor_sync(kFull, nx, G / 2);
      const float oy = __shfl_xor_sync(kFull, ny, G / 2);
      const float oz = __shfl_xor_sync(kFull, nz, G / 2);
      v0 = wide_lane ? e0 : o0;
      v1 = wide_lane ? e1 : o1;
      wx = wide_lane ? nx : ox;
      wy = wide_lane ? ny : oy;
      wz = wide_lane ? nz : oz;
      e0 = wide_lane ? o0 : e0;
      e1 = wide_lane ? o1 : e1;
      nx = wide_lane ? ox : nx;
      ny = wide_lane ? oy : ny;
      nz = wide_lane ? oz : nz;
    }
    // residual maxima: strict; (plane2) wide over ww and over w
    float r[4] = {0.f, 0.f, 0.f, 0.f}, rm[4];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int i = li + G * j;
      if (j < Pw && i < nA) {
        const float dx = sx[i], dy = sy[i], dz = sz[i];
        const bool w = (wk >> j) & 1u;   // rr * 0 never raises a max
        if (w)
          r[0] = fmaxf(r[0], fabsf(nx * (dx - m.mx) + ny * (dy - m.my)
                                   + nz * (dz - m.mz)));
        if (MODE == 2 && (w || ((inw >> j) & 1u))) {
          const float rw = fabsf(wx * (dx - mw.mx) + wy * (dy - mw.my)
                                 + wz * (dz - mw.mz));
          if ((inw >> j) & 1u) r[1] = fmaxf(r[1], rw);
          if (w) r[2] = fmaxf(r[2], rw);
        }
      }
    }
    if (MODE == 2) {
      group_reduce<4, G, 3>(r, rm, li, lane, Max());
    } else {
#pragma unroll
      for (int o = 1; o < G; o <<= 1)
        r[0] = fmaxf(r[0], __shfl_xor_sync(kFull, r[0], o));
      rm[0] = r[0];
    }
    valid = m.cnt >= (float)pr.min_count && rm[0] <= pr.tol
            && e1 > pr.cond_frac * e0;
    if (MODE == 2) {                   // two-scale fallback
      const bool fb_ok = mw.cnt >= (float)pr.min_wide && v1 > pr.cond_frac * v0
                         && rm[1] <= pr.tol && rm[2] <= pr.tol;
      if (!valid && fb_ok) {
        m.mx = mw.mx;
        m.my = mw.my;
        m.mz = mw.mz;
        nx = wx;
        ny = wy;
        nz = wz;
        valid = true;
      }
    }
  }
  if (live && li == 0) {
    pr.cen[3 * n] = m.mx + qx;         // back to world
    pr.cen[3 * n + 1] = m.my + qy;
    pr.cen[3 * n + 2] = m.mz + qz;
    pr.nrm[3 * n] = nx;
    pr.nrm[3 * n + 1] = ny;
    pr.nrm[3 * n + 2] = nz;
    pr.valid[n] = valid ? 1 : 0;
  }
}

template <int G, int P>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
select_fit_kernel(const Launch L) {
  constexpr int QB = kThreads / G;     // queries per block
  __shared__ __align__(16) float sm[QB][3][G * P];
  const bool later = (int)blockIdx.x >= L.blocks0;
  const int which = later ? 1 - L.first : L.first;
  const SelectFitProblem pr = which ? L.p[1] : L.p[0];
  const int vec = which ? L.vec[1] : L.vec[0];
  const int blk = (int)blockIdx.x - (later ? L.blocks0 : 0);
  const int g = threadIdx.x / G, li = threadIdx.x & (G - 1);
  const int lane = threadIdx.x & 31;
  const int n = blk * QB + g;
  const bool live = n < pr.N;   // a dead group runs with no candidates

  switch (pr.mode) {                   // uniform over the block
    case 0:
      fit<G, P, 0>(pr, vec, n, live, li, lane, sm[g][0], sm[g][1], sm[g][2]);
      break;
    case 1:
      fit<G, P, 1>(pr, vec, n, live, li, lane, sm[g][0], sm[g][1], sm[g][2]);
      break;
    default:
      fit<G, P, 2>(pr, vec, n, live, li, lane, sm[g][0], sm[g][1], sm[g][2]);
      break;
  }
}

// (G, P) of a launch from its largest C: 8 lanes for C <= 8, else 16
// lanes with P (a power of two) candidates a lane.
void lanes(int C, int& G, int& P) {
  G = C <= 8 ? 8 : 16;
  P = 1;
  while (G * P < C) P *= 2;
}

typedef void (*KernelFn)(const Launch);

template <int P>
KernelFn kernel16(int p) {
  if constexpr (16 * P >= kMaxC) {
    return select_fit_kernel<16, P>;
  } else {
    return p <= P ? select_fit_kernel<16, P> : kernel16<2 * P>(p);
  }
}

KernelFn kernel_for(int G, int P) {
  return G == 8 ? select_fit_kernel<8, 1> : kernel16<1>(P);
}

bool bad(const SelectFitProblem& p) {
  return p.N > 0 && (p.C <= 0 || p.C > kMaxC || p.k <= 0 || p.k > kMaxK ||
                     p.mode < 0 || p.mode > 2);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// The launch of problems a and b (b may be null or empty).
int plan(const SelectFitProblem* a, const SelectFitProblem* b, Launch& L,
         int& G, int& P, int& blocks) {
  L = Launch{};
  L.p[0] = *a;
  if (b) L.p[1] = *b;
  if (bad(L.p[0]) || bad(L.p[1])) return (int)cudaErrorInvalidValue;
  int cmax = 1;
  for (int i = 0; i < 2; ++i) {
    const SelectFitProblem& p = L.p[i];
    if (p.N > 0 && p.C > cmax) cmax = p.C;
    L.vec[i] = p.C % 4 == 0 && p.row_stride % 4 == 0 && aligned16(p.cx) &&
               aligned16(p.cy) && aligned16(p.cz);
  }
  lanes(cmax, G, P);
  const int QB = kThreads / G;
  const long long w0 = (long long)L.p[0].N * L.p[0].C;
  const long long w1 = (long long)L.p[1].N * L.p[1].C;
  L.first = w1 > w0 ? 1 : 0;
  L.blocks0 = (L.p[L.first].N + QB - 1) / QB;
  blocks = L.blocks0 + (L.p[1 - L.first].N + QB - 1) / QB;
  return 0;
}

}  // namespace

// One launch for problem a and, when b is not null, problem b. Returns the
// CUDA error of the launch (0 = ok).
extern "C" int select_fit_launch(const SelectFitProblem* a,
                                 const SelectFitProblem* b, void* stream) {
  Launch L;
  int G, P, blocks;
  const int err = plan(a, b, L, G, P, blocks);
  if (err != 0) return err;
  if (blocks == 0) return 0;
  kernel_for(G, P)<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(L);
  return (int)cudaGetLastError();
}

// Geometry of one launch at these sizes (for reports): out = [G, P,
// blocks, threads, static shared bytes, registers a thread, local (spill)
// bytes a thread, resident blocks per SM].
extern "C" int select_fit_geometry(int Na, int Ca, int Nb, int Cb,
                                   int* out) {
  SelectFitProblem a = {}, b = {};
  a.N = Na;
  a.C = Ca;
  a.k = 1;
  b.N = Nb;
  b.C = Cb;
  b.k = 1;
  Launch L;
  int G, P, blocks;
  int err = plan(&a, &b, L, G, P, blocks);
  if (err != 0) return err;
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, kernel_for(G, P));
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_for(G, P),
                                                      kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  const int v[8] = {G, P, blocks, kThreads, (int)fa.sharedSizeBytes,
                    fa.numRegs, (int)fa.localSizeBytes, per_sm};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}
