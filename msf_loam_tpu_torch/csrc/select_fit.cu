// Fused k-NN selection + line / plane fit over gathered candidates, one
// warp per query.
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
// What bounds it on the H100: bytes. The work is one read of the
// candidates (12 B x C per query: 12.6 MB for the plane2 call at N=4096,
// C=256, about 3.8 us at 3.35 TB/s) and a few hundred flops per candidate.
// The design reads every candidate exactly once into registers (C/32 per
// lane, lanes on consecutive addresses, so each x/y/z row is one coalesced
// 1 KB read), keeps all passes (distances, k mins, moments, residual
// maxima) in registers with butterfly warp reductions, and lets every
// lane evaluate the 3x3 eigensolve redundantly instead of serialising on
// one lane.
//
// Compiled with -fmad=false; sums are reduced in another order than the
// plain PyTorch version, so centres, normals and gate values agree with it
// to float32 rounding, not bit for bit. d2 is bit-equal.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // 8 queries per block
constexpr int kMaxPerLane = 8;    // C <= 256
constexpr int kMaxK = 32;
constexpr float kInf = 3.0e38f;   // select_fit.py _INF

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float warp_min(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

struct Moments {
  float cnt, mx, my, mz;
  float sxx, syy, szz, sxy, sxz, syz;
};

__device__ Moments moments(const float* w, const float* dx, const float* dy,
                           const float* dz) {
  float c = 0.f, sx = 0.f, sy = 0.f, sz = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    c += w[j];
    sx += w[j] * dx[j];
    sy += w[j] * dy[j];
    sz += w[j] * dz[j];
  }
  Moments m;
  m.cnt = warp_sum(c);
  const float cd = 1.0f / fmaxf(m.cnt, 1.0f);
  m.mx = warp_sum(sx) * cd;
  m.my = warp_sum(sy) * cd;
  m.mz = warp_sum(sz) * cd;
  float xx = 0.f, yy = 0.f, zz = 0.f, xy = 0.f, xz = 0.f, yz = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    const float rx = dx[j] - m.mx, ry = dy[j] - m.my, rz = dz[j] - m.mz;
    xx += w[j] * rx * rx;
    yy += w[j] * ry * ry;
    zz += w[j] * rz * rz;
    xy += w[j] * rx * ry;
    xz += w[j] * rx * rz;
    yz += w[j] * ry * rz;
  }
  m.sxx = warp_sum(xx);
  m.syy = warp_sum(yy);
  m.szz = warp_sum(zz);
  m.sxy = warp_sum(xy);
  m.sxz = warp_sum(xz);
  m.syz = warp_sum(yz);
  return m;
}

// eigenvalues, descending (select_fit.py _eig3)
__device__ void eig3(const Moments& m, float& w0, float& w1, float& w2) {
  const float sxx = m.sxx, syy = m.syy, szz = m.szz;
  const float sxy = m.sxy, sxz = m.sxz, syz = m.syz;
  const float p1 = sxy * sxy + sxz * sxz + syz * syz;
  const float qm = (sxx + syy + szz) / 3.0f;
  const float ax = sxx - qm, ay = syy - qm, az = szz - qm;
  const float p2 = ax * ax + ay * ay + az * az + 2.0f * p1;
  const float p = sqrtf(fmaxf(p2 / 6.0f, 1e-30f));
  const float b00 = ax / p, b11 = ay / p, b22 = az / p;
  const float b01 = sxy / p, b02 = sxz / p, b12 = syz / p;
  const float detb = b00 * (b11 * b22 - b12 * b12) - b01 * (b01 * b22 - b12 * b02)
                     + b02 * (b01 * b12 - b11 * b02);
  const float r = fminf(fmaxf(detb / 2.0f, -1.0f), 1.0f);
  float c = 1.0f;
  for (int it = 0; it < 8; ++it) {
    c = c - (4.0f * c * c * c - 3.0f * c - r) / fmaxf(12.0f * c * c - 3.0f, 1e-6f);
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

// unit eigenvector of the eigenvalue other than wj, wk (select_fit.py _eigvec)
__device__ void eigvec(const Moments& m, float wj, float wk, float& vx,
                       float& vy, float& vz) {
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
  const int col = pick0 ? 0 : (pick1 ? 1 : 2);
  const float v0 = mm[0][col], v1 = mm[1][col], v2 = mm[2][col];
  const float nrm2 = v0 * v0 + v1 * v1 + v2 * v2;
  const float nrm = sqrtf(fmaxf(nrm2, 0.0f));   // 1e-60 is 0 in float32
  const bool ok = nrm2 > 1e-40f;
  vx = ok ? v0 / nrm : 1.0f;
  vy = ok ? v1 / nrm : 0.0f;
  vz = ok ? v2 / nrm : 0.0f;
}

__device__ float max_resid(const float* w, const float* dx, const float* dy,
                           const float* dz, const Moments& m, float nx,
                           float ny, float nz, const float* w2, float* max2) {
  float r1 = 0.f, r2 = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    const float rr = fabsf(nx * (dx[j] - m.mx) + ny * (dy[j] - m.my) + nz * (dz[j] - m.mz));
    r1 = fmaxf(r1, rr * w[j]);
    if (w2) r2 = fmaxf(r2, rr * w2[j]);
  }
  if (max2) *max2 = warp_max(r2);
  return warp_max(r1);
}

__global__ void __launch_bounds__(kThreads)
select_fit_kernel(const float* __restrict__ q, const float* __restrict__ cx,
                  const float* __restrict__ cy, const float* __restrict__ cz,
                  long long row_stride, int N, int C, int k, int mode,
                  int min_count, int min_wide, float eig_ratio, float tol,
                  float cond_frac, float r2s, float r2w,
                  float* __restrict__ d2k_out, float* __restrict__ cen_out,
                  float* __restrict__ nrm_out,
                  unsigned char* __restrict__ valid_out) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (n >= N) return;   // warp-uniform
  const float qx = q[3 * n], qy = q[3 * n + 1], qz = q[3 * n + 2];
  const size_t base = (size_t)n * row_stride;

  float dx[kMaxPerLane], dy[kMaxPerLane], dz[kMaxPerLane];
  float d2[kMaxPerLane], d2s[kMaxPerLane], w[kMaxPerLane];
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) {
    const int c = lane + 32 * j;
    if (c < C) {
      dx[j] = cx[base + c] - qx;
      dy[j] = cy[base + c] - qy;
      dz[j] = cz[base + c] - qz;
      d2[j] = dx[j] * dx[j] + dy[j] * dy[j] + dz[j] * dz[j];
      d2s[j] = d2[j] <= r2s ? d2[j] : kInf;
    } else {               // absent: no distance, no weight
      dx[j] = dy[j] = dz[j] = 0.f;
      d2[j] = d2s[j] = kInf;
    }
  }

  // k sequential masked minima; every element equal to the minimum goes
  float cur[kMaxPerLane];
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j) cur[j] = d2s[j];
  float kth = kInf;
  for (int i = 0; i < k; ++i) {
    float v = kInf;
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j) v = fminf(v, cur[j]);
    v = warp_min(v);
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j) cur[j] = cur[j] <= v ? kInf : cur[j];
    if (lane == 0) d2k_out[(size_t)n * k + i] = v;
    kth = v;
  }
#pragma unroll
  for (int j = 0; j < kMaxPerLane; ++j)
    w[j] = (d2s[j] <= kth && d2s[j] < kInf * 0.5f) ? 1.0f : 0.0f;

  float cen[3], nrm[3];
  bool valid;
  const Moments m = moments(w, dx, dy, dz);
  float e0, e1, e2;
  eig3(m, e0, e1, e2);
  if (mode == 0) {                     // line: largest eigenvector
    eigvec(m, e1, e2, nrm[0], nrm[1], nrm[2]);
    valid = m.cnt >= (float)min_count && e0 > eig_ratio * e1;
    cen[0] = m.mx; cen[1] = m.my; cen[2] = m.mz;
  } else {                             // plane: smallest eigenvector
    eigvec(m, e0, e1, nrm[0], nrm[1], nrm[2]);
    const float maxres = max_resid(w, dx, dy, dz, m, nrm[0], nrm[1], nrm[2],
                                   nullptr, nullptr);
    valid = m.cnt >= (float)min_count && maxres <= tol && e1 > cond_frac * e0;
    cen[0] = m.mx; cen[1] = m.my; cen[2] = m.mz;
    if (mode == 2) {                   // two-scale fallback
      float ww[kMaxPerLane];
#pragma unroll
      for (int j = 0; j < kMaxPerLane; ++j) ww[j] = d2[j] <= r2w ? 1.0f : 0.0f;
      const Moments mw = moments(ww, dx, dy, dz);
      float v0, v1, v2;
      eig3(mw, v0, v1, v2);
      float wn[3];
      eigvec(mw, v0, v1, wn[0], wn[1], wn[2]);
      float res_n;
      const float res_w = max_resid(ww, dx, dy, dz, mw, wn[0], wn[1], wn[2],
                                    w, &res_n);
      const bool fb_ok = mw.cnt >= (float)min_wide && v1 > cond_frac * v0
                         && res_w <= tol && res_n <= tol;
      if (!valid && fb_ok) {
        cen[0] = mw.mx; cen[1] = mw.my; cen[2] = mw.mz;
        nrm[0] = wn[0]; nrm[1] = wn[1]; nrm[2] = wn[2];
        valid = true;
      }
    }
  }
  if (lane == 0) {
    cen_out[3 * n] = cen[0] + qx;      // back to world
    cen_out[3 * n + 1] = cen[1] + qy;
    cen_out[3 * n + 2] = cen[2] + qz;
    nrm_out[3 * n] = nrm[0];
    nrm_out[3 * n + 1] = nrm[1];
    nrm_out[3 * n + 2] = nrm[2];
    valid_out[n] = valid ? 1 : 0;
  }
}

}  // namespace

// Candidates of query n, coordinate a, index c at ca[n * row_stride + c]:
// rows layout (N, 3C) passes cx = base, cy = base + C, cz = base + 2C,
// row_stride = 3C; planar (3, N, C) passes the three planes, stride C.
extern "C" int select_fit_launch(const float* q, const float* cx,
                                 const float* cy, const float* cz,
                                 long long row_stride, int N, int C, int k,
                                 int mode, int min_count, int min_wide,
                                 float eig_ratio, float tol, float cond_frac,
                                 float r2s, float r2w, float* d2k, float* cen,
                                 float* nrm, unsigned char* valid,
                                 void* stream) {
  if (N <= 0) return 0;
  if (C <= 0 || C > 32 * kMaxPerLane || k <= 0 || k > kMaxK || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  const int per_block = kThreads / 32;
  const int blocks = (N + per_block - 1) / per_block;
  select_fit_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      q, cx, cy, cz, row_stride, N, C, k, mode, min_count, min_wide,
      eig_ratio, tol, cond_frac, r2s, r2w, d2k, cen, nrm, valid);
  return (int)cudaGetLastError();
}
