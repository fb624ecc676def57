// K2 spfh and K3 wsum: the two passes of the fused FPFH-33 descriptor;
// K9 moments (below them): the moment pass of the radius normals.
//
// Replace the TPU kernels pctpu/features/pallas_fpfh.py:_spfh_kernel and
// _wsum_kernel (both launched by _fpfh_fused_impl).
//
// What they compute, per query point (row) of batch element b, over the
// db columns of its query tile's x-band [base*db_tile, (base+nt)*db_tile):
//   d2     = |q|^2 + |p|^2 - 2 q.p         (q = query point, p = db point)
//   within = d2 + pen <= r^2  and  row != col   (pen = 1e30 on masked cols)
// K2 (spfh): the Darboux angles of every within pair from six factored
//   dots of per-point vectors (q, u = n_q, q x u against p, v = n_p,
//   v x p), binned into 3 x 11 histograms; the result is scaled by
//   100 / max(count, 1). The angle f3 uses the reference's Cephes
//   polynomial atan2 (not atan2f) and the same floor/clip binning, so bin
//   boundaries fall where the TPU kernel puts them.
// K3 (wsum): sum over within pairs of rsqrt(max(d2,1e-12)) * spfh[col],
//   divided by max(count, 1).
// The file is compiled with --fmad=false, so every product and sum rounds
// where the plain PyTorch version rounds.
//
// Bound on an H100: operations. K2 spends about 80 FP32 operations on a
// within pair and about 12 on a pair outside the radius; K3 about 8 per
// pair plus 66 per within pair. The inputs (a few MB) are read from L2.
//
// Design (a first, simple one): grid (nq, B), one query per thread (256
// threads = one query tile), the in-band db staged in shared memory in
// chunks of 128 columns (K2: the 12 packed rows; K3: also the chunk's 33
// SPFH values per column), every thread of a warp reading the same column
// at once (a broadcast). K2 keeps each thread's 33-bin histogram in shared
// memory laid out [bin][thread] (no bank conflicts); K3 keeps its 33 sums
// in registers. Only 8 x 16 = 128 blocks run at the main path's shapes;
// splitting the band across blocks is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kQT = 256;       // queries per block = the query tile
constexpr int kTN = 128;       // db columns per shared-memory chunk
constexpr int kBins = 11;
constexpr int kH = 3 * kBins;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kHalfPi = 1.57079632679489661923f;
constexpr float kTwoPiInv = (float)(11.0 / (2.0 * 3.14159265358979323846));

// reference pallas_fpfh.py:_atan2f, term for term
__device__ __forceinline__ float atan2_cephes(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float hi = fmaxf(ax, ay);
  const float a = fminf(ax, ay) / fmaxf(hi, 1e-30f);
  const float z = a * a;
  const float p = ((((8.05374449538e-2f * z - 1.38776856032e-1f) * z
                     + 1.99777106478e-1f) * z - 3.33329491539e-1f) * z) * a
                  + a;
  float r = ay > ax ? kHalfPi - p : p;
  r = x < 0.f ? kPi - r : r;
  return y < 0.f ? -r : r;
}

// floor, then clip to [0, 10] in float before the cast (NaN -> 0)
__device__ __forceinline__ int bin_of(float v) {
  return (int)fminf(fmaxf(floorf(v), 0.f), (float)(kBins - 1));
}

__global__ void __launch_bounds__(kQT)
spfh_kernel(const float* __restrict__ amat, const float* __restrict__ dbmat,
            const int* __restrict__ base, const int* __restrict__ nt,
            float* __restrict__ hist_out, float* __restrict__ cnt_out,
            int Np, int db_tile, float r2) {
  __shared__ float sdb[12][kTN];
  __shared__ float shist[kH * kQT];
  const int b = blockIdx.y, i = blockIdx.x, tid = threadIdx.x;
  const int nq = gridDim.x;
  const int row = i * kQT + tid;
  const float* a = amat + ((size_t)b * Np + row) * 11;
  const float q0 = a[0], q1 = a[1], q2 = a[2];
  const float u0 = a[3], u1 = a[4], u2 = a[5];
  const float x0 = a[6], x1 = a[7], x2 = a[8];
  const float qq = a[9], uq = a[10];
  for (int k = 0; k < kH; ++k) shist[k * kQT + tid] = 0.f;
  float cnt = 0.f;

  const int start = base[b * nq + i] * db_tile;
  const int ncols = nt[b * nq + i] * db_tile;
  const float* dbb = dbmat + (size_t)b * 12 * Np;
  for (int off = 0; off < ncols; off += kTN) {
    __syncthreads();
    for (int e = tid; e < 12 * kTN; e += kQT) {
      const int r = e / kTN, c = e % kTN;
      sdb[r][c] = dbb[(size_t)r * Np + start + off + c];
    }
    __syncthreads();
    for (int c = 0; c < kTN; ++c) {
      const int col = start + off + c;
      const float p0 = sdb[0][c], p1 = sdb[1][c], p2 = sdb[2][c];
      const float qp = q0 * p0 + q1 * p1 + q2 * p2;
      const float d2 = (qq + sdb[9][c]) - 2.0f * qp;
      if (!(d2 + sdb[11][c] <= r2) || row == col) continue;
      const float v0 = sdb[3][c], v1 = sdb[4][c], v2 = sdb[5][c];
      const float up = u0 * p0 + u1 * p1 + u2 * p2;
      const float qv = q0 * v0 + q1 * v1 + q2 * v2;
      const float un = u0 * v0 + u1 * v1 + u2 * v2;
      const float xv = x0 * v0 + x1 * v1 + x2 * v2;
      const float uw = u0 * sdb[6][c] + u1 * sdb[7][c] + u2 * sdb[8][c];
      const float inv_d = 1.0f / sqrtf(fmaxf(d2, 1e-12f));
      const float f2 = (up - uq) * inv_d;
      const float s = sqrtf(fmaxf(1.0f - f2 * f2, 0.f));
      const float inv_s = 1.0f / fmaxf(s, 1e-12f);
      const float f1 = (uw - xv) * inv_d * inv_s;
      const float dn = (sdb[10][c] - qv) * inv_d;
      const float f3 = atan2_cephes((dn - f2 * un) * inv_s, un);
      shist[bin_of((f1 + 1.0f) * 5.5f) * kQT + tid] += 1.f;
      shist[(kBins + bin_of((f2 + 1.0f) * 5.5f)) * kQT + tid] += 1.f;
      shist[(2 * kBins + bin_of((f3 + kPi) * kTwoPiInv)) * kQT + tid] += 1.f;
      cnt += 1.f;
    }
  }
  cnt = fmaxf(cnt, 1.f);
  const float scale = 100.0f / cnt;
  float* out = hist_out + ((size_t)b * Np + row) * kH;
  for (int k = 0; k < kH; ++k) out[k] = shist[k * kQT + tid] * scale;
  cnt_out[(size_t)b * Np + row] = cnt;
}

__global__ void __launch_bounds__(kQT)
wsum_kernel(const float* __restrict__ amat, const float* __restrict__ dbmat,
            const int* __restrict__ base, const int* __restrict__ nt,
            const float* __restrict__ s33, float* __restrict__ out,
            int Np, int db_tile, float r2) {
  __shared__ float sp[5][kTN];       // x, y, z, |p|^2, pen
  __shared__ float ss[kTN * kH];     // the chunk's SPFH rows
  const int b = blockIdx.y, i = blockIdx.x, tid = threadIdx.x;
  const int nq = gridDim.x;
  const int row = i * kQT + tid;
  const float* a = amat + ((size_t)b * Np + row) * 11;
  const float q0 = a[0], q1 = a[1], q2 = a[2], qq = a[9];
  float acc[kH];
#pragma unroll
  for (int k = 0; k < kH; ++k) acc[k] = 0.f;
  float k_eff = 0.f;

  const int start = base[b * nq + i] * db_tile;
  const int ncols = nt[b * nq + i] * db_tile;
  const float* dbb = dbmat + (size_t)b * 12 * Np;
  const int src_rows[5] = {0, 1, 2, 9, 11};
  for (int off = 0; off < ncols; off += kTN) {
    __syncthreads();
    for (int e = tid; e < 5 * kTN; e += kQT) {
      const int r = e / kTN, c = e % kTN;
      sp[r][c] = dbb[(size_t)src_rows[r] * Np + start + off + c];
    }
    const float* srow = s33 + ((size_t)b * Np + start + off) * kH;
    for (int e = tid; e < kTN * kH; e += kQT) ss[e] = srow[e];
    __syncthreads();
    for (int c = 0; c < kTN; ++c) {
      const int col = start + off + c;
      const float qp = q0 * sp[0][c] + q1 * sp[1][c] + q2 * sp[2][c];
      const float d2 = (qq + sp[3][c]) - 2.0f * qp;
      if (!(d2 + sp[4][c] <= r2) || row == col) continue;
      const float w = 1.0f / sqrtf(fmaxf(d2, 1e-12f));
#pragma unroll
      for (int k = 0; k < kH; ++k) acc[k] += w * ss[c * kH + k];
      k_eff += 1.f;
    }
  }
  const float den = fmaxf(k_eff, 1.f);
  float* o = out + ((size_t)b * Np + row) * kH;
#pragma unroll
  for (int k = 0; k < kH; ++k) o[k] = acc[k] / den;
}

// K9 moments: the radius-neighbourhood moments of the normals pass.
//
// Replaces the TPU kernel pctpu/features/pallas_fpfh.py:_moments_kernel
// (launched by normals_radius_fused). Per query row of query tile i,
// over the db columns of the tile's x-band:
//   w      = (|q|^2 + |p|^2 - 2 q.p) + pen <= r^2   (self included)
//   out[q] = sum over w of [x,y,z,x^2,y^2,z^2,xy,xz,yz,1], with
//            (x,y,z) = p - cent[i], the tile's centroid (0 on a dead col).
// The TPU kernel sums through a [TQ,TN]x[TN,10] f32 dot in an unspecified
// order; here each query sums its features in f64 and rounds once to
// f32, as the plain version does, so the two agree to within one f32 ulp.
//
// Bound on an H100: operations. About 10 FP32 operations per in-band
// pair (the distance test) and 10 f64 adds per pair inside the radius;
// the inputs (a few MB) are read from L2.
//
// Design (a first, simple one): grid (nq, B), one query per thread (the
// block is the query tile), the in-band db staged in shared memory in
// chunks of 128 columns. The shift is the tile's centroid, shared by
// every thread of the block, so each column's 10 shifted features are
// computed once per block while staging, not once per pair. A tile with
// no valid point has nt = 0 and writes zeros.
__global__ void __launch_bounds__(kQT)
moments_kernel(const float* __restrict__ amat,
               const float* __restrict__ dbmat,
               const float* __restrict__ cent, const int* __restrict__ base,
               const int* __restrict__ nt, float* __restrict__ out, int Np,
               int db_tile, float r2) {
  __shared__ float sp[5][kTN];       // x, y, z, |p|^2, pen
  __shared__ float sf[10][kTN];      // the shifted features
  const int b = blockIdx.y, i = blockIdx.x, tid = threadIdx.x;
  const int nq = gridDim.x, qt = blockDim.x;
  const int row = i * qt + tid;
  const float* a = amat + ((size_t)b * Np + row) * 4;
  const float q0 = a[0], q1 = a[1], q2 = a[2], qq = a[3];
  const float* c3 = cent + ((size_t)b * nq + i) * 3;
  const float cx = c3[0], cy = c3[1], cz = c3[2];
  double acc[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) acc[k] = 0.0;

  const int start = base[b * nq + i] * db_tile;
  const int ncols = nt[b * nq + i] * db_tile;
  const float* dbb = dbmat + (size_t)b * 5 * Np;
  for (int off = 0; off < ncols; off += kTN) {
    __syncthreads();
    for (int c = tid; c < kTN; c += qt) {
      const int col = start + off + c;
      float v[5];
#pragma unroll
      for (int r = 0; r < 5; ++r) v[r] = dbb[(size_t)r * Np + col];
#pragma unroll
      for (int r = 0; r < 5; ++r) sp[r][c] = v[r];
      const bool dead = v[4] > 1.0f;
      const float x = dead ? 0.f : v[0] - cx;
      const float y = dead ? 0.f : v[1] - cy;
      const float z = dead ? 0.f : v[2] - cz;
      sf[0][c] = x;
      sf[1][c] = y;
      sf[2][c] = z;
      sf[3][c] = x * x;
      sf[4][c] = y * y;
      sf[5][c] = z * z;
      sf[6][c] = x * y;
      sf[7][c] = x * z;
      sf[8][c] = y * z;
      sf[9][c] = dead ? 0.f : 1.f;
    }
    __syncthreads();
    for (int c = 0; c < kTN; ++c) {
      const float qp = q0 * sp[0][c] + q1 * sp[1][c] + q2 * sp[2][c];
      const float d2 = (qq + sp[3][c]) - 2.0f * qp;
      if (!(d2 + sp[4][c] <= r2)) continue;
#pragma unroll
      for (int k = 0; k < 10; ++k) acc[k] += (double)sf[k][c];
    }
  }
  float* o = out + ((size_t)b * Np + row) * 10;
#pragma unroll
  for (int k = 0; k < 10; ++k) o[k] = (float)acc[k];
}

}  // namespace

// amat [B,Np,4], dbmat [B,5,Np], cent [B,nq,3], base/nt [B,nq] i32 ->
// out [B,Np,10]. nq = Np / q_tile; needs q_tile % 32 == 0, q_tile <= 256
// and db_tile % 128 == 0.
extern "C" int pct_moments(const float* amat, const float* dbmat,
                           const float* cent, const int* base, const int* nt,
                           float* out, int B, int Np, int q_tile, int db_tile,
                           float r2, cudaStream_t stream) {
  if (q_tile <= 0 || q_tile % 32 != 0 || q_tile > kQT || db_tile % kTN != 0
      || Np % q_tile != 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || Np <= 0) return 0;
  dim3 grid(Np / q_tile, B);
  moments_kernel<<<grid, q_tile, 0, stream>>>(amat, dbmat, cent, base, nt,
                                              out, Np, db_tile, r2);
  return (int)cudaGetLastError();
}

// amat [B,Np,11], dbmat [B,12,Np], base/nt [B,Np/256] i32 ->
// hist [B,Np,33], cnt [B,Np]. Needs q_tile == 256, db_tile % 128 == 0.
extern "C" int pct_spfh(const float* amat, const float* dbmat, const int* base,
                        const int* nt, float* hist, float* cnt, int B, int Np,
                        int q_tile, int db_tile, float r2,
                        cudaStream_t stream) {
  if (q_tile != kQT || db_tile % kTN != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || Np <= 0) return 0;
  dim3 grid(Np / kQT, B);
  spfh_kernel<<<grid, kQT, 0, stream>>>(amat, dbmat, base, nt, hist, cnt, Np,
                                        db_tile, r2);
  return (int)cudaGetLastError();
}

// s33 [B,Np,33] (K2's hist) -> out [B,Np,33]. Same tile rules as pct_spfh.
extern "C" int pct_wsum(const float* amat, const float* dbmat, const int* base,
                        const int* nt, const float* s33, float* out, int B,
                        int Np, int q_tile, int db_tile, float r2,
                        cudaStream_t stream) {
  if (q_tile != kQT || db_tile % kTN != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || Np <= 0) return 0;
  dim3 grid(Np / kQT, B);
  wsum_kernel<<<grid, kQT, 0, stream>>>(amat, dbmat, base, nt, s33, out, Np,
                                        db_tile, r2);
  return (int)cudaGetLastError();
}
