// K4 / kernel 5 icp_mega: every fixed ICP iteration of a pair sweep (or of
// one pair) in one launch.
//
// Replaces the TPU kernels pctpu/ops/pallas_icp_mega.py:
// _icp_mega_kernel_batch (K4, launched by icp_mega_batch :422) and
// _icp_mega_kernel (kernel 5, launched by icp_mega :355), thin wrappers
// over one body, _mega_body :174-294, whose sequential (B, iters, ntiles)
// or (iters, ntiles) grid carries the pose and the 4x4 moments in scratch
// memory from one grid step to the next. Kernel 5 is this entry with
// B = 1: one CTA.
//
// What it computes, per pair and iteration, for each query tile: the tile
// transformed by the current pose; the db window [base, base + wb) blocks
// from the tile's transformed centre through the bucket LUT; for each
// query the nearest db point of the window by d2 = pen2 - 2 b.q (fixed
// order ((x*a0 + y*a1) + z*a2) + pen2 with a = -2q), with the coordinates
// of all points tied at a block's minimum averaged (their count from the
// db's ones row) and a strict '<' across blocks; the gate
// minv + |q|^2 + qpen < thresh^2; and the 16 homogeneous moments of the
// gated pairs, summed in f64 and rounded once to f32 (the TPU kernel sums
// in f32 in an unspecified order; an f64 sum makes the f32 moments, and
// so every later iteration, independent of the summation order, which
// keeps kernel and plain version on one trajectory). After the last tile
// thread 0 solves Procrustes in scalars
// (a line-for-line transcription of _s_procrustes_from_moments /
// _s_rotation_polar3: 6 Newton-polar steps, 12 cubic-Newton steps, the
// adjugate reflection flip) and composes the pose unless fewer than 3
// correspondences passed the gate. The file is compiled with --fmad=false,
// so every product and sum rounds where the plain PyTorch version rounds.
//
// Bound on an H100: operations. About 10 FP32 operations per (query, db)
// pair and iteration; the inputs (under 1 MB per pair) stay in L2.
//
// Design (a first, simple one): Hopper has no sequential grid, so the
// TPU's grid becomes ONE CTA PER PAIR (grid (B,), 512 threads) with the
// iteration and query-tile loops inside the block; the pose lives in
// shared memory. Each thread holds up to 4 queries in registers, so every
// db point staged in shared memory (chunks of 2048 points, 40 KB) serves
// 4 queries. The 16 moments are reduced in a fixed order (warp shuffles,
// then the warps' partial sums in warp order), with no atomics, so a run
// is deterministic. At B = 16 only 16 of 132 SMs work; splitting a pair
// across CTAs (a cluster, or a second pass for the moments) is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kQ = 4;          // queries per thread per pass
constexpr int kChunk = 2048;   // db points per shared-memory chunk
constexpr int kLutBins = 1024;
constexpr float kBig = 1e30f;

// ---- scalar 3x3 algebra (reference pallas_icp_mega.py:47-167) ----------

__device__ void s_cross(const float* a, const float* b, float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ float s_dot(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ float s_fro2(const float M[3][3]) {
  float s = 0.f;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) s = s + M[i][j] * M[i][j];
  return s;
}

__device__ void s_inv_transpose(const float X[3][3], float out[3][3]) {
  float c[3][3];
  s_cross(X[1], X[2], c[0]);
  s_cross(X[2], X[0], c[1]);
  s_cross(X[0], X[1], c[2]);
  const float det = s_dot(X[0], c[0]);
  const float safe = fabsf(det) > 1e-30f ? det : 1e-30f;
  const float inv = 1.0f / safe;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) out[i][j] = c[i][j] * inv;
}

__device__ void s_rotation_polar3(const float H[3][3], int newton_iters,
                                  float R[3][3]) {
  const float fn = sqrtf(fmaxf(s_fro2(H), 1e-30f));
  float X[3][3], Hn[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) Hn[i][j] = X[i][j] = H[i][j] / fn;

  for (int it = 0; it < newton_iters; ++it) {
    float Xit[3][3];
    s_inv_transpose(X, Xit);
    const float g = sqrtf(sqrtf(s_fro2(Xit) / fmaxf(s_fro2(X), 1e-30f)));
    const float gi = 0.5f / g;
    const float gh = 0.5f * g;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) X[i][j] = gh * X[i][j] + gi * Xit[i][j];
  }

  float cr[3];
  s_cross(X[1], X[2], cr);
  const float d = s_dot(X[0], cr);

  float S0[3][3], S[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float s = 0.f;
      for (int k = 0; k < 3; ++k) s = s + X[k][i] * Hn[k][j];
      S0[i][j] = s;
    }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) S[i][j] = 0.5f * (S0[i][j] + S0[j][i]);

  const float a = S[0][0] + S[1][1] + S[2][2];
  const float b = S[0][0] * S[1][1] - S[0][1] * S[0][1] + S[0][0] * S[2][2]
                  - S[0][2] * S[0][2] + S[1][1] * S[2][2]
                  - S[1][2] * S[1][2];
  s_cross(S[1], S[2], cr);
  const float c = s_dot(S[0], cr);
  float lam = 0.f;
  for (int it = 0; it < 12; ++it) {
    const float f = ((lam - a) * lam + b) * lam - c;
    float fp = (3.0f * lam - 2.0f * a) * lam + b;
    fp = fabsf(fp) > 1e-30f ? fp : 1e-30f;
    lam = lam - f / fp;
  }

  float B2[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) B2[i][j] = i == j ? S[i][j] - lam : S[i][j];
  float a0[3], a1[3], a2[3];
  s_cross(B2[1], B2[2], a0);
  s_cross(B2[2], B2[0], a1);
  s_cross(B2[0], B2[1], a2);
  const float n0 = s_dot(a0, a0), n1 = s_dot(a1, a1), n2 = s_dot(a2, a2);
  const bool use0 = (n0 >= n1) && (n0 >= n2);
  const bool use1 = n1 >= n2;
  float v[3];
  for (int i = 0; i < 3; ++i) v[i] = use0 ? a0[i] : (use1 ? a1[i] : a2[i]);
  const float vn = sqrtf(fmaxf(s_dot(v, v), 1e-30f));
  for (int i = 0; i < 3; ++i) v[i] = v[i] / vn;

  const bool neg = d < 0.f;
  for (int i = 0; i < 3; ++i) {
    const float xv = s_dot(X[i], v);
    for (int j = 0; j < 3; ++j)
      R[i][j] = neg ? X[i][j] - 2.0f * xv * v[j] : X[i][j];
  }
}

// m[a][b] = sum w [p;1]_a [q;1]_b  ->  (R, t)
__device__ void s_procrustes_from_moments(const float m[4][4],
                                          int newton_iters, float R[3][3],
                                          float t[3]) {
  const float sw = fmaxf(m[3][3], 1e-12f);
  const float inv_sw = 1.0f / sw;
  const float sp[3] = {m[0][3], m[1][3], m[2][3]};
  const float sq[3] = {m[3][0], m[3][1], m[3][2]};
  float H[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) H[i][j] = m[j][i] - sq[i] * sp[j] * inv_sw;
  s_rotation_polar3(H, newton_iters, R);
  float src_c[3], dst_c[3];
  for (int i = 0; i < 3; ++i) {
    src_c[i] = sp[i] * inv_sw;
    dst_c[i] = sq[i] * inv_sw;
  }
  for (int i = 0; i < 3; ++i) {
    float rs = 0.f;
    for (int k = 0; k < 3; ++k) rs = rs + R[i][k] * src_c[k];
    t[i] = dst_c[i] - rs;
  }
}

// Python floor division for a possibly negative numerator
__device__ __forceinline__ int floordiv(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// ---- the kernel ---------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
icp_mega_kernel(const float* __restrict__ dbt5, const float* __restrict__ src3,
                const float* __restrict__ spen, const int* __restrict__ lut,
                const float* __restrict__ centers,
                const float* __restrict__ scal, float* __restrict__ out,
                int Np, int Mp, int block, int wb, int tq, int iters,
                int newton_iters, int lut_len, float thresh2) {
  __shared__ float sx[kChunk], sy[kChunk], sz[kChunk], sp2[kChunk],
      so[kChunk];
  __shared__ float pose[12];
  __shared__ double red[kWarps][16];

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int nb = Np / block, ntiles = Mp / tq;
  const float* db = dbt5 + (size_t)b * 5 * Np;
  const float* src = src3 + (size_t)b * 3 * Mp;
  const float* qpen = spen + (size_t)b * Mp;
  const int* lutb = lut + (size_t)b * lut_len;
  const float* cen = centers + (size_t)b * 3 * ntiles;
  const float* sc = scal + (size_t)b * 16;
  const float lo = sc[12], hi = sc[13], axf = sc[14];
  if (tid < 12) pose[tid] = sc[tid];
  __syncthreads();

  for (int k = 0; k < iters; ++k) {
    const float r00 = pose[0], r01 = pose[1], r02 = pose[2];
    const float r10 = pose[3], r11 = pose[4], r12 = pose[5];
    const float r20 = pose[6], r21 = pose[7], r22 = pose[8];
    const float t0 = pose[9], t1 = pose[10], t2 = pose[11];
    double m[16];   // f64 sums: exact products, order-independent to f32
#pragma unroll
    for (int e = 0; e < 16; ++e) m[e] = 0.0;

    for (int i = 0; i < ntiles; ++i) {
      // window base from the tile's TRANSFORMED centre (reference :202-218)
      const float c0 = cen[3 * i], c1 = cen[3 * i + 1], c2 = cen[3 * i + 2];
      const float cx = r00 * c0 + r01 * c1 + r02 * c2 + t0;
      const float cy = r10 * c0 + r11 * c1 + r12 * c2 + t1;
      const float cz = r20 * c0 + r21 * c1 + r22 * c2 + t2;
      const float val = axf < 0.5f ? cx : (axf < 1.5f ? cy : cz);
      const float binf = (val - lo) / fmaxf(hi - lo, 1e-12f) * (float)kLutBins;
      const int bin = (int)fminf(fmaxf(binf, 0.f), (float)kLutBins);
      const int pos = lutb[bin];
      int base = floordiv(pos - (wb * block) / 2 + block / 2, block);
      base = min(max(base, 0), nb - wb);

      for (int p0 = 0; p0 < tq; p0 += kThreads * kQ) {
        float a0[kQ], a1[kQ], a2[kQ], xt[kQ], yt[kQ], zt[kQ], qn[kQ], qp[kQ];
        float minv[kQ], mx[kQ], my[kQ], mz[kQ], mc[kQ];
        bool live[kQ];
#pragma unroll
        for (int s = 0; s < kQ; ++s) {
          const int qi = p0 + s * kThreads + tid;
          live[s] = qi < tq;
          const int col = i * tq + (live[s] ? qi : 0);
          const float q0 = src[col], q1 = src[Mp + col], q2 = src[2 * Mp + col];
          xt[s] = r00 * q0 + r01 * q1 + r02 * q2 + t0;
          yt[s] = r10 * q0 + r11 * q1 + r12 * q2 + t1;
          zt[s] = r20 * q0 + r21 * q1 + r22 * q2 + t2;
          qn[s] = xt[s] * xt[s] + yt[s] * yt[s] + zt[s] * zt[s];
          qp[s] = qpen[col];
          a0[s] = -2.0f * xt[s];
          a1[s] = -2.0f * yt[s];
          a2[s] = -2.0f * zt[s];
          minv[s] = kBig;
          mx[s] = my[s] = mz[s] = 0.f;
          mc[s] = 1.f;
        }
        for (int j = 0; j < wb; ++j) {
          const int start = (base + j) * block;
          float bmin[kQ], bx[kQ], by[kQ], bz[kQ], bc[kQ];
#pragma unroll
          for (int s = 0; s < kQ; ++s) {
            bmin[s] = __int_as_float(0x7f800000);   // +inf
            bx[s] = by[s] = bz[s] = bc[s] = 0.f;
          }
          for (int off = 0; off < block; off += kChunk) {
            const int len = min(kChunk, block - off);
            __syncthreads();
            for (int c = tid; c < len; c += kThreads) {
              const int g = start + off + c;
              sx[c] = db[g];
              sy[c] = db[Np + g];
              sz[c] = db[2 * Np + g];
              sp2[c] = db[3 * Np + g];
              so[c] = db[4 * Np + g];
            }
            __syncthreads();
            for (int c = 0; c < len; ++c) {
              const float x = sx[c], y = sy[c], z = sz[c], p2 = sp2[c];
#pragma unroll
              for (int s = 0; s < kQ; ++s) {
                const float d2 = ((x * a0[s] + y * a1[s]) + z * a2[s]) + p2;
                if (d2 < bmin[s]) {
                  bmin[s] = d2;
                  bx[s] = x;
                  by[s] = y;
                  bz[s] = z;
                  bc[s] = so[c];
                } else if (d2 == bmin[s]) {   // tie: average the block's ties
                  bx[s] += x;
                  by[s] += y;
                  bz[s] += z;
                  bc[s] += so[c];
                }
              }
            }
          }
#pragma unroll
          for (int s = 0; s < kQ; ++s)
            if (bmin[s] < minv[s]) {   // strict: an earlier block wins
              minv[s] = bmin[s];
              mx[s] = bx[s];
              my[s] = by[s];
              mz[s] = bz[s];
              mc[s] = bc[s];
            }
        }
#pragma unroll
        for (int s = 0; s < kQ; ++s) {
          if (!live[s]) continue;
          const float cnt = fmaxf(mc[s], 1.f);
          const float hq[4] = {mx[s] / cnt, my[s] / cnt, mz[s] / cnt, 1.f};
          const float w = ((minv[s] + qn[s]) + qp[s]) < thresh2 ? 1.f : 0.f;
          const float hp[4] = {xt[s] * w, yt[s] * w, zt[s] * w, w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              m[a * 4 + c] += (double)hp[a] * (double)hq[c];
        }
      }
    }

    // fixed-order block reduction of the 16 moments
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      double v = m[e];
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
      if (lane == 0) red[warp][e] = v;
    }
    __syncthreads();
    if (tid == 0) {
      float M[4][4];
      for (int e = 0; e < 16; ++e) {
        double s = 0.0;
        for (int w = 0; w < kWarps; ++w) s += red[w][e];
        M[e / 4][e % 4] = (float)s;
      }
      float R[3][3], t[3];
      s_procrustes_from_moments(M, newton_iters, R, t);
      const float Told[3][3] = {{r00, r01, r02}, {r10, r11, r12},
                                {r20, r21, r22}};
      const float told[3] = {t0, t1, t2};
      // degenerate-iteration guard: Procrustes needs >= 3 correspondences
      const bool ok = M[3][3] >= 3.0f;
      for (int a = 0; a < 3; ++a) {
        float rt = 0.f;
        for (int c = 0; c < 3; ++c) {
          float rn = 0.f;
          for (int q = 0; q < 3; ++q) rn = rn + R[a][q] * Told[q][c];
          pose[3 * a + c] = ok ? rn : Told[a][c];
          rt = rt + R[a][c] * told[c];
        }
        pose[9 + a] = ok ? rt + t[a] : told[a];
      }
    }
    __syncthreads();
  }
  if (tid < 16) out[(size_t)b * 16 + tid] = tid < 12 ? pose[tid] : 0.f;
}

}  // namespace

// dbt5 [B,5,Np], src3 [B,3,Mp], spen [B,Mp], lut [B,lut_len] i32,
// centers [B,3*Mp/tq], scal [B,16] (R row-major, t, lo, hi, axis, 0)
// -> out [B,16] (R, t, zeros). Needs Np % block == 0, Mp % tq == 0,
// 1 <= wb <= Np / block.
extern "C" int pct_icp_mega(const float* dbt5, const float* src3,
                            const float* spen, const int* lut,
                            const float* centers, const float* scal,
                            float* out, int B, int Np, int Mp, int block,
                            int wb, int tq, int iters, int newton_iters,
                            int lut_len, float thresh2, cudaStream_t stream) {
  if (block <= 0 || tq <= 0 || Np % block != 0 || Mp % tq != 0 || wb < 1
      || wb > Np / block || lut_len != kLutBins + 1)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  icp_mega_kernel<<<B, kThreads, 0, stream>>>(
      dbt5, src3, spen, lut, centers, scal, out, Np, Mp, block, wb, tq, iters,
      newton_iters, lut_len, thresh2);
  return (int)cudaGetLastError();
}
