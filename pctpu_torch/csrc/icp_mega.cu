// K4 / kernel 5 icp_mega: every fixed ICP iteration of a pair sweep (or of
// one pair) in one launch, spread over the whole card.
//
// Replaces the TPU kernels pctpu/ops/pallas_icp_mega.py:
// _icp_mega_kernel_batch (K4, launched by icp_mega_batch :422) and
// _icp_mega_kernel (kernel 5, launched by icp_mega :355), thin wrappers
// over one body, _mega_body :174-294, whose sequential (B, iters, ntiles)
// or (iters, ntiles) grid carries the pose and the 4x4 moments in scratch
// memory from one grid step to the next. Kernel 5 is this entry with
// B = 1.
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
// in f32 in an unspecified order; an f64 sum of the exact f32 products
// makes the f32 moments, and so every later iteration, independent of the
// summation order, which keeps kernel and plain version on one
// trajectory). Then Procrustes in scalars (a line-for-line transcription
// of _s_procrustes_from_moments / _s_rotation_polar3: 6 Newton-polar
// steps, 12 cubic-Newton steps, the adjugate reflection flip), composed
// into the pose unless fewer than 3 correspondences passed the gate. The
// file is compiled with --fmad=false, so every product and sum rounds
// where the plain PyTorch version rounds.
//
// Bound on an H100: FP32 operations, about 8 per (query, window column)
// pair and iteration (the d2 dot: 3 mul + 3 add, the compare, the rare tie
// update); the inputs (a few MB) stay in L2.
//
// Design. One persistent cooperative launch (grid no larger than the CTAs
// the card holds at once, so a CTA may wait on another). A work UNIT is
// (pair, query tile, query slice); the CTAs stride over all units of all
// pairs, every iteration. What it does about the four limits of the first
// design (one CTA per pair, 512 x 4 query slots, scalar staging, a serial
// solve):
//  1. Spread: the wrapper (ops/pallas_icp_mega.py:unit_plan) picks LANES,
//     the lanes that share one query (1..32), so that a launch has at
//     least three units per SM where the shape allows; each lane scans
//     every LANES-th column of the window and the lanes of a query combine
//     (min, tie sums, count) by xor shuffles at every db block's end, so
//     equal minima still add within a block and a strict '<' keeps the
//     earlier block. All lanes of a group end with identical bits
//     (IEEE addition commutes).
//  2. Live slots: a unit holds 256 x 2 / LANES queries, and LANES is
//     first raised until that divides query_tile, so no thread holds a
//     dead query slot (for a power-of-two tile of at least 16).
//  3. Overlap: the window streams through a two-slot ring of 1,024-point
//     chunks in shared memory (x, y, z, pen2 as one float4, the ones row
//     beside it; 40 KB in all, so 4 CTAs fit an SM) loaded with cp.async:
//     chunk j + 1 is in flight while chunk j is compared. A window that
//     fits one chunk overlaps with the other CTAs on its SM instead.
//  4. Solve: each unit writes its 16 f64 moment partials (fixed-order CTA
//     reduction) to scratch [B, units per pair, 16]; the last unit of a
//     pair to finish (an atomic count per pair, after a thread fence) sums
//     the pair's partials in a fixed order, rounds once to f32, solves
//     Procrustes, writes the pose and releases the pair's version k + 1.
//     A unit of iteration k + 1 acquires that version before it reads the
//     pose: one CTA per pair solves, no grid barrier separates the
//     iterations, and pairs run ahead of one another. Partials, counts and
//     poses need one buffer each: the last unit reads the partials and
//     writes the pose only after every unit of its pair has read the pose
//     and written its partial, and the next writes wait for the version.
//     Every CTA finishes its iteration-k units before it waits for a
//     version k + 1, so by induction on k no wait lasts forever. A run is
//     deterministic.
// The kernel allocates nothing: the wrapper passes the scratch. A refused
// cooperative launch (too many CTAs) returns its error code.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQ = 2;            // queries per thread (per lane group)
constexpr int kChunk = 1024;     // db points per ring slot
constexpr int kMinBlocks = 4;    // CTAs per SM the registers are sized for
constexpr int kRedBatch = 16;    // partial loads in flight per thread
constexpr int kLutBins = 1024;
constexpr float kBig = 1e30f;

struct MegaArgs {
  const float* dbt5;     // [B,5,Np] x, y, z, pen2, ones
  const float* src3;     // [B,3,Mp]
  const float* spen;     // [B,Mp]
  const int* lut;        // [B,lut_len]
  const float* centers;  // [B,3*ntiles]
  const float* scal;     // [B,16] R row-major, t, lo, hi, axis, 0
  float* out;            // [B,16] R, t, zeros
  double* part;          // [B,upp,16] scratch: each unit's moments
  float* poses;          // [B,12] scratch: the running iteration's pose
  unsigned* cnt;         // [B] scratch: units of the pair done this iteration
  unsigned* ver;         // [B] scratch: iterations of the pair solved
  int B, Np, Mp, block, wb, tq, iters, newton_iters, lut_len, lanes;
  float thresh2;
};

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

// ---- staging: cp.async into the ring ------------------------------------

__device__ __forceinline__ void cp_async4(void* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- a pair's pose version: released by its solver, acquired by its units

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// db columns [g0, g0 + len) of one pair's SoA rows -> one ring slot
__device__ void stage(float4* s4, float* s1, const float* db, int Np, int g0,
                      int len) {
  for (int c = threadIdx.x; c < len; c += kThreads) {
    const float* p = db + g0 + c;
    cp_async4(&s4[c].x, p);
    cp_async4(&s4[c].y, p + Np);
    cp_async4(&s4[c].z, p + 2 * Np);
    cp_async4(&s4[c].w, p + 3 * Np);
    cp_async4(&s1[c], p + 4 * Np);
  }
  cp_async_commit();
}

// ---- the kernel ---------------------------------------------------------

__global__ void __launch_bounds__(kThreads, kMinBlocks)
icp_mega_kernel(const MegaArgs a) {
  __shared__ float4 s4[2][kChunk];
  __shared__ float s1[2][kChunk];
  __shared__ double red[kThreads / 16][16];   // >= kWarps rows
  __shared__ float pose[12];
  __shared__ float msum[16];
  __shared__ int is_last;

  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = a.lanes, sub = tid % L, grp = tid / L;
  const int ngrp = kThreads / L, S = ngrp * kQ;      // queries per unit
  const int spt = (a.tq + S - 1) / S, ntiles = a.Mp / a.tq;
  const int upp = ntiles * spt, units = a.B * upp;
  const int nb = a.Np / a.block, W = a.wb * a.block;
  const int nch = (W + kChunk - 1) / kChunk;
  const float inf = __int_as_float(0x7f800000);

  // set-up: each pair's pose from scal, its count and version 0
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    if (tid < 12) a.poses[b * 12 + tid] = a.scal[b * 16 + tid];
    if (tid < 16 && a.iters == 0)
      a.out[b * 16 + tid] = tid < 12 ? a.scal[b * 16 + tid] : 0.f;
    if (tid == 0) a.cnt[b] = a.ver[b] = 0u;
  }
  grid.sync();

  for (int k = 0; k < a.iters; ++k) {
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int b = u / upp, ul = u - b * upp;
      const int tile = ul / spt, q0 = (ul - tile * spt) * S;
      const float* db = a.dbt5 + (size_t)b * 5 * a.Np;
      const float* src = a.src3 + (size_t)b * 3 * a.Mp;
      const float* qpen = a.spen + (size_t)b * a.Mp;
      const float* sc = a.scal + (size_t)b * 16;
      const float* cen = a.centers + (size_t)b * 3 * ntiles + 3 * tile;
      // what does not wait for the pose is loaded first
      const float c0 = cen[0], c1 = cen[1], c2 = cen[2];
      const float lo = sc[12], hi = sc[13], axf = sc[14];
      float a0[kQ], a1[kQ], a2[kQ];
#pragma unroll
      for (int s = 0; s < kQ; ++s) {
        const int qi = q0 + s * ngrp + grp;
        const int col = tile * a.tq + (qi < a.tq ? qi : 0);
        a0[s] = src[col];
        a1[s] = src[a.Mp + col];
        a2[s] = src[2 * a.Mp + col];
      }
      if (tid == 0)   // wait until iteration k's pose of the pair is out
        while (ld_acquire(a.ver + b) < (unsigned)k) __nanosleep(32);
      __syncthreads();   // ... and the previous unit is done with smem
      if (tid < 12) pose[tid] = __ldcg(a.poses + b * 12 + tid);
      __syncthreads();
      const float r00 = pose[0], r01 = pose[1], r02 = pose[2];
      const float r10 = pose[3], r11 = pose[4], r12 = pose[5];
      const float r20 = pose[6], r21 = pose[7], r22 = pose[8];
      const float t0 = pose[9], t1 = pose[10], t2 = pose[11];

      // window base from the tile's TRANSFORMED centre (reference :202-218)
      const float cx = r00 * c0 + r01 * c1 + r02 * c2 + t0;
      const float cy = r10 * c0 + r11 * c1 + r12 * c2 + t1;
      const float cz = r20 * c0 + r21 * c1 + r22 * c2 + t2;
      const float val = axf < 0.5f ? cx : (axf < 1.5f ? cy : cz);
      const float binf =
          (val - lo) / fmaxf(hi - lo, 1e-12f) * (float)kLutBins;
      const int bin = (int)fminf(fmaxf(binf, 0.f), (float)kLutBins);
      const int pos = a.lut[(size_t)b * a.lut_len + bin];
      int base = floordiv(pos - (a.wb * a.block) / 2 + a.block / 2, a.block);
      base = min(max(base, 0), nb - a.wb);
      const int g0 = base * a.block;
      stage(s4[0], s1[0], db, a.Np, g0, min(kChunk, W));

      // a = -2 q for the transformed query q (so q = -0.5 a, exactly)
      float minv[kQ], mx[kQ], my[kQ], mz[kQ], mc[kQ];
      float bmin[kQ], bx[kQ], by[kQ], bz[kQ], bc[kQ];
#pragma unroll
      for (int s = 0; s < kQ; ++s) {
        const float q0_ = a0[s], q1_ = a1[s], q2_ = a2[s];
        a0[s] = -2.0f * (r00 * q0_ + r01 * q1_ + r02 * q2_ + t0);
        a1[s] = -2.0f * (r10 * q0_ + r11 * q1_ + r12 * q2_ + t1);
        a2[s] = -2.0f * (r20 * q0_ + r21 * q1_ + r22 * q2_ + t2);
        minv[s] = kBig;
        mx[s] = my[s] = mz[s] = 0.f;
        mc[s] = 1.f;
        bmin[s] = inf;
        bx[s] = by[s] = bz[s] = bc[s] = 0.f;
      }

      for (int ch = 0; ch < nch; ++ch) {
        const int buf = ch & 1, c_lo = ch * kChunk;
        const int c_hi = min(W, c_lo + kChunk);
        if (ch + 1 < nch) {   // the next chunk flies while this one runs
          stage(s4[buf ^ 1], s1[buf ^ 1], db, a.Np, g0 + c_hi,
                min(kChunk, W - c_hi));
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        const float4* p4 = s4[buf];
        const float* p1 = s1[buf];
        for (int cb = c_lo; cb < c_hi;) {
          const int bend = min(c_hi, (cb / a.block + 1) * a.block);
#pragma unroll 4
          for (int c = cb + sub; c < bend; c += L) {
            const float4 p = p4[c - c_lo];
#pragma unroll
            for (int s = 0; s < kQ; ++s) {
              const float d2 = ((p.x * a0[s] + p.y * a1[s]) + p.z * a2[s])
                               + p.w;
              if (d2 <= bmin[s]) {
                const float o = p1[c - c_lo];
                if (d2 < bmin[s]) {
                  bmin[s] = d2;
                  bx[s] = p.x;
                  by[s] = p.y;
                  bz[s] = p.z;
                  bc[s] = o;
                } else {   // tie: average the block's ties
                  bx[s] += p.x;
                  by[s] += p.y;
                  bz[s] += p.z;
                  bc[s] += o;
                }
              }
            }
          }
          if (bend % a.block == 0) {   // a db block ends
#pragma unroll
            for (int s = 0; s < kQ; ++s) {
              for (int o = L >> 1; o > 0; o >>= 1) {   // its lanes combine
                const float om = __shfl_xor_sync(0xffffffffu, bmin[s], o);
                const float ox = __shfl_xor_sync(0xffffffffu, bx[s], o);
                const float oy = __shfl_xor_sync(0xffffffffu, by[s], o);
                const float oz = __shfl_xor_sync(0xffffffffu, bz[s], o);
                const float oc = __shfl_xor_sync(0xffffffffu, bc[s], o);
                if (om < bmin[s]) {
                  bmin[s] = om;
                  bx[s] = ox;
                  by[s] = oy;
                  bz[s] = oz;
                  bc[s] = oc;
                } else if (om == bmin[s]) {
                  bx[s] += ox;
                  by[s] += oy;
                  bz[s] += oz;
                  bc[s] += oc;
                }
              }
              if (bmin[s] < minv[s]) {   // strict: an earlier block wins
                minv[s] = bmin[s];
                mx[s] = bx[s];
                my[s] = by[s];
                mz[s] = bz[s];
                mc[s] = bc[s];
              }
              bmin[s] = inf;
              bx[s] = by[s] = bz[s] = bc[s] = 0.f;
            }
          }
          cb = bend;
        }
        __syncthreads();   // this slot is refilled two chunks on
      }

      // the unit's moments (lane 0 of each group), f64, in a fixed order
      float hp[kQ][4], hq[kQ][4];
#pragma unroll
      for (int s = 0; s < kQ; ++s) {
        const int qi = q0 + s * ngrp + grp;
        const bool on = qi < a.tq && sub == 0;
        const float xt = -0.5f * a0[s], yt = -0.5f * a1[s],
                    zt = -0.5f * a2[s];
        const float qn = xt * xt + yt * yt + zt * zt;
        const float qp = qpen[tile * a.tq + (on ? qi : 0)];
        const float cnt = fmaxf(mc[s], 1.f);
        const float w = on && ((minv[s] + qn) + qp) < a.thresh2 ? 1.f : 0.f;
        hq[s][0] = mx[s] / cnt;
        hq[s][1] = my[s] / cnt;
        hq[s][2] = mz[s] / cnt;
        hq[s][3] = 1.f;
        hp[s][0] = xt * w;
        hp[s][1] = yt * w;
        hp[s][2] = zt * w;
        hp[s][3] = w;
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        double v = 0.0;
#pragma unroll
        for (int s = 0; s < kQ; ++s)
          v += (double)hp[s][e / 4] * (double)hq[s][e % 4];
        for (int o = 16; o > 0; o >>= 1)
          v += __shfl_down_sync(0xffffffffu, v, o);
        if (lane == 0) red[warp][e] = v;
      }
      __syncthreads();
      if (tid < 16) {
        double v = 0.0;
        for (int w = 0; w < kWarps; ++w) v += red[w][tid];
        a.part[((size_t)b * upp + ul) * 16 + tid] = v;
        __threadfence();
      }
      __syncthreads();
      if (tid == 0)
        is_last = atomicAdd(a.cnt + b, 1u) == (unsigned)(upp - 1);
      __syncthreads();
      if (!is_last) continue;

      // the pair's last unit: its moments in a fixed order, then the solve
      __threadfence();
      {   // thread t: moment t % 16 over units t / 16, t / 16 + 16, ...,
          // kRedBatch loads in flight at a time
        const int e = tid & 15, j = tid >> 4;
        double v = 0.0;
        for (int i0 = j; i0 < upp; i0 += 16 * kRedBatch) {
          double x[kRedBatch];
#pragma unroll
          for (int r = 0; r < kRedBatch; ++r) {
            const int i = i0 + 16 * r;
            x[r] = i < upp ? __ldcg(a.part + ((size_t)b * upp + i) * 16 + e)
                           : 0.0;
          }
#pragma unroll
          for (int r = 0; r < kRedBatch; ++r) v += x[r];
        }
        red[j][e] = v;
      }
      __syncthreads();
      if (tid < 16) {
        double v = 0.0;
        for (int j = 0; j < kThreads / 16; ++j) v += red[j][tid];
        msum[tid] = (float)v;
      }
      __syncthreads();
      if (tid == 0) {
        float M[4][4];
        for (int e = 0; e < 16; ++e) M[e / 4][e % 4] = msum[e];
        float R[3][3], t[3], nxt[12];
        s_procrustes_from_moments(M, a.newton_iters, R, t);
        const float Told[3][3] = {{r00, r01, r02}, {r10, r11, r12},
                                  {r20, r21, r22}};
        const float told[3] = {t0, t1, t2};
        // degenerate-iteration guard: Procrustes needs >= 3 correspondences
        const bool ok = M[3][3] >= 3.0f;
        for (int r = 0; r < 3; ++r) {
          float rt = 0.f;
          for (int c = 0; c < 3; ++c) {
            float rn = 0.f;
            for (int q = 0; q < 3; ++q) rn = rn + R[r][q] * Told[q][c];
            nxt[3 * r + c] = ok ? rn : Told[r][c];
            rt = rt + R[r][c] * told[c];
          }
          nxt[9 + r] = ok ? rt + t[r] : told[r];
        }
        for (int e = 0; e < 12; ++e) a.poses[b * 12 + e] = nxt[e];
        if (k == a.iters - 1)
          for (int e = 0; e < 16; ++e)
            a.out[b * 16 + e] = e < 12 ? nxt[e] : 0.f;
        a.cnt[b] = 0u;
        __threadfence();
        st_release(a.ver + b, (unsigned)(k + 1));   // the pose is out
      }
    }
  }
}

}  // namespace

// The CTAs of icp_mega_kernel that `device` holds at once (the largest
// grid a cooperative launch takes) -> *ctas.
extern "C" int pct_icp_mega_capacity(int device, int* ctas) {
  int sms = 0, per_sm = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, icp_mega_kernel,
                                                    kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  *ctas = per_sm * sms;
  return 0;
}

// dbt5 [B,5,Np], src3 [B,3,Mp], spen [B,Mp], lut [B,lut_len] i32,
// centers [B,3*Mp/tq], scal [B,16] (R row-major, t, lo, hi, axis, 0)
// -> out [B,16] (R, t, zeros). Scratch: part [B,upp,16] f64, poses
// [B,12] f32, cnt and ver [B] u32, where upp = (Mp/tq) *
// ceil(tq / (256*2/lanes)).
// Needs Np % block == 0, Mp % tq == 0, 1 <= wb <= Np / block, lanes a
// power of two in [1, 32], 1 <= grid <= pct_icp_mega_capacity.
extern "C" int pct_icp_mega(const float* dbt5, const float* src3,
                            const float* spen, const int* lut,
                            const float* centers, const float* scal,
                            float* out, double* part, float* poses,
                            unsigned* cnt, unsigned* ver, int B, int Np,
                            int Mp, int block, int wb, int tq, int iters,
                            int newton_iters, int lut_len, int lanes, int grid,
                            float thresh2, cudaStream_t stream) {
  if (block <= 0 || tq <= 0 || Np % block != 0 || Mp % tq != 0 || wb < 1
      || wb > Np / block || lut_len != kLutBins + 1 || lanes < 1
      || lanes > 32 || (lanes & (lanes - 1)) != 0 || grid < 1 || iters < 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  MegaArgs a{dbt5, src3, spen, lut, centers, scal, out, part, poses, cnt,
             ver, B, Np, Mp, block, wb, tq, iters, newton_iters, lut_len,
             lanes, thresh2};
  void* params[] = {&a};
  return (int)cudaLaunchCooperativeKernel((const void*)icp_mega_kernel,
                                          dim3(grid), dim3(kThreads), params,
                                          0, stream);
}
