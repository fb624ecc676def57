// K6 banded_nn, K7 banded_moments, K8 banded_moments_v2: windowed
// (axis-sorted) 1-NN and fused ICP association + 4x4 moments.
//
// Replaces the TPU kernels of pctpu/ops/pallas_banded.py:
//   K6 _banded_kernel (:104, launched by nearest_banded :165),
//   K7 _moments_kernel (:179, icp_moments_banded :299),
//   K8 _moments_kernel_v2 (:321, icp_moments_banded_v2 :433).
// On the TPU, K7 and K8 carry the 4x4 moment sum across a sequential grid
// of query tiles.
//
// What they compute, per query tile of `tq` queries, against the db window
// [base, base + wb) blocks of `block` sorted columns:
//   K6: for each query the sorted column minimising
//       d2 = dx*dx + dy*dy + dz*dz + pen (in that order), scanning the
//       window in ascending column order with a strict '<' (the lowest
//       column wins a tie, an earlier block wins across blocks); (1e30, 0)
//       when nothing beats 1e30. `base` comes from the wrapper
//       (_tile_offsets).
//   K7: the query is already transformed; d2' = pen2 - 2 ((x bx + y by) +
//       z bz); inside a block the coordinates of every column tied at the
//       block's minimum are summed with their count (the db's ones row), a
//       strict '<' decides across blocks, the matched point is
//       sum / max(count, 1); the gate is (minv + |q|^2) + qpen < thresh^2;
//       and the tile's 16 moments sum w [q;1]_a [matched;1]_b.
//   K8: as K7, but the tile is transformed inside the kernel,
//       ((r0 x + r1 y) + r2 z) + t, and the window base comes from the
//       tile's transformed centre: clip(lut[bin] // block - wb // 2, 0,
//       nb - wb), bin = clip(trunc((v - lo) / max(hi - lo, 1e-12) * 1024),
//       0, 1024). (Not K4's base formula.)
// K7 and K8 sum each tile's moments in f64 (the products of two f32 are
// exact there) and write one [16] f64 partial per tile; the wrapper sums
// the partials in f64 and rounds once to f32. The file is compiled with
// --fmad=false, so every product and sum rounds where the plain PyTorch
// versions round.
//
// Bound on an H100: operations. Each (query, window column) pair costs 3
// multiplies, 2-3 adds and a compare (K6: 3 subtracts more) at the FP32
// CUDA-core rate; the inputs are read once per tile from L2.
//
// Design (a first, simple one): Hopper has no sequential grid, so each
// query tile is one CTA (grid = number of tiles, 256 threads): the kernels
// fill the card when there are more than 132 tiles. Each thread holds 2
// queries in registers; the window streams through shared memory in
// chunks of 2048 columns, structure-of-arrays, so every thread of a warp
// reads the same word (a broadcast). K7/K8 reduce the 16 moments in a
// fixed order (warp shuffles, then the warps' sums in warp order) with no
// atomics, so a run is deterministic and the cross-tile sum happens once,
// in the wrapper.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQ = 2;          // queries per thread per pass
constexpr int kChunk = 2048;   // db columns per shared-memory chunk
constexpr int kLutBins = 1024;
constexpr float kBig = 1e30f;

// ---- K6 -------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
banded_nn_kernel(const float* __restrict__ q, const float* __restrict__ dbt,
                 const float* __restrict__ pen,
                 const int* __restrict__ offsets, float* __restrict__ d2_out,
                 int* __restrict__ idx_out, int Np, int block, int wb,
                 int tq) {
  __shared__ float sx[kChunk], sy[kChunk], sz[kChunk], sp[kChunk];
  const int tile = blockIdx.x, tid = threadIdx.x;
  const int base = offsets[tile];
  for (int p0 = 0; p0 < tq; p0 += kThreads * kQ) {
    float qx[kQ], qy[kQ], qz[kQ], best[kQ];
    int bi[kQ];
    bool live[kQ];
#pragma unroll
    for (int s = 0; s < kQ; ++s) {
      const int qi = p0 + s * kThreads + tid;
      live[s] = qi < tq;
      const size_t row = (size_t)tile * tq + (live[s] ? qi : 0);
      qx[s] = q[row * 3];
      qy[s] = q[row * 3 + 1];
      qz[s] = q[row * 3 + 2];
      best[s] = kBig;
      bi[s] = 0;
    }
    for (int j = 0; j < wb; ++j) {
      const int start = (base + j) * block;
      for (int off = 0; off < block; off += kChunk) {
        const int len = min(kChunk, block - off);
        __syncthreads();
        for (int c = tid; c < len; c += kThreads) {
          const int g = start + off + c;
          sx[c] = dbt[g];
          sy[c] = dbt[Np + g];
          sz[c] = dbt[2 * Np + g];
          sp[c] = pen[g];
        }
        __syncthreads();
        for (int c = 0; c < len; ++c) {
          const float x = sx[c], y = sy[c], z = sz[c], p = sp[c];
#pragma unroll
          for (int s = 0; s < kQ; ++s) {
            const float dx = qx[s] - x, dy = qy[s] - y, dz = qz[s] - z;
            const float d2 = ((dx * dx + dy * dy) + dz * dz) + p;
            if (d2 < best[s]) {   // strict, ascending: the lowest column wins
              best[s] = d2;
              bi[s] = start + off + c;
            }
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kQ; ++s) {
      if (!live[s]) continue;
      const size_t row = (size_t)tile * tq + p0 + s * kThreads + tid;
      d2_out[row] = best[s];
      idx_out[row] = bi[s];
    }
  }
}

// ---- K7 / K8 shared association + moments ----------------------------------

struct Window {
  float x[kChunk], y[kChunk], z[kChunk], one[kChunk], p2[kChunk];
};

// One pass of kQ queries per thread (already transformed): associate each
// live query in the window and add its gated moments to m (f64).
__device__ void window_moments(const float (&xt)[kQ], const float (&yt)[kQ],
                               const float (&zt)[kQ], const float (&qp)[kQ],
                               const bool (&live)[kQ],
                               const float* __restrict__ dbt4,
                               const float* __restrict__ pen2, int Np,
                               int base, int block, int wb, float thresh2,
                               Window& w, double (&m)[16]) {
  const int tid = threadIdx.x;
  float minv[kQ], mx[kQ], my[kQ], mz[kQ], mc[kQ];
#pragma unroll
  for (int s = 0; s < kQ; ++s) {
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
        w.x[c] = dbt4[g];
        w.y[c] = dbt4[Np + g];
        w.z[c] = dbt4[2 * Np + g];
        w.one[c] = dbt4[3 * Np + g];
        w.p2[c] = pen2[g];
      }
      __syncthreads();
      for (int c = 0; c < len; ++c) {
        const float x = w.x[c], y = w.y[c], z = w.z[c], p2 = w.p2[c];
#pragma unroll
        for (int s = 0; s < kQ; ++s) {
          const float cross = (xt[s] * x + yt[s] * y) + zt[s] * z;
          const float d2 = p2 - 2.0f * cross;
          if (d2 < bmin[s]) {
            bmin[s] = d2;
            bx[s] = x;
            by[s] = y;
            bz[s] = z;
            bc[s] = w.one[c];
          } else if (d2 == bmin[s]) {   // tie: average the block's ties
            bx[s] += x;
            by[s] += y;
            bz[s] += z;
            bc[s] += w.one[c];
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
    const float qn = (xt[s] * xt[s] + yt[s] * yt[s]) + zt[s] * zt[s];
    const float wt = ((minv[s] + qn) + qp[s]) < thresh2 ? 1.f : 0.f;
    const float hp[4] = {xt[s] * wt, yt[s] * wt, zt[s] * wt, wt};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        m[a * 4 + c] += (double)hp[a] * (double)hq[c];
  }
}

// Fixed-order CTA reduction of the 16 f64 moments into out[16].
__device__ void reduce_moments(double (&m)[16], double* __restrict__ out) {
  __shared__ double red[kWarps][16];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    double v = m[e];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp][e] = v;
  }
  __syncthreads();
  if (tid < 16) {
    double s = 0.0;
    for (int wi = 0; wi < kWarps; ++wi) s += red[wi][tid];
    out[tid] = s;
  }
}

// ---- K7 -------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
banded_moments_kernel(const float* __restrict__ q,
                      const float* __restrict__ qpen,
                      const float* __restrict__ dbt4,
                      const float* __restrict__ pen2,
                      const int* __restrict__ offsets,
                      double* __restrict__ out, int Np, int block, int wb,
                      int tq, float thresh2) {
  __shared__ Window w;
  const int tile = blockIdx.x, tid = threadIdx.x;
  const int base = offsets[tile];
  double m[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) m[e] = 0.0;
  for (int p0 = 0; p0 < tq; p0 += kThreads * kQ) {
    float xt[kQ], yt[kQ], zt[kQ], qp[kQ];
    bool live[kQ];
#pragma unroll
    for (int s = 0; s < kQ; ++s) {
      const int qi = p0 + s * kThreads + tid;
      live[s] = qi < tq;
      const size_t row = (size_t)tile * tq + (live[s] ? qi : 0);
      xt[s] = q[row * 3];
      yt[s] = q[row * 3 + 1];
      zt[s] = q[row * 3 + 2];
      qp[s] = qpen[row];
    }
    window_moments(xt, yt, zt, qp, live, dbt4, pen2, Np, base, block, wb,
                   thresh2, w, m);
  }
  reduce_moments(m, out + (size_t)tile * 16);
}

// ---- K8 -------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
banded_moments_v2_kernel(const float* __restrict__ scal,
                         const int* __restrict__ lut,
                         const float* __restrict__ centers,
                         const float* __restrict__ src3,
                         const float* __restrict__ spen,
                         const float* __restrict__ dbt4,
                         const float* __restrict__ pen2t,
                         double* __restrict__ out, int Mp, int Np, int block,
                         int wb, int tq, float thresh2) {
  __shared__ Window w;
  const int tile = blockIdx.x, tid = threadIdx.x;
  const float r00 = scal[0], r01 = scal[1], r02 = scal[2];
  const float r10 = scal[3], r11 = scal[4], r12 = scal[5];
  const float r20 = scal[6], r21 = scal[7], r22 = scal[8];
  const float t0 = scal[9], t1 = scal[10], t2 = scal[11];
  const float lo = scal[12], hi = scal[13], axf = scal[14];

  // window base from the tile's TRANSFORMED centre (reference :332-343)
  const float c0 = centers[3 * tile], c1 = centers[3 * tile + 1],
              c2 = centers[3 * tile + 2];
  const float cx = r00 * c0 + r01 * c1 + r02 * c2 + t0;
  const float cy = r10 * c0 + r11 * c1 + r12 * c2 + t1;
  const float cz = r20 * c0 + r21 * c1 + r22 * c2 + t2;
  const float val = axf < 0.5f ? cx : (axf < 1.5f ? cy : cz);
  const float binf = (val - lo) / fmaxf(hi - lo, 1e-12f) * (float)kLutBins;
  const int bin = (int)fminf(fmaxf(binf, 0.f), (float)kLutBins);
  const int nb = Np / block;
  const int base = min(max(lut[bin] / block - wb / 2, 0), nb - wb);

  double m[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) m[e] = 0.0;
  for (int p0 = 0; p0 < tq; p0 += kThreads * kQ) {
    float xt[kQ], yt[kQ], zt[kQ], qp[kQ];
    bool live[kQ];
#pragma unroll
    for (int s = 0; s < kQ; ++s) {
      const int qi = p0 + s * kThreads + tid;
      live[s] = qi < tq;
      const int col = tile * tq + (live[s] ? qi : 0);
      const float x = src3[col], y = src3[Mp + col], z = src3[2 * Mp + col];
      xt[s] = r00 * x + r01 * y + r02 * z + t0;
      yt[s] = r10 * x + r11 * y + r12 * z + t1;
      zt[s] = r20 * x + r21 * y + r22 * z + t2;
      qp[s] = spen[col];
    }
    window_moments(xt, yt, zt, qp, live, dbt4, pen2t, Np, base, block, wb,
                   thresh2, w, m);
  }
  reduce_moments(m, out + (size_t)tile * 16);
}

bool bad_tiling(int Mp, int Np, int block, int wb, int tq) {
  return block <= 0 || tq <= 0 || Np % block != 0 || Mp % tq != 0 || wb < 1
         || wb > Np / block;
}

}  // namespace

// q [Mp,3], dbt [3,Np], pen [Np], offsets [Mp/tq] i32 -> d2 [Mp] f32,
// idx [Mp] i32 (sorted column).
extern "C" int pct_banded_nn(const float* q, const float* dbt,
                             const float* pen, const int* offsets, float* d2,
                             int* idx, int Mp, int Np, int block, int wb,
                             int tq, cudaStream_t stream) {
  if (bad_tiling(Mp, Np, block, wb, tq)) return (int)cudaErrorInvalidValue;
  if (Mp == 0) return 0;
  banded_nn_kernel<<<Mp / tq, kThreads, 0, stream>>>(q, dbt, pen, offsets, d2,
                                                     idx, Np, block, wb, tq);
  return (int)cudaGetLastError();
}

// q [Mp,3] transformed, qpen [Mp], dbt4 [4,Np], pen2 [Np], offsets [Mp/tq]
// i32 -> out [Mp/tq,16] f64 per-tile moments.
extern "C" int pct_banded_moments(const float* q, const float* qpen,
                                  const float* dbt4, const float* pen2,
                                  const int* offsets, double* out, int Mp,
                                  int Np, int block, int wb, int tq,
                                  float thresh2, cudaStream_t stream) {
  if (bad_tiling(Mp, Np, block, wb, tq)) return (int)cudaErrorInvalidValue;
  if (Mp == 0) return 0;
  banded_moments_kernel<<<Mp / tq, kThreads, 0, stream>>>(
      q, qpen, dbt4, pen2, offsets, out, Np, block, wb, tq, thresh2);
  return (int)cudaGetLastError();
}

// scal [16] (R row-major, t, lo, hi, axis, 0), lut [1025] i32,
// centers [3*Mp/tq], src3 [3,Mp], spen [Mp], dbt4 [4,Np], pen2t [Np]
// -> out [Mp/tq,16] f64 per-tile moments.
extern "C" int pct_banded_moments_v2(const float* scal, const int* lut,
                                     const float* centers, const float* src3,
                                     const float* spen, const float* dbt4,
                                     const float* pen2t, double* out, int Mp,
                                     int Np, int block, int wb, int tq,
                                     float thresh2, cudaStream_t stream) {
  if (bad_tiling(Mp, Np, block, wb, tq)) return (int)cudaErrorInvalidValue;
  if (Mp == 0) return 0;
  banded_moments_v2_kernel<<<Mp / tq, kThreads, 0, stream>>>(
      scal, lut, centers, src3, spen, dbt4, pen2t, out, Mp, Np, block, wb, tq,
      thresh2);
  return (int)cudaGetLastError();
}
