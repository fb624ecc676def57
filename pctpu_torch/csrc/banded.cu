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
// K6 (redesigned on K7/K8's units, lanes and ring; its first design ran
// one 256-thread CTA per query tile, 32 CTAs on 132 SMs at P5's shape, 2
// queries a thread, a scalar shared load a coordinate and a branch per
// pair: 152 us a P5 launch): a unit is (tile, query slice), one CTA of
// 256 threads; `lanes` lanes share each of a thread's 4 queries
// (ops/pallas_banded.py:nearest_banded_plan: at least 3 units per SM where
// the shape allows, and 4 units an SM resident, so P5's 512 units run in
// one wave); the window streams through the two-slot cp.async ring as one
// float4 (x, y, z, pen) a column, so one shared load serves 4 queries;
// the scan is a compare and two selects a pair. Each lane scans every
// lanes-th column of the window in ascending order with a strict '<', so
// it keeps its minimum and the first of its columns at it; at the end the
// group's lanes take the lexicographic (d2, column) minimum by xor
// shuffles. That is the reference's rule (the lowest column wins a tie in
// a block, an earlier block across blocks: both say the lowest column at
// the window's minimum), and a lane that never beats 1e30 keeps (1e30, 0),
// so a query with nothing in reach still gets (1e30, 0).
//
// K7 and K8 share one body (banded_moments_kernel<kPosed>), redesigned on
// the whole-loop ICP kernel's (csrc/icp_mega.cu). Their first design ran
// one 256-thread CTA per tile (32 CTAs on 132 SMs at P5's shape), 2
// queries a thread and five scalar shared loads a column, and spent two
// thirds of its 472 us a launch in the shape of its tie branch
// (tools/fps_k8_sweep.py, H100 80GB HBM3, 700 W). They differ only where
// kPosed says: K8 (true) poses its tile inside the kernel and finds the
// window base from the LUT; K7 (false) reads its queries as given, rows
// of 3, and its window base from the wrapper's offsets. Otherwise:
//  1. Units and lanes: a unit is (tile, query slice), one CTA; LANES lanes
//     share a query (ops/pallas_banded.py:moments_v2_plan, the rule of
//     pallas_icp_mega.unit_plan at B = 1: at least 3 units per SM where
//     the shape allows), each scanning every LANES-th column of a block.
//  2. Loads: the window streams through a two-slot ring of 1,024-column
//     chunks loaded with cp.async, (x, y, z, pen2) as one float4, so one
//     shared load serves a thread's 4 queries (2 were slower at P5's
//     shape: more units, a load for every 2 queries).
//  3. A branch-free scan: with many lanes a query, some lane of a warp
//     lowers its running minimum on most columns, so a branch on it runs
//     its body nearly always. Each lane keeps, per query, the block's
//     running minimum, the first column that reached it and a flag set by
//     any column equal to the running minimum. At a block's end the
//     group's lanes combine the minimum by xor shuffles; a block that wins
//     (strict '<': an earlier block keeps a tie) takes its one column's
//     coordinates, or, where the minimum may be tied (the flag, or two
//     lanes at it), the sum over the block's columns at the minimum with
//     their count (each lane's in column order, the lanes' by xor).
//  4. Partials: each unit writes its 16 f64 moments (a fixed-order CTA
//     reduction) to scratch; the last unit of a tile to finish (an atomic
//     ticket per tile, after a fence) sums the tile's units in slice order
//     into out[tile] and puts the ticket back to 0. A run is
//     deterministic, and the wrapper's [Mp/tq, 16] output is unchanged.
//  5. An ordinary launch: one grid of all units, one ICP iteration.
#include <cuda_runtime.h>

namespace {

constexpr int kLutBins = 1024;
constexpr float kBig = 1e30f;
constexpr int kMomThreads = 256;   // K6-K8: threads a unit
constexpr int kWarps = kMomThreads / 32;
constexpr int kMomQpt = 4;         // K7/K8: queries a thread
constexpr int kNnQpt = 4;          // K6: queries a thread
constexpr int kMomChunk = 1024;    // K6-K8: db columns a ring slot

// ---- K7's and K8's arguments; the ring K6-K8 stream their windows through

struct MomentsArgs {
  const float* scal;     // K8: [16] R row-major, t, lo, hi, axis, 0
  const int* lut;        // K8: [kLutBins + 1]
  const float* centers;  // K8: [3 * Mp / tq]
  const int* offsets;    // K7: [Mp / tq] each tile's first window block
  const float* q;        // K8: [3, Mp] source columns; K7: [Mp, 3] rows
  const float* qpen;     // [Mp] 0 valid / BIG
  const float* dbt4;     // [4, Np] x, y, z, ones
  const float* pen2t;    // [Np]
  double* out;           // [Mp / tq, 16]
  double* part;          // [units, 16] scratch: each unit's moments
  unsigned* tickets;     // [Mp / tq] zero: units of the tile done
  int Mp, Np, block, wb, tq, lanes;
  float thresh2;
};

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

// db columns [g0, g0 + len) -> one ring slot of (x, y, z, pen) (K7/K8:
// pen2 = |b|^2 + pen)
__device__ void stage_moments(float4* s4, const float* dbt4,
                              const float* pen2t, int Np, int g0, int len) {
  for (int c = threadIdx.x; c < len; c += kMomThreads) {
    const float* p = dbt4 + g0 + c;
    cp_async4(&s4[c].x, p);
    cp_async4(&s4[c].y, p + Np);
    cp_async4(&s4[c].z, p + 2 * Np);
    cp_async4(&s4[c].w, pen2t + g0 + c);
  }
  cp_async_commit();
}

// ---- K6 -------------------------------------------------------------------

// One unit (tile, query slice) of a K6 launch: `lanes` lanes share each of
// a thread's kNnQpt queries and scan every lanes-th column of the window,
// which streams through the two-slot ring. Each lane keeps its strict '<'
// minimum and the first of its columns that reached it; at the end the
// group's lanes take the lexicographic (d2, column) minimum by xor.
__global__ void __launch_bounds__(kMomThreads, 4)
banded_nn_kernel(const float* __restrict__ q, const float* __restrict__ dbt,
                 const float* __restrict__ pen,
                 const int* __restrict__ offsets, float* __restrict__ d2_out,
                 int* __restrict__ idx_out, int Np, int block, int wb,
                 int tq, int lanes) {
  constexpr int QPT = kNnQpt;
  __shared__ float4 s4[2][kMomChunk];
  const int tid = threadIdx.x;
  const int L = lanes, sub = tid % L, grp = tid / L;
  const int ngrp = kMomThreads / L, S = ngrp * QPT;   // queries a unit
  const int spt = (tq + S - 1) / S;
  const int u = blockIdx.x, tile = u / spt, q0 = (u - tile * spt) * S;
  const int W = wb * block;
  const int nch = (W + kMomChunk - 1) / kMomChunk;
  const int g0 = offsets[tile] * block;
  stage_moments(s4[0], dbt, pen, Np, g0, min(kMomChunk, W));

  float qx[QPT], qy[QPT], qz[QPT], best[QPT];
  int bi[QPT];   // the window column (from 0) that reached best
#pragma unroll
  for (int s = 0; s < QPT; ++s) {
    const int qi = q0 + s * ngrp + grp;
    const size_t row = (size_t)tile * tq + (qi < tq ? qi : 0);
    qx[s] = q[row * 3];
    qy[s] = q[row * 3 + 1];
    qz[s] = q[row * 3 + 2];
    best[s] = kBig;
    bi[s] = 0;
  }

  for (int ch = 0; ch < nch; ++ch) {
    const int buf = ch & 1, c_lo = ch * kMomChunk;
    const int c_hi = min(W, c_lo + kMomChunk);
    if (ch + 1 < nch) {   // the next chunk flies while this one runs
      stage_moments(s4[buf ^ 1], dbt, pen, Np, g0 + c_hi,
                    min(kMomChunk, W - c_hi));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float4* p4 = s4[buf];
#pragma unroll 4
    for (int c = c_lo + sub; c < c_hi; c += L) {   // branch-free
      const float4 p = p4[c - c_lo];
#pragma unroll
      for (int s = 0; s < QPT; ++s) {
        const float dx = qx[s] - p.x, dy = qy[s] - p.y, dz = qz[s] - p.z;
        const float d2 = ((dx * dx + dy * dy) + dz * dz) + p.w;
        const bool lt = d2 < best[s];   // strict: a lane's first column wins
        bi[s] = lt ? c : bi[s];
        best[s] = lt ? d2 : best[s];
      }
    }
    __syncthreads();   // this slot is refilled two chunks on
  }

#pragma unroll
  for (int s = 0; s < QPT; ++s) {
    float d = best[s];
    int i = bi[s];
    for (int o = L >> 1; o > 0; o >>= 1) {   // lexicographic (d2, column)
      const float od = __shfl_xor_sync(0xffffffffu, d, o);
      const int oi = __shfl_xor_sync(0xffffffffu, i, o);
      const bool take = od < d || (od == d && oi < i);
      d = take ? od : d;
      i = take ? oi : i;
    }
    const int qi = q0 + s * ngrp + grp;
    if (sub == 0 && qi < tq) {
      const size_t row = (size_t)tile * tq + qi;
      d2_out[row] = d;
      idx_out[row] = d < kBig ? g0 + i : 0;   // (1e30, 0): nothing in reach
    }
  }
}

// ---- K7 and K8: one body ---------------------------------------------------

// d2' of a db column for a posed query, in K7/K8's order
__device__ __forceinline__ float moment_d2(float qx, float qy, float qz,
                                           float x, float y, float z,
                                           float pen2) {
  const float cross = (qx * x + qy * y) + qz * z;
  return pen2 - 2.0f * cross;
}

// The first window block of `tile`: K7's from the wrapper; K8's from the
// tile's POSED centre (reference :332-343)
template <bool kPosed>
__device__ __forceinline__ int window_base(const MomentsArgs& a, int tile) {
  if constexpr (!kPosed) {
    return a.offsets[tile];
  } else {
    const float* s = a.scal;
    const float c0 = a.centers[3 * tile], c1 = a.centers[3 * tile + 1],
                c2 = a.centers[3 * tile + 2];
    const float cx = s[0] * c0 + s[1] * c1 + s[2] * c2 + s[9];
    const float cy = s[3] * c0 + s[4] * c1 + s[5] * c2 + s[10];
    const float cz = s[6] * c0 + s[7] * c1 + s[8] * c2 + s[11];
    const float lo = s[12], hi = s[13], axf = s[14];
    const float val = axf < 0.5f ? cx : (axf < 1.5f ? cy : cz);
    const float binf = (val - lo) / fmaxf(hi - lo, 1e-12f) * (float)kLutBins;
    const int bin = (int)fminf(fmaxf(binf, 0.f), (float)kLutBins);
    const int nb = a.Np / a.block;
    return min(max(a.lut[bin] / a.block - a.wb / 2, 0), nb - a.wb);
  }
}

// Query `col`: K7's as given; K8's posed as ((r0 x + r1 y) + r2 z) + t
template <bool kPosed>
__device__ __forceinline__ void load_query(const MomentsArgs& a, int col,
                                           float& x, float& y, float& z) {
  if constexpr (!kPosed) {
    x = a.q[3 * col];
    y = a.q[3 * col + 1];
    z = a.q[3 * col + 2];
  } else {
    const float* s = a.scal;
    const float u = a.q[col], v = a.q[a.Mp + col], w = a.q[2 * a.Mp + col];
    x = s[0] * u + s[1] * v + s[2] * w + s[9];
    y = s[3] * u + s[4] * v + s[5] * w + s[10];
    z = s[6] * u + s[7] * v + s[8] * w + s[11];
  }
}

template <bool kPosed>
__global__ void __launch_bounds__(kMomThreads, 3)
banded_moments_kernel(const MomentsArgs a) {
  constexpr int QPT = kMomQpt;
  __shared__ float4 s4[2][kMomChunk];
  __shared__ double red[kWarps][16];
  __shared__ int is_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = a.lanes, sub = tid % L, grp = tid / L;
  const int ngrp = kMomThreads / L, S = ngrp * QPT;   // queries a unit
  const int spt = (a.tq + S - 1) / S;
  const int u = blockIdx.x, tile = u / spt, q0 = (u - tile * spt) * S;
  const int W = a.wb * a.block;
  const int nch = (W + kMomChunk - 1) / kMomChunk;
  // the lanes of this thread's query group within its warp
  const unsigned gmask =
      L == 32 ? 0xffffffffu : ((1u << L) - 1u) << (lane & ~(L - 1));
  const float inf = __int_as_float(0x7f800000);
  const float* dbx = a.dbt4;
  const float *dby = dbx + a.Np, *dbz = dbx + 2 * a.Np, *dbo = dbx + 3 * a.Np;

  const int g0 = window_base<kPosed>(a, tile) * a.block;
  stage_moments(s4[0], a.dbt4, a.pen2t, a.Np, g0, min(kMomChunk, W));

  // the unit's posed queries. Per query and lane: the block's running
  // minimum, the first column that reached it, and whether any column
  // equalled the running minimum (a possible tie); per query: the best
  // block's minimum and its matched coordinate sums and count
  float qx[QPT], qy[QPT], qz[QPT];
  float minv[QPT], mx[QPT], my[QPT], mz[QPT], mc[QPT];
  float bmin[QPT];
  int bidx[QPT];
  bool teq[QPT];
#pragma unroll
  for (int s = 0; s < QPT; ++s) {
    const int qi = q0 + s * ngrp + grp;
    load_query<kPosed>(a, tile * a.tq + (qi < a.tq ? qi : 0), qx[s], qy[s],
                       qz[s]);
    minv[s] = kBig;
    mx[s] = my[s] = mz[s] = 0.f;
    mc[s] = 1.f;
    bmin[s] = inf;
    bidx[s] = 0;
    teq[s] = false;
  }

  for (int ch = 0; ch < nch; ++ch) {
    const int buf = ch & 1, c_lo = ch * kMomChunk;
    const int c_hi = min(W, c_lo + kMomChunk);
    if (ch + 1 < nch) {   // the next chunk flies while this one runs
      stage_moments(s4[buf ^ 1], a.dbt4, a.pen2t, a.Np, g0 + c_hi,
                    min(kMomChunk, W - c_hi));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float4* p4 = s4[buf];
    for (int cb = c_lo; cb < c_hi;) {
      const int bend = min(c_hi, (cb / a.block + 1) * a.block);
#pragma unroll 4
      for (int c = cb + sub; c < bend; c += L) {   // branch-free
        const float4 p = p4[c - c_lo];
#pragma unroll
        for (int s = 0; s < QPT; ++s) {
          const float d2 = moment_d2(qx[s], qy[s], qz[s], p.x, p.y, p.z, p.w);
          teq[s] = teq[s] || d2 == bmin[s];
          bidx[s] = d2 < bmin[s] ? c : bidx[s];
          bmin[s] = fminf(bmin[s], d2);
        }
      }
      if (bend % a.block == 0) {   // a db block ends: its lanes combine
        const int blk0 = bend - a.block;
#pragma unroll
        for (int s = 0; s < QPT; ++s) {
          float M = bmin[s];
          for (int o = L >> 1; o > 0; o >>= 1)
            M = fminf(M, __shfl_xor_sync(0xffffffffu, M, o));
          const unsigned at = __ballot_sync(0xffffffffu, bmin[s] == M) & gmask;
          const unsigned tie =
              __ballot_sync(0xffffffffu, bmin[s] == M && teq[s]) & gmask;
          const int first = __shfl_sync(0xffffffffu, bidx[s], __ffs(at) - 1);
          if (M < minv[s]) {   // strict: an earlier block wins a tie
            minv[s] = M;
            if (__popc(at) == 1 && tie == 0) {   // one column at the minimum
              const int g = g0 + first;
              mx[s] = dbx[g];
              my[s] = dby[g];
              mz[s] = dbz[g];
              mc[s] = dbo[g];
            } else {   // ties: each lane sums its columns at the minimum in
                       // column order, then the group's lanes by xor
              float sx = 0.f, sy = 0.f, sz = 0.f, so = 0.f;
              for (int c = blk0 + sub; c < bend; c += L) {
                const int g = g0 + c;
                const float x = dbx[g], y = dby[g], z = dbz[g];
                if (moment_d2(qx[s], qy[s], qz[s], x, y, z, a.pen2t[g]) == M) {
                  sx += x;
                  sy += y;
                  sz += z;
                  so += dbo[g];
                }
              }
              for (int o = L >> 1; o > 0; o >>= 1) {
                sx += __shfl_xor_sync(gmask, sx, o);
                sy += __shfl_xor_sync(gmask, sy, o);
                sz += __shfl_xor_sync(gmask, sz, o);
                so += __shfl_xor_sync(gmask, so, o);
              }
              mx[s] = sx;
              my[s] = sy;
              mz[s] = sz;
              mc[s] = so;
            }
          }
          bmin[s] = inf;
          teq[s] = false;
        }
      }
      cb = bend;
    }
    __syncthreads();   // this slot is refilled two chunks on
  }

  // the unit's moments (lane 0 of each group), f64, in a fixed order
  double m[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) m[e] = 0.0;
#pragma unroll
  for (int s = 0; s < QPT; ++s) {
    const int qi = q0 + s * ngrp + grp;
    if (qi >= a.tq || sub != 0) continue;
    const float cnt = fmaxf(mc[s], 1.f);
    const float hq[4] = {mx[s] / cnt, my[s] / cnt, mz[s] / cnt, 1.f};
    const float qn = (qx[s] * qx[s] + qy[s] * qy[s]) + qz[s] * qz[s];
    const float qp = a.qpen[tile * a.tq + qi];
    const float wt = ((minv[s] + qn) + qp) < a.thresh2 ? 1.f : 0.f;
    const float hp[4] = {qx[s] * wt, qy[s] * wt, qz[s] * wt, wt};
#pragma unroll
    for (int e = 0; e < 16; ++e)
      m[e] += (double)hp[e / 4] * (double)hq[e % 4];
  }
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    double v = m[e];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp][e] = v;
  }
  __syncthreads();
  if (spt == 1) {   // the unit is the tile
    if (tid < 16) {
      double v = 0.0;
      for (int w = 0; w < kWarps; ++w) v += red[w][tid];
      a.out[(size_t)tile * 16 + tid] = v;
    }
    return;
  }
  if (tid < 16) {
    double v = 0.0;
    for (int w = 0; w < kWarps; ++w) v += red[w][tid];
    a.part[(size_t)u * 16 + tid] = v;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0)
    is_last = atomicAdd(a.tickets + tile, 1u) == (unsigned)(spt - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (tid < 16) {   // the tile's units in slice order
    double v = 0.0;
    for (int j = 0; j < spt; ++j)
      v += __ldcg(a.part + ((size_t)tile * spt + j) * 16 + tid);
    a.out[(size_t)tile * 16 + tid] = v;
  }
  if (tid == 0) a.tickets[tile] = 0u;
}

bool bad_tiling(int Mp, int Np, int block, int wb, int tq) {
  return block <= 0 || tq <= 0 || Np % block != 0 || Mp % tq != 0 || wb < 1
         || wb > Np / block;
}

bool bad_lanes(int lanes) {
  return lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0;
}

template <bool kPosed>
int launch_moments(const MomentsArgs& a, cudaStream_t stream) {
  if (bad_tiling(a.Mp, a.Np, a.block, a.wb, a.tq) || bad_lanes(a.lanes))
    return (int)cudaErrorInvalidValue;
  if (a.Mp == 0) return 0;
  const int slice = kMomThreads / a.lanes * kMomQpt;
  const int units = a.Mp / a.tq * ((a.tq + slice - 1) / slice);
  banded_moments_kernel<kPosed><<<units, kMomThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q [Mp,3], dbt [3,Np], pen [Np], offsets [Mp/tq] i32 -> d2 [Mp] f32,
// idx [Mp] i32 (sorted column). One CTA per unit: (Mp/tq) * ceil(tq /
// (256 * 4 / lanes)) units, lanes a power of two in [1, 32]
// (ops/pallas_banded.py:nearest_banded_plan).
extern "C" int pct_banded_nn(const float* q, const float* dbt,
                             const float* pen, const int* offsets, float* d2,
                             int* idx, int Mp, int Np, int block, int wb,
                             int tq, int lanes, cudaStream_t stream) {
  if (bad_tiling(Mp, Np, block, wb, tq) || bad_lanes(lanes))
    return (int)cudaErrorInvalidValue;
  if (Mp == 0) return 0;
  const int slice = kMomThreads / lanes * kNnQpt;
  const int units = Mp / tq * ((tq + slice - 1) / slice);
  banded_nn_kernel<<<units, kMomThreads, 0, stream>>>(
      q, dbt, pen, offsets, d2, idx, Np, block, wb, tq, lanes);
  return (int)cudaGetLastError();
}

// The scratch of K7 and K8: part [units,16] f64 and tickets [Mp/tq] u32,
// zero (put back to 0), where units = (Mp/tq) * ceil(tq / (256 * 4 /
// lanes)); lanes a power of two in [1, 32]
// (ops/pallas_banded.py:moments_v2_plan).

// K7: q [Mp,3] posed, qpen [Mp], dbt4 [4,Np], pen2 [Np], offsets [Mp/tq]
// i32 -> out [Mp/tq,16] f64 per-tile moments.
extern "C" int pct_banded_moments(const float* q, const float* qpen,
                                  const float* dbt4, const float* pen2,
                                  const int* offsets, double* out,
                                  double* part, unsigned* tickets, int Mp,
                                  int Np, int block, int wb, int tq,
                                  int lanes, float thresh2,
                                  cudaStream_t stream) {
  const MomentsArgs a{nullptr, nullptr, nullptr, offsets, q, qpen, dbt4,
                      pen2, out, part, tickets, Mp, Np, block, wb, tq,
                      lanes, thresh2};
  return launch_moments<false>(a, stream);
}

// K8: scal [16] (R row-major, t, lo, hi, axis, 0), lut [1025] i32,
// centers [3*Mp/tq], src3 [3,Mp], spen [Mp], dbt4 [4,Np], pen2t [Np]
// -> out [Mp/tq,16] f64 per-tile moments.
extern "C" int pct_banded_moments_v2(const float* scal, const int* lut,
                                     const float* centers, const float* src3,
                                     const float* spen, const float* dbt4,
                                     const float* pen2t, double* out,
                                     double* part, unsigned* tickets, int Mp,
                                     int Np, int block, int wb, int tq,
                                     int lanes, float thresh2,
                                     cudaStream_t stream) {
  const MomentsArgs a{scal, lut, centers, nullptr, src3, spen, dbt4, pen2t,
                      out, part, tickets, Mp, Np, block, wb, tq, lanes,
                      thresh2};
  return launch_moments<true>(a, stream);
}
