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
// Bound on an H100: operations. K2 spends about 10 FP32 operations on
// every in-band pair (the distance test) and about 70 more on a pair
// within the radius (three IEEE divides, two square roots, the atan2
// polynomial, the bins); K3 about 8 per pair plus 68 per within pair. The
// inputs (a few MB) are read from L2.
//
// Design. A query tile's x-band is shared by its 256 queries, only a few
// per cent of its pairs lie within the radius, and a query's neighbours
// lie in a narrow x-window of the band. So both kernels spread the
// queries over many warps, test only the steps of the band that can hold
// a neighbour, and keep the cheap distance test apart from the work on
// within pairs (the first design ran one query a thread over the whole
// band, 8 warps an SM, and branched per pair):
// - A CTA of `threads` takes `threads / 32 * Q` consecutive queries of one
//   query tile (`fpfh_plan` in features/pallas_fpfh.py shapes the launch);
//   each warp takes Q of them (Q = 1, 2 or 4, a template) and tests them
//   against 32 band columns a step, each column's p, |p|^2 and pen read
//   once for the Q queries; a ballot gives each query's within set.
// - The band goes in chunks of up to 128 steps. For each chunk the CTA
//   first tabulates, step by step, the running maximum of x over the
//   valid columns (pen < 1e20) from the chunk's start and the running
//   minimum from its end (redux.sync on order-preserving integer keys,
//   then a shuffle scan). A warp visits only the steps between the first
//   whose running maximum reaches x_min - R and the first whose running
//   minimum passes x_max + R, x_min and x_max its queries' x and R the
//   radius widened by the rounding the d2 formula can make (16 ulps of
//   (|q| + |p|)^2, `window`): every skipped column is farther than R in
//   x, so its computed d2 exceeds r^2. The tables hold for any input;
//   on the x-sorted voxel clouds of the paths they halve the pairs
//   tested. A column whose penalty is at least 1e20 (the packing puts
//   1e30 on masked points) is never within for points within 1e9 of the
//   origin, so it bounds nothing.
// - K2 reads the columns through L1 (its CTAs of 256 threads share a
//   band) and appends the within pairs (query slot, column, d2) to a ring
//   in shared memory, one per warp, and works them off 32 at a time, one
//   pair a lane, so the Darboux angles and bins run on full warps. Each
//   pair adds 1 to three integer bins of its query in shared memory
//   (atomicAdd on int: exact in any order), and a query's count is the
//   sum of its first 11 bins. At the end each count is scaled once,
//   100 / cnt, as in the first design: the result does not depend on the
//   split.
// - K3 keeps a query's 33 sums on the warp's lanes (channel k on lane k,
//   channel 32 also on lane 0). Its CTAs are wide (up to 1,024 threads)
//   and stage, one piece of `warps` steps at a time, the SPFH rows and
//   the test's columns of the steps their warps visit in shared memory:
//   each row is read from L2 once a CTA, not once a within pair. Each
//   query's within columns go, with their d2, to a ring of its own in
//   ascending order; eight at a time, lane i forms entry i's weight, the
//   warp reads the eight rows and adds them in that order, so each sum
//   runs in the order of the first design and the result is the same bit
//   for bit. Every ring is emptied before the next piece is staged.
#include <cuda_runtime.h>

namespace {

constexpr int kQT = 256;       // the query tile (K9: the largest tile)
constexpr int kTN = 128;       // db_tile is a multiple of it
constexpr int kBins = 11;
constexpr int kH = 3 * kBins;
constexpr int kChunkSteps = 128;   // steps of 32 columns a table covers
constexpr int kRing = 256;     // K2: a warp's ring of within pairs
constexpr int kSlotShift = 24; // K2: a ring entry is slot << 24 | offset
constexpr int kQRing = 64;     // K3: a query's ring of within columns
constexpr int kBatch = 8;      // K3: rows added per batch of loads
constexpr float kNeverWithin = 1e20f;   // a penalty at or above it
constexpr unsigned kFull = 0xffffffffu;
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

// The step tables of one chunk of the band, in shared memory: `hi[s]` the
// largest x of the valid columns in steps 0..s, `lo[s]` the smallest in
// steps s..steps-1 (-inf / +inf where there is none), and `pp` the
// largest |p|^2 of the chunk's valid columns.
struct Table {
  float hi[kChunkSteps], lo[kChunkSteps], step_pp[kChunkSteps];
  float pp, pad;
  int first, last;            // K3: the steps its warps visit, together
};
constexpr int kTableWords = (int)sizeof(Table) / 4;

// A float's bits as an int whose order is the float's (for redux.sync).
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float unordered(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// Fills `t` for the `steps` steps of columns from `col0` (a multiple of
// 32 columns each), from the db's rows of x, |p|^2 and pen (K2/K3: rows 0,
// 9 and 11 of [12][Np]; K9: rows 0, 3 and 4 of [5][Np]). All threads of
// the CTA call it, between barriers. A column bounds nothing unless its
// pen is below 1e20 and its x and |p|^2 are numbers (a NaN never passes
// the test).
__device__ void fill_table(Table& t, const float* __restrict__ xs,
                           const float* __restrict__ pps,
                           const float* __restrict__ pens, int col0,
                           int steps) {
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int st = warp; st < steps; st += warps) {
    const int col = col0 + st * 32 + lane;
    const float px = __ldg(xs + col), pp = __ldg(pps + col);
    const bool valid = __ldg(pens + col) < kNeverWithin
                       && px == px && pp == pp;
    const int lo = __reduce_min_sync(kFull, ordered(valid ? px : INFINITY));
    const int hi = __reduce_max_sync(kFull, ordered(valid ? px : -INFINITY));
    const unsigned mp = __reduce_max_sync(
        kFull, __float_as_uint(valid ? fmaxf(pp, 0.f) : 0.f));
    if (lane == 0) {
      t.lo[st] = unordered(lo), t.hi[st] = unordered(hi);
      t.step_pp[st] = __uint_as_float(mp);
    }
  }
  __syncthreads();
  if (warp == 0) {            // running max forwards, running min backwards
    constexpr int kPer = kChunkSteps / 32;
    float h[kPer], l[kPer], mp = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int st = lane * kPer + i;
      h[i] = st < steps ? t.hi[st] : -INFINITY;
      l[i] = st < steps ? t.lo[st] : INFINITY;
      mp = fmaxf(mp, st < steps ? t.step_pp[st] : 0.f);
      if (i > 0) h[i] = fmaxf(h[i], h[i - 1]);
    }
#pragma unroll
    for (int i = kPer - 2; i >= 0; --i) l[i] = fminf(l[i], l[i + 1]);
    float hs = h[kPer - 1], ls = l[0];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float hn = __shfl_up_sync(kFull, hs, o);
      const float ln = __shfl_down_sync(kFull, ls, o);
      if (lane >= o) hs = fmaxf(hs, hn);
      if (lane + o < 32) ls = fminf(ls, ln);
      mp = fmaxf(mp, __shfl_xor_sync(kFull, mp, o));
    }
    float before = __shfl_up_sync(kFull, hs, 1);      // lanes < this one
    float after = __shfl_down_sync(kFull, ls, 1);     // lanes > this one
    if (lane == 0) before = -INFINITY;
    if (lane == 31) after = INFINITY;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int st = lane * kPer + i;
      if (st < steps) {
        t.hi[st] = fmaxf(h[i], before);
        t.lo[st] = fminf(l[i], after);
      }
    }
    if (lane == 0) t.pp = mp, t.first = steps, t.last = 0;
  }
  __syncthreads();
}

// The x distance beyond which a pair's computed d2 exceeds r2, for
// queries with |q|^2 <= qq and columns with |p|^2 <= pp: d2's formula
// errs by less than 8 ulps of (|q| + |p|)^2 against the exact |q - p|^2,
// and the x comparisons by a few ulps of |x| + R; both are doubled.
__device__ __forceinline__ float window(float r2, float qq, float pp) {
  const double u = 1.0 / (1 << 24);
  const double m = (sqrt((double)fmaxf(qq, 0.f))
                    + sqrt((double)fmaxf(pp, 0.f))) * (1.0 + 4.0 * u);
  const double r = sqrt(fmax((double)r2, 0.0) + 16.0 * u * m * m);
  return __double2float_ru((r + 8.0 * u * m) * (1.0 + 1e-6));
}

// [first, last) steps of a table a group of queries with x in [xlo, xhi]
// must visit (both tables are monotone).
__device__ __forceinline__ void visit_range(const Table& t, int steps,
                                            float xlo, float xhi, float R,
                                            int& first, int& last) {
  const float a = xlo - R, b = xhi + R;
  int lo = 0, hi = steps;                    // first st with hi[st] >= a
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (t.hi[mid] >= a) hi = mid; else lo = mid + 1;
  }
  first = lo;
  hi = steps;                                // first st with lo[st] > b
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (t.lo[mid] > b) hi = mid; else lo = mid + 1;
  }
  last = lo;
}

// A lane's db column for the distance test: p, |p|^2 and pen (rows 0-2,
// 9 and 11 of the packed db [12][Np]).
struct Col {
  float p0, p1, p2, pp, pen;
};

__device__ __forceinline__ Col load_col(const float* __restrict__ dbb, int Np,
                                        int col) {
  return Col{__ldg(dbb + col), __ldg(dbb + Np + col),
             __ldg(dbb + 2 * Np + col), __ldg(dbb + 9 * Np + col),
             __ldg(dbb + 11 * Np + col)};
}

// A warp's Q queries: their packed rows' p and |p|^2 in registers, and
// the x range and largest |p|^2 of the group.
template <int Q>
struct Group {
  float q0[Q], q1[Q], q2[Q], qq[Q];
  float xlo, xhi, qq_max;
  __device__ __forceinline__ void load(const float* a) {   // a: [Q][11]
    xlo = INFINITY, xhi = -INFINITY, qq_max = 0.f;
#pragma unroll
    for (int s = 0; s < Q; ++s) {
      q0[s] = a[s * 11], q1[s] = a[s * 11 + 1], q2[s] = a[s * 11 + 2];
      qq[s] = a[s * 11 + 9];
      xlo = fminf(xlo, q0[s]), xhi = fmaxf(xhi, q0[s]);
      qq_max = fmaxf(qq_max, qq[s]);
    }
  }
  // query s against column c: within, and the pair's d2
  __device__ __forceinline__ bool within(int s, const Col& c, int row,
                                         int col, float r2, float& d2) const {
    const float qp = q0[s] * c.p0 + q1[s] * c.p1 + q2[s] * c.p2;
    d2 = (qq[s] + c.pp) - 2.0f * qp;
    return d2 + c.pen <= r2 && row != col;
  }
};

// K2's shared memory for `warps` warps of Q queries: the bins
// [queries][33] (int), the queries' packed rows [queries][11], the table,
// and each warp's ring (kRing keys, then kRing d2).
__host__ __device__ constexpr int spfh_smem(int warps, int queries) {
  return queries * (kH + 11) * 4 + (int)sizeof(Table) + warps * kRing * 8;
}

// K3's: the table, each warp's Q rings (kQRing entries of (row offset,
// d2) a query), and the SPFH rows and the test's p, |p|^2 and pen of
// `warps` steps (32 columns a step).
__host__ __device__ constexpr int wsum_smem(int warps, int queries) {
  return (int)sizeof(Table) + queries * kQRing * 8
         + warps * 32 * (kH + 5) * 4;
}

// The Darboux angles of one within pair (query row a, db column col of
// dbb [12][Np], its d2) into three bins of `h` (the query's 33), in the
// first design's formulas and order.
__device__ __forceinline__ void bin_pair(const float* __restrict__ a,
                                         const float* __restrict__ dbb,
                                         int Np, int col, float d2, int* h) {
  const float q0 = a[0], q1 = a[1], q2 = a[2];
  const float u0 = a[3], u1 = a[4], u2 = a[5];
  const float x0 = a[6], x1 = a[7], x2 = a[8];
  const float uq = a[10];
  const float p0 = __ldg(dbb + col), p1 = __ldg(dbb + Np + col);
  const float p2 = __ldg(dbb + 2 * Np + col);
  const float v0 = __ldg(dbb + 3 * Np + col), v1 = __ldg(dbb + 4 * Np + col);
  const float v2 = __ldg(dbb + 5 * Np + col);
  const float w0 = __ldg(dbb + 6 * Np + col), w1 = __ldg(dbb + 7 * Np + col);
  const float w2 = __ldg(dbb + 8 * Np + col);
  const float pv = __ldg(dbb + 10 * Np + col);
  const float up = u0 * p0 + u1 * p1 + u2 * p2;
  const float qv = q0 * v0 + q1 * v1 + q2 * v2;
  const float un = u0 * v0 + u1 * v1 + u2 * v2;
  const float xv = x0 * v0 + x1 * v1 + x2 * v2;
  const float uw = u0 * w0 + u1 * w1 + u2 * w2;
  const float inv_d = 1.0f / sqrtf(fmaxf(d2, 1e-12f));
  const float f2 = (up - uq) * inv_d;
  const float s = sqrtf(fmaxf(1.0f - f2 * f2, 0.f));
  const float inv_s = 1.0f / fmaxf(s, 1e-12f);
  const float f1 = (uw - xv) * inv_d * inv_s;
  const float dn = (pv - qv) * inv_d;
  const float f3 = atan2_cephes((dn - f2 * un) * inv_s, un);
  atomicAdd(h + bin_of((f1 + 1.0f) * 5.5f), 1);
  atomicAdd(h + kBins + bin_of((f2 + 1.0f) * 5.5f), 1);
  atomicAdd(h + 2 * kBins + bin_of((f3 + kPi) * kTwoPiInv), 1);
}

// Works off `n` (<= 32) ring entries from `head`, one a lane.
__device__ __forceinline__ void drain(const int* __restrict__ keys,
                                      const float* __restrict__ d2s,
                                      unsigned head, int n, int lane,
                                      const float* __restrict__ qa,
                                      const float* __restrict__ dbb, int Np,
                                      int start, int* hist) {
  if (lane < n) {
    const unsigned e = (head + lane) & (kRing - 1);
    const int key = keys[e];
    const int slot = key >> kSlotShift;
    const int col = start + (key & ((1 << kSlotShift) - 1));
    bin_pair(qa + slot * 11, dbb, Np, col, d2s[e], hist + slot * kH);
  }
}

template <int Q>
__global__ void __launch_bounds__(1024)
spfh_kernel(const float* __restrict__ amat, const float* __restrict__ dbmat,
            const int* __restrict__ base, const int* __restrict__ nt,
            float* __restrict__ hist_out, float* __restrict__ cnt_out,
            int Np, int db_tile, float r2) {
  extern __shared__ int smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, tid = threadIdx.x;
  const int queries = warps * Q;
  int* hist = smem;                                         // [queries][33]
  float* qa = reinterpret_cast<float*>(hist + queries * kH);
  Table& table = *reinterpret_cast<Table*>(qa + queries * 11);
  int* keys = reinterpret_cast<int*>(&table + 1) + warp * 2 * kRing;
  float* d2s = reinterpret_cast<float*>(keys + kRing);

  const int b = blockIdx.y, nq = Np / kQT;
  const int per_tile = kQT / queries;
  const int tile = blockIdx.x / per_tile;
  const int row0 = tile * kQT + (blockIdx.x % per_tile) * queries;
  const float* arow = amat + ((size_t)b * Np + row0) * 11;
  for (int e = tid; e < queries * kH; e += blockDim.x) hist[e] = 0;
  for (int e = tid; e < queries * 11; e += blockDim.x) qa[e] = arow[e];
  __syncthreads();

  const int start = base[b * nq + tile] * db_tile;
  const int ncols = nt[b * nq + tile] * db_tile;
  const float* dbb = dbmat + (size_t)b * 12 * Np;
  const unsigned below = (1u << lane) - 1u;
  const int g = warp * Q;                       // the warp's first query
  Group<Q> grp;
  grp.load(qa + g * 11);
  unsigned head = 0, tail = 0;                  // warp-uniform ring counters
  for (int c0 = 0; c0 < ncols; c0 += kChunkSteps * 32) {
    const int steps = min(kChunkSteps, (ncols - c0) / 32);
    fill_table(table, dbb, dbb + 9 * Np, dbb + 11 * Np, start + c0,
               steps);
    int first, last;
    visit_range(table, steps, grp.xlo, grp.xhi,
                window(r2, grp.qq_max, table.pp), first, last);
    Col next = first < last ? load_col(dbb, Np, start + c0 + first * 32
                                       + lane) : Col{};
    for (int st = first; st < last; ++st) {
      const int off = c0 + st * 32 + lane, col = start + off;
      const Col c = next;                       // the next step's loads fly
      if (st + 1 < last) next = load_col(dbb, Np, col + 32);
#pragma unroll
      for (int s = 0; s < Q; ++s) {
        float d2;
        const bool in = grp.within(s, c, row0 + g + s, col, r2, d2);
        const unsigned m = __ballot_sync(kFull, in);
        if (m == 0u) continue;
        if (in) {
          const unsigned e = (tail + __popc(m & below)) & (kRing - 1);
          keys[e] = (g + s) << kSlotShift | off;
          d2s[e] = d2;
        }
        tail += __popc(m);
      }
      __syncwarp();
      for (; tail - head >= 32; head += 32)
        drain(keys, d2s, head, 32, lane, qa, dbb, Np, start, hist);
      __syncwarp();
    }
    __syncthreads();                            // the table is used up
  }
  drain(keys, d2s, head, (int)(tail - head), lane, qa, dbb, Np, start, hist);
  __syncthreads();

  // scale once per query: 100 / max(count, 1), the count being the sum of
  // the query's first 11 bins (each pair adds one to each histogram); the
  // scales take the place of the packed rows
  float* scale = qa;
  for (int q = tid; q < queries; q += blockDim.x) {
    int c = 0;
#pragma unroll
    for (int k = 0; k < kBins; ++k) c += hist[q * kH + k];
    const float cnt = fmaxf((float)c, 1.f);
    scale[q] = 100.0f / cnt;
    cnt_out[(size_t)b * Np + row0 + q] = cnt;
  }
  __syncthreads();
  float* out = hist_out + ((size_t)b * Np + row0) * kH;
  for (int e = tid; e < queries * kH; e += blockDim.x)
    out[e] = (float)hist[e] * scale[e / kH];
}

// Adds a batch of `n` (<= kBatch) entries of a query's ring to its sums:
// `ring` the batch's first entry (row offset in the staged SPFH `rows`
// as int bits, d2), the batch contiguous. Lane i forms entry i's weight and
// channel-32 product; the rows' loads go first, then the adds in ring
// order, each weight and product shuffled to the lanes.
__device__ __forceinline__ void add_rows(const float2* __restrict__ ring,
                                         int n, int lane,
                                         const float* __restrict__ rows,
                                         float& acc, float& acc32) {
  const float2 mine = ring[min(lane, kBatch - 1)];
  const float w = 1.0f / sqrtf(fmaxf(mine.y, 1e-12f));
  const float t32 = lane < n ? w * rows[__float_as_int(mine.x) + 32] : 0.f;
  float v[kBatch];
#pragma unroll
  for (int i = 0; i < kBatch; ++i)
    v[i] = rows[__float_as_int(ring[min(i, n - 1)].x) + lane];
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    if (i < n) {
      acc += __shfl_sync(kFull, w, i) * v[i];
      acc32 += __shfl_sync(kFull, t32, i);
    }
  }
}

template <int Q>
__global__ void __launch_bounds__(1024)
wsum_kernel(const float* __restrict__ amat, const float* __restrict__ dbmat,
            const int* __restrict__ base, const int* __restrict__ nt,
            const float* __restrict__ s33, float* __restrict__ out,
            int Np, int db_tile, float r2) {
  extern __shared__ int smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int queries = warps * Q;
  const int piece = warps;                      // steps staged at once
  Table& table = *reinterpret_cast<Table*>(smem);
  // the warp's Q rings of (row offset in the staged rows, d2); a batch
  // starts at a multiple of kBatch, so its entries are contiguous
  float2* ring0 = reinterpret_cast<float2*>(smem + kTableWords);
  float2* rings = ring0 + warp * Q * kQRing;
  float* rows = reinterpret_cast<float*>(ring0 + queries * kQRing);
  float* cols = rows + piece * 32 * kH;         // [5][piece * 32]: p, |p|^2, pen

  const int b = blockIdx.y, nq = Np / kQT;
  const int per_tile = kQT / queries;
  const int tile = blockIdx.x / per_tile;
  const int row0 = tile * kQT + (blockIdx.x % per_tile) * queries;
  const int start = base[b * nq + tile] * db_tile;
  const int ncols = nt[b * nq + tile] * db_tile;
  const float* dbb = dbmat + (size_t)b * 12 * Np;
  const unsigned below = (1u << lane) - 1u;
  const int g = warp * Q;
  Group<Q> grp;
  grp.load(amat + ((size_t)b * Np + row0 + g) * 11);
  float acc[Q], acc32[Q];
  int k_eff[Q];
  unsigned head[Q], tail[Q];
#pragma unroll
  for (int s = 0; s < Q; ++s)
    acc[s] = 0.f, acc32[s] = 0.f, k_eff[s] = 0, head[s] = tail[s] = 0;
  for (int c0 = 0; c0 < ncols; c0 += kChunkSteps * 32) {
    const int steps = min(kChunkSteps, (ncols - c0) / 32);
    fill_table(table, dbb, dbb + 9 * Np, dbb + 11 * Np, start + c0,
               steps);
    int first, last;
    visit_range(table, steps, grp.xlo, grp.xhi,
                window(r2, grp.qq_max, table.pp), first, last);
    if (lane == 0 && first < last) {            // the CTA's steps
      atomicMin(&table.first, first);
      atomicMax(&table.last, last);
    }
    __syncthreads();
    const int cta_last = table.last;
    // the SPFH rows of `piece` steps at a time in shared memory (16-byte
    // copies: a step's 32 rows are 4,224 bytes), then the warps' steps
    // among them; every ring is emptied before the next piece
    for (int p0 = table.first; p0 < cta_last; p0 += piece) {
      const int p1 = min(p0 + piece, cta_last);
      const int col0 = start + c0 + p0 * 32, n = (p1 - p0) * 32;
      const float4* src = reinterpret_cast<const float4*>(
          s33 + ((size_t)b * Np + col0) * kH);
      float4* dst = reinterpret_cast<float4*>(rows);
      for (int e = threadIdx.x; e < n * kH / 4; e += blockDim.x)
        dst[e] = __ldg(src + e);
      for (int e = threadIdx.x; e < 5 * n; e += blockDim.x) {
        const int r = e / n, k = e - r * n;
        cols[r * piece * 32 + k] =
            __ldg(dbb + (r < 3 ? r : 2 * r + 3) * Np + col0 + k);
      }
      __syncthreads();
      const int s0 = max(first, p0), s1 = min(last, p1);
      for (int st = s0; st < s1; ++st) {
        const int col = start + c0 + st * 32 + lane;
        const int k = (st - p0) * 32 + lane, roff = k * kH;
        const Col c{cols[k], cols[piece * 32 + k], cols[2 * piece * 32 + k],
                    cols[3 * piece * 32 + k], cols[4 * piece * 32 + k]};
#pragma unroll
        for (int s = 0; s < Q; ++s) {
          float d2;
          const bool in = grp.within(s, c, row0 + g + s, col, r2, d2);
          const unsigned m = __ballot_sync(kFull, in);
          if (m == 0u) continue;
          if (in) {
            const unsigned e = (tail[s] + __popc(m & below)) & (kQRing - 1);
            rings[s * kQRing + e] = make_float2(__int_as_float(roff), d2);
          }
          tail[s] += __popc(m);
          k_eff[s] += __popc(m);
        }
        __syncwarp();
#pragma unroll
        for (int s = 0; s < Q; ++s)
          for (; tail[s] - head[s] >= kBatch; head[s] += kBatch)
            add_rows(rings + s * kQRing + (head[s] & (kQRing - 1)), kBatch,
                     lane, rows, acc[s], acc32[s]);
        __syncwarp();
      }
#pragma unroll
      for (int s = 0; s < Q; ++s) {
        if (tail[s] != head[s])
          add_rows(rings + s * kQRing + (head[s] & (kQRing - 1)),
                   (int)(tail[s] - head[s]), lane, rows, acc[s], acc32[s]);
        head[s] = tail[s] = 0;
      }
      __syncthreads();                          // the rows are used up
    }
  }
#pragma unroll
  for (int s = 0; s < Q; ++s) {
    const float den = fmaxf((float)k_eff[s], 1.f);
    float* o = out + ((size_t)b * Np + row0 + g + s) * kH;
    o[lane] = acc[s] / den;
    if (lane == 0) o[32] = acc32[s] / den;
  }
}

// K9 moments: the radius-neighbourhood moments of the normals pass.
//
// Replaces the TPU kernel pctpu/features/pallas_fpfh.py:_moments_kernel
// (launched by normals_radius_fused). Per query row of query tile i,
// over the db columns of the tile's x-band:
//   w      = (|q|^2 + |p|^2 - 2 q.p) + pen <= r^2   (self included)
//   out[q] = sum over w of [x,y,z,x^2,y^2,z^2,xy,xz,yz,1], with
//            (x,y,z) = p - cent[i], the tile's centroid (0 on a dead col,
//            pen > 1).
// The TPU kernel sums through a [TQ,TN]x[TN,10] f32 dot in an unspecified
// order; here each query sums its features in f64 in ascending column
// order and rounds once to f32, as the plain version does, so the two
// agree to within one f32 ulp.
//
// Bound on an H100: operations. About 10 FP32 operations on each pair
// the test cannot skip (a live column within r of the query in x) and 10
// f64 adds on each pair inside the radius; the inputs (a few MB) are read
// from L2.
//
// Design (redesigned on K2/K3's machinery above; the first design ran one
// query a thread, a CTA a query tile, over every column of its band, with
// a divergent branch into the 10 f64 adds on each within pair, and tested
// all 537M pairs of the unbanded SLAM frames): each warp takes Q (1, 2 or
// 4) consecutive queries of one query tile (`moments_plan` in
// features/pallas_fpfh.py shapes the launch: a CTA's queries lie in one
// tile) and tests them against 32 band columns a step, each column's p,
// |p|^2 and pen read once for the Q queries; a ballot gives each query's
// within set. The step tables (`fill_table`, from K9's own rows) limit
// each warp to the steps of its chunk that can hold a neighbour; they
// hold for any input (pen >= 0) and prune wherever the cloud is sorted by
// x, banded or not (the voxel clouds of the paths are). On a step with
// any within pair, each lane computes its column's 10 shifted features
// with the first design's f32 operations into the warp's row of shared
// memory; then lane 5 s + k adds channels k and k + 5 of query s's within
// columns, lowest first, into two f64 sums. A query's channel is one sum
// in ascending column order, as in the first design, so the result equals
// it bit for bit. A tile with no valid point has nt = 0 and writes zeros.
constexpr int kMomLanes = 5;   // lanes a query: two channels a lane

// K9's shared memory for `warps` warps: the table and each warp's step of
// features, [32 columns][5 lanes] of (channel k, channel k + 5).
__host__ __device__ constexpr int moments_smem(int warps) {
  return (int)sizeof(Table) + warps * 32 * 10 * 4;
}

template <int Q>
__global__ void __launch_bounds__(1024)
moments_kernel(const float* __restrict__ amat,
               const float* __restrict__ dbmat,
               const float* __restrict__ cent, const int* __restrict__ base,
               const int* __restrict__ nt, float* __restrict__ out, int Np,
               int q_tile, int db_tile, float r2) {
  extern __shared__ int smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  Table& table = *reinterpret_cast<Table*>(smem);
  float2* feat = reinterpret_cast<float2*>(smem + kTableWords)
                 + warp * 32 * kMomLanes;

  const int b = blockIdx.y, nq = Np / q_tile;
  const int row0 = blockIdx.x * warps * Q;      // the CTA's first query
  const int tile = row0 / q_tile;
  const int g = row0 + warp * Q;                // the warp's first query
  const float* a = amat + ((size_t)b * Np + g) * 4;
  float q0[Q], q1[Q], q2[Q], qq[Q];
  float xlo = INFINITY, xhi = -INFINITY, qq_max = 0.f;
#pragma unroll
  for (int s = 0; s < Q; ++s) {
    q0[s] = a[s * 4], q1[s] = a[s * 4 + 1], q2[s] = a[s * 4 + 2];
    qq[s] = a[s * 4 + 3];
    xlo = fminf(xlo, q0[s]), xhi = fmaxf(xhi, q0[s]);
    qq_max = fmaxf(qq_max, qq[s]);
  }
  const float* c3 = cent + ((size_t)b * nq + tile) * 3;
  const float cx = c3[0], cy = c3[1], cz = c3[2];
  // lane 5 s + k: query s's channels k and k + 5 (lanes past 5 Q idle)
  const int ms = lane / kMomLanes, mk = lane - ms * kMomLanes;
  double acc0 = 0.0, acc1 = 0.0;

  const int start = base[b * nq + tile] * db_tile;
  const int ncols = nt[b * nq + tile] * db_tile;
  const float* dbb = dbmat + (size_t)b * 5 * Np;
  for (int c0 = 0; c0 < ncols; c0 += kChunkSteps * 32) {
    const int steps = min(kChunkSteps, (ncols - c0) / 32);
    fill_table(table, dbb, dbb + 3 * Np, dbb + 4 * Np, start + c0, steps);
    int first, last;
    visit_range(table, steps, xlo, xhi, window(r2, qq_max, table.pp), first,
                last);
    for (int st = first; st < last; ++st) {
      const int col = start + c0 + st * 32 + lane;
      const float px = __ldg(dbb + col), py = __ldg(dbb + Np + col);
      const float pz = __ldg(dbb + 2 * Np + col);
      const float pp = __ldg(dbb + 3 * Np + col);
      const float pen = __ldg(dbb + 4 * Np + col);
      unsigned mine = 0u, any = 0u;
#pragma unroll
      for (int s = 0; s < Q; ++s) {
        const float qp = q0[s] * px + q1[s] * py + q2[s] * pz;
        const float d2 = (qq[s] + pp) - 2.0f * qp;
        const unsigned m = __ballot_sync(kFull, d2 + pen <= r2);
        mine = ms == s ? m : mine;
        any |= m;
      }
      if (any == 0u) continue;
      const bool dead = pen > 1.0f;
      const float x = dead ? 0.f : px - cx;
      const float y = dead ? 0.f : py - cy;
      const float z = dead ? 0.f : pz - cz;
      float2* f = feat + lane * kMomLanes;
      f[0] = make_float2(x, z * z);
      f[1] = make_float2(y, x * y);
      f[2] = make_float2(z, x * z);
      f[3] = make_float2(x * x, y * z);
      f[4] = make_float2(y * y, dead ? 0.f : 1.f);
      __syncwarp();
      const float2* fk = feat + mk;
      while (mine != 0u) {                      // ascending columns
        const float2 v = fk[(__ffs(mine) - 1) * kMomLanes];
        mine &= mine - 1u;
        acc0 += (double)v.x;
        acc1 += (double)v.y;
      }
      __syncwarp();                             // the row is used up
    }
    __syncthreads();                            // the table is used up
  }
  if (ms < Q) {
    float* o = out + ((size_t)b * Np + g + ms) * 10;
    o[mk] = (float)acc0;
    o[mk + kMomLanes] = (float)acc1;
  }
}

// The K9 launch shape: `threads` a CTA (a multiple of 32, at most 1024),
// `warp_queries` (1, 2 or 4) queries a warp, and `cta_queries` = threads /
// 32 * warp_queries dividing q_tile (a multiple of 32 up to 256).
bool bad_moments_shape(int Np, int q_tile, int db_tile, int threads,
                       int cta_queries, int warp_queries) {
  return q_tile <= 0 || q_tile % 32 != 0 || q_tile > kQT || db_tile <= 0
         || db_tile % kTN != 0 || Np % q_tile != 0 || threads % 32 != 0
         || threads < 32 || threads > 1024
         || !(warp_queries == 1 || warp_queries == 2 || warp_queries == 4)
         || cta_queries != threads / 32 * warp_queries
         || q_tile % cta_queries != 0;
}

template <int Q>
int launch_moments(const float* amat, const float* dbmat, const float* cent,
                   const int* base, const int* nt, float* out, int B, int Np,
                   int q_tile, int db_tile, int threads, float r2,
                   cudaStream_t stream) {
  dim3 grid(Np / (threads / 32 * Q), B);
  moments_kernel<Q><<<grid, threads, moments_smem(threads / 32), stream>>>(
      amat, dbmat, cent, base, nt, out, Np, q_tile, db_tile, r2);
  return (int)cudaGetLastError();
}

}  // namespace

// amat [B,Np,4], dbmat [B,5,Np], cent [B,nq,3], base/nt [B,nq] i32 ->
// out [B,Np,10]. nq = Np / q_tile; needs q_tile % 32 == 0, q_tile <= 256,
// db_tile % 128 == 0 and a launch shape `bad_moments_shape` takes
// (features/pallas_fpfh.py:moments_plan).
extern "C" int pct_moments(const float* amat, const float* dbmat,
                           const float* cent, const int* base, const int* nt,
                           float* out, int B, int Np, int q_tile, int db_tile,
                           int threads, int cta_queries, int warp_queries,
                           float r2, cudaStream_t stream) {
  if (bad_moments_shape(Np, q_tile, db_tile, threads, cta_queries,
                        warp_queries))
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || Np <= 0) return 0;
  auto launch = warp_queries == 4   ? launch_moments<4>
                : warp_queries == 2 ? launch_moments<2>
                                    : launch_moments<1>;
  return launch(amat, dbmat, cent, base, nt, out, B, Np, q_tile, db_tile,
                threads, r2, stream);
}

namespace {

// The K2 / K3 launch shape: `threads` a CTA (a multiple of 32, at most
// 1024), `warp_queries` (1, 2 or 4) queries a warp tests at once, and
// `cta_queries` = threads / 32 * warp_queries dividing the 256-query tile.
bool bad_shape(int Np, int q_tile, int db_tile, int threads, int cta_queries,
               int warp_queries) {
  return q_tile != kQT || db_tile <= 0 || db_tile % kTN != 0 || Np % kQT != 0
         || Np >= (1 << kSlotShift) || threads % 32 != 0 || threads < 32
         || threads > 1024
         || !(warp_queries == 1 || warp_queries == 2 || warp_queries == 4)
         || cta_queries != threads / 32 * warp_queries
         || kQT % cta_queries != 0;
}

template <int Q>
int launch_spfh(const float* amat, const float* dbmat, const int* base,
                const int* nt, float* hist, float* cnt, int B, int Np,
                int db_tile, int threads, float r2, cudaStream_t stream) {
  const int queries = threads / 32 * Q;
  const int smem = spfh_smem(threads / 32, queries);
  const cudaError_t e = cudaFuncSetAttribute(
      spfh_kernel<Q>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(Np / queries, B);
  spfh_kernel<Q><<<grid, threads, smem, stream>>>(amat, dbmat, base, nt,
                                                  hist, cnt, Np, db_tile, r2);
  return (int)cudaGetLastError();
}

template <int Q>
int launch_wsum(const float* amat, const float* dbmat, const int* base,
                const int* nt, const float* s33, float* out, int B, int Np,
                int db_tile, int threads, float r2, cudaStream_t stream) {
  const int queries = threads / 32 * Q;
  const int smem = wsum_smem(threads / 32, queries);
  const cudaError_t e = cudaFuncSetAttribute(
      wsum_kernel<Q>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(Np / queries, B);
  wsum_kernel<Q><<<grid, threads, smem, stream>>>(amat, dbmat, base, nt, s33,
                                                  out, Np, db_tile, r2);
  return (int)cudaGetLastError();
}

}  // namespace

// amat [B,Np,11], dbmat [B,12,Np], base/nt [B,Np/256] i32 ->
// hist [B,Np,33], cnt [B,Np]. Needs q_tile == 256, db_tile % 128 == 0,
// Np < 2^24 and a launch shape `bad_shape` takes.
extern "C" int pct_spfh(const float* amat, const float* dbmat, const int* base,
                        const int* nt, float* hist, float* cnt, int B, int Np,
                        int q_tile, int db_tile, int threads, int cta_queries,
                        int warp_queries, float r2, cudaStream_t stream) {
  if (bad_shape(Np, q_tile, db_tile, threads, cta_queries, warp_queries))
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || Np <= 0) return 0;
  auto launch = warp_queries == 4   ? launch_spfh<4>
                : warp_queries == 2 ? launch_spfh<2>
                                    : launch_spfh<1>;
  return launch(amat, dbmat, base, nt, hist, cnt, B, Np, db_tile, threads, r2,
                stream);
}

// s33 [B,Np,33] (K2's hist) -> out [B,Np,33]. Same rules as pct_spfh.
extern "C" int pct_wsum(const float* amat, const float* dbmat, const int* base,
                        const int* nt, const float* s33, float* out, int B,
                        int Np, int q_tile, int db_tile, int threads,
                        int cta_queries, int warp_queries, float r2,
                        cudaStream_t stream) {
  if (bad_shape(Np, q_tile, db_tile, threads, cta_queries, warp_queries))
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || Np <= 0) return 0;
  auto launch = warp_queries == 4   ? launch_wsum<4>
                : warp_queries == 2 ? launch_wsum<2>
                                    : launch_wsum<1>;
  return launch(amat, dbmat, base, nt, s33, out, B, Np, db_tile, threads, r2,
                stream);
}
