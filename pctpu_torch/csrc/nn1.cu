// K1 nn1: exact batched 1-NN by direct squared differences.
//
// Replaces the TPU kernel pctpu/ops/pallas_nn.py:_nn_kernel
// (nearest_pallas), which keeps the db resident in VMEM and streams query
// tiles through it.
//
// What it computes: for each query q of batch element b, the db index i
// minimising d2 = dx*dx + dy*dy + dz*dz + pen[i] (pen = 0 for a valid db
// point, 1e30 for a masked or padded one), scanning i in ascending order
// with a strict '<', so the lowest index wins ties; (d2, i) = (1e30, 0)
// when no db point is valid. Each product and sum is rounded on its own
// (__fmul_rn/__fadd_rn) in the reference's order, so no FMA contraction
// moves a tie away from the plain PyTorch version.
//
// Bound on an H100: operations. chip_smoke.py counts 8 flops per (query,
// db) pair (3 subtracts, 3 multiplies, 2 adds) at the FP32 CUDA-core rate
// of 67 TFLOP/s, which assumes FMAs. Built with --fmad=false, as the exact
// ties need, a pair costs 8 instructions (3 FADD, 3 FMUL, 2 FADD; 9 with
// the penalty add) plus its share of the compare (about 1.3): about
// 2.96e13 such instructions a second on 132 SMs x 128 lanes at 1.755 GHz,
// so the instruction floor sits at about 2.5x the bound.
//
// What held the first design back (one query per thread, one CTA of 128
// queries scanning the whole db: 32 CTAs on 132 SMs for a SLAM launch of
// B = 1, M = 4,096, each pair a ~32-cycle dependent chain), and what this
// one does about it:
// - The db is cut into slices. The grid is (query tiles x slices, B); a
//   CTA of 128 threads holds 128 x kQPT queries (kQPT per thread, strided
//   by 128 so the loads coalesce) and scans one slice. `nn1_plan`
//   (pctpu_torch/ops/pallas_nn.py), which mirrors this arithmetic, cuts
//   the db into up to 16 slices: the SLAM front end's launch becomes one
//   wave of 128 CTAs, about one warp per scheduler (tools/k1_k14_sweep.py
//   on an H100: 13.9 us, against 20.4 us for 544 CTAs of one warp, which
//   put 5 on some SMs and 4 on others; 32- and 64-thread CTAs were no
//   faster at any path's shape).
// - The kQPT queries of a thread are independent chains that overlap, and
//   the compare is taken once per group of kGroup db points: a tree of
//   fminf, then one compare and two selects, no branch (about 1.3
//   instructions a pair instead of 3); the winning group's first equal
//   point is found once per chunk (see `scan`). A branch per group of 4
//   instead ran 10-40% slower on the same sweep.
// - The db is staged as one float4 (x, y, z, pen) per point, so one
//   broadcast LDS.128 feeds every query of a thread, and each chunk of
//   kChunk points arrives by 4-byte cp.async into a two-stage ring while
//   the previous one is compared. A chunk whose penalties are all 0 skips
//   the penalty add (adding 0.0f to a d2 >= 0 is exact).
// - The merge across slices: each CTA of a multi-slice launch writes its
//   partial (d2, i) to part [S, B, M]; the last CTA of a query tile to
//   finish (an atomic ticket per (b, tile)) merges the S partials in slice
//   order with a strict '<' from (1e30, 0) -- the same answer as one scan
//   in ascending index, ties across slice boundaries included -- loading 8
//   slices' partials at once, and puts the ticket back to 0, so the
//   tickets need no clearing launch between calls. No float atomics:
//   every run gives the same bits.
#include <cuda_runtime.h>

namespace {

constexpr int kQPT = 4;            // queries per thread
constexpr int kThreads = 128;      // CTA width
constexpr int kGroup = 8;          // db points whose minimum one compare takes
constexpr int kChunk = 256;        // db points per ring stage (4 KB)
constexpr int kMergeAhead = 8;     // slices a merge loads at once
constexpr float kBig = 1e30f;

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

// db points [lo, lo + len) of one batch element into a ring stage
__device__ __forceinline__ void stage(float4* buf, const float* dbb,
                                      const float* penb, int lo, int len) {
  for (int c = threadIdx.x; c < len; c += kThreads) {
    const float* p = dbb + (size_t)(lo + c) * 3;
    cp_async4(&buf[c].x, p);
    cp_async4(&buf[c].y, p + 1);
    cp_async4(&buf[c].z, p + 2);
    cp_async4(&buf[c].w, penb + lo + c);
  }
}

// whether every penalty this thread staged is 0 (its own copies are
// complete after cp.async.wait_group)
__device__ __forceinline__ bool staged_valid(const float4* buf, int len) {
  bool ok = true;
  for (int c = threadIdx.x; c < len; c += kThreads) ok &= buf[c].w == 0.0f;
  return ok;
}

template <bool kPen>
__device__ __forceinline__ float dist2(float qx, float qy, float qz,
                                       const float4& p) {
  const float dx = __fsub_rn(qx, p.x);
  const float dy = __fsub_rn(qy, p.y);
  const float dz = __fsub_rn(qz, p.z);
  float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
  d2 = __fadd_rn(d2, __fmul_rn(dz, dz));
  return kPen ? __fadd_rn(d2, p.w) : d2;
}

// The points of one chunk against each query, kGroup at a time: the
// group's minimum m replaces the best when m < best, and the group's first
// index is kept (bg); adds only min, compare and two selects a group, no
// branch. The index is resolved at the chunk's end, while its points are
// still staged: the first point of group bg whose d2 equals the best -- so
// the result is what a strict '<' in ascending index gives (fminf passes a
// NaN over, as the compare would; a later group with the same minimum does
// not replace an earlier one). The last len % kGroup points take the
// plain compare.
template <bool kPen>
__device__ __forceinline__ void scan(const float4* buf, int len, int base,
                                     const float (&qx)[kQPT],
                                     const float (&qy)[kQPT],
                                     const float (&qz)[kQPT],
                                     float (&best)[kQPT], int (&bi)[kQPT]) {
  int bg[kQPT];
#pragma unroll
  for (int k = 0; k < kQPT; ++k) bg[k] = -1;
  const int lenG = len - len % kGroup;
  for (int c = 0; c < lenG; c += kGroup) {
    float4 p[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) p[j] = buf[c + j];
#pragma unroll
    for (int k = 0; k < kQPT; ++k) {
      float m = dist2<kPen>(qx[k], qy[k], qz[k], p[0]);
#pragma unroll
      for (int j = 1; j < kGroup; ++j)
        m = fminf(m, dist2<kPen>(qx[k], qy[k], qz[k], p[j]));
      const bool better = m < best[k];
      best[k] = better ? m : best[k];
      bg[k] = better ? c : bg[k];
    }
  }
#pragma unroll
  for (int k = 0; k < kQPT; ++k) {
    if (bg[k] < 0) continue;
    int j = 0;       // the group holds the best: the first equal point
    while (j < kGroup - 1 &&
           dist2<true>(qx[k], qy[k], qz[k], buf[bg[k] + j]) != best[k])
      ++j;
    bi[k] = base + bg[k] + j;
  }
  for (int c = lenG; c < len; ++c) {
    const float4 p = buf[c];
#pragma unroll
    for (int k = 0; k < kQPT; ++k) {
      const float d = dist2<kPen>(qx[k], qy[k], qz[k], p);
      if (d < best[k]) {
        best[k] = d;
        bi[k] = base + c;
      }
    }
  }
}

// grid (tiles * slices, B); CTA (tile, s) = blockIdx.x / slices, % slices
__global__ void __launch_bounds__(kThreads)
nn1_kernel(const float* __restrict__ query, const float* __restrict__ db,
           const float* __restrict__ pen, float* __restrict__ d2_out,
           int* __restrict__ idx_out, float* __restrict__ part_d2,
           int* __restrict__ part_idx, int* __restrict__ tickets, int M,
           int N, int tiles, int slices, int slice_len) {
  __shared__ float4 ring[2][kChunk];
  __shared__ int s_last;
  constexpr int T = kThreads;
  const int b = blockIdx.y, B = gridDim.y;
  const int tile = blockIdx.x / slices, s = blockIdx.x % slices;
  const int q0 = tile * T * kQPT + threadIdx.x;   // query k: q0 + k * T

  float qx[kQPT], qy[kQPT], qz[kQPT], best[kQPT];
  int bi[kQPT];
#pragma unroll
  for (int k = 0; k < kQPT; ++k) {
    const int q = min(q0 + k * T, M - 1);
    const float* qp = query + ((size_t)b * M + q) * 3;
    qx[k] = qp[0];
    qy[k] = qp[1];
    qz[k] = qp[2];
    best[k] = kBig;
    bi[k] = 0;
  }

  const float* dbb = db + (size_t)b * N * 3;
  const float* penb = pen + (size_t)b * N;
  const int lo = s * slice_len, hi = min(N, lo + slice_len);
  const int chunks = hi > lo ? (hi - lo + kChunk - 1) / kChunk : 0;
  if (chunks > 0) {
    stage(ring[0], dbb, penb, lo, min(kChunk, hi - lo));
    cp_async_commit();
  }
  for (int ch = 0; ch < chunks; ++ch) {
    const int start = lo + ch * kChunk;
    const int len = min(kChunk, hi - start);
    if (ch + 1 < chunks) {   // the next chunk flies while this one is scanned
      stage(ring[(ch + 1) & 1], dbb, penb, start + kChunk,
            min(kChunk, hi - start - kChunk));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const float4* buf = ring[ch & 1];
    if (__syncthreads_and(staged_valid(buf, len)))
      scan<false>(buf, len, start, qx, qy, qz, best, bi);
    else
      scan<true>(buf, len, start, qx, qy, qz, best, bi);
    __syncthreads();         // the stage is refilled two chunks on
  }

  if (slices == 1) {
#pragma unroll
    for (int k = 0; k < kQPT; ++k) {
      const int q = q0 + k * T;
      if (q < M) {
        d2_out[(size_t)b * M + q] = best[k];
        idx_out[(size_t)b * M + q] = bi[k];
      }
    }
    return;
  }

#pragma unroll
  for (int k = 0; k < kQPT; ++k) {
    const int q = q0 + k * T;
    if (q < M) {
      const size_t o = ((size_t)s * B + b) * M + q;
      part_d2[o] = best[k];
      part_idx[o] = bi[k];
    }
  }
  __threadfence();           // the partials are visible before the ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    int* t = tickets + (size_t)b * tiles + tile;
    s_last = atomicAdd(t, 1) == slices - 1;
    if (s_last) *t = 0;      // every slice has arrived: ready for the next
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // slice order, strict '<'; the loads of kMergeAhead slices for all kQPT
  // queries are in flight before the first compare
  float bd[kQPT];
  int bx[kQPT];
#pragma unroll
  for (int k = 0; k < kQPT; ++k) {
    bd[k] = kBig;
    bx[k] = 0;
  }
  for (int j0 = 0; j0 < slices; j0 += kMergeAhead) {
    float v[kMergeAhead][kQPT];
    int x[kMergeAhead][kQPT];
#pragma unroll
    for (int u = 0; u < kMergeAhead; ++u) {
#pragma unroll
      for (int k = 0; k < kQPT; ++k) {
        const int q = q0 + k * T;
        const bool on = j0 + u < slices && q < M;
        const size_t o = ((size_t)(j0 + u) * B + b) * M + q;
        v[u][k] = on ? __ldcg(part_d2 + o) : kBig;
        x[u][k] = on ? __ldcg(part_idx + o) : 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kMergeAhead; ++u) {
#pragma unroll
      for (int k = 0; k < kQPT; ++k) {
        if (v[u][k] < bd[k]) {
          bd[k] = v[u][k];
          bx[k] = x[u][k];
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kQPT; ++k) {
    const int q = q0 + k * T;
    if (q < M) {
      d2_out[(size_t)b * M + q] = bd[k];
      idx_out[(size_t)b * M + q] = bx[k];
    }
  }
}

}  // namespace

// query [B,M,3], db [B,N,3], pen [B,N] f32 -> d2 [B,M] f32, idx [B,M] i32.
// The launch shape comes from the caller (nn1_plan): `tiles` query tiles
// of 128 threads x 4 queries, `slices` db slices of `slice_len` points.
// With slices > 1, part_d2 / part_idx hold [slices, B, M] partials and
// tickets B * tiles ints that are 0 before the call (and are 0 again after
// it).
extern "C" int pct_nn1(const float* query, const float* db, const float* pen,
                       float* d2, int* idx, float* part_d2, int* part_idx,
                       int* tickets, int B, int M, int N, int tiles,
                       int slices, int slice_len, cudaStream_t stream) {
  if (B <= 0 || M <= 0) return 0;
  if (N < 0 || slices < 1 || slice_len < 0 ||
      (long long)tiles * kThreads * kQPT < M ||
      (long long)slices * slice_len < N ||
      (slices > 1 && (!part_d2 || !part_idx || !tickets)))
    return (int)cudaErrorInvalidValue;
  dim3 grid(tiles * slices, B);
  nn1_kernel<<<grid, kThreads, 0, stream>>>(query, db, pen, d2, idx,
                                            part_d2, part_idx, tickets, M, N,
                                            tiles, slices, slice_len);
  return (int)cudaGetLastError();
}
