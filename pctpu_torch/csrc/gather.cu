// Kernels 13 gather_rows and 14 scatter_add_rows: the row gather and its
// transpose, a deterministic row scatter-add.
//
// Replace the TPU kernels pctpu/ops/pallas_gather.py:_gather_kernel
// (gather_rows_pallas) and _scatter_add_kernel (scatter_add_rows_pallas),
// which keep the whole [N, C] table (or output) of one batch element in VMEM
// and copy (or add) one row per step of a sequential loop.
//
// Kernel 13, as the plain version (pctpu_torch/ops/gather.py:
// _flat_row_gather): out[b, i, :] = table[b, clip(idx[b, i], 0, N-1), :],
// an exact copy. One warp per output row, the lanes over channels, so both
// the read of the table row and the write are coalesced.
//
// Kernel 14, as the plain version (pctpu_torch/ops/pallas_gather.py:
// scatter_add_rows_plain): out[b, n, :] = the sum of g[b, i, :] over the i
// with clip(idx[b, i], 0, N-1) == n, added one at a time in ascending i onto
// 0.0f -- the TPU kernel's sequential order. No float atomics: a float sum
// taken in the order atomics land changes from run to run.
//
// Bound on an H100: bytes. Kernel 13 reads each index and copies C floats
// per row; kernel 14 reads g once (M*C floats) and writes B*N*C floats, one
// add per read float; the inverted index costs a few integer operations per
// entry.
//
// Kernel 14 is two launches, which pct_scatter_add_rows makes in order and
// pct_scatter_sort / pct_scatter_sum expose apart for timing:
// (a) bucket_kernel, a stable counting sort of the clipped idx into bucket
//     starts and an order, one CTA per batch element. The first design
//     placed the entries with warp 0 alone, M/32 serial steps (0.143 ms of
//     2.611 at B 32 x M 16,384 on an H100). Now the entries are cut into
//     one run per warp: per-run counts of each key, one scan, and every
//     warp places its own run (M/1024 steps), ranks within a group of 32
//     by __match_any_sync, as before. Integer-only and stable.
// (b) bucket_sum_kernel. The first design gave one warp to each output
//     row and ran the channels outside, the bucket inside: every lane
//     walked the bucket ceil(C/32) times, re-reading order[j] and adding
//     each g value to one accumulator, a serial chain of dependent loads
//     and adds (2.462 ms for the sum at the same shape, where the
//     ball-query padding puts hundreds of entries in the buckets of low
//     point indices). Now one warp takes a (row, chunk of 128 channels)
//     task, the bucket outside: it reads 32 entries of order at once and
//     shuffles them out, keeps kAhead g rows in flight, and each lane adds
//     a row's 4 channels, read by one 16-byte load, onto 4 accumulators.
//     Where C % 4 != 0 the rows start at any 4-byte offset: the chunks are
//     124 channels, and a lane takes the floats past its aligned 16 bytes
//     from its neighbour's load by a shuffle (scalar loads ran at a quarter
//     of the rate). The tasks run point-major, so the long buckets of low
//     indices start first. Each channel still receives its adds in
//     ascending i, so the sums are bit-identical to the plain version's.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;              // warps per block of kernel 13
constexpr int kSumWarps = 8;           // warps (tasks) per sum block
constexpr int kAhead = 16;             // g rows a warp loads ahead
constexpr int kSortThreads = 1024;     // threads of bucket_kernel
constexpr size_t kSortSmemMax = 200 * 1024;   // bytes of counts + keys

__device__ __forceinline__ int clip_row(int j, int N) {
  return j < 0 ? 0 : (j >= N ? N - 1 : j);
}

__global__ void __launch_bounds__(kWarps * 32)
gather_rows_kernel(const float* __restrict__ table,
                   const int* __restrict__ idx, float* __restrict__ out,
                   int B, int N, int M, int C) {
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= (long long)B * M) return;   // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const long long b = row / M;
  const int j = clip_row(idx[row], N);
  const float* src = table + ((size_t)b * N + j) * C;
  float* dst = out + (size_t)row * C;
  for (int c = lane; c < C; c += 32) dst[c] = src[c];
}

// The stable counting sort of one batch element per CTA: start [B, N+1]
// (each bucket's first slot), order [B, M] (the entries i, bucket by
// bucket, ascending i within each). The M entries are cut into `parts`
// contiguous runs, one per warp (parts <= 32, a power of two); cnt[p][k]
// counts key k in run p. One exclusive scan over the keys of the summed
// counts gives the bucket starts, and a walk over the runs of each key
// gives run p its first slot in bucket k. Then each of the `parts` warps
// places its run in ascending i, 32 entries at a time, each at its slot
// plus its rank among the equal keys of its group (__match_any_sync).
// cnt [parts*N] and keys [M] sit in shared memory when in_smem, else in
// scratch [B, N+M] (parts = 1). Integer-only: any order of the count
// atomics gives the same counts.
__global__ void __launch_bounds__(kSortThreads)
bucket_kernel(const int* __restrict__ idx, int* __restrict__ start,
              int* __restrict__ order, int* __restrict__ scratch, int N,
              int M, int parts, int in_smem) {
  extern __shared__ int s_sort[];   // cnt[parts * N], keys[M] when in_smem
  __shared__ int warp_sums[32];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = T >> 5;
  const int* I = idx + (size_t)b * M;
  int* cnt = in_smem ? s_sort : scratch + (size_t)b * (N + M);
  int* keys = cnt + (size_t)parts * N;
  int* S = start + (size_t)b * (N + 1);
  int* O = order + (size_t)b * M;
  const int run_len = (M + parts - 1) / parts;

  for (int n = tid; n < parts * N; n += T) cnt[n] = 0;
  __syncthreads();
  for (int i = tid; i < M; i += T) {
    const int k = clip_row(I[i], N);
    keys[i] = k;
    atomicAdd(&cnt[(i / run_len) * N + k], 1);
  }
  __syncthreads();

  // exclusive scan of the keys' totals: thread t owns keys [t*seg, +seg)
  const int seg = (N + T - 1) / T;
  const int lo = min(N, tid * seg), hi = min(N, lo + seg);
  int run = 0;
  for (int n = lo; n < hi; ++n)
    for (int p = 0; p < parts; ++p) run += cnt[p * N + n];
  int incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += v;
    }
    warp_sums[lane] = w;   // inclusive over the warps
  }
  __syncthreads();
  int base = incl - run + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int n = lo; n < hi; ++n) {
    S[n] = base;
    for (int p = 0; p < parts; ++p) {   // from here on: run p's next slot
      const int c = cnt[p * N + n];
      cnt[p * N + n] = base;
      base += c;
    }
  }
  if (tid == 0) S[N] = M;
  __syncthreads();

  // stable placement: warp p walks run p in ascending i, 32 at a time
  if (warp < parts) {
    int* cur = cnt + (size_t)warp * N;
    const int end = min(M, (warp + 1) * run_len);
    for (int i0 = warp * run_len; i0 < end; i0 += 32) {
      const int i = i0 + lane;
      const bool valid = i < end;
      const int k = valid ? keys[i] : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, k);
      if (valid) O[cur[k] + __popc(peers & ((1u << lane) - 1u))] = i;
      __syncwarp();
      if (valid && lane == __ffs(peers) - 1) cur[k] += __popc(peers);
      __syncwarp();
    }
  }
}

// One warp per task, a (output row (b, n), chunk of channels) pair, and
// kSumWarps tasks per CTA, the chunks of a row side by side, the rows in
// the order (n, b). A lane owns 4
// consecutive channels and reads them with one 16-byte load per g row:
// - kAligned (C % 4 == 0, g and out 16-byte aligned): chunks of 128
//   channels, lane L's at 4L;
// - else a g row starts `off` floats past a 16-byte boundary (0-3, per
//   row): chunks of 124 channels; lane L loads the aligned 16 bytes that
//   hold its first channel and takes the rest from lane L + 1's load by a
//   shuffle (lane 31 only feeds lane 30). Every load holds at least one
//   float of its row.
// The bucket's entries run outside the channels: the warp reads 32 entries
// of `order` at once and shuffles each out, loads kAhead g rows before
// adding the first, and adds each onto its 4 accumulators in bucket order
// (ascending i), so the sums are bit-identical to the plain version's.
template <bool kAligned>
__global__ void __launch_bounds__(kSumWarps * 32)
bucket_sum_kernel(const float* __restrict__ g, const int* __restrict__ start,
                  const int* __restrict__ order, float* __restrict__ out,
                  int B, int N, int M, int C, int chunks) {
  constexpr int kWidth = kAligned ? 128 : 124;   // channels per chunk
  const long long task =
      (long long)blockIdx.x * kSumWarps + (threadIdx.x >> 5);
  if (task >= (long long)B * N * chunks) return;   // whole warps leave
  const int lane = threadIdx.x & 31;
  // tasks run point-major (all batch elements' row 0 first): ball-query
  // indices pad each ball with its lowest-index hit, so the longest
  // buckets sit at low n, and their tasks start first
  const long long rt = task / chunks;
  const int c0 = (int)(task - rt * chunks) * kWidth;
  const int n = (int)(rt / B);
  const long long b = rt - (long long)n * B;
  const long long row = b * N + n;
  const int* S = start + b * (N + 1);
  const int* O = order + b * M;
  const int s = S[n], e = S[n + 1];
  const float* G = g + (size_t)b * M * C;
  const int cl = c0 + 4 * lane;   // this lane's first channel (and block)

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int j0 = s; j0 < e; j0 += 32) {
    const int cnt = min(32, e - j0);
    const int mine = lane < cnt ? O[j0 + lane] : 0;
    for (int t = 0; t < cnt; t += kAhead) {
      float4 val[kAhead];
      int off[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int r = __shfl_sync(0xffffffffu, mine, (t + u) & 31);
        const float* src = G + (size_t)r * C;
        off[u] = kAligned ? 0 : (int)((reinterpret_cast<size_t>(src) >> 2) & 3);
        const float4* blk = reinterpret_cast<const float4*>(src - off[u]) +
                            (c0 >> 2) + lane;
        val[u] = t + u < cnt && cl < C + off[u]
                     ? __ldg(blk)
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if (t + u >= cnt) break;   // warp-uniform
        float4 v = val[u];
        if (!kAligned) {
          // channels cl..cl+3 sit at positions off..off+3 of this block and
          // the next one (lane + 1's)
          const float4 nb = make_float4(
              __shfl_down_sync(0xffffffffu, v.x, 1),
              __shfl_down_sync(0xffffffffu, v.y, 1),
              __shfl_down_sync(0xffffffffu, v.z, 1),
              __shfl_down_sync(0xffffffffu, v.w, 1));
          const int o = off[u];
          v = o == 0 ? v
            : o == 1 ? make_float4(v.y, v.z, v.w, nb.x)
            : o == 2 ? make_float4(v.z, v.w, nb.x, nb.y)
                     : make_float4(v.w, nb.x, nb.y, nb.z);
        }
        acc[0] = __fadd_rn(acc[0], v.x);
        acc[1] = __fadd_rn(acc[1], v.y);
        acc[2] = __fadd_rn(acc[2], v.z);
        acc[3] = __fadd_rn(acc[3], v.w);
      }
    }
  }
  float* dst = out + (size_t)row * C;
  if (kAligned) {
    if (cl < C)
      *reinterpret_cast<float4*>(dst + cl) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else if (lane < 31) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (cl + k < C) dst[cl + k] = acc[k];
  }
}

template <bool kAligned>
cudaError_t launch_sum(const float* g, const int* start, const int* order,
                       float* out, int B, int N, int M, int C,
                       cudaStream_t stream) {
  const int width = kAligned ? 128 : 124;
  const int chunks = (C + width - 1) / width;
  const long long tasks = (long long)B * N * chunks;
  bucket_sum_kernel<kAligned>
      <<<(unsigned)((tasks + kSumWarps - 1) / kSumWarps), kSumWarps * 32, 0,
         stream>>>(g, start, order, out, B, N, M, C, chunks);
  return cudaGetLastError();
}

unsigned row_blocks(long long rows) {
  return (unsigned)((rows + kWarps - 1) / kWarps);
}

}  // namespace

// table [B,N,C] f32, idx [B,M] i32 -> out [B,M,C] f32.
extern "C" int pct_gather_rows(const float* table, const int* idx, float* out,
                               int B, int N, int M, int C,
                               cudaStream_t stream) {
  if (B <= 0 || M <= 0 || C <= 0) return 0;
  if (N <= 0) return (int)cudaErrorInvalidValue;
  gather_rows_kernel<<<row_blocks((long long)B * M), kWarps * 32, 0,
                       stream>>>(table, idx, out, B, N, M, C);
  return (int)cudaGetLastError();
}

// Kernel 14, first half: the stable bucket sort of idx [B,M] i32 into
// start [B,N+1] and order [B,M]; scratch [B,N+M] is read only when the
// (N + M) ints do not fit in shared memory.
extern "C" int pct_scatter_sort(const int* idx, int* start, int* order,
                                int* scratch, int B, int M, int N,
                                cudaStream_t stream) {
  if (B <= 0) return 0;
  if (N <= 0 || M < 0) return (int)cudaErrorInvalidValue;
  // as many runs (warps) as shared memory holds counts for; one run over
  // the global scratch when not even cnt[N] and keys[M] fit
  int parts = kSortThreads / 32;
  while (parts > 1 && (size_t)(parts * N + M) * sizeof(int) > kSortSmemMax)
    parts >>= 1;
  const size_t smem = (size_t)(parts * N + M) * sizeof(int);
  const int in_smem = smem <= kSortSmemMax;
  if (in_smem && smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bucket_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  bucket_kernel<<<B, kSortThreads, in_smem ? smem : 0, stream>>>(
      idx, start, order, scratch, N, M, parts, in_smem);
  return (int)cudaGetLastError();
}

// Kernel 14, second half: out [B,N,C] f32 = the sums of g [B,M,C] f32 over
// the buckets that pct_scatter_sort left in start and order.
extern "C" int pct_scatter_sum(const float* g, const int* start,
                               const int* order, float* out, int B, int M,
                               int N, int C, cudaStream_t stream) {
  if (B <= 0 || C <= 0) return 0;
  if (N <= 0 || M < 0) return (int)cudaErrorInvalidValue;
  const bool aligned = C % 4 == 0 &&
                       (reinterpret_cast<size_t>(g) & 15) == 0 &&
                       (reinterpret_cast<size_t>(out) & 15) == 0;
  return (int)(aligned
                   ? launch_sum<true>(g, start, order, out, B, N, M, C, stream)
                   : launch_sum<false>(g, start, order, out, B, N, M, C,
                                       stream));
}

// g [B,M,C] f32, idx [B,M] i32 -> out [B,N,C] f32: the sort, then the sum;
// start [B,N+1], order [B,M] and scratch [B,N+M] are int32 work buffers of
// the caller.
extern "C" int pct_scatter_add_rows(const float* g, const int* idx,
                                    int* start, int* order, int* scratch,
                                    float* out, int B, int M, int N, int C,
                                    cudaStream_t stream) {
  if (B <= 0 || C <= 0) return 0;
  const int e = pct_scatter_sort(idx, start, order, scratch, B, M, N, stream);
  if (e != 0) return e;
  return pct_scatter_sum(g, start, order, out, B, M, N, C, stream);
}
