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
// an exact copy.
//
// Kernel 14, as the plain version (pctpu_torch/ops/pallas_gather.py:
// scatter_add_rows_plain): out[b, n, :] = the sum of g[b, i, :] over the i
// with clip(idx[b, i], 0, N-1) == n, added one at a time in ascending i onto
// 0.0f -- the TPU kernel's sequential order. No float atomics: a float sum
// taken in the order atomics land changes from run to run.
//
// Bound on an H100: bytes. Kernel 13 reads each index and copies C floats
// per row; kernel 14 reads g once (M*C floats) and writes B*N*C floats.
// One add per read float; the inverted index costs a few integer operations
// per entry.
//
// Design (a first, simple one):
// - Kernel 13: one warp per output row, the lanes over channels, so both
//   the read of the table row and the write are coalesced.
// - Kernel 14 in two launches. (a) bucket_kernel, one CTA per batch
//   element: a stable counting sort of the clipped idx -- integer counts
//   (int atomics give the same counts in any order), an exclusive block
//   scan into the bucket starts, then warp 0 walks the entries in ascending
//   i, 32 at a time, and places each at its bucket's cursor plus its rank
//   among the equal keys of its group of 32 (__match_any_sync), which keeps
//   each bucket in ascending i. Counts and keys sit in shared memory when
//   (N + M) ints fit, else in a global scratch row. (b) bucket_sum_kernel,
//   one warp per output row (b, n), the lanes over channels: each lane adds
//   its channel of the bucket's g rows in bucket order.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;              // warps per block of the row kernels
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

// start [B, N+1], order [B, M]; scratch [B, N+M] used when !in_smem
__global__ void __launch_bounds__(kSortThreads)
bucket_kernel(const int* __restrict__ idx, int* __restrict__ start,
              int* __restrict__ order, int* __restrict__ scratch, int N,
              int M, int in_smem) {
  extern __shared__ int s_sort[];   // cur[N], keys[M] when in_smem
  __shared__ int warp_sums[32];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = T >> 5;
  const int* I = idx + (size_t)b * M;
  int* cur = in_smem ? s_sort : scratch + (size_t)b * (N + M);
  int* keys = cur + N;
  int* S = start + (size_t)b * (N + 1);
  int* O = order + (size_t)b * M;

  for (int n = tid; n < N; n += T) cur[n] = 0;
  __syncthreads();
  for (int i = tid; i < M; i += T) {
    const int k = clip_row(I[i], N);
    keys[i] = k;
    atomicAdd(&cur[k], 1);
  }
  __syncthreads();

  // exclusive scan of the counts: thread t owns the run [t*seg, t*seg+seg)
  const int seg = (N + T - 1) / T;
  const int lo = min(N, tid * seg), hi = min(N, lo + seg);
  int run = 0;
  for (int n = lo; n < hi; ++n) run += cur[n];
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
    const int c = cur[n];
    S[n] = base;
    cur[n] = base;   // from here on: the bucket's next free slot
    base += c;
  }
  if (tid == 0) S[N] = M;
  __syncthreads();

  // stable placement: warp 0 alone, groups of 32 entries in ascending i
  if (warp == 0) {
    for (int i0 = 0; i0 < M; i0 += 32) {
      const int i = i0 + lane;
      const bool valid = i < M;
      const int k = valid ? keys[i] : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, k);
      if (valid) O[cur[k] + __popc(peers & ((1u << lane) - 1u))] = i;
      __syncwarp();
      if (valid && lane == __ffs(peers) - 1) cur[k] += __popc(peers);
      __syncwarp();
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
bucket_sum_kernel(const float* __restrict__ g, const int* __restrict__ start,
                  const int* __restrict__ order, float* __restrict__ out,
                  int B, int N, int M, int C) {
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= (long long)B * N) return;
  const int lane = threadIdx.x & 31;
  const long long b = row / N;
  const int n = (int)(row - b * N);
  const int* S = start + b * (N + 1);
  const int* O = order + b * M;
  const int s = S[n], e = S[n + 1];
  const float* G = g + (size_t)b * M * C;
  float* dst = out + (size_t)row * C;
  for (int c = lane; c < C; c += 32) {
    float acc = 0.0f;
    for (int j = s; j < e; ++j) acc = __fadd_rn(acc, G[(size_t)O[j] * C + c]);
    dst[c] = acc;
  }
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

// g [B,M,C] f32, idx [B,M] i32 -> out [B,N,C] f32; start [B,N+1], order
// [B,M] and scratch [B,N+M] are int32 work buffers of the caller.
extern "C" int pct_scatter_add_rows(const float* g, const int* idx,
                                    int* start, int* order, int* scratch,
                                    float* out, int B, int M, int N, int C,
                                    cudaStream_t stream) {
  if (B <= 0 || C <= 0) return 0;
  if (N <= 0 || M < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(N + M) * sizeof(int);
  const int in_smem = smem <= kSortSmemMax;
  if (in_smem && smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bucket_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  bucket_kernel<<<B, kSortThreads, in_smem ? smem : 0, stream>>>(
      idx, start, order, scratch, N, M, in_smem);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bucket_sum_kernel<<<row_blocks((long long)B * N), kWarps * 32, 0,
                      stream>>>(g, start, order, out, B, N, M, C);
  return (int)cudaGetLastError();
}
