// Kernel V, voxel_run_means: the centroid of each voxel of a full-capacity
// voxel downsample, from its contiguous run of cell-lexsorted points.
//
// Replaces no TPU kernel: the JAX package sums each voxel with
// jax.ops.segment_sum (pctpu/ops/voxel.py:66), plain XLA. The plain PyTorch
// version (pctpu_torch/ops/voxel.py:_run_means_plain) takes each sum as the
// difference of a float64 torch.cumsum over [N, 4] at the run's two ends.
// On the card that cumsum runs along the slow axis, where PyTorch gives each
// of the 4 columns one thread that walks all N rows in sequence: 20 ms of
// device time for a 124,668-point HDL-64E scan. This kernel needs no scan:
// the runs are contiguous after the lexsort, so each voxel sums its own.
//
// What it computes, for voxel v (ps [N,3] float32, ms and new_run [N] bool,
// s_v [N] int64, *nv int64, out [N,3] float32):
// - v < nv: the run is the rows from s_v[v] on, up to the first row that is
//   masked out or starts the next run (new_run), or N. x, y, z are summed in
//   float64 in ascending row order onto 0.0, the count as an integer; then
//   out[v] = (float)(sum / max(count, 1)), one division and one rounding, as
//   the plain version's `(sums[:, :3] / clamp_min(count, 1)).float()`. The
//   result equals a host float64 sum of the run in row order, rounded once,
//   bit for bit; the plain version's prefix differences may land one float32
//   ulp away (cancellation against a prefix of up to ~1e7 m).
// - v >= nv: out[v] = 0. voxel_downsample overwrites those rows.
// No atomics and a fixed order, so every run gives the same bits.
//
// Bound on an H100: bytes. It reads each valid row once (12 bytes of point,
// 2 flag bytes) and the nv run starts, and writes N rows: ~3.2 MB at
// N 124,668, about 1 us at 3.35 TB/s. Its time is the longest run, whose
// in-order sum is one chain of dependent float64 adds (10,644 rows in a 2 m
// voxel near the sensor of the benchmark's scans). Each voxel has a warp:
// the 32 lanes read 32 consecutive rows at once (coalesced), a ballot finds
// the first row past the run, the lanes put their rows in float64 in the
// warp's slice of shared memory, and every lane adds the chunk's rows from
// there in row order, while the next chunk's loads are in flight. Every lane
// holds the same sums; lane 0 writes them. Warps stride over the voxels and
// all threads over the padding rows, from a grid of at most kMaxBlocks
// blocks whatever nv is (it is read on the card only). Device time for the
// two clouds of one benchmark pair on an H100 (PERF.md, row V): 2.2 ms with
// a thread a voxel reading its run 16 rows at a time, 0.77 ms with a warp a
// voxel handing the rows round by __shfl_sync, 0.33 ms from shared memory.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kMaxBlocks = 4096;
constexpr unsigned kFull = 0xffffffffu;

// Row r of voxel v's run (whose first row is s): its point, and whether it
// ends the run (past N, masked out, or the next run's first row). Rows past
// N read row N - 1, so every lane loads.
__device__ __forceinline__ void load_row(const float* __restrict__ ps,
                                         const unsigned char* __restrict__ ms,
                                         const unsigned char* __restrict__ nr,
                                         long long r, long long s, long long n,
                                         float& x, float& y, float& z,
                                         bool& stop) {
  const bool in = r < n;
  const long long rc = in ? r : n - 1;
  x = ps[3 * rc];
  y = ps[3 * rc + 1];
  z = ps[3 * rc + 2];
  const unsigned char valid = ms[rc], start = nr[rc];   // both loads at once
  stop = !in | (valid == 0) | ((r != s) & (start != 0));
}

__global__ void __launch_bounds__(kThreads)
run_means_kernel(const float* __restrict__ ps,
                 const unsigned char* __restrict__ ms,
                 const unsigned char* __restrict__ new_run,
                 const long long* __restrict__ s_v,
                 const long long* __restrict__ nv_ptr,
                 float* __restrict__ out, long long n) {
  const long long nv = *nv_ptr;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long threads = (long long)gridDim.x * kThreads;
  for (long long i = nv + tid; i < n; i += threads) {
    out[3 * i] = 0.0f;
    out[3 * i + 1] = 0.0f;
    out[3 * i + 2] = 0.0f;
  }
  __shared__ double rows[kWarpsPerBlock][3][32];   // a warp's chunk, by axis
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (long long v = tid >> 5; v < nv; v += threads >> 5) {  // warp-uniform
    const long long s = s_v[v];
    double sx = 0.0, sy = 0.0, sz = 0.0;
    long long cnt = 0;
    float x, y, z;
    bool stop;
    load_row(ps, ms, new_run, s + lane, s, n, x, y, z, stop);
    for (long long r0 = s;; r0 += 32) {
      const unsigned stops = __ballot_sync(kFull, stop);
      const int take = stops ? __ffs(stops) - 1 : 32;
      float nx = 0.0f, ny = 0.0f, nz = 0.0f;
      bool nstop = true;
      if (!stops)
        load_row(ps, ms, new_run, r0 + 32 + lane, s, n, nx, ny, nz, nstop);
      // rows past the run add +0.0, which leaves a sum exactly as it is
      // (it starts at +0.0 and never reaches -0.0 under round-to-nearest)
      __syncwarp();                 // every lane is done with the last chunk
      rows[w][0][lane] = x;
      rows[w][1][lane] = y;
      rows[w][2][lane] = z;
      __syncwarp();
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const bool in_run = k < take;
        sx += in_run ? rows[w][0][k] : 0.0;
        sy += in_run ? rows[w][1][k] : 0.0;
        sz += in_run ? rows[w][2][k] : 0.0;
      }
      cnt += take;
      if (stops) break;
      x = nx;
      y = ny;
      z = nz;
      stop = nstop;
    }
    if (lane == 0) {
      const double c = cnt > 0 ? (double)cnt : 1.0;
      out[3 * v] = (float)(sx / c);
      out[3 * v + 1] = (float)(sy / c);
      out[3 * v + 2] = (float)(sz / c);
    }
  }
}

}  // namespace

extern "C" int pct_voxel_run_means(const float* ps, const unsigned char* ms,
                                   const unsigned char* new_run,
                                   const long long* s_v,
                                   const long long* nv, float* out, int n,
                                   cudaStream_t stream) {
  if (n <= 0) return 0;
  const long long want = ((long long)n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  run_means_kernel<<<blocks, kThreads, 0, stream>>>(ps, ms, new_run, s_v, nv,
                                                    out, (long long)n);
  return (int)cudaGetLastError();
}
