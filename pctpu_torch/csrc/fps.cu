// Kernels 10 and 11 fps: greedy furthest-point sampling, one CTA per cloud.
//
// Replaces the TPU kernels pctpu/ops/pallas_fps.py:_fps_kernel_batched
// (fps_pallas_batched, kernel 11) and _fps_kernel (fps_pallas, kernel 10,
// this entry at B = 1), which keep the cloud in VMEM and run the m-step
// loop inside one program.
//
// What it computes, bit for bit as the plain PyTorch version
// (pctpu_torch/ops/pallas_fps.py:fps_plain): idx[0] = 0; mind starts at
// 1e10; each step reads the last pick's xyz, d = (dx*dx + dy*dy) + dz*dz
// with every product and sum rounded on its own (__fmul_rn/__fadd_rn, and
// the library is built with --fmad=false), mind = min(mind, d); an
// ineligible point scores -1e30; the next pick is the highest score, the
// lowest index among equal scores (at both reduction levels).
//
// Bound on an H100: latency. Each of the m-1 steps is a dependent block
// reduction (a warp shuffle tree, shared memory, two barriers) over a few
// flops per point; at B = 32 only 32 of the 132 SMs have a cloud. The
// arithmetic (about 12 flops per point and step) and the bytes (12 B per
// point read once, 4 B per pick written) are far below what the card can
// do in that time.
//
// Design (a first, simple one): blockDim = min(1024, N rounded up to 32);
// thread t owns points t, t + T, t + 2T, ... and keeps their mind in
// registers (PER of them, a template constant) when N <= 16 T, else in a
// global scratch row. Points sit in shared memory as x, y, z rows when
// 12 N bytes fit, else they are read from global memory (through L1/L2).
#include <cuda_runtime.h>
#include <climits>
#include <cmath>

namespace {

constexpr int kMaxThreads = 1024;
constexpr float kNeg = -1e30f;
constexpr float kInitMind = 1e10f;
constexpr size_t kSmemPointsMax = 200 * 1024;   // bytes of xyz in smem

__device__ __forceinline__ float sqdist(float x, float y, float z, float lx,
                                        float ly, float lz) {
  const float dx = __fsub_rn(x, lx), dy = __fsub_rn(y, ly),
              dz = __fsub_rn(z, lz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// (score, index) pairs: a higher score wins, then a lower index
__device__ __forceinline__ void take_better(float& bs, int& bi, float os,
                                            int oi) {
  if (os > bs || (os == bs && oi < bi)) {
    bs = os;
    bi = oi;
  }
}

__device__ __forceinline__ void warp_best(float& bs, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float os = __shfl_down_sync(0xffffffffu, bs, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    take_better(bs, bi, os, oi);
  }
}

template <int PER>   // points per thread with mind in registers; 0: scratch
__global__ void __launch_bounds__(kMaxThreads)
fps_kernel(const float* __restrict__ pts, const unsigned char* __restrict__ elig,
           int* __restrict__ out, float* __restrict__ scratch, int N, int m,
           int smem_pts) {
  extern __shared__ float s_xyz[];   // x[N], y[N], z[N] when smem_pts
  __shared__ float red_s[32];
  __shared__ int red_i[32];
  __shared__ int s_last;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = T >> 5;
  const float* P = pts + (size_t)b * N * 3;
  const unsigned char* E = elig + (size_t)b * N;
  float* S = scratch + (size_t)b * N;

  const float *px, *py, *pz;
  int st;
  if (smem_pts) {
    for (int i = tid; i < N; i += T) {
      s_xyz[i] = P[(size_t)i * 3 + 0];
      s_xyz[N + i] = P[(size_t)i * 3 + 1];
      s_xyz[2 * N + i] = P[(size_t)i * 3 + 2];
    }
    px = s_xyz;
    py = s_xyz + N;
    pz = s_xyz + 2 * N;
    st = 1;
  } else {
    px = P;
    py = P + 1;
    pz = P + 2;
    st = 3;
  }
  float mind[PER > 0 ? PER : 1];
  if (PER > 0) {
#pragma unroll
    for (int k = 0; k < (PER > 0 ? PER : 1); ++k) mind[k] = kInitMind;
  } else {
    for (int i = tid; i < N; i += T) S[i] = kInitMind;
  }
  if (tid == 0) out[(size_t)b * m] = 0;
  __syncthreads();

  int last = 0;
  for (int step = 1; step < m; ++step) {
    const float lx = px[(size_t)last * st], ly = py[(size_t)last * st],
                lz = pz[(size_t)last * st];
    float bs = -INFINITY;
    int bi = INT_MAX;
    if (PER > 0) {
#pragma unroll
      for (int k = 0; k < (PER > 0 ? PER : 1); ++k) {
        const int i = tid + k * T;
        if (i < N) {
          const float d = sqdist(px[(size_t)i * st], py[(size_t)i * st],
                                 pz[(size_t)i * st], lx, ly, lz);
          mind[k] = fminf(mind[k], d);
          const float s = E[i] ? mind[k] : kNeg;
          if (s > bs) {   // ascending i: the first maximum stays
            bs = s;
            bi = i;
          }
        }
      }
    } else {
      for (int i = tid; i < N; i += T) {
        const float d = sqdist(px[(size_t)i * st], py[(size_t)i * st],
                               pz[(size_t)i * st], lx, ly, lz);
        const float md = fminf(S[i], d);
        S[i] = md;
        const float s = E[i] ? md : kNeg;
        if (s > bs) {
          bs = s;
          bi = i;
        }
      }
    }
    warp_best(bs, bi);
    if (lane == 0) {
      red_s[warp] = bs;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bs = lane < nwarps ? red_s[lane] : -INFINITY;
      bi = lane < nwarps ? red_i[lane] : INT_MAX;
      warp_best(bs, bi);
      if (lane == 0) {
        s_last = bi;
        out[(size_t)b * m + step] = bi;
      }
    }
    __syncthreads();
    last = s_last;
  }
}

template <int PER>
cudaError_t launch(const float* pts, const unsigned char* elig, int* idx,
                   float* scratch, int B, int N, int m, int threads,
                   int smem_pts, cudaStream_t stream) {
  const size_t smem = smem_pts ? (size_t)N * 3 * sizeof(float) : 0;
  if (smem > 0) {   // the static reduction buffers count against 48 KB too
    const cudaError_t e = cudaFuncSetAttribute(
        fps_kernel<PER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  fps_kernel<PER><<<B, threads, smem, stream>>>(pts, elig, idx, scratch, N,
                                                m, smem_pts);
  return cudaGetLastError();
}

}  // namespace

// pts [B,N,3] f32, elig [B,N] bool (1 byte), scratch [B,N] f32 ->
// idx [B,m] i32.
extern "C" int pct_fps(const float* pts, const unsigned char* elig, int* idx,
                       float* scratch, int B, int N, int m,
                       cudaStream_t stream) {
  if (B <= 0 || m <= 0) return 0;
  if (N <= 0) return (int)cudaErrorInvalidValue;
  const int threads = N >= kMaxThreads ? kMaxThreads : ((N + 31) / 32) * 32;
  const int per = (N + threads - 1) / threads;
  const int smem_pts = (size_t)N * 3 * sizeof(float) <= kSmemPointsMax;
  cudaError_t e;
  if (per <= 1)
    e = launch<1>(pts, elig, idx, scratch, B, N, m, threads, smem_pts, stream);
  else if (per <= 2)
    e = launch<2>(pts, elig, idx, scratch, B, N, m, threads, smem_pts, stream);
  else if (per <= 4)
    e = launch<4>(pts, elig, idx, scratch, B, N, m, threads, smem_pts, stream);
  else if (per <= 8)
    e = launch<8>(pts, elig, idx, scratch, B, N, m, threads, smem_pts, stream);
  else if (per <= 16)
    e = launch<16>(pts, elig, idx, scratch, B, N, m, threads, smem_pts,
                   stream);
  else
    e = launch<0>(pts, elig, idx, scratch, B, N, m, threads, smem_pts, stream);
  return (int)e;
}
