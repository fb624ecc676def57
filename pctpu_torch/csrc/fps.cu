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
// lowest index among equal scores.
//
// Bound on an H100: latency. Each of the m-1 steps is a dependent CTA-wide
// argmax over a few flops per point; the arithmetic (about 12 flops per
// point and step) and the bytes (12 B per point read once, 4 B per pick
// written) are far below what the card does in that time.
//
// Design, rebuilt around the step's latency (tools/fps_k8_sweep.py):
//  1. Everything a thread owns lives in registers: in the "registers" mode
//     the xyz and mind of its PER points t, t + T, ... (PER a template
//     constant); eligibility is folded in once, as an ineligible point's
//     mind starting at -1e30 (min(-1e30, d) = -1e30 for every d >= 0, so
//     the scores are the reference's bits), and the step loads nothing
//     from global memory. A shared-memory copy of the cloud gives every
//     thread the pick's xyz.
//  2. The winner is reduced on one 32-bit key, the score's bits mapped to
//     an order-preserving unsigned: __reduce_max_sync of the key, then
//     __reduce_min_sync of the index over the lanes that hold the maximum
//     (no shuffle trees).
//  3. One barrier a step: each warp writes (key, index) to a slot of the
//     step's parity, and after the barrier every warp reduces the partials
//     itself (block_winner), so no second barrier and no broadcast slot.
//     The empty step of this skeleton (pct_fps_floor) takes 0.15-0.25 us
//     at 32-1,024 threads; the first design's two barriers and shuffle
//     trees took 0.47-0.65 us, one redux and a ballot 0.18-0.28 (H100
//     80GB HBM3, 700 W).
//  4. The CTA width, PER and the mode come from the wrapper
//     (ops/pallas_fps.py:fps_plan). Past the register budget the "shared"
//     mode keeps mind in registers and reads xyz from shared memory each
//     step; past 16 points a thread, "scratch" keeps mind in a global row;
//     past shared memory, "global" reads xyz from global memory too.
// Measured limits (H100 80GB HBM3, 700 W): a step of SA1 (4,096 points,
// 256 threads) takes 0.50 us, 0.16 of it the empty step and the rest the
// 16 points a thread (about 12 instructions a point on one SM); one cloud
// on a thread-block cluster of 2-8 CTAs (partials written to every CTA's
// shared memory, one cluster barrier a step) floored at 0.77-0.89 us a
// step, so a cloud stays on one CTA. pct_fps_floor runs the step's
// skeleton without the distance work, for tools/fps_k8_sweep.py and
// chip_smoke.py.
#include <cuda_runtime.h>
#include <cmath>

namespace {

constexpr int kMaxThreads = 1024;
constexpr float kNeg = -1e30f;
constexpr float kInitMind = 1e10f;
constexpr size_t kSmemPointsMax = 200 * 1024;   // bytes of xyz in smem
constexpr int kRegBudget = 32768;   // registers a CTA spends on its points
enum Mode { kRegisters = 0, kShared = 1, kScratch = 2, kGlobal = 3 };

__device__ __forceinline__ float sqdist(float x, float y, float z, float lx,
                                        float ly, float lz) {
  const float dx = __fsub_rn(x, lx), dy = __fsub_rn(y, ly),
              dz = __fsub_rn(z, lz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// ---- a step's winner, and the empty step -------------------------------

// order-preserving map of a float score to an unsigned key
__device__ __forceinline__ unsigned score_key(float s) {
  const unsigned u = __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The CTA's winner of one step: the highest key, then the lowest index.
// Each warp reduces (key, index) with two redux instructions and writes
// its partial to the slot of the step's parity; after one barrier every
// warp reduces the partials itself. A warp writes slot p again two steps
// later, after the next barrier, which every warp passes only once it has
// read slot p: so one barrier a step suffices.
__device__ __forceinline__ int block_winner(unsigned key, unsigned idx,
                                            uint2 (*red)[32], int par,
                                            int lane, int warp, int nwarps) {
  const unsigned kmax = __reduce_max_sync(0xffffffffu, key);
  const unsigned imin =
      __reduce_min_sync(0xffffffffu, key == kmax ? idx : 0xffffffffu);
  if (lane == 0) red[par][warp] = make_uint2(kmax, imin);
  __syncthreads();
  const uint2 p = lane < nwarps ? red[par][lane] : make_uint2(0u, 0xffffffffu);
  const unsigned gmax = __reduce_max_sync(0xffffffffu, p.x);
  return (int)__reduce_min_sync(0xffffffffu, p.x == gmax ? p.y : 0xffffffffu);
}

// m - 1 steps of the step skeleton with no distance work: each thread's
// key depends on the last pick, then the CTA's winner, then the winner's
// xyz read from shared memory (N points); the floor of a step at this CTA
// width.
__global__ void __launch_bounds__(kMaxThreads)
fps_floor_kernel(int* __restrict__ out, int N, int m) {
  extern __shared__ float s_xyz[];
  __shared__ uint2 red[2][32];
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = T >> 5;
  for (int i = tid; i < 3 * N; i += T) s_xyz[i] = (float)i;
  __syncthreads();
  int last = 0;
  float acc = 0.f;
  for (int step = 1; step < m; ++step) {
    const unsigned key = ((unsigned)tid * 2654435761u)
                         ^ ((unsigned)last * 40503u)
                         ^ __float_as_uint(acc);
    last = min(block_winner(key, (unsigned)tid, red, step & 1, lane, warp,
                            nwarps),
               N - 1);
    acc = (s_xyz[last] + s_xyz[N + last]) + s_xyz[2 * N + last];
    if (tid == 0) out[(size_t)blockIdx.x * m + step] = last;
  }
}

// The largest CTA a template of the kernel takes: in the registers mode,
// 4 registers a point within kRegBudget.
constexpr int max_threads(int per, bool reg_xyz) {
  return reg_xyz && per > 0 && kRegBudget / (4 * per) < kMaxThreads
             ? kRegBudget / (4 * per) : kMaxThreads;
}

// PER > 0: each thread's PER points' mind in registers, their xyz too when
// REG_XYZ ("registers") or read from shared memory each step ("shared").
// PER == 0: mind in the global scratch row, xyz in shared memory when
// smem_pts ("scratch") or in global memory ("global").
template <int PER, bool REG_XYZ>
__global__ void __launch_bounds__(max_threads(PER, REG_XYZ))
fps_kernel(const float* __restrict__ pts, const unsigned char* __restrict__ elig,
           int* __restrict__ out, float* __restrict__ scratch, int N, int m,
           int smem_pts) {
  extern __shared__ float s_xyz[];   // x[N], y[N], z[N] when smem_pts
  __shared__ uint2 red[2][32];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = T >> 5;
  const float* P = pts + (size_t)b * N * 3;
  const unsigned char* E = elig + (size_t)b * N;
  float* S = scratch + (size_t)b * N;
  int* O = out + (size_t)b * m;

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
  constexpr int R = PER > 0 ? PER : 1;
  float x[R], y[R], z[R], mind[R];
  if (PER > 0) {
#pragma unroll
    for (int k = 0; k < R; ++k) {   // a point past N never wins: -inf
      const int i = tid + k * T;
      const bool in = i < N;
      mind[k] = in ? (E[i] ? kInitMind : kNeg) : -INFINITY;
      if (REG_XYZ) {
        x[k] = in ? P[(size_t)i * 3 + 0] : 0.f;
        y[k] = in ? P[(size_t)i * 3 + 1] : 0.f;
        z[k] = in ? P[(size_t)i * 3 + 2] : 0.f;
      }
    }
  } else {
    for (int i = tid; i < N; i += T) S[i] = E[i] ? kInitMind : kNeg;
  }
  if (tid == 0) O[0] = 0;
  __syncthreads();

  float lx = px[0], ly = py[0], lz = pz[0];
  for (int step = 1; step < m; ++step) {
    float bs;
    int bi;
    if (PER > 0) {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        float xk = x[k], yk = y[k], zk = z[k];
        if (!REG_XYZ) {   // a point past N reads point N - 1: its mind stays
          const int i = min(tid + k * T, N - 1);
          xk = px[i];
          yk = py[i];
          zk = pz[i];
        }
        mind[k] = fminf(mind[k], sqdist(xk, yk, zk, lx, ly, lz));
      }
      bs = mind[0];
      bi = tid;
#pragma unroll
      for (int k = 1; k < R; ++k)
        if (mind[k] > bs) {   // ascending index: the first maximum stays
          bs = mind[k];
          bi = tid + k * T;
        }
    } else {
      bs = -INFINITY;
      bi = tid;
      for (int i = tid; i < N; i += T) {
        const float md = fminf(S[i], sqdist(px[(size_t)i * st],
                                            py[(size_t)i * st],
                                            pz[(size_t)i * st], lx, ly, lz));
        S[i] = md;
        if (md > bs) {
          bs = md;
          bi = i;
        }
      }
    }
    const int last = block_winner(score_key(bs), (unsigned)bi, red, step & 1,
                                  lane, warp, nwarps);
    if (tid == 0) O[step] = last;
    lx = px[(size_t)last * st];
    ly = py[(size_t)last * st];
    lz = pz[(size_t)last * st];
  }
}

template <int PER, bool REG_XYZ>
cudaError_t launch(const float* pts, const unsigned char* elig, int* idx,
                   float* scratch, int B, int N, int m, int threads,
                   int smem_pts, cudaStream_t stream) {
  const size_t smem = smem_pts ? (size_t)N * 3 * sizeof(float) : 0;
  if (smem > 0) {   // the static reduction slots count against 48 KB too
    const cudaError_t e = cudaFuncSetAttribute(
        fps_kernel<PER, REG_XYZ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  fps_kernel<PER, REG_XYZ><<<B, threads, smem, stream>>>(
      pts, elig, idx, scratch, N, m, smem_pts);
  return cudaGetLastError();
}

template <bool REG_XYZ>
cudaError_t launch_per(int per, const float* pts, const unsigned char* elig,
                       int* idx, float* scratch, int B, int N, int m,
                       int threads, cudaStream_t stream) {
  switch (per) {
    case 1:
      return launch<1, REG_XYZ>(pts, elig, idx, scratch, B, N, m, threads, 1,
                                stream);
    case 2:
      return launch<2, REG_XYZ>(pts, elig, idx, scratch, B, N, m, threads, 1,
                                stream);
    case 4:
      return launch<4, REG_XYZ>(pts, elig, idx, scratch, B, N, m, threads, 1,
                                stream);
    case 8:
      return launch<8, REG_XYZ>(pts, elig, idx, scratch, B, N, m, threads, 1,
                                stream);
    case 16:
      return launch<16, REG_XYZ>(pts, elig, idx, scratch, B, N, m, threads, 1,
                                 stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// pts [B,N,3] f32, elig [B,N] bool (1 byte), scratch [B,N] f32 (read in
// the scratch and global modes only) -> idx [B,m] i32. threads, per and
// mode as ops/pallas_fps.py:fps_plan gives them: mode 0 registers and 1
// shared need per in {1, 2, 4, 8, 16} with per * threads >= N and the
// cloud within shared memory, mode 0 also 4 * per * threads <= 32768;
// modes 2 scratch (the cloud within shared memory) and 3 global need
// per == 0.
extern "C" int pct_fps(const float* pts, const unsigned char* elig, int* idx,
                       float* scratch, int B, int N, int m, int threads,
                       int per, int mode, cudaStream_t stream) {
  if (B <= 0 || m <= 0) return 0;
  const bool fits = (size_t)N * 3 * sizeof(float) <= kSmemPointsMax;
  const bool in_regs = mode == kRegisters || mode == kShared;
  if (N <= 0 || threads < 32 || threads > kMaxThreads || threads % 32
      || mode < kRegisters || mode > kGlobal
      || (in_regs && ((long long)per * threads < N || !fits))
      || (!in_regs && per != 0) || (mode == kScratch && !fits)
      || (mode == kRegisters && 4 * per * threads > kRegBudget))
    return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (mode == kRegisters)
    e = launch_per<true>(per, pts, elig, idx, scratch, B, N, m, threads,
                         stream);
  else if (mode == kShared)
    e = launch_per<false>(per, pts, elig, idx, scratch, B, N, m, threads,
                          stream);
  else
    e = launch<0, false>(pts, elig, idx, scratch, B, N, m, threads,
                         mode == kScratch, stream);
  return (int)e;
}

// The floor of a step at this CTA width: B CTAs of `threads` run the m - 1
// steps of fps_floor_kernel (no distance work) -> out [B,m] i32.
extern "C" int pct_fps_floor(int* out, int B, int N, int m, int threads,
                             cudaStream_t stream) {
  if (B <= 0 || m <= 0) return 0;
  if (N <= 0 || threads < 32 || threads > kMaxThreads || threads % 32
      || (size_t)N * 3 * sizeof(float) > kSmemPointsMax)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)N * 3 * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      fps_floor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  fps_floor_kernel<<<B, threads, smem, stream>>>(out, N, m);
  return (int)cudaGetLastError();
}
