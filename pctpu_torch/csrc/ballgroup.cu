// Kernel 12 ball_group: fused ball query + row grouping + centre-relative
// xyz (the forward pass).
//
// Replaces the TPU kernel pctpu/ops/pallas_ballgroup.py:_ballgroup_kernel
// (ball_group_pallas, ball_group_pallas_batched), which keeps the packed
// cloud in VMEM and emits each of the nsample rows by a one-hot matmul.
//
// What it computes, as the plain PyTorch version
// (pctpu_torch/ops/pallas_ballgroup.py:ball_group_plain): for each centre
// c of cloud b, the first nsample point indices i in ascending order with
//   d2 = (b2 + c2) - 2 * cross < r2      (strict),
//   b2 = (x*x + y*y) + z*z  (1e30 for a masked point),
//   c2 = (cx*cx + cy*cy) + cz*cz,  cross = (x*cx + y*cy) + z*cz,
// every product and sum rounded on its own (--fmad=false); slots past the
// hit count repeat the first hit, and an empty ball takes index 0 (the
// contract of ops/ball_query.py). Each slot's row of `packed` [N, C] is
// copied exactly, its first 3 channels minus the centre when sub_xyz. C is
// any channel count >= 3.
//
// Bound on an H100: the scan, about 10 flops a candidate up to the
// nsample-th hit, at cls-msg's SA1 (a 4,096-point cloud of 6 channels:
// most balls of r 0.1 never fill, so most centres test every point); the
// rows written at SA2, where 32 x 128 centres x 32 rows x 323 channels are
// 170 MB, about 51 us at 3.35 TB/s (tools/k7_k12_sweep.py).
//
// The first design ran one warp per (cloud, centre), each lane reading
// its candidate's xyz from device memory at the row stride C: every SA1
// warp repeated the same strided scan of its cloud, 50 to 4,096
// dependent loads deep, so the scan took 110-152 us of SA1's 115-165 us
// launches; SA2's rows went out as one 4-byte store a lane with an integer
// division per element, 101 us of its 107 (tools/k7_k12_sweep.py, H100
// 80GB HBM3, 700 W). Now (the launch shape from
// ops/pallas_ballgroup.py:ball_group_plan):
//  1. A CTA per (cloud, chunk of centres), up to 1,024 threads wide, sized
//     so the launch is one wave of the card; its warps take the chunk's
//     centres one at a time as they come free (a shared counter), one
//     warp a centre. The widest CTA the card can fill ran fastest (SA1 at
//     r 0.1: 46.8 us at 1,024 threads, 52.8 at 256, 67.6 at 128).
//  2. The cloud staged once a CTA in shared memory as (x, y, z, b2), b2
//     rounded as the plain version rounds it (the "shared" mode); past
//     shared memory the same scan reads the cloud from device memory and
//     computes b2 there (the "global" mode). The staged cloud is padded to
//     a whole scan step with points that never hit (b2 = +inf).
//  3. The scan: each lane tests one candidate of each of 4 groups of 32
//     (one 16-byte shared load a candidate; (b2 + c2) - 2 cross as one
//     FFMA, exact because 2 cross is); a ballot per group, and only a
//     group with a hit pays for the slot arithmetic (a popc prefix and a
//     predicated store). Hits keep ascending index order, and the scan
//     stops at the step that holds the nsample-th hit.
//  4. The rows: a centre's nsample x C floats are one contiguous run,
//     written as 16-byte stores where nsample * C % 4 == 0 (4-byte ones
//     elsewhere), with the (slot, channel) position advanced by additions
//     and the rows read from L2; the stores stream past L2 (st.global.cs),
//     which keeps the clouds there.
#include <cuda_runtime.h>

namespace {

constexpr float kBig = 1e30f;
constexpr int kGroups = 4;                // groups of 32 candidates a step
constexpr int kStep = 32 * kGroups;       // candidates a scan step
constexpr int kSmemMax = 232448;          // a block's shared memory (H100)
constexpr int kSmemStatic = 16;           // the kernel's own (next_centre)
constexpr int kShared = 0, kGlobal = 1;   // where the cloud lives

struct BallArgs {
  const float* centers;        // [B, M, 3]
  const float* packed;         // [B, N, C], xyz first
  const unsigned char* mask;   // [B, N] or null
  float* out;                  // [B, M, K, C]
  int* idx;                    // [B, M, K]
  int B, M, N, C, K, centres, ctas, sub_xyz;
  float r2;
};

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

// point i of a cloud as (x, y, z, b2), b2 = 1e30 for a masked point
__device__ __forceinline__ float4 cloud_point(const float* __restrict__ P,
                                              const unsigned char* Mk, int i,
                                              int C) {
  const float* p = P + (size_t)i * C;
  const float x = __ldg(p), y = __ldg(p + 1), z = __ldg(p + 2);
  const float b2 = Mk && !Mk[i] ? kBig : dot3(x, y, z, x, y, z);
  return make_float4(x, y, z, b2);
}

// The first K hits of the centre (cx, cy, cz) in ascending index into
// slots (one warp); returns how many there are, at most K. Each lane
// tests one candidate of each group of 32; `cloud` is the staged cloud
// ("shared") or unused ("global": read from P).
template <int kMode>
__device__ int scan_ball(const float4* cloud, const float* __restrict__ P,
                         const unsigned char* Mk, int N, int C, int K,
                         float cx, float cy, float cz, float r2, int* slots) {
  const int lane = threadIdx.x & 31;
  const unsigned bit = 1u << lane, below = bit - 1u;
  const float c2 = dot3(cx, cy, cz, cx, cy, cz);
  const float4 never = make_float4(0.f, 0.f, 0.f, __int_as_float(0x7f800000));
  int count = 0;
  for (int base = 0; base < N && count < K; base += kStep) {
    unsigned ball[kGroups];
    unsigned any = 0u;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int i = base + g * 32 + lane;
      float4 p;
      if constexpr (kMode == kShared)
        p = cloud[i];
      else
        p = i < N ? cloud_point(P, Mk, i, C) : never;
      const float cross = dot3(p.x, p.y, p.z, cx, cy, cz);
      // (b2 + c2) - 2 cross, rounded once more: 2 cross is exact
      const float d2 = __fmaf_rn(-2.0f, cross, __fadd_rn(p.w, c2));
      ball[g] = __ballot_sync(0xffffffffu, d2 < r2);
      any |= ball[g];
    }
    if (any == 0u) continue;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {   // the groups with a hit
      if (ball[g] == 0u) continue;
      const int slot = count + __popc(ball[g] & below);
      if ((ball[g] & bit) && slot < K) slots[slot] = base + g * 32 + lane;
      count += __popc(ball[g]);
    }
  }
  return min(count, K);
}

// A centre's K rows (one warp): o[k * C + c] = P[slots[k] * C + c], minus
// the centre in the first 3 channels when sub; VEC floats a store.
template <int VEC>
__device__ void emit_rows(const float* __restrict__ P, const int* slots,
                          float* __restrict__ o, int K, int C, float cx,
                          float cy, float cz, int sub) {
  const int lane = threadIdx.x & 31;
  const int total = K * C / VEC;
  constexpr int kPass = 32 * VEC;           // floats a pass of the warp
  const int dk = kPass / C, dc = kPass - dk * C;
  int k = lane * VEC / C, c = lane * VEC - k * C;
#pragma unroll 4
  for (int j = lane; j < total; j += 32) {
    float v[VEC];
    int kk = k, cc = c;
    const float* row = P + (size_t)slots[kk] * C;
#pragma unroll
    for (int t = 0; t < VEC; ++t) {
      float x = __ldg(row + cc);
      if (sub && cc < 3) x = __fsub_rn(x, cc == 0 ? cx : (cc == 1 ? cy : cz));
      v[t] = x;
      if (t + 1 < VEC && ++cc == C) {
        cc = 0;
        row = P + (size_t)slots[++kk] * C;
      }
    }
    if constexpr (VEC == 4)
      __stcs(reinterpret_cast<float4*>(o) + j,
             make_float4(v[0], v[1], v[2], v[3]));
    else
      __stcs(o + j, v[0]);
    k += dk;
    c += dc;
    if (c >= C) {
      c -= C;
      ++k;
    }
  }
}

template <int kMode, int VEC>
__global__ void __launch_bounds__(1024)
ballgroup_kernel(const BallArgs a) {
  extern __shared__ float4 smem[];
  __shared__ int next_centre;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x / a.ctas, chunk = blockIdx.x - b * a.ctas;
  const float* P = a.packed + (size_t)b * a.N * a.C;
  const unsigned char* Mk = a.mask ? a.mask + (size_t)b * a.N : nullptr;
  const int ns = (a.N + kStep - 1) / kStep * kStep;
  if (threadIdx.x == 0) next_centre = 0;
  int* slots = reinterpret_cast<int*>(smem) + warp * a.K;
  if constexpr (kMode == kShared) {
    const float4 never =
        make_float4(0.f, 0.f, 0.f, __int_as_float(0x7f800000));
#pragma unroll 4
    for (int i = threadIdx.x; i < ns; i += blockDim.x)
      smem[i] = i < a.N ? cloud_point(P, Mk, i, a.C) : never;
    slots = reinterpret_cast<int*>(smem + ns) + warp * a.K;
  }
  __syncthreads();
  // the chunk's centres, taken by the warps as they come free
  const int m0 = chunk * a.centres, todo = min(a.M - m0, a.centres);
  for (;;) {
    int j = 0;
    if (lane == 0) j = atomicAdd(&next_centre, 1);
    j = __shfl_sync(0xffffffffu, j, 0);
    if (j >= todo) break;
    const long long cm = (long long)b * a.M + m0 + j;
    const float cx = a.centers[cm * 3 + 0], cy = a.centers[cm * 3 + 1],
                cz = a.centers[cm * 3 + 2];
    const int filled = scan_ball<kMode>(smem, P, Mk, a.N, a.C, a.K, cx, cy,
                                        cz, a.r2, slots);
    __syncwarp();
    const int first = filled > 0 ? slots[0] : 0;
    for (int k = filled + lane; k < a.K; k += 32) slots[k] = first;
    __syncwarp();
    for (int k = lane; k < a.K; k += 32) a.idx[cm * a.K + k] = slots[k];
    emit_rows<VEC>(P, slots, a.out + cm * a.K * a.C, a.K, a.C, cx, cy, cz,
                   a.sub_xyz);
    __syncwarp();   // the slots serve the warp's next centre
  }
}

template <int kMode, int VEC>
int launch(const BallArgs& a, int threads, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ballgroup_kernel<kMode, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ballgroup_kernel<kMode, VEC><<<a.B * a.ctas, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// centers [B,M,3] f32, packed [B,N,C] f32 (xyz first), mask [B,N] bool or
// null -> out [B,M,K,C] f32, idx [B,M,K] i32. The launch: CTAs of
// `threads` threads (one warp a centre), `centres`
// centres each, the cloud in shared memory (mode 0) or read from device
// memory (mode 1), `vec` floats a store (4 needs K * C % 4 == 0)
// (ops/pallas_ballgroup.py:ball_group_plan).
extern "C" int pct_ball_group(const float* centers, const float* packed,
                              const unsigned char* mask, float* out, int* idx,
                              int B, int M, int N, int C, int K, int sub_xyz,
                              int threads, int centres, int mode,
                              int vec, float r2, cudaStream_t stream) {
  if (B <= 0 || M <= 0) return 0;
  if (N <= 0 || C < 3 || K <= 0 || threads % 32 != 0 || threads < 32
      || threads > 1024      || centres < 1 || (mode != kShared && mode != kGlobal)
      || (vec != 1 && vec != 4) || (vec == 4 && (long long)K * C % 4 != 0))
    return (int)cudaErrorInvalidValue;
  const long long ns = ((long long)N + kStep - 1) / kStep * kStep;
  const long long smem = (mode == kShared ? ns * 16 : 0)
                         + (long long)threads / 32 * K * 4;
  const long long ctas = ((long long)M + centres - 1) / centres;
  if (smem + kSmemStatic > kSmemMax || (long long)B * ctas > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const BallArgs a{centers, packed, mask, out, idx, B, M, N, C, K, centres,
                   (int)ctas, sub_xyz, r2};
  if (mode == kShared)
    return vec == 4 ? launch<kShared, 4>(a, threads, smem, stream)
                    : launch<kShared, 1>(a, threads, smem, stream);
  return vec == 4 ? launch<kGlobal, 4>(a, threads, smem, stream)
                  : launch<kGlobal, 1>(a, threads, smem, stream);
}
