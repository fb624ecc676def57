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
// any channel count.
//
// Bound on an H100: bytes. The grouped output (B*M*K*C floats) dwarfs the
// inputs: cls-msg SA1's third scale writes 32*512*128*6*4 B = 50 MB, about
// 15 us at 3.35 TB/s. The scan costs about 10 flops per candidate and stops
// at the nsample-th hit.
//
// Design (a first, simple one): one warp per (cloud, centre), 4 warps per
// block. The lanes test 32 consecutive candidates at a time; __ballot_sync
// and a popc prefix give each hit its slot, kept in shared memory; the
// scan stops once nsample hits are found (an early exit changes no
// result). The warp then writes the K indices and the K*C grouped floats
// as one contiguous run, lane by lane (coalesced stores).
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr float kBig = 1e30f;

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

__global__ void __launch_bounds__(kWarps * 32)
ballgroup_kernel(const float* __restrict__ centers,
                 const float* __restrict__ packed,
                 const unsigned char* __restrict__ mask,
                 float* __restrict__ out, int* __restrict__ idx_out, int B,
                 int M, int N, int C, int K, float r2, int sub_xyz) {
  extern __shared__ int s_slots[];   // [kWarps][K]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long cm = (long long)blockIdx.x * kWarps + warp;   // b*M + m
  if (cm >= (long long)B * M) return;   // the whole warp leaves together
  const int b = (int)(cm / M);
  int* slots = s_slots + warp * K;
  const float cx = centers[cm * 3 + 0], cy = centers[cm * 3 + 1],
              cz = centers[cm * 3 + 2];
  const float c2 = dot3(cx, cy, cz, cx, cy, cz);
  const float* P = packed + (size_t)b * N * C;
  const unsigned char* Mk = mask ? mask + (size_t)b * N : nullptr;

  int count = 0;   // warp-uniform: every lane sees the same ballots
  for (int base = 0; base < N && count < K; base += 32) {
    const int i = base + lane;
    bool hit = false;
    if (i < N) {
      const float* p = P + (size_t)i * C;
      const float x = p[0], y = p[1], z = p[2];
      float b2 = dot3(x, y, z, x, y, z);
      if (Mk && !Mk[i]) b2 = kBig;
      const float cross = dot3(x, y, z, cx, cy, cz);
      const float d2 = __fsub_rn(__fadd_rn(b2, c2), __fmul_rn(2.0f, cross));
      hit = d2 < r2;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (hit) {
      const int slot = count + __popc(ballot & ((1u << lane) - 1u));
      if (slot < K) slots[slot] = i;
    }
    count += __popc(ballot);
  }
  __syncwarp();
  const int filled = count < K ? count : K;
  const int first = filled > 0 ? slots[0] : 0;
  for (int k = filled + lane; k < K; k += 32) slots[k] = first;
  __syncwarp();

  int* io = idx_out + (size_t)cm * K;
  for (int k = lane; k < K; k += 32) io[k] = slots[k];
  float* o = out + (size_t)cm * K * C;
  const int total = K * C;
  for (int e = lane; e < total; e += 32) {
    const int k = e / C, c = e - k * C;
    float v = P[(size_t)slots[k] * C + c];
    if (sub_xyz && c < 3) v = __fsub_rn(v, c == 0 ? cx : (c == 1 ? cy : cz));
    o[e] = v;
  }
}

}  // namespace

// centers [B,M,3] f32, packed [B,N,C] f32 (xyz first), mask [B,N] bool or
// null -> out [B,M,K,C] f32, idx [B,M,K] i32.
extern "C" int pct_ball_group(const float* centers, const float* packed,
                              const unsigned char* mask, float* out, int* idx,
                              int B, int M, int N, int C, int K, int sub_xyz,
                              float r2, cudaStream_t stream) {
  if (B <= 0 || M <= 0) return 0;
  if (N <= 0 || C < 3 || K <= 0) return (int)cudaErrorInvalidValue;
  const long long warps = (long long)B * M;
  const unsigned grid = (unsigned)((warps + kWarps - 1) / kWarps);
  const size_t smem = (size_t)kWarps * K * sizeof(int);
  if (smem > 48 * 1024) {   // the kernel has no static shared memory
    const cudaError_t e = cudaFuncSetAttribute(
        ballgroup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ballgroup_kernel<<<grid, kWarps * 32, smem, stream>>>(
      centers, packed, mask, out, idx, B, M, N, C, K, r2, sub_xyz);
  return (int)cudaGetLastError();
}
