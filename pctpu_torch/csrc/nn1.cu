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
// Bound on an H100: operations. Each (query, db) pair costs 3 subtracts,
// 3 multiplies, 3 adds and a compare, about 8 flops at FP32 CUDA-core rate;
// the inputs are read once per block from L2 (a few hundred KB).
//
// Design (a first, simple one): grid (ceil(M/128), B), one query per
// thread held in registers, the db streamed through shared memory in
// structure-of-arrays tiles (x, y, z, pen) so every thread of a warp
// reads the same word (a broadcast, no bank conflicts). Faster designs
// (several queries per thread, splitting the db across blocks) are later
// work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;   // db points per shared-memory tile (16 KB)
constexpr float kBig = 1e30f;

__global__ void __launch_bounds__(kThreads)
nn1_kernel(const float* __restrict__ query, const float* __restrict__ db,
           const float* __restrict__ pen, float* __restrict__ d2_out,
           int* __restrict__ idx_out, int M, int N) {
  __shared__ float sx[kTile], sy[kTile], sz[kTile], sp[kTile];
  const int b = blockIdx.y;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const bool active = q < M;
  const float* qp = query + ((size_t)b * M + (active ? q : 0)) * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];
  const float* dbb = db + (size_t)b * N * 3;
  const float* penb = pen + (size_t)b * N;

  float best = kBig;
  int best_i = 0;
  for (int start = 0; start < N; start += kTile) {
    const int len = min(kTile, N - start);
    __syncthreads();
    for (int c = threadIdx.x; c < len; c += kThreads) {
      sx[c] = dbb[(size_t)(start + c) * 3 + 0];
      sy[c] = dbb[(size_t)(start + c) * 3 + 1];
      sz[c] = dbb[(size_t)(start + c) * 3 + 2];
      sp[c] = penb[start + c];
    }
    __syncthreads();
    for (int c = 0; c < len; ++c) {
      const float dx = __fsub_rn(qx, sx[c]);
      const float dy = __fsub_rn(qy, sy[c]);
      const float dz = __fsub_rn(qz, sz[c]);
      float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      d2 = __fadd_rn(d2, __fmul_rn(dz, dz));
      d2 = __fadd_rn(d2, sp[c]);
      if (d2 < best) {
        best = d2;
        best_i = start + c;
      }
    }
  }
  if (active) {
    d2_out[(size_t)b * M + q] = best;
    idx_out[(size_t)b * M + q] = best_i;
  }
}

}  // namespace

// query [B,M,3], db [B,N,3], pen [B,N] f32 -> d2 [B,M] f32, idx [B,M] i32.
extern "C" int pct_nn1(const float* query, const float* db, const float* pen,
                       float* d2, int* idx, int B, int M, int N,
                       cudaStream_t stream) {
  if (B <= 0 || M <= 0) return 0;
  dim3 grid((M + kThreads - 1) / kThreads, B);
  nn1_kernel<<<grid, kThreads, 0, stream>>>(query, db, pen, d2, idx, M, N);
  return (int)cudaGetLastError();
}
