// RANSAC's select and refine: one block per pair takes the best hypothesis,
// refits it by weighted Procrustes and re-scores every correspondence.
//
// Replaces no TPU kernel: the JAX package's refine (pctpu/register/
// ransac.py:ransac_registration_batch, from `best = jnp.argmax` on) is plain
// XLA ops, which the plain PyTorch version (pctpu_torch/register/ransac.py:
// _select_refine_plain) ports op for op. On the card that chain was about 880
// dependent launches a call, whatever the batch: weighted_procrustes' sums,
// rotation_polar3's six Newton steps and two eigh3 calls on [B,3,3] tensors,
// the re-score and the result's assembly. The host spent its time
// enqueueing them while the card sat idle. Here they are one launch.
//
// What it computes, for pair b (scores [B,H] int32, inl [B,H,M] bool, src
// and dst [B,M,3] float32, valid [B,M] bool, n_valid [B] float32):
// 1. best = the first index of the maximum of scores[b, :] (torch.argmax);
//    w = inl[b, best, :] as 0/1.
// 2. wsum = max(sum w, 1e-12); the weighted centroids p_c, q_c; then
//    H = sum_i (q_i - q_c) ((p_i - p_c) w_i)^T, in two passes as
//    weighted_procrustes takes them.
// 3. R = rotation_polar3(H) term for term as pctpu_torch/register/
//    procrustes.py and ops/eigh3.py write it: the Frobenius normalisation,
//    six Newton steps with the cofactor inverse-transpose and its 1e-30 det
//    guard, the reflection flip from eigh3 of Up^T H with one adjugate
//    polish, and the closed-form fallback from eigh3 of H^T H (stable
//    ascending order, rank tests 0.1, 1e-3 and 2e-3), taken when H is
//    degenerate or the Newton result is not finite. t = q_c - R p_c.
// 4. err2_i = sum_k (R p_i + t - q_i)_k^2; mask_i = err2_i < thresh2 and
//    valid_i; inliers = sum mask; fitness = inliers / n_valid; T = [R t; 0 1].
// Each product and sum is rounded on its own (--fmad=false) in the plain
// version's order, and a division by a Python scalar in the plain version
// is a product with the float reciprocal here, as PyTorch's CUDA division
// takes it. The sums over M run in another order than PyTorch's and
// cuBLAS's, so the result is not the plain version's bit for bit: R within
// 1e-5 a term, t within 1e-4 m (tests/test_torch_cuda.py).
//
// Bound on an H100: neither bytes nor operations. A pair reads H scores,
// one M-byte inlier row and 2 x M x 12 bytes of points (about 16 KB at
// H 1,024, M 512) and does some 60 M + 2,000 flops: well under a
// microsecond of the card's rates. Its time is latency: three block
// reductions and the 3x3 algebra, a chain of a few thousand dependent
// operations on one thread. The design keeps that chain short:
// - one block of 256 threads a pair; the scans over H and M are
//   block-stride loops, any H >= 1 and M >= 0;
// - the sums are per-thread partials in index order, then a warp tree by
//   __shfl_down_sync and the warps' totals in warp order: a fixed order, so
//   every run gives the same bits;
// - the Newton path runs on thread 0 and the fallback on thread 32, in two
//   warps at once; thread 0 then picks, as torch.where does.
#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// 2.0 * math.pi / 3.0, which PyTorch rounds to float32 before the add
constexpr float kTwoPiThird = (float)(2.0 * 3.141592653589793 / 3.0);

struct V3 {
  float v[3];
};
struct M3 {
  float a[3][3];  // a[row][col]
};

// torch.clamp_min: NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

__device__ __forceinline__ V3 cross(const V3& a, const V3& b) {
  return {{a.v[1] * b.v[2] - a.v[2] * b.v[1],
           a.v[2] * b.v[0] - a.v[0] * b.v[2],
           a.v[0] * b.v[1] - a.v[1] * b.v[0]}};
}

__device__ __forceinline__ float dot(const V3& a, const V3& b) {
  return a.v[0] * b.v[0] + a.v[1] * b.v[1] + a.v[2] * b.v[2];
}

__device__ __forceinline__ float norm(const V3& a) { return sqrtf(dot(a, a)); }

__device__ __forceinline__ V3 row(const M3& m, int i) {
  return {{m.a[i][0], m.a[i][1], m.a[i][2]}};
}

__device__ __forceinline__ V3 col(const M3& m, int j) {
  return {{m.a[0][j], m.a[1][j], m.a[2][j]}};
}

// sum of the squares of all nine terms, row by row
__device__ __forceinline__ float sumsq(const M3& m) {
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) s = s + m.a[i][j] * m.a[i][j];
  return s;
}

// A B, each term sum_k A[i][k] B[k][j] in ascending k
__device__ __forceinline__ M3 matmul(const M3& A, const M3& B) {
  M3 C;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C.a[i][j] = A.a[i][0] * B.a[0][j] + A.a[i][1] * B.a[1][j] +
                  A.a[i][2] * B.a[2][j];
  return C;
}

// A^T B
__device__ __forceinline__ M3 matmul_tn(const M3& A, const M3& B) {
  M3 C;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C.a[i][j] = A.a[0][i] * B.a[0][j] + A.a[1][i] * B.a[1][j] +
                  A.a[2][i] * B.a[2][j];
  return C;
}

__device__ __forceinline__ V3 matvec(const M3& A, const V3& x) {
  return {{A.a[0][0] * x.v[0] + A.a[0][1] * x.v[1] + A.a[0][2] * x.v[2],
           A.a[1][0] * x.v[0] + A.a[1][1] * x.v[1] + A.a[1][2] * x.v[2],
           A.a[2][0] * x.v[0] + A.a[2][1] * x.v[1] + A.a[2][2] * x.v[2]}};
}

// 0.5 (A + A^T)
__device__ __forceinline__ M3 symmetrise(const M3& A) {
  M3 S;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) S.a[i][j] = 0.5f * (A.a[i][j] + A.a[j][i]);
  return S;
}

__device__ __forceinline__ M3 eye() {
  return {{{1.0f, 0.0f, 0.0f}, {0.0f, 1.0f, 0.0f}, {0.0f, 0.0f, 1.0f}}};
}

__device__ __forceinline__ bool finite(const M3& m) {
  bool ok = true;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) ok = ok && isfinite(m.a[i][j]);
  return ok;
}

// ops/eigh3.py:eigvalsh3, ascending
__device__ V3 eigvalsh3(const M3& A) {
  const float third = 1.0f / 3.0f;
  const float a00 = A.a[0][0], a11 = A.a[1][1], a22 = A.a[2][2];
  const float a01 = A.a[0][1], a02 = A.a[0][2], a12 = A.a[1][2];
  const float q = (a00 + a11 + a22) * third;
  const float b00 = a00 - q, b11 = a11 - q, b22 = a22 - q;
  const float p2 = b00 * b00 + b11 * b11 + b22 * b22 +
                   2.0f * (a01 * a01 + a02 * a02 + a12 * a12);
  const float p = sqrtf(clamp_min(p2 * (1.0f / 6.0f), 0.0f));
  const float sp = p > 0.0f ? p : 1.0f;
  const float detB = b00 * (b11 * b22 - a12 * a12) -
                     a01 * (a01 * b22 - a12 * a02) +
                     a02 * (a01 * a12 - b11 * a02);
  float r = detB / (2.0f * (sp * sp * sp));
  r = r < -1.0f ? -1.0f : (r > 1.0f ? 1.0f : r);
  const float phi = acosf(r) * third;
  const float two_p = 2.0f * p;
  const float e_hi = q + two_p * cosf(phi);
  const float e_lo = q + two_p * cosf(phi + kTwoPiThird);
  const float e_mid = 3.0f * q - e_hi - e_lo;
  if (p2 > 0.0f) return {{e_lo, e_mid, e_hi}};
  return {{q, q, q}};
}

// ops/eigh3.py:_eigvec_for: the largest cross product of rows of A - lam I
__device__ void eigvec_for(const M3& A, float lam, V3& v, float& n) {
  M3 B;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      B.a[i][j] = A.a[i][j] - lam * (i == j ? 1.0f : 0.0f);
  const V3 r0 = row(B, 0), r1 = row(B, 1), r2 = row(B, 2);
  const V3 c01 = cross(r0, r1), c02 = cross(r0, r2), c12 = cross(r1, r2);
  const float n01 = dot(c01, c01), n02 = dot(c02, c02), n12 = dot(c12, c12);
  const bool best12 = (n12 >= n01) && (n12 >= n02);
  const bool best02 = !best12 && (n02 >= n01);
  v = best12 ? c12 : (best02 ? c02 : c01);
  n = best12 ? n12 : (best02 ? n02 : n01);
}

__device__ __forceinline__ V3 scale(const V3& a, float s) {
  return {{a.v[0] / s, a.v[1] / s, a.v[2] / s}};
}

// ops/eigh3.py:eigh3: w ascending, V's columns the eigenvectors
__device__ void eigh3(const M3& A, V3& w, M3& V) {
  const float eps = 1e-20f;
  w = eigvalsh3(A);
  V3 v0, v2;
  float n0, n2;
  eigvec_for(A, w.v[0], v0, n0);
  eigvec_for(A, w.v[2], v2, n2);
  const float a0 = fabsf(w.v[0]), a1 = fabsf(w.v[1]), a2 = fabsf(w.v[2]);
  const float amax = (isnan(a0) || isnan(a1) || isnan(a2))
                         ? a0 + a1 + a2
                         : fmaxf(fmaxf(a0, a1), a2);
  const float sc = powf(clamp_min(amax, 1.0f), 4.0f);
  const bool ok0 = n0 > eps * sc, ok2 = n2 > eps * sc;
  const V3 ex = {{1.0f, 0.0f, 0.0f}}, ez = {{0.0f, 0.0f, 1.0f}};
  if (!ok0) v0 = ex;
  v0 = scale(v0, norm(v0));
  if (!ok2) v2 = ez;
  const float d = dot(v2, v0);
#pragma unroll
  for (int k = 0; k < 3; ++k) v2.v[k] = v2.v[k] - d * v0.v[k];
  const float norm2 = norm(v2);
  V3 alt = cross(v0, fabsf(v0.v[0]) < 0.9f ? ex : V3{{0.0f, 1.0f, 1.0f}});
  alt = scale(alt, norm(alt));
  v2 = norm2 > 1e-12f ? scale(v2, clamp_min(norm2, 1e-30f)) : alt;
  const V3 v1 = cross(v2, v0);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    V.a[i][0] = v0.v[i];
    V.a[i][1] = v1.v[i];
    V.a[i][2] = v2.v[i];
  }
}

// register/procrustes.py:_inv_transpose3: X^{-T} by cofactors over det
__device__ M3 inv_transpose3(const M3& X) {
  const V3 r0 = row(X, 0), r1 = row(X, 1), r2 = row(X, 2);
  const V3 c[3] = {cross(r1, r2), cross(r2, r0), cross(r0, r1)};
  const float det = dot(r0, c[0]);
  const float safe = fabsf(det) > 1e-30f ? det : 1e-30f;
  M3 out;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) out.a[i][j] = c[i].v[j] / safe;
  return out;
}

// the Newton path of rotation_polar3 on the normalised H: the polar factor
// Up, flipped through its least singular direction when det(Up) < 0
__device__ M3 polar_newton(const M3& H) {
  M3 X = H;
  for (int it = 0; it < 6; ++it) {
    const M3 Xit = inv_transpose3(X);
    const float g = sqrtf(sqrtf(sumsq(Xit) / clamp_min(sumsq(X), 1e-30f)));
    const float ig = 1.0f / g;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        X.a[i][j] = 0.5f * (g * X.a[i][j] + ig * Xit.a[i][j]);
  }
  const M3& Up = X;
  const float d = dot(row(Up, 0), cross(row(Up, 1), row(Up, 2)));
  const M3 S = symmetrise(matmul_tn(Up, H));
  V3 w;
  M3 V;
  eigh3(S, w, V);
  M3 B;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      B.a[i][j] = S.a[i][j] - w.v[0] * (i == j ? 1.0f : 0.0f);
  // adj(B)'s columns: cross products of B's rows; v = adj(B) V[:, 0]
  const V3 a0 = cross(row(B, 1), row(B, 2)), a1 = cross(row(B, 2), row(B, 0)),
           a2 = cross(row(B, 0), row(B, 1));
  const V3 e = col(V, 0);
  V3 v;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    v.v[i] = a0.v[i] * e.v[0] + a1.v[i] * e.v[1] + a2.v[i] * e.v[2];
  v = scale(v, clamp_min(norm(v), 1e-30f));
  if (!(d < 0.0f)) return Up;
  M3 flip;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      flip.a[i][j] = (i == j ? 1.0f : 0.0f) - 2.0f * v.v[i] * v.v[j];
  return matmul(Up, flip);
}

// torch.argsort(stable=True) of three values, NaN last
__device__ __forceinline__ bool before(float a, float b) {
  return a < b || (!isnan(a) && isnan(b));
}

// the fallback of rotation_polar3 on the normalised H, from eigh3 of H^T H;
// `degenerate` is its test of the least singular value
__device__ M3 polar_fallback(const M3& H, bool& degenerate) {
  V3 w;
  M3 V;
  eigh3(symmetrise(matmul_tn(H, H)), w, V);
  int o[3] = {0, 1, 2};
#pragma unroll
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && before(w.v[o[j]], w.v[o[j - 1]]); --j) {
      const int s = o[j];
      o[j] = o[j - 1];
      o[j - 1] = s;
    }
  float s[3];
  V3 vg[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s[c] = sqrtf(clamp_min(w.v[o[c]], 0.0f));
    vg[c] = col(V, o[c]);
  }
  const V3 u2 = scale(matvec(H, vg[2]), clamp_min(s[2], 1e-30f));
  V3 u1 = scale(matvec(H, vg[1]), clamp_min(s[1], 1e-30f));
  const float d = dot(u1, u2);
#pragma unroll
  for (int k = 0; k < 3; ++k) u1.v[k] = u1.v[k] - d * u2.v[k];
  u1 = scale(u1, clamp_min(norm(u1), 1e-30f));
  const V3 u0 = cross(u2, u1);
  const V3 v0 = cross(vg[2], vg[1]);
  degenerate = s[0] < 2e-3f * clamp_min(s[2], 1e-30f);
  if (s[2] < 0.1f || s[1] <= 1e-3f * s[2]) return eye();
  M3 R;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      R.a[i][j] = u2.v[i] * vg[2].v[j] + u1.v[i] * vg[1].v[j] +
                  u0.v[i] * v0.v[j];
  return R;
}

// thread 0 of the block gets the sums over the block of v[0..N), added
// per warp by a shuffle tree, then over the warps in order
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N],
                                          float (*scratch)[N]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] += __shfl_down_sync(kFull, v[k], o);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) scratch[warp][k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float s = scratch[0][k];
      for (int w = 1; w < kWarps; ++w) s += scratch[w][k];
      v[k] = s;
    }
  }
}

__global__ void __launch_bounds__(kThreads) ransac_refine_kernel(
    const int* __restrict__ scores, const unsigned char* __restrict__ inl,
    const float* __restrict__ src, const float* __restrict__ dst,
    const unsigned char* __restrict__ valid,
    const float* __restrict__ n_valid, float* __restrict__ T,
    unsigned char* __restrict__ mask, int* __restrict__ inliers,
    float* __restrict__ fitness, int H, int M, float thresh2) {
  __shared__ int s_best[kWarps][2];
  __shared__ float s_sum1[kWarps][7];
  __shared__ float s_sum2[kWarps][9];
  __shared__ int s_count[kWarps];
  __shared__ float s_c[6];       // p_c, q_c
  __shared__ float s_H[9];
  __shared__ float s_fb[9];      // the fallback's rotation
  __shared__ int s_degenerate;  // the fallback's test of H
  __shared__ int s_bad;         // the Newton result is not finite
  __shared__ float s_Rt[12];     // R row-major, then t
  __shared__ int s_row;

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* p = src + (size_t)b * M * 3;
  const float* q = dst + (size_t)b * M * 3;

  // 1. the first index of the maximum score
  int bv = INT_MIN, bi = INT_MAX;
  for (int h = tid; h < H; h += kThreads) {
    const int v = scores[(size_t)b * H + h];
    if (v > bv) bv = v, bi = h;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int ov = __shfl_down_sync(kFull, bv, o);
    const int oi = __shfl_down_sync(kFull, bi, o);
    if (ov > bv || (ov == bv && oi < bi)) bv = ov, bi = oi;
  }
  if (lane == 0) s_best[warp][0] = bv, s_best[warp][1] = bi;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kWarps; ++w) {
      const int ov = s_best[w][0], oi = s_best[w][1];
      if (ov > bv || (ov == bv && oi < bi)) bv = ov, bi = oi;
    }
    s_row = bi;
  }
  __syncthreads();
  const unsigned char* wrow = inl + ((size_t)b * H + s_row) * M;

  // 2. the weight, the weighted sums of p and q, then H
  float acc1[7] = {0, 0, 0, 0, 0, 0, 0};
  for (int i = tid; i < M; i += kThreads) {
    const float w = wrow[i] ? 1.0f : 0.0f;
    acc1[0] += w;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      acc1[1 + k] += p[3 * i + k] * w;
      acc1[4 + k] += q[3 * i + k] * w;
    }
  }
  block_sum<7>(acc1, s_sum1);
  if (tid == 0) {
    const float wsum = clamp_min(acc1[0], 1e-12f);
#pragma unroll
    for (int k = 0; k < 6; ++k) s_c[k] = acc1[1 + k] / wsum;
  }
  __syncthreads();
  const float pc[3] = {s_c[0], s_c[1], s_c[2]};
  const float qc[3] = {s_c[3], s_c[4], s_c[5]};
  float acc2[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  for (int i = tid; i < M; i += kThreads) {
    const float w = wrow[i] ? 1.0f : 0.0f;
    float a[3], d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      a[k] = (p[3 * i + k] - pc[k]) * w;
      d[k] = q[3 * i + k] - qc[k];
    }
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) acc2[3 * r + c] += d[r] * a[c];
  }
  block_sum<9>(acc2, s_sum2);
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) s_H[k] = acc2[k];
  }
  __syncthreads();

  // 3. R = rotation_polar3(H): the Newton path on thread 0, the fallback
  // on thread 32, both from the Frobenius-normalised H
  if (tid == 0 || tid == 32) {
    M3 Hn;
    float fro = 0.0f;
#pragma unroll
    for (int k = 0; k < 9; ++k) fro = fro + s_H[k] * s_H[k];
    fro = clamp_min(sqrtf(fro), 1e-30f);
#pragma unroll
    for (int k = 0; k < 9; ++k) Hn.a[k / 3][k % 3] = s_H[k] / fro;
    if (tid == 32) {
      bool degenerate;
      const M3 R = polar_fallback(Hn, degenerate);
#pragma unroll
      for (int k = 0; k < 9; ++k) s_fb[k] = R.a[k / 3][k % 3];
      s_degenerate = degenerate;
    } else {
      const M3 Rn = polar_newton(Hn);
      const bool bad = !finite(Rn);
#pragma unroll
      for (int k = 0; k < 9; ++k) s_Rt[k] = Rn.a[k / 3][k % 3];
      s_bad = bad;
    }
  }
  __syncthreads();
  if (tid == 0) {
    const bool fallback = s_degenerate || s_bad;
    M3 R;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      if (fallback) s_Rt[k] = s_fb[k];
      R.a[k / 3][k % 3] = s_Rt[k];
    }
    const V3 tc = matvec(R, V3{{pc[0], pc[1], pc[2]}});
#pragma unroll
    for (int k = 0; k < 3; ++k) s_Rt[9 + k] = qc[k] - tc.v[k];
  }
  __syncthreads();

  // 4. the re-score, the inlier count, fitness and T
  float R[9], t[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = s_Rt[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = s_Rt[9 + k];
  int count = 0;
  for (int i = tid; i < M; i += kThreads) {
    float err2 = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float e = R[3 * k] * p[3 * i] + R[3 * k + 1] * p[3 * i + 1] +
                      R[3 * k + 2] * p[3 * i + 2] + t[k] - q[3 * i + k];
      err2 = err2 + e * e;
    }
    const bool in = err2 < thresh2 && valid[(size_t)b * M + i];
    mask[(size_t)b * M + i] = in;
    count += in;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) count += __shfl_down_sync(kFull, count, o);
  if (lane == 0) s_count[warp] = count;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kWarps; ++w) count += s_count[w];
    inliers[b] = count;
    fitness[b] = (float)count / n_valid[b];
    float* Tb = T + (size_t)b * 16;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      Tb[4 * k] = R[3 * k], Tb[4 * k + 1] = R[3 * k + 1],
      Tb[4 * k + 2] = R[3 * k + 2], Tb[4 * k + 3] = t[k];
    }
    Tb[12] = 0.0f, Tb[13] = 0.0f, Tb[14] = 0.0f, Tb[15] = 1.0f;
  }
}

}  // namespace

extern "C" int pct_ransac_refine(const int* scores, const unsigned char* inl,
                                 const float* src, const float* dst,
                                 const unsigned char* valid,
                                 const float* n_valid, float* T,
                                 unsigned char* mask, int* inliers,
                                 float* fitness, int B, int H, int M,
                                 float thresh2, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (H < 1 || M < 0) return (int)cudaErrorInvalidValue;
  ransac_refine_kernel<<<B, kThreads, 0, stream>>>(
      scores, inl, src, dst, valid, n_valid, T, mask, inliers, fitness, H, M,
      thresh2);
  return (int)cudaGetLastError();
}
