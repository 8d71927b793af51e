// Batched solve of small SPD systems for Hopper (sm_90a): the Cholesky
// factorisation and both substitutions of every system in one launch.
//
// Replaces no TPU kernel: the JAX package's utils/linalg.py::spd_solve is an
// unrolled Cholesky of one jnp op a matrix entry, which XLA fuses. In eager
// PyTorch the same chain (utils/linalg.py::_spd_solve, the plain version this
// kernel is held to) is one launch an entry and a term: 466 launches for a
// 9 x 9 system against a vector, 253 for a 7 x 7 one against 6 columns, four
// such calls a step on the Franka path, where the host's launch overhead is
// most of the step. This kernel does one call in one launch.
//
// Math, per system (the leading axes flattened into one batch), as the plain
// version writes it (float32, the square root and 1/d each correctly
// rounded; built with -fmad=false so no multiply and add are fused, and every
// sum is taken in ascending index):
//   for each column j: s = a_jj - L_j0 L_j0 - ... - L_j,j-1 L_j,j-1,
//     d = sqrt(s), r_j = 1 / d, and for each row i > j
//     L_ij = (a_ij - L_i0 L_j0 - ... - L_i,j-1 L_j,j-1) r_j;
//   for each right-hand column: y_i = (b_i - L_i0 y_0 - ... - L_i,i-1 y_i-1) r_i
//     in ascending i, then x_i = (y_i - L_i+1,i x_i+1 - ... - L_n-1,i x_n-1) r_i
//     in descending i.
// For the inverse, B is the identity, formed in registers and never read.
//
// What bounds it on this card. At the Franka path's phase-A shape (4,096
// systems of 9 x 9 against a vector) a call reads 4,096 x 90 floats and
// writes 4,096 x 9: 1.6 MB, ~0.5 us at 3.35 TB/s, and its ~1,000 flops a
// system are nothing beside that. Its time is the latency of one system's
// dependent chain. So a system is one warp, which works a column's rows in
// parallel: lane i owns row i of the factor (n <= 24 < 32), and every lane
// forms column j's pivot itself from the shared row j, the same bits as the
// plain version's one pivot, so a column costs one __syncwarp and no
// shuffle. For the substitutions lane c owns right-hand column c, in chunks
// of 32 columns, and keeps its y in shared memory; the factor is read from
// shared memory, the same word by every lane (a broadcast). Rows of the
// factor lie an odd number of words apart, so lane i's reads of its own row
// fall in distinct banks. Nothing depends on the shape beyond (batch, n, k),
// read off the call.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 24;   // utils/linalg.py _UNROLL_MAX
constexpr int kWarps = 4;   // systems a block

// shared words a system: its factor (n rows of ld words), 1/L_jj, and one
// column of y for each of the 32 lanes
__host__ __device__ constexpr int stride(int n) { return n | 1; }
__host__ __device__ constexpr int words(int n) { return n * stride(n) + n + 32 * n; }

__global__ void __launch_bounds__(32 * kWarps) chol_solve(
    const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ X,
    int n, int k, long long batch) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long b = (long long)blockIdx.x * kWarps + w;
  if (b >= batch) return;  // a whole warp leaves together
  const int ld = stride(n);
  float* L = smem + w * words(n);
  float* rinv = L + n * ld;
  float* y = rinv + n;

  const float* a = A + b * n * n;
  for (int e = lane; e < n * n; e += 32) L[(e / n) * ld + e % n] = a[e];
  __syncwarp();

  // left-looking: column j from the finished columns 0..j-1, in place over A
  // (the diagonal stays a_jj, read by every lane, and is never written)
  for (int j = 0; j < n; ++j) {
    const float* Lj = L + j * ld;
    float s = Lj[j];
    for (int q = 0; q < j; ++q) s = s - Lj[q] * Lj[q];
    const float r = __frcp_rn(__fsqrt_rn(s));  // torch.sqrt, then 1.0 / d: a reciprocal
    if (lane > j && lane < n) {
      float* Li = L + lane * ld;
      float t = Li[j];
      for (int q = 0; q < j; ++q) t = t - Li[q] * Lj[q];
      Li[j] = t * r;
    }
    if (lane == j) rinv[j] = r;
    __syncwarp();
  }

  float* x = X + b * n * k;
  const float* rhs = B == nullptr ? nullptr : B + b * n * k;
  for (int c = lane; c < k; c += 32) {
    float* yc = y + lane;  // y_i of this lane's column at yc[32 i]
    for (int i = 0; i < n; ++i) {
      float t = rhs == nullptr ? (i == c ? 1.0f : 0.0f) : rhs[i * k + c];
      for (int q = 0; q < i; ++q) t = t - L[i * ld + q] * yc[32 * q];
      yc[32 * i] = t * rinv[i];
    }
    // backward over the same slots: yc[32 q] holds x_q for q > i
    for (int i = n - 1; i >= 0; --i) {
      float t = yc[32 * i];
      for (int q = i + 1; q < n; ++q) t = t - L[q * ld + i] * yc[32 * q];
      const float xi = t * rinv[i];
      yc[32 * i] = xi;
      x[i * k + c] = xi;
    }
  }
}

}  // namespace

// Launches chol_solve on `stream`. A (batch, n, n), B (batch, n, k) and
// X (batch, n, k) are contiguous f32; B null solves against the identity
// (k = n), giving A^-1. Returns cudaGetLastError() after the launch: 0 if it
// was accepted.
extern "C" int chol_forward(const float* A, const float* B, float* X, int n, int k,
                            long long batch, void* stream) {
  if (n <= 0 || n > kMaxN || k <= 0 || batch <= 0 || (B == nullptr && k != n))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (batch + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t shared = sizeof(float) * kWarps * words(n);  // <= 22 KB at n = 24
  chol_solve<<<(unsigned)blocks, 32 * kWarps, shared, (cudaStream_t)stream>>>(
      A, B, X, n, k, batch);
  return (int)cudaGetLastError();
}
