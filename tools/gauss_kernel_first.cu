// FROZEN TEST ORACLE, not part of the package's build: the first CUDA design of
// the Gaussian tile kernel (two launches, 64x64 tiles, 4x4 outputs a thread,
// every tile of a symmetric call computed), kept unchanged so that
// chip_smoke.py and tools/time_gauss_tile.py can hold the redesigned kernel in
// bigkrls_tpu_torch/csrc/gauss_kernel.cu bit-equal to it and time the two side
// by side. tools/k1_oracle.py builds it (nvcc, -I bigkrls_tpu_torch/csrc, the
// package's flags) and binds gauss_tile_first_f32 with ctypes. Nothing in
// bigkrls_tpu_torch reaches it. The original note follows.
//
// Gaussian kernel tile builder for Hopper (sm_90a): out[i, j] = exp(-||a_i - b_j||^2 / sigma).
//
// Replaces the Pallas TPU kernel bigkrls_tpu/ops/kernels.py::_gauss_tile_kernel
// (launched by gauss_kernel_pallas). What it computes, not how the TPU did it:
//
//   r_i  = sum_p a_ip^2,  r_j = sum_p b_jp^2           (pre-pass, one thread per row)
//   g_ij = sum_p a_ip b_jp                              (IEEE fp32 FMA chain, p ascending)
//   d2   = max(r_i + r_j - 2 g_ij, 0),  out = expf(-d2 / sigma)
//
// The per-entry arithmetic lives in gauss_entry.cuh, shared with
// kernel_matmul.cu.
//
// No padding: P and the row counts are arbitrary and the ragged tile edges are
// masked. No TF32 and no tensor cores: the rank-P cancellation at r ~ P lands
// inside exp(), so every product and sum is a true fp32 FMA.
//
// Symmetry. With A == B the (i, j) and (j, i) entries run the same FMA chain over
// p in the same order with the two factors swapped; IEEE multiply and add are
// commutative, so g_ij == g_ji and r_i + r_j == r_j + r_i bit for bit, and K comes
// out exactly symmetric. The port's K is therefore symmetric like the plain
// (XLA-equivalent) gauss_kernel, and unlike the Pallas wrapper, which never
// symmetrized. With symmetric_diag the diagonal is written as exactly 1.
//
// Bound on an H100. Each output costs 2P FLOP of FMA (134 at P = 67) plus one
// expf, and one 4-byte store: about 33 FLOP per byte of HBM traffic, near the
// fp32 SIMT / HBM ridge (67 TFLOP/s over 3.35 TB/s is 20 FLOP/byte). The design
// keeps both sides cheap: 64x64 output tiles with 4x4 outputs per thread reuse
// each shared-memory operand 4 times from registers, the A and B row blocks are
// staged through shared memory in 16-wide slices of P (so any P fits), and the
// stores are row-contiguous across each half-warp. wgmma/TMA are not used.
//
// Output offsets are 64-bit: N^2 passes 2^31 at N ~ 46k.

#include "gauss_entry.cuh"

namespace {

using bigkrls::gauss_entry;
using bigkrls::gram_fma;

constexpr int TILE = 64;      // output tile edge
constexpr int KSLICE = 16;    // width of the P slice staged per step
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(THREADS)
gauss_tile_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  const float* __restrict__ ra, const float* __restrict__ rb,
                  int64_t M, int64_t N, int64_t P, float sigma,
                  float* __restrict__ out, int symmetric_diag) {
  // slices stored transposed ([k][row]) so the inner loop reads are a broadcast
  // (As: one row per 16 threads) and conflict-free consecutive words (Bs)
  __shared__ float As[KSLICE][TILE];
  __shared__ float Bs[KSLICE][TILE];

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int64_t m0 = (int64_t)blockIdx.y * TILE;
  const int64_t n0 = (int64_t)blockIdx.x * TILE;

  float g[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) g[i][j] = 0.0f;

  for (int64_t k0 = 0; k0 < P; k0 += KSLICE) {
    // TILE*KSLICE = 1024 elements per operand, 4 per thread; zero-fill past the
    // edges (a zero factor leaves an fp32 FMA chain bit-unchanged)
#pragma unroll
    for (int l = 0; l < (TILE * KSLICE) / THREADS; ++l) {
      const int e = threadIdx.x + l * THREADS;
      const int row = e / KSLICE;
      const int k = e % KSLICE;
      const int64_t gk = k0 + k;
      const int64_t am = m0 + row;
      const int64_t bn = n0 + row;
      As[k][row] = (am < M && gk < P) ? A[am * P + gk] : 0.0f;
      Bs[k][row] = (bn < N && gk < P) ? B[bn * P + gk] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KSLICE; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) g[i][j] = gram_fma(a[i], b[j], g[i][j]);
    }
    __syncthreads();
  }

  const float rcp = bigkrls::sigma_reciprocal(sigma);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = m0 + ty + 16 * i;
    if (row >= M) continue;
    const float r_row = ra[row];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t col = n0 + tx + 16 * j;
      if (col >= N) continue;
      float v = gauss_entry(g[i][j], r_row, rb[col], sigma, rcp);
      if (symmetric_diag && row == col) v = 1.0f;
      out[row * N + col] = v;
    }
  }
}

}  // namespace

// C interface for ctypes. A is (M, P), B is (N, P), out is (M, N), all row-major
// contiguous fp32 on the current device; ra (M) and rb (N) are scratch for the
// row norms, and may alias when A == B. Launches on `stream` and does not
// synchronize. Returns cudaGetLastError() after the launches.
extern "C" int gauss_tile_first_f32(const float* A, const float* B, float* ra, float* rb,
                                  int64_t M, int64_t N, int64_t P, float sigma, float* out,
                                  int symmetric_diag, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bigkrls::launch_row_sqnorm(A, M, P, ra, s);
  if (rb != ra) bigkrls::launch_row_sqnorm(B, N, P, rb, s);
  dim3 grid((unsigned)((N + TILE - 1) / TILE), (unsigned)((M + TILE - 1) / TILE));
  gauss_tile_kernel<<<grid, THREADS, 0, s>>>(A, B, ra, rb, M, N, P, sigma, out,
                                             symmetric_diag);
  return (int)cudaGetLastError();
}
