// Gaussian kernel tile builder for Hopper (sm_90a): out[i, j] = exp(-||a_i - b_j||^2 / sigma).
//
// Replaces the Pallas TPU kernel bigkrls_tpu/ops/kernels.py::_gauss_tile_kernel
// (launched by gauss_kernel_pallas). What it computes, not how the TPU did it:
//
//   r_i  = sum_p a_ip^2,  r_j = sum_p b_jp^2           (IEEE fp32 FMA chain, p ascending)
//   g_ij = sum_p a_ip b_jp                              (IEEE fp32 FMA chain, p ascending)
//   d2   = max(r_i + r_j - 2 g_ij, 0),  out = expf(-d2 / sigma)
//
// The per-entry arithmetic lives in gauss_entry.cuh, shared with
// kernel_matmul.cu, whose on-chip tile equals this kernel's bit for bit.
//
// Why it is SIMT. The rank-P cancellation at r ~ P lands inside exp(), so the
// product is IEEE fp32: every step a true FMA, the p sum one chain in ascending
// order (no split, no pairwise sum: either changes bits). wgmma and mma have no
// fp32 input type, so the tensor cores are out, and the bound is the fp32 SIMT
// bound: max(2 M N P / 67 TFLOP/s, 4 (M P + N P + M N) / 3.35 TB/s).
//
// What bounds it on an H100, and what the design does about each.
//
// * Issue slots. An entry costs P FMAs and about 30 instructions of quotient
//   and expf, so at P = 67 the card's FMA pipes are the limit and everything
//   else has to stay out of their way. A thread owns 8 x 4 (or 8 x 8) outputs
//   and reads its operands from shared memory as 16-byte vectors along p: 12
//   (16) loads feed 128 (256) FMAs, and most of a warp's loads are broadcasts.
//   Rows sit in shared memory at a pitch of 4 x odd floats, so the 8 rows a
//   quarter-warp reads at once fall into 8 distinct groups of 4 banks.
// * Symmetric calls (A and B the same rows) compute only the tiles with
//   J >= I. An off-diagonal tile is stored twice from one staging buffer in
//   shared memory: by rows to (I, J) and by columns to (J, I); the buffer's
//   pitch is odd, so both reads are conflict-free. (j, i) would run the same
//   chain with its factors swapped, and IEEE multiply and add are commutative:
//   the mirrored entry is the computed one bit for bit, and K is bit-symmetric
//   by construction. FMAs and expf halve; the store does not. Diagonal tiles
//   are computed whole. With symmetric_diag the diagonal is written as exactly
//   1. The block index is decoded to (I, J) in integers (a double sqrt as a
//   first guess, then corrected), exact for every grid CUDA allows.
// * Stores. K stays a contiguous (M, N) matrix, so a row pitch of 4 N bytes is
//   in general no multiple of 16 (N = 3106) and neither a TMA tensor map nor
//   16-byte stores apply. The finished tile goes through shared memory and out
//   as whole row segments: a warp writes 32 consecutive floats (128 bytes) per
//   instruction, whatever the alignment of the row. What the stores cost here
//   is their instructions, not their bytes: lanes that store 2 or 4 floats at
//   once where N allows it changed nothing, while stepping the pointers by
//   additions and testing the tile's edges once, outside the loops, took the
//   store loops from about 20 instructions a store to 5 (and the staging loop
//   likewise): 0.043 -> 0.037 ms at (3106, 67).
// * One launch. The row norms are computed from the staged rows inside the
//   tile kernel (a thread per row, the same chain as row_sqnorm_kernel, so the
//   same bits), interleaved with the product: no pre-pass, no scratch for them.
// * Staging. A tile's rows of X arrive by cp.async, 16 bytes a thread, which
//   needs 16-byte aligned rows at a pitch that is a multiple of 4 floats.
//   Where P % 4 != 0 (the fit's 67) one small kernel in front copies X into a
//   zero-padded pitch (a zero factor leaves a chain bit-unchanged); the
//   wrapper only allocates the room. Staging such rows by 4-byte copies
//   inside the tile kernel was measured: at (3106, 67) it cost 0.014 ms of
//   0.057, on every tile, where the copy costs once per call; and the same
//   copy made by a PyTorch call cost the host 0.017 ms. P up to 72 is staged
//   whole, once; wider P runs in 32-wide slices through two buffers, the next
//   slice in flight during the current one's FMAs. P = 67 runs 68 steps.
// * Waves. Tiles are 64 x 64 (128 threads, 4 blocks an SM) or 128 x 128
//   (256 threads, 2 blocks an SM), chosen on the host from waves x
//   work per tile (ops/kernels.py::_tile_plan), so a small problem still fills
//   the card. Every entry sees the same operations whatever the tile.
//
// Output offsets are 64-bit: N^2 passes 2^31 at N ~ 46k.
//
// Measuring without a profiler: -DBIGKRLS_K1_ABLATE_GRAM drops the product's
// loads and FMAs, _ENTRY the quotient and expf, _STORE the global stores. The
// ablated kernels compute garbage (tools/time_gauss_tile.py --ablate).

#include "gauss_entry.cuh"

namespace {

using bigkrls::gauss_entry;
using bigkrls::gram_fma;

constexpr int TX = 16;  // threads along a tile's columns
constexpr int TM = 8;   // rows a thread owns

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// asynchronous copies global -> shared; `ok` false writes zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const int bytes = ok ? 16 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The t-th pair (r, c), c <= r, of the lower triangle in row-major order:
// t = r (r + 1) / 2 + c. The square root is only a first guess; the two loops
// make the answer exact (ops/kernels.py::_tri_decode is the same code).
__device__ __forceinline__ void tri_decode(int64_t t, int64_t& r, int64_t& c) {
  int64_t rr = (int64_t)((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
  while (rr * (rr + 1) / 2 > t) --rr;
  while ((rr + 1) * (rr + 2) / 2 <= t) ++rr;
  r = rr;
  c = t - rr * (rr + 1) / 2;
}

// Copy columns [k0, k0 + 4 nq) of `rows` rows of X (row pitch ldx), from row0
// on, into dst (row pitch `pitch`), 16 bytes a thread. The rows x nq chunks
// are dealt out in row-major order, chunk e to thread e % THREADS, so
// consecutive lanes copy consecutive addresses and no lane idles; a thread
// steps from one of its chunks to the next by additions alone. Rows past
// `total` become zeros.
template <int THREADS>
__device__ __forceinline__ void stage(float* dst, int pitch, const float* __restrict__ X,
                                      int64_t ldx, int64_t row0, int64_t total, int rows, int k0,
                                      int nq) {
  int row = threadIdx.x / nq;
  int q = threadIdx.x - row * nq;
  const int drow = THREADS / nq;
  const int dq = THREADS - drow * nq;
  const int valid = (int)min((int64_t)rows, total - row0);  // rows that exist
  const float* src = X + (row0 + row) * ldx + k0 + 4 * q;
  float* d = dst + row * pitch + 4 * q;
  const int64_t src_step = drow * ldx + 4 * dq;
  const int dst_step = drow * pitch + 4 * dq;
  const int64_t src_wrap = ldx - 4 * nq;
  const int dst_wrap = pitch - 4 * nq;
  while (row < rows) {
    const bool ok = row < valid;
    cp_async16(d, ok ? src : X, ok);
    row += drow;
    q += dq;
    src += src_step;
    d += dst_step;
    if (q >= nq) {
      q -= nq;
      ++row;
      src += src_wrap;
      d += dst_wrap;
    }
  }
}

template <int BM, int BN>
__global__ void __launch_bounds__(2 * BM, BM == 64 ? 4 : 2)
gauss_tile_kernel(const float* __restrict__ A, const float* __restrict__ B, int64_t M, int64_t N,
                  int ldx, int kc, int pitch, float sigma, float* __restrict__ out,
                  int symmetric_diag, int mirror, int64_t tiles_n) {
  constexpr int THREADS = 2 * BM;
  constexpr int TY = BM / TM;   // threads along a tile's rows
  constexpr int TN = BN / TX;   // columns a thread owns
  constexpr int SP = BN + 1;    // pitch of the finished tile in shared memory (odd)
  constexpr int NW = THREADS / 32;
  static_assert(BM + BN <= THREADS, "a thread per staged row for the norms");

  // `stages` buffers of (BM + BN) x pitch floats (A's rows, then B's); the
  // finished tile, BM x SP, reuses them after the last slice
  extern __shared__ __align__(16) float smem[];
  __shared__ float rA[BM];
  __shared__ float rB[BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  int64_t ti, tj;
  if (mirror) {
    tri_decode((int64_t)blockIdx.x, tj, ti);  // tj >= ti
  } else {
    ti = (int64_t)blockIdx.x / tiles_n;
    tj = (int64_t)blockIdx.x % tiles_n;
  }
  const int64_t m0 = ti * BM;
  const int64_t n0 = tj * BN;

  const int slices = (ldx + kc - 1) / kc;
  const int stage_floats = (BM + BN) * pitch;

  auto load = [&](int s) {
    float* buf = smem + (s & 1) * stage_floats;
    const int k0 = s * kc;
    const int nq = min(kc, ldx - k0) / 4;
    stage<THREADS>(buf, pitch, A, ldx, m0, M, BM, k0, nq);
    stage<THREADS>(buf + BM * pitch, pitch, B, ldx, n0, N, BN, k0, nq);
    cp_async_commit();
  };

  float g[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) g[i][j] = 0.0f;
  // this thread's row of the staged block, for its norm
  const int nrow = tid < BM + BN ? tid : 0;
  float rn = 0.0f;

  load(0);
  for (int s = 0; s < slices; ++s) {
    if (s + 1 < slices) {
      load(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* buf = smem + (s & 1) * stage_floats;
    const int nq = min(kc, ldx - s * kc) / 4;
    const float* ap = buf + ty * pitch;
    const float* bp = buf + (BM + tx) * pitch;
    const float* np = buf + nrow * pitch;
    for (int q = 0; q < nq; ++q) {
#ifndef BIGKRLS_K1_ABLATE_GRAM
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(ap + i * TY * pitch + 4 * q);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(bp + j * TX * pitch + 4 * q);
#pragma unroll
        for (int i = 0; i < TM; ++i) g[i][j] = gram_fma(a[i].x, b.x, g[i][j]);
#pragma unroll
        for (int i = 0; i < TM; ++i) g[i][j] = gram_fma(a[i].y, b.y, g[i][j]);
#pragma unroll
        for (int i = 0; i < TM; ++i) g[i][j] = gram_fma(a[i].z, b.z, g[i][j]);
#pragma unroll
        for (int i = 0; i < TM; ++i) g[i][j] = gram_fma(a[i].w, b.w, g[i][j]);
      }
#endif
      const float4 x = *reinterpret_cast<const float4*>(np + 4 * q);
      rn = __fmaf_rn(x.x, x.x, rn);
      rn = __fmaf_rn(x.y, x.y, rn);
      rn = __fmaf_rn(x.z, x.z, rn);
      rn = __fmaf_rn(x.w, x.w, rn);
    }
    __syncthreads();
  }
  if (tid < BM) {
    rA[tid] = rn;
  } else if (tid < BM + BN) {
    rB[tid - BM] = rn;
  }
  __syncthreads();

  // the entries, into the staging tile
  const float rcp = bigkrls::sigma_reciprocal(sigma);
  float* S = smem;
  // the exact-1 diagonal crosses this tile where row - column == dd
  const int64_t d0 = n0 - m0;
  const int dd = symmetric_diag && d0 > -BN && d0 < BM ? (int)d0 : BM;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int rl = ty + TY * i;
    const float r_row = rA[rl];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int cl = tx + TX * j;
#ifndef BIGKRLS_K1_ABLATE_ENTRY
      float v = gauss_entry(g[i][j], r_row, rB[cl], sigma, rcp);
#else
      float v = g[i][j] + r_row + rB[cl];
#endif
      if (rl - cl == dd) v = 1.0f;
      S[rl * SP + cl] = v;
    }
  }
  __syncthreads();

#ifdef BIGKRLS_K1_ABLATE_STORE
  if (sigma > 0.0f) return;  // always: the wrapper refuses any other sigma
#endif
  // by rows to (I, J): a warp writes 32 consecutive floats per instruction.
  // Pointers step by additions; the edge tests are made once, outside.
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int nr = (int)min((int64_t)BM, M - m0);  // rows and columns that exist
  const int nc = (int)min((int64_t)BN, N - n0);
  {
    float* dst = out + (m0 + warp) * N + n0 + lane;
    const float* src = S + warp * SP + lane;
    for (int rl = warp; rl < nr; rl += NW, dst += NW * N, src += NW * SP) {
#pragma unroll
      for (int c = 0; c < BN; c += 32)
        if (lane + c < nc) dst[c] = src[c];
    }
  }
  // by columns to (J, I); M == N here, and the odd pitch keeps the column
  // reads on 32 distinct banks
  if (mirror && ti != tj) {
    float* dst = out + (n0 + warp) * N + m0 + lane;
    const float* src = S + lane * SP + warp;
    for (int cl = warp; cl < nc; cl += NW, dst += NW * N, src += NW) {
#pragma unroll
      for (int r = 0; r < BM; r += 32)
        if (lane + r < nr) dst[r] = src[r * SP];
    }
  }
}

// X (rows, P) into dst (rows, ldx), zeros in the columns from P on; rows_a
// rows come from A, the rest from B
__global__ void pad_rows_kernel(const float* __restrict__ A, const float* __restrict__ B,
                                int64_t rows_a, int64_t rows, int64_t P, int64_t ldx,
                                float* __restrict__ dst) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= rows * ldx) return;
  const int64_t row = e / ldx;
  const int64_t c = e % ldx;
  const float* src = row < rows_a ? A + row * P : B + (row - rows_a) * P;
  dst[e] = c < P ? src[c] : 0.0f;
}

template <int BM, int BN>
int launch(const float* A, const float* B, int64_t M, int64_t N, int ldx, int kc, float sigma,
           float* out, int symmetric_diag, int mirror, cudaStream_t s) {
  const int64_t tiles_m = (M + BM - 1) / BM;
  const int64_t tiles_n = (N + BN - 1) / BN;
  if (mirror && (BM != BN || M != N)) return (int)cudaErrorInvalidValue;
  const int64_t blocks = mirror ? tiles_m * (tiles_m + 1) / 2 : tiles_m * tiles_n;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int pitch = (kc / 4) % 2 == 1 ? kc : kc + 4;  // 4 x odd: see the note on banks
  const int stages = ldx > kc ? 2 : 1;
  const int operands = stages * (BM + BN) * pitch, finished = BM * (BN + 1);
  const int bytes = (operands > finished ? operands : finished) * (int)sizeof(float);
  static int allowed[bigkrls::MAX_DEVICES] = {};  // per device: see allow_dynamic_shared
  const cudaError_t e = bigkrls::allow_dynamic_shared(gauss_tile_kernel<BM, BN>, bytes, allowed);
  if (e != cudaSuccess) return (int)e;
  gauss_tile_kernel<BM, BN><<<(unsigned)blocks, 2 * BM, bytes, s>>>(
      A, B, M, N, ldx, kc, pitch, sigma, out, symmetric_diag, mirror, tiles_n);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface for ctypes. A is (M, P), B is (N, P), out is (M, N), all row-major
// contiguous fp32 on the current device. The tile kernel copies 16 bytes at a
// time, so it needs rows 16-byte aligned at a pitch that is a multiple of 4
// floats: where P % 4 != 0 or a pointer is not aligned, `scratch` holds room
// for M + N rows (max(M, N) where A and B are the same pointer) of P rounded up to a
// multiple of 4 floats, and one small kernel copies the rows there with zeros
// in the pad; else scratch is null. `tile` is the square tile's edge, 64 or 128.
// kc, a multiple of 4 no larger than 72, is the width of the slice of the rows
// staged at once. mirror (A and B are the same pointer, the tile is square)
// computes only the tiles with J >= I and stores each off-diagonal one twice.
// Launches on `stream` and does not synchronize. Returns cudaGetLastError()
// after the launches.
extern "C" int gauss_tile_f32(const float* A, const float* B, int64_t M, int64_t N, int64_t P,
                              float* scratch, float sigma, float* out, int symmetric_diag,
                              int mirror, int tile, int kc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || P < 1 || P > INT32_MAX - 8 || kc < 4 || kc > 72 || kc % 4 != 0 ||
      (mirror && A != B))
    return (int)cudaErrorInvalidValue;
  int ldx = (int)P;
  if (scratch != nullptr) {
    ldx = (int)((P + 3) / 4 * 4);
    // one pointer: the rows are shared, the longer operand's are copied once
    const int64_t rows_a = A != B ? M : M > N ? M : N;
    const int64_t rows = A != B ? M + N : rows_a;
    const int64_t blocks = (rows * ldx + 255) / 256;
    if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
    pad_rows_kernel<<<(unsigned)blocks, 256, 0, s>>>(A, B, rows_a, rows, P, ldx, scratch);
    B = A == B ? scratch : scratch + M * ldx;
    A = scratch;
  } else if (P % 4 != 0 || reinterpret_cast<uintptr_t>(A) % 16 != 0 ||
             reinterpret_cast<uintptr_t>(B) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (tile == 64)
    return launch<64, 64>(A, B, M, N, ldx, kc, sigma, out, symmetric_diag, mirror, s);
  if (tile == 128)
    return launch<128, 128>(A, B, M, N, ldx, kc, sigma, out, symmetric_diag, mirror, s);
  return (int)cudaErrorInvalidValue;
}
