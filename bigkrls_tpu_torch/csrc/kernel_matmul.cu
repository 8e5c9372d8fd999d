// Kernel-free product for Hopper (sm_90a): out = (K(X) V + init) * out_scale with
// K_ij = exp(-max(r_i + r_j - 2 x_i.x_j, 0) / sigma), K never written to device memory.
//
// Replaces the Pallas TPU kernel bigkrls_tpu/ops/matvec.py::_km_kernel (launched
// by kernel_matmul_pallas and its _fast alias) and computes the function of the
// JAX package's default streaming product, matvec.py::kernel_matmul, whose
// init / out_scale epilogue the Pallas kernel lacks. What it computes, not how
// the TPU did it:
//
// * One block owns one 64 x MT tile of the output (64 rows of X, MT = 64 G
//   columns of V, G = 1, 2 or 3 chosen per call) and loops over all column
//   blocks j of K in steps of 64 itself, with the sum held in registers. The
//   TPU kernel relied on its grid running j in order with the output block
//   resident; here blocks run in no order, so nothing carries over between
//   them. No atomics and no second pass: every output element is summed over j
//   ascending whatever G is, so runs repeat bit for bit.
// * Per j step the block builds the 64 x 64 tile of K in shared memory: the
//   rank-P part as an IEEE fp32 FMA chain with p ascending (exactly P steps),
//   the norms from a pre-pass, clamp, expf. This is gauss_entry.cuh's
//   arithmetic, the same as the dense kernel's, so the tile equals
//   gauss_tile(X, X) bit for bit. Like the JAX kernel_matmul, and unlike the
//   dense kernel in its symmetric mode, no exact-1 diagonal is written: K_ii
//   is exp(-max(2 r_i - 2 x_i.x_i, 0) / sigma), which is 1 only up to the
//   rounding of r_i.
// * Then tile . V_j for a staged 64 x MT slice of V. Precise mode (FAST =
//   false): fp32 FMA, 4 x 4G outputs per thread, no tensor cores. Fast mode
//   (FAST = true, the counterpart of Precision.DEFAULT on tile . V only):
//   nvcuda::wmma TF32 m16n16k8 fragments fed from the same two shared arrays
//   (the tile rounded to TF32 as it is stored, V as it is loaded into
//   fragments); fp32 accumulators. The rank-P part is never TF32: its errors land inside exp().
// * No padding: N, P and the width M of V are arbitrary; ragged edges are masked
//   (zero rows of V past N, zero tile entries past N, guarded stores).
// * Epilogue: each output element is read once as init (when given) and written
//   once by the same thread, so out may alias init. It must not alias X or V,
//   which other blocks are still reading.
// * Row offsets into V, init and out are 64-bit: N * M passes 2^31.
//
// Bound on an H100. The work is 2 N^2 (P + M) FLOP and X, V, out together are
// O(N (P + M)) bytes, so operations bind, not bytes: fp32 FMA throughput in
// precise mode, the fp32 rank-P part plus TF32 tensor-core throughput in fast
// mode. What the kernel spends beyond that is scheduler slots: the K tile
// (P FMAs, an IEEE division and an expf per entry, about 40 operations) is
// rebuilt once per m-tile, ceil(M / MT) times per (i, j), and the shared-memory
// loads of the tile . V pass compete with its FMAs for those slots. A wide
// m-tile cuts both: G = 3 at M = 540 rebuilds the tile 3 times (576 columns, 7%
// masked) where 64-wide tiles rebuild it 9 times, and feeds 48 FMAs from 4
// 16-byte loads. G is the host's choice, the least ceil(M / 64G) (64G +
// TILE_COST) over G, narrowed again while the grid would not fill the card.
// The slice of V, the block's largest load (every block streams all of its MT
// columns of V through L2 once), travels by cp.async
// while the tile is built. wgmma, TMA, more rows per block (which would cut
// that V traffic) and a deeper pipeline are left for later.
//
// Measuring without a profiler: compiled with -DBIGKRLS_ABLATE_GRAM, _EXP,
// _VLOAD or _PASS the kernel skips that part (and computes garbage);
// tools/time_kernel_matmul.py --ablate times the variants to attribute the
// kernel's time to its parts. No build of the package defines them.

#include <mma.h>

#include "gauss_entry.cuh"

namespace {

using namespace nvcuda;
using bigkrls::gauss_entry;
using bigkrls::gram_fma;

constexpr int TILE = 64;      // output rows per block, and the j step
constexpr int PC = 32;        // width of the P chunk staged per step
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4G outputs each
constexpr int LD = TILE + 4;  // shared row pitch: keeps float4 and wmma alignment, spreads banks
constexpr int MAX_G = 3;
// cost of building one tile entry, in units of one column's FMA: weighs a
// wider m-tile's masked columns against rebuilding the tile once more
constexpr int TILE_COST = 48;

constexpr int smem_floats(int G) { return TILE * LD + TILE * (TILE * G + 4) + 2 * PC * LD; }

// 16- and 4-byte asynchronous copies global -> shared; `ok` false writes zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = ok ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

// stage rows row0.. of X, columns k0..k0+PC, transposed into dst[p][row]; zero
// past the edges
__device__ __forceinline__ void load_x_chunk(const float* __restrict__ X, int64_t N, int P,
                                             int64_t row0, int k0, float* dst, int tid) {
#pragma unroll
  for (int l = 0; l < (TILE * PC) / THREADS; ++l) {
    const int e = tid + l * THREADS;
    const int row = e / PC;
    const int k = e % PC;
    const int64_t xr = row0 + row;
    dst[k * LD + row] = (xr < N && k0 + k < P) ? X[xr * P + k0 + k] : 0.0f;
  }
}

template <int G, bool FAST>
__global__ void __launch_bounds__(THREADS, 2)
kernel_matmul_kernel(const float* __restrict__ X, const float* __restrict__ r,
                     const float* __restrict__ V, const float* init, float* out,
                     int64_t N, int P, int64_t M, float sigma, float out_scale, int vec4) {
  constexpr int MT = TILE * G;  // output columns per block
  constexpr int LDV = MT + 4;
  extern __shared__ __align__(128) float smem[];
  float* Ks = smem;              // K tile [i][j], pitch LD
  float* Vs = Ks + TILE * LD;    // V slice [j][m], pitch LDV
  float* Xi = Vs + TILE * LDV;   // X chunks, transposed [p][row], pitch LD
  float* Xj = Xi + PC * LD;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int64_t i0 = (int64_t)blockIdx.x * TILE;
  const int64_t m0 = (int64_t)blockIdx.y * MT;
  const bool one_chunk = P <= PC;

  // fast mode: warp w owns 2 x G fragments, rows 32 (w / 4) and columns
  // 16 G (w % 4): per 8-deep step it loads 2 + G fragments for 2 G products
  const int frow = ((tid / 32) / 4) * 2;
  const int fcol = ((tid / 32) % 4) * G;
  wmma::fragment<wmma::accumulator, 16, 16, 8, float> cfrag[2][G];
  float acc[4][4 * G];
  if constexpr (FAST) {
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int f = 0; f < G; ++f) wmma::fill_fragment(cfrag[a][f], 0.0f);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4 * G; ++c) acc[i][c] = 0.0f;
  }

  float ri[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = i0 + ty * 4 + i;
    ri[i] = row < N ? r[row] : 0.0f;
  }
  if (one_chunk) load_x_chunk(X, N, P, i0, 0, Xi, tid);

  for (int64_t j0 = 0; j0 < N; j0 += TILE) {
    // ---- the V slice (rows j0.., columns m0.., zero past the edges) starts
    // on its way to shared memory now and is awaited after the tile is built
#ifdef BIGKRLS_ABLATE_VLOAD
    if (j0 == 0)
#endif
    if (vec4) {  // M % 4 == 0 and V 16-byte aligned: a float4 is all in or all out
#pragma unroll
      for (int l = 0; l < (TILE * MT / 4) / THREADS; ++l) {
        const int e = tid + l * THREADS;
        const int k = e / (MT / 4);
        const int c = (e % (MT / 4)) * 4;
        const bool ok = j0 + k < N && m0 + c < M;
        cp_async16(&Vs[k * LDV + c], ok ? &V[(j0 + k) * M + m0 + c] : V, ok);
      }
    } else {
#pragma unroll 4
      for (int l = 0; l < (TILE * MT) / THREADS; ++l) {
        const int e = tid + l * THREADS;
        const int k = e / MT;
        const int c = e % MT;
        const bool ok = j0 + k < N && m0 + c < M;
        cp_async4(&Vs[k * LDV + c], ok ? &V[(j0 + k) * M + m0 + c] : V, ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);

    // ---- rank-P part: g = X_i X_j^T, fp32 FMA chain with p ascending ----
    float g[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) g[i][j] = 0.0f;

    for (int k0 = 0; k0 < P; k0 += PC) {
      if (!one_chunk) {
        __syncthreads();  // the previous chunk's readers are done
        load_x_chunk(X, N, P, i0, k0, Xi, tid);
      }
      load_x_chunk(X, N, P, j0, k0, Xj, tid);
      __syncthreads();
#ifdef BIGKRLS_ABLATE_GRAM
      const int kn = 0;
#else
      const int kn = min(PC, P - k0);
#endif
#pragma unroll 4
      for (int k = 0; k < kn; ++k) {
        const float4 a4 = *reinterpret_cast<const float4*>(&Xi[k * LD + ty * 4]);
        const float4 b4 = *reinterpret_cast<const float4*>(&Xj[k * LD + tx * 4]);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
        const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] = gram_fma(a[i], b[j], g[i][j]);
      }
    }

    // ---- the K tile into shared memory; entries past N are zero ----
    float rj[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t col = j0 + tx * 4 + j;
      rj[j] = col < N ? r[col] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool row_ok = i0 + ty * 4 + i < N;
      float kv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = row_ok && (j0 + tx * 4 + j < N);
#ifdef BIGKRLS_ABLATE_EXP
        kv[j] = ok ? g[i][j] + ri[i] + rj[j] : 0.0f;
#else
        kv[j] = ok ? gauss_entry(g[i][j], ri[i], rj[j], sigma) : 0.0f;
#endif
        if constexpr (FAST) kv[j] = wmma::__float_to_tf32(kv[j]);
      }
      *reinterpret_cast<float4*>(&Ks[(ty * 4 + i) * LD + tx * 4]) =
          make_float4(kv[0], kv[1], kv[2], kv[3]);
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();

    // ---- tile . V_j ----
#ifdef BIGKRLS_ABLATE_PASS
    if (j0 < 0)
#endif
    if constexpr (FAST) {
#pragma unroll
      for (int kk = 0; kk < TILE; kk += 8) {
        wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, wmma::row_major> af[2];
#pragma unroll
        for (int a = 0; a < 2; ++a)  // rounded to TF32 when the tile was stored
          wmma::load_matrix_sync(af[a], &Ks[(frow + a) * 16 * LD + kk], LD);
#pragma unroll
        for (int f = 0; f < G; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, wmma::row_major> bf;
          wmma::load_matrix_sync(bf, &Vs[kk * LDV + (fcol + f) * 16], LDV);
#pragma unroll
          for (int t = 0; t < bf.num_elements; ++t) bf.x[t] = wmma::__float_to_tf32(bf.x[t]);
#pragma unroll
          for (int a = 0; a < 2; ++a) wmma::mma_sync(cfrag[a][f], af[a], bf, cfrag[a][f]);
        }
      }
    } else {
#pragma unroll 2
      for (int k = 0; k < TILE; k += 4) {
        float a[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 a4 = *reinterpret_cast<const float4*>(&Ks[(ty * 4 + i) * LD + k]);
          a[i][0] = a4.x; a[i][1] = a4.y; a[i][2] = a4.z; a[i][3] = a4.w;
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int gg = 0; gg < G; ++gg) {
            const float4 b4 =
                *reinterpret_cast<const float4*>(&Vs[(k + kk) * LDV + gg * TILE + tx * 4]);
            const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[i][gg * 4 + j] = __fmaf_rn(a[i][kk], b[j], acc[i][gg * 4 + j]);
          }
        }
      }
    }
    __syncthreads();
  }

  if constexpr (FAST) {
    // accumulator fragments -> shared -> the thread layout of the epilogue
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int f = 0; f < G; ++f)
        wmma::store_matrix_sync(&Vs[(frow + a) * 16 * LDV + (fcol + f) * 16], cfrag[a][f], LDV,
                                wmma::mem_row_major);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int gg = 0; gg < G; ++gg)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][gg * 4 + j] = Vs[(ty * 4 + i) * LDV + gg * TILE + tx * 4 + j];
  }

  // ---- epilogue: (sum + init) * out_scale; init and out may be one buffer ----
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = i0 + ty * 4 + i;
    if (row >= N) continue;
#pragma unroll
    for (int gg = 0; gg < G; ++gg) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t col = m0 + gg * TILE + tx * 4 + j;
        if (col >= M) continue;
        const int64_t off = row * M + col;
        float v = acc[i][gg * 4 + j];
        if (init != nullptr) v = __fadd_rn(v, init[off]);
        out[off] = __fmul_rn(v, out_scale);
      }
    }
  }
}

template <int G, bool FAST>
int launch(const float* X, const float* r, const float* V, const float* init, float* out,
           int64_t N, int P, int64_t M, float sigma, float out_scale, cudaStream_t s) {
  constexpr int MT = TILE * G;
  constexpr int bytes = smem_floats(G) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(kernel_matmul_kernel<G, FAST>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const int vec4 = (M % 4 == 0) && (reinterpret_cast<uintptr_t>(V) % 16 == 0);
  dim3 grid((unsigned)((N + TILE - 1) / TILE), (unsigned)((M + MT - 1) / MT));
  kernel_matmul_kernel<G, FAST><<<grid, THREADS, bytes, s>>>(X, r, V, init, out, N, P, M, sigma,
                                                             out_scale, vec4);
  return (int)cudaGetLastError();
}

template <bool FAST>
int launch_g(int G, const float* X, const float* r, const float* V, const float* init,
             float* out, int64_t N, int P, int64_t M, float sigma, float out_scale,
             cudaStream_t s) {
  switch (G) {
    case 1: return launch<1, FAST>(X, r, V, init, out, N, P, M, sigma, out_scale, s);
    case 2: return launch<2, FAST>(X, r, V, init, out, N, P, M, sigma, out_scale, s);
    default: return launch<3, FAST>(X, r, V, init, out, N, P, M, sigma, out_scale, s);
  }
}

}  // namespace

// C interface for ctypes. X is (N, P), V is (N, M), out is (N, M), init is (N, M)
// or null, all row-major contiguous fp32 on the current device; r (N) is scratch
// for the row norms. out may be the same buffer as init and must not overlap X
// or V. fast != 0 runs tile . V in TF32 on the tensor cores. m_tiles = 0 lets
// the kernel choose its m-tile width (64, 128 or 192 columns); 1, 2 or 3 forces
// it. Launches on `stream` and does not synchronize. Returns cudaGetLastError()
// after the launches.
extern "C" int kernel_matmul_f32(const float* X, const float* V, const float* init, float* r,
                                 float* out, int64_t N, int64_t P, int64_t M, float sigma,
                                 float out_scale, int fast, int m_tiles, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P > INT32_MAX) return (int)cudaErrorInvalidValue;
  bigkrls::launch_row_sqnorm(X, N, P, r, s);
  int G = m_tiles;
  if (G < 1 || G > MAX_G) {
    int64_t best = INT64_MAX;
    for (int c = 1; c <= MAX_G; ++c) {
      const int64_t mt = TILE * c;
      const int64_t cost = ((M + mt - 1) / mt) * (mt + TILE_COST);
      if (cost < best) { best = cost; G = c; }
    }
    // a small problem wants blocks before it wants wide tiles: narrow the tile
    // while the grid would leave SMs (two blocks each) without work
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int64_t rows = (N + TILE - 1) / TILE;
    while (G > 1 && rows * ((M + TILE * G - 1) / (TILE * G)) < 2 * (int64_t)sms) --G;
  }
  if (fast) return launch_g<true>(G, X, r, V, init, out, N, (int)P, M, sigma, out_scale, s);
  return launch_g<false>(G, X, r, V, init, out, N, (int)P, M, sigma, out_scale, s);
}
