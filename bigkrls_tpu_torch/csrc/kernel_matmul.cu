// Kernel-free product for Hopper (sm_90a): out = (K(X) V + init) * out_scale with
// K_ij = exp(-max(r_i + r_j - 2 x_i.x_j, 0) / sigma), K never written to device memory.
//
// Replaces the Pallas TPU kernel bigkrls_tpu/ops/matvec.py::_km_kernel (launched
// by kernel_matmul_pallas and its _fast alias) and computes the function of the
// JAX package's default streaming product, matvec.py::kernel_matmul, whose
// init / out_scale epilogue the Pallas kernel lacks. What it computes, not how
// the TPU did it:
//
// * One block owns 64 rows of the output and 64 NT columns of V and loops over
//   all column blocks j of K in steps of 64 itself, with the sum held in
//   registers. NT is 1 or 4 (64 or 256 columns), or 5 as half of a pair: a
//   cluster of two blocks on neighbouring SMs that own 2 x 320 columns of the
//   same 64 rows (the host picks, see ops/matvec.py::_tile_plan). Blocks share
//   nothing but a pair's K tiles; no atomics and no second pass. Every output
//   element sees the same sequence of operations whatever NT is, so the result
//   does not depend on NT and runs repeat bit for bit.
// * The block is three warpgroups that never reconverge. The producer
//   warpgroup builds the 64 x 64 tile of K for a later step while the two
//   consumer warpgroups multiply the current tile into their accumulators: two
//   tile buffers in shared memory, a full and an empty mbarrier each, no
//   block-wide barrier after the split. setmaxnreg moves registers between the
//   warpgroups. In a pair the two producers take turns: block 0 builds the
//   tiles of the even steps and block 1 those of the odd steps, each writes
//   its tile into both blocks' shared memory (st.shared::cluster) and arrives
//   on both full barriers; consumers release a buffer to the block that fills
//   it. So at m = 540 every K tile is built once per (i, j), by one of two SMs
//   that both use it, each SM streams half of V's columns, and a consumer
//   thread holds 80 accumulators. A single 576-wide block (144 accumulators a
//   thread) was measured first: ptxas spilled in the product loop and it ran
//   95 ms where the pair runs 65.
// * The tile is gauss_entry.cuh's arithmetic: the rank-P part as an IEEE fp32
//   FMA chain with p ascending (exactly P steps), the norms from a pre-pass,
//   clamp, the IEEE quotient by sigma, expf; the same operations as the dense
//   kernel's, so the tile equals gauss_tile(X, X) bit for bit. Like the JAX
//   kernel_matmul, and unlike the dense kernel in its symmetric mode, no
//   exact-1 diagonal is written. X_j and the norms (and X_i when P > 32)
//   arrive in 32-wide chunks by cp.async, one chunk ahead of the chain that
//   consumes it, with a barrier of the producer warpgroup's own (bar.sync 1)
//   per chunk.
// * tile . V_j runs on the tensor cores: mma.sync.m16n8k8 TF32 with fp32
//   accumulators, A fragments by ldmatrix from the tile, B fragments from the
//   V slice as it lies in memory (row-major (j, m); mma.sync has no layout
//   rule, so V is neither transposed nor copied). Three modes:
//     SPLIT (precise): tile = hi + lo and V = hi + lo, each part rounded to
//       TF32 (to nearest, as cvt.rna does); lo.hi + hi.lo + hi.hi, three
//       tensor-core passes. The dropped lo.lo term and the rounding of the lo
//       parts are 2^-22 relative per product, the accuracy of an fp32 product.
//       The producer splits the tile once; consumers split their V fragments
//       in registers. The tensor cores add into an fp32 accumulator by
//       truncation, and over N / 8 steps that error grows past an IEEE
//       chain's tenfold (measured); so each 8-deep step's three passes go into
//       a partial sum that starts at zero, and the running sum takes it by an
//       IEEE add. That is 4 registers per mma.sync fragment, and the reason
//       the product is mma.sync: a wgmma accumulator is the whole 64 x N
//       block, and a second one does not fit beside it.
//     FAST: one pass on the hi parts (TF32-rounded tile and V), the
//       counterpart of Precision.DEFAULT on tile . V only; its 8-deep partial
//       sums go into the running sum by an IEEE add as SPLIT's do (added
//       directly, the accumulator's truncation made a 1M-row product 7.5x as
//       far from float64 as the same TF32 rounding with IEEE sums).
//     FMA: no tensor cores; each output is an IEEE fp32 FMA chain over j
//       ascending, in the same accumulator layout. It is what SPLIT's error is
//       measured against and is reached only by tools and tests.
//   The rank-P part is never TF32 in any mode: its errors land inside exp().
// * Each consumer warp stages its own 8 NT columns of V, 16 rows at a time,
//   through a ring of 3 stages with 16-byte cp.async and waits on nothing but
//   its own copies (cp.async.wait_group + __syncwarp). V's row pitch (ldv) is
//   a multiple of 4 floats and V is 16-byte aligned: the wrapper pads a V
//   whose width is not. Rows past N are zero-filled; tile entries past N are
//   zero.
// * Epilogue: each output element is read once as init (when given) and written
//   once by the thread that holds its accumulator, so out may alias init. It
//   must not alias X or V, which other blocks are still reading.
// * Row offsets into V, init and out are 64-bit: N * M passes 2^31.
// * The cross entry computes (K(Xa, Xb) V + init) * out_scale for Xa (Na, P),
//   Xb (Nb, P) and V (Nb, M): the rows of the output (and of each tile) come
//   from Xa and the columns of K, the steps j and the rows of V from Xb, each
//   with its own norms and its own bound. That is one step of a ring product
//   (parallel/ring_kernel.py): a block of rows against a visiting block.
//   The square entry is the cross entry with Xa = Xb, one norm pre-pass and
//   Na = Nb, so it runs the same operations as before the cross entry existed.
//
// Bound on an H100. The work is 2 N^2 P fp32 operations for the tile and
// 2 N^2 M (FAST) or 6 N^2 M (SPLIT) TF32 operations for the product; X, V, out
// together are O(N (P + M)) bytes, so operations bind, not bytes. mma.sync TF32
// tops out at 0.57 mma per clock and SM on this card (tools/mma_sync_peak.cu,
// 62% of the wgmma peak); the consumers reach about 0.36. What else holds the
// kernel back is written in PERF.md: a producer warpgroup is latency-bound on
// its own chain (chunk, FMAs, quotient, expf, stores), the pair's tile stores
// and arrivals cross between SMs, and every block streams all of its columns
// of V through L2 once per 64 rows.
//
// Measuring without a profiler: compiled with -DBIGKRLS_ABLATE_GRAM, _EXP,
// _VLOAD or _MMA the kernel skips that part (and computes garbage); with
// _NO_OVERLAP a producer does not start a tile before its previous one has been
// read. tools/time_kernel_matmul.py --ablate times the variants to attribute
// the kernel's time to its parts. No build of the package defines them.

#include "gauss_entry.cuh"

namespace {

using bigkrls::gauss_entry;
using bigkrls::gram_fma;

constexpr int TILE = 64;          // output rows per block, and the j step
constexpr int PC = 32;            // width of the P chunk staged per step
constexpr int KC = 16;            // rows of V per ring stage
constexpr int STAGES = 3;         // ring depth of the V slices
constexpr int LDA = TILE + 4;     // shared row pitch of the tile and the X chunks:
                                  // 16-byte rows, 8 rows on 8 distinct bank groups
constexpr int XBUF = (PC + 1) * LDA;  // an X chunk [p][row] and, as one more row, the rows' norms
constexpr int CONSUMER_WARPS = 8;
constexpr int CONSUMERS = 32 * CONSUMER_WARPS;
constexpr int PRODUCERS = 128;
constexpr int THREADS = CONSUMERS + PRODUCERS;

enum Mode { SPLIT = 0, FAST = 1, FMA = 2 };

constexpr int TILE_BUFS = 2;      // K tiles in shared memory: one read while the next is built

// floats of shared memory: tile buffers (hi, and lo in SPLIT mode), X chunks
// (X_j double-buffered; X_i once when P fits one chunk, else double-buffered),
// the consumer warps' V rings; then 2 * TILE_BUFS mbarriers
__host__ __device__ constexpr int tile_floats(int mode) {
  return TILE_BUFS * (mode == SPLIT ? 2 : 1) * TILE * LDA;
}
// row pitch of a warp's V slice: its 8 nt columns, padded where needed so that
// the pitch is 8 or 24 mod 32 and a B fragment's 4 rows fall on distinct banks
__host__ __device__ constexpr int ring_pitch(int nt) {
  return (8 * nt) % 32 == 8 || (8 * nt) % 32 == 24 ? 8 * nt : 8 * nt + 8;
}
__host__ __device__ constexpr int ring_floats(int nt) {
  return CONSUMER_WARPS * STAGES * KC * ring_pitch(nt);
}
inline int smem_bytes(int nt, int mode, int P) {
  const int xbufs = P > PC ? 4 : 3;
  return (tile_floats(mode) + xbufs * XBUF + ring_floats(nt)) * (int)sizeof(float) + 64;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// asynchronous copies global -> shared; `ok` false writes zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const int bytes = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const int bytes = ok ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// a pair of blocks (a cluster of 2): rank in the pair, the other block's address
// of one of this block's shared-memory addresses, a 16-byte store and an
// mbarrier arrival there, and the pair's own barrier
__device__ __forceinline__ unsigned pair_rank() {
  unsigned rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  return rank;
}
__device__ __forceinline__ unsigned peer_address(unsigned local, unsigned peer) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(peer));
  return remote;
}
__device__ __forceinline__ void peer_store(unsigned remote, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(remote), "f"(v.x),
               "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}
__device__ __forceinline__ void peer_arrive(unsigned remote_bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(remote_bar)
               : "memory");
}
__device__ __forceinline__ void pair_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}
// wait until the barrier's phase differs from `parity`; a wait that lasts
// seconds is a broken pipeline, and traps instead of hanging the card
template <bool PAIR>
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  const long long t0 = clock64();
  unsigned done = 0;
  while (!done) {
    if constexpr (PAIR)  // the other block of the pair arrives here too
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
    else
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
    if (!done && clock64() - t0 > (1ll << 32)) __trap();
  }
}

// round to TF32 (10 mantissa bits), to nearest, ties away from zero: what
// cvt.rna.tf32.f32 gives for every finite value, in two integer operations (the
// conversion unit is the slower pipe, and the consumers round 2 to 4 values per
// 4 mma)
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// four 8 x 4 blocks of 32-bit values: lane l gives the address of row l % 8 of
// block l / 8 and receives element (l / 4, l % 4) of each block
__device__ __forceinline__ void ldmatrix_x4(unsigned (&a)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_u32(p)));
}

// c += a (16 x 8, row) . b (8 x 8, col), TF32 operands, fp32 accumulators
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int REGS>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// registers a thread: at launch 65536 / (384 BLOCKS) rounded down to 8 (168 or
// 80), then 2 CONSUMER_REGS + PRODUCER_REGS a little under 3 times that: at
// exactly 3 times the last warpgroup to grow waited for ever (measured)
template <int NT> struct Plan {
  static constexpr int BLOCKS = 1, CONSUMER_REGS = 208, PRODUCER_REGS = 88;
};
template <> struct Plan<1> {
  static constexpr int BLOCKS = 2, CONSUMER_REGS = 72, PRODUCER_REGS = 88;
};
// the widest block is half of a pair (a cluster of 2 blocks on neighbouring
// SMs): 2 x 320 columns of the same 64 rows. The two producer warpgroups build
// the K tiles in turns, block 0 the even steps and block 1 the odd ones, each
// into its own tile buffer of both blocks' shared memory
constexpr int PAIR_NT = 5;

// start the copies of rows row0.. of X, columns k0..k0+PC, transposed into
// dst[p][row], and of the rows' norms into dst[PC][row]; zero past the edges.
// Thread tid copies column k0 + tid % 32 of rows tid / 32, + 4, + 8, ...
__device__ __forceinline__ void load_x_chunk(const float* __restrict__ X,
                                             const float* __restrict__ r, int64_t N, int P,
                                             int64_t row0, int k0, float* dst, int tid) {
  const int k = tid % PC;
  const bool k_ok = k0 + k < P;
  int64_t xr = row0 + tid / PC;
  const float* src = X + xr * P + k0 + k;
  float* d = dst + k * LDA + tid / PC;
#pragma unroll 4
  for (int l = 0; l < (TILE * PC) / PRODUCERS; ++l) {
    const bool ok = k_ok && xr < N;
    cp_async4(d, ok ? src : X, ok);
    xr += PRODUCERS / PC;
    src += (PRODUCERS / PC) * (int64_t)P;
    d += PRODUCERS / PC;
  }
  if (tid < TILE) {
    const bool ok = row0 + tid < N;
    cp_async4(dst + PC * LDA + tid, ok ? r + row0 + tid : r, ok);
  }
}

template <int NT, int MODE>
__global__ void __launch_bounds__(THREADS, Plan<NT>::BLOCKS)
kernel_matmul_kernel(const float* __restrict__ Xa, const float* __restrict__ ra, int64_t Na,
                     const float* __restrict__ Xb, const float* __restrict__ rb, int64_t Nb,
                     const float* __restrict__ V, int64_t ldv, const float* init, float* out,
                     int P, int64_t M, float sigma, float out_scale) {
  constexpr int WN = 8 * NT;            // columns of V per consumer warp
  constexpr int WP = ring_pitch(NT);    // and the row pitch of its slices
  constexpr int TPARTS = MODE == SPLIT ? 2 : 1;
  constexpr bool PAIR = NT == PAIR_NT;
  constexpr int ENTRY_REGS = 65536 / (THREADS * Plan<NT>::BLOCKS) / 8 * 8;  // 168 or 80
  extern __shared__ __align__(128) float smem[];
  float* Ts = smem;                                   // [buf][hi, lo][i][j], pitch LDA
  float* Xj = Ts + tile_floats(MODE);                 // [2][p][row] + norms, pitch LDA
  float* Xi = Xj + 2 * XBUF;                          // [1 or 2][p][row]
  float* Vs = Xi + (P > PC ? 2 : 1) * XBUF;           // [warp][stage][k], pitch WP
  const unsigned bars = smem_u32(Vs + ring_floats(NT));  // full[TILE_BUFS], empty[TILE_BUFS]

  const int64_t i0 = (int64_t)blockIdx.x * TILE;
  const int64_t m0 = (int64_t)blockIdx.y * (TILE * NT);
  const int steps = (int)((Nb + TILE - 1) / TILE);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int b = 0; b < TILE_BUFS; ++b) {
      mbar_init(bars + 8 * b, PRODUCERS);  // every thread of the producer that fills b
      // one lane per consumer warp, of both blocks in a pair
      mbar_init(bars + 8 * (TILE_BUFS + b), CONSUMER_WARPS * (PAIR ? 2 : 1));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  unsigned rank = 0;  // in a pair: this block fills tile buffer `rank`, at steps rank, rank + 2, ...
  if constexpr (PAIR) {
    static_assert(TILE_BUFS == 2, "a pair has one tile buffer per block");
    pair_sync();  // the other block's barriers exist before anyone arrives there
    rank = pair_rank();
  }
  const unsigned peer = rank ^ 1;
  constexpr int STRIDE = PAIR ? 2 : 1;  // steps from one of this producer's tiles to its next

  if (threadIdx.x >= CONSUMERS) {
    // ================= producer warpgroup: the K tiles =================
    if constexpr (Plan<NT>::PRODUCER_REGS > ENTRY_REGS)
      regs_inc<Plan<NT>::PRODUCER_REGS>();
    else
      regs_dec<Plan<NT>::PRODUCER_REGS>();
    const int tid = threadIdx.x - CONSUMERS;
    const int tx = tid % 8;        // columns 8 tx .. 8 tx + 7 of the tile
    const int ty = 4 * (tid / 8);  // rows ty .. ty + 3
    const bool multi = P > PC;
    const float rcp = bigkrls::sigma_reciprocal(sigma);
    const int nch = (P + PC - 1) / PC;

    // chunk f = step * nch + c lives in buffer f % 2 and is copied while chunk
    // f - 1 is consumed
    load_x_chunk(Xb, rb, Nb, P, (int64_t)rank * TILE, 0, Xj, tid);
    load_x_chunk(Xa, ra, Na, P, i0, 0, Xi, tid);
    cp_async_commit();
    cp_async_wait<0>();
    asm volatile("bar.sync 1, %0;\n" ::"n"(PRODUCERS) : "memory");
    const float4 ri4 = *reinterpret_cast<const float4*>(&Xi[PC * LDA + ty]);
    const float ri[4] = {ri4.x, ri4.y, ri4.z, ri4.w};

    int f = 0;
    for (int js = rank; js < steps; js += STRIDE) {
      const int64_t j0 = (int64_t)js * TILE;
      const int b = js % TILE_BUFS;
#ifdef BIGKRLS_ABLATE_NO_OVERLAP  // no building while this producer's last tile is in use
      if (js >= STRIDE)
        mbar_wait<PAIR>(bars + 8 * (TILE_BUFS + (js - STRIDE) % TILE_BUFS),
                        ((js - STRIDE) / TILE_BUFS) & 1);
#endif

      // ---- rank-P part: g = X_i X_j^T, fp32 FMA chain with p ascending ----
      float g[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) g[i][j] = 0.0f;
      float rj[8];

      for (int c = 0; c < nch; ++c, ++f) {
        const bool last = js + STRIDE >= steps && c + 1 == nch;
        if (!last) {
          const int cn = c + 1 == nch ? 0 : c + 1;
          const int64_t jn = c + 1 == nch ? j0 + STRIDE * TILE : j0;
          load_x_chunk(Xb, rb, Nb, P, jn, cn * PC, Xj + ((f + 1) & 1) * XBUF, tid);
          if (multi) load_x_chunk(Xa, ra, Na, P, i0, cn * PC, Xi + ((f + 1) & 1) * XBUF, tid);
        }
        cp_async_commit();
        const float* xj = Xj + (f & 1) * XBUF;
        const float* xi = multi ? Xi + (f & 1) * XBUF : Xi;
#ifdef BIGKRLS_ABLATE_GRAM
        const int kn = 0;
#else
        const int kn = min(PC, P - c * PC);
#endif
#pragma unroll 2
        for (int k = 0; k < kn; ++k) {
          const float4 a4 = *reinterpret_cast<const float4*>(&xi[k * LDA + ty]);
          const float a[4] = {a4.x, a4.y, a4.z, a4.w};
          const float4 b0 = *reinterpret_cast<const float4*>(&xj[k * LDA + tx * 8]);
          const float4 b1 = *reinterpret_cast<const float4*>(&xj[k * LDA + tx * 8 + 4]);
          const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) g[i][j] = gram_fma(a[i], b[j], g[i][j]);
        }
        if (c + 1 == nch) {
          const float4 r0 = *reinterpret_cast<const float4*>(&xj[PC * LDA + tx * 8]);
          const float4 r1 = *reinterpret_cast<const float4*>(&xj[PC * LDA + tx * 8 + 4]);
          rj[0] = r0.x; rj[1] = r0.y; rj[2] = r0.z; rj[3] = r0.w;
          rj[4] = r1.x; rj[5] = r1.y; rj[6] = r1.z; rj[7] = r1.w;
        }
        cp_async_wait<0>();
        asm volatile("bar.sync 1, %0;\n" ::"n"(PRODUCERS) : "memory");
      }

      // ---- the entries, then into the tile buffer once its readers are done ----
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool row_ok = i0 + ty + i < Na;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const bool ok = row_ok && (j0 + tx * 8 + j < Nb);
#ifdef BIGKRLS_ABLATE_EXP
          g[i][j] = ok ? g[i][j] + ri[i] + rj[j] : 0.0f;
#else
          g[i][j] = ok ? gauss_entry(g[i][j], ri[i], rj[j], sigma, rcp) : 0.0f;
#endif
        }
      }
      mbar_wait<PAIR>(bars + 8 * (TILE_BUFS + b), ((js / TILE_BUFS) & 1) ^ 1);
      float* T = Ts + b * TPARTS * TILE * LDA;
      // 16 bytes into this block's tile and, in a pair, the other block's
      auto store4 = [&](float* dst, float4 v) {
        *reinterpret_cast<float4*>(dst) = v;
        if constexpr (PAIR) peer_store(peer_address(smem_u32(dst), peer), v);
      };
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float hi[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) hi[j] = MODE == FMA ? g[i][j] : tf32_rna(g[i][j]);
        float* row = &T[(ty + i) * LDA + tx * 8];
        store4(row, make_float4(hi[0], hi[1], hi[2], hi[3]));
        store4(row + 4, make_float4(hi[4], hi[5], hi[6], hi[7]));
        if constexpr (MODE == SPLIT) {
          float lo[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) lo[j] = tf32_rna(__fsub_rn(g[i][j], hi[j]));
          row += TILE * LDA;
          store4(row, make_float4(lo[0], lo[1], lo[2], lo[3]));
          store4(row + 4, make_float4(lo[4], lo[5], lo[6], lo[7]));
        }
      }
      mbar_arrive(bars + 8 * b);
      if constexpr (PAIR) peer_arrive(peer_address(bars + 8 * b, peer));
    }
    if constexpr (PAIR) pair_sync();  // no block leaves while the other may still write to it
  } else {
    // ================= consumer warpgroups: tile . V =================
    if constexpr (Plan<NT>::CONSUMER_REGS > ENTRY_REGS)
      regs_inc<Plan<NT>::CONSUMER_REGS>();
    else
      regs_dec<Plan<NT>::CONSUMER_REGS>();
    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;
    const int gq = lane / 4;  // fragment row (A, C) and column (B)
    const int tq = lane % 4;
    float* Vw = Vs + warp * STAGES * KC * WP;
    const int64_t mw = m0 + warp * WN;  // this warp's first column of V
    const int nq = steps * (TILE / KC);

    // start the copy of rows 16 q .. 16 q + 15 of this warp's columns of V
    auto load_v = [&](int q, int stage) {
#ifdef BIGKRLS_ABLATE_VLOAD
      if (q >= STAGES) return;
#endif
      float* dst = Vw + stage * KC * WP;
#pragma unroll
      for (int u = 0; u < NT; ++u) {
        const int e = lane + 32 * u;
        const int rr = e / (2 * NT);
        const int cc = (e % (2 * NT)) * 4;
        const int64_t row = (int64_t)q * KC + rr;
        const bool ok = row < Nb && mw + cc < ldv;
        cp_async16(&dst[rr * WP + cc], ok ? &V[row * ldv + mw + cc] : V, ok);
      }
    };

    float acc[4][NT][4];  // [16-row block][8-column block][c0..c3 of the mma layout]
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nq) load_v(s, s);
      cp_async_commit();
    }

    int q = 0, stage = 0;
    for (int js = 0; js < steps; ++js) {
      const int b = js % TILE_BUFS;
      mbar_wait<PAIR>(bars + 8 * b, (js / TILE_BUFS) & 1);
      const float* Thi = Ts + b * TPARTS * TILE * LDA;
      const float* Tlo = Thi + TILE * LDA;  // SPLIT only

      for (int kc = 0; kc < TILE / KC; ++kc, ++q) {
        cp_async_wait<STAGES - 2>();  // this lane's copies of slice q have landed
        __syncwarp();                 // every lane's have, and slice q - 1 is read
        {
          const int nxt = q + STAGES - 1;
          const int ns = stage == 0 ? STAGES - 1 : stage - 1;  // the stage of slice q - 1
          if (nxt < nq) load_v(nxt, ns);
          cp_async_commit();
        }
        const float* Vst = Vw + stage * KC * WP;
        stage = stage + 1 == STAGES ? 0 : stage + 1;
#ifdef BIGKRLS_ABLATE_MMA
        if (js >= 0) continue;
#endif
        if constexpr (MODE == FMA) {
#pragma unroll
          for (int k4 = 0; k4 < KC; k4 += 4) {
            float a[8][4];
#pragma unroll
            for (int h = 0; h < 8; ++h) {  // rows 16 (h / 2) + gq + 8 (h % 2)
              const float4 a4 = *reinterpret_cast<const float4*>(
                  &Thi[(16 * (h / 2) + gq + 8 * (h % 2)) * LDA + kc * KC + k4]);
              a[h][0] = a4.x; a[h][1] = a4.y; a[h][2] = a4.z; a[h][3] = a4.w;
            }
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
              for (int nt = 0; nt < NT; ++nt) {
                const float2 b2 =
                    *reinterpret_cast<const float2*>(&Vst[(k4 + kk) * WP + 8 * nt + 2 * tq]);
#pragma unroll
                for (int h = 0; h < 8; ++h) {
                  float* c = acc[h / 2][nt];
                  c[2 * (h % 2)] = __fmaf_rn(a[h][kk], b2.x, c[2 * (h % 2)]);
                  c[2 * (h % 2) + 1] = __fmaf_rn(a[h][kk], b2.y, c[2 * (h % 2) + 1]);
                }
              }
            }
          }
        } else {
          // one 8-deep step: A fragments of the four 16-row blocks, then per
          // 8-column block of V its B fragment and the products
          auto k8_step = [&](int ks) {
            const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;
            const int acol = kc * KC + ks + (lane >> 4) * 4;
            unsigned ahi[4][4], alo[4][4];
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) {
              ldmatrix_x4(ahi[mt], &Thi[(16 * mt + arow) * LDA + acol]);
              if constexpr (MODE == SPLIT) ldmatrix_x4(alo[mt], &Tlo[(16 * mt + arow) * LDA + acol]);
            }
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const float v0 = Vst[(ks + tq) * WP + 8 * nt + gq];
              const float v1 = Vst[(ks + tq + 4) * WP + 8 * nt + gq];
              const float h0 = tf32_rna(v0), h1 = tf32_rna(v1);
              const unsigned bh0 = __float_as_uint(h0), bh1 = __float_as_uint(h1);
              // the tensor cores' fp32 sum truncates: they take the 8-deep
              // partial sums only, and the running sum is an IEEE add
              if constexpr (MODE == SPLIT) {
                const unsigned bl0 = __float_as_uint(tf32_rna(__fsub_rn(v0, h0)));
                const unsigned bl1 = __float_as_uint(tf32_rna(__fsub_rn(v1, h1)));
#pragma unroll
                for (int mt = 0; mt < 4; ++mt) {
                  float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                  mma_tf32(part, alo[mt], bh0, bh1);
                  mma_tf32(part, ahi[mt], bl0, bl1);
                  mma_tf32(part, ahi[mt], bh0, bh1);
#pragma unroll
                  for (int e = 0; e < 4; ++e) acc[mt][nt][e] = __fadd_rn(acc[mt][nt][e], part[e]);
                }
              } else {
#pragma unroll
                for (int mt = 0; mt < 4; ++mt) {
                  float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                  mma_tf32(part, ahi[mt], bh0, bh1);
#pragma unroll
                  for (int e = 0; e < 4; ++e) acc[mt][nt][e] = __fadd_rn(acc[mt][nt][e], part[e]);
                }
              }
            }
          };
#pragma unroll
          for (int ks = 0; ks < KC; ks += 8) k8_step(ks);
        }
      }
      __syncwarp();  // every lane has read tile js
      if (lane == 0) {  // tell the producer that fills buffer b
        if (!PAIR || (unsigned)b == rank)
          mbar_arrive(bars + 8 * (TILE_BUFS + b));
        else
          peer_arrive(peer_address(bars + 8 * (TILE_BUFS + b), peer));
      }
    }
    cp_async_wait<0>();

    // ---- epilogue: (sum + init) * out_scale; init and out may be one buffer ----
#pragma unroll
    for (int h = 0; h < 8; ++h) {
      const int64_t row = i0 + 16 * (h / 2) + gq + 8 * (h % 2);
      if (row >= Na) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int64_t col = mw + 8 * nt + 2 * tq + e;
          if (col >= M) continue;
          const int64_t off = row * M + col;
          float v = acc[h / 2][nt][2 * (h % 2) + e];
          if (init != nullptr) v = __fadd_rn(v, init[off]);
          out[off] = __fmul_rn(v, out_scale);
        }
      }
    }
    if constexpr (PAIR) pair_sync();
  }
}

// the operands of one product: Xa's rows against Xb's, each with its norms
struct Operands {
  const float *Xa, *ra;
  int64_t Na;
  const float *Xb, *rb;
  int64_t Nb;
};

template <int NT, int MODE>
int launch(const Operands& x, const float* V, int64_t ldv, const float* init, float* out, int P,
           int64_t M, float sigma, float out_scale, cudaStream_t s) {
  const int bytes = smem_bytes(NT, MODE, P);
  static int allowed[bigkrls::MAX_DEVICES] = {};  // per device: see allow_dynamic_shared
  cudaError_t e = bigkrls::allow_dynamic_shared(kernel_matmul_kernel<NT, MODE>, bytes, allowed);
  if (e != cudaSuccess) return (int)e;
  constexpr int MT = TILE * NT;
  constexpr unsigned PAIRED = NT == PAIR_NT ? 2 : 1;  // blocks per cluster, along y
  const unsigned col_blocks = (unsigned)((M + MT - 1) / MT);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((x.Na + TILE - 1) / TILE), (col_blocks + PAIRED - 1) / PAIRED * PAIRED);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = PAIRED;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel_matmul_kernel<NT, MODE>, x.Xa, x.ra, x.Na, x.Xb, x.rb, x.Nb,
                         V, ldv, init, out, P, M, sigma, out_scale);
  return bigkrls::launch_error(e);
}

template <int MODE>
int launch_nt(int nt, const Operands& x, const float* V, int64_t ldv, const float* init,
              float* out, int P, int64_t M, float sigma, float out_scale, cudaStream_t s) {
  switch (nt) {
    case 1: return launch<1, MODE>(x, V, ldv, init, out, P, M, sigma, out_scale, s);
    case 4: return launch<4, MODE>(x, V, ldv, init, out, P, M, sigma, out_scale, s);
    case PAIR_NT: return launch<PAIR_NT, MODE>(x, V, ldv, init, out, P, M, sigma, out_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// one product: the norm pre-passes (one when Xa is Xb), then the kernel
int product(const float* Xa, int64_t Na, const float* Xb, int64_t Nb, const float* V, int64_t ldv,
            const float* init, float* r, float* out, int64_t P, int64_t M, float sigma,
            float out_scale, int mode, int n_tiles, cudaStream_t s) {
  if (P > INT32_MAX || Na > (int64_t)INT32_MAX * (TILE / 8) || Nb > (int64_t)INT32_MAX * (TILE / 8) ||
      ldv < M || ldv % 4 != 0 || reinterpret_cast<uintptr_t>(V) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const bool same = Xa == Xb && Na == Nb;
  bigkrls::launch_row_sqnorm(Xa, Na, P, r, s);
  float* rb = same ? r : r + Na;
  if (!same) bigkrls::launch_row_sqnorm(Xb, Nb, P, rb, s);
  const Operands x{Xa, r, Na, Xb, rb, Nb};
  const int p = (int)P;
  switch (mode) {
    case SPLIT: return launch_nt<SPLIT>(n_tiles, x, V, ldv, init, out, p, M, sigma, out_scale, s);
    case FAST: return launch_nt<FAST>(n_tiles, x, V, ldv, init, out, p, M, sigma, out_scale, s);
    case FMA: return launch_nt<FMA>(n_tiles, x, V, ldv, init, out, p, M, sigma, out_scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface for ctypes. X is (N, P), out is (N, M), init is (N, M) or null, all
// row-major contiguous fp32 on the current device; V is (N, M) with a row pitch
// of ldv floats, ldv a multiple of 4 and V 16-byte aligned; r (N) is scratch
// for the row norms. out may be the same buffer as init and must not overlap X
// or V. mode: 0 split-TF32 (three tensor-core passes), 1 fast (one TF32 pass),
// 2 IEEE fp32 FMA (no tensor cores). n_tiles: the block's width in 64-column
// units: 1, 4, or 5 for a pair of blocks (2 x 320 columns). Launches on `stream` and does not synchronize. Returns
// cudaGetLastError() after the launches.
extern "C" int kernel_matmul_f32(const float* X, const float* V, int64_t ldv, const float* init,
                                 float* r, float* out, int64_t N, int64_t P, int64_t M,
                                 float sigma, float out_scale, int mode, int n_tiles,
                                 void* stream) {
  return product(X, N, X, N, V, ldv, init, r, out, P, M, sigma, out_scale, mode, n_tiles,
                 static_cast<cudaStream_t>(stream));
}

// The cross entry: Xa (Na, P) and Xb (Nb, P), V (Nb, M) with pitch ldv, init and
// out (Na, M); r (Na + Nb) is scratch for both norms. Otherwise as above.
extern "C" int kernel_matmul_cross_f32(const float* Xa, int64_t Na, const float* Xb, int64_t Nb,
                                       const float* V, int64_t ldv, const float* init, float* r,
                                       float* out, int64_t P, int64_t M, float sigma,
                                       float out_scale, int mode, int n_tiles, void* stream) {
  return product(Xa, Na, Xb, Nb, V, ldv, init, r, out, P, M, sigma, out_scale, mode, n_tiles,
                 static_cast<cudaStream_t>(stream));
}
