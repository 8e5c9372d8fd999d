// Entry arithmetic of the Gaussian kernel, shared by the dense tile kernel
// (gauss_kernel.cu) and the kernel-free product (kernel_matmul.cu):
//
//   r_i  = sum_p x_ip^2                        (row_sqnorm_kernel, one thread per row)
//   g_ij = sum_p a_ip b_jp                     (gram_fma: IEEE fp32 FMA chain, p ascending)
//   k_ij = expf(-max(r_i + r_j - 2 g_ij, 0) / sigma)            (gauss_entry; IEEE quotient)
//
// Both kernels run exactly these operations per entry, so for the same rows
// they produce the same bits: the product's on-chip tile equals the dense
// kernel's tile wherever the dense kernel does not overwrite the diagonal.
// No TF32 and no tensor cores here: the rank-P cancellation at r ~ P lands
// inside exp().
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bigkrls {

// static: each translation unit that includes this header gets its own copy
static __global__ void row_sqnorm_kernel(const float* __restrict__ X, int64_t rows, int64_t P,
                                  float* __restrict__ r) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  const float* x = X + i * P;
  float acc = 0.0f;
  for (int64_t p = 0; p < P; ++p) acc = __fmaf_rn(x[p], x[p], acc);
  r[i] = acc;
}

// The most devices a process launches the kernels on.
constexpr int MAX_DEVICES = 64;

// Let `kernel` take `bytes` of dynamic shared memory on the current device.
// The attribute belongs to the function in one device's context, so what was
// allowed is kept per device: `allowed` is the calling instantiation's own
// table, one entry a device, raised only where a launch needs more. A
// failure is returned and cleared (see launch_error).
template <typename Kernel>
inline cudaError_t allow_dynamic_shared(Kernel* kernel, int bytes, int (&allowed)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev < 0 || dev >= MAX_DEVICES)) return cudaErrorInvalidDevice;
  if (e == cudaSuccess && bytes > allowed[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess) allowed[dev] = bytes;
  }
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

// The launch's error: `e` where the launch call itself failed, else what
// cudaGetLastError() holds. Either way the thread's last error is read and
// so cleared: a failure left pending would be reported by the next launch
// that succeeds, on whichever device.
inline int launch_error(cudaError_t e) {
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

static inline void launch_row_sqnorm(const float* X, int64_t rows, int64_t P, float* r,
                              cudaStream_t s) {
  const int nb = 256;
  row_sqnorm_kernel<<<(unsigned)((rows + nb - 1) / nb), nb, 0, s>>>(X, rows, P, r);
}

// one step of the rank-P chain; a zero factor (edge padding) leaves g bit-unchanged
__device__ __forceinline__ float gram_fma(float a, float b, float g) {
  return __fmaf_rn(a, b, g);
}

// 1 / sigma, correctly rounded: once per thread, outside its loops
__device__ __forceinline__ float sigma_reciprocal(float sigma) { return __frcp_rn(sigma); }

// The entry. d2 / sigma is the IEEE quotient, computed without the compiler's
// division, whose range check is a branch per entry that keeps a thread's
// entries from overlapping (measured: 160 clocks an entry, one after the
// other). With rcp the correctly rounded 1 / sigma, q0 = RN(d2 rcp) is within
// an ulp of the quotient, its remainder fma(-q0, sigma, d2) is exact, and
// RN(q0 + rem rcp) is the correctly rounded quotient (Markstein's theorem).
// Where d2 / sigma is subnormal the remainder may round; expf(-q) is 1 there
// whatever q's last bits are.
__device__ __forceinline__ float gauss_entry(float g, float r_row, float r_col, float sigma,
                                             float rcp) {
  const float s = __fadd_rn(r_row, r_col);
  const float d2 = fmaxf(__fmaf_rn(-2.0f, g, s), 0.0f);
  const float q0 = __fmul_rn(d2, rcp);
  const float q = __fmaf_rn(__fmaf_rn(-q0, sigma, d2), rcp, q0);
  return expf(-q);
}

}  // namespace bigkrls
