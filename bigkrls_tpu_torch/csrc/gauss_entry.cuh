// Entry arithmetic of the Gaussian kernel, shared by the dense tile kernel
// (gauss_kernel.cu) and the kernel-free product (kernel_matmul.cu):
//
//   r_i  = sum_p x_ip^2                        (row_sqnorm_kernel, one thread per row)
//   g_ij = sum_p a_ip b_jp                     (gram_fma: IEEE fp32 FMA chain, p ascending)
//   k_ij = expf(-max(r_i + r_j - 2 g_ij, 0) / sigma)            (gauss_entry)
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

static inline void launch_row_sqnorm(const float* X, int64_t rows, int64_t P, float* r,
                              cudaStream_t s) {
  const int nb = 256;
  row_sqnorm_kernel<<<(unsigned)((rows + nb - 1) / nb), nb, 0, s>>>(X, rows, P, r);
}

// one step of the rank-P chain; a zero factor (edge padding) leaves g bit-unchanged
__device__ __forceinline__ float gram_fma(float a, float b, float g) {
  return __fmaf_rn(a, b, g);
}

__device__ __forceinline__ float gauss_entry(float g, float r_row, float r_col, float sigma) {
  const float s = __fadd_rn(r_row, r_col);
  const float d2 = fmaxf(__fmaf_rn(-2.0f, g, s), 0.0f);
  return expf(-d2 / sigma);
}

}  // namespace bigkrls
