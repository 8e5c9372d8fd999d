// What mma.sync can reach on one card: m16n8k8 TF32 (and m16n8k16 bf16) with
// fp32 accumulators, operands in registers, ILP independent accumulators a
// warp, 4 to 16 warps an SM, one block per SM. Prints the rate per SM and the
// card's TFLOP/s; the product kernel's tile . V pass is held against it.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o mma_sync_peak tools/mma_sync_peak.cu
//   ./mma_sync_peak
#include <cstdio>
#include <cuda_runtime.h>

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3},{%4,%5,%6,%7},{%8,%9},{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3},{%4,%5,%6,%7},{%8,%9},{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int ILP, int KIND>
__global__ void chain(float* out, int iters, unsigned seed) {
  float c[ILP][4];
  unsigned a[4] = {seed, seed + 1, seed + 2, seed + 3};
  for (int i = 0; i < ILP; ++i)
    for (int e = 0; e < 4; ++e) c[i][e] = 0.f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < ILP; ++i) {
      if (KIND == 0) mma_tf32(c[i], a, seed + i, seed + 2 * i);
      else mma_bf16(c[i], a, seed + i, seed + 2 * i);
    }
  }
  float s = 0;
  for (int i = 0; i < ILP; ++i)
    for (int e = 0; e < 4; ++e) s += c[i][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int ILP, int KIND>
void run(int sms, int warps, float* out) {
  const int iters = 20000;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  chain<ILP, KIND><<<sms, warps * 32>>>(out, 100, 0);
  cudaEventRecord(e0);
  chain<ILP, KIND><<<sms, warps * 32>>>(out, iters, 0);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  const double mmas = (double)iters * ILP * warps;  // per SM
  const double flop = mmas * sms * (KIND == 0 ? 2048.0 : 4096.0);
  printf("%s ILP %d warps %d: %.3f ms, %.1f TFLOP/s, %.3f mma per ns per SM\n",
         KIND == 0 ? "tf32 m16n8k8" : "bf16 m16n8k16", ILP, warps, ms, flop / ms / 1e9,
         mmas / (ms * 1e6));
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  cudaMalloc(&out, (size_t)sms * 1024 * sizeof(float));
  for (int w : {4, 8, 12, 16}) {
    run<4, 0>(sms, w, out);
    run<16, 0>(sms, w, out);
  }
  for (int w : {4, 8, 16}) run<16, 1>(sms, w, out);
  const cudaError_t e = cudaDeviceSynchronize();
  printf("%s\n", cudaGetErrorString(e));
  return e == cudaSuccess ? 0 : 1;
}
