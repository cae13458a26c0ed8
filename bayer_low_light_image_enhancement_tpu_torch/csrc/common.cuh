// Shared helpers for the port's CUDA kernels (built for sm_90a by
// kernels/_build.py into one shared library with a plain C interface).
#ifndef BLLE_COMMON_CUH
#define BLLE_COMMON_CUH

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16(v); }
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// The block's dynamic shared memory, 128-byte aligned.
__device__ __forceinline__ unsigned char* dyn_smem() {
  extern __shared__ __align__(128) unsigned char blle_smem[];
  return blle_smem;
}

// Launch on `stream` and return the launch's error (a refused launch, e.g.
// too much shared memory, never runs and a later synchronise does not
// report it). Kernels above 48 KB of dynamic shared memory must opt in.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, dim3 block, size_t smem,
                   cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, block, smem, stream>>>(args...);
  return cudaGetLastError();
}

#endif  // BLLE_COMMON_CUH
