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

// Tile helpers shared by the fused-block kernels (fused_block.cu,
// fused_block_bwd.cu): 256-thread blocks, NHWC bf16 activations, WMMA
// 16x16x16 bf16 products with fp32 accumulation.
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ constexpr int align128(int n) { return (n + 127) / 128 * 128; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ bool inside(int r, int c, int H, int W) {
  return r >= 0 && r < H && c >= 0 && c < W;
}

// Load the window rows [r0, r0+WR) x cols [c0, c0+WC) of one NHWC image
// into dst[p][0:C] (bf16, row stride ld), zeros outside the image and in the
// padding rows [WR*WC, rows). 16-byte units; C % 8 == 0.
template <int C>
__device__ void load_window(bf16* dst, int ld, int rows, const bf16* __restrict__ img,
                            int H, int W, int r0, int c0, int WR, int WC) {
  constexpr int U = C / 8;
  for (int e = threadIdx.x; e < rows * U; e += kThreads) {
    const int p = e / U, part = e % U;
    const int gr = r0 + p / WC, gc = c0 + p % WC;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (p < WR * WC && gr >= 0 && gr < H && gc >= 0 && gc < W)
      val = *reinterpret_cast<const uint4*>(img + ((size_t)gr * W + gc) * C + part * 8);
    *reinterpret_cast<uint4*>(dst + p * ld + part * 8) = val;
  }
}

// LayerNorm without affine (biased variance, eps 1e-5, fp32 statistics) of
// n rows of C values, one thread per row; src and dst may alias. A zero row
// stays zero. With `rstd`, row p's 1/sigma goes to rstd[p].
template <int C, typename SrcT>
__device__ void layernorm_rows(const SrcT* src, int lds, bf16* dst, int ldd, int n,
                               float* rstd = nullptr) {
  for (int p = threadIdx.x; p < n; p += kThreads) {
    const SrcT* s = src + p * lds;
    float mu = 0.f;
    for (int c = 0; c < C; ++c) mu += to_f(s[c]);
    mu *= 1.0f / C;
    float var = 0.f;
    for (int c = 0; c < C; ++c) {
      const float d = to_f(s[c]) - mu;
      var += d * d;
    }
    const float inv = rsqrtf(var * (1.0f / C) + 1e-5f);
    if (rstd) rstd[p] = inv;
    bf16* d = dst + p * ldd;
    for (int c = 0; c < C; ++c) d[c] = f2bf((to_f(s[c]) - mu) * inv);
  }
}

// out[M][N] (fp32, shared, stride ldo) = a[M][K] (bf16, shared, stride lda)
// @ b[K][N] (bf16, global, row-major, stride ldb), 16x16 output tiles dealt
// round-robin to the warps.
template <int M, int N, int K>
__device__ void gemm_bf16(const bf16* a, int lda, const bf16* __restrict__ b, int ldb,
                          float* out, int ldo) {
  using namespace nvcuda;
  constexpr int NT = N / 16;
  const int warp = threadIdx.x / 32;
  for (int t = warp; t < (M / 16) * NT; t += kWarps) {
    const int mi = t / NT, ni = t % NT;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, a + mi * 16 * lda + k, lda);
      wmma::load_matrix_sync(fb, b + (size_t)k * ldb + ni * 16, ldb);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out + mi * 16 * ldo + ni * 16, acc, ldo, wmma::mem_row_major);
  }
}

}  // namespace

#endif  // BLLE_COMMON_CUH
