// Hopper warpgroup matrix multiply (wgmma) from shared memory, the subset the
// weight-grad pass (weight_grad.cu) uses: bf16 operands, fp32 accumulators,
// m64n64k16, no swizzle. Built for sm_90a only (wgmma does not exist on
// plain sm_90).
//
// Operand layout. Without swizzle a wgmma operand is a grid of "core
// matrices", each 8 rows of 16 contiguous bytes (128 bytes in all). Both
// operands here are MN-major (the [pixels, channels] products read A and B
// with the channels contiguous), so a core matrix holds 8 k-rows of 8
// consecutive m (or n) values, and the descriptor gives the byte distance
// between core matrices adjacent along K (leading, LBO) and along M or N
// (stride, SBO). The instruction's transpose flags say MN-major.
#ifndef BLLE_WGMMA_CUH
#define BLLE_WGMMA_CUH

#include <cstdint>

namespace {

// Shared-memory matrix descriptor: start address, LBO and SBO (bytes, 16-byte
// units in the descriptor), no swizzle (layout type 0), base offset 0.
__device__ __forceinline__ uint64_t wgmma_desc(const void* smem, int lbo, int sbo) {
  const uint64_t a = static_cast<uint64_t>(__cvta_generic_to_shared(smem));
  return ((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64] for one warpgroup; A and B
// in shared memory, MN-major with transpose flags TA = TB = 1 (0: K-major).
// scale_d 0 overwrites d.
// Thread t of the warpgroup holds d[4j..4j+3] = D[r][c], D[r][c+1],
// D[r+8][c], D[r+8][c+1] with r = 16 (t / 32) + (t % 32) / 4 and
// c = 8 j + 2 (t % 4).
template <int TA = 1, int TB = 1>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// Order this thread's generic-proxy shared-memory writes (st.shared,
// cp.async) before later async-proxy reads (wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait for every committed wgmma group; the empty asm on each accumulator
// keeps the compiler from reading d before the wait.
__device__ __forceinline__ void wgmma_wait_all(float (&d)[32]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

}  // namespace

#endif  // BLLE_WGMMA_CUH
