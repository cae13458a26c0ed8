// K3P: the pipelined apply + FFN pass (apply_pipelined.cuh), the port of the
// TPU kernel `_apply_ffn_kernel_v6`. Same arguments and result as K3's
// `blle_apply_pass` (fused_block.cu).
#include "apply_pipelined.cuh"

// x [B,H,W,C] bf16, apply [B,C,C] bf16 -> out [B,H,W,C] bf16 on `grid`
// persistent CTAs (kernels/fused_block.py `block_plan`; <= 0: as many as are
// resident, at most one per tile); C in {32, 64, 128, 256}, anything else is
// refused (cudaErrorInvalidValue).
extern "C" int blle_apply_pipelined(const void* x, const void* apply, const void* wv,
                                    const void* bv, const void* dwv, const void* bdwv,
                                    const void* bproj, const void* wp1, const void* bp1,
                                    const void* dwf, const void* bdwf, const void* wp2,
                                    const void* bp2, void* out, int B, int H, int W, int C,
                                    int grid, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const void* p[13] = {x, apply, wv, bv, dwv, bdwv, bproj, wp1, bp1, dwf, bdwf, wp2, bp2};
  switch (C) {
    case 32: return (int)apply_pipelined<32, 5>(p, out, B, H, W, s, grid);
    case 64: return (int)apply_pipelined<64, 5>(p, out, B, H, W, s, grid);
    case 128: return (int)apply_pipelined<128, 5>(p, out, B, H, W, s, grid);
    case 256: return (int)apply_pipelined<256, 5>(p, out, B, H, W, s, grid);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K3P's plan at width C (pipe_kernel_info): info[0..4] = TH, TW, threads,
// shared-memory bytes, blocks per SM; blle_block_kernel_info's kind 4.
extern "C" int blle_apply_pipelined_info(int C, long long* info) {
  switch (C) {
    case 32: return (int)pipe_kernel_info<32>(info);
    case 64: return (int)pipe_kernel_info<64>(info);
    case 128: return (int)pipe_kernel_info<128>(info);
    case 256: return (int)pipe_kernel_info<256>(info);
    default: return (int)cudaErrorInvalidValue;
  }
}
