// K3P: the pipelined apply + FFN pass (apply_pipelined.cuh), the port of the
// TPU kernel `_apply_ffn_kernel_v6`. Same arguments and result as K3's
// `blle_apply_pass` (fused_block.cu).
#include "apply_pipelined.cuh"

// x [B,H,W,C] bf16, apply [B,C,C] bf16 -> out [B,H,W,C] bf16; C in
// {32, 64, 128, 256}, anything else is refused (cudaErrorInvalidValue).
extern "C" int blle_apply_pipelined(const void* x, const void* apply, const void* wv,
                                    const void* bv, const void* dwv, const void* bdwv,
                                    const void* bproj, const void* wp1, const void* bp1,
                                    const void* dwf, const void* bdwf, const void* wp2,
                                    const void* bp2, void* out, int B, int H, int W, int C,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const void* p[13] = {x, apply, wv, bv, dwv, bdwv, bproj, wp1, bp1, dwf, bdwf, wp2, bp2};
  switch (C) {
    case 32: return (int)apply_pipelined<32, 5>(p, out, B, H, W, s);
    case 64: return (int)apply_pipelined<64, 5>(p, out, B, H, W, s);
    case 128: return (int)apply_pipelined<128, 5>(p, out, B, H, W, s);
    case 256: return (int)apply_pipelined<256, 5>(p, out, B, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
