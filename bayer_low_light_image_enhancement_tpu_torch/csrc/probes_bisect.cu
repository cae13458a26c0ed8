// P, the bisect ladder: the production apply-pass templates K3
// (apply1_kernel / apply2_kernel, block_tiles.cuh) and K3P
// (apply_pipelined_kernel, apply_pipelined.cuh) cut after stage 1-4 by their
// compile-time STAGE.
// Port of the TPU probe `benchmarks/bisect_b5.py`, which rebuilt the v5/v6
// apply body stage by stage; here the ladder cuts the real kernels, and its
// stage 5 is the production kernel itself (`blle_apply_pass`,
// `blle_apply_pipelined`), so the differences between rungs time each
// stage of the kernel the model launches:
//   1 window + LN1 + v 1x1, 2 + dw3x3 + apply + b_proj, 3 + first residual,
//   4 + LN2 + FFN expand, (5 + FFN dw3x3 + GELU + project + second residual).
// K3 runs as two kernels split at y: its stages 1-3 are cuts of the first
// (stage 3 is that kernel whole), stage 4 is the first kernel plus the
// second cut after the expand.
// Widths: the RawFormer-S levels C in {32, 64, 128, 256}.
#include "apply_pipelined.cuh"
#include "block_tiles.cuh"

namespace {

template <int C>
cudaError_t cut(const void* const* p, void* out, void* ybuf, int B, int H, int W, int stage,
                bool pipelined, cudaStream_t s) {
  switch (stage * 2 + (pipelined ? 1 : 0)) {
    case 2: return apply_tiles<C, 1>(p, out, ybuf, B, H, W, s);
    case 3: return apply_pipelined<C, 1>(p, out, B, H, W, s);
    case 4: return apply_tiles<C, 2>(p, out, ybuf, B, H, W, s);
    case 5: return apply_pipelined<C, 2>(p, out, B, H, W, s);
    case 6: return apply_tiles<C, 3>(p, out, ybuf, B, H, W, s);
    case 7: return apply_pipelined<C, 3>(p, out, B, H, W, s);
    case 8: return apply_tiles<C, 4>(p, out, ybuf, B, H, W, s);
    case 9: return apply_pipelined<C, 4>(p, out, B, H, W, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The arguments of `blle_apply_pass` (ybuf: y between K3's kernels at stage
// 4), then stage (1-4) and pipelined (0: K3, 1: K3P) -> out [B,H,W,C] bf16,
// the stage's tensor at every pixel.
extern "C" int blle_probe_apply_cut(const void* x, const void* apply, const void* wv,
                                    const void* bv, const void* dwv, const void* bdwv,
                                    const void* bproj, const void* wp1, const void* bp1,
                                    const void* dwf, const void* bdwf, const void* wp2,
                                    const void* bp2, void* ybuf, void* out, int B, int H, int W,
                                    int C, int stage, int pipelined, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const void* p[13] = {x, apply, wv, bv, dwv, bdwv, bproj, wp1, bp1, dwf, bdwf, wp2, bp2};
  switch (C) {
    case 32: return (int)cut<32>(p, out, ybuf, B, H, W, stage, pipelined != 0, s);
    case 64: return (int)cut<64>(p, out, ybuf, B, H, W, stage, pipelined != 0, s);
    case 128: return (int)cut<128>(p, out, ybuf, B, H, W, stage, pipelined != 0, s);
    case 256: return (int)cut<256>(p, out, ybuf, B, H, W, stage, pipelined != 0, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
