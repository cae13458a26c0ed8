// K2 and K3 in band mode: the fused TransformerBlock forward of one frame
// cut into H-bands riding the batch axis (models/fused_apply.py
// `make_banded_forward`, kernels/fused_block.py's band mode).
//
// Replaces the band mode of the TPU kernels `_gram_kernel_merged` and
// `_apply_ffn_kernel` (bayer_low_light_image_enhancement_tpu/kernels/
// fused_block.py, reached from `fused_transformer_block(bands=, frame_h=)`):
// their windows take halo rows from the neighbour bands, their 1x1 outputs
// that feed a dw3x3 are masked by the frame's bounds rather than the band's
// (`_real_mask` with `row_seg` / `h_tot`), and the gram counts each frame
// pixel once (`_own_mask`), so that a frame's band partials sum to its gram.
//
// Interface (the TPU kernels' too): x is each band with 2 halo rows a side
// already filled from its neighbour bands (zeros past the frame's edges),
// [B, H + 4, W, C]; image b is band b % bands of its frame, whose rows
// [0, frame_h) are real. The same kernels as fused_block.cu (block_tiles.cuh,
// RowMap<true>): K2 writes each band's partial gram and sums of squares,
// which the caller sums per frame before the finalise; K3's first kernel
// writes y on the band's rows -1 .. H into ybuf [B, H + 2, W, C], so that
// its second kernel reads y's 1-row halo from its own input as it does on a
// whole image. A tiled rank whose neighbours send it these halo rows
// presents the same interface.
#include "block_tiles.cuh"

// xh [B, H+4, W, C] bf16 -> out [B, C*C + 2C] fp32: each band's partial
// gram q^T k over its own rows inside the frame, then its sums of q^2 and of
// k^2; ncta CTAs per (band, channel block), the workspace as
// blle_gram_workspace_floats(B, H, W, C) gives for them.
extern "C" int blle_gram_pass_banded(const void* x, const void* wqk, const void* bqk,
                                     const void* dwqk, const void* bdwqk, void* workspace,
                                     void* out, int B, int H, int W, int C, int ncta, int bands,
                                     int frame_h, void* stream) {
  if (bands < 1 || B % bands || frame_h < 1 || frame_h > bands * H)
    return (int)cudaErrorInvalidValue;
  return (int)gram_pass<true, true>(x, wqk, bqk, dwqk, bdwqk, workspace, out, B, H, W, C, ncta,
                                    (cudaStream_t)stream, band_gram_map(H, bands, frame_h));
}

// xh [B, H+4, W, C] bf16, apply [B, C, C] bf16 (each band its frame's) ->
// out [B, H, W, C] bf16; ybuf [B, H+2, W, C] bf16 holds y between the two
// kernels, which run on grid1 and grid2 CTAs (the plans of H + 2 and H rows).
extern "C" int blle_apply_pass_banded(const void* x, const void* apply, const void* wv,
                                      const void* bv, const void* dwv, const void* bdwv,
                                      const void* bproj, const void* wp1, const void* bp1,
                                      const void* dwf, const void* bdwf, const void* wp2,
                                      const void* bp2, void* ybuf, void* out, int B, int H,
                                      int W, int C, int grid1, int grid2, int bands, int frame_h,
                                      void* stream) {
  if (bands < 1 || B % bands || frame_h < 1 || frame_h > bands * H)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const void* p[13] = {x, apply, wv, bv, dwv, bdwv, bproj, wp1, bp1, dwf, bdwf, wp2, bp2};
  switch (C) {
#define BLLE_RUN(c)                                                                       \
  case c:                                                                                 \
    return (int)apply_tiles<c, 5, true, true>(p, out, ybuf, B, H, W, s, grid1, grid2, bands, \
                                              frame_h);
    BLLE_WIDTHS(BLLE_RUN)
#undef BLLE_RUN
    default: return (int)cudaErrorInvalidValue;
  }
}
