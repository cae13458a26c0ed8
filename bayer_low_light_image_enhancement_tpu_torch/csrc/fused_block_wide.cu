// K2 and K3 at the wide widths, C = 384 and 512: the bottleneck blocks of
// RawFormer-B (dim 48) and RawFormer-L (dim 64), which band mode runs on the
// card's kernels as the JAX package's band mode runs every TransformerBlock
// on its Pallas kernels (bayer_low_light_image_enhancement_tpu/models/
// fused_apply.py, "force-fuses EVERY TransformerBlock"). Replaces
// `_gram_kernel_merged` and `_apply_ffn_kernel` / `_apply_ffn_chain`
// (bayer_low_light_image_enhancement_tpu/kernels/fused_block.py) at those
// widths, plain and in band mode.
//
// The same templates as fused_block.cu and fused_block_banded.cu
// (block_tiles.cuh), with the staging that fits a block's 227 KB at these
// widths (GramCfg, Apply1Cfg, Apply2Cfg): 32-channel weight chunks, the gram
// in 2 x 2 blocks of 192 channels at C = 384 and 4 x 4 of 128 at 512, tiles
// of 2-6 rows, mostly one window buffer. K2 computes the whole [C, C] gram
// (the finalise reads only its 8 head-diagonal blocks, but the operators'
// [B, C*C + 2C] layout holds every entry, as at the other widths).
// Instantiated here, in a source of their own, so that their build runs
// beside the others'; the entry points of fused_block.cu /
// fused_block_banded.cu call these functions. A1, K3P and the bisect ladder
// have no wide width.
//
// Bound on the H100: at RawFormer-L's banded bottleneck, [8, 23, 272, 512],
// the products (3 C^2 MACs a pixel in K2, 6 C^2 in K3) take the tensor
// cores about five times as long as x takes to move: both passes are bound
// by operations, as at C = 256.
#include "block_tiles.cuh"

cudaError_t wide_gram_pass(const void* x, const void* wqk, const void* bqk, const void* dwqk,
                           const void* bdwqk, void* workspace, void* out, int B, int H, int W,
                           int C, int ncta, cudaStream_t s, int bands, int frame_h) {
  float *ws = (float*)workspace, *o = (float*)out;
  switch (C) {
#define BLLE_RUN(c)                                                                          \
  case c:                                                                                    \
    if (bands > 0)                                                                           \
      return gram_run<c, true, true>(x, wqk, bqk, dwqk, bdwqk, ws, o, B, H, W, ncta, s,      \
                                     band_gram_map(H, bands, frame_h));                      \
    return gram_run<c, true>(x, wqk, bqk, dwqk, bdwqk, ws, o, B, H, W, ncta, s);
    BLLE_WIDE_WIDTHS(BLLE_RUN)
#undef BLLE_RUN
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t wide_apply_pass(const void* const* p, void* out, void* ybuf, int B, int H, int W,
                            int C, cudaStream_t s, int grid1, int grid2, int bands, int frame_h) {
  switch (C) {
#define BLLE_RUN(c)                                                                          \
  case c:                                                                                    \
    if (bands > 0)                                                                           \
      return apply_tiles<c, 5, true, true>(p, out, ybuf, B, H, W, s, grid1, grid2, bands,    \
                                           frame_h);                                         \
    return apply_tiles<c, 5>(p, out, ybuf, B, H, W, s, grid1, grid2);
    BLLE_WIDE_WIDTHS(BLLE_RUN)
#undef BLLE_RUN
    default: return cudaErrorInvalidValue;
  }
}

long long wide_gram_workspace_floats(int B, int H, int W, int C) {
  switch (C) {
#define BLLE_WS(c) \
  case c: return (long long)B * GramCfg<c>::NBLK * gram_ctas<c, true>(B, H, W) * GramCfg<c>::E;
    BLLE_WIDE_WIDTHS(BLLE_WS)
#undef BLLE_WS
    default: return -1;
  }
}

cudaError_t wide_block_kernel_info(int kind, int C, long long* info) {
  switch (C) {
#define BLLE_INFO(c) case c: return block_kernel_info<c>(kind, info);
    BLLE_WIDE_WIDTHS(BLLE_INFO)
#undef BLLE_INFO
    default: return cudaErrorInvalidValue;
  }
}
