// K2 and K3: the fused RawFormer TransformerBlock forward (inference).
//
//   y   = x + proj(channel_attention(dw3x3(qkv1x1(LN1(x)))))
//   out = y + pointwise2(GELU(dw3x3(pointwise1(LN2(y)))))
//
// The channel attention needs, per image, the [C, C] gram q^T k and the
// squared norms of q and k summed over EVERY pixel before any output pixel
// can be formed, so the block runs as two passes over x with a tiny [C, C]
// step between them (kernels/fused_block.py: `finalize_attention`, plain
// torch) that folds normalisation, temperature, per-head softmax and the
// output projection into one per-image matrix `apply`:
//
//   K2 (pass A) replaces the TPU kernels `_gram_kernel_merged` and
//      `_gram_kernel` (bayer_low_light_image_enhancement_tpu/kernels/
//      fused_block.py, both reached from `fused_transformer_block`): LN1
//      without affine -> [q|k] 1x1 -> dw3x3 -> per image the gram and the
//      sums of squares. The TPU carried the sum in its output block across a
//      sequential grid; here each persistent CTA carries its share in
//      registers over every tile it walks and writes one partial, and a
//      second kernel sums the partials in a fixed order (deterministic).
//   K3 (pass B) replaces `_apply_ffn_kernel` / `_apply_ffn_chain`: LN1 -> v
//      (1x1, dw3x3) -> y = x + v @ apply + b_proj -> LN2 -> 1x1 to 2C ->
//      dw3x3 -> exact GELU -> 1x1 -> + y, as two kernels in one call with a
//      1-pixel halo each (y, bf16, passes between them through L2).
//
// The LN affines are folded into the following 1x1 weights host-side, as on
// the TPU. bf16 in, fp32 accumulate; LayerNorm statistics, depthwise convs
// and GELU in fp32. Zero padding is applied to each 1x1 OUTPUT before its
// depthwise conv (a 1x1 of zero-padded x would give the bias there), and y
// is zero outside the image before LN2.
//
// Bound on the H100: the function itself moves x twice and writes one
// output (0.006-0.16 ms at the RawFormer-S shapes), and its products are a
// few GFLOP for the tensor cores. The first port (one tile per block, ~14
// barrier phases a tile, WMMA B fragments loaded from device memory in the
// innermost loop, one thread per LayerNorm row, 2-pixel halo, a partial
// gram per tile in device memory) ran at 27-79x that bound. The design
// (block_tiles.cuh) answers each of those: persistent occupancy-sized grids
// walking tiles in strip order with the next window prefetched by cp.async;
// weights in shared memory (resident at C <= 64, streamed in 64-channel
// chunks through a cp.async ring above); every product on mma.sync from
// shared memory; LayerNorm by lane quads; bias, mask, dw3x3, GELU as
// epilogues; K3 split at y so each half needs a 1-pixel halo (LN1 and the v
// 1x1 on (TH+2)(TW+2) instead of (TH+4)(TW+4) pixels); K2 with one partial
// per CTA and, from C = 192, its gram split into 2 x 2 channel blocks so that
// the deep levels spread over more CTAs.
//
// Supported widths: C in {32, 48, 64, 96, 128, 192, 256} (every RawFormer
// level with C <= 256), FFN hidden width 2C. The kernel templates live in
// block_tiles.cuh, which A1 (fused_attention.cu) and the bisect ladder
// (probes_bisect.cu) instantiate too.
#include "block_tiles.cuh"

// Floats of device workspace `blle_gram_pass` needs: the per-CTA partials.
extern "C" long long blle_gram_workspace_floats(int B, int H, int W, int C) {
  return gram_workspace_floats<true>(B, H, W, C);
}

extern "C" int blle_apply_pipelined_info(int C, long long* info);  // fused_block_pipelined.cu
extern "C" int blle_attn_apply_info(int C, long long* info);       // fused_attention.cu

// The plan of block kernel `kind` at width C (block_kernel_info,
// block_tiles.cuh; kind 4: K3P, apply_pipelined.cuh; kind 5: A1's apply pass,
// K3's phase 1 without LN1, fused_attention.cu) -> info[0..4] = TH, TW,
// threads, shared-memory bytes, blocks per SM.
extern "C" int blle_block_kernel_info(int kind, int C, long long* info) {
  if (kind == 4) return blle_apply_pipelined_info(C, info);
  if (kind == 5) return blle_attn_apply_info(C, info);
  switch (C) {
#define BLLE_INFO(c) case c: return (int)block_kernel_info<c>(kind, info);
    BLLE_WIDTHS(BLLE_INFO)
#undef BLLE_INFO
    default: return (int)cudaErrorInvalidValue;
  }
}

// x [B,H,W,C] bf16 -> out [B, C*C + 2C] fp32: per image the gram q^T k
// (row-major [C,C]) then sum q^2 [C] then sum k^2 [C]; on ncta CTAs per
// (image, channel block) (kernels/fused_block.py `block_plan`; <= 0: the
// library's own, which blle_gram_workspace_floats sizes).
extern "C" int blle_gram_pass(const void* x, const void* wqk, const void* bqk,
                              const void* dwqk, const void* bdwqk, void* workspace,
                              void* out, int B, int H, int W, int C, int ncta, void* stream) {
  return (int)gram_pass<true>(x, wqk, bqk, dwqk, bdwqk, workspace, out, B, H, W, C, ncta,
                              (cudaStream_t)stream);
}

// x [B,H,W,C] bf16, apply [B,C,C] bf16 -> out [B,H,W,C] bf16; ybuf
// [B,H,W,C] bf16 holds y between the two kernels, which run on grid1 and
// grid2 CTAs (kernels/fused_block.py `block_plan`; <= 0: as many as are
// resident, at most one per tile).
extern "C" int blle_apply_pass(const void* x, const void* apply, const void* wv,
                               const void* bv, const void* dwv, const void* bdwv,
                               const void* bproj, const void* wp1, const void* bp1,
                               const void* dwf, const void* bdwf, const void* wp2,
                               const void* bp2, void* ybuf, void* out, int B, int H, int W,
                               int C, int grid1, int grid2, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const void* p[13] = {x, apply, wv, bv, dwv, bdwv, bproj, wp1, bp1, dwf, bdwf, wp2, bp2};
  switch (C) {
#define BLLE_RUN(c) case c: return (int)apply_tiles<c, 5>(p, out, ybuf, B, H, W, s, grid1, grid2);
    BLLE_WIDTHS(BLLE_RUN)
#undef BLLE_RUN
    default: return (int)cudaErrorInvalidValue;
  }
}
