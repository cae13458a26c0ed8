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
//      fused_block.py, both reached from `fused_transformer_block`): per
//      8x8 pixel tile, LN1 without affine -> [q|k] 1x1 -> dw3x3 -> the
//      tile's partial gram and sums of squares. The TPU carried the sum in
//      its output block across a sequential grid; blocks here run in
//      parallel in no order, so each tile writes its partial and a second
//      kernel sums them (in fixed order: the result is deterministic).
//   K3 (pass B) replaces `_apply_ffn_kernel` / `_apply_ffn_chain`: per tile
//      with a 2-pixel halo, LN1 -> v (1x1, dw3x3) -> y = x + v @ apply +
//      b_proj -> LN2 -> 1x1 to 2C -> dw3x3 -> exact GELU -> 1x1 -> + y.
//
// The LN affines are folded into the following 1x1 weights host-side, as on
// the TPU. The 1x1 convs, the attention apply and the gram run on the tensor
// cores (WMMA 16x16x16, bf16 in, fp32 accumulate); LayerNorm statistics,
// depthwise convs and GELU run in fp32 on the CUDA cores.
//
// Bound: the unfused block is bound by HBM traffic (every qkv / FFN
// intermediate goes through device memory). Here x is read twice (once per
// pass, plus halo re-reads that hit L2) and the output written once; every
// intermediate stays in shared memory, so HBM is no longer the limit. What
// bounds this first version is the per-tile chain of dependent phases, each
// ending at a block barrier, with one thread per pixel in the LayerNorms and
// one tile per block (few warps in flight at the widest levels), plus the
// halo recompute ((TH+4)(TW+4)/(TH*TW) of the v 1x1). The 8x8 tiles (4x8 in
// pass B for C > 64) are what fits the widest level's buffers in the 227 KB
// of shared memory. Zero padding is applied to each 1x1 OUTPUT before its
// depthwise conv (a 1x1 of zero-padded x would give the bias there), and y is
// zero outside the image before LN2.
//
// Supported widths: C in {32, 48, 64, 96, 128, 192, 256} (every RawFormer
// level with C <= 256), FFN hidden width 2C. The kernel templates live in
// block_tiles.cuh, which A1 (fused_attention.cu) and the bisect ladder
// (probes_bisect.cu) instantiate too.
#include "block_tiles.cuh"

// Floats of device workspace `blle_gram_pass` needs: the per-tile partials
// plus one level of the reduction.
extern "C" long long blle_gram_workspace_floats(int B, int H, int W, int C) {
  return gram_workspace_floats(B, H, W, C);
}

// x [B,H,W,C] bf16 -> out [B, C*C + 2C] fp32: per image the gram q^T k
// (row-major [C,C]) then sum q^2 [C] then sum k^2 [C].
extern "C" int blle_gram_pass(const void* x, const void* wqk, const void* bqk,
                              const void* dwqk, const void* bdwqk, void* workspace,
                              void* out, int B, int H, int W, int C, void* stream) {
  return (int)gram_pass<true>(x, wqk, bqk, dwqk, bdwqk, workspace, out, B, H, W, C,
                              (cudaStream_t)stream);
}

// x [B,H,W,C] bf16, apply [B,C,C] bf16 -> out [B,H,W,C] bf16.
extern "C" int blle_apply_pass(const void* x, const void* apply, const void* wv,
                               const void* bv, const void* dwv, const void* bdwv,
                               const void* bproj, const void* wp1, const void* bp1,
                               const void* dwf, const void* bdwf, const void* wp2,
                               const void* bp2, void* out, int B, int H, int W, int C,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const void* p[13] = {x, apply, wv, bv, dwv, bdwv, bproj, wp1, bp1, dwf, bdwf, wp2, bp2};
  switch (C) {
    case 32: return (int)apply_tiles<32, 5>(p, out, B, H, W, s);
    case 48: return (int)apply_tiles<48, 5>(p, out, B, H, W, s);
    case 64: return (int)apply_tiles<64, 5>(p, out, B, H, W, s);
    case 96: return (int)apply_tiles<96, 5>(p, out, B, H, W, s);
    case 128: return (int)apply_tiles<128, 5>(p, out, B, H, W, s);
    case 192: return (int)apply_tiles<192, 5>(p, out, B, H, W, s);
    case 256: return (int)apply_tiles<256, 5>(p, out, B, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
