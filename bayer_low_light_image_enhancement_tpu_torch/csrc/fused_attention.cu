// A1: the standalone channel attention (ChannelAttention's forward, without
// LayerNorm or residual), the port of the retired TPU kernel
// `fused_channel_attention` (attic/fused_attention.py):
//
//   q, k, v = dw3x3(conv1x1(x))   (the 1x1 output zero-padded for the dw)
//   out     = proj(softmax_head(norm(q)^T norm(k) * T) applied to v)
//
// Two passes over x, like K2/K3: the gram pass is K2's tile code with the
// LayerNorm taken out (gram_tile_kernel<C, false>, block_tiles.cuh), then the
// same fixed-order reduction; the [C, C] finalise stays plain torch
// (kernels/fused_block.py: finalize_attention) and folds normalisation,
// temperature, softmax and the projection into `apply`; the apply pass
// below recomputes v per tile (1x1 + dw3x3, 1-pixel halo) and writes
// v @ apply + b_proj. x is read twice and the output written once; q, k and
// v never leave shared memory.
//
// Bound: like K2/K3, the per-tile chain of dependent phases, not the bytes.
// Widths: C in {32, 48, 64, 96, 128, 192, 256}.
#include "block_tiles.cuh"

namespace {

// Apply pass: tiles with a 1-pixel halo (v's dw3x3).
template <int C>
struct AttnCfg {
  static constexpr int TH = C > 64 ? 4 : 8, TW = 8;
  static constexpr int KCH = C % 32 == 0 ? 32 : 16;
  static constexpr int WR = TH + 2, WC = TW + 2;
  static constexpr int NWIN = WR * WC, NWIN_P = round16(NWIN);
  static constexpr int NPIX = TH * TW;
  static constexpr int LDB = C + 8, LDK = KCH + 4;
  static constexpr int OFF_Z = align128(NWIN_P * LDB * 2);
  static constexpr int OFF_V = OFF_Z + align128(NWIN_P * LDK * 4);
  static constexpr int SMEM = OFF_V + align128(NPIX * LDB * 2);
};

template <int C>
__global__ void __launch_bounds__(kThreads) attn_apply_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ apply,
    const bf16* __restrict__ wv, const float* __restrict__ bv,
    const float* __restrict__ dwv, const float* __restrict__ bdwv,
    const float* __restrict__ bproj, bf16* __restrict__ out, int H, int W, int tiles_w) {
  using A = AttnCfg<C>;
  bf16* xs = reinterpret_cast<bf16*>(dyn_smem());
  float* zs = reinterpret_cast<float*>(dyn_smem() + A::OFF_Z);
  bf16* v = reinterpret_cast<bf16*>(dyn_smem() + A::OFF_V);
  const int tile = blockIdx.x, b = blockIdx.y;
  const int r0 = (tile / tiles_w) * A::TH, c0 = (tile % tiles_w) * A::TW;

  load_window<C>(xs, A::LDB, A::NWIN_P, x + (size_t)b * H * W * C, H, W, r0 - 1, c0 - 1,
                 A::WR, A::WC);
  __syncthreads();
  // v = dw3x3(mask(x @ wv + bv)) + bdwv at own pixels, chunk by chunk.
  for (int n0 = 0; n0 < C; n0 += A::KCH) {
    gemm_bf16<A::NWIN_P, A::KCH, C>(xs, A::LDB, wv + n0, C, zs, A::LDK);
    __syncthreads();
    for (int e = threadIdx.x; e < A::NWIN * A::KCH; e += kThreads) {
      const int p = e / A::KCH, n = e % A::KCH;
      const bool in = inside(r0 - 1 + p / A::WC, c0 - 1 + p % A::WC, H, W);
      zs[p * A::LDK + n] = in ? zs[p * A::LDK + n] + bv[n0 + n] : 0.0f;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < A::NPIX * A::KCH; e += kThreads) {
      const int p = e / A::KCH, n = e % A::KCH;
      const int i = p / A::TW, j = p % A::TW;
      float acc = bdwv[n0 + n];
      for (int di = 0; di < 3; ++di)
        for (int dj = 0; dj < 3; ++dj)
          acc += zs[((i + di) * A::WC + j + dj) * A::LDK + n] * dwv[(di * 3 + dj) * C + n0 + n];
      v[p * A::LDB + n0 + n] = f2bf(acc);
    }
    __syncthreads();
  }
  // out = v @ apply + b_proj at own pixels inside the image.
  for (int n0 = 0; n0 < C; n0 += A::KCH) {
    gemm_bf16<A::NPIX, A::KCH, C>(v, A::LDB, apply + (size_t)b * C * C + n0, C, zs, A::LDK);
    __syncthreads();
    for (int e = threadIdx.x; e < A::NPIX * A::KCH; e += kThreads) {
      const int p = e / A::KCH, n = e % A::KCH;
      const int i = p / A::TW, j = p % A::TW;
      if (inside(r0 + i, c0 + j, H, W))
        out[(((size_t)b * H + r0 + i) * W + c0 + j) * C + n0 + n] =
            f2bf(zs[p * A::LDK + n] + bproj[n0 + n]);
    }
    __syncthreads();
  }
}

template <int C>
cudaError_t attn_apply_tiles(const void* const* p, void* out, int B, int H, int W,
                             cudaStream_t s) {
  using A = AttnCfg<C>;
  const int tw = cdiv(W, A::TW), tiles = cdiv(H, A::TH) * tw;
  return launch(attn_apply_kernel<C>, dim3(tiles, B), dim3(kThreads), A::SMEM, s,
                (const bf16*)p[0], (const bf16*)p[1], (const bf16*)p[2], (const float*)p[3],
                (const float*)p[4], (const float*)p[5], (const float*)p[6], (bf16*)out, H, W,
                tw);
}

}  // namespace

extern "C" long long blle_attn_gram_workspace_floats(int B, int H, int W, int C) {
  return gram_workspace_floats(B, H, W, C);
}

// x [B,H,W,C] bf16 -> out [B, C*C + 2C] fp32 (gram q^T k, sum q^2, sum k^2)
// with q, k = dw3x3(x @ wqk + bqk), no LayerNorm.
extern "C" int blle_attn_gram(const void* x, const void* wqk, const void* bqk,
                              const void* dwqk, const void* bdwqk, void* workspace, void* out,
                              int B, int H, int W, int C, void* stream) {
  return (int)gram_pass<false>(x, wqk, bqk, dwqk, bdwqk, workspace, out, B, H, W, C,
                               (cudaStream_t)stream);
}

// x [B,H,W,C] bf16, apply [B,C,C] bf16 -> out = dw3x3(x @ wv + bv) @ apply +
// bproj, [B,H,W,C] bf16.
extern "C" int blle_attn_apply(const void* x, const void* apply, const void* wv,
                               const void* bv, const void* dwv, const void* bdwv,
                               const void* bproj, void* out, int B, int H, int W, int C,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const void* p[7] = {x, apply, wv, bv, dwv, bdwv, bproj};
  switch (C) {
    case 32: return (int)attn_apply_tiles<32>(p, out, B, H, W, s);
    case 48: return (int)attn_apply_tiles<48>(p, out, B, H, W, s);
    case 64: return (int)attn_apply_tiles<64>(p, out, B, H, W, s);
    case 96: return (int)attn_apply_tiles<96>(p, out, B, H, W, s);
    case 128: return (int)attn_apply_tiles<128>(p, out, B, H, W, s);
    case 192: return (int)attn_apply_tiles<192>(p, out, B, H, W, s);
    case 256: return (int)attn_apply_tiles<256>(p, out, B, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
