// K3P: the apply + FFN pass of the fused TransformerBlock (the function of
// K3, block_tiles.cuh), software-pipelined. Template shared by
// fused_block_pipelined.cu (the production kernel) and probes_bisect.cu (the
// kernel cut after an earlier stage).
//
// Replaces the TPU kernel `_apply_ffn_kernel_v6`
// (bayer_low_light_image_enhancement_tpu/kernels/fused_block.py, reached
// from `fused_transformer_block` under BAYER_TPU_FUSED_V5=1). v6 answered
// K3's bottleneck on the TPU, a serial per-tile chain of dependent phases,
// with three changes, each carried over in Hopper's terms:
//
//   1. An ordered walk: each CTA of a persistent grid takes a contiguous run
//      of tiles in strip order (down a column strip of one image, then the
//      next strip), so consecutive windows share their halo rows in L2.
//   2. Asynchronous prefetch: the (TH+4) x (TW+4) x C window of the next
//      tile comes into the second of two shared-memory buffers by cp.async
//      while the current tile computes (v6's make_async_copy double buffer).
//   3. Two phases that overlap: phase 1 (LN1 -> v 1x1 -> dw3x3 -> v @ apply
//      + b_proj -> first residual) runs on one warp group (warps 0-7) for
//      tile i while phase 2 (LN2 -> 1x1 -> dw3x3 -> GELU -> 1x1 -> second
//      residual) runs on the other (warps 8-15) for tile i-1. y, the first
//      residual's output at the tile's 1-pixel ring, zero outside the image,
//      passes between them through a 2-slot bf16 ring in shared memory
//      (v6's ybuf). Named barriers hand the slots over: phase 1 waits on
//      EMPTY[s] before writing slot s and arrives on FULL[s] after; phase 2
//      waits on FULL[s] and arrives on EMPTY[s] once it has read the slot.
//      So phase 1 can run at most two tiles ahead, and it never overwrites
//      a slot phase 2 is still reading (v6's epilogue-step hazard).
//
// Bound: as K3, the per-tile chain; the two groups give the SM a second
// independent chain to schedule (one group's depthwise / LayerNorm work on
// the CUDA cores beside the other's tensor-core products), and the prefetch
// takes the window load off the chain. Products stay WMMA 16x16x16 (bf16
// in, fp32 accumulate). y is kept in bf16 (as v6 keeps it): two fp32 slots
// do not fit beside two windows at C = 256.
//
// Widths: power-of-two C in {32, 64, 128, 256} (the JAX gate: 1/C folds
// exactly into the bf16 mean), FFN hidden width 2C. Shared memory: two
// windows, the phase-1 chunk and v, two y slots, LN2(y), the phase-2 chunk
// and the GELU output; 4x4 tiles at C = 256 are what fit in 227 KB.
#ifndef BLLE_APPLY_PIPELINED_CUH
#define BLLE_APPLY_PIPELINED_CUH

#include "common.cuh"

namespace {

constexpr int kGroupThreads = 256, kGroupWarps = kGroupThreads / 32;
constexpr int kPipeThreads = 2 * kGroupThreads;
// Named barrier ids: each group's own, then FULL[0..1], EMPTY[0..1].
constexpr int kBarP1 = 1, kBarP2 = 2, kBarFull = 3, kBarEmpty = 5;

template <int C>
struct PipeCfg {
  static constexpr int TH = C >= 128 ? 4 : 8, TW = C >= 256 ? 4 : 8;
  static constexpr int CH = 2 * C, KCH = 32;
  static constexpr int WR = TH + 4, WC = TW + 4;
  static constexpr int NWIN = WR * WC, NWIN_P = round16(NWIN);
  static constexpr int R1R = TH + 2, R1C = TW + 2;
  static constexpr int NR1 = R1R * R1C, NR1_P = round16(NR1);
  static constexpr int NPIX = TH * TW;
  static constexpr int LDB = C + 8, LDK = KCH + 4, LDH = CH + 8;
  static constexpr int SZ_WIN = align128(NWIN_P * LDB * 2);  // each window
  static constexpr int SZ_Z1 = align128(NWIN_P * LDK * 4);   // phase-1 chunk
  static constexpr int SZ_R = align128(NR1_P * LDB * 2);     // v, y slot, LN2(y)
  static constexpr int SZ_Z2 = align128(NR1_P * LDK * 4);    // phase-2 chunk
  static constexpr int SZ_F = align128(NPIX * LDH * 2);      // GELU output
  static constexpr int OFF_Z1 = 2 * SZ_WIN, OFF_V = OFF_Z1 + SZ_Z1;
  static constexpr int OFF_Y = OFF_V + SZ_R, OFF_YN = OFF_Y + 2 * SZ_R;
  static constexpr int OFF_Z2 = OFF_YN + SZ_R, OFF_F = OFF_Z2 + SZ_Z2;
  static constexpr int SMEM = OFF_F + SZ_F;
  static_assert(SMEM <= 232448, "K3P shared memory exceeds 227 KB");
  static_assert(NPIX % 16 == 0 && C % KCH == 0, "K3P tile geometry");
};

struct TilePos {
  int b, r0, c0;
};

// Tile L of the strip order: strip L / tiles_h is (image, column of tiles),
// row of tiles L % tiles_h.
template <int C>
__device__ __forceinline__ TilePos pipe_tile(long long L, int tiles_h, int tiles_w) {
  using P = PipeCfg<C>;
  const long long strip = L / tiles_h;
  return {(int)(strip / tiles_w), (int)(L % tiles_h) * P::TH, (int)(strip % tiles_w) * P::TW};
}

// STAGE < 5 cuts the kernel after an earlier stage, as apply_tile_kernel
// (block_tiles.cuh) does, writing that stage's tensor at the own pixels:
// stages 1-3 end in phase 1 (phase 2's group exits at once), stage 4 in
// phase 2. STAGE 5 is the production K3P.
template <int C, int STAGE>
__global__ void __launch_bounds__(kPipeThreads, 1) apply_pipelined_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ apply,
    const bf16* __restrict__ wv, const float* __restrict__ bv,
    const float* __restrict__ dwv, const float* __restrict__ bdwv,
    const float* __restrict__ bproj, const bf16* __restrict__ wp1,
    const float* __restrict__ bp1, const float* __restrict__ dwf,
    const float* __restrict__ bdwf, const bf16* __restrict__ wp2,
    const float* __restrict__ bp2, bf16* __restrict__ out, int H, int W, int tiles_h,
    int tiles_w, long long total) {
  using P = PipeCfg<C>;
  unsigned char* sm = dyn_smem();
  const long long first = total * blockIdx.x / gridDim.x;
  const int n = (int)(total * (blockIdx.x + 1) / gridDim.x - first);
  const int tid = threadIdx.x % kGroupThreads, warp = tid / 32;
  bf16* const ybuf[2] = {reinterpret_cast<bf16*>(sm + P::OFF_Y),
                         reinterpret_cast<bf16*>(sm + P::OFF_Y + P::SZ_R)};
  // Stage output at own pixel (i, j) of tile t, channel ch.
  auto put = [&](const TilePos& t, int i, int j, int ch, float val) {
    if (inside(t.r0 + i, t.c0 + j, H, W))
      out[(((size_t)t.b * H + t.r0 + i) * W + t.c0 + j) * C + ch] = f2bf(val);
  };

  if (threadIdx.x < kGroupThreads) {
    // ---------------- Phase 1: LN1 -> v -> attention apply -> y ----------
    bf16* const win[2] = {reinterpret_cast<bf16*>(sm), reinterpret_cast<bf16*>(sm + P::SZ_WIN)};
    float* z1 = reinterpret_cast<float*>(sm + P::OFF_Z1);
    bf16* v = reinterpret_cast<bf16*>(sm + P::OFF_V);
    for (int e = tid; e < (P::NR1_P - P::NR1) * P::LDB; e += kGroupThreads)
      v[P::NR1 * P::LDB + e] = f2bf(0.0f);  // padding rows of v
    auto prefetch = [&](int k) {
      const TilePos t = pipe_tile<C>(first + k, tiles_h, tiles_w);
      load_window_async<C>(win[k & 1], P::LDB, P::NWIN_P, x + (size_t)t.b * H * W * C, H, W,
                           t.r0 - 2, t.c0 - 2, P::WR, P::WC, tid, kGroupThreads);
    };
    if (n > 0) prefetch(0);
    cp_async_commit();
    for (int k = 0; k < n; ++k) {
      const TilePos t = pipe_tile<C>(first + k, tiles_h, tiles_w);
      const bf16* xb = x + (size_t)t.b * H * W * C;
      bf16* xs = win[k & 1];
      cp_async_wait<0>();
      bar_sync(kBarP1, kGroupThreads);  // window k landed; tile k-1 done with the other
      if (k + 1 < n) prefetch(k + 1);
      cp_async_commit();
      layernorm_rows_t<C>(tid, kGroupThreads, xs, P::LDB, xs, P::LDB, P::NWIN);
      bar_sync(kBarP1, kGroupThreads);

      // v = dw3x3(mask(LN1(x) @ wv + bv)) + bdwv at the ring, chunk by chunk.
      for (int n0 = 0; n0 < C; n0 += P::KCH) {
        gemm_bf16_w<P::NWIN_P, P::KCH, C>(warp, kGroupWarps, xs, P::LDB, wv + n0, C, z1, P::LDK);
        bar_sync(kBarP1, kGroupThreads);
        for (int e = tid; e < P::NWIN * P::KCH; e += kGroupThreads) {
          const int p = e / P::KCH, c = e % P::KCH;
          const bool in = inside(t.r0 - 2 + p / P::WC, t.c0 - 2 + p % P::WC, H, W);
          z1[p * P::LDK + c] = in ? z1[p * P::LDK + c] + bv[n0 + c] : 0.0f;
        }
        bar_sync(kBarP1, kGroupThreads);
        if constexpr (STAGE == 1) {
          for (int e = tid; e < P::NPIX * P::KCH; e += kGroupThreads) {
            const int p = e / P::KCH, c = e % P::KCH, i = p / P::TW, j = p % P::TW;
            put(t, i, j, n0 + c, z1[((i + 2) * P::WC + j + 2) * P::LDK + c]);
          }
          bar_sync(kBarP1, kGroupThreads);
          continue;
        }
        for (int e = tid; e < P::NR1 * P::KCH; e += kGroupThreads) {
          const int p = e / P::KCH, c = e % P::KCH;
          const int i1 = p / P::R1C, j1 = p % P::R1C;
          float acc = bdwv[n0 + c];
          for (int di = 0; di < 3; ++di)
            for (int dj = 0; dj < 3; ++dj)
              acc += z1[((i1 + di) * P::WC + j1 + dj) * P::LDK + c] *
                     dwv[(di * 3 + dj) * C + n0 + c];
          v[p * P::LDB + n0 + c] = f2bf(acc);
        }
        bar_sync(kBarP1, kGroupThreads);
      }
      if constexpr (STAGE == 1) continue;

      // y = x + v @ apply + b_proj inside the image, 0 outside, into slot
      // k % 2 once phase 2 has released it.
      const int slot = k & 1;
      if constexpr (STAGE > 3) bar_sync(kBarEmpty + slot, kPipeThreads);
      for (int n0 = 0; n0 < C; n0 += P::KCH) {
        gemm_bf16_w<P::NR1_P, P::KCH, C>(warp, kGroupWarps, v, P::LDB,
                                         apply + (size_t)t.b * C * C + n0, C, z1, P::LDK);
        bar_sync(kBarP1, kGroupThreads);
        for (int e = tid; e < P::NR1_P * P::KCH; e += kGroupThreads) {
          const int p = e / P::KCH, c = e % P::KCH;
          const int i1 = p / P::R1C, j1 = p % P::R1C;
          const int gr = t.r0 - 1 + i1, gc = t.c0 - 1 + j1;
          const bool own = i1 >= 1 && i1 <= P::TH && j1 >= 1 && j1 <= P::TW && p < P::NR1;
          const float att = z1[p * P::LDK + c] + bproj[n0 + c];
          float val = 0.0f;
          if (p < P::NR1 && inside(gr, gc, H, W))
            val = bf2f(xb[((size_t)gr * W + gc) * C + n0 + c]) + att;
          if constexpr (STAGE == 2) {
            if (own) put(t, i1 - 1, j1 - 1, n0 + c, att);
          } else if constexpr (STAGE == 3) {
            if (own) put(t, i1 - 1, j1 - 1, n0 + c, val);
          } else {
            ybuf[slot][p * P::LDB + n0 + c] = f2bf(val);
          }
        }
        bar_sync(kBarP1, kGroupThreads);
      }
      if constexpr (STAGE > 3) bar_arrive(kBarFull + slot, kPipeThreads);
    }
    return;
  }

  // ---------------- Phase 2: LN2 -> FFN -> second residual ----------------
  if constexpr (STAGE <= 3) return;
  bf16* yn = reinterpret_cast<bf16*>(sm + P::OFF_YN);
  float* z2 = reinterpret_cast<float*>(sm + P::OFF_Z2);
  bf16* f = reinterpret_cast<bf16*>(sm + P::OFF_F);
  for (int s = 0; s < 2 && s < n; ++s) bar_arrive(kBarEmpty + s, kPipeThreads);
  for (int k = 0; k < n; ++k) {
    const TilePos t = pipe_tile<C>(first + k, tiles_h, tiles_w);
    const int slot = k & 1;
    const bf16* ys = ybuf[slot];
    bar_sync(kBarFull + slot, kPipeThreads);
    layernorm_rows_t<C>(tid, kGroupThreads, ys, P::LDB, yn, P::LDB, P::NR1_P);
    bar_sync(kBarP2, kGroupThreads);

    // f = GELU(dw3x3(mask(LN2(y) @ wp1 + bp1)) + bdwf) at own pixels.
    for (int h0 = 0; h0 < P::CH; h0 += P::KCH) {
      gemm_bf16_w<P::NR1_P, P::KCH, C>(warp, kGroupWarps, yn, P::LDB, wp1 + h0, P::CH, z2,
                                       P::LDK);
      bar_sync(kBarP2, kGroupThreads);
      for (int e = tid; e < P::NR1_P * P::KCH; e += kGroupThreads) {
        const int p = e / P::KCH, c = e % P::KCH;
        const bool in = p < P::NR1 &&
                        inside(t.r0 - 1 + p / P::R1C, t.c0 - 1 + p % P::R1C, H, W);
        z2[p * P::LDK + c] = in ? z2[p * P::LDK + c] + bp1[h0 + c] : 0.0f;
      }
      bar_sync(kBarP2, kGroupThreads);
      if constexpr (STAGE == 4) {
        if (h0 < C) {
          for (int e = tid; e < P::NPIX * P::KCH; e += kGroupThreads) {
            const int p = e / P::KCH, c = e % P::KCH, i = p / P::TW, j = p % P::TW;
            put(t, i, j, h0 + c, z2[((i + 1) * P::R1C + j + 1) * P::LDK + c]);
          }
        }
        bar_sync(kBarP2, kGroupThreads);
        continue;
      }
      for (int e = tid; e < P::NPIX * P::KCH; e += kGroupThreads) {
        const int p = e / P::KCH, c = e % P::KCH;
        const int i = p / P::TW, j = p % P::TW;
        float acc = bdwf[h0 + c];
        for (int di = 0; di < 3; ++di)
          for (int dj = 0; dj < 3; ++dj)
            acc += z2[((i + di) * P::R1C + j + dj) * P::LDK + c] *
                   dwf[(di * 3 + dj) * P::CH + h0 + c];
        f[p * P::LDH + h0 + c] = f2bf(0.5f * acc * (1.0f + erff(acc * 0.70710678118654752f)));
      }
      bar_sync(kBarP2, kGroupThreads);
    }

    if constexpr (STAGE == 5) {
      // out = y + f @ wp2 + bp2 at own pixels inside the image.
      for (int n0 = 0; n0 < C; n0 += P::KCH) {
        gemm_bf16_w<P::NPIX, P::KCH, P::CH>(warp, kGroupWarps, f, P::LDH, wp2 + n0, C, z2,
                                            P::LDK);
        bar_sync(kBarP2, kGroupThreads);
        for (int e = tid; e < P::NPIX * P::KCH; e += kGroupThreads) {
          const int p = e / P::KCH, c = e % P::KCH, i = p / P::TW, j = p % P::TW;
          const float yv = bf2f(ys[((i + 1) * P::R1C + j + 1) * P::LDB + n0 + c]);
          put(t, i, j, n0 + c, yv + z2[p * P::LDK + c] + bp2[n0 + c]);
        }
        bar_sync(kBarP2, kGroupThreads);
      }
    }
    if (k + 2 < n) bar_arrive(kBarEmpty + slot, kPipeThreads);
  }
}

// Launch K3P (or a cut of it) on a persistent grid: as many CTAs as fit on
// the card at once, each with a contiguous run of the B * tiles_h * tiles_w
// tiles in strip order.
template <int C, int STAGE>
cudaError_t apply_pipelined(const void* const* p, void* out, int B, int H, int W,
                            cudaStream_t s) {
  using P = PipeCfg<C>;
  auto kernel = apply_pipelined_kernel<C, STAGE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kPipeThreads, P::SMEM);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int tiles_h = cdiv(H, P::TH), tiles_w = cdiv(W, P::TW);
  const long long total = (long long)B * tiles_h * tiles_w;
  const int grid = (int)(total < (long long)sms * per_sm ? total : (long long)sms * per_sm);
  return launch(kernel, dim3(grid), dim3(kPipeThreads), P::SMEM, s, (const bf16*)p[0],
                (const bf16*)p[1], (const bf16*)p[2], (const float*)p[3], (const float*)p[4],
                (const float*)p[5], (const float*)p[6], (const bf16*)p[7], (const float*)p[8],
                (const float*)p[9], (const float*)p[10], (const bf16*)p[11],
                (const float*)p[12], (bf16*)out, H, W, tiles_h, tiles_w, total);
}

}  // namespace

#endif  // BLLE_APPLY_PIPELINED_CUH
