// K3P: the apply + FFN pass of the fused TransformerBlock (the function of
// K3, block_tiles.cuh) as one kernel, its two phases overlapped. Template
// shared by fused_block_pipelined.cu (the production kernel) and
// probes_bisect.cu (the kernel cut after an earlier stage).
//
// Replaces the TPU kernel `_apply_ffn_kernel_v6`
// (bayer_low_light_image_enhancement_tpu/kernels/fused_block.py, reached
// from `fused_transformer_block` under BAYER_TPU_FUSED_V5=1). v6 answered
// K3's bottleneck on the TPU, a serial per-tile chain of dependent phases,
// with an ordered walk, an asynchronous window prefetch and two phases that
// overlap, y handed between them on chip. Here, in Hopper's terms:
//
//   1. A persistent grid (the occupancy API's CTAs, at most one per tile)
//      in which each CTA walks a contiguous run of tiles in strip order
//      (down a column strip of one image, then the next), so neighbouring
//      windows share their halo rows in L2.
//   2. Two groups of 8 warps. Phase 1 (LN1 -> v 1x1 -> dw3x3 -> v @ apply +
//      b_proj -> first residual) runs on group 1 for tile i while phase 2
//      (LN2 -> 1x1 -> dw3x3 -> GELU -> 1x1 -> second residual) runs on
//      group 2 for tile i-1. y, the first residual's output at the tile's
//      1-pixel ring (zero outside the image), passes between them in bf16
//      through a 2-slot ring in shared memory: phase 1 waits on EMPTY[s]
//      before it writes slot s (v, then y over it) and arrives on FULL[s]
//      after; phase 2 waits on FULL[s], keeps y at the own pixels for the
//      residual, normalises the slot in place, and arrives on EMPTY[s] once
//      its last expand product has read it. Named barriers (ids 3-6, both
//      groups) guard the ring, and each group has its own (1, 2).
//   3. Phase 1's window (the tile with a 2-pixel halo) comes in by cp.async
//      while the previous tile computes: into a second buffer at C = 32,
//      into the same one once its v 1x1 has read it at the widths where two
//      do not fit.
//
// Each phase is built from block_tiles.cuh's pieces, run by its own 256
// threads: products on mma.sync from shared memory via ldmatrix (`product`,
// `product_acc`), LayerNorm by lane quads, the depthwise conv as a column
// walk with the 3 x 3 neighbourhood in registers (`dw3x3_own`), bias, mask,
// GELU and bf16 rounding as epilogues. Each phase owns its weights: resident
// in shared memory at C <= 64 (phase 1's per-image `apply` reloaded when the
// walk enters another image), above that streamed through its own two-slot
// cp.async ring in chunks of KW output channels (or KW rows of the apply and
// projection matrices), the next chunk arriving while the current one
// multiplies. The v @ apply and FFN projection products accumulate in
// registers across their K chunks. The depthwise taps and the biases are
// staged in shared memory except at C = 256, where they are read from
// device memory (L1) to make room.
//
// Against K3 (two kernels split at y, each with a 1-pixel halo), one kernel
// saves y's round trip through L2 and a launch but pays a 2-pixel halo for
// LN1 and the v 1x1, and smaller tiles, since both phases' buffers share
// one SM's 227 KB: 8 x 16 at C = 32, 8 x 8 at 64, 4 x 8 at 128, 4 x 4 at
// 256.
//
// Widths: power-of-two C in {32, 64, 128, 256} (the JAX gate: 1/C folds
// exactly into the bf16 mean), FFN hidden width 2C.
#ifndef BLLE_APPLY_PIPELINED_CUH
#define BLLE_APPLY_PIPELINED_CUH

#include "block_tiles.cuh"

namespace {

constexpr int kGroupThreads = 256, kGroupWarps = kGroupThreads / 32;
constexpr int kPipeThreads = 2 * kGroupThreads;
// Named barrier ids: each group's own, then FULL[0..1], EMPTY[0..1].
constexpr int kBarP1 = 1, kBarP2 = 2, kBarFull = 3, kBarEmpty = 5;

template <int C>
struct PipeCfg {
  static constexpr int TH = C <= 64 ? 8 : 4, TW = C == 32 ? 16 : C <= 128 ? 8 : 4;
  static constexpr int CH = 2 * C;
  static constexpr bool RES = C <= 64;       // weights resident (else streamed)
  static constexpr int KW = C == 256 ? 32 : 64;  // streamed chunk: columns or K rows
  static constexpr int WINS = C == 32 ? 2 : 1;   // window buffers
  static constexpr bool TAPS = C != 256;     // dw taps in shared memory (else device memory)
  // Phase 1: v 1x1 in NCH1 column chunks of NC1, v @ apply in NK1 K chunks of KC1.
  static constexpr int NC1 = RES ? C : KW, NCH1 = C / NC1, KC1 = RES ? C : KW, NK1 = C / KC1;
  // Phase 2: expand in NCH2 column chunks of NC2, projection in NK2 K chunks of KC2.
  static constexpr int NC2 = RES ? 64 : KW, NCH2 = CH / NC2, KC2 = RES ? CH : KW, NK2 = CH / KC2;
  static constexpr int STEPS1 = NCH1 + NK1, STEPS2 = NCH2 + NK2;  // streamed chunks a tile
  // The window (2-pixel halo), the ring (1-pixel halo), the own pixels.
  static constexpr int WC2 = TW + 4, R2 = (TH + 4) * WC2, R2P = round16(R2);
  static constexpr int WC1 = TW + 2, R1 = (TH + 2) * WC1, R1P = round16(R1);
  static constexpr int P = TH * TW;
  static constexpr int LDX = C + 8, LDZ1 = NC1 + 8, LDZ2 = NC2 + 8, LDF = CH + 8;
  static constexpr int LDWC = KW + 8, LDWR = C + 8;  // a streamed column / row chunk
  static constexpr int SZ_SLOT = cmax(align128(C * LDWC * 2), align128(KW * LDWR * 2));
  // fp32 vectors: phase 1 [taps 9C][bdwv][bv][bproj], phase 2 [taps 9CH][bdwf][bp1][bp2].
  static constexpr int T1 = TAPS ? 9 * C : 0, V_BDW1 = T1, V_B1 = T1 + C, V_BP = T1 + 2 * C;
  static constexpr int T2 = TAPS ? 9 * CH : 0, V_BDW2 = T2, V_B2 = T2 + CH, V_BO = T2 + 2 * CH;
  static constexpr int SZ_WIN = align128(R2P * LDX * 2), SZ_Z1 = align128(R2P * LDZ1 * 4);
  static constexpr int SZ_WV = align128(C * (C + 8) * 2);  // resident wv, and apply
  static constexpr int SZ_W1 = RES ? 2 * SZ_WV : 2 * SZ_SLOT;
  static constexpr int SZ_VT1 = align128((T1 + 3 * C) * 4);
  static constexpr int SZ_Y = align128(R1P * LDX * 2), SZ_YO = align128(P * LDX * 2);
  static constexpr int SZ_Z2 = align128(R1P * LDZ2 * 4), SZ_F = align128(P * LDF * 2);
  static constexpr int SZ_WP1 = align128(C * (CH + 8) * 2);  // resident wp1, then wp2
  static constexpr int SZ_W2 = RES ? SZ_WP1 + align128(CH * (C + 8) * 2) : 2 * SZ_SLOT;
  static constexpr int SZ_VT2 = align128((T2 + 2 * CH + C) * 4);
  static constexpr int OFF_Z1 = WINS * SZ_WIN, OFF_W1 = OFF_Z1 + SZ_Z1;
  static constexpr int OFF_VT1 = OFF_W1 + SZ_W1, OFF_Y = OFF_VT1 + SZ_VT1;
  static constexpr int OFF_YO = OFF_Y + 2 * SZ_Y, OFF_Z2 = OFF_YO + SZ_YO;
  static constexpr int OFF_F = OFF_Z2 + SZ_Z2, OFF_W2 = OFF_F + SZ_F;
  static constexpr int OFF_VT2 = OFF_W2 + SZ_W2, SMEM = OFF_VT2 + SZ_VT2;
  static_assert(SMEM <= kSmemPerBlock, "K3P shared memory exceeds 227 KB");
  static_assert(P % 16 == 0 && (RES || C % KW == 0) && NC2 % 16 == 0, "K3P tile geometry");
};

struct PipeArgs {
  const bf16* x;
  const bf16* apply;
  const bf16* wv;
  const float* bv;
  const float* dwv;
  const float* bdwv;
  const float* bproj;
  const bf16* wp1;
  const float* bp1;
  const float* dwf;
  const float* bdwf;
  const bf16* wp2;
  const float* bp2;
  bf16* out;
  int H, W, tiles_h, tiles_w;
  long long total;
};

// Phase 1 on threads tid in [0, 256): for each tile of the run, y at the
// ring into slot k % 2 (STAGE >= 4), or the cut's tensor at the own pixels
// into out (STAGE 1-3).
template <int C, int STAGE>
__device__ void pipe_phase1(const PipeArgs& a, unsigned char* sm, long long first, int n,
                            int tid) {
  using P = PipeCfg<C>;
  constexpr int NT = kGroupThreads, NW = kGroupWarps;
  bf16* const win0 = reinterpret_cast<bf16*>(sm);
  float* const z1 = reinterpret_cast<float*>(sm + P::OFF_Z1);
  bf16* const w1 = reinterpret_cast<bf16*>(sm + P::OFF_W1);  // resident wv, apply or the ring
  float* const vt = reinterpret_cast<float*>(sm + P::OFF_VT1);
  const float* const taps = P::TAPS ? vt : a.dwv;
  auto ybuf = [&](int s) { return reinterpret_cast<bf16*>(sm + P::OFF_Y + s * P::SZ_Y); };
  auto window = [&](int k) { return win0 + (P::WINS == 2 ? (k & 1) * (P::SZ_WIN / 2) : 0); };
  auto slot = [&](long long g) { return w1 + (g & 1) * (P::SZ_SLOT / 2); };
  auto load_win = [&](int k) {
    const TilePos3 t = tile_pos<P::TH, P::TW>(first + k, a.tiles_h, a.tiles_w);
    load_window_async<C>(window(k), P::LDX, P::R2P, a.x + (size_t)t.b * a.H * a.W * C, a.H,
                         a.W, t.r0 - 2, t.c0 - 2, P::TH + 4, P::WC2, tid, NT);
  };
  // Streamed: global step g's chunk (wv columns, then apply rows of image b).
  auto load_step = [&](long long g, int b) {
    const int st = (int)(g % P::STEPS1);
    if (st < P::NCH1) {
      const int n0 = st * P::KW;
      load_rows_async_t<NT>(tid, slot(g), P::LDWC, a.wv, C, C, P::KW,
                            [&](int c) { return n0 + c; });
    } else {
      load_rows_async_t<NT>(tid, slot(g), P::LDWR,
                            a.apply + (size_t)b * C * C + (size_t)(st - P::NCH1) * P::KW * C, C,
                            P::KW, C, Same());
    }
  };
  auto put = [&](const TilePos3& t, int i, int j, int ch, float v0, float v1) {
    if (inside(t.r0 + i, t.c0 + j, a.H, a.W))
      st_bf2(a.out + (((size_t)t.b * a.H + t.r0 + i) * a.W + t.c0 + j) * C + ch, v0, v1);
  };

  if (n > 0) {
    load_win(0);
    if constexpr (P::TAPS) load_taps_async_t<NT>(tid, vt, C, a.dwv, C, Same());
    load_vec_async_t<NT>(tid, vt + P::V_BDW1, a.bdwv, C, Same());
    load_vec_async_t<NT>(tid, vt + P::V_B1, a.bv, C, Same());
    load_vec_async_t<NT>(tid, vt + P::V_BP, a.bproj, C, Same());
    if constexpr (P::RES)
      load_rows_async_t<NT>(tid, w1, C + 8, a.wv, C, C, C, Same());
    else
      load_step(0, tile_pos<P::TH, P::TW>(first, a.tiles_h, a.tiles_w).b);
  }
  cp_async_commit();
  int cur_b = -1;
  for (int k = 0; k < n; ++k) {
    const TilePos3 t = tile_pos<P::TH, P::TW>(first + k, a.tiles_h, a.tiles_w);
    bf16* const xs = window(k);
    bf16* const ys = ybuf(k & 1);
    const long long g0 = (long long)k * P::STEPS1;
    // The step after g: the next chunk of this tile or the first of the next.
    auto prefetch = [&](long long g) {
      if constexpr (!P::RES) {
        if (g % P::STEPS1 != 0)
          load_step(g, t.b);
        else if (k + 1 < n)
          load_step(g, 0);
      }
    };
    cp_async_wait<0>();
    bar_sync(kBarP1, NT);  // window k landed; tile k - 1 is done with every buffer
    if (P::WINS == 2 && k + 1 < n) load_win(k + 1);
    if constexpr (P::RES) {
      if (t.b != cur_b)
        load_rows_async_t<NT>(tid, w1 + P::SZ_WV / 2, C + 8, a.apply + (size_t)t.b * C * C, C, C,
                              C, Same());
      cur_b = t.b;
    }
    cp_async_commit();
    layernorm_quads_t<C, NT>(tid, xs, P::LDX, P::R2);
    bar_sync(kBarP1, NT);
    if constexpr (STAGE >= 4) bar_sync(kBarEmpty + (k & 1), kPipeThreads);  // slot free
    // v = dw3x3(mask(LN1(x) @ wv + bv)) + bdwv at the ring, into the slot.
    for (int st = 0; st < P::NCH1; ++st) {
      const int n0 = st * P::NC1;
      const bf16* wc;
      int ldw;
      if constexpr (P::RES) {
        if (st > 0) bar_sync(kBarP1, NT);  // the previous chunk's dw3x3 is done with z1
        wc = w1 + n0, ldw = C + 8;
      } else {
        if (st > 0) {
          cp_async_wait<0>();
          bar_sync(kBarP1, NT);
        }
        prefetch(g0 + st + 1);
        cp_async_commit();
        wc = slot(g0 + st), ldw = P::LDWC;
      }
      product_t<NW, P::R2P / 16, P::NC1 / 8, C>(
          tid, xs, P::LDX, wc, ldw, [&](int row, int c, float v0, float v1) {
            float2 o = make_float2(0.f, 0.f);
            if (row < P::R2 && inside(t.r0 - 2 + row / P::WC2, t.c0 - 2 + row % P::WC2, a.H, a.W)) {
              const float2 bb = ld2(vt + P::V_B1 + n0 + c);
              o = make_float2(v0 + bb.x, v1 + bb.y);
            }
            *reinterpret_cast<float2*>(z1 + row * P::LDZ1 + c) = o;
          });
      bar_sync(kBarP1, NT);
      if (P::WINS == 1 && st == P::NCH1 - 1 && k + 1 < n) {  // the window is read: refill it
        load_win(k + 1);
        cp_async_commit();
      }
      if constexpr (STAGE == 1) {
        for (int e = tid; e < P::P * P::NC1 / 2; e += NT) {
          const int p = e / (P::NC1 / 2), c = 2 * (e % (P::NC1 / 2)), i = p / P::TW, j = p % P::TW;
          const float2 o = ld2(z1 + ((i + 2) * P::WC2 + j + 2) * P::LDZ1 + c);
          put(t, i, j, n0 + c, o.x, o.y);
        }
      } else {
        dw3x3_own_t<NT, P::TH + 2, P::TW + 2, P::NC1>(
            tid, z1, P::LDZ1, taps + n0, C, vt + P::V_BDW1 + n0,
            [&](int p, int cq, float4 v) { st_bf4(ys + p * P::LDX + n0 + 4 * cq, v); });
      }
    }
    // y = x + v @ apply + b_proj at the ring inside the image, 0 outside.
    using AI = Items<NW, P::R1P / 16, C / 8>;
    float acc[AI::PER][2][2][4];
#pragma unroll
    for (int s = 0; s < AI::PER; ++s)
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[s][e / 8][(e / 4) % 2][e % 4] = 0.f;
    if constexpr (P::RES) {
      if (P::WINS == 1 && k + 1 < n)
        cp_async_wait<1>();  // the image's apply (the next window may still fly)
      else
        cp_async_wait<0>();
      bar_sync(kBarP1, NT);  // v complete, apply landed
      if constexpr (STAGE != 1)
        product_acc_t<false, NW, P::R1P / 16, C / 8, C>(tid, acc, ys, P::LDX, w1 + P::SZ_WV / 2,
                                                         C + 8);
    } else {
      for (int kk = 0; kk < P::NK1; ++kk) {
        const long long g = g0 + P::NCH1 + kk;
        cp_async_wait<0>();
        bar_sync(kBarP1, NT);
        prefetch(g + 1);
        cp_async_commit();
        if constexpr (STAGE != 1)
          product_acc_t<false, NW, P::R1P / 16, C / 8, P::KW>(tid, acc, ys + kk * P::KW, P::LDX,
                                                               slot(g), P::LDWR);
      }
    }
    if constexpr (STAGE != 1) {
      bar_sync(kBarP1, NT);  // every warp is done reading v from the slot
      acc_epilogue_t<NW, P::R1P / 16, C / 8>(tid, acc, [&](int p, int nn, float v0, float v1) {
        if (p >= P::R1) return;
        const int i1 = p / P::WC1, j1 = p % P::WC1, gr = t.r0 - 1 + i1, gc = t.c0 - 1 + j1;
        const bool in = inside(gr, gc, a.H, a.W);
        const bool own = i1 >= 1 && i1 <= P::TH && j1 >= 1 && j1 <= P::TW;
        const float2 bp = ld2(vt + P::V_BP + nn);
        float y0 = 0.f, y1 = 0.f;
        if (in) {
          const float2 xv = ld_bf2(a.x + (((size_t)t.b * a.H + gr) * a.W + gc) * C + nn);
          y0 = xv.x + v0 + bp.x, y1 = xv.y + v1 + bp.y;
        }
        if constexpr (STAGE == 2) {
          if (own) put(t, i1 - 1, j1 - 1, nn, v0 + bp.x, v1 + bp.y);
        } else if constexpr (STAGE == 3) {
          if (own) put(t, i1 - 1, j1 - 1, nn, y0, y1);
        } else {
          st_bf2(ys + p * P::LDX + nn, y0, y1);
        }
      });
    }
    if constexpr (STAGE >= 4) bar_arrive(kBarFull + (k & 1), kPipeThreads);
  }
}

// Phase 2 on threads tid in [0, 256) (the block's threads 256-511): for each
// tile, out = y + FFN(LN2(y)) at the own pixels from slot k % 2 (STAGE 5),
// or the first C channels of the expand output (STAGE 4).
template <int C, int STAGE>
__device__ void pipe_phase2(const PipeArgs& a, unsigned char* sm, long long first, int n,
                            int tid) {
  using P = PipeCfg<C>;
  constexpr int NT = kGroupThreads, NW = kGroupWarps;
  bf16* const yo = reinterpret_cast<bf16*>(sm + P::OFF_YO);
  float* const z2 = reinterpret_cast<float*>(sm + P::OFF_Z2);
  bf16* const f = reinterpret_cast<bf16*>(sm + P::OFF_F);
  bf16* const w2 = reinterpret_cast<bf16*>(sm + P::OFF_W2);  // resident wp1, wp2 or the ring
  float* const vt = reinterpret_cast<float*>(sm + P::OFF_VT2);
  const float* const taps = P::TAPS ? vt : a.dwf;
  auto slot = [&](long long g) { return w2 + (g & 1) * (P::SZ_SLOT / 2); };
  // Streamed: global step g's chunk (wp1 columns, then wp2 rows).
  auto load_step = [&](long long g) {
    const int st = (int)(g % P::STEPS2);
    if (st < P::NCH2) {
      const int h0 = st * P::KW;
      load_rows_async_t<NT>(tid, slot(g), P::LDWC, a.wp1, P::CH, C, P::KW,
                            [&](int c) { return h0 + c; });
    } else {
      load_rows_async_t<NT>(tid, slot(g), P::LDWR, a.wp2 + (size_t)(st - P::NCH2) * P::KW * C, C,
                            P::KW, C, Same());
    }
  };

  if (n > 0) {
    if constexpr (P::TAPS) load_taps_async_t<NT>(tid, vt, P::CH, a.dwf, P::CH, Same());
    load_vec_async_t<NT>(tid, vt + P::V_BDW2, a.bdwf, P::CH, Same());
    load_vec_async_t<NT>(tid, vt + P::V_B2, a.bp1, P::CH, Same());
    load_vec_async_t<NT>(tid, vt + P::V_BO, a.bp2, C, Same());
    if constexpr (P::RES) {
      load_rows_async_t<NT>(tid, w2, P::CH + 8, a.wp1, P::CH, C, P::CH, Same());
      load_rows_async_t<NT>(tid, w2 + P::SZ_WP1 / 2, C + 8, a.wp2, C, P::CH, C, Same());
    } else {
      load_step(0);
    }
  }
  cp_async_commit();
  for (int s = 0; s < 2 && s < n; ++s) bar_arrive(kBarEmpty + s, kPipeThreads);
  for (int k = 0; k < n; ++k) {
    const TilePos3 t = tile_pos<P::TH, P::TW>(first + k, a.tiles_h, a.tiles_w);
    bf16* const ys = reinterpret_cast<bf16*>(sm + P::OFF_Y + (k & 1) * P::SZ_Y);
    const long long g0 = (long long)k * P::STEPS2;
    auto prefetch = [&](long long g) {
      if constexpr (!P::RES) {
        if (g < (long long)n * P::STEPS2) load_step(g);
      }
    };
    auto own = [&](int p) { return inside(t.r0 + p / P::TW, t.c0 + p % P::TW, a.H, a.W); };
    auto gidx = [&](int p) {
      return (((size_t)t.b * a.H + t.r0 + p / P::TW) * a.W + t.c0 + p % P::TW) * C;
    };
    // Waiting on FULL also orders every warp of this group after its own
    // tile k - 1: yo, z2 and f are free.
    bar_sync(kBarFull + (k & 1), kPipeThreads);
    for (int e = tid; e < P::P * C / 8; e += NT) {  // y at the own pixels, for the residual
      const int p = e / (C / 8), u = e % (C / 8);
      *reinterpret_cast<uint4*>(yo + p * P::LDX + 8 * u) = *reinterpret_cast<const uint4*>(
          ys + ((p / P::TW + 1) * P::WC1 + p % P::TW + 1) * P::LDX + 8 * u);
    }
    bar_sync(kBarP2, NT);
    layernorm_quads_t<C, NT>(tid, ys, P::LDX, P::R1);
    cp_async_wait<0>();  // the weights (resident, or this tile's first chunk)
    bar_sync(kBarP2, NT);
    // f = GELU(dw3x3(mask(LN2(y) @ wp1 + bp1)) + bdwf) at the own pixels.
    for (int st = 0; st < P::NCH2; ++st) {
      const int h0 = st * P::NC2;
      const bf16* wc;
      int ldw;
      if constexpr (P::RES) {
        if (st > 0) bar_sync(kBarP2, NT);
        wc = w2 + h0, ldw = P::CH + 8;
      } else {
        if (st > 0) {
          cp_async_wait<0>();
          bar_sync(kBarP2, NT);
        }
        prefetch(g0 + st + 1);
        cp_async_commit();
        wc = slot(g0 + st), ldw = P::LDWC;
      }
      product_t<NW, P::R1P / 16, P::NC2 / 8, C>(
          tid, ys, P::LDX, wc, ldw, [&](int row, int c, float v0, float v1) {
            float2 o = make_float2(0.f, 0.f);
            if (row < P::R1 && inside(t.r0 - 1 + row / P::WC1, t.c0 - 1 + row % P::WC1, a.H, a.W)) {
              const float2 bb = ld2(vt + P::V_B2 + h0 + c);
              o = make_float2(v0 + bb.x, v1 + bb.y);
            }
            *reinterpret_cast<float2*>(z2 + row * P::LDZ2 + c) = o;
          });
      bar_sync(kBarP2, NT);
      if (st == P::NCH2 - 1 && k + 2 < n)
        bar_arrive(kBarEmpty + (k & 1), kPipeThreads);  // the slot is read: phase 1 may refill it
      if constexpr (STAGE == 4) {
        for (int e = tid; e < P::P * P::NC2 / 2; e += NT) {
          const int p = e / (P::NC2 / 2), c = 2 * (e % (P::NC2 / 2));
          if (h0 + c < C && own(p)) {
            const float2 o =
                ld2(z2 + ((p / P::TW + 1) * P::WC1 + p % P::TW + 1) * P::LDZ2 + c);
            st_bf2(a.out + gidx(p) + h0 + c, o.x, o.y);
          }
        }
      } else {
        dw3x3_own_t<NT, P::TH, P::TW, P::NC2>(
            tid, z2, P::LDZ2, taps + h0, P::CH, vt + P::V_BDW2 + h0, [&](int p, int cq, float4 v) {
              st_bf4(f + p * P::LDF + h0 + 4 * cq,
                     make_float4(gelu(v.x), gelu(v.y), gelu(v.z), gelu(v.w)));
            });
      }
    }
    // out = y + f @ wp2 + bp2 at the own pixels inside the image.
    using PI = Items<NW, P::P / 16, C / 8>;
    float acc[PI::PER][2][2][4];
#pragma unroll
    for (int s = 0; s < PI::PER; ++s)
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[s][e / 8][(e / 4) % 2][e % 4] = 0.f;
    if constexpr (P::RES) {
      bar_sync(kBarP2, NT);  // f complete
      if constexpr (STAGE == 5)
        product_acc_t<false, NW, P::P / 16, C / 8, P::CH>(tid, acc, f, P::LDF, w2 + P::SZ_WP1 / 2,
                                                           C + 8);
    } else {
      for (int kk = 0; kk < P::NK2; ++kk) {
        const long long g = g0 + P::NCH2 + kk;
        cp_async_wait<0>();
        bar_sync(kBarP2, NT);
        prefetch(g + 1);
        cp_async_commit();
        if constexpr (STAGE == 5)
          product_acc_t<false, NW, P::P / 16, C / 8, P::KW>(tid, acc, f + kk * P::KW, P::LDF,
                                                             slot(g), P::LDWR);
      }
    }
    if constexpr (STAGE == 5)
      acc_epilogue_t<NW, P::P / 16, C / 8>(tid, acc, [&](int p, int nn, float v0, float v1) {
        if (!own(p)) return;
        const float2 yv = ld_bf2(yo + p * P::LDX + nn), bb = ld2(vt + P::V_BO + nn);
        st_bf2(a.out + gidx(p) + nn, yv.x + v0 + bb.x, yv.y + v1 + bb.y);
      });
  }
}

// STAGE < 5 cuts the kernel after an earlier stage, as apply1_kernel /
// apply2_kernel (block_tiles.cuh) do, writing that stage's tensor at the own
// pixels: stages 1-3 end in phase 1 (phase 2's group exits at once), stage 4
// in phase 2. STAGE 5 is the production K3P.
template <int C, int STAGE>
__global__ void __launch_bounds__(kPipeThreads, 1) apply_pipelined_kernel(const PipeArgs a) {
  unsigned char* sm = dyn_smem();
  const long long first = a.total * blockIdx.x / gridDim.x;
  const int n = (int)(a.total * (blockIdx.x + 1) / gridDim.x - first);
  if (threadIdx.x < kGroupThreads)
    pipe_phase1<C, STAGE>(a, sm, first, n, threadIdx.x);
  else if constexpr (STAGE >= 4)
    pipe_phase2<C, STAGE>(a, sm, first, n, threadIdx.x - kGroupThreads);
}

// Launch K3P (or a cut of it) on a persistent grid of `grid` CTAs (<= 0:
// as many as are resident, at most one per tile), each with a contiguous
// run of the B * tiles_h * tiles_w tiles in strip order; p holds the
// arguments of blle_apply_pass in order.
template <int C, int STAGE>
cudaError_t apply_pipelined(const void* const* p, void* out, int B, int H, int W,
                            cudaStream_t s, int grid = 0) {
  using P = PipeCfg<C>;
  const int th = cdiv(H, P::TH), tw = cdiv(W, P::TW);
  const long long total = (long long)B * th * tw;
  const int g = apply_grid(apply_pipelined_kernel<C, STAGE>, kPipeThreads, P::SMEM, total, grid);
  if (g < 1) return grid > 0 ? cudaErrorInvalidValue : cudaErrorInvalidConfiguration;
  const PipeArgs a{(const bf16*)p[0],  (const bf16*)p[1],  (const bf16*)p[2],  (const float*)p[3],
                   (const float*)p[4], (const float*)p[5], (const float*)p[6], (const bf16*)p[7],
                   (const float*)p[8], (const float*)p[9], (const float*)p[10], (const bf16*)p[11],
                   (const float*)p[12], (bf16*)out,        H,                  W,
                   th,                 tw,                 total};
  return launch(apply_pipelined_kernel<C, STAGE>, dim3(g), dim3(kPipeThreads), P::SMEM, s, a);
}

// K3P's plan at width C: info = TH, TW, threads, shared-memory bytes, blocks
// per SM (the occupancy API's), as block_kernel_info gives the others.
template <int C>
cudaError_t pipe_kernel_info(long long* info) {
  using P = PipeCfg<C>;
  info[0] = P::TH, info[1] = P::TW, info[2] = kPipeThreads, info[3] = P::SMEM;
  info[4] = blocks_per_sm(apply_pipelined_kernel<C, 5>, kPipeThreads, P::SMEM);
  return info[4] > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

}  // namespace

#endif  // BLLE_APPLY_PIPELINED_CUH
