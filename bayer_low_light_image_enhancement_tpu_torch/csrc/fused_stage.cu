// T1: the ConvTransformer stage tail, the port of the retired TPU kernel
// `fused_stage_tail` (attic/fused_stage.py, `_stage_tail_kernel`):
//
//   conv = lrelu(conv3x3(x) + b_c)
//   y    = conv @ Wr[:C] + t @ Wr[C:] + b_r      (the concat [conv, t] folded
//                                                  into the split weight)
//   out  = lrelu(conv3x3(y) + b_o)
//
// 3x3 convs with SAME zero padding, lrelu slope 0.2; x and t bf16, products
// on the tensor cores (fp32 accumulate), conv and y rounded to bf16 (as the
// TPU kernel rounds them).
//
// Bound: the tensor-core products (20 C^2 MACs a pixel) at C >= 64; the bytes
// (x, t in, out) at C = 32 and 48. What held the first port back was neither:
// it read every weight fragment from L2 once per 16 rows of small tiles with
// recomputed halos (3.7-336 KB of weights an output pixel). This design
// stages the weights in shared memory once per 128-pixel tile and reads
// them from there for every row of it, and computes each value once:
//
// * Two kernels split at y (as K3 is split): tail_conv_kernel computes conv
//   from x with a 1-pixel halo, then y at the tile's own pixels from conv and
//   t, and writes y (bf16); tail_out_kernel computes out from y with a
//   1-pixel halo. y's round trip (2 B H W C bytes) mostly stays in L2.
// * Tiles of 8 x 16 own pixels (128 rows of every product, M = 128), the
//   window (10 x 18 pixels, row stride C + 8 bf16) in shared memory. A 16-row
//   m-tile is one row of the tile, so tap (di, dj) of m-tile i is the window
//   at row (i + di) * 18 + dj: the A operand of every tap is the window at an
//   offset, read by ldmatrix with no gather and no wasted rows.
// * Weights, one [K][C] matrix (K = 9 C taps + 2 C reduce rows, or 9 C),
//   resident in shared memory at C <= 64; above, streamed in chunks of KC
//   K-rows (one tap, 64 or 96 input channels) through a ring of NS slots,
//   the next chunks in flight while one multiplies, flowing across tiles.
// * C = 128, 192, 256 (whole 64-column swizzle atoms): wgmma m64nCk16, two
//   warpgroups of 64 output rows each, A (the window's rows) in registers
//   from ldmatrix, B the chunk in shared memory. Thread 0 loads the chunks
//   by TMA (128-byte swizzle) on an mbarrier per slot, and refills a slot
//   once the 8 warps have arrived on its "empty" mbarrier: no block barrier
//   a step and no load instructions on the warps that multiply. (With every
//   thread loading its share by cp.async and a block barrier a step, the
//   loads did not overlap the products: builds with either switched off
//   each took most of the whole's time.)
// * C <= 96: mma.sync m16n8k16 from ldmatrix (block_tiles.cuh's helpers),
//   8 warps each a WM x WN block; C = 96 streams by cp.async with a block
//   barrier a step.
// * Accumulators stay in registers from the first tap through the epilogue
//   (bias, lrelu, bf16 straight from the fragments).
// * Persistent grid (the occupancy API's CTAs, passed by the wrapper), each
//   CTA walking a run of tiles in strip order; the next tile's window
//   arrives by cp.async into a second buffer where shared memory allows it
//   without costing a CTA an SM, else into the one window as soon as the
//   tile is done with it. At C = 256 conv is kept over the dead x window
//   (TailCfg::VX): the window, t and two 32 KB weight slots take 224 KB.
//
// Widths: C in {32, 48, 64, 96, 128, 192, 256}. blle_stage_tail_info gives
// each kernel's plan; kernels/fused_stage.py `tail_config` mirrors it.
#include <cuda.h>  // CUtensorMap and its enums (the encoder comes through the runtime)

#include <mutex>

#include "block_tiles.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kTailThreads = 256;

// K rows of a streamed weight chunk at width C (all of a kernel's rows are
// resident at C <= 64).
__host__ __device__ constexpr int tail_kc(int C) { return C <= 64 ? C : C == 96 ? 96 : 64; }
// The products on wgmma (A from registers, the weight chunks loaded by TMA in
// the 128-byte swizzled layout wgmma reads): the streamed widths that are
// whole 64-column atoms, C = 128, 192, 256. The others run mma.sync from
// ldmatrix.
__host__ __device__ constexpr bool tail_wg(int C) { return C > 64 && C % 64 == 0; }
// Shared memory of T1's kernel `kind` (0: tail_conv_kernel, 1:
// tail_out_kernel) at width C: `windows` 10 x 18-pixel windows; at kind 0 t
// and conv at the 128 own pixels (conv over the window when `vx`); then the
// weights resident, or `slots` chunk slots of rows C + 8 bf16; under wgmma
// 64 bytes of ring barriers, then slots of KC x C bf16 from the next
// 1024-byte shared address (1 KB of slack).
__host__ __device__ constexpr int tail_smem(int C, int kind, int windows, bool vx, int slots) {
  return windows * align128(180 * (C + 8) * 2) +
         (kind == 0 ? (vx ? 1 : 2) * align128(128 * (C + 8) * 2) : 0) +
         (C <= 64  ? align128((kind == 0 ? 11 : 9) * C * (C + 8) * 2)
          : tail_wg(C) ? 64 + 1024 + slots * tail_kc(C) * C * 2
                       : slots * align128(tail_kc(C) * (C + 8) * 2));
}
// 256-thread CTAs an SM that `bytes` of shared memory allow (1 KB each kept
// by the runtime).
__host__ __device__ constexpr int tail_per_sm(int bytes) {
  return 2 * (bytes + 1024) <= kSmemPerSm ? 2 : 1;
}

// KIND 0: tail_conv_kernel (x, t -> y); KIND 1: tail_out_kernel (y -> out).
template <int C, int KIND>
struct TailCfg {
  static constexpr int TH = 8, TW = 16, P = TH * TW, WR = TH + 2, WC = TW + 2, R = WR * WC;
  static constexpr int NT = kTailThreads, NW = NT / 32;
  static constexpr bool RES = C <= 64;  // every weight resident
  static constexpr bool WG = tail_wg(C);
  static constexpr int KC = tail_kc(C), NCH = C / KC;  // K rows of a chunk, chunks a tap
  static constexpr int LD = C + 8;  // row stride (bf16) of activations and mma.sync weights
  static constexpr int KROWS = (KIND == 0 ? 11 : 9) * C;  // weight rows: taps (+ reduce)
  static constexpr int STEPS = KROWS / KC;                // streamed chunks a tile
  static constexpr int SZ_WIN = align128(R * LD * 2), SZ_PIX = align128(P * LD * 2);
  static constexpr int SZ_SLOT = WG ? KC * C * 2 : align128(KC * LD * 2);
  // conv over the dead x window only where t, conv and two slots do not fit
  // beside one window.
  static constexpr bool VX = KIND == 0 && tail_smem(C, KIND, 1, false, 2) > kSmemPerBlock;
  // three ring slots where they fit beside one window, else two.
  static constexpr int NS = RES ? 0 : tail_smem(C, KIND, 1, VX, 3) <= kSmemPerBlock ? 3 : 2;
  static constexpr int RING = NS > 0 ? NS : 1;
  // two windows where they fit without losing a CTA an SM.
  static constexpr int NXW = !VX && tail_smem(C, KIND, 2, VX, NS) <= kSmemPerBlock &&
                                     tail_per_sm(tail_smem(C, KIND, 2, VX, NS)) ==
                                         tail_per_sm(tail_smem(C, KIND, 1, VX, NS))
                                 ? 2 : 1;
  static constexpr int SMEM = tail_smem(C, KIND, NXW, VX, NS), MINB = tail_per_sm(SMEM);
  static constexpr int OFF_T = NXW * SZ_WIN;             // t (KIND 0)
  static constexpr int OFF_V = VX ? 0 : OFF_T + SZ_PIX;  // conv (KIND 0)
  static constexpr int OFF_W = KIND == 0 ? OFF_T + (VX ? 1 : 2) * SZ_PIX : NXW * SZ_WIN;
  // KIND 0 on cp.async: the step after whose barrier the next tile's window
  // may load into the one window (the first reduce step: conv's products are
  // done); with two windows, the tile's first step.
  static constexpr int S_WIN = NXW == 2 ? 0 : 9 * NCH;
  // warps: WGM x WGN blocks of WM x WN outputs, MT m16 and NT8 n8 tiles each
  // (under wgmma warp w holds tile row w of its warpgroup's 64 x C block).
  static constexpr int WGN = WG || C == 48 ? 1 : C <= 96 ? 2 : 4, WGM = NW / WGN;
  static constexpr int WN = C / WGN, MT = P / 16 / WGM, NT8 = WN / 8;
  static_assert(SMEM <= kSmemPerBlock, "T1 shared memory exceeds 227 KB");
  static_assert(C % KC == 0 && KC % 16 == 0 && WN % 16 == 0 && MT * 16 * WGM == P, "T1 geometry");
  static_assert(!WG || (MT == 1 && WGM == 8 && KC == 64), "T1 wgmma geometry");
  static_assert(WG || !VX, "conv over the window is laid out for the wgmma ring");
  static_assert(RES || WG || KIND == 1 || S_WIN <= STEPS - NS + 1,
                "the window lands after it is needed");
};

__device__ __forceinline__ float lrelu(float v) { return v >= 0.0f ? v : 0.2f * v; }

// acc += A [128 rows, K] @ B [K, C] on this warp's WM x WN block by mma.sync,
// K = KD. m-tile i's 16 rows start at A0 + i * mstride (row stride LD); B
// row k at B + k * LD.
template <class T, int KD>
__device__ __forceinline__ void chunk_mma(float (&acc)[T::MT][T::NT8][4], const bf16* A0,
                                          int mstride, const bf16* B, int lane, int wm,
                                          int wn) {
  const bf16* a_row = A0 + (wm * T::MT) * mstride + (lane & 15) * T::LD + (lane >> 4) * 8;
  const bf16* b_row = B + ((lane & 7) + ((lane >> 3) & 1) * 8) * T::LD + wn * T::WN +
                      (lane >> 4) * 8;
#pragma unroll
  for (int k = 0; k < KD; k += 16) {
    unsigned a[T::MT][4];
#pragma unroll
    for (int i = 0; i < T::MT; ++i) ldsm_x4(a[i], a_row + i * mstride + k);
#pragma unroll
    for (int j = 0; j < T::NT8 / 2; ++j) {
      unsigned b[4];
      ldsm_x4_t(b, b_row + k * T::LD + j * 16);
#pragma unroll
      for (int i = 0; i < T::MT; ++i) {
        mma16816(acc[i][2 * j], a[i], b[0], b[1]);
        mma16816(acc[i][2 * j + 1], a[i], b[2], b[3]);
      }
    }
  }
}

// acc += A [128 rows, KC] @ B [KC, C] on wgmma: warp w loads its 16 rows
// (tile row w, at A0 + w * mstride) as register fragments, its warpgroup
// multiplies them with the swizzled chunk at `slot` (C / 64 blocks of [KC
// rows][64 columns], 128 bytes a row: LBO = KC * 128 bytes between blocks,
// SBO = 1024 between 8-row atoms), one m64nCk16 per 16 K rows; returns when
// the products are done (the slot may then be refilled).
template <class T, int C>
__device__ __forceinline__ void chunk_wgmma(float (&acc)[T::MT][T::NT8][4], const bf16* A0,
                                            int mstride, const bf16* slot, int lane, int warp) {
  float(&d)[C / 2] = *reinterpret_cast<float(*)[C / 2]>(&acc[0][0][0]);
  const bf16* a_row = A0 + warp * mstride + (lane & 15) * T::LD + (lane >> 4) * 8;
  unsigned a[T::KC / 16][4];
#pragma unroll
  for (int k = 0; k < T::KC / 16; ++k) ldsm_x4(a[k], a_row + k * 16);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < T::KC / 16; ++k)
    wgmma_m64nk16_rs<C>(d, a[k], wgmma_desc_sw128(slot + k * 16 * 64, T::KC * 128, 1024), 1);
  wgmma_commit();
  wgmma_wait<0>(d);
}

template <class T>
__device__ __forceinline__ void zero_acc(float (&acc)[T::MT][T::NT8][4]) {
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

// f(p, n, v0, v1) for the output pixel p (0..127) and channels n, n + 1 of
// each pair the warp's accumulators hold.
template <class T, typename F>
__device__ __forceinline__ void acc_each(const float (&acc)[T::MT][T::NT8][4], int lane, int wm,
                                         int wn, F&& f) {
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT8; ++j) {
      const int p = (wm * T::MT + i) * 16 + lane / 4, n = wn * T::WN + j * 8 + 2 * (lane % 4);
      f(p, n, acc[i][j][0], acc[i][j][1]);
      f(p + 8, n, acc[i][j][2], acc[i][j][3]);
    }
}

// bf16 pair (a, b) rounded into global pixel p of the tile at (r0, c0) of
// image img ([H, W, C]), channels n, n + 1, if the pixel is inside.
template <int C>
__device__ __forceinline__ void store_own(bf16* img, int H, int W, int r0, int c0, int p, int n,
                                          float a, float b) {
  const int r = r0 + p / 16, c = c0 + p % 16;
  if (r < H && c < W) st_bf2(img + ((size_t)r * W + c) * C + n, a, b);
}

// The weight ring of a T1 kernel. Weights are one [KROWS][C] bf16 matrix
// (kernel 0: the 9 C tap rows, then wr1's C, then wr2's C; kernel 1: the
// taps), walked in chunks of KC rows, chunk g (of the CTA's walk) in slot
// g % NS. Under wgmma thread 0 loads a chunk by TMA (C / 64 boxes of 64
// columns x KC rows, 128-byte swizzle) on full[slot] and reuses a slot once
// the 8 warps have arrived on empty[slot]: no block barrier a step, and no
// load instructions on the warps that multiply. Under mma.sync every thread
// loads its share by cp.async, one commit group a step, and a block barrier
// a step hands the slot over.
template <class T, int C>
struct Ring {
  bf16* slots;
  uint64_t* full;   // wgmma: TMA landed (one arrival + the bytes)
  uint64_t* empty;  // wgmma: the 8 warps are done with the slot
  const bf16* w;
  const CUtensorMap* map;
  long long steps;  // chunks of the CTA's walk

  __device__ Ring(unsigned char* sm, const bf16* w_, const CUtensorMap* map_, long long steps_)
      : w(w_), map(map_), steps(steps_) {
    unsigned char* base = sm + T::OFF_W;
    if constexpr (T::WG) {
      full = reinterpret_cast<uint64_t*>(base);
      empty = full + T::NS;
      const unsigned a = smem_addr(base + 64);
      slots = reinterpret_cast<bf16*>(base + 64 + (1024u - a % 1024u) % 1024u);
    } else {
      full = empty = nullptr;
      slots = reinterpret_cast<bf16*>(base);
    }
  }
  __device__ bf16* slot(long long g) const {
    return slots + (int)(g % T::RING) * (T::SZ_SLOT / 2);
  }
  // Chunk h into its slot (wgmma: thread 0 only, after the slot's last
  // readers are done; mma.sync: every thread its share, uncommitted).
  __device__ void load(long long h) const {
    if (h >= steps) return;
    const int row = (int)(h % T::STEPS) * T::KC;
    if constexpr (T::WG) {
      if (threadIdx.x != 0) return;
      const int s = (int)(h % T::NS);
      if (h >= T::NS) mbar_wait(&empty[s], (unsigned)((h / T::NS - 1) & 1));
      mbar_expect_tx(&full[s], T::KC * C * 2);
#pragma unroll
      for (int j = 0; j < C / 64; ++j)
        tma_load_2d(slot(h) + j * T::KC * 64, map, j * 64, row, &full[s]);
    } else {
      load_rows_async<T::NT>(slot(h), T::LD, w + (size_t)row * C, C, T::KC, C, Same());
    }
  }
  // Before the first chunk: the barriers (wgmma) and chunks 0 .. NS - 2.
  __device__ void start() const {
    if constexpr (T::WG) {
      if (threadIdx.x == 0) {
        for (int s = 0; s < T::NS; ++s) {
          mbar_init(&full[s], 1);
          mbar_init(&empty[s], T::NW);
        }
        fence_mbar_init();
      }
      __syncthreads();
      for (int h = 0; h < T::NS - 1; ++h) load(h);
    } else {
      for (int h = 0; h < T::NS - 1; ++h) {
        load(h);
        cp_async_commit();
      }
    }
  }
  // Wait for chunk g (wgmma: its TMA; the caller has loaded chunk g + NS - 1
  // first).
  __device__ void wait(long long g) const {
    if constexpr (T::WG) mbar_wait(&full[g % T::NS], (unsigned)((g / T::NS) & 1));
  }
  // This warp is done with chunk g's slot.
  __device__ void release(long long g, int lane) const {
    if constexpr (T::WG) {
      if (lane == 0) mbar_arrive(&empty[g % T::NS]);
    }
  }
};

// tail_conv_kernel: y = conv @ wr1 + t @ wr2 + br, conv = lrelu(conv3x3(x) +
// bc) rounded to bf16, at every pixel of the call. w: [11 C][C] bf16 (taps,
// wr1, wr2), wmap its tensor map (wgmma widths).
template <int C>
__global__ void __launch_bounds__(kTailThreads, (TailCfg<C, 0>::MINB))
    tail_conv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ t,
                     const bf16* __restrict__ w, const float* __restrict__ bc,
                     const float* __restrict__ br, bf16* __restrict__ y, int H, int W,
                     int tiles_h, int tiles_w, long long total,
                     const __grid_constant__ CUtensorMap wmap) {
  using T = TailCfg<C, 0>;
  constexpr int NCH = T::NCH;
  unsigned char* sm = dyn_smem();
  bf16* const win0 = reinterpret_cast<bf16*>(sm);
  bf16* const win1 = reinterpret_cast<bf16*>(sm + (T::NXW == 2 ? T::SZ_WIN : 0));
  bf16* const ts = reinterpret_cast<bf16*>(sm + T::OFF_T);
  bf16* const vs = reinterpret_cast<bf16*>(sm + T::OFF_V);
  const long long first = total * blockIdx.x / gridDim.x;
  const long long last = total * (blockIdx.x + 1) / gridDim.x;
  const Ring<T, C> ring(sm, w, &wmap, (last - first) * T::STEPS);
  const int tid = threadIdx.x, lane = tid % 32, wm = tid / 32 / T::WGN, wn = tid / 32 % T::WGN;
  const size_t plane = (size_t)H * W * C;
  auto win = [&](long long L) { return T::NXW == 2 && ((L - first) & 1) ? win1 : win0; };
  auto load_win = [&](long long L) {
    const TilePos3 q = tile_pos<T::TH, T::TW>(L, tiles_h, tiles_w);
    load_window_async<C>(win(L), T::LD, T::R, x + q.b * plane, H, W, q.r0 - 1, q.c0 - 1, T::WR,
                         T::WC, tid, T::NT);
  };
  auto load_t = [&](long long L) {
    const TilePos3 q = tile_pos<T::TH, T::TW>(L, tiles_h, tiles_w);
    load_window_async<C>(ts, T::LD, T::P, t + q.b * plane, H, W, q.r0, q.c0, T::TH, T::TW, tid,
                         T::NT);
  };
  float acc[T::MT][T::NT8][4];
  auto product = [&](const bf16* A0, int mstride, const bf16* B) {
    if constexpr (T::WG)
      chunk_wgmma<T, C>(acc, A0, mstride, B, lane, wm);
    else
      chunk_mma<T, T::KC>(acc, A0, mstride, B, lane, wm, wn);
  };
  auto conv_epilogue = [&]() {
    acc_each<T>(acc, lane, wm, wn, [&](int p, int n, float v0, float v1) {
      const float2 b = __ldg(reinterpret_cast<const float2*>(bc + n));
      *reinterpret_cast<unsigned*>(vs + p * T::LD + n) = pack_bf2(lrelu(v0 + b.x), lrelu(v1 + b.y));
    });
  };
  auto y_epilogue = [&](const TilePos3& q) {
    bf16* img = y + q.b * plane;
    acc_each<T>(acc, lane, wm, wn, [&](int p, int n, float v0, float v1) {
      const float2 b = __ldg(reinterpret_cast<const float2*>(br + n));
      store_own<C>(img, H, W, q.r0, q.c0, p, n, v0 + b.x, v1 + b.y);
    });
  };
  // The A operand of streamed step s (base of m-tile 0, m-tile stride).
  auto a_of = [&](int s, const bf16* xs, int& mstride) -> const bf16* {
    const int k0 = (s % NCH) * T::KC;
    if (s < 9 * NCH) {
      const int tap = s / NCH;
      mstride = T::WC * T::LD;
      return xs + ((tap / 3) * T::WC + tap % 3) * T::LD + k0;
    }
    mstride = 16 * T::LD;
    return (s < 10 * NCH ? vs : ts) + k0;
  };

  if (first >= last) return;
  load_win(first);
  if constexpr (T::WG) cp_async_commit();
  if constexpr (T::RES) {
    load_rows_async<T::NT>(ring.slots, T::LD, w, C, 11 * C, C, Same());
    cp_async_commit();
  } else {
    ring.start();
  }
  for (long long L = first; L < last; ++L) {
    const TilePos3 q = tile_pos<T::TH, T::TW>(L, tiles_h, tiles_w);
    bf16* const xs = win(L);
    const long long g0 = (L - first) * T::STEPS;
    zero_acc<T>(acc);
    if constexpr (T::RES) {
      cp_async_wait<0>();
      __syncthreads();  // window L and the weights landed; tile L - 1 is done with every buffer
      load_t(L);
      cp_async_commit();
      if (T::NXW == 2 && L + 1 < last) load_win(L + 1);
      cp_async_commit();
      for (int tap = 0; tap < 9; ++tap)
        chunk_mma<T, C>(acc, xs + ((tap / 3) * T::WC + tap % 3) * T::LD, T::WC * T::LD,
                        ring.slots + tap * C * T::LD, lane, wm, wn);
      conv_epilogue();
      cp_async_wait<1>();
      __syncthreads();  // t landed, conv complete, every warp done with the window
      if (T::NXW == 1 && L + 1 < last) load_win(L + 1);
      cp_async_commit();
      zero_acc<T>(acc);
      chunk_mma<T, C>(acc, vs, 16 * T::LD, ring.slots + 9 * C * T::LD, lane, wm, wn);
      chunk_mma<T, C>(acc, ts, 16 * T::LD, ring.slots + 10 * C * T::LD, lane, wm, wn);
    } else if constexpr (T::WG) {
      cp_async_wait<0>();
      __syncthreads();  // window L landed; tile L - 1 is done with t, conv and its window
      load_t(L);
      if (T::NXW == 2 && L + 1 < last) load_win(L + 1);
      cp_async_commit();
      for (int s = 0; s < T::STEPS; ++s) {
        const long long g = g0 + s;
        if (s == 9 * NCH) {
          __syncthreads();  // every warp's conv products are done: the window is dead
          if (T::NXW == 1 && !T::VX && L + 1 < last) load_win(L + 1);
          cp_async_commit();
          conv_epilogue();
          zero_acc<T>(acc);
          cp_async_wait<1>();
          __syncthreads();  // conv complete (over the window at VX); t landed
        }
        if (T::VX && s == 10 * NCH) {
          __syncthreads();  // every warp is done with conv, kept over the window
          if (L + 1 < last) load_win(L + 1);
          cp_async_commit();
        }
        ring.load(g + T::NS - 1);
        ring.wait(g);
        int mstride;
        const bf16* A0 = a_of(s, xs, mstride);
        product(A0, mstride, ring.slot(g));
        ring.release(g, lane);
      }
    } else {
      for (int s = 0; s < T::STEPS; ++s) {
        const long long g = g0 + s;
        cp_async_wait<T::NS - 2>();
        __syncthreads();  // chunk g landed; every warp is done with step g - 1
        ring.load(g + T::NS - 1);
        if (s == 0) load_t(L);
        if (s == T::S_WIN && L + 1 < last) load_win(L + 1);
        cp_async_commit();
        if (s == 9 * NCH) {  // every warp is done with conv's products
          conv_epilogue();
          zero_acc<T>(acc);
          __syncthreads();  // conv complete
        }
        int mstride;
        const bf16* A0 = a_of(s, xs, mstride);
        product(A0, mstride, ring.slot(g));
      }
    }
    y_epilogue(q);
  }
}

// tail_out_kernel: out = lrelu(conv3x3(y) + bo) at every pixel of the call.
// w: [9 C][C] bf16 taps, wmap its tensor map (wgmma widths).
template <int C>
__global__ void __launch_bounds__(kTailThreads, (TailCfg<C, 1>::MINB))
    tail_out_kernel(const bf16* __restrict__ y, const bf16* __restrict__ w,
                    const float* __restrict__ bo, bf16* __restrict__ out, int H, int W,
                    int tiles_h, int tiles_w, long long total,
                    const __grid_constant__ CUtensorMap wmap) {
  using T = TailCfg<C, 1>;
  constexpr int NCH = T::NCH;
  unsigned char* sm = dyn_smem();
  bf16* const win0 = reinterpret_cast<bf16*>(sm);
  bf16* const win1 = reinterpret_cast<bf16*>(sm + (T::NXW == 2 ? T::SZ_WIN : 0));
  const long long first = total * blockIdx.x / gridDim.x;
  const long long last = total * (blockIdx.x + 1) / gridDim.x;
  const Ring<T, C> ring(sm, w, &wmap, (last - first) * T::STEPS);
  const int tid = threadIdx.x, lane = tid % 32, wm = tid / 32 / T::WGN, wn = tid / 32 % T::WGN;
  const size_t plane = (size_t)H * W * C;
  auto win = [&](long long L) { return T::NXW == 2 && ((L - first) & 1) ? win1 : win0; };
  auto load_win = [&](long long L) {
    const TilePos3 q = tile_pos<T::TH, T::TW>(L, tiles_h, tiles_w);
    load_window_async<C>(win(L), T::LD, T::R, y + q.b * plane, H, W, q.r0 - 1, q.c0 - 1, T::WR,
                         T::WC, tid, T::NT);
  };
  float acc[T::MT][T::NT8][4];
  auto product = [&](const bf16* A0, const bf16* B) {
    if constexpr (T::WG)
      chunk_wgmma<T, C>(acc, A0, T::WC * T::LD, B, lane, wm);
    else
      chunk_mma<T, T::KC>(acc, A0, T::WC * T::LD, B, lane, wm, wn);
  };
  auto out_epilogue = [&](const TilePos3& q) {
    bf16* img = out + q.b * plane;
    acc_each<T>(acc, lane, wm, wn, [&](int p, int n, float v0, float v1) {
      const float2 b = __ldg(reinterpret_cast<const float2*>(bo + n));
      store_own<C>(img, H, W, q.r0, q.c0, p, n, lrelu(v0 + b.x), lrelu(v1 + b.y));
    });
  };

  if (first >= last) return;
  load_win(first);
  if constexpr (T::WG) cp_async_commit();
  if constexpr (T::RES) {
    load_rows_async<T::NT>(ring.slots, T::LD, w, C, 9 * C, C, Same());
    cp_async_commit();
  } else {
    ring.start();
  }
  for (long long L = first; L < last; ++L) {
    const TilePos3 q = tile_pos<T::TH, T::TW>(L, tiles_h, tiles_w);
    bf16* const xs = win(L);
    const long long g0 = (L - first) * T::STEPS;
    zero_acc<T>(acc);
    if constexpr (T::RES) {
      cp_async_wait<0>();
      __syncthreads();  // window L landed; tile L - 1 is done with the other window
      if (T::NXW == 2 && L + 1 < last) load_win(L + 1);
      cp_async_commit();
      for (int tap = 0; tap < 9; ++tap)
        chunk_mma<T, C>(acc, xs + ((tap / 3) * T::WC + tap % 3) * T::LD, T::WC * T::LD,
                        ring.slots + tap * C * T::LD, lane, wm, wn);
    } else if constexpr (T::WG) {
      cp_async_wait<0>();
      __syncthreads();  // window L landed; tile L - 1 is done with the other window
      if (T::NXW == 2 && L + 1 < last) load_win(L + 1);
      cp_async_commit();
      for (int s = 0; s < T::STEPS; ++s) {
        const long long g = g0 + s;
        const int tap = s / NCH;
        ring.load(g + T::NS - 1);
        ring.wait(g);
        product(xs + ((tap / 3) * T::WC + tap % 3) * T::LD + (s % NCH) * T::KC, ring.slot(g));
        ring.release(g, lane);
      }
    } else {
      for (int s = 0; s < T::STEPS; ++s) {
        const long long g = g0 + s;
        // With one window, the tile's window was issued after the last tile's
        // products, outside the ring's groups: wait for everything.
        if (T::NXW == 1 && s == 0)
          cp_async_wait<0>();
        else
          cp_async_wait<T::NS - 2>();
        __syncthreads();  // chunk g landed; every warp is done with step g - 1
        ring.load(g + T::NS - 1);
        if (T::NXW == 2 && s == 0 && L + 1 < last) load_win(L + 1);
        cp_async_commit();
        const int tap = s / NCH;
        product(xs + ((tap / 3) * T::WC + tap % 3) * T::LD + (s % NCH) * T::KC, ring.slot(g));
      }
    }
    if (T::NXW == 1 && L + 1 < last) {
      __syncthreads();  // every warp is done with the window
      load_win(L + 1);
      cp_async_commit();
    }
    out_epilogue(q);
  }
}

// w [rows][C] bf16 as a 2-D tensor map of 64-column x 64-row boxes, 128-byte
// swizzle (the layout chunk_wgmma reads). The last few maps are kept: the
// wrapper hands the same weights again.
bool tail_map(CUtensorMap* map, const void* w, int rows, int C) {
  struct Entry {
    const void* w;
    int rows, C;
    CUtensorMap map;
  };
  static std::mutex mu;
  static Entry cache[16] = {};
  static int next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache)
    if (e.w == w && e.rows == rows && e.C == C) {
      *map = e.map;
      return true;
    }
  TmaEncodeTiled fn = tma_encoder();
  if (!fn || w == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)C * 2};
  const cuuint32_t box[2] = {64, 64}, unit[2] = {1, 1};
  if (fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w), dims, strides, box, unit,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  cache[next] = {w, rows, C, *map};
  next = (next + 1) % 16;
  return true;
}

template <int C>
cudaError_t tail_run(const void* const* p, void* ybuf, void* out, int B, int H, int W,
                     int grid1, int grid2, cudaStream_t s) {
  using T0 = TailCfg<C, 0>;
  using T1 = TailCfg<C, 1>;
  const int th = cdiv(H, T0::TH), tw = cdiv(W, T0::TW);
  const long long total = (long long)B * th * tw;
  const int g1 = apply_grid(tail_conv_kernel<C>, T0::NT, T0::SMEM, total, grid1);
  const int g2 = apply_grid(tail_out_kernel<C>, T1::NT, T1::SMEM, total, grid2);
  if (g1 < 1 || g2 < 1)
    return grid1 > 0 || grid2 > 0 ? cudaErrorInvalidValue : cudaErrorInvalidConfiguration;
  CUtensorMap m1 = {}, m2 = {};
  if (tail_wg(C) && (!tail_map(&m1, p[2], 11 * C, C) || !tail_map(&m2, p[5], 9 * C, C)))
    return cudaErrorInvalidValue;
  cudaError_t err = launch(tail_conv_kernel<C>, dim3(g1), dim3(T0::NT), T0::SMEM, s,
                           (const bf16*)p[0], (const bf16*)p[1], (const bf16*)p[2],
                           (const float*)p[3], (const float*)p[4], (bf16*)ybuf, H, W, th, tw,
                           total, m1);
  if (err != cudaSuccess) return err;
  return launch(tail_out_kernel<C>, dim3(g2), dim3(T1::NT), T1::SMEM, s, (const bf16*)ybuf,
                (const bf16*)p[5], (const float*)p[6], (bf16*)out, H, W, th, tw, total, m2);
}

// One kernel's plan: TH, TW, threads, shared-memory bytes, blocks per SM
// (the occupancy API's), weights resident (1) or streamed (0), K rows a
// chunk, ring slots, windows, conv over the window (1) or not (0), products
// on wgmma (1) or mma.sync (0).
template <int C, int KIND, typename Kernel>
cudaError_t tail_info(Kernel kernel, long long* info) {
  using T = TailCfg<C, KIND>;
  info[0] = T::TH, info[1] = T::TW, info[2] = T::NT, info[3] = T::SMEM;
  info[4] = blocks_per_sm(kernel, T::NT, T::SMEM);
  info[5] = T::RES, info[6] = T::KC, info[7] = T::NS, info[8] = T::NXW, info[9] = T::VX;
  info[10] = T::WG;
  return info[4] > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

}  // namespace

// x, t [B,H,W,C] bf16; w1 [11 C][C] bf16 (conv's taps, tap di*3+dj then in,
// then the reduce weight's conv half wr1 and t half wr2, each [in][out]);
// bc, br [C] fp32; w2 [9 C][C] bf16 (Conv_out's taps); bo [C] fp32; ybuf
// [B,H,W,C] bf16 scratch -> out [B,H,W,C] bf16. grid1 / grid2: the two
// kernels' CTAs (<= 0: as many as are resident, at most one per tile).
extern "C" int blle_stage_tail(const void* x, const void* t, const void* w1, const void* bc,
                               const void* br, const void* w2, const void* bo, void* ybuf,
                               void* out, int B, int H, int W, int C, int grid1, int grid2,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const void* p[7] = {x, t, w1, bc, br, w2, bo};
  switch (C) {
#define BLLE_TAIL(c) \
  case c: return (int)tail_run<c>(p, ybuf, out, B, H, W, grid1, grid2, s);
    BLLE_WIDTHS(BLLE_TAIL)
#undef BLLE_TAIL
    default: return (int)cudaErrorInvalidValue;
  }
}

// kind 0: tail_conv_kernel, 1: tail_out_kernel -> info[11] as tail_info.
extern "C" int blle_stage_tail_info(int kind, int C, long long* info) {
  switch (C) {
#define BLLE_TAIL_INFO(c)                                                            \
  case c:                                                                            \
    return (int)(kind == 0 ? tail_info<c, 0>(tail_conv_kernel<c>, info)              \
                           : kind == 1 ? tail_info<c, 1>(tail_out_kernel<c>, info)   \
                                       : cudaErrorInvalidValue);
    BLLE_WIDTHS(BLLE_TAIL_INFO)
#undef BLLE_TAIL_INFO
    default: return (int)cudaErrorInvalidValue;
  }
}
