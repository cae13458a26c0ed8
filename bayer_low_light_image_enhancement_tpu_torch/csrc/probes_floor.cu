// P, the floor ladder: stripped copies of the apply pass's window structure
// (K3's tile geometry at C = 32: TW = 8 columns, a 2-pixel halo), timed to
// find what moving the windows costs and what each layer of work adds.
// Port of the TPU probes `benchmarks/probe_floor.py` (p0-p3),
// `benchmarks/exp_dma_floor.py` (blocked3 / blocked1 / dma at levels c, m, v)
// and `benchmarks/exp_dma_bw.py` (buffer count, tile height).
//
// Load strategies (STRAT):
//   0 plain   one tile per block, thread loads of the whole (TH+4)x(TW+4)
//             window, as K3 loads it (blocked3's counterpart);
//   1 center  one tile per block, only the TH x TW own pixels loaded, the
//             halo left zero: not a valid result at level v, a yardstick of
//             movement like blocked1;
//   2 async   a persistent grid, each CTA walking a contiguous run of tiles
//             in strip order with a double-buffered cp.async window ring
//             (dma's counterpart, K3P's load);
//   3 async4  the same with four buffers, three windows in flight (--nbuf 4);
//   4 tma     a persistent grid whose windows come by TMA, the H100's
//             counterpart of the TPU copy engine that `dma` drives: each
//             window one box of a 4-D tensor map over x [B, H, W, C] (the
//             halo past the image arrives as zeros), a ring of four slots
//             on full / empty mbarriers, one producer thread in a ninth
//             warp issuing every window of the CTA's walk while the other
//             eight warps do the level's work (windows stored dense, C
//             channels a pixel).
// Levels (LEVEL):
//   0 c  copy the own pixels out;
//   1 m  6 chained [pixels, C] x [C, C] WMMA products over the window;
//   2 v  probe_floor's p3 mix: product -> dw3x3 -> 3 products -> dw3x3 ->
//        exact GELU -> 2 products (ring pixels outside the image zeroed
//        after the first dw3x3, so the result is the whole-image chain with
//        zero padding).
// Tile heights TH in {4, 8, 16} (--th). Products bias-free, dw taps [9][C]
// fp32, intermediates rounded to bf16.
#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kFC = 32, kFTW = 8;

template <int TH>
struct FloorCfg {
  static constexpr int WR = TH + 4, WC = kFTW + 4;
  static constexpr int NWIN = WR * WC, NWIN_P = round16(NWIN);
  static constexpr int R1C = kFTW + 2, NR1 = (TH + 2) * R1C, NR1_P = round16(NR1);
  static constexpr int NPIX = TH * kFTW;
  static constexpr int LDB = kFC + 8, LDF = kFC + 4;
  static constexpr int SZ_WIN = align128(NWIN_P * LDB * 2);  // each window buffer
  static constexpr int SZ_R = align128(NR1_P * LDB * 2);     // ring-sized bf16
  static constexpr int SZ_Z = align128(NWIN_P * LDF * 4);    // fp32 product
  // After the window buffers: a window-sized bf16 buffer, a ring-sized one,
  // the fp32 product.
  static constexpr int work_bytes(int level) {
    return level == 0 ? 0 : SZ_WIN + SZ_R + SZ_Z;
  }
};

// Own pixels only (the `center` strategy): window pixel (wr, wc) is loaded
// when 2 <= wr < TH+2 and 2 <= wc < TW+2, zero elsewhere.
template <int TH>
__device__ void load_center(bf16* dst, const bf16* __restrict__ img, int H, int W, int r0,
                            int c0) {
  using F = FloorCfg<TH>;
  constexpr int U = kFC / 8;
  for (int e = threadIdx.x; e < F::NWIN_P * U; e += kThreads) {
    const int p = e / U, part = e % U;
    const int wr = p / F::WC, wc = p % F::WC;
    const int gr = r0 - 2 + wr, gc = c0 - 2 + wc;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (p < F::NWIN && wr >= 2 && wr < TH + 2 && wc >= 2 && wc < kFTW + 2 &&
        inside(gr, gc, H, W))
      val = *reinterpret_cast<const uint4*>(img + ((size_t)gr * W + gc) * kFC + part * 8);
    *reinterpret_cast<uint4*>(dst + p * F::LDB + part * 8) = val;
  }
}

// out[M][C] (bf16, stride LDB) = round(z[M][C]) (fp32, stride LDF).
template <int M, int LDB, int LDF>
__device__ void to_bf16(const float* z, bf16* out) {
  for (int e = threadIdx.x; e < M * kFC; e += kThreads)
    out[(e / kFC) * LDB + e % kFC] = f2bf(z[(e / kFC) * LDF + e % kFC]);
}

// A barrier of the kThreads threads that do a tile's work: the whole block,
// or (NAMED, the `tma` strategy) named barrier 1 without the producer warp.
template <bool NAMED>
__device__ __forceinline__ void tile_sync() {
  if constexpr (NAMED)
    bar_sync(1, kThreads);
  else
    __syncthreads();
}

// One tile's work on its window xs (row stride LDW; the window buffer may be
// overwritten), by threads 0 .. kThreads - 1.
template <int LEVEL, int TH, int LDW, bool NAMED>
__device__ void floor_tile(bf16* xs, unsigned char* work, const bf16* __restrict__ w,
                           const float* __restrict__ dw, bf16* __restrict__ out, int b, int r0,
                           int c0, int H, int W) {
  using F = FloorCfg<TH>;
  auto sync = [] { tile_sync<NAMED>(); };
  auto put = [&](int p, int n, float val) {
    const int i = p / kFTW, j = p % kFTW;
    if (inside(r0 + i, c0 + j, H, W))
      out[(((size_t)b * H + r0 + i) * W + c0 + j) * kFC + n] = f2bf(val);
  };
  if constexpr (LEVEL == 0) {
    for (int e = threadIdx.x; e < F::NPIX * kFC; e += kThreads) {
      const int p = e / kFC, n = e % kFC;
      put(p, n, bf2f(xs[((p / kFTW + 2) * F::WC + p % kFTW + 2) * LDW + n]));
    }
    return;
  }
  bf16* a = reinterpret_cast<bf16*>(work);
  bf16* r = reinterpret_cast<bf16*>(work + F::SZ_WIN);
  float* z = reinterpret_cast<float*>(work + F::SZ_WIN + F::SZ_R);
  if constexpr (LEVEL == 1) {
    const bf16* cur = xs;
    int ld = LDW;
    for (int step = 0; step < 6; ++step) {
      gemm_bf16<F::NWIN_P, kFC, kFC>(cur, ld, w, kFC, z, F::LDF);
      sync();
      if (step < 5) {
        to_bf16<F::NWIN_P, F::LDB, F::LDF>(z, a);
        cur = a, ld = F::LDB;
        sync();
      }
    }
    for (int e = threadIdx.x; e < F::NPIX * kFC; e += kThreads) {
      const int p = e / kFC, n = e % kFC;
      put(p, n, z[((p / kFTW + 2) * F::WC + p % kFTW + 2) * F::LDF + n]);
    }
    return;
  }
  // LEVEL 2: product over the window, dw3x3 to the ring (zero outside the
  // image), 3 products over the ring, dw3x3 to the own pixels, GELU, 2
  // products.
  gemm_bf16<F::NWIN_P, kFC, kFC>(xs, LDW, w, kFC, z, F::LDF);
  sync();
  to_bf16<F::NWIN_P, F::LDB, F::LDF>(z, a);
  sync();
  for (int e = threadIdx.x; e < F::NR1_P * kFC; e += kThreads) {
    const int p = e / kFC, n = e % kFC;
    const int i1 = p / F::R1C, j1 = p % F::R1C;
    float acc = 0.0f;
    if (p < F::NR1 && inside(r0 - 1 + i1, c0 - 1 + j1, H, W))
      for (int di = 0; di < 3; ++di)
        for (int dj = 0; dj < 3; ++dj)
          acc += bf2f(a[((i1 + di) * F::WC + j1 + dj) * F::LDB + n]) * dw[(di * 3 + dj) * kFC + n];
    r[p * F::LDB + n] = f2bf(acc);
  }
  sync();
  for (int step = 0; step < 3; ++step) {
    gemm_bf16<F::NR1_P, kFC, kFC>(r, F::LDB, w, kFC, z, F::LDF);
    sync();
    to_bf16<F::NR1_P, F::LDB, F::LDF>(z, r);
    sync();
  }
  for (int e = threadIdx.x; e < F::NPIX * kFC; e += kThreads) {
    const int p = e / kFC, n = e % kFC;
    const int i = p / kFTW, j = p % kFTW;
    float acc = 0.0f;
    for (int di = 0; di < 3; ++di)
      for (int dj = 0; dj < 3; ++dj)
        acc += bf2f(r[((i + di) * F::R1C + j + dj) * F::LDB + n]) * dw[(di * 3 + dj) * kFC + n];
    a[p * F::LDB + n] = f2bf(0.5f * acc * (1.0f + erff(acc * 0.70710678118654752f)));
  }
  sync();
  gemm_bf16<F::NPIX, kFC, kFC>(a, F::LDB, w, kFC, z, F::LDF);
  sync();
  to_bf16<F::NPIX, F::LDB, F::LDF>(z, a);
  sync();
  gemm_bf16<F::NPIX, kFC, kFC>(a, F::LDB, w, kFC, z, F::LDF);
  sync();
  for (int e = threadIdx.x; e < F::NPIX * kFC; e += kThreads)
    put(e / kFC, e % kFC, z[(e / kFC) * F::LDF + e % kFC]);
}

template <int STRAT, int LEVEL, int TH>
__global__ void __launch_bounds__(kThreads) floor_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w, const float* __restrict__ dw,
    bf16* __restrict__ out, int H, int W, int tiles_h, int tiles_w, long long total) {
  using F = FloorCfg<TH>;
  constexpr int NBUF = STRAT == 3 ? 4 : STRAT == 2 ? 2 : 1;
  unsigned char* sm = dyn_smem();
  unsigned char* work = sm + NBUF * F::SZ_WIN;
  auto tile_of = [&](long long L, int& b, int& r0, int& c0) {
    const long long strip = L / tiles_h;
    b = (int)(strip / tiles_w);
    r0 = (int)(L % tiles_h) * TH;
    c0 = (int)(strip % tiles_w) * kFTW;
  };
  int b, r0, c0;
  if constexpr (STRAT <= 1) {
    bf16* xs = reinterpret_cast<bf16*>(sm);
    tile_of(blockIdx.x, b, r0, c0);
    const bf16* img = x + (size_t)b * H * W * kFC;
    if constexpr (STRAT == 0)
      load_window<kFC>(xs, F::LDB, F::NWIN_P, img, H, W, r0 - 2, c0 - 2, F::WR, F::WC);
    else
      load_center<TH>(xs, img, H, W, r0, c0);
    __syncthreads();
    floor_tile<LEVEL, TH, F::LDB, false>(xs, work, w, dw, out, b, r0, c0, H, W);
  } else {
    const long long first = total * blockIdx.x / gridDim.x;
    const int n = (int)(total * (blockIdx.x + 1) / gridDim.x - first);
    auto issue = [&](int k) {
      if (k < n) {
        int bb, rr, cc;
        tile_of(first + k, bb, rr, cc);
        load_window_async<kFC>(reinterpret_cast<bf16*>(sm + (k % NBUF) * F::SZ_WIN), F::LDB,
                               F::NWIN_P, x + (size_t)bb * H * W * kFC, H, W, rr - 2, cc - 2,
                               F::WR, F::WC, threadIdx.x, kThreads);
      }
      cp_async_commit();  // an empty group past the end keeps the count uniform
    };
    for (int k = 0; k < NBUF - 1; ++k) issue(k);
    for (int k = 0; k < n; ++k) {
      issue(k + NBUF - 1);
      cp_async_wait<NBUF - 1>();
      __syncthreads();
      tile_of(first + k, b, r0, c0);
      floor_tile<LEVEL, TH, F::LDB, false>(reinterpret_cast<bf16*>(sm + (k % NBUF) * F::SZ_WIN),
                                           work, w, dw, out, b, r0, c0, H, W);
      __syncthreads();
    }
  }
}

// The `tma` strategy: warps 0-7 do the tiles' work, lane 0 of warp 8 is the
// producer. Slot s of the ring is full[s]'s (one arrival and the box's bytes)
// and empty[s]'s (one arrival a working warp) once a walk round.
constexpr int kTmaSlots = 4;

template <int TH>
struct TmaCfg {
  static constexpr int BOX = FloorCfg<TH>::NWIN * kFC * 2;  // one dense window
  static constexpr int SLOT = align128(BOX), OFF_SLOTS = 128;
  static constexpr int bytes(int level) {
    return OFF_SLOTS + kTmaSlots * SLOT + FloorCfg<TH>::work_bytes(level);
  }
  static_assert(FloorCfg<TH>::NWIN_P == FloorCfg<TH>::NWIN, "the box fills the padded rows");
};

template <int LEVEL, int TH>
__global__ void __launch_bounds__(kThreads + 32) floor_tma_kernel(
    const bf16* __restrict__ w, const float* __restrict__ dw, bf16* __restrict__ out, int H,
    int W, int tiles_h, int tiles_w, long long total, const __grid_constant__ CUtensorMap xmap) {
  using T = TmaCfg<TH>;
  constexpr int NS = kTmaSlots;
  unsigned char* sm = dyn_smem();
  uint64_t* const full = reinterpret_cast<uint64_t*>(sm);
  uint64_t* const empty = full + NS;
  unsigned char* const work = sm + T::OFF_SLOTS + NS * T::SLOT;
  auto slot = [&](int k) { return sm + T::OFF_SLOTS + (k % NS) * T::SLOT; };
  const long long first = total * blockIdx.x / gridDim.x;
  const int n = (int)(total * (blockIdx.x + 1) / gridDim.x - first);
  auto tile_of = [&](int k, int& b, int& r0, int& c0) {
    const long long L = first + k, strip = L / tiles_h;
    b = (int)(strip / tiles_w);
    r0 = (int)(L % tiles_h) * TH;
    c0 = (int)(strip % tiles_w) * kFTW;
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    fence_mbar_init();
  }
  __syncthreads();
  int b, r0, c0;
  if (threadIdx.x >= kThreads) {  // the producer warp
    if (threadIdx.x == kThreads) {
      for (int k = 0; k < n; ++k) {
        const int s = k % NS;
        if (k >= NS) mbar_wait(&empty[s], (unsigned)((k / NS - 1) & 1));
        tile_of(k, b, r0, c0);
        mbar_expect_tx(&full[s], T::BOX);
        tma_load_4d(slot(k), &xmap, 0, c0 - 2, r0 - 2, b, &full[s]);
      }
    }
    return;
  }
  for (int k = 0; k < n; ++k) {
    mbar_wait(&full[k % NS], (unsigned)((k / NS) & 1));
    tile_of(k, b, r0, c0);
    floor_tile<LEVEL, TH, kFC, true>(reinterpret_cast<bf16*>(slot(k)), work, w, dw, out, b, r0,
                                     c0, H, W);
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(&empty[k % NS]);  // this warp is done with the slot
    if constexpr (LEVEL > 0) tile_sync<true>();  // the work buffers are free again
  }
}

// x [B, H, W, kFC] bf16 as a 4-D tensor map (channels innermost) whose box is
// one (TH + 4) x (kFTW + 4) window.
bool floor_map(CUtensorMap* map, const void* x, int B, int H, int W, int th) {
  TmaEncodeTiled fn = tma_encoder();
  if (!fn) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)kFC, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)kFC * 2, (cuuint64_t)W * kFC * 2,
                                 (cuuint64_t)H * W * kFC * 2};
  const cuuint32_t box[4] = {kFC, kFTW + 4, (cuuint32_t)th + 4, 1}, unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The persistent grid of a floor kernel: as many CTAs as are resident, at
// most one per tile; 0 on error.
template <typename Kernel>
long long floor_grid(Kernel kernel, int threads, int smem, long long total) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
          cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
          cudaSuccess)
    return 0;
  return total < (long long)sms * per_sm ? total : (long long)sms * per_sm;
}

template <int LEVEL, int TH>
cudaError_t floor_tma_launch(const void* x, const void* w, const void* dw, void* out, int B,
                             int H, int W, cudaStream_t s) {
  const int smem = TmaCfg<TH>::bytes(LEVEL);
  auto kernel = floor_tma_kernel<LEVEL, TH>;
  const int tiles_h = cdiv(H, TH), tiles_w = cdiv(W, kFTW);
  const long long total = (long long)B * tiles_h * tiles_w;
  const long long grid = floor_grid(kernel, kThreads + 32, smem, total);
  if (grid < 1) return cudaErrorInvalidConfiguration;
  CUtensorMap map;
  if (!floor_map(&map, x, B, H, W, TH)) return cudaErrorInvalidValue;
  return launch(kernel, dim3((unsigned)grid), dim3(kThreads + 32), smem, s, (const bf16*)w,
                (const float*)dw, (bf16*)out, H, W, tiles_h, tiles_w, total, map);
}

template <int STRAT, int LEVEL, int TH>
cudaError_t floor_launch(const void* x, const void* w, const void* dw, void* out, int B, int H,
                         int W, cudaStream_t s) {
  using F = FloorCfg<TH>;
  constexpr int NBUF = STRAT == 3 ? 4 : STRAT == 2 ? 2 : 1;
  const int smem = NBUF * F::SZ_WIN + F::work_bytes(LEVEL);
  auto kernel = floor_kernel<STRAT, LEVEL, TH>;
  const int tiles_h = cdiv(H, TH), tiles_w = cdiv(W, kFTW);
  const long long total = (long long)B * tiles_h * tiles_w;
  const long long grid = STRAT >= 2 ? floor_grid(kernel, kThreads, smem, total) : total;
  if (grid < 1) return cudaErrorInvalidConfiguration;
  return launch(kernel, dim3((unsigned)grid), dim3(kThreads), smem, s, (const bf16*)x,
                (const bf16*)w, (const float*)dw, (bf16*)out, H, W, tiles_h, tiles_w, total);
}

template <int STRAT, int LEVEL>
cudaError_t floor_th(const void* x, const void* w, const void* dw, void* out, int B, int H,
                     int W, int th, cudaStream_t s) {
  if constexpr (STRAT == 4) {
    switch (th) {
      case 4: return floor_tma_launch<LEVEL, 4>(x, w, dw, out, B, H, W, s);
      case 8: return floor_tma_launch<LEVEL, 8>(x, w, dw, out, B, H, W, s);
      case 16: return floor_tma_launch<LEVEL, 16>(x, w, dw, out, B, H, W, s);
      default: return cudaErrorInvalidValue;
    }
  } else {
    switch (th) {
      case 4: return floor_launch<STRAT, LEVEL, 4>(x, w, dw, out, B, H, W, s);
      case 8: return floor_launch<STRAT, LEVEL, 8>(x, w, dw, out, B, H, W, s);
      case 16: return floor_launch<STRAT, LEVEL, 16>(x, w, dw, out, B, H, W, s);
      default: return cudaErrorInvalidValue;
    }
  }
}

template <int STRAT>
cudaError_t floor_level(const void* x, const void* w, const void* dw, void* out, int B, int H,
                        int W, int level, int th, cudaStream_t s) {
  switch (level) {
    case 0: return floor_th<STRAT, 0>(x, w, dw, out, B, H, W, th, s);
    case 1: return floor_th<STRAT, 1>(x, w, dw, out, B, H, W, th, s);
    case 2: return floor_th<STRAT, 2>(x, w, dw, out, B, H, W, th, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [B,H,W,32] bf16, w [32,32] bf16, dw [9,32] fp32 -> out [B,H,W,32] bf16;
// strategy 0-4 (plain, center, async, async4, tma), level 0-2 (c, m, v), th in
// {4, 8, 16}.
extern "C" int blle_probe_floor(const void* x, const void* w, const void* dw, void* out, int B,
                                int H, int W, int C, int strategy, int level, int th,
                                void* stream) {
  if (C != kFC) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (strategy) {
    case 0: return (int)floor_level<0>(x, w, dw, out, B, H, W, level, th, s);
    case 1: return (int)floor_level<1>(x, w, dw, out, B, H, W, level, th, s);
    case 2: return (int)floor_level<2>(x, w, dw, out, B, H, W, level, th, s);
    case 3: return (int)floor_level<3>(x, w, dw, out, B, H, W, level, th, s);
    case 4: return (int)floor_level<4>(x, w, dw, out, B, H, W, level, th, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
