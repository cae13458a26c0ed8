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
//   3 async4  the same with four buffers, three windows in flight (--nbuf 4).
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

// One tile's work on its window xs (the window buffer may be overwritten).
template <int LEVEL, int TH>
__device__ void floor_tile(bf16* xs, unsigned char* work, const bf16* __restrict__ w,
                           const float* __restrict__ dw, bf16* __restrict__ out, int b, int r0,
                           int c0, int H, int W) {
  using F = FloorCfg<TH>;
  auto put = [&](int p, int n, float val) {
    const int i = p / kFTW, j = p % kFTW;
    if (inside(r0 + i, c0 + j, H, W))
      out[(((size_t)b * H + r0 + i) * W + c0 + j) * kFC + n] = f2bf(val);
  };
  if constexpr (LEVEL == 0) {
    for (int e = threadIdx.x; e < F::NPIX * kFC; e += kThreads) {
      const int p = e / kFC, n = e % kFC;
      put(p, n, bf2f(xs[((p / kFTW + 2) * F::WC + p % kFTW + 2) * F::LDB + n]));
    }
    return;
  }
  bf16* a = reinterpret_cast<bf16*>(work);
  bf16* r = reinterpret_cast<bf16*>(work + F::SZ_WIN);
  float* z = reinterpret_cast<float*>(work + F::SZ_WIN + F::SZ_R);
  if constexpr (LEVEL == 1) {
    const bf16* cur = xs;
    for (int step = 0; step < 6; ++step) {
      gemm_bf16<F::NWIN_P, kFC, kFC>(cur, F::LDB, w, kFC, z, F::LDF);
      __syncthreads();
      if (step < 5) {
        to_bf16<F::NWIN_P, F::LDB, F::LDF>(z, a);
        cur = a;
        __syncthreads();
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
  gemm_bf16<F::NWIN_P, kFC, kFC>(xs, F::LDB, w, kFC, z, F::LDF);
  __syncthreads();
  to_bf16<F::NWIN_P, F::LDB, F::LDF>(z, a);
  __syncthreads();
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
  __syncthreads();
  for (int step = 0; step < 3; ++step) {
    gemm_bf16<F::NR1_P, kFC, kFC>(r, F::LDB, w, kFC, z, F::LDF);
    __syncthreads();
    to_bf16<F::NR1_P, F::LDB, F::LDF>(z, r);
    __syncthreads();
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
  __syncthreads();
  gemm_bf16<F::NPIX, kFC, kFC>(a, F::LDB, w, kFC, z, F::LDF);
  __syncthreads();
  to_bf16<F::NPIX, F::LDB, F::LDF>(z, a);
  __syncthreads();
  gemm_bf16<F::NPIX, kFC, kFC>(a, F::LDB, w, kFC, z, F::LDF);
  __syncthreads();
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
    floor_tile<LEVEL, TH>(xs, work, w, dw, out, b, r0, c0, H, W);
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
      floor_tile<LEVEL, TH>(reinterpret_cast<bf16*>(sm + (k % NBUF) * F::SZ_WIN), work, w, dw,
                            out, b, r0, c0, H, W);
      __syncthreads();
    }
  }
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
  long long grid = total;
  if (STRAT >= 2) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           smem);
    int dev = 0, sms = 0, per_sm = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    grid = total < (long long)sms * per_sm ? total : (long long)sms * per_sm;
  }
  return launch(kernel, dim3((unsigned)grid), dim3(kThreads), smem, s, (const bf16*)x,
                (const bf16*)w, (const float*)dw, (bf16*)out, H, W, tiles_h, tiles_w, total);
}

template <int STRAT, int LEVEL>
cudaError_t floor_th(const void* x, const void* w, const void* dw, void* out, int B, int H,
                     int W, int th, cudaStream_t s) {
  switch (th) {
    case 4: return floor_launch<STRAT, LEVEL, 4>(x, w, dw, out, B, H, W, s);
    case 8: return floor_launch<STRAT, LEVEL, 8>(x, w, dw, out, B, H, W, s);
    case 16: return floor_launch<STRAT, LEVEL, 16>(x, w, dw, out, B, H, W, s);
    default: return cudaErrorInvalidValue;
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
// strategy 0-3 (plain, center, async, async4), level 0-2 (c, m, v), th in
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
    default: return (int)cudaErrorInvalidValue;
  }
}
