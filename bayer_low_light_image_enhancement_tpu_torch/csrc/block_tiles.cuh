// The tiled passes of the fused TransformerBlock forward, K2 (gram) and K3
// (apply + FFN), as templates shared by the translation units that
// instantiate them: fused_block.cu (the production K2 and K3),
// fused_attention.cu (A1's gram pass: K2 without the LayerNorm) and
// probes_bisect.cu (K3 cut after an earlier stage). See fused_block.cu for
// what the passes compute and why they are shaped so.
#ifndef BLLE_BLOCK_TILES_CUH
#define BLLE_BLOCK_TILES_CUH

#include "common.cuh"

using namespace nvcuda;

namespace {

// Shared-memory plan of pass A (gram), 8x8 tiles with a 1-pixel halo.
template <int C>
struct GramCfg {
  static constexpr int TH = 8, TW = 8, C2 = 2 * C;
  static constexpr int KCH = C % 32 == 0 ? 32 : 16;  // 1x1 output chunk
  static constexpr int WR = TH + 2, WC = TW + 2;
  static constexpr int NWIN = WR * WC, NWIN_P = round16(NWIN);
  static constexpr int NPIX = TH * TW;
  static constexpr int LDX = C + 8, LDZ = KCH + 4, LDQ = C2 + 8;
  static constexpr int OFF_Z = align128(NWIN_P * LDX * 2);
  static constexpr int OFF_Q = OFF_Z + align128(NWIN_P * LDZ * 4);
  static constexpr int SMEM = OFF_Q + align128(NPIX * LDQ * 2);
};

// Shared-memory plan of pass B (apply + FFN), tiles with a 2-pixel halo.
// Four regions, reused across phases:
//   A: x window -> LN1 (bf16) | LN2(y) (bf16) | FFN output o (fp32)
//   B: 1x1 output chunk of v or of the FFN hidden layer (fp32)
//   Cr: v at the 1-pixel ring (bf16) | GELU output f (bf16)
//   D: attention output, then y, at the 1-pixel ring (fp32)
template <int C>
struct ApplyCfg {
  static constexpr int TH = C > 64 ? 4 : 8, TW = 8, CH = 2 * C;
  static constexpr int KCH = C % 32 == 0 ? 32 : 16;
  static constexpr int WR = TH + 4, WC = TW + 4;
  static constexpr int NWIN = WR * WC, NWIN_P = round16(NWIN);
  static constexpr int R1R = TH + 2, R1C = TW + 2;
  static constexpr int NR1 = R1R * R1C, NR1_P = round16(NR1);
  static constexpr int NPIX = TH * TW;
  static constexpr int LDB = C + 8, LDF = C + 4, LDK = KCH + 4, LDH = CH + 8;
  static constexpr int SZ_A = align128(
      cmax(cmax(NWIN_P * LDB * 2, NR1_P * LDB * 2), NPIX * LDF * 4));
  static constexpr int SZ_B = align128(cmax(NWIN_P * LDK * 4, NR1_P * LDK * 4));
  static constexpr int SZ_C = align128(cmax(NR1_P * LDB * 2, NPIX * LDH * 2));
  static constexpr int SZ_D = align128(NR1_P * LDF * 4);
  static constexpr int OFF_B = SZ_A, OFF_C = OFF_B + SZ_B, OFF_D = OFF_C + SZ_C;
  static constexpr int SMEM = OFF_D + SZ_D;
};

// ---------------------------------------------------------------------------
// K2, pass A: per-tile partial gram [C*C] and sums of squares [2C]. With LN
// false the 1x1 reads x itself (A1, the standalone channel attention).
// ---------------------------------------------------------------------------
template <int C, bool LN>
__global__ void __launch_bounds__(kThreads) gram_tile_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ wqk,
    const float* __restrict__ bqk, const float* __restrict__ dwqk,
    const float* __restrict__ bdwqk, float* __restrict__ partials,
    int H, int W, int tiles_w, int tiles_per_img) {
  using G = GramCfg<C>;
  bf16* xs = reinterpret_cast<bf16*>(dyn_smem());
  float* zs = reinterpret_cast<float*>(dyn_smem() + G::OFF_Z);
  bf16* qk = reinterpret_cast<bf16*>(dyn_smem() + G::OFF_Q);
  const int tile = blockIdx.x, b = blockIdx.y;
  const int r0 = (tile / tiles_w) * G::TH, c0 = (tile % tiles_w) * G::TW;

  load_window<C>(xs, G::LDX, G::NWIN_P, x + (size_t)b * H * W * C, H, W, r0 - 1,
                 c0 - 1, G::WR, G::WC);
  __syncthreads();
  if constexpr (LN) {
    layernorm_rows<C>(xs, G::LDX, xs, G::LDX, G::NWIN);
    __syncthreads();
  }

  for (int n0 = 0; n0 < G::C2; n0 += G::KCH) {
    gemm_bf16<G::NWIN_P, G::KCH, C>(xs, G::LDX, wqk + n0, G::C2, zs, G::LDZ);
    __syncthreads();
    // 1x1 bias, then zero outside the image (the depthwise conv's padding).
    for (int e = threadIdx.x; e < G::NWIN * G::KCH; e += kThreads) {
      const int p = e / G::KCH, n = e % G::KCH;
      const bool in = inside(r0 - 1 + p / G::WC, c0 - 1 + p % G::WC, H, W);
      zs[p * G::LDZ + n] = in ? zs[p * G::LDZ + n] + bqk[n0 + n] : 0.0f;
    }
    __syncthreads();
    // Depthwise 3x3 at the tile's own pixels; zero for pixels past the edge.
    for (int e = threadIdx.x; e < G::NPIX * G::KCH; e += kThreads) {
      const int p = e / G::KCH, n = e % G::KCH;
      const int i = p / G::TW, j = p % G::TW;
      float acc = bdwqk[n0 + n];
      for (int di = 0; di < 3; ++di)
        for (int dj = 0; dj < 3; ++dj)
          acc += zs[((i + di) * G::WC + j + dj) * G::LDZ + n] *
                 dwqk[(di * 3 + dj) * G::C2 + n0 + n];
      qk[p * G::LDQ + n0 + n] = f2bf(inside(r0 + i, c0 + j, H, W) ? acc : 0.0f);
    }
    __syncthreads();
  }

  // gram[i][j] = sum_p q[p][i] k[p][j]: q^T is q read column-major.
  float* part = partials + ((size_t)b * tiles_per_img + tile) * (C * C + G::C2);
  constexpr int GT = C / 16;
  const int warp = threadIdx.x / 32;
  for (int t = warp; t < GT * GT; t += kWarps) {
    const int ti = t / GT, tj = t % GT;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int p0 = 0; p0 < G::NPIX; p0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fq;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fk;
      wmma::load_matrix_sync(fq, qk + p0 * G::LDQ + ti * 16, G::LDQ);
      wmma::load_matrix_sync(fk, qk + p0 * G::LDQ + C + tj * 16, G::LDQ);
      wmma::mma_sync(acc, fq, fk, acc);
    }
    wmma::store_matrix_sync(part + ti * 16 * C + tj * 16, acc, C, wmma::mem_row_major);
  }
  for (int n = threadIdx.x; n < G::C2; n += kThreads) {
    float s = 0.0f;
    for (int p = 0; p < G::NPIX; ++p) {
      const float v = bf2f(qk[p * G::LDQ + n]);
      s += v * v;
    }
    part[C * C + n] = s;
  }
}

// out[b][s][e] = sum of in[b][t][e] over t in [s*chunk, min(T, s*chunk+chunk)).
__global__ void __launch_bounds__(256) reduce_partials_kernel(
    const float* __restrict__ in, float* __restrict__ out, int T, int E, int chunk) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const int b = blockIdx.y, s = blockIdx.z, S = gridDim.z;
  const int t1 = min(T, (s + 1) * chunk);
  const float* src = in + (size_t)b * T * E + e;
  float acc = 0.0f;
  for (int t = s * chunk; t < t1; ++t) acc += src[(size_t)t * E];
  out[((size_t)b * S + s) * E + e] = acc;
}

int gram_tiles_per_image(int H, int W) { return cdiv(H, 8) * cdiv(W, 8); }

// Floats of workspace a gram pass needs: the per-tile partials plus one
// level of the reduction.
long long gram_workspace_floats(int B, int H, int W, int C) {
  const long long T = gram_tiles_per_image(H, W), E = (long long)C * C + 2 * C;
  return (long long)B * (T + (T + 63) / 64) * E;
}

template <int C, bool LN>
cudaError_t gram_tiles(const void* x, const void* wqk, const void* bqk, const void* dwqk,
                       const void* bdwqk, float* partials, int B, int H, int W,
                       cudaStream_t s) {
  using G = GramCfg<C>;
  const int tw = cdiv(W, G::TW), tiles = cdiv(H, G::TH) * tw;
  return launch(gram_tile_kernel<C, LN>, dim3(tiles, B), dim3(kThreads), G::SMEM, s,
                (const bf16*)x, (const bf16*)wqk, (const float*)bqk,
                (const float*)dwqk, (const float*)bdwqk, partials, H, W, tw, tiles);
}

// The whole gram pass: tile partials, then their sum in chunks of 64 (fixed
// order: deterministic) until one row of C*C + 2C floats remains per image.
template <bool LN>
cudaError_t gram_pass(const void* x, const void* wqk, const void* bqk, const void* dwqk,
                      const void* bdwqk, void* workspace, void* out, int B, int H, int W,
                      int C, cudaStream_t s) {
  const int T = gram_tiles_per_image(H, W), E = C * C + 2 * C;
  float* part = (float*)workspace;
  float* bufs[2] = {part + (size_t)B * T * E, part};
  cudaError_t err;
  switch (C) {
    case 32: err = gram_tiles<32, LN>(x, wqk, bqk, dwqk, bdwqk, part, B, H, W, s); break;
    case 48: err = gram_tiles<48, LN>(x, wqk, bqk, dwqk, bdwqk, part, B, H, W, s); break;
    case 64: err = gram_tiles<64, LN>(x, wqk, bqk, dwqk, bdwqk, part, B, H, W, s); break;
    case 96: err = gram_tiles<96, LN>(x, wqk, bqk, dwqk, bdwqk, part, B, H, W, s); break;
    case 128: err = gram_tiles<128, LN>(x, wqk, bqk, dwqk, bdwqk, part, B, H, W, s); break;
    case 192: err = gram_tiles<192, LN>(x, wqk, bqk, dwqk, bdwqk, part, B, H, W, s); break;
    case 256: err = gram_tiles<256, LN>(x, wqk, bqk, dwqk, bdwqk, part, B, H, W, s); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const float* src = part;
  int t = T, which = 0;
  const dim3 block(256);
  while (t > 64) {
    const int S = cdiv(t, 64);
    err = launch(reduce_partials_kernel, dim3(cdiv(E, 256), B, S), block, 0, s, src,
                 bufs[which], t, E, 64);
    if (err != cudaSuccess) return err;
    src = bufs[which];
    which ^= 1;
    t = S;
  }
  return launch(reduce_partials_kernel, dim3(cdiv(E, 256), B, 1), block, 0, s, src,
                (float*)out, t, E, t);
}

// ---------------------------------------------------------------------------
// K3, pass B: attention apply + first residual + ConvFFN + second residual.
// STAGE < 5 cuts the kernel after an earlier stage and writes that stage's
// tensor at the tile's own pixels into `out` (the bisect ladder,
// probes_bisect.cu): 1 the v 1x1 output (after bias and mask), 2 the
// attention output v @ apply + b_proj, 3 y, 4 the first C channels of the
// FFN expand output (after bias and mask). STAGE 5 is the production K3.
// ---------------------------------------------------------------------------
template <int C, int STAGE>
__global__ void __launch_bounds__(kThreads) apply_tile_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ apply,
    const bf16* __restrict__ wv, const float* __restrict__ bv,
    const float* __restrict__ dwv, const float* __restrict__ bdwv,
    const float* __restrict__ bproj, const bf16* __restrict__ wp1,
    const float* __restrict__ bp1, const float* __restrict__ dwf,
    const float* __restrict__ bdwf, const bf16* __restrict__ wp2,
    const float* __restrict__ bp2, bf16* __restrict__ out, int H, int W,
    int tiles_w) {
  using A = ApplyCfg<C>;
  unsigned char* sm = dyn_smem();
  bf16* xs = reinterpret_cast<bf16*>(sm);             // region A
  bf16* yn = reinterpret_cast<bf16*>(sm);             // region A
  float* o = reinterpret_cast<float*>(sm);            // region A
  float* zs = reinterpret_cast<float*>(sm + A::OFF_B);  // region B
  bf16* v = reinterpret_cast<bf16*>(sm + A::OFF_C);   // region Cr
  bf16* f = reinterpret_cast<bf16*>(sm + A::OFF_C);   // region Cr
  float* y = reinterpret_cast<float*>(sm + A::OFF_D);  // region D
  const int tile = blockIdx.x, b = blockIdx.y;
  const int r0 = (tile / tiles_w) * A::TH, c0 = (tile % tiles_w) * A::TW;
  const bf16* xb = x + (size_t)b * H * W * C;
  // Stage output at own pixel p (row-major in the tile), channel n.
  auto put = [&](int p, int n, float val) {
    const int i = p / A::TW, j = p % A::TW;
    if (inside(r0 + i, c0 + j, H, W))
      out[(((size_t)b * H + r0 + i) * W + c0 + j) * C + n] = f2bf(val);
  };

  // Window pixel (wr, wc) is global (r0-2+wr, c0-2+wc); ring pixel (i1, j1)
  // is global (r0-1+i1, c0-1+j1); own pixel (i, j) is global (r0+i, c0+j).
  load_window<C>(xs, A::LDB, A::NWIN_P, xb, H, W, r0 - 2, c0 - 2, A::WR, A::WC);
  for (int e = threadIdx.x; e < (A::NR1_P - A::NR1) * A::LDB; e += kThreads)
    v[A::NR1 * A::LDB + e] = f2bf(0.0f);  // padding rows of v
  __syncthreads();
  layernorm_rows<C>(xs, A::LDB, xs, A::LDB, A::NWIN);
  __syncthreads();

  // v = dw3x3(mask(LN1(x) @ wv + bv)) + bdwv at the ring, chunk by chunk.
  for (int n0 = 0; n0 < C; n0 += A::KCH) {
    gemm_bf16<A::NWIN_P, A::KCH, C>(xs, A::LDB, wv + n0, C, zs, A::LDK);
    __syncthreads();
    for (int e = threadIdx.x; e < A::NWIN * A::KCH; e += kThreads) {
      const int p = e / A::KCH, n = e % A::KCH;
      const bool in = inside(r0 - 2 + p / A::WC, c0 - 2 + p % A::WC, H, W);
      zs[p * A::LDK + n] = in ? zs[p * A::LDK + n] + bv[n0 + n] : 0.0f;
    }
    __syncthreads();
    if constexpr (STAGE == 1) {
      for (int e = threadIdx.x; e < A::NPIX * A::KCH; e += kThreads) {
        const int p = e / A::KCH, n = e % A::KCH;
        put(p, n0 + n, zs[((p / A::TW + 2) * A::WC + p % A::TW + 2) * A::LDK + n]);
      }
      __syncthreads();
      continue;
    }
    for (int e = threadIdx.x; e < A::NR1 * A::KCH; e += kThreads) {
      const int p = e / A::KCH, n = e % A::KCH;
      const int i1 = p / A::R1C, j1 = p % A::R1C;
      float acc = bdwv[n0 + n];
      for (int di = 0; di < 3; ++di)
        for (int dj = 0; dj < 3; ++dj)
          acc += zs[((i1 + di) * A::WC + j1 + dj) * A::LDK + n] *
                 dwv[(di * 3 + dj) * C + n0 + n];
      v[p * A::LDB + n0 + n] = f2bf(acc);
    }
    __syncthreads();
  }
  if constexpr (STAGE == 1) return;

  // y = x + v @ apply + b_proj inside the image, 0 outside (the FFN
  // depthwise conv's zero padding).
  gemm_bf16<A::NR1_P, C, C>(v, A::LDB, apply + (size_t)b * C * C, C, y, A::LDF);
  __syncthreads();
  if constexpr (STAGE == 2) {
    for (int e = threadIdx.x; e < A::NPIX * C; e += kThreads) {
      const int p = e / C, n = e % C;
      put(p, n, y[((p / A::TW + 1) * A::R1C + p % A::TW + 1) * A::LDF + n] + bproj[n]);
    }
    return;
  }
  for (int e = threadIdx.x; e < A::NR1_P * C; e += kThreads) {
    const int p = e / C, n = e % C;
    const int gr = r0 - 1 + p / A::R1C, gc = c0 - 1 + p % A::R1C;
    float val = 0.0f;
    if (p < A::NR1 && inside(gr, gc, H, W))
      val = bf2f(xb[((size_t)gr * W + gc) * C + n]) + y[p * A::LDF + n] + bproj[n];
    y[p * A::LDF + n] = val;
  }
  __syncthreads();
  if constexpr (STAGE == 3) {
    for (int e = threadIdx.x; e < A::NPIX * C; e += kThreads) {
      const int p = e / C, n = e % C;
      put(p, n, y[((p / A::TW + 1) * A::R1C + p % A::TW + 1) * A::LDF + n]);
    }
    return;
  }
  layernorm_rows<C>(y, A::LDF, yn, A::LDB, A::NR1_P);
  __syncthreads();

  // f = GELU(dw3x3(mask(LN2(y) @ wp1 + bp1)) + bdwf) at own pixels.
  for (int h0 = 0; h0 < A::CH; h0 += A::KCH) {
    gemm_bf16<A::NR1_P, A::KCH, C>(yn, A::LDB, wp1 + h0, A::CH, zs, A::LDK);
    __syncthreads();
    for (int e = threadIdx.x; e < A::NR1_P * A::KCH; e += kThreads) {
      const int p = e / A::KCH, n = e % A::KCH;
      const bool in = p < A::NR1 &&
                      inside(r0 - 1 + p / A::R1C, c0 - 1 + p % A::R1C, H, W);
      zs[p * A::LDK + n] = in ? zs[p * A::LDK + n] + bp1[h0 + n] : 0.0f;
    }
    __syncthreads();
    if constexpr (STAGE == 4) {
      if (h0 < C) {
        for (int e = threadIdx.x; e < A::NPIX * A::KCH; e += kThreads) {
          const int p = e / A::KCH, n = e % A::KCH;
          put(p, h0 + n, zs[((p / A::TW + 1) * A::R1C + p % A::TW + 1) * A::LDK + n]);
        }
      }
      __syncthreads();
      continue;
    }
    for (int e = threadIdx.x; e < A::NPIX * A::KCH; e += kThreads) {
      const int p = e / A::KCH, n = e % A::KCH;
      const int i = p / A::TW, j = p % A::TW;
      float acc = bdwf[h0 + n];
      for (int di = 0; di < 3; ++di)
        for (int dj = 0; dj < 3; ++dj)
          acc += zs[((i + di) * A::R1C + j + dj) * A::LDK + n] *
                 dwf[(di * 3 + dj) * A::CH + h0 + n];
      const float g = 0.5f * acc * (1.0f + erff(acc * 0.70710678118654752f));
      f[p * A::LDH + h0 + n] = f2bf(g);
    }
    __syncthreads();
  }
  if constexpr (STAGE == 4) return;

  // out = y + f @ wp2 + bp2 at own pixels inside the image.
  gemm_bf16<A::NPIX, C, A::CH>(f, A::LDH, wp2, C, o, A::LDF);
  __syncthreads();
  for (int e = threadIdx.x; e < A::NPIX * C; e += kThreads) {
    const int p = e / C, n = e % C;
    const int p1 = (p / A::TW + 1) * A::R1C + p % A::TW + 1;
    put(p, n, y[p1 * A::LDF + n] + o[p * A::LDF + n] + bp2[n]);
  }
}

template <int C, int STAGE>
cudaError_t apply_tiles(const void* const* p, void* out, int B, int H, int W,
                        cudaStream_t s) {
  using A = ApplyCfg<C>;
  const int tw = cdiv(W, A::TW), tiles = cdiv(H, A::TH) * tw;
  return launch(apply_tile_kernel<C, STAGE>, dim3(tiles, B), dim3(kThreads), A::SMEM, s,
                (const bf16*)p[0], (const bf16*)p[1], (const bf16*)p[2],
                (const float*)p[3], (const float*)p[4], (const float*)p[5],
                (const float*)p[6], (const bf16*)p[7], (const float*)p[8],
                (const float*)p[9], (const float*)p[10], (const bf16*)p[11],
                (const float*)p[12], (bf16*)out, H, W, tw);
}

}  // namespace

#endif  // BLLE_BLOCK_TILES_CUH
