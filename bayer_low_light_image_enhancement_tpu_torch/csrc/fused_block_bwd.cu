// B1 and B2: the fused RawFormer TransformerBlock backward (training).
//
// The forward (fused_block.cu, K2 -> finalize -> K3) keeps every pixel-sized
// intermediate on chip; the backward does the same by recomputing them from
// x, in two passes mirroring the forward's split around the global [C, C]
// attention state:
//
//   B1 replaces the TPU kernel `_bwd1_kernel`
//      (bayer_low_light_image_enhancement_tpu/kernels/fused_block_bwd.py,
//      reached from `fused_block_backward`): per tile with a 3-pixel halo it
//      recomputes LN1 -> v -> y = x + v @ apply + b_proj -> LN2 -> t (1x1)
//      -> f_pre (dw3x3) and, from the upstream dy, forms
//        dx2 = dy + LN2^T(dt @ wp1^T),   dt = dw3x3^T(dy @ wp2^T * GELU'(f_pre)),
//      writes dx2 (the grad at y), and accumulates d_apply = v^T dx2 (per
//      image) and the grads of wp1, bp1, dwf, bdwf, wp2, bp2 and b_proj.
//   (torch autograd through `finalize_attention` then turns d_apply into
//    d_gram, d_qss, d_kss and the temperature / projection grads.)
//   B2 replaces `_bwd2_kernel`: per tile with a 2-pixel halo it recomputes
//      LN1 -> [q|k] (1x1, dw3x3) and the pre-dw z of q, k, v, forms
//        dq = k @ d_gram^T + 2 q d_qss,  dk = q @ d_gram + 2 k d_kss,
//        dv = dx2 @ apply^T,
//      back-propagates the depthwise convs (the transposed dw3x3 is the dw3x3
//      with flipped taps) and the 1x1s, and writes
//        dx = dx2 + LN1^T([dz_q|dz_k|dz_v] @ [wqk|wv]^T)
//      plus the grads of wqk, bqk, dwqk, bdwqk, wv, bv, dwv, bdwv.
//
// Both passes take the LN-affine-folded weights of the forward; the affines'
// grads follow from the folded ones by autograd through the fold
// (kernels/fused_block.py `fold_block_params`), so LayerNorm is
// differentiated here without affine.
//
// Global sums. The TPU accumulated weight grads in output blocks across a
// sequential grid; CUDA blocks run in no order. Each block here is
// persistent: grid (ctas_per_image, B), the block walks its image's tiles
// with a stride and adds every tile's contribution into its own fp32 partial
// in device memory (no other block touches it, so no atomics). A reduction
// kernel then sums the partials in a fixed order: the result is
// deterministic. The partial of B1 holds d_apply (per image) beside the
// weight grads.
//
// Bound: like the forward, the unfused backward is bound by HBM traffic for
// its pixel-sized intermediates; here only x, dy (B1) and x, dx2 (B2) are
// read and dx2 / dx written. What bounds this first version is the per-tile
// chain of barriers, the halo recompute (B1 evaluates the v 1x1 on
// (TH+6)(TW+6) pixels per TH*TW own ones) and, at C >= 128, the
// read-modify-write of the [C, 2C] weight-grad partials per tile. Tiles are
// 8x8 for C <= 64, 4x8 for C = 96/128 and 4x4 for C = 192/256: what fits the
// buffers of the widest level in the 227 KB of shared memory. The FFN is
// processed in chunks of 32 hidden channels (its dw3x3 and GELU are per
// channel), which bounds shared memory at every C.
//
// Supported widths: C in {32, 48, 64, 96, 128, 192, 256}, FFN hidden 2C.
#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int HC = 32;  // hidden-channel chunk of B1 (2C is a multiple of 32)

__host__ __device__ constexpr int round8(int n) { return (n + 7) / 8 * 8; }

template <int C>
struct TileGeom {
  static constexpr int TH = C > 64 ? 4 : 8, TW = C > 128 ? 4 : 8;
  static constexpr int NP = TH * TW;  // own pixels
  static constexpr int W3R = TH + 6, W3C = TW + 6, N3 = W3R * W3C, N3_P = round16(N3);
  static constexpr int W2R = TH + 4, W2C = TW + 4, N2 = W2R * W2C, N2_P = round16(N2);
  static constexpr int W1R = TH + 2, W1C = TW + 2, N1 = W1R * W1C, N1_P = round16(N1);
  static constexpr int KCH = C % 32 == 0 ? 32 : 16;  // chunk of the attention 1x1s
  static constexpr int LDB = C + 8, LDF = C + 4, LDK = KCH + 4;
  static_assert(NP % 16 == 0 && N2 % 16 == 0, "tile shapes must be WMMA-aligned");
};

// Shared-memory plan of B1. Regions, reused across phases:
//   A:  x window -> LN1 (bf16, 3-ring) | y (fp32, 2-ring) | dyh (fp32, own)
//       | dense own yh and dy (bf16)
//   V:  v (bf16, 2-ring) | hidden chunk t (2-ring), f_pre/df (1-ring),
//       dg (1-ring), dt (own), all fp32 | dx2 (bf16, own)
//   YH: z chunk of the v 1x1 (fp32, 3-ring) | LN2(y) (bf16, 2-ring)
//   DY: dy (bf16, 1-ring); VO: v (bf16, own); G, DT: GELU(f_pre) and dt
//   (bf16, own, all 2C channels); RS: 1/sigma of y (2-ring).
template <int C>
struct Bwd1Cfg : TileGeom<C> {
  using G = TileGeom<C>;
  static constexpr int CH = 2 * C, LDT = HC + 4, LDH = CH + 8;
  static constexpr int SZ_A = align128(
      cmax(cmax(G::N3_P * G::LDB * 2, G::N2_P * G::LDF * 4),
           cmax(G::NP * G::LDF * 4, 2 * G::NP * G::LDB * 2)));
  static constexpr int OFF_DG = (G::N2_P + G::N1_P) * LDT * 4;
  static constexpr int OFF_DTF = OFF_DG + G::N1_P * LDT * 4;
  static constexpr int SZ_V = align128(cmax(G::N2_P * G::LDB * 2, OFF_DTF + G::NP * LDT * 4));
  static constexpr int SZ_YH = align128(cmax(G::N2_P * G::LDB * 2, G::N3_P * G::LDK * 4));
  static constexpr int SZ_DY = align128(G::N1_P * G::LDB * 2);
  static constexpr int SZ_VO = align128(G::NP * G::LDB * 2);
  static constexpr int SZ_G = align128(G::NP * LDH * 2);
  static constexpr int OFF_V = SZ_A, OFF_YH = OFF_V + SZ_V, OFF_DY = OFF_YH + SZ_YH;
  static constexpr int OFF_VO = OFF_DY + SZ_DY, OFF_G = OFF_VO + SZ_VO;
  static constexpr int OFF_DT = OFF_G + SZ_G, OFF_RS = OFF_DT + SZ_G;
  static constexpr int SMEM = OFF_RS + align128(G::N2_P * 4);
  static_assert(SMEM <= 232448, "B1 tile does not fit in shared memory");
  // Partial layout (floats): d_apply [C,C] | dwp1 [C,2C] | dwp2 [2C,C] |
  // ddwf [9,2C] | dbdwf [2C] | dbp1 [2C] | dbp2 [C] | dbproj [C].
  static constexpr int P_W1 = C * C, P_W2 = P_W1 + C * CH, P_DWF = P_W2 + CH * C;
  static constexpr int P_BDWF = P_DWF + 9 * CH, P_B1 = P_BDWF + CH, P_B2 = P_B1 + CH;
  static constexpr int P_BPROJ = P_B2 + C, E = round8(P_BPROJ + C);
};

// Shared-memory plan of B2:
//   XH: x window -> LN1 (bf16, 2-ring); Z: pre-dw z chunk (fp32, 2-ring);
//   D: dq|dk|dv chunk (fp32, 1-ring); DZF: dz chunk (fp32, own);
//   Q: [q|k] and their pre-dw z (bf16, 1-ring) | dx2 (bf16, 1-ring),
//      dxh (fp32, own) and dense own LN1(x) (bf16);
//   DZ: [dz_q|dz_k|dz_v] (bf16, own); RS: 1/sigma of x (2-ring).
template <int C>
struct Bwd2Cfg : TileGeom<C> {
  using G = TileGeom<C>;
  static constexpr int C3 = 3 * C, LDQ = 2 * C + 8, LDZ3 = C3 + 8;
  static constexpr int SZ_XH = align128(G::N2_P * G::LDB * 2);
  static constexpr int SZ_Z = align128(G::N2_P * G::LDK * 4);
  static constexpr int SZ_D = align128(G::N1_P * G::LDK * 4);
  static constexpr int SZ_DZF = align128(G::NP * G::LDK * 4);
  static constexpr int OFF_ZR = G::N1_P * LDQ * 2;  // within Q
  static constexpr int OFF_DXH = align128(G::N1_P * G::LDB * 2);
  static constexpr int OFF_XHO = OFF_DXH + align128(G::NP * G::LDF * 4);
  static constexpr int SZ_Q = align128(cmax(2 * OFF_ZR, OFF_XHO + G::NP * G::LDB * 2));
  static constexpr int OFF_Z = SZ_XH, OFF_D = OFF_Z + SZ_Z, OFF_DZF = OFF_D + SZ_D;
  static constexpr int OFF_Q = OFF_DZF + SZ_DZF, OFF_DZ = OFF_Q + SZ_Q;
  static constexpr int OFF_RS = OFF_DZ + align128(G::NP * LDZ3 * 2);
  static constexpr int SMEM = OFF_RS + align128(G::N2_P * 4);
  static_assert(SMEM <= 232448, "B2 tile does not fit in shared memory");
  // Partial layout (floats): dW [C,3C] (= [dwqk | dwv]) | ddw [9,3C] |
  // dbdw [3C] | db [3C].
  static constexpr int P_DW = C * C3, P_BDW = P_DW + 9 * C3, P_B = P_BDW + C3;
  static constexpr int E = round8(P_B + C3);
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out[M][N] (fp32, device memory, stride ldo) += a^T b, a [K][M] and b [K][N]
// bf16 in shared memory (strides lda, ldb): the weight-grad product
// [pixels, M]^T x [pixels, N]. 16x16 output tiles dealt round-robin to the
// warps; each tile is read, accumulated on the tensor cores and written back
// by the warp that owns it (the same warp on every call).
template <int M, int N, int K>
__device__ void atb_accum(const bf16* a, int lda, const bf16* b, int ldb, float* out,
                          int ldo) {
  constexpr int NT = N / 16;
  const int warp = threadIdx.x / 32;
  for (int t = warp; t < (M / 16) * NT; t += kWarps) {
    const int mi = t / NT, ni = t % NT;
    float* o = out + (size_t)mi * 16 * ldo + ni * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, o, ldo, wmma::mem_row_major);
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, a + k * lda + mi * 16, lda);
      wmma::load_matrix_sync(fb, b + k * ldb + ni * 16, ldb);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(o, acc, ldo, wmma::mem_row_major);
  }
}

// GELU (exact, erf) and its derivative, as K3 evaluates GELU.
__device__ __forceinline__ float gelu_cdf(float v) {
  return 0.5f * (1.0f + erff(v * 0.70710678118654752f));
}
__device__ __forceinline__ float gelu_grad(float v) {
  return gelu_cdf(v) + v * 0.39894228040143268f * __expf(-0.5f * v * v);
}

// LayerNorm-without-affine backward at the tile's own pixels, one warp per
// pixel: out = res + rstd * (g - mean(g) - xh * mean(g * xh)), zero outside
// the image; written as bf16 to `sm_out` (own, dense, stride ldo) and, inside
// the image, to the global image `gl_out`.
//   g:   fp32 own [NP][ldg]; xh: bf16 at window coords (stride ldx, window
//   row width wc, own pixel (i, j) at (i + halo, j + halo)); rstd per window
//   row; res: bf16 at 1-ring coords (stride ldr) or, if null, the global
//   image `gl_res`; sm_out may be null.
template <int C, int TH, int TW>
__device__ void ln_backward_own(const float* g, int ldg, const bf16* xh, int ldx, int wc,
                                int halo, const float* rstd, const bf16* res, int ldr,
                                const bf16* __restrict__ gl_res, bf16* sm_out, int ldo,
                                bf16* __restrict__ gl_out, int H, int W, int r0, int c0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int p = warp; p < TH * TW; p += kWarps) {
    const int i = p / TW, j = p % TW;
    const int px = (i + halo) * wc + j + halo;
    const bool in = inside(r0 + i, c0 + j, H, W);
    const size_t gi = ((size_t)(r0 + i) * W + c0 + j) * C;
    float m1 = 0.f, m2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float gv = g[p * ldg + c];
      m1 += gv;
      m2 += gv * bf2f(xh[px * ldx + c]);
    }
    m1 = warp_sum(m1) * (1.0f / C);
    m2 = warp_sum(m2) * (1.0f / C);
    const float r = rstd[px];
    for (int c = lane; c < C; c += 32) {
      float v = 0.f;
      if (in) {
        const float rv = res ? bf2f(res[((i + 1) * (TW + 2) + j + 1) * ldr + c])
                             : bf2f(gl_res[gi + c]);
        v = rv + r * (g[p * ldg + c] - m1 - bf2f(xh[px * ldx + c]) * m2);
        gl_out[gi + c] = f2bf(v);
      }
      if (sm_out) sm_out[p * ldo + c] = f2bf(v);
    }
  }
}

// ---------------------------------------------------------------------------
// B1: FFN / LN2 backward, dx2 and d_apply.
// ---------------------------------------------------------------------------
template <int C>
__global__ void __launch_bounds__(kThreads) bwd1_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ dy,
    const bf16* __restrict__ apply, const bf16* __restrict__ wv,
    const float* __restrict__ bv, const float* __restrict__ dwv,
    const float* __restrict__ bdwv, const float* __restrict__ bproj,
    const bf16* __restrict__ wp1, const float* __restrict__ bp1,
    const float* __restrict__ dwf, const float* __restrict__ bdwf,
    const bf16* __restrict__ wp2t, const bf16* __restrict__ wp1t,
    bf16* __restrict__ dx2, float* __restrict__ partials, int H, int W, int tiles_w,
    int tiles) {
  using K = Bwd1Cfg<C>;
  constexpr int TH = K::TH, TW = K::TW, NP = K::NP, CH = K::CH;
  constexpr int W3C = K::W3C, W2C = K::W2C, W1C = K::W1C;
  constexpr int LDB = K::LDB, LDF = K::LDF, LDK = K::LDK, LDT = K::LDT, LDH = K::LDH;
  unsigned char* sm = dyn_smem();
  bf16* xh = reinterpret_cast<bf16*>(sm);           // A
  float* yf = reinterpret_cast<float*>(sm);         // A
  float* dyh = reinterpret_cast<float*>(sm);        // A
  bf16* yho = reinterpret_cast<bf16*>(sm);          // A
  bf16* dyo = yho + NP * LDB;                       // A
  bf16* v = reinterpret_cast<bf16*>(sm + K::OFF_V);   // V
  float* t = reinterpret_cast<float*>(sm + K::OFF_V);  // V
  float* fp = t + K::N2_P * LDT;                       // V
  float* dg = reinterpret_cast<float*>(sm + K::OFF_V + K::OFF_DG);    // V
  float* dtf = reinterpret_cast<float*>(sm + K::OFF_V + K::OFF_DTF);  // V
  bf16* dx2s = reinterpret_cast<bf16*>(sm + K::OFF_V);  // V
  float* zs = reinterpret_cast<float*>(sm + K::OFF_YH);  // YH
  bf16* yh = reinterpret_cast<bf16*>(sm + K::OFF_YH);    // YH
  bf16* dys = reinterpret_cast<bf16*>(sm + K::OFF_DY);
  bf16* vo = reinterpret_cast<bf16*>(sm + K::OFF_VO);
  bf16* gs = reinterpret_cast<bf16*>(sm + K::OFF_G);
  bf16* dts = reinterpret_cast<bf16*>(sm + K::OFF_DT);
  float* rs = reinterpret_cast<float*>(sm + K::OFF_RS);

  const int b = blockIdx.y;
  const size_t img = (size_t)b * H * W * C;
  const bf16* xb = x + img;
  float* part = partials + ((size_t)b * gridDim.x + blockIdx.x) * K::E;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    // Window coords: 3-ring (a, c) is global (r0-3+a, c0-3+c), 2-ring is
    // (r0-2+a, c0-2+c), 1-ring is (r0-1+a, c0-1+c), own (i, j) is (r0+i, c0+j).
    const int r0 = (tile / tiles_w) * TH, c0 = (tile % tiles_w) * TW;

    load_window<C>(xh, LDB, K::N3_P, xb, H, W, r0 - 3, c0 - 3, K::W3R, W3C);
    load_window<C>(dys, LDB, K::N1_P, dy + img, H, W, r0 - 1, c0 - 1, K::W1R, W1C);
    __syncthreads();
    layernorm_rows<C>(xh, LDB, xh, LDB, K::N3);
    __syncthreads();

    // v = dw3x3(mask(LN1(x) @ wv + bv)) + bdwv at the 2-ring.
    for (int n0 = 0; n0 < C; n0 += K::KCH) {
      gemm_bf16<K::N3_P, K::KCH, C>(xh, LDB, wv + n0, C, zs, LDK);
      __syncthreads();
      for (int e = threadIdx.x; e < K::N3 * K::KCH; e += kThreads) {
        const int p = e / K::KCH, n = e % K::KCH;
        const bool in = inside(r0 - 3 + p / W3C, c0 - 3 + p % W3C, H, W);
        zs[p * LDK + n] = in ? zs[p * LDK + n] + bv[n0 + n] : 0.0f;
      }
      __syncthreads();
      for (int e = threadIdx.x; e < K::N2 * K::KCH; e += kThreads) {
        const int p = e / K::KCH, n = e % K::KCH;
        const int a = p / W2C, c = p % W2C;
        float acc = bdwv[n0 + n];
        for (int di = 0; di < 3; ++di)
          for (int dj = 0; dj < 3; ++dj)
            acc += zs[((a + di) * W3C + c + dj) * LDK + n] * dwv[(di * 3 + dj) * C + n0 + n];
        v[p * LDB + n0 + n] = f2bf(acc);
      }
      __syncthreads();
    }

    // y = x + v @ apply + b_proj at the 2-ring, zero outside the image; v at
    // own pixels, dense, for d_apply.
    gemm_bf16<K::N2_P, C, C>(v, LDB, apply + (size_t)b * C * C, C, yf, LDF);
    __syncthreads();
    for (int e = threadIdx.x; e < K::N2 * C; e += kThreads) {
      const int p = e / C, n = e % C;
      const int gr = r0 - 2 + p / W2C, gc = c0 - 2 + p % W2C;
      yf[p * LDF + n] = inside(gr, gc, H, W)
                            ? bf2f(xb[((size_t)gr * W + gc) * C + n]) + yf[p * LDF + n] + bproj[n]
                            : 0.0f;
    }
    for (int e = threadIdx.x; e < NP * C; e += kThreads) {
      const int p = e / C, n = e % C;
      const int i = p / TW, j = p % TW;
      vo[p * LDB + n] = inside(r0 + i, c0 + j, H, W) ? v[((i + 2) * W2C + j + 2) * LDB + n]
                                                     : f2bf(0.0f);
    }
    __syncthreads();
    layernorm_rows<C>(yf, LDF, yh, LDB, K::N2, rs);
    __syncthreads();

    // FFN backward, 32 hidden channels at a time.
    for (int h0 = 0; h0 < CH; h0 += HC) {
      gemm_bf16<K::N2_P, HC, C>(yh, LDB, wp1 + h0, CH, t, LDT);
      gemm_bf16<K::N1_P, HC, C>(dys, LDB, wp2t + h0, CH, dg, LDT);
      __syncthreads();
      for (int e = threadIdx.x; e < K::N2 * HC; e += kThreads) {
        const int p = e / HC, n = e % HC;
        const bool in = inside(r0 - 2 + p / W2C, c0 - 2 + p % W2C, H, W);
        t[p * LDT + n] = in ? t[p * LDT + n] + bp1[h0 + n] : 0.0f;
      }
      __syncthreads();
      // f_pre at the 1-ring; df = dg * GELU'(f_pre); GELU(f_pre) at own.
      for (int e = threadIdx.x; e < K::N1 * HC; e += kThreads) {
        const int p = e / HC, n = e % HC;
        const int a = p / W1C, c = p % W1C;
        float acc = bdwf[h0 + n];
        for (int di = 0; di < 3; ++di)
          for (int dj = 0; dj < 3; ++dj)
            acc += t[((a + di) * W2C + c + dj) * LDT + n] * dwf[(di * 3 + dj) * CH + h0 + n];
        const bool in = inside(r0 - 1 + a, c0 - 1 + c, H, W);
        fp[p * LDT + n] = in ? dg[p * LDT + n] * gelu_grad(acc) : 0.0f;
        if (a >= 1 && a <= TH && c >= 1 && c <= TW)
          gs[((a - 1) * TW + c - 1) * LDH + h0 + n] = f2bf(in ? acc * gelu_cdf(acc) : 0.0f);
      }
      __syncthreads();
      // dt = dw3x3^T(df) at own pixels inside the image.
      for (int e = threadIdx.x; e < NP * HC; e += kThreads) {
        const int p = e / HC, n = e % HC;
        const int i = p / TW, j = p % TW;
        float acc = 0.0f;
        for (int di = 0; di < 3; ++di)
          for (int dj = 0; dj < 3; ++dj)
            acc += fp[((i + 2 - di) * W1C + j + 2 - dj) * LDT + n] *
                   dwf[(di * 3 + dj) * CH + h0 + n];
        acc = inside(r0 + i, c0 + j, H, W) ? acc : 0.0f;
        dtf[p * LDT + n] = acc;
        dts[p * LDH + h0 + n] = f2bf(acc);
      }
      __syncthreads();
      // Per-channel sums over own pixels: ddwf (9 taps), dbdwf, dbp1.
      for (int e = threadIdx.x; e < 11 * HC; e += kThreads) {
        const int k = e / HC, n = e % HC;
        float s = 0.0f;
        for (int p = 0; p < NP; ++p) {
          const int i = p / TW, j = p % TW;
          const float d = fp[((i + 1) * W1C + j + 1) * LDT + n];
          if (k < 9)
            s += d * t[((i + 1 + k / 3) * W2C + j + 1 + k % 3) * LDT + n];
          else if (k == 9)
            s += d;
          else
            s += dtf[p * LDT + n];
        }
        float* dst = k < 9 ? part + K::P_DWF + k * CH : part + (k == 9 ? K::P_BDWF : K::P_B1);
        dst[h0 + n] += s;
      }
      __syncthreads();
    }

    // dx2 = dy + LN2^T(dt @ wp1^T) at own pixels.
    gemm_bf16<NP, C, CH>(dts, LDH, wp1t, C, dyh, LDF);
    __syncthreads();
    ln_backward_own<C, TH, TW>(dyh, LDF, yh, LDB, W2C, 2, rs, dys, LDB, nullptr, dx2s, LDB,
                               dx2 + img, H, W, r0, c0);
    __syncthreads();
    for (int e = threadIdx.x; e < NP * C; e += kThreads) {
      const int p = e / C, n = e % C;
      const int i = p / TW, j = p % TW;
      yho[p * LDB + n] = yh[((i + 2) * W2C + j + 2) * LDB + n];
      dyo[p * LDB + n] = dys[((i + 1) * W1C + j + 1) * LDB + n];
    }
    for (int n = threadIdx.x; n < C; n += kThreads) {
      float sp = 0.0f, s2 = 0.0f;
      for (int p = 0; p < NP; ++p) {
        const int i = p / TW, j = p % TW;
        sp += bf2f(dx2s[p * LDB + n]);
        s2 += bf2f(dys[((i + 1) * W1C + j + 1) * LDB + n]);
      }
      part[K::P_BPROJ + n] += sp;
      part[K::P_B2 + n] += s2;
    }
    __syncthreads();
    atb_accum<C, C, NP>(vo, LDB, dx2s, LDB, part, C);             // d_apply
    atb_accum<C, CH, NP>(yho, LDB, dts, LDH, part + K::P_W1, CH);  // dwp1
    atb_accum<CH, C, NP>(gs, LDH, dyo, LDB, part + K::P_W2, C);    // dwp2
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// B2: attention-branch backward and dx.
// ---------------------------------------------------------------------------

// dz = dw3x3^T(d) at own pixels inside the image for channels [n0, n0+KCH)
// of the 3C q|k|v channels (taps `dw`, row stride `ldw`), into dzf (fp32)
// and dz (bf16, column n0 + n); d is the 1-ring chunk.
template <int C>
__device__ void dz_chunk(const float* d, const float* __restrict__ dw, int ldw, float* dzf,
                         bf16* dz, int n0, int H, int W, int r0, int c0) {
  using K = Bwd2Cfg<C>;
  for (int e = threadIdx.x; e < K::NP * K::KCH; e += kThreads) {
    const int p = e / K::KCH, n = e % K::KCH;
    const int i = p / K::TW, j = p % K::TW;
    float acc = 0.0f;
    for (int di = 0; di < 3; ++di)
      for (int dj = 0; dj < 3; ++dj)
        acc += d[((i + 2 - di) * K::W1C + j + 2 - dj) * K::LDK + n] * dw[(di * 3 + dj) * ldw + n];
    acc = inside(r0 + i, c0 + j, H, W) ? acc : 0.0f;
    dzf[p * K::LDK + n] = acc;
    dz[p * K::LDZ3 + n0 + n] = f2bf(acc);
  }
}

// Per-channel sums over own pixels for channels [n0, n0+KCH): ddw (9 taps of
// z * d), dbdw (sum d), db (sum dz). z is bf16 at 1-ring coords (zr, stride
// ldz) or fp32 at 2-ring coords (zf).
template <int C>
__device__ void dw_sums(const float* d, const float* dzf, const bf16* zr, int ldz,
                        const float* zf, float* part, int n0) {
  using K = Bwd2Cfg<C>;
  for (int e = threadIdx.x; e < 11 * K::KCH; e += kThreads) {
    const int k = e / K::KCH, n = e % K::KCH;
    float s = 0.0f;
    for (int p = 0; p < K::NP; ++p) {
      const int i = p / K::TW, j = p % K::TW;
      const float dv = d[((i + 1) * K::W1C + j + 1) * K::LDK + n];
      if (k < 9) {
        const int di = k / 3, dj = k % 3;
        const float z = zr ? bf2f(zr[((i + di) * K::W1C + j + dj) * ldz + n])
                           : zf[((i + 1 + di) * K::W2C + j + 1 + dj) * K::LDK + n];
        s += dv * z;
      } else if (k == 9) {
        s += dv;
      } else {
        s += dzf[p * K::LDK + n];
      }
    }
    float* dst = k < 9 ? part + K::P_DW + k * K::C3 : part + (k == 9 ? K::P_BDW : K::P_B);
    dst[n0 + n] += s;
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads) bwd2_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ dx2,
    const bf16* __restrict__ applyt, const bf16* __restrict__ dgramt,
    const bf16* __restrict__ dgram, const float* __restrict__ dss,
    const bf16* __restrict__ wqk, const float* __restrict__ bqk,
    const float* __restrict__ dwqk, const float* __restrict__ bdwqk,
    const bf16* __restrict__ wv, const float* __restrict__ bv,
    const float* __restrict__ dwv, const float* __restrict__ bdwv,
    const bf16* __restrict__ wqkvt, bf16* __restrict__ dx, float* __restrict__ partials,
    int H, int W, int tiles_w, int tiles) {
  using K = Bwd2Cfg<C>;
  constexpr int NP = K::NP, KCH = K::KCH, C2 = 2 * C;
  constexpr int W2C = K::W2C, W1C = K::W1C;
  constexpr int LDB = K::LDB, LDF = K::LDF, LDK = K::LDK, LDQ = K::LDQ;
  unsigned char* sm = dyn_smem();
  bf16* xh = reinterpret_cast<bf16*>(sm);
  float* z = reinterpret_cast<float*>(sm + K::OFF_Z);
  float* d = reinterpret_cast<float*>(sm + K::OFF_D);
  float* dzf = reinterpret_cast<float*>(sm + K::OFF_DZF);
  bf16* qk = reinterpret_cast<bf16*>(sm + K::OFF_Q);
  bf16* zr = reinterpret_cast<bf16*>(sm + K::OFF_Q + K::OFF_ZR);
  bf16* d2 = reinterpret_cast<bf16*>(sm + K::OFF_Q);
  float* dxh = reinterpret_cast<float*>(sm + K::OFF_Q + K::OFF_DXH);
  bf16* xho = reinterpret_cast<bf16*>(sm + K::OFF_Q + K::OFF_XHO);
  bf16* dz = reinterpret_cast<bf16*>(sm + K::OFF_DZ);
  float* rs = reinterpret_cast<float*>(sm + K::OFF_RS);

  const int b = blockIdx.y;
  const size_t img = (size_t)b * H * W * C;
  const bf16* dgt = dgramt + (size_t)b * C * C;
  const bf16* dgr = dgram + (size_t)b * C * C;
  float* part = partials + ((size_t)b * gridDim.x + blockIdx.x) * K::E;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    // 2-ring (a, c) is global (r0-2+a, c0-2+c), 1-ring (r0-1+a, c0-1+c).
    const int r0 = (tile / tiles_w) * K::TH, c0 = (tile % tiles_w) * K::TW;

    load_window<C>(xh, LDB, K::N2_P, x + img, H, W, r0 - 2, c0 - 2, K::W2R, W2C);
    for (int e = threadIdx.x; e < (K::N1_P - K::N1) * LDQ; e += kThreads)
      qk[K::N1 * LDQ + e] = f2bf(0.0f);  // padding rows of [q|k]
    __syncthreads();
    layernorm_rows<C>(xh, LDB, xh, LDB, K::N2, rs);
    __syncthreads();

    // [q|k] = dw3x3(mask(LN1(x) @ wqk + bqk)) + bdwqk at the 1-ring, zero
    // outside the image; the pre-dw z kept at the 1-ring for the tap grads.
    for (int n0 = 0; n0 < C2; n0 += KCH) {
      gemm_bf16<K::N2_P, KCH, C>(xh, LDB, wqk + n0, C2, z, LDK);
      __syncthreads();
      for (int e = threadIdx.x; e < K::N2 * KCH; e += kThreads) {
        const int p = e / KCH, n = e % KCH;
        const bool in = inside(r0 - 2 + p / W2C, c0 - 2 + p % W2C, H, W);
        z[p * LDK + n] = in ? z[p * LDK + n] + bqk[n0 + n] : 0.0f;
      }
      __syncthreads();
      for (int e = threadIdx.x; e < K::N1 * KCH; e += kThreads) {
        const int p = e / KCH, n = e % KCH;
        const int a = p / W1C, c = p % W1C;
        float acc = bdwqk[n0 + n];
        for (int di = 0; di < 3; ++di)
          for (int dj = 0; dj < 3; ++dj)
            acc += z[((a + di) * W2C + c + dj) * LDK + n] * dwqk[(di * 3 + dj) * C2 + n0 + n];
        qk[p * LDQ + n0 + n] = f2bf(inside(r0 - 1 + a, c0 - 1 + c, H, W) ? acc : 0.0f);
        zr[p * LDQ + n0 + n] = f2bf(z[((a + 1) * W2C + c + 1) * LDK + n]);
      }
      __syncthreads();
    }

    // dq = k @ d_gram^T + 2 q d_qss, dk = q @ d_gram + 2 k d_kss (1-ring,
    // zero outside the image), then their dz and tap / bias sums.
    for (int n0 = 0; n0 < C2; n0 += KCH) {
      if (n0 < C)
        gemm_bf16<K::N1_P, KCH, C>(qk + C, LDQ, dgt + n0, C, d, LDK);
      else
        gemm_bf16<K::N1_P, KCH, C>(qk, LDQ, dgr + n0 - C, C, d, LDK);
      __syncthreads();
      for (int e = threadIdx.x; e < K::N1 * KCH; e += kThreads) {
        const int p = e / KCH, n = e % KCH;
        const bool in = inside(r0 - 1 + p / W1C, c0 - 1 + p % W1C, H, W);
        d[p * LDK + n] = in ? d[p * LDK + n] + 2.0f * bf2f(qk[p * LDQ + n0 + n]) *
                                                   dss[(size_t)b * C2 + n0 + n]
                            : 0.0f;
      }
      __syncthreads();
      dz_chunk<C>(d, dwqk + n0, C2, dzf, dz, n0, H, W, r0, c0);
      __syncthreads();
      dw_sums<C>(d, dzf, zr + n0, LDQ, nullptr, part, n0);
      __syncthreads();
    }

    // dv = dx2 @ apply^T at the 1-ring; z of v recomputed at the 2-ring.
    load_window<C>(d2, LDB, K::N1_P, dx2 + img, H, W, r0 - 1, c0 - 1, K::W1R, W1C);
    __syncthreads();
    for (int n0 = 0; n0 < C; n0 += KCH) {
      gemm_bf16<K::N2_P, KCH, C>(xh, LDB, wv + n0, C, z, LDK);
      gemm_bf16<K::N1_P, KCH, C>(d2, LDB, applyt + (size_t)b * C * C + n0, C, d, LDK);
      __syncthreads();
      for (int e = threadIdx.x; e < K::N2 * KCH; e += kThreads) {
        const int p = e / KCH, n = e % KCH;
        const bool in = inside(r0 - 2 + p / W2C, c0 - 2 + p % W2C, H, W);
        z[p * LDK + n] = in ? z[p * LDK + n] + bv[n0 + n] : 0.0f;
      }
      __syncthreads();
      dz_chunk<C>(d, dwv + n0, C, dzf, dz, C2 + n0, H, W, r0, c0);
      __syncthreads();
      dw_sums<C>(d, dzf, nullptr, 0, z, part, C2 + n0);
      __syncthreads();
    }

    // dx = dx2 + LN1^T(dz @ [wqk|wv]^T) at own pixels.
    gemm_bf16<NP, C, K::C3>(dz, K::LDZ3, wqkvt, C, dxh, LDF);
    __syncthreads();
    ln_backward_own<C, K::TH, K::TW>(dxh, LDF, xh, LDB, W2C, 2, rs, d2, LDB, nullptr, nullptr,
                                     0, dx + img, H, W, r0, c0);
    __syncthreads();
    for (int e = threadIdx.x; e < NP * C; e += kThreads) {
      const int p = e / C, n = e % C;
      const int i = p / K::TW, j = p % K::TW;
      xho[p * LDB + n] = inside(r0 + i, c0 + j, H, W) ? xh[((i + 2) * W2C + j + 2) * LDB + n]
                                                      : f2bf(0.0f);
    }
    __syncthreads();
    atb_accum<C, K::C3, NP>(xho, LDB, dz, K::LDZ3, part, K::C3);  // [dwqk | dwv]
    __syncthreads();
  }
}

// out[y][e] = sum over t < T of in[(y*T + t) * ld + e], for e < n: the
// fixed-order sum of the per-block partials.
__global__ void __launch_bounds__(256) sum_partials_kernel(const float* __restrict__ in,
                                                           long long ld, float* __restrict__ out,
                                                           int T, int n) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const float* src = in + (size_t)blockIdx.y * T * ld + e;
  float acc = 0.0f;
  for (int t = 0; t < T; ++t) acc += src[(size_t)t * ld];
  out[(size_t)blockIdx.y * n + e] = acc;
}

// Persistent blocks per image: one wave of one block per SM over the batch.
int ctas_per_image(int B, int tiles) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int n = sms / B;
  return n < 1 ? 1 : (n > tiles ? tiles : n);
}

template <typename Cfg>
int tiles_of(int H, int W) { return cdiv(H, Cfg::TH) * cdiv(W, Cfg::TW); }

template <int C>
cudaError_t bwd1_run(const void* const* p, void* ws, void* dx2, float* dapply, float* dw,
                     int B, int H, int W, cudaStream_t s) {
  using K = Bwd1Cfg<C>;
  const int tw = cdiv(W, K::TW), tiles = tiles_of<K>(H, W), nct = ctas_per_image(B, tiles);
  float* part = (float*)ws;
  cudaError_t err = cudaMemsetAsync(part, 0, (size_t)B * nct * K::E * sizeof(float), s);
  if (err != cudaSuccess) return err;
  err = launch(bwd1_kernel<C>, dim3(nct, B), dim3(kThreads), K::SMEM, s,
               (const bf16*)p[0], (const bf16*)p[1], (const bf16*)p[2], (const bf16*)p[3],
               (const float*)p[4], (const float*)p[5], (const float*)p[6], (const float*)p[7],
               (const bf16*)p[8], (const float*)p[9], (const float*)p[10], (const float*)p[11],
               (const bf16*)p[12], (const bf16*)p[13], (bf16*)dx2, part, H, W, tw, tiles);
  if (err != cudaSuccess) return err;
  err = launch(sum_partials_kernel, dim3(cdiv(C * C, 256), B), dim3(256), 0, s, part,
               (long long)K::E, dapply, nct, C * C);
  if (err != cudaSuccess) return err;
  const int n = K::E - C * C;
  return launch(sum_partials_kernel, dim3(cdiv(n, 256), 1), dim3(256), 0, s, part + C * C,
                (long long)K::E, dw, B * nct, n);
}

template <int C>
cudaError_t bwd2_run(const void* const* p, void* ws, void* dx, float* dw, int B, int H,
                     int W, cudaStream_t s) {
  using K = Bwd2Cfg<C>;
  const int tw = cdiv(W, K::TW), tiles = tiles_of<K>(H, W), nct = ctas_per_image(B, tiles);
  float* part = (float*)ws;
  cudaError_t err = cudaMemsetAsync(part, 0, (size_t)B * nct * K::E * sizeof(float), s);
  if (err != cudaSuccess) return err;
  err = launch(bwd2_kernel<C>, dim3(nct, B), dim3(kThreads), K::SMEM, s,
               (const bf16*)p[0], (const bf16*)p[1], (const bf16*)p[2], (const bf16*)p[3],
               (const bf16*)p[4], (const float*)p[5], (const bf16*)p[6], (const float*)p[7],
               (const float*)p[8], (const float*)p[9], (const bf16*)p[10], (const float*)p[11],
               (const float*)p[12], (const float*)p[13], (const bf16*)p[14], (bf16*)dx, part,
               H, W, tw, tiles);
  if (err != cudaSuccess) return err;
  return launch(sum_partials_kernel, dim3(cdiv(K::E, 256), 1), dim3(256), 0, s, part,
                (long long)K::E, dw, B * nct, K::E);
}

template <template <int> class Cfg>
long long workspace_floats(int B, int H, int W, int C) {
  switch (C) {
#define BLLE_WS(c) \
  case c: return (long long)B * ctas_per_image(B, tiles_of<Cfg<c>>(H, W)) * Cfg<c>::E;
    BLLE_WS(32) BLLE_WS(48) BLLE_WS(64) BLLE_WS(96) BLLE_WS(128) BLLE_WS(192) BLLE_WS(256)
#undef BLLE_WS
    default: return -1;
  }
}

}  // namespace

// Floats of device workspace (the per-block partials) B1 / B2 need.
extern "C" long long blle_bwd1_workspace_floats(int B, int H, int W, int C) {
  return workspace_floats<Bwd1Cfg>(B, H, W, C);
}
extern "C" long long blle_bwd2_workspace_floats(int B, int H, int W, int C) {
  return workspace_floats<Bwd2Cfg>(B, H, W, C);
}

// Floats of B1's / B2's weight-grad output (layouts as Bwd1Cfg / Bwd2Cfg
// partials without d_apply; kernels/fused_block_bwd.py splits them).
extern "C" long long blle_bwd1_grad_floats(int C) {
  switch (C) {
#define BLLE_G(c) case c: return Bwd1Cfg<c>::E - c * c;
    BLLE_G(32) BLLE_G(48) BLLE_G(64) BLLE_G(96) BLLE_G(128) BLLE_G(192) BLLE_G(256)
#undef BLLE_G
    default: return -1;
  }
}
extern "C" long long blle_bwd2_grad_floats(int C) {
  switch (C) {
#define BLLE_G(c) case c: return Bwd2Cfg<c>::E;
    BLLE_G(32) BLLE_G(48) BLLE_G(64) BLLE_G(96) BLLE_G(128) BLLE_G(192) BLLE_G(256)
#undef BLLE_G
    default: return -1;
  }
}

// B1. x, dy [B,H,W,C] bf16; apply [B,C,C] bf16; wv [C,C] bf16; bv, dwv [9,C],
// bdwv, bproj fp32; wp1 [C,2C] bf16; bp1, dwf [9,2C], bdwf fp32; wp2t [C,2C]
// and wp1t [2C,C] bf16 (transposes of wp2 and wp1)
// -> dx2 [B,H,W,C] bf16, dapply [B,C,C] fp32, dw (B1 grad layout) fp32.
extern "C" int blle_bwd1(const void* x, const void* dy, const void* apply, const void* wv,
                         const void* bv, const void* dwv, const void* bdwv, const void* bproj,
                         const void* wp1, const void* bp1, const void* dwf, const void* bdwf,
                         const void* wp2t, const void* wp1t, void* workspace, void* dx2,
                         void* dapply, void* dw, int B, int H, int W, int C, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const void* p[14] = {x, dy, apply, wv, bv, dwv, bdwv, bproj, wp1, bp1, dwf, bdwf, wp2t, wp1t};
  float *da = (float*)dapply, *g = (float*)dw;
  switch (C) {
    case 32: return (int)bwd1_run<32>(p, workspace, dx2, da, g, B, H, W, s);
    case 48: return (int)bwd1_run<48>(p, workspace, dx2, da, g, B, H, W, s);
    case 64: return (int)bwd1_run<64>(p, workspace, dx2, da, g, B, H, W, s);
    case 96: return (int)bwd1_run<96>(p, workspace, dx2, da, g, B, H, W, s);
    case 128: return (int)bwd1_run<128>(p, workspace, dx2, da, g, B, H, W, s);
    case 192: return (int)bwd1_run<192>(p, workspace, dx2, da, g, B, H, W, s);
    case 256: return (int)bwd1_run<256>(p, workspace, dx2, da, g, B, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// B2. x, dx2 [B,H,W,C] bf16; applyt, dgramt, dgram [B,C,C] bf16 (apply^T,
// d_gram^T, d_gram); dss [B,2C] fp32 (d_qss | d_kss); wqk [C,2C] bf16; bqk,
// dwqk [9,2C], bdwqk fp32; wv [C,C] bf16; bv, dwv [9,C], bdwv fp32; wqkvt
// [3C,C] bf16 ([wqk|wv]^T) -> dx [B,H,W,C] bf16, dw (B2 grad layout) fp32.
extern "C" int blle_bwd2(const void* x, const void* dx2, const void* applyt,
                         const void* dgramt, const void* dgram, const void* dss,
                         const void* wqk, const void* bqk, const void* dwqk, const void* bdwqk,
                         const void* wv, const void* bv, const void* dwv, const void* bdwv,
                         const void* wqkvt, void* workspace, void* dx, void* dw, int B, int H,
                         int W, int C, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const void* p[15] = {x, dx2, applyt, dgramt, dgram, dss, wqk, bqk,
                       dwqk, bdwqk, wv, bv, dwv, bdwv, wqkvt};
  float* g = (float*)dw;
  switch (C) {
    case 32: return (int)bwd2_run<32>(p, workspace, dx, g, B, H, W, s);
    case 48: return (int)bwd2_run<48>(p, workspace, dx, g, B, H, W, s);
    case 64: return (int)bwd2_run<64>(p, workspace, dx, g, B, H, W, s);
    case 96: return (int)bwd2_run<96>(p, workspace, dx, g, B, H, W, s);
    case 128: return (int)bwd2_run<128>(p, workspace, dx, g, B, H, W, s);
    case 192: return (int)bwd2_run<192>(p, workspace, dx, g, B, H, W, s);
    case 256: return (int)bwd2_run<256>(p, workspace, dx, g, B, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
