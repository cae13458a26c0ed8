// B1 and B2: the fused RawFormer TransformerBlock backward (training).
//
// What they compute. The forward (fused_block.cu, K2 -> finalize -> K3)
// keeps every pixel-sized intermediate on chip; the backward does the same
// by recomputing them from x, in two passes mirroring the forward's split
// around the global [C, C] attention state:
//
//   B1 replaces the TPU kernel `_bwd1_kernel`
//      (bayer_low_light_image_enhancement_tpu/kernels/fused_block_bwd.py:194,
//      called at :650 from `fused_block_backward`): per tile with a 3-pixel
//      halo it recomputes LN1 -> v -> y = x + v @ apply + b_proj -> LN2 -> t
//      (1x1) -> f_pre (dw3x3) and, from the upstream dy, forms
//        dx2 = dy + LN2^T(dt @ wp1^T),   dt = dw3x3^T(dy @ wp2^T * GELU'(f_pre)),
//      writes dx2 (the grad at y), and the weight grads d_apply = v^T dx2 (per
//      image), dwp1 = LN2(y)^T dt, dwp2 = GELU(f_pre)^T dy and the tap and
//      bias grads of dwf, bdwf, bp1, bp2, b_proj.
//   (torch autograd through `finalize_attention` then turns d_apply into
//    d_gram, d_qss, d_kss and the temperature / projection grads.)
//   B2 replaces `_bwd2_kernel` (:318, called at :748): per tile with a
//      2-pixel halo it recomputes LN1 -> [q|k] (1x1, dw3x3) and the pre-dw z
//      of q, k, v, forms dq = k @ d_gram^T + 2 q d_qss, dk = q @ d_gram + 2 k
//      d_kss, dv = dx2 @ apply^T, back-propagates the depthwise convs (the
//      transposed dw3x3 is the dw3x3 with flipped taps) and the 1x1s, and
//      writes dx = dx2 + LN1^T([dz_q|dz_k|dz_v] @ [wqk|wv]^T), the grads
//      [dwqk|dwv] = LN1(x)^T [dz_q|dz_k|dz_v] and the tap and bias grads.
// Both take the LN-affine-folded weights of the forward; LayerNorm is
// differentiated here without affine.
//
// What bounds them on the H100. The function's own cost is small (x and dy
// or dx2 read once, dx2 or dx written once: 0.01-0.03 ms at the RawFormer-S
// training shapes). What a tiled version pays is the halo recompute (B1's
// 3-ring evaluates LN1 and the v 1x1 on (TH+6)(TW+6) pixels per TH*TW own
// ones), a chain of ~20 barrier-separated phases per tile, the depthwise
// convs on the fp32 pipes, and the weight-grad sums: [pixels, C]^T x
// [pixels, 2C] products whose result must outlive every tile. The TPU kept
// those in output blocks resident across its sequential grid; CUDA blocks
// run in no order and nothing carries over between them.
//
// The design, element by element:
// 1. Weight grads never make a per-tile round trip through device memory.
//    * C <= 64 ("on chip"): each persistent block holds d_apply, dwp1, dwp2
//      (B2: [dwqk|dwv]) in WMMA accumulator fragments owned by fixed warps
//      for all of its tiles (B1 at C = 64: 80 16x16 fragments, 5 a warp),
//      and the tap / bias sums in fp32 shared memory; it writes its partial
//      once, at the end, and a fixed-order sum over the blocks finishes.
//    * C >= 96 ("split"): B1's accumulators (0.18-1.3 MB) cannot stay on
//      chip. The tile pass writes the products' operands once, in bf16,
//      per own pixel (B1: v, LN2(y), dt, GELU(f_pre); B2: LN1(x) and
//      [dz_q|dz_k|dz_v]; dx2 and dy are in memory already) and
//      weight_grad.cu forms A^T B with K = all pixels on wgmma, split-K
//      partials summed in a fixed order. The tap and bias sums stay on chip.
//    The crossover is measured (PERF.md): below C = 96 the split route
//    takes as long as the on-chip one once the 1x1 weights sit in the same
//    place, and on chip needs no operand memory; from C = 96 on the
//    accumulators do not fit.
//    No atomics anywhere: every result is deterministic.
// 2. The persistent grid is the occupancy API's blocks per SM times the SMs,
//    spread over the batch. At C <= 64 a block has 16 warps (512 threads):
//    16 resident warps per SM with one block, where the shared-memory plan
//    (160-227 KB) allows no second one. Where they fit (C <= 48) the 1x1
//    weights and the image's [C, C] matrices stay in shared memory for the
//    block's lifetime (rows padded against bank conflicts); elsewhere the
//    WMMA loads read them from L2.
// 3. Tiles: 8x16 own pixels at C = 32 (B1's 3-ring recomputes 14*22/128 =
//    2.41x the own pixels, B2's 2-ring 12*20/128 = 1.88x; 8x8 before: 3.06x
//    and 2.25x), 8x8 at C = 48, 64 (3.06x, 2.25x), 4x8 at 96, 128 (4.38x,
//    3.00x) and 4x4 at 192, 256 (6.25x, 4.00x): what fits the widest buffers
//    of each width in the 227 KB of shared memory. C = 32 takes 16-channel
//    chunks of the 1x1s and of the FFN hidden layer to fit its wider tile.
// 4. The depthwise convs, their transposes and the tap / bias sums are
//    vectorised: a thread owns 4 channels (16-byte fp32 loads, its 9 taps in
//    registers) and walks pixels; the sums run per thread, then across the
//    lanes of a quad by shuffles and across warps in a fixed order. The
//    LayerNorm rows load 16 bytes at a time.
//
// Supported widths: C in {32, 48, 64, 96, 128, 192, 256}, FFN hidden 2C.
#include "common.cuh"

using namespace nvcuda;

namespace {

// Widths from which the weight-grad products leave the tile pass
// (kernels/fused_block_bwd.py SPLIT_MIN_WIDTH says the same).
constexpr int kSplitMinC = 96;

__host__ __device__ constexpr int round8(int n) { return (n + 7) / 8 * 8; }

template <int C>
struct TileGeom {
  static constexpr bool SPLIT = C >= kSplitMinC;
  static constexpr int NT = SPLIT ? 256 : 512, NW = NT / 32;
  static constexpr int TH = C > 64 ? 4 : 8, TW = C == 32 ? 16 : C > 128 ? 4 : 8;
  static constexpr int NP = TH * TW;  // own pixels
  static constexpr int W3R = TH + 6, W3C = TW + 6, N3 = W3R * W3C, N3_P = round16(N3);
  static constexpr int W2R = TH + 4, W2C = TW + 4, N2 = W2R * W2C, N2_P = round16(N2);
  static constexpr int W1R = TH + 2, W1C = TW + 2, N1 = W1R * W1C, N1_P = round16(N1);
  static constexpr int LDB = C + 8, LDF = C + 4;
  static_assert(NP % 16 == 0 && N2 % 16 == 0, "tile shapes must be WMMA-aligned");
};

// Column sums over a tile's own pixels of NS quantities of NCH channels:
// thread tid owns channels 4q..4q+3, q = tid % Q, and walks the pixel rows
// tid / Q, + R, ... Where Q divides 32 the lanes of a warp that share q are
// summed by shuffles and one partial per warp goes to scratch; otherwise one
// per row. G partials [G][NS][NCH] are then summed in a fixed order.
template <int NT, int NCH, int NS>
struct ColSum {
  static constexpr int Q = NCH / 4, R = NT / Q;
  static constexpr bool SHFL = Q < 32 && 32 % Q == 0;
  static constexpr int G = SHFL ? NT / 32 : R;
  static constexpr int SCRATCH = G * NS * NCH;  // floats
};

__device__ __forceinline__ float4 f4(float v) { return make_float4(v, v, v, v); }
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float4 fma4(float4 a, float4 b, float4 c) {
  return make_float4(fmaf(a.x, b.x, c.x), fmaf(a.y, b.y, c.y), fmaf(a.z, b.z, c.z),
                     fmaf(a.w, b.w, c.w));
}
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
// 4 bf16 (8 bytes) <-> float4.
__device__ __forceinline__ float4 ld4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ unsigned bf2_bits(float a, float b) {
  return (unsigned)__bfloat16_as_ushort(f2bf(a)) | ((unsigned)__bfloat16_as_ushort(f2bf(b)) << 16);
}
__device__ __forceinline__ void st4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(bf2_bits(v.x, v.y), bf2_bits(v.z, v.w));
}
__device__ __forceinline__ void copy16(bf16* dst, const bf16* src) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}

// GELU (exact, erf) and its derivative, as K3 evaluates GELU.
__device__ __forceinline__ float gelu_cdf(float v) {
  return 0.5f * (1.0f + erff(v * 0.70710678118654752f));
}
__device__ __forceinline__ float gelu_grad(float v) {
  return gelu_cdf(v) + v * 0.39894228040143268f * __expf(-0.5f * v * v);
}

// Reduce each thread's running sums s[NS] (see ColSum) over the threads of
// its channel quad and add the totals, in a fixed order, into dst(k, n).
// Every thread of the block calls it; it ends with a barrier.
template <int NT, int NCH, int NS, typename Dst>
__device__ void commit_colsums(float4 (&s)[NS], float* scratch, Dst dst) {
  using CS = ColSum<NT, NCH, NS>;
  const int tid = threadIdx.x, q = tid % CS::Q;
  if constexpr (CS::SHFL) {
#pragma unroll
    for (int o = CS::Q; o < 32; o <<= 1)
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        s[k].x += __shfl_xor_sync(0xffffffffu, s[k].x, o);
        s[k].y += __shfl_xor_sync(0xffffffffu, s[k].y, o);
        s[k].z += __shfl_xor_sync(0xffffffffu, s[k].z, o);
        s[k].w += __shfl_xor_sync(0xffffffffu, s[k].w, o);
      }
  }
  const int g = CS::SHFL ? tid / 32 : tid / CS::Q;
  const bool writer = CS::SHFL ? tid % 32 < CS::Q : tid < CS::Q * CS::R;
  if (writer)
#pragma unroll
    for (int k = 0; k < NS; ++k) st4(scratch + (g * NS + k) * NCH + 4 * q, s[k]);
  __syncthreads();
  for (int e = tid; e < NS * NCH; e += NT) {
    float t = 0.0f;
    for (int i = 0; i < CS::G; ++i) t += scratch[i * NS * NCH + e];
    dst(e / NCH, e % NCH) += t;
  }
  __syncthreads();
}

// LayerNorm rows as common.cuh's layernorm_rows_t computes them (the same
// sums in the same order), a thread per row, but with 16-byte loads and
// stores (8 bf16 or 4 fp32 values): conflict-free where the scalar row walk
// hits one bank 4-8 times. src and dst may alias.
__device__ __forceinline__ void unpack16(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack16(const float* p, float (&v)[4]) {
  const float4 u = ld4(p);
  v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
}
template <int C, int NT, typename SrcT>
__device__ void layernorm_rows_vec(const SrcT* src, int lds, bf16* dst, int ldd, int n,
                                   float* rstd = nullptr) {
  constexpr int V = 16 / sizeof(SrcT);
  float v[V];
  for (int p = threadIdx.x; p < n; p += NT) {
    const SrcT* s = src + p * lds;
    float mu = 0.f, var = 0.f;
    for (int c = 0; c < C; c += V) {
      unpack16(s + c, v);
#pragma unroll
      for (int i = 0; i < V; ++i) mu += v[i];
    }
    mu *= 1.0f / C;
    for (int c = 0; c < C; c += V) {
      unpack16(s + c, v);
#pragma unroll
      for (int i = 0; i < V; ++i) var += (v[i] - mu) * (v[i] - mu);
    }
    const float inv = rsqrtf(var * (1.0f / C) + 1e-5f);
    if (rstd) rstd[p] = inv;
    for (int c = 0; c < C; c += V) {
      unpack16(s + c, v);
#pragma unroll
      for (int i = 0; i < V; i += 4)
        st4(dst + p * ldd + c + i, make_float4((v[i] - mu) * inv, (v[i + 1] - mu) * inv,
                                               (v[i + 2] - mu) * inv, (v[i + 3] - mu) * inv));
    }
  }
}

// dst[r][0:cols] (stride ldd) = src[r][0:cols] (dense) for r < rows, bf16,
// 16-byte units, by blocks of NT threads.
template <int NT>
__device__ void copy_rows(bf16* dst, int ldd, const bf16* __restrict__ src, int rows, int cols) {
  const int u8 = cols / 8;
  for (int e = threadIdx.x; e < rows * u8; e += NT)
    copy16(dst + (e / u8) * ldd + 8 * (e % u8), src + (e / u8) * cols + 8 * (e % u8));
}

// LayerNorm-without-affine backward at the tile's own pixels, one warp per
// pixel: out = res + rstd * (g - mean(g) - xh * mean(g * xh)), zero outside
// the image; written as bf16 to `sm_out` (own, dense, stride ldo) if not
// null and, inside the image, to the global image `gl_out`.
//   g: fp32 own [NP][ldg]; xh: bf16 at window coords (stride ldx, window
//   row width wc, own pixel (i, j) at (i + halo, j + halo)); rstd per window
//   row; res: bf16 at 1-ring coords (stride ldr).
template <int C, int TH, int TW, int NW>
__device__ void ln_backward_own(const float* g, int ldg, const bf16* xh, int ldx, int wc,
                                int halo, const float* rstd, const bf16* res, int ldr,
                                bf16* sm_out, int ldo, bf16* __restrict__ gl_out, int H, int W,
                                int r0, int c0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int p = warp; p < TH * TW; p += NW) {
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
    for (int o = 16; o > 0; o >>= 1) {
      m1 += __shfl_xor_sync(0xffffffffu, m1, o);
      m2 += __shfl_xor_sync(0xffffffffu, m2, o);
    }
    m1 *= 1.0f / C;
    m2 *= 1.0f / C;
    const float r = rstd[px];
    for (int c = lane; c < C; c += 32) {
      float v = 0.f;
      if (in) {
        const float rv = bf2f(res[((i + 1) * (TW + 2) + j + 1) * ldr + c]);
        v = rv + r * (g[p * ldg + c] - m1 - bf2f(xh[px * ldx + c]) * m2);
        gl_out[gi + c] = f2bf(v);
      }
      if (sm_out) sm_out[p * ldo + c] = f2bf(v);
    }
  }
}

// acc (+)= a^T b over the tile's NP own pixels for the 16x16 output tile
// (mi, ni): a [NP][lda], b [NP][ldb] bf16 in shared memory.
template <int NP>
__device__ __forceinline__ void atb_tile(wmma::fragment<wmma::accumulator, 16, 16, 16, float>& acc,
                                         const bf16* a, int lda, const bf16* b, int ldb, int mi,
                                         int ni) {
#pragma unroll
  for (int k = 0; k < NP; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
    wmma::load_matrix_sync(fa, a + k * lda + mi * 16, lda);
    wmma::load_matrix_sync(fb, b + k * ldb + ni * 16, ldb);
    wmma::mma_sync(acc, fa, fb, acc);
  }
}

// ---------------------------------------------------------------------------
// B1: FFN / LN2 backward, dx2 and d_apply.
// ---------------------------------------------------------------------------

// Shared-memory plan of B1. Regions, reused across phases:
//   A:  x window -> LN1 (bf16, 3-ring) | y (fp32, 2-ring) | tap-sum scratch
//       | dyh (fp32, own) | dense own yh and dy (bf16, on chip only)
//   V:  v (bf16, 2-ring) | hidden chunk t (2-ring), f_pre/df (1-ring),
//       dg (1-ring), dt (own), all fp32 | dx2 (bf16, own) + bias-sum scratch
//   YH: z chunk of the v 1x1 (fp32, 3-ring) | LN2(y) (bf16, 2-ring)
//   DY: dy (bf16, 1-ring); DT: dt (bf16, own, all 2C channels); RS: 1/sigma
//   of y (2-ring); SUM: the tap and bias sums (fp32, the block's lifetime);
//   on chip only: VO: v (bf16, own), G: GELU(f_pre) (bf16, own, 2C); where
//   they fit (C <= 48): WT: the 1x1 weights wv, wp1, wp2^T, wp1^T and the
//   image's apply (bf16, rows padded by 8, the block's lifetime).
template <int C>
struct Bwd1Cfg : TileGeom<C> {
  using G_ = TileGeom<C>;
  static constexpr int CH = 2 * C;
  static constexpr int KCH = C == 32 ? 16 : C % 32 == 0 ? 32 : 16;  // v 1x1 chunk
  static constexpr int HC = C == 32 ? 16 : 32;                       // FFN hidden chunk
  static constexpr int LDK = KCH + 4, LDT = HC + 4, LDH = CH + 8;
  using CS_TAP = ColSum<G_::NT, HC, 11>;
  using CS_BIAS = ColSum<G_::NT, C, 2>;
  static constexpr int SZ_A = align128(cmax(
      cmax(G_::N3_P * G_::LDB * 2, G_::N2_P * G_::LDF * 4),
      cmax(cmax(G_::NP * G_::LDF * 4, 2 * G_::NP * G_::LDB * 2), CS_TAP::SCRATCH * 4)));
  static constexpr int OFF_FP = G_::N2_P * LDT * 4;  // within V
  static constexpr int OFF_DG = OFF_FP + G_::N1_P * LDT * 4;
  static constexpr int OFF_DTF = OFF_DG + G_::N1_P * LDT * 4;
  static constexpr int OFF_S8 = align128(G_::NP * G_::LDB * 2);
  static constexpr int SZ_V = align128(cmax(cmax(G_::N2_P * G_::LDB * 2, OFF_DTF + G_::NP * LDT * 4),
                                            OFF_S8 + CS_BIAS::SCRATCH * 4));
  static constexpr int SZ_YH = align128(cmax(G_::N2_P * G_::LDB * 2, G_::N3_P * LDK * 4));
  static constexpr int SZ_DY = align128(G_::N1_P * G_::LDB * 2);
  static constexpr int SZ_DT = align128(G_::NP * LDH * 2);
  static constexpr int SZ_VO = G_::SPLIT ? 0 : align128(G_::NP * G_::LDB * 2);
  static constexpr int SZ_G = G_::SPLIT ? 0 : SZ_DT;
  // Sums (floats): ddwf [9,2C] | dbdwf [2C] | dbp1 [2C] | dbp2 [C] | dbproj [C].
  static constexpr int NSUM = 11 * CH + 2 * C;
  static constexpr int OFF_V = SZ_A, OFF_YH = OFF_V + SZ_V, OFF_DY = OFF_YH + SZ_YH;
  static constexpr int OFF_DT = OFF_DY + SZ_DY, OFF_RS = OFF_DT + SZ_DT;
  static constexpr int OFF_SUM = OFF_RS + align128(G_::N2_P * 4);
  static constexpr int OFF_VO = OFF_SUM + align128(NSUM * 4), OFF_G = OFF_VO + SZ_VO;
  // WT (bf16 offsets, rows padded by 8): wv | wp1 | wp2^T | wp1^T | apply.
  static constexpr int W_WP1 = C * (C + 8), W_WP2T = W_WP1 + C * (CH + 8);
  static constexpr int W_WP1T = W_WP2T + C * (CH + 8), W_APPLY = W_WP1T + CH * (C + 8);
  static constexpr int OFF_WT = OFF_G + SZ_G, SZ_WT = align128((W_APPLY + C * (C + 8)) * 2);
  static constexpr bool WSM = OFF_WT + SZ_WT <= 232448;  // the weights fit: on chip
  static constexpr int LDW = WSM ? C + 8 : C, LDWH = WSM ? CH + 8 : CH;  // their row strides
  static constexpr int SMEM = OFF_WT + (WSM ? SZ_WT : 0);
  static_assert(SMEM <= 232448, "B1 tile does not fit in shared memory");
  // The block's partial (floats). On chip: d_apply [C,C] | dwp1 [C,2C] |
  // dwp2 [2C,C] | sums; split: sums.
  static constexpr int P_W1 = C * C, P_W2 = P_W1 + C * CH, P_SUM = P_W2 + CH * C;
  static constexpr int E = G_::SPLIT ? round8(NSUM) : round8(P_SUM + NSUM);
  // On-chip accumulator fragments: the 16x16 tiles of d_apply, dwp1, dwp2,
  // tile t held by warp t % NW as its fragment t / NW.
  static constexpr int T_DA = (C / 16) * (C / 16), T_W1 = (C / 16) * (CH / 16);
  static constexpr int T_ALL = T_DA + 2 * T_W1;
  static constexpr int NF = G_::SPLIT ? 1 : (T_ALL + G_::NW - 1) / G_::NW;
};

template <int C>
__global__ void __launch_bounds__(TileGeom<C>::NT) bwd1_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ dy,
    const bf16* __restrict__ apply, const bf16* __restrict__ wv,
    const float* __restrict__ bv, const float* __restrict__ dwv,
    const float* __restrict__ bdwv, const float* __restrict__ bproj,
    const bf16* __restrict__ wp1, const float* __restrict__ bp1,
    const float* __restrict__ dwf, const float* __restrict__ bdwf,
    const bf16* __restrict__ wp2t, const bf16* __restrict__ wp1t,
    bf16* __restrict__ dx2, bf16* __restrict__ op_v, bf16* __restrict__ op_y,
    bf16* __restrict__ op_dt, bf16* __restrict__ op_g, float* __restrict__ partials, int H,
    int W, int tiles_w, int tiles) {
  using K = Bwd1Cfg<C>;
  constexpr bool SPLIT = K::SPLIT;
  constexpr int NT = K::NT, NW = K::NW, TH = K::TH, TW = K::TW, NP = K::NP, CH = K::CH;
  constexpr int HC = K::HC, KCH = K::KCH;
  constexpr int W3C = K::W3C, W2C = K::W2C, W1C = K::W1C;
  constexpr int LDB = K::LDB, LDF = K::LDF, LDK = K::LDK, LDT = K::LDT, LDH = K::LDH;
  unsigned char* sm = dyn_smem();
  bf16* xh = reinterpret_cast<bf16*>(sm);           // A
  float* yf = reinterpret_cast<float*>(sm);         // A
  float* scr_tap = reinterpret_cast<float*>(sm);    // A
  float* dyh = reinterpret_cast<float*>(sm);        // A
  bf16* yho = reinterpret_cast<bf16*>(sm);          // A
  bf16* dyo = yho + NP * LDB;                       // A
  bf16* v = reinterpret_cast<bf16*>(sm + K::OFF_V);   // V
  float* t = reinterpret_cast<float*>(sm + K::OFF_V);  // V
  float* fp = reinterpret_cast<float*>(sm + K::OFF_V + K::OFF_FP);
  float* dg = reinterpret_cast<float*>(sm + K::OFF_V + K::OFF_DG);
  float* dtf = reinterpret_cast<float*>(sm + K::OFF_V + K::OFF_DTF);
  bf16* dx2s = reinterpret_cast<bf16*>(sm + K::OFF_V);
  float* scr_bias = reinterpret_cast<float*>(sm + K::OFF_V + K::OFF_S8);
  float* zs = reinterpret_cast<float*>(sm + K::OFF_YH);  // YH
  bf16* yh = reinterpret_cast<bf16*>(sm + K::OFF_YH);    // YH
  bf16* dys = reinterpret_cast<bf16*>(sm + K::OFF_DY);
  bf16* dts = reinterpret_cast<bf16*>(sm + K::OFF_DT);
  float* rs = reinterpret_cast<float*>(sm + K::OFF_RS);
  float* sums = reinterpret_cast<float*>(sm + K::OFF_SUM);
  bf16* vo = reinterpret_cast<bf16*>(sm + K::OFF_VO);
  bf16* gs = reinterpret_cast<bf16*>(sm + K::OFF_G);

  const int tid = threadIdx.x, warp = tid / 32;
  const int b = blockIdx.y;
  const size_t img = (size_t)b * H * W * C, pix0 = (size_t)b * H * W;
  const bf16* xb = x + img;
  float* part = partials + ((size_t)b * gridDim.x + blockIdx.x) * K::E;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[K::NF];
#pragma unroll
  for (int f = 0; f < K::NF; ++f) wmma::fill_fragment(acc[f], 0.0f);
  for (int e = tid; e < K::NSUM; e += NT) sums[e] = 0.0f;
  // The 1x1 weights (and the image's apply): from shared memory where they
  // fit, else from device memory (L2).
  const bf16* apply_b = apply + (size_t)b * C * C;
  const bf16 *Wv = wv, *Wp1 = wp1, *Wp2t = wp2t, *Wp1t = wp1t, *Ap = apply_b;
  if constexpr (K::WSM) {
    bf16* wt = reinterpret_cast<bf16*>(sm + K::OFF_WT);
    Wv = wt, Wp1 = wt + K::W_WP1, Wp2t = wt + K::W_WP2T, Wp1t = wt + K::W_WP1T;
    Ap = wt + K::W_APPLY;
    copy_rows<NT>(wt, K::LDW, wv, C, C);
    copy_rows<NT>(wt + K::W_WP1, K::LDWH, wp1, C, CH);
    copy_rows<NT>(wt + K::W_WP2T, K::LDWH, wp2t, C, CH);
    copy_rows<NT>(wt + K::W_WP1T, K::LDW, wp1t, CH, C);
    copy_rows<NT>(wt + K::W_APPLY, K::LDW, apply_b, C, C);
  }
  constexpr int LDW = K::LDW, LDWH = K::LDWH;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    // Window coords: 3-ring (a, c) is global (r0-3+a, c0-3+c), 2-ring is
    // (r0-2+a, c0-2+c), 1-ring is (r0-1+a, c0-1+c), own (i, j) is (r0+i, c0+j).
    const int r0 = (tile / tiles_w) * TH, c0 = (tile % tiles_w) * TW;

    load_window_async<C>(xh, LDB, K::N3_P, xb, H, W, r0 - 3, c0 - 3, K::W3R, W3C, tid, NT);
    load_window_async<C>(dys, LDB, K::N1_P, dy + img, H, W, r0 - 1, c0 - 1, K::W1R, W1C, tid, NT);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    layernorm_rows_vec<C, NT>(xh, LDB, xh, LDB, K::N3);
    __syncthreads();

    // v = dw3x3(mask(LN1(x) @ wv + bv)) + bdwv at the 2-ring.
    for (int n0 = 0; n0 < C; n0 += KCH) {
      constexpr int Q = KCH / 4;
      const int q = tid % Q;
      gemm_bf16_w<K::N3_P, KCH, C>(warp, NW, xh, LDB, Wv + n0, LDW, zs, LDK);
      __syncthreads();
      {
        const float4 bb = ld4(bv + n0 + 4 * q);
        for (int p = tid / Q; p < K::N3; p += NT / Q) {
          float* z = zs + p * LDK + 4 * q;
          st4(z, inside(r0 - 3 + p / W3C, c0 - 3 + p % W3C, H, W) ? add4(ld4(z), bb) : f4(0.f));
        }
      }
      __syncthreads();
      {
        float4 wt[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) wt[k] = ld4(dwv + k * C + n0 + 4 * q);
        const float4 bias = ld4(bdwv + n0 + 4 * q);
        for (int p = tid / Q; p < K::N2; p += NT / Q) {
          const int a = p / W2C, c = p % W2C;
          float4 s = bias;
#pragma unroll
          for (int k = 0; k < 9; ++k)
            s = fma4(ld4(zs + ((a + k / 3) * W3C + c + k % 3) * LDK + 4 * q), wt[k], s);
          st4(v + p * LDB + n0 + 4 * q, s);
        }
      }
      __syncthreads();
    }

    // y = x + v @ apply + b_proj at the 2-ring, zero outside the image; v at
    // own pixels (dense, zero outside the image, on chip; to memory, split).
    gemm_bf16_w<K::N2_P, C, C>(warp, NW, v, LDB, Ap, LDW, yf, LDF);
    __syncthreads();
    {
      constexpr int Q = C / 4;
      for (int e = tid; e < K::N2 * Q; e += NT) {
        const int p = e / Q, q = e % Q;
        const int gr = r0 - 2 + p / W2C, gc = c0 - 2 + p % W2C;
        float* y = yf + p * LDF + 4 * q;
        st4(y, inside(gr, gc, H, W)
                   ? add4(add4(ld4(xb + ((size_t)gr * W + gc) * C + 4 * q), ld4(y)),
                          ld4(bproj + 4 * q))
                   : f4(0.f));
      }
      constexpr int U = C / 8;
      for (int e = tid; e < NP * U; e += NT) {
        const int p = e / U, u = e % U, i = p / TW, j = p % TW;
        const bool in = inside(r0 + i, c0 + j, H, W);
        const bf16* src = v + ((i + 2) * W2C + j + 2) * LDB + 8 * u;
        if constexpr (SPLIT) {
          if (in) copy16(op_v + (pix0 + (size_t)(r0 + i) * W + c0 + j) * C + 8 * u, src);
        } else {
          *reinterpret_cast<uint4*>(vo + p * LDB + 8 * u) =
              in ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
        }
      }
    }
    __syncthreads();
    layernorm_rows_vec<C, NT>(yf, LDF, yh, LDB, K::N2, rs);
    __syncthreads();

    // FFN backward, HC hidden channels at a time.
    for (int h0 = 0; h0 < CH; h0 += HC) {
      constexpr int Q = HC / 4;
      const int q = tid % Q;
      gemm_bf16_w<K::N2_P, HC, C>(warp, NW, yh, LDB, Wp1 + h0, LDWH, t, LDT);
      gemm_bf16_w<K::N1_P, HC, C>(warp, NW, dys, LDB, Wp2t + h0, LDWH, dg, LDT);
      __syncthreads();
      {
        const float4 bb = ld4(bp1 + h0 + 4 * q);
        for (int p = tid / Q; p < K::N2; p += NT / Q) {
          float* tp = t + p * LDT + 4 * q;
          st4(tp, inside(r0 - 2 + p / W2C, c0 - 2 + p % W2C, H, W) ? add4(ld4(tp), bb) : f4(0.f));
        }
      }
      __syncthreads();
      float4 wt[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) wt[k] = ld4(dwf + k * CH + h0 + 4 * q);
      // f_pre at the 1-ring; df = dg * GELU'(f_pre); GELU(f_pre) at own.
      {
        const float4 bias = ld4(bdwf + h0 + 4 * q);
        for (int p = tid / Q; p < K::N1; p += NT / Q) {
          const int a = p / W1C, c = p % W1C;
          float4 s = bias;
#pragma unroll
          for (int k = 0; k < 9; ++k)
            s = fma4(ld4(t + ((a + k / 3) * W2C + c + k % 3) * LDT + 4 * q), wt[k], s);
          const bool in = inside(r0 - 1 + a, c0 - 1 + c, H, W);
          const float4 d = ld4(dg + p * LDT + 4 * q);
          st4(fp + p * LDT + 4 * q,
              in ? make_float4(d.x * gelu_grad(s.x), d.y * gelu_grad(s.y), d.z * gelu_grad(s.z),
                               d.w * gelu_grad(s.w))
                 : f4(0.f));
          if (a >= 1 && a <= TH && c >= 1 && c <= TW) {
            const float4 gl = in ? make_float4(s.x * gelu_cdf(s.x), s.y * gelu_cdf(s.y),
                                               s.z * gelu_cdf(s.z), s.w * gelu_cdf(s.w))
                                 : f4(0.f);
            if constexpr (SPLIT) {
              if (in)
                st4(op_g + (pix0 + (size_t)(r0 - 1 + a) * W + c0 - 1 + c) * CH + h0 + 4 * q, gl);
            } else {
              st4(gs + ((a - 1) * TW + c - 1) * LDH + h0 + 4 * q, gl);
            }
          }
        }
      }
      __syncthreads();
      // dt = dw3x3^T(df) at own pixels inside the image.
      for (int p = tid / Q; p < NP; p += NT / Q) {
        const int i = p / TW, j = p % TW;
        float4 s = f4(0.f);
#pragma unroll
        for (int k = 0; k < 9; ++k)
          s = fma4(ld4(fp + ((i + 2 - k / 3) * W1C + j + 2 - k % 3) * LDT + 4 * q), wt[k], s);
        if (!inside(r0 + i, c0 + j, H, W)) s = f4(0.f);
        st4(dtf + p * LDT + 4 * q, s);
        st4(dts + p * LDH + h0 + 4 * q, s);
      }
      __syncthreads();
      // Per-channel sums over own pixels: ddwf (9 taps of df * t), dbdwf
      // (df), dbp1 (dt).
      {
        float4 s[11];
#pragma unroll
        for (int k = 0; k < 11; ++k) s[k] = f4(0.f);
        for (int p = tid / Q; p < NP; p += NT / Q) {
          const int i = p / TW, j = p % TW;
          const float4 d = ld4(fp + ((i + 1) * W1C + j + 1) * LDT + 4 * q);
#pragma unroll
          for (int k = 0; k < 9; ++k)
            s[k] = fma4(d, ld4(t + ((i + 1 + k / 3) * W2C + j + 1 + k % 3) * LDT + 4 * q), s[k]);
          s[9] = add4(s[9], d);
          s[10] = add4(s[10], ld4(dtf + p * LDT + 4 * q));
        }
        commit_colsums<NT, HC, 11>(s, scr_tap,
                                   [&](int k, int n) -> float& { return sums[k * CH + h0 + n]; });
      }
    }

    // dx2 = dy + LN2^T(dt @ wp1^T) at own pixels.
    gemm_bf16_w<NP, C, CH>(warp, NW, dts, LDH, Wp1t, LDW, dyh, LDF);
    __syncthreads();
    ln_backward_own<C, TH, TW, NW>(dyh, LDF, yh, LDB, W2C, 2, rs, dys, LDB, dx2s, LDB, dx2 + img,
                                   H, W, r0, c0);
    __syncthreads();
    // dbp2 = sum dy, dbproj = sum dx2 over own pixels.
    {
      using CS = typename K::CS_BIAS;
      const int q = tid % CS::Q;
      float4 s[2] = {f4(0.f), f4(0.f)};
      if (tid < CS::Q * CS::R)
        for (int p = tid / CS::Q; p < NP; p += CS::R) {
          const int i = p / TW, j = p % TW;
          s[0] = add4(s[0], ld4(dys + ((i + 1) * W1C + j + 1) * LDB + 4 * q));
          s[1] = add4(s[1], ld4(dx2s + p * LDB + 4 * q));
        }
      commit_colsums<NT, C, 2>(s, scr_bias,
                               [&](int k, int n) -> float& { return sums[11 * CH + k * C + n]; });
    }

    if constexpr (SPLIT) {
      // LN2(y) and dt at own pixels inside the image: the operands of
      // dwp1 = LN2(y)^T dt (weight_grad.cu).
      constexpr int U = C / 8, UH = CH / 8;
      for (int e = tid; e < NP * (U + UH); e += NT) {
        const int p = e / (U + UH), u = e % (U + UH), i = p / TW, j = p % TW;
        if (!inside(r0 + i, c0 + j, H, W)) continue;
        const size_t px = pix0 + (size_t)(r0 + i) * W + c0 + j;
        if (u < U)
          copy16(op_y + px * C + 8 * u, yh + ((i + 2) * W2C + j + 2) * LDB + 8 * u);
        else
          copy16(op_dt + px * CH + 8 * (u - U), dts + p * LDH + 8 * (u - U));
      }
    } else {
      // Dense own LN2(y) and dy, then the products into the block's
      // fragments: d_apply += v^T dx2, dwp1 += LN2(y)^T dt, dwp2 += G^T dy.
      constexpr int U = C / 8;
      for (int e = tid; e < NP * U; e += NT) {
        const int p = e / U, u = e % U, i = p / TW, j = p % TW;
        copy16(yho + p * LDB + 8 * u, yh + ((i + 2) * W2C + j + 2) * LDB + 8 * u);
        copy16(dyo + p * LDB + 8 * u, dys + ((i + 1) * W1C + j + 1) * LDB + 8 * u);
      }
      __syncthreads();
#pragma unroll
      for (int f = 0; f < K::NF; ++f) {
        const int u = warp + f * NW;
        if (u < K::T_DA)
          atb_tile<NP>(acc[f], vo, LDB, dx2s, LDB, u / (C / 16), u % (C / 16));
        else if (u < K::T_DA + K::T_W1)
          atb_tile<NP>(acc[f], yho, LDB, dts, LDH, (u - K::T_DA) / (CH / 16),
                       (u - K::T_DA) % (CH / 16));
        else if (u < K::T_ALL)
          atb_tile<NP>(acc[f], gs, LDH, dyo, LDB, (u - K::T_DA - K::T_W1) / (C / 16),
                       (u - K::T_DA - K::T_W1) % (C / 16));
      }
      __syncthreads();
    }
  }
  __syncthreads();

  // The block's partial, written once.
  if constexpr (!SPLIT) {
#pragma unroll
    for (int f = 0; f < K::NF; ++f) {
      const int u = warp + f * NW;
      if (u < K::T_DA)
        wmma::store_matrix_sync(part + (u / (C / 16)) * 16 * C + (u % (C / 16)) * 16, acc[f], C,
                                wmma::mem_row_major);
      else if (u < K::T_DA + K::T_W1)
        wmma::store_matrix_sync(part + K::P_W1 + ((u - K::T_DA) / (CH / 16)) * 16 * CH +
                                    ((u - K::T_DA) % (CH / 16)) * 16,
                                acc[f], CH, wmma::mem_row_major);
      else if (u < K::T_ALL)
        wmma::store_matrix_sync(part + K::P_W2 + ((u - K::T_DA - K::T_W1) / (C / 16)) * 16 * C +
                                    ((u - K::T_DA - K::T_W1) % (C / 16)) * 16,
                                acc[f], C, wmma::mem_row_major);
    }
  }
  float* psum = part + (SPLIT ? 0 : K::P_SUM);
  for (int e = tid; e < K::NSUM; e += NT) psum[e] = sums[e];
}

// ---------------------------------------------------------------------------
// B2: attention-branch backward and dx.
// ---------------------------------------------------------------------------

// Shared-memory plan of B2:
//   XH: x window -> LN1 (bf16, 2-ring); Z: pre-dw z chunk (fp32, 2-ring);
//   D: dq|dk|dv chunk (fp32, 1-ring); DZF: dz chunk (fp32, own);
//   Q: [q|k] and their pre-dw z (bf16, 1-ring) | dx2 (bf16, 1-ring),
//      dxh (fp32, own) and dense own LN1(x) (bf16);
//   DZ: [dz_q|dz_k|dz_v] (bf16, own); RS: 1/sigma of x (2-ring); SUM: the
//   tap and bias sums (the block's lifetime); SCR: their scratch; where they
//   fit (C <= 48): WT: wqk, wv, [wqk|wv]^T and the image's d_gram^T, d_gram,
//   apply^T (bf16, rows padded by 8, the block's lifetime).
template <int C>
struct Bwd2Cfg : TileGeom<C> {
  using G_ = TileGeom<C>;
  static constexpr int KCH = C % 32 == 0 ? 32 : 16;  // chunk of the 1x1s
  static constexpr int C3 = 3 * C, LDK = KCH + 4, LDQ = 2 * C + 8, LDZ3 = C3 + 8;
  using CS_TAP = ColSum<G_::NT, KCH, 11>;
  static constexpr int SZ_XH = align128(G_::N2_P * G_::LDB * 2);
  static constexpr int SZ_Z = align128(G_::N2_P * LDK * 4);
  static constexpr int SZ_D = align128(G_::N1_P * LDK * 4);
  static constexpr int SZ_DZF = align128(G_::NP * LDK * 4);
  static constexpr int OFF_ZR = G_::N1_P * LDQ * 2;  // within Q
  static constexpr int OFF_DXH = align128(G_::N1_P * G_::LDB * 2);
  static constexpr int OFF_XHO = OFF_DXH + align128(G_::NP * G_::LDF * 4);
  static constexpr int SZ_Q = align128(cmax(2 * OFF_ZR, OFF_XHO + G_::NP * G_::LDB * 2));
  // Sums (floats): ddw [9,3C] | dbdw [3C] | db [3C].
  static constexpr int NSUM = 11 * C3;
  static constexpr int OFF_Z = SZ_XH, OFF_D = OFF_Z + SZ_Z, OFF_DZF = OFF_D + SZ_D;
  static constexpr int OFF_Q = OFF_DZF + SZ_DZF, OFF_DZ = OFF_Q + SZ_Q;
  static constexpr int OFF_RS = OFF_DZ + align128(G_::NP * LDZ3 * 2);
  static constexpr int OFF_SUM = OFF_RS + align128(G_::N2_P * 4);
  static constexpr int OFF_SCR = OFF_SUM + align128(NSUM * 4);
  // WT (bf16 offsets): wqk | wv | wqkvt | dgramt | dgram | applyt.
  static constexpr int W_WV = C * (2 * C + 8), W_WQKVT = W_WV + C * (C + 8);
  static constexpr int W_DGT = W_WQKVT + C3 * (C + 8), W_DGR = W_DGT + C * (C + 8);
  static constexpr int W_AT = W_DGR + C * (C + 8), SZ_WT = align128((W_AT + C * (C + 8)) * 2);
  static constexpr int OFF_WT = OFF_SCR + align128(CS_TAP::SCRATCH * 4);
  static constexpr bool WSM = OFF_WT + SZ_WT <= 232448;  // the weights fit: on chip
  static constexpr int LDW = WSM ? C + 8 : C, LDW2 = WSM ? 2 * C + 8 : 2 * C;
  static constexpr int SMEM = OFF_WT + (WSM ? SZ_WT : 0);
  static_assert(SMEM <= 232448, "B2 tile does not fit in shared memory");
  // The block's partial (floats). On chip: [dwqk|dwv] [C,3C] | sums; split:
  // sums.
  static constexpr int P_SUM = C * C3;
  static constexpr int E = G_::SPLIT ? round8(NSUM) : round8(P_SUM + NSUM);
  static constexpr int T_ALL = (C / 16) * (C3 / 16);
  static constexpr int NF = G_::SPLIT ? 1 : (T_ALL + G_::NW - 1) / G_::NW;
};

// dz = dw3x3^T(d) at own pixels inside the image for the chunk's channels
// (taps `dw`, row stride `ldw`), into dzf (fp32) and dz (bf16, column n0).
template <int C>
__device__ void dz_chunk(const float* d, const float* __restrict__ dw, int ldw, float* dzf,
                         bf16* dz, int n0, int H, int W, int r0, int c0) {
  using K = Bwd2Cfg<C>;
  constexpr int Q = K::KCH / 4;
  const int q = threadIdx.x % Q;
  float4 wt[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) wt[k] = ld4(dw + k * ldw + 4 * q);
  for (int p = threadIdx.x / Q; p < K::NP; p += K::NT / Q) {
    const int i = p / K::TW, j = p % K::TW;
    float4 s = f4(0.f);
#pragma unroll
    for (int k = 0; k < 9; ++k)
      s = fma4(ld4(d + ((i + 2 - k / 3) * K::W1C + j + 2 - k % 3) * K::LDK + 4 * q), wt[k], s);
    if (!inside(r0 + i, c0 + j, H, W)) s = f4(0.f);
    st4(dzf + p * K::LDK + 4 * q, s);
    st4(dz + p * K::LDZ3 + n0 + 4 * q, s);
  }
}

// Per-channel sums over own pixels for the chunk's channels: ddw (9 taps of
// z * d), dbdw (sum d), db (sum dz), added into sums at column n0. z is bf16
// at 1-ring coords (zr, stride ldz) or fp32 at 2-ring coords (zf).
template <int C>
__device__ void dw_sums(const float* d, const float* dzf, const bf16* zr, int ldz,
                        const float* zf, float* sums, float* scratch, int n0) {
  using K = Bwd2Cfg<C>;
  constexpr int Q = K::KCH / 4;
  const int q = threadIdx.x % Q;
  float4 s[11];
#pragma unroll
  for (int k = 0; k < 11; ++k) s[k] = f4(0.f);
  for (int p = threadIdx.x / Q; p < K::NP; p += K::NT / Q) {
    const int i = p / K::TW, j = p % K::TW;
    const float4 dv = ld4(d + ((i + 1) * K::W1C + j + 1) * K::LDK + 4 * q);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const float4 z = zr ? ld4(zr + ((i + k / 3) * K::W1C + j + k % 3) * ldz + 4 * q)
                          : ld4(zf + ((i + 1 + k / 3) * K::W2C + j + 1 + k % 3) * K::LDK + 4 * q);
      s[k] = fma4(dv, z, s[k]);
    }
    s[9] = add4(s[9], dv);
    s[10] = add4(s[10], ld4(dzf + p * K::LDK + 4 * q));
  }
  commit_colsums<K::NT, K::KCH, 11>(
      s, scratch, [&](int k, int n) -> float& { return sums[k * K::C3 + n0 + n]; });
}

template <int C>
__global__ void __launch_bounds__(TileGeom<C>::NT) bwd2_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ dx2,
    const bf16* __restrict__ applyt, const bf16* __restrict__ dgramt,
    const bf16* __restrict__ dgram, const float* __restrict__ dss,
    const bf16* __restrict__ wqk, const float* __restrict__ bqk,
    const float* __restrict__ dwqk, const float* __restrict__ bdwqk,
    const bf16* __restrict__ wv, const float* __restrict__ bv,
    const float* __restrict__ dwv, const float* __restrict__ bdwv,
    const bf16* __restrict__ wqkvt, bf16* __restrict__ dx, bf16* __restrict__ op_x,
    bf16* __restrict__ op_dz, float* __restrict__ partials, int H, int W, int tiles_w,
    int tiles) {
  using K = Bwd2Cfg<C>;
  constexpr bool SPLIT = K::SPLIT;
  constexpr int NT = K::NT, NW = K::NW, NP = K::NP, KCH = K::KCH, C2 = 2 * C, C3 = K::C3;
  constexpr int W2C = K::W2C, W1C = K::W1C;
  constexpr int LDB = K::LDB, LDF = K::LDF, LDK = K::LDK, LDQ = K::LDQ, LDZ3 = K::LDZ3;
  constexpr int Q = KCH / 4;
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
  float* sums = reinterpret_cast<float*>(sm + K::OFF_SUM);
  float* scr = reinterpret_cast<float*>(sm + K::OFF_SCR);

  const int tid = threadIdx.x, warp = tid / 32, q = tid % Q;
  const int b = blockIdx.y;
  const size_t img = (size_t)b * H * W * C, pix0 = (size_t)b * H * W;
  const bf16* dgt = dgramt + (size_t)b * C * C;
  const bf16* dgr = dgram + (size_t)b * C * C;
  const bf16* at = applyt + (size_t)b * C * C;
  float* part = partials + ((size_t)b * gridDim.x + blockIdx.x) * K::E;
  // The 1x1 weights and the image's [C, C] matrices: from shared memory
  // where they fit, else from device memory (L2).
  const bf16 *Wqk = wqk, *Wv = wv, *Wqkvt = wqkvt;
  if constexpr (K::WSM) {
    bf16* wt = reinterpret_cast<bf16*>(sm + K::OFF_WT);
    copy_rows<NT>(wt, K::LDW2, wqk, C, C2);
    copy_rows<NT>(wt + K::W_WV, K::LDW, wv, C, C);
    copy_rows<NT>(wt + K::W_WQKVT, K::LDW, wqkvt, C3, C);
    copy_rows<NT>(wt + K::W_DGT, K::LDW, dgt, C, C);
    copy_rows<NT>(wt + K::W_DGR, K::LDW, dgr, C, C);
    copy_rows<NT>(wt + K::W_AT, K::LDW, at, C, C);
    Wqk = wt, Wv = wt + K::W_WV, Wqkvt = wt + K::W_WQKVT;
    dgt = wt + K::W_DGT, dgr = wt + K::W_DGR, at = wt + K::W_AT;
  }
  constexpr int LDW = K::LDW, LDW2 = K::LDW2;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[K::NF];
#pragma unroll
  for (int f = 0; f < K::NF; ++f) wmma::fill_fragment(acc[f], 0.0f);
  for (int e = tid; e < K::NSUM; e += NT) sums[e] = 0.0f;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    // 2-ring (a, c) is global (r0-2+a, c0-2+c), 1-ring (r0-1+a, c0-1+c).
    const int r0 = (tile / tiles_w) * K::TH, c0 = (tile % tiles_w) * K::TW;

    load_window_async<C>(xh, LDB, K::N2_P, x + img, H, W, r0 - 2, c0 - 2, K::W2R, W2C, tid, NT);
    cp_async_commit();
    for (int e = tid; e < (K::N1_P - K::N1) * LDQ; e += NT)
      qk[K::N1 * LDQ + e] = f2bf(0.0f);  // padding rows of [q|k]
    cp_async_wait<0>();
    __syncthreads();
    layernorm_rows_vec<C, NT>(xh, LDB, xh, LDB, K::N2, rs);
    __syncthreads();

    // [q|k] = dw3x3(mask(LN1(x) @ wqk + bqk)) + bdwqk at the 1-ring, zero
    // outside the image; the pre-dw z kept at the 1-ring for the tap grads.
    for (int n0 = 0; n0 < C2; n0 += KCH) {
      gemm_bf16_w<K::N2_P, KCH, C>(warp, NW, xh, LDB, Wqk + n0, LDW2, z, LDK);
      __syncthreads();
      {
        const float4 bb = ld4(bqk + n0 + 4 * q);
        for (int p = tid / Q; p < K::N2; p += NT / Q) {
          float* zp = z + p * LDK + 4 * q;
          st4(zp, inside(r0 - 2 + p / W2C, c0 - 2 + p % W2C, H, W) ? add4(ld4(zp), bb) : f4(0.f));
        }
      }
      __syncthreads();
      {
        float4 wt[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) wt[k] = ld4(dwqk + k * C2 + n0 + 4 * q);
        const float4 bias = ld4(bdwqk + n0 + 4 * q);
        for (int p = tid / Q; p < K::N1; p += NT / Q) {
          const int a = p / W1C, c = p % W1C;
          float4 s = bias;
#pragma unroll
          for (int k = 0; k < 9; ++k)
            s = fma4(ld4(z + ((a + k / 3) * W2C + c + k % 3) * LDK + 4 * q), wt[k], s);
          st4(qk + p * LDQ + n0 + 4 * q, inside(r0 - 1 + a, c0 - 1 + c, H, W) ? s : f4(0.f));
          st4(zr + p * LDQ + n0 + 4 * q, ld4(z + ((a + 1) * W2C + c + 1) * LDK + 4 * q));
        }
      }
      __syncthreads();
    }

    // dq = k @ d_gram^T + 2 q d_qss, dk = q @ d_gram + 2 k d_kss (1-ring,
    // zero outside the image), then their dz and tap / bias sums.
    for (int n0 = 0; n0 < C2; n0 += KCH) {
      if (n0 < C)
        gemm_bf16_w<K::N1_P, KCH, C>(warp, NW, qk + C, LDQ, dgt + n0, LDW, d, LDK);
      else
        gemm_bf16_w<K::N1_P, KCH, C>(warp, NW, qk, LDQ, dgr + n0 - C, LDW, d, LDK);
      __syncthreads();
      {
        const float4 ds = ld4(dss + (size_t)b * C2 + n0 + 4 * q);
        for (int p = tid / Q; p < K::N1; p += NT / Q) {
          float* dp = d + p * LDK + 4 * q;
          const float4 qv = ld4(qk + p * LDQ + n0 + 4 * q);
          st4(dp, inside(r0 - 1 + p / W1C, c0 - 1 + p % W1C, H, W)
                      ? make_float4(dp[0] + 2.0f * qv.x * ds.x, dp[1] + 2.0f * qv.y * ds.y,
                                    dp[2] + 2.0f * qv.z * ds.z, dp[3] + 2.0f * qv.w * ds.w)
                      : f4(0.f));
        }
      }
      __syncthreads();
      dz_chunk<C>(d, dwqk + n0, C2, dzf, dz, n0, H, W, r0, c0);
      __syncthreads();
      dw_sums<C>(d, dzf, zr + n0, LDQ, nullptr, sums, scr, n0);
    }

    // dv = dx2 @ apply^T at the 1-ring; z of v recomputed at the 2-ring.
    load_window_async<C>(d2, LDB, K::N1_P, dx2 + img, H, W, r0 - 1, c0 - 1, K::W1R, W1C, tid, NT);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int n0 = 0; n0 < C; n0 += KCH) {
      gemm_bf16_w<K::N2_P, KCH, C>(warp, NW, xh, LDB, Wv + n0, LDW, z, LDK);
      gemm_bf16_w<K::N1_P, KCH, C>(warp, NW, d2, LDB, at + n0, LDW, d, LDK);
      __syncthreads();
      {
        const float4 bb = ld4(bv + n0 + 4 * q);
        for (int p = tid / Q; p < K::N2; p += NT / Q) {
          float* zp = z + p * LDK + 4 * q;
          st4(zp, inside(r0 - 2 + p / W2C, c0 - 2 + p % W2C, H, W) ? add4(ld4(zp), bb) : f4(0.f));
        }
      }
      __syncthreads();
      dz_chunk<C>(d, dwv + n0, C, dzf, dz, C2 + n0, H, W, r0, c0);
      __syncthreads();
      dw_sums<C>(d, dzf, nullptr, 0, z, sums, scr, C2 + n0);
    }

    // dx = dx2 + LN1^T(dz @ [wqk|wv]^T) at own pixels.
    gemm_bf16_w<NP, C, C3>(warp, NW, dz, LDZ3, Wqkvt, LDW, dxh, LDF);
    __syncthreads();
    ln_backward_own<C, K::TH, K::TW, NW>(dxh, LDF, xh, LDB, W2C, 2, rs, d2, LDB, nullptr, 0,
                                         dx + img, H, W, r0, c0);
    if constexpr (SPLIT) {
      // LN1(x) and [dz_q|dz_k|dz_v] at own pixels inside the image: the
      // operands of [dwqk|dwv] = LN1(x)^T dz (weight_grad.cu).
      constexpr int U = C / 8, U3 = C3 / 8;
      for (int e = tid; e < NP * (U + U3); e += NT) {
        const int p = e / (U + U3), u = e % (U + U3), i = p / K::TW, j = p % K::TW;
        if (!inside(r0 + i, c0 + j, H, W)) continue;
        const size_t px = pix0 + (size_t)(r0 + i) * W + c0 + j;
        if (u < U)
          copy16(op_x + px * C + 8 * u, xh + ((i + 2) * W2C + j + 2) * LDB + 8 * u);
        else
          copy16(op_dz + px * C3 + 8 * (u - U), dz + p * LDZ3 + 8 * (u - U));
      }
      __syncthreads();
    } else {
      __syncthreads();
      constexpr int U = C / 8;
      for (int e = tid; e < NP * U; e += NT) {
        const int p = e / U, u = e % U, i = p / K::TW, j = p % K::TW;
        *reinterpret_cast<uint4*>(xho + p * LDB + 8 * u) =
            inside(r0 + i, c0 + j, H, W)
                ? *reinterpret_cast<const uint4*>(xh + ((i + 2) * W2C + j + 2) * LDB + 8 * u)
                : make_uint4(0, 0, 0, 0);
      }
      __syncthreads();
#pragma unroll
      for (int f = 0; f < K::NF; ++f) {
        const int u = warp + f * NW;
        if (u < K::T_ALL) atb_tile<NP>(acc[f], xho, LDB, dz, LDZ3, u / (C3 / 16), u % (C3 / 16));
      }
      __syncthreads();
    }
  }
  __syncthreads();

  if constexpr (!SPLIT) {
#pragma unroll
    for (int f = 0; f < K::NF; ++f) {
      const int u = warp + f * NW;
      if (u < K::T_ALL)
        wmma::store_matrix_sync(part + (u / (C3 / 16)) * 16 * C3 + (u % (C3 / 16)) * 16, acc[f],
                                C3, wmma::mem_row_major);
    }
  }
  float* psum = part + (SPLIT ? 0 : K::P_SUM);
  for (int e = tid; e < K::NSUM; e += NT) psum[e] = sums[e];
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

// Persistent blocks per image: the blocks that fit on the card at once (the
// occupancy API's blocks per SM times the SMs), spread over the batch.
template <typename Kern>
int ctas_per_image(Kern kernel, int threads, int smem, int B, int tiles) {
  int dev = 0, sms = 132, per_sm = 1;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) ==
          cudaSuccess &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
          cudaSuccess)
    per_sm = 1;
  const int n = (per_sm < 1 ? 1 : per_sm) * sms / B;
  return n < 1 ? 1 : (n > tiles ? tiles : n);
}

template <typename Cfg>
int tiles_of(int H, int W) { return cdiv(H, Cfg::TH) * cdiv(W, Cfg::TW); }

template <int C>
int bwd1_ctas(int B, int H, int W) {
  using K = Bwd1Cfg<C>;
  return ctas_per_image(bwd1_kernel<C>, K::NT, K::SMEM, B, tiles_of<K>(H, W));
}
template <int C>
int bwd2_ctas(int B, int H, int W) {
  using K = Bwd2Cfg<C>;
  return ctas_per_image(bwd2_kernel<C>, K::NT, K::SMEM, B, tiles_of<K>(H, W));
}

template <int C>
cudaError_t bwd1_run(const void* const* p, bf16* const* ops, void* ws, void* dx2, float* dapply,
                     float* dw, int B, int H, int W, cudaStream_t s) {
  using K = Bwd1Cfg<C>;
  if ((ops[0] != nullptr) != K::SPLIT) return cudaErrorInvalidValue;
  const int tw = cdiv(W, K::TW), tiles = tiles_of<K>(H, W), nct = bwd1_ctas<C>(B, H, W);
  float* part = (float*)ws;
  cudaError_t err = launch(
      bwd1_kernel<C>, dim3(nct, B), dim3(K::NT), K::SMEM, s, (const bf16*)p[0],
      (const bf16*)p[1], (const bf16*)p[2], (const bf16*)p[3], (const float*)p[4],
      (const float*)p[5], (const float*)p[6], (const float*)p[7], (const bf16*)p[8],
      (const float*)p[9], (const float*)p[10], (const float*)p[11], (const bf16*)p[12],
      (const bf16*)p[13], (bf16*)dx2, ops[0], ops[1], ops[2], ops[3], part, H, W, tw, tiles);
  if (err != cudaSuccess) return err;
  float* gsum = dw + (K::P_SUM - C * C);  // the sums' place in the grad layout
  if (K::SPLIT)  // d_apply, dwp1, dwp2: weight_grad.cu
    return launch(sum_partials_kernel, dim3(cdiv(K::NSUM, 256), 1), dim3(256), 0, s, part,
                  (long long)K::E, gsum, B * nct, K::NSUM);
  err = launch(sum_partials_kernel, dim3(cdiv(C * C, 256), B), dim3(256), 0, s, part,
               (long long)K::E, dapply, nct, C * C);
  if (err != cudaSuccess) return err;
  const int n = K::P_SUM + K::NSUM - C * C;
  return launch(sum_partials_kernel, dim3(cdiv(n, 256), 1), dim3(256), 0, s, part + C * C,
                (long long)K::E, dw, B * nct, n);
}

template <int C>
cudaError_t bwd2_run(const void* const* p, bf16* const* ops, void* ws, void* dx, float* dw,
                     int B, int H, int W, cudaStream_t s) {
  using K = Bwd2Cfg<C>;
  if ((ops[0] != nullptr) != K::SPLIT) return cudaErrorInvalidValue;
  const int tw = cdiv(W, K::TW), tiles = tiles_of<K>(H, W), nct = bwd2_ctas<C>(B, H, W);
  float* part = (float*)ws;
  cudaError_t err = launch(
      bwd2_kernel<C>, dim3(nct, B), dim3(K::NT), K::SMEM, s, (const bf16*)p[0],
      (const bf16*)p[1], (const bf16*)p[2], (const bf16*)p[3], (const bf16*)p[4],
      (const float*)p[5], (const bf16*)p[6], (const float*)p[7], (const float*)p[8],
      (const float*)p[9], (const bf16*)p[10], (const float*)p[11], (const float*)p[12],
      (const float*)p[13], (const bf16*)p[14], (bf16*)dx, ops[0], ops[1], part, H, W, tw,
      tiles);
  if (err != cudaSuccess) return err;
  if (K::SPLIT)  // [dwqk|dwv]: weight_grad.cu
    return launch(sum_partials_kernel, dim3(cdiv(K::NSUM, 256), 1), dim3(256), 0, s, part,
                  (long long)K::E, dw + K::P_SUM, B * nct, K::NSUM);
  const int n = K::P_SUM + K::NSUM;
  return launch(sum_partials_kernel, dim3(cdiv(n, 256), 1), dim3(256), 0, s, part,
                (long long)K::E, dw, B * nct, n);
}

#define BLLE_WIDTHS(X) X(32) X(48) X(64) X(96) X(128) X(192) X(256)

}  // namespace

// Floats of device workspace (the per-block partials) B1 / B2 need.
extern "C" long long blle_bwd1_workspace_floats(int B, int H, int W, int C) {
  switch (C) {
#define BLLE_WS(c) \
  case c: return (long long)B * bwd1_ctas<c>(B, H, W) * Bwd1Cfg<c>::E;
    BLLE_WIDTHS(BLLE_WS)
#undef BLLE_WS
    default: return -1;
  }
}
extern "C" long long blle_bwd2_workspace_floats(int B, int H, int W, int C) {
  switch (C) {
#define BLLE_WS(c) \
  case c: return (long long)B * bwd2_ctas<c>(B, H, W) * Bwd2Cfg<c>::E;
    BLLE_WIDTHS(BLLE_WS)
#undef BLLE_WS
    default: return -1;
  }
}

// Floats of B1's / B2's weight-grad output. B1: dwp1 [C,2C] | dwp2 [2C,C] |
// ddwf [9,2C] | dbdwf [2C] | dbp1 [2C] | dbp2 [C] | dbproj [C]; B2: [dwqk|dwv]
// [C,3C] | ddw [9,3C] | dbdw [3C] | db [3C] (kernels/fused_block_bwd.py
// splits them).
extern "C" long long blle_bwd1_grad_floats(int C) {
  switch (C) {
#define BLLE_G(c) case c: return Bwd1Cfg<c>::P_SUM + Bwd1Cfg<c>::NSUM - c * c;
    BLLE_WIDTHS(BLLE_G)
#undef BLLE_G
    default: return -1;
  }
}
extern "C" long long blle_bwd2_grad_floats(int C) {
  switch (C) {
#define BLLE_G(c) case c: return Bwd2Cfg<c>::P_SUM + Bwd2Cfg<c>::NSUM;
    BLLE_WIDTHS(BLLE_G)
#undef BLLE_G
    default: return -1;
  }
}

// B1. x, dy [B,H,W,C] bf16; apply [B,C,C] bf16; wv [C,C] bf16; bv, dwv [9,C],
// bdwv, bproj fp32; wp1 [C,2C] bf16; bp1, dwf [9,2C], bdwf fp32; wp2t [C,2C]
// and wp1t [2C,C] bf16 (transposes of wp2 and wp1); at C >= 96 the operand
// buffers v, LN2(y) [B*H*W, C] and dt, GELU(f_pre) [B*H*W, 2C] bf16 (null
// below) -> dx2 [B,H,W,C] bf16, dapply [B,C,C] fp32 and dw (B1 grad layout)
// fp32; at C >= 96 d_apply, dwp1 and dwp2 are left to weight_grad.cu.
extern "C" int blle_bwd1(const void* x, const void* dy, const void* apply, const void* wv,
                         const void* bv, const void* dwv, const void* bdwv, const void* bproj,
                         const void* wp1, const void* bp1, const void* dwf, const void* bdwf,
                         const void* wp2t, const void* wp1t, void* op_v, void* op_y,
                         void* op_dt, void* op_g, void* workspace, void* dx2, void* dapply,
                         void* dw, int B, int H, int W, int C, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const void* p[14] = {x, dy, apply, wv, bv, dwv, bdwv, bproj, wp1, bp1, dwf, bdwf, wp2t, wp1t};
  bf16* ops[4] = {(bf16*)op_v, (bf16*)op_y, (bf16*)op_dt, (bf16*)op_g};
  float *da = (float*)dapply, *g = (float*)dw;
  switch (C) {
#define BLLE_RUN(c) case c: return (int)bwd1_run<c>(p, ops, workspace, dx2, da, g, B, H, W, s);
    BLLE_WIDTHS(BLLE_RUN)
#undef BLLE_RUN
    default: return (int)cudaErrorInvalidValue;
  }
}

// B2. x, dx2 [B,H,W,C] bf16; applyt, dgramt, dgram [B,C,C] bf16 (apply^T,
// d_gram^T, d_gram); dss [B,2C] fp32 (d_qss | d_kss); wqk [C,2C] bf16; bqk,
// dwqk [9,2C], bdwqk fp32; wv [C,C] bf16; bv, dwv [9,C], bdwv fp32; wqkvt
// [3C,C] bf16 ([wqk|wv]^T); at C >= 96 the operand buffers LN1(x)
// [B*H*W, C] and dz [B*H*W, 3C] bf16 (null below) -> dx [B,H,W,C] bf16, dw
// (B2 grad layout) fp32; at C >= 96 [dwqk|dwv] is left to weight_grad.cu.
extern "C" int blle_bwd2(const void* x, const void* dx2, const void* applyt,
                         const void* dgramt, const void* dgram, const void* dss,
                         const void* wqk, const void* bqk, const void* dwqk, const void* bdwqk,
                         const void* wv, const void* bv, const void* dwv, const void* bdwv,
                         const void* wqkvt, void* op_x, void* op_dz, void* workspace, void* dx,
                         void* dw, int B, int H, int W, int C, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const void* p[15] = {x, dx2, applyt, dgramt, dgram, dss, wqk, bqk,
                       dwqk, bdwqk, wv, bv, dwv, bdwv, wqkvt};
  bf16* ops[2] = {(bf16*)op_x, (bf16*)op_dz};
  float* g = (float*)dw;
  switch (C) {
#define BLLE_RUN(c) case c: return (int)bwd2_run<c>(p, ops, workspace, dx, g, B, H, W, s);
    BLLE_WIDTHS(BLLE_RUN)
#undef BLLE_RUN
    default: return (int)cudaErrorInvalidValue;
  }
}
