// T1: the ConvTransformer stage tail, the port of the retired TPU kernel
// `fused_stage_tail` (attic/fused_stage.py):
//
//   conv = lrelu(conv3x3(x) + b_c)
//   y    = conv @ Wr[:C] + t @ Wr[C:] + b_r      (the concat [conv, t] folded
//                                                  into the split weight)
//   out  = lrelu(conv3x3(y) + b_o)
//
// 3x3 convs with SAME zero padding, lrelu slope 0.2; x and t bf16, products
// on the tensor cores (WMMA, fp32 accumulate), conv and y rounded to bf16
// (as the TPU kernel rounds them). One pass over tiles: x with a 2-pixel
// halo, t with a 1-pixel halo; conv and y stay in shared memory.
//
// Each full 3x3 conv is an implicit GEMM of 9 per-tap [pixels, C] x [C, C]
// products. Every buffer keeps pixels in the window's row stride WC =
// TW + 4, so tap (di, dj) of output row m is input row m + di * WC + dj: the
// A operand of a tap is the buffer itself at a row offset (two columns per
// row of garbage outputs are computed and dropped). Row offsets are
// arbitrary, so rows are 32-byte aligned (stride C + 16 bf16) as WMMA loads
// require. The tap weights (9 C^2 bf16, 1.2 MB at C = 256) are read as WMMA
// B fragments from global memory (L2) and never staged in shared memory.
//
// Bound: the tensor-core products (2 x 9 taps + 2 reduce products per
// pixel, C^2 MACs each), done at WMMA's rate with tile halos recomputed
// ((TH+2)(TW+4) conv rows per TH*TW outputs); the bytes (x, t in, out) are
// far smaller. Widths: C in {32, 48, 64, 96, 128, 192, 256}.
#include "common.cuh"

using namespace nvcuda;

namespace {

template <int C>
struct TailCfg {
  static constexpr int TH = C > 128 ? 4 : 8, TW = C > 64 ? 8 : 16;
  static constexpr int KCH = C % 32 == 0 ? 32 : 16;
  static constexpr int WC = TW + 4;                  // row stride of every buffer
  static constexpr int M1 = round16((TH + 2) * WC);  // conv / y rows (the ring)
  static constexpr int M2 = round16(TH * WC);        // output rows
  static constexpr int NX = round16(M1 + 2 * WC + 2);  // x rows (taps read past M1)
  static constexpr int LDB = C + 16, LDK = KCH + 4;
  static constexpr int SZ_X = align128(NX * LDB * 2);   // x window, then y
  static constexpr int SZ_T = align128(M1 * LDB * 2);   // t at the ring
  static constexpr int SZ_CV = align128(M1 * LDB * 2);  // conv at the ring
  static constexpr int OFF_T = SZ_X, OFF_CV = OFF_T + SZ_T, OFF_Z = OFF_CV + SZ_CV;
  static constexpr int SMEM = OFF_Z + align128(M1 * LDK * 4);
  static_assert(SMEM <= 232448, "T1 shared memory exceeds 227 KB");
  static_assert(M2 + 2 * WC + 2 <= NX, "conv_out taps read past the y buffer");
};

// rows x C bf16 of one NHWC image into dst (row stride ld): buffer row p is
// global pixel (r0 + p / WC, c0 + p % WC) when p / WC < nr and p % WC < nc,
// zero otherwise and outside the image.
template <int C>
__device__ void load_strided(bf16* dst, int ld, int rows, const bf16* __restrict__ img, int H,
                             int W, int r0, int c0, int WC, int nr, int nc) {
  constexpr int U = C / 8;
  for (int e = threadIdx.x; e < rows * U; e += kThreads) {
    const int p = e / U, part = e % U;
    const int i = p / WC, j = p % WC;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (i < nr && j < nc && inside(r0 + i, c0 + j, H, W))
      val = *reinterpret_cast<const uint4*>(img + ((size_t)(r0 + i) * W + c0 + j) * C +
                                            part * 8);
    *reinterpret_cast<uint4*>(dst + p * ld + part * 8) = val;
  }
}

// out[M][KCH] (fp32) = sum over the 9 taps of a[m + di*WC + dj][:] @
// w[tap][:, n0:n0+KCH] (w [9][C][C] bf16, global).
template <int C, int M>
__device__ void conv3x3_chunk(const bf16* a, const bf16* __restrict__ w, int n0, float* out) {
  using T = TailCfg<C>;
  constexpr int NT = T::KCH / 16;
  const int warp = threadIdx.x / 32;
  for (int tt = warp; tt < (M / 16) * NT; tt += kWarps) {
    const int mi = tt / NT, ni = tt % NT;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int tap = 0; tap < 9; ++tap) {
      const bf16* at = a + (mi * 16 + (tap / 3) * T::WC + tap % 3) * T::LDB;
      const bf16* wt = w + (size_t)tap * C * C + n0 + ni * 16;
      for (int k = 0; k < C; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, at + k, T::LDB);
        wmma::load_matrix_sync(fb, wt + (size_t)k * C, C);
        wmma::mma_sync(acc, fa, fb, acc);
      }
    }
    wmma::store_matrix_sync(out + mi * 16 * T::LDK + ni * 16, acc, T::LDK, wmma::mem_row_major);
  }
}

// out[M1][KCH] = a1 @ w1[:, n0:] + a2 @ w2[:, n0:] (the split reduce).
template <int C>
__device__ void reduce_chunk(const bf16* a1, const bf16* a2, const bf16* __restrict__ w1,
                             const bf16* __restrict__ w2, int n0, float* out) {
  using T = TailCfg<C>;
  constexpr int NT = T::KCH / 16;
  const int warp = threadIdx.x / 32;
  for (int tt = warp; tt < (T::M1 / 16) * NT; tt += kWarps) {
    const int mi = tt / NT, ni = tt % NT;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int half = 0; half < 2; ++half) {
      const bf16* a = (half ? a2 : a1) + mi * 16 * T::LDB;
      const bf16* w = (half ? w2 : w1) + n0 + ni * 16;
      for (int k = 0; k < C; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, a + k, T::LDB);
        wmma::load_matrix_sync(fb, w + (size_t)k * C, C);
        wmma::mma_sync(acc, fa, fb, acc);
      }
    }
    wmma::store_matrix_sync(out + mi * 16 * T::LDK + ni * 16, acc, T::LDK, wmma::mem_row_major);
  }
}

__device__ __forceinline__ float lrelu(float v) { return v >= 0.0f ? v : 0.2f * v; }

template <int C>
__global__ void __launch_bounds__(kThreads) stage_tail_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ t, const bf16* __restrict__ wc,
    const float* __restrict__ bc, const bf16* __restrict__ wr1, const bf16* __restrict__ wr2,
    const float* __restrict__ br, const bf16* __restrict__ wo, const float* __restrict__ bo,
    bf16* __restrict__ out, int H, int W, int tiles_w) {
  using T = TailCfg<C>;
  unsigned char* sm = dyn_smem();
  bf16* xs = reinterpret_cast<bf16*>(sm);  // x window; y once conv is done
  bf16* ys = reinterpret_cast<bf16*>(sm);
  bf16* ts = reinterpret_cast<bf16*>(sm + T::OFF_T);
  bf16* cv = reinterpret_cast<bf16*>(sm + T::OFF_CV);
  float* zs = reinterpret_cast<float*>(sm + T::OFF_Z);
  const int tile = blockIdx.x, b = blockIdx.y;
  const int r0 = (tile / tiles_w) * T::TH, c0 = (tile % tiles_w) * T::TW;
  const size_t img = (size_t)b * H * W * C;

  // Row m of the ring buffers is global (r0 - 1 + m / WC, c0 - 1 + m % WC),
  // a ring pixel when m % WC < TW + 2; row m of x is global (r0 - 2 + m / WC,
  // c0 - 2 + m % WC); output row m is global (r0 + m / WC, c0 + m % WC).
  auto ring_in = [&](int m) {
    return m < (T::TH + 2) * T::WC && m % T::WC < T::TW + 2 &&
           inside(r0 - 1 + m / T::WC, c0 - 1 + m % T::WC, H, W);
  };
  load_strided<C>(xs, T::LDB, T::NX, x + img, H, W, r0 - 2, c0 - 2, T::WC, T::TH + 4,
                  T::TW + 4);
  load_strided<C>(ts, T::LDB, T::M1, t + img, H, W, r0 - 1, c0 - 1, T::WC, T::TH + 2,
                  T::TW + 2);
  __syncthreads();

  // conv = lrelu(conv3x3(x) + bc) at the ring, zero outside the image.
  for (int n0 = 0; n0 < C; n0 += T::KCH) {
    conv3x3_chunk<C, T::M1>(xs, wc, n0, zs);
    __syncthreads();
    for (int e = threadIdx.x; e < T::M1 * T::KCH; e += kThreads) {
      const int m = e / T::KCH, n = e % T::KCH;
      cv[m * T::LDB + n0 + n] = f2bf(ring_in(m) ? lrelu(zs[m * T::LDK + n] + bc[n0 + n]) : 0.0f);
    }
    __syncthreads();
  }
  // y = conv @ wr1 + t @ wr2 + br at the ring, zero outside (conv_out's
  // padding), over the x window (dead now).
  for (int n0 = 0; n0 < C; n0 += T::KCH) {
    reduce_chunk<C>(cv, ts, wr1, wr2, n0, zs);
    __syncthreads();
    for (int e = threadIdx.x; e < T::M1 * T::KCH; e += kThreads) {
      const int m = e / T::KCH, n = e % T::KCH;
      ys[m * T::LDB + n0 + n] = f2bf(ring_in(m) ? zs[m * T::LDK + n] + br[n0 + n] : 0.0f);
    }
    __syncthreads();
  }
  // out = lrelu(conv3x3(y) + bo) at own pixels inside the image.
  for (int n0 = 0; n0 < C; n0 += T::KCH) {
    conv3x3_chunk<C, T::M2>(ys, wo, n0, zs);
    __syncthreads();
    for (int e = threadIdx.x; e < T::M2 * T::KCH; e += kThreads) {
      const int m = e / T::KCH, n = e % T::KCH;
      const int i = m / T::WC, j = m % T::WC;
      if (i < T::TH && j < T::TW && inside(r0 + i, c0 + j, H, W))
        out[img + ((size_t)(r0 + i) * W + c0 + j) * C + n0 + n] =
            f2bf(lrelu(zs[m * T::LDK + n] + bo[n0 + n]));
    }
    __syncthreads();
  }
}

template <int C>
cudaError_t stage_tail_tiles(const void* const* p, void* out, int B, int H, int W,
                             cudaStream_t s) {
  using T = TailCfg<C>;
  const int tw = cdiv(W, T::TW), tiles = cdiv(H, T::TH) * tw;
  return launch(stage_tail_kernel<C>, dim3(tiles, B), dim3(kThreads), T::SMEM, s,
                (const bf16*)p[0], (const bf16*)p[1], (const bf16*)p[2], (const float*)p[3],
                (const bf16*)p[4], (const bf16*)p[5], (const float*)p[6], (const bf16*)p[7],
                (const float*)p[8], (bf16*)out, H, W, tw);
}

}  // namespace

// x, t [B,H,W,C] bf16; wc, wo [9][C][C] bf16 (tap di*3+dj, in, out); wr1, wr2
// [C][C] bf16 (the reduce weight's conv and t halves); bc, br, bo [C] fp32
// -> out [B,H,W,C] bf16.
extern "C" int blle_stage_tail(const void* x, const void* t, const void* wc, const void* bc,
                               const void* wr1, const void* wr2, const void* br,
                               const void* wo, const void* bo, void* out, int B, int H, int W,
                               int C, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const void* p[9] = {x, t, wc, bc, wr1, wr2, br, wo, bo};
  switch (C) {
    case 32: return (int)stage_tail_tiles<32>(p, out, B, H, W, s);
    case 48: return (int)stage_tail_tiles<48>(p, out, B, H, W, s);
    case 64: return (int)stage_tail_tiles<64>(p, out, B, H, W, s);
    case 96: return (int)stage_tail_tiles<96>(p, out, B, H, W, s);
    case 128: return (int)stage_tail_tiles<128>(p, out, B, H, W, s);
    case 192: return (int)stage_tail_tiles<192>(p, out, B, H, W, s);
    case 256: return (int)stage_tail_tiles<256>(p, out, B, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
