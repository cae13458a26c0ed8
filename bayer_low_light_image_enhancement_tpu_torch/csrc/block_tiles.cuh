// The tiled passes of the fused TransformerBlock forward, K2 (gram) and K3
// (apply + FFN), as templates shared by the translation units that
// instantiate them: fused_block.cu (the production K2 and K3),
// fused_block_banded.cu (K2 and K3 in band mode, BAND = true),
// fused_attention.cu (A1's gram and apply passes: K2 and K3's phase 1
// without their LayerNorm) and
// probes_bisect.cu (K3 cut after an earlier stage). fused_block.cu says what
// the passes compute; this file says how they are laid out on the H100.
//
// Every kernel here is persistent: the grid is the occupancy API's blocks
// per SM times the SMs, and each block (CTA) walks a contiguous run of tiles
// in strip order (down a column of tiles, then the next column), so that
// neighbouring windows share their halo rows in L2. The next tile's window
// arrives by cp.async into a second buffer while the current tile computes.
//
// Products run on the tensor cores with mma.sync m16n8k16 (bf16 in, fp32
// accumulate), both operands read from shared memory by ldmatrix: the
// activations [pixels, C] (channels contiguous) are A, K-major; the weights
// [in, out] are B, read transposed. A warp computes 32x16 output items (two
// m16 by two n8 tiles) so that each fragment it loads feeds two products.
// wgmma is not used: its 64-row M would pad the 60-180-row windows of
// these tiles, and its K-major A layout is unsettled on this card, where
// mma.sync from shared memory needs no layout probe.
//
// Weights never come from device memory into fragments. At C <= 64 all of a
// kernel's weights stay in shared memory for the CTA's whole walk (K3's
// per-image `apply` is reloaded when the walk enters another image). Above
// that they stream through a two-slot cp.async ring in chunks of 64 output
// channels (or 64 K rows of the FFN projection), the next chunk arriving
// while the current one multiplies.
//
// LayerNorm runs a quad of lanes per row (8-byte loads, the sums by two
// shuffles), in place on the window. Bias and the image-edge mask are the
// epilogue of the product that feeds them, written straight into the fp32
// chunk the depthwise conv reads; the depthwise conv runs 4 channels a
// thread with its 9 taps in registers, and GELU and bf16 rounding are its
// epilogue. The taps and biases sit in shared memory for the CTA's walk:
// read from device memory in each chunk's epilogue, their latency was on
// the critical path of every step.
#ifndef BLLE_BLOCK_TILES_CUH
#define BLLE_BLOCK_TILES_CUH

#include "common.cuh"

namespace {

constexpr int kSmemPerSm = 233472;   // shared memory of one H100 SM
constexpr int kSmemPerBlock = 232448;  // the most one block may use
// Two 256-thread CTAs per SM where two fit (the runtime keeps 1 KB per
// block), else one of 512 threads: 16 warps per SM either way.
__host__ __device__ constexpr int block_threads(int smem) {
  return 2 * (smem + 1024) <= kSmemPerSm ? 256 : 512;
}

// ---------------------------------------------------------------------------
// mma.sync m16n8k16 from shared memory.
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x2_t(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}
// d += A (16x16, row) B (16x8, col); thread t holds d[0..1] = D[t/4][2(t%4)
// + 0..1] and d[2..3] the same columns of row t/4 + 8.
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of rows [m0, m0+16) and k [k0, k0+16). AT false: A is
// stored [M][K] (row stride lda); AT true: A is stored transposed, [K][M]
// (the gram's q^T, read from q [pixels][channels]).
template <bool AT>
__device__ __forceinline__ void load_a(unsigned (&a)[4], const bf16* A, int lda, int m0, int k0,
                                       int lane) {
  if constexpr (!AT) {
    ldsm_x4(a, A + (m0 + (lane & 15)) * lda + k0 + (lane >> 4) * 8);
  } else {
    const int mi = lane >> 3, r = lane & 7;
    ldsm_x4_t(a, A + (k0 + r + (mi >> 1) * 8) * lda + m0 + (mi & 1) * 8);
  }
}
// B stored [K][N] (row stride ldb): the fragments of the n8 tiles at n0 and
// n0 + 8 (b[0..1], b[2..3]), or of the one at n0.
__device__ __forceinline__ void load_b2(unsigned (&b)[4], const bf16* B, int ldb, int k0, int n0,
                                        int lane) {
  const int mi = lane >> 3, r = lane & 7;
  ldsm_x4_t(b, B + (k0 + r + (mi & 1) * 8) * ldb + n0 + (mi >> 1) * 8);
}
__device__ __forceinline__ void load_b1(unsigned (&b)[4], const bf16* B, int ldb, int k0, int n0,
                                        int lane) {
  const int l = lane & 15;
  unsigned t[2];
  ldsm_x2_t(t, B + (k0 + (l & 7) + (l >> 3) * 8) * ldb + n0);
  b[0] = t[0], b[1] = t[1], b[2] = b[3] = 0u;
}

// The items of an MT x NT8 product (m16 x n8 tiles) for NW warps: MG x NG
// tiles each, 2 x 2 (every fragment a warp loads feeds two products) where
// that still gives every warp an item, else 1 x 2, else 1 x 1; dealt
// round-robin, PER items a warp at most.
template <int NW, int MT, int NT8>
struct Items {
  static constexpr int MG = (MT + 1) / 2 * ((NT8 + 1) / 2) >= NW ? 2 : 1;
  static constexpr int NG = MG == 2 || MT * ((NT8 + 1) / 2) >= NW ? 2 : 1;
  static constexpr int MGS = (MT + MG - 1) / MG, NGS = (NT8 + NG - 1) / NG, N = MGS * NGS;
  static constexpr int PER = (N + NW - 1) / NW;
};

// acc[i][j] += A[m tile mi0+i] B[n8 tile ni0+j] over k in [0, K), for
// i < MG, j < NG and the tiles that exist (MT m16 tiles, NT8 n8 tiles).
template <bool AT, int MG, int NG, int MT, int NT8, int K>
__device__ __forceinline__ void mma_item(float (&acc)[2][2][4], const bf16* A, int lda,
                                         const bf16* B, int ldb, int mi0, int ni0, int lane) {
  const bool m1 = MG == 2 && mi0 + 1 < MT, n1 = NG == 2 && ni0 + 1 < NT8;
#pragma unroll 4
  for (int k0 = 0; k0 < K; k0 += 16) {
    unsigned a[4], b[4];
    if (n1)
      load_b2(b, B, ldb, k0, ni0 * 8, lane);
    else
      load_b1(b, B, ldb, k0, ni0 * 8, lane);
    load_a<AT>(a, A, lda, mi0 * 16, k0, lane);
    mma16816(acc[0][0], a, b[0], b[1]);
    if (n1) mma16816(acc[0][1], a, b[2], b[3]);
    if (m1) {
      load_a<AT>(a, A, lda, (mi0 + 1) * 16, k0, lane);
      mma16816(acc[1][0], a, b[0], b[1]);
      if (n1) mma16816(acc[1][1], a, b[2], b[3]);
    }
  }
}

// epi(row, col, v0, v1) for the two adjacent columns col, col+1 of each
// output row an item's accumulators hold.
template <int MG, int NG, int MT, int NT8, typename Epi>
__device__ __forceinline__ void item_epilogue(const float (&acc)[2][2][4], int mi0, int ni0,
                                              int lane, Epi&& epi) {
#pragma unroll
  for (int i = 0; i < MG; ++i)
#pragma unroll
    for (int j = 0; j < NG; ++j)
      if (mi0 + i < MT && ni0 + j < NT8) {
        const int row = (mi0 + i) * 16 + lane / 4, col = (ni0 + j) * 8 + 2 * (lane % 4);
        epi(row, col, acc[i][j][0], acc[i][j][1]);
        epi(row + 8, col, acc[i][j][2], acc[i][j][3]);
      }
}

// out (via epi) = A [MT*16][K] @ B [K][NT8*8], by NW warps: the group of
// threads tid in [0, 32 NW) (the block's by default; a group's warps are
// whole warps, so lane = tid % 32).
template <int NW, int MT, int NT8, int K, typename Epi>
__device__ __forceinline__ void product_t(int tid, const bf16* A, int lda, const bf16* B,
                                          int ldb, Epi&& epi) {
  using I = Items<NW, MT, NT8>;
  const int warp = tid / 32, lane = tid % 32;
  for (int it = warp; it < I::N; it += NW) {
    const int mi0 = it / I::NGS * I::MG, ni0 = it % I::NGS * I::NG;
    float acc[2][2][4] = {};
    mma_item<false, I::MG, I::NG, MT, NT8, K>(acc, A, lda, B, ldb, mi0, ni0, lane);
    item_epilogue<I::MG, I::NG, MT, NT8>(acc, mi0, ni0, lane, epi);
  }
}
template <int NW, int MT, int NT8, int K, typename Epi>
__device__ __forceinline__ void product(const bf16* A, int lda, const bf16* B, int ldb,
                                        Epi&& epi) {
  product_t<NW, MT, NT8, K>(threadIdx.x, A, lda, B, ldb, epi);
}

// acc (+)= the same product, each warp keeping its items' accumulators in
// registers across calls (the gram over a walk, the FFN projection over its
// K chunks).
template <bool AT, int NW, int MT, int NT8, int K>
__device__ __forceinline__ void product_acc_t(int tid,
                                              float (&acc)[Items<NW, MT, NT8>::PER][2][2][4],
                                              const bf16* A, int lda, const bf16* B, int ldb) {
  using I = Items<NW, MT, NT8>;
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int s = 0; s < I::PER; ++s) {
    const int it = warp + s * NW;
    if (it < I::N)
      mma_item<AT, I::MG, I::NG, MT, NT8, K>(acc[s], A, lda, B, ldb, it / I::NGS * I::MG,
                                             it % I::NGS * I::NG, lane);
  }
}
template <bool AT, int NW, int MT, int NT8, int K>
__device__ __forceinline__ void product_acc(float (&acc)[Items<NW, MT, NT8>::PER][2][2][4],
                                            const bf16* A, int lda, const bf16* B, int ldb) {
  product_acc_t<AT, NW, MT, NT8, K>(threadIdx.x, acc, A, lda, B, ldb);
}

template <int NW, int MT, int NT8, typename Epi>
__device__ __forceinline__ void acc_epilogue_t(
    int tid, const float (&acc)[Items<NW, MT, NT8>::PER][2][2][4], Epi&& epi) {
  using I = Items<NW, MT, NT8>;
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int s = 0; s < I::PER; ++s) {
    const int it = warp + s * NW;
    if (it < I::N)
      item_epilogue<I::MG, I::NG, MT, NT8>(acc[s], it / I::NGS * I::MG, it % I::NGS * I::NG, lane,
                                           epi);
  }
}
template <int NW, int MT, int NT8, typename Epi>
__device__ __forceinline__ void acc_epilogue(const float (&acc)[Items<NW, MT, NT8>::PER][2][2][4],
                                             Epi&& epi) {
  acc_epilogue_t<NW, MT, NT8>(threadIdx.x, acc, epi);
}

// ---------------------------------------------------------------------------
// Element helpers.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float4 fma4(float4 a, float4 b, float4 c) {
  return make_float4(fmaf(a.x, b.x, c.x), fmaf(a.y, b.y, c.y), fmaf(a.z, b.z, c.z),
                     fmaf(a.w, b.w, c.w));
}
__device__ __forceinline__ unsigned pack_bf2(float a, float b) {
  return (unsigned)__bfloat16_as_ushort(f2bf(a)) |
         ((unsigned)__bfloat16_as_ushort(f2bf(b)) << 16);
}
__device__ __forceinline__ float bf_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }
// 4 values rounded to bf16 at p (8 bytes).
__device__ __forceinline__ void st_bf4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf2(v.x, v.y), pack_bf2(v.z, v.w));
}
// Global bf16 pair at p (4-byte aligned).
__device__ __forceinline__ float2 ld_bf2(const bf16* p) {
  const unsigned w = *reinterpret_cast<const unsigned*>(p);
  return make_float2(bf_lo(w), bf_hi(w));
}
__device__ __forceinline__ void st_bf2(bf16* p, float a, float b) {
  *reinterpret_cast<unsigned*>(p) = pack_bf2(a, b);
}
__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// LayerNorm without affine (biased variance, eps 1e-5, fp32 statistics) of
// rows [0, n) of bf16 rows (stride ld), in place: a quad of lanes per row,
// lane q of the quad holding the 4-channel units q, q + 4, ... (8-byte
// loads), the sums by two shuffles. A zero row stays zero. Threads tid in
// [0, NT) (whole warps) share the rows.
template <int C, int NT>
__device__ void layernorm_quads_t(int tid, bf16* rows, int ld, int n) {
  constexpr int U = C / 16;
  const int quad = tid / 4, ql = tid % 4;
  for (int base = 0; base < n; base += NT / 4) {
    const int p = base + quad;
    bf16* r = rows + (p < n ? p : 0) * ld;
    float v[U][4];
    float s = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const uint2 w = *reinterpret_cast<const uint2*>(r + (u * 4 + ql) * 4);
      v[u][0] = bf_lo(w.x), v[u][1] = bf_hi(w.x), v[u][2] = bf_lo(w.y), v[u][3] = bf_hi(w.y);
      s += (v[u][0] + v[u][1]) + (v[u][2] + v[u][3]);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    const float mu = s * (1.0f / C);
    float q = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) q += (v[u][e] - mu) * (v[u][e] - mu);
    q += __shfl_xor_sync(0xffffffffu, q, 1);
    q += __shfl_xor_sync(0xffffffffu, q, 2);
    const float inv = rsqrtf(q * (1.0f / C) + 1e-5f);
    if (p < n) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        *reinterpret_cast<uint2*>(r + (u * 4 + ql) * 4) =
            make_uint2(pack_bf2((v[u][0] - mu) * inv, (v[u][1] - mu) * inv),
                       pack_bf2((v[u][2] - mu) * inv, (v[u][3] - mu) * inv));
    }
  }
}
template <int C, int NT>
__device__ void layernorm_quads(bf16* rows, int ld, int n) {
  layernorm_quads_t<C, NT>(threadIdx.x, rows, ld, n);
}

// dst[k][0:ncols] (stride ldd) <- src[k * lds + col(j)] for j < ncols, k <
// rows, by cp.async in 8-column units (col maps a unit's first column and
// keeps the unit contiguous); issued by the NT threads tid (the block's by
// default).
template <int NT, typename Col>
__device__ __forceinline__ void load_rows_async_t(int tid, bf16* dst, int ldd,
                                                  const bf16* __restrict__ src, int lds, int rows,
                                                  int ncols, Col&& col) {
  const int u8 = ncols / 8;
  for (int e = tid; e < rows * u8; e += NT) {
    const int k = e / u8, u = e % u8;
    cp_async16(dst + k * ldd + u * 8, src + (size_t)k * lds + col(u * 8), true);
  }
}
template <int NT, typename Col>
__device__ __forceinline__ void load_rows_async(bf16* dst, int ldd, const bf16* __restrict__ src,
                                                int lds, int rows, int ncols, Col&& col) {
  load_rows_async_t<NT>(threadIdx.x, dst, ldd, src, lds, rows, ncols, col);
}
struct Same {
  __device__ int operator()(int c) const { return c; }
};
// dst[j] (fp32) <- src[col(j)] for j < n, by cp.async in 4-float units.
template <int NT, typename Col>
__device__ __forceinline__ void load_vec_async_t(int tid, float* dst,
                                                 const float* __restrict__ src, int n, Col&& col) {
  for (int u = tid; u < n / 4; u += NT) cp_async16(dst + 4 * u, src + col(4 * u), true);
}
template <int NT, typename Col>
__device__ __forceinline__ void load_vec_async(float* dst, const float* __restrict__ src, int n,
                                               Col&& col) {
  load_vec_async_t<NT>(threadIdx.x, dst, src, n, col);
}
// The 9 rows of depthwise taps (row stride ld, columns col(j), j < n) into
// dst [9][n] by cp.async; with the biases (load_vec_async) they are staged
// once per CTA for its epilogues.
template <int NT, typename Col>
__device__ __forceinline__ void load_taps_async_t(int tid, float* dst, int n,
                                                  const float* __restrict__ taps, int ld,
                                                  Col&& col) {
  for (int k = 0; k < 9; ++k) load_vec_async_t<NT>(tid, dst + k * n, taps + k * ld, n, col);
}
template <int NT, typename Col>
__device__ __forceinline__ void load_taps_async(float* dst, int n, const float* __restrict__ taps,
                                                int ld, Col&& col) {
  load_taps_async_t<NT>(threadIdx.x, dst, n, taps, ld, col);
}

// Depthwise 3x3 at a tile's TH x TW own pixels of the NC channels of a
// chunk: z holds the pre-dw values (bias and edge mask applied) at the
// window of the tile with a 1-pixel halo (fp32, row stride ldz, window row
// width TW + 2); taps [9][ldt] and bias, fp32 in shared memory, start at the
// chunk's first channel. A task is (column j, channel quad cq, run of RH
// rows): it walks down the column with the 3 x 3 neighbourhood in registers,
// loading 3 new values a row (9 without reuse: the dw is bound by these
// shared-memory reads). RS runs a column fill the block, at least 2 rows
// each. out(p, cq, value) gets each result. No barrier. Threads tid in
// [0, NT) (the block's by default) share the tasks.
template <int NT, int TH, int TW, int NC, typename Out>
__device__ __forceinline__ void dw3x3_own_t(int tid, const float* z, int ldz, const float* taps,
                                            int ldt, const float* bias, Out&& out) {
  constexpr int CQ = NC / 4, WC = TW + 2, RS0 = NT / (TW * CQ);
  constexpr int RS = RS0 >= TH / 2 ? TH / 2 : RS0 >= 2 ? 2 : 1, RH = TH / RS;
  static_assert(TH % RS == 0, "dw3x3 row runs");
  for (int task = tid; task < TW * CQ * RS; task += NT) {
    const int cq = task % CQ, j = task / CQ % TW, i0 = task / (CQ * TW) * RH;
    float4 t[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) t[k] = ld4(taps + k * ldt + 4 * cq);
    const float4 b = ld4(bias + 4 * cq);
    const float* zc = z + (i0 * WC + j) * ldz + 4 * cq;  // window (i0, j)
    float4 w[3][3];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) w[r][dj] = ld4(zc + (r * WC + dj) * ldz);
#pragma unroll
    for (int r = 0; r < RH; ++r) {
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) w[(r + 2) % 3][dj] = ld4(zc + ((r + 2) * WC + dj) * ldz);
      float4 a = b;
#pragma unroll
      for (int di = 0; di < 3; ++di)
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) a = fma4(w[(r + di) % 3][dj], t[di * 3 + dj], a);
      out((i0 + r) * TW + j, cq, a);
    }
  }
}
template <int NT, int TH, int TW, int NC, typename Out>
__device__ __forceinline__ void dw3x3_own(const float* z, int ldz, const float* taps, int ldt,
                                          const float* bias, Out&& out) {
  dw3x3_own_t<NT, TH, TW, NC>(threadIdx.x, z, ldz, taps, ldt, bias, out);
}

// Blocks per SM the occupancy API grants `kernel` (after the shared-memory
// opt-in); 0 on error.
template <typename Kernel>
int blocks_per_sm(Kernel kernel, int threads, int smem) {
  int per_sm = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
          cudaSuccess)
    return 0;
  return per_sm;
}
// The persistent grid's size: blocks per SM times the SMs; 0 on error.
template <typename Kernel>
int resident_blocks(Kernel kernel, int threads, int smem) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return blocks_per_sm(kernel, threads, smem) * sms;
}

// ---------------------------------------------------------------------------
// Band mode (models/fused_apply.py `make_banded_forward`): each frame is cut
// into `bands` bands of H rows riding the batch axis (image b is band
// b % bands of its frame), and each band's input carries halo rows filled
// from its neighbour bands (zeros past the frame's edges). A kernel's output
// row r of image b then reads input row r + din of a buffer of hin rows, and
// is frame row fr0 + (b % bands) * hband + r. The 1x1 outputs that feed a
// dw3x3 are zeroed outside the FRAME (rows [0, frame_h)), not outside the
// band: the halo rows carry the neighbours' real values, which the band's
// edge rows need (the TPU kernels' `_real_mask` with `row_seg` / `h_tot`).
// The gram counts only own rows inside the frame, so each frame pixel once.
// BAND false is the plain image: every call reduces to inside(r, c, H, W).
// ---------------------------------------------------------------------------
template <bool BAND>
struct RowMap {
  int hin, din, fr0, bands, hband, frame_h;
  // Rows of an image's input buffer, for output images of H rows.
  __device__ __forceinline__ int in_rows(int H) const {
    if constexpr (BAND) return hin; else return H;
  }
  __device__ __forceinline__ int in_row(int r) const {
    if constexpr (BAND) return r + din; else return r;
  }
  // Frame row of output row 0 of image b.
  __device__ __forceinline__ int frame_off(int b) const {
    if constexpr (BAND) return fr0 + (b % bands) * hband; else return 0;
  }
  // Whether output-coordinate pixel (r, c) of the image at frame offset off
  // holds a real input (the pre-dw masks).
  __device__ __forceinline__ bool real(int off, int r, int c, int H, int W) const {
    if constexpr (BAND) {
      const int ir = r + din, fr = off + r;
      return ir >= 0 && ir < hin && fr >= 0 && fr < frame_h && c >= 0 && c < W;
    } else {
      return inside(r, c, H, W);
    }
  }
  // Whether own pixel (r, c) enters the gram.
  __device__ __forceinline__ bool counted(int off, int r, int c, int H, int W) const {
    if constexpr (BAND) return inside(r, c, H, W) && off + r >= 0 && off + r < frame_h;
    else return inside(r, c, H, W);
  }
};
// The maps of a band-mode block: x is [B, H + 4, W, C] (2 halo rows a side),
// K2 and K3's phase 2 produce the band's H own rows, K3's phase 1 y on H + 2
// rows (band rows -1 .. H) into a [B, H + 2, W, C] buffer, so that phase 2
// finds its 1-row halo of y in its own input.
__host__ __device__ inline RowMap<true> band_gram_map(int H, int bands, int frame_h) {
  return {H + 4, 2, 0, bands, H, frame_h};
}
__host__ __device__ inline RowMap<true> band_apply1_map(int H, int bands, int frame_h) {
  return {H + 4, 1, -1, bands, H, frame_h};
}
__host__ __device__ inline RowMap<true> band_apply2_map(int H, int bands, int frame_h) {
  return {H + 2, 1, 0, bands, H, frame_h};
}

// ---------------------------------------------------------------------------
// K2, pass A: per image the gram q^T k and the sums of q^2 and k^2. With LN
// false the 1x1 reads x itself (A1, the standalone channel attention).
//
// Plan: tiles of TH x TW own pixels with a 1-pixel halo. From C = 192 the
// [C, C] gram is split into S x S channel blocks (S = 2), each walked by its
// own CTAs: a CTA of block (bi, bj) computes only the q channels of bi and
// the k channels of bj (the [q|k] 1x1 at N2 = 2 C / S columns, the cheap
// LayerNorm recomputed), and keeps its [CB, CB] gram block (its warps'
// accumulators) and its 2 CB sums of squares (thread n sums column n of
// the tile's bf16 q|k) in registers over every tile of its run. It writes one partial at
// the end; gram_reduce_kernel sums the partials of each (image, block) in a
// fixed order (no atomics: reruns are bitwise equal).
// ---------------------------------------------------------------------------
template <int C>
struct GramCfg {
  static constexpr int TH = C == 256 ? 4 : 8, TW = C == 32 || C == 96 ? 16 : 8;
  static constexpr int S = C >= 192 ? 2 : 1, CB = C / S, N2 = 2 * CB, NBLK = S * S;
  static constexpr int NC = N2 <= 96 ? N2 : 64, NCH = N2 / NC;
  static constexpr bool RES = C <= 64;  // the [q|k] weights resident
  static constexpr int P = TH * TW, WR = TH + 2, WC = TW + 2, R = WR * WC, RP = round16(R);
  static constexpr int LDX = C + 8, LDW = (RES ? N2 : NC) + 8, LDZ = NC + 8, LDQ = N2 + 8;
  static constexpr int SZ_WIN = align128(RP * LDX * 2), SZ_WS = align128(C * LDW * 2);
  static constexpr int SZ_W = RES ? SZ_WS : 2 * SZ_WS;
  static constexpr int SZ_Z = align128(RP * LDZ * 4), SZ_Q = align128(P * LDQ * 2);
  // dw taps [9][N2], dw bias, 1x1 bias (fp32)
  static constexpr int V_BDW = 9 * N2, V_B = 10 * N2, SZ_V = align128(11 * N2 * 4);
  static constexpr int OFF_W = 2 * SZ_WIN, OFF_Z = OFF_W + SZ_W, OFF_Q = OFF_Z + SZ_Z;
  static constexpr int OFF_V = OFF_Q + SZ_Q, SMEM = OFF_V + SZ_V;
  static constexpr int NT = block_threads(SMEM), NW = NT / 32;
  static constexpr int GM = CB / 16, GN = CB / 8;  // the gram block's m16 / n8 tiles
  static constexpr int E = CB * CB + 2 * CB;       // floats of a partial
  static_assert(SMEM <= kSmemPerBlock, "K2 shared memory exceeds 227 KB");
  static_assert(P % 16 == 0 && CB % 16 == 0 && N2 % NC == 0 && NC % 16 == 0 && N2 <= NT,
                "K2 geometry");
};

template <int C, bool LN, bool BAND = false>
__global__ void __launch_bounds__(GramCfg<C>::NT, GramCfg<C>::NT == 256 ? 2 : 1) gram_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ wqk, const float* __restrict__ bqk,
    const float* __restrict__ dwqk, const float* __restrict__ bdwqk,
    float* __restrict__ partials, int H, int W, int tiles_h, int tiles_w, RowMap<BAND> rm) {
  using G = GramCfg<C>;
  constexpr int NT = G::NT;
  unsigned char* sm = dyn_smem();
  bf16* const win[2] = {reinterpret_cast<bf16*>(sm), reinterpret_cast<bf16*>(sm + G::SZ_WIN)};
  bf16* const wsm = reinterpret_cast<bf16*>(sm + G::OFF_W);
  float* const z = reinterpret_cast<float*>(sm + G::OFF_Z);
  bf16* const qk = reinterpret_cast<bf16*>(sm + G::OFF_Q);
  float* const vt = reinterpret_cast<float*>(sm + G::OFF_V);
  const int b = blockIdx.z, blk = blockIdx.y, bi = blk / G::S, bj = blk % G::S;
  const int T = tiles_h * tiles_w;
  const int first = (int)((long long)T * blockIdx.x / gridDim.x);
  const int last = (int)((long long)T * (blockIdx.x + 1) / gridDim.x);
  const int HX = rm.in_rows(H), off = rm.frame_off(b);
  const bf16* xb = x + (size_t)b * HX * W * C;
  // Column n of the block's [q|k] -> column of the [C, 2C] weights.
  auto col = [&](int n) { return n < G::CB ? bi * G::CB + n : C + bj * G::CB + n - G::CB; };
  auto load_win = [&](int L) {
    const int r0 = (L % tiles_h) * G::TH, c0 = (L / tiles_h) * G::TW;
    load_window_async<C>(win[(L - first) & 1], G::LDX, G::RP, xb, HX, W, rm.in_row(r0 - 1),
                         c0 - 1, G::WR, G::WC, threadIdx.x, NT);
  };
  auto load_chunk = [&](int g) {  // the chunk of global step g into its ring slot
    const int n0 = (g % G::NCH) * G::NC;
    load_rows_async<NT>(wsm + (g & 1) * (G::SZ_WS / 2), G::LDW, wqk, 2 * C, C, G::NC,
                        [&](int n) { return col(n0 + n); });
  };

  using GI = Items<G::NW, G::GM, G::GN>;
  float gacc[GI::PER][2][2][4];
#pragma unroll
  for (int s = 0; s < GI::PER; ++s)
#pragma unroll
    for (int e = 0; e < 16; ++e) gacc[s][e / 8][(e / 4) % 2][e % 4] = 0.f;
  float ss = 0.f;  // thread n < N2: the sum of squares of [q|k] column n

  if (first < last) load_win(first);
  load_taps_async<NT>(vt, G::N2, dwqk, 2 * C, col);
  load_vec_async<NT>(vt + G::V_BDW, bdwqk, G::N2, col);
  load_vec_async<NT>(vt + G::V_B, bqk, G::N2, col);
  if constexpr (G::RES)
    load_rows_async<NT>(wsm, G::LDW, wqk, 2 * C, C, G::N2, col);
  else if (first < last)
    load_chunk(0);
  cp_async_commit();
  for (int L = first; L < last; ++L) {
    const int r0 = (L % tiles_h) * G::TH, c0 = (L / tiles_h) * G::TW;
    bf16* const xs = win[(L - first) & 1];
    cp_async_wait<0>();
    __syncthreads();  // window L landed; tile L - 1 is done with every buffer
    if (L + 1 < last) load_win(L + 1);
    cp_async_commit();
    if constexpr (LN) {
      layernorm_quads<C, NT>(xs, G::LDX, G::R);
      __syncthreads();
    }
    for (int ch = 0; ch < G::NCH; ++ch) {
      const bf16* wc;
      if constexpr (G::RES) {
        if (ch > 0) __syncthreads();  // the previous chunk's dw3x3 is done with z
        wc = wsm + ch * G::NC;
      } else {
        const int g = (L - first) * G::NCH + ch;
        if (ch > 0) {
          cp_async_wait<0>();
          __syncthreads();
        }
        if (ch + 1 < G::NCH || L + 1 < last) load_chunk(g + 1);
        cp_async_commit();
        wc = wsm + (g & 1) * (G::SZ_WS / 2);
      }
      // z = [q|k] 1x1 of the window (+ bias), zero outside the image.
      product<G::NW, G::RP / 16, G::NC / 8, C>(
          xs, G::LDX, wc, G::LDW, [&](int row, int c, float v0, float v1) {
            const int wr = row / G::WC, wcc = row % G::WC;
            float2 o = make_float2(0.f, 0.f);
            if (row < G::R && rm.real(off, r0 - 1 + wr, c0 - 1 + wcc, H, W)) {
              const float2 bb = ld2(vt + G::V_B + ch * G::NC + c);
              o = make_float2(v0 + bb.x, v1 + bb.y);
            }
            *reinterpret_cast<float2*>(z + row * G::LDZ + c) = o;
          });
      __syncthreads();
      // q, k = dw3x3 at the own pixels (zero past the edge), rounded to bf16.
      dw3x3_own<NT, G::TH, G::TW, G::NC>(
          z, G::LDZ, vt + ch * G::NC, G::N2, vt + G::V_BDW + ch * G::NC,
          [&](int p, int cq, float4 a) {
            const bool in = rm.counted(off, r0 + p / G::TW, c0 + p % G::TW, H, W);
            st_bf4(qk + p * G::LDQ + ch * G::NC + 4 * cq,
                   in ? a : make_float4(0.f, 0.f, 0.f, 0.f));
          });
    }
    __syncthreads();
    // gram[i][j] += sum over the tile's pixels of q[p][i] k[p][j].
    product_acc<true, G::NW, G::GM, G::GN, G::P>(gacc, qk, G::LDQ, qk + G::CB, G::LDQ);
    if ((int)threadIdx.x < G::N2) {
      float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
      for (int p = 0; p < G::P; ++p) {
        const float v = bf2f(qk[p * G::LDQ + threadIdx.x]);
        t[p % 4] = fmaf(v, v, t[p % 4]);
      }
      ss += (t[0] + t[1]) + (t[2] + t[3]);
    }
  }

  // One partial per CTA: the gram block, then the q and k sums.
  float* part = partials + (((size_t)b * G::NBLK + blk) * gridDim.x + blockIdx.x) * G::E;
  acc_epilogue<G::NW, G::GM, G::GN>(gacc, [&](int r, int c, float v0, float v1) {
    *reinterpret_cast<float2*>(part + r * G::CB + c) = make_float2(v0, v1);
  });
  if ((int)threadIdx.x < G::N2) part[G::CB * G::CB + threadIdx.x] = ss;
}

// out[b] = [gram (C x C) | sum q^2 (C) | sum k^2 (C)] from the partials
// [B][S*S blocks][ncta][CB*CB + 2 CB], each element summed over the CTAs in
// order. Grid (., S*S, B).
__global__ void __launch_bounds__(256) gram_reduce_kernel(const float* __restrict__ ws,
                                                          float* __restrict__ out, int C, int S,
                                                          int ncta) {
  const int CB = C / S, E = CB * CB + 2 * CB;
  const int e = blockIdx.x * 256 + threadIdx.x, blk = blockIdx.y, b = blockIdx.z;
  if (e >= E) return;
  const int bi = blk / S, bj = blk % S;
  const float* src = ws + ((size_t)b * S * S + blk) * ncta * E + e;
  float acc = 0.f;
  for (int t = 0; t < ncta; ++t) acc += src[(size_t)t * E];
  float* o = out + (size_t)b * (C * C + 2 * C);
  if (e < CB * CB)
    o[(bi * CB + e / CB) * C + bj * CB + e % CB] = acc;
  else if (e < CB * CB + CB) {
    if (bj == 0) o[C * C + bi * CB + e - CB * CB] = acc;
  } else if (bi == 0) {
    o[C * C + C + bj * CB + e - CB * CB - CB] = acc;
  }
}

// CTAs per (image, channel block): the blocks resident on the card spread
// over B x S^2, at least 1, at most the tiles of an image.
template <int C, bool LN>
int gram_ctas(int B, int H, int W) {
  using G = GramCfg<C>;
  const int tiles = cdiv(H, G::TH) * cdiv(W, G::TW);
  const int n = resident_blocks(gram_kernel<C, LN>, G::NT, G::SMEM) / (B * G::NBLK);
  return n < 1 ? 1 : (n > tiles ? tiles : n);
}

#define BLLE_WIDTHS(X) X(32) X(48) X(64) X(96) X(128) X(192) X(256)

// Floats of workspace a gram pass needs: the per-CTA partials.
template <bool LN>
long long gram_workspace_floats(int B, int H, int W, int C) {
  switch (C) {
#define BLLE_WS(c) \
  case c: return (long long)B * GramCfg<c>::NBLK * gram_ctas<c, LN>(B, H, W) * GramCfg<c>::E;
    BLLE_WIDTHS(BLLE_WS)
#undef BLLE_WS
    default: return -1;
  }
}

template <int C, bool LN, bool BAND = false>
cudaError_t gram_run(const void* x, const void* wqk, const void* bqk, const void* dwqk,
                     const void* bdwqk, float* ws, float* out, int B, int H, int W, int ncta,
                     cudaStream_t s, RowMap<BAND> rm = {}) {
  using G = GramCfg<C>;
  const int th = cdiv(H, G::TH), tw = cdiv(W, G::TW);
  if (ncta <= 0) ncta = gram_ctas<C, LN>(B, H, W);
  if (ncta > th * tw) return cudaErrorInvalidValue;
  cudaError_t err = launch(gram_kernel<C, LN, BAND>, dim3(ncta, G::NBLK, B), dim3(G::NT), G::SMEM,
                           s, (const bf16*)x, (const bf16*)wqk, (const float*)bqk,
                           (const float*)dwqk, (const float*)bdwqk, ws, H, W, th, tw, rm);
  if (err != cudaSuccess) return err;
  return launch(gram_reduce_kernel, dim3(cdiv(G::E, 256), G::NBLK, B), dim3(256), 0, s,
                (const float*)ws, out, C, G::S, ncta);
}

// The whole gram pass: the tile kernel on ncta CTAs per (image, channel
// block) (<= 0: gram_ctas, the occupancy API's), then the fixed-order
// reduction. BAND: x is [B, H + 4, W, C] of band_gram_map (out holds each
// band's partial: the caller sums a frame's bands).
template <bool LN, bool BAND = false>
cudaError_t gram_pass(const void* x, const void* wqk, const void* bqk, const void* dwqk,
                      const void* bdwqk, void* workspace, void* out, int B, int H, int W,
                      int C, int ncta, cudaStream_t s, RowMap<BAND> rm = {}) {
  float *ws = (float*)workspace, *o = (float*)out;
  switch (C) {
#define BLLE_RUN(c) \
  case c: return gram_run<c, LN, BAND>(x, wqk, bqk, dwqk, bdwqk, ws, o, B, H, W, ncta, s, rm);
    BLLE_WIDTHS(BLLE_RUN)
#undef BLLE_RUN
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// K3, pass B: attention apply + first residual + ConvFFN + second residual,
// as two kernels in one call, each with a 1-pixel halo (the 2-pixel halo of
// one kernel would recompute LN1 and the v 1x1 on (TH+4)(TW+4) pixels a
// tile): phase 1 writes y = x + dw3x3(v 1x1) @ apply + b_proj at every
// pixel of the image (bf16, as K3P keeps it), which stays in L2 for phase 2
// (LN2 -> 1x1 to 2C -> dw3x3 -> GELU -> 1x1 -> + y). Each walks the
// B x tiles of the call in strip order on a persistent grid.
//
// STAGE < 5 cuts the pass after an earlier stage and writes that stage's
// tensor at the own pixels into `out` (the bisect ladder, probes_bisect.cu):
// 1 the v 1x1 output (after bias and mask), 2 the attention output v @ apply
// + b_proj, 3 y (phase 1 alone), 4 the first C channels of the FFN expand
// output (after bias and mask). STAGE 5 is the production K3.
// ---------------------------------------------------------------------------

struct TilePos3 {
  int b, r0, c0;
};
// Tile L of the strip order over the call: strip L / tiles_h is (image,
// column of tiles), row of tiles L % tiles_h.
template <int TH, int TW>
__device__ __forceinline__ TilePos3 tile_pos(long long L, int tiles_h, int tiles_w) {
  const long long strip = L / tiles_h;
  return {(int)(strip / tiles_w), (int)(L % tiles_h) * TH, (int)(strip % tiles_w) * TW};
}

template <int C>
struct Apply1Cfg {
  static constexpr int TH = C == 256 ? 4 : 8, TW = C <= 48 ? 16 : 8;
  static constexpr int NC = C <= 96 ? C : 64, NCH = C / NC;
  static constexpr bool RES = C <= 64;  // wv and the image's apply resident
  static constexpr int P = TH * TW, WR = TH + 2, WC = TW + 2, R = WR * WC, RP = round16(R);
  static constexpr int LDX = C + 8, LDW = (RES ? C : NC) + 8, LDZ = NC + 8;
  static constexpr int SZ_WIN = align128(RP * LDX * 2), SZ_WS = align128(C * LDW * 2);
  static constexpr int SZ_Z = align128(RP * LDZ * 4), SZ_V = align128(P * LDX * 2);
  // dw taps [9][C], dw bias, v bias, b_proj (fp32)
  static constexpr int V_BDW = 9 * C, V_B = 10 * C, V_BP = 11 * C, SZ_VT = align128(12 * C * 4);
  static constexpr int OFF_W = 2 * SZ_WIN, OFF_Z = OFF_W + 2 * SZ_WS, OFF_V = OFF_Z + SZ_Z;
  static constexpr int OFF_VT = OFF_V + SZ_V, SMEM = OFF_VT + SZ_VT;
  static constexpr int NT = block_threads(SMEM), NW = NT / 32;
  static_assert(SMEM <= kSmemPerBlock, "K3 phase 1 shared memory exceeds 227 KB");
  static_assert(P % 16 == 0 && C % NC == 0 && NC % 16 == 0, "K3 phase 1 geometry");
};

// LN false skips LN1: the v 1x1 reads x itself (A1's apply pass, at STAGE 2).
template <int C, int STAGE, bool LN = true, bool BAND = false>
__global__ void __launch_bounds__(Apply1Cfg<C>::NT, Apply1Cfg<C>::NT == 256 ? 2 : 1)
    apply1_kernel(const bf16* __restrict__ x, const bf16* __restrict__ apply,
                  const bf16* __restrict__ wv, const float* __restrict__ bv,
                  const float* __restrict__ dwv, const float* __restrict__ bdwv,
                  const float* __restrict__ bproj, bf16* __restrict__ out, int H, int W,
                  int tiles_h, int tiles_w, long long total, RowMap<BAND> rm) {
  using A = Apply1Cfg<C>;
  constexpr int NT = A::NT, STEPS = 2 * A::NCH;  // streamed chunks a tile: wv, then apply
  unsigned char* sm = dyn_smem();
  bf16* const win[2] = {reinterpret_cast<bf16*>(sm), reinterpret_cast<bf16*>(sm + A::SZ_WIN)};
  bf16* const slot[2] = {reinterpret_cast<bf16*>(sm + A::OFF_W),
                         reinterpret_cast<bf16*>(sm + A::OFF_W + A::SZ_WS)};
  float* const z = reinterpret_cast<float*>(sm + A::OFF_Z);
  bf16* const v = reinterpret_cast<bf16*>(sm + A::OFF_V);
  float* const vt = reinterpret_cast<float*>(sm + A::OFF_VT);
  const long long first = total * blockIdx.x / gridDim.x;
  const long long last = total * (blockIdx.x + 1) / gridDim.x;
  const int HX = rm.in_rows(H);
  auto load_win = [&](long long L) {
    const TilePos3 t = tile_pos<A::TH, A::TW>(L, tiles_h, tiles_w);
    load_window_async<C>(win[(L - first) & 1], A::LDX, A::RP, x + (size_t)t.b * HX * W * C, HX,
                         W, rm.in_row(t.r0 - 1), t.c0 - 1, A::WR, A::WC, threadIdx.x, NT);
  };
  // Streamed: global step g's chunk (the walk's tile (g / STEPS) of image b).
  auto load_step = [&](long long g, int b) {
    const int st = (int)(g % STEPS), n0 = (st % A::NCH) * A::NC;
    const bf16* src = st < A::NCH ? wv : apply + (size_t)b * C * C;
    load_rows_async<NT>(slot[g & 1], A::LDW, src, C, C, A::NC, [&](int c) { return n0 + c; });
  };

  if (first < last) {
    load_win(first);
    load_taps_async<NT>(vt, C, dwv, C, Same());
    load_vec_async<NT>(vt + A::V_BDW, bdwv, C, Same());
    load_vec_async<NT>(vt + A::V_B, bv, C, Same());
    load_vec_async<NT>(vt + A::V_BP, bproj, C, Same());
    if constexpr (A::RES)
      load_rows_async<NT>(slot[0], A::LDW, wv, C, C, C, Same());
    else
      load_step(0, tile_pos<A::TH, A::TW>(first, tiles_h, tiles_w).b);
  }
  cp_async_commit();
  int cur_b = -1;
  for (long long L = first; L < last; ++L) {
    const TilePos3 t = tile_pos<A::TH, A::TW>(L, tiles_h, tiles_w);
    const int off = rm.frame_off(t.b);
    bf16* const xs = win[(L - first) & 1];
    const long long g0 = (L - first) * STEPS;
    // The step after g: the next chunk of this tile or the first of the next.
    auto prefetch = [&](long long g) {
      if constexpr (!A::RES) {
        if (g % STEPS != 0)
          load_step(g, t.b);
        else if (L + 1 < last)
          load_step(g, tile_pos<A::TH, A::TW>(L + 1, tiles_h, tiles_w).b);
      }
    };
    cp_async_wait<0>();
    __syncthreads();  // window L landed; tile L - 1 is done with every buffer
    if (L + 1 < last) load_win(L + 1);
    if constexpr (A::RES) {
      if (t.b != cur_b) load_rows_async<NT>(slot[1], A::LDW, apply + (size_t)t.b * C * C, C, C, C,
                                            Same());
      cur_b = t.b;
    }
    cp_async_commit();
    if constexpr (LN) {
      layernorm_quads<C, NT>(xs, A::LDX, A::R);
      __syncthreads();
    }
    // v = dw3x3(mask(LN1(x) @ wv + bv)) + bdwv at the own pixels.
    for (int st = 0; st < A::NCH; ++st) {
      const int n0 = st * A::NC;
      const bf16* wc;
      if constexpr (A::RES) {
        if (st > 0) __syncthreads();
        wc = slot[0] + n0;
      } else {
        if (st > 0) {
          cp_async_wait<0>();
          __syncthreads();
        }
        prefetch(g0 + st + 1);
        cp_async_commit();
        wc = slot[(g0 + st) & 1];
      }
      product<A::NW, A::RP / 16, A::NC / 8, C>(
          xs, A::LDX, wc, A::LDW, [&](int row, int c, float v0, float v1) {
            float2 o = make_float2(0.f, 0.f);
            if (row < A::R && rm.real(off, t.r0 - 1 + row / A::WC, t.c0 - 1 + row % A::WC, H, W)) {
              const float2 bb = ld2(vt + A::V_B + n0 + c);
              o = make_float2(v0 + bb.x, v1 + bb.y);
            }
            *reinterpret_cast<float2*>(z + row * A::LDZ + c) = o;
          });
      __syncthreads();
      if constexpr (STAGE == 1) {
        for (int e = threadIdx.x; e < A::P * A::NC / 2; e += NT) {
          const int p = e / (A::NC / 2), c = 2 * (e % (A::NC / 2)), i = p / A::TW, j = p % A::TW;
          if (inside(t.r0 + i, t.c0 + j, H, W)) {
            const float2 o = *reinterpret_cast<const float2*>(z + ((i + 1) * A::WC + j + 1) * A::LDZ + c);
            st_bf2(out + (((size_t)t.b * H + t.r0 + i) * W + t.c0 + j) * C + n0 + c, o.x, o.y);
          }
        }
      } else {
        dw3x3_own<NT, A::TH, A::TW, A::NC>(
            z, A::LDZ, vt + n0, C, vt + A::V_BDW + n0,
            [&](int p, int cq, float4 a) { st_bf4(v + p * A::LDX + n0 + 4 * cq, a); });
      }
    }
    // y = x + v @ apply + b_proj at the own pixels inside the image.
    auto epi = [&](int n0) {
      return [&, n0](int p, int c, float v0, float v1) {
        const int i = p / A::TW, j = p % A::TW, n = n0 + c;
        if (!inside(t.r0 + i, t.c0 + j, H, W)) return;
        const size_t idx = (((size_t)t.b * H + t.r0 + i) * W + t.c0 + j) * C + n;
        const float2 bp = ld2(vt + A::V_BP + n);
        float a0 = v0 + bp.x, a1 = v1 + bp.y;
        if constexpr (STAGE != 2) {
          size_t xi = idx;
          if constexpr (BAND) xi = (((size_t)t.b * HX + rm.in_row(t.r0 + i)) * W + t.c0 + j) * C + n;
          const float2 xv = ld_bf2(x + xi);
          a0 += xv.x, a1 += xv.y;
        }
        st_bf2(out + idx, a0, a1);
      };
    };
    if constexpr (A::RES) {
      cp_async_wait<0>();
      __syncthreads();  // v complete, the image's apply landed
      if constexpr (STAGE != 1)
        product<A::NW, A::P / 16, C / 8, C>(v, A::LDX, slot[1], A::LDW, epi(0));
    } else {
      for (int st = A::NCH; st < STEPS; ++st) {
        cp_async_wait<0>();
        __syncthreads();
        prefetch(g0 + st + 1);
        cp_async_commit();
        if constexpr (STAGE != 1)
          product<A::NW, A::P / 16, A::NC / 8, C>(v, A::LDX, slot[(g0 + st) & 1], A::LDW,
                                                  epi((st - A::NCH) * A::NC));
      }
    }
  }
}

template <int C>
struct Apply2Cfg {
  static constexpr int TH = C >= 192 ? 4 : 8, TW = C == 32 ? 16 : 8, CH = 2 * C;
  // 32-channel chunks at C = 32 keep the fp32 chunk small enough for two
  // CTAs an SM.
  static constexpr int NC = C == 32 ? 32 : CH <= 96 ? CH : 64, NCH = CH / NC;
  static constexpr bool RES = C <= 64;  // wp1 and wp2 resident
  static constexpr int KC = RES ? CH : 64, NKC = CH / KC;  // K chunks of the projection
  static constexpr int P = TH * TW, WR = TH + 2, WC = TW + 2, R = WR * WC, RP = round16(R);
  static constexpr int LDX = C + 8, LDZ = NC + 8, LDF = CH + 8;
  static constexpr int LDW1 = (RES ? CH : NC) + 8, LDW2 = C + 8;
  static constexpr int SZ_W1 = align128(C * LDW1 * 2), SZ_W2 = align128(KC * LDW2 * 2);
  static constexpr int SZ_SLOT = cmax(SZ_W1, SZ_W2);
  static constexpr int SZ_W = RES ? SZ_W1 + SZ_W2 : 2 * SZ_SLOT;
  static constexpr int SZ_WIN = align128(RP * LDX * 2), SZ_Z = align128(RP * LDZ * 4);
  static constexpr int SZ_F = align128(P * LDF * 2);
  // dw taps [9][CH], dw bias, expand bias [CH], projection bias [C] (fp32)
  static constexpr int V_BDW = 9 * CH, V_B1 = 10 * CH, V_B2 = 11 * CH;
  static constexpr int SZ_VT = align128((11 * CH + C) * 4);
  static constexpr int OFF_W = 2 * SZ_WIN, OFF_Z = OFF_W + SZ_W, OFF_F = OFF_Z + SZ_Z;
  static constexpr int OFF_VT = OFF_F + SZ_F, SMEM = OFF_VT + SZ_VT;
  static constexpr int NT = block_threads(SMEM), NW = NT / 32;
  static_assert(SMEM <= kSmemPerBlock, "K3 phase 2 shared memory exceeds 227 KB");
  static_assert(P % 16 == 0 && CH % NC == 0 && NC % 16 == 0 && CH % KC == 0, "K3 phase 2 geometry");
};

template <int C, int STAGE, bool BAND = false>
__global__ void __launch_bounds__(Apply2Cfg<C>::NT, Apply2Cfg<C>::NT == 256 ? 2 : 1)
    apply2_kernel(const bf16* __restrict__ y, const bf16* __restrict__ wp1,
                  const float* __restrict__ bp1, const float* __restrict__ dwf,
                  const float* __restrict__ bdwf, const bf16* __restrict__ wp2,
                  const float* __restrict__ bp2, bf16* __restrict__ out, int H, int W,
                  int tiles_h, int tiles_w, long long total, RowMap<BAND> rm) {
  using A = Apply2Cfg<C>;
  constexpr int NT = A::NT, STEPS = A::NCH + A::NKC;  // streamed chunks a tile
  unsigned char* sm = dyn_smem();
  bf16* const win[2] = {reinterpret_cast<bf16*>(sm), reinterpret_cast<bf16*>(sm + A::SZ_WIN)};
  bf16* const slot[2] = {reinterpret_cast<bf16*>(sm + A::OFF_W),
                         reinterpret_cast<bf16*>(sm + A::OFF_W + A::SZ_SLOT)};
  bf16* const w1 = reinterpret_cast<bf16*>(sm + A::OFF_W);             // resident
  bf16* const w2 = reinterpret_cast<bf16*>(sm + A::OFF_W + A::SZ_W1);  // resident
  float* const z = reinterpret_cast<float*>(sm + A::OFF_Z);
  bf16* const f = reinterpret_cast<bf16*>(sm + A::OFF_F);
  float* const vt = reinterpret_cast<float*>(sm + A::OFF_VT);
  const long long first = total * blockIdx.x / gridDim.x;
  const long long last = total * (blockIdx.x + 1) / gridDim.x;
  const int HY = rm.in_rows(H);
  auto load_win = [&](long long L) {
    const TilePos3 t = tile_pos<A::TH, A::TW>(L, tiles_h, tiles_w);
    load_window_async<C>(win[(L - first) & 1], A::LDX, A::RP, y + (size_t)t.b * HY * W * C, HY,
                         W, rm.in_row(t.r0 - 1), t.c0 - 1, A::WR, A::WC, threadIdx.x, NT);
  };
  // Streamed: global step g's chunk (wp1 columns, then wp2 rows).
  auto load_step = [&](long long g) {
    const int st = (int)(g % STEPS);
    if (st < A::NCH) {
      const int n0 = st * A::NC;
      load_rows_async<NT>(slot[g & 1], A::LDW1, wp1, A::CH, C, A::NC,
                          [&](int c) { return n0 + c; });
    } else {
      load_rows_async<NT>(slot[g & 1], A::LDW2, wp2 + (size_t)(st - A::NCH) * A::KC * C, C,
                          A::KC, C, Same());
    }
  };

  if (first < last) {
    load_win(first);
    load_taps_async<NT>(vt, A::CH, dwf, A::CH, Same());
    load_vec_async<NT>(vt + A::V_BDW, bdwf, A::CH, Same());
    load_vec_async<NT>(vt + A::V_B1, bp1, A::CH, Same());
    load_vec_async<NT>(vt + A::V_B2, bp2, C, Same());
    if constexpr (A::RES) {
      load_rows_async<NT>(w1, A::LDW1, wp1, A::CH, C, A::CH, Same());
      load_rows_async<NT>(w2, A::LDW2, wp2, C, A::CH, C, Same());
    } else {
      load_step(0);
    }
  }
  cp_async_commit();
  for (long long L = first; L < last; ++L) {
    const TilePos3 t = tile_pos<A::TH, A::TW>(L, tiles_h, tiles_w);
    bf16* const ys = win[(L - first) & 1];
    const long long g0 = (L - first) * STEPS;
    auto prefetch = [&](long long g) {
      if constexpr (!A::RES) {
        if (g % STEPS != 0 || L + 1 < last) load_step(g);
      }
    };
    const int off = rm.frame_off(t.b);
    auto own = [&](int p) { return inside(t.r0 + p / A::TW, t.c0 + p % A::TW, H, W); };
    auto gidx = [&](int p) {
      return (((size_t)t.b * H + t.r0 + p / A::TW) * W + t.c0 + p % A::TW) * C;
    };
    // y's index of own pixel p (its own buffer's rows in band mode).
    auto yidx = [&](int p) {
      if constexpr (BAND)
        return (((size_t)t.b * HY + rm.in_row(t.r0 + p / A::TW)) * W + t.c0 + p % A::TW) * C;
      else
        return gidx(p);
    };
    cp_async_wait<0>();
    __syncthreads();  // window L landed; tile L - 1 is done with every buffer
    if (L + 1 < last) load_win(L + 1);
    cp_async_commit();
    layernorm_quads<C, NT>(ys, A::LDX, A::R);
    __syncthreads();
    // f = GELU(dw3x3(mask(LN2(y) @ wp1 + bp1)) + bdwf) at the own pixels.
    for (int st = 0; st < A::NCH; ++st) {
      const int n0 = st * A::NC;
      const bf16* wc;
      if constexpr (A::RES) {
        if (st > 0) __syncthreads();
        wc = w1 + n0;
      } else {
        if (st > 0) {
          cp_async_wait<0>();
          __syncthreads();
        }
        prefetch(g0 + st + 1);
        cp_async_commit();
        wc = slot[(g0 + st) & 1];
      }
      product<A::NW, A::RP / 16, A::NC / 8, C>(
          ys, A::LDX, wc, A::LDW1, [&](int row, int c, float v0, float v1) {
            float2 o = make_float2(0.f, 0.f);
            if (row < A::R && rm.real(off, t.r0 - 1 + row / A::WC, t.c0 - 1 + row % A::WC, H, W)) {
              const float2 bb = ld2(vt + A::V_B1 + n0 + c);
              o = make_float2(v0 + bb.x, v1 + bb.y);
            }
            *reinterpret_cast<float2*>(z + row * A::LDZ + c) = o;
          });
      __syncthreads();
      if constexpr (STAGE == 4) {
        for (int e = threadIdx.x; e < A::P * A::NC / 2; e += NT) {
          const int p = e / (A::NC / 2), c = 2 * (e % (A::NC / 2));
          const int i = p / A::TW, j = p % A::TW;
          if (n0 + c < C && own(p)) {
            const float2 o = *reinterpret_cast<const float2*>(z + ((i + 1) * A::WC + j + 1) * A::LDZ + c);
            st_bf2(out + gidx(p) + n0 + c, o.x, o.y);
          }
        }
      } else {
        dw3x3_own<NT, A::TH, A::TW, A::NC>(
            z, A::LDZ, vt + n0, A::CH, vt + A::V_BDW + n0,
            [&](int p, int cq, float4 a) {
              st_bf4(f + p * A::LDF + n0 + 4 * cq,
                     make_float4(gelu(a.x), gelu(a.y), gelu(a.z), gelu(a.w)));
            });
      }
    }
    // out = y + f @ wp2 + bp2 at the own pixels inside the image.
    using PI = Items<A::NW, A::P / 16, C / 8>;
    float pacc[PI::PER][2][2][4];
#pragma unroll
    for (int s = 0; s < PI::PER; ++s)
#pragma unroll
      for (int e = 0; e < 16; ++e) pacc[s][e / 8][(e / 4) % 2][e % 4] = 0.f;
    if constexpr (A::RES) {
      __syncthreads();  // f complete
      if constexpr (STAGE == 5)
        product_acc<false, A::NW, A::P / 16, C / 8, A::CH>(pacc, f, A::LDF, w2, A::LDW2);
    } else {
      for (int k = 0; k < A::NKC; ++k) {
        const long long g = g0 + A::NCH + k;
        cp_async_wait<0>();
        __syncthreads();
        prefetch(g + 1);
        cp_async_commit();
        if constexpr (STAGE == 5)
          product_acc<false, A::NW, A::P / 16, C / 8, A::KC>(pacc, f + k * A::KC, A::LDF,
                                                              slot[g & 1], A::LDW2);
      }
    }
    if constexpr (STAGE == 5)
      acc_epilogue<A::NW, A::P / 16, C / 8>(pacc, [&](int p, int n, float v0, float v1) {
        if (!own(p)) return;
        const size_t idx = gidx(p) + n;
        const float2 yv = ld_bf2(y + yidx(p) + n), bb = ld2(vt + A::V_B2 + n);
        st_bf2(out + idx, yv.x + v0 + bb.x, yv.y + v1 + bb.y);
      });
  }
}

template <typename Cfg>
long long apply_tiles_total(int B, int H, int W) {
  return (long long)B * cdiv(H, Cfg::TH) * cdiv(W, Cfg::TW);
}

// The persistent grid of a K3 kernel: `want` CTAs (<= 0: as many as are
// resident, at most one per tile); 0 if `want` exceeds the tiles.
template <typename Kernel>
int apply_grid(Kernel kernel, int threads, int smem, long long total, int want) {
  if (want > 0) return want <= total ? want : 0;
  const int res = resident_blocks(kernel, threads, smem);
  return (int)(total < res ? total : res);
}

// K3 (or a cut of it): phase 1 into `out` (STAGE <= 3) or into `ybuf`
// ([B,H,W,C] bf16), then phase 2 from `ybuf` into `out`, on grid1 / grid2
// CTAs (<= 0: apply_grid's); p holds the arguments of blle_apply_pass in
// order (p[0..6] only for STAGE <= 3). LN false: phase 1 without LN1 (A1's
// apply pass, fused_attention.cu). BAND (STAGE 5): x is [B, H + 4, W, C],
// phase 1 writes y on H + 2 rows into ybuf [B, H + 2, W, C]
// (band_apply1_map, band_apply2_map); out is [B, H, W, C].
template <int C, int STAGE, bool LN = true, bool BAND = false>
cudaError_t apply_tiles(const void* const* p, void* out, void* ybuf, int B, int H, int W,
                        cudaStream_t s, int grid1 = 0, int grid2 = 0, int bands = 1,
                        int frame_h = 0) {
  using A1 = Apply1Cfg<C>;
  using A2 = Apply2Cfg<C>;
  constexpr int S1 = STAGE < 3 ? STAGE : 3;
  static_assert(!BAND || STAGE == 5, "band mode runs the whole pass");
  RowMap<BAND> rm1 = {}, rm2 = {};
  if constexpr (BAND) {
    rm1 = band_apply1_map(H, bands, frame_h);
    rm2 = band_apply2_map(H, bands, frame_h);
  }
  {
    const int H1 = BAND ? H + 2 : H;
    const long long total = apply_tiles_total<A1>(B, H1, W);
    const int grid = apply_grid(apply1_kernel<C, S1, LN, BAND>, A1::NT, A1::SMEM, total, grid1);
    if (grid < 1) return grid1 > 0 ? cudaErrorInvalidValue : cudaErrorInvalidConfiguration;
    cudaError_t err = launch(
        apply1_kernel<C, S1, LN, BAND>, dim3(grid), dim3(A1::NT), A1::SMEM, s, (const bf16*)p[0],
        (const bf16*)p[1], (const bf16*)p[2], (const float*)p[3], (const float*)p[4],
        (const float*)p[5], (const float*)p[6], (bf16*)(STAGE <= 3 ? out : ybuf), H1, W,
        cdiv(H1, A1::TH), cdiv(W, A1::TW), total, rm1);
    if (err != cudaSuccess || STAGE <= 3) return err;
  }
  if constexpr (STAGE >= 4) {
    const long long total = apply_tiles_total<A2>(B, H, W);
    const int grid = apply_grid(apply2_kernel<C, STAGE, BAND>, A2::NT, A2::SMEM, total, grid2);
    if (grid < 1) return grid2 > 0 ? cudaErrorInvalidValue : cudaErrorInvalidConfiguration;
    return launch(apply2_kernel<C, STAGE, BAND>, dim3(grid), dim3(A2::NT), A2::SMEM, s,
                  (const bf16*)ybuf, (const bf16*)p[7], (const float*)p[8], (const float*)p[9],
                  (const float*)p[10], (const bf16*)p[11], (const float*)p[12], (bf16*)out, H, W,
                  cdiv(H, A2::TH), cdiv(W, A2::TW), total, rm2);
  }
  return cudaSuccess;
}

// Shape of the plan of one of the block kernels at width C (kernels/
// fused_block.py `tile_config` mirrors it): kind 0 K2, 1 K3 phase 1, 2 K3
// phase 2, 3 A1's gram (K2 without LayerNorm) -> info = TH, TW, threads,
// shared-memory bytes, blocks per SM (the occupancy API's). Kinds 4 (K3P) and
// 5 (A1's apply pass) are answered by their own sources (fused_block.cu).
template <int C>
cudaError_t block_kernel_info(int kind, long long* info) {
  switch (kind) {
#define BLLE_INFO(Cfg, kernel)                                                       \
  info[0] = Cfg::TH, info[1] = Cfg::TW, info[2] = Cfg::NT, info[3] = Cfg::SMEM,      \
  info[4] = blocks_per_sm(kernel, Cfg::NT, Cfg::SMEM);                               \
  return info[4] > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
    case 0: BLLE_INFO(GramCfg<C>, (gram_kernel<C, true>))
    case 1: BLLE_INFO(Apply1Cfg<C>, (apply1_kernel<C, 3>))
    case 2: BLLE_INFO(Apply2Cfg<C>, (apply2_kernel<C, 5>))
    case 3: BLLE_INFO(GramCfg<C>, (gram_kernel<C, false>))
#undef BLLE_INFO
    default: return cudaErrorInvalidValue;
  }
}
}  // namespace

#endif  // BLLE_BLOCK_TILES_CUH
