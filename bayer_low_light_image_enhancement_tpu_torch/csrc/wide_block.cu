// K2 and K3 at the wide widths, C = 384 and 512: the bottleneck blocks of
// RawFormer-B (dim 48) and RawFormer-L (dim 64), which band mode runs on the
// card's kernels as the JAX package's band mode runs every TransformerBlock
// on its Pallas kernels (bayer_low_light_image_enhancement_tpu/models/
// fused_apply.py). Replaces `_gram_kernel_merged` (:406) and
// `_apply_ffn_kernel` (:683) / `_apply_ffn_chain` (:609) of
// bayer_low_light_image_enhancement_tpu/kernels/fused_block.py at those
// widths, plain and in band mode; kernels/wide_block.py chains the kernels
// of this file (and the weight-grad pass, weight_grad.cu, for the gram).
//
// Bound on the H100. At RawFormer-L's banded bottleneck, [8, 23, 272, 512]
// (halo'd input [8, 27, 272, 512]), K2's products are 3 C^2 MACs a pixel
// (the [q|k] 1x1 and the gram: ~44 GFLOP, 0.045 ms at 989 TFLOP/s) and K3's
// 6 C^2 (~88 GFLOP, 0.09 ms); x moves in ~0.02 ms. At these widths each 1x1
// is a dense GEMM (K = 384-1024, N = 384-1024), so the design gives the
// products to the tensor cores at large M and lets the intermediates go
// through device memory, where they cost little: K2's fp32 z is 223 MB at
// 512, ~0.07 ms written and ~0.07 ms read. A tile kernel that keeps them on
// chip (the staging this replaces) had to split the [C, C] gram into 4 x 4
// channel blocks that each recomputed LayerNorm, the 1x1 and the dw3x3, and
// fed 80-row mma.sync products from 32-channel chunks behind barrier chains:
// ~5% of the tensor cores' rate. The passes here:
//
// Each kernel's bound below is at that shape, in band mode (K2's first pass).
//
// * wide_ln_kernel: LayerNorm without affine (fp32 statistics, bf16 out) of
//   the rows the next product needs, a warp a pixel (8-byte loads, the sums
//   by shuffles). Bound by bytes: x read once, x-hat written once (111 MB,
//   0.033 ms for K2's 25 rows a band).
// * wide_gemm_kernel: out = A @ B (+ epilogue) on wgmma, A [G, M, K] bf16
//   K-major (the pixels' channels), B [K, N] bf16 MN-major (the weights as
//   stored, or one [K, N] a group: v @ apply[b]). A CTA computes 128 x TN
//   tiles (TN = 256, or 192 at C = 384) with two consumer warpgroups of 64
//   rows; one producer warp keeps a ring of 4 stages of 64 K rows full by
//   TMA (A as one 64 x 128 box, B as TN / 64 boxes of 64 x 64, 128-byte
//   swizzle) on full / empty mbarriers, so the next tile's loads run under
//   this tile's epilogue. The grid is persistent (the occupancy API's CTAs,
//   at most one a tile), tiles N-fastest so that the CTAs in flight share
//   their A tiles in L2; each weight byte is read once per 128-row tile.
//   Epilogues: bias and the frame's row mask into fp32 z (the 1x1 outputs
//   that feed a dw3x3), or bias plus a bf16 residual into bf16 (y = x + v @
//   apply + b_proj; out = y + f @ wp2 + bp2), written from the accumulators.
//   Bound: K2's [54400, 512] @ [512, 1024] by bytes (A, the weights and the
//   fp32 z, 280 MB, 0.083 ms; its 57 GFLOP take 0.058 ms); K3's four 0.25
//   ms together (bytes: 838 MB; their 169 GFLOP take 0.17 ms).
// * wide_dw_kernel: the depthwise 3x3 on fp32 z (zero outside the rows and
//   columns it is given), 4 channels a thread by 16-byte loads, each thread
//   walking 8 rows of a column with the 3 x 3 neighbourhood in registers;
//   its neighbours in the CTA read the same columns through L1. Epilogues:
//   bf16 q and k (zero outside the counted rows) with the CTA's partial sums
//   of q^2 and k^2 (summed over its threads in a fixed order); bf16 v; bf16
//   GELU(.) (exact erf). Bound by bytes: z read once, the bf16 out written
//   once (K2's 223 + 102 MB, 0.097 ms).
// * wide_gram_finish_kernel: the operator's [B, C*C + 2C] row from the
//   weight-grad pass's [B, C, C] gram (copied) and the dw pass's partial
//   sums (summed in order): no atomics anywhere, reruns are bitwise equal.
//
// Rounding points (those of the tile kernels, so that phase 3's and 18's
// tolerances hold): LayerNorm out bf16; the 1x1 outputs that feed a dw3x3
// fp32; q, k, v after the dw3x3 bf16; y bf16; the GELU output bf16.
#include <cuda.h>  // CUtensorMap and its enums (the encoder comes through the runtime)

#include <mutex>

#include "block_tiles.cuh"
#include "wgmma.cuh"

namespace {

// ---------------------------------------------------------------------------
// LayerNorm pass.
// ---------------------------------------------------------------------------

constexpr int kLnPixels = 8;  // pixels a 256-thread CTA: a warp each

// out [B, R, W, C] <- LN(x [B, HX, W, C] rows [r0, r0 + R) of each image).
template <int C>
__global__ void __launch_bounds__(256) wide_ln_kernel(const bf16* __restrict__ x,
                                                      bf16* __restrict__ out, int HX, int r0,
                                                      int R, int W, long long pixels) {
  constexpr int U = C / 128;  // 4-channel units a lane
  const long long p = (long long)blockIdx.x * kLnPixels + threadIdx.x / 32;
  if (p >= pixels) return;
  const int lane = threadIdx.x % 32;
  const long long per = (long long)R * W, b = p / per;
  const bf16* src = x + ((b * HX + r0) * W + (p - b * per)) * C;
  float v[U][4];
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const uint2 w = *reinterpret_cast<const uint2*>(src + (u * 32 + lane) * 4);
    v[u][0] = bf_lo(w.x), v[u][1] = bf_hi(w.x), v[u][2] = bf_lo(w.y), v[u][3] = bf_hi(w.y);
    s += (v[u][0] + v[u][1]) + (v[u][2] + v[u][3]);
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float mu = s * (1.0f / C);
  float q = 0.f;
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) q += (v[u][e] - mu) * (v[u][e] - mu);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
  const float inv = rsqrtf(q * (1.0f / C) + 1e-5f);
  bf16* dst = out + p * C;
#pragma unroll
  for (int u = 0; u < U; ++u)
    *reinterpret_cast<uint2*>(dst + (u * 32 + lane) * 4) =
        make_uint2(pack_bf2((v[u][0] - mu) * inv, (v[u][1] - mu) * inv),
                   pack_bf2((v[u][2] - mu) * inv, (v[u][3] - mu) * inv));
}

// ---------------------------------------------------------------------------
// The GEMM: 128 x TN tiles on wgmma, TMA-fed by a producer warp.
//
// A's stage is one TMA box of 64 channels x 128 rows with the 128-byte
// swizzle: row r's 128 bytes at r * 128, 8-row atoms 1024 bytes apart; as a
// K-major operand its descriptor's SBO is 1024, its LBO unused (16), and
// k16 step j starts 32 j bytes into the rows. B's stage is TN / 64 boxes of
// 64 channels x 64 K rows, MN-major as in the weight-grad pass (LBO 8 KB
// between boxes, SBO 1 KB between 8-row groups, step j 2048 bytes on).
// ---------------------------------------------------------------------------

constexpr int kGm = 128;             // rows of a tile: two warpgroups of 64
constexpr int kGk = 64;              // K rows a stage
constexpr int kGStages = 4;          // ring slots
constexpr int kGThreads = 288;       // two consumer warpgroups and the producer warp
constexpr int kGA = kGm * kGk * 2;   // A's bytes a stage
constexpr int kGBox = 64 * kGk * 2;  // one B box

template <int TN>
__host__ __device__ constexpr int gemm_stage_bytes() {
  return kGA + TN / 64 * kGBox;
}
// The ring (aligned to the swizzle's 1024-byte period), then the full and
// empty barriers.
template <int TN>
__host__ __device__ constexpr int gemm_smem() {
  return 1024 + kGStages * gemm_stage_bytes<TN>() + 2 * kGStages * 8;
}

struct GemmArgs {
  CUtensorMap a;  // A [G, M, K] as boxes of 64 K x 128 rows
  CUtensorMap b;  // B [Gb, K, N] as boxes of 64 N x 64 K (Gb = G if batched, else 1)
  const float* bias;  // [N]
  void* out;          // [G * M, N]: fp32 (z) or bf16 (with the residual)
  const bf16* res;    // the residual [B, RR, W, N] (bf16 epilogue)
  int G, M, K, N, batched;
  // Output row p of the call (p = g M + m) is pixel (p / (R W), p / W % R,
  // p % W) of a [B, R, W, N] tensor; the residual's row of it is r + dr of RR.
  int R, W, RR, dr;
  // z's row mask: frame row (b % bands) hb + fr0 + r, real in [0, frame_h).
  int bands, hb, fr0, frame_h;
};

template <int TN, bool RES>
__device__ __forceinline__ void gemm_epilogue(const GemmArgs& g, const float (&d)[TN / 2],
                                              int grp, int mi, int ni, int wg) {
  const int t = threadIdx.x % 128, l = t % 32;
  const int n0 = ni * TN + 2 * (l % 4);
  const long long per = (long long)g.R * g.W;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = mi * kGm + 64 * wg + 16 * (t / 32) + l / 4 + 8 * h;
    if (row >= g.M) continue;
    const long long p = (long long)grp * g.M + row, b = p / per;
    const int r = (int)(p / g.W % g.R);
    if constexpr (!RES) {
      const int fr = (int)(b % g.bands) * g.hb + g.fr0 + r;
      const bool real = fr >= 0 && fr < g.frame_h;
      float* o = reinterpret_cast<float*>(g.out) + p * g.N + n0;
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
        const float2 bb = ld2(g.bias + n0 + 8 * j);
        *reinterpret_cast<float2*>(o + 8 * j) =
            real ? make_float2(d[4 * j + 2 * h] + bb.x, d[4 * j + 2 * h + 1] + bb.y)
                 : make_float2(0.f, 0.f);
      }
    } else {
      const int c = (int)(p % g.W);
      bf16* o = reinterpret_cast<bf16*>(g.out) + p * g.N + n0;
      const bf16* rs = g.res + ((b * g.RR + r + g.dr) * g.W + c) * g.N + n0;
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
        const float2 bb = ld2(g.bias + n0 + 8 * j), rv = ld_bf2(rs + 8 * j);
        st_bf2(o + 8 * j, d[4 * j + 2 * h] + bb.x + rv.x, d[4 * j + 2 * h + 1] + bb.y + rv.y);
      }
    }
  }
}

template <int TN, bool RES>
__global__ void __launch_bounds__(kGThreads, 1) wide_gemm_kernel(const __grid_constant__ GemmArgs g) {
  unsigned char* raw = dyn_smem();
  unsigned char* const ring = raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
  uint64_t* const full = reinterpret_cast<uint64_t*>(ring + kGStages * gemm_stage_bytes<TN>());
  uint64_t* const empty = full + kGStages;
  const int mt = (g.M + kGm - 1) / kGm, nt = g.N / TN, tiles = g.G * mt * nt, ks = g.K / kGk;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kGStages; ++i) mbar_init(&full[i], 1), mbar_init(&empty[i], 2);
    fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x >= 256) {  // the producer warp: its lane 0 issues every load
    if (threadIdx.x != 256) return;
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int ni = t % nt, mi = t / nt % mt, grp = t / (nt * mt);
      for (int k = 0; k < ks; ++k, ++it) {
        const int s = it % kGStages;
        if (it >= kGStages) mbar_wait(&empty[s], (it / kGStages - 1) & 1);
        unsigned char* dst = ring + s * gemm_stage_bytes<TN>();
        mbar_expect_tx(&full[s], gemm_stage_bytes<TN>());
        tma_load_3d(dst, &g.a, k * kGk, mi * kGm, grp, &full[s]);
#pragma unroll
        for (int j = 0; j < TN / 64; ++j)
          tma_load_3d(dst + kGA + j * kGBox, &g.b, ni * TN + 64 * j, k * kGk,
                      g.batched ? grp : 0, &full[s]);
      }
    }
    return;
  }
  const int wg = threadIdx.x / 128;
  const bool leader = threadIdx.x % 128 == 0;
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int ni = t % nt, mi = t / nt % mt, grp = t / (nt * mt);
    float d[TN / 2];
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) d[i] = 0.f;
    for (int k = 0; k < ks; ++k, ++it) {
      const int s = it % kGStages;
      mbar_wait(&full[s], (it / kGStages) & 1);
      const unsigned char* sa = ring + s * gemm_stage_bytes<TN>() + wg * (kGA / 2);
      const unsigned char* sb = ring + s * gemm_stage_bytes<TN>() + kGA;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kGk / 16; ++j)
        wgmma_m64nk16<TN, 0>(d, wgmma_desc_sw128(sa + 32 * j, 16, 1024),
                             wgmma_desc_sw128(sb + 2048 * j, kGBox, 1024), 1);
      wgmma_commit();
      wgmma_wait<1>(d);  // the previous stage's products are done: free its slot
      if (k > 0 && leader) mbar_arrive(&empty[(it - 1) % kGStages]);
    }
    wgmma_wait<0>(d);
    if (leader) mbar_arrive(&empty[(it - 1) % kGStages]);
    gemm_epilogue<TN, RES>(g, d, grp, mi, ni, wg);
  }
}

// A [G, M, K] / B [Gb, K, N] bf16 as a 3-D tensor map of b0 x b1 boxes
// (the innermost dimension first), 128-byte swizzle, zeros outside the
// tensor. The last few maps are kept: a block hands the same buffers again.
bool gemm_map(CUtensorMap* map, const void* p, int d0, int d1, int d2, int b0, int b1) {
  struct Entry {
    const void* p;
    int d0, d1, d2, b0, b1;
    CUtensorMap map;
  };
  static std::mutex mu;
  static Entry cache[32] = {};
  static int next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache)
    if (e.p == p && e.d0 == d0 && e.d1 == d1 && e.d2 == d2 && e.b0 == b0 && e.b1 == b1) {
      *map = e.map;
      return true;
    }
  TmaEncodeTiled fn = tma_encoder();
  if (!fn || p == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)d0 * 2, (cuuint64_t)d0 * d1 * 2};
  const cuuint32_t box[3] = {(cuuint32_t)b0, (cuuint32_t)b1, 1}, unit[3] = {1, 1, 1};
  if (fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p), dims, strides, box, unit,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  cache[next] = {p, d0, d1, d2, b0, b1, *map};
  next = (next + 1) % 32;
  return true;
}

// f(kernel, smem) for the kernel of tile width tn (192, 256) and epilogue.
template <typename F>
cudaError_t with_gemm(int tn, bool res, F&& f) {
  if (tn == 256) return res ? f(wide_gemm_kernel<256, true>, gemm_smem<256>())
                            : f(wide_gemm_kernel<256, false>, gemm_smem<256>());
  if (tn == 192) return res ? f(wide_gemm_kernel<192, true>, gemm_smem<192>())
                            : f(wide_gemm_kernel<192, false>, gemm_smem<192>());
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The depthwise 3x3 pass.
// ---------------------------------------------------------------------------

constexpr int kDwRows = 8;  // output rows a thread walks
constexpr int kDwCols = 8;  // columns a CTA: a warp each, 32 channel quads a warp

enum DwEpi { kDwQK = 0, kDwV = 1, kDwGelu = 2 };

// Output row r of image b (r < RO) is the dw3x3 centred on z row r + dz of
// z [B, RZ, W, F] (zeros outside [0, RZ) x [0, W)) plus the bias. kDwQK:
// channels [0, C) to out0 (q) and [C, 2C) to out1 (k), both [B, RO, W, C]
// bf16, zero where frame row (b % bands) hb + r is outside [0, frame_h);
// the CTA's sums of their squares (the bf16 values) to partials [B, NX, F]
// (NX = gridDim.x). kDwV / kDwGelu: out0 [B, RO, W, F] bf16 of the value or
// its GELU. Grid (cdiv(W, 8) cdiv(RO, 8), F / 128, B).
template <int EPI>
__global__ void __launch_bounds__(256) wide_dw_kernel(
    const float* __restrict__ z, const float* __restrict__ taps, const float* __restrict__ bias,
    bf16* __restrict__ out0, bf16* __restrict__ out1, float* __restrict__ partials, int RZ,
    int RO, int dz, int W, int F, int bands, int hb, int frame_h) {
  const int q = threadIdx.x % 32, j = threadIdx.x / 32, ncg = (W + kDwCols - 1) / kDwCols;
  const int cg = blockIdx.x % ncg, r0 = blockIdx.x / ncg * kDwRows;
  const int b = blockIdx.z, n = blockIdx.y * 128 + 4 * q, c = cg * kDwCols + j;
  const int r1 = min(RO, r0 + kDwRows), C = F / 2;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 ss = zero;
  if (c < W) {
    float4 t[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) t[k] = ld4(taps + k * F + n);
    const float4 bb = ld4(bias + n);
    const float* zb = z + (size_t)b * RZ * W * F + n;
    auto load = [&](int zr, int cc) {
      return zr >= 0 && zr < RZ && cc >= 0 && cc < W ? ld4(zb + ((size_t)zr * W + cc) * F) : zero;
    };
    float4 w[3][3];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) w[r][dj] = load(r0 + dz - 1 + r, c - 1 + dj);
#pragma unroll
    for (int i = 0; i < kDwRows; ++i) {
      const int r = r0 + i;
      if (r >= r1) break;
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) w[(i + 2) % 3][dj] = load(r + dz + 1, c - 1 + dj);
      float4 a = bb;
#pragma unroll
      for (int di = 0; di < 3; ++di)
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) a = fma4(w[(i + di) % 3][dj], t[di * 3 + dj], a);
      const size_t pix = ((size_t)b * RO + r) * W + c;
      if constexpr (EPI == kDwQK) {
        const int fr = (b % bands) * hb + r;
        uint2 v = make_uint2(pack_bf2(a.x, a.y), pack_bf2(a.z, a.w));
        if (fr < 0 || fr >= frame_h) v = make_uint2(0u, 0u);
        bf16* o = n < C ? out0 + pix * C + n : out1 + pix * C + n - C;
        *reinterpret_cast<uint2*>(o) = v;
        const float v0 = bf_lo(v.x), v1 = bf_hi(v.x), v2 = bf_lo(v.y), v3 = bf_hi(v.y);
        ss.x = fmaf(v0, v0, ss.x), ss.y = fmaf(v1, v1, ss.y);
        ss.z = fmaf(v2, v2, ss.z), ss.w = fmaf(v3, v3, ss.w);
      } else if constexpr (EPI == kDwV) {
        st_bf4(out0 + pix * F + n, a);
      } else {
        st_bf4(out0 + pix * F + n, make_float4(gelu(a.x), gelu(a.y), gelu(a.z), gelu(a.w)));
      }
    }
  }
  if constexpr (EPI == kDwQK) {
    __shared__ float4 red[kDwCols][32];
    red[j][q] = ss;
    __syncthreads();
    if (j == 0) {
      float4 acc = red[0][q];
#pragma unroll
      for (int k = 1; k < kDwCols; ++k) {
        const float4 o = red[k][q];
        acc.x += o.x, acc.y += o.y, acc.z += o.z, acc.w += o.w;
      }
      *reinterpret_cast<float4*>(partials + ((size_t)b * gridDim.x + blockIdx.x) * F + n) = acc;
    }
  }
}

// out[b] = [gram[b] (C x C) | the sums of the partials [b, :NX, 2C] in
// order]: 4 floats a thread. Grid (cdiv(C * C + 2C, 1024), B).
__global__ void __launch_bounds__(256) wide_gram_finish_kernel(const float* __restrict__ gram,
                                                               const float* __restrict__ partials,
                                                               float* __restrict__ out, int C,
                                                               int NX) {
  const int b = blockIdx.y, e = 4 * (blockIdx.x * 256 + threadIdx.x), E = C * C + 2 * C;
  if (e >= E) return;
  float4 v;
  if (e < C * C) {
    v = ld4(gram + (size_t)b * C * C + e);
  } else {
    const float* src = partials + (size_t)b * NX * 2 * C + (e - C * C);
    v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int x = 0; x < NX; ++x) {
      const float4 o = ld4(src + (size_t)x * 2 * C);
      v.x += o.x, v.y += o.y, v.z += o.z, v.w += o.w;
    }
  }
  *reinterpret_cast<float4*>(out + (size_t)b * E + e) = v;
}

bool wide_c(int C) { return C == 384 || C == 512; }

}  // namespace

// out [B, R, W, C] bf16 <- LayerNorm of rows [r0, r0 + R) of each image of
// x [B, HX, W, C] bf16 (no affine, fp32 statistics).
extern "C" int blle_wide_layernorm(const void* x, void* out, int B, int HX, int r0, int R, int W,
                                   int C, void* stream) {
  if (!wide_c(C) || B < 1 || R < 1 || W < 1 || r0 < 0 || r0 + R > HX)
    return (int)cudaErrorInvalidValue;
  const long long pixels = (long long)B * R * W;
  const long long blocks = (pixels + kLnPixels - 1) / kLnPixels;
  if (blocks > (1LL << 31) - 1) return (int)cudaErrorInvalidValue;
  auto run = [&](auto kernel) {
    return (int)launch(kernel, dim3((unsigned)blocks), dim3(256), 0, (cudaStream_t)stream,
                       (const bf16*)x, (bf16*)out, HX, r0, R, W, pixels);
  };
  return C == 384 ? run(wide_ln_kernel<384>) : run(wide_ln_kernel<512>);
}

// One product, its arguments in table[0 .. 19]: A, B, bias, residual (or
// NULL: the fp32 z epilogue), out, G, M, K, N, batched, tile width (192 or
// 256), CTAs, R, W, RR, dr, bands, hb, fr0, frame_h (GemmArgs); kernels/
// wide_block.py `gemm_plan` lays it out.
extern "C" int blle_wide_gemm(const long long* t, void* stream) {
  GemmArgs g{};
  g.bias = (const float*)t[2];
  g.res = (const bf16*)t[3];
  g.out = (void*)t[4];
  g.G = (int)t[5], g.M = (int)t[6], g.K = (int)t[7], g.N = (int)t[8], g.batched = (int)t[9];
  const int tn = (int)t[10], ctas = (int)t[11];
  g.R = (int)t[12], g.W = (int)t[13], g.RR = (int)t[14], g.dr = (int)t[15];
  g.bands = (int)t[16], g.hb = (int)t[17], g.fr0 = (int)t[18], g.frame_h = (int)t[19];
  if ((tn != 192 && tn != 256) || g.G < 1 || g.M < 1 || g.K < kGk || g.K % kGk || g.N % tn ||
      g.R < 1 || g.W < 1 || (long long)g.G * g.M % ((long long)g.R * g.W) || g.bands < 1 ||
      (g.res && g.RR < g.R + g.dr) || !t[0] || !t[1] || !t[2] || !t[4])
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)g.G * ((g.M + kGm - 1) / kGm) * (g.N / tn);
  if (ctas < 1 || ctas > tiles || tiles > (1LL << 31) - 1 ||
      !gemm_map(&g.a, (const void*)t[0], g.K, g.M, g.G, kGk, kGm) ||
      !gemm_map(&g.b, (const void*)t[1], g.N, g.K, g.batched ? g.G : 1, 64, kGk))
    return (int)cudaErrorInvalidValue;
  return (int)with_gemm(tn, g.res != nullptr, [&](auto kernel, int smem) {
    return launch(kernel, dim3(ctas), dim3(kGThreads), smem, (cudaStream_t)stream, g);
  });
}

// info = {dynamic shared memory bytes, threads a CTA, ring stages, CTAs an
// SM (the occupancy API's)} of the GEMM of tile width tn.
extern "C" int blle_wide_gemm_info(int tn, long long* info) {
  return (int)with_gemm(tn, false, [&](auto kernel, int smem) {
    info[0] = smem, info[1] = kGThreads, info[2] = kGStages;
    info[3] = blocks_per_sm(kernel, kGThreads, smem);
    return info[3] > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
  });
}

// The depthwise pass (wide_dw_kernel) with epilogue epi (0 q / k with the
// partial sums, 1 v, 2 GELU); bands, hb, frame_h: q / k's counted rows.
extern "C" int blle_wide_dw(const void* z, const void* taps, const void* bias, void* out0,
                            void* out1, void* partials, int B, int RZ, int RO, int dz, int W,
                            int F, int epi, int bands, int hb, int frame_h, void* stream) {
  if (B < 1 || B > 65535 || RZ < 1 || RO < 1 || W < 1 || F % 128 || F < 128 || bands < 1 ||
      epi < 0 || epi > 2 || (epi == kDwQK && (!out1 || !partials || F % 256)))
    return (int)cudaErrorInvalidValue;
  const long long nx = (long long)((W + kDwCols - 1) / kDwCols) * ((RO + kDwRows - 1) / kDwRows);
  if (nx > (1LL << 31) - 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)nx, F / 128, B);
  auto run = [&](auto kernel) {
    return (int)launch(kernel, grid, dim3(256), 0, (cudaStream_t)stream, (const float*)z,
                       (const float*)taps, (const float*)bias, (bf16*)out0, (bf16*)out1,
                       (float*)partials, RZ, RO, dz, W, F, bands, hb, frame_h);
  };
  if (epi == kDwQK) return run(wide_dw_kernel<kDwQK>);
  return epi == kDwV ? run(wide_dw_kernel<kDwV>) : run(wide_dw_kernel<kDwGelu>);
}

// out [B, C*C + 2C] fp32 <- gram [B, C, C] and the dw pass's partials
// [B, nx, 2C] summed over nx in order.
extern "C" int blle_wide_gram_finish(const void* gram, const void* partials, void* out, int B,
                                     int C, int nx, void* stream) {
  if (!wide_c(C) || B < 1 || B > 65535 || nx < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((C * C + 2 * C + 1023) / 1024, B);
  return (int)launch(wide_gram_finish_kernel, grid, dim3(256), 0, (cudaStream_t)stream,
                     (const float*)gram, (const float*)partials, (float*)out, C, nx);
}
