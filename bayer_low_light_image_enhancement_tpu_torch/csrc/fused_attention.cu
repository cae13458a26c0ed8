// A1: the standalone channel attention (ChannelAttention's forward, without
// LayerNorm or residual), the port of the retired TPU kernel
// `fused_channel_attention` (attic/fused_attention.py):
//
//   q, k, v = dw3x3(conv1x1(x))   (the 1x1 output zero-padded for the dw)
//   out     = proj(softmax_head(norm(q)^T norm(k) * T) applied to v)
//
// Four launches, no torch arithmetic between them:
//   1. the gram pass, K2's tile kernel without the LayerNorm
//      (gram_kernel<C, false>, block_tiles.cuh): per image the gram q^T k
//      and the sums of q^2 and k^2, one partial per persistent CTA;
//   2. the fixed-order reduction of those partials (gram_reduce_kernel);
//   3. the finalise (attn_finalize_kernel, below), which the TPU kernel ran
//      in its own body: normalisation, temperature, the per-head softmax and
//      the projection folded into one bf16 [C, C] matrix `apply` per image;
//   4. the apply pass, K3's phase-1 kernel without LN1 at its STAGE 2
//      (apply1_kernel<C, 2, false>, block_tiles.cuh): v = dw3x3(x @ wv + bv)
//      per tile, out = v @ apply + b_proj.
// x is read twice and the output written once; q, k and v never leave
// shared memory. The gram and apply kernels are persistent on the grids of
// the wrapper's plan (kernels/fused_block.py `block_plan`, kinds
// "attn_gram" and "attn_apply").
//
// Bound on the H100: x read twice and the output written once (0.02-0.11 ms
// at the RawFormer-S block shapes), a few GFLOP on the tensor cores: both
// tile kernels inherit K2's and K3's design against it (the next window by
// cp.async, weights in shared memory, mma.sync from shared memory). The
// finalise is a few microseconds of L2-resident work; it reads only the
// heads' diagonal ch x ch blocks of the gram (the head mask zeroes the
// rest of the softmax).
// Widths: C in {32, 48, 64, 96, 128, 192, 256}; any head count dividing C.
#include "block_tiles.cuh"

#include <cmath>

namespace {

// The finalise: one CTA per (block of kFinJB attention columns and block of
// kFinDW output columns, head, image). Every read of device memory is staged
// through a shared buffer of kFinBuf floats that all threads fill at once,
// so a step waits for one load latency and not one per row: first the
// head's logits, kFinBuf / ch rows at a time (each row's max and sum, a warp
// a row, then the CTA's columns of the softmax), then the head's rows of
// wproj's column block, for apply[c0 + j][d] = sum_i attn[i][j]
// wproj[c0 + i][d]. Each column block takes the rows' max and sum itself
// (ch x ch logits): the blocks spread a narrow call over more SMs. A thread
// owns one column d and a run of at most kFinRpt rows j, a multiple of 4, so
// that it reads its softmax values as float4.
constexpr int kFinThreads = 256, kFinJB = 32, kFinDW = 64, kFinRpt = 8, kFinBuf = 8192;
static_assert(kFinThreads / kFinDW * kFinRpt >= kFinJB, "the groups cover the rows");

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared floats of the finalise at head width ch.
__host__ __device__ constexpr int finalize_smem_floats(int ch) {
  return kFinBuf + (4 + kFinJB) * ch;
}

// sums [B][C*C + 2C] fp32 (gram, sum q^2, sum k^2), temperature [heads],
// wproj [C][C] fp32 ([in][out]) -> apply [B][C][C] bf16; ch = C / heads.
__global__ void __launch_bounds__(kFinThreads) attn_finalize_kernel(
    const float* __restrict__ sums, const float* __restrict__ temperature,
    const float* __restrict__ wproj, bf16* __restrict__ apply, int C, int ch) {
  constexpr int NW = kFinThreads / 32;
  float* const buf = reinterpret_cast<float*>(dyn_smem());  // [kFinBuf] staging
  float* const qinv = buf + kFinBuf;                        // [ch]
  float* const kinv = qinv + ch;                            // [ch]
  float* const rmax = kinv + ch;                            // [ch] row max
  float* const rinv = rmax + ch;                            // [ch] 1 / row sum
  float* const prob = rinv + ch;                            // [ch][kFinJB]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int cols = min(C, kFinDW), nd = (C + cols - 1) / cols;
  const int j0 = blockIdx.x / nd * kFinJB, d0 = blockIdx.x % nd * cols;
  const int h = blockIdx.y, b = blockIdx.z;
  const int c0 = h * ch, nj = min(kFinJB, ch - j0);
  const float* const gram = sums + (size_t)b * (C * C + 2 * C);
  const float* const qss = gram + (size_t)C * C;
  const float* const kss = qss + C;
  const float temp = temperature[h];
  // F.normalize's 1 / max(|x|, 1e-12).
  for (int i = tid; i < ch; i += kFinThreads) {
    qinv[i] = 1.0f / fmaxf(sqrtf(qss[c0 + i]), 1e-12f);
    kinv[i] = 1.0f / fmaxf(sqrtf(kss[c0 + i]), 1e-12f);
  }
  __syncthreads();
  const int rows = kFinBuf / ch < ch ? kFinBuf / ch : ch;  // logit rows a step
  for (int i0 = 0; i0 < ch; i0 += rows) {
    const int nr = min(rows, ch - i0);
    // buf[i][j]: the logit of row i0 + i, in the twin's order of products.
#pragma unroll 4
    for (int e = tid; e < nr * ch; e += kFinThreads) {
      const int i = e / ch, j = e % ch;
      buf[e] = gram[(size_t)(c0 + i0 + i) * C + c0 + j] * qinv[i0 + i] * kinv[j] * temp;
    }
    __syncthreads();
    for (int i = warp; i < nr; i += NW) {
      const float* row = buf + i * ch;
      float m = -INFINITY;
      for (int j = lane; j < ch; j += 32) m = fmaxf(m, row[j]);
      m = warp_max(m);
      float l = 0.f;
      for (int j = lane; j < ch; j += 32) l += expf(row[j] - m);
      l = warp_sum(l);
      if (lane == 0) rmax[i0 + i] = m, rinv[i0 + i] = 1.0f / l;
    }
    __syncthreads();
    for (int e = tid; e < nr * nj; e += kFinThreads) {
      const int i = e / nj, jj = e % nj;
      prob[(i0 + i) * kFinJB + jj] = expf(buf[i * ch + j0 + jj] - rmax[i0 + i]) * rinv[i0 + i];
    }
    __syncthreads();  // buf is free again
  }
  // Thread tid: output column d = d0 + tid % cols, rows jt .. jt + rpt - 1 of
  // the block, jt = g rpt (g = tid / cols of G groups; threads past the
  // groups only stage wproj).
  const int G = kFinThreads / cols, g = tid / cols, d = d0 + tid % cols;
  const int rpt = ((kFinJB + G - 1) / G + 3) / 4 * 4, jt = g * rpt;
  const int krows = kFinBuf / cols < ch ? kFinBuf / cols : ch;  // wproj rows a step
  float acc[kFinRpt] = {};
  for (int i0 = 0; i0 < ch; i0 += krows) {
    const int ni = min(krows, ch - i0);
#pragma unroll 4
    for (int e = tid; e < ni * cols; e += kFinThreads) {
      const int i = e / cols, dd = d0 + e % cols;
      buf[e] = dd < C ? wproj[(size_t)(c0 + i0 + i) * C + dd] : 0.f;
    }
    __syncthreads();
    if (g < G && jt < nj)
      for (int i = 0; i < ni; ++i) {
        const float w = buf[i * cols + tid % cols];
        const float4* p = reinterpret_cast<const float4*>(prob + (i0 + i) * kFinJB + jt);
#pragma unroll
        for (int q = 0; q < kFinRpt / 4; ++q)
          if (4 * q < rpt) {
            const float4 v = p[q];
            acc[4 * q] = fmaf(v.x, w, acc[4 * q]);
            acc[4 * q + 1] = fmaf(v.y, w, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(v.z, w, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(v.w, w, acc[4 * q + 3]);
          }
      }
    __syncthreads();  // buf is free again
  }
  if (g < G && d < C) {
    bf16* out = apply + ((size_t)b * C + c0 + j0 + jt) * C + d;
#pragma unroll
    for (int r = 0; r < kFinRpt; ++r)
      if (r < rpt && jt + r < nj) out[(size_t)r * C] = f2bf(acc[r]);
  }
}

// The apply pass's plan (kernels/fused_block.py kind "attn_apply"): TH, TW,
// threads, shared-memory bytes, blocks per SM.
template <int C>
cudaError_t attn_apply_info(long long* info) {
  using A = Apply1Cfg<C>;
  info[0] = A::TH, info[1] = A::TW, info[2] = A::NT, info[3] = A::SMEM;
  info[4] = blocks_per_sm(apply1_kernel<C, 2, false>, A::NT, A::SMEM);
  return info[4] > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

}  // namespace

extern "C" long long blle_attn_gram_workspace_floats(int B, int H, int W, int C) {
  return gram_workspace_floats<false>(B, H, W, C);
}

// x [B,H,W,C] bf16 -> out [B, C*C + 2C] fp32 (gram q^T k, sum q^2, sum k^2)
// with q, k = dw3x3(x @ wqk + bqk), no LayerNorm; on ncta CTAs per (image,
// channel block) (<= 0: the library's own, which
// blle_attn_gram_workspace_floats sizes).
extern "C" int blle_attn_gram(const void* x, const void* wqk, const void* bqk,
                              const void* dwqk, const void* bdwqk, void* workspace, void* out,
                              int B, int H, int W, int C, int ncta, void* stream) {
  return (int)gram_pass<false>(x, wqk, bqk, dwqk, bdwqk, workspace, out, B, H, W, C, ncta,
                               (cudaStream_t)stream);
}

// sums [B, C*C + 2C] fp32 (blle_attn_gram's out), temperature [heads] fp32,
// wproj [C, C] fp32 ([in, out]) -> apply [B, C, C] bf16, the per-head
// normalised softmax folded into the projection.
extern "C" int blle_attn_finalize(const void* sums, const void* temperature, const void* wproj,
                                  void* apply, int B, int C, int heads, void* stream) {
  if (B < 1 || B > 65535 || C < 1 || heads < 1 || heads > 65535 || C % heads)
    return (int)cudaErrorInvalidValue;
  const int ch = C / heads;
  const size_t smem = (size_t)finalize_smem_floats(ch) * sizeof(float);
  if (smem > (size_t)kSmemPerBlock) return (int)cudaErrorInvalidValue;
  const int cols = C < kFinDW ? C : kFinDW;
  return (int)launch(attn_finalize_kernel, dim3(cdiv(ch, kFinJB) * cdiv(C, cols), heads, B),
                     dim3(kFinThreads), smem, (cudaStream_t)stream, (const float*)sums,
                     (const float*)temperature, (const float*)wproj, (bf16*)apply, C, ch);
}

// x [B,H,W,C] bf16, apply [B,C,C] bf16 -> out = dw3x3(x @ wv + bv) @ apply +
// bproj, [B,H,W,C] bf16, on `grid` CTAs (<= 0: as many as are resident, at
// most one per tile).
extern "C" int blle_attn_apply(const void* x, const void* apply, const void* wv,
                               const void* bv, const void* dwv, const void* bdwv,
                               const void* bproj, void* out, int B, int H, int W, int C,
                               int grid, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const void* p[7] = {x, apply, wv, bv, dwv, bdwv, bproj};
  switch (C) {
#define BLLE_RUN(c) \
  case c: return (int)apply_tiles<c, 2, false>(p, out, nullptr, B, H, W, s, grid);
    BLLE_WIDTHS(BLLE_RUN)
#undef BLLE_RUN
    default: return (int)cudaErrorInvalidValue;
  }
}

// The apply pass's plan at width C (blle_block_kernel_info's kind 5).
extern "C" int blle_attn_apply_info(int C, long long* info) {
  switch (C) {
#define BLLE_INFO(c) case c: return (int)attn_apply_info<c>(info);
    BLLE_WIDTHS(BLLE_INFO)
#undef BLLE_INFO
    default: return (int)cudaErrorInvalidValue;
  }
}
