// The weight-grad products of B1 and B2 at C >= 96: out[g] = A[g]^T B[g],
// A [G, K, M] and B [G, K, N] bf16 (K = pixels, the channels contiguous),
// fp32 out [G, M, N].
//
// Part of the port of the TPU kernels `_bwd1_kernel` and `_bwd2_kernel`
// (bayer_low_light_image_enhancement_tpu/kernels/fused_block_bwd.py:194 and
// :318), whose weight-grad outputs stayed resident across the TPU's
// sequential grid. At C >= 96 B1's [C, 2C] accumulators do not fit on chip,
// so fused_block_bwd.cu writes each product's operands once per pixel and
// this pass contracts them over all pixels of the launch (B1: d_apply per
// image, dwp1, dwp2; B2: [dwqk|dwv]).
//
// Bound: reading A and B once (K (M + N) bf16); the products are
// 2 M N K flops, far below the tensor cores' rate. Design: one warpgroup per
// block computes a 64x64 output tile over a slice of K on wgmma (m64n64k16,
// both operands MN-major in shared memory without swizzle, see wgmma.cuh),
// the next 64-pixel stage loaded by cp.async while the current one
// multiplies. K is split over blocks so that a launch has about a thousand
// of them; each writes its fp32 partial tile once and a second kernel sums
// the slices in a fixed order (no atomics: deterministic). Up to four
// products share a launch (kernels/weight_grad.py plans the split).
#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kMaxProblems = 4;
constexpr int kWgSmem = 2 * 2 * 64 * 64 * 2;  // two stages of a 64x64 A and B tile, bf16

struct WgProblem {
  const bf16* a;   // [G, K, M]
  const bf16* b;   // [G, K, N]
  float* ws;       // partials [G, S, M, N]
  float* out;      // [G, M, N]
  int G, K, M, N;  // M, N multiples of 8
  int S, kslice;   // K slices of kslice rows (a multiple of 64), the last ragged
  int first_cta;   // the problem's first block in the launch
};
struct WgProblems {
  WgProblem p[kMaxProblems];
  int n;
};

// The problem of block `cta` (problems sorted by first_cta; fixed indices
// keep the parameter struct out of local memory).
__device__ __forceinline__ WgProblem problem_of(const WgProblems& pr, int cta) {
  WgProblem P = pr.p[0];
#pragma unroll
  for (int i = 1; i < kMaxProblems; ++i)
    if (i < pr.n && cta >= pr.p[i].first_cta) P = pr.p[i];
  return P;
}

__global__ void __launch_bounds__(128) weight_grad_kernel(const __grid_constant__ WgProblems pr) {
  bf16(*sa)[64 * 64] = reinterpret_cast<bf16(*)[64 * 64]>(dyn_smem());  // 2 stages of A
  bf16(*sb)[64 * 64] = sa + 2;                                             // and of B
  const WgProblem P = problem_of(pr, blockIdx.x);
  const int tid = threadIdx.x;
  const int mt = (P.M + 63) / 64, nt = (P.N + 63) / 64;
  int cta = blockIdx.x - P.first_cta;
  const int s = cta % P.S;
  cta /= P.S;
  const int ni = cta % nt;
  cta /= nt;
  const int mi = cta % mt, g = cta / mt;
  const int k0 = s * P.kslice, k1 = min(P.K, k0 + P.kslice);
  const int m0 = mi * 64, n0 = ni * 64;
  const bf16* A = P.a + (size_t)g * P.K * P.M;
  const bf16* B = P.b + (size_t)g * P.K * P.N;

  // Stage `buf` <- rows [kk, kk + 64) of the slice: 16-byte chunks of 8
  // channels; chunk (k, u) is row k%8 of the core matrix (u, k/8) (64
  // elements each, K-adjacent core matrices 128 bytes apart, M-adjacent 1024).
  auto load = [&](int buf, int kk) {
    for (int c = tid; c < 512; c += 128) {
      const int k = c / 8, u = c % 8, row = kk + k;
      const int o = (u * 8 + k / 8) * 64 + (k % 8) * 8;
      const bool va = row < k1 && m0 + 8 * u < P.M, vb = row < k1 && n0 + 8 * u < P.N;
      cp_async16(&sa[buf][o], va ? A + (size_t)row * P.M + m0 + 8 * u : A, va);
      cp_async16(&sb[buf][o], vb ? B + (size_t)row * P.N + n0 + 8 * u : B, vb);
    }
  };

  float d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.0f;
  const int steps = (k1 - k0 + 63) / 64;
  load(0, k0);
  cp_async_commit();
  for (int it = 0; it < steps; ++it) {
    const int buf = it & 1;
    if (it + 1 < steps) load(buf ^ 1, k0 + 64 * (it + 1));
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)  // k16 step j: core matrices 2j, 2j+1 along K
      wgmma_m64n64k16(d, wgmma_desc(&sa[buf][j * 128], 128, 1024),
                      wgmma_desc(&sb[buf][j * 128], 128, 1024), 1);
    wgmma_commit();
    wgmma_wait_all(d);
    __syncthreads();
  }

  // The partial tile, written once: d[4j..4j+3] = D[r][c], D[r][c+1],
  // D[r+8][c], D[r+8][c+1] (wgmma.cuh).
  float* out = P.ws + (size_t)(g * P.S + s) * P.M * P.N;
  const int w = tid / 32, l = tid % 32;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int r = m0 + 16 * w + l / 4, c = n0 + 8 * j + 2 * (l % 4);
    if (c < P.N) {
      if (r < P.M)
        *reinterpret_cast<float2*>(out + (size_t)r * P.N + c) = make_float2(d[4 * j], d[4 * j + 1]);
      if (r + 8 < P.M)
        *reinterpret_cast<float2*>(out + (size_t)(r + 8) * P.N + c) =
            make_float2(d[4 * j + 2], d[4 * j + 3]);
    }
  }
}

// out[g][e] = sum over s of ws[g][s][e], s in order; grid (., G, problems).
__global__ void __launch_bounds__(256) weight_grad_reduce_kernel(
    const __grid_constant__ WgProblems pr) {
  WgProblem P = pr.p[0];
#pragma unroll
  for (int i = 1; i < kMaxProblems; ++i)
    if (i == (int)blockIdx.z) P = pr.p[i];
  const int g = blockIdx.y, mn = P.M * P.N, e = blockIdx.x * 256 + threadIdx.x;
  if (g >= P.G || e >= mn) return;
  const float* src = P.ws + (size_t)g * P.S * mn + e;
  float acc = 0.0f;
  for (int s = 0; s < P.S; ++s) acc += src[(size_t)s * mn];
  P.out[(size_t)g * mn + e] = acc;
}

}  // namespace

// n products described by table[11 * i ...] = a, b, ws, out, G, K, M, N, S,
// kslice, first_cta (kernels/weight_grad.py `plan`); problems in order of
// first_cta, the launch's blocks the last one's first_cta plus its G *
// ceil(M/64) * ceil(N/64) * S.
extern "C" int blle_weight_grad(const long long* table, int n, void* stream) {
  if (n < 1 || n > kMaxProblems) return (int)cudaErrorInvalidValue;
  WgProblems pr{};
  pr.n = n;
  int blocks = 0, max_mn = 0, max_g = 0;
  for (int i = 0; i < n; ++i) {
    const long long* t = table + 11 * i;
    WgProblem& P = pr.p[i];
    P.a = (const bf16*)t[0];
    P.b = (const bf16*)t[1];
    P.ws = (float*)t[2];
    P.out = (float*)t[3];
    P.G = (int)t[4], P.K = (int)t[5], P.M = (int)t[6], P.N = (int)t[7];
    P.S = (int)t[8], P.kslice = (int)t[9], P.first_cta = (int)t[10];
    if (P.G < 1 || P.K < 1 || P.M % 8 || P.N % 8 || P.M < 8 || P.N < 8 || P.S < 1 ||
        P.kslice % 64 || (long long)P.S * P.kslice < P.K ||
        (long long)(P.S - 1) * P.kslice >= P.K || P.first_cta != blocks)
      return (int)cudaErrorInvalidValue;
    blocks += P.G * cdiv(P.M, 64) * cdiv(P.N, 64) * P.S;
    max_mn = P.M * P.N > max_mn ? P.M * P.N : max_mn;
    max_g = P.G > max_g ? P.G : max_g;
  }
  for (int i = n; i < kMaxProblems; ++i) pr.p[i] = pr.p[n - 1];
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = launch(weight_grad_kernel, dim3(blocks), dim3(128), kWgSmem, s, pr);
  if (err != cudaSuccess) return (int)err;
  return (int)launch(weight_grad_reduce_kernel, dim3(cdiv(max_mn, 256), max_g, n), dim3(256), 0,
                     s, pr);
}
