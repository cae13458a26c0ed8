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
// Bound: reading A and B once (K (M + N) bf16 bytes); the products are
// 2 M N K flops, far below the tensor cores' rate, so the design is about
// moving each operand byte about once at the memory's rate:
//
// * A CTA computes a 128 x TN output tile (TN = 64, 128, 192 or 256, one
//   per launch) over a contiguous slice of K: two warpgroups of 64 rows on
//   wgmma m64nTNk16. With N <= 256 a K slice of A is read once per 256
//   columns, of B once per 128 rows.
// * TMA feeds a ring of kStages 64-pixel stages, kAhead in flight ahead of
//   the product: one thread issues a 64-channel x 64-pixel box per operand
//   column block (3-D tensor maps over [G, K, channels], zeros past K and
//   past the channels), one transaction barrier (mbarrier) a stage. The
//   boxes land in the 128-byte-swizzled MN-major layout wgmma reads
//   (wgmma.cuh; LBO = 8 KB between 64-channel atoms, SBO = 1 KB between
//   8-pixel rows, settled on the H100 by the weight-grad card tests). A
//   cp.async ring of the unswizzled layout stayed well below the memory's
//   rate whatever its depth or thread mapping; TMA keeps more bytes in
//   flight per SM.
//   wgmma.wait_group 1 lets each stage's product run while the next lands;
//   the CTA barrier after the stage's wait proves both warpgroups done with
//   the slot two stages back, which thread 0 then refills.
// * K slices: the CTAs of a thread-block cluster (kernels/weight_grad.py
//   `plan`: up to 8, one tile, consecutive slices) sum their fp32 tiles
//   through distributed shared memory in rank order, each rank a share of
//   the rows, so one partial per cluster reaches device memory, or the
//   output itself where one cluster covers all of K. Otherwise the last
//   cluster to store its partial rows (an arrival counter per tile and rank,
//   reset by that cluster) sums all the clusters' partials of those rows in
//   order into the output: one launch, no second kernel.
// * The grid is one wave: `plan` sizes it from the occupancy API
//   (blle_weight_grad_info: clusters the card holds at once).
//
// Sums run in a fixed order with no float atomics: reruns are bitwise
// equal. Up to four products share a launch.
#include <cuda.h>  // CUtensorMap and its enums (the encoder comes through the runtime)

#include <mutex>
#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kMaxProblems = 4;
constexpr int kTm = 128;             // output rows of a CTA: two warpgroups of 64
constexpr int kKs = 64;              // pixels a stage
constexpr int kStages = 4;           // ring slots
constexpr int kAhead = kStages - 2;  // stages in flight ahead of the product
constexpr int kWgThreads = 256;
constexpr int kMaxCluster = 8;
constexpr int kBox = 64 * kKs * 2;  // one TMA box: 64 channels x 64 pixels, bf16

template <int TN>
__host__ __device__ constexpr int stage_bytes() {
  return (kTm + TN) / 64 * kBox;
}
// The fp32 row stride of the epilogue tile (padded: no bank conflicts).
template <int TN>
__host__ __device__ constexpr int tile_ld() {
  return TN + 8;
}
template <int TN>
__host__ __device__ constexpr int ring_bytes() {
  return cmax(kStages * stage_bytes<TN>(), kTm * tile_ld<TN>() * 4);
}
// The ring (aligned to the swizzle's 1024-byte period inside the dynamic
// shared memory), its stage barriers and a flag.
template <int TN>
__host__ __device__ constexpr int wg_smem() {
  return 1024 + ring_bytes<TN>() + kStages * 8 + 16;
}

struct WgProblem {
  float* ws;       // the clusters' partials [G, S / cl, M, N] (unused if S == cl)
  float* out;      // [G, M, N]
  int* count;      // arrivals per (tile, rank), zero between launches (unused if S == cl)
  int G, K, M, N;  // M, N multiples of 8
  int S;           // K slices a tile (a multiple of cl, at most ceil(K / kKs))
  int first_cta;   // the problem's first CTA in the launch (a multiple of cl)
};
struct WgProblems {
  CUtensorMap a[kMaxProblems];  // A [G, K, M] as boxes of 64 channels x 64 pixels
  CUtensorMap b[kMaxProblems];  // B [G, K, N] likewise
  WgProblem p[kMaxProblems];
  int n, cl;  // products, CTAs a cluster
};

// The index of the problem of CTA `cta` (problems sorted by first_cta).
__device__ __forceinline__ int problem_of(const WgProblems& pr, int cta) {
  int i = 0;
#pragma unroll
  for (int j = 1; j < kMaxProblems; ++j)
    if (j < pr.n && cta >= pr.p[j].first_cta) i = j;
  return i;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
// Every thread of every CTA of the cluster arrives, then waits: shared-memory
// writes before it are visible to the whole cluster after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
// The address of the same shared-memory offset in CTA `rank` of the cluster.
__device__ __forceinline__ unsigned map_rank(unsigned addr, unsigned rank) {
  unsigned r;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ float4 ld_cluster_f4(unsigned addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}
__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x, a.y += b.y, a.z += b.z, a.w += b.w;
}

template <int TN>
__global__ void __launch_bounds__(kWgThreads, 1) weight_grad_kernel(
    const __grid_constant__ WgProblems pr) {
  unsigned char* raw = dyn_smem();
  unsigned char* const ring = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  uint64_t* const full = reinterpret_cast<uint64_t*>(ring + ring_bytes<TN>());
  int* const flag = reinterpret_cast<int*>(full + kStages);
  const int pi = problem_of(pr, blockIdx.x);
  const WgProblem P = pr.p[pi];
  const int tid = threadIdx.x, wg = tid / 128;
  const int mt = (P.M + kTm - 1) / kTm, nt = (P.N + TN - 1) / TN;
  int cta = blockIdx.x - P.first_cta;
  const int s = cta % P.S;
  cta /= P.S;
  const int tile = cta, ni = cta % nt;
  cta /= nt;
  const int mi = cta % mt, g = cta / mt;
  // Slice s of S covers stages [st s / S, st (s + 1) / S) of st; rows past K
  // come in as zeros (the tensor maps end there).
  const int st = (P.K + kKs - 1) / kKs;
  const int s0 = (int)((long long)st * s / P.S), s1 = (int)((long long)st * (s + 1) / P.S);
  const int steps = s1 - s0, m0 = mi * kTm, n0 = ni * TN;
  // The boxes of the tile that hold data: columns at or past M or N are not
  // loaded (they only reach output rows or columns that are never stored).
  const int na = min(kTm / 64, (P.M - m0 + 63) / 64), nb = min(TN / 64, (P.N - n0 + 63) / 64);
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) mbar_init(&full[i], 1);
    fence_mbar_init();
  }
  __syncthreads();
  // Stage i into its slot: A's boxes, then B's, one barrier for all.
  auto load = [&](int i) {
    unsigned char* dst = ring + (i % kStages) * stage_bytes<TN>();
    uint64_t* bar = &full[i % kStages];
    const int k = (s0 + i) * kKs;
    mbar_expect_tx(bar, (na + nb) * kBox);
    for (int j = 0; j < na; ++j) tma_load_3d(dst + j * kBox, &pr.a[pi], m0 + 64 * j, k, g, bar);
    for (int j = 0; j < nb; ++j)
      tma_load_3d(dst + (kTm / 64 + j) * kBox, &pr.b[pi], n0 + 64 * j, k, g, bar);
  };

  float d[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) d[i] = 0.0f;
  if (tid == 0)
    for (int i = 0; i < kAhead && i < steps; ++i) load(i);
  for (int it = 0; it < steps; ++it) {
    mbar_wait(&full[it % kStages], (it / kStages) & 1);
    __syncthreads();  // every product up to stage it - 2 is done: its slot may be refilled
    if (tid == 0 && it + kAhead < steps) load(it + kAhead);
    const unsigned char* sa = ring + (it % kStages) * stage_bytes<TN>() + wg * kBox;
    const unsigned char* sb = ring + (it % kStages) * stage_bytes<TN>() + kTm / 64 * kBox;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kKs / 16; ++j)  // k16 step j: two 8-row atoms along K
      wgmma_m64nk16<TN>(d, wgmma_desc_sw128(sa + j * 2048, kBox, 1024),
                        wgmma_desc_sw128(sb + j * 2048, kBox, 1024), 1);
    wgmma_commit();
    wgmma_wait<1>(d);
  }
  wgmma_wait<0>(d);
  __syncthreads();

  // The CTA's fp32 tile into shared memory (the ring is free): d[4j..4j+3]
  // = D[r][c], D[r][c+1], D[r+8][c], D[r+8][c+1] (wgmma.cuh).
  float* tilebuf = reinterpret_cast<float*>(ring);
  constexpr int LD = tile_ld<TN>();
  {
    const int w = (tid % 128) / 32, l = tid % 32, r = 64 * wg + 16 * w + l / 4;
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const int c = 8 * j + 2 * (l % 4);
      *reinterpret_cast<float2*>(tilebuf + r * LD + c) = make_float2(d[4 * j], d[4 * j + 1]);
      *reinterpret_cast<float2*>(tilebuf + (r + 8) * LD + c) =
          make_float2(d[4 * j + 2], d[4 * j + 3]);
    }
  }
  cluster_sync();

  // Rank r of the cluster sums rows [r kTm / cl, (r + 1) kTm / cl) of the
  // cluster's tiles, ranks in order, and stores them: into out where the
  // cluster covers all of K, else into its partial.
  const int cl = pr.cl, rows = kTm / cl, SC = P.S / cl, r0 = (int)cluster_rank() * rows;
  const size_t mn = (size_t)P.M * P.N;
  float* dst = SC == 1 ? P.out + g * mn : P.ws + ((size_t)g * SC + s / cl) * mn;
  const unsigned base = smem_u32(tilebuf);
  // Two outputs a thread at a time, all their loads in flight together.
  for (int e0 = tid; e0 < rows * (TN / 4); e0 += 2 * kWgThreads) {
    float4 v[2][kMaxCluster];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = e0 + h * kWgThreads, r = r0 + e / (TN / 4), c = 4 * (e % (TN / 4));
      const unsigned off = base + (unsigned)(r * LD + c) * 4;
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        if (q < cl && e < rows * (TN / 4)) v[h][q] = ld_cluster_f4(map_rank(off, q));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = e0 + h * kWgThreads, r = r0 + e / (TN / 4), c = 4 * (e % (TN / 4));
      if (e >= rows * (TN / 4) || m0 + r >= P.M || n0 + c >= P.N) continue;
#pragma unroll
      for (int q = 1; q < kMaxCluster; ++q)
        if (q < cl) add4(v[h][0], v[h][q]);
      *reinterpret_cast<float4*>(dst + (size_t)(m0 + r) * P.N + n0 + c) = v[h][0];
    }
  }
  cluster_sync();  // no CTA leaves while the others read its tile
  if (SC == 1) return;

  // The last of the tile's clusters to store these rows sums them over all
  // the clusters' partials, in order, into out (the counter only picks who).
  __threadfence();
  __syncthreads();
  int* const cnt = P.count + tile * cl + r0 / rows;
  if (tid == 0) *flag = atomicAdd(cnt, 1) == SC - 1;
  __syncthreads();
  if (!*flag) return;
  if (tid == 0) *cnt = 0;  // ready for the next launch
  const float* src = P.ws + (size_t)g * SC * mn;
  for (int e = tid; e < rows * (TN / 4); e += kWgThreads) {
    const int r = r0 + e / (TN / 4), c = 4 * (e % (TN / 4));
    if (m0 + r >= P.M || n0 + c >= P.N) continue;
    const float* o = src + (size_t)(m0 + r) * P.N + n0 + c;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sc0 = 0; sc0 < SC; sc0 += 8) {  // 8 partials' loads in flight at a time
      float4 v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (sc0 + j < SC) v[j] = __ldcg(reinterpret_cast<const float4*>(o + (sc0 + j) * mn));
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (sc0 + j < SC) add4(acc, v[j]);
    }
    *reinterpret_cast<float4*>(P.out + g * mn + (o - src)) = acc;
  }
}

// The launch of 128 x TN tiles: `blocks` CTAs in clusters of cl.
template <int TN>
struct Launch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  Launch(int blocks, int cl, cudaStream_t s) {
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(kWgThreads);
    cfg.dynamicSmemBytes = wg_smem<TN>();
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cl;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  // The shared-memory opt-in, once per device.
  static cudaError_t allow() {
    static bool done[64] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess || (dev < 64 && done[dev])) return e;
    e = cudaFuncSetAttribute(weight_grad_kernel<TN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             wg_smem<TN>());
    if (e == cudaSuccess && dev < 64) done[dev] = true;
    return e;
  }
  cudaError_t run(const WgProblems& pr) {
    cudaError_t e = allow();
    if (e == cudaSuccess) e = cudaLaunchKernelEx(&cfg, weight_grad_kernel<TN>, pr);
    return e != cudaSuccess ? e : cudaGetLastError();
  }
  // Clusters of cl CTAs the card holds at once (the occupancy API).
  cudaError_t clusters(int* n) {
    cudaError_t e = allow();
    return e != cudaSuccess ? e : cudaOccupancyMaxActiveClusters(n, weight_grad_kernel<TN>, &cfg);
  }
};

// f(std::integral_constant<int, tn>) for tn in 64, 128, 192, 256.
template <typename F>
cudaError_t with_tn(int tn, F&& f) {
  switch (tn) {
    case 64: return f(std::integral_constant<int, 64>());
    case 128: return f(std::integral_constant<int, 128>());
    case 192: return f(std::integral_constant<int, 192>());
    case 256: return f(std::integral_constant<int, 256>());
    default: return cudaErrorInvalidValue;
  }
}

bool valid_cl(int cl) { return cl == 1 || cl == 2 || cl == 4 || cl == 8; }

// X [G, K, W] bf16 as a 3-D tensor map of 64 x 64 boxes (channels fastest),
// 128-byte swizzle, zeros outside the tensor. The last few maps are kept:
// a training step hands the pass the same buffers again.
bool encode(CUtensorMap* map, const void* x, int G, int K, int W) {
  struct Entry {
    const void* x;
    int G, K, W;
    CUtensorMap map;
  };
  static std::mutex mu;
  static Entry cache[16] = {};
  static int next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache)
    if (e.x == x && e.G == G && e.K == K && e.W == W) {
      *map = e.map;
      return true;
    }
  TmaEncodeTiled fn = tma_encoder();
  if (!fn || x == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)K, (cuuint64_t)G};
  const cuuint64_t strides[2] = {(cuuint64_t)W * 2, (cuuint64_t)K * W * 2};
  const cuuint32_t box[3] = {64, kKs, 1}, unit[3] = {1, 1, 1};
  if (fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims, strides, box, unit,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  cache[next] = {x, G, K, W, *map};
  next = (next + 1) % 16;
  return true;
}

}  // namespace

// n products described by table[11 * i ...] = a, b, ws, out, count, G, K, M,
// N, S, first_cta (kernels/weight_grad.py `plan`), output tiles of 128 x tn,
// clusters of cl CTAs; problems in order of first_cta, the launch's CTAs the
// last one's first_cta plus its G * ceil(M/128) * ceil(N/tn) * S. Where S >
// cl, `count` holds G * ceil(M/128) * ceil(N/tn) * cl zeros, and the launch
// leaves them zero.
extern "C" int blle_weight_grad(const long long* table, int n, int tn, int cl, void* stream) {
  if (n < 1 || n > kMaxProblems || !valid_cl(cl)) return (int)cudaErrorInvalidValue;
  WgProblems pr{};
  pr.n = n;
  pr.cl = cl;
  long long blocks = 0;
  for (int i = 0; i < n; ++i) {
    const long long* t = table + 11 * i;
    WgProblem& P = pr.p[i];
    P.ws = (float*)t[2];
    P.out = (float*)t[3];
    P.count = (int*)t[4];
    P.G = (int)t[5], P.K = (int)t[6], P.M = (int)t[7], P.N = (int)t[8];
    P.S = (int)t[9], P.first_cta = (int)t[10];
    if (P.G < 1 || P.K < 1 || P.M % 8 || P.N % 8 || P.M < 8 || P.N < 8 || P.S < 1 ||
        P.S % cl || P.S > cdiv(P.K, kKs) || P.first_cta != blocks ||
        (P.S > cl && (P.ws == nullptr || P.count == nullptr)) ||
        !encode(&pr.a[i], (const void*)t[0], P.G, P.K, P.M) ||
        !encode(&pr.b[i], (const void*)t[1], P.G, P.K, P.N))
      return (int)cudaErrorInvalidValue;
    blocks += (long long)P.G * cdiv(P.M, kTm) * cdiv(P.N, tn) * P.S;
  }
  if (blocks < 1 || blocks > (1LL << 31) - 1) return (int)cudaErrorInvalidValue;
  for (int i = n; i < kMaxProblems; ++i) pr.p[i] = pr.p[n - 1];
  return (int)with_tn(tn, [&](auto t) {
    return Launch<decltype(t)::value>((int)blocks, cl, (cudaStream_t)stream).run(pr);
  });
}

// info = {dynamic shared memory bytes, threads a CTA, ring stages, clusters
// of cl CTAs the card holds at once} for output tiles of 128 x tn.
extern "C" int blle_weight_grad_info(int tn, int cl, long long* info) {
  if (!valid_cl(cl)) return (int)cudaErrorInvalidValue;
  return (int)with_tn(tn, [&](auto t) {
    Launch<decltype(t)::value> query(cl, cl, nullptr);
    int clusters = 0;
    const cudaError_t e = query.clusters(&clusters);
    info[0] = query.cfg.dynamicSmemBytes;
    info[1] = kWgThreads;
    info[2] = kStages;
    info[3] = clusters;
    return e;
  });
}

// Floats of the clusters' partials for n products (G, K, M, N, S per
// product in shapes[5 i ...]) in clusters of cl CTAs: what `plan` allocates.
extern "C" long long blle_weight_grad_workspace_floats(const long long* shapes, int n, int cl) {
  long long floats = 0;
  for (int i = 0; i < n; ++i) {
    const long long* t = shapes + 5 * i;
    if (t[4] > cl) floats += t[0] * (t[4] / cl) * t[2] * t[3];
  }
  return floats;
}
