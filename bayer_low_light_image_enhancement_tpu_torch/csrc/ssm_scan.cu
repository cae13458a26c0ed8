// S1 / S2: the selective scan (Mamba SSM) forward and backward.
//
// Replaces the TPU kernels of bayer_low_light_image_enhancement_tpu/kernels/
// ssm_scan.py: S1 replaces `_ssm_kernel` (inference, `selective_scan_pallas`)
// and `_ssm_fwd_states_kernel` (training forward, `_fwd_with_states`), which
// the template flag kStates tells apart; S2 replaces `_ssm_bwd_kernel`
// (`_bwd_pallas`). Per batch b, channel d and state n:
//
//   a_t = exp(dt_t[d] A[d,n]),   h_t = a_t h_{t-1} + dt_t[d] u_t[d] B_t[n]
//   y_t[d] = sum_n C_t[n] h_t[n] + D[d] u_t[d]
//
// and the adjoint, a reverse scan  lam_t = C_t dy_t + a_{t+1} lam_{t+1}.
// u, dt, B, C (and dy) are bf16 or fp32; every recurrence runs in fp32.
//
// Bound: operations. Each (b, t, d, n) costs one exp (the SFU, 16 per SM
// per clock) and a handful of fp32 FMAs, against 2-4 bytes of input per
// (b, t, d): at the WFB shapes (N = 32) the exps alone take ~3x longer than
// moving the bytes. What the TPU kernel kept out of HBM, the [L, D, N]
// expansion, never leaves registers here.
//
// S1's design: a block stages each 32-step sub-chunk of its channel tile's
// inputs in shared memory (cp.async, double-buffered) and walks each
// channel's states from there, the exps of 8 steps ahead of the chain
// h = a h + x and y summed over the states by a transpose-reduce; see the
// note above fwd_chunk. The TPU carried the state across a sequential grid
// of L-chunks; here the plan (kernels/ssm_scan.fwd_plan) cuts L into nc
// chunks only when the (b, d) walks alone leave the card short of warps:
//   nc = 1: one launch, one serial walk per (b, d), one exp per element;
//   nc > 1: ssm_fwd_end_kernel walks chunk 0 from zero (its y and states
//     are final) and chunks 1..nc-2 for their zero-start end states and
//     sums of dt; ssm_fwd_scan_kernel composes each chunk c >= 1's entry
//     state from those (the chunk-carry algebra of ops/ssm.py, c terms)
//     and rescans it: 2 (nc - 1) / nc exps per element, two launches.
// nc = 2 halves no serial walk (chunk 1 waits for chunk 0), so the plan
// never takes it.
// S2 cuts L into 128-step chunks that run in parallel, in reverse:
//   1. ssm_bwd_chunk_kernel: each chunk's zero-start a_first * lam_first;
//   2. ssm_compose_rev_kernel: the carry mu entering each chunk from the
//      right, mu(c-1) = z(c) + exp(A sum dt(c)) mu(c);
//   3. ssm_bwd_kernel: per chunk, sub-chunk by sub-chunk from the last,
//      recompute h from the saved entry state, then walk lam backwards and
//      emit du, ddt per element; see the design note above it.
// dB and dC sum over d, dA and dD over b and t: fixed-order sums of
// per-block partials, no atomics, so reruns are bitwise equal.
// Ragged L and D are masked in the kernels: both stage ragged steps as
// dt = 0, u = B = C = dy = 0, which carry the state and lam through
// unchanged and add nothing, and store no output outside [L] x [D].
#include "common.cuh"

namespace {

constexpr int kSub = 32;  // steps per saved state = staged sub-chunk = backward sub-chunk
constexpr int kRed = 8;   // steps per transpose-reduce
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return f2bf(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 2^x on the SFU (one MUFU.EX2; what __expf issues after its multiply by
// log2 e, which S1 folds into A once).
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// One halving level of transpose_sum: lanes with bit X set keep v[O..2O),
// the others v[0..O), each adding its partner's copy (O shuffles).
template <int O, int X>
__device__ __forceinline__ void halve(float (&v)[kRed], int lane) {
  const bool up = lane & X;
#pragma unroll
  for (int k = 0; k < O; ++k) {
    const float keep = up ? v[k + O] : v[k], send = up ? v[k] : v[k + O];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, X);
  }
}

// v[k] for kRed steps k in each lane -> the sum over each aligned group of
// G lanes of v[k] for k = (lane % G) / (G / kRed), in every lane: halving
// exchanges at xor G/2, G/4, G/8, then full ones below (for G = 32: 9
// shuffles for 8 steps, where a butterfly per step takes 5; a fixed
// order). Every index is a constant, so v stays in registers.
static_assert(kRed == 8, "transpose_sum is written out for 8 steps");
template <int G = 32>
__device__ __forceinline__ float transpose_sum(float (&v)[kRed], int lane) {
  static_assert(G == 8 || G == 32, "groups of 8 or 32 lanes");
  halve<4, G / 2>(v, lane);
  halve<2, G / 4>(v, lane);
  halve<1, G / 8>(v, lane);
#pragma unroll
  for (int x = G / 16; x >= 1; x >>= 1) v[0] += __shfl_xor_sync(0xffffffffu, v[0], x);
  return v[0];
}

// ---- S1: the forward ------------------------------------------------------
// Layout: a (b, d) walk is kLanes = 8 lanes holding kSpl = 4 states each
// (states >= N carry zeros), so a warp walks 4 channels and a block of
// kFwdWarps warps a tile of DT = 32 channels. Against one lane per state
// (PERF.md §6): a quarter of the warps per walk, but a quarter of the
// shared-memory traffic per element and fewer instructions (the B, C loads
// and the reduce shared by 4 states), so the plan's chunks supply the
// warps. Per kSub-step sub-chunk:
//   1. the block stages the u, dt tile [kSub][DT] and the B, C rows
//      [kSub][32] in their own type with 16-byte cp.async (plain loads
//      where N < 32 or a shape or pointer is not 16-byte aligned; ragged
//      steps and states >= N as zeros, which carry h through unchanged),
//      kFwdRaw sub-chunks in flight: two ahead of the walk;
//   2. one pass converts sub-chunk i + 1 to fp32 {dt, dt u} and u per
//      channel, [DT][kSub] (two steps a 16-byte load), and to {B, C} pairs
//      [kSub][32] (bf16 inputs: both halves of one word, which halves the
//      walk's shared-memory traffic, what limits it) while the warps walk
//      sub-chunk i: one barrier a sub-chunk;
//   3. each channel walks 8 steps at a time: the 8 x 4 exps first, then
//      the chain h = a h + (dt u) B (the only serial dependency), y's terms
//      C h summed over its 8 lanes by a transpose-reduce into a shared
//      [kSub][DT] tile, which leaves as coalesced rows.
constexpr int kFwdWarps = 8;
constexpr int kFwdThreads = kFwdWarps * 32;
constexpr int kSpl = 4;              // states a lane
constexpr int kLanes = 32 / kSpl;    // lanes a channel
constexpr int DT = kFwdWarps * kSpl;  // channels a block (the tile)
constexpr int kFwdRaw = 3;           // staged sub-chunks in flight
constexpr int kXfLd = kSub + 2;      // float2 row of xf: 16 bytes of pad, conflict-free channels
constexpr int kUfLd = kSub + 1;      // float row of uf
// Blocks per SM the register budget is set for: 2 (128 registers) spills
// nothing; 3 spilled 12-76 bytes for a few percent.
constexpr int kFwdMinBlocks = 2;

// {B, C} of one (step, state) as the walk reads it: bf16 inputs keep their
// two bf16 in one word (B low); fp32 inputs two floats.
template <typename T>
struct BcPair;
template <>
struct BcPair<bf16> {
  typedef unsigned type;
};
template <>
struct BcPair<float> {
  typedef float2 type;
};

template <typename T>
struct FwdSmem {  // byte offsets: kFwdRaw raw buffers, then two of each converted one
  static constexpr int raw_ud = 2 * kSub * DT * (int)sizeof(T);        // u, dt
  static constexpr int raw = raw_ud + 2 * kSub * 32 * (int)sizeof(T);  // + B, C
  static constexpr int xf_size = DT * kXfLd * 8;                       // float2 {dt, dt u}
  static constexpr int uf_size = (DT * kUfLd * 4 + 15) / 16 * 16;      // float u
  static constexpr int bc_size = kSub * 32 * (int)sizeof(typename BcPair<T>::type);
  static constexpr int ys_size = kSub * DT * (int)sizeof(T);  // T [kSub][DT]
  static constexpr int xf = kFwdRaw * raw;
  static constexpr int uf = xf + 2 * xf_size;
  static constexpr int bc = uf + 2 * uf_size;
  static constexpr int ys = bc + 2 * bc_size;
  static constexpr int total = ys + 2 * ys_size;
};

template <typename T>
struct FwdArgs {
  const T *u, *dt, *Bm, *Cm;
  const float *A, *Dskip;
  T* y;
  float *states, *hend, *sdt;  // hend [B][nc-1][D][N], sdt [B][nc-1][D]
  int L, D, N, chunk, nc;
  int vec_ud, vec_bc;  // 16-byte copies of the u, dt (and y) tiles / the B, C rows
};

// Stage sub-chunk rows [ts, ts + nt) of block tile d0 into raw buffer `raw`:
// the u, dt tile [kSub][DT] and the B, C rows [kSub][32] (states >= N as
// zeros). Every loop has a trip count known at compile time.
template <typename T>
__device__ __forceinline__ void fwd_stage(const FwdArgs<T>& a, unsigned char* raw, int b,
                                          int d0, int ts, int nt) {
  constexpr int U = 16 / (int)sizeof(T);  // elements per 16 bytes
  T* su = reinterpret_cast<T*>(raw);
  T* sdt = su + kSub * DT;
  T* sB = reinterpret_cast<T*>(raw + FwdSmem<T>::raw_ud);
  T* sC = sB + kSub * 32;
  const int tid = threadIdx.x, D = a.D, N = a.N;
  const size_t row0 = (size_t)b * a.L + ts;
  const T zero = from_f<T>(0.f);
  if (a.vec_ud) {
    constexpr int R = DT / U, UD = 2 * kSub * R;  // 16-byte units a row, of both tiles
    static_assert(UD % kFwdThreads == 0, "whole rounds of u, dt units");
#pragma unroll
    for (int e0 = 0; e0 < UD; e0 += kFwdThreads) {
      const int e = e0 + tid, which = e / (kSub * R), k = e % (kSub * R), j = k / R, part = k % R;
      const T* src = which ? a.dt : a.u;
      const bool ok = j < nt;
      cp_async16((which ? sdt : su) + j * DT + part * U,
                 ok ? src + (row0 + j) * D + d0 + part * U : src, ok);
    }
  } else {
#pragma unroll
    for (int e0 = 0; e0 < kSub * DT; e0 += kFwdThreads) {
      const int e = e0 + tid, j = e / DT, dl = e % DT;
      const bool ok = j < nt && d0 + dl < D;
      const size_t i = (row0 + j) * D + d0 + dl;
      su[e] = ok ? a.u[i] : zero;
      sdt[e] = ok ? a.dt[i] : zero;
    }
  }
  if (a.vec_bc) {  // N = 32: the sub-chunk's rows are one run
    constexpr int UB = kSub * 32 / U;
    static_assert(2 * UB % kFwdThreads == 0, "whole rounds of B, C units");
#pragma unroll
    for (int e0 = 0; e0 < 2 * UB; e0 += kFwdThreads) {
      const int e = e0 + tid, which = e / UB, k = e % UB;
      const T* src = which ? a.Cm : a.Bm;
      const bool ok = k * U / 32 < nt;
      cp_async16((which ? sC : sB) + k * U, ok ? src + row0 * 32 + k * U : src, ok);
    }
  } else {
#pragma unroll
    for (int e0 = 0; e0 < kSub * 32; e0 += kFwdThreads) {
      const int e = e0 + tid, j = e / 32, n = e % 32;
      const bool ok = j < nt && n < N;
      const size_t r = (row0 + j) * N + n;
      sB[e] = ok ? a.Bm[r] : zero;
      sC[e] = ok ? a.Cm[r] : zero;
    }
  }
  cp_async_commit();
}

// Raw buffer -> converted buffer `buf`: xf {dt, dt u} and uf u, [DT][kSub]
// each (a channel's steps contiguous), and bc {B, C} [kSub][32].
template <typename T>
__device__ __forceinline__ void fwd_convert(const unsigned char* raw, unsigned char* sm,
                                            int buf) {
  using S = FwdSmem<T>;
  const T* su = reinterpret_cast<const T*>(raw);
  const T* sdt = su + kSub * DT;
  const T* sB = reinterpret_cast<const T*>(raw + S::raw_ud);
  const T* sC = sB + kSub * 32;
  float2* xf = reinterpret_cast<float2*>(sm + S::xf + buf * S::xf_size);
  float* uf = reinterpret_cast<float*>(sm + S::uf + buf * S::uf_size);
#pragma unroll
  for (int e0 = 0; e0 < kSub * DT; e0 += kFwdThreads) {
    const int e = e0 + threadIdx.x, dl = e / kSub, j = e % kSub;
    const float dv = to_f(sdt[j * DT + dl]), uv = to_f(su[j * DT + dl]);
    xf[dl * kXfLd + j] = make_float2(dv, dv * uv);
    uf[dl * kUfLd + j] = uv;
  }
  static_assert(kSub * 32 == 4 * kFwdThreads, "four B, C values a thread");
  const int e = 4 * threadIdx.x;
  unsigned char* bc = sm + S::bc + buf * S::bc_size;
  if constexpr (sizeof(T) == 2) {
    const uint2 b4 = *reinterpret_cast<const uint2*>(sB + e);
    const uint2 c4 = *reinterpret_cast<const uint2*>(sC + e);
    *reinterpret_cast<uint4*>(bc + e * 4) =
        make_uint4(__byte_perm(b4.x, c4.x, 0x5410), __byte_perm(b4.x, c4.x, 0x7632),
                   __byte_perm(b4.y, c4.y, 0x5410), __byte_perm(b4.y, c4.y, 0x7632));
  } else {
    const float4 b4 = *reinterpret_cast<const float4*>(sB + e);
    const float4 c4 = *reinterpret_cast<const float4*>(sC + e);
    float4* o = reinterpret_cast<float4*>(bc + e * 8);
    o[0] = make_float4(b4.x, c4.x, b4.y, c4.y);
    o[1] = make_float4(b4.z, c4.z, b4.w, c4.w);
  }
}

// A lane's kSpl states' {B, C} from bc row r, as fp32.
__device__ __forceinline__ void load_bc(const unsigned* r, float (&bv)[kSpl],
                                        float (&cv)[kSpl]) {
  const uint4 v = *reinterpret_cast<const uint4*>(r);
  const unsigned w[kSpl] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int s = 0; s < kSpl; ++s) {
    bv[s] = __uint_as_float(w[s] << 16);
    cv[s] = __uint_as_float(w[s] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load_bc(const float2* r, float (&bv)[kSpl], float (&cv)[kSpl]) {
#pragma unroll
  for (int s = 0; s < kSpl; s += 2) {
    const float4 v = *reinterpret_cast<const float4*>(r + s);
    bv[s] = v.x, cv[s] = v.y, bv[s + 1] = v.z, cv[s + 1] = v.w;
  }
}

// Store y rows [ts, ts + nt) of the tile from ys.
template <typename T>
__device__ __forceinline__ void fwd_store_y(const FwdArgs<T>& a, const T* ys, int b, int d0,
                                            int ts, int nt) {
  constexpr int U = 16 / (int)sizeof(T);
  const size_t row0 = (size_t)b * a.L + ts;
  if (a.vec_ud) {
    constexpr int R = DT / U;
    for (int e = threadIdx.x; e < nt * R; e += kFwdThreads) {
      const int j = e / R, part = e % R;
      *reinterpret_cast<uint4*>(a.y + (row0 + j) * a.D + d0 + part * U) =
          *reinterpret_cast<const uint4*>(ys + j * DT + part * U);
    }
  } else {
    for (int e = threadIdx.x; e < nt * DT; e += kFwdThreads) {
      const int j = e / DT, dl = e % DT;
      if (d0 + dl < a.D) a.y[(row0 + j) * a.D + d0 + dl] = ys[e];
    }
  }
}

// One sub-chunk of channel dl's walk from h (lane sg of its 8 holds states
// sg * kSpl + s), from converted buffer `buf`. kY: y's terms into ys; kSum:
// sum dt into `sum`.
template <typename T, bool kY, bool kSum>
__device__ __forceinline__ void fwd_walk(const unsigned char* sm, int buf, T* ys, int dl, int sg,
                                         int lane, const float (&a2)[kSpl], float (&h)[kSpl],
                                         float dsk, float& sum) {
  using S = FwdSmem<T>;
  using P = typename BcPair<T>::type;
  static_assert(kLanes == kRed, "one step of the 8 a lane after the transpose-reduce");
  const float4* xf =
      reinterpret_cast<const float4*>(sm + S::xf + buf * S::xf_size) + dl * (kXfLd / 2);
  const float* uf = reinterpret_cast<const float*>(sm + S::uf + buf * S::uf_size) + dl * kUfLd;
  const P* bc = reinterpret_cast<const P*>(sm + S::bc + buf * S::bc_size) + sg * kSpl;
#pragma unroll
  for (int q = 0; q < kSub / kRed; ++q) {
    float dtu[kRed], e[kRed][kSpl], yv[kRed];
#pragma unroll
    for (int k = 0; k < kRed; k += 2) {  // the exps, ahead of the chain
      const float4 x = xf[(q * kRed + k) / 2];  // {dt, dt u} of steps k, k + 1
      dtu[k] = x.y, dtu[k + 1] = x.w;
      if (kSum) sum += x.x + x.z;
#pragma unroll
      for (int s = 0; s < kSpl; ++s) {
        e[k][s] = ex2(x.x * a2[s]);
        e[k + 1][s] = ex2(x.z * a2[s]);
      }
    }
#pragma unroll
    for (int k = 0; k < kRed; ++k) {
      float bv[kSpl], cv[kSpl];
      load_bc(bc + (q * kRed + k) * 32, bv, cv);
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < kSpl; ++s) {
        h[s] = fmaf(e[k][s], h[s], dtu[k] * bv[s]);
        acc = fmaf(cv[s], h[s], acc);
      }
      yv[k] = acc;
    }
    if (kY) {
      const int j = q * kRed + sg;
      ys[j * DT + dl] = from_f<T>(transpose_sum<kLanes>(yv, lane) + dsk * uf[j]);
    }
  }
}

// Chunk c of block (tile blockIdx.y, batch blockIdx.z). kY: write y (and
// with kStates the state entering every sub-chunk); kEnd: write the chunk's
// end state to hend (and, without kY, its sum of dt to sdt). Without kEnd
// the entry state is composed from the end states of chunks 0..c-1:
//   h_in(c) = end(c-1) + exp(A sdt(c-1)) (end(c-2) + ...), end(0) exact.
template <typename T, bool kStates, bool kY, bool kEnd>
__device__ __forceinline__ void fwd_chunk(const FwdArgs<T>& a, int c) {
  using S = FwdSmem<T>;
  unsigned char* sm = dyn_smem();
  const int lane = threadIdx.x % 32, sg = lane % kLanes;
  const int dl = threadIdx.x / 32 * kSpl + lane / kLanes, b = blockIdx.z, d0 = blockIdx.y * DT;
  const int d = d0 + dl, D = a.D, N = a.N, ncm = a.nc - 1;
  const bool live = d < D;
  float a2[kSpl], h[kSpl];
#pragma unroll
  for (int s = 0; s < kSpl; ++s) {
    const int n = sg * kSpl + s;
    a2[s] = live && n < N ? a.A[d * N + n] * kLog2e : 0.f;
    h[s] = 0.f;
  }
  if (!kEnd && live) {
    for (int cc = 0; cc < c; ++cc) {
      const size_t o = ((size_t)b * ncm + cc) * D + d;
      const float sd = cc > 0 ? a.sdt[o] : 0.f;
#pragma unroll
      for (int s = 0; s < kSpl; ++s) {
        const int n = sg * kSpl + s;
        const float he = n < N ? a.hend[o * N + n] : 0.f;
        h[s] = cc > 0 ? fmaf(ex2(sd * a2[s]), h[s], he) : he;
      }
    }
  }
  const float dsk = live ? a.Dskip[d] : 0.f;
  const int t0 = c * a.chunk, t1 = min(a.L, t0 + a.chunk);
  const int s0 = t0 / kSub, nsc = (t1 + kSub - 1) / kSub - s0, nsub = (a.L + kSub - 1) / kSub;
  // Sub-chunk i of the chunk: its raw buffer i % kFwdRaw, its converted
  // buffers and y tile i % 2. One commit group per sub-chunk (empty past
  // the last), so cp_async_wait<1> always leaves exactly the newest one in
  // flight.
  auto stage = [&](int i) {
    const int ts = (s0 + i) * kSub;
    if (i < nsc)
      fwd_stage<T>(a, sm + i % kFwdRaw * S::raw, b, d0, ts, min(kSub, t1 - ts));
    else
      cp_async_commit();
  };
  auto convert = [&](int i) { fwd_convert<T>(sm + i % kFwdRaw * S::raw, sm, i % 2); };
  auto ys = [&](int i) { return reinterpret_cast<T*>(sm + S::ys + i % 2 * S::ys_size); };
  stage(0);
  stage(1);
  cp_async_wait<1>();
  __syncthreads();
  convert(0);
  stage(2);
  float sum = 0.f;
  for (int i = 0; i < nsc; ++i) {
    cp_async_wait<1>();
    // Sub-chunk i is converted and i + 1 has landed; every walk of i - 1
    // is done, so its y tile is whole and its converted buffers are free.
    __syncthreads();
    if (kY && i > 0) fwd_store_y<T>(a, ys(i - 1), b, d0, (s0 + i - 1) * kSub, kSub);
    if (i + 1 < nsc) convert(i + 1);
    stage(i + 3);  // into the raw buffer convert(i) emptied
    if (kStates && kY && live) {
#pragma unroll
      for (int q = 0; q < kSpl; ++q) {
        const int n = sg * kSpl + q;
        if (n < N) a.states[(((size_t)b * nsub + s0 + i) * D + d) * N + n] = h[q];
      }
    }
    fwd_walk<T, kY, kEnd && !kY>(sm, i % 2, ys(i), dl, sg, lane, a2, h, dsk, sum);
  }
  __syncthreads();
  if (kY) {
    const int ts = (s0 + nsc - 1) * kSub;
    fwd_store_y<T>(a, ys(nsc - 1), b, d0, ts, t1 - ts);
  }
  if (kEnd && live) {
    const size_t o = ((size_t)b * ncm + c) * D + d;
#pragma unroll
    for (int q = 0; q < kSpl; ++q) {
      const int n = sg * kSpl + q;
      if (n < N) a.hend[o * N + n] = h[q];
    }
    if (!kY && sg == 0) a.sdt[o] = sum;
  }
}

// Pass 1 (nc > 1), grid (nc - 1, tiles, B): chunk 0 walks from zero, its
// exact y (and states) and end state; chunks 1..nc-2 only their zero-start
// end states and sums of dt.
template <typename T, bool kStates>
__global__ void __launch_bounds__(kFwdThreads, kFwdMinBlocks)
    ssm_fwd_end_kernel(const FwdArgs<T> a) {
  if (blockIdx.x == 0)
    fwd_chunk<T, kStates, true, true>(a, 0);
  else
    fwd_chunk<T, false, false, true>(a, blockIdx.x);
}

// Pass 2, grid (max(1, nc - 1), tiles, B): chunk blockIdx.x + (nc > 1) from
// its composed entry state (zero for the only chunk): y, and states.
template <typename T, bool kStates>
__global__ void __launch_bounds__(kFwdThreads, kFwdMinBlocks)
    ssm_fwd_scan_kernel(const FwdArgs<T> a) {
  fwd_chunk<T, kStates, true, false>(a, blockIdx.x + (a.nc > 1 ? 1 : 0));
}

// The backward's blocks (passes 1 and 3).
constexpr int kBwdWarps = 4;
constexpr int kBwdThreads = kBwdWarps * 32;
// Blocks per SM the register budget is set for: at 3 (168 registers) ptxas
// spills the walk's rows whatever the layout; at 2 nothing spills.
constexpr int kBwdMinBlocks = 2;

// f(j, dl) for the elements k = tid, tid + kBwdThreads, ... of a [rows][dn]
// tile, k = j * dn + dl, stepped without a division per element.
template <typename F>
__device__ __forceinline__ void for_tile(int rows, int dn, F f) {
  const int q = kBwdThreads / dn, r = kBwdThreads % dn;
  int j = threadIdx.x / dn, dl = threadIdx.x % dn;
  while (j < rows) {
    f(j, dl);
    j += q;
    dl += r;
    if (dl >= dn) {
      dl -= dn;
      ++j;
    }
  }
}

// Shared-memory layout of ssm_bwd_kernel, in floats. in4: per step and
// channel {dt, u, dy, -} (after a channel's walk {du, ddt, -, -}); bc: per
// step and state {B, C}; the dB reduce buffer [kBwdWarps][kSub][32] over
// both once they are consumed; each warp's h rows and dC rows [kSub][32];
// per channel the lam carry, the dA and the dD sums.
struct BwdSmem {
  int ld, in4, bc, hist, accC, carry, dA, dD, total;
  __host__ __device__ explicit BwdSmem(int dgroup) {
    ld = dgroup + 1;  // odd float4 row stride: conflict-free per-lane rows
    in4 = 0;
    bc = in4 + 4 * kSub * ld;
    const int in_end = bc + 2 * kSub * 32, red_end = kBwdWarps * kSub * 32;
    hist = in_end > red_end ? in_end : red_end;
    accC = hist + kBwdWarps * kSub * 32;
    carry = accC + kBwdWarps * kSub * 32;
    dA = carry + dgroup * 32;
    dD = dA + dgroup * 32;
    total = dD + dgroup;
  }
};

// Backward pass 1: chunk blockIdx.x's zero-start carry a_first * lam_first
// (z) and its sum of dt, for the d-group blockIdx.y of ssm_bwd_kernel's
// plan. Block kBwdWarps warps, warp w the channels w, w + kBwdWarps, ... of
// the group. Per kSub-step sub-chunk from the chunk's last, the block stages
// {dt, dy} [kSub][dgroup] and C [kSub][32] in shared memory
// (coalesced loads; ragged steps as zeros, which leave the carry as it is),
// and each warp walks its channels' carries (kept in shared memory between
// sub-chunks) from there.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads) ssm_bwd_chunk_kernel(
    const T* __restrict__ dt, const float* __restrict__ A, const T* __restrict__ Cm,
    const T* __restrict__ dy, float* __restrict__ z, float* __restrict__ sdt, int L, int D,
    int N, int chunk, int dgroup) {
  const int c = blockIdx.x, g = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int tid = threadIdx.x, w = tid / 32, n = tid % 32;
  const int ld = dgroup + 1;
  float* sm = reinterpret_cast<float*>(dyn_smem());
  float2* in2 = reinterpret_cast<float2*>(sm);  // [kSub][ld] {dt, dy}
  float* sC = sm + 2 * kSub * ld;               // [kSub][32]
  float* carry_s = sC + kSub * 32;              // [dgroup][32]
  float* sdt_s = carry_s + dgroup * 32;         // [dgroup]
  const int d0 = g * dgroup, dn = min(dgroup, D - d0);
  for (int k = tid; k < dn * 32; k += kBwdThreads) carry_s[k] = 0.f;
  for (int k = tid; k < dn; k += kBwdThreads) sdt_s[k] = 0.f;
  const int t0 = c * chunk, t1 = min(L, t0 + chunk);
  for (int s = (t1 - 1) / kSub; s >= t0 / kSub; --s) {
    const int ts = s * kSub, nt = min(t1, ts + kSub) - ts;
    __syncthreads();  // the previous sub-chunk's walks are done
    for_tile(kSub, dn, [&](int j, int dl) {
      const size_t i = ((size_t)b * L + ts + j) * D + d0 + dl;
      in2[j * ld + dl] = j < nt ? make_float2(to_f(dt[i]), to_f(dy[i])) : make_float2(0.f, 0.f);
    });
    for (int k = tid; k < kSub * 32; k += kBwdThreads) {
      const int j = k / 32, nn = k % 32;
      sC[k] = j < nt && nn < N ? to_f(Cm[((size_t)b * L + ts + j) * N + nn]) : 0.f;
    }
    __syncthreads();
    for (int dl = w; dl < dn; dl += kBwdWarps) {
      const float a_dn = n < N ? A[(d0 + dl) * N + n] : 0.f;
      float carry = carry_s[dl * 32 + n], sum = 0.f;
#pragma unroll
      for (int j = kSub - 1; j >= 0; --j) {
        const float2 x = in2[j * ld + dl];
        carry = __expf(x.x * a_dn) * (sC[j * 32 + n] * x.y + carry);
        sum += x.x;
      }
      carry_s[dl * 32 + n] = carry;
      if (n == 0) sdt_s[dl] += sum;
    }
  }
  __syncthreads();
  for (int k = tid; k < dn * 32; k += kBwdThreads) {
    const int dl = k / 32, nn = k % 32;
    if (nn < N) z[(((size_t)b * nc + c) * D + d0 + dl) * N + nn] = carry_s[k];
  }
  for (int k = tid; k < dn; k += kBwdThreads) sdt[((size_t)b * nc + c) * D + d0 + k] = sdt_s[k];
}

size_t chunk_smem(int dgroup) {
  return (size_t)(2 * kSub * (dgroup + 1) + kSub * 32 + dgroup * 33) * sizeof(float);
}

// Backward pass 2: replace each chunk's z by the carry mu entering it from
// the right (zero for the last chunk), in place. One thread per (b, d, n);
// kCompose chunks' loads are issued before their stores.
constexpr int kCompose = 16;

__global__ void ssm_compose_rev_kernel(const float* __restrict__ A, float* __restrict__ z,
                                       const float* __restrict__ sdt, int Bsz, int D, int N,
                                       int nc) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)Bsz * D * N) return;
  const int n = (int)(idx % N), d = (int)(idx / N % D), b = (int)(idx / ((long long)N * D));
  const float a_dn = A[d * N + n];
  float mu = 0.f;
  for (int c1 = nc; c1 > 0; c1 -= kCompose) {
    float zc[kCompose], e[kCompose];
#pragma unroll
    for (int k = 0; k < kCompose; ++k) {  // chunks c1 - 1 - k
      const int c = c1 - 1 - k;
      const size_t o = ((size_t)b * nc + max(c, 0)) * D + d;
      zc[k] = c >= 0 ? z[o * N + n] : 0.f;
      e[k] = c >= 0 ? __expf(a_dn * sdt[o]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kCompose; ++k) {
      const int c = c1 - 1 - k;
      if (c >= 0) z[(((size_t)b * nc + c) * D + d) * N + n] = mu;
      mu = zc[k] + e[k] * mu;
    }
  }
}

// Backward pass 3, the design for the H100. Grid (chunks, d-groups, B);
// block kBwdWarps warps; the block owns channels [g * dgroup, min(D, (g + 1)
// * dgroup)), warp w the channels w, w + kBwdWarps, ... of them (dgroup /
// kBwdWarps each; a ragged group leaves some warps fewer or none). Per
// kSub-step sub-chunk, from the chunk's last:
//   1. the block stages {dt, u, dy} [kSub][dgroup] and {B, C} [kSub][32] as
//      fp32 in shared memory with coalesced loads (ragged steps as zeros),
//      so the walks read shared memory (one 16-byte and one 8-byte load a
//      step), not device memory;
//   2. each warp, channel by channel: the recompute from the saved state
//      keeps a_t = exp(dt A) in registers (the only exp of the walk), h_t
//      in its shared h rows, and adds h_t dy_t into its shared dC row (each
//      lane its own column: no barrier); the reverse walk of lam reuses
//      a_t, adds lam dt u into its dB row accB[t] in registers, and
//      buffers gg A and lam B for kRed steps at a time; a transpose-reduce
//      over the 32 lanes (9 shuffles for 8 steps, where a butterfly per
//      step takes 5) leaves each step's two sums over n in 4 lanes, one of
//      which stages du, ddt in the step's input slot and adds its dD term;
//   3. the block sums its warps' dB rows (through a shared buffer over the
//      consumed inputs) and dC rows in a fixed order and writes dB / dC:
//      into the outputs when one group covers D, else into per-group
//      partials; du / ddt leave as coalesced [t][d] rows.
// Registers: the 32-step a_t and dB rows, 8 steps of the two buffers; both
// sums' rows in registers (no shared read-modify-write at all) needed 168
// registers and spilled, and so did this layout at 3 blocks per SM, so the
// block runs 2 per SM (8 warps) with nothing spilled.
// dA and dD (sums over b and t) leave as one per-(b, chunk) partial row each.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks) ssm_bwd_kernel(
    const T* __restrict__ u, const T* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ Dskip,
    const T* __restrict__ dy, const float* __restrict__ states, const float* __restrict__ mu,
    float* __restrict__ du, float* __restrict__ ddt, float* __restrict__ dB_out,
    float* __restrict__ dC_out, float* __restrict__ dA_part, float* __restrict__ dD_part,
    int L, int D, int N, int chunk, int dgroup) {
  const int c = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, Bsz = gridDim.z;
  const int tid = threadIdx.x, w = tid / 32, n = tid % 32;
  const int nsub = (L + kSub - 1) / kSub;
  const BwdSmem lay(dgroup);
  const int ld = lay.ld;
  float* sm = reinterpret_cast<float*>(dyn_smem());
  float4* in4 = reinterpret_cast<float4*>(sm + lay.in4);
  float2* bc = reinterpret_cast<float2*>(sm + lay.bc);
  float *red = sm, *hist = sm + lay.hist + w * kSub * 32, *accC = sm + lay.accC + w * kSub * 32;
  float *carry_s = sm + lay.carry, *dA_s = sm + lay.dA, *dD_s = sm + lay.dD;
  const int d0 = g * dgroup, dn = min(dgroup, D - d0);

  for (int k = tid; k < dn * 32; k += kBwdThreads) {
    const int dl = k / 32, nn = k % 32;
    carry_s[k] = nn < N ? mu[(((size_t)b * nc + c) * D + d0 + dl) * N + nn] : 0.f;
    dA_s[k] = 0.f;
  }
  for (int k = tid; k < dn; k += kBwdThreads) dD_s[k] = 0.f;

  const int t0 = c * chunk, t1 = min(L, t0 + chunk);
  for (int s = (t1 - 1) / kSub; s >= t0 / kSub; --s) {
    const int ts = s * kSub, nt = min(t1, ts + kSub) - ts;
    __syncthreads();  // the previous sub-chunk is done with every buffer
    for_tile(kSub, dn, [&](int j, int dl) {
      const size_t i = ((size_t)b * L + ts + j) * D + d0 + dl;
      in4[j * ld + dl] = j < nt ? make_float4(to_f(dt[i]), to_f(u[i]), to_f(dy[i]), 0.f)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
    });
    for (int k = tid; k < kSub * 32; k += kBwdThreads) {
      const int j = k / 32, nn = k % 32;
      const size_t r = ((size_t)b * L + ts + j) * N + nn;
      bc[k] = j < nt && nn < N ? make_float2(to_f(Bm[r]), to_f(Cm[r])) : make_float2(0.f, 0.f);
    }
    __syncthreads();

    float accB[kSub];
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      accB[j] = 0.f;
      accC[j * 32 + n] = 0.f;
    }
    for (int dl = w; dl < dn; dl += kBwdWarps) {
      const int d = d0 + dl;
      const float a_dn = n < N ? A[d * N + n] : 0.f;
      const float h_in = n < N ? states[(((size_t)b * nsub + s) * D + d) * N + n] : 0.f;
      float av[kSub];
      float h = h_in;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const float4 x = in4[j * ld + dl];  // dt, u, dy
        const float a = __expf(x.x * a_dn);
        h = a * h + x.x * x.y * bc[j * 32 + n].x;
        av[j] = a;
        hist[j * 32 + n] = h;
        accC[j * 32 + n] += h * x.z;
      }
      float carry = carry_s[dl * 32 + n], dA_acc = 0.f, dD_acc = 0.f;
      const float dsk = Dskip[d];
#pragma unroll
      for (int q = kSub / kRed - 1; q >= 0; --q) {
        const int j0 = q * kRed;
        float ga[kRed], lb[kRed];
#pragma unroll
        for (int k = kRed - 1; k >= 0; --k) {
          const int j = j0 + k;
          const float4 x = in4[j * ld + dl];
          const float2 v = bc[j * 32 + n];
          const float lam = v.y * x.z + carry;
          const float gg = lam * (j > 0 ? hist[(j - 1) * 32 + n] : h_in) * av[j];  // dL/d(dt A)
          dA_acc += gg * x.x;
          ga[k] = gg * a_dn;
          lb[k] = lam * v.x;  // summed over n: dL/d(dt u)
          accB[j] += lam * (x.x * x.y);
          carry = av[j] * lam;
        }
        const float ddt_a = transpose_sum(ga, n), dtu = transpose_sum(lb, n);
        const int j = j0 + n / (32 / kRed);
        const float4 x = in4[j * ld + dl];
        __syncwarp();  // every lane has read its step's inputs
        if (n % (32 / kRed) == 0) {  // one writer per step
          dD_acc += x.z * x.y;
          in4[j * ld + dl] = make_float4(dtu * x.x + x.z * dsk, dtu * x.y + ddt_a, 0.f, 0.f);
        }
      }
      carry_s[dl * 32 + n] = carry;
      dA_s[dl * 32 + n] += dA_acc;
      const float dd = warp_sum(dD_acc);
      if (n == 0) dD_s[dl] += dd;
      __syncwarp();  // the next channel overwrites hist
    }
    __syncthreads();  // du / ddt of every channel are staged in in4
    for_tile(nt, dn, [&](int j, int dl) {
      const size_t i = ((size_t)b * L + ts + j) * D + d0 + dl;
      const float4 x = in4[j * ld + dl];
      du[i] = x.x;
      ddt[i] = x.y;
    });
    // dB (through red) and dC (the warps' own rows): the block sums its
    // warps in order.
    __syncthreads();  // in4 is consumed
#pragma unroll
    for (int j = 0; j < kSub; ++j) red[(w * kSub + j) * 32 + n] = accB[j];
    __syncthreads();
    for (int k = tid; k < nt * 32; k += kBwdThreads) {
      const int j = k / 32, nn = k % 32;
      if (nn >= N) continue;
      float sb = 0.f, sc = 0.f;
#pragma unroll
      for (int w2 = 0; w2 < kBwdWarps; ++w2) {
        sb += red[(w2 * kSub + j) * 32 + nn];
        sc += sm[lay.accC + (w2 * kSub + j) * 32 + nn];
      }
      const size_t o = (((size_t)g * Bsz + b) * L + ts + j) * N + nn;
      dB_out[o] = sb;
      dC_out[o] = sc;
    }
  }
  __syncthreads();
  for (int k = tid; k < dn * 32; k += kBwdThreads) {
    const int dl = k / 32, nn = k % 32;
    if (nn < N) dA_part[(((size_t)b * nc + c) * D + d0 + dl) * N + nn] = dA_s[k];
  }
  for (int k = tid; k < dn; k += kBwdThreads)
    dD_part[((size_t)b * nc + c) * D + d0 + k] = dD_s[k];
}

// out[i] = sum_{k < K} in[k * M + i], k in order: one thread per output
// (the dB / dC partials of several d-groups: K small, M large).
__global__ void ssm_sum_kernel(const float* __restrict__ in, float* __restrict__ out, int K,
                               long long M) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  float s = 0.f;
  for (int k = 0; k < K; ++k) s += in[k * M + i];
  out[i] = s;
}

// The same sum with K large and M small (the dA / dD partials, one row per
// (b, chunk)): block (32, 32) owns 32 outputs; thread (x, y) sums rows y,
// y + 32, ... of output x, then thread (x, 0) sums the 32 in order.
__global__ void __launch_bounds__(1024) ssm_sum_rows_kernel(const float* __restrict__ in,
                                                           float* __restrict__ out, int K,
                                                           long long M) {
  __shared__ float part[32][33];
  const long long i = (long long)blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (i < M)
    for (int k = threadIdx.y; k < K; k += 32) s += in[k * M + i];
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && i < M) {
    float t = 0.f;
    for (int y = 0; y < 32; ++y) t += part[y][threadIdx.x];
    out[i] = t;
  }
}

struct BwdLayout {  // workspace of the backward, in floats
  size_t z, sdt, dB, dC, dA, dD, total;
  BwdLayout(int Bsz, int L, int D, int N, int chunk, int dgroup) {
    const size_t nc = (L + chunk - 1) / chunk, G = (D + dgroup - 1) / dgroup;
    // dB / dC partials only when several d-groups share a (b, t) row
    const size_t part = G > 1 ? G * Bsz * L * N : 0, dpart = (size_t)Bsz * nc * D;
    z = 0;
    sdt = z + dpart * N;
    dB = sdt + dpart;
    dC = dB + part;
    dA = dC + part;
    dD = dA + dpart * N;
    total = dD + dpart;
  }
};

size_t bwd_smem(int dgroup) { return (size_t)BwdSmem(dgroup).total * sizeof(float); }

bool bad_shape(int Bsz, int L, int D, int N, int chunk) {
  return Bsz < 1 || Bsz > 65535 || L < 1 || D < 1 || N < 1 || N > 32 || chunk < kSub ||
         chunk % kSub != 0;
}

template <typename T, bool kStates>
cudaError_t ssm_fwd_launch(const FwdArgs<T>& a, int Bsz, cudaStream_t s) {
  const size_t smem = FwdSmem<T>::total;
  const int tiles = cdiv(a.D, DT);
  if (a.nc > 1) {
    const cudaError_t e = launch(ssm_fwd_end_kernel<T, kStates>, dim3(a.nc - 1, tiles, Bsz),
                                 dim3(kFwdThreads), smem, s, a);
    if (e != cudaSuccess) return e;
  }
  return launch(ssm_fwd_scan_kernel<T, kStates>, dim3(a.nc > 1 ? a.nc - 1 : 1, tiles, Bsz),
                dim3(kFwdThreads), smem, s, a);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename T>
cudaError_t ssm_fwd(FwdArgs<T> a, int Bsz, cudaStream_t s) {
  if (a.nc > 1 && (a.hend == nullptr || a.sdt == nullptr)) return cudaErrorInvalidValue;
  a.vec_ud = a.D % DT == 0 && aligned16(a.u) && aligned16(a.dt) && aligned16(a.y);
  a.vec_bc = a.N == 32 && aligned16(a.Bm) && aligned16(a.Cm);
  return a.states != nullptr ? ssm_fwd_launch<T, true>(a, Bsz, s)
                             : ssm_fwd_launch<T, false>(a, Bsz, s);
}

template <typename T>
int fwd_blocks_per_sm() {
  const auto kernel = ssm_fwd_scan_kernel<T, true>;
  const int smem = FwdSmem<T>::total;
  int per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kFwdThreads, smem);
  return e == cudaSuccess ? per_sm : -1;
}

template <typename T>
cudaError_t ssm_bwd(const T* u, const T* dt, const float* A, const T* Bm, const T* Cm,
                    const float* Dskip, const T* dy, const float* states, float* du,
                    float* ddt, float* dA, float* dB, float* dC, float* dD, float* ws, int Bsz,
                    int L, int D, int N, int chunk, int dgroup, cudaStream_t s) {
  const int nc = cdiv(L, chunk), G = cdiv(D, dgroup);
  const BwdLayout lay(Bsz, L, D, N, chunk, dgroup);
  float *z = ws + lay.z, *sdt = ws + lay.sdt;
  cudaError_t e = launch(ssm_bwd_chunk_kernel<T>, dim3(nc, G, Bsz), dim3(kBwdThreads),
                         chunk_smem(dgroup), s, dt, A, Cm, dy, z, sdt, L, D, N, chunk, dgroup);
  if (e != cudaSuccess) return e;
  const long long threads = (long long)Bsz * D * N;
  e = launch(ssm_compose_rev_kernel, dim3((unsigned)((threads + 255) / 256)), dim3(256), 0, s, A,
             z, sdt, Bsz, D, N, nc);
  if (e != cudaSuccess) return e;
  float *pB = G > 1 ? ws + lay.dB : dB, *pC = G > 1 ? ws + lay.dC : dC;
  e = launch(ssm_bwd_kernel<T>, dim3(nc, G, Bsz), dim3(kBwdThreads), bwd_smem(dgroup), s, u, dt,
             A, Bm, Cm, Dskip, dy, states, z, du, ddt, pB, pC, ws + lay.dA, ws + lay.dD, L, D,
             N, chunk, dgroup);
  if (e != cudaSuccess) return e;
  if (G > 1) {
    const long long bln = (long long)Bsz * L * N;
    const dim3 grid((unsigned)((bln + 255) / 256));
    if ((e = launch(ssm_sum_kernel, grid, dim3(256), 0, s, (const float*)pB, dB, G, bln)) !=
        cudaSuccess)
      return e;
    if ((e = launch(ssm_sum_kernel, grid, dim3(256), 0, s, (const float*)pC, dC, G, bln)) !=
        cudaSuccess)
      return e;
  }
  const long long dnn = (long long)D * N;
  e = launch(ssm_sum_rows_kernel, dim3((unsigned)((dnn + 31) / 32)), dim3(32, 32), 0, s,
             (const float*)(ws + lay.dA), dA, Bsz * nc, dnn);
  if (e != cudaSuccess) return e;
  return launch(ssm_sum_rows_kernel, dim3((unsigned)cdiv(D, 32)), dim3(32, 32), 0, s,
                (const float*)(ws + lay.dD), dD, Bsz * nc, (long long)D);
}

}  // namespace

// y [B, L, D] in the inputs' type; states (may be null) [B, ceil(L/32), D,
// N] fp32; with nc = ceil(L / chunk) > 1 chunks, hend [B, nc-1, D, N] and
// sdt [B, nc-1, D] fp32 scratch (unused, may be null, for one chunk).
extern "C" int blle_ssm_fwd(const void* u, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* Dskip, void* y, void* states,
                            void* hend, void* sdt, int Bsz, int L, int D, int N, int chunk,
                            int in_bf16, void* stream) {
  if (bad_shape(Bsz, L, D, N, chunk) || cdiv(D, DT) > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float *a = (const float*)A, *dsk = (const float*)Dskip;
  float *st = (float*)states, *he = (float*)hend, *sd = (float*)sdt;
  const int nc = cdiv(L, chunk);
  if (in_bf16)
    return ssm_fwd<bf16>({(const bf16*)u, (const bf16*)dt, (const bf16*)Bm, (const bf16*)Cm, a, dsk,
                          (bf16*)y, st, he, sd, L, D, N, chunk, nc, 0, 0},
                         Bsz, s);
  return ssm_fwd<float>({(const float*)u, (const float*)dt, (const float*)Bm, (const float*)Cm, a,
                         dsk, (float*)y, st, he, sd, L, D, N, chunk, nc, 0, 0},
                        Bsz, s);
}

// Blocks of S1 resident per SM (the occupancy API: registers and shared
// memory), or -1 on an error.
extern "C" int blle_ssm_fwd_blocks_per_sm(int in_bf16) {
  return in_bf16 ? fwd_blocks_per_sm<bf16>() : fwd_blocks_per_sm<float>();
}

extern "C" long long blle_ssm_bwd_workspace_floats(int Bsz, int L, int D, int N, int chunk,
                                                   int dgroup) {
  return (long long)BwdLayout(Bsz, L, D, N, chunk, dgroup).total;
}

// Blocks of ssm_bwd_kernel resident per SM at `dgroup` channels per block
// (the occupancy API: registers and shared memory), or -1 on an error.
extern "C" int blle_ssm_bwd_blocks_per_sm(int dgroup, int in_bf16) {
  int per_sm = 0;
  const size_t smem = bwd_smem(dgroup);
  cudaError_t e = in_bf16 ? cudaFuncSetAttribute(ssm_bwd_kernel<bf16>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem)
                          : cudaFuncSetAttribute(ssm_bwd_kernel<float>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem);
  if (e == cudaSuccess)
    e = in_bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ssm_bwd_kernel<bf16>,
                                                                kBwdThreads, smem)
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ssm_bwd_kernel<float>,
                                                                kBwdThreads, smem);
  return e == cudaSuccess ? per_sm : -1;
}

// du, ddt [B, L, D], dA [D, N], dB, dC [B, L, N], dD [D], all fp32; states
// from blle_ssm_fwd; dgroup (channels per block) a multiple of kBwdWarps.
extern "C" int blle_ssm_bwd(const void* u, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* Dskip, const void* dy,
                            const void* states, void* du, void* ddt, void* dA, void* dB,
                            void* dC, void* dD, void* workspace, int Bsz, int L, int D, int N,
                            int chunk, int dgroup, int in_bf16, void* stream) {
  if (bad_shape(Bsz, L, D, N, chunk) || dgroup < kBwdWarps || dgroup % kBwdWarps != 0 ||
      cdiv(D, dgroup) > 65535 || bwd_smem(dgroup) > 232448)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float *a = (const float*)A, *dsk = (const float*)Dskip, *st = (const float*)states;
  float *o_du = (float*)du, *o_ddt = (float*)ddt, *o_dA = (float*)dA, *o_dB = (float*)dB,
        *o_dC = (float*)dC, *o_dD = (float*)dD, *ws = (float*)workspace;
  if (in_bf16)
    return ssm_bwd<bf16>((const bf16*)u, (const bf16*)dt, a, (const bf16*)Bm, (const bf16*)Cm,
                         dsk, (const bf16*)dy, st, o_du, o_ddt, o_dA, o_dB, o_dC, o_dD, ws, Bsz,
                         L, D, N, chunk, dgroup, s);
  return ssm_bwd<float>((const float*)u, (const float*)dt, a, (const float*)Bm,
                        (const float*)Cm, dsk, (const float*)dy, st, o_du, o_ddt, o_dA, o_dB,
                        o_dC, o_dD, ws, Bsz, L, D, N, chunk, dgroup, s);
}
