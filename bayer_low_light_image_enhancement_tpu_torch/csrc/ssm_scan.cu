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
// Design: one warp per (b, d), one lane per state n (N <= 32; lanes >= N
// carry zeros), y_t summed over the lanes with shuffles. The TPU carried the
// state across a sequential grid of L-chunks; here L is cut into chunks that
// run in parallel, with the chunk-carry algebra of ops/ssm.py:
//   1. ssm_chunk_end_kernel: each chunk's zero-start end state and sum(dt);
//   2. ssm_compose_kernel: per (b, d, n), the ordered composition
//      h_in(c+1) = exp(A sum dt(c)) h_in(c) + h_end(c) over the chunks;
//   3. ssm_scan_kernel: each chunk rescans from its true entry state and
//      writes y; with kStates it also saves the state entering every
//      kSub-step sub-chunk (what the backward restarts from).
// The backward mirrors it in reverse:
//   1. ssm_bwd_chunk_kernel: each chunk's zero-start a_first * lam_first;
//   2. ssm_compose_rev_kernel: the carry mu entering each chunk from the
//      right, mu(c-1) = z(c) + exp(A sum dt(c)) mu(c);
//   3. ssm_bwd_kernel: per chunk, sub-chunk by sub-chunk from the last,
//      recompute h from the saved entry state, then walk lam backwards and
//      emit du, ddt per element; see the design note above it.
// dB and dC sum over d, dA and dD over b and t: fixed-order sums of
// per-block partials, no atomics, so reruns are bitwise equal.
// Ragged L and D are masked in the kernels: the forward masks its loops; the
// backward stages ragged steps as dt = 0, B = C = dy = 0, which carry the
// state and lam through unchanged and add nothing.
#include "common.cuh"

namespace {

constexpr int kScanWarps = 8;  // channels d per block (one warp each)
constexpr int kScanThreads = kScanWarps * 32;
constexpr int kSub = 32;       // steps per saved state = backward sub-chunk

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

// Forward pass 1: the zero-start end state of chunk blockIdx.x and its
// sum of dt. Grid (chunks, ceil(D / kScanWarps), B).
template <typename T>
__global__ void __launch_bounds__(kScanThreads) ssm_chunk_end_kernel(
    const T* __restrict__ u, const T* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, float* __restrict__ hend, float* __restrict__ sdt,
    int L, int D, int N, int chunk) {
  const int c = blockIdx.x, b = blockIdx.z, nc = gridDim.x;
  const int d = blockIdx.y * kScanWarps + threadIdx.x / 32;
  const int n = threadIdx.x % 32;
  if (d >= D) return;
  const float a_dn = n < N ? A[d * N + n] : 0.f;
  const int t0 = c * chunk, t1 = min(L, t0 + chunk);
  float h = 0.f, s = 0.f;
  for (int t = t0; t < t1; ++t) {
    const size_t i = ((size_t)b * L + t) * D + d;
    const float dtv = to_f(dt[i]), uv = to_f(u[i]);
    const float bv = n < N ? to_f(Bm[((size_t)b * L + t) * N + n]) : 0.f;
    h = __expf(dtv * a_dn) * h + dtv * uv * bv;
    s += dtv;
  }
  const size_t o = ((size_t)b * nc + c) * D + d;
  if (n < N) hend[o * N + n] = h;
  if (n == 0) sdt[o] = s;
}

// Forward pass 2: replace each chunk's end state by its entry state, in
// place. One thread per (b, d, n).
__global__ void ssm_compose_kernel(const float* __restrict__ A, float* __restrict__ h,
                                   const float* __restrict__ sdt, int Bsz, int D, int N,
                                   int nc) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)Bsz * D * N) return;
  const int n = (int)(idx % N), d = (int)(idx / N % D), b = (int)(idx / ((long long)N * D));
  const float a_dn = A[d * N + n];
  float carry = 0.f;
  for (int c = 0; c < nc; ++c) {
    const size_t o = ((size_t)b * nc + c) * D + d;
    const float end = h[o * N + n];
    h[o * N + n] = carry;
    carry = __expf(a_dn * sdt[o]) * carry + end;
  }
}

// Forward pass 3: rescan chunk blockIdx.x from its entry state (zero when
// `entry` is null), write y, and with kStates the state entering every
// kSub-step sub-chunk (states [B, ceil(L / kSub), D, N]; chunk % kSub == 0).
template <typename T, bool kStates>
__global__ void __launch_bounds__(kScanThreads) ssm_scan_kernel(
    const T* __restrict__ u, const T* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ Dskip,
    const float* __restrict__ entry, T* __restrict__ y, float* __restrict__ states,
    int L, int D, int N, int chunk) {
  const int c = blockIdx.x, b = blockIdx.z, nc = gridDim.x;
  const int d = blockIdx.y * kScanWarps + threadIdx.x / 32;
  const int n = threadIdx.x % 32;
  if (d >= D) return;
  const int nsub = (L + kSub - 1) / kSub;
  const float a_dn = n < N ? A[d * N + n] : 0.f;
  const float dsk = Dskip[d];
  float h = (entry != nullptr && n < N) ? entry[(((size_t)b * nc + c) * D + d) * N + n] : 0.f;
  const int t0 = c * chunk, t1 = min(L, t0 + chunk);
  for (int t = t0; t < t1; ++t) {
    if (kStates && t % kSub == 0 && n < N)
      states[(((size_t)b * nsub + t / kSub) * D + d) * N + n] = h;
    const size_t i = ((size_t)b * L + t) * D + d;
    const size_t r = ((size_t)b * L + t) * N + n;
    const float dtv = to_f(dt[i]), uv = to_f(u[i]);
    const float bv = n < N ? to_f(Bm[r]) : 0.f;
    const float cv = n < N ? to_f(Cm[r]) : 0.f;
    h = __expf(dtv * a_dn) * h + dtv * uv * bv;
    const float yv = warp_sum(cv * h);
    if (n == 0) y[i] = from_f<T>(yv + dsk * uv);
  }
}

// The backward's blocks (passes 1 and 3).
constexpr int kBwdWarps = 4;
constexpr int kBwdThreads = kBwdWarps * 32;
// Blocks per SM the register budget is set for: at 3 (168 registers) ptxas
// spills the walk's rows whatever the layout; at 2 nothing spills.
constexpr int kBwdMinBlocks = 2;
constexpr int kRed = 8;           // steps per transpose-reduce

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

// v[k] for kRed steps k in each lane -> the sum over the 32 lanes of v[k]
// for k = lane / (32 / kRed), in every lane: halving exchanges at xor 16, 8,
// 4, then full ones at 2, 1 (9 shuffles for 8 steps; a fixed order). Every
// index is a constant, so v stays in registers.
static_assert(kRed == 8, "transpose_sum is written out for 8 steps");
__device__ __forceinline__ float transpose_sum(float (&v)[kRed], int lane) {
  halve<4, 16>(v, lane);
  halve<2, 8>(v, lane);
  halve<1, 4>(v, lane);
  v[0] += __shfl_xor_sync(0xffffffffu, v[0], 2);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

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

template <typename T>
cudaError_t ssm_fwd(const T* u, const T* dt, const float* A, const T* Bm, const T* Cm,
                    const float* Dskip, T* y, float* states, float* hbuf, float* sbuf, int Bsz,
                    int L, int D, int N, int chunk, cudaStream_t s) {
  const int nc = cdiv(L, chunk);
  const dim3 grid(nc, cdiv(D, kScanWarps), Bsz), block(kScanThreads);
  const float* entry = nullptr;
  if (nc > 1) {
    cudaError_t e = launch(ssm_chunk_end_kernel<T>, grid, block, 0, s, u, dt, A, Bm, hbuf, sbuf,
                           L, D, N, chunk);
    if (e != cudaSuccess) return e;
    const long long threads = (long long)Bsz * D * N;
    e = launch(ssm_compose_kernel, dim3((unsigned)((threads + 255) / 256)), dim3(256), 0, s, A,
               hbuf, sbuf, Bsz, D, N, nc);
    if (e != cudaSuccess) return e;
    entry = hbuf;
  }
  if (states != nullptr)
    return launch(ssm_scan_kernel<T, true>, grid, block, 0, s, u, dt, A, Bm, Cm, Dskip, entry,
                  y, states, L, D, N, chunk);
  return launch(ssm_scan_kernel<T, false>, grid, block, 0, s, u, dt, A, Bm, Cm, Dskip, entry, y,
                states, L, D, N, chunk);
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
// N] fp32; hbuf [B, ceil(L/chunk), D, N] and sbuf [B, ceil(L/chunk), D] fp32
// scratch (unused for a single chunk).
extern "C" int blle_ssm_fwd(const void* u, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* Dskip, void* y, void* states,
                            void* hbuf, void* sbuf, int Bsz, int L, int D, int N, int chunk,
                            int in_bf16, void* stream) {
  if (bad_shape(Bsz, L, D, N, chunk)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float *a = (const float*)A, *dsk = (const float*)Dskip;
  float *st = (float*)states, *hb = (float*)hbuf, *sb = (float*)sbuf;
  if (in_bf16)
    return ssm_fwd<bf16>((const bf16*)u, (const bf16*)dt, a, (const bf16*)Bm, (const bf16*)Cm,
                         dsk, (bf16*)y, st, hb, sb, Bsz, L, D, N, chunk, s);
  return ssm_fwd<float>((const float*)u, (const float*)dt, a, (const float*)Bm,
                        (const float*)Cm, dsk, (float*)y, st, hb, sb, Bsz, L, D, N, chunk, s);
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
