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
//      recompute h from the saved entry state into registers, then walk lam
//      backwards in registers and emit du, ddt per element. dB and dC sum
//      over d: each warp (which loops over the d's of its block's d-group)
//      adds into its own shared-memory rows, the block sums its warps in a
//      fixed order into one fp32 partial per d-group, and ssm_sum_kernel
//      sums the d-groups in a fixed order; dA and dD (sums over b and t) go
//      the same way through per-(b, chunk) partials. No atomics:
//      deterministic.
// Ragged L and D are masked in the kernels (no padding with dt = 0 steps).
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

// Backward pass 1: chunk blockIdx.x's zero-start carry a_first * lam_first
// (z) and its sum of dt. Grid as forward pass 1.
template <typename T>
__global__ void __launch_bounds__(kScanThreads) ssm_bwd_chunk_kernel(
    const T* __restrict__ dt, const float* __restrict__ A, const T* __restrict__ Cm,
    const T* __restrict__ dy, float* __restrict__ z, float* __restrict__ sdt, int L, int D,
    int N, int chunk) {
  const int c = blockIdx.x, b = blockIdx.z, nc = gridDim.x;
  const int d = blockIdx.y * kScanWarps + threadIdx.x / 32;
  const int n = threadIdx.x % 32;
  if (d >= D) return;
  const float a_dn = n < N ? A[d * N + n] : 0.f;
  const int t0 = c * chunk, t1 = min(L, t0 + chunk);
  float carry = 0.f, s = 0.f;
  for (int t = t1 - 1; t >= t0; --t) {
    const size_t i = ((size_t)b * L + t) * D + d;
    const float dtv = to_f(dt[i]), dyv = to_f(dy[i]);
    const float cv = n < N ? to_f(Cm[((size_t)b * L + t) * N + n]) : 0.f;
    carry = __expf(dtv * a_dn) * (cv * dyv + carry);
    s += dtv;
  }
  const size_t o = ((size_t)b * nc + c) * D + d;
  if (n < N) z[o * N + n] = carry;
  if (n == 0) sdt[o] = s;
}

// Backward pass 2: replace each chunk's z by the carry mu entering it from
// the right (zero for the last chunk), in place. One thread per (b, d, n).
__global__ void ssm_compose_rev_kernel(const float* __restrict__ A, float* __restrict__ z,
                                       const float* __restrict__ sdt, int Bsz, int D, int N,
                                       int nc) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)Bsz * D * N) return;
  const int n = (int)(idx % N), d = (int)(idx / N % D), b = (int)(idx / ((long long)N * D));
  const float a_dn = A[d * N + n];
  float mu = 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const size_t o = ((size_t)b * nc + c) * D + d;
    const float zc = z[o * N + n];
    z[o * N + n] = mu;
    mu = zc + __expf(a_dn * sdt[o]) * mu;
  }
}

// Backward pass 3. Grid (chunks, d-groups, B); block kScanWarps warps; the
// block owns channels [g * dgroup, min(D, (g + 1) * dgroup)), warp w the
// channels w, w + kScanWarps, ... of them. Shared memory: the per-warp dB and
// dC rows of the current sub-chunk [kScanWarps][kSub][32] each, then per
// channel of the group the lam carry [dgroup][32], the dA sum [dgroup][32]
// and the dD sum [dgroup].
template <typename T>
__global__ void __launch_bounds__(kScanThreads) ssm_bwd_kernel(
    const T* __restrict__ u, const T* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ Dskip,
    const T* __restrict__ dy, const float* __restrict__ states, const float* __restrict__ mu,
    float* __restrict__ du, float* __restrict__ ddt, float* __restrict__ dB_part,
    float* __restrict__ dC_part, float* __restrict__ dA_part, float* __restrict__ dD_part,
    int L, int D, int N, int chunk, int dgroup) {
  const int c = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, Bsz = gridDim.z;
  const int w = threadIdx.x / 32, n = threadIdx.x % 32;
  const int nsub = (L + kSub - 1) / kSub;
  float* bufB = reinterpret_cast<float*>(dyn_smem());
  float* bufC = bufB + kScanWarps * kSub * 32;
  float* carry_s = bufC + kScanWarps * kSub * 32;
  float* dA_s = carry_s + dgroup * 32;
  float* dD_s = dA_s + dgroup * 32;
  const int d0 = g * dgroup, dn = min(dgroup, D - d0);

  for (int k = threadIdx.x; k < dn * 32; k += kScanThreads) {
    const int dl = k / 32, nn = k % 32;
    carry_s[k] = nn < N ? mu[(((size_t)b * nc + c) * D + d0 + dl) * N + nn] : 0.f;
    dA_s[k] = 0.f;
  }
  for (int k = threadIdx.x; k < dn; k += kScanThreads) dD_s[k] = 0.f;
  __syncthreads();

  const int t0 = c * chunk, t1 = min(L, t0 + chunk);
  float* myB = bufB + w * kSub * 32;
  float* myC = bufC + w * kSub * 32;
  for (int s = (t1 - 1) / kSub; s >= t0 / kSub; --s) {
    const int ts = s * kSub, te = min(t1, ts + kSub);
    bool first = true;
    for (int dl = w; dl < dn; dl += kScanWarps) {
      const int d = d0 + dl;
      const float a_dn = n < N ? A[d * N + n] : 0.f;
      const float dsk = Dskip[d];
      const float h_in = n < N ? states[(((size_t)b * nsub + s) * D + d) * N + n] : 0.f;
      float hist[kSub];
      float h = h_in;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int t = ts + j;
        float vc = 0.f;
        if (t < te) {
          const size_t i = ((size_t)b * L + t) * D + d;
          const float dtv = to_f(dt[i]), uv = to_f(u[i]), dyv = to_f(dy[i]);
          const float bv = n < N ? to_f(Bm[((size_t)b * L + t) * N + n]) : 0.f;
          h = __expf(dtv * a_dn) * h + dtv * uv * bv;
          vc = h * dyv;
        }
        hist[j] = h;
        myC[j * 32 + n] = first ? vc : myC[j * 32 + n] + vc;
      }
      float carry = carry_s[dl * 32 + n];
      float dA_acc = 0.f, dD_acc = 0.f;
#pragma unroll
      for (int j = kSub - 1; j >= 0; --j) {
        const int t = ts + j;
        float vb = 0.f;
        if (t < te) {
          const size_t i = ((size_t)b * L + t) * D + d;
          const size_t r = ((size_t)b * L + t) * N + n;
          const float dtv = to_f(dt[i]), uv = to_f(u[i]), dyv = to_f(dy[i]);
          const float bv = n < N ? to_f(Bm[r]) : 0.f;
          const float cv = n < N ? to_f(Cm[r]) : 0.f;
          const float a = __expf(dtv * a_dn);
          const float lam = cv * dyv + carry;
          const float gg = lam * (j > 0 ? hist[j - 1] : h_in) * a;  // dL/d(dt A)
          dA_acc += gg * dtv;
          const float ddt_a = warp_sum(gg * a_dn);
          const float dtu = warp_sum(lam * bv);  // dL/d(dt u)
          vb = lam * dtv * uv;
          if (n == 0) {
            du[i] = dtu * dtv + dyv * dsk;
            ddt[i] = dtu * uv + ddt_a;
            dD_acc += dyv * uv;
          }
          carry = a * lam;
        }
        myB[j * 32 + n] = first ? vb : myB[j * 32 + n] + vb;
      }
      carry_s[dl * 32 + n] = carry;
      dA_s[dl * 32 + n] += dA_acc;
      if (n == 0) dD_s[dl] += dD_acc;
      first = false;
    }
    if (first) {  // a warp without a channel in this group
      for (int j = 0; j < kSub; ++j) myB[j * 32 + n] = myC[j * 32 + n] = 0.f;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < (te - ts) * 32; k += kScanThreads) {
      const int j = k / 32, nn = k % 32;
      if (nn >= N) continue;
      float sb = 0.f, sc = 0.f;
      for (int w2 = 0; w2 < kScanWarps; ++w2) {
        sb += bufB[(w2 * kSub + j) * 32 + nn];
        sc += bufC[(w2 * kSub + j) * 32 + nn];
      }
      const size_t o = (((size_t)g * Bsz + b) * L + ts + j) * N + nn;
      dB_part[o] = sb;
      dC_part[o] = sc;
    }
    __syncthreads();
  }
  for (int k = threadIdx.x; k < dn * 32; k += kScanThreads) {
    const int dl = k / 32, nn = k % 32;
    if (nn < N) dA_part[(((size_t)b * nc + c) * D + d0 + dl) * N + nn] = dA_s[k];
  }
  for (int k = threadIdx.x; k < dn; k += kScanThreads)
    dD_part[((size_t)b * nc + c) * D + d0 + k] = dD_s[k];
}

// out[i] = sum_{k < K} in[k * M + i], k in order.
__global__ void ssm_sum_kernel(const float* __restrict__ in, float* __restrict__ out, int K,
                               long long M) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  float s = 0.f;
  for (int k = 0; k < K; ++k) s += in[k * M + i];
  out[i] = s;
}

cudaError_t sum_rows(const float* in, float* out, int K, long long M, cudaStream_t s) {
  return launch(ssm_sum_kernel, dim3((unsigned)((M + 255) / 256)), dim3(256), 0, s, in, out, K,
                M);
}

struct BwdLayout {  // workspace of the backward, in floats
  size_t z, sdt, dB, dC, dA, dD, total;
  BwdLayout(int Bsz, int L, int D, int N, int chunk, int dgroup) {
    const size_t nc = (L + chunk - 1) / chunk, G = (D + dgroup - 1) / dgroup;
    const size_t part = G * Bsz * L * N, dpart = (size_t)Bsz * nc * D;
    z = 0;
    sdt = z + dpart * N;
    dB = sdt + dpart;
    dC = dB + part;
    dA = dC + part;
    dD = dA + dpart * N;
    total = dD + dpart;
  }
};

size_t bwd_smem(int dgroup) {
  return (size_t)(2 * kScanWarps * kSub * 32 + dgroup * 65) * sizeof(float);
}

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
  const dim3 grid(nc, cdiv(D, kScanWarps), Bsz), block(kScanThreads);
  cudaError_t e = launch(ssm_bwd_chunk_kernel<T>, grid, block, 0, s, dt, A, Cm, dy, z, sdt, L,
                         D, N, chunk);
  if (e != cudaSuccess) return e;
  const long long threads = (long long)Bsz * D * N;
  e = launch(ssm_compose_rev_kernel, dim3((unsigned)((threads + 255) / 256)), dim3(256), 0, s, A,
             z, sdt, Bsz, D, N, nc);
  if (e != cudaSuccess) return e;
  e = launch(ssm_bwd_kernel<T>, dim3(nc, G, Bsz), block, bwd_smem(dgroup), s, u, dt, A, Bm, Cm,
             Dskip, dy, states, z, du, ddt, ws + lay.dB, ws + lay.dC, ws + lay.dA, ws + lay.dD,
             L, D, N, chunk, dgroup);
  if (e != cudaSuccess) return e;
  const long long bln = (long long)Bsz * L * N;
  if ((e = sum_rows(ws + lay.dB, dB, G, bln, s)) != cudaSuccess) return e;
  if ((e = sum_rows(ws + lay.dC, dC, G, bln, s)) != cudaSuccess) return e;
  if ((e = sum_rows(ws + lay.dA, dA, Bsz * nc, (long long)D * N, s)) != cudaSuccess) return e;
  return sum_rows(ws + lay.dD, dD, Bsz * nc, D, s);
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

// du, ddt [B, L, D], dA [D, N], dB, dC [B, L, N], dD [D], all fp32; states
// from blle_ssm_fwd; dgroup a multiple of 8 (channels per block).
extern "C" int blle_ssm_bwd(const void* u, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* Dskip, const void* dy,
                            const void* states, void* du, void* ddt, void* dA, void* dB,
                            void* dC, void* dD, void* workspace, int Bsz, int L, int D, int N,
                            int chunk, int dgroup, int in_bf16, void* stream) {
  if (bad_shape(Bsz, L, D, N, chunk) || dgroup < kScanWarps || dgroup % kScanWarps != 0 ||
      cdiv(D, dgroup) > 65535)
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
