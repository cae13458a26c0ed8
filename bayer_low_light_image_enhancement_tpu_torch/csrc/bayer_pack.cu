// K1: fused Bayer decode + normalise + amplify + clamp + RGGB pack.
//
// Replaces the TPU kernel `_pack_kernel` driven by `bayer_pack_normalize`
// (bayer_low_light_image_enhancement_tpu/kernels/bayer_pack.py), AND the
// space-to-depth that the TPU left to XLA after it: the mosaic
// [B, H, W] uint16 goes in, the packed NHWC planes [B, H/2, W/2, 4]
// (R, G1, G2, B = 2x2 positions (0,0), (0,1), (1,0), (1,1)) come out.
//
// Per code: read unsigned (hot pixels >= 32768 stay large and clip to the
// white level), clip to [512, 16383], scale by 1/(16383-512+1e-6), times the
// image's ratio, optionally min(., 1) (the model's input clamp).
//
// Bound: memory. 2 bytes read and 2 (bf16) written per mosaic code, a few
// flops each. Design: each thread owns 4 output pixels of one packed row,
// i.e. 8 codes of each of the two mosaic rows: two 16-byte loads and (bf16)
// two 16-byte stores, neighbouring threads on neighbouring addresses. A
// width that is not a multiple of 8 (or an unaligned pointer) takes the
// same thread layout with element-wise loads and stores.
#include "common.cuh"

namespace {

constexpr float kBlack = 512.0f;
constexpr float kWhite = 16383.0f;
constexpr float kScale = (float)(1.0 / (16383.0 - 512.0 + 1e-6));

template <typename OutT>
__device__ __forceinline__ OutT to_out(float v);
template <>
__device__ __forceinline__ float to_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 to_out<bf16>(float v) { return f2bf(v); }

__device__ __forceinline__ float decode(uint16_t code, float ratio, int clamp01) {
  float x = fminf(fmaxf((float)code, kBlack), kWhite);
  x = (x - kBlack) * kScale * ratio;
  return clamp01 ? fminf(x, 1.0f) : x;
}

template <typename OutT>
__global__ void __launch_bounds__(256) bayer_pack_kernel(
    const uint16_t* __restrict__ mosaic, const float* __restrict__ ratio,
    OutT* __restrict__ out, int B, int H, int W, int clamp01, int vec) {
  const int H2 = H / 2, W2 = W / 2;
  const int groups = (W2 + 3) / 4;  // 4 packed pixels per thread
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * H2 * groups) return;
  const int g = (int)(idx % groups);
  const long long row = idx / groups;  // b * H2 + i
  const int i = (int)(row % H2);
  const int b = (int)(row / H2);
  const float r = ratio[b];
  const uint16_t* top = mosaic + ((long long)b * H + 2 * i) * W + 8 * g;
  const uint16_t* bot = top + W;
  OutT* o = out + (row * W2 + 4 * g) * 4;

  __align__(16) uint16_t t[8];
  __align__(16) uint16_t u[8];
  __align__(16) OutT v[16];
  const int n = vec ? 4 : min(4, W2 - 4 * g);
  if (vec) {
    *reinterpret_cast<uint4*>(t) = *reinterpret_cast<const uint4*>(top);
    *reinterpret_cast<uint4*>(u) = *reinterpret_cast<const uint4*>(bot);
  } else {
    for (int k = 0; k < 2 * n; ++k) {
      t[k] = top[k];
      u[k] = bot[k];
    }
  }
  for (int q = 0; q < n; ++q) {
    v[4 * q + 0] = to_out<OutT>(decode(t[2 * q], r, clamp01));      // R
    v[4 * q + 1] = to_out<OutT>(decode(t[2 * q + 1], r, clamp01));  // G1
    v[4 * q + 2] = to_out<OutT>(decode(u[2 * q], r, clamp01));      // G2
    v[4 * q + 3] = to_out<OutT>(decode(u[2 * q + 1], r, clamp01));  // B
  }
  if (vec) {
    constexpr int kVecs = (int)(16 * sizeof(OutT) / sizeof(uint4));
    for (int k = 0; k < kVecs; ++k)
      reinterpret_cast<uint4*>(o)[k] = reinterpret_cast<const uint4*>(v)[k];
  } else {
    for (int k = 0; k < 4 * n; ++k) o[k] = v[k];
  }
}

}  // namespace

extern "C" int blle_bayer_pack(const void* mosaic, const void* ratio, void* out,
                               int B, int H, int W, int out_bf16, int clamp01,
                               void* stream) {
  const int groups = (W / 2 + 3) / 4;
  const long long total = (long long)B * (H / 2) * groups;
  const int vec = (W % 8 == 0) && ((uintptr_t)mosaic % 16 == 0) &&
                  ((uintptr_t)out % 16 == 0);
  const dim3 grid((unsigned)((total + 255) / 256));
  cudaStream_t s = (cudaStream_t)stream;
  const uint16_t* m = (const uint16_t*)mosaic;
  const float* r = (const float*)ratio;
  if (out_bf16)
    return launch(bayer_pack_kernel<bf16>, grid, dim3(256), 0, s, m, r,
                  (bf16*)out, B, H, W, clamp01, vec);
  return launch(bayer_pack_kernel<float>, grid, dim3(256), 0, s, m, r,
                (float*)out, B, H, W, clamp01, vec);
}

extern "C" const char* blle_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
