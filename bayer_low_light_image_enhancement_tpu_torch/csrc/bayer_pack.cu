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
// flops each. Design: a "group" is 4 output pixels of one packed row, i.e.
// 8 codes of each of its two mosaic rows (two 16-byte loads, two 16-byte
// bf16 stores). The grid is 2-D: x over column blocks, y over packed rows
// (row b * H/2 + i reads mosaic rows 2 row and 2 row + 1, so no division
// by the image height but the one that picks the row's ratio, in 32 bits),
// with a grid-stride loop in y where the rows exceed the grid's 65535. A
// thread takes kGroups groups blockDim.x apart in one row and issues all of its
// loads before any store. blle_bayer_pack_info gives the geometry
// (kernels/bayer_pack.py `pack_geometry` mirrors it). A width that is not a
// multiple of 8 (or an unaligned pointer) takes the same geometry with
// element-wise loads and stores.
#include "common.cuh"

namespace {

constexpr float kBlack = 512.0f;
constexpr float kWhite = 16383.0f;
constexpr float kScale = (float)(1.0 / (16383.0 - 512.0 + 1e-6));
constexpr int kGroups = 2;         // groups a thread
constexpr int kMaxTx = 512;        // threads a row block at most
constexpr int kBlockThreads = 128;  // the least threads a block (rows stack up to it)
constexpr int kMaxGridY = 65535;

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

// The launch over `rows` = B * H/2 packed rows of `groups` groups each:
// block (tx, ty), grid (gx, gy).
struct PackGeometry {
  int tx, ty, gx, gy;
};

PackGeometry pack_geometry(long long rows, int groups) {
  const int need = groups > kGroups ? (groups + kGroups - 1) / kGroups : 1;  // threads a row
  const int gx = (need + kMaxTx - 1) / kMaxTx;
  const int tx = ((need + gx - 1) / gx + 31) / 32 * 32;
  const int ty = tx >= kBlockThreads ? 1 : kBlockThreads / tx;
  const long long gy = (rows + ty - 1) / ty;
  return {tx, ty, gx, (int)(gy < kMaxGridY ? gy : kMaxGridY)};
}

template <typename OutT, bool VEC>
__global__ void __launch_bounds__(kMaxTx) bayer_pack_kernel(
    const uint16_t* __restrict__ mosaic, const float* __restrict__ ratio,
    OutT* __restrict__ out, int rows, int H2, int W, int clamp01) {
  const int W2 = W / 2, groups = (W2 + 3) / 4;
  const int g0 = blockIdx.x * (kGroups * blockDim.x) + threadIdx.x;
  // 32-bit unsigned rows: rows < 2^31 and a step < 2^25 never wrap.
  for (unsigned row = blockIdx.y * blockDim.y + threadIdx.y; row < (unsigned)rows;
       row += gridDim.y * blockDim.y) {
    const float r = ratio[row / (unsigned)H2];
    const uint16_t* top = mosaic + (size_t)row * 2 * W;
    OutT* o = out + (size_t)row * W2 * 4;
    __align__(16) uint16_t t[kGroups][8];
    __align__(16) uint16_t u[kGroups][8];
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const int g = g0 + k * blockDim.x;
      if (g >= groups) continue;
      if constexpr (VEC) {
        *reinterpret_cast<uint4*>(t[k]) = *reinterpret_cast<const uint4*>(top + 8 * g);
        *reinterpret_cast<uint4*>(u[k]) = *reinterpret_cast<const uint4*>(top + W + 8 * g);
      } else {
        const int n = min(8, W - 8 * g);
        for (int e = 0; e < n; ++e) {
          t[k][e] = top[8 * g + e];
          u[k][e] = top[W + 8 * g + e];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const int g = g0 + k * blockDim.x;
      if (g >= groups) continue;
      const int n = VEC ? 4 : min(4, W2 - 4 * g);
      __align__(16) OutT v[16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q < n) {
          v[4 * q + 0] = to_out<OutT>(decode(t[k][2 * q], r, clamp01));      // R
          v[4 * q + 1] = to_out<OutT>(decode(t[k][2 * q + 1], r, clamp01));  // G1
          v[4 * q + 2] = to_out<OutT>(decode(u[k][2 * q], r, clamp01));      // G2
          v[4 * q + 3] = to_out<OutT>(decode(u[k][2 * q + 1], r, clamp01));  // B
        }
      }
      OutT* dst = o + 16 * g;
      if constexpr (VEC) {
        constexpr int kVecs = (int)(16 * sizeof(OutT) / sizeof(uint4));
#pragma unroll
        for (int e = 0; e < kVecs; ++e)
          reinterpret_cast<uint4*>(dst)[e] = reinterpret_cast<const uint4*>(v)[e];
      } else {
        for (int e = 0; e < 4 * n; ++e) dst[e] = v[e];
      }
    }
  }
}

template <typename OutT>
cudaError_t pack_launch(const uint16_t* m, const float* r, OutT* o, int B, int H, int W,
                        int clamp01, bool vec, cudaStream_t s) {
  const long long rows = (long long)B * (H / 2);
  const PackGeometry g = pack_geometry(rows, (W / 2 + 3) / 4);
  const dim3 grid(g.gx, g.gy), block(g.tx, g.ty);
  if (vec)
    return launch(bayer_pack_kernel<OutT, true>, grid, block, 0, s, m, r, o, (int)rows, H / 2,
                  W, clamp01);
  return launch(bayer_pack_kernel<OutT, false>, grid, block, 0, s, m, r, o, (int)rows, H / 2, W,
                clamp01);
}

}  // namespace

extern "C" int blle_bayer_pack(const void* mosaic, const void* ratio, void* out,
                               int B, int H, int W, int out_bf16, int clamp01,
                               void* stream) {
  const bool vec = (W % 8 == 0) && ((uintptr_t)mosaic % 16 == 0) && ((uintptr_t)out % 16 == 0);
  cudaStream_t s = (cudaStream_t)stream;
  const uint16_t* m = (const uint16_t*)mosaic;
  const float* r = (const float*)ratio;
  if (out_bf16) return (int)pack_launch(m, r, (bf16*)out, B, H, W, clamp01, vec, s);
  return (int)pack_launch(m, r, (float*)out, B, H, W, clamp01, vec, s);
}

// The launch geometry at [B, H, W]: info = threads x, threads y, grid x,
// grid y, groups a thread.
extern "C" int blle_bayer_pack_info(int B, int H, int W, long long* info) {
  const PackGeometry g = pack_geometry((long long)B * (H / 2), (W / 2 + 3) / 4);
  info[0] = g.tx, info[1] = g.ty, info[2] = g.gx, info[3] = g.gy, info[4] = kGroups;
  return 0;
}

extern "C" const char* blle_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
