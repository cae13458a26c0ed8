// Native batch-assembly engine for the SID/MCR data pipeline.
//
// The reference feeds training with a torch DataLoader running 16 worker
// *processes* (its train.py:99), each re-executing Python per item. Here
// the hot host-side work — cropping the uint16 mosaic + float GT,
// flips, black-level/ratio normalisation — is a C++ thread pool writing
// directly into the caller's pinned batch buffers (zero Python per item,
// zero copies beyond the one gather).
//
// Randomness (crop offsets / flip flags) stays in Python so the native and
// numpy paths are bit-identical under the same draws; the C++ side is pure
// deterministic data movement, parallel over batch items.
//
// Built as a plain C ABI for ctypes (no pybind11 needed).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr float kBlack = 512.0f;
constexpr float kWhite = 16383.0f;

struct SampleSpec {
  const uint16_t* mosaic;  // [h, w]
  const float* gt;         // [h, w, 3] (float path), or nullptr
  const uint16_t* gt16;    // [h, w, 3] (compact path), or nullptr
  int h, w;
  int ci, cj;              // crop offsets (even)
  bool flip_lr, flip_ud;
  float ratio;
};

inline void assemble_one(const SampleSpec& s, int patch, float* out_raw,
                         uint16_t* out_raw_u16, float* out_gt,
                         uint16_t* out_gt16) {
  const float scale = 1.0f / (kWhite - kBlack + 1e-6f);
  for (int r = 0; r < patch; ++r) {
    // Source row under flips: flips are applied to the cropped window.
    int sr = s.flip_ud ? (patch - 1 - r) : r;
    const size_t row_off = (size_t)(s.ci + sr) * s.w + s.cj;
    const uint16_t* mrow = s.mosaic + row_off;
    for (int c = 0; c < patch; ++c) {
      int sc = s.flip_lr ? (patch - 1 - c) : c;
      uint16_t code = mrow[sc];
      if (out_raw != nullptr) {
        float v = (float)code;
        v = std::min(std::max(v, kBlack), kWhite);
        out_raw[(size_t)r * patch + c] = (v - kBlack) * scale * s.ratio;
      }
      if (out_raw_u16 != nullptr) {
        out_raw_u16[(size_t)r * patch + c] = code;
      }
      if (out_gt != nullptr) {
        const float* g = s.gt + (row_off + (size_t)sc) * 3;
        float* o = out_gt + ((size_t)r * patch + c) * 3;
        o[0] = g[0];
        o[1] = g[1];
        o[2] = g[2];
      }
      if (out_gt16 != nullptr) {
        const uint16_t* g = s.gt16 + (row_off + (size_t)sc) * 3;
        uint16_t* o = out_gt16 + ((size_t)r * patch + c) * 3;
        o[0] = g[0];
        o[1] = g[1];
        o[2] = g[2];
      }
    }
  }
}

}  // namespace

extern "C" {

// Assemble a batch of (raw, gt) training patches in parallel.
//   mosaics[i]: pointer to full uint16 mosaic [h[i], w[i]]
//   gts[i]:     pointer to full float32 GT   [h[i], w[i], 3] (already /65535)
//   ci/cj/flip_lr/flip_ud/ratios: per-slot augmentation draws
//   out_raw:    [batch, patch, patch, 1] float32 (normalised+amplified)
//   out_gt:     [batch, patch, patch, 3] float32
// Returns 0 on success.
int bp_assemble_batch(const uint16_t** mosaics, const float** gts,
                      const int* hs, const int* ws, const int* ci,
                      const int* cj, const uint8_t* flip_lr,
                      const uint8_t* flip_ud, const float* ratios, int batch,
                      int patch, float* out_raw, float* out_gt,
                      int num_threads) {
  if (batch <= 0 || patch <= 0) return 1;
  std::vector<SampleSpec> specs(batch);
  for (int i = 0; i < batch; ++i) {
    specs[i] = SampleSpec{mosaics[i],      gts[i],  nullptr, hs[i], ws[i],
                          ci[i],           cj[i],   flip_lr[i] != 0,
                          flip_ud[i] != 0, ratios[i]};
    if (ci[i] < 0 || cj[i] < 0 || ci[i] + patch > hs[i] || cj[i] + patch > ws[i])
      return 2;
  }

  int nt = std::max(1, std::min(num_threads, batch));
  std::atomic<int> next{0};
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= batch) return;
      const size_t rstride = (size_t)patch * patch;
      assemble_one(specs[i], patch, out_raw + (size_t)i * rstride, nullptr,
                   out_gt + (size_t)i * rstride * 3, nullptr);
    }
  };

  if (nt == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(nt);
    for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  return 0;
}

// Compact-transfer variant: GT stays uint16 end-to-end and the raw mosaic
// ships as codes, so the H2D copy is 16-bit everywhere — normalisation
// ((clip(x,512,16383)-512)/range*ratio) and the /65535 GT decode move into
// the train step on the device. 5x less transfer than the fp32 batch.
int bp_assemble_batch_u16gt(const uint16_t** mosaics, const uint16_t** gts16,
                            const int* hs, const int* ws, const int* ci,
                            const int* cj, const uint8_t* flip_lr,
                            const uint8_t* flip_ud, const float* ratios,
                            int batch, int patch, uint16_t* out_raw_u16,
                            uint16_t* out_gt16, int num_threads) {
  if (batch <= 0 || patch <= 0) return 1;
  std::vector<SampleSpec> specs(batch);
  for (int i = 0; i < batch; ++i) {
    specs[i] = SampleSpec{mosaics[i],      nullptr, gts16[i], hs[i], ws[i],
                          ci[i],           cj[i],   flip_lr[i] != 0,
                          flip_ud[i] != 0, ratios[i]};
    if (ci[i] < 0 || cj[i] < 0 || ci[i] + patch > hs[i] || cj[i] + patch > ws[i])
      return 2;
  }
  int nt = std::max(1, std::min(num_threads, batch));
  std::atomic<int> next{0};
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= batch) return;
      const size_t rstride = (size_t)patch * patch;
      assemble_one(specs[i], patch, nullptr,
                   out_raw_u16 + (size_t)i * rstride, nullptr,
                   out_gt16 + (size_t)i * rstride * 3);
    }
  };
  if (nt == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(nt);
    for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  return 0;
}

// Convert a decoded 16-bit GT image to float32 [0,1] in parallel stripes
// (the reference divides by 65535 per item in Python, in its load_dataset.py).
int bp_gt_to_float(const uint16_t* gt16, float* out, int64_t n,
                   int num_threads) {
  int nt = std::max(1, num_threads);
  const float inv = 1.0f / 65535.0f;
  std::vector<std::thread> threads;
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([=]() {
      for (int64_t i = lo; i < hi; ++i) out[i] = gt16[i] * inv;
    });
  }
  for (auto& t : threads) t.join();
  return 0;
}

}  // extern "C"
