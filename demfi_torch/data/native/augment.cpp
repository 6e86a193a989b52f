// Host-side augmentation of the training input pipeline.
//
// Fuses the per-sample augmentation chain of the train sampler (random
// crop -> horizontal flip -> rot90 x k -> [-1, 1] float normalisation,
// demfi_torch/data/datasets.py) into one pass that writes the final NHWC
// float32 sample directly: no intermediate numpy copies, no negative
// strides. PNG decoding stays where it is (demfi_torch/data/imageio.py).
//
// Built with g++ at first use into demfi_torch/_build/ and bound with
// ctypes (demfi_torch/data/native/__init__.py). Three channels only.

#include <cstddef>
#include <cstdint>

namespace {

// Map an output pixel (i, j) of the ps x ps augmented patch back to the
// cropped source pixel, inverting: flip (columns) then rot90 x k
// (numpy's rot90(m, k, (0, 1)): k=1: out[i,j] = m[j, n-1-i];
// k=2: m[n-1-i, n-1-j]; k=3: m[n-1-j, i]). The flip comes first.
inline void source_index(int i, int j, int ps, int flip, int rot,
                         int* sy, int* sx) {
  int y, x;
  switch (rot & 3) {
    default: y = i;          x = j;          break;
    case 1:  y = j;          x = ps - 1 - i; break;
    case 2:  y = ps - 1 - i; x = ps - 1 - j; break;
    case 3:  y = ps - 1 - j; x = i;          break;
  }
  if (flip) x = ps - 1 - x;
  *sy = y;
  *sx = x;
}

void augment_one(const uint8_t* frame, int H, int W, int cy, int cx,
                 int ps, int flip, int rot, float* out) {
  // frame: [H, W, 3] uint8; out: [ps, ps, 3] float32 in [-1, 1]
  (void)H;
  for (int i = 0; i < ps; ++i) {
    float* orow = out + (size_t)i * ps * 3;
    for (int j = 0; j < ps; ++j) {
      int sy, sx;
      source_index(i, j, ps, flip, rot, &sy, &sx);
      const uint8_t* p = frame + ((size_t)(cy + sy) * W + (cx + sx)) * 3;
      orow[j * 3 + 0] = (p[0] / 255.0f - 0.5f) * 2.0f;
      orow[j * 3 + 1] = (p[1] / 255.0f - 0.5f) * 2.0f;
      orow[j * 3 + 2] = (p[2] / 255.0f - 0.5f) * 2.0f;
    }
  }
}

}  // namespace

extern "C" {

// frames: [T, H, W, 3] uint8 (one sample's stacked window)
// out:    [T, ps, ps, 3] float32
void demfi_augment_pack(const uint8_t* frames, int T, int H, int W,
                        int cy, int cx, int ps, int flip, int rot,
                        float* out) {
  for (int t = 0; t < T; ++t) {
    augment_one(frames + (size_t)t * H * W * 3, H, W, cy, cx, ps, flip,
                rot, out + (size_t)t * ps * ps * 3);
  }
}

// Plain normalisation: n uint8 values -> float32 in [-1, 1].
void demfi_normalize(const uint8_t* frames, int64_t n, float* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = (frames[i] / 255.0f - 0.5f) * 2.0f;
}

}  // extern "C"
