// Bilinear zero-padded gather, float32, NCHW, for Hopper (sm_90a).
//
// Replaces the TPU kernel _gather_kernel / bilinear_gather_tpu
// (demfi_tpu/ops/pallas_kernels.py:58, :145), used there by bwarp_tpu
// (relative: coords = grid + flow, times the 0.999 mask) and
// bilinear_sample_abs_tpu (absolute: raw flow values as coordinates).
// Plain PyTorch version: bilinear_gather_plain in demfi_torch/ops/warp.py.
//
// What it computes, per query pixel q of batch element b:
//   (px, py) = coords[b, :, q]            (+ (x_q, y_q) in relative mode)
//   out[b, c, q] = sum over the 4 corner taps of img[b, c, tap] * w_tap,
//   w_tap = bilinear weight * (tap inside the image), zero padding;
//   relative mode also writes ones[b, 0, q] = sum of the w_tap (the
//   sample of an all-ones image) and multiplies out by (ones >= 0.999),
//   both in float32. The output grid (Hq, Wq) follows coords, not the
//   image: FGAC at rr > 0 samples a (3H, 3W) query grid.
//
// Bound: device-memory bytes. It does about 2 flops per byte it must
// move (read img and coords once, write out and ones once), far below
// the card's ~20 flops/byte balance point for float32.
//
// Design: one thread per query pixel computes the tap offsets and the
// four weights once and reuses them over a chunk of 16 channels
// (gridDim.z walks the chunks). The 32 threads of a warp are 32
// neighbouring query pixels: their output stores are contiguous, and for
// smooth flows their taps are neighbours too, so the loads coalesce and
// the 2x2 footprint is re-read from L1/L2 rather than device memory.
// The weight, in-image-weight and accumulation arithmetic uses
// round-to-nearest intrinsics in the plain version's order (no FMA
// contraction), so the 0.999 mask is bit-identical to the plain
// version's. Exact for any motion: there is no motion window.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChanChunk = 16;

__global__ void __launch_bounds__(kThreads)
bilinear_gather_kernel(const float* __restrict__ img,
                       const float* __restrict__ coords,
                       float* __restrict__ out, float* __restrict__ ones,
                       int C, int H, int W, int Hq, int Wq, int relative) {
  const int64_t nq = (int64_t)Hq * Wq;
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= nq) return;
  const int b = blockIdx.y;
  const int c_lo = blockIdx.z * kChanChunk;
  const int c_hi = min(C, c_lo + kChanChunk);

  float px = coords[((int64_t)b * 2 + 0) * nq + q];
  float py = coords[((int64_t)b * 2 + 1) * nq + q];
  if (relative) {
    px = __fadd_rn((float)(q % Wq), px);
    py = __fadd_rn((float)(q / Wq), py);
  }
  const float x0 = floorf(px);
  const float y0 = floorf(py);
  const float fx = __fsub_rn(px, x0);
  const float fy = __fsub_rn(py, y0);
  const float gx = __fsub_rn(1.0f, fx);
  const float gy = __fsub_rn(1.0f, fy);

  float wt[4];
  int64_t off[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int dy = k >> 1, dx = k & 1;
    const float xi = x0 + (float)dx;
    const float yi = y0 + (float)dy;
    const bool valid = xi >= 0.0f && xi < (float)W && yi >= 0.0f &&
                       yi < (float)H;
    wt[k] = __fmul_rn(__fmul_rn(dx ? fx : gx, dy ? fy : gy),
                      valid ? 1.0f : 0.0f);
    // out-of-image taps read a clamped in-image pixel with weight 0
    // (fmaxf maps NaN to 0), as the plain version does
    const int xc = (int)fminf(fmaxf(xi, 0.0f), (float)(W - 1));
    const int yc = (int)fminf(fmaxf(yi, 0.0f), (float)(H - 1));
    off[k] = (int64_t)yc * W + xc;
  }
  const float in_img = __fadd_rn(__fadd_rn(__fadd_rn(wt[0], wt[1]), wt[2]),
                                 wt[3]);
  const float mask = (!relative || in_img >= 0.999f) ? 1.0f : 0.0f;

  const int64_t hw = (int64_t)H * W;
  const float* src = img + (int64_t)b * C * hw;
  float* dst = out + (int64_t)b * C * nq + q;
  for (int c = c_lo; c < c_hi; ++c) {
    const float* p = src + (int64_t)c * hw;
    float v = __fmul_rn(__ldg(p + off[0]), wt[0]);
    v = __fadd_rn(v, __fmul_rn(__ldg(p + off[1]), wt[1]));
    v = __fadd_rn(v, __fmul_rn(__ldg(p + off[2]), wt[2]));
    v = __fadd_rn(v, __fmul_rn(__ldg(p + off[3]), wt[3]));
    if (relative) v = __fmul_rn(v, mask);
    dst[(int64_t)c * nq] = v;
  }
  if (relative && blockIdx.z == 0) ones[(int64_t)b * nq + q] = in_img;
}

}  // namespace

// img [B,C,H,W], coords [B,2,Hq,Wq], out [B,C,Hq,Wq], ones [B,1,Hq,Wq]
// (relative mode only; may be null otherwise). All float32, contiguous,
// on one device. Launches on `stream` and returns cudaGetLastError().
extern "C" int demfi_bilinear_gather_f32(const float* img, const float* coords,
                                         float* out, float* ones, int B, int C,
                                         int H, int W, int Hq, int Wq,
                                         int relative, void* stream) {
  const int64_t nq = (int64_t)Hq * Wq;
  if (B <= 0 || nq <= 0) return (int)cudaSuccess;
  if (B > 65535) return (int)cudaErrorInvalidConfiguration;
  const int chunks = C > 0 ? (C + kChanChunk - 1) / kChanChunk : 1;
  const dim3 grid((unsigned)((nq + kThreads - 1) / kThreads), (unsigned)B,
                  (unsigned)chunks);
  bilinear_gather_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      img, coords, out, ones, C, H, W, Hq, Wq, relative);
  return (int)cudaGetLastError();
}
