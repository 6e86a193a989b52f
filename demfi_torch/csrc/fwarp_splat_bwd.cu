// Backward of the Gaussian forward splat (forward warp), float32, NCHW,
// for Hopper (sm_90a).
//
// No TPU kernel: the JAX package's forward-warp fast paths are custom_vjps
// whose backward recomputes through the exact XLA op (demfi_tpu/ops/
// warp.py: _fwarp_fast_bwd, and _fwarp_shift_fast_bwd, which takes
// _fwarp_xla's vjp whichever kernel served the forward), so what this
// kernel computes is the vjp of _fwarp_xla (demfi_tpu/ops/warp.py:549). It
// is the backward of all three forward warps of the port (fwarp_splat.cu,
// fwarp_shift.cu, and the guard between them). Plain PyTorch version:
// fwarp_splat_plain_vjp in demfi_torch/ops/warp.py.
//
// What it computes: the forward adds img[b, :, p] * w_k and w_k to out and
// norm at the four corners t_k = (y + r1 + a_k, x + c1 + b_k) of each
// source pixel p = (y, x), (r1, c1) = floor(flo), (fr, fc) the fractional
// parts, w_k = exp(-((fr - a_k)^2 + (fc - b_k)^2)), corners outside the
// image dropped. So, per source pixel, over its corners inside the image:
//   grad_img[b, c, p] = sum_k w_k * grad_out[b, c, t_k]
//   s_k = sum_c img[b, c, p] * grad_out[b, c, t_k] + grad_norm[b, 0, t_k]
//   grad_flo[b, 1, p] = sum_k -2 (fr - a_k) w_k s_k    (rows, y)
//   grad_flo[b, 0, p] = sum_k -2 (fc - b_k) w_k s_k    (columns, x)
// with d floor/d flo = 0 and d fr/d flo = 1. A source pixel the forward
// kernel drops (a flow that is NaN, infinite or so large that no corner
// lies in the image; the same float test as fwarp_splat.cu) gets zero
// gradients, finite.
//
// Bound: device-memory bytes (read img, flo, grad_out and grad_norm once,
// write grad_img and grad_flo once; a few flops per byte).
// Design, simple on purpose: one thread per source pixel, a 32 x 8 block
// of them; it gathers its four corners' grad_out for each channel and
// sums in a fixed order. No atomics: the same bits every run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTX = 32;
constexpr int kTY = 8;

__global__ void __launch_bounds__(kTX * kTY)
fwarp_splat_bwd_kernel(const float* __restrict__ img,
                       const float* __restrict__ flo,
                       const float* __restrict__ gout,
                       const float* __restrict__ gnorm,
                       float* __restrict__ grad_img,
                       float* __restrict__ grad_flo, int C, int H, int W) {
  const int x = blockIdx.x * kTX + threadIdx.x;
  const int y = blockIdx.y * kTY + threadIdx.y;
  if (x >= W || y >= H) return;
  const int b = blockIdx.z;
  const int hw = H * W;
  const int p = y * W + x;
  const float* fl = flo + (int64_t)b * 2 * hw;
  const float dc = __ldg(fl + p);        // along W
  const float dr = __ldg(fl + hw + p);   // along H
  const float c1 = floorf(dc);
  const float r1 = floorf(dr);
  const float fc = __fsub_rn(dc, c1);
  const float fr = __fsub_rn(dr, r1);
  const float ftr = __fadd_rn((float)y, r1);
  const float ftc = __fadd_rn((float)x, c1);
  const float* src = img + (int64_t)b * C * hw + p;
  float* gi = grad_img + (int64_t)b * C * hw + p;
  float* gf = grad_flo + (int64_t)b * 2 * hw + p;
  // false for NaN, infinities and huge flows, tested before any conversion
  if (!(ftr >= -1.0f && ftr < (float)H && ftc >= -1.0f && ftc < (float)W)) {
    for (int c = 0; c < C; ++c) gi[(int64_t)c * hw] = 0.0f;
    gf[0] = 0.0f;
    gf[hw] = 0.0f;
    return;
  }
  const int tr = (int)ftr, tc = (int)ftc;
  float wgt[4], s[4];
  int t[4];
  bool in[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int ddr = k >> 1, ddc = k & 1;
    const int r = tr + ddr, c = tc + ddc;
    in[k] = r >= 0 && r < H && c >= 0 && c < W;
    const float a = __fsub_rn(fr, (float)ddr);
    const float d = __fsub_rn(fc, (float)ddc);
    wgt[k] = expf(-__fadd_rn(__fmul_rn(a, a), __fmul_rn(d, d)));
    t[k] = in[k] ? r * W + c : 0;
    s[k] = in[k] ? __ldg(gnorm + (int64_t)b * hw + t[k]) : 0.0f;
  }
  const float* g = gout + (int64_t)b * C * hw;
  for (int c = 0; c < C; ++c) {
    const float v = __ldg(src + (int64_t)c * hw);
    const float* gc = g + (int64_t)c * hw;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!in[k]) continue;
      const float go = __ldg(gc + t[k]);
      acc += wgt[k] * go;
      s[k] += v * go;
    }
    gi[(int64_t)c * hw] = acc;
  }
  float gr = 0.0f, gcol = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!in[k]) continue;
    const float ws = wgt[k] * s[k];
    gr += -2.0f * (fr - (float)(k >> 1)) * ws;
    gcol += -2.0f * (fc - (float)(k & 1)) * ws;
  }
  gf[0] = gcol;
  gf[hw] = gr;
}

}  // namespace

// img [B,C,H,W], flo [B,2,H,W], gout [B,C,H,W], gnorm [B,1,H,W]; grad_img
// [B,C,H,W] and grad_flo [B,2,H,W] written in full. All float32,
// contiguous, on one device; H*W below 2^31. Launches on `stream` and
// returns cudaGetLastError().
extern "C" int demfi_fwarp_splat_bwd_f32(const float* img, const float* flo,
                                         const float* gout,
                                         const float* gnorm, float* grad_img,
                                         float* grad_flo, int B, int C, int H,
                                         int W, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  if (C < 0 || (int64_t)H * W > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int64_t gy = (H + kTY - 1) / kTY;
  if (B > 65535 || gy > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)((W + kTX - 1) / kTX), (unsigned)gy,
                  (unsigned)B);
  fwarp_splat_bwd_kernel<<<grid, dim3(kTX, kTY), 0, (cudaStream_t)stream>>>(
      img, flo, gout, gnorm, grad_img, grad_flo, C, H, W);
  return (int)cudaGetLastError();
}
