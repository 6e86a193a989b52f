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
// Rows of a split frame (--mesh_spatial), as in the forward (fwarp_splat.cu):
// the source may be rows [r0, r0 + H) of a frame of Ho rows, its row y
// being row y + r0 of the canvases that the cotangents grad_out [B,C,Ho,W]
// and grad_norm [B,1,Ho,W] cover (the whole frame's: the backward of the
// ranks' canvas sum). grad_img and grad_flo are the source rows'. The base
// row y + r0 is an int added to floor(flo) in float, as in the forward, so
// a shard's gradients are the unsplit call's rows bit for bit (Ho = H and
// r0 = 0 for a whole frame).
//
// Bound: device-memory bytes (read img, flo, grad_out and grad_norm once,
// write grad_img and grad_flo once; a few flops per byte).
//
// One kernel, one or two halves. A train step calls this function twice,
// both from CFR (demfi_torch/ops/warp.py: cfr_flow_t_align), on two flow
// fields of equal shapes at C = 2: about 11 MB together at batch 2,
// 256x256, 3.3 us of the card's memory rate. What a call pays for there
// is not bytes but the launch, a partial wave of blocks and each thread's
// chain of dependent loads (flo, then grad_norm, img and grad_out at its
// corners). So the entry takes two halves of equal shapes (CFR's two
// warps, one launch; blockIdx.z walks the batch elements of both) or one
// (any other caller). One thread per source pixel, a 32 x 8 block of
// them; each thread issues every load of its corners before the first
// use: the flow, then the grad_norm corners, then for each tile of
// channels (all of C at the compile-time C = 2; one channel at a time
// for any other C) the img values and grad_out corners: at C = 2, 16
// independent loads a pixel. An empty kernel on the two halves' grid
// takes about 0.005 ms on an H100 (chip_smoke.py phase 7(a)), more than
// the function's 0.0034 ms of bytes: the launch, not the work, sets the
// floor. The sum runs in a fixed order per pixel (corners 0..3, channels
// in order), with no atomics: the same bits every run, and one half
// gives the same bits alone as in a pair (tests/test_torch_cuda.py).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTX = 32;
constexpr int kTY = 8;

template <int kC>
__global__ void __launch_bounds__(kTX * kTY)
fwarp_splat_bwd_kernel(const float* __restrict__ img_a,
                       const float* __restrict__ img_b,
                       const float* __restrict__ flo_a,
                       const float* __restrict__ flo_b,
                       const float* __restrict__ gout_a,
                       const float* __restrict__ gout_b,
                       const float* __restrict__ gnorm_a,
                       const float* __restrict__ gnorm_b,
                       float* __restrict__ grad_img,
                       float* __restrict__ grad_flo, int B, int C_rt, int H,
                       int W, int Ho, int r0) {
  const int C = kC > 0 ? kC : C_rt;
  constexpr int kNC = kC > 0 ? kC : 1;   // channels whose loads go together
  const int x = blockIdx.x * kTX + threadIdx.x;
  const int y = blockIdx.y * kTY + threadIdx.y;
  if (x >= W || y >= H) return;
  const int z = blockIdx.z;              // batch element of the outputs
  const bool second = z >= B;
  const int b = second ? z - B : z;
  const int hw = H * W;     // a source plane
  const int ohw = Ho * W;   // a canvas plane
  const int p = y * W + x;
  const float* src = (second ? img_b : img_a) + (int64_t)b * C * hw + p;
  const float* fl = (second ? flo_b : flo_a) + (int64_t)b * 2 * hw + p;
  const float* g = (second ? gout_b : gout_a) + (int64_t)b * C * ohw;
  const float* gn = (second ? gnorm_b : gnorm_a) + (int64_t)b * ohw;
  float* gi = grad_img + (int64_t)z * C * hw + p;
  float* gf = grad_flo + (int64_t)z * 2 * hw + p;

  const float dc = __ldg(fl);        // along W
  const float dr = __ldg(fl + hw);   // along H
  const float c1 = floorf(dc);
  const float r1 = floorf(dr);
  const float fc = __fsub_rn(dc, c1);
  const float fr = __fsub_rn(dr, r1);
  const float ftr = __fadd_rn((float)(y + r0), r1);
  const float ftc = __fadd_rn((float)x, c1);
  // false for NaN, infinities and huge flows, tested before any
  // conversion (fwarp_splat.cu's test)
  if (!(ftr >= -1.0f && ftr < (float)Ho && ftc >= -1.0f && ftc < (float)W)) {
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
    in[k] = r >= 0 && r < Ho && c >= 0 && c < W;
    const float a = __fsub_rn(fr, (float)ddr);
    const float d = __fsub_rn(fc, (float)ddc);
    wgt[k] = expf(-__fadd_rn(__fmul_rn(a, a), __fmul_rn(d, d)));
    t[k] = in[k] ? r * W + c : 0;
  }
  // grad_norm at every corner: s starts from it
#pragma unroll
  for (int k = 0; k < 4; ++k) s[k] = in[k] ? __ldg(gn + t[k]) : 0.0f;
  // channels, kNC at a time: every img value and grad_out corner of the
  // tile loaded, then summed
  for (int c0 = 0; c0 < C; c0 += kNC) {
    float v[kNC], go[kNC][4];
#pragma unroll
    for (int cc = 0; cc < kNC; ++cc) {
      const float* gc = g + (int64_t)(c0 + cc) * ohw;
      v[cc] = __ldg(src + (int64_t)(c0 + cc) * hw);
#pragma unroll
      for (int k = 0; k < 4; ++k) go[cc][k] = in[k] ? __ldg(gc + t[k]) : 0.0f;
    }
#pragma unroll
    for (int cc = 0; cc < kNC; ++cc) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (!in[k]) continue;
        acc += wgt[k] * go[cc][k];
        s[k] += v[cc] * go[cc][k];
      }
      gi[(int64_t)(c0 + cc) * hw] = acc;
    }
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

// halves = 1 or 2 of equal shapes, a and b (b unread for one half):
// img_* [B,C,H,W], flo_* [B,2,H,W], gout_* [B,C,Ho,W], gnorm_* [B,1,Ho,W];
// grad_img [halves*B,C,H,W] and grad_flo [halves*B,2,H,W] written in full,
// half a's batch elements first. Source row y is canvas row y + r0 (Ho = H
// and r0 = 0 for a whole frame). All float32, contiguous, on one device;
// Ho*W below 2^31. Launches on `stream` and returns cudaGetLastError().
extern "C" int demfi_fwarp_splat_bwd_f32(
    const float* img_a, const float* img_b, const float* flo_a,
    const float* flo_b, const float* gout_a, const float* gout_b,
    const float* gnorm_a, const float* gnorm_b, float* grad_img,
    float* grad_flo, int halves, int B, int C, int H, int W, int Ho, int r0,
    void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  if (C < 0 || (halves != 1 && halves != 2) || (int64_t)Ho * W > INT32_MAX ||
      r0 < 0 || (int64_t)r0 + H > Ho)
    return (int)cudaErrorInvalidValue;
  const int64_t gy = (H + kTY - 1) / kTY;
  if ((int64_t)halves * B > 65535 || gy > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)((W + kTX - 1) / kTX), (unsigned)gy,
                  (unsigned)(halves * B));
  const dim3 block(kTX, kTY);
  cudaStream_t st = (cudaStream_t)stream;
  if (C == 2)
    fwarp_splat_bwd_kernel<2><<<grid, block, 0, st>>>(
        img_a, img_b, flo_a, flo_b, gout_a, gout_b, gnorm_a, gnorm_b,
        grad_img, grad_flo, B, C, H, W, Ho, r0);
  else
    fwarp_splat_bwd_kernel<0><<<grid, block, 0, st>>>(
        img_a, img_b, flo_a, flo_b, gout_a, gout_b, gnorm_a, gnorm_b,
        grad_img, grad_flo, B, C, H, W, Ho, r0);
  return (int)cudaGetLastError();
}
