// Backward of the bilinear zero-padded gather, float32, NCHW, for Hopper
// (sm_90a).
//
// No TPU kernel: the JAX package's gather fast paths are custom_vjps whose
// backward recomputes through the exact XLA op (demfi_tpu/ops/warp.py:
// _bwarp_fast_bwd, _abs_fast_bwd), so what this kernel computes is the vjp
// of _bwarp_xla (relative mode, demfi_tpu/ops/warp.py:448) and of
// _bilinear_abs_xla (absolute mode, :494). Forward: bilinear_gather.cu.
// Plain PyTorch version: bilinear_gather_plain_vjp in
// demfi_torch/ops/warp.py (autograd through bilinear_gather_plain).
//
// What it computes, per query pixel q of batch element b, with the
// forward's taps, weights w_k (bilinear weight times tap validity) and
// mask m (relative mode: in-image weight >= 0.999, else 1):
//   grad_img[b, c, tap_k] += grad_out[b, c, q] * m * w_k     (atomics)
//   grad_coords[b, 0, q] = m * sum over c, k of grad_out[b, c, q]
//                          * img[b, c, tap_k] * dw_k/dfx     (likewise y)
// with d floor/dx = 0 and d fx/dx = 1; the tap validity and the mask are
// constants (they carry no gradient), so a tap outside the image, or a
// pixel the mask zeroes, contributes nothing. With `relative`, d px / d
// flow = 1, so the same sum is the flow's gradient.
// A call may consist of two halves (the backward of bwarp_pair): two image,
// coordinate and grad_out pointers of n batch elements each, written to
// grad_img [2n,C,H,W] and grad_coords [2n,2,Hq,Wq].
//
// Bound: device-memory bytes (read grad_out, coords and the taps of img
// once, write grad_img and grad_coords once; about 5 flops per byte).
// Design, simple on purpose: a 2-D grid over the query grid, one thread
// per query pixel that walks all C channels, so grad_coords is one
// thread's sum (the same bits every run); grad_img takes float atomics
// onto the four taps (their order, so the last bits of grad_img, vary from
// run to run). int32 offsets inside a plane, as in the forward; the weight
// arithmetic is the forward's (round-to-nearest intrinsics in the plain
// version's order), so the mask agrees with the forward's bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTX = 32;
constexpr int kTY = 8;

__global__ void __launch_bounds__(kTX * kTY)
bilinear_gather_bwd_kernel(const float* __restrict__ img_a,
                           const float* __restrict__ img_b,
                           const float* __restrict__ coords_a,
                           const float* __restrict__ coords_b,
                           const float* __restrict__ gout_a,
                           const float* __restrict__ gout_b,
                           float* __restrict__ grad_img,
                           float* __restrict__ grad_coords, int n, int C,
                           int H, int W, int Hq, int Wq, int relative) {
  const int x = blockIdx.x * kTX + threadIdx.x;
  const int y = blockIdx.y * kTY + threadIdx.y;
  if (x >= Wq || y >= Hq) return;
  const int zb = blockIdx.z;                 // batch element over both halves
  const bool second = zb >= n;
  const int b = second ? zb - n : zb;
  const float* img = second ? img_b : img_a;
  const float* coords = second ? coords_b : coords_a;
  const float* gout = second ? gout_b : gout_a;
  const int nq = Hq * Wq;
  const int hw = H * W;
  const int q = y * Wq + x;

  float qx = __ldg(coords + (int64_t)b * 2 * nq + q);
  float qy = __ldg(coords + (int64_t)b * 2 * nq + nq + q);
  if (relative) {
    qx = __fadd_rn((float)x, qx);
    qy = __fadd_rn((float)y, qy);
  }
  const float xf = floorf(qx);
  const float yf = floorf(qy);
  const float fx = __fsub_rn(qx, xf);
  const float fy = __fsub_rn(qy, yf);
  const float gx = __fsub_rn(1.0f, fx);
  const float gy = __fsub_rn(1.0f, fy);
  float wt[4], dwx[4], dwy[4];
  int off[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int dy = k >> 1, dx = k & 1;
    const float xi = xf + (float)dx;
    const float yi = yf + (float)dy;
    const float v = (xi >= 0.0f && xi < (float)W && yi >= 0.0f &&
                     yi < (float)H) ? 1.0f : 0.0f;
    wt[k] = __fmul_rn(__fmul_rn(dx ? fx : gx, dy ? fy : gy), v);
    // d w_k / d fx and d w_k / d fy (the validity a constant)
    dwx[k] = (dx ? 1.0f : -1.0f) * (dy ? fy : gy) * v;
    dwy[k] = (dy ? 1.0f : -1.0f) * (dx ? fx : gx) * v;
    const int xc = (int)fminf(fmaxf(xi, 0.0f), (float)(W - 1));
    const int yc = (int)fminf(fmaxf(yi, 0.0f), (float)(H - 1));
    off[k] = yc * W + xc;
  }
  const float in_img =
      __fadd_rn(__fadd_rn(__fadd_rn(wt[0], wt[1]), wt[2]), wt[3]);
  const float mask = (!relative || in_img >= 0.999f) ? 1.0f : 0.0f;

  float gcx = 0.0f, gcy = 0.0f;
  if (mask != 0.0f) {
    const float* p = img + (int64_t)b * C * hw;
    const float* g = gout + (int64_t)b * C * nq + q;
    float* gi = grad_img + (int64_t)zb * C * hw;
    for (int c = 0; c < C; ++c) {
      const float go = __ldg(g + (int64_t)c * nq);
      const float* pc = p + (int64_t)c * hw;
      float* gic = gi + (int64_t)c * hw;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (wt[k] == 0.0f && dwx[k] == 0.0f && dwy[k] == 0.0f) continue;
        const float tap = __ldg(pc + off[k]);
        gcx += go * tap * dwx[k];
        gcy += go * tap * dwy[k];
        if (wt[k] != 0.0f) atomicAdd(gic + off[k], go * wt[k]);
      }
    }
  }
  float* gc = grad_coords + (int64_t)zb * 2 * nq + q;
  gc[0] = gcx;
  gc[nq] = gcy;
}

}  // namespace

// The vjp of one gather of one or two halves. img_a [n,C,H,W], coords_a
// [n,2,Hq,Wq] and gout_a [n,C,Hq,Wq]; img_b, coords_b, gout_b: the second
// half of the same shapes, or all null. grad_img [halves*n,C,H,W], zeroed
// by the caller; grad_coords [halves*n,2,Hq,Wq], written in full. All
// float32, contiguous, on one device; H*W and Hq*Wq below 2^31. Launches
// on `stream` and returns cudaGetLastError().
extern "C" int demfi_bilinear_gather_bwd_f32(
    const float* img_a, const float* img_b, const float* coords_a,
    const float* coords_b, const float* gout_a, const float* gout_b,
    float* grad_img, float* grad_coords, int n, int C, int H, int W, int Hq,
    int Wq, int relative, void* stream) {
  if (n <= 0 || Hq <= 0 || Wq <= 0) return (int)cudaSuccess;
  const bool pair = img_b != nullptr;
  if (pair != (coords_b != nullptr) || pair != (gout_b != nullptr) ||
      H <= 0 || W <= 0 || C < 0 || (int64_t)H * W > INT32_MAX ||
      (int64_t)Hq * Wq > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int64_t batch = (int64_t)n * (pair ? 2 : 1);
  const int64_t gy = (Hq + kTY - 1) / kTY;
  if (gy > 65535 || batch > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)((Wq + kTX - 1) / kTX), (unsigned)gy,
                  (unsigned)batch);
  bilinear_gather_bwd_kernel<<<grid, dim3(kTX, kTY), 0,
                               (cudaStream_t)stream>>>(
      img_a, img_b, coords_a, coords_b, gout_a, gout_b, grad_img,
      grad_coords, n, C, H, W, Hq, Wq, relative);
  return (int)cudaGetLastError();
}
