// Deterministic forward warp (Gaussian splat as an output-stationary
// stencil sum), float32, NCHW, for Hopper (sm_90a).
//
// Replaces the TPU kernels _fwarp_shift_kernel_v2 and _fwarp_shift_kernel
// (demfi_tpu/ops/pallas_kernels.py:479 and :421), both reached through
// fwarp_shift_tpu (:551); the two bodies compute the same sum and differ
// only in how they were laid out for the TPU's compiler, so this one
// kernel stands for both. Used by CFR where the configuration asks for
// repeatable bits. Plain PyTorch version: fwarp_shift_plain in
// demfi_torch/ops/warp.py.
//
// What it computes: with (r1, c1) = floor(flo) and (fr, fc) the
// fractional parts of a source pixel's displacement,
//   wy = (exp(-fr^2), exp(-(fr-1)^2)),  wx = (exp(-fc^2), exp(-(fc-1)^2)),
//   out(y, x) = sum over dy, dx in [-D, D+1] of
//               vals(y-dy, x-dx) * MY_dy(y-dy, x-dx) * MX_dx(y-dy, x-dx),
//   MY_dy = [r1 == dy] wy0 + [r1 == dy-1] wy1, MX_dx likewise,
// over the source pixels inside the image, for vals = (img, 1): the C
// warped channels and the weight norm. This is the forward splat of
// fwarp_splat.cu read from the side of the output pixel; the two are
// equal wherever max|flo| <= D - 1 (the caller's guard), to the rounding
// of exp(-(a^2 + b^2)) against exp(-a^2) * exp(-b^2). The bucket is
// floor(flo), not floor(grid + flo). Splats that land outside the image
// have no output pixel and so are dropped.
//
// Bound: the function's is the splat's, device-memory bytes (read img
// and flo once, write out and norm once; 4 corners of C+1 multiply-adds
// per source pixel). This algorithm pays more: it tests (2D+2)^2 source
// pixels per output pixel, 324 at D = 8 and 4,356 at D = 32, each up to
// two loads from L1, two floors and four compares; about one tap in
// (2D+2)^2 / 4 matches and pays the two expf and the C+1 multiply-adds.
// That is the price of a fixed summation order without atomics, and it
// puts the kernel far above its bound.
//
// Design: one thread per output pixel, a 32x8 tile per block (a warp
// reads 32 neighbouring source pixels of one row, so the loads coalesce
// and the block's (8 + 2D + 1) x (32 + 2D + 1) source window stays in
// L1). The window is walked in a fixed order, dy outer and dx inner, and
// every term is added with round-to-nearest intrinsics and no FMA
// contraction, in the plain version's order: the sum's order, and so
// every bit of the result, is fixed whatever the grid, and there are no
// atomics. Channels are taken four at a time (one pass for CFR's C = 2).
// D is a run-time argument. A tile of floor(flo) and the four weights in
// shared memory would take the floors and the second load out of the tap
// loop; not done yet.
//
// Guard: with `flag` not null the launch first reduces
// any(|flo| > D - 1) to *flag on the device (fwarp_flag_kernel: a
// grid-stride pass over flo, one atomicOr per block that found one). The
// stencil then does its work only where *flag == 0; where it is 1 every
// thread writes 0 to its output elements instead, which is the cleared
// accumulator that fwarp_splat.cu, given the same flag, then adds into.
// So the choice between the two kernels needs no copy to the host, and
// the outputs need no separate clearing pass on either route. When the
// stencil does its work, one thread adds 1 to *served (if not null).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;
constexpr int kChunk = 4;   // channels accumulated per pass

constexpr int kFlagThreads = 256;
constexpr int kFlagBlocks = 1056;   // 8 blocks for each of the 132 SMs

// *flag |= any(|flo[i]| > bound), i < n. *flag is cleared before the launch.
__global__ void __launch_bounds__(kFlagThreads)
fwarp_flag_kernel(const float* __restrict__ flo, int64_t n, float bound,
                  int* __restrict__ flag) {
  int found = 0;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    found |= (fabsf(flo[i]) > bound);
  if (__syncthreads_or(found) && threadIdx.x == 0) atomicOr(flag, 1);
}

__global__ void __launch_bounds__(kTileX * kTileY)
fwarp_shift_kernel(const float* __restrict__ img,
                   const float* __restrict__ flo, float* __restrict__ out,
                   float* __restrict__ norm, const int* __restrict__ flag,
                   int* __restrict__ served, int C, int H, int W, int D,
                   int chunks) {
  const int x = blockIdx.x * kTileX + threadIdx.x;
  const int y = blockIdx.y * kTileY + threadIdx.y;
  const int b = blockIdx.z / chunks;
  const int c0 = (blockIdx.z % chunks) * kChunk;
  const int nc = min(kChunk, C - c0);
  const int64_t hw = (int64_t)H * W;
  if (flag != nullptr && *flag != 0) {   // the splat's call: clear for it
    if (x >= W || y >= H) return;
    const int64_t q = (int64_t)y * W + x;
    for (int c = 0; c < nc; ++c)
      out[((int64_t)b * C + c0 + c) * hw + q] = 0.0f;
    if (c0 == 0) norm[(int64_t)b * hw + q] = 0.0f;
    return;
  }
  if (served != nullptr && blockIdx.x == 0 && blockIdx.y == 0 &&
      blockIdx.z == 0 && threadIdx.x == 0 && threadIdx.y == 0)
    atomicAdd(served, 1);
  if (x >= W || y >= H) return;
  const float* fx = flo + ((int64_t)b * 2 + 0) * hw;   // along W
  const float* fy = flo + ((int64_t)b * 2 + 1) * hw;   // along H
  const float* src = img + ((int64_t)b * C + c0) * hw;

  float acc[kChunk] = {0.0f, 0.0f, 0.0f, 0.0f};
  float acc_n = 0.0f;
  for (int dy = -D; dy <= D + 1; ++dy) {
    const int sy = y - dy;
    if (sy < 0 || sy >= H) continue;
    const float fdy = (float)dy;
    for (int dx = -D; dx <= D + 1; ++dx) {
      const int sx = x - dx;
      if (sx < 0 || sx >= W) continue;
      const int64_t p = (int64_t)sy * W + sx;
      const float dr = fy[p];
      const float r1 = floorf(dr);
      const bool y0 = (r1 == fdy);
      if (!y0 && r1 != fdy - 1.0f) continue;
      const float dc = fx[p];
      const float c1 = floorf(dc);
      const float fdx = (float)dx;
      const bool x0 = (c1 == fdx);
      if (!x0 && c1 != fdx - 1.0f) continue;
      float a = __fsub_rn(dr, r1);
      float d = __fsub_rn(dc, c1);
      if (!y0) a = __fsub_rn(a, 1.0f);
      if (!x0) d = __fsub_rn(d, 1.0f);
      const float my = expf(-__fmul_rn(a, a));
      const float mx = expf(-__fmul_rn(d, d));
      const float wgt = __fmul_rn(my, mx);
      for (int c = 0; c < nc; ++c)
        acc[c] = __fadd_rn(acc[c], __fmul_rn(src[(int64_t)c * hw + p], wgt));
      acc_n = __fadd_rn(acc_n, wgt);
    }
  }
  const int64_t q = (int64_t)y * W + x;
  for (int c = 0; c < nc; ++c)
    out[((int64_t)b * C + c0 + c) * hw + q] = acc[c];
  if (c0 == 0) norm[(int64_t)b * hw + q] = acc_n;
}

}  // namespace

// img [B,C,H,W], flo [B,2,H,W], out [B,C,H,W], norm [B,1,H,W]: float32,
// contiguous, on one device. Every element of out and norm is written:
// the stencil sum, or 0 where `flag` is given and comes out 1. flag (one
// int32 on the device, written here) and served (int32 on the device):
// or null. Launches on `stream` and returns the first CUDA error.
extern "C" int demfi_fwarp_shift_f32(const float* img, const float* flo,
                                     float* out, float* norm, int* flag,
                                     int* served, int B, int C, int H, int W,
                                     int D, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  if (D < 1) return (int)cudaErrorInvalidValue;
  const int chunks = (C + kChunk - 1) / kChunk;
  const int64_t gz = (int64_t)B * chunks;
  const int64_t gy = (H + kTileY - 1) / kTileY;
  if (gz > 65535 || gy > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)((W + kTileX - 1) / kTileX), (unsigned)gy,
                  (unsigned)gz);
  const dim3 block(kTileX, kTileY);
  if (flag != nullptr) {
    const cudaError_t rc =
        cudaMemsetAsync(flag, 0, sizeof(int), (cudaStream_t)stream);
    if (rc != cudaSuccess) return (int)rc;
    const int64_t n = (int64_t)B * 2 * H * W;
    const int64_t blocks = (n + kFlagThreads - 1) / kFlagThreads;
    fwarp_flag_kernel<<<(unsigned)(blocks < kFlagBlocks ? blocks : kFlagBlocks),
                        kFlagThreads, 0, (cudaStream_t)stream>>>(
        flo, n, (float)(D - 1), flag);
  }
  fwarp_shift_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      img, flo, out, norm, flag, served, C, H, W, D, chunks);
  return (int)cudaGetLastError();
}
