// Gaussian forward splat (forward warp), float32, NCHW, for Hopper (sm_90a).
//
// Replaces the TPU kernel _fwarp_kernel / fwarp_tpu
// (demfi_tpu/ops/pallas_kernels.py:273, :343), used by CFR
// (demfi_tpu/ops/warp.py:1073-1074). Plain PyTorch version:
// fwarp_splat_plain in demfi_torch/ops/warp.py.
//
// What it computes: each source pixel p = (y, x) of batch element b adds
// img[b, :, p] * w and w to out[b, :, t] and norm[b, 0, t] for the 4
// corners t = (y + r1 + dr, x + c1 + dc), dr, dc in {0, 1}, with
// (r1, c1) = floor(flo[b, :, p]) and w = exp(-((fr - dr)^2 + (fc - dc)^2))
// of the fractional parts. The bucket is floor(flo) added to the integer
// base grid, not floor(grid + flo): the two differ when the float sum
// rounds across an integer. Corners outside the image are dropped.
//
// Bound: device-memory bytes (read img and flo once, write out and norm
// once; about 2 flops per byte).
//
// Design: source-stationary scatter, one thread per source pixel, with
// float32 atomicAdd of the C+1 channels (image plus normaliser). Reads
// are perfectly coalesced; the adds go out as fire-and-forget reductions
// that resolve in L2 (on the main path the 3-channel accumulator of all
// 7 instants is 19 MB, inside the 50 MB L2). Exact for any motion; the
// order of the atomics varies from run to run, so results agree with the
// plain version to rounding, not bitwise. The weights use
// round-to-nearest intrinsics in the plain version's order.
//
// Guard: with `flag` not null the kernel does its work only where
// *flag != 0, else every thread returns at once: the flag is the one that
// fwarp_shift.cu computed (some |flo| lies beyond its window), and the
// accumulator is the output that its launch cleared. When the kernel does
// its work, one thread adds 1 to *served (if not null).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fwarp_splat_kernel(const float* __restrict__ img,
                   const float* __restrict__ flo, float* __restrict__ out,
                   float* __restrict__ norm, const int* __restrict__ flag,
                   int* __restrict__ served, int C, int H, int W) {
  if (flag != nullptr && *flag == 0) return;
  if (served != nullptr && blockIdx.x == 0 && blockIdx.y == 0 &&
      threadIdx.x == 0)
    atomicAdd(served, 1);
  const int64_t hw = (int64_t)H * W;
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= hw) return;
  const int b = blockIdx.y;
  const float y = (float)(p / W);
  const float x = (float)(p % W);

  const float dc = flo[((int64_t)b * 2 + 0) * hw + p];
  const float dr = flo[((int64_t)b * 2 + 1) * hw + p];
  const float c1 = floorf(dc);
  const float r1 = floorf(dr);
  const float fc = __fsub_rn(dc, c1);
  const float fr = __fsub_rn(dr, r1);

  const float* src = img + (int64_t)b * C * hw + p;
  float* dst = out + (int64_t)b * C * hw;
  float* nrm = norm + (int64_t)b * hw;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int ddr = k >> 1, ddc = k & 1;
    const float a = __fsub_rn(fr, (float)ddr);
    const float d = __fsub_rn(fc, (float)ddc);
    const float wgt = expf(-__fadd_rn(__fmul_rn(a, a), __fmul_rn(d, d)));
    const float tr = __fadd_rn(__fadd_rn(y, r1), (float)ddr);
    const float tc = __fadd_rn(__fadd_rn(x, c1), (float)ddc);
    if (!(tr >= 0.0f && tr < (float)H && tc >= 0.0f && tc < (float)W))
      continue;
    const int64_t t = (int64_t)tr * W + (int64_t)tc;
    for (int c = 0; c < C; ++c)
      atomicAdd(dst + (int64_t)c * hw + t, __fmul_rn(src[(int64_t)c * hw], wgt));
    atomicAdd(nrm + t, wgt);
  }
}

}  // namespace

// img [B,C,H,W], flo [B,2,H,W], out [B,C,H,W] and norm [B,1,H,W] zeroed by
// the caller. All float32, contiguous, on one device. flag and served:
// int32 on the device, or null. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int demfi_fwarp_splat_f32(const float* img, const float* flo,
                                     float* out, float* norm,
                                     const int* flag, int* served, int B,
                                     int C, int H, int W, void* stream) {
  const int64_t hw = (int64_t)H * W;
  if (B <= 0 || hw <= 0) return (int)cudaSuccess;
  if (B > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)((hw + kThreads - 1) / kThreads), (unsigned)B);
  fwarp_splat_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      img, flo, out, norm, flag, served, C, H, W);
  return (int)cudaGetLastError();
}
