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
// Rows of a split frame (--mesh_spatial): the source may be Hs rows of an
// output canvas of H rows, its row y being canvas row y + r0. A source
// pixel then lands at (r0 + y) + r1, anywhere in the canvas; every rank
// splats its rows into its own zeroed canvas and a sum over the ranks
// (all_reduce) is the unsplit splat. The base row y + r0 is an int added
// to floor(flo) in float, as in the unsplit call (Hs = H, r0 = 0), so
// each pixel's targets and weights are the unsplit call's.
//
// Non-finite flows: a source pixel whose flow is NaN or infinite, or so
// large that no corner lies in the image (1e9), is dropped, like a splat
// that leaves the image. Its float compares fail before any conversion to
// int, so it neither adds nor widens its block's box. (The plain version
// multiplies a NaN weight by a validity of 0 and scatters the NaN at an
// index clamped from NaN.long(), which depends on the platform: there is
// no exact result to hold the kernel to, and dropped keeps the output
// finite.)
//
// Bound: device-memory bytes (read img and flo once, write out and norm
// once; per corner inside the image the weight and C+1 multiply-adds,
// about 2 flops per byte). The first port of this kernel was held by
// something else: one thread per source pixel issued 4 (C+1) scalar float
// atomics to global memory (12 at C = 2), to three planes 0.9 MB apart,
// and the L2 took them one float at a time.
//
// Design: a block takes a 32x8 tile of source pixels of one batch element
// and gathers its splats in shared memory first.
//  - Each thread computes its integer target (y + r1, x + c1); the block
//    reduces their min and max (warp reductions, then one shared step).
//    The box of targets, one row and column more for the +1 corners,
//    clipped to the image, its columns widened to 16-byte groups, is the
//    block's accumulator of C+1 planes.
//  - Where the box fits the 24 KB buffer ((C+1) * area <= 6144 floats; a
//    tile whose floor(flo) spreads by up to about 20 px still fits at
//    C = 2), the block clears it, adds its 4 (C+1) values per pixel there
//    with shared float atomics (on sm_90 these compile to compare-and-
//    swap loops, ATOMS.CAST.SPIN in the SASS), and after
//    a barrier flushes it with one 16-byte reduction (atomicAdd on
//    float4, sm_90, global memory) per group of four targets and plane,
//    skipping groups that nothing touched (a touched target has a weight
//    sum of at least exp(-2)). A group's lanes outside the box add 0.
//  - Where it does not fit (flows that spread the tile's targets, as
//    i.i.d. noise does), the block adds straight to global memory, one
//    scalar atomic per corner and channel: the exact route for any
//    motion, decided per block in the same launch, not a fallback.
//  - W not a multiple of 4 (or outputs not 16-byte aligned; the launcher
//    checks) flushes with scalar atomics, entry by entry.
//  - 40 registers (__launch_bounds__ with 6 blocks an SM).
//  - With `route_stats` not null, one thread per block adds 1 to
//    route_stats[0] (shared route, empty blocks included) or [1] (global
//    route): for measurement; the hot path passes null.
// What did not pay (python -m demfi_torch.utils.splat_variants, PERF.md):
// other tiles (32x4, 32x16, two or four pixels per thread), larger boxes,
// lane pairs merged before the shared atomics, __match_any_sync
// aggregation in shared or global memory, red.shared, odd rows taking
// their corners in another order, a scalar flush.
// The weights use round-to-nearest intrinsics in the plain version's
// order, and the same expf; only the order of the additions differs from
// the plain version, and it varies from run to run (atomics), so results
// agree with it to rounding, not bitwise.
//
// Guard: with `flag` not null the kernel does its work only where
// *flag != 0, else every block returns at once, before it touches
// anything: the flag is the one that fwarp_shift.cu computed (some |flo|
// lies beyond its window), and the accumulator is the output that its
// launch cleared. The kernel only adds. When it does its work, one thread
// adds 1 to *served (if not null).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kTileX = 32;
constexpr int kRows = 8;                // thread rows of a block
constexpr int kPix = 1;                 // source pixels per thread, kRows apart
constexpr int kTileY = kRows * kPix;
constexpr int kThreads = kTileX * kRows;
constexpr int kWarps = kThreads / 32;
// the shared accumulator (dynamic shared memory): 24 KB a 32x8 tile
constexpr int kBoxFloats = 6144 * kPix;
// blocks an SM must hold: caps a thread at 40 registers; without the cap
// the compiler takes more, fewer blocks fit an SM, and the kernel is
// slower (PERF.md)
constexpr int kMinBlocks = 6;

__global__ void __launch_bounds__(kThreads, kMinBlocks)
fwarp_splat_kernel(const float* __restrict__ img,
                   const float* __restrict__ flo, float* __restrict__ out,
                   float* __restrict__ norm, const int* __restrict__ flag,
                   int* __restrict__ served,
                   unsigned long long* __restrict__ route_stats, int C, int H,
                   int W, int Hs, int r0, int vec) {
  if (flag != nullptr && *flag == 0) return;
  extern __shared__ __align__(16) float box[];   // kBoxFloats
  __shared__ int part[kWarps][4];
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  if (served != nullptr && blockIdx.x == 0 && blockIdx.y == 0 &&
      blockIdx.z == 0 && tid == 0)
    atomicAdd(served, 1);
  const int x = blockIdx.x * kTileX + threadIdx.x;
  const int y0 = blockIdx.y * kTileY + threadIdx.y;
  const int b = blockIdx.z;
  const int hw = H * W;        // an output plane
  const int shw = Hs * W;      // a source plane
  const float* fx = flo + (int64_t)b * 2 * shw;  // along W
  const float* fy = fx + shw;                    // along H

  // per pixel the (0, 0) corner's target; a pixel is live if some corner
  // lies in the image. False for NaN, infinities and huge flows, tested
  // in float before any conversion to int. Threads past the image's edge
  // stay to the barriers, not live.
  bool live[kPix];
  int tr[kPix], tc[kPix];
  float fr[kPix], fc[kPix];
  int rlo = INT_MAX, rhi = INT_MIN, clo = INT_MAX, chi = INT_MIN;
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    const int y = y0 + j * kRows;
    live[j] = false;
    tr[j] = tc[j] = 0;
    fr[j] = fc[j] = 0.0f;
    if (x < W && y < Hs) {
      const float dc = fx[y * W + x];
      const float dr = fy[y * W + x];
      const float c1 = floorf(dc);
      const float r1 = floorf(dr);
      fc[j] = __fsub_rn(dc, c1);
      fr[j] = __fsub_rn(dr, r1);
      const float ftr = __fadd_rn((float)(y + r0), r1);
      const float ftc = __fadd_rn((float)x, c1);
      if (ftr >= -1.0f && ftr < (float)H && ftc >= -1.0f &&
          ftc < (float)W) {
        live[j] = true;
        tr[j] = (int)ftr;
        tc[j] = (int)ftc;
        rlo = min(rlo, tr[j]);
        rhi = max(rhi, tr[j]);
        clo = min(clo, tc[j]);
        chi = max(chi, tc[j]);
      }
    }
  }

  // the block's box of targets
  rlo = __reduce_min_sync(0xffffffffu, rlo);
  rhi = __reduce_max_sync(0xffffffffu, rhi);
  clo = __reduce_min_sync(0xffffffffu, clo);
  chi = __reduce_max_sync(0xffffffffu, chi);
  if ((tid & 31) == 0) {
    part[tid >> 5][0] = rlo;
    part[tid >> 5][1] = rhi;
    part[tid >> 5][2] = clo;
    part[tid >> 5][3] = chi;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    rlo = min(rlo, part[w][0]);
    rhi = max(rhi, part[w][1]);
    clo = min(clo, part[w][2]);
    chi = max(chi, part[w][3]);
  }
  if (rlo == INT_MAX) {   // no pixel of the tile reaches the image
    if (route_stats != nullptr && tid == 0) atomicAdd(route_stats, 1ull);
    return;
  }
  // rows [rb, rb + bh), columns [cb, cb + bw), bw a multiple of 4
  const int rb = max(rlo, 0);
  const int bh = min(rhi + 1, H - 1) - rb + 1;
  const int cb = max(clo, 0) & ~3;
  const int bw = ((min(chi + 1, W - 1) | 3) - cb) + 1;
  const int area = bh * bw;
  const float* src = img + (int64_t)b * C * shw;

  if ((int64_t)(C + 1) * area > kBoxFloats) {
    // the global route: every corner and channel its own atomic
    if (route_stats != nullptr && tid == 0) atomicAdd(route_stats + 1, 1ull);
    float* dst = out + (int64_t)b * C * hw;
    float* nrm = norm + (int64_t)b * hw;
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      if (!live[j]) continue;
      const int p = (y0 + j * kRows) * W + x;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int ddr = k >> 1, ddc = k & 1;
        const int r = tr[j] + ddr, c = tc[j] + ddc;
        if (r < 0 || r >= H || c < 0 || c >= W) continue;
        const float a = __fsub_rn(fr[j], (float)ddr);
        const float d = __fsub_rn(fc[j], (float)ddc);
        const float wgt = expf(-__fadd_rn(__fmul_rn(a, a), __fmul_rn(d, d)));
        const int t = r * W + c;
        for (int ch = 0; ch < C; ++ch)
          atomicAdd(dst + (int64_t)ch * hw + t,
                    __fmul_rn(src[(int64_t)ch * shw + p], wgt));
        atomicAdd(nrm + t, wgt);
      }
    }
    return;
  }

  // the shared route: clear the box, add into it, flush it
  if (route_stats != nullptr && tid == 0) atomicAdd(route_stats, 1ull);
  float4* box4 = reinterpret_cast<float4*>(box);
  const int groups = area >> 2;   // per plane
  for (int i = tid; i < (C + 1) * groups; i += kThreads)
    box4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    if (!live[j]) continue;
    const int p = (y0 + j * kRows) * W + x;
    float wgt[4];
    int slot[4];   // offset in a plane of the box, or -1 outside the image
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int ddr = k >> 1, ddc = k & 1;
      const int r = tr[j] + ddr, c = tc[j] + ddc;
      const float a = __fsub_rn(fr[j], (float)ddr);
      const float d = __fsub_rn(fc[j], (float)ddc);
      wgt[k] = expf(-__fadd_rn(__fmul_rn(a, a), __fmul_rn(d, d)));
      slot[k] = (r < 0 || r >= H || c < 0 || c >= W)
                    ? -1 : (r - rb) * bw + (c - cb);
    }
    for (int ch = 0; ch < C; ++ch) {
      const float v = src[(int64_t)ch * shw + p];
      float* plane = box + ch * area;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (slot[k] >= 0) atomicAdd(plane + slot[k], __fmul_rn(v, wgt[k]));
    }
    float* plane = box + C * area;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (slot[k] >= 0) atomicAdd(plane + slot[k], wgt[k]);
  }
  __syncthreads();

  const int gw = bw >> 2;
  float* dst = out + (int64_t)b * C * hw;
  float* nrm = norm + (int64_t)b * hw;
  for (int g = tid; g < groups; g += kThreads) {
    const float4 n = box4[C * groups + g];
    if (n.x == 0.0f && n.y == 0.0f && n.z == 0.0f && n.w == 0.0f) continue;
    const int gr = g / gw;
    const int col = cb + 4 * (g - gr * gw);
    const int t = (rb + gr) * W + col;
    if (vec) {
      for (int ch = 0; ch < C; ++ch)
        atomicAdd(reinterpret_cast<float4*>(dst + (int64_t)ch * hw + t),
                  box4[ch * groups + g]);
      atomicAdd(reinterpret_cast<float4*>(nrm + t), n);
    } else {
      const float nv[4] = {n.x, n.y, n.z, n.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (nv[e] == 0.0f || col + e >= W) continue;
        for (int ch = 0; ch < C; ++ch)
          atomicAdd(dst + (int64_t)ch * hw + t + e,
                    box[ch * area + 4 * g + e]);
        atomicAdd(nrm + t + e, nv[e]);
      }
    }
  }
}

}  // namespace

// img [B,C,Hs,W], flo [B,2,Hs,W], out [B,C,H,W] and norm [B,1,H,W] zeroed
// by the caller: float32, contiguous, on one device, H*W and Hs*W below
// 2^31; source row y is output row y + r0 (Hs = H and r0 = 0 for a whole
// frame). flag and served: int32 on the device, or null; route_stats: two
// uint64 on the device, or null. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int demfi_fwarp_splat_f32(const float* img, const float* flo,
                                     float* out, float* norm,
                                     const int* flag, int* served,
                                     unsigned long long* route_stats, int B,
                                     int C, int H, int W, int Hs, int r0,
                                     void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Hs <= 0) return (int)cudaSuccess;
  if (C < 0 || (int64_t)H * W > INT32_MAX || (int64_t)Hs * W > INT32_MAX ||
      r0 < 0 || (int64_t)r0 + Hs > H)
    return (int)cudaErrorInvalidValue;
  const int64_t gy = (Hs + kTileY - 1) / kTileY;
  if (B > 65535 || gy > 65535) return (int)cudaErrorInvalidConfiguration;
  const int vec = W % 4 == 0 && (uintptr_t)out % 16 == 0 &&
                  (uintptr_t)norm % 16 == 0;
  constexpr int kShared = kBoxFloats * sizeof(float);
  if (kShared + sizeof(int) * kWarps * 4 > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        fwarp_splat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kShared);
    if (rc != cudaSuccess) return (int)rc;
  }
  const dim3 grid((unsigned)((W + kTileX - 1) / kTileX), (unsigned)gy,
                  (unsigned)B);
  fwarp_splat_kernel<<<grid, dim3(kTileX, kRows), kShared,
                       (cudaStream_t)stream>>>(
      img, flo, out, norm, flag, served, route_stats, C, H, W, Hs, r0, vec);
  return (int)cudaGetLastError();
}
