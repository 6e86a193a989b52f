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
// per source pixel). This algorithm pays more: an output pixel must find,
// among the (2D+2)^2 source pixels of its window (324 at D = 8, 4,356 at
// D = 32), the about four whose splat reaches it. That search is the
// price of a fixed summation order without atomics, and it keeps the
// kernel above the byte bound; the design makes each test cheap, skips
// most of them and keeps the warp together on the matches.
//
// Design: one thread per output pixel, a 32x16 tile per block.
//  - The block first loads its (16 + 2D + 1) x (32 + 2D + 1) source
//    window once, coalesced, into dynamic shared memory as one int32 per
//    source pixel: floor(flo_y) * 65536 + floor(flo_x). A source pixel
//    outside the image, with a non-finite flow or with a floor outside
//    [-D-1, D+1] can reach no pixel of the window and gets a sentinel
//    that no tap matches. 7 KB at D = 8, 32 KB at D = 32; the largest
//    window whose tile fits a block's 227 KB is D = 107, and a larger D
//    is refused (cudaErrorInvalidValue).
//  - The tap test is one shared-memory load, one subtraction and one
//    mask: with key = dy * 65536 + dx, key - word is (dy - r1) * 65536 +
//    (dx - c1), and the tap matches iff that is 0, 1, 65536 or 65537,
//    that is iff (key - word) & ~0x10001 == 0. The lanes of a warp read
//    consecutive words (no bank conflicts). No bounds test, no 64-bit
//    index and no floorf is left in the loop.
//  - Whole source rows, and most columns of the others, are skipped. A
//    warp is 32 neighbouring output pixels of one row, and for one dy all
//    its taps lie in one row of the tile. The warp that loads a tile row
//    reduces (__reduce_min/max_sync) the range of r1 and of c1 over the
//    row's words and leaves them beside the tile. A row whose r1 range
//    misses {dy - 1, dy} is skipped for the whole warp with one 16-byte
//    shared load; of the others only dx in [min c1, max c1 + 1] is
//    walked. On flows that vary slowly along a row that leaves two or
//    three of the 2D + 2 rows and a few of their 2D + 2 columns. (Testing
//    the row's words for each dy with __any_sync skipped the same rows
//    and was 1.2-1.9x slower.)
//  - Only a matching tap touches global memory: it reads flo again for
//    the fractional parts and forms the two expf weights and the C+1
//    products. The lanes of a warp match at different taps, so a thread
//    keeps a match pending and the warp adds its pending matches together
//    (see the kernel): 1.3x faster than adding each where it is found.
//  - The window is walked in a fixed order, dy outer and dx inner, and
//    every term is added with round-to-nearest intrinsics and no FMA
//    contraction, in the plain version's order: a skipped or non-matching
//    tap adds nothing, so the sum's order, and every bit of the result,
//    is fixed whatever the grid, and there are no atomics. Channels are
//    taken four at a time (one pass for CFR's C = 2). D is a run-time
//    argument.
//  - With `row_stats` not null every warp adds the rows it had to
//    consider and the rows it skipped to row_stats[0] and [1] (for
//    measurement; the hot path passes null).
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
constexpr int kTileY = 16;
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

// the word of a source pixel that no tap can match: r1 = 16384
constexpr int kNoMatch = 0x40000000;
constexpr int kMaxSharedBytes = 232448;   // 227 KB, a block's most on sm_90

// an empty range of a tile row: no dy and no dx lies inside it
constexpr int kEmptyLo = 32767, kEmptyHi = -32768;

__host__ __device__ inline int tile_w(int D) { return kTileX + 2 * D + 1; }
__host__ __device__ inline int tile_h(int D) { return kTileY + 2 * D + 1; }
// the rows' int4 ranges follow the tile's words, 16-byte aligned
__host__ __device__ inline int range_offset(int D) {
  return (tile_h(D) * tile_w(D) + 3) & ~3;
}
__host__ __device__ inline int64_t shared_bytes(int D) {
  return (int64_t)range_offset(D) * sizeof(int) +
         (int64_t)tile_h(D) * sizeof(int4);
}

__global__ void __launch_bounds__(kTileX * kTileY)
fwarp_shift_kernel(const float* __restrict__ img,
                   const float* __restrict__ flo, float* __restrict__ out,
                   float* __restrict__ norm, const int* __restrict__ flag,
                   int* __restrict__ served,
                   unsigned long long* __restrict__ row_stats, int C, int H,
                   int W, int D, int chunks) {
  // [tile_h(D)][tile_w(D)] target words, then tile_h(D) row ranges
  extern __shared__ __align__(16) int tile[];
  const int bx0 = blockIdx.x * kTileX;
  const int by0 = blockIdx.y * kTileY;
  const int x = bx0 + threadIdx.x;
  const int y = by0 + threadIdx.y;
  const int b = blockIdx.z / chunks;
  const int c0 = (blockIdx.z - b * chunks) * kChunk;
  const int nc = min(kChunk, C - c0);
  const int hw = H * W;
  const bool inside = x < W && y < H;
  float* dst = out + ((int64_t)b * C + c0) * hw + (y * W + x);
  float* dst_n = norm + (int64_t)b * hw + (y * W + x);
  if (flag != nullptr && *flag != 0) {   // the splat's call: clear for it
    if (!inside) return;
    for (int c = 0; c < nc; ++c) dst[(int64_t)c * hw] = 0.0f;
    if (c0 == 0) *dst_n = 0.0f;
    return;
  }
  if (served != nullptr && blockIdx.x == 0 && blockIdx.y == 0 &&
      blockIdx.z == 0 && threadIdx.x == 0 && threadIdx.y == 0)
    atomicAdd(served, 1);
  const float* fx = flo + (int64_t)b * 2 * hw;   // along W
  const float* fy = fx + hw;                     // along H
  const float* src = img + ((int64_t)b * C + c0) * hw;

  // the tile: local (ly, lx) is source pixel (by0 - D - 1 + ly,
  // bx0 - D - 1 + lx). A warp loads whole tile rows and leaves each
  // row's range of r1 and of c1 (over the words that can match) behind.
  const int tw = tile_w(D), th = tile_h(D);
  int4* range = reinterpret_cast<int4*>(tile + range_offset(D));
  const float reach = (float)(D + 1);
  for (int ly = threadIdx.y; ly < th; ly += kTileY) {
    const int sy = by0 - D - 1 + ly;
    int r_lo = kEmptyLo, r_hi = kEmptyHi, c_lo = kEmptyLo, c_hi = kEmptyHi;
    for (int lx = threadIdx.x; lx < tw; lx += kTileX) {
      const int sx = bx0 - D - 1 + lx;
      int word = kNoMatch;
      if (sy >= 0 && sy < H && sx >= 0 && sx < W) {
        const float r1 = floorf(fy[sy * W + sx]);
        const float c1 = floorf(fx[sy * W + sx]);
        // false for NaN and infinities too
        if (r1 >= -reach && r1 <= reach && c1 >= -reach && c1 <= reach) {
          const int ri = (int)r1, ci = (int)c1;
          word = ri * 65536 + ci;
          r_lo = min(r_lo, ri);
          r_hi = max(r_hi, ri);
          c_lo = min(c_lo, ci);
          c_hi = max(c_hi, ci);
        }
      }
      tile[ly * tw + lx] = word;
    }
    r_lo = __reduce_min_sync(0xffffffffu, r_lo);
    r_hi = __reduce_max_sync(0xffffffffu, r_hi);
    c_lo = __reduce_min_sync(0xffffffffu, c_lo);
    c_hi = __reduce_max_sync(0xffffffffu, c_hi);
    if (threadIdx.x == 0) range[ly] = make_int4(r_lo, r_hi, c_lo, c_hi);
  }
  __syncthreads();

  float acc[kChunk] = {0.0f, 0.0f, 0.0f, 0.0f};
  float acc_n = 0.0f;
  unsigned skipped = 0;
  // A matching tap costs some 60 operations and the lanes of a warp
  // match at different taps, so a thread does not add a match where it
  // finds it: it keeps one pending (source pixel and which of the two
  // buckets matched), and the warp adds all its pending matches together
  // when some lane finds its next one. Each thread still adds its own
  // matches in the order it found them.
  int pend_p = -1, pend_diff = 0;
  auto add_pending = [&]() {
    if (pend_p < 0) return;
    const float dr = fy[pend_p];
    const float dc = fx[pend_p];
    float a = __fsub_rn(dr, floorf(dr));
    float d = __fsub_rn(dc, floorf(dc));
    if (pend_diff & 0x10000) a = __fsub_rn(a, 1.0f);   // r1 == dy - 1
    if (pend_diff & 1) d = __fsub_rn(d, 1.0f);         // c1 == dx - 1
    const float my = expf(-__fmul_rn(a, a));
    const float mx = expf(-__fmul_rn(d, d));
    const float wgt = __fmul_rn(my, mx);
    for (int c = 0; c < nc; ++c)
      acc[c] = __fadd_rn(acc[c],
                         __fmul_rn(src[(int64_t)c * hw + pend_p], wgt));
    acc_n = __fadd_rn(acc_n, wgt);
    pend_p = -1;
  };
  // tap (dy, dx) of this thread is tile word (ty - dy, tx - dx); the taps
  // of the warp's 32 threads for one dy span exactly tile row ty - dy
  const int ty = threadIdx.y + D + 1;
  const int tx = threadIdx.x + D + 1;
  for (int dy = -D; dy <= D + 1; ++dy) {
    // a source pixel splats into row dy iff r1 is dy or dy - 1, and into
    // column dx iff c1 is dx or dx - 1: outside the row's ranges nothing
    // can match, for any thread of the warp
    const int4 rg = range[ty - dy];
    if (dy < rg.x || dy - 1 > rg.y) {
      ++skipped;
      continue;
    }
    const int dx_lo = max(-D, rg.z), dx_hi = min(D + 1, rg.w + 1);
    const int* row = tile + (ty - dy) * tw;
    const int sy = y - dy;
    int key = dy * 65536 + dx_lo;
#pragma unroll 2
    for (int dx = dx_lo; dx <= dx_hi; ++dx, ++key) {
      const int diff = key - row[tx - dx];
      const bool match = (diff & ~0x10001) == 0;
      if (__any_sync(0xffffffffu, match && pend_p >= 0)) add_pending();
      if (match) {
        pend_p = sy * W + (x - dx);
        pend_diff = diff;
      }
    }
  }
  add_pending();
  if (row_stats != nullptr && threadIdx.x == 0) {
    atomicAdd(row_stats, (unsigned long long)(2 * D + 2));
    atomicAdd(row_stats + 1, (unsigned long long)skipped);
  }
  if (!inside) return;
  for (int c = 0; c < nc; ++c) dst[(int64_t)c * hw] = acc[c];
  if (c0 == 0) *dst_n = acc_n;
}

}  // namespace

// img [B,C,H,W], flo [B,2,H,W], out [B,C,H,W], norm [B,1,H,W]: float32,
// contiguous, on one device, H*W below 2^31. Every element of out and
// norm is written: the stencil sum, or 0 where `flag` is given and comes
// out 1. flag (one int32 on the device, written here), served (int32 on
// the device) and row_stats (two uint64 on the device): or null. 1 <= D <=
// 107, the largest window whose tile fits shared memory. Launches on
// `stream` and returns the first CUDA error.
extern "C" int demfi_fwarp_shift_f32(const float* img, const float* flo,
                                     float* out, float* norm, int* flag,
                                     int* served,
                                     unsigned long long* row_stats, int B,
                                     int C, int H, int W, int D,
                                     void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0) return (int)cudaSuccess;
  if (D < 1 || (int64_t)H * W > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int64_t shared = shared_bytes(D);
  if (shared > kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  if (shared > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        fwarp_shift_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shared);
    if (rc != cudaSuccess) return (int)rc;
  }
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
  fwarp_shift_kernel<<<grid, block, (size_t)shared, (cudaStream_t)stream>>>(
      img, flo, out, norm, flag, served, row_stats, C, H, W, D, chunks);
  return (int)cudaGetLastError();
}
