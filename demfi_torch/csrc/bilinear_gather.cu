// Bilinear zero-padded gather, NCHW, for Hopper (sm_90a): float32 or
// bfloat16 image values, float32 coordinates, weights, accumulation and
// output.
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
//   relative mode multiplies out by (in_img >= 0.999), in_img being the
//   sum of the w_tap (the sample of an all-ones image), in float32, and
//   writes in_img to ones[b, 0, q] where the caller asks for that plane.
//   The output grid (Hq, Wq) follows coords, not the image: FGAC at
//   rr > 0 samples a (3H, 3W) query grid.
// Row offset (relative mode): query row y stands for row y + row0 of the
// image's grid, so (px, py) = (x_q, y_q + row0) + coords[b, :, q]. A
// card that holds rows [row0, row0 + Hq) of a frame split by rows
// (--mesh_spatial) warps its rows out of the whole source frame with it:
// the int row is converted and added once, as in the unsplit call, so the
// result is the unsplit call's rows bit for bit. (Absolute coordinates
// formed by the caller would give the same bits, but absolute mode has no
// 0.999 mask and returns no in-image weight: the offset keeps one mode
// for both.) Relative mode needs Wq == W and row0 + Hq <= H.
// A call may consist of two halves (bwarp_pair: both directions' warps):
// two image and two coordinate pointers of n batch elements each, written
// to one output of 2n batch elements, so that the caller concatenates
// nothing.
//
// Image values: float32 (demfi_bilinear_gather_f32) or bfloat16
// (demfi_bilinear_gather_bf16, the bf16 model's feature and image warps),
// a template parameter of the kernel. A bf16 tap is a 2-byte load widened
// to float32 exactly (its bits shifted into the high half); everything
// after the load is the float32 kernel's, so the in-image weight, the
// 0.999 mask, `ones` and `out` stay float32 whatever the image's type (the
// JAX package's _bilinear_zeros casts each tap to float32 the same way).
//
// Bound: device-memory bytes. It does about 2 flops per byte it must
// move (read img and coords once, write out once), far below the card's
// ~20 flops/byte balance point for float32. At the small shapes of the
// main path (C = 3; B = 1) the old kernel was held by its per-thread
// set-up and by too few bytes in flight instead.
//
// Design:
//  - a 2-D grid over the query grid, a block of 32 x 4 threads, each
//    thread kPX = 2 query pixels of one row, 32 apart (pixel j of lane l
//    is x = x_block + 32 j + l). So a warp instruction still loads and
//    stores 32 neighbouring floats (one full 128-byte line per store, and
//    taps that coalesce where the flow is smooth), while a thread has two
//    pixels' independent loads in flight and pays the block/row index
//    arithmetic once. x and y come from blockIdx/threadIdx: no division.
//    (Pixels next to each other in one thread, stored as one 16-byte
//    vector, measured 25 % slower at every shape: the lanes' taps then
//    lie 4 floats apart and each load touches four times the lines.);
//  - offsets inside one H x W plane are int32 (the wrapper refuses planes
//    of 2^31 elements or more); the batch and channel base is added to
//    the pointers in 64 bits once, outside the loops;
//  - channels in compile-time tiles: C <= 4 is one fully unrolled tile
//    (every load of the thread started before the first use), wider C
//    walks tiles of 2 channels with a one-channel tail. blockIdx.z walks
//    (batch element, chunk of 8 channels): measured, 8 beat 16 and all
//    of C in one block at B = 14 as at B = 1 (more, smaller blocks; the
//    weights recomputed per chunk cost less than the longer last wave);
//  - out is written with streaming stores (__stcs): a 58-807 MB output
//    should not push the image out of the 50 MB L2. The image and the
//    coordinates are read with __ldg;
//  - the ones plane is written only if its pointer is not null.
// The weight, in-image-weight and accumulation arithmetic uses
// round-to-nearest intrinsics in the plain version's order (no FMA
// contraction), so the 0.999 mask is bit-identical to the plain
// version's. Exact for any motion: there is no motion window.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTX = 32;     // lanes along x
constexpr int kTY = 4;      // rows of a block
constexpr int kPX = 2;      // query pixels of a thread, kTX apart
constexpr int kWideTile = 2;   // channels per tile where C > 4
constexpr int kChunk = 8;      // channels per block where C > 4

// An image value as float32: bfloat16 is stored as its 16 bits, the high
// half of the float32 with the same value.
__device__ __forceinline__ float tap_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float tap_f32(const uint16_t* p) {
  return __uint_as_float((uint32_t)__ldg(p) << 16);
}

// The four taps of kPX pixels, CT channels: out = sum of img * weight in
// the plain version's order, times the mask.
template <int CT, typename T>
__device__ __forceinline__ void gather_tile(
    const T* __restrict__ p, float* __restrict__ dst, int hw, int nq,
    const int (&off)[kPX][4], const float (&wt)[kPX][4],
    const float (&mask)[kPX], const bool (&live)[kPX], int relative) {
  float v[CT][kPX];
#pragma unroll
  for (int k = 0; k < CT; ++k) {
    const T* pk = p + (int64_t)k * hw;
#pragma unroll
    for (int j = 0; j < kPX; ++j) {
      float t = __fmul_rn(tap_f32(pk + off[j][0]), wt[j][0]);
      t = __fadd_rn(t, __fmul_rn(tap_f32(pk + off[j][1]), wt[j][1]));
      t = __fadd_rn(t, __fmul_rn(tap_f32(pk + off[j][2]), wt[j][2]));
      t = __fadd_rn(t, __fmul_rn(tap_f32(pk + off[j][3]), wt[j][3]));
      if (relative) t = __fmul_rn(t, mask[j]);
      v[k][j] = t;
    }
  }
#pragma unroll
  for (int k = 0; k < CT; ++k) {
    float* dk = dst + (int64_t)k * nq;
#pragma unroll
    for (int j = 0; j < kPX; ++j)
      if (live[j]) __stcs(dk + j * kTX, v[k][j]);
  }
}

// CT: channels per tile; T: the image's element type (float, or uint16_t
// holding bfloat16). The block's chunk of channels is [c_lo, c_hi),
// c_lo = (blockIdx.z % chunks) * cpb.
template <int CT, typename T>
__global__ void __launch_bounds__(kTX * kTY)
bilinear_gather_kernel(const T* __restrict__ img_a,
                       const T* __restrict__ img_b,
                       const float* __restrict__ coords_a,
                       const float* __restrict__ coords_b,
                       float* __restrict__ out, float* __restrict__ ones,
                       int n, int C, int H, int W, int Hq, int Wq, int cpb,
                       int chunks, int relative, int row0) {
  const int y = blockIdx.y * kTY + threadIdx.y;
  const int x0 = blockIdx.x * (kTX * kPX) + threadIdx.x;
  if (y >= Hq || x0 >= Wq) return;
  const int zb = blockIdx.z / chunks;        // batch element of the output
  const int c_lo = (blockIdx.z - zb * chunks) * cpb;
  const int c_hi = min(C, c_lo + cpb);
  const bool second = zb >= n;               // the pair's second half
  const int b = second ? zb - n : zb;
  const T* img = second ? img_b : img_a;
  const float* coords = second ? coords_b : coords_a;
  const int nq = Hq * Wq;
  const int hw = H * W;
  const int q0 = y * Wq + x0;
  const float* cx = coords + (int64_t)b * 2 * nq + q0;
  const float* cy = cx + nq;

  bool live[kPX];
  float px[kPX], py[kPX];
#pragma unroll
  for (int j = 0; j < kPX; ++j) {
    live[j] = x0 + j * kTX < Wq;
    // a pixel beyond the row's end computes on (0, 0) and stores nothing
    px[j] = live[j] ? __ldg(cx + j * kTX) : 0.0f;
    py[j] = live[j] ? __ldg(cy + j * kTX) : 0.0f;
  }

  float wt[kPX][4];
  int off[kPX][4];
  float mask[kPX], in_img[kPX];
#pragma unroll
  for (int j = 0; j < kPX; ++j) {
    float qx = px[j], qy = py[j];
    if (relative) {
      qx = __fadd_rn((float)(x0 + j * kTX), qx);
      qy = __fadd_rn((float)(y + row0), qy);
    }
    const float xf = floorf(qx);
    const float yf = floorf(qy);
    const float fx = __fsub_rn(qx, xf);
    const float fy = __fsub_rn(qy, yf);
    const float gx = __fsub_rn(1.0f, fx);
    const float gy = __fsub_rn(1.0f, fy);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int dy = k >> 1, dx = k & 1;
      const float xi = xf + (float)dx;
      const float yi = yf + (float)dy;
      const bool valid = xi >= 0.0f && xi < (float)W && yi >= 0.0f &&
                         yi < (float)H;
      wt[j][k] = __fmul_rn(__fmul_rn(dx ? fx : gx, dy ? fy : gy),
                           valid ? 1.0f : 0.0f);
      // out-of-image taps read a clamped in-image pixel with weight 0
      // (fmaxf maps NaN to 0), as the plain version does
      const int xc = (int)fminf(fmaxf(xi, 0.0f), (float)(W - 1));
      const int yc = (int)fminf(fmaxf(yi, 0.0f), (float)(H - 1));
      off[j][k] = yc * W + xc;
    }
    in_img[j] = __fadd_rn(
        __fadd_rn(__fadd_rn(wt[j][0], wt[j][1]), wt[j][2]), wt[j][3]);
    mask[j] = (!relative || in_img[j] >= 0.999f) ? 1.0f : 0.0f;
  }

  const T* p = img + ((int64_t)b * C + c_lo) * hw;
  float* dst = out + ((int64_t)zb * C + c_lo) * nq + q0;
  int c = c_lo;
  for (; c + CT <= c_hi; c += CT) {
    gather_tile<CT, T>(p, dst, hw, nq, off, wt, mask, live, relative);
    p += (int64_t)CT * hw;
    dst += (int64_t)CT * nq;
  }
  for (; c < c_hi; ++c) {
    gather_tile<1, T>(p, dst, hw, nq, off, wt, mask, live, relative);
    p += hw;
    dst += nq;
  }
  if (ones != nullptr && c_lo == 0) {
    float* o = ones + (int64_t)zb * nq + q0;
#pragma unroll
    for (int j = 0; j < kPX; ++j)
      if (live[j]) __stcs(o + j * kTX, in_img[j]);
  }
}

// One gather of one or two halves. img_a [n,C,H,W] with coords_a
// [n,2,Hq,Wq]; img_b, coords_b: the second half of the same shapes, or
// both null. out [halves*n,C,Hq,Wq]; ones [halves*n,1,Hq,Wq] or null
// (relative mode only: the in-image weight plane). The image T, the rest
// float32; all contiguous, on one device; H*W and Hq*Wq below 2^31.
// row0: the image row of query row 0 (relative mode; 0 for a whole
// frame). Launches on `stream` and returns cudaGetLastError().
template <typename T>
int launch_gather(const T* img_a, const T* img_b, const float* coords_a,
                  const float* coords_b, float* out, float* ones, int n,
                  int C, int H, int W, int Hq, int Wq, int relative,
                  int row0, void* stream) {
  if (n <= 0 || Hq <= 0 || Wq <= 0) return (int)cudaSuccess;
  if ((img_b == nullptr) != (coords_b == nullptr) || H <= 0 || W <= 0 ||
      (int64_t)H * W > INT32_MAX || (int64_t)Hq * Wq > INT32_MAX ||
      row0 < 0 || (relative && (Wq != W || (int64_t)row0 + Hq > H)))
    return (int)cudaErrorInvalidValue;
  const int64_t batch = (int64_t)n * (img_b != nullptr ? 2 : 1);
  const int64_t gx = (Wq + kTX * kPX - 1) / (kTX * kPX);
  const int64_t gy = (Hq + kTY - 1) / kTY;
  const int cpb = C > 4 ? kChunk : (C > 0 ? C : 1);   // channels per block
  const int chunks = C > 0 ? (C + cpb - 1) / cpb : 1;
  const int64_t gz = batch * chunks;
  if (gy > 65535 || gz > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)gx, (unsigned)gy, (unsigned)gz);
  const dim3 block(kTX, kTY);
  const cudaStream_t s = (cudaStream_t)stream;
#define DEMFI_GATHER(CT)                                                     \
  bilinear_gather_kernel<CT, T><<<grid, block, 0, s>>>(                      \
      img_a, img_b, coords_a, coords_b, out, ones, n, C, H, W, Hq, Wq, cpb,  \
      chunks, relative, row0)
  switch (C) {
    case 1: DEMFI_GATHER(1); break;
    case 2: DEMFI_GATHER(2); break;
    case 3: DEMFI_GATHER(3); break;
    case 4: DEMFI_GATHER(4); break;
    default: DEMFI_GATHER(kWideTile); break;
  }
#undef DEMFI_GATHER
  return (int)cudaGetLastError();
}

}  // namespace

// float32 image values.
extern "C" int demfi_bilinear_gather_f32(
    const float* img_a, const float* img_b, const float* coords_a,
    const float* coords_b, float* out, float* ones, int n, int C, int H,
    int W, int Hq, int Wq, int relative, int row0, void* stream) {
  return launch_gather(img_a, img_b, coords_a, coords_b, out, ones, n, C, H,
                       W, Hq, Wq, relative, row0, stream);
}

// bfloat16 image values (their 16 bits), float32 everything else.
extern "C" int demfi_bilinear_gather_bf16(
    const uint16_t* img_a, const uint16_t* img_b, const float* coords_a,
    const float* coords_b, float* out, float* ones, int n, int C, int H,
    int W, int Hq, int Wq, int relative, int row0, void* stream) {
  return launch_gather(img_a, img_b, coords_a, coords_b, out, ones, n, C, H,
                       W, Hq, Wq, relative, row0, stream);
}
