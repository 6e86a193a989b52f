// Backward of the bilinear zero-padded gather, NCHW, for Hopper (sm_90a):
// float32 or bfloat16 image values, float32 everything else.
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
//   grad_img[b, c, tap_k] += grad_out[b, c, q] * m * w_k     (a scatter)
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
// Row offset (relative mode), as in the forward (bilinear_gather.cu): query
// row y stands for row y + row0 of the image's grid, so (px, py) = (x_q,
// y_q + row0) + coords[b, :, q], the int added before the one float add.
// A card that holds rows [row0, row0 + Hq) of a frame split by rows
// (--mesh_spatial) passes its rows' coordinates and cotangent and the
// whole gathered frame: grad_coords is its rows', grad_img the whole
// frame's (zero-filled by the caller), which the ranks then sum (the
// backward of allgather_rows, demfi_torch/parallel/halo.py). Everything
// after the tap positions works in the image's rows, so the box of a query
// tile sits where its taps do, whatever row0 is. Relative mode needs
// Wq == W and row0 + Hq <= H.
//
// Image values: float32 (demfi_bilinear_gather_bwd_f32) or bfloat16
// (demfi_bilinear_gather_bwd_bf16), as in the forward: a bf16 tap is
// widened to float32 exactly. grad_coords is float32 either way. grad_img
// has the image's type; at bfloat16 the scatter adds into a zero-filled
// float32 scratch plane, and a second launch rounds it to bfloat16 once
// (round to nearest even), so no sum rounds to bfloat16 on the way (the
// JAX package's vjp scatter-adds bfloat16 contributions; this is the
// exacter of the two).
//
// Bound: device-memory bytes (read grad_out, coords and the taps of img
// once, write grad_img and grad_coords once; about 5 flops per byte).
// What held the first design (one thread per query pixel walking all C
// channels, up to four scalar global float atomics per channel onto the
// taps): the atomics, 67 M a float32 train step at about 120 G/s in L2;
// at FGAC (absolute mode on raw flow values) every block's atomics land on
// the same few thousand addresses near the image's origin and serialise.
//
// Design: the scatter goes through a shared-memory box of the block's
// taps, as the forward splat's does (fwarp_splat.cu), kept in fixed point
// so that its adds are native integer atomics.
//  - A block takes a 32x8 tile of query pixels of one batch element of
//    one half. A pixel is live if the mask keeps it and one of its taps
//    lies in the image; its integer tap base is (floor(py), floor(px)).
//    The block reduces the bases' min and max and the largest |grad_out|
//    of its live pixels over all channels (warp reductions, then one
//    shared step). The box is the bases' bounds plus one row and one
//    column, clipped to the image, its columns widened to 16-byte groups.
//    In relative mode it sits near the tile; in absolute mode wherever
//    the tile's coordinates point.
//  - Box route, where the box spans at most kMaxArea taps: the block walks
//    C in chunks of as many channels as the 32 KB box holds. Each value
//    go * m * w_k is scaled by 2^s, with s set by the block's largest
//    |grad_out| so that no sum can overflow, rounded to an integer, and
//    added as two int32 parts (above and below bit kLowBits) into two
//    planes with shared integer atomics, which are single instructions;
//    shared float atomics are compare-and-swap loops on sm_90, and they
//    held an earlier version of this kernel. The integer sums are exact
//    and do not depend on the order of the adds; each value's rounding to
//    a multiple of 2^-s lies some 2^-33 of the largest |grad_out| below a
//    float32 rounding. After a barrier the block flushes the chunk: each
//    tap's sum rounded to float32 once, one 16-byte reduction (atomicAdd
//    on float4, sm_90, global memory) per group of four and channel,
//    all-zero groups skipped, the box cleared behind.
//  - Global route, where the box is larger (taps spread by i.i.d. noise
//    motion), or where grad_out is not finite or its largest |value| is
//    below 2^-60 and not 0 (beyond the scale's float range): the block
//    adds straight to global memory, one scalar float atomic per tap and
//    channel: the exact route for any input, decided per block in the
//    same launch, not a fallback.
//  - W not a multiple of 4 (or grad_img not 16-byte aligned; the launcher
//    checks) flushes with scalar atomics, entry by entry.
//  - Each thread loads the next channel's grad_out and taps before it
//    adds the current one's; 64 registers (kMinBlocks, 4 blocks an SM).
//  - grad_coords is one thread's sum over all channels in channel order,
//    across chunks and on either route, with explicit round-to-nearest
//    multiply-adds: the same bits every run, and between a pair launch
//    and two single launches. grad_img's last bits vary from run to run
//    (the global reductions). int32 offsets inside a plane, as in the
//    forward; the weight arithmetic is the forward's (round-to-nearest
//    intrinsics in the plain version's order), so the mask agrees with
//    the forward's bit for bit.
//  - With `route_stats` not null, one thread per block adds 1 to
//    route_stats[0] (box route, blocks with no live pixel included) or [1]
//    (global route): for measurement; the hot path passes null.
// What did not pay (python -m demfi_torch.utils.gather_variants --bwd,
// PERF.md): shared float atomics in the box (compare-and-swap loops; with
// runs of equal taps summed by warp shuffles first, as FGAC's smooth
// coordinates call for, still slower than the fixed point), a copy of the
// box per warp with plain adds (flushing eight copies cost more than the
// atomics saved), 64-bit shared integer atomics (compare-and-swap loops
// too), a neighbouring lane taking the shared taps of its left neighbour,
// other box sizes and register caps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kTX = 32;
constexpr int kTY = 8;
constexpr int kThreads = kTX * kTY;
constexpr int kWarps = kThreads / 32;
constexpr int kCastThreads = 256;
// blocks an SM must hold: caps a thread at 64 registers (80 without the
// cap, and slower: PERF.md)
constexpr int kMinBlocks = 4;
// the shared box (dynamic shared memory): 32 KB of int32 words
constexpr int kBoxWords = 8192;
// the largest box (taps a channel) that takes the box route
constexpr int kMaxArea = 2048;
// the box's fixed point: a value's low kLowBits bits add in a plane of
// their own
constexpr int kLowBits = 20;
constexpr float kLowScale = (float)(1 << kLowBits);
constexpr float kLowUnit = 1.0f / kLowScale;
// |grad_out| bounds (float bits) outside which a block takes the global
// route: non-finite, or below 2^-60 and not 0 (the scale's float range)
constexpr unsigned kInfBits = 0x7f800000u;
constexpr unsigned kTinyBits = (127u - 60u) << 23;
constexpr unsigned kAll = 0xffffffffu;

// An image value as float32 (bfloat16 is stored as its 16 bits).
__device__ __forceinline__ float tap_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float tap_f32(const uint16_t* p) {
  return __uint_as_float((uint32_t)__ldg(p) << 16);
}

// A live pixel's grad_out and four taps (at their clamped offsets) of
// channel c, loaded a channel ahead of their use.
template <typename T>
struct Channel {
  float go, tap[4];
  __device__ __forceinline__ void load(const float* g, const T* p, int c,
                                       int nq, int hw, const int (&off)[4]) {
    go = __ldg(g + (int64_t)c * nq);
#pragma unroll
    for (int k = 0; k < 4; ++k) tap[k] = tap_f32(p + (int64_t)c * hw + off[k]);
  }
};

// One channel of a live pixel: its four scatter values (go * w_k) and its
// terms of grad_coords (one rounding per operation, the same on either
// route; a tap outside the image adds nothing).
template <typename T>
__device__ __forceinline__ void channel_terms(
    const Channel<T>& ch, const float (&wt)[4], const float (&dwx)[4],
    const float (&dwy)[4], float (&val)[4], float& gcx, float& gcy) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    val[k] = 0.0f;
    if (wt[k] == 0.0f && dwx[k] == 0.0f && dwy[k] == 0.0f) continue;
    const float gt = __fmul_rn(ch.go, ch.tap[k]);
    gcx = __fmaf_rn(gt, dwx[k], gcx);
    gcy = __fmaf_rn(gt, dwy[k], gcy);
    val[k] = __fmul_rn(ch.go, wt[k]);
  }
}

// A tap's box sum (high and low parts at the scale 2^s) as float32: one
// rounding of the exact integer, then an exact power-of-two scaling.
__device__ __forceinline__ float to_float(int hi, int lo, float unscale) {
  return __fmul_rn(__ll2float_rn((long long)hi * (1ll << kLowBits) + lo),
                   unscale);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bilinear_gather_bwd_kernel(const T* __restrict__ img_a,
                           const T* __restrict__ img_b,
                           const float* __restrict__ coords_a,
                           const float* __restrict__ coords_b,
                           const float* __restrict__ gout_a,
                           const float* __restrict__ gout_b,
                           float* __restrict__ grad_img,
                           float* __restrict__ grad_coords,
                           unsigned long long* __restrict__ route_stats,
                           int n, int C, int H, int W, int Hq, int Wq,
                           int relative, int row0, int vec) {
  extern __shared__ __align__(16) int box[];   // kBoxWords
  __shared__ int part[kWarps][5];
  const int tid = threadIdx.y * kTX + threadIdx.x;
  const int lane = tid & 31;
  const int x = blockIdx.x * kTX + threadIdx.x;
  const int y = blockIdx.y * kTY + threadIdx.y;
  // threads past the query grid's edge stay to the reductions and barriers
  const bool in_grid = x < Wq && y < Hq;
  const int zb = blockIdx.z;                 // batch element over both halves
  const bool second = zb >= n;
  const int b = second ? zb - n : zb;
  const T* img = second ? img_b : img_a;
  const float* coords = second ? coords_b : coords_a;
  const float* gout = second ? gout_b : gout_a;
  const int nq = Hq * Wq;
  const int hw = H * W;
  const int q = in_grid ? y * Wq + x : 0;

  float wt[4], dwx[4], dwy[4];
  int off[4];
  bool ok[4];
  bool live = false;
  int ty = 0, tx = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    wt[k] = dwx[k] = dwy[k] = 0.0f;
    off[k] = 0;
    ok[k] = false;
  }
  if (in_grid) {
    float qx = __ldg(coords + (int64_t)b * 2 * nq + q);
    float qy = __ldg(coords + (int64_t)b * 2 * nq + nq + q);
    if (relative) {
      qx = __fadd_rn((float)x, qx);
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
      ok[k] = xi >= 0.0f && xi < (float)W && yi >= 0.0f && yi < (float)H;
      const float v = ok[k] ? 1.0f : 0.0f;
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
    // NaN and far-outside coordinates have no tap inside: never live, so
    // never converted to int below
    live = (!relative || in_img >= 0.999f) &&
           (ok[0] || ok[1] || ok[2] || ok[3]);
    if (live) {
      tx = (int)xf;   // in [-1, W - 1]
      ty = (int)yf;   // in [-1, H - 1]
    }
  }

  const float* g = gout + (int64_t)b * C * nq + q;
  const T* p = img + (int64_t)b * C * hw;

  // the block's box of tap bases, and the bound of its scatter values:
  // the largest |grad_out| of its live pixels over all channels (as bits:
  // NaN and infinities order above every finite value)
  unsigned big = 0u;
  if (live)
    for (int c = 0; c < C; ++c)
      big = max(big, __float_as_uint(__ldg(g + (int64_t)c * nq)) &
                         0x7fffffffu);
  int rlo = __reduce_min_sync(kAll, live ? ty : INT_MAX);
  int rhi = __reduce_max_sync(kAll, live ? ty : INT_MIN);
  int clo = __reduce_min_sync(kAll, live ? tx : INT_MAX);
  int chi = __reduce_max_sync(kAll, live ? tx : INT_MIN);
  big = __reduce_max_sync(kAll, big);
  if (lane == 0) {
    part[tid >> 5][0] = rlo;
    part[tid >> 5][1] = rhi;
    part[tid >> 5][2] = clo;
    part[tid >> 5][3] = chi;
    part[tid >> 5][4] = (int)big;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    rlo = min(rlo, part[w][0]);
    rhi = max(rhi, part[w][1]);
    clo = min(clo, part[w][2]);
    chi = max(chi, part[w][3]);
    big = max(big, (unsigned)part[w][4]);
  }
  float* gi = grad_img + (int64_t)zb * C * hw;
  float* gc = grad_coords + (int64_t)zb * 2 * nq + q;
  float gcx = 0.0f, gcy = 0.0f;

  // rows [rb, rb + bh), columns [cb, cb + bw), bw a multiple of 4; an
  // empty box (no live pixel) when rlo == INT_MAX
  const bool empty = rlo == INT_MAX;
  const int rb = max(rlo, 0);
  const int bh = empty ? 0 : min(rhi + 1, H - 1) - rb + 1;
  const int cb = max(clo, 0) & ~3;
  const int bw = empty ? 0 : ((min(chi + 1, W - 1) | 3) - cb) + 1;
  const int area = bh * bw;

  if (area > kMaxArea || big >= kInfBits || (big != 0u && big < kTinyBits)) {
    // the global route: one float atomic per tap and channel, straight to
    // global memory
    if (route_stats != nullptr && tid == 0) atomicAdd(route_stats + 1, 1ull);
    Channel<T> next;
    if (live && C > 0) next.load(g, p, 0, nq, hw, off);
    for (int c = 0; live && c < C; ++c) {
      const Channel<T> cur = next;
      if (c + 1 < C) next.load(g, p, c + 1, nq, hw, off);
      float val[4];
      channel_terms(cur, wt, dwx, dwy, val, gcx, gcy);
      float* gic = gi + (int64_t)c * hw;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (ok[k] && val[k] != 0.0f) atomicAdd(gic + off[k], val[k]);
    }
    if (in_grid) {
      gc[0] = gcx;
      gc[nq] = gcy;
    }
    return;
  }

  // the box route
  if (route_stats != nullptr && tid == 0) atomicAdd(route_stats, 1ull);
  if (empty) {
    if (in_grid) {
      gc[0] = 0.0f;
      gc[nq] = 0.0f;
    }
    return;
  }
  // Fixed point: with 2^(e-1) <= big < 2^e, a tap's sum over the block is
  // below 256 * 2^e = 2^(e+8) (a pixel adds at most |grad_out| to one
  // tap), so at the scale 2^s, s = 42 - e, it is below 2^50 in magnitude:
  // its part above the low kLowBits bits fits an int32, as does the sum of
  // at most 256 low parts. Each value rounds to a multiple of 2^-s, far
  // below a float32 rounding of the sum; the integer sums are exact.
  const int s = 42 - (big == 0u ? 0 : (int)(big >> 23) - 126);
  const float scale = __uint_as_float((unsigned)(s + 127) << 23);
  const float unscale = __uint_as_float((unsigned)(127 - s) << 23);
  int slot[4];   // a tap's offset in a plane of the box, or -1 outside
#pragma unroll
  for (int k = 0; k < 4; ++k)
    slot[k] = live && ok[k]
                  ? (ty + (k >> 1) - rb) * bw + (tx + (k & 1) - cb) : -1;
  const int groups = area >> 2;   // int4 groups a plane
  const int gw = bw >> 2;
  // a channel takes two planes: the high parts, then the low ones
  const int cc = min(C, kBoxWords / (2 * area));   // channels a chunk
  int4* box4 = reinterpret_cast<int4*>(box);
  for (int i = tid; i < 2 * cc * groups; i += kThreads)
    box4[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  Channel<T> next;
  if (live && C > 0) next.load(g, p, 0, nq, hw, off);
  for (int c0 = 0; c0 < C; c0 += cc) {
    const int nc = min(cc, C - c0);
    for (int ch = 0; live && ch < nc; ++ch) {
      const int c = c0 + ch;
      const Channel<T> cur = next;
      if (c + 1 < C) next.load(g, p, c + 1, nq, hw, off);
      float val[4];
      channel_terms(cur, wt, dwx, dwy, val, gcx, gcy);
      int* hi_plane = box + 2 * ch * area;
      int* lo_plane = hi_plane + area;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (slot[k] < 0 || val[k] == 0.0f) continue;
        // exact: a power-of-two scale, then integers below 2^50
        const float v = rintf(__fmul_rn(val[k], scale));
        const float hi = floorf(__fmul_rn(v, kLowUnit));
        const float lo = __fsub_rn(v, __fmul_rn(hi, kLowScale));
        atomicAdd(hi_plane + slot[k], __float2int_rz(hi));
        if (lo != 0.0f) atomicAdd(lo_plane + slot[k], __float2int_rz(lo));
      }
    }
    __syncthreads();
    // flush the chunk: one float per tap, one rounding of its exact sum,
    // one 16-byte reduction per group of four and channel; the box is
    // cleared behind
    for (int i = tid; i < nc * groups; i += kThreads) {
      const int ch = i / groups;
      const int gg = i - ch * groups;
      const int hi_at = 2 * ch * groups + gg;
      const int4 h = box4[hi_at];
      const int4 l = box4[hi_at + groups];
      if ((h.x | h.y | h.z | h.w | l.x | l.y | l.z | l.w) == 0) continue;
      box4[hi_at] = make_int4(0, 0, 0, 0);
      box4[hi_at + groups] = make_int4(0, 0, 0, 0);
      const float4 v = make_float4(to_float(h.x, l.x, unscale),
                                   to_float(h.y, l.y, unscale),
                                   to_float(h.z, l.z, unscale),
                                   to_float(h.w, l.w, unscale));
      const int gr = gg / gw;
      const int col = cb + 4 * (gg - gr * gw);
      float* dst = gi + (int64_t)(c0 + ch) * hw + (rb + gr) * W + col;
      if (vec) {
        atomicAdd(reinterpret_cast<float4*>(dst), v);
      } else {
        const float ve[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (ve[e] != 0.0f && col + e < W) atomicAdd(dst + e, ve[e]);
      }
    }
    __syncthreads();
  }
  if (in_grid) {
    gc[0] = gcx;
    gc[nq] = gcy;
  }
}

// grad_img's float32 sums rounded to bfloat16, once: four consecutive
// elements a thread, with one 16-byte load and one 8-byte store where
// `vec` (both buffers so aligned) and all four lie below n.
__global__ void __launch_bounds__(kCastThreads)
round_to_bf16_kernel(const float* __restrict__ src,
                     __nv_bfloat16* __restrict__ dst, int64_t n, int vec) {
  const int64_t i = 4 * ((int64_t)blockIdx.x * kCastThreads + threadIdx.x);
  if (i >= n) return;
  if (vec && i + 3 < n) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(src + i));
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    __stcs(reinterpret_cast<uint2*>(dst + i),
           make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                      *reinterpret_cast<const unsigned*>(&hi)));
    return;
  }
  for (int64_t j = i; j < i + 4 && j < n; ++j)
    dst[j] = __float2bfloat16_rn(src[j]);
}

// The vjp of one gather of one or two halves. img_a [n,C,H,W], coords_a
// [n,2,Hq,Wq] and gout_a [n,C,Hq,Wq]; img_b, coords_b, gout_b: the second
// half of the same shapes, or all null. grad_acc [halves*n,C,H,W] float32,
// zeroed by the caller, takes the scatter; grad_coords [halves*n,2,Hq,Wq],
// written in full; route_stats: two uint64 on the device, or null; row0:
// the image row of query row 0 (relative mode; 0 for a whole frame and in
// absolute mode). The image T, the rest float32; all contiguous, on one
// device; H*W and Hq*Wq below 2^31. Launches on `stream` and returns
// cudaGetLastError().
template <typename T>
int launch_gather_bwd(const T* img_a, const T* img_b, const float* coords_a,
                      const float* coords_b, const float* gout_a,
                      const float* gout_b, float* grad_acc,
                      float* grad_coords, unsigned long long* route_stats,
                      int n, int C, int H, int W, int Hq, int Wq,
                      int relative, int row0, cudaStream_t stream) {
  const bool pair = img_b != nullptr;
  if (pair != (coords_b != nullptr) || pair != (gout_b != nullptr) ||
      H <= 0 || W <= 0 || C < 0 || (int64_t)H * W > INT32_MAX ||
      (int64_t)Hq * Wq > INT32_MAX || row0 < 0 || (!relative && row0 != 0) ||
      (relative && (Wq != W || (int64_t)row0 + Hq > H)))
    return (int)cudaErrorInvalidValue;
  const int64_t batch = (int64_t)n * (pair ? 2 : 1);
  const int64_t gy = (Hq + kTY - 1) / kTY;
  if (gy > 65535 || batch > 65535) return (int)cudaErrorInvalidConfiguration;
  const int vec = W % 4 == 0 && (uintptr_t)grad_acc % 16 == 0;
  constexpr int kShared = kBoxWords * sizeof(int);
  if (kShared + sizeof(int) * kWarps * 5 > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        bilinear_gather_bwd_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kShared);
    if (rc != cudaSuccess) return (int)rc;
  }
  const dim3 grid((unsigned)((Wq + kTX - 1) / kTX), (unsigned)gy,
                  (unsigned)batch);
  bilinear_gather_bwd_kernel<T><<<grid, dim3(kTX, kTY), kShared, stream>>>(
      img_a, img_b, coords_a, coords_b, gout_a, gout_b, grad_acc,
      grad_coords, route_stats, n, C, H, W, Hq, Wq, relative, row0, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// float32 image values: grad_img [halves*n,C,H,W] float32, zeroed by the
// caller, takes the scatter directly.
extern "C" int demfi_bilinear_gather_bwd_f32(
    const float* img_a, const float* img_b, const float* coords_a,
    const float* coords_b, const float* gout_a, const float* gout_b,
    float* grad_img, float* grad_coords, unsigned long long* route_stats,
    int n, int C, int H, int W, int Hq, int Wq, int relative, int row0,
    void* stream) {
  if (n <= 0 || Hq <= 0 || Wq <= 0) return (int)cudaSuccess;
  return launch_gather_bwd(img_a, img_b, coords_a, coords_b, gout_a, gout_b,
                           grad_img, grad_coords, route_stats, n, C, H, W,
                           Hq, Wq, relative, row0, (cudaStream_t)stream);
}

// bfloat16 image values (their 16 bits): the scatter adds into grad_acc
// [halves*n,C,H,W] float32, zeroed by the caller, and a second launch
// writes it to grad_img [halves*n,C,H,W] bfloat16.
extern "C" int demfi_bilinear_gather_bwd_bf16(
    const uint16_t* img_a, const uint16_t* img_b, const float* coords_a,
    const float* coords_b, const float* gout_a, const float* gout_b,
    float* grad_acc, void* grad_img, float* grad_coords,
    unsigned long long* route_stats, int n, int C, int H, int W, int Hq,
    int Wq, int relative, int row0, void* stream) {
  if (n <= 0 || Hq <= 0 || Wq <= 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const int rc = launch_gather_bwd(img_a, img_b, coords_a, coords_b, gout_a,
                                   gout_b, grad_acc, grad_coords, route_stats,
                                   n, C, H, W, Hq, Wq, relative, row0, s);
  if (rc != (int)cudaSuccess) return rc;
  const int64_t total = (int64_t)n * (img_b != nullptr ? 2 : 1) * C * H * W;
  if (total == 0) return (int)cudaSuccess;
  const int64_t blocks = (total + 4 * kCastThreads - 1) / (4 * kCastThreads);
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidConfiguration;
  const int vec = (uintptr_t)grad_acc % 16 == 0 && (uintptr_t)grad_img % 8 == 0;
  round_to_bf16_kernel<<<(unsigned)blocks, kCastThreads, 0, s>>>(
      grad_acc, (__nv_bfloat16*)grad_img, total, vec);
  return (int)cudaGetLastError();
}
