// The epilogue of a bfloat16 convolution, in place, on a dense
// channels_last (NHWC) output, for Hopper (sm_90a): its bias add and the
// one elementwise step the model applies right after it, a ReLU or a
// residual add.
//
// No TPU kernel: the JAX model leaves the bias add to flax's nn.Conv and
// the ReLU and residual adds to XLA, which fuses them itself. On the card
// the port's bfloat16 model took them as separate PyTorch ops: the
// broadcast bias add (generic, offset-computing elementwise_kernel, about
// 46 % of the card's memory rate), then F.relu or the residual add, each
// reading and writing the whole tensor again. Plain PyTorch version:
// conv_epilogue_plain in demfi_torch/ops/kernels.py.
//
// What it computes, per element e of y [N, C, H, W] held as NHWC (channel
// c = e mod C), the same operations in the same order as the separate ops
// (bf16_rn: round to nearest even, what c10::BFloat16(float) does on
// sm_80 and later):
//   b = bf16_rn(bias[c])                       (bias.to(bfloat16))
//   v = bf16_rn(float(y[e]) + float(b))        (y + b[:, None, None])
//   relu:     v = isnan(v) ? v : bf16_rn(fmaxf(float(v), 0))   (F.relu, as
//             ATen's clamp_min kernel computes it)
//   residual: v = bf16_rn(float(r[e]) + float(v))              (r + y)
//   y[e] = v
// The convolution itself rounds to bfloat16 before (cuDNN), so the output
// keeps both roundings of the JAX model's bfloat16 convolution (the
// convolution's, then the bias add's). The bias comes as the float32
// parameter and is rounded here, which spares the separate cast launch.
//
// Bound: device-memory bytes. One read of y, one of r where given, one
// write of y; a few operations per element.
//
// Design: a grid-stride pass over the flat NHWC tensor, 16-byte loads and
// stores of 8 bfloat16 values (the innermost axis is C), at most 8 blocks
// of 256 threads per SM, so that one wave covers the card and every
// thread has a 16-byte load (32 bytes with a residual) in flight each
// iteration. Each block stages the rounded bias in shared memory once. A
// thread's channel index is taken from its first offset with one modulo
// and then advanced by the stride's channel step (no division in the
// loop). Where C is a multiple of 8 a vector's 8 channels are contiguous
// in shared memory (two 16-byte shared loads); otherwise (C = 1, 5, 9, 35,
// 133 in the model) the index wraps element by element. The last n mod 8
// elements go one by one. y and r must be 16-byte aligned
// (kernels.conv_epilogue_takes refuses others: the model's outputs and
// residuals are whole tensors or batch slices of them).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kVec = 8;       // bfloat16 values in 16 bytes
// the largest C whose float32 bias fits the 48 KB of shared memory a block
// has without opting in to more (kernels.EPILOGUE_MAX_C)
constexpr int kMaxC = 48 * 1024 / 4;

enum Mode { kBias = 0, kRelu = 1, kResidual = 2 };

template <int kMode>
__device__ __forceinline__ __nv_bfloat16 epilogue(__nv_bfloat16 y, float b,
                                                  __nv_bfloat16 r) {
  __nv_bfloat16 v = __float2bfloat16_rn(__bfloat162float(y) + b);
  if (kMode == kRelu) {
    const float f = __bfloat162float(v);
    return f != f ? v : __float2bfloat16_rn(fmaxf(f, 0.0f));   // NaN: v
  }
  if (kMode == kResidual)
    return __float2bfloat16_rn(__bfloat162float(r) + __bfloat162float(v));
  return v;
}

// kVecC8: C a multiple of 8 (a vector's 8 channels contiguous)
template <int kMode, bool kVecC8>
__global__ void __launch_bounds__(kThreads)
conv_epilogue_kernel(__nv_bfloat16* __restrict__ y,
                     const float* __restrict__ bias,
                     const __nv_bfloat16* __restrict__ r, int64_t n, int C) {
  extern __shared__ float s_bias[];
  for (int c = threadIdx.x; c < C; c += blockDim.x)
    s_bias[c] = __bfloat162float(__float2bfloat16_rn(bias[c]));
  __syncthreads();

  const int64_t stride = (int64_t)gridDim.x * blockDim.x * kVec;
  int64_t e = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * kVec;
  int ch = (int)(e % C);
  const int dch = (int)(stride % C);
  const int64_t n_body = n - n % kVec;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);

  for (; e < n_body; e += stride) {
    uint4 yv = *reinterpret_cast<const uint4*>(y + e);
    uint4 rv = yv;
    if (kMode == kResidual) rv = *reinterpret_cast<const uint4*>(r + e);
    __nv_bfloat16* ye = reinterpret_cast<__nv_bfloat16*>(&yv);
    const __nv_bfloat16* re = reinterpret_cast<const __nv_bfloat16*>(&rv);
    if (kVecC8) {
      const float4 b0 = *reinterpret_cast<const float4*>(s_bias + ch);
      const float4 b1 = *reinterpret_cast<const float4*>(s_bias + ch + 4);
      const float b[kVec] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        ye[k] = epilogue<kMode>(ye[k], b[k], re[k]);
    } else {
      int cc = ch;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        ye[k] = epilogue<kMode>(ye[k], s_bias[cc], re[k]);
        if (++cc == C) cc = 0;
      }
    }
    *reinterpret_cast<uint4*>(y + e) = yv;
    ch += dch;
    if (ch >= C) ch -= C;
  }
  if (blockIdx.x == 0) {                // the last n mod 8 elements
    const int64_t t = n_body + threadIdx.x;
    if (t < n)
      y[t] = epilogue<kMode>(y[t], s_bias[(int)(t % C)],
                             kMode == kResidual ? r[t] : zero);
  }
}

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0 &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 132;
  return count[dev];
}

template <int kMode>
cudaError_t launch(__nv_bfloat16* y, const float* bias,
                   const __nv_bfloat16* r, int64_t n, int C,
                   cudaStream_t st) {
  const int64_t per_block = (int64_t)kVec * kThreads;
  const int64_t want = (n + per_block - 1) / per_block;
  const int64_t cap = (int64_t)sm_count() * kBlocksPerSm;
  const unsigned grid = (unsigned)(want < cap ? (want > 0 ? want : 1) : cap);
  const size_t smem = (size_t)C * sizeof(float);
  if (C % kVec == 0)
    conv_epilogue_kernel<kMode, true><<<grid, kThreads, smem, st>>>(
        y, bias, r, n, C);
  else
    conv_epilogue_kernel<kMode, false><<<grid, kThreads, smem, st>>>(
        y, bias, r, n, C);
  return cudaGetLastError();
}

}  // namespace

// y: bfloat16 [n / C, C] (an NHWC tensor), updated in place; bias: float32
// [C]; r: bfloat16 like y, or null; relu: 0 or 1 (not with r). y and r
// 16-byte aligned.
extern "C" int demfi_conv_epilogue_bf16(void* y, const void* bias,
                                        const void* r, long long n, int C,
                                        int relu, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (C <= 0 || C > kMaxC || n % C != 0 || (relu && r != nullptr) ||
      (uintptr_t)y % 16 != 0 || (uintptr_t)r % 16 != 0)
    return (int)cudaErrorInvalidValue;
  auto* yb = static_cast<__nv_bfloat16*>(y);
  auto* b = static_cast<const float*>(bias);
  auto* rb = static_cast<const __nv_bfloat16*>(r);
  cudaStream_t st = (cudaStream_t)stream;
  if (r != nullptr) return (int)launch<kResidual>(yb, b, rb, n, C, st);
  if (relu) return (int)launch<kRelu>(yb, b, nullptr, n, C, st);
  return (int)launch<kBias>(yb, b, nullptr, n, C, st);
}
