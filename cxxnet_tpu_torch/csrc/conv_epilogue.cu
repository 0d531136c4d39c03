// conv_epilogue for NVIDIA Hopper (sm_90a): the per-channel epilogue of
// a convolution,
//
//     out[i] = cast_out(relu?(float(x[i]) * scale[c] + shift[c])),
//     c = i mod C,
//
// over a contiguous NHWC or (N, C) tensor; x is float32, bfloat16 or
// int32, out float32 or bfloat16, scale and shift float32 (C,).
//
// Replaces the TPU Pallas kernel cxxnet_tpu/layers/pallas_kernels.py:
// 327-364 (_conv_epilogue_kernel / _conv_epilogue_call), both of its
// input kinds. On the float32 and bfloat16 serve paths it applies the
// batch-norm fold (running-stats scale and shift, plus the fused relu)
// to every conv output. On the int8 serve path x is the int32
// accumulator of the int8 convolution and scale the per-channel
// dequant (activation scale times weight scale, the batch-norm factor
// already folded into the quantized weight).
//
// What bounds it: bytes. Each element is read once and written once and
// costs two flops, so the kernel is memory bound at any size (0.25
// flop/byte in f32, far below the roughly 20 flop/byte at which the
// card's f32 units become the limit). The design therefore only moves
// bytes efficiently:
//   - a grid-stride loop over 4-element vectors: 16-byte loads and
//     stores for float32 (8-byte for bfloat16), neighbouring threads
//     on neighbouring addresses, when C % 4 == 0 and every pointer is
//     aligned; a scalar loop otherwise;
//   - scale and shift through the read-only cache (__ldg), one float4
//     each per vector;
//   - the channel index carried incrementally across the grid stride,
//     so the loop does one 64-bit division per thread, not per element;
//   - the multiply and the add rounded separately (__fmul_rn,
//     __fadd_rn), the same two roundings as the plain PyTorch version,
//     so the two agree bit for bit;
//   - an int32 accumulator converts with __int2float_rn, round to
//     nearest even, as torch's .to(float32) and XLA's convert do:
//     accumulators here exceed 2^24 (|acc| <= 2304 * 127^2), where a
//     truncating conversion would differ. It loads as one 16-byte int4
//     per 4 elements.
// No TMA and no fusion into the convolution: that is later work.
//
// Plain C interface, loaded with ctypes. The launch goes on the caller's
// stream; the return value is cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int32_t v) {
  return __int2float_rn(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <bool kRelu>
__device__ __forceinline__ float apply(float x, float s, float t) {
  float y = __fadd_rn(__fmul_rn(x, s), t);
  if (kRelu) y = (y < 0.0f) ? 0.0f : y;   // NaN passes, as in torch.relu
  return y;
}

__device__ __forceinline__ void load4(const float* p, int64_t v,
                                      float (&a)[4]) {
  const float4 q = reinterpret_cast<const float4*>(p)[v];
  a[0] = q.x; a[1] = q.y; a[2] = q.z; a[3] = q.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, int64_t v,
                                      float (&a)[4]) {
  const uint2 q = reinterpret_cast<const uint2*>(p)[v];
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.y));
  a[0] = lo.x; a[1] = lo.y; a[2] = hi.x; a[3] = hi.y;
}

__device__ __forceinline__ void load4(const int32_t* p, int64_t v,
                                      float (&a)[4]) {
  const int4 q = reinterpret_cast<const int4*>(p)[v];
  a[0] = __int2float_rn(q.x); a[1] = __int2float_rn(q.y);
  a[2] = __int2float_rn(q.z); a[3] = __int2float_rn(q.w);
}

__device__ __forceinline__ void store4(float* p, int64_t v,
                                       const float (&a)[4]) {
  reinterpret_cast<float4*>(p)[v] = make_float4(a[0], a[1], a[2], a[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, int64_t v,
                                       const float (&a)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a[0], a[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(a[2], a[3]);
  uint2 q;
  q.x = *reinterpret_cast<uint32_t*>(&lo);
  q.y = *reinterpret_cast<uint32_t*>(&hi);
  reinterpret_cast<uint2*>(p)[v] = q;
}

// n4 vectors of 4 elements; C = 4 * c4 channels.
template <typename TIn, typename TOut, bool kRelu>
__global__ void __launch_bounds__(kThreads)
epilogue_vec4(const TIn* __restrict__ x, const float* __restrict__ scale,
              const float* __restrict__ shift, TOut* __restrict__ y,
              int64_t n4, int c4) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int step = static_cast<int>(stride % c4);
  int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int cv = static_cast<int>(v % c4);
  const float4* s4 = reinterpret_cast<const float4*>(scale);
  const float4* t4 = reinterpret_cast<const float4*>(shift);
  for (; v < n4; v += stride) {
    const float4 s = __ldg(s4 + cv);
    const float4 t = __ldg(t4 + cv);
    float a[4];
    load4(x, v, a);
    a[0] = apply<kRelu>(a[0], s.x, t.x);
    a[1] = apply<kRelu>(a[1], s.y, t.y);
    a[2] = apply<kRelu>(a[2], s.z, t.z);
    a[3] = apply<kRelu>(a[3], s.w, t.w);
    store4(y, v, a);
    cv += step;
    if (cv >= c4) cv -= c4;
  }
}

template <typename TIn, typename TOut, bool kRelu>
__global__ void __launch_bounds__(kThreads)
epilogue_scalar(const TIn* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ shift, TOut* __restrict__ y,
                int64_t n, int c) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int step = static_cast<int>(stride % c);
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int ci = static_cast<int>(i % c);
  for (; i < n; i += stride) {
    y[i] = from_f32<TOut>(
        apply<kRelu>(to_f32(x[i]), __ldg(scale + ci), __ldg(shift + ci)));
    ci += step;
    if (ci >= c) ci -= c;
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 1;
  }
  return count;
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

template <typename TIn, typename TOut, bool kRelu>
void launch(const void* x, const float* scale, const float* shift, void* y,
            int64_t n, int c, cudaStream_t stream) {
  const bool vec = (c % 4 == 0) && aligned(x, 4 * sizeof(TIn)) &&
                   aligned(y, 4 * sizeof(TOut)) && aligned(scale, 16) &&
                   aligned(shift, 16);
  const int64_t work = vec ? n / 4 : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sm_count()) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  if (vec) {
    epilogue_vec4<TIn, TOut, kRelu>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
            static_cast<const TIn*>(x), scale, shift, static_cast<TOut*>(y),
            work, c / 4);
  } else {
    epilogue_scalar<TIn, TOut, kRelu>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
            static_cast<const TIn*>(x), scale, shift, static_cast<TOut*>(y),
            work, c);
  }
}

template <typename TIn, typename TOut>
void launch_relu(const void* x, const float* scale, const float* shift,
                 void* y, int64_t n, int c, int relu, cudaStream_t stream) {
  if (relu) {
    launch<TIn, TOut, true>(x, scale, shift, y, n, c, stream);
  } else {
    launch<TIn, TOut, false>(x, scale, shift, y, n, c, stream);
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int32 (input only). n
// elements, c channels (n % c == 0). Returns a cudaError_t value; 0 is
// success.
extern "C" int cxn_conv_epilogue(const void* x, const void* scale,
                                 const void* shift, void* y, long long n,
                                 int c, int in_dtype, int out_dtype,
                                 int relu, void* stream) {
  if (n <= 0 || c <= 0 || n % c != 0 || in_dtype < 0 || in_dtype > 2 ||
      out_dtype < 0 || out_dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  const int64_t nn = static_cast<int64_t>(n);
  if (in_dtype == 0 && out_dtype == 0) {
    launch_relu<float, float>(x, sc, sh, y, nn, c, relu, s);
  } else if (in_dtype == 0 && out_dtype == 1) {
    launch_relu<float, __nv_bfloat16>(x, sc, sh, y, nn, c, relu, s);
  } else if (in_dtype == 1 && out_dtype == 0) {
    launch_relu<__nv_bfloat16, float>(x, sc, sh, y, nn, c, relu, s);
  } else if (in_dtype == 1) {
    launch_relu<__nv_bfloat16, __nv_bfloat16>(x, sc, sh, y, nn, c, relu, s);
  } else if (out_dtype == 0) {
    launch_relu<int32_t, float>(x, sc, sh, y, nn, c, relu, s);
  } else {
    launch_relu<int32_t, __nv_bfloat16>(x, sc, sh, y, nn, c, relu, s);
  }
  return static_cast<int>(cudaGetLastError());
}
