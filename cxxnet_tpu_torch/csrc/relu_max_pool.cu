// relu_max_pool for NVIDIA Hopper (sm_90a): a relu fused into a k x k,
// stride-1, VALID max pool over an NHWC float32 or bfloat16 tensor, and
// its backward.
//
// Forward (cxn_relu_max_pool_fwd), x (B, H, W, C) -> y (B, OH, OW, C),
// OH = H - k + 1, OW = W - k + 1, r = max(x, 0):
//
//     y[b,i,j,c] = max over (di, dj) in k x k of r[b, i+di, j+dj, c]
//
// taken in the order (0,0), then di outer and dj inner, with NaN
// propagated as torch.maximum / jnp.maximum propagate it (fmaxf drops
// NaN, so it is not used).
//
// Backward (cxn_relu_max_pool_bwd), from x, y and the cotangent dy:
//
//     acc[b,i,j,c] = sum over di (outer), dj (inner) with (i-di, j-dj)
//                    inside the output, of dy[b, i-di, j-dj, c] where
//                    r[b,i,j,c] == y[b, i-di, j-dj, c]      (f32, from 0)
//     dx[b,i,j,c]  = x[b,i,j,c] > 0 ? acc[b,i,j,c] : 0
//
// In bfloat16 every value converts exactly to f32, so the forward's
// maxima (taken in f32) are the bf16 maxima, and the backward compares
// and accumulates in f32 and rounds dx to bf16 once, as the reference's
// kernel does (its compares run in f32).
//
// Every tied maximum is credited (the reference cxxnet's unpool), not
// only the first as F.max_pool2d's and XLA's select-and-scatter
// backwards credit it.
//
// Replaces the TPU Pallas kernels cxxnet_tpu/layers/pallas_kernels.py:
// _relu_pool_fwd_kernel (:91, called by _relu_pool_call_fwd :141-153)
// and _relu_pool_bwd_kernel (:107, called by _relu_pool_call_bwd
// :170-189), with the custom VJP at :212-233. The Pallas kernels take one
// batch item per grid step and chunk H with a k-1 halo so that a block
// fits the TPU's 16 MB of VMEM; a CUDA grid has no such limit, so
// neither the per-item blocking nor the chunking is carried over.
//
// What bounds it: bytes. The forward reads x once and writes y (8 bytes
// a pair of float32 elements, 4 in bf16; k*k compares per output); the
// backward reads x, y and dy and writes dx (16 bytes, 8 in bf16; k*k
// compares and adds per input element): far below the ~20 flop/byte at
// which the f32 units would be the limit. The design:
//   - one thread per output (forward) or input (backward) element, or
//     per 4 channels (a 16-byte load in float32, 8-byte in bf16) when
//     C % 4 == 0 (64/128/256 on kaiming's path) and the pointers allow
//     it; a scalar kernel otherwise. A grid-stride loop covers any
//     size; offsets are 64-bit (the stem's x at batch 128 holds 97.3 M
//     elements);
//   - the k*k re-reads of neighbouring windows hit L1/L2; no shared
//     memory tiling (later work);
//   - the backward is a gather over inputs, not a scatter over outputs:
//     each input element walks the windows that cover it in the
//     reference's order and sums in a register, so there are no float
//     atomics, dx repeats bit for bit from run to run, and it equals a
//     plain version that adds in the same (di, dj) order;
//   - dy is read through its four strides (the gradient handed back by
//     the next convolution may be a permuted view), never copied.
//
// Plain C interface, loaded with ctypes. Launches go on the caller's
// stream; each entry returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 16;

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

unsigned grid_for(int64_t work) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sm_count()) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned>(blocks);
}

// max(v, 0) with NaN kept, as torch.maximum(x, 0)
__device__ __forceinline__ float relu_nan(float v) {
  return (v > 0.0f || v != v) ? v : 0.0f;
}

// torch.maximum(m, a): NaN if either is NaN
__device__ __forceinline__ float max_nan(float m, float a) {
  return (a > m || a != a) ? a : m;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// V consecutive channels of a T tensor as floats: V = 4 (one 16-byte
// float4 or 8-byte bf16 load) or 1. A bf16 store rounds to nearest
// even (exact for a maximum, one rounding for the backward's sum).
template <int V>
struct Vec {
  float v[V];
  __device__ __forceinline__ void load(const float* p) {
    if constexpr (V == 4) {
      const float4 q = *reinterpret_cast<const float4*>(p);
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
      v[0] = *p;
    }
  }
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    if constexpr (V == 4) {
      const uint2 q = *reinterpret_cast<const uint2*>(p);
      const float2 lo = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&q.x));
      const float2 hi = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&q.y));
      v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
    } else {
      v[0] = __bfloat162float(*p);
    }
  }
  __device__ __forceinline__ void store(float* p) const {
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      *p = v[0];
    }
  }
  __device__ __forceinline__ void store(__nv_bfloat16* p) const {
    if constexpr (V == 4) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
      __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
      uint2 q;
      q.x = *reinterpret_cast<uint32_t*>(&lo);
      q.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(p) = q;
    } else {
      *p = __float2bfloat16_rn(v[0]);
    }
  }
};

// ---------------------------------------------------------------- forward

// one thread per V channels of one output pixel; n = B*OH*OW*(C/V)
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
cxn_relu_max_pool_fwd_k(const T* __restrict__ x, T* __restrict__ y,
                        int64_t n, int h, int w, int c, int k) {
  const int oh = h - k + 1;
  const int ow = w - k + 1;
  const int cv = c / V;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < n; t += stride) {
    int64_t q = t;
    const int ch = static_cast<int>(q % cv) * V;
    q /= cv;
    const int j = static_cast<int>(q % ow);
    q /= ow;
    const int i = static_cast<int>(q % oh);
    const int64_t b = q / oh;
    const T* xp = x + ((b * h + i) * w + j) * c + ch;
    Vec<V> m;
    m.load(xp);
#pragma unroll
    for (int l = 0; l < V; ++l) m.v[l] = relu_nan(m.v[l]);
    for (int di = 0; di < k; ++di) {
      for (int dj = 0; dj < k; ++dj) {
        if (di == 0 && dj == 0) continue;
        Vec<V> a;
        a.load(xp + (static_cast<int64_t>(di) * w + dj) * c);
#pragma unroll
        for (int l = 0; l < V; ++l) m.v[l] = max_nan(m.v[l], relu_nan(a.v[l]));
      }
    }
    m.store(y + t * V);
  }
}

// --------------------------------------------------------------- backward

// one thread per V channels of one input pixel; n = B*H*W*(C/V). y is
// dense NHWC; dy has element strides (sb, sh, sw, sc), sc == 1 when V == 4.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
cxn_relu_max_pool_bwd_k(const T* __restrict__ x, const T* __restrict__ y,
                        const T* __restrict__ dy, T* __restrict__ dx,
                        int64_t n, int h, int w, int c, int k, int64_t sb,
                        int64_t sh, int64_t sw, int64_t sc) {
  const int oh = h - k + 1;
  const int ow = w - k + 1;
  const int cv = c / V;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < n; t += stride) {
    int64_t q = t;
    const int ch = static_cast<int>(q % cv) * V;
    q /= cv;
    const int j = static_cast<int>(q % w);
    q /= w;
    const int i = static_cast<int>(q % h);
    const int64_t b = q / h;
    Vec<V> xv;
    xv.load(x + t * V);
    float r[V];
    float acc[V];
#pragma unroll
    for (int l = 0; l < V; ++l) {
      r[l] = relu_nan(xv.v[l]);
      acc[l] = 0.0f;
    }
    for (int di = 0; di < k; ++di) {
      const int oi = i - di;
      if (oi < 0 || oi >= oh) continue;
      for (int dj = 0; dj < k; ++dj) {
        const int oj = j - dj;
        if (oj < 0 || oj >= ow) continue;
        Vec<V> yv;
        yv.load(y + ((b * oh + oi) * ow + oj) * c + ch);
        const T* dp = dy + b * sb + oi * sh + oj * sw;
        if constexpr (V == 4) {
          Vec<V> g;
          g.load(dp + ch);
#pragma unroll
          for (int l = 0; l < V; ++l) {
            if (r[l] == yv.v[l]) acc[l] += g.v[l];
          }
        } else {
#pragma unroll
          for (int l = 0; l < V; ++l) {
            if (r[l] == yv.v[l]) acc[l] += to_f32(dp[(ch + l) * sc]);
          }
        }
      }
    }
    Vec<V> out;
#pragma unroll
    for (int l = 0; l < V; ++l) out.v[l] = (xv.v[l] > 0.0f) ? acc[l] : 0.0f;
    out.store(dx + t * V);
  }
}

template <typename T>
void fwd_typed(const void* x, void* y, int b, int h, int w, int c, int k,
               cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const int64_t outs = static_cast<int64_t>(b) * (h - k + 1) * (w - k + 1);
  const uintptr_t va = 4 * sizeof(T);
  if (c % 4 == 0 && aligned(x, va) && aligned(y, va)) {
    const int64_t n = outs * (c / 4);
    cxn_relu_max_pool_fwd_k<T, 4><<<grid_for(n), kThreads, 0, s>>>(
        xt, yt, n, h, w, c, k);
  } else {
    const int64_t n = outs * c;
    cxn_relu_max_pool_fwd_k<T, 1><<<grid_for(n), kThreads, 0, s>>>(
        xt, yt, n, h, w, c, k);
  }
}

template <typename T>
void bwd_typed(const void* x, const void* y, const void* dy, void* dx, int b,
               int h, int w, int c, int k, int64_t db, int64_t dh, int64_t dw,
               int64_t dc, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  const T* dt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  const int64_t ins = static_cast<int64_t>(b) * h * w;
  const uintptr_t va = 4 * sizeof(T);
  const bool vec = c % 4 == 0 && dc == 1 && db % 4 == 0 && dh % 4 == 0 &&
                   dw % 4 == 0 && aligned(x, va) && aligned(y, va) &&
                   aligned(dy, va) && aligned(dx, va);
  if (vec) {
    const int64_t n = ins * (c / 4);
    cxn_relu_max_pool_bwd_k<T, 4><<<grid_for(n), kThreads, 0, s>>>(
        xt, yt, dt, dxt, n, h, w, c, k, db, dh, dw, dc);
  } else {
    const int64_t n = ins * c;
    cxn_relu_max_pool_bwd_k<T, 1><<<grid_for(n), kThreads, 0, s>>>(
        xt, yt, dt, dxt, n, h, w, c, k, db, dh, dw, dc);
  }
}

}  // namespace

// x: contiguous (b, h, w, c); y: contiguous (b, h-k+1, w-k+1, c); both
// float32 (dtype 0) or bfloat16 (dtype 1). Returns a cudaError_t value;
// 0 is success.
extern "C" int cxn_relu_max_pool_fwd(const void* x, void* y, int b, int h,
                                     int w, int c, int k, int dtype,
                                     void* stream) {
  if (b <= 0 || c <= 0 || k < 1 || h < k || w < k ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    fwd_typed<float>(x, y, b, h, w, c, k, s);
  } else {
    fwd_typed<__nv_bfloat16>(x, y, b, h, w, c, k, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, dx: contiguous (b, h, w, c); y: contiguous (b, h-k+1, w-k+1, c); dy:
// y's shape read through its element strides (db, dh, dw, dc), each >= 0;
// all of one dtype, float32 (0) or bfloat16 (1). Returns a cudaError_t
// value; 0 is success.
extern "C" int cxn_relu_max_pool_bwd(const void* x, const void* y,
                                     const void* dy, void* dx, int b, int h,
                                     int w, int c, int k, long long db,
                                     long long dh, long long dw, long long dc,
                                     int dtype, void* stream) {
  if (b <= 0 || c <= 0 || k < 1 || h < k || w < k || db < 0 || dh < 0 ||
      dw < 0 || dc < 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    bwd_typed<float>(x, y, dy, dx, b, h, w, c, k, db, dh, dw, dc, s);
  } else {
    bwd_typed<__nv_bfloat16>(x, y, dy, dx, b, h, w, c, k, db, dh, dw, dc, s);
  }
  return static_cast<int>(cudaGetLastError());
}
