// bn_apply for NVIDIA Hopper (sm_90a): the folded batch-norm epilogue
// of the training forward and its backward, on float32 or bfloat16
// activations (scale and shift are float32 either way).
//
// Forward (cxn_bn_apply_fwd), per channel c = i mod C of a contiguous
// NHWC or (N, C) tensor:
//
//     y[i] = relu?(x[i] * scale[c] + shift[c])
//
// Backward (cxn_bn_apply_bwd), over the (rows, C) view of the same
// tensors, rows = N*H*W:
//
//     dym[r,c]  = relu ? (y[r,c] > 0 ? dy[r,c] : 0) : dy[r,c]
//     dx[r,c]   = dym[r,c] * scale[c] + 0
//     dscale[c] = sum_r dym[r,c] * x[r,c]        (f32)
//     dshift[c] = sum_r dym[r,c]                 (f32)
//
// The arithmetic is the activation dtype's, as the reference's kernel
// applies scale and shift "in the block's compute dtype": in float32
// the multiply and the add are rounded separately (__fmul_rn,
// __fadd_rn), as PyTorch rounds them. In bfloat16, scale and shift are
// first rounded to bf16, and every multiply and add is rounded to bf16
// (the f32 result of two bf16 operands, then one round to nearest
// even), as PyTorch's and XLA's bf16 tensor ops round them:
//
//     y   = relu?(bf16(bf16(x * bf16(s)) + bf16(t)))
//     dx  = bf16(bf16(dym * bf16(s)) + 0)
//     dscale = sum_r f32(bf16(dym * x)),  dshift = sum_r f32(dym)
//
// So the kernel and its plain version agree bit for bit in both dtypes
// (the two channel sums only up to their order).
//
// Replaces the TPU Pallas kernel cxxnet_tpu/layers/pallas_kernels.py:
// 247-291 (_bn_apply_kernel / _bn_apply_call) and its VJP :294-322. The
// reference's VJP runs the forward kernel again for dx (shift 0) and
// leaves the two channel sums to XLA; here the backward is ONE pass
// that reads x, y and dy once and writes dx, with the sums reduced on
// the way. At float32 it does not depend on how scale and shift were
// made, so conv_epilogue's float32 VJP (pallas_kernels.py:367-400) can
// call it as is.
//
// conv_epilogue's VJP on bfloat16 (cxn_conv_epilogue_bwd; the
// reference's _conv_epilogue_vjp_bwd, pallas_kernels.py:388-398) is the
// same pass with two differences: x and dx may be of another dtype than
// y and dy ((x, y) in {(bf16, bf16), (f32, bf16), (bf16, f32)}), and
// the arithmetic is float32 whatever the dtypes, since the reference
// computes dx with the f32 epilogue kernel and the sums from f32 casts:
//
//     dym = y > 0 ? dy : 0            (y and dy in y's dtype)
//     dx  = round_to_x_dtype(f32(dym) * scale + 0)      (one rounding)
//     dscale = sum_r f32(dym) * f32(x),  dshift = sum_r f32(dym)  (f32)
//
// One template serves both: the activation types of x and of y, and
// the rounding policy (Arith<T> for bn_apply, Arith<float> here).
//
// What bounds it: bytes. The forward reads x and writes y (8 bytes a
// float32 element, 4 a bfloat16 one, and 2 flops); the backward reads
// x, y, dy and writes dx (16 or 8 bytes and 5 flops an element). Both
// sit far below the ~20 flop/byte at which the card's f32 units become
// the limit. The design:
//   - forward: conv_epilogue's grid-stride loop over 4-element
//     vectors (16-byte loads in float32, 8-byte in bf16; scalar when
//     C % 4 != 0), scale and shift through the read-only cache;
//   - backward (cxn_bn_bwd): one launch. A host-side plan
//     (kernels.bn_bwd_plan) picks the vector width V (8 channels in
//     bf16, 4 in float32: 16-byte loads in both; x and y of two dtypes
//     take 4; V = 1 for the rest),
//     a block of ct channel vectors times rpi row groups (up to 256
//     threads), so that every thread owns a (row group, channel
//     vector) pair and whole warps where the channel count allows, and
//     the number of row blocks from bytes: about 1024 resident threads
//     an SM, few enough that the f32 partial rows stay within 5 % of
//     the layer's traffic. Each thread keeps one channel vector fixed
//     and walks its rows four at a time, all twelve loads issued
//     before the first use, with its two partial sums in registers;
//     the block adds its threads' sums by a fixed tree in shared
//     memory and writes one partial row; the last block of each group
//     of row blocks adds the group's rows in order, and the last group
//     the group rows, told apart by arrival counters (after
//     __threadfence) in a persistent per-device buffer that the
//     finishing blocks reset. No float atomics and no second launch:
//     the sums repeat bit for bit from run to run;
//   - dy may be a row-strided view (ld_dy >= C): the gradient that a
//     channel concat hands back is a slice of a wider tensor, read in
//     place instead of copied.
// No TMA and no fusion into the neighbouring convolutions: later work.
//
// Plain C interface, loaded with ctypes. Launches go on the caller's
// stream; each entry returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

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

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The rounding of one tensor op in the activation dtype T.
template <typename T>
struct Arith;
template <>
struct Arith<float> {
  static __device__ __forceinline__ float coef(float s) { return s; }
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
};
template <>
struct Arith<__nv_bfloat16> {
  static __device__ __forceinline__ float coef(float s) {
    return round_bf16(s);
  }
  static __device__ __forceinline__ float mul(float a, float b) {
    return round_bf16(__fmul_rn(a, b));
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return round_bf16(__fadd_rn(a, b));
  }
};

// s and t already through Arith<T>::coef
template <typename T, bool kRelu>
__device__ __forceinline__ float apply(float x, float s, float t) {
  float y = Arith<T>::add(Arith<T>::mul(x, s), t);
  if (kRelu) y = (y < 0.0f) ? 0.0f : y;   // NaN passes, as in torch.relu
  return y;
}

// V consecutive elements of a T tensor as floats (V = 4 or 1)
template <int V>
__device__ __forceinline__ void loadv(const float* p, float (&a)[V]) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    a[0] = q.x; a[1] = q.y; a[2] = q.z; a[3] = q.w;
  } else {
    a[0] = *p;
  }
}
template <int V>
__device__ __forceinline__ void loadv(const __nv_bfloat16* p, float (&a)[V]) {
  if constexpr (V == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&q.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&q.y));
    a[0] = lo.x; a[1] = lo.y; a[2] = hi.x; a[3] = hi.y;
  } else {
    a[0] = __bfloat162float(*p);
  }
}

template <int V>
__device__ __forceinline__ void storev(float* p, const float (&a)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  } else {
    *p = a[0];
  }
}
// round to nearest even: exact for bn_apply's values (bf16 already),
// the one rounding of dx for conv_epilogue's VJP
template <int V>
__device__ __forceinline__ void storev(__nv_bfloat16* p, const float (&a)[V]) {
  if constexpr (V == 4) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(a[0], a[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(a[2], a[3]);
    uint2 q;
    q.x = *reinterpret_cast<uint32_t*>(&lo);
    q.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = q;
  } else {
    *p = __float2bfloat16_rn(a[0]);
  }
}

// V consecutive float32 per-channel factors through the read-only cache
// (V = 1, 4 or 8)
template <int V>
__device__ __forceinline__ void ldg_vec(const float* p, float (&a)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p) + i);
      a[4 * i] = q.x; a[4 * i + 1] = q.y; a[4 * i + 2] = q.z;
      a[4 * i + 3] = q.w;
    }
  } else {
    a[0] = __ldg(p);
  }
}

// ---------------------------------------------------------------- forward

// nv vectors of V elements; C = V * cv channels
template <typename T, int V, bool kRelu>
__global__ void __launch_bounds__(kThreads)
cxn_bn_fwd(const T* __restrict__ x, const float* __restrict__ scale,
           const float* __restrict__ shift, T* __restrict__ y, int64_t nv,
           int cv) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int step = static_cast<int>(stride % cv);
  int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int c = static_cast<int>(v % cv);
  for (; v < nv; v += stride) {
    float s[V], t[V], a[V];
    ldg_vec<V>(scale + c * V, s);
    ldg_vec<V>(shift + c * V, t);
    loadv<V>(x + v * V, a);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      a[j] = apply<T, kRelu>(a[j], Arith<T>::coef(s[j]), Arith<T>::coef(t[j]));
    }
    storev<V>(y + v * V, a);
    c += step;
    if (c >= cv) c -= cv;
  }
}

template <typename T, bool kRelu>
void launch_fwd(const T* x, const float* scale, const float* shift, T* y,
                int64_t n, int c, cudaStream_t stream) {
  const bool vec = (c % 4 == 0) && aligned(x, 4 * sizeof(T)) &&
                   aligned(y, 4 * sizeof(T)) && aligned(scale, 16) &&
                   aligned(shift, 16);
  const int64_t work = vec ? n / 4 : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sm_count()) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  if (vec) {
    cxn_bn_fwd<T, 4, kRelu><<<static_cast<unsigned>(blocks), kThreads, 0,
                              stream>>>(x, scale, shift, y, work, c / 4);
  } else {
    cxn_bn_fwd<T, 1, kRelu><<<static_cast<unsigned>(blocks), kThreads, 0,
                              stream>>>(x, scale, shift, y, work, c);
  }
}

// --------------------------------------------------------------- backward

constexpr int kBwdMaxThreads = 256;
constexpr int kBwdRows = 4;   // rows a thread loads before their first use
constexpr int kBwdMaxSegs = 8;  // row segments a finishing block adds apart

// V elements of T in registers, as loaded: one 16-byte load for V = 4
// floats or V = 8 bf16, 8 bytes for V = 4 bf16, one element for V = 1;
// streamed (ld.global.cs: read once, evict first).
template <typename T, int V>
struct Raw;
template <>
struct Raw<float, 1> {
  float r;
  __device__ __forceinline__ void load(const float* p) { r = __ldcs(p); }
  __device__ __forceinline__ void get(float (&a)[1]) const { a[0] = r; }
};
template <>
struct Raw<float, 4> {
  float4 r;
  __device__ __forceinline__ void load(const float* p) {
    r = __ldcs(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ void get(float (&a)[4]) const {
    a[0] = r.x; a[1] = r.y; a[2] = r.z; a[3] = r.w;
  }
};
template <>
struct Raw<__nv_bfloat16, 1> {
  unsigned short r;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    r = __ldcs(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ __forceinline__ void get(float (&a)[1]) const {
    a[0] = __uint_as_float(static_cast<uint32_t>(r) << 16);
  }
};
template <>
struct Raw<__nv_bfloat16, 4> {
  uint2 r;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    r = __ldcs(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ void get(float (&a)[4]) const {
    a[0] = __uint_as_float(r.x << 16); a[1] = __uint_as_float(r.x & 0xffff0000u);
    a[2] = __uint_as_float(r.y << 16); a[3] = __uint_as_float(r.y & 0xffff0000u);
  }
};
template <>
struct Raw<__nv_bfloat16, 8> {
  uint4 r;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    r = __ldcs(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void get(float (&a)[8]) const {
    a[0] = __uint_as_float(r.x << 16); a[1] = __uint_as_float(r.x & 0xffff0000u);
    a[2] = __uint_as_float(r.y << 16); a[3] = __uint_as_float(r.y & 0xffff0000u);
    a[4] = __uint_as_float(r.z << 16); a[5] = __uint_as_float(r.z & 0xffff0000u);
    a[6] = __uint_as_float(r.w << 16); a[7] = __uint_as_float(r.w & 0xffff0000u);
  }
};

// dx, streamed (st.global.cs): V = 8 bf16 or V = 4 floats as one
// 16-byte store, V = 4 bf16 as 8 bytes, V = 1 one element; rounding
// to nearest even, as storev
template <int V>
__device__ __forceinline__ void store_dx(__nv_bfloat16* p, const float (&a)[V]) {
  if constexpr (V == 1) {
    *p = __float2bfloat16_rn(a[0]);
  } else {
    uint32_t w[V / 2];
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      __nv_bfloat162 h = __floats2bfloat162_rn(a[2 * i], a[2 * i + 1]);
      w[i] = *reinterpret_cast<uint32_t*>(&h);
    }
    if constexpr (V == 8) {
      __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
    } else {
      __stcs(reinterpret_cast<uint2*>(p), make_uint2(w[0], w[1]));
    }
  }
}
template <int V>
__device__ __forceinline__ void store_dx(float* p, const float (&a)[V]) {
  if constexpr (V == 1) {
    *p = a[0];
  } else {
    __stcs(reinterpret_cast<float4*>(p), make_float4(a[0], a[1], a[2], a[3]));
  }
}

// V consecutive float32 partial sums (V = 1, 4 or 8), through L2 only:
// other blocks wrote them
template <int V>
__device__ __forceinline__ void ldcg_vec(const float* p, float (&a)[V]) {
  if constexpr (V == 1) {
    a[0] = __ldcg(p);
  } else {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float4 q = __ldcg(reinterpret_cast<const float4*>(p) + i);
      a[4 * i] = q.x; a[4 * i + 1] = q.y; a[4 * i + 2] = q.z; a[4 * i + 3] = q.w;
    }
  }
}
template <int V>
__device__ __forceinline__ void st_vec(float* p, const float (&a)[V]) {
  if constexpr (V == 1) {
    *p = a[0];
  } else {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      reinterpret_cast<float4*>(p)[i] =
          make_float4(a[4 * i], a[4 * i + 1], a[4 * i + 2], a[4 * i + 3]);
    }
  }
}

// Counts the block's arrival on *cnt once every thread's writes are
// done (the barrier, then one thread's __threadfence before the
// atomic: the release CUTLASS's semaphore uses). True in the block that
// arrives `expect`-th, which resets the counter and, after its own
// fence, sees every other block's writes. Every thread calls it.
__device__ __forceinline__ bool arrive_last(unsigned int* cnt,
                                            int expect,
                                            unsigned int* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const bool last =
        atomicAdd(cnt, 1u) == static_cast<unsigned int>(expect - 1);
    if (last) {
      *cnt = 0;
      __threadfence();
    }
    *flag = last;
  }
  __syncthreads();
  return *flag != 0;
}

// Sums rows [first, first + count) of the partial rows (2 * c floats
// each: the dscale part, then the dshift part) for the channel vectors
// [v0, v0 + width) of this tile, into row `out` (or dscale / dshift
// when out is null), with every thread of the block: segment g of
// `segs` adds rows first + g, first + g + segs, ... in order, then the
// segments are added in order in shared memory (red, blockDim.x * V
// floats at least). Every thread of the block calls it.
template <int V>
__device__ __forceinline__ void add_rows(const float* part, int c, int first,
                                         int count, int v0, int width,
                                         float* out, float* dscale,
                                         float* dshift, float* red) {
  const int items = 2 * width;
  const int segs = max(1, min(kBwdMaxSegs,
                              min(count, static_cast<int>(blockDim.x) / items)));
  const int lanes = blockDim.x / segs;       // items a pass
  const int g = threadIdx.x / lanes;
  const int lane = threadIdx.x % lanes;
  for (int base = 0; base < items; base += lanes) {
    const int item = base + lane;
    const bool mine = item < items && g < segs;
    const int half = item / width;           // 0: dscale, 1: dshift
    const int ch = (v0 + item % width) * V;
    float sum[V];
    if (mine) {
      const float* src =
          part + static_cast<int64_t>(first) * 2 * c + half * c + ch;
      ldcg_vec<V>(src + static_cast<int64_t>(g) * 2 * c, sum);
#pragma unroll 4
      for (int b = g + segs; b < count; b += segs) {
        float v[V];
        ldcg_vec<V>(src + static_cast<int64_t>(b) * 2 * c, v);
#pragma unroll
        for (int j = 0; j < V; ++j) sum[j] += v[j];
      }
    }
    __syncthreads();                         // red free again
    if (mine) {
#pragma unroll
      for (int j = 0; j < V; ++j) red[(g * lanes + lane) * V + j] = sum[j];
    }
    __syncthreads();
    if (mine && g == 0) {
      for (int q = 1; q < segs; ++q) {
#pragma unroll
        for (int j = 0; j < V; ++j) sum[j] += red[(q * lanes + lane) * V + j];
      }
      float* dst = out != nullptr ? out + half * c + ch
                                  : (half == 0 ? dscale : dshift) + ch;
      st_vec<V>(dst, sum);
    }
  }
}

// One pass over the (rows, c) tensors: dx, and dscale / dshift reduced
// on the way. Block (bx, tile) owns rows [bx * rows_per_block, ...) and
// the channel vectors [tile * ct, tile * ct + ct) (V channels each);
// its ct * rpi threads map one to each (row group, channel vector), and
// thread (rr, cv) walks rows rr, rr + rpi, ..., kBwdRows rows at a
// time with all their loads issued before the first use. The block
// adds its threads' sums over rr by a fixed tree in shared memory and
// writes one partial row. Then the partial rows are added in fixed
// block order without a second launch: the blocks of a group of
// `group` consecutive row blocks count their arrival (after a
// __threadfence) on a counter of the group; the last to arrive adds
// the group's rows in order, resets the counter, and, where there are
// several groups, writes a group row and counts on the tile's top
// counter, whose last arrival adds the group rows in order into dscale
// and dshift. The counters live in a persistent per-device buffer
// (ngroups + 1 per tile) that is zero between launches.
// TX is the type of x and dx, TY of y and dy; A rounds the arithmetic
// (Arith<T> for bn_apply, Arith<float> for conv_epilogue's VJP).
template <typename TX, typename TY, typename A, int V, bool kRelu>
__global__ void __launch_bounds__(kBwdMaxThreads)
cxn_bn_bwd(const TX* __restrict__ x, const TY* __restrict__ y,
           const TY* __restrict__ dy, const float* __restrict__ scale,
           TX* __restrict__ dx, float* __restrict__ part,
           unsigned int* __restrict__ counters, float* __restrict__ dscale,
           float* __restrict__ dshift, int64_t rows, int c, int64_t ld_dy,
           int64_t rows_per_block, int ct, int rpi, int group) {
  extern __shared__ float red[];             // [blockDim.x][2 V]
  __shared__ unsigned int is_last;
  const int nv = c / V;
  const int v0 = blockIdx.y * ct;
  const int width = min(ct, nv - v0);
  const int tid = threadIdx.x;
  const int cv = tid % ct;
  const int rr = tid / ct;
  const bool active = cv < width;
  const int ch = (v0 + cv) * V;
  float acc_s[V], acc_t[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    acc_s[j] = 0.0f;
    acc_t[j] = 0.0f;
  }
  if (active) {
    float s[V];
    ldg_vec<V>(scale + ch, s);
#pragma unroll
    for (int j = 0; j < V; ++j) s[j] = A::coef(s[j]);
    const int64_t r_begin = static_cast<int64_t>(blockIdx.x) * rows_per_block;
    const int64_t r_end = min(rows, r_begin + rows_per_block);
    const int64_t step = static_cast<int64_t>(rpi) * kBwdRows;
    for (int64_t r = r_begin + rr; r < r_end; r += step) {
      Raw<TX, V> rx[kBwdRows];
      Raw<TY, V> rd[kBwdRows], ry[kBwdRows];
#pragma unroll
      for (int u = 0; u < kBwdRows; ++u) {
        // a row past the end loads the last row again, unused: every
        // load is issued, none depends on another
        const int64_t row = min(r + u * rpi, r_end - 1);
        rx[u].load(x + row * c + ch);
        rd[u].load(dy + row * ld_dy + ch);
        if (kRelu) ry[u].load(y + row * c + ch);
      }
#pragma unroll
      for (int u = 0; u < kBwdRows; ++u) {
        const int64_t row = r + u * rpi;
        if (row >= r_end) break;
        float xv[V], dv[V], o[V];
        rx[u].get(xv);
        rd[u].get(dv);
        if (kRelu) {
          float yv[V];
          ry[u].get(yv);
#pragma unroll
          for (int j = 0; j < V; ++j) dv[j] = (yv[j] > 0.0f) ? dv[j] : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < V; ++j) {
          // dx as the reference computes it: the forward's arithmetic
          // with shift 0 (the + 0 turns -0 into +0, as it does there)
          o[j] = A::add(A::mul(dv[j], s[j]), 0.0f);
          acc_s[j] += A::mul(dv[j], xv[j]);
          acc_t[j] += dv[j];
        }
        store_dx<V>(dx + row * c + ch, o);
      }
    }
  }
  // the block's sums over rr, by a fixed tree
  float* mine = red + tid * 2 * V;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mine[j] = acc_s[j];
    mine[V + j] = acc_t[j];
  }
  __syncthreads();
  int half_span = 1;
  while (half_span < rpi) half_span <<= 1;
  for (half_span >>= 1; half_span > 0; half_span >>= 1) {
    if (rr < half_span && rr + half_span < rpi) {
      const float* other = red + (tid + half_span * ct) * 2 * V;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        acc_s[j] += other[j];
        acc_t[j] += other[V + j];
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        mine[j] = acc_s[j];
        mine[V + j] = acc_t[j];
      }
    }
    __syncthreads();
  }
  const int nbx = gridDim.x;
  if (nbx == 1) {
    if (rr == 0 && active) {
      st_vec<V>(dscale + ch, acc_s);
      st_vec<V>(dshift + ch, acc_t);
    }
    return;
  }
  if (rr == 0 && active) {
    float* row = part + static_cast<int64_t>(blockIdx.x) * 2 * c;
    st_vec<V>(row + ch, acc_s);
    st_vec<V>(row + c + ch, acc_t);
  }
  const int ngroups = (nbx + group - 1) / group;
  unsigned int* cnt =
      counters + static_cast<int64_t>(blockIdx.y) * (ngroups + 1);
  const int g = blockIdx.x / group;
  const int gsize = min(group, nbx - g * group);
  if (!arrive_last(&cnt[g], gsize, &is_last)) return;
  if (ngroups == 1) {
    add_rows<V>(part, c, 0, nbx, v0, width, nullptr, dscale, dshift, red);
    return;
  }
  add_rows<V>(part, c, g * group, gsize, v0, width,
              part + static_cast<int64_t>(nbx + g) * 2 * c, nullptr, nullptr,
              red);
  if (!arrive_last(&cnt[ngroups], ngroups, &is_last)) return;
  add_rows<V>(part, c, nbx, ngroups, v0, width, nullptr, dscale, dshift,
              red);
}

// The launch of the host-side plan (kernels.bn_bwd_plan): grid (nbx,
// ceil(nv / ct)), ct * rpi threads.
template <typename TX, typename TY, typename A, int V, bool kRelu>
cudaError_t launch_bwd(const TX* x, const TY* y, const TY* dy,
                       const float* scale, TX* dx, float* part,
                       unsigned int* counters, float* dscale, float* dshift,
                       int64_t rows, int c, int64_t ld_dy, int ct, int rpi,
                       int nbx, int group, cudaStream_t stream) {
  const int nv = c / V;
  const int tiles = (nv + ct - 1) / ct;
  const int64_t rows_per_block = (rows + nbx - 1) / nbx;
  const int threads = ct * rpi;
  const size_t smem = static_cast<size_t>(threads) * 2 * V * sizeof(float);
  dim3 grid(static_cast<unsigned>(nbx), static_cast<unsigned>(tiles));
  cxn_bn_bwd<TX, TY, A, V, kRelu><<<grid, threads, smem, stream>>>(
      x, y, dy, scale, dx, part, counters, dscale, dshift, rows, c, ld_dy,
      rows_per_block, ct, rpi, group);
  return cudaSuccess;
}

struct BwdPlan {
  int v, ct, rpi, nbx, group;
};

template <typename TX, typename TY, typename A, int V>
cudaError_t bwd_v(const void* x, const void* y, const void* dy,
                  const void* scale, void* dx, void* part, void* counters,
                  void* dscale, void* dshift, int64_t rows, int c,
                  int64_t ld_dy, int relu, const BwdPlan& p, cudaStream_t s) {
  const TX* xt = static_cast<const TX*>(x);
  const TY* yt = static_cast<const TY*>(y);
  const TY* dt = static_cast<const TY*>(dy);
  const float* sc = static_cast<const float*>(scale);
  TX* dxt = static_cast<TX*>(dx);
  float* pf = static_cast<float*>(part);
  unsigned int* cn = static_cast<unsigned int*>(counters);
  float* ds = static_cast<float*>(dscale);
  float* dh = static_cast<float*>(dshift);
  if (relu) {
    return launch_bwd<TX, TY, A, V, true>(xt, yt, dt, sc, dxt, pf, cn, ds, dh,
                                          rows, c, ld_dy, p.ct, p.rpi, p.nbx,
                                          p.group, s);
  }
  return launch_bwd<TX, TY, A, V, false>(xt, yt, dt, sc, dxt, pf, cn, ds, dh,
                                         rows, c, ld_dy, p.ct, p.rpi, p.nbx,
                                         p.group, s);
}

// checks the plan against the tensors, then launches V's instantiation
// (V = 8 only where x and y are both bf16)
template <typename TX, typename TY, typename A>
cudaError_t bwd_typed(const void* x, const void* y, const void* dy,
                      const void* scale, void* dx, void* part, void* counters,
                      void* dscale, void* dshift, int64_t rows, int c,
                      int64_t ld_dy, int relu, const BwdPlan& p,
                      cudaStream_t s) {
  const int v = p.v;
  const bool v_ok = v == 1 || v == 4 ||
                    (v == 8 && sizeof(TX) == 2 && sizeof(TY) == 2);
  if (!v_ok || c % v != 0 || ld_dy % v != 0 || p.ct < 1 || p.rpi < 1 ||
      p.ct * p.rpi > kBwdMaxThreads || p.nbx < 1 || p.group < 1 ||
      part == nullptr || counters == nullptr) {
    return cudaErrorInvalidValue;
  }
  if (v > 1) {
    const uintptr_t vx = v * sizeof(TX), vy = v * sizeof(TY);
    if (!aligned(x, vx) || !aligned(dy, vy) || !aligned(dx, vx) ||
        !aligned(scale, 16) || !aligned(part, 16) || !aligned(dscale, 16) ||
        !aligned(dshift, 16) || (relu && !aligned(y, vy))) {
      return cudaErrorInvalidValue;
    }
  }
  if (v == 8) {
    if constexpr (sizeof(TX) == 2 && sizeof(TY) == 2) {
      return bwd_v<TX, TY, A, 8>(x, y, dy, scale, dx, part, counters, dscale,
                                 dshift, rows, c, ld_dy, relu, p, s);
    }
  } else if (v == 4) {
    return bwd_v<TX, TY, A, 4>(x, y, dy, scale, dx, part, counters, dscale,
                               dshift, rows, c, ld_dy, relu, p, s);
  }
  return bwd_v<TX, TY, A, 1>(x, y, dy, scale, dx, part, counters, dscale,
                             dshift, rows, c, ld_dy, relu, p, s);
}

template <typename T>
void fwd_typed(const void* x, const void* scale, const void* shift, void* y,
               int64_t n, int c, int relu, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  T* yt = static_cast<T*>(y);
  if (relu) {
    launch_fwd<T, true>(xt, sc, sh, yt, n, c, s);
  } else {
    launch_fwd<T, false>(xt, sc, sh, yt, n, c, s);
  }
}

}  // namespace

// n elements, c channels (n % c == 0), contiguous; x and y float32
// (dtype 0) or bfloat16 (dtype 1), scale and shift float32.
// Returns a cudaError_t value; 0 is success.
extern "C" int cxn_bn_apply_fwd(const void* x, const void* scale,
                                const void* shift, void* y, long long n,
                                int c, int relu, int dtype, void* stream) {
  if (n <= 0 || c <= 0 || n % c != 0 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    fwd_typed<float>(x, scale, shift, y, n, c, relu, s);
  } else {
    fwd_typed<__nv_bfloat16>(x, scale, shift, y, n, c, relu, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// rows x c tensors of one dtype (0 float32, 1 bfloat16); x, y and dx
// contiguous, dy with row stride ld_dy >= c; y may be null when relu ==
// 0. scale is float32. The plan (kernels.bn_bwd_plan): v channels a
// vector (8, 4 or 1; 8 only for bf16), ct vectors and rpi row groups
// a
// block (ct * rpi <= 256 threads), nbx row blocks, summed in groups of
// `group`. part is a float32 scratch of 2 * c * (nbx + ceil(nbx /
// group)) values, counters a zeroed uint32 buffer of ceil(c / v / ct) *
// (ceil(nbx / group) + 1) values that the launch leaves zeroed. dscale
// and dshift receive c float32 sums.
// Returns a cudaError_t value; 0 is success.
extern "C" int cxn_bn_apply_bwd(const void* x, const void* y,
                                const void* dy, const void* scale, void* dx,
                                void* part, void* counters, void* dscale,
                                void* dshift, long long rows, int c,
                                long long ld_dy, int relu, int dtype, int v,
                                int ct, int rpi, int nbx, int group,
                                void* stream) {
  if (rows <= 0 || c <= 0 || ld_dy < c || (relu && y == nullptr) ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdPlan p{v, ct, rpi, nbx, group};
  cudaError_t err;
  if (dtype == 0) {
    err = bwd_typed<float, float, Arith<float>>(x, y, dy, scale, dx, part,
                                                counters, dscale, dshift, rows,
                                                c, ld_dy, relu, p, s);
  } else {
    using B = __nv_bfloat16;
    err = bwd_typed<B, B, Arith<B>>(x, y, dy, scale, dx, part, counters,
                                    dscale, dshift, rows, c, ld_dy, relu, p,
                                    s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// conv_epilogue's VJP: as cxn_bn_apply_bwd, with x and dx of x_dtype and
// y and dy of y_dtype (0 float32, 1 bfloat16) and float32 arithmetic.
// Returns a cudaError_t value; 0 is success.
extern "C" int cxn_conv_epilogue_bwd(const void* x, const void* y,
                                     const void* dy, const void* scale,
                                     void* dx, void* part, void* counters,
                                     void* dscale, void* dshift,
                                     long long rows, int c, long long ld_dy,
                                     int relu, int x_dtype, int y_dtype,
                                     int v, int ct, int rpi, int nbx,
                                     int group, void* stream) {
  if (rows <= 0 || c <= 0 || ld_dy < c || (relu && y == nullptr) ||
      (x_dtype != 0 && x_dtype != 1) || (y_dtype != 0 && y_dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdPlan p{v, ct, rpi, nbx, group};
  using B = __nv_bfloat16;
  using F = Arith<float>;
  cudaError_t err;
  if (x_dtype == 0 && y_dtype == 0) {
    err = bwd_typed<float, float, F>(x, y, dy, scale, dx, part, counters,
                                     dscale, dshift, rows, c, ld_dy, relu, p,
                                     s);
  } else if (x_dtype == 0) {
    err = bwd_typed<float, B, F>(x, y, dy, scale, dx, part, counters, dscale,
                                 dshift, rows, c, ld_dy, relu, p, s);
  } else if (y_dtype == 0) {
    err = bwd_typed<B, float, F>(x, y, dy, scale, dx, part, counters, dscale,
                                 dshift, rows, c, ld_dy, relu, p, s);
  } else {
    err = bwd_typed<B, B, F>(x, y, dy, scale, dx, part, counters, dscale,
                             dshift, rows, c, ld_dy, relu, p, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
