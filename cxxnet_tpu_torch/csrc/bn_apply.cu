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
//   - backward: block (bx, by) owns a contiguous range of rows and a
//     tile of channel vectors. Each thread keeps one channel vector
//     fixed and walks rows, so its two partial sums live in registers;
//     the block adds its threads' sums in a fixed order in shared
//     memory and writes one (2, C) row of a per-block scratch. A second
//     small kernel adds the blocks' rows in a fixed order (8 chains
//     per channel, coalesced across channels). No float atomics: the
//     sums repeat bit for bit from run to run;
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
template <int V>
__device__ __forceinline__ void ldg_vec(const float* p, float (&a)[V]) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    a[0] = q.x; a[1] = q.y; a[2] = q.z; a[3] = q.w;
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

// Block (blockIdx.x, blockIdx.y): rows [bx*rows_per_block, ...) and the
// channel vectors [by*ct, by*ct + tile). Thread tid works on vector
// tid % tile of the tile and on every rpi-th row from tid / tile.
// part is (2, gridDim.x, c): the block's dscale row, then its dshift row.
// TX is the type of x and dx, TY of y and dy; A rounds the arithmetic
// (Arith<T> for bn_apply, Arith<float> for conv_epilogue's VJP).
template <typename TX, typename TY, typename A, int V, bool kRelu>
__global__ void __launch_bounds__(kThreads)
cxn_bn_bwd_partial(const TX* __restrict__ x, const TY* __restrict__ y,
                   const TY* __restrict__ dy, const float* __restrict__ scale,
                   TX* __restrict__ dx, float* __restrict__ part, int64_t rows,
                   int c, int64_t ld_dy, int64_t rows_per_block, int ct) {
  __shared__ float red_s[kThreads][V];
  __shared__ float red_t[kThreads][V];
  const int nv = c / V;
  const int v0 = blockIdx.y * ct;
  const int tile = min(ct, nv - v0);
  const int rpi = kThreads / tile;
  const int tid = threadIdx.x;
  const int cv = tid % tile;
  const int rr = tid / tile;
  const int ch = (v0 + cv) * V;
  float acc_s[V], acc_t[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    acc_s[j] = 0.0f;
    acc_t[j] = 0.0f;
  }
  if (rr < rpi) {
    float s[V];
    loadv<V>(scale + ch, s);
#pragma unroll
    for (int j = 0; j < V; ++j) s[j] = A::coef(s[j]);
    const int64_t r_end =
        min(rows, (static_cast<int64_t>(blockIdx.x) + 1) * rows_per_block);
    for (int64_t r = static_cast<int64_t>(blockIdx.x) * rows_per_block + rr;
         r < r_end; r += rpi) {
      const int64_t off = r * c + ch;
      float xv[V], dv[V], o[V];
      loadv<V>(x + off, xv);
      loadv<V>(dy + r * ld_dy + ch, dv);
      if (kRelu) {
        float yv[V];
        loadv<V>(y + off, yv);
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
      storev<V>(dx + off, o);
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    red_s[tid][j] = acc_s[j];
    red_t[tid][j] = acc_t[j];
  }
  __syncthreads();
  if (rr == 0) {
    for (int k = 1; k < rpi; ++k) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        acc_s[j] += red_s[k * tile + cv][j];
        acc_t[j] += red_t[k * tile + cv][j];
      }
    }
    const int64_t nbx = gridDim.x;
    float* ps = part + static_cast<int64_t>(blockIdx.x) * c + ch;
    float* pt = part + (nbx + blockIdx.x) * c + ch;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      ps[j] = acc_s[j];
      pt[j] = acc_t[j];
    }
  }
}

// Adds the blocks' partial rows. A block covers 32 channels (one per
// lane, so each load of a warp is 128 contiguous bytes) with 8 chains
// per channel: chain k adds the rows of blocks k, k + 8, k + 16, ...
// in order, and the 8 chain sums are then added in order. The order is
// fixed by the grid alone, so the result repeats bit for bit.
constexpr int kFinishLanes = 32;
constexpr int kFinishChains = kThreads / kFinishLanes;   // 8

__global__ void __launch_bounds__(kThreads)
cxn_bn_bwd_finish(const float* __restrict__ part, int nbx, int c,
                  float* __restrict__ dscale, float* __restrict__ dshift) {
  __shared__ float red_s[kFinishChains][kFinishLanes];
  __shared__ float red_t[kFinishChains][kFinishLanes];
  const int lane = threadIdx.x % kFinishLanes;
  const int chain = threadIdx.x / kFinishLanes;
  const int ch = blockIdx.x * kFinishLanes + lane;
  float s = 0.0f, t = 0.0f;
  if (ch < c) {
    const int64_t off_t = static_cast<int64_t>(nbx) * c;
#pragma unroll 4
    for (int b = chain; b < nbx; b += kFinishChains) {
      s += part[static_cast<int64_t>(b) * c + ch];
      t += part[off_t + static_cast<int64_t>(b) * c + ch];
    }
  }
  red_s[chain][lane] = s;
  red_t[chain][lane] = t;
  __syncthreads();
  if (chain == 0 && ch < c) {
    for (int k = 1; k < kFinishChains; ++k) {
      s += red_s[k][lane];
      t += red_t[k][lane];
    }
    dscale[ch] = s;
    dshift[ch] = t;
  }
}

template <typename TX, typename TY, typename A, int V, bool kRelu>
void launch_bwd(const TX* x, const TY* y, const TY* dy, const float* scale,
                TX* dx, float* part, int max_blocks, float* dscale,
                float* dshift, int64_t rows, int c, int64_t ld_dy,
                cudaStream_t stream) {
  const int nv = c / V;
  const int ct = nv < kThreads ? nv : kThreads;
  const int tiles = (nv + ct - 1) / ct;
  const int rpi = kThreads / ct;
  // enough blocks to fill the card, at least four rows per thread each
  int64_t want = (rows + 4 * rpi - 1) / (4 * rpi);
  int64_t cap = static_cast<int64_t>(sm_count()) * kBlocksPerSm / tiles;
  if (cap > max_blocks) cap = max_blocks;
  if (cap < 1) cap = 1;
  if (want > cap) want = cap;
  if (want < 1) want = 1;
  const int64_t rows_per_block = (rows + want - 1) / want;
  const int64_t nbx = (rows + rows_per_block - 1) / rows_per_block;
  dim3 grid(static_cast<unsigned>(nbx), static_cast<unsigned>(tiles));
  cxn_bn_bwd_partial<TX, TY, A, V, kRelu><<<grid, kThreads, 0, stream>>>(
      x, y, dy, scale, dx, part, rows, c, ld_dy, rows_per_block, ct);
  cxn_bn_bwd_finish<<<(c + kFinishLanes - 1) / kFinishLanes, kThreads, 0,
                      stream>>>(part, static_cast<int>(nbx), c, dscale,
                                dshift);
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

template <typename TX, typename TY, typename A>
void bwd_typed(const void* x, const void* y, const void* dy,
               const void* scale, void* dx, void* part, int max_blocks,
               void* dscale, void* dshift, int64_t rows, int c,
               int64_t ld_dy, int relu, cudaStream_t s) {
  const TX* xt = static_cast<const TX*>(x);
  const TY* yt = static_cast<const TY*>(y);
  const TY* dt = static_cast<const TY*>(dy);
  const float* sc = static_cast<const float*>(scale);
  TX* dxt = static_cast<TX*>(dx);
  float* pf = static_cast<float*>(part);
  float* ds = static_cast<float*>(dscale);
  float* dh = static_cast<float*>(dshift);
  const uintptr_t vx = 4 * sizeof(TX);
  const uintptr_t vy = 4 * sizeof(TY);
  const bool vec = (c % 4 == 0) && (ld_dy % 4 == 0) && aligned(x, vx) &&
                   aligned(dy, vy) && aligned(dx, vx) && aligned(scale, 16) &&
                   (!relu || aligned(y, vy));
  if (vec && relu) {
    launch_bwd<TX, TY, A, 4, true>(xt, yt, dt, sc, dxt, pf, max_blocks, ds,
                                   dh, rows, c, ld_dy, s);
  } else if (vec) {
    launch_bwd<TX, TY, A, 4, false>(xt, yt, dt, sc, dxt, pf, max_blocks, ds,
                                    dh, rows, c, ld_dy, s);
  } else if (relu) {
    launch_bwd<TX, TY, A, 1, true>(xt, yt, dt, sc, dxt, pf, max_blocks, ds,
                                   dh, rows, c, ld_dy, s);
  } else {
    launch_bwd<TX, TY, A, 1, false>(xt, yt, dt, sc, dxt, pf, max_blocks, ds,
                                    dh, rows, c, ld_dy, s);
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
// 0. scale is float32. part is a float32 scratch of 2 * max_blocks * c
// values. dscale and dshift receive c float32 sums.
// Returns a cudaError_t value; 0 is success.
extern "C" int cxn_bn_apply_bwd(const void* x, const void* y,
                                const void* dy, const void* scale, void* dx,
                                void* part, int max_blocks, void* dscale,
                                void* dshift, long long rows, int c,
                                long long ld_dy, int relu, int dtype,
                                void* stream) {
  if (rows <= 0 || c <= 0 || ld_dy < c || max_blocks < 1 ||
      (relu && y == nullptr) || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    bwd_typed<float, float, Arith<float>>(x, y, dy, scale, dx, part,
                                          max_blocks, dscale, dshift, rows, c,
                                          ld_dy, relu, s);
  } else {
    using B = __nv_bfloat16;
    bwd_typed<B, B, Arith<B>>(x, y, dy, scale, dx, part, max_blocks, dscale,
                              dshift, rows, c, ld_dy, relu, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// conv_epilogue's VJP: as cxn_bn_apply_bwd, with x and dx of x_dtype and
// y and dy of y_dtype (0 float32, 1 bfloat16) and float32 arithmetic.
// Returns a cudaError_t value; 0 is success.
extern "C" int cxn_conv_epilogue_bwd(const void* x, const void* y,
                                     const void* dy, const void* scale,
                                     void* dx, void* part, int max_blocks,
                                     void* dscale, void* dshift,
                                     long long rows, int c, long long ld_dy,
                                     int relu, int x_dtype, int y_dtype,
                                     void* stream) {
  if (rows <= 0 || c <= 0 || ld_dy < c || max_blocks < 1 ||
      (relu && y == nullptr) || (x_dtype != 0 && x_dtype != 1) ||
      (y_dtype != 0 && y_dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using B = __nv_bfloat16;
  using F = Arith<float>;
  if (x_dtype == 0 && y_dtype == 0) {
    bwd_typed<float, float, F>(x, y, dy, scale, dx, part, max_blocks, dscale,
                               dshift, rows, c, ld_dy, relu, s);
  } else if (x_dtype == 0) {
    bwd_typed<float, B, F>(x, y, dy, scale, dx, part, max_blocks, dscale,
                           dshift, rows, c, ld_dy, relu, s);
  } else if (y_dtype == 0) {
    bwd_typed<B, float, F>(x, y, dy, scale, dx, part, max_blocks, dscale,
                           dshift, rows, c, ld_dy, relu, s);
  } else {
    bwd_typed<B, B, F>(x, y, dy, scale, dx, part, max_blocks, dscale, dshift,
                       rows, c, ld_dy, relu, s);
  }
  return static_cast<int>(cudaGetLastError());
}
