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
// fits the TPU's 16 MB of VMEM. A CUDA block keeps nothing but
// registers, so it needs no such limit: the strips below (also with a
// k-1 halo) exist to give every SM blocks, not to fit a buffer.
//
// What bounds it: bytes, and behind them the instructions that move
// them. The forward reads x once and writes y (8 bytes a pair of
// float32 elements, 4 in bf16; k*k maxima an output); the backward
// reads x, y and dy and writes dx (16 bytes, 8 in bf16; k*k compares
// and adds an input element): far below the ~20 flop/byte at which
// the f32 units would be the limit. The first design (one thread per
// output or input vector, four 64-bit divisions to decode it in a
// grid-stride loop, k*k loads an output and 1 + 2k*k an input, 8-byte
// bf16 vectors) issued so many index and load instructions that its
// bf16 kernels, with half the bytes, took as long as the f32 ones, at
// 23-47 % of the bound. The design now, chosen on the host by
// layers/kernels.py relu_max_pool_plan:
//
// "slide" (k in {2, 3}, C a multiple of the vector, 16-byte aligned
// bases, h*w*c below 2^31, dy with unit channel stride and strides
// that keep its vectors aligned -- kaiming's path):
//   - a block is (channel vectors) x (a tile of columns) of one strip
//     of R rows of one image; its index is decoded once, with 32-bit
//     arithmetic, and one 64-bit image base is kept. No loop divides;
//   - 16-byte vectors in both dtypes: 4 float32 channels, 8 bf16. bf16
//     data stays packed in bf16x2 words: the forward's maxima are one
//     max.NaN.bf16x2 a pair and its relu one unordered compare and a
//     mask (-0 becomes +0), the backward's compares one set.eq a pair;
//   - forward: each thread walks the R + k - 1 input rows of its strip
//     down its column. For each row it takes the maximum over its k
//     columns (k loads; the neighbours' columns hit L1) and keeps the
//     last k row maxima in a register ring (unrolled by k, so every
//     ring index is static); once the ring is full it stores one output
//     row. That is about k loads an output instead of k*k. relu commutes
//     with the maximum, so it is applied once, to the output;
//   - backward: the same walk over input rows. A ring holds the last k
//     output rows' y and dy at the k output columns that cover the
//     thread's input column; each new input row loads one output row's
//     k columns of y and dy (about 1 + 2k loads an input instead of
//     1 + 2k*k) and sums the covering windows from the ring in (di, dj)
//     order. Outside the output, y is -1 (never a relu'd value), so
//     such windows add nothing;
//   - the walk runs in whole groups of k steps with no bounds test, so
//     a group's loads can issue together, then the strip's last steps.
// What bounds it now, on one H100 80GB HBM3 at 700 W (chip_smoke.py):
// the forward moves kaiming's stem at ~90 % of the card's memory rate;
// the backward runs at ~75-80 % of it. Its ring is where its loads
// land, so the next row's loads wait for this row's sums, and its ~117
// registers a thread (capped at 128 by the launch bounds) hold ~512
// threads an SM. The strips (4 rows forward, 8 backward), blocks (256
// and 128 threads) and the backward's launch bounds are the values
// that timed best in a sweep of them at kaiming's pools (PERF.md).
// "generic" (every other k, C, alignment or dy): the first design, one
// thread per 4 channels (C % 4 == 0, aligned, unit-stride dy) or per
// channel, dy read through its four strides.
//
// The maxima are exact in any order (relu makes every term +0 or more,
// or NaN, and a NaN wins either way), so the forward's bits do not
// depend on the route; the backward's f32 sum keeps the (di, dj) order
// on both routes (adding +0 for a window that does not credit the
// element, as the plain version does, is exact: the sum starts at +0
// and is never -0).
//
// Plain C interface, loaded with ctypes. Launches go on the caller's
// stream; each entry returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // the generic route's block
constexpr int kSlideMaxThreads = 256;

// Blocks of kSlideMaxThreads the slide backward asks the compiler to
// fit on an SM: 2 caps it at 128 registers a thread (k = 3 takes ~117,
// 136 uncapped, and spills at 3).
constexpr int kSlideBwdMinBlocks = 2;

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
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

// ------------------------------------------------------ the slide route

// One 16-byte vector of channels as kWords = 4 32-bit words: a float32
// channel a word, or a bf16x2 pair.
constexpr int kWords = 4;

struct Words {
  uint32_t u[kWords];
};

__device__ __forceinline__ Words load_words(const void* p) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  Words r;
  r.u[0] = q.x; r.u[1] = q.y; r.u[2] = q.z; r.u[3] = q.w;
  return r;
}

__device__ __forceinline__ void store_words(void* p, const Words& r) {
  *reinterpret_cast<uint4*>(p) = make_uint4(r.u[0], r.u[1], r.u[2], r.u[3]);
}

__device__ __forceinline__ Words fill_words(uint32_t v) {
  Words r;
#pragma unroll
  for (int q = 0; q < kWords; ++q) r.u[q] = v;
  return r;
}

// The word arithmetic of each dtype: a NaN-propagating maximum, relu,
// the sentinel that no relu'd value equals, and the backward's step
// (add the cotangent where r equals y) into f32 accumulators.
template <typename T>
struct WordOps;

template <>
struct WordOps<float> {
  static constexpr int kPerWord = 1;
  static constexpr uint32_t kNotRelu = 0xbf800000u;  // -1.0f
  static __device__ __forceinline__ uint32_t max(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("max.NaN.f32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  static __device__ __forceinline__ uint32_t relu(uint32_t a) {
    return __float_as_uint(relu_nan(__uint_as_float(a)));
  }
  // r: relu(x) of this word, as relu() gives it
  static __device__ __forceinline__ void credit(float* acc, uint32_t r,
                                                uint32_t y, uint32_t dy) {
    if (__uint_as_float(r) == __uint_as_float(y)) acc[0] += __uint_as_float(dy);
  }
  static __device__ __forceinline__ void positive(bool* m, uint32_t x) {
    m[0] = __uint_as_float(x) > 0.0f;
  }
  static __device__ __forceinline__ uint32_t pack(const float* v) {
    return __float_as_uint(v[0]);
  }
};

template <>
struct WordOps<__nv_bfloat16> {
  static constexpr int kPerWord = 2;
  static constexpr uint32_t kNotRelu = 0xbf80bf80u;  // -1.0, -1.0
  static __device__ __forceinline__ __nv_bfloat162 b2(uint32_t a) {
    return *reinterpret_cast<__nv_bfloat162*>(&a);
  }
  static __device__ __forceinline__ uint32_t u32(__nv_bfloat162 a) {
    return *reinterpret_cast<uint32_t*>(&a);
  }
  static __device__ __forceinline__ uint32_t max(uint32_t a, uint32_t b) {
    return u32(__hmax2_nan(b2(a), b2(b)));
  }
  // keeps a half where it is > 0 or NaN (an unordered compare), else
  // +0, as relu_nan does: -0 becomes +0 whatever order the hardware's
  // maximum gives +-0
  static __device__ __forceinline__ uint32_t relu(uint32_t a) {
    return a & __hgtu2_mask(b2(a), __float2bfloat162_rn(0.0f));
  }
  static __device__ __forceinline__ void credit(float* acc, uint32_t r,
                                                uint32_t y, uint32_t dy) {
    // 0xffff in each half where r == y (IEEE: NaN never equal), so the
    // masked cotangent adds dy or +0
    const uint32_t d = dy & __heq2_mask(b2(r), b2(y));
    acc[0] += __uint_as_float(d << 16);
    acc[1] += __uint_as_float(d & 0xffff0000u);
  }
  static __device__ __forceinline__ void positive(bool* m, uint32_t x) {
    m[0] = __uint_as_float(x << 16) > 0.0f;
    m[1] = __uint_as_float(x & 0xffff0000u) > 0.0f;
  }
  static __device__ __forceinline__ uint32_t pack(const float* v) {
    return u32(__floats2bfloat162_rn(v[0], v[1]));
  }
};

// The block's place: blockIdx.x = ((b * strips + strip) * ctiles +
// ctile) * tiles + tile, decoded once; threadIdx.x is the channel
// vector within the channel tile, threadIdx.y the column within the
// column tile.
struct Place {
  int b, row0, col, cvec;
};

__device__ __forceinline__ Place place(int tiles, int ctiles, int strips,
                                       int rows) {
  int q = blockIdx.x;
  const int tile = q % tiles;
  q /= tiles;
  const int ctile = q % ctiles;
  q /= ctiles;
  Place p;
  p.row0 = (q % strips) * rows;
  p.b = q / strips;
  p.col = tile * blockDim.y + threadIdx.y;
  p.cvec = ctile * blockDim.x + threadIdx.x;
  return p;
}

// forward: one thread per (column j, vector of kWords words) of R output rows
template <typename T, int K>
__global__ void __launch_bounds__(kSlideMaxThreads)
cxn_relu_max_pool_fwd_slide(const T* __restrict__ x, T* __restrict__ y,
                            int h, int w, int c, int rows, int tiles,
                            int ctiles, int strips) {
  using Ops = WordOps<T>;
  constexpr int V = kWords * Ops::kPerWord;
  const Place p = place(tiles, ctiles, strips, rows);
  const int oh = h - K + 1, ow = w - K + 1;
  if (p.col >= ow || p.cvec * V >= c) return;
  const int n = min(rows, oh - p.row0);  // output rows of this strip
  const int xs = w * c, ys = ow * c;     // row strides (h*w*c < 2^31)
  const T* xp = x + static_cast<int64_t>(p.b) * h * xs + p.row0 * xs +
                p.col * c + p.cvec * V;
  T* yp = y + static_cast<int64_t>(p.b) * oh * ys + p.row0 * ys + p.col * c +
          p.cvec * V;
  Words ring[K];  // row maxima of the last K input rows, slot t % K
  // step t: input row t of the strip into slot u = t % K (u is a
  // constant wherever the step is inlined), then output row t - K + 1
  auto step = [&](int t, int u) {
    const T* row = xp + t * xs;
    Words m = load_words(row);
#pragma unroll
    for (int dj = 1; dj < K; ++dj) {
      const Words a = load_words(row + dj * c);
#pragma unroll
      for (int q = 0; q < kWords; ++q) m.u[q] = Ops::max(m.u[q], a.u[q]);
    }
    ring[u] = m;
    if (t >= K - 1) {
      Words o = ring[0];
#pragma unroll
      for (int s = 1; s < K; ++s) {
#pragma unroll
        for (int q = 0; q < kWords; ++q) {
          o.u[q] = Ops::max(o.u[q], ring[s].u[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < kWords; ++q) o.u[q] = Ops::relu(o.u[q]);
      store_words(yp + (t - K + 1) * ys, o);
    }
  };
  // whole groups of K steps carry no bounds test, so a group's loads
  // can all be in flight together; then the last steps
  const int steps = n + K - 1;
  int t0 = 0;
  for (; t0 + K <= steps; t0 += K) {
#pragma unroll
    for (int u = 0; u < K; ++u) step(t0 + u, u);
  }
#pragma unroll
  for (int u = 0; u < K - 1; ++u) {
    if (t0 + u < steps) step(t0 + u, u);
  }
}

// backward: one thread per (input column j, vector of kWords words) of
// R input rows. y is dense NHWC; dy has element strides (sb, sh, sw, 1),
// each a multiple of the vector.
template <typename T, int K>
__global__ void __launch_bounds__(kSlideMaxThreads, kSlideBwdMinBlocks)
cxn_relu_max_pool_bwd_slide(const T* __restrict__ x, const T* __restrict__ y,
                            const T* __restrict__ dy, T* __restrict__ dx,
                            int h, int w, int c, int rows, int tiles,
                            int ctiles, int strips, int64_t sb, int64_t sh,
                            int64_t sw) {
  using Ops = WordOps<T>;
  constexpr int P = Ops::kPerWord;
  constexpr int V = kWords * P;
  const Place p = place(tiles, ctiles, strips, rows);
  const int oh = h - K + 1, ow = w - K + 1;
  if (p.col >= w || p.cvec * V >= c) return;
  const int n = min(rows, h - p.row0);  // input rows of this strip
  const int xs = w * c, ys = ow * c;
  const int64_t xb = static_cast<int64_t>(p.b) * h * xs;
  const T* xp = x + xb + p.row0 * xs + p.col * c + p.cvec * V;
  T* dxp = dx + xb + p.row0 * xs + p.col * c + p.cvec * V;
  const T* yb = y + static_cast<int64_t>(p.b) * oh * ys + p.cvec * V;
  const T* db = dy + p.b * sb + p.cvec * V;
  // output columns j - dj that exist
  bool col_ok[K];
#pragma unroll
  for (int dj = 0; dj < K; ++dj) {
    col_ok[dj] = p.col - dj >= 0 && p.col - dj < ow;
  }
  // y and dy of the last K output rows at columns j - dj, slot t % K
  Words ry[K][K], rd[K][K];
  // step t: output row o = row0 - (K - 1) + t into slot u = t % K (u is
  // a constant wherever the step is inlined), then input row o
  auto step = [&](int t, int u) {
    const int o = p.row0 - (K - 1) + t;
    const bool row_ok = o >= 0 && o < oh;
#pragma unroll
    for (int dj = 0; dj < K; ++dj) {
      if (row_ok && col_ok[dj]) {
        ry[u][dj] = load_words(yb + o * ys + (p.col - dj) * c);
        rd[u][dj] = load_words(db + o * sh + (p.col - dj) * sw);
      } else {
        ry[u][dj] = fill_words(Ops::kNotRelu);
        rd[u][dj] = fill_words(0u);
      }
    }
    if (t >= K - 1) {
      const int i = t - (K - 1);  // input row within the strip
      const Words xv = load_words(xp + i * xs);
      float acc[V];
#pragma unroll
      for (int l = 0; l < V; ++l) acc[l] = 0.0f;
      uint32_t r[kWords];
#pragma unroll
      for (int q = 0; q < kWords; ++q) r[q] = Ops::relu(xv.u[q]);
#pragma unroll
      for (int di = 0; di < K; ++di) {
        const int s = (u - di + K) % K;  // output row (i - di)
#pragma unroll
        for (int dj = 0; dj < K; ++dj) {
#pragma unroll
          for (int q = 0; q < kWords; ++q) {
            Ops::credit(acc + q * P, r[q], ry[s][dj].u[q], rd[s][dj].u[q]);
          }
        }
      }
      Words out;
#pragma unroll
      for (int q = 0; q < kWords; ++q) {
        bool pos[P];
        Ops::positive(pos, xv.u[q]);
#pragma unroll
        for (int l = 0; l < P; ++l) {
          if (!pos[l]) acc[q * P + l] = 0.0f;
        }
        out.u[q] = Ops::pack(acc + q * P);
      }
      store_words(dxp + i * xs, out);
    }
  };
  const int steps = n + K - 1;
  int t0 = 0;
  for (; t0 + K <= steps; t0 += K) {
#pragma unroll
    for (int u = 0; u < K; ++u) step(t0 + u, u);
  }
#pragma unroll
  for (int u = 0; u < K - 1; ++u) {
    if (t0 + u < steps) step(t0 + u, u);
  }
}

// ---------------------------------------------------- the generic route

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

// ------------------------------------------------------------ launching

// The plan's fields (layers/kernels.py relu_max_pool_plan): route 0 is
// generic (v = 4 or 1, `blocks` blocks of kThreads in a grid-stride
// loop), route 1 slide (v = 16 bytes of channels; blocks of ct x
// tw threads over tiles x ctiles x strips x b, strips of `rows` rows).
struct Plan {
  int route, v, rows, tw, ct, tiles, ctiles, strips;
  long long blocks;
};

enum { kGeneric = 0, kSlide = 1 };

template <typename T>
bool slide_ok(const Plan& pl, int b, int c, int k, int span, int height) {
  return (k == 2 || k == 3) && pl.v * sizeof(T) == 16 && c % pl.v == 0 &&
         pl.tw >= 1 && pl.ct >= 1 &&
         pl.tw * pl.ct <= kSlideMaxThreads && pl.rows >= 1 &&
         static_cast<long long>(pl.tiles) * pl.tw >= span &&
         static_cast<long long>(pl.ctiles) * pl.ct * pl.v >= c &&
         static_cast<long long>(pl.strips) * pl.rows >= height &&
         pl.blocks == static_cast<long long>(pl.tiles) * pl.ctiles *
                          pl.strips * b &&
         pl.blocks < (1ll << 31);
}

template <typename T>
void fwd_slide(const T* x, T* y, int h, int w, int c, int k, const Plan& pl,
               cudaStream_t s) {
  const dim3 block(pl.ct, pl.tw);
  const unsigned grid = static_cast<unsigned>(pl.blocks);
  if (k == 2) {
    cxn_relu_max_pool_fwd_slide<T, 2><<<grid, block, 0, s>>>(
        x, y, h, w, c, pl.rows, pl.tiles, pl.ctiles, pl.strips);
  } else {
    cxn_relu_max_pool_fwd_slide<T, 3><<<grid, block, 0, s>>>(
        x, y, h, w, c, pl.rows, pl.tiles, pl.ctiles, pl.strips);
  }
}

template <typename T>
void bwd_slide(const T* x, const T* y, const T* dy, T* dx, int h, int w,
               int c, int k, int64_t db, int64_t dh, int64_t dw,
               const Plan& pl, cudaStream_t s) {
  const dim3 block(pl.ct, pl.tw);
  const unsigned grid = static_cast<unsigned>(pl.blocks);
  if (k == 2) {
    cxn_relu_max_pool_bwd_slide<T, 2><<<grid, block, 0, s>>>(
        x, y, dy, dx, h, w, c, pl.rows, pl.tiles, pl.ctiles, pl.strips, db,
        dh, dw);
  } else {
    cxn_relu_max_pool_bwd_slide<T, 3><<<grid, block, 0, s>>>(
        x, y, dy, dx, h, w, c, pl.rows, pl.tiles, pl.ctiles, pl.strips, db,
        dh, dw);
  }
}

template <typename T>
int fwd_typed(const void* x, void* y, int b, int h, int w, int c, int k,
              const Plan& pl, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const uintptr_t va = pl.v * sizeof(T);
  if (pl.blocks < 1 || !aligned(x, va) || !aligned(y, va) || c % pl.v) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (pl.route == kSlide) {
    if (!slide_ok<T>(pl, b, c, k, w - k + 1, h - k + 1)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    fwd_slide<T>(xt, yt, h, w, c, k, pl, s);
    return static_cast<int>(cudaGetLastError());
  }
  if (pl.route != kGeneric || (pl.v != 4 && pl.v != 1) ||
      pl.blocks > 0x7fffffffll) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n = static_cast<int64_t>(b) * (h - k + 1) * (w - k + 1) *
                    (c / pl.v);
  const unsigned grid = static_cast<unsigned>(pl.blocks);
  if (pl.v == 4) {
    cxn_relu_max_pool_fwd_k<T, 4><<<grid, kThreads, 0, s>>>(xt, yt, n, h, w,
                                                            c, k);
  } else {
    cxn_relu_max_pool_fwd_k<T, 1><<<grid, kThreads, 0, s>>>(xt, yt, n, h, w,
                                                            c, k);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_typed(const void* x, const void* y, const void* dy, void* dx, int b,
              int h, int w, int c, int k, int64_t db, int64_t dh, int64_t dw,
              int64_t dc, const Plan& pl, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  const T* dt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  const uintptr_t va = pl.v * sizeof(T);
  const bool vec_ok = c % pl.v == 0 && aligned(x, va) && aligned(y, va) &&
                      aligned(dx, va) && aligned(dy, va) &&
                      (pl.v == 1 || (dc == 1 && db % pl.v == 0 &&
                                     dh % pl.v == 0 && dw % pl.v == 0));
  if (pl.blocks < 1 || !vec_ok) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (pl.route == kSlide) {
    if (!slide_ok<T>(pl, b, c, k, w, h)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    bwd_slide<T>(xt, yt, dt, dxt, h, w, c, k, db, dh, dw, pl, s);
    return static_cast<int>(cudaGetLastError());
  }
  if (pl.route != kGeneric || (pl.v != 4 && pl.v != 1) ||
      pl.blocks > 0x7fffffffll) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n = static_cast<int64_t>(b) * h * w * (c / pl.v);
  const unsigned grid = static_cast<unsigned>(pl.blocks);
  if (pl.v == 4) {
    cxn_relu_max_pool_bwd_k<T, 4><<<grid, kThreads, 0, s>>>(
        xt, yt, dt, dxt, n, h, w, c, k, db, dh, dw, dc);
  } else {
    cxn_relu_max_pool_bwd_k<T, 1><<<grid, kThreads, 0, s>>>(
        xt, yt, dt, dxt, n, h, w, c, k, db, dh, dw, dc);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: contiguous (b, h, w, c); y: contiguous (b, h-k+1, w-k+1, c); both
// float32 (dtype 0) or bfloat16 (dtype 1); then the plan's fields.
// Returns a cudaError_t value; 0 is success (cudaErrorInvalidValue for
// a plan these tensors cannot take).
extern "C" int cxn_relu_max_pool_fwd(const void* x, void* y, int b, int h,
                                     int w, int c, int k, int dtype,
                                     int route, int v, int rows, int tw,
                                     int ct, int tiles, int ctiles,
                                     int strips, long long blocks,
                                     void* stream) {
  if (b <= 0 || c <= 0 || k < 1 || h < k || w < k || v < 1 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan pl{route, v, rows, tw, ct, tiles, ctiles, strips, blocks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd_typed<float>(x, y, b, h, w, c, k, pl, s);
  return fwd_typed<__nv_bfloat16>(x, y, b, h, w, c, k, pl, s);
}

// x, dx: contiguous (b, h, w, c); y: contiguous (b, h-k+1, w-k+1, c); dy:
// y's shape read through its element strides (db, dh, dw, dc), each >= 0;
// all of one dtype, float32 (0) or bfloat16 (1); then the plan's fields.
// Returns a cudaError_t value; 0 is success.
extern "C" int cxn_relu_max_pool_bwd(const void* x, const void* y,
                                     const void* dy, void* dx, int b, int h,
                                     int w, int c, int k, long long db,
                                     long long dh, long long dw, long long dc,
                                     int dtype, int route, int v, int rows,
                                     int tw, int ct, int tiles, int ctiles,
                                     int strips, long long blocks,
                                     void* stream) {
  if (b <= 0 || c <= 0 || k < 1 || h < k || w < k || db < 0 || dh < 0 ||
      dw < 0 || dc < 0 || v < 1 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan pl{route, v, rows, tw, ct, tiles, ctiles, strips, blocks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return bwd_typed<float>(x, y, dy, dx, b, h, w, c, k, db, dh, dw, dc, pl,
                            s);
  }
  return bwd_typed<__nv_bfloat16>(x, y, dy, dx, b, h, w, c, k, db, dh, dw,
                                  dc, pl, s);
}
