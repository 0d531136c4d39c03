// pool_concat for NVIDIA Hopper (sm_90a): the fused tail of an
// Inception tower, a channel concat one of whose branches is the
// UN-pooled input of a k x k, stride-1, SAME (zero pad k/2) max or avg
// pool, and its backward.
//
// Forward (cxn_pool_concat_fwd): branches x_0 .. x_{n-1}, each (B, H, W,
// C_i) float32 or bfloat16 read through its four element strides, into
// the dense (B, H, W, sum C_i) output of dtype T (the first branch's).
// For output (b, i, j, c) in branch q's segment [off_q, off_q + C_q):
//
//   plain branch:  out = T(x_q[b, i, j, c - off_q])
//   pool branch:   v(di, dj) = T(x_q[b, i+di-p, j+dj-p, c - off_q]), or 0
//                  outside the map (a zero pad, not -inf), p = k / 2;
//                  max:  y = v(0,0), then y = max(y, v) over (di, dj) in
//                        row-major order but (0,0), NaN propagated as
//                        jnp.maximum / torch.maximum do (fmaxf alone
//                        drops it); of +0 and -0 the +0, as PyTorch's
//                        CUDA maximum takes it
//                  avg:  y = v(0,0), then y = y + v in the same order,
//                        each add rounded in T, then one product with
//                        inv = T(1 / (k*k)) rounded in T (a product, not
//                        a division; in bf16 not 1/9 in f32)
//
// Backward (cxn_pool_concat_bwd), the pool branch only (a plain branch's
// gradient is its slice of dy: a view, or a cast where its dtype is not
// T). dy (B, H, W, sum C_i) of dtype T read through its strides; the
// forward's output supplies the residual y_pool. For input (b, i, j, c):
//
//   acc = 0.0f; for (di, dj) in row-major order, with output
//   o = (i+p-di, j+p-dj) inside the map:
//     max:  acc += f32(dy[b, o, off + c]) where f32(x[b,i,j,c]) ==
//           f32(out[b, o, off + c])     (every tied maximum credited; a
//           NaN window credits nobody; the pad's zeros are cropped)
//     avg:  acc += f32(dy[b, o, off + c]) * f32(1 / (k*k))  (one rounded
//           product per window)
//   dx[b, i, j, c] = round_to_x_dtype(acc)
//
// This is the reference's scatter (pallas_kernels.py:494-524: accp.at[
// di:di+h, dj:dj+w].add(contrib) in (di, dj) order) written as a
// gather: each input walks the windows that cover it in the same order
// and sums in a register, so the f32 sequence is the same, there are no
// float atomics, and dx repeats bit for bit.
//
// Replaces the TPU Pallas kernel cxxnet_tpu/layers/pallas_kernels.py:
// _pool_concat_kernel (:412-435, called by _pool_concat_call :438-463)
// and its VJP (:466-527, XLA code there). The Pallas kernel takes one
// batch item per grid step (the whole (H, W, C) item in VMEM, hence the
// reference's 6 MiB gate, kept by the planner so that both packages fuse
// the same concats) and the pool input arrives pre-padded by XLA; here
// the pad is a bounds check and a CUDA grid has no per-item blocking.
//
// What bounds it: bytes. The forward reads every branch once and writes
// the output once (8 bytes per float32 output element, 4 in bf16; k*k
// operations per pool element); the backward reads x, the output
// segment and dy's segment and writes dx (16 bytes per f32 element,
// k*k compares and adds; under avg dy and dx alone, 8 bytes).
//
// The forward's design (cxn_pool_concat_fwd_tile, tiled as
// layers/kernels.py pool_concat_plan chooses): a block takes a tile of
// output pixels (up to 8 rows x 32 columns of one image) and one job,
// 128 bytes of channels of one branch, so a launch has images x tiles x
// jobs blocks and every branch's copy and the pool's window run side by
// side. It is templated on the output dtype T and on "every branch is
// T" (the tower's case; a branch of the other dtype is read through its
// dtype and cast, in the same kernel). Where a branch's dtype is T, its
// channel stride 1, and its other strides, width, output offset and
// bases allow it, a thread moves 16 bytes (4 f32 or 8 bf16 channels);
// otherwise it moves one element. A plain branch is a straight copy,
// four vectors a thread in flight. The pool branch's job stages its
// (rows + k - 1) x (cols + k - 1) halo of those channels into shared
// memory once (16-byte cp.async, zero-filled where the window leaves
// the map), then reads the k*k taps there, so each input element leaves
// L2 about (rows + k - 1)(cols + k - 1) / (rows cols) times instead of
// k*k. On the vector route the taps combine word by word (Words<T>:
// max.NaN, in bf16 two channels an instruction; f32 adds, or bf16 adds
// two channels an instruction, each rounded once to bf16, which is the
// f32 add rounded to bf16), and the avg's product is taken in f32 and
// rounded to T, as on the scalar route, so the bits do not depend on
// the route. 64-bit offsets.
//
// The backward's design (cxn_pool_concat_bwd_tile, tiled as
// layers/kernels.py pool_concat_bwd_plan chooses): a block takes a tile
// of input pixels (up to 8 rows x 32 columns of one image) and one job,
// 128 bytes of the pool branch's channels (64 where what a block stages
// would crowd an SM's shared memory). It stages the outputs whose
// windows cover the tile, clipped to the map, into shared memory once:
// dy's segment, and under max out's segment and the tile's x (16-byte
// cp.async), so each dy and out element leaves L2 about min(rows + k - 1,
// H) min(cols + k - 1, W) / (rows cols) times instead of k*k. A thread
// then takes one input pixel and 16 bytes of channels (4 f32 or 8 bf16),
// walks its taps in the reference's order from shared memory with one
// f32 accumulator a channel (in bf16 under max the compare takes two
// channels an instruction and masks the cotangent), and stores dx with
// one 16-byte store. What bounds it besides bytes: the taps' shared
// memory reads and f32 adds, 9 a channel for a 3 x 3 window, run after
// the block's copies; blocks of one SM overlap one another's. Where
// a tensor cannot take 16-byte vectors (another dtype for x, a channel
// stride other than 1, strides, offset or bases off the vector), the
// scalar route runs the same tiles one element a thread, read through
// its dtype. Clipping the halo keeps every window the reference's 6 MiB
// gate admits within a block's shared memory.
//
// Plain C interface, loaded with ctypes. Launches go on the caller's
// stream; each entry returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFwdThreads = 256;   // the forward's block
constexpr int kFwdMinBlocks = 6;   // forward blocks an SM (register cap)
constexpr int kCopyVecs = 4;       // a plain copy's vectors in flight
constexpr int kBwdThreads = 256;   // the backward's largest block
constexpr int kBwdMinBlocks = 3;   // backward blocks an SM (register cap)
constexpr int kMaxBranches = 8;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// torch.maximum(m, a) as PyTorch's CUDA kernel computes it: NaN if
// either is NaN, else ::max (fmaxf, which takes +0 over -0)
__device__ __forceinline__ float max_nan(float m, float a) {
  if (m != m) return m;
  if (a != a) return a;
  return fmaxf(m, a);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// one element of a float32 (dtype 0) or bfloat16 (dtype 1) tensor
__device__ __forceinline__ float load_as_f32(const void* p, int64_t off,
                                             int dtype) {
  return dtype == 0 ? static_cast<const float*>(p)[off]
                    : __bfloat162float(
                          static_cast<const __nv_bfloat16*>(p)[off]);
}

// The rounding of one tensor op in the output dtype T.
template <typename T>
struct Arith;
template <>
struct Arith<float> {
  static __device__ __forceinline__ float cast(float v) { return v; }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};
template <>
struct Arith<__nv_bfloat16> {
  static __device__ __forceinline__ float cast(float v) {
    return round_bf16(v);
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return round_bf16(__fadd_rn(a, b));
  }
  static __device__ __forceinline__ float mul(float a, float b) {
    return round_bf16(__fmul_rn(a, b));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);   // exact: v is a bf16 value
  }
};

// ---------------------------------------------------------------- forward

// Tiling of a launch, from layers/kernels.py pool_concat_plan: a block
// takes tile (tr output rows x tw output cols) of one image and one
// job, cc channels of one branch (blockIdx.x = image * tiles + tile,
// blockIdx.y = job; branch q owns jobs [jobs[q], jobs[q + 1])).
struct Tiling {
  int tr, tw, cc, rtiles, ctiles;
};

struct Branches {
  const void* ptr[kMaxBranches];
  int64_t s[kMaxBranches][4];   // element strides (b, h, w, c)
  int off[kMaxBranches + 1];    // channel offsets; off[n] = total
  int dtype[kMaxBranches];      // 0 float32, 1 bfloat16
  int vec[kMaxBranches];        // 1: the 16-byte route
  int jobs[kMaxBranches + 1];   // job offsets; jobs[n] = total
  int n;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  // bytes 0 fills the 16 bytes with zeros (the pad), reading nothing
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

// a 16-byte vector of T as f32 values (exact), and back (v holds T
// values, so the packing is exact too)
template <typename T>
__device__ __forceinline__ void unpack(const uint4& q, float* f);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& q, float* f) {
  f[0] = __uint_as_float(q.x);
  f[1] = __uint_as_float(q.y);
  f[2] = __uint_as_float(q.z);
  f[3] = __uint_as_float(q.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& q,
                                                      float* f) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <typename T>
__device__ __forceinline__ uint4 pack(const float* f);
template <>
__device__ __forceinline__ uint4 pack<float>(const float* f) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
template <>
__device__ __forceinline__ uint4 pack<__nv_bfloat16>(const float* f) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = (__float_as_uint(f[2 * i]) >> 16) |
           (__float_as_uint(f[2 * i + 1]) & 0xffff0000u);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The window's steps on a 16-byte vector of T, word by word: float32 in
// f32, bf16 two to an instruction. max.NaN gives NaN where either is
// NaN and +0 over -0 (torch.maximum's result; the card's check holds
// the bits); add.rn.bf16x2 rounds each half once, which is the f32 add
// rounded to bf16 (double rounding through f32 is innocuous for a sum
// of two bf16 values: the bias gradient's argument).
template <typename T>
struct Words;
template <>
struct Words<float> {
  static __device__ __forceinline__ uint32_t max1(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("max.NaN.f32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  static __device__ __forceinline__ uint4 max(const uint4& a, const uint4& b) {
    return make_uint4(max1(a.x, b.x), max1(a.y, b.y), max1(a.z, b.z),
                      max1(a.w, b.w));
  }
  static __device__ __forceinline__ uint32_t add1(uint32_t a, uint32_t b) {
    return __float_as_uint(__fadd_rn(__uint_as_float(a), __uint_as_float(b)));
  }
  static __device__ __forceinline__ uint4 add(const uint4& a, const uint4& b) {
    return make_uint4(add1(a.x, b.x), add1(a.y, b.y), add1(a.z, b.z),
                      add1(a.w, b.w));
  }
};
template <>
struct Words<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t max1(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  static __device__ __forceinline__ uint4 max(const uint4& a, const uint4& b) {
    return make_uint4(max1(a.x, b.x), max1(a.y, b.y), max1(a.z, b.z),
                      max1(a.w, b.w));
  }
  static __device__ __forceinline__ uint32_t add1(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  static __device__ __forceinline__ uint4 add(const uint4& a, const uint4& b) {
    return make_uint4(add1(a.x, b.x), add1(a.y, b.y), add1(a.z, b.z),
                      add1(a.w, b.w));
  }
};

// one element of a branch as T: read as T where every branch is T
// (kSame), else through the branch's dtype (block-uniform), rounded as
// the plain version's x.to(T) rounds it
template <typename T, bool kSame>
__device__ __forceinline__ float load_cast(const void* p, int64_t off,
                                           int dtype) {
  if (kSame) {
    return Arith<T>::cast(load_as_f32(p, off, sizeof(T) == 4 ? 0 : 1));
  }
  return Arith<T>::cast(load_as_f32(p, off, dtype));
}

// the tap (0,0) of a window, then the rest in row-major order, over the
// f32 values of T elements at `at` (elements) in the halo, pitch `hp`
// elements a halo row and `cp` a halo pixel
template <typename T, int K>
__device__ __forceinline__ float window(const T* at, int k, int hp, int cp,
                                        int avg, float inv) {
  using A = Arith<T>;
  float y = to_f32(at[0]);
#pragma unroll
  for (int di = 0; di < (K > 0 ? K : k); ++di) {
#pragma unroll
    for (int dj = 0; dj < (K > 0 ? K : k); ++dj) {
      if (di == 0 && dj == 0) continue;
      const float v = to_f32(at[di * hp + dj * cp]);
      y = avg ? A::add(y, v) : max_nan(y, v);
    }
  }
  return avg ? A::mul(y, inv) : y;
}

// Block (image, tile, job). A plain branch's job copies its channels of
// the tile's pixels: 16-byte vectors where the branch takes the vector
// route (its dtype is T; unit channel stride; strides, width, output
// offset and bases 16-byte aligned), else element by element with a
// cast. The pool branch's job stages the tile's (tr + k - 1) x
// (tw + k - 1) halo of its cc channels into shared memory as T (16-byte
// cp.async with zero fill for the pad on the vector route; loads and a
// cast otherwise), then every output reads its k*k taps from there and
// writes 16 bytes (or one element) of the output.
template <typename T, bool kSame, int K>
__global__ void __launch_bounds__(kFwdThreads, kFwdMinBlocks)
cxn_pool_concat_fwd_tile(const __grid_constant__ Branches br, int pos,
                         int k_rt, int avg, float inv, T* __restrict__ out,
                         int h, int w, Tiling tl) {
  using A = Arith<T>;
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  T* halo = reinterpret_cast<T*>(smem);
  const int k = K > 0 ? K : k_rt;
  const int p = k / 2;
  const int64_t ctot = br.off[br.n];
  const int tiles = tl.rtiles * tl.ctiles;
  const int tile = blockIdx.x % tiles;
  const int64_t img = blockIdx.x / tiles;
  const int i0 = (tile / tl.ctiles) * tl.tr;
  const int j0 = (tile % tl.ctiles) * tl.tw;
  const int rows = min(tl.tr, h - i0);
  const int cols = min(tl.tw, w - j0);
  const int job = blockIdx.y;
  int q = 0;
  while (job >= br.jobs[q + 1]) ++q;
  const int c0 = (job - br.jobs[q]) * tl.cc;
  const int cw = min(tl.cc, br.off[q + 1] - br.off[q] - c0);
  const int64_t s1 = br.s[q][1], s2 = br.s[q][2];
  const void* xp = br.ptr[q];
  const int dt = br.dtype[q];
  const bool vec = br.vec[q] != 0;
  // the branch at (img, 0, 0, c0) and the output at the tile's origin
  const int64_t xb = img * br.s[q][0] + c0 * br.s[q][3];
  T* ob = out + ((img * h + i0) * w + j0) * ctot + br.off[q] + c0;
  const int64_t orow = static_cast<int64_t>(w) * ctot;

  if (q != pos) {
    if (vec) {
      // kCopyVecs vectors a thread in flight before the first store
      const T* x = static_cast<const T*>(xp) + xb;
      const int nv = cw / V;
      const int total = rows * cols * nv;
      for (int e0 = threadIdx.x; e0 < total; e0 += kCopyVecs * kFwdThreads) {
        uint4 val[kCopyVecs];
        T* dst[kCopyVecs];
#pragma unroll
        for (int u = 0; u < kCopyVecs; ++u) {
          const int e = e0 + u * kFwdThreads;
          dst[u] = nullptr;
          if (e < total) {
            const int v = e % nv, pix = e / nv;
            const int r = pix / cols, c = pix % cols;
            val[u] = __ldg(reinterpret_cast<const uint4*>(
                x + (i0 + r) * s1 + (j0 + c) * s2 + v * V));
            dst[u] = ob + r * orow + c * ctot + v * V;
          }
        }
#pragma unroll
        for (int u = 0; u < kCopyVecs; ++u) {
          if (dst[u] != nullptr) *reinterpret_cast<uint4*>(dst[u]) = val[u];
        }
      }
    } else {
      const int64_t s3 = br.s[q][3];
      for (int e = threadIdx.x; e < rows * cols * cw; e += kFwdThreads) {
        const int ch = e % cw, pix = e / cw;
        const int r = pix / cols, c = pix % cols;
        A::store(ob + r * orow + c * ctot + ch,
                 load_cast<T, kSame>(xp, xb + (i0 + r) * s1 + (j0 + c) * s2 +
                                             ch * s3, dt));
      }
    }
    return;
  }

  // the pool branch: stage the halo, pixel pitch cc elements
  const int hr = rows + k - 1, hc = cols + k - 1;
  const int cp = tl.cc;
  if (vec) {
    const T* x = static_cast<const T*>(xp) + xb;
    const int nv = cw / V;
    for (int e = threadIdx.x; e < hr * hc * nv; e += kFwdThreads) {
      const int v = e % nv, hpix = e / nv;
      const int ii = i0 + hpix / hc - p, jj = j0 + hpix % hc - p;
      const bool in = ii >= 0 && ii < h && jj >= 0 && jj < w;
      cp_async16(halo + hpix * cp + v * V,
                 in ? x + ii * s1 + jj * s2 + v * V : x, in ? 16 : 0);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
  } else {
    const int64_t s3 = br.s[q][3];
    for (int e = threadIdx.x; e < hr * hc * cw; e += kFwdThreads) {
      const int ch = e % cw, hpix = e / cw;
      const int ii = i0 + hpix / hc - p, jj = j0 + hpix % hc - p;
      float v = 0.0f;
      if (ii >= 0 && ii < h && jj >= 0 && jj < w) {
        v = load_cast<T, kSame>(xp, xb + ii * s1 + jj * s2 + ch * s3, dt);
      }
      A::store(halo + hpix * cp + ch, v);
    }
  }
  __syncthreads();
  const int hp = hc * cp;   // a halo row, elements
  if (vec) {
    const int nv = cw / V;
    for (int e = threadIdx.x; e < rows * cols * nv; e += kFwdThreads) {
      const int v = e % nv, pix = e / nv;
      const int r = pix / cols, c = pix % cols;
      const T* at = halo + r * hp + c * cp + v * V;
      uint4 y = *reinterpret_cast<const uint4*>(at);
#pragma unroll
      for (int di = 0; di < (K > 0 ? K : k); ++di) {
#pragma unroll
        for (int dj = 0; dj < (K > 0 ? K : k); ++dj) {
          if (di == 0 && dj == 0) continue;
          const uint4 t =
              *reinterpret_cast<const uint4*>(at + di * hp + dj * cp);
          y = avg ? Words<T>::add(y, t) : Words<T>::max(y, t);
        }
      }
      if (avg) {
        float f[V];
        unpack<T>(y, f);
#pragma unroll
        for (int u = 0; u < V; ++u) f[u] = A::mul(f[u], inv);
        y = pack<T>(f);
      }
      *reinterpret_cast<uint4*>(ob + r * orow + c * ctot + v * V) = y;
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols * cw; e += kFwdThreads) {
      const int ch = e % cw, pix = e / cw;
      const int r = pix / cols, c = pix % cols;
      A::store(ob + r * orow + c * ctot + ch,
               window<T, K>(halo + r * hp + c * cp + ch, k, hp, cp, avg,
                            inv));
    }
  }
}

// --------------------------------------------------------------- backward

// A backward launch, from layers/kernels.py pool_concat_bwd_plan: block
// (image * tiles + tile, job) takes a tile of tr x tw input pixels of one
// image and cc channels of the pool branch. dy and out are read at
// channel off + c of their (b, h, w, ctot) element strides ds / os; x
// through xs; dx is dense (b, h, w, c). hr x hc: the largest clipped halo
// of a tile, which sets where each staged tensor starts.
struct BwdArgs {
  const void* x;
  const void* dy;
  const void* out;
  void* dx;
  int64_t xs[4], ds[4], os[4];
  int off, c, h, w, k, avg;
  float inv;
  int tr, tw, cc, rtiles, ctiles, hr, hc;
};

// Where x equals out, two bf16 channels an instruction: each half all
// ones or zero. set.eq on bf16x2 gives f32 =='s answer on the widened
// values (+0 equals -0, a NaN equals nothing, no flush of subnormals).
__device__ __forceinline__ uint32_t eq_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("set.eq.u32.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// Block (image, tile, job). Stage the outputs whose windows cover the
// tile, clipped to the map: rows [max(0, i0 - p), min(h - 1, i0 + rows - 1
// + p)], the same for columns; dy's segment, and under max out's segment
// too, cc channels a pixel, pitch cc elements (on the vector route with
// 16-byte cp.async, and under max the tile's x beside them; otherwise
// element by element through the strides, as TY). Then a thread takes
// one input pixel and one 16-byte vector of channels (or one channel on
// the scalar route) and walks the taps (di, dj) in row-major order whose
// output o = (i + p - di, j + p - dj) lies in the map, exactly the staged
// ones: one f32 accumulator a channel from +0, adding dy where f32(x) ==
// f32(out) (max; f32 ==, so a NaN on either side credits nothing and +0
// equals -0), or the product dy * inv rounded before the add (avg;
// __fmul_rn then __fadd_rn, no contraction). A tap that is skipped
// adds nothing, which is the reference's adding +0: the accumulator
// starts at +0 and under round-to-nearest never becomes -0, so +0 is the
// identity. So in bf16 under max every staged tap is added, its
// uncredited channels masked to +0 (eq_bf16x2). dx = the accumulator
// rounded once to TX.
template <typename TY, typename TX, bool kVec, int K>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
cxn_pool_concat_bwd_tile(const __grid_constant__ BwdArgs a) {
  constexpr int V = 16 / sizeof(TY);
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = K > 0 ? K : a.k;
  const int p = k / 2;
  const bool avg = a.avg != 0;
  const int tiles = a.rtiles * a.ctiles;
  const int tile = blockIdx.x % tiles;
  const int64_t img = blockIdx.x / tiles;
  const int i0 = (tile / a.ctiles) * a.tr;
  const int j0 = (tile % a.ctiles) * a.tw;
  const int rows = min(a.tr, a.h - i0);
  const int cols = min(a.tw, a.w - j0);
  const int c0 = blockIdx.y * a.cc;
  const int cw = min(a.cc, a.c - c0);
  const int oi0 = max(0, i0 - p), oj0 = max(0, j0 - p);
  const int hr = min(a.h - 1, i0 + rows - 1 + p) - oi0 + 1;
  const int hc = min(a.w - 1, j0 + cols - 1 + p) - oj0 + 1;
  const int cp = a.cc;                       // a staged pixel, elements
  TY* sdy = reinterpret_cast<TY*>(smem);
  TY* sout = sdy + a.hr * a.hc * cp;         // max only
  TY* sx = sout + a.hr * a.hc * cp;          // max on the vector route
  // dy and out at (img, oi0, oj0, off + c0); x at (img, i0, j0, c0)
  const int64_t db = img * a.ds[0] + oi0 * a.ds[1] + oj0 * a.ds[2] +
                     (a.off + c0) * a.ds[3];
  const int64_t ob = img * a.os[0] + oi0 * a.os[1] + oj0 * a.os[2] +
                     (a.off + c0) * a.os[3];
  const int64_t xb = img * a.xs[0] + i0 * a.xs[1] + j0 * a.xs[2] +
                     c0 * a.xs[3];
  TX* dxb = static_cast<TX*>(a.dx) +
             ((img * a.h + i0) * a.w + j0) * a.c + c0;
  const int64_t drow = static_cast<int64_t>(a.w) * a.c;

  if constexpr (kVec) {
    const TY* dy = static_cast<const TY*>(a.dy) + db;
    const TY* out = static_cast<const TY*>(a.out) + ob;
    const int nv = cw / V;
    for (int e = threadIdx.x; e < hr * hc * nv; e += blockDim.x) {
      const int v = e % nv, hp = e / nv;
      const int r = hp / hc, c = hp % hc;
      cp_async16(sdy + hp * cp + v * V, dy + r * a.ds[1] + c * a.ds[2] + v * V,
                 16);
      if (!avg) {
        cp_async16(sout + hp * cp + v * V,
                   out + r * a.os[1] + c * a.os[2] + v * V, 16);
      }
    }
    if (!avg) {
      const TY* x = static_cast<const TY*>(a.x) + xb;
      for (int e = threadIdx.x; e < rows * cols * nv; e += blockDim.x) {
        const int v = e % nv, pix = e / nv;
        const int r = pix / cols, c = pix % cols;
        cp_async16(sx + pix * cp + v * V,
                   x + r * a.xs[1] + c * a.xs[2] + v * V, 16);
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
  } else {
    const TY* dy = static_cast<const TY*>(a.dy);
    const TY* out = static_cast<const TY*>(a.out);
    for (int e = threadIdx.x; e < hr * hc * cw; e += blockDim.x) {
      const int ch = e % cw, hp = e / cw;
      const int r = hp / hc, c = hp % hc;
      sdy[hp * cp + ch] = dy[db + r * a.ds[1] + c * a.ds[2] + ch * a.ds[3]];
      if (!avg) {
        sout[hp * cp + ch] =
            out[ob + r * a.os[1] + c * a.os[2] + ch * a.os[3]];
      }
    }
  }
  __syncthreads();

  const int hrow = hc * cp;                  // a staged row, elements
  const int br = i0 + p - oi0, bc = j0 + p - oj0;   // tap (0,0) of (0,0)
  if constexpr (kVec) {
    const int nv = cw / V;
    for (int e = threadIdx.x; e < rows * cols * nv; e += blockDim.x) {
      const int v = e % nv, pix = e / nv;
      const int r = pix / cols, c = pix % cols;
      float acc[V], xv[V];
#pragma unroll
      for (int u = 0; u < V; ++u) acc[u] = 0.0f;
      const uint4 xq = avg ? make_uint4(0, 0, 0, 0)
                           : *reinterpret_cast<const uint4*>(sx + pix * cp +
                                                             v * V);
      unpack<TY>(xq, xv);
      // the taps in the map: staged rows r + br - di in [0, hr), columns
      // c + bc - dj in [0, hc)
      const int di0 = max(0, r + br - hr + 1), di1 = min(k - 1, r + br);
      const int dj0 = max(0, c + bc - hc + 1), dj1 = min(k - 1, c + bc);
      const int at = (r + br) * hrow + (c + bc) * cp + v * V;
#pragma unroll
      for (int di = 0; di < (K > 0 ? K : k); ++di) {
        if (di < di0 || di > di1) continue;
#pragma unroll
        for (int dj = 0; dj < (K > 0 ? K : k); ++dj) {
          if (dj < dj0 || dj > dj1) continue;
          const int o = at - di * hrow - dj * cp;
          const uint4 gq = *reinterpret_cast<const uint4*>(sdy + o);
          float g[V];
          if (avg) {
            unpack<TY>(gq, g);
#pragma unroll
            for (int u = 0; u < V; ++u) {
              acc[u] = __fadd_rn(acc[u], __fmul_rn(g[u], a.inv));
            }
          } else if constexpr (sizeof(TY) == 2) {
            // dy's bits where x == out, two channels a word, +0 elsewhere
            const uint4 yq = *reinterpret_cast<const uint4*>(sout + o);
            const uint4 cq = make_uint4(gq.x & eq_bf16x2(xq.x, yq.x),
                                        gq.y & eq_bf16x2(xq.y, yq.y),
                                        gq.z & eq_bf16x2(xq.z, yq.z),
                                        gq.w & eq_bf16x2(xq.w, yq.w));
            unpack<TY>(cq, g);
#pragma unroll
            for (int u = 0; u < V; ++u) acc[u] = __fadd_rn(acc[u], g[u]);
          } else {
            float y[V];
            unpack<TY>(gq, g);
            unpack<TY>(*reinterpret_cast<const uint4*>(sout + o), y);
#pragma unroll
            for (int u = 0; u < V; ++u) {
              if (xv[u] == y[u]) acc[u] = __fadd_rn(acc[u], g[u]);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < V; ++u) acc[u] = Arith<TX>::cast(acc[u]);
      *reinterpret_cast<uint4*>(dxb + r * drow + c * a.c + v * V) =
          pack<TX>(acc);
    }
  } else {
    const TX* x = static_cast<const TX*>(a.x) + xb;
    for (int e = threadIdx.x; e < rows * cols * cw; e += blockDim.x) {
      const int ch = e % cw, pix = e / cw;
      const int r = pix / cols, c = pix % cols;
      const float xv =
          avg ? 0.0f : to_f32(x[r * a.xs[1] + c * a.xs[2] + ch * a.xs[3]]);
      const int di0 = max(0, r + br - hr + 1), di1 = min(k - 1, r + br);
      const int dj0 = max(0, c + bc - hc + 1), dj1 = min(k - 1, c + bc);
      const int at = (r + br) * hrow + (c + bc) * cp + ch;
      float acc = 0.0f;
      for (int di = di0; di <= di1; ++di) {
        for (int dj = dj0; dj <= dj1; ++dj) {
          const int o = at - di * hrow - dj * cp;
          const float g = to_f32(sdy[o]);
          if (avg) {
            acc = __fadd_rn(acc, __fmul_rn(g, a.inv));
          } else if (xv == to_f32(sout[o])) {
            acc = __fadd_rn(acc, g);
          }
        }
      }
      Arith<TX>::store(dxb + r * drow + c * a.c + ch, Arith<TX>::cast(acc));
    }
  }
}

// the window every Inception module uses (3) unrolled, any other odd k
// at run time; kSame where every branch is of the output's dtype
template <typename T, bool kSame>
cudaError_t fwd_launch(const Branches& br, int pos, int k, int mode,
                       float inv, void* out, int h, int w, const Tiling& tl,
                       dim3 grid, int smem, cudaStream_t s) {
  T* o = static_cast<T*>(out);
  auto kern = k == 3 ? cxn_pool_concat_fwd_tile<T, kSame, 3>
                     : cxn_pool_concat_fwd_tile<T, kSame, 0>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, kFwdThreads, smem, s>>>(br, pos, k, mode, inv, o, h, w, tl);
  return cudaSuccess;
}

// the vector route on one dtype, or the scalar route on any pair; the
// vector route's window of 3 unrolled
template <typename TY, typename TX>
cudaError_t bwd_launch(const BwdArgs& a, bool vec, dim3 grid, int threads,
                       int smem, cudaStream_t s) {
  void (*kern)(BwdArgs) = cxn_pool_concat_bwd_tile<TY, TX, false, 0>;
  if constexpr (sizeof(TY) == sizeof(TX)) {
    if (vec) {
      kern = a.k == 3 ? cxn_pool_concat_bwd_tile<TY, TX, true, 3>
                      : cxn_pool_concat_bwd_tile<TY, TX, true, 0>;
    }
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, threads, smem, s>>>(a);
  return cudaSuccess;
}

}  // namespace

// n branches (2..8): ptrs[q], strides[4q..4q+3] (elements), channels[q],
// dtypes[q] (0 float32, 1 bfloat16), vec[q] (1: the 16-byte route).
// out: dense (b, h, w, sum channels) of out_dtype. pos: the pool branch;
// k odd >= 1; mode 0 max, 1 avg; inv: 1/(k*k) in out_dtype (avg). tr,
// tw, cc: the tile (output rows, cols) and the channels a job, as
// layers/kernels.py pool_concat_plan chooses them; a vector route the
// branch cannot take is refused. Returns a cudaError_t value; 0 is
// success.
extern "C" int cxn_pool_concat_fwd(int n, const void* const* ptrs,
                                   const long long* strides,
                                   const int* channels, const int* dtypes,
                                   const int* vec, int pos, int k, int mode,
                                   float inv, void* out, int out_dtype, int b,
                                   int h, int w, int tr, int tw, int cc,
                                   void* stream) {
  if (n < 2 || n > kMaxBranches || pos < 0 || pos >= n || k < 1 ||
      k % 2 == 0 || (mode != 0 && mode != 1) || b <= 0 || h <= 0 || w <= 0 ||
      (out_dtype != 0 && out_dtype != 1) || tr < 1 || tw < 1 || cc < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int esz = out_dtype == 0 ? 4 : 2;
  const int v = 16 / esz;
  Branches br;
  br.n = n;
  br.off[0] = 0;
  br.jobs[0] = 0;
  bool same = true;
  for (int q = 0; q < n; ++q) {
    if (channels[q] <= 0 || (dtypes[q] != 0 && dtypes[q] != 1)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    br.ptr[q] = ptrs[q];
    for (int d = 0; d < 4; ++d) br.s[q][d] = strides[4 * q + d];
    br.dtype[q] = dtypes[q];
    br.vec[q] = vec[q] != 0;
    br.off[q + 1] = br.off[q] + channels[q];
    br.jobs[q + 1] = br.jobs[q] + (channels[q] + cc - 1) / cc;
    same = same && dtypes[q] == out_dtype;
  }
  for (int q = 0; q < n; ++q) {
    const int64_t* st = br.s[q];
    if (br.vec[q] &&
        (dtypes[q] != out_dtype || st[3] != 1 || st[0] % v || st[1] % v ||
         st[2] % v || channels[q] % v || br.off[q] % v || br.off[n] % v ||
         cc % v || reinterpret_cast<uintptr_t>(ptrs[q]) % 16 ||
         reinterpret_cast<uintptr_t>(out) % 16)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  Tiling tl;
  tl.tr = tr;
  tl.tw = tw;
  tl.cc = cc;
  tl.rtiles = (h + tr - 1) / tr;
  tl.ctiles = (w + tw - 1) / tw;
  const int64_t blocks = static_cast<int64_t>(b) * tl.rtiles * tl.ctiles;
  const int64_t smem =
      static_cast<int64_t>(tr + k - 1) * (tw + k - 1) * cc * esz;
  if (blocks >= (int64_t{1} << 31) || br.jobs[n] >= 65536 ||
      smem > 227 * 1024 ||
      static_cast<int64_t>(b) * h * w >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(br.jobs[n]));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int sm = static_cast<int>(smem);
  cudaError_t e;
  if (out_dtype == 0) {
    e = same ? fwd_launch<float, true>(br, pos, k, mode, inv, out, h, w, tl,
                                       grid, sm, s)
             : fwd_launch<float, false>(br, pos, k, mode, inv, out, h, w, tl,
                                        grid, sm, s);
  } else {
    e = same ? fwd_launch<__nv_bfloat16, true>(br, pos, k, mode, inv, out, h,
                                               w, tl, grid, sm, s)
             : fwd_launch<__nv_bfloat16, false>(br, pos, k, mode, inv, out,
                                                h, w, tl, grid, sm, s);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The pool branch's gradient. x: (b, h, w, c) of x_dtype through strides
// xs; dy and out: (b, h, w, ctot) of y_dtype through strides ds and os
// (out and os are read under max only), the pool segment at channel off;
// dx: dense (b, h, w, c) of x_dtype. k odd >= 1; mode 0 max, 1 avg; inv:
// float32 1/(k*k) (avg). vec (1: the 16-byte route), tr, tw, cc and
// threads as layers/kernels.py pool_concat_bwd_plan chooses them; a
// vector route the tensors cannot take is refused. Returns a cudaError_t
// value; 0 is success.
extern "C" int cxn_pool_concat_bwd(const void* x, int x_dtype,
                                   const long long* xs,
                                   const void* dy, const void* out,
                                   int y_dtype, const long long* ds,
                                   const long long* os, int off, int k,
                                   int mode, float inv, void* dx, int b,
                                   int h, int w, int c, int vec, int tr,
                                   int tw, int cc, int threads,
                                   void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || c <= 0 || off < 0 || k < 1 ||
      k % 2 == 0 || (mode != 0 && mode != 1) ||
      (x_dtype != 0 && x_dtype != 1) || (y_dtype != 0 && y_dtype != 1) ||
      (mode == 0 && out == nullptr) || tr < 1 || tw < 1 || cc < 1 ||
      threads < 32 || threads > kBwdThreads || threads % 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool avg = mode == 1;
  const int esz = y_dtype == 0 ? 4 : 2;
  const int v = 16 / esz;
  if (vec) {
    // dy's segment; under max also x and out's segment (avg reads no x)
    const long long* st[3] = {ds, xs, os};
    bool ok = x_dtype == y_dtype && c % v == 0 && cc % v == 0 &&
              off % v == 0 && reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
              reinterpret_cast<uintptr_t>(dx) % 16 == 0 &&
              (avg || (reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0));
    for (int t = 0; t < (avg ? 1 : 3); ++t) {
      ok = ok && st[t][3] == 1 && st[t][0] % v == 0 && st[t][1] % v == 0 &&
           st[t][2] % v == 0;
    }
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  }
  BwdArgs a;
  a.x = x;
  a.dy = dy;
  a.out = out;
  a.dx = dx;
  for (int d = 0; d < 4; ++d) {
    a.xs[d] = xs[d];
    a.ds[d] = ds[d];
    a.os[d] = avg ? 0 : os[d];
  }
  a.off = off;
  a.c = c;
  a.h = h;
  a.w = w;
  a.k = k;
  a.avg = avg;
  a.inv = inv;
  a.tr = tr;
  a.tw = tw;
  a.cc = cc;
  a.rtiles = (h + tr - 1) / tr;
  a.ctiles = (w + tw - 1) / tw;
  a.hr = min(tr + k - 1, h);
  a.hc = min(tw + k - 1, w);
  const int64_t blocks = static_cast<int64_t>(b) * a.rtiles * a.ctiles;
  const int64_t jobs = (c + cc - 1) / cc;
  // dy's halo, out's under max, and x's tile under max on the vector route
  const int64_t staged = static_cast<int64_t>(a.hr) * a.hc * (avg ? 1 : 2) +
                         (vec && !avg ? static_cast<int64_t>(tr) * tw : 0);
  const int64_t smem = staged * cc * esz;
  if (blocks >= (int64_t{1} << 31) || jobs >= 65536 || smem > 227 * 1024 ||
      static_cast<int64_t>(b) * h * w >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(jobs));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int sm = static_cast<int>(smem);
  cudaError_t e;
  if (y_dtype == 0) {
    e = x_dtype == 0
            ? bwd_launch<float, float>(a, vec != 0, grid, threads, sm, s)
            : bwd_launch<float, __nv_bfloat16>(a, vec != 0, grid, threads,
                                               sm, s);
  } else {
    e = x_dtype == 0
            ? bwd_launch<__nv_bfloat16, float>(a, vec != 0, grid, threads,
                                               sm, s)
            : bwd_launch<__nv_bfloat16, __nv_bfloat16>(a, vec != 0, grid,
                                                       threads, sm, s);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
