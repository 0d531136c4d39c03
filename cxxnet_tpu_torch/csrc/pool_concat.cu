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
// k*k compares and adds). The design: blocks stride over the output
// (forward) or input (backward) pixels and a block's threads over the
// pixel's channels, branch by branch, so a warp's loads and stores are
// contiguous in every dense tensor, no division runs per element and a
// branch's parameters are loaded once per pixel; a 3 x 3 window (every
// Inception module's) is unrolled, so its nine loads are in flight
// together; 64-bit offsets; the k*k re-reads of neighbouring windows hit
// L1/L2. It stays latency-bound (few loads in flight per thread): 5-10x
// its bound at the tower's shapes on an H100. Several pixels or vector
// loads per thread, and shared-memory tiling of the window, are later
// work.
//
// Plain C interface, loaded with ctypes. Launches go on the caller's
// stream; each entry returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBlocksPerSm = 16;
constexpr int kMaxBranches = 8;

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

// one block per pixel, at most kBlocksPerSm per SM (the blocks stride)
unsigned grid_for(int64_t npix) {
  int64_t blocks = npix;
  const int64_t cap = static_cast<int64_t>(sm_count()) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned>(blocks);
}

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

struct Branches {
  const void* ptr[kMaxBranches];
  int64_t s[kMaxBranches][4];   // element strides (b, h, w, c)
  int off[kMaxBranches + 1];    // channel offsets; off[n] = total
  int dtype[kMaxBranches];      // 0 float32, 1 bfloat16
  int n;
};

// ---------------------------------------------------------------- forward

// Block-strided over the B*H*W output pixels; per pixel the block walks
// the branches in turn (each branch's pointer, strides and dtype are
// block-uniform and loaded once per pixel) and its threads walk the
// branch's channels, so a warp's stores and its loads from every dense
// branch are contiguous.
// K > 0 fixes the window at compile time (its k*k loads unrolled and in
// flight together); K = 0 reads it from k.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
cxn_pool_concat_fwd_k(const __grid_constant__ Branches br, int pos, int k_rt,
                      int avg, float inv, T* __restrict__ out, int npix,
                      int h, int w) {
  using A = Arith<T>;
  const int k = K > 0 ? K : k_rt;
  const int ctot = br.off[br.n];
  const int p = k / 2;
  for (int pix = blockIdx.x; pix < npix; pix += gridDim.x) {
    const int j = pix % w;
    const int i = (pix / w) % h;
    const int64_t b = pix / (w * h);
    T* orow = out + static_cast<int64_t>(pix) * ctot;
    for (int q = 0; q < br.n; ++q) {
      const void* xp = br.ptr[q];
      const int64_t s1 = br.s[q][1], s2 = br.s[q][2], s3 = br.s[q][3];
      const int64_t base = b * br.s[q][0];
      const int dt = br.dtype[q];
      const int off = br.off[q];
      const int cq = br.off[q + 1] - off;
      if (q != pos) {
        const int64_t at = base + i * s1 + j * s2;
        for (int c = threadIdx.x; c < cq; c += blockDim.x) {
          A::store(orow + off + c, A::cast(load_as_f32(xp, at + c * s3, dt)));
        }
        continue;
      }
      for (int c = threadIdx.x; c < cq; c += blockDim.x) {
        const int64_t at = base + c * s3;
        float y = 0.0f;
#pragma unroll
        for (int di = 0; di < k; ++di) {
          const int ii = i + di - p;
          const bool row_in = ii >= 0 && ii < h;
#pragma unroll
          for (int dj = 0; dj < k; ++dj) {
            const int jj = j + dj - p;
            const float v = (row_in && jj >= 0 && jj < w)
                ? A::cast(load_as_f32(xp, at + ii * s1 + jj * s2, dt))
                : 0.0f;
            if (di == 0 && dj == 0) {
              y = v;
            } else {
              y = avg ? A::add(y, v) : max_nan(y, v);
            }
          }
        }
        if (avg) y = A::mul(y, inv);
        A::store(orow + off + c, y);
      }
    }
  }
}

// --------------------------------------------------------------- backward

// The pool branch's input (B, H, W, C) into dense dx of dtype TX, laid
// out as the forward: block-strided over pixels, threads over channels.
// x read through strides xs; dy and out (the forward's output, for the
// max residual) through theirs, both of y_dtype.
template <typename TX, int K>
__global__ void __launch_bounds__(kThreads)
cxn_pool_concat_bwd_k(const void* __restrict__ x, int x_dtype, int64_t xs0,
                      int64_t xs1, int64_t xs2, int64_t xs3,
                      const void* __restrict__ dy, const void* __restrict__ out,
                      int y_dtype, int64_t ds0, int64_t ds1, int64_t ds2,
                      int64_t ds3, int64_t os0, int64_t os1, int64_t os2,
                      int64_t os3, int off, int k_rt, int avg, float inv,
                      TX* __restrict__ dx, int npix, int h, int w, int c) {
  const int k = K > 0 ? K : k_rt;
  const int p = k / 2;
  for (int pix = blockIdx.x; pix < npix; pix += gridDim.x) {
    const int j = pix % w;
    const int i = (pix / w) % h;
    const int64_t b = pix / (w * h);
    for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
      const int64_t dbase = b * ds0 + (off + ch) * ds3;
      const int64_t obase = b * os0 + (off + ch) * os3;
      const float xv = avg ? 0.0f
                           : load_as_f32(x, b * xs0 + i * xs1 + j * xs2 +
                                                ch * xs3, x_dtype);
      float acc = 0.0f;
#pragma unroll
      for (int di = 0; di < k; ++di) {
        const int oi = i + p - di;
        if (oi < 0 || oi >= h) continue;
#pragma unroll
        for (int dj = 0; dj < k; ++dj) {
          const int oj = j + p - dj;
          if (oj < 0 || oj >= w) continue;
          const float g =
              load_as_f32(dy, dbase + oi * ds1 + oj * ds2, y_dtype);
          if (avg) {
            acc += __fmul_rn(g, inv);
          } else if (xv == load_as_f32(out, obase + oi * os1 + oj * os2,
                                       y_dtype)) {
            acc += g;
          }
        }
      }
      Arith<TX>::store(dx + static_cast<int64_t>(pix) * c + ch,
                       Arith<TX>::cast(acc));
    }
  }
}

// the window every Inception module uses (3) unrolled, any other odd k
// at run time
template <typename T>
void fwd_launch(const Branches& br, int pos, int k, int mode, float inv,
                void* out, int np, int h, int w, cudaStream_t s) {
  T* o = static_cast<T*>(out);
  if (k == 3) {
    cxn_pool_concat_fwd_k<T, 3><<<grid_for(np), kThreads, 0, s>>>(
        br, pos, k, mode, inv, o, np, h, w);
  } else {
    cxn_pool_concat_fwd_k<T, 0><<<grid_for(np), kThreads, 0, s>>>(
        br, pos, k, mode, inv, o, np, h, w);
  }
}

template <typename TX>
void bwd_launch(const void* x, int x_dtype, const long long* xs,
                const void* dy, const void* out, int y_dtype,
                const long long* ds, const long long* os, int off, int k,
                int mode, float inv, void* dx, int np, int h, int w, int c,
                cudaStream_t s) {
  TX* d = static_cast<TX*>(dx);
  if (k == 3) {
    cxn_pool_concat_bwd_k<TX, 3><<<grid_for(np), kThreads, 0, s>>>(
        x, x_dtype, xs[0], xs[1], xs[2], xs[3], dy, out, y_dtype, ds[0],
        ds[1], ds[2], ds[3], os[0], os[1], os[2], os[3], off, k, mode, inv,
        d, np, h, w, c);
  } else {
    cxn_pool_concat_bwd_k<TX, 0><<<grid_for(np), kThreads, 0, s>>>(
        x, x_dtype, xs[0], xs[1], xs[2], xs[3], dy, out, y_dtype, ds[0],
        ds[1], ds[2], ds[3], os[0], os[1], os[2], os[3], off, k, mode, inv,
        d, np, h, w, c);
  }
}

}  // namespace

// n branches (2..8): ptrs[q], strides[4q..4q+3] (elements), channels[q],
// dtypes[q] (0 float32, 1 bfloat16). out: dense (b, h, w, sum channels)
// of out_dtype. pos: the pool branch; k odd >= 3; mode 0 max, 1 avg;
// inv: 1/(k*k) in out_dtype (avg). Returns a cudaError_t value; 0 is
// success.
extern "C" int cxn_pool_concat_fwd(int n, const void* const* ptrs,
                                   const long long* strides,
                                   const int* channels, const int* dtypes,
                                   int pos, int k, int mode, float inv,
                                   void* out, int out_dtype, int b, int h,
                                   int w, void* stream) {
  if (n < 2 || n > kMaxBranches || pos < 0 || pos >= n || k < 1 ||
      k % 2 == 0 || (mode != 0 && mode != 1) || b <= 0 || h <= 0 || w <= 0 ||
      (out_dtype != 0 && out_dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Branches br;
  br.n = n;
  br.off[0] = 0;
  for (int q = 0; q < n; ++q) {
    if (channels[q] <= 0 || (dtypes[q] != 0 && dtypes[q] != 1)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    br.ptr[q] = ptrs[q];
    for (int d = 0; d < 4; ++d) br.s[q][d] = strides[4 * q + d];
    br.dtype[q] = dtypes[q];
    br.off[q + 1] = br.off[q] + channels[q];
  }
  const int64_t npix = static_cast<int64_t>(b) * h * w;
  if (npix >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int np = static_cast<int>(npix);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0) {
    fwd_launch<float>(br, pos, k, mode, inv, out, np, h, w, s);
  } else {
    fwd_launch<__nv_bfloat16>(br, pos, k, mode, inv, out, np, h, w, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The pool branch's gradient. x: (b, h, w, c) of x_dtype through strides
// xs; dy and out: (b, h, w, ctot) of y_dtype through strides ds and os
// (out and os are read under max only), the pool segment at channel off; dx: dense (b, h, w, c) of x_dtype.
// k odd >= 1; mode 0 max, 1 avg; inv: float32 1/(k*k) (avg). Returns a
// cudaError_t value; 0 is success.
extern "C" int cxn_pool_concat_bwd(const void* x, int x_dtype,
                                   const long long* xs,
                                   const void* dy, const void* out,
                                   int y_dtype, const long long* ds,
                                   const long long* os, int off, int k,
                                   int mode, float inv, void* dx, int b,
                                   int h, int w, int c, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || c <= 0 || off < 0 || k < 1 ||
      k % 2 == 0 || (mode != 0 && mode != 1) ||
      (x_dtype != 0 && x_dtype != 1) || (y_dtype != 0 && y_dtype != 1) ||
      (mode == 0 && out == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t npix = static_cast<int64_t>(b) * h * w;
  if (npix >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int np = static_cast<int>(npix);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) {
    bwd_launch<float>(x, x_dtype, xs, dy, out, y_dtype, ds, os, off, k, mode,
                      inv, dx, np, h, w, c, s);
  } else {
    bwd_launch<__nv_bfloat16>(x, x_dtype, xs, dy, out, y_dtype, ds, os, off,
                              k, mode, inv, dx, np, h, w, c, s);
  }
  return static_cast<int>(cudaGetLastError());
}
