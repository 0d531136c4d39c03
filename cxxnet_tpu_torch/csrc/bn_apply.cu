// bn_apply for NVIDIA Hopper (sm_90a): the folded batch-norm epilogue
// of the training forward and its backward, float32.
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
// Replaces the TPU Pallas kernel cxxnet_tpu/layers/pallas_kernels.py:
// 247-291 (_bn_apply_kernel / _bn_apply_call) and its VJP :294-322. The
// reference's VJP runs the forward kernel again for dx (shift 0) and
// leaves the two channel sums to XLA; here the backward is ONE pass
// that reads x, y and dy once and writes dx, with the sums reduced on
// the way. It does not depend on how scale and shift were made, so
// conv_epilogue's VJP (pallas_kernels.py:367-400) can call it as is.
//
// What bounds it: bytes. The forward reads x and writes y (8 bytes and
// 2 flops per element); the backward reads x, y, dy and writes dx (16
// bytes and 5 flops per element). Both sit far below the ~20 flop/byte
// at which the card's f32 units become the limit. The design:
//   - forward: conv_epilogue's grid-stride loop over 16-byte float4
//     vectors (scalar when C % 4 != 0), scale and shift through the
//     read-only cache, the multiply and the add rounded separately
//     (__fmul_rn, __fadd_rn) as PyTorch rounds them, so the kernel and
//     its plain version agree bit for bit;
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

template <bool kRelu>
__device__ __forceinline__ float apply(float x, float s, float t) {
  float y = __fadd_rn(__fmul_rn(x, s), t);
  if (kRelu) y = (y < 0.0f) ? 0.0f : y;   // NaN passes, as in torch.relu
  return y;
}

// ---------------------------------------------------------------- forward

template <bool kRelu>
__global__ void __launch_bounds__(kThreads)
cxn_bn_fwd_vec4(const float* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ shift, float* __restrict__ y,
                int64_t n4, int c4) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int step = static_cast<int>(stride % c4);
  int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int cv = static_cast<int>(v % c4);
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* s4 = reinterpret_cast<const float4*>(scale);
  const float4* t4 = reinterpret_cast<const float4*>(shift);
  float4* y4 = reinterpret_cast<float4*>(y);
  for (; v < n4; v += stride) {
    const float4 s = __ldg(s4 + cv);
    const float4 t = __ldg(t4 + cv);
    const float4 a = x4[v];
    y4[v] = make_float4(apply<kRelu>(a.x, s.x, t.x), apply<kRelu>(a.y, s.y, t.y),
                        apply<kRelu>(a.z, s.z, t.z), apply<kRelu>(a.w, s.w, t.w));
    cv += step;
    if (cv >= c4) cv -= c4;
  }
}

template <bool kRelu>
__global__ void __launch_bounds__(kThreads)
cxn_bn_fwd_scalar(const float* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ shift, float* __restrict__ y, int64_t n,
                  int c) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int step = static_cast<int>(stride % c);
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int ci = static_cast<int>(i % c);
  for (; i < n; i += stride) {
    y[i] = apply<kRelu>(x[i], __ldg(scale + ci), __ldg(shift + ci));
    ci += step;
    if (ci >= c) ci -= c;
  }
}

template <bool kRelu>
void launch_fwd(const float* x, const float* scale, const float* shift,
                float* y, int64_t n, int c, cudaStream_t stream) {
  const bool vec = (c % 4 == 0) && aligned(x, 16) && aligned(y, 16) &&
                   aligned(scale, 16) && aligned(shift, 16);
  const int64_t work = vec ? n / 4 : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sm_count()) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  if (vec) {
    cxn_bn_fwd_vec4<kRelu><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        x, scale, shift, y, work, c / 4);
  } else {
    cxn_bn_fwd_scalar<kRelu><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        x, scale, shift, y, work, c);
  }
}

// --------------------------------------------------------------- backward

template <int V>
__device__ __forceinline__ void loadv(const float* p, float (&a)[V]);
template <>
__device__ __forceinline__ void loadv<4>(const float* p, float (&a)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  a[0] = q.x; a[1] = q.y; a[2] = q.z; a[3] = q.w;
}
template <>
__device__ __forceinline__ void loadv<1>(const float* p, float (&a)[1]) {
  a[0] = *p;
}

template <int V>
__device__ __forceinline__ void storev(float* p, const float (&a)[V]);
template <>
__device__ __forceinline__ void storev<4>(float* p, const float (&a)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
}
template <>
__device__ __forceinline__ void storev<1>(float* p, const float (&a)[1]) {
  *p = a[0];
}

// Block (blockIdx.x, blockIdx.y): rows [bx*rows_per_block, ...) and the
// channel vectors [by*ct, by*ct + tile). Thread tid works on vector
// tid % tile of the tile and on every rpi-th row from tid / tile.
// part is (2, gridDim.x, c): the block's dscale row, then its dshift row.
template <int V, bool kRelu>
__global__ void __launch_bounds__(kThreads)
cxn_bn_bwd_partial(const float* __restrict__ x, const float* __restrict__ y,
                   const float* __restrict__ dy, const float* __restrict__ scale,
                   float* __restrict__ dx, float* __restrict__ part, int64_t rows,
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
        o[j] = __fadd_rn(__fmul_rn(dv[j], s[j]), 0.0f);
        acc_s[j] += __fmul_rn(dv[j], xv[j]);
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

template <int V, bool kRelu>
void launch_bwd(const float* x, const float* y, const float* dy,
                const float* scale, float* dx, float* part, int max_blocks,
                float* dscale, float* dshift, int64_t rows, int c,
                int64_t ld_dy, cudaStream_t stream) {
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
  cxn_bn_bwd_partial<V, kRelu><<<grid, kThreads, 0, stream>>>(
      x, y, dy, scale, dx, part, rows, c, ld_dy, rows_per_block, ct);
  cxn_bn_bwd_finish<<<(c + kFinishLanes - 1) / kFinishLanes, kThreads, 0,
                      stream>>>(part, static_cast<int>(nbx), c, dscale,
                                dshift);
}

}  // namespace

// n elements, c channels (n % c == 0), all float32 and contiguous.
// Returns a cudaError_t value; 0 is success.
extern "C" int cxn_bn_apply_fwd(const void* x, const void* scale,
                                const void* shift, void* y, long long n,
                                int c, int relu, void* stream) {
  if (n <= 0 || c <= 0 || n % c != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* xf = static_cast<const float*>(x);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  float* yf = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (relu) {
    launch_fwd<true>(xf, sc, sh, yf, n, c, s);
  } else {
    launch_fwd<false>(xf, sc, sh, yf, n, c, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// rows x c float32 tensors; x, y and dx contiguous, dy with row stride
// ld_dy >= c; y may be null when relu == 0. part is a float32 scratch of
// 2 * max_blocks * c values. dscale and dshift receive c float32 sums.
// Returns a cudaError_t value; 0 is success.
extern "C" int cxn_bn_apply_bwd(const void* x, const void* y,
                                const void* dy, const void* scale, void* dx,
                                void* part, int max_blocks, void* dscale,
                                void* dshift, long long rows, int c,
                                long long ld_dy, int relu, void* stream) {
  if (rows <= 0 || c <= 0 || ld_dy < c || max_blocks < 1 ||
      (relu && y == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  const float* df = static_cast<const float*>(dy);
  const float* sc = static_cast<const float*>(scale);
  float* dxf = static_cast<float*>(dx);
  float* pf = static_cast<float*>(part);
  float* ds = static_cast<float*>(dscale);
  float* dt = static_cast<float*>(dshift);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (c % 4 == 0) && (ld_dy % 4 == 0) && aligned(x, 16) &&
                   aligned(dy, 16) && aligned(dx, 16) && aligned(scale, 16) &&
                   (!relu || aligned(y, 16));
  if (vec && relu) {
    launch_bwd<4, true>(xf, yf, df, sc, dxf, pf, max_blocks, ds, dt, rows, c,
                        ld_dy, s);
  } else if (vec) {
    launch_bwd<4, false>(xf, yf, df, sc, dxf, pf, max_blocks, ds, dt, rows, c,
                         ld_dy, s);
  } else if (relu) {
    launch_bwd<1, true>(xf, yf, df, sc, dxf, pf, max_blocks, ds, dt, rows, c,
                        ld_dy, s);
  } else {
    launch_bwd<1, false>(xf, yf, df, sc, dxf, pf, max_blocks, ds, dt, rows, c,
                         ld_dy, s);
  }
  return static_cast<int>(cudaGetLastError());
}
