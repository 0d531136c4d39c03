// bias_grad_bf16 for NVIDIA Hopper (sm_90a): the gradient of a bias
// added to a bfloat16 conv or fullc output, summed in bfloat16 in the
// order the reference's XLA:CPU build sums it.
//
// Under dtype = bfloat16 the reference adds bias.astype(bf16) to a bf16
// output; the transpose of that broadcast is a reduce of the bf16
// cotangent over every axis but the channel, whose add is a bf16 add
// (f32 add of two bf16 values, then one round to nearest even). XLA:CPU
// rewrites such a reduce into a tree (its optimized HLO shows it):
//
//   while some reduced dim is larger than 32:
//     every reduced dim d > 32 is zero-padded to a multiple of 32, the
//     pad split low = floor(pad / 2), high = the rest, and cut into
//     windows of 32; a dim of 32 or less is one window of its size;
//     each window is summed in row-major order from +0 (reduce-window)
//   then the windows' partials are summed in row-major order from +0
//
// and the bf16 sum is converted to the f32 bias. The plan (windows,
// sizes and low pads per pass) is computed once in Python
// (layers/kernels.py xla_bias_sum_plan), which the plain version shares;
// this file runs it. Each pass is one launch:
//
//     out[w, c] = bf16 sum, row-major over the window w, of x[..., c]
//
// with one lane per (window, channel): a sequential rounding sum that
// no vectorized tensor op can reproduce. A zero pad adds +0 to a sum
// that is never -0 (it starts at +0, and x + (-x) is +0), so the pad
// is skipped, not read.
//
// Replaces the reference's bias-gradient reduce, XLA code behind
// cxxnet_tpu/layers/conv.py:258 (conv) and common.py:100 (fullc); no
// Pallas kernel. PyTorch's autograd of the broadcast add sums in f32
// and rounds once, which is not the reference's sum.
//
// What bounds it: bytes in principle (each cotangent element is read
// once, 2 bytes, for one add), but the order makes each (window,
// channel) sum one dependent chain of up to 32^3 rounded adds, and there
// are only windows x channels chains (4 x 4 x 4 x 64 on kaiming-224's
// stem): the chain's latency bounds it. So the loads must not wait on
// the chain: a block takes one window and 32 channels; fifteen warps
// stage the window's elements a tile at a time into shared memory (a
// warp's loads are 32 neighbouring channels, a chunk of rows issued at
// once) while the first walks the previous tile, one lane per channel.
//
// Plain C interface, loaded with ctypes. Launches go on the caller's
// stream; the entry returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;                  // channels per block: one warp
constexpr int kWarps = 16;                  // warp 0 sums, 1..15 load
constexpr int kThreads = kLanes * kWarps;
constexpr int kTile = 256;                  // window elements per tile
// a loader warp's consecutive rows of a tile, all loads in flight at once
constexpr int kChunk = (kTile + kWarps - 2) / (kWarps - 1);
constexpr int kMaxPasses = 8;

__device__ __forceinline__ float bf16_add(float acc, float v) {
  return __bfloat162float(__float2bfloat16_rn(__fadd_rn(acc, v)));
}

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);   // exact: v is a bf16 value
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

struct Pass {
  int n[3];     // windows per reduced dim
  int w[3];     // window size per reduced dim
  int lo[3];    // low zero pad per reduced dim
};

// Block (window, channel group): the window's elements inside the
// unpadded (A, B, D, C) tensor x (strides s0..s3), in row-major order,
// for kLanes channels from c0. Warps 1..kWarps-1 stage kTile elements x
// kLanes channels at a time into shared memory (double-buffered; each
// loader warp kChunk consecutive elements, its loads all issued before
// its stores) while warp 0 walks the previous tile, one lane per
// channel, adding each element to its channel's bf16 sum in order. out
// is the dense (n0, n1, n2, C) tensor of the windows' sums.
template <typename TOut>
__global__ void __launch_bounds__(kThreads)
cxn_bias_window_sum(const __nv_bfloat16* __restrict__ x, int64_t s0,
                    int64_t s1, int64_t s2, int64_t s3, int a_dim, int b_dim,
                    int d_dim, int c_dim, Pass p, TOut* __restrict__ out) {
  __shared__ __nv_bfloat16 tile[2][kTile][kLanes];
  const int groups = (c_dim + kLanes - 1) / kLanes;
  const int c0 = (blockIdx.x % groups) * kLanes;
  int q = blockIdx.x / groups;
  const int w2 = q % p.n[2];
  q /= p.n[2];
  const int w1 = q % p.n[1];
  const int w0 = q / p.n[1];
  // the window's box inside the unpadded tensor
  const int a0 = max(0, w0 * p.w[0] - p.lo[0]);
  const int la = min(a_dim, (w0 + 1) * p.w[0] - p.lo[0]) - a0;
  const int b0 = max(0, w1 * p.w[1] - p.lo[1]);
  const int lb = min(b_dim, (w1 + 1) * p.w[1] - p.lo[1]) - b0;
  const int d0 = max(0, w2 * p.w[2] - p.lo[2]);
  const int ld = min(d_dim, (w2 + 1) * p.w[2] - p.lo[2]) - d0;
  const int len = max(0, la) * max(0, lb) * max(0, ld);
  const int ntiles = (len + kTile - 1) / kTile;
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int c = c0 + lane;
  const __nv_bfloat16* xc = x + (c < c_dim ? c : 0) * s3;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);

  // loader warp `warp` stages its chunk of elements [r0, r0 + kTile)
  auto stage = [&](int buf, int r0) {
    const int row0 = (warp - 1) * kChunk;
    int r = r0 + row0;
    if (row0 >= kTile || r >= len) return;
    int d = r % ld;
    int b = (r / ld) % lb;
    int a = r / (ld * lb);
    __nv_bfloat16 v[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const bool ok = row0 + u < kTile && r + u < len && c < c_dim;
      v[u] = ok ? xc[(a0 + a) * s0 + (b0 + b) * s1 + (d0 + d) * s2] : zero;
      if (++d == ld) {
        d = 0;
        if (++b == lb) {
          b = 0;
          ++a;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      if (row0 + u < kTile) tile[buf][row0 + u][lane] = v[u];
    }
  };
  if (warp > 0 && ntiles > 0) stage(0, 0);
  __syncthreads();
  float acc = 0.0f;
  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    if (warp == 0) {
      const int rows = min(kTile, len - t * kTile);
#pragma unroll 8
      for (int row = 0; row < rows; ++row) {
        acc = bf16_add(acc, __bfloat162float(tile[buf][row][lane]));
      }
    } else if (t + 1 < ntiles) {
      stage(buf ^ 1, (t + 1) * kTile);
    }
    __syncthreads();
  }
  if (warp == 0 && c < c_dim) {
    const int64_t win = (static_cast<int64_t>(w0) * p.n[1] + w1) * p.n[2] + w2;
    store(out + win * c_dim + c, acc);
  }
}

template <typename TOut>
void launch(const __nv_bfloat16* x, const int64_t (&s)[4],
            const int (&dims)[3], int c, const Pass& p, TOut* out,
            cudaStream_t stream) {
  const int64_t blocks = static_cast<int64_t>(p.n[0]) * p.n[1] * p.n[2] *
                         ((c + kLanes - 1) / kLanes);
  cxn_bias_window_sum<TOut><<<static_cast<unsigned>(blocks), kThreads, 0,
                              stream>>>(x, s[0], s[1], s[2], s[3], dims[0],
                                        dims[1], dims[2], c, p, out);
}

}  // namespace

// dy: bfloat16 (a, b, d, c) read through element strides (sa, sb, sd,
// sc). plan: npass passes of 9 ints each (n0 n1 n2, w0 w1 w2, lo0 lo1
// lo2); every pass but the last writes its partial sums into scratch (a
// bf16 buffer of scratch_elems values, ping-ponged between its halves),
// the last (one window per dim) writes c float32 values into out.
// Returns a cudaError_t value; 0 is success.
extern "C" int cxn_bias_grad_bf16(const void* dy, long long sa, long long sb,
                                  long long sd, long long sc, int a, int b,
                                  int d, int c, int npass, const int* plan,
                                  void* scratch, long long scratch_elems,
                                  void* out, void* stream) {
  if (a <= 0 || b <= 0 || d <= 0 || c <= 0 || npass < 1 ||
      npass > kMaxPasses || plan == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(dy);
  int64_t strides[4] = {sa, sb, sd, sc};
  int dims[3] = {a, b, d};
  __nv_bfloat16* buf = static_cast<__nv_bfloat16*>(scratch);
  const int64_t half = scratch_elems / 2;
  for (int i = 0; i < npass; ++i) {
    Pass p;
    for (int j = 0; j < 3; ++j) {
      p.n[j] = plan[9 * i + j];
      p.w[j] = plan[9 * i + 3 + j];
      p.lo[j] = plan[9 * i + 6 + j];
      if (p.n[j] < 1 || p.w[j] < 1 || p.lo[j] < 0) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    }
    if (i == npass - 1) {
      if (p.n[0] != 1 || p.n[1] != 1 || p.n[2] != 1) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      launch<float>(src, strides, dims, c, p, static_cast<float*>(out), s);
      break;
    }
    const int64_t need = static_cast<int64_t>(p.n[0]) * p.n[1] * p.n[2] * c;
    if (buf == nullptr || need > half) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    __nv_bfloat16* dst = buf + (i % 2) * half;
    launch<__nv_bfloat16>(src, strides, dims, c, p, dst, s);
    // the partials are dense (n0, n1, n2, c): the next pass's input
    src = dst;
    strides[0] = static_cast<int64_t>(p.n[1]) * p.n[2] * c;
    strides[1] = static_cast<int64_t>(p.n[2]) * c;
    strides[2] = c;
    strides[3] = 1;
    for (int j = 0; j < 3; ++j) dims[j] = p.n[j];
  }
  return static_cast<int>(cudaGetLastError());
}
