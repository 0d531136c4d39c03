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
// sizes and low pads per pass, and each pass's route) is computed once
// in Python (layers/kernels.py xla_bias_sum_plan, bias_grad_plan),
// which the plain version shares; this file runs it. Each pass is one
// launch:
//
//     out[w, c] = bf16 sum, row-major over the window w, of x[..., c]
//
// a sequential rounding sum per (window, channel) that no vectorized
// tensor op can reproduce. A zero pad adds +0 to a sum that is never -0
// (it starts at +0, and x + (-x) is +0), so the pad is skipped, not
// read.
//
// Replaces the reference's bias-gradient reduce, XLA code behind
// cxxnet_tpu/layers/conv.py:258 (conv) and common.py:100 (fullc); no
// Pallas kernel. PyTorch's autograd of the broadcast add sums in f32
// and rounds once, which is not the reference's sum.
//
// What bounds it: the chains, not the bytes. Each (window, channel) sum
// is one dependent chain of up to 32^3 rounded adds (25,088 on
// AlexNet's conv1 cotangent), and there are only windows x channels of
// them, so the floor is the longest window of each pass times the
// latency of one dependent add, summed over the passes (chip_smoke.py
// prints it beside the bytes bound as chain_bound_ms, from the latency
// cxn_bf16_add_chain measures: ~8.3 SM cycles on an H100, where ptxas
// alternates HADD2.BF16 and HFMA2.MMA.BF16). The design keeps every add
// on that chain and little else on the summing warp:
//
//   - one instruction per add: add.rn.bf16x2 (sm_90) adds two channels'
//     sums at once, each rounded once to bf16. That is the reference's
//     f32 add then round: the exact sum of two bf16 values rounded to
//     f32 and then to bf16 equals it rounded once to bf16 (f32's 24
//     bits are at least 2 x 8 + 1: Figueroa, "When is double rounding
//     innocuous?", 1995; both share the exponent range, and the sum of
//     two bf16 subnormals is exact in both). cxn_bf16_add_pairs lets
//     the card show it on edge classes (subnormals, signed zeros, inf);
//   - the "ring" route (unit channel stride, 16-byte aligned rows, C %
//     8 == 0): a block of two warps per (window, group of G channels),
//     a lane per channel pair. One warp copies the window into a ring
//     of 4 KiB stages in shared memory with 16-byte cp.async (its row
//     cursor split into (a, b, d) once, then stepped without a division
//     or a branch), completing each stage on an mbarrier; the other
//     waits on that mbarrier, loads the stage's rows into registers,
//     releases the slot on a second mbarrier and runs its adds back to
//     back. No block barrier in the loop. One copier per SM could not
//     feed the chains when the blocks covered half the card, so the
//     plan narrows G (64, 32, 16 channels) until the blocks fill it
//     (conv1 at 16 channels: 192 blocks where 64 would give 64); stages
//     of 32 to 128 rows keep the summer's per-stage wait small against
//     its adds;
//   - the "direct" route (any strides, an odd C, a short last dim, the
//     small partial passes): a warp per (window, 64 channels) loads a
//     lane's two channels per row into a register batch of kBatch rows
//     before it adds them.
//
// A single warp that both copies and adds issues several instructions
// a row besides its add, and its in-order issue puts them on the
// chain; hence the two warps. On an H100 the ring takes AlexNet's conv2
// cotangent (256, 27, 27, 256) to ~1.1x its chain (PERF.md).
//
// Plain C interface, loaded with ctypes. Launches go on the caller's
// stream; the entry returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr int kGroup = 2 * kLanes;  // channels a direct-route warp: a pair a lane
// the ring: kStages stages of kStageBytes (32 rows of 64 channels, 64
// of 32 or 128 of 16), and its mbarriers (two a stage), within the 48
// KiB of dynamic shared memory a block gets unasked
constexpr int kStageBytes = 4096;
constexpr int kStages = 11;
constexpr int kRingBytes = kStages * kStageBytes + 2 * kStages * 8;
constexpr int kBatch = 16;                  // rows a direct-route batch
constexpr int kMaxPasses = 8;
constexpr int kPlanInts = 11;               // n[3] w[3] lo[3] route group
enum Route { kDirect = 0, kRing = 1 };

// one add.rn.bf16x2: both halves rounded once to bf16
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ void store(__nv_bfloat16* p, uint32_t bits) {
  *p = __ushort_as_bfloat16(static_cast<unsigned short>(bits));
}
__device__ __forceinline__ void store(float* p, uint32_t bits) {
  *p = __uint_as_float(bits << 16);   // exact: bf16 to f32
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// 16 bytes global -> shared, of which the first `bytes` are read and
// the rest zero-filled (0: all zeros, nothing read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
// bar's arrival once this thread's cp.async copies so far have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

struct Pass {
  int n[3];     // windows per reduced dim
  int w[3];     // window size per reduced dim
  int lo[3];    // low zero pad per reduced dim
};

// The window of this block inside the unpadded (A, B, D, C) tensor: its
// origin, extents and element count, and the channel group's first
// channel (groups of `group` channels). blockIdx.x = window * groups +
// group.
struct Window {
  int a0, b0, d0, la, lb, ld, len, c0;
  int64_t index;
};

__device__ __forceinline__ Window window_of(const Pass& p, int a_dim,
                                            int b_dim, int d_dim, int c_dim,
                                            int group) {
  const int groups = (c_dim + group - 1) / group;
  Window r;
  r.c0 = (blockIdx.x % groups) * group;
  int q = blockIdx.x / groups;
  const int w2 = q % p.n[2];
  q /= p.n[2];
  const int w1 = q % p.n[1];
  const int w0 = q / p.n[1];
  r.a0 = max(0, w0 * p.w[0] - p.lo[0]);
  r.la = max(0, min(a_dim, (w0 + 1) * p.w[0] - p.lo[0]) - r.a0);
  r.b0 = max(0, w1 * p.w[1] - p.lo[1]);
  r.lb = max(0, min(b_dim, (w1 + 1) * p.w[1] - p.lo[1]) - r.b0);
  r.d0 = max(0, w2 * p.w[2] - p.lo[2]);
  r.ld = max(0, min(d_dim, (w2 + 1) * p.w[2] - p.lo[2]) - r.d0);
  r.len = r.la * r.lb * r.ld;
  r.index = (static_cast<int64_t>(w0) * p.n[1] + w1) * p.n[2] + w2;
  return r;
}

// The ring route. Block: two warps, one (window, group of G channels,
// G = 64, 32 or 16: narrower groups put more blocks, so more SMs'
// loads, on a window set that is small); x has unit channel stride,
// 16-byte aligned rows and base, and C % 8 == 0. Stage t of the block's
// ring holds the window's rows [t * kRows, (t + 1) * kRows) in
// row-major order, each the group's channels (2G bytes), zero-filled
// past the window and past C, so every stage adds kRows rows (a zero
// adds +0 to a sum that is never -0: exact). Warp 0 copies: lane l
// copies 16-byte chunk l % (G / 8) of rows l / (G / 8) + (256 / G) u,
// with cp.async, stepping its row cursor without a division or a
// branch after its first row, and the stage's mbarrier `full`
// completes when every lane's copies have landed; before it refills a
// slot it waits on the slot's `empty`. Warp 1 sums: it waits on
// `full`, lane l < G / 2 adds word l of each row (channels c0 + 2l,
// c0 + 2l + 1) in row order, and arrives on `empty`. No block barrier
// in the loop; the summing warp issues little besides its chain of adds.
template <typename TOut, int G>
__global__ void __launch_bounds__(2 * kLanes)
cxn_bias_window_ring(const __nv_bfloat16* __restrict__ x, int64_t s0,
                     int64_t s1, int64_t s2, int a_dim, int b_dim, int d_dim,
                     int c_dim, Pass p, TOut* __restrict__ out) {
  constexpr int kWords = G / 2;                  // words a row
  constexpr int kRows = kStageBytes / (G * 2);   // rows a stage
  constexpr int kChunks = G / 8;                 // 16-byte copies a row
  constexpr int kStep = kLanes / kChunks;        // rows a warp copy
  extern __shared__ __align__(16) uint32_t ring[];  // [kStages][kRows][G/2]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes / 4);
  uint64_t* empty = full + kStages;
  const Window win = window_of(p, a_dim, b_dim, d_dim, c_dim, G);
  const int lane = threadIdx.x % kLanes;
  const int nst = (win.len + kRows - 1) / kRows;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&full[st], kLanes);
      mbar_init(&empty[st], kLanes);
    }
  }
  __syncthreads();   // the barriers, once, before either warp starts
  if (threadIdx.x < kLanes) {
    // the copier: this lane's rows phase + kStep j, cursor (r, b, d) at
    // element offset off
    const int chunk = lane % kChunks;
    const int phase = lane / kChunks;
    const bool mine = win.c0 + chunk * 8 < c_dim;
    const int64_t carry = s1 - static_cast<int64_t>(win.ld) * s2;
    const int64_t wrap = s0 - static_cast<int64_t>(win.lb) * s1;
    // the first row, phase < kStep, may lie past the first line (ld can
    // be kStep / 2) or past the first plane (lb ld can be less than
    // kStep): split it into (a, b, d) once, so that the loop's cursor
    // starts with d < ld and b < lb
    const int plane = max(1, win.lb * win.ld);
    const int a = phase / plane;
    int b = (phase - a * plane) / max(1, win.ld);
    int d = phase - a * plane - b * win.ld;
    int r = phase;
    int64_t off = (win.a0 + a) * s0 + (win.b0 + b) * s1 +
                  (win.d0 + d) * s2 + win.c0 + chunk * 8;
    const uint32_t dst0 = smem_u32(ring) + phase * (G * 2) + chunk * 16;
    int slot = 0;
    uint32_t parity = 0;
#pragma unroll 1
    for (int t = 0; t < nst; ++t) {
      if (t >= kStages) mbar_wait(&empty[slot], parity ^ 1);
      const uint32_t dst = dst0 + slot * (kRows * G * 2);
#pragma unroll
      for (int u = 0; u < kRows / kStep; ++u) {
        const bool ok = mine && r < win.len;
        cp_async16(dst + u * kStep * (G * 2), ok ? x + off : x, ok ? 16 : 0);
        // step kStep rows: two carries at most, as d < ld and the
        // route keeps every window line at least kStep / 2 rows long
        // (d + kStep < 3 ld); each carry wraps b past the plane
        r += kStep;
        d += kStep;
        off += kStep * s2;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const bool cy = d >= win.ld;
          d = cy ? d - win.ld : d;
          b = cy ? b + 1 : b;
          const bool wr = b == win.lb;
          b = wr ? 0 : b;
          off += (cy ? carry : 0) + (wr ? wrap : 0);
        }
      }
      cp_async_arrive(&full[slot]);
      if (++slot == kStages) {
        slot = 0;
        parity ^= 1;
      }
    }
    cp_async_wait<0>();
    return;
  }
  // the summer
  const uint32_t* base = ring + (lane < kWords ? lane : 0);
  uint32_t acc = 0;   // +0, +0
  int slot = 0;
  uint32_t parity = 0;
#pragma unroll 1
  for (int t = 0; t < nst; ++t) {
    mbar_wait(&full[slot], parity);
    const uint32_t* st = base + slot * (kRows * kWords);
    uint32_t v[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) v[i] = st[i * kWords];
    asm volatile("" ::: "memory");   // every load issued before the adds
    mbar_arrive(&empty[slot]);       // the slot's words are in registers
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc = add_bf16x2(acc, v[i]);
    if (++slot == kStages) {
      slot = 0;
      parity ^= 1;
    }
  }
  const int c = win.c0 + 2 * lane;
  TOut* o = out + win.index * c_dim + c;
  if (lane < kWords && c < c_dim) store(o, acc & 0xffffu);
  if (lane < kWords && c + 1 < c_dim) store(o + 1, acc >> 16);
}

// The direct route, for any strides and C. Block: one warp, one
// (window, channel group); lane l loads channels c0 + 2l and c0 + 2l + 1
// of kBatch rows into registers (all loads issued before the first
// add), then adds them in row order.
template <typename TOut>
__global__ void __launch_bounds__(kLanes)
cxn_bias_window_direct(const __nv_bfloat16* __restrict__ x, int64_t s0,
                       int64_t s1, int64_t s2, int64_t s3, int a_dim,
                       int b_dim, int d_dim, int c_dim, Pass p,
                       TOut* __restrict__ out) {
  const Window win = window_of(p, a_dim, b_dim, d_dim, c_dim, kGroup);
  const int c = win.c0 + 2 * threadIdx.x;
  const bool ok0 = c < c_dim, ok1 = c + 1 < c_dim;
  const int64_t o0 = ok0 ? c * s3 : 0;
  const int64_t o1 = ok1 ? (c + 1) * s3 : 0;
  const __nv_bfloat16 zero = __ushort_as_bfloat16(0);
  // the window's row r = (a, b, d) at element offset off
  int b = 0, d = 0;
  int64_t off = win.a0 * s0 + win.b0 * s1 + win.d0 * s2;
  const int64_t carry = s1 - static_cast<int64_t>(win.ld) * s2;
  const int64_t wrap = s0 - static_cast<int64_t>(win.lb) * s1;
  uint32_t acc = 0;
#pragma unroll 1
  for (int r0 = 0; r0 < win.len; r0 += kBatch) {
    const int rows = min(kBatch, win.len - r0);
    uint32_t v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (u < rows) {
        v[u] = pack(ok0 ? x[off + o0] : zero, ok1 ? x[off + o1] : zero);
        off += s2;
        if (++d == win.ld) {
          d = 0;
          off += carry;
          if (++b == win.lb) {
            b = 0;
            off += wrap;
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (u < rows) acc = add_bf16x2(acc, v[u]);
    }
  }
  TOut* o = out + win.index * c_dim + c;
  if (ok0) store(o, acc & 0xffffu);
  if (ok1) store(o + 1, acc >> 16);
}

// the ring route at group width g: rows the copier's cursor steps (a
// window line must hold at least half of them)
int ring_step(int g) { return kLanes / (g / 8); }

bool ring_ok(const void* x, const int64_t (&s)[4], const int (&dims)[3],
             int c, int g) {
  return (g == 64 || g == 32 || g == 16) && s[3] == 1 && s[0] % 8 == 0 &&
         s[1] % 8 == 0 && s[2] % 8 == 0 && c % 8 == 0 &&
         2 * dims[2] >= ring_step(g) &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

template <typename TOut>
cudaError_t launch(const __nv_bfloat16* x, const int64_t (&s)[4],
                   const int (&dims)[3], int c, const Pass& p, int route,
                   int g, TOut* out, cudaStream_t stream) {
  const int group = route == kRing ? g : kGroup;
  const int64_t blocks = static_cast<int64_t>(p.n[0]) * p.n[1] * p.n[2] *
                         ((c + group - 1) / group);
  if (blocks >= (int64_t{1} << 31)) return cudaErrorInvalidValue;
  const unsigned n = static_cast<unsigned>(blocks);
  if (route == kRing) {
    auto kern = g == 64 ? cxn_bias_window_ring<TOut, 64>
                : g == 32 ? cxn_bias_window_ring<TOut, 32>
                          : cxn_bias_window_ring<TOut, 16>;
    kern<<<n, 2 * kLanes, kRingBytes, stream>>>(x, s[0], s[1], s[2], dims[0],
                                               dims[1], dims[2], c, p, out);
  } else {
    cxn_bias_window_direct<TOut><<<n, kLanes, 0, stream>>>(
        x, s[0], s[1], s[2], s[3], dims[0], dims[1], dims[2], c, p, out);
  }
  return cudaSuccess;
}

// ------------------------------------------------ measurement entries

// out = a + b elementwise, one add.rn.bf16x2 a pair
__global__ void cxn_bf16_add_pairs_k(const uint32_t* __restrict__ a,
                                     const uint32_t* __restrict__ b,
                                     uint32_t* __restrict__ out, int64_t n) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    out[i] = add_bf16x2(a[i], b[i]);
  }
}

// One warp: each lane adds word 32 + lane of x to word lane, n times,
// each add waiting on the last; writes the sums and the SM clock cycles
// the chain took on lane 0.
__global__ void __launch_bounds__(kLanes)
cxn_bf16_add_chain_k(const uint32_t* __restrict__ x, int n,
                     uint32_t* __restrict__ out,
                     long long* __restrict__ cycles) {
  uint32_t acc = x[threadIdx.x];
  const uint32_t v = x[kLanes + threadIdx.x];
  __syncwarp();
  const long long t0 = clock64();
#pragma unroll 16
  for (int i = 0; i < n; ++i) acc = add_bf16x2(acc, v);
  const long long t1 = clock64();
  out[threadIdx.x] = acc;
  if (threadIdx.x == 0) *cycles = t1 - t0;
}

}  // namespace

// dy: bfloat16 (a, b, d, c) read through element strides (sa, sb, sd,
// sc). plan: npass passes of 11 ints each (n0 n1 n2, w0 w1 w2, lo0 lo1
// lo2, route: 0 direct, 1 ring, the ring's group width: 64, 32 or 16);
// every pass but the last writes its partial sums into scratch (a bf16 buffer of scratch_elems values,
// ping-ponged between its halves), the last (one window per dim)
// writes c float32 values into out. A ring pass whose input cannot take
// it is refused. Returns a cudaError_t value; 0 is success.
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
    const int* pi = plan + kPlanInts * i;
    for (int j = 0; j < 3; ++j) {
      p.n[j] = pi[j];
      p.w[j] = pi[3 + j];
      p.lo[j] = pi[6 + j];
      if (p.n[j] < 1 || p.w[j] < 1 || p.lo[j] < 0) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    }
    const int route = pi[9];
    const int g = pi[10];
    if ((route != kDirect && route != kRing) ||
        (route == kRing && !ring_ok(src, strides, dims, c, g))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t e;
    if (i == npass - 1) {
      if (p.n[0] != 1 || p.n[1] != 1 || p.n[2] != 1) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      e = launch<float>(src, strides, dims, c, p, route, g,
                        static_cast<float*>(out), s);
      if (e != cudaSuccess) return static_cast<int>(e);
      break;
    }
    const int64_t need = static_cast<int64_t>(p.n[0]) * p.n[1] * p.n[2] * c;
    if (buf == nullptr || need > half) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    __nv_bfloat16* dst = buf + (i % 2) * half;
    e = launch<__nv_bfloat16>(src, strides, dims, c, p, route, g, dst, s);
    if (e != cudaSuccess) return static_cast<int>(e);
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

// Measurement entry (chip_smoke.py only, no training path): out = a + b
// over n bf16x2 words, one add.rn.bf16x2 each, to hold the instruction
// against the f32-add-then-round of the plain version on edge classes.
extern "C" int cxn_bf16_add_pairs(const void* a, const void* b, void* out,
                                  long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n + 255) / 256;
  cxn_bf16_add_pairs_k<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                         256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// Measurement entry (chip_smoke.py only): one warp runs a chain of n
// dependent add.rn.bf16x2 on x's 64 words; the sums go to out (32
// words), the chain's SM cycles to cycles (one int64 on the device).
extern "C" int cxn_bf16_add_chain(const void* x, int n, void* out,
                                  void* cycles, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cxn_bf16_add_chain_k<<<1, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), n, static_cast<uint32_t*>(out),
      static_cast<long long*>(cycles));
  return static_cast<int>(cudaGetLastError());
}
