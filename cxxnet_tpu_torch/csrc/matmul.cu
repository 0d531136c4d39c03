// matmul for NVIDIA Hopper (sm_90a): C = A . B in float32,
//
//     C[m, n] = sum_k A[m, k] * B[k, n],
//
// with float32 or bfloat16 operands (each operand its own dtype), f32
// accumulation and a row-major f32 (M, N) output. Each operand comes
// with its strides, and one of them must be 1: A(m, k) sits at
// a[m * sam + k * sak], B(k, n) at b[k * sbk + n * sbn]. So the
// backward's dy . w^T and x^T . dy read the saved tensors through
// transposed views, with no copy, and a bf16 operand is read as it is,
// with no upcast copy: under dtype = bfloat16 the forward is
// bf16 . bf16, and the backward's products are f32 . bf16 (dy . w^T)
// and bf16 . f32 (x^T . dy), since the cotangent of the f32 output is
// f32.
//
// Replaces the TPU Pallas kernel cxxnet_tpu/layers/pallas_kernels.py:
// 35-66 (_matmul_kernel / _matmul_pallas_raw) and the two products of
// its VJP (:69-86), the kernel of the pallas_fullc layer. The Pallas
// version pads M and N to 256 and K to 8 with copies; here the ragged
// edges are masked in the kernel (zero-filled tile loads, guarded
// stores).
//
// What bounds it: at fullc sizes, the latency of a small product.
// Inception-BN's fc1 (M = 128 images, K = 1024, N = 1000) does 0.262
// GFLOP per product on 4.6 MB in f32. With TF32 off the f32 product is
// full f32, which the tensor cores do not compute, so its ceiling is
// the 67 TFLOP/s of the CUDA cores (3.9 us); a bf16 . bf16 product runs
// on the bf16 tensor cores (989 TFLOP/s), where its 2.3 MB of bytes
// bound it (0.7 us). Cut into output tiles alone, such a product makes
// a few dozen blocks for 132 SMs. Two routes, chosen by the host-side
// plan (kernels.matmul_plan in layers/kernels.py), which passes the
// route, the split count and the block count:
//
//   - cxn_sgemm_fma (f32 . f32, and any product with a f32 operand or
//     an operand that breaks TMA's rules): a 64 x 64 output tile per
//     128-thread block, 32-deep K slices staged in a ring of 4
//     shared-memory stages: f32 operands by 16-byte cp.async along
//     their contiguous dimension, bf16 operands by 16-byte loads held
//     in registers while the current slice is multiplied and converted
//     exactly on their way into shared memory; the next three slices
//     are in flight during the FMAs. Each of the block's two 64-thread
//     warp groups takes one 16-deep half of every slice, each thread
//     holding an 8 x 8 register tile updated by fmaf; the halves'
//     tiles are added (first + second) at the end.
//   - cxn_sgemm_wgmma (bf16 . bf16, A k-contiguous, B n-contiguous,
//     TMA-aligned): one warpgroup per 64 x 64 output tile runs wgmma
//     m64n64k16 with f32 accumulation, A and B brought in by TMA with
//     128-byte swizzle into a ring of 4 stages, completion on
//     mbarriers. B is read N-major, as w lies in memory ((K, N)
//     row-major), through the instruction's transpose bit: no copy of
//     w. The TMA descriptors are made on the host through
//     cudaGetDriverEntryPoint (no link against libcuda) and passed as
//     __grid_constant__ parameters.
//
// Both routes split K inside a thread-block cluster of `splits` CTAs
// (the cluster runs along gridDim.z; the plan keeps it to 4, since on
// the H100 an 8-CTA cluster took ~5 us longer to schedule at fc1's
// shapes): each CTA sums its K range, stores its rows of every other
// CTA's slice of the tile into that CTA's shared memory (distributed
// shared memory), and after one cluster barrier each CTA adds its
// slice's partial rows in split order. One launch per product, no
// scratch, no float atomics: the result repeats bit for bit. A product of two bf16 values
// is exact in f32, so either route differs from the plain version only
// by the order (and, on the tensor cores, the internal rounding) of
// its sums.
//
// Plain C interface, loaded with ctypes. The launch goes on the caller's
// stream; the return value is cudaGetLastError() after the launch.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSplits = 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Adds the cluster's partial (BM, BN) tiles, each at `part` (row pitch
// ldp floats) in its CTA's shared memory, in split (cluster rank)
// order, and stores the sum's rows that fall inside (M, N). CTA o owns
// the o-th slice of ceil(BM / splits) rows: every CTA first stores its
// rows of each slice into the owner's `recv` (slot = its rank; at
// least (BM + splits) * ldp floats, a region no CTA uses otherwise, so
// a CTA may fill another's while that one still computes) through
// distributed shared memory, then, after one cluster barrier, each
// owner adds its slots in rank order from its own shared memory and
// stores them. With one split the CTA stores its own tile, no
// exchange. Every thread of every CTA of the cluster calls it; no CTA
// touches another's shared memory after the barrier.
template <int BM, int BN, int kThreads>
__device__ __forceinline__ void cluster_reduce_store(const float* part,
                                                     float* recv, int ldp,
                                                     float* c, int M, int N,
                                                     int m0, int n0) {
  cg::cluster_group cl = cg::this_cluster();
  const int splits = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  const int rows = (BM + splits - 1) / splits;
  constexpr int kQuads = BN / 4;
  // one split: the CTA's own tile is the sum
  const float* sum = splits == 1 ? part : recv;
  for (int e = threadIdx.x; splits > 1 && e < BM * kQuads; e += kThreads) {
    const int r = e / kQuads;
    const int cc = (e % kQuads) * 4;
    const int owner = r / rows;
    float* dst = cl.map_shared_rank(recv, owner) +
                 (rank * rows + r - owner * rows) * ldp + cc;
    *reinterpret_cast<float4*>(dst) =
        *reinterpret_cast<const float4*>(part + r * ldp + cc);
  }
  if (splits > 1) cl.sync();
  const int r_begin = rank * rows;
  const int r_end = min(BM, r_begin + rows);
  const bool vec_out =
      (N % 4 == 0) && ((reinterpret_cast<uintptr_t>(c) & 15) == 0);
  for (int e = threadIdx.x; e < (r_end - r_begin) * kQuads; e += kThreads) {
    const int lr = e / kQuads;
    const int cc = (e % kQuads) * 4;
    const int gm = m0 + r_begin + lr, gn = n0 + cc;
    if (gm >= M || gn >= N) continue;
    float4 acc = *reinterpret_cast<const float4*>(sum + lr * ldp + cc);
    for (int q = 1; q < splits; ++q) {
      const float4 v =
          *reinterpret_cast<const float4*>(recv + (q * rows + lr) * ldp + cc);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    float* dst = c + static_cast<int64_t>(gm) * N + gn;
    if (vec_out && gn + 3 < N) {
      *reinterpret_cast<float4*>(dst) = acc;
    } else {
      dst[0] = acc.x;
      if (gn + 1 < N) dst[1] = acc.y;
      if (gn + 2 < N) dst[2] = acc.z;
      if (gn + 3 < N) dst[3] = acc.w;
    }
  }
}

// ------------------------------------------------------------ FMA route

constexpr int kFBM = 64;
constexpr int kFBN = 64;
constexpr int kFBK = 32;                     // a stage: two 16-deep halves
constexpr int kFQuarter = 16;
constexpr int kFGroups = kFBK / kFQuarter;   // warp groups, one a half
constexpr int kFGroupThreads = 64;           // 8 x 8 threads, 8 x 8 each
constexpr int kFThreads = kFGroups * kFGroupThreads;   // 128
constexpr int kFStages = 4;
constexpr int kKPitch = kFBK + 4;            // a k-contiguous tile's row
constexpr int kFStage = kFBM * kKPitch;      // floats, either operand
constexpr int kFPartPitch = kFBN + 4;
constexpr int kFPart = kFBM * kFPartPitch;   // one quarter's tile
// the stage ring (the quarters' tiles reuse it), then the receive slots
// of the split reduction, which other CTAs of the cluster may fill
// while this one still computes
constexpr int kFRing = kFStages * 2 * kFStage;
constexpr int kFSmemBytes = (kFRing + (kFBM + 8) * kFPartPitch) * 4;
static_assert(kFBM == kFBN, "one stage size serves both operands");
static_assert(kFGroups * kFPart <= kFRing,
              "the quarters' tiles reuse the stage ring");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  using raw = uint32_t;
  static constexpr int kPerChunk = 4;       // elements in 16 bytes
  static __device__ __forceinline__ float f32(uint32_t r) {
    return __uint_as_float(r);
  }
};
template <>
struct Elem<uint16_t> {                     // bfloat16 bits
  using raw = uint16_t;
  static constexpr int kPerChunk = 8;
  static __device__ __forceinline__ float f32(uint32_t r) {
    return __uint_as_float(r << 16);        // exact
  }
};

// Eight bf16 (one 16-byte chunk, raw) to eight floats in shared memory
__device__ __forceinline__ void store_bf16x8(float* dst, const uint4& q) {
  float4 lo, hi;
  lo.x = __uint_as_float(q.x << 16);
  lo.y = __uint_as_float(q.x & 0xffff0000u);
  lo.z = __uint_as_float(q.y << 16);
  lo.w = __uint_as_float(q.y & 0xffff0000u);
  hi.x = __uint_as_float(q.z << 16);
  hi.y = __uint_as_float(q.z & 0xffff0000u);
  hi.z = __uint_as_float(q.w << 16);
  hi.w = __uint_as_float(q.w & 0xffff0000u);
  reinterpret_cast<float4*>(dst)[0] = lo;
  reinterpret_cast<float4*>(dst)[1] = hi;
}

// One operand's (rows x kFBK) slice: kR = kFBM for A, kFBN for B.
// kKC: the operand is k-contiguous (its slice lands as [r][kKPitch]),
// else r-contiguous ([k][kR]). g(r, k) = p[r * ld + k] (kKC) or
// p[r + k * ld]. vec: 16-byte chunks along the contiguous dimension
// (base 16-byte aligned, ld and the contiguous extent whole chunks):
// f32 chunks go by cp.async, bf16 chunks through registers; otherwise
// element by element through registers.
template <typename T, int kR, bool kKC>
struct Loader {
  using E = Elem<T>;
  static constexpr int kPer = E::kPerChunk;
  static constexpr int kChunks = kR * kFBK / kPer;
  static constexpr int kChunksPerThread = kChunks / kFThreads;
  static constexpr int kElemsPerThread = kR * kFBK / kFThreads;
  static_assert(kChunks % kFThreads == 0, "whole chunks per thread");

  const T* p;
  int64_t ld;
  int extent_r, extent_k;
  bool vec;
  // bf16 chunks (4 words each) or single elements, in flight
  uint32_t raw[kElemsPerThread > 4 * kChunksPerThread
                   ? kElemsPerThread
                   : 4 * kChunksPerThread];

  __device__ __forceinline__ static float* slot(float* ring, int s) {
    return ring + s * kFStage;
  }

  // issue the loads of the slice at (r0, k0) for stage s
  __device__ __forceinline__ void issue(float* ring, int s, int r0, int k0) {
    float* dst = slot(ring, s);
    const int tid = threadIdx.x;
    if (vec) {
      constexpr int kCPR = kKC ? kFBK / kPer : kR / kPer;   // chunks a line
#pragma unroll
      for (int i = 0; i < kChunksPerThread; ++i) {
        const int e = tid + i * kFThreads;
        const int line = e / kCPR, q = e % kCPR;
        int r, k;
        if (kKC) {
          r = line;
          k = q * kPer;
        } else {
          k = line;
          r = q * kPer;
        }
        const int gr = r0 + r, gk = k0 + k;
        const bool ok = gr < extent_r && gk < extent_k;
        const T* src = ok ? (kKC ? p + static_cast<int64_t>(gr) * ld + gk
                                 : p + gr + static_cast<int64_t>(gk) * ld)
                          : p;
        float* d = kKC ? dst + r * kKPitch + k : dst + k * kR + r;
        if (sizeof(T) == 4) {
          cp_async16(d, src, ok);
        } else {
          uint4 q4 = make_uint4(0, 0, 0, 0);
          if (ok) q4 = __ldg(reinterpret_cast<const uint4*>(src));
          raw[4 * i + 0] = q4.x;
          raw[4 * i + 1] = q4.y;
          raw[4 * i + 2] = q4.z;
          raw[4 * i + 3] = q4.w;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kElemsPerThread; ++i) {
        const int e = tid + i * kFThreads;
        int r, k;
        if (kKC) {
          r = e / kFBK;
          k = e % kFBK;
        } else {
          k = e / kR;
          r = e % kR;
        }
        const int gr = r0 + r, gk = k0 + k;
        typename E::raw v = 0;
        if (gr < extent_r && gk < extent_k) {
          v = *reinterpret_cast<const typename E::raw*>(
              kKC ? p + static_cast<int64_t>(gr) * ld + gk
                  : p + gr + static_cast<int64_t>(gk) * ld);
        }
        raw[i] = v;
      }
    }
  }

  // store what issue() holds in registers into stage s
  __device__ __forceinline__ void finish(float* ring, int s) {
    if (vec && sizeof(T) == 4) return;      // cp.async wrote it
    float* dst = slot(ring, s);
    const int tid = threadIdx.x;
    if (vec) {
      constexpr int kCPR = kKC ? kFBK / kPer : kR / kPer;
#pragma unroll
      for (int i = 0; i < kChunksPerThread; ++i) {
        const int e = tid + i * kFThreads;
        const int line = e / kCPR, q = e % kCPR;
        float* d = kKC ? dst + line * kKPitch + q * kPer
                       : dst + line * kR + q * kPer;
        store_bf16x8(d, make_uint4(raw[4 * i], raw[4 * i + 1],
                                   raw[4 * i + 2], raw[4 * i + 3]));
      }
    } else {
#pragma unroll
      for (int i = 0; i < kElemsPerThread; ++i) {
        const int e = tid + i * kFThreads;
        int r, k;
        if (kKC) {
          r = e / kFBK;
          k = e % kFBK;
        } else {
          k = e / kR;
          r = e % kR;
        }
        dst[kKC ? r * kKPitch + k : k * kR + r] = E::f32(raw[i]);
      }
    }
  }
};

// TA, TB: float or uint16_t (bfloat16 bits). kAK: A is k-contiguous
// (sak == 1, lda = sam), else m-contiguous (sam == 1, lda = sak).
// kBN: B is n-contiguous (sbn == 1, ldb = sbk), else k-contiguous
// (sbk == 1, ldb = sbn). Grid (ceil(N / 64), ceil(M / 64), splits),
// clusters of (1, 1, splits). Warp group q (64 threads) multiplies the
// q-th 16-deep quarter of every stage; thread (ty, tx) of a group holds
// rows ty*4 + i and 32 + ty*4 + i of an m-contiguous A (ty + 8 i of a
// k-contiguous one) and columns tx*4 + j and 32 + tx*4 + j of an
// n-contiguous B (tx + 8 j of a k-contiguous one): every fragment read
// is a conflict-free 16-byte shared load.
template <typename TA, typename TB, bool kAK, bool kBN>
__global__ void __launch_bounds__(kFThreads, 1)
cxn_sgemm_fma(const TA* __restrict__ a, const TB* __restrict__ b,
              float* __restrict__ c, int M, int N, int K, int64_t lda,
              int64_t ldb, bool vec_a, bool vec_b) {
  extern __shared__ __align__(16) float fsmem[];
  float* ring_a = fsmem;
  float* ring_b = fsmem + kFStages * kFStage;
  const int tid = threadIdx.x;
  const int grp = tid / kFGroupThreads;
  const int tx = tid % 8;
  const int ty = (tid % kFGroupThreads) / 8;
  const int m0 = blockIdx.y * kFBM;
  const int n0 = blockIdx.x * kFBN;
  const int splits = gridDim.z;
  const int kt_total = (K + kFBK - 1) / kFBK;
  const int per = (kt_total + splits - 1) / splits;
  const int kt0 = blockIdx.z * per;
  const int nt = max(0, min(kt_total, kt0 + per) - kt0);

  Loader<TA, kFBM, kAK> la{a, lda, M, K, vec_a, {}};
  Loader<TB, kFBN, !kBN> lb{b, ldb, N, K, vec_b, {}};

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

#pragma unroll
  for (int t = 0; t < kFStages - 1; ++t) {
    if (t < nt) {
      la.issue(ring_a, t, m0, (kt0 + t) * kFBK);
      lb.issue(ring_b, t, n0, (kt0 + t) * kFBK);
      la.finish(ring_a, t);
      lb.finish(ring_b, t);
    }
    cp_async_commit();
  }

  for (int t = 0; t < nt; ++t) {
    cp_async_wait<kFStages - 2>();
    __syncthreads();
    const int nxt = t + kFStages - 1;
    const int ns = nxt % kFStages;
    if (nxt < nt) {
      la.issue(ring_a, ns, m0, (kt0 + nxt) * kFBK);
      lb.issue(ring_b, ns, n0, (kt0 + nxt) * kFBK);
    }
    cp_async_commit();
    const float* As = ring_a + (t % kFStages) * kFStage;
    const float* Bs = ring_b + (t % kFStages) * kFStage;
#pragma unroll
    for (int kq = 0; kq < kFQuarter; kq += 4) {
      const int k4 = grp * kFQuarter + kq;
      float av[8][4], bv[8][4];
      if (kAK) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 q = *reinterpret_cast<const float4*>(
              As + (ty + 8 * i) * kKPitch + k4);
          av[i][0] = q.x; av[i][1] = q.y; av[i][2] = q.z; av[i][3] = q.w;
        }
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 q0 =
              *reinterpret_cast<const float4*>(As + (k4 + u) * kFBM + ty * 4);
          const float4 q1 = *reinterpret_cast<const float4*>(
              As + (k4 + u) * kFBM + 32 + ty * 4);
          av[0][u] = q0.x; av[1][u] = q0.y; av[2][u] = q0.z; av[3][u] = q0.w;
          av[4][u] = q1.x; av[5][u] = q1.y; av[6][u] = q1.z; av[7][u] = q1.w;
        }
      }
      if (kBN) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 q0 =
              *reinterpret_cast<const float4*>(Bs + (k4 + u) * kFBN + tx * 4);
          const float4 q1 = *reinterpret_cast<const float4*>(
              Bs + (k4 + u) * kFBN + 32 + tx * 4);
          bv[0][u] = q0.x; bv[1][u] = q0.y; bv[2][u] = q0.z; bv[3][u] = q0.w;
          bv[4][u] = q1.x; bv[5][u] = q1.y; bv[6][u] = q1.z; bv[7][u] = q1.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 q = *reinterpret_cast<const float4*>(
              Bs + (tx + 8 * j) * kKPitch + k4);
          bv[j][0] = q.x; bv[j][1] = q.y; bv[j][2] = q.z; bv[j][3] = q.w;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[i][j] = fmaf(av[i][u], bv[j][u], acc[i][j]);
          }
        }
      }
    }
    if (nxt < nt) {
      la.finish(ring_a, ns);
      lb.finish(ring_b, ns);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  // the quarters' tiles over the stage ring, then their sum in quarter
  // order as the CTA's partial tile (in quarter 0's place)
  float* mine = fsmem + grp * kFPart;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = kAK ? ty + 8 * i : (i < 4 ? 0 : 32) + ty * 4 + (i & 3);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cc = kBN ? (j < 4 ? 0 : 32) + tx * 4 + (j & 3) : tx + 8 * j;
      mine[r * kFPartPitch + cc] = acc[i][j];
    }
  }
  __syncthreads();
  for (int e = tid; e < kFBM * kFBN / 4; e += kFThreads) {
    const int off = (e / (kFBN / 4)) * kFPartPitch + (e % (kFBN / 4)) * 4;
    float4 v = *reinterpret_cast<const float4*>(fsmem + off);
#pragma unroll
    for (int q = 1; q < kFGroups; ++q) {
      const float4 w = *reinterpret_cast<const float4*>(fsmem + q * kFPart + off);
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    *reinterpret_cast<float4*>(fsmem + off) = v;
  }
  __syncthreads();
  cluster_reduce_store<kFBM, kFBN, kFThreads>(fsmem, fsmem + kFRing,
                                              kFPartPitch, c, M, N, m0, n0);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename K, typename... Args>
cudaError_t launch_cluster(K kernel, dim3 grid, int threads, int smem,
                           int splits, cudaStream_t s, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename TA, typename TB>
cudaError_t launch_fma(const void* a, const void* b, float* c, int M, int N,
                       int K, bool a_k, bool b_n, int64_t lda, int64_t ldb,
                       int splits, cudaStream_t s) {
  const TA* at = static_cast<const TA*>(a);
  const TB* bt = static_cast<const TB*>(b);
  constexpr int pa = Elem<TA>::kPerChunk, pb = Elem<TB>::kPerChunk;
  // 16-byte chunks: aligned base, whole chunks per line and per stride
  const bool vec_a = aligned16(a) && lda % pa == 0 && (a_k ? K : M) % pa == 0;
  const bool vec_b = aligned16(b) && ldb % pb == 0 && (b_n ? N : K) % pb == 0;
  dim3 grid((N + kFBN - 1) / kFBN, (M + kFBM - 1) / kFBM, splits);
  if (a_k && b_n) {
    return launch_cluster(cxn_sgemm_fma<TA, TB, true, true>, grid, kFThreads,
                          kFSmemBytes, splits, s, at, bt, c, M, N, K, lda,
                          ldb, vec_a, vec_b);
  } else if (a_k) {
    return launch_cluster(cxn_sgemm_fma<TA, TB, true, false>, grid,
                          kFThreads, kFSmemBytes, splits, s, at, bt, c, M, N,
                          K, lda, ldb, vec_a, vec_b);
  } else if (b_n) {
    return launch_cluster(cxn_sgemm_fma<TA, TB, false, true>, grid,
                          kFThreads, kFSmemBytes, splits, s, at, bt, c, M, N,
                          K, lda, ldb, vec_a, vec_b);
  }
  return launch_cluster(cxn_sgemm_fma<TA, TB, false, false>, grid, kFThreads,
                        kFSmemBytes, splits, s, at, bt, c, M, N, K, lda, ldb,
                        vec_a, vec_b);
}

// ---------------------------------------------------------- wgmma route

constexpr int kWBM = 64;
constexpr int kWBN = 64;
constexpr int kWBK = 64;                     // 128 bytes of bf16: one
constexpr int kWThreads = 128;               // swizzle atom wide
constexpr int kWStages = 4;
constexpr int kWTile = kWBM * kWBK * 2;      // bytes, A or B, per stage
constexpr int kWPartPitch = kWBN + 4;
constexpr int kWSmemBytes = 1024 + 2 * kWStages * kWTile +
                            (2 * kWBM + 8) * kWPartPitch * 4 + kWStages * 8;

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
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
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// A shared-memory matrix descriptor for a 128-byte-swizzled tile:
// start address, leading and stride byte offsets (16-byte units), and
// the swizzle mode (1: 128 bytes) in bits 62-63.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void reg_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D(64 x 64, f32) += A(64 x 16, K-major) . B(16 x 64, N-major)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// Grid (ceil(N / 64), ceil(M / 64), splits), clusters of (1, 1, splits);
// tma_a maps A as (K, M) bf16, tma_b maps B as (N, K) bf16, both with
// 64 x 64 boxes and 128-byte swizzle.
__global__ void __launch_bounds__(kWThreads, 1)
cxn_sgemm_wgmma(const __grid_constant__ CUtensorMap tma_a,
                const __grid_constant__ CUtensorMap tma_b,
                float* __restrict__ c, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char wsmem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(wsmem) + 1023) & ~uintptr_t(1023));
  unsigned char* sa = base;
  unsigned char* sb = base + kWStages * kWTile;
  float* part = reinterpret_cast<float*>(sb + kWStages * kWTile);
  float* recv = part + kWBM * kWPartPitch;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(recv + (kWBM + 8) * kWPartPitch);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kWBM;
  const int n0 = blockIdx.x * kWBN;
  const int splits = gridDim.z;
  const int kb_total = (K + kWBK - 1) / kWBK;
  const int per = (kb_total + splits - 1) / splits;
  const int kb0 = blockIdx.z * per;
  const int nkb = max(0, min(kb_total, kb0 + per) - kb0);

  if (tid == 0) {
    for (int s = 0; s < kWStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < kWStages && s < nkb; ++s) {
      mbar_expect_tx(&full[s], 2 * kWTile);
      tma_load_2d(sa + s * kWTile, &tma_a, &full[s], (kb0 + s) * kWBK, m0);
      tma_load_2d(sb + s * kWTile, &tma_b, &full[s], n0, (kb0 + s) * kWBK);
    }
  }
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  for (int kb = 0; kb < nkb; ++kb) {
    const int s = kb % kWStages;
    mbar_wait(&full[s], (kb / kWStages) & 1);
    const unsigned char* ta = sa + s * kWTile;
    const unsigned char* tb = sb + s * kWTile;
    reg_fence(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWBK / 16; ++kk) {
      // A: rows of 128 bytes along K, 8-row groups 1024 bytes apart; a
      // k16 step moves 32 bytes along the row. B: rows of 128 bytes
      // along N, one per k; 8-k groups 1024 bytes apart; a k16 step
      // moves 16 rows.
      wgmma_m64n64k16(acc, smem_desc(ta + kk * 32, 16, 1024),
                      smem_desc(tb + kk * 16 * 128, 1024, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(acc);
    if (kb + kWStages < nkb) {
      __syncthreads();                       // every warp done with s
      if (tid == 0) {
        const int kn = kb0 + kb + kWStages;
        mbar_expect_tx(&full[s], 2 * kWTile);
        tma_load_2d(sa + s * kWTile, &tma_a, &full[s], kn * kWBK, m0);
        tma_load_2d(sb + s * kWTile, &tma_b, &full[s], n0, kn * kWBK);
      }
    }
  }
  // the accumulator fragment: warp w holds rows 16w .. 16w + 15; lane l
  // rows 16w + l / 4 (+ 8), columns 8i + 2 (l % 4) (+ 1)
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4;
#pragma unroll
  for (int i = 0; i < kWBN / 8; ++i) {
    const int col = 8 * i + 2 * (lane % 4);
    part[r0 * kWPartPitch + col] = acc[4 * i];
    part[r0 * kWPartPitch + col + 1] = acc[4 * i + 1];
    part[(r0 + 8) * kWPartPitch + col] = acc[4 * i + 2];
    part[(r0 + 8) * kWPartPitch + col + 1] = acc[4 * i + 3];
  }
  __syncthreads();
  cluster_reduce_store<kWBM, kWBN, kWThreads>(part, recv, kWPartPitch, c, M,
                                              N, m0, n0);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (rows, ld) bf16 matrix as a TMA map: dims (cols, rows), 64 x 64 boxes
bool make_map(CUtensorMap* map, const void* p, int rows, int cols,
              int64_t ld) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// a: (M, K) with strides (sam, sak); b: (K, N) with strides (sbk, sbn);
// c: (M, N) row-major float32. a_dtype and b_dtype: 0 float32, 1
// bfloat16. One stride of each operand must be 1. K may be 0 (c is
// then zero). The plan (kernels.matmul_plan): route 0 takes the FMA
// kernel (64 x 128 tiles), route 1 the wgmma kernel (64 x 64 tiles;
// bf16 . bf16, sak == sbn == 1, 16-byte-aligned bases and row
// strides); splits (1-8) CTAs per cluster split K; blocks is the grid's
// size, checked against the route's tiles times splits. Returns a
// cudaError_t value; 0 is success.
extern "C" int cxn_matmul(const void* a, const void* b, void* c, int M,
                          int N, int K, long long sam, long long sak,
                          long long sbk, long long sbn, int a_dtype,
                          int b_dtype, int route, int splits, long long blocks,
                          void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || (sak != 1 && sam != 1) ||
      (sbn != 1 && sbk != 1) || a_dtype < 0 || a_dtype > 1 || b_dtype < 0 ||
      b_dtype > 1 || splits < 1 || splits > kMaxSplits || route < 0 ||
      route > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* cf = static_cast<float*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (route == 1) {
    const long long tiles = static_cast<long long>((N + kWBN - 1) / kWBN) *
                            ((M + kWBM - 1) / kWBM);
    if (a_dtype != 1 || b_dtype != 1 || sak != 1 || sbn != 1 ||
        (sam * 2) % 16 != 0 || (sbk * 2) % 16 != 0 || !aligned16(a) ||
        !aligned16(b) || blocks != tiles * splits) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    CUtensorMap ma, mb;
    if (!make_map(&ma, a, M, K > 0 ? K : 1, sam) ||
        !make_map(&mb, b, K > 0 ? K : 1, N, sbk)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    dim3 grid((N + kWBN - 1) / kWBN, (M + kWBM - 1) / kWBM, splits);
    err = launch_cluster(cxn_sgemm_wgmma, grid, kWThreads, kWSmemBytes,
                         splits, s, ma, mb, cf, M, N, K);
  } else {
    const long long tiles = static_cast<long long>((N + kFBN - 1) / kFBN) *
                            ((M + kFBM - 1) / kFBM);
    if (blocks != tiles * splits) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const bool a_k = (sak == 1);
    const bool b_n = (sbn == 1);
    const int64_t lda = a_k ? sam : sak;
    const int64_t ldb = b_n ? sbk : sbn;
    if (a_dtype == 0 && b_dtype == 0) {
      err = launch_fma<float, float>(a, b, cf, M, N, K, a_k, b_n, lda, ldb,
                                     splits, s);
    } else if (a_dtype == 0) {
      err = launch_fma<float, uint16_t>(a, b, cf, M, N, K, a_k, b_n, lda,
                                        ldb, splits, s);
    } else if (b_dtype == 0) {
      err = launch_fma<uint16_t, float>(a, b, cf, M, N, K, a_k, b_n, lda,
                                        ldb, splits, s);
    } else {
      err = launch_fma<uint16_t, uint16_t>(a, b, cf, M, N, K, a_k, b_n, lda,
                                           ldb, splits, s);
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
