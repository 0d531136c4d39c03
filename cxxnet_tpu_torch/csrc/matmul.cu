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
// What bounds it: operations, at fullc sizes. Inception-BN's fc1
// (M = 128 images, K = 1024, N = 1000) does 0.262 GFLOP per product on
// 4.6 MB in f32, about 57 flop/byte. With TF32 off the reference's f32
// product is full f32, which the tensor cores do not compute (TF32
// keeps 10 mantissa bits), so the ceiling is the 67 TFLOP/s of the
// CUDA cores and the bound is 3.9 us per product. A bf16 . bf16
// product could run on the bf16 tensor cores (989 TFLOP/s, a bound
// set by its 2.3 MB of bytes instead); this kernel does not use them
// yet. The design is the classic shared-memory SGEMM: a 64 x 64 output
// tile per 256-thread block, 16-deep K slices staged in shared memory
// as float32 (a bf16 element converts exactly on its way in), each
// thread holding a 4 x 4 register tile of accumulators updated by
// fmaf. A product of two bf16 values is exact in f32, so a bf16 . bf16
// result differs from the plain version only by the order of its
// sums. Tile loads map neighbouring threads to neighbouring addresses
// for either layout of each operand (a template flag per operand,
// beside its dtype). No wgmma, TMA or split-K: a tensor-core kernel
// (mma/wgmma for bf16, 3xTF32 for f32) and split-K for the small-M
// products are later work.
//
// Plain C interface, loaded with ctypes. The launch goes on the caller's
// stream; the return value is cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kTM = 4;
constexpr int kTN = 4;
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);   // 256
constexpr int kPad = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// TA, TB: the operands' element types (float or __nv_bfloat16).
// kAK: A is k-contiguous (sak == 1, lda = sam), else m-contiguous
// (sam == 1, lda = sak). kBN_: B is n-contiguous (sbn == 1, ldb = sbk),
// else k-contiguous (sbk == 1, ldb = sbn).
template <typename TA, typename TB, bool kAK, bool kBN_>
__global__ void __launch_bounds__(kThreads)
cxn_sgemm(const TA* __restrict__ a, const TB* __restrict__ b,
          float* __restrict__ c, int M, int N, int K, int64_t lda, int64_t ldb) {
  __shared__ float As[kBK][kBM + kPad];
  __shared__ float Bs[kBK][kBN + kPad];
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);
  const int ty = tid / (kBN / kTN);
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
  }
  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < (kBM * kBK) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      int mm, kk;
      if (kAK) {
        kk = e % kBK;
        mm = e / kBK;
      } else {
        mm = e % kBM;
        kk = e / kBM;
      }
      const int gm = m0 + mm, gk = k0 + kk;
      float v = 0.0f;
      if (gm < M && gk < K) {
        v = to_f32(kAK ? a[static_cast<int64_t>(gm) * lda + gk]
                       : a[gm + static_cast<int64_t>(gk) * lda]);
      }
      As[kk][mm] = v;
    }
#pragma unroll
    for (int i = 0; i < (kBN * kBK) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      int nn, kk;
      if (kBN_) {
        nn = e % kBN;
        kk = e / kBN;
      } else {
        kk = e % kBK;
        nn = e / kBK;
      }
      const int gn = n0 + nn, gk = k0 + kk;
      float v = 0.0f;
      if (gn < N && gk < K) {
        v = to_f32(kBN_ ? b[static_cast<int64_t>(gk) * ldb + gn]
                        : b[gk + static_cast<int64_t>(gn) * ldb]);
      }
      Bs[kk][nn] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float ar[kTM], br[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) ar[i] = As[kk][ty * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) br[j] = Bs[kk][tx * kTN + j];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty * kTM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx * kTN + j;
      if (gn < N) c[static_cast<int64_t>(gm) * N + gn] = acc[i][j];
    }
  }
}

template <typename TA, typename TB>
void launch(const void* a, const void* b, float* c, int M, int N, int K,
            bool a_k, bool b_n, int64_t lda, int64_t ldb, cudaStream_t s) {
  const TA* at = static_cast<const TA*>(a);
  const TB* bt = static_cast<const TB*>(b);
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  if (a_k && b_n) {
    cxn_sgemm<TA, TB, true, true><<<grid, kThreads, 0, s>>>(at, bt, c, M, N,
                                                             K, lda, ldb);
  } else if (a_k) {
    cxn_sgemm<TA, TB, true, false><<<grid, kThreads, 0, s>>>(at, bt, c, M, N,
                                                              K, lda, ldb);
  } else if (b_n) {
    cxn_sgemm<TA, TB, false, true><<<grid, kThreads, 0, s>>>(at, bt, c, M, N,
                                                              K, lda, ldb);
  } else {
    cxn_sgemm<TA, TB, false, false><<<grid, kThreads, 0, s>>>(at, bt, c, M,
                                                               N, K, lda, ldb);
  }
}

}  // namespace

// a: (M, K) with strides (sam, sak); b: (K, N) with strides (sbk, sbn);
// c: (M, N) row-major float32. a_dtype and b_dtype: 0 float32, 1
// bfloat16. One stride of each operand must be 1. K may be 0 (c is
// then zero). Returns a cudaError_t value; 0 is success.
extern "C" int cxn_matmul(const void* a, const void* b, void* c, int M,
                          int N, int K, long long sam, long long sak,
                          long long sbk, long long sbn, int a_dtype,
                          int b_dtype, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || (sak != 1 && sam != 1) ||
      (sbn != 1 && sbk != 1) || a_dtype < 0 || a_dtype > 1 || b_dtype < 0 ||
      b_dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool a_k = (sak == 1);
  const bool b_n = (sbn == 1);
  const int64_t lda = a_k ? sam : sak;
  const int64_t ldb = b_n ? sbk : sbn;
  float* cf = static_cast<float*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_dtype == 0 && b_dtype == 0) {
    launch<float, float>(a, b, cf, M, N, K, a_k, b_n, lda, ldb, s);
  } else if (a_dtype == 0) {
    launch<float, __nv_bfloat16>(a, b, cf, M, N, K, a_k, b_n, lda, ldb, s);
  } else if (b_dtype == 0) {
    launch<__nv_bfloat16, float>(a, b, cf, M, N, K, a_k, b_n, lda, ldb, s);
  } else {
    launch<__nv_bfloat16, __nv_bfloat16>(a, b, cf, M, N, K, a_k, b_n, lda,
                                         ldb, s);
  }
  return static_cast<int>(cudaGetLastError());
}
