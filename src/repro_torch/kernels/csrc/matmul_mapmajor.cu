// Blocked compute-mode matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/matmul_mapmajor/matmul_mapmajor.py::
// matmul_mapmajor (body _mm_kernel): (M, K) @ (K, N) with K innermost and an
// accumulator in the mode's type.  The bias add and ReLU that the JAX
// package applies outside the kernel (matmul_mapmajor/ops.py, the float
// dense hooks) are folded into the flush here, with the same roundings:
// y = cast(acc); y = cast(y + cast(bias)); relu(y).
//
// Design.  A block owns a 16 x 64 output tile and walks K in 64-deep
// shared-memory tiles; M and N edges are masked, so M is never padded (the
// TPU wrapper pads M to a 256-row block even at batch 1).  The B tile is
// loaded with 16-byte vectors when N and the pointer allow it.  IMPRECISE
// keeps the sum of one bk-deep chunk in f32, rounds it to bf16 and adds it
// to a bf16 accumulator (rounded again): the TPU kernel's bf16 scratch
// accumulator with one bk block per grid step.  bk must be a multiple of 64.
//
// Bound.  On AlexNet's fc6-fc8 at batch 1-8 the work is far below the ridge
// point (about 2B FLOP per weight byte), so the bound is bytes: streaming the
// weights once.  This kernel keeps one tile in flight per block and has only
// N/64 blocks, so it is latency-bound well above that; deeper pipelining
// (cp.async or TMA rings) and a split over K are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int BM = 16;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int kColLanes = 16;              // threads along N
constexpr int kColsPerThread = BN / kColLanes;

static_assert(BM * kColLanes == kThreads, "thread layout");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Round to the output type: identity for f32, bf16 otherwise.
template <typename T> __device__ __forceinline__ float round_out(float v) {
  return to_f32(from_f32<T>(v));
}

template <typename T, bool kImprecise>
__global__ void __launch_bounds__(kThreads)
matmul_mapmajor_kernel(const T* __restrict__ A, const T* __restrict__ B,
                       const float* __restrict__ bias, T* __restrict__ C,
                       int M, int N, int K, int bk, int relu, int vec_b) {
  __shared__ __align__(16) T As[BM][BK];
  __shared__ __align__(16) T Bs[BK][BN];
  constexpr int kVec = 16 / sizeof(T);     // elements in one 16-byte load

  const int tid = threadIdx.x;
  const int tx = tid % kColLanes;
  const int ty = tid / kColLanes;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[kColsPerThread];
  float part[kColsPerThread];
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) {
    acc[j] = 0.f;
    part[j] = 0.f;
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int r = e / BK;
      const int kk = e % BK;
      const int gm = m0 + r;
      const int gk = k0 + kk;
      As[r][kk] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : from_f32<T>(0.f);
    }
    if (vec_b) {
      for (int e = tid; e < BK * BN / kVec; e += kThreads) {
        const int kk = e / (BN / kVec);
        const int c = (e % (BN / kVec)) * kVec;
        const int gk = k0 + kk;
        const int gn = n0 + c;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (gk < K && gn < N)
          v = *reinterpret_cast<const uint4*>(B + (size_t)gk * N + gn);
        *reinterpret_cast<uint4*>(&Bs[kk][c]) = v;
      }
    } else {
      for (int e = tid; e < BK * BN; e += kThreads) {
        const int kk = e / BN;
        const int c = e % BN;
        const int gk = k0 + kk;
        const int gn = n0 + c;
        Bs[kk][c] = (gk < K && gn < N) ? B[(size_t)gk * N + gn] : from_f32<T>(0.f);
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float a = to_f32(As[ty][kk]);
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const float b = to_f32(Bs[kk][tx + kColLanes * j]);
        if (kImprecise) part[j] = fmaf(a, b, part[j]);
        else acc[j] = fmaf(a, b, acc[j]);
      }
    }
    __syncthreads();
    if (kImprecise && ((k0 + BK) % bk == 0 || k0 + BK >= K)) {
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        acc[j] = round_bf16(acc[j] + round_bf16(part[j]));
        part[j] = 0.f;
      }
    }
  }

  const int gm = m0 + ty;
  if (gm >= M) return;
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) {
    const int gn = n0 + tx + kColLanes * j;
    if (gn >= N) continue;
    float v = round_out<T>(acc[j]);
    if (bias != nullptr) v = round_out<T>(v + round_out<T>(bias[gn]));
    if (relu) v = fmaxf(v, 0.f);
    C[(size_t)gm * N + gn] = from_f32<T>(v);
  }
}

template <typename T, bool kImprecise>
int launch(const void* a, const void* b, const void* bias, void* c, int M,
           int N, int K, int bk, int relu, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int vec_b = (N % kVec == 0) && (reinterpret_cast<uintptr_t>(b) % 16 == 0);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  matmul_mapmajor_kernel<T, kImprecise><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const float*>(bias), static_cast<T*>(c), M, N, K, bk, relu,
      vec_b);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int matmul_mapmajor_block_k() { return BK; }

// mode: 0 PRECISE, 1 RELAXED, 2 IMPRECISE.  Returns 0 on success, else the
// cudaError_t of the refused launch; 1000 for arguments this kernel does not
// take.
int matmul_mapmajor_launch(const void* a, const void* b, const void* bias,
                           void* c, int M, int N, int K, int bk, int mode,
                           int relu, void* stream) {
  if (M < 1 || N < 1 || K < 1 || bk < BK || bk % BK != 0) return 1000;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return launch<float, false>(a, b, bias, c, M, N, K, bk, relu, s);
    case 1:
      return launch<__nv_bfloat16, false>(a, b, bias, c, M, N, K, bk, relu, s);
    case 2:
      return launch<__nv_bfloat16, true>(a, b, bias, c, M, N, K, bk, relu, s);
    default:
      return 1000;
  }
}

}  // extern "C"
