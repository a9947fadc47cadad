// Blocked int8 x int8 -> int32 matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/matmul_mapmajor/matmul_mapmajor.py::
// matmul_mapmajor_int8 (body _mm_kernel with an int32 accumulator):
// (M, K) @ (K, N) with K innermost, summed exactly in int32, then the flush
// out = cast(relu(float(acc) * s + bias)), with s and bias per column.
//
//   a    (M, K) int8     quantized activations, row-major
//   b    (K, N) int8     quantized weights, row-major (N innermost)
//   s    (N,) f32        activation scale x weight scale per column
//   bias (N,) f32 or null
//   c    (M, N)          bf16 (or f32)
//
// Design.  The float kernel's tiling (matmul_mapmajor.cu): a block owns a
// 16 x 64 output tile and walks K in 64-deep shared-memory tiles; M, N and K
// edges are masked, so nothing is padded.  Each thread owns one row and four
// columns and adds four products at a time with __dp4a, which wants four
// consecutive K values in one 32-bit word.  A's rows have K innermost, so
// its words load as they are.  B has N innermost: each thread loads a 4 (K)
// x 4 (N) block of B as four row words and transposes it with __byte_perm
// while staging, so the tile in shared memory holds, per column, four
// consecutive K values per word.  Where K, N or a pointer is not a multiple
// of 4 the loads go byte by byte, masked.
//
// Flush.  The int32 sums are exact, so the flush is the only place the card
// could differ from the plain version.  It rounds as the TPU kernel does:
// float(acc), times s (one f32 rounding), plus the bias (another), ReLU,
// then round to bf16; __fmul_rn/__fadd_rn keep nvcc from contracting them
// into one FMA.
//
// Bound.  On AlexNet's fc6-fc8 at batch 1-8 the work is far below the ridge
// point, so the bound is bytes: streaming the 1-byte weights once.  This
// kernel keeps one tile in flight per block and has only N/64 blocks, so it
// is latency-bound well above that; more blocks (a split over K, exact with
// int32 atomics), deeper pipelining (cp.async or TMA rings) and the s8
// tensor-core path are later work.
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
static_assert(BM * (BK / 4) == kThreads, "one A word per thread");
static_assert((BK / 4) * (BN / 4) == kThreads, "one 4x4 B block per thread");

template <typename T> __device__ __forceinline__ T to_out(float v);
template <> __device__ __forceinline__ float to_out<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Four consecutive int8 of row `row` from column `col` as one word (byte i =
// column col + i), zero past the matrix.  vec: cols, rows and the pointer
// allow one aligned 32-bit load.
__device__ __forceinline__ unsigned load4(const int8_t* __restrict__ m,
                                          int rows, int cols, int row, int col,
                                          int vec) {
  if (row >= rows || col >= cols) return 0u;
  const int8_t* p = m + (size_t)row * cols + col;
  if (vec) return *reinterpret_cast<const unsigned*>(p);
  unsigned v = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (col + i < cols) v |= (unsigned)(uint8_t)p[i] << (8 * i);
  return v;
}

template <typename TOut>
__global__ void __launch_bounds__(kThreads)
matmul_mapmajor_int8_kernel(const int8_t* __restrict__ A,
                            const int8_t* __restrict__ B,
                            const float* __restrict__ scale,
                            const float* __restrict__ bias,
                            TOut* __restrict__ C, int M, int N, int K,
                            int relu, int vec) {
  __shared__ int As[BM][BK / 4];            // As[r][k4]: A[r][4k4 .. 4k4+3]
  __shared__ int Bs[BK / 4][BN + 1];        // Bs[k4][c]: B[4k4 .. 4k4+3][c]

  const int tid = threadIdx.x;
  const int tx = tid % kColLanes;
  const int ty = tid / kColLanes;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int a_r = tid / (BK / 4);           // A word this thread stages
  const int a_k4 = tid % (BK / 4);
  const int b_k4 = tid / (BN / 4);          // B 4x4 block this thread stages
  const int b_c4 = tid % (BN / 4);

  int acc[kColsPerThread];
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) acc[j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    As[a_r][a_k4] = (int)load4(A, M, K, m0 + a_r, k0 + 4 * a_k4, vec);
    unsigned r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = load4(B, K, N, k0 + 4 * b_k4 + i, n0 + 4 * b_c4, vec);
    // 4x4 byte transpose: column j's word gets byte j of rows 0..3.
    const unsigned lo01 = __byte_perm(r[0], r[1], 0x5140);
    const unsigned lo23 = __byte_perm(r[2], r[3], 0x5140);
    const unsigned hi01 = __byte_perm(r[0], r[1], 0x7362);
    const unsigned hi23 = __byte_perm(r[2], r[3], 0x7362);
    int* bcol = &Bs[b_k4][4 * b_c4];
    bcol[0] = (int)__byte_perm(lo01, lo23, 0x5410);
    bcol[1] = (int)__byte_perm(lo01, lo23, 0x7632);
    bcol[2] = (int)__byte_perm(hi01, hi23, 0x5410);
    bcol[3] = (int)__byte_perm(hi01, hi23, 0x7632);
    __syncthreads();
#pragma unroll
    for (int k4 = 0; k4 < BK / 4; ++k4) {
      const int a = As[ty][k4];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        acc[j] = __dp4a(a, Bs[k4][tx + kColLanes * j], acc[j]);
    }
    __syncthreads();
  }

  const int gm = m0 + ty;
  if (gm >= M) return;
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) {
    const int gn = n0 + tx + kColLanes * j;
    if (gn >= N) continue;
    float v = __fmul_rn(__int2float_rn(acc[j]), scale[gn]);
    if (bias != nullptr) v = __fadd_rn(v, bias[gn]);
    if (relu) v = fmaxf(v, 0.f);
    C[(size_t)gm * N + gn] = to_out<TOut>(v);
  }
}

template <typename TOut>
int launch(const void* a, const void* b, const void* scale, const void* bias,
           void* c, int M, int N, int K, int relu, cudaStream_t stream) {
  const int vec = (K % 4 == 0) && (N % 4 == 0) &&
                  (reinterpret_cast<uintptr_t>(a) % 4 == 0) &&
                  (reinterpret_cast<uintptr_t>(b) % 4 == 0);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  matmul_mapmajor_int8_kernel<TOut><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<TOut*>(c), M, N, K, relu, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int matmul_mapmajor_int8_block_k() { return BK; }

// out_f32: 0 bf16, 1 f32.  Returns 0 on success, else the cudaError_t of the
// refused launch; 1000 for arguments this kernel does not take.
int matmul_mapmajor_int8_launch(const void* a, const void* b, const void* scale,
                                const void* bias, void* c, int M, int N, int K,
                                int relu, int out_f32, void* stream) {
  if (M < 1 || N < 1 || K < 1 || scale == nullptr) return 1000;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_f32) return launch<float>(a, b, scale, bias, c, M, N, K, relu, s);
  return launch<__nv_bfloat16>(a, b, scale, bias, c, M, N, K, relu, s);
}

}  // extern "C"
