// Blocked compute-mode matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/matmul_mapmajor/matmul_mapmajor.py::
// matmul_mapmajor (body _mm_kernel): (M, K) @ (K, N) with K walked in bk-deep
// chunks and an accumulator in the mode's type.  The bias add and ReLU that
// the JAX package applies outside the kernel (matmul_mapmajor/ops.py, the
// float dense hooks) are folded into the flush here, with the same
// roundings: y = cast(acc); y = cast(y + cast(bias)); relu(y).
//
// Bound.  On AlexNet's fc6-fc8 at batch 1-8 the work is far below the ridge
// point (about 2M FLOP per weight byte), so the bound is bytes: streaming
// the weights once at HBM's rate.  That takes many bytes in flight at once,
// so the design is about parallelism and latency, not arithmetic.
//
// Design: split over K along the plan's bk chunks, two launches.
// 1. matmul_mapmajor_split: a block of 4 warps owns (16 rows of M, 64
//    columns of N, one bk chunk of K): fc6 at bk = 512 has 64 x 18 = 1,152
//    blocks, fc7 512, fc8 128.  It streams its chunk of B in 64-deep stages
//    through a ring of kStages stages in shared memory with 16-byte cp.async
//    (L2 only), three stages ahead of the products; each thread has several
//    16-byte loads in flight per stage.  Edges (M, N, a short last K chunk)
//    are zero-filled by cp.async's source size, so nothing is padded in
//    device memory; where a row is not a multiple of 16 bytes, or a pointer
//    is not 16-byte aligned, that operand is staged by plain loads instead.
//    RELAXED/IMPRECISE multiply with mma.sync.m16n8k16 (bf16 in, f32
//    accumulate): A by ldmatrix, B by ldmatrix.trans from its row-major
//    [k][n] tile; rows of A past M are zero.  The tensor cores take the
//    arithmetic off the FP32 pipes, which the bf16 -> f32 widening of an
//    FMA design would keep busy for every weight.  PRECISE multiplies in f32
//    with FMA (no TF32).  Each block writes its chunk's f32 partial product
//    to a workspace (K/bk, M, N) that the caller allocates.
// 2. matmul_mapmajor_reduce: one thread per output element sums the chunks
//    in chunk order (RELAXED, PRECISE: f32; IMPRECISE: acc = bf16(acc +
//    bf16(part)), the TPU kernel's bf16 scratch accumulator with one bk
//    chunk per grid step), then flushes.  No atomics: the result is the same
//    from run to run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // 4 warps, 16 columns each
constexpr int BM = 16;
constexpr int BN = 64;
constexpr int BK = 64;             // K depth of one stage
constexpr int kStages = 4;         // ring depth; loads run kStages - 1 ahead
constexpr int kPitch = 72;         // row pitch in elements: 64 + 8 (bank groups)
constexpr int kStageElems = (BM + BK) * kPitch;   // A tile then B tile
constexpr int kReduceThreads = 256;

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16-byte copy; the bytes past src_bytes (0 or 16) are zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// kMma: bf16 tensor cores (RELAXED, IMPRECISE) or f32 FMA (PRECISE).
template <typename T, bool kMma>
__global__ void __launch_bounds__(kThreads)
matmul_mapmajor_split(const T* __restrict__ A, const T* __restrict__ B,
                      float* __restrict__ ws, int M, int N, int K, int bk,
                      int vec_a, int vec_b) {
  constexpr int kVec = 16 / sizeof(T);     // elements per 16-byte chunk
  constexpr int D = kStages - 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);  // [kStages][(BM + BK) * kPitch]

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int chunk = blockIdx.y;
  const int m0 = blockIdx.z * BM;
  const int k_begin = chunk * bk;
  const int k_end = min(K, k_begin + bk);
  const int n_steps = (k_end - k_begin + BK - 1) / BK;

  // Stage `step`: A rows m0.., k k0..k0+63 and B rows k0..k0+63, cols n0..;
  // everything outside (M, K) x (K, N) reads as zero.
  auto issue = [&](int step) {
    T* As = sm + (step % kStages) * kStageElems;
    T* Bs = As + BM * kPitch;
    const int k0 = k_begin + step * BK;
    if (vec_a) {
      for (int e = tid; e < BM * (BK / kVec); e += kThreads) {
        const int r = e / (BK / kVec);
        const int c = (e % (BK / kVec)) * kVec;
        const bool ok = m0 + r < M && k0 + c < k_end;
        cp_async16(smem_addr(As + r * kPitch + c),
                   ok ? A + (size_t)(m0 + r) * K + k0 + c : A, ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < BM * BK; e += kThreads) {
        const int r = e / BK;
        const int c = e % BK;
        As[r * kPitch + c] = (m0 + r < M && k0 + c < k_end)
                                 ? A[(size_t)(m0 + r) * K + k0 + c] : from_f32<T>(0.f);
      }
    }
    if (vec_b) {
      for (int e = tid; e < BK * (BN / kVec); e += kThreads) {
        const int r = e / (BN / kVec);
        const int c = (e % (BN / kVec)) * kVec;
        const bool ok = k0 + r < k_end && n0 + c < N;
        cp_async16(smem_addr(Bs + r * kPitch + c),
                   ok ? B + (size_t)(k0 + r) * N + n0 + c : B, ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < BK * BN; e += kThreads) {
        const int r = e / BN;
        const int c = e % BN;
        Bs[r * kPitch + c] = (k0 + r < k_end && n0 + c < N)
                                 ? B[(size_t)(k0 + r) * N + n0 + c] : from_f32<T>(0.f);
      }
    }
  };

  for (int s = 0; s < D; ++s) {
    if (s < n_steps) issue(s);
    cp_async_commit();
  }

  float* out = ws + (size_t)chunk * M * N;
  const int lane = tid % 32;
  const int warp = tid / 32;
  if constexpr (kMma) {
    // A: lane -> row lane % 16, k half 8 * (lane / 16).  B (.trans): lane ->
    // k row (lane % 8) + 8 * ((lane / 8) % 2), column half 8 * (lane / 16):
    // matrices (k0-7,n0-7), (k8-15,n0-7), (k0-7,n8-15), (k8-15,n8-15) =
    // b0, b1 of the warp's two n8 tiles.
    const uint32_t a_off = ((lane % 16) * kPitch + 8 * (lane / 16)) * sizeof(T);
    const uint32_t b_off = ((BM + lane % 8 + 8 * ((lane / 8) % 2)) * kPitch
                            + warp * 16 + 8 * (lane / 16)) * sizeof(T);
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int t = 0; t < n_steps; ++t) {
      cp_async_wait<D - 1>();
      __syncthreads();   // stage t landed for all; stage t-1 is free
      if (t + D < n_steps) issue(t + D);
      cp_async_commit();
      const uint32_t st = smem_addr(sm + (t % kStages) * kStageElems);
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        uint32_t a[4], b[4];
        ldmatrix_x4(a, st + a_off + ks * 16 * sizeof(T));
        ldmatrix_x4_trans(b, st + b_off + ks * 16 * kPitch * sizeof(T));
        mma_bf16(acc[0], a, b[0], b[1]);
        mma_bf16(acc[1], a, b[2], b[3]);
      }
    }
    cp_async_wait<0>();
    // C fragment: c0, c1 at (row g, cols 2q, 2q+1), c2, c3 at row g + 8.
    const int g = lane / 4;
    const int q = lane % 4;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + g + 8 * (e / 2);
        const int nn = n0 + warp * 16 + 8 * j + 2 * q + e % 2;
        if (m < M && nn < N) out[(size_t)m * N + nn] = acc[j][e];
      }
  } else {
    // f32 FMA: thread (ty, tx) owns rows ty, ty + 8 and columns 4tx..4tx+3.
    const int tx = tid % 16;
    const int ty = tid / 16;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int t = 0; t < n_steps; ++t) {
      cp_async_wait<D - 1>();
      __syncthreads();
      if (t + D < n_steps) issue(t + D);
      cp_async_commit();
      const float* As = reinterpret_cast<const float*>(sm + (t % kStages) * kStageElems);
      const float* Bs = As + BM * kPitch;
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        const float4 b = *reinterpret_cast<const float4*>(Bs + k * kPitch + 4 * tx);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float a = As[(ty + 8 * i) * kPitch + k];
          acc[i][0] = fmaf(a, b.x, acc[i][0]);
          acc[i][1] = fmaf(a, b.y, acc[i][1]);
          acc[i][2] = fmaf(a, b.z, acc[i][2]);
          acc[i][3] = fmaf(a, b.w, acc[i][3]);
        }
      }
    }
    cp_async_wait<0>();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = m0 + ty + 8 * i;
        const int nn = n0 + 4 * tx + j;
        if (m < M && nn < N) out[(size_t)m * N + nn] = acc[i][j];
      }
  }
}

template <typename T, bool kImprecise>
__global__ void __launch_bounds__(kReduceThreads)
matmul_mapmajor_reduce(const float* __restrict__ ws, const float* __restrict__ bias,
                       T* __restrict__ C, int M, int N, int chunks, int relu) {
  const size_t idx = (size_t)blockIdx.x * kReduceThreads + threadIdx.x;
  const size_t MN = (size_t)M * N;
  if (idx >= MN) return;
  float acc = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const float part = ws[c * MN + idx];
    acc = kImprecise ? round_bf16(acc + round_bf16(part)) : acc + part;
  }
  float v = round_out<T>(acc);
  if (bias != nullptr) v = round_out<T>(v + round_out<T>(bias[idx % N]));
  if (relu) v = fmaxf(v, 0.f);
  C[idx] = from_f32<T>(v);
}

int n_chunks(int K, int bk) { return (K + bk - 1) / bk; }

template <typename T, bool kImprecise>
int launch(const void* a, const void* b, const void* bias, void* c, void* ws,
           int M, int N, int K, int bk, int relu, cudaStream_t stream) {
  constexpr bool kMma = sizeof(T) == 2;
  constexpr int kVec = 16 / sizeof(T);
  const int vec_a = K % kVec == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const int vec_b = N % kVec == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const int chunks = n_chunks(K, bk);
  const size_t smem = (size_t)kStages * kStageElems * sizeof(T);
  auto split = matmul_mapmajor_split<T, kMma>;
  cudaError_t err = cudaFuncSetAttribute(
      split, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BN - 1) / BN, chunks, (M + BM - 1) / BM);
  split<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<float*>(ws),
      M, N, K, bk, vec_a, vec_b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t MN = (size_t)M * N;
  matmul_mapmajor_reduce<T, kImprecise>
      <<<(unsigned)((MN + kReduceThreads - 1) / kReduceThreads), kReduceThreads, 0, stream>>>(
          static_cast<const float*>(ws), static_cast<const float*>(bias),
          static_cast<T*>(c), M, N, chunks, relu);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int matmul_mapmajor_block_k() { return BK; }

// Blocks of the split launch: 64-column slices x bk chunks x 16-row tiles.
long long matmul_mapmajor_grid_blocks(int M, int N, int K, int bk) {
  return (long long)((N + BN - 1) / BN) * n_chunks(K, bk) * ((M + BM - 1) / BM);
}

// mode: 0 PRECISE, 1 RELAXED, 2 IMPRECISE.  ws: an f32 workspace of
// ceil(K / bk) * M * N elements.  Two launches on `stream`.  Returns 0 on
// success, else the cudaError_t of the refused launch; 1000 for arguments
// this kernel does not take.
int matmul_mapmajor_launch(const void* a, const void* b, const void* bias,
                           void* c, void* ws, int M, int N, int K, int bk,
                           int mode, int relu, void* stream) {
  if (M < 1 || N < 1 || K < 1 || bk < BK || bk % BK != 0) return 1000;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return launch<float, false>(a, b, bias, c, ws, M, N, K, bk, relu, s);
    case 1:
      return launch<__nv_bfloat16, false>(a, b, bias, c, ws, M, N, K, bk, relu, s);
    case 2:
      return launch<__nv_bfloat16, true>(a, b, bias, c, ws, M, N, K, bk, relu, s);
    default:
      return 1000;
  }
}

}  // extern "C"
