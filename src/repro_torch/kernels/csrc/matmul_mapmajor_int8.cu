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
//   ws   (splits, M, N)  int32 workspace, allocated by the caller
//
// Bound.  On AlexNet's fc6-fc8 at batch 1-8 the work is far below the int8
// ridge point (M MACs per weight byte), so the bound is bytes: streaming the
// 1-byte weights once at HBM's rate, 11.3 + 5.0 + 1.2 us.  That takes many
// bytes in flight at once, so the design is about parallelism and latency,
// not the MMA rate.
//
// Design: split over K, two launches, as the float kernel
// (matmul_mapmajor.cu) does.
// 1. matmul_mapmajor_int8_split: a block of 4 warps owns (16 rows of M,
//    64 columns of N, one K chunk).  Unlike the float kernel the chunk does
//    not follow the plan's bk: int32 sums are exact, so any split gives the
//    same bits, and the kernel picks the chunk from the shapes so that the
//    grid has about kTargetBlocks (4 per SM) blocks: fc6 576, fc7 512,
//    fc8 512 at M <= 16.  Each block streams its chunk in 64-deep stages
//    through a ring of kStages stages in shared memory with cp.async, four
//    stages ahead of the products.  Edges (M, N, the last K chunk) are
//    zero-filled by cp.async's source size, so nothing is padded in device
//    memory.  The copy width is the widest of 16, 8 and 4 bytes that the row
//    length and the pointer allow (fc8's 1000-byte rows take 8); where none
//    does, that operand is staged by plain byte loads.
//    Arithmetic: mma.sync.m16n8k32 s8 x s8 -> s32, A by ldmatrix (its rows
//    have K innermost).  B is (K, N) with N innermost, and the MMA wants K
//    innermost per column; ldmatrix has no 8-bit transpose.  So B's rows are
//    staged as they are, by cp.async, but each K row goes to a permuted row
//    of the stage (perm_row): within 16 rows, K = 4q + 2h + l lands in row
//    8h + 2q + l.  ldmatrix.trans (b16) then hands lane (g, q) 2x2 byte
//    blocks whose bytes, regrouped by two __byte_perm, are exactly K =
//    4q..4q+3 of column 2g (one n8 tile) and of column 2g + 1 (a second):
//    the two tiles hold the even and the odd columns of the warp's 16, and
//    the accumulators come out as four consecutive columns per lane.  No
//    transposed copy of B is made and no second shared buffer or barrier is
//    needed.  Each block writes its chunk's int32 partial to the workspace.
// 2. matmul_mapmajor_int8_reduce: one thread per output element sums the
//    splits (exact, any order gives the same int32) and flushes.
// Workspace and a second launch rather than int32 atomics: atomics need an
// accumulator zeroed before every call (a launch of its own) and a counter
// per tile to find the last block; the workspace is 1.0-1.2 MB on fc6-fc8
// at batch 8, written and read back through L2, and the result is the same
// from run to run either way.
//
// Flush.  The int32 sums are exact, so the flush is the only place the card
// could differ from the plain version.  It rounds as the TPU kernel does:
// float(acc), times s (one f32 rounding), plus the bias (another), ReLU,
// then round to bf16; __fmul_rn/__fadd_rn keep nvcc from contracting them
// into one FMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // 4 warps, 16 columns each
constexpr int BM = 16;
constexpr int BN = 64;
constexpr int BK = 64;             // K depth of one stage
constexpr int kStages = 5;         // ring depth; loads run kStages - 1 ahead
constexpr int kPitch = 80;         // bytes per staged row: 64 + 16 (an odd
                                   // number of 16-byte chunks: no conflicts)
constexpr int kStageBytes = (BM + BK) * kPitch;   // A tile, then B tile
constexpr int kTargetBlocks = 4 * 132;            // about 4 blocks per SM
constexpr int kReduceThreads = 256;

template <typename T> __device__ __forceinline__ T to_out(float v);
template <> __device__ __forceinline__ float to_out<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// A V-byte copy (V = 16, 8 or 4); the bytes past src_bytes (0 or V) are
// zero-filled.  16 bytes go through L2 only.
template <int V>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int src_bytes) {
  if constexpr (V == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(dst), "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 ::"r"(dst), "l"(src), "n"(V), "r"(src_bytes));
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
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The stage row that K offset k (0..63) of a B stage goes to: within each
// 16 rows, k = 4q + 2h + l -> 8h + 2q + l, so that ldmatrix.trans's 8-row
// matrices 2j and 2j + 1 hold K = 4q, 4q + 1 and 4q + 2, 4q + 3 at the same
// lane (see the header).
__device__ __forceinline__ int perm_row(int k) {
  return (k & ~15) | ((k & 2) << 2) | ((k & 12) >> 1) | (k & 1);
}

// The widest copy (16, 8, 4 bytes, or 1: plain loads) that rows of
// `row_bytes` bytes starting at `p` allow.
int copy_width(const void* p, int row_bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  for (int v = 16; v >= 4; v /= 2)
    if (row_bytes % v == 0 && a % v == 0) return v;
  return 1;
}

template <int V> struct Width { static constexpr int value = V; };

// Dispatch a staging body on the runtime copy width.
template <typename F>
__device__ __forceinline__ void with_width(int v, F&& f) {
  switch (v) {
    case 16: f(Width<16>{}); break;
    case 8: f(Width<8>{}); break;
    case 4: f(Width<4>{}); break;
    default: f(Width<1>{}); break;
  }
}

// At most 80 registers a thread: 6 blocks per SM, so that a grid of about
// kTargetBlocks is resident at once (at 128 registers only 4 were, and fc6's
// 576 blocks ran in two waves).
__global__ void __launch_bounds__(kThreads, 6)
matmul_mapmajor_int8_split(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                           int* __restrict__ ws, int M, int N, int K, int chunk,
                           int va, int vb) {
  constexpr int D = kStages - 1;
  extern __shared__ __align__(16) unsigned char sm[];   // [kStages][kStageBytes]

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * BM;
  const int k_begin = split * chunk;
  const int k_end = min(K, k_begin + chunk);
  const int n_steps = (k_end - k_begin + BK - 1) / BK;

  // Stage `step`: A rows m0.., K k0..k0+63 as [m][k], and B rows
  // k0..k0+63 (permuted), columns n0..n0+63 as [k][n]; everything outside
  // (M, K) x (K, N) reads as zero.  The chunk ends at a multiple of 64 or at
  // K, and K (for A) and N (for B) are multiples of the copy width, so no
  // copy straddles an edge.
  auto issue = [&](int step) {
    unsigned char* As = sm + (step % kStages) * kStageBytes;
    unsigned char* Bs = As + BM * kPitch;
    const int k0 = k_begin + step * BK;
    with_width(va, [&](auto w) {
      constexpr int V = decltype(w)::value;
      constexpr int C = BK / V;
      for (int e = tid; e < BM * C; e += kThreads) {
        const int r = e / C;
        const int c = (e % C) * V;
        const bool ok = m0 + r < M && k0 + c < k_end;
        const int8_t* src = A + (size_t)(m0 + r) * K + k0 + c;
        if constexpr (V == 1)
          As[r * kPitch + c] = ok ? (unsigned char)*src : 0;
        else
          cp_async<V>(smem_addr(As + r * kPitch + c), ok ? src : A, ok ? V : 0);
      }
    });
    with_width(vb, [&](auto w) {
      constexpr int V = decltype(w)::value;
      constexpr int C = BN / V;
      for (int e = tid; e < BK * C; e += kThreads) {
        const int r = e / C;
        const int c = (e % C) * V;
        const bool ok = k0 + r < k_end && n0 + c < N;
        const int8_t* src = B + (size_t)(k0 + r) * N + n0 + c;
        unsigned char* dst = Bs + perm_row(r) * kPitch + c;
        if constexpr (V == 1)
          *dst = ok ? (unsigned char)*src : 0;
        else
          cp_async<V>(smem_addr(dst), ok ? src : B, ok ? V : 0);
      }
    });
  };

  for (int s = 0; s < D; ++s) {
    if (s < n_steps) issue(s);
    cp_async_commit();
  }

  const int lane = tid % 32;
  const int warp = tid / 32;
  // A: lane -> row lane % 16, K half 16 * (lane / 16): matrices (rows 0-7,
  // K 0-15), (8-15, 0-15), (0-7, 16-31), (8-15, 16-31) = a0..a3.
  // B (.trans): lane -> stage row lane of the 32-deep step (matrix j =
  // rows 8j..8j+7), the warp's 16 columns.
  const uint32_t a_off = (lane % 16) * kPitch + 16 * (lane / 16);
  const uint32_t b_off = BM * kPitch + lane * kPitch + 16 * warp;
  // acc[0]: the even columns 2g of the warp's 16, acc[1] the odd ones.
  int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
  for (int t = 0; t < n_steps; ++t) {
    cp_async_wait<D - 1>();
    __syncthreads();   // stage t landed for all; stage t-1 is free
    if (t + D < n_steps) issue(t + D);
    cp_async_commit();
    const uint32_t st = smem_addr(sm + (t % kStages) * kStageBytes);
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t a[4], r[4];
      ldmatrix_x4(a, st + a_off + ks * 32);
      ldmatrix_x4_trans(r, st + b_off + ks * 32 * kPitch);
      // r[j] = rows (2q, 2q+1) of matrix j at columns (2g, 2g+1); bytes 0, 2
      // of r[0], r[1] are K = 4q..4q+3 of column 2g, bytes 1, 3 of column
      // 2g + 1 (r[2], r[3]: K + 16).
      mma_s8(acc[0], a, __byte_perm(r[0], r[1], 0x6420), __byte_perm(r[2], r[3], 0x6420));
      mma_s8(acc[1], a, __byte_perm(r[0], r[1], 0x7531), __byte_perm(r[2], r[3], 0x7531));
    }
  }
  cp_async_wait<0>();

  // C fragment of tile p: c0, c1 at (row g, tile columns 2q, 2q+1), c2, c3
  // at row g + 8; tile column j of tile p is column 2j + p of the warp's 16,
  // so lane (g, q) holds columns 4q..4q+3 of rows g and g + 8.
  int* out = ws + (size_t)split * M * N;
  const int g = lane / 4;
  const int q = lane % 4;
  const int nb = n0 + 16 * warp + 4 * q;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + g + 8 * h;
    if (m >= M) continue;
    const int v[4] = {acc[0][2 * h], acc[1][2 * h], acc[0][2 * h + 1], acc[1][2 * h + 1]};
    int* o = out + (size_t)m * N + nb;
    if (N % 4 == 0 && nb + 3 < N) {
      *reinterpret_cast<int4*>(o) = make_int4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (nb + j < N) o[j] = v[j];
    }
  }
}

template <typename TOut>
__global__ void __launch_bounds__(kReduceThreads)
matmul_mapmajor_int8_reduce(const int* __restrict__ ws, const float* __restrict__ scale,
                            const float* __restrict__ bias, TOut* __restrict__ C,
                            int M, int N, int splits, int relu) {
  const size_t idx = (size_t)blockIdx.x * kReduceThreads + threadIdx.x;
  const size_t MN = (size_t)M * N;
  if (idx >= MN) return;
  int acc = 0;
  for (int s = 0; s < splits; ++s) acc += ws[s * MN + idx];
  const int n = (int)(idx % N);
  float v = __fmul_rn(__int2float_rn(acc), scale[n]);
  if (bias != nullptr) v = __fadd_rn(v, bias[n]);
  if (relu) v = fmaxf(v, 0.f);
  C[idx] = to_out<TOut>(v);
}

// K chunk of one block: a multiple of BK, long enough that the grid has
// about kTargetBlocks blocks (at most the whole of K).
int chunk_bytes(int M, int N, int K) {
  const long long tiles = (long long)((N + BN - 1) / BN) * ((M + BM - 1) / BM);
  const long long steps = (K + BK - 1) / BK;
  const long long want = (kTargetBlocks + tiles - 1) / tiles;
  return (int)((steps + want - 1) / want) * BK;
}

int n_splits(int M, int N, int K) {
  const int chunk = chunk_bytes(M, N, K);
  return (K + chunk - 1) / chunk;
}

template <typename TOut>
int launch(const void* a, const void* b, const void* scale, const void* bias,
           void* c, void* ws, int M, int N, int K, int relu, cudaStream_t stream) {
  const int chunk = chunk_bytes(M, N, K);
  const int splits = n_splits(M, N, K);
  const size_t smem = (size_t)kStages * kStageBytes;
  const dim3 grid((N + BN - 1) / BN, splits, (M + BM - 1) / BM);
  matmul_mapmajor_int8_split<<<grid, kThreads, smem, stream>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
      static_cast<int*>(ws), M, N, K, chunk, copy_width(a, K), copy_width(b, N));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t MN = (size_t)M * N;
  matmul_mapmajor_int8_reduce<TOut>
      <<<(unsigned)((MN + kReduceThreads - 1) / kReduceThreads), kReduceThreads, 0, stream>>>(
          static_cast<const int*>(ws), static_cast<const float*>(scale),
          static_cast<const float*>(bias), static_cast<TOut*>(c), M, N, splits, relu);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int matmul_mapmajor_int8_block_k() { return BK; }

// Blocks of the split launch: 64-column slices x K splits x 16-row tiles.
long long matmul_mapmajor_int8_grid_blocks(int M, int N, int K) {
  return (long long)((N + BN - 1) / BN) * n_splits(M, N, K) * ((M + BM - 1) / BM);
}

// ws: an int32 workspace of ws_splits * M * N elements, ws_splits at least
// the K splits (ceil(K / chunk), the chunk as chunk_bytes() picks it; the
// Python wrapper restates the rule).  out_f32: 0 bf16, 1 f32.  Two
// launches on `stream`.  Returns 0 on success, else the cudaError_t of the
// refused launch; 1000 for arguments this kernel does not take.
int matmul_mapmajor_int8_launch(const void* a, const void* b, const void* scale,
                                const void* bias, void* c, void* ws, int M, int N,
                                int K, int ws_splits, int relu, int out_f32,
                                void* stream) {
  if (M < 1 || N < 1 || K < 1 || scale == nullptr || ws == nullptr ||
      ws_splits < n_splits(M, N, K) || reinterpret_cast<uintptr_t>(ws) % 16 != 0)
    return 1000;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_f32) return launch<float>(a, b, scale, bias, c, ws, M, N, K, relu, s);
  return launch<__nv_bfloat16>(a, b, scale, bias, c, ws, M, N, K, relu, s);
}

}  // extern "C"
