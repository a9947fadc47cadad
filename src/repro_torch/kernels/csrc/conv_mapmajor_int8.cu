// Map-major OLP direct convolution on the int8 datapath for Hopper (sm_90a),
// plain C interface.
//
// Replaces the TPU kernel repro/kernels/conv_mapmajor/conv_mapmajor.py::
// conv_mapmajor_int8 (body _conv_kernel with an int32 accumulator): for each
// (kh, kw) a (pixels, u_in) x (u_in, u_out) int8 product over a strided
// patch, summed exactly in int32 over the Gi input channel groups, then the
// flush out = cast(relu(float(acc) * s + b)).
//
//   x    (N, Gi, Hp, Wp, u)          int8, map-major, already padded
//   w    (Go, u_out, Gi, Kh, Kw, u)  int8, map-major weights
//   s    (Go, u_out) f32             activation scale x weight scale per channel
//   bias (Go, u_out) f32 or null
//   out  (N, Go, Ho, Wo, u_out)      bf16 (or f32), map-major
//
// Design: the float kernel's implicit GEMM (conv_mapmajor.cu) with 1-byte
// operands.  A block of 8 warps owns one (n, go, 64-lane slice of u_out,
// 8x8 tile of output pixels): M = the tile's 64 pixels, N = 64 output lanes
// (32 where u_out <= 32), K walked as (gi, kh, kw, u_in in 32-deep steps).
// Each warp computes 16 pixels x 32 lanes with mma.sync.m16n8k32 (s8 x s8,
// s32 accumulate) on the int8 tensor cores; the int32 accumulators live in
// the fragments across all steps (the sums are exact: no rounding anywhere
// before the flush).  Both operands come by ldmatrix.x4 (b16 rows of 16
// bytes: lane (g, q) gets bytes 4q..4q+3 of row g, the s8 fragment layout),
// double-buffered in registers across the 32-deep steps, with no transpose:
// - A is a shifted window of the staged input patch: row r of step (kh, kw)
//   is the patch pixel ((ph*s + kh)*PW + pw*s + kw), u_in innermost;
// - B is the map-major weight slice as it is: u_out rows of u_in contiguous
//   bytes, the [n][k] ("col") layout the MMA wants.
//
// Staging: cp.async into rings in shared memory, as in the float kernel:
// weight slices weight_stages() deep (loaded weight_stages() - 1 steps
// ahead), two patch buffers (the next gi's patch arrives during this gi's
// last steps).  Every row is padded to row_pitch(u) = round_up(u, 32) + 16
// bytes: K is zero-filled up to the 32-deep MMA step, and the odd number of
// 16-byte chunks per row puts the 8 rows of an ldmatrix in 8 different bank
// groups.  Shared memory is zeroed once per block; pixels outside the input,
// lanes past u_out and K past u are never written after that.  Copies are
// 16 bytes where u is a multiple of 16 and the pointers allow, else 4 bytes
// (u = 4, 8, 12, 36, 100, ...: u is always a multiple of 4).  Where two
// patches and the weight ring pass the 232,448 B a block may have (conv1's
// 11x11/4: 465,696 B at u = 128), a lean staging takes a 4x8 tile (the last
// four warps idle), one patch, loaded at each gi's first step with its
// latency exposed, and two slices (conv1: 147,600 B).  The largest lean
// request (k = 11, stride 4, u = 128) is 147,600 B, so every shape the
// earlier __dp4a kernel took (u a multiple of 4 up to 128, k <= 11,
// stride <= 4) fits.  conv_mapmajor_int8_smem_bytes below is the whole
// dynamic request; the same formula in Python (kernels/conv_mapmajor/
// conv_mapmajor.py::kernel_smem_bytes_int8) is the planner's rule-1
// envelope under IMPRECISE_INT8.  At u = 128: conv2 69,120 B, conv3-conv5
// 56,448 B; 3 blocks per SM either way (shared memory, registers).
//
// Flush.  The int32 sums are exact, so the flush is the only place the card
// could differ from the plain version.  It rounds as the TPU kernel does:
// float(acc) (round to nearest), times s (one f32 rounding), plus the bias
// (another), ReLU, then round to bf16.  __fmul_rn/__fadd_rn keep nvcc from
// contracting the two into one FMA, which would round once.  Each lane
// writes two neighbouring output lanes as one bf16 pair.
//
// Small grids: a split of the K walk over a thread block cluster.  Where
// the grid has at most a quarter as many blocks as the card has SMs
// (AlexNet's conv3-conv5 at batch 1: 16-24), the (gi, kh, kw) steps of each
// output tile are cut into contiguous ranges, one per block of a cluster of
// up to 8, so that about one block runs on each SM.  Each block starts its
// range with the patch of its first gi.  At the end every block parks its
// int32 partial sums in its own shared memory, rank 0 adds the others'
// through distributed shared memory (exact: int32) and flushes; one launch,
// no workspace, no atomics.  Larger grids are not split: there each split
// block's own patch and prologue cost more than the split gains.
//
// The step loop has no integer division: (gi, kh, kw) is walked with
// counters and each thread's first (row, copy) of a weight slice is computed
// once: with two warps per SMSP to hide them, the divisions' serial chains
// took a large share of every step.
//
// Bound.  At AlexNet conv2-conv5 shapes the work is far above the int8
// ridge point, so the bound is operations at the int8 tensor-core rate.
// What keeps this design from it is the cost of a (gi, kh, kw) step, far
// more than its 16 MMAs per warp at u = 128 need, in three parts of about
// the same size: the step's barrier and scalar work, the weight slice's
// copies, and the ldmatrix/MMA work.  On the H100 a deeper
// weight ring, two steps per barrier and 32 x 32 warp tiles did not shorten
// it measurably; fewer, larger copies (TMA) and a persistent block that
// overlaps one tile's flush with the next one's loads are what is left.
// 13x13 planes fill 8x8 tiles to 66 %.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;      // 8 warps: 4 along pixels x 2 along lanes
constexpr int kTileW = 8;
constexpr int kTileH = 8;
constexpr int kLeanTileH = 4;      // the lean staging's tile height
constexpr int kBN = 64;            // output lanes per block
constexpr int kMaxU = 128;
// The most dynamic shared memory a block may request on an H100.
constexpr long long kSmemBudget = 232448;

static_assert(kTileH * kTileW == 64 && kThreads == 256,
              "warp layout: 4 x 2 warps of 16 pixels x 32 lanes");
// The split of the (gi, kh, kw) walk over a cluster, for grids that leave
// most of the card idle: where the unsplit grid has at most kSplitMaxBlocks
// blocks (a quarter of an H100's kSMs), about one block per SM, at most
// kMaxSplit blocks a cluster (the portable cluster size) and at least
// kMinSteps steps a block.  Larger grids are not split: there each split
// block's own patch and prologue cost more than the split gains.  The
// partial sums pass through shared memory, 16 int32 a thread, so a split
// block needs that much.
constexpr int kSMs = 132;
constexpr int kSplitMaxBlocks = kSMs / 4;
constexpr int kMaxSplit = 8;
constexpr int kMinSteps = 4;
constexpr long long kPartialBytes = 16LL * 4 * kThreads;

// Bytes per staged row: K padded to the 32-deep MMA step, plus one 16-byte
// chunk so consecutive rows fall in different bank groups.
__host__ __device__ inline int row_pitch(int u) { return (u + 31) / 32 * 32 + 16; }
// Weight slices in the ring: the lookahead is one less.  The next gi's patch
// is issued with the weights of its first step, into the patch buffer the
// gi before last used; that buffer is free when Kh*Kw >= the lookahead.
__host__ __device__ inline int weight_stages(int Kh, int Kw) { return Kh * Kw >= 2 ? 3 : 2; }
// Rows of a staged weight slice: 64 lanes, or 32 where u_out is that narrow.
__host__ __device__ inline int weight_rows(int u_out) { return u_out <= 32 ? 32 : kBN; }

// The staging a shape gets.  Full: an 8x8 tile, two patch buffers and
// weight_stages() weight slices.  Lean, where that is over kSmemBudget: a
// 4x8 tile, one patch buffer (loaded at the first step of each gi once
// every thread is done with the last) and two weight slices.
struct Staging {
  int tile_h, patches, wstages;
  long long bytes;
};
inline Staging staging(int Kh, int Kw, int stride, int u, int u_out) {
  const long long pw = (long long)(kTileW - 1) * stride + Kw;
  const long long row = row_pitch(u);
  const long long wrows = weight_rows(u_out);
  const int ws = weight_stages(Kh, Kw);
  const long long full = (2 * ((kTileH - 1) * stride + Kh) * pw + ws * wrows) * row;
  if (full <= kSmemBudget) return {kTileH, 2, ws, full};
  const long long lean = (((kLeanTileH - 1) * stride + Kh) * pw + 2 * wrows) * row;
  return {kLeanTileH, 1, 2, lean};
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// A V-byte copy (16 through L2 only, or 4).
template <int V>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src) {
  if constexpr (V == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src));
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
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two neighbouring output lanes; `pair`: one 4-byte (bf16) or 8-byte (f32)
// store, else two (the second only where it is a lane of the output).
__device__ __forceinline__ void store2(__nv_bfloat16* o, float v0, float v1,
                                       bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(o) =
        __halves2bfloat162(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
  } else {
    o[0] = __float2bfloat16_rn(v0);
    if (second) o[1] = __float2bfloat16_rn(v1);
  }
}
__device__ __forceinline__ void store2(float* o, float v0, float v1, bool pair,
                                       bool second) {
  if (pair) {
    *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
  } else {
    o[0] = v0;
    if (second) o[1] = v1;
  }
}

struct ConvArgs {
  const int8_t* x;
  const int8_t* w;
  const float* scale;
  const float* bias;
  void* out;
  int Gi, Hp, Wp, u, u_out, Kh, Kw, stride, Ho, Wo;
  int tiles_w, n_slices, relu, vec;   // vec: copy width, 16 or 4 bytes
  int ksplit, split_steps;            // blocks a cluster, steps a block
};

// dequant -> bias -> ReLU for output lane co of group go.
__device__ __forceinline__ float flush(const ConvArgs& p, int go, int co, int acc) {
  float v = __fmul_rn(__int2float_rn(acc), p.scale[go * p.u_out + co]);
  if (p.bias != nullptr) v = __fadd_rn(v, p.bias[go * p.u_out + co]);
  return p.relu ? fmaxf(v, 0.f) : v;
}

template <int V> struct Width { static constexpr int value = V; };

// D: the weight ring's lookahead (its stages less one); P: patch buffers,
// 2 for the full staging (8x8 tile), 1 for the lean one (4x8 tile).
template <typename TOut, int D, int P>
__global__ void __launch_bounds__(kThreads)
conv_mapmajor_int8_kernel(const ConvArgs p) {
  constexpr int S = D + 1;
  constexpr int TH = P == 2 ? kTileH : kLeanTileH;
  constexpr int kPix = TH * kTileW;
  static_assert(P == 2 || D == 1, "a lean staging has one patch, two slices");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pitch = row_pitch(p.u);
  const int PH = (TH - 1) * p.stride + p.Kh;
  const int PW = (kTileW - 1) * p.stride + p.Kw;
  const int patch_bytes = PH * PW * pitch;
  const int wrows = weight_rows(p.u_out);
  const int wstage_bytes = wrows * pitch;
  unsigned char* xs = smem_raw;                      // [P][PH * PW][pitch]
  unsigned char* ws = xs + P * patch_bytes;          // [S][wrows][pitch]

  const int tid = threadIdx.x;
  const int go = blockIdx.y / p.n_slices;
  const int n0 = (blockIdx.y % p.n_slices) * kBN;
  const int n = blockIdx.z;
  const int Go = gridDim.y / p.n_slices;
  // blockIdx.x = tile * ksplit + rank: the ksplit blocks of a tile form one
  // cluster, and block `rank` walks steps t_begin .. t_begin + n_steps - 1.
  const int tile = blockIdx.x / p.ksplit;
  const int rank = blockIdx.x - tile * p.ksplit;
  const int oh0 = (tile / p.tiles_w) * TH;
  const int ow0 = (tile % p.tiles_w) * kTileW;
  const int ih0 = oh0 * p.stride;
  const int iw0 = ow0 * p.stride;
  const int KK = p.Kh * p.Kw;
  const int t_begin = rank * p.split_steps;
  const int n_steps = min(p.Gi * KK - t_begin, p.split_steps);

  {
    const int n16 = (P * patch_bytes + S * wstage_bytes) / 16;
    uint4* z = reinterpret_cast<uint4*>(smem_raw);
    for (int e = tid; e < n16; e += kThreads) z[e] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  const int co_stride = p.Gi * KK * p.u;               // w: next output lane
  // Global step t's slice starts t * u bytes after the block's first row;
  // w_blk is at this block's first step.
  const int8_t* w_blk = p.w + (size_t)(go * p.u_out + n0) * co_stride + (size_t)t_begin * p.u;
  const int rows = min(kBN, p.u_out - n0);
  const int pix = PH * PW;
  // Copies per staged row, this thread's first (row, copy) of a weight
  // slice and the stride between its copies: no division in the step loop.
  const int chunks = p.u / p.vec;
  const int r0 = tid / chunks, c0 = tid % chunks;
  const int dr = kThreads / chunks, dc = kThreads % chunks;

  // Step `step`'s weight slice into ring stage step % S, V bytes a copy.
  auto issue_weights_v = [&](auto width, int step) {
    constexpr int V = decltype(width)::value;
    const uint32_t wd = smem_addr(ws + (step % S) * wstage_bytes);
    const int8_t* wsrc = w_blk + (size_t)step * p.u;
    for (int r = r0, c = c0; r < rows;) {
      cp_async<V>(wd + r * pitch + c * V, wsrc + r * co_stride + c * V);
      r += dr;
      c += dc;
      if (c >= chunks) {
        c -= chunks;
        ++r;
      }
    }
  };
  // Input group gi's patch into buffer gi % P.
  auto issue_patch_v = [&](auto width, int gi) {
    constexpr int V = decltype(width)::value;
    const uint32_t xd = smem_addr(xs + (gi % P) * patch_bytes);
    const int8_t* xg = p.x + (size_t)(n * p.Gi + gi) * p.Hp * p.Wp * p.u;
    for (int e = tid; e < pix * chunks; e += kThreads) {
      const int q = e / chunks;
      const int c = (e - q * chunks) * V;
      const int ih = ih0 + q / PW;
      const int iw = iw0 + q % PW;
      if (ih < p.Hp && iw < p.Wp)
        cp_async<V>(xd + q * pitch + c, xg + ((size_t)ih * p.Wp + iw) * p.u + c);
    }
  };
  auto issue_weights = [&](int step) {
    if (p.vec == 16) issue_weights_v(Width<16>{}, step);
    else issue_weights_v(Width<4>{}, step);
  };
  auto issue_patch = [&](int gi) {
    if (p.vec == 16) issue_patch_v(Width<16>{}, gi);
    else issue_patch_v(Width<4>{}, gi);
  };
  // Full staging: a step's loads are its weight slice and, at the first
  // step of a gi or of the block, that gi's patch (its buffer was last read
  // D or more steps before, since Kh * Kw >= D).  Steps are issued in order;
  // (issue_gi, issue_kk) is the next one's (gi, kh * Kw + kw).
  const int gi0 = t_begin / KK;
  const int kk0 = t_begin - gi0 * KK;
  int issue_gi = gi0, issue_kk = kk0;
  auto issue = [&](int step) {
    issue_weights(step);
    if (P == 2 && (issue_kk == 0 || step == 0)) issue_patch(issue_gi);
    if (++issue_kk == KK) {
      issue_kk = 0;
      ++issue_gi;
    }
  };

  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp % 4;
  const int wn = warp / 4;
  // Warps past a lean 4x8 tile or a 32-row slice have nothing to compute.
  const bool busy = wm * 16 < kPix && wn * 32 < wrows;
  // A: lane -> pixel row lane % 16 of the warp's 16, K half 16 * (lane / 16):
  // matrices (pixels 0-7, K 0-15), (8-15, 0-15), (0-7, 16-31), (8-15, 16-31)
  // = a0..a3.
  const int pa = (wm * 16 + lane % 16) % kPix;
  const int a_off = ((pa / kTileW) * p.stride * PW + (pa % kTileW) * p.stride) * pitch
                    + 16 * (lane / 16);
  // B: lane -> output lane (lane % 8) + 8 * (lane / 16) of a 16-lane group,
  // K half 16 * ((lane / 8) % 2): matrices (n0-7, K 0-15), (n0-7, K 16-31),
  // (n8-15, K 0-15), (n8-15, K 16-31) = b0, b1 of two n8 tiles.
  const int b_off = ((wn * 32 + lane % 8 + 8 * (lane / 16)) % wrows) * pitch
                    + 16 * ((lane / 8) % 2);
  const uint32_t xs_base = smem_addr(xs);
  const uint32_t ws_base = smem_addr(ws);
  const int ksteps = (pitch - 16) / 32;
  const uint32_t b_group = 16u * pitch;   // next 16 output lanes

  int acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;

  for (int s = 0; s < D; ++s) {
    if (s < n_steps) issue(s);
    cp_async_commit();
  }
  // Step t_begin + t = (gi, kh, kw), walked without division.
  int gi = gi0, kh = kk0 / p.Kw, kw = kk0 - (kk0 / p.Kw) * p.Kw;
  for (int t = 0; t < n_steps; ++t) {
    // Wait for step t's loads, free step t-1's buffers, start step t + D's.
    cp_async_wait<D - 1>();
    __syncthreads();   // step t landed for all; step t-1's buffers are free
    if (t + D < n_steps) issue(t + D);
    cp_async_commit();
    if (P == 1 && ((kh == 0 && kw == 0) || t == 0)) {   // lean: patch exposed
      issue_patch(gi);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    const uint32_t xa = xs_base + (uint32_t)((gi % P) * patch_bytes + a_off
                                             + (kh * PW + kw) * pitch);
    const uint32_t wb = ws_base + (uint32_t)((t % S) * wstage_bytes + b_off);
    if (++kw == p.Kw) {
      kw = 0;
      if (++kh == p.Kh) {
        kh = 0;
        ++gi;
      }
    }
    if (busy) {
      // Fragments double-buffered in registers: the ldmatrix of 32-deep
      // step ks + 1 is issued before the products of step ks.
      uint32_t a[2][4], b0[2][4], b1[2][4];
      ldmatrix_x4(a[0], xa);
      ldmatrix_x4(b0[0], wb);
      ldmatrix_x4(b1[0], wb + b_group);
#pragma unroll
      for (int ks = 0; ks < kMaxU / 32; ++ks) {
        if (ks >= ksteps) break;
        const int cur = ks % 2;
        if (ks + 1 < ksteps) {
          ldmatrix_x4(a[cur ^ 1], xa + (ks + 1) * 32);
          ldmatrix_x4(b0[cur ^ 1], wb + (ks + 1) * 32);
          ldmatrix_x4(b1[cur ^ 1], wb + b_group + (ks + 1) * 32);
        }
        mma_s8(acc[0], a[cur], b0[cur][0], b0[cur][1]);
        mma_s8(acc[1], a[cur], b0[cur][2], b0[cur][3]);
        mma_s8(acc[2], a[cur], b1[cur][0], b1[cur][1]);
        mma_s8(acc[3], a[cur], b1[cur][2], b1[cur][3]);
      }
    }
  }
  cp_async_wait<0>();
  if (p.ksplit > 1) {
    // The cluster's partial sums meet in rank 0's registers (exact int32):
    // each block parks its own in its shared memory, rank 0 reads the
    // others' through distributed shared memory, and no block leaves before
    // rank 0 has read it.
    cg::cluster_group cluster = cg::this_cluster();
    __syncthreads();   // every warp is done with the staging buffers
    int* part = reinterpret_cast<int*>(smem_raw);   // [16 values][kThreads]
#pragma unroll
    for (int v = 0; v < 16; ++v) part[v * kThreads + tid] = acc[v / 4][v % 4];
    cluster.sync();
    if (rank == 0) {
      for (int r = 1; r < p.ksplit; ++r) {
        const int* other = cluster.map_shared_rank(part, r);
#pragma unroll
        for (int v = 0; v < 16; ++v) acc[v / 4][v % 4] += other[v * kThreads + tid];
      }
    }
    cluster.sync();
    if (rank != 0) return;
  }
  if (!busy) return;
  // C fragment: c0, c1 at (pixel g, lanes 2q, 2q+1), c2, c3 at pixel g + 8.
  const int g = lane / 4;
  const int q = lane % 4;
  const bool even = p.u_out % 2 == 0;   // pairs are aligned
  TOut* outp = static_cast<TOut*>(p.out);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int pp = wm * 16 + g + 8 * h;
    const int oh = oh0 + pp / kTileW;
    const int ow = ow0 + pp % kTileW;
    if (oh >= p.Ho || ow >= p.Wo) continue;
    TOut* op = outp + (((size_t)(n * Go + go) * p.Ho + oh) * p.Wo + ow) * p.u_out;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = n0 + wn * 32 + 8 * j + 2 * q;
      if (co >= p.u_out) continue;
      const bool second = co + 1 < p.u_out;
      const float v0 = flush(p, go, co, acc[j][2 * h]);
      const float v1 = second ? flush(p, go, co + 1, acc[j][2 * h + 1]) : 0.f;
      store2(op + co, v0, v1, even && second, second);
    }
  }
}

int tiles(int Ho, int Wo, int tile_h, int* tiles_w) {
  *tiles_w = (Wo + kTileW - 1) / kTileW;
  return ((Ho + tile_h - 1) / tile_h) * *tiles_w;
}

// Blocks a cluster (the split of the step walk) for a grid of `blocks`
// unsplit blocks, as set out at kSplitMaxBlocks; none where the partial sums
// would not fit the block's shared memory.  *split_steps: steps a block (the
// last block of a cluster may have fewer, never none).
int split_of(long long blocks, int n_steps, long long smem, int* split_steps) {
  int ks = (int)((kSMs + blocks - 1) / blocks);
  ks = min(ks, min(kMaxSplit, n_steps / kMinSteps));
  if (blocks > kSplitMaxBlocks || ks < 2 || smem < kPartialBytes) ks = 1;
  *split_steps = (n_steps + ks - 1) / ks;
  return (n_steps + *split_steps - 1) / *split_steps;
}

template <typename TOut>
int launch(ConvArgs p, int N, int Go, cudaStream_t stream) {
  const Staging st = staging(p.Kh, p.Kw, p.stride, p.u, p.u_out);
  const int n_tiles = tiles(p.Ho, p.Wo, st.tile_h, &p.tiles_w);
  p.n_slices = (p.u_out + kBN - 1) / kBN;
  p.vec = p.u % 16 == 0 && reinterpret_cast<uintptr_t>(p.x) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(p.w) % 16 == 0 ? 16 : 4;
  p.ksplit = split_of((long long)n_tiles * Go * p.n_slices * N, p.Gi * p.Kh * p.Kw,
                      st.bytes, &p.split_steps);
  const dim3 grid(n_tiles * p.ksplit, Go * p.n_slices, N);
  auto kernel = st.patches == 1 ? conv_mapmajor_int8_kernel<TOut, 1, 1>
                : st.wstages == 3 ? conv_mapmajor_int8_kernel<TOut, 2, 2>
                                  : conv_mapmajor_int8_kernel<TOut, 1, 2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)st.bytes);
  if (err != cudaSuccess) return (int)err;
  if (p.ksplit == 1) {
    kernel<<<grid, kThreads, st.bytes, stream>>>(p);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = st.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = p.ksplit;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block requests, in bytes, as staging() picks
// it: two int8 patches of an 8x8 output tile with its halo,
// ((8-1)*s + Kh) x ((8-1)*s + Kw) pixels, and weight_stages(Kh, Kw) weight
// slices of weight_rows(u_out) lanes; or, where that is over 232,448 B, one
// patch of a 4x8 tile and two slices.  Every row is row_pitch(u) =
// round_up(u, 32) + 16 bytes.
long long conv_mapmajor_int8_smem_bytes(int Kh, int Kw, int stride, int u,
                                        int u_out) {
  return staging(Kh, Kw, stride, u, u_out).bytes;
}

int conv_mapmajor_int8_max_u() { return kMaxU; }

// Blocks in one launch: output tiles (8x8, or 4x8 under the lean staging)
// x Go x 64-lane slices of u_out x N, times the blocks a cluster.
long long conv_mapmajor_int8_grid_blocks(int N, int Gi, int Go, int u_out, int Ho,
                                         int Wo, int Kh, int Kw, int stride, int u) {
  int tiles_w, split_steps;
  const Staging st = staging(Kh, Kw, stride, u, u_out);
  const long long blocks =
      (long long)tiles(Ho, Wo, st.tile_h, &tiles_w) * Go * ((u_out + kBN - 1) / kBN) * N;
  return blocks * split_of(blocks, Gi * Kh * Kw, st.bytes, &split_steps);
}

// Returns 0 on success, else the cudaError_t of the refused launch; 1000 for
// arguments this kernel does not take (u not a multiple of 4, a pointer to x
// or w not 4-byte aligned, shapes out of range).  out_f32: 0 bf16, 1 f32.
int conv_mapmajor_int8_launch(const void* x, const void* w, const void* scale,
                              const void* bias, void* out, int N, int Gi,
                              int Hp, int Wp, int u, int Go, int u_out, int Kh,
                              int Kw, int stride, int Ho, int Wo, int relu,
                              int out_f32, void* stream) {
  if (u < 4 || u > kMaxU || u % 4 != 0 || u_out < 1 || u_out > kMaxU ||
      stride < 1 || Kh < 1 || Kw < 1 || Ho < 1 || Wo < 1 || N < 1 || Go < 1 ||
      Gi < 1 || Hp < (Ho - 1) * stride + Kh || Wp < (Wo - 1) * stride + Kw ||
      reinterpret_cast<uintptr_t>(x) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 4 != 0 || scale == nullptr)
    return 1000;
  ConvArgs p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
             static_cast<const float*>(scale), static_cast<const float*>(bias),
             out, Gi, Hp, Wp, u, u_out, Kh, Kw, stride, Ho, Wo, 0, 0, relu, 0, 1, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_f32) return launch<float>(p, N, Go, s);
  return launch<__nv_bfloat16>(p, N, Go, s);
}

}  // extern "C"
