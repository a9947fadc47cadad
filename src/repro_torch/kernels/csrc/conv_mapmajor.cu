// Map-major OLP direct convolution for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/conv_mapmajor/conv_mapmajor.py::
// conv_mapmajor (body _conv_kernel): for each (kh, kw) a (pixels, u_in) x
// (u_in, u_out) product over a strided patch, summed over the Gi input
// channel groups, with bias -> ReLU -> cast folded into the flush.
//
//   x    (N, Gi, Hp, Wp, u)          map-major, already padded (SAME/VALID)
//   w    (Go, u_out, Gi, Kh, Kw, u)  map-major weights
//   bias (Go, u_out) f32 or null
//   out  (N, Go, Ho, Wo, u_out)      map-major
//
// Design: an implicit GEMM per block.  A block of 8 warps owns one
// (n, go, 64-lane slice of u_out, 8x8 tile of output pixels): M = the tile's
// 64 pixels, N = 64 output lanes (32 where u_out <= 32), K walked as
// (gi, kh, kw, u_in in 16-deep steps).  Each warp computes 16 pixels x 32
// lanes with mma.sync.m16n8k16 (bf16 in, f32 accumulate), operands from
// ldmatrix.x4, double-buffered in registers across the 16-deep steps:
// - A is a shifted window of the staged input patch: ldmatrix takes one row
//   address per lane, so row r of step (kh, kw) is the patch pixel
//   ((ph*s + kh)*PW + pw*s + kw); the (kh, kw) shift costs no copy.
// - B comes straight from the map-major weights: the (gi, kh, kw) slice is
//   u_out rows of u_in contiguous elements, already the [n][k] ("col")
//   layout mma.sync wants, so nothing is transposed or repacked.
// mma.sync rather than wgmma: wgmma wants 64-row tiles per warpgroup and B
// in its own shared-memory layout; at these sizes (K = 1.2k-3.5k, a few
// hundred blocks) what limits is moving operands, not the MMA rate.
//
// Staging: cp.async (16 B, L2 only) into rings in shared memory.  Weights
// take a ring of weight_stages() slices, loaded weight_stages() - 1 steps
// ahead, so the next slices are in flight while this step's products run;
// the tile's input patch with its halo, ((8-1)*s + Kh) x ((8-1)*s + Kw)
// pixels, takes a ring of two, so the next gi's patch arrives during this
// gi's last steps.  Every row is padded to row_pitch(u) = round_up(u, 16) + 8
// elements: K is zero-filled up to the 16-deep MMA step, and the odd number
// of 16-byte chunks per row puts the 8 rows of an ldmatrix in 8 different
// bank groups (a 256-byte pitch would put all 8 in one).  Shared memory is
// zeroed once per block; pixels outside the input, lanes past u_out and K
// past u are never written after that.  Rows that are not 16-byte multiples
// (u = 4 in bf16) are staged by plain loads instead of cp.async.  Where two
// patches and the weight ring would pass the 232,448 B a block may have
// (large kernels or strides, f32 operands), a lean staging takes a 4x8 tile
// (the last four warps idle), one patch, loaded at each gi's first step with
// its latency exposed, and two slices.  That keeps the envelope at least as
// wide as an 8x8 tile's unpadded patch plus one weight slice (every k <= 11,
// stride <= 4; tests/test_torch_kernels.py checks), and 32-lane slices where
// u_out <= 32 keep it so for narrow outputs.  conv_mapmajor_smem_bytes below
// is the whole dynamic request; the same formula in Python
// (kernels/conv_mapmajor/conv_mapmajor.py::kernel_smem_bytes) is the
// planner's rule-1 envelope.
//
// Arithmetic.  RELAXED (and the IMPRECISE_INT8 dequant path): bf16 operands,
// f32 accumulation across all steps in the MMA accumulators.  IMPRECISE: a
// second fragment set `part` takes one (gi, kh, kw) step's u_in-deep product;
// then acc = bf16(acc + bf16(part)) and part is reset, as the TPU kernel's
// bf16 scratch accumulator does.  PRECISE: f32 operands on the same staging,
// f32 FMA on the FP32 pipes (neither bf16 nor TF32 tensor cores hold the
// 1e-5 it is checked to); the planner never routes PRECISE to this kernel.
//
// Bound.  At AlexNet conv2-conv5 shapes the work is far above the ridge point
// (hundreds of FLOP per byte), so the bound is operations at the bf16
// tensor-core rate.  What keeps this design from it is latency per step:
// each (gi, kh, kw) step is 8 MMA steps per warp between a cp.async wait
// and a barrier, with one or two blocks per SM (106-131 KB of shared memory
// each) to hide them; each block streams its weight slices from L2 once
// per 64 pixels (a 32-pixel tile would double that traffic); 13x13 planes fill
// 8x8 tiles to 66 %; at batch 1 there are only 16-64 blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

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

// K padded to the 16-deep MMA step, plus 8 elements (one 16-byte chunk for
// bf16) so consecutive rows fall in different bank groups.
__host__ __device__ inline int row_pitch(int u) { return (u + 15) / 16 * 16 + 8; }
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
inline Staging staging(int Kh, int Kw, int stride, int u, int u_out, int mode) {
  const long long pw = (long long)(kTileW - 1) * stride + Kw;
  const long long row = (long long)row_pitch(u) * (mode == 0 ? 4 : 2);
  const long long wrows = weight_rows(u_out);
  const int ws = weight_stages(Kh, Kw);
  const long long full = (2 * ((kTileH - 1) * stride + Kh) * pw + ws * wrows) * row;
  if (full <= kSmemBudget) return {kTileH, 2, ws, full};
  const long long lean = (((kLeanTileH - 1) * stride + Kh) * pw + 2 * wrows) * row;
  return {kLeanTileH, 1, 2, lean};
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
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
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct ConvArgs {
  const void* x;
  const void* w;
  const float* bias;
  void* out;
  int Gi, Hp, Wp, u, u_out, Kh, Kw, stride, Ho, Wo;
  int tiles_w, n_slices, relu, vec;
};

// Flush one output element: bias -> ReLU -> cast, in the accumulator's type
// (bf16 for IMPRECISE, f32 otherwise).
template <typename T, bool kImprecise>
__device__ __forceinline__ void store_out(const ConvArgs& p, T* op, int go,
                                          int co, float v) {
  if (p.bias != nullptr) {
    const float b = p.bias[go * p.u_out + co];
    v = kImprecise ? round_bf16(v + round_bf16(b)) : v + b;
  }
  if (p.relu) v = fmaxf(v, 0.f);
  op[co] = from_f32<T>(v);
}

// kMode: 0 PRECISE (T = float, FMA), 1 RELAXED, 2 IMPRECISE (T = bf16, MMA).
// D: the weight ring's lookahead (its stages less one); P: patch buffers,
// 2 for the full staging (8x8 tile), 1 for the lean one (4x8 tile).
template <typename T, int kMode, int D, int P>
__global__ void __launch_bounds__(kThreads)
conv_mapmajor_kernel(const ConvArgs p) {
  constexpr int S = D + 1;
  constexpr int TH = P == 2 ? kTileH : kLeanTileH;
  constexpr int kPix = TH * kTileW;
  constexpr bool kImprecise = kMode == 2;
  constexpr int kVec = 16 / sizeof(T);     // elements per 16-byte chunk
  static_assert(P == 2 || D == 1, "a lean staging has one patch, two slices");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pitch = row_pitch(p.u);
  const int PH = (TH - 1) * p.stride + p.Kh;
  const int PW = (kTileW - 1) * p.stride + p.Kw;
  const int patch_elems = PH * PW * pitch;
  const int wrows = weight_rows(p.u_out);
  const int wstage_elems = wrows * pitch;
  T* xs = reinterpret_cast<T*>(smem_raw);              // [P][PH * PW][pitch]
  T* ws = xs + P * patch_elems;                         // [S][wrows][pitch]

  const int tid = threadIdx.x;
  const int go = blockIdx.y / p.n_slices;
  const int n0 = (blockIdx.y % p.n_slices) * kBN;
  const int n = blockIdx.z;
  const int Go = gridDim.y / p.n_slices;
  const int oh0 = (blockIdx.x / p.tiles_w) * TH;
  const int ow0 = (blockIdx.x % p.tiles_w) * kTileW;
  const int ih0 = oh0 * p.stride;
  const int iw0 = ow0 * p.stride;
  const int KK = p.Kh * p.Kw;
  const int n_steps = p.Gi * KK;

  {
    const int n16 = (P * patch_elems + S * wstage_elems) * (int)sizeof(T) / 16;
    uint4* z = reinterpret_cast<uint4*>(smem_raw);
    for (int e = tid; e < n16; e += kThreads) z[e] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  const T* x = static_cast<const T*>(p.x);
  const int co_stride = p.Gi * KK * p.u;               // w: next output lane
  // Step t's slice starts t * u elements after the block's first row.
  const T* w_blk = static_cast<const T*>(p.w) + (size_t)(go * p.u_out + n0) * co_stride;
  const int rows = min(kBN, p.u_out - n0);
  const int chunks = max(p.u / kVec, 1);               // per row, vec path
  // This thread's first (row, chunk) of a slice, and the stride between its
  // chunks, so that staging a slice costs no division.
  const int r0 = tid / chunks, c0 = tid % chunks;
  const int dr = kThreads / chunks, dc = kThreads % chunks;
  const int pix = PH * PW;

  // Step `step`'s weight slice into ring stage step % S.
  auto issue_weights = [&](int step) {
    T* wd = ws + (step % S) * wstage_elems;
    const T* wsrc = w_blk + (size_t)step * p.u;
    if (p.vec) {
      const uint32_t wd_s = smem_addr(wd);
      for (int r = r0, c = c0; r < rows;) {
        cp_async16(wd_s + (r * pitch + c * kVec) * (int)sizeof(T),
                   wsrc + r * co_stride + c * kVec);
        r += dr;
        c += dc;
        if (c >= chunks) {
          c -= chunks;
          ++r;
        }
      }
    } else {
      for (int e = tid; e < rows * p.u; e += kThreads) {
        const int r = e / p.u;
        const int c = e - r * p.u;
        wd[r * pitch + c] = wsrc[r * co_stride + c];
      }
    }
  };
  // Input group gi's patch into buffer gi % P.
  auto issue_patch = [&](int gi) {
    T* xd = xs + (gi % P) * patch_elems;
    const T* xg = x + (size_t)(n * p.Gi + gi) * p.Hp * p.Wp * p.u;
    if (p.vec) {
      for (int e = tid; e < pix * chunks; e += kThreads) {
        const int q = e / chunks;
        const int c = (e - q * chunks) * kVec;
        const int ih = ih0 + q / PW;
        const int iw = iw0 + q % PW;
        if (ih < p.Hp && iw < p.Wp)
          cp_async16(smem_addr(xd + q * pitch + c),
                     xg + ((size_t)ih * p.Wp + iw) * p.u + c);
      }
    } else {
      for (int e = tid; e < pix * p.u; e += kThreads) {
        const int q = e / p.u;
        const int c = e - q * p.u;
        const int ih = ih0 + q / PW;
        const int iw = iw0 + q % PW;
        if (ih < p.Hp && iw < p.Wp)
          xd[q * pitch + c] = xg[((size_t)ih * p.Wp + iw) * p.u + c];
      }
    }
  };
  // Full staging: a step's loads are its weight slice and, at the first
  // step of a gi, that gi's patch (its buffer was last read D or more steps
  // before, since Kh * Kw >= D).
  auto issue = [&](int step) {
    issue_weights(step);
    if (P == 2 && step % KK == 0) issue_patch(step / KK);
  };
  auto prologue = [&]() {
    for (int s = 0; s < D; ++s) {
      if (s < n_steps) issue(s);
      cp_async_commit();
    }
  };
  // Before step t's products: wait for its loads, free step t-1's buffers,
  // start step t + D's.  The lean staging loads the patch here, exposed.
  auto begin_step = [&](int t) {
    cp_async_wait<D - 1>();
    __syncthreads();   // step t landed for all; step t-1's buffers are free
    if (t + D < n_steps) issue(t + D);
    cp_async_commit();
    if (P == 1 && t % KK == 0) {
      issue_patch(t / KK);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
  };

  const int lane = tid % 32;
  const int warp = tid / 32;
  const int kpad = pitch - 8;
  T* outp = static_cast<T*>(p.out);

  if constexpr (kMode == 0) {
    // ---- PRECISE: f32 FMA, 4 pixels x 4 lanes per thread ----------------
    const int tp = tid / 16;     // pixels tp + 16 i
    const int tc = tid % 16;     // lanes n0 + tc + 16 j
    int x_off[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pp = (tp + 16 * i) % kPix;   // lean: the idle half repeats
      x_off[i] = ((pp / kTileW) * p.stride * PW + (pp % kTileW) * p.stride) * pitch;
    }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    prologue();
    for (int t = 0; t < n_steps; ++t) {
      begin_step(t);
      const int gi = t / KK;
      const int kk = t % KK;
      const float* xk = reinterpret_cast<const float*>(xs) + (gi % P) * patch_elems
                        + ((kk / p.Kw) * PW + kk % p.Kw) * pitch;
      const float* wk = reinterpret_cast<const float*>(ws) + (t % S) * wstage_elems + tc * pitch;
      for (int k = 0; k < kpad; k += 4) {
        float4 xv[4], wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = *reinterpret_cast<const float4*>(xk + x_off[i] + k);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wv[j] = 16 * j < wrows ? *reinterpret_cast<const float4*>(wk + 16 * j * pitch + k)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float a = acc[i][j];
            a = fmaf(xv[i].x, wv[j].x, a);
            a = fmaf(xv[i].y, wv[j].y, a);
            a = fmaf(xv[i].z, wv[j].z, a);
            a = fmaf(xv[i].w, wv[j].w, a);
            acc[i][j] = a;
          }
      }
    }
    cp_async_wait<0>();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pp = tp + 16 * i;
      const int oh = oh0 + pp / kTileW;
      const int ow = ow0 + pp % kTileW;
      if (pp >= kPix || oh >= p.Ho || ow >= p.Wo) continue;
      T* op = outp + (((size_t)(n * Go + go) * p.Ho + oh) * p.Wo + ow) * p.u_out;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int co = n0 + tc + 16 * j;
        if (co < p.u_out) store_out<T, false>(p, op, go, co, acc[i][j]);
      }
    }
  } else {
    // ---- RELAXED / IMPRECISE: bf16 mma.sync, 16 pixels x 32 lanes per warp
    const int wm = warp % 4;
    const int wn = warp / 4;
    // Warps past a lean 4x8 tile or a 32-row slice have nothing to compute.
    const bool busy = wm * 16 < kPix && wn * 32 < wrows;
    // A: lane -> pixel row lane % 16 of the warp's 16, k half 8 * (lane / 16).
    const int pa = (wm * 16 + lane % 16) % kPix;
    const int a_off = ((pa / kTileW) * p.stride * PW + (pa % kTileW) * p.stride) * pitch
                      + 8 * (lane / 16);
    // B: lane -> output lane (lane % 8) + 8 * (lane / 16) of a 16-lane group,
    // k half 8 * ((lane / 8) % 2): matrices (n0-7,k0-7), (n0-7,k8-15),
    // (n8-15,k0-7), (n8-15,k8-15) = b0, b1 of two n8 tiles.
    const int b_off = ((wn * 32 + lane % 8 + 8 * (lane / 16)) % wrows) * pitch
                      + 8 * ((lane / 8) % 2);
    const uint32_t xs_base = smem_addr(xs);
    const uint32_t ws_base = smem_addr(ws);
    const int ksteps = kpad / 16;
    const uint32_t b_group = 16u * pitch * sizeof(T);   // next 16 output lanes

    float acc[4][4], part[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[j][e] = 0.f;
        part[j][e] = 0.f;
      }

    prologue();
    for (int t = 0; t < n_steps; ++t) {
      begin_step(t);
      const int gi = t / KK;
      const int kk = t % KK;
      const uint32_t xa = xs_base + (uint32_t)((gi % P) * patch_elems + a_off
                                               + ((kk / p.Kw) * PW + kk % p.Kw) * pitch)
                                        * sizeof(T);
      const uint32_t wb = ws_base + (uint32_t)((t % S) * wstage_elems + b_off) * sizeof(T);
      float (&d)[4][4] = kImprecise ? part : acc;
      if (busy) {
        // Fragments double-buffered in registers: the ldmatrix of 16-deep
        // step ks + 1 is issued before the products of step ks.
        uint32_t a[2][4], b0[2][4], b1[2][4];
        ldmatrix_x4(a[0], xa);
        ldmatrix_x4(b0[0], wb);
        ldmatrix_x4(b1[0], wb + b_group);
#pragma unroll
        for (int ks = 0; ks < kMaxU / 16; ++ks) {
          if (ks >= ksteps) break;
          const int cur = ks % 2;
          if (ks + 1 < ksteps) {
            ldmatrix_x4(a[cur ^ 1], xa + (ks + 1) * 32);
            ldmatrix_x4(b0[cur ^ 1], wb + (ks + 1) * 32);
            ldmatrix_x4(b1[cur ^ 1], wb + b_group + (ks + 1) * 32);
          }
          mma_bf16(d[0], a[cur], b0[cur][0], b0[cur][1]);
          mma_bf16(d[1], a[cur], b0[cur][2], b0[cur][3]);
          mma_bf16(d[2], a[cur], b1[cur][0], b1[cur][1]);
          mma_bf16(d[3], a[cur], b1[cur][2], b1[cur][3]);
        }
      }
      if (kImprecise) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[j][e] = round_bf16(acc[j][e] + round_bf16(part[j][e]));
            part[j][e] = 0.f;
          }
      }
    }
    cp_async_wait<0>();
    if (!busy) return;
    // C fragment: c0, c1 at (row g, lanes 2q, 2q+1), c2, c3 at row g + 8.
    const int g = lane / 4;
    const int q = lane % 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pp = wm * 16 + g + 8 * h;
      const int oh = oh0 + pp / kTileW;
      const int ow = ow0 + pp % kTileW;
      if (oh >= p.Ho || ow >= p.Wo) continue;
      T* op = outp + (((size_t)(n * Go + go) * p.Ho + oh) * p.Wo + ow) * p.u_out;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = n0 + wn * 32 + 8 * j + 2 * q + e;
          if (co < p.u_out) store_out<T, kImprecise>(p, op, go, co, acc[j][2 * h + e]);
        }
    }
  }
}

int tiles(int Ho, int Wo, int tile_h, int* tiles_w) {
  *tiles_w = (Wo + kTileW - 1) / kTileW;
  return ((Ho + tile_h - 1) / tile_h) * *tiles_w;
}

template <typename T, int kMode>
int launch(ConvArgs p, int N, int Go, cudaStream_t stream) {
  const Staging st = staging(p.Kh, p.Kw, p.stride, p.u, p.u_out, kMode);
  const int n_tiles = tiles(p.Ho, p.Wo, st.tile_h, &p.tiles_w);
  p.n_slices = (p.u_out + kBN - 1) / kBN;
  p.vec = (p.u * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(p.x) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(p.w) % 16 == 0;
  const dim3 grid(n_tiles, Go * p.n_slices, N);
  auto kernel = st.patches == 1 ? conv_mapmajor_kernel<T, kMode, 1, 1>
                : st.wstages == 3 ? conv_mapmajor_kernel<T, kMode, 2, 2>
                                  : conv_mapmajor_kernel<T, kMode, 1, 2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)st.bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, st.bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block requests, as staging() picks it: two
// patches of an 8x8 output tile with its halo, ((8-1)*s + Kh) x
// ((8-1)*s + Kw) pixels, and weight_stages(Kh, Kw) weight slices of
// weight_rows(u_out) lanes; or, where that is over 232,448 B, one patch of a
// 4x8 tile and two slices.  Every row is row_pitch(u) elements of the
// operand type (4 B for PRECISE, 2 B for RELAXED/IMPRECISE).
// mode: 0 PRECISE, 1 RELAXED, 2 IMPRECISE.
long long conv_mapmajor_smem_bytes(int Kh, int Kw, int stride, int u,
                                   int u_out, int mode) {
  return staging(Kh, Kw, stride, u, u_out, mode).bytes;
}

int conv_mapmajor_max_u() { return kMaxU; }

// Blocks in one launch: output tiles (8x8, or 4x8 under the lean staging)
// x Go x 64-lane slices of u_out x N.
long long conv_mapmajor_grid_blocks(int N, int Go, int u_out, int Ho, int Wo,
                                    int Kh, int Kw, int stride, int u, int mode) {
  int tiles_w;
  const Staging st = staging(Kh, Kw, stride, u, u_out, mode);
  return (long long)tiles(Ho, Wo, st.tile_h, &tiles_w) * Go * ((u_out + kBN - 1) / kBN) * N;
}

// Returns 0 on success, else the cudaError_t of the refused launch; 1000 for
// arguments this kernel does not take.
int conv_mapmajor_launch(const void* x, const void* w, const void* bias,
                         void* out, int N, int Gi, int Hp, int Wp, int u,
                         int Go, int u_out, int Kh, int Kw, int stride, int Ho,
                         int Wo, int mode, int relu, void* stream) {
  if (u < 1 || u > kMaxU || u_out < 1 || u_out > kMaxU || stride < 1 ||
      Kh < 1 || Kw < 1 || Ho < 1 || Wo < 1 || N < 1 || Go < 1 || Gi < 1 ||
      Hp < (Ho - 1) * stride + Kh || Wp < (Wo - 1) * stride + Kw)
    return 1000;
  ConvArgs p{x, w, static_cast<const float*>(bias), out, Gi, Hp, Wp, u, u_out,
             Kh, Kw, stride, Ho, Wo, 0, 0, relu, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch<float, 0>(p, N, Go, s);
    case 1: return launch<__nv_bfloat16, 1>(p, N, Go, s);
    case 2: return launch<__nv_bfloat16, 2>(p, N, Go, s);
    default: return 1000;
  }
}

}  // extern "C"
