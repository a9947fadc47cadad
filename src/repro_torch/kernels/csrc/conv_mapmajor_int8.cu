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
// Design.  The float kernel's decomposition (conv_mapmajor.cu): a block owns
// one (n, go, 8x8 tile of output pixels) and loops over Gi x Kh x Kw itself,
// since Hopper blocks run in no order and cannot carry a sum between them as
// the TPU's sequential Gi grid axis does.  Per input group it stages the
// tile's int8 patch with its halo, ((8-1)*s + Kh) x ((8-1)*s + Kw) x u, in
// shared memory; per (kh, kw) it stages the (u_out, u_in) weight slice.
// Map-major keeps u_in innermost in both, so four neighbouring input
// channels are one 32-bit word: each thread holds 4 pixels x 8 output
// channels of int32 sums in registers and adds four products at a time with
// __dp4a.  Weight rows are padded by one word (an odd stride in words), so
// the 16 channel lanes of a warp read 16 different banks.  u must be a
// multiple of 4.  The two buffers are the whole dynamic shared memory
// request: conv_mapmajor_int8_smem_bytes below, and the same formula in
// Python (kernels/conv_mapmajor/conv_mapmajor.py::kernel_smem_bytes_int8) is
// the planner's rule-1 envelope under IMPRECISE_INT8.
//
// Flush.  The int32 sums are exact, so the flush is the only place the card
// could differ from the plain version.  It rounds as the TPU kernel does:
// float(acc) (round to nearest), times s (one f32 rounding), plus the bias
// (another), ReLU, then round to bf16.  __fmul_rn/__fadd_rn keep nvcc from
// contracting the two into one FMA, which would round once.
//
// Bound.  At AlexNet conv2-conv5 shapes the work is far above the int8 ridge
// point, so the bound is operations at the int8 tensor-core rate.  This
// first kernel runs __dp4a on the integer pipes (one instruction per four
// MACs), not the tensor cores, so it sits well above that bound; mma.sync
// m16n8k32 s8 / wgmma tiles and a cp.async or TMA ring are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileH = 8;
constexpr int kTileW = 8;
constexpr int kPixLanes = 16;      // threads along output pixels
constexpr int kPixPerThread = 4;   // kPixLanes * kPixPerThread == kTileH * kTileW
constexpr int kChLanes = 16;       // threads along output channels
constexpr int kChPerThread = 8;    // kChLanes * kChPerThread == 128 == max u_out
constexpr int kMaxU = kChLanes * kChPerThread;

static_assert(kPixLanes * kChLanes == kThreads, "thread layout");
static_assert(kPixLanes * kPixPerThread == kTileH * kTileW, "pixel tile");

template <typename T> __device__ __forceinline__ T to_out(float v);
template <> __device__ __forceinline__ float to_out<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// x and w are read as 32-bit words: four int8 channels each (u4 = u / 4).
template <typename TOut>
__global__ void __launch_bounds__(kThreads)
conv_mapmajor_int8_kernel(const int* __restrict__ x, const int* __restrict__ w,
                          const float* __restrict__ scale,
                          const float* __restrict__ bias, TOut* __restrict__ out,
                          int Gi, int Hp, int Wp, int u4, int u_out, int Kh,
                          int Kw, int stride, int Ho, int Wo, int tiles_w,
                          int relu) {
  extern __shared__ __align__(16) int smem[];
  const int PH = (kTileH - 1) * stride + Kh;
  const int PW = (kTileW - 1) * stride + Kw;
  int* xs = smem;                          // (PH, PW, u4) words
  int* ws = xs + PH * PW * u4;             // (u_out, u4 + 1) words
  const int ws_ld = u4 + 1;

  const int tile = blockIdx.x;
  const int go = blockIdx.y;
  const int n = blockIdx.z;
  const int Go = gridDim.y;
  const int oh0 = (tile / tiles_w) * kTileH;
  const int ow0 = (tile % tiles_w) * kTileW;
  const int ih0 = oh0 * stride;
  const int iw0 = ow0 * stride;
  const int tid = threadIdx.x;
  const int tc = tid % kChLanes;
  const int tp = tid / kChLanes;

  int pix_off[kPixPerThread];
#pragma unroll
  for (int i = 0; i < kPixPerThread; ++i) {
    const int p = tp + kPixLanes * i;
    pix_off[i] = ((p / kTileW) * stride * PW + (p % kTileW) * stride) * u4;
  }

  int acc[kPixPerThread][kChPerThread];
#pragma unroll
  for (int i = 0; i < kPixPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kChPerThread; ++j) acc[i][j] = 0;

  const size_t co_stride = (size_t)Gi * Kh * Kw * u4;   // w: next output channel
  const int patch_words = PH * PW * u4;
  const int w_words = u_out * u4;

  for (int gi = 0; gi < Gi; ++gi) {
    __syncthreads();   // every thread is done reading xs of the previous group
    const int* xg = x + (size_t)(n * Gi + gi) * Hp * Wp * u4;
    for (int e = tid; e < patch_words; e += kThreads) {
      const int c = e % u4;
      const int rest = e / u4;
      const int ih = ih0 + rest / PW;
      const int iw = iw0 + rest % PW;
      xs[e] = (ih < Hp && iw < Wp) ? xg[((size_t)ih * Wp + iw) * u4 + c] : 0;
    }
    for (int kh = 0; kh < Kh; ++kh) {
      for (int kw = 0; kw < Kw; ++kw) {
        __syncthreads();   // xs staged; ws of the previous step no longer read
        const int* wg = w + ((size_t)go * u_out * Gi + gi) * Kh * Kw * u4
                          + (size_t)(kh * Kw + kw) * u4;
        for (int e = tid; e < w_words; e += kThreads) {
          const int co = e / u4;
          const int c = e % u4;
          ws[co * ws_ld + c] = wg[co * co_stride + c];
        }
        __syncthreads();
        const int* xk = xs + (kh * PW + kw) * u4;
#pragma unroll 4
        for (int c = 0; c < u4; ++c) {
          int xv[kPixPerThread];
          int wv[kChPerThread];
#pragma unroll
          for (int i = 0; i < kPixPerThread; ++i) xv[i] = xk[pix_off[i] + c];
#pragma unroll
          for (int j = 0; j < kChPerThread; ++j) {
            const int co = tc + kChLanes * j;
            wv[j] = co < u_out ? ws[co * ws_ld + c] : 0;
          }
#pragma unroll
          for (int i = 0; i < kPixPerThread; ++i)
#pragma unroll
            for (int j = 0; j < kChPerThread; ++j)
              acc[i][j] = __dp4a(xv[i], wv[j], acc[i][j]);
        }
      }
    }
  }

  // Flush: dequant -> bias -> ReLU -> cast, then one write of the map-major
  // output.
#pragma unroll
  for (int i = 0; i < kPixPerThread; ++i) {
    const int p = tp + kPixLanes * i;
    const int oh = oh0 + p / kTileW;
    const int ow = ow0 + p % kTileW;
    if (oh >= Ho || ow >= Wo) continue;
    TOut* op = out + (((size_t)(n * Go + go) * Ho + oh) * Wo + ow) * u_out;
#pragma unroll
    for (int j = 0; j < kChPerThread; ++j) {
      const int co = tc + kChLanes * j;
      if (co >= u_out) continue;
      float v = __fmul_rn(__int2float_rn(acc[i][j]), scale[go * u_out + co]);
      if (bias != nullptr) v = __fadd_rn(v, bias[go * u_out + co]);
      if (relu) v = fmaxf(v, 0.f);
      op[co] = to_out<TOut>(v);
    }
  }
}

template <typename TOut>
int launch(const void* x, const void* w, const void* scale, const void* bias,
           void* out, int N, int Gi, int Hp, int Wp, int u, int Go, int u_out,
           int Kh, int Kw, int stride, int Ho, int Wo, int relu, size_t smem,
           cudaStream_t stream) {
  auto kernel = conv_mapmajor_int8_kernel<TOut>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_h = (Ho + kTileH - 1) / kTileH;
  const int tiles_w = (Wo + kTileW - 1) / kTileW;
  dim3 grid(tiles_h * tiles_w, Go, N);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const int*>(x), static_cast<const int*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<TOut*>(out), Gi, Hp, Wp, u / 4, u_out, Kh, Kw, stride, Ho,
      Wo, tiles_w, relu);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block requests, in bytes: the int8 input patch
// with its halo plus the (u_out, u + 4) int8 weight slice.
long long conv_mapmajor_int8_smem_bytes(int Kh, int Kw, int stride, int u,
                                        int u_out) {
  const long long PH = (long long)(kTileH - 1) * stride + Kh;
  const long long PW = (long long)(kTileW - 1) * stride + Kw;
  return PH * PW * u + (long long)u_out * (u + 4);
}

int conv_mapmajor_int8_max_u() { return kMaxU; }

// Returns 0 on success, else the cudaError_t of the refused launch; 1000 for
// arguments this kernel does not take (u not a multiple of 4, a pointer to x
// or w not 4-byte aligned, shapes out of range).  out_f32: 0 bf16, 1 f32.
int conv_mapmajor_int8_launch(const void* x, const void* w, const void* scale,
                              const void* bias, void* out, int N, int Gi,
                              int Hp, int Wp, int u, int Go, int u_out, int Kh,
                              int Kw, int stride, int Ho, int Wo, int relu,
                              int out_f32, void* stream) {
  if (u < 4 || u > kMaxU || u % 4 != 0 || u_out < 1 || u_out > kMaxU ||
      stride < 1 || Ho < 1 || Wo < 1 || N < 1 || Go < 1 || Gi < 1 ||
      Hp < (Ho - 1) * stride + Kh || Wp < (Wo - 1) * stride + Kw ||
      reinterpret_cast<uintptr_t>(x) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 4 != 0 || scale == nullptr)
    return 1000;
  const size_t smem = (size_t)conv_mapmajor_int8_smem_bytes(Kh, Kw, stride, u, u_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_f32)
    return launch<float>(x, w, scale, bias, out, N, Gi, Hp, Wp, u, Go, u_out,
                         Kh, Kw, stride, Ho, Wo, relu, smem, s);
  return launch<__nv_bfloat16>(x, w, scale, bias, out, N, Gi, Hp, Wp, u, Go,
                               u_out, Kh, Kw, stride, Ho, Wo, relu, smem, s);
}

}  // extern "C"
