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
// Design.  The TPU grid is (N, Go, Gi) with Gi sequential and a whole padded
// plane per block (up to ~13 MB of VMEM).  Hopper blocks run in no order and
// have at most 227 KB of shared memory, so a block here owns one
// (n, go, 8x8 tile of output pixels) and loops over Gi x Kh x Kw itself.  Per
// input group it stages the tile's input patch with its halo,
// ((8-1)*s + Kh) x ((8-1)*s + Kw) x u, in shared memory; per (kh, kw) it
// stages the (u_in, u_out) weight slice, transposed so that neighbouring
// threads read neighbouring output channels.  Those two buffers are the whole
// dynamic shared memory request: conv_mapmajor_smem_bytes below, and the
// same formula in Python (kernels/conv_mapmajor/conv_mapmajor.py::
// kernel_smem_bytes) is the planner's rule-1 envelope.
//
// Arithmetic.  PRECISE: f32 operands, f32 FMA (no TF32).  RELAXED: bf16
// operands widened to f32, f32 accumulation, bf16 out.  IMPRECISE: each
// (gi, kh, kw) step's partial sum is rounded to bf16 and added to a bf16
// accumulator (rounded again), as the TPU kernel's bf16 scratch does.
//
// Bound.  At AlexNet conv2-conv5 shapes the work is above the ridge point
// (hundreds of FLOP per byte), so the bound is operations; this first kernel
// runs on the FP32 pipes (FMA), not the tensor cores, so it sits well above
// that bound.  mma.sync / wgmma tiles are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

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

template <typename T, bool kImprecise>
__global__ void __launch_bounds__(kThreads)
conv_mapmajor_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const float* __restrict__ bias, T* __restrict__ out,
                     int Gi, int Hp, int Wp, int u, int u_out, int Kh, int Kw,
                     int stride, int Ho, int Wo, int tiles_w, int relu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int PH = (kTileH - 1) * stride + Kh;
  const int PW = (kTileW - 1) * stride + Kw;
  T* xs = reinterpret_cast<T*>(smem_raw);          // (PH, PW, u)
  T* ws = xs + (size_t)PH * PW * u;                 // (u, u_out + 1)
  const int ws_ld = u_out + 1;

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
    pix_off[i] = ((p / kTileW) * stride * PW + (p % kTileW) * stride) * u;
  }

  float acc[kPixPerThread][kChPerThread];
  float part[kPixPerThread][kChPerThread];
#pragma unroll
  for (int i = 0; i < kPixPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kChPerThread; ++j) {
      acc[i][j] = 0.f;
      part[i][j] = 0.f;
    }

  const size_t co_stride = (size_t)Gi * Kh * Kw * u;   // w: next output channel
  const int patch_elems = PH * PW * u;
  const int w_elems = u_out * u;

  for (int gi = 0; gi < Gi; ++gi) {
    __syncthreads();   // every thread is done reading xs of the previous group
    const T* xg = x + (size_t)(n * Gi + gi) * Hp * Wp * u;
    for (int e = tid; e < patch_elems; e += kThreads) {
      const int c = e % u;
      const int rest = e / u;
      const int ih = ih0 + rest / PW;
      const int iw = iw0 + rest % PW;
      xs[e] = (ih < Hp && iw < Wp) ? xg[((size_t)ih * Wp + iw) * u + c]
                                   : from_f32<T>(0.f);
    }
    for (int kh = 0; kh < Kh; ++kh) {
      for (int kw = 0; kw < Kw; ++kw) {
        __syncthreads();   // xs staged; ws of the previous step no longer read
        const T* wg = w + ((size_t)go * u_out * Gi + gi) * Kh * Kw * u
                        + (size_t)(kh * Kw + kw) * u;
        for (int e = tid; e < w_elems; e += kThreads) {
          const int co = e / u;
          const int ci = e % u;
          ws[ci * ws_ld + co] = wg[co * co_stride + ci];
        }
        __syncthreads();
        const T* xk = xs + (kh * PW + kw) * u;
#pragma unroll 4
        for (int ci = 0; ci < u; ++ci) {
          float xv[kPixPerThread];
          float wv[kChPerThread];
#pragma unroll
          for (int i = 0; i < kPixPerThread; ++i) xv[i] = to_f32(xk[pix_off[i] + ci]);
#pragma unroll
          for (int j = 0; j < kChPerThread; ++j) {
            const int co = tc + kChLanes * j;
            wv[j] = co < u_out ? to_f32(ws[ci * ws_ld + co]) : 0.f;
          }
#pragma unroll
          for (int i = 0; i < kPixPerThread; ++i)
#pragma unroll
            for (int j = 0; j < kChPerThread; ++j) {
              if (kImprecise) part[i][j] = fmaf(xv[i], wv[j], part[i][j]);
              else acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
            }
        }
        if (kImprecise) {
#pragma unroll
          for (int i = 0; i < kPixPerThread; ++i)
#pragma unroll
            for (int j = 0; j < kChPerThread; ++j) {
              acc[i][j] = round_bf16(acc[i][j] + round_bf16(part[i][j]));
              part[i][j] = 0.f;
            }
        }
      }
    }
  }

  // Flush: bias -> ReLU -> cast, in the accumulator's type (bf16 for
  // IMPRECISE, f32 otherwise), then one write of the map-major output.
#pragma unroll
  for (int i = 0; i < kPixPerThread; ++i) {
    const int p = tp + kPixLanes * i;
    const int oh = oh0 + p / kTileW;
    const int ow = ow0 + p % kTileW;
    if (oh >= Ho || ow >= Wo) continue;
    T* op = out + (((size_t)(n * Go + go) * Ho + oh) * Wo + ow) * u_out;
#pragma unroll
    for (int j = 0; j < kChPerThread; ++j) {
      const int co = tc + kChLanes * j;
      if (co >= u_out) continue;
      float v = acc[i][j];
      if (bias != nullptr) {
        const float b = bias[go * u_out + co];
        v = kImprecise ? round_bf16(v + round_bf16(b)) : v + b;
      }
      if (relu) v = fmaxf(v, 0.f);
      op[co] = from_f32<T>(v);
    }
  }
}

template <typename T, bool kImprecise>
int launch(const void* x, const void* w, const void* bias, void* out, int N,
           int Gi, int Hp, int Wp, int u, int Go, int u_out, int Kh, int Kw,
           int stride, int Ho, int Wo, int relu, size_t smem,
           cudaStream_t stream) {
  auto kernel = conv_mapmajor_kernel<T, kImprecise>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_h = (Ho + kTileH - 1) / kTileH;
  const int tiles_w = (Wo + kTileW - 1) / kTileW;
  dim3 grid(tiles_h * tiles_w, Go, N);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<T*>(out), Gi, Hp, Wp, u,
      u_out, Kh, Kw, stride, Ho, Wo, tiles_w, relu);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block requests: the input patch with its halo
// plus the padded weight slice, in the operand type (4 B for PRECISE,
// 2 B for RELAXED/IMPRECISE).  mode: 0 PRECISE, 1 RELAXED, 2 IMPRECISE.
long long conv_mapmajor_smem_bytes(int Kh, int Kw, int stride, int u,
                                   int u_out, int mode) {
  const long long PH = (long long)(kTileH - 1) * stride + Kh;
  const long long PW = (long long)(kTileW - 1) * stride + Kw;
  const long long elem = mode == 0 ? 4 : 2;
  return (PH * PW * u + (long long)u * (u_out + 1)) * elem;
}

int conv_mapmajor_max_u() { return kMaxU; }

// Returns 0 on success, else the cudaError_t of the refused launch; 1000 for
// arguments this kernel does not take.
int conv_mapmajor_launch(const void* x, const void* w, const void* bias,
                         void* out, int N, int Gi, int Hp, int Wp, int u,
                         int Go, int u_out, int Kh, int Kw, int stride, int Ho,
                         int Wo, int mode, int relu, void* stream) {
  if (u < 1 || u > kMaxU || u_out < 1 || u_out > kMaxU || stride < 1 ||
      Ho < 1 || Wo < 1 || N < 1 || Go < 1 || Gi < 1 ||
      Hp < (Ho - 1) * stride + Kh || Wp < (Wo - 1) * stride + Kw)
    return 1000;
  const size_t smem = (size_t)conv_mapmajor_smem_bytes(Kh, Kw, stride, u, u_out, mode);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return launch<float, false>(x, w, bias, out, N, Gi, Hp, Wp, u, Go, u_out,
                                  Kh, Kw, stride, Ho, Wo, relu, smem, s);
    case 1:
      return launch<__nv_bfloat16, false>(x, w, bias, out, N, Gi, Hp, Wp, u, Go,
                                          u_out, Kh, Kw, stride, Ho, Wo, relu,
                                          smem, s);
    case 2:
      return launch<__nv_bfloat16, true>(x, w, bias, out, N, Gi, Hp, Wp, u, Go,
                                         u_out, Kh, Kw, stride, Ho, Wo, relu,
                                         smem, s);
    default:
      return 1000;
  }
}

}  // extern "C"
