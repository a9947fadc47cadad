// Channel LayerNorm on NCHW bf16 for Hopper (sm_90a), plain C interface.
//
// Replaces no TPU kernel: the JAX package has no LayerNorm over the
// channels of an NCHW activation.  ConvNeXt normalizes over C at every
// pixel (23 times in ConvNeXt-T); the library's LayerNorm normalizes the
// last dimension, so on the port's NCHW layout each one would need a
// transpose copy before it and another after.  This kernel reads NCHW as it
// lies: y[n, c, p] = (x[n, c, p] - mean) * rstd * w[c] + b[c], with mean and
// the biased variance over c of x[n, :, p] taken in f32 from the bf16
// operand, rstd = rsqrt(var + eps), the affine in f32 and one rounding to
// bf16.  An (N, C) vector (after a global pool) is the case P = 1.
//
// Bound.  A few operations an element against 4 bytes moved (2 read, 2
// written): far below the ridge point, so bytes at HBM's rate bound it.
//
// Design.  A block of 256 threads owns TP consecutive pixels of one image
// (TP = 32, 16 or 8, picked by the wrapper so that small planes still give
// enough blocks) and all C channels: thread (tx, ty) takes pixel tx and the
// channels ty, ty + G, ... (G = 256 / TP).  Neighbouring threads read
// neighbouring pixels of one channel row, so each load is a run of TP bf16.
// The block stages its C x TP tile in shared memory on the first read (at
// most 768 x 32 x 2 = 48 KB), so the exact two-pass statistics (the mean,
// then the mean squared deviation) and the output read device memory once:
// each pass sums a thread's channels, then the G partial sums of a pixel in
// shared memory.  The weight and bias (f32, C each) are read through L1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int TP>
__global__ void __launch_bounds__(kThreads)
layernorm_nchw_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, __nv_bfloat16* __restrict__ y,
                      int C, int P, float eps) {
  constexpr int G = kThreads / TP;
  extern __shared__ __align__(16) unsigned char smem[];
  float* part = reinterpret_cast<float*>(smem);            // [G][TP]
  float* stat = part + G * TP;                             // [2][TP]: mean, rstd
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(stat + 2 * TP);  // [C][TP]

  const int tiles = (P + TP - 1) / TP;
  const int n = blockIdx.x / tiles;
  const int p0 = (blockIdx.x - n * tiles) * TP;
  const int tx = threadIdx.x % TP;
  const int ty = threadIdx.x / TP;
  const int p = p0 + tx;
  const bool valid = p < P;
  const size_t base = (size_t)n * C * P + p;

  float s = 0.f;
  for (int c = ty; c < C; c += G) {
    const __nv_bfloat16 v = valid ? x[base + (size_t)c * P] : __float2bfloat16(0.f);
    tile[c * TP + tx] = v;
    s += __bfloat162float(v);
  }
  part[ty * TP + tx] = s;
  __syncthreads();
  if (ty == 0) {
    float t = 0.f;
    for (int g = 0; g < G; ++g) t += part[g * TP + tx];
    stat[tx] = t / (float)C;
  }
  __syncthreads();
  const float mean = stat[tx];
  float q = 0.f;
  for (int c = ty; c < C; c += G) {
    const float d = __bfloat162float(tile[c * TP + tx]) - mean;
    q += d * d;
  }
  part[ty * TP + tx] = q;
  __syncthreads();
  if (ty == 0) {
    float t = 0.f;
    for (int g = 0; g < G; ++g) t += part[g * TP + tx];
    stat[TP + tx] = rsqrtf(t / (float)C + eps);
  }
  __syncthreads();
  if (!valid) return;
  const float rstd = stat[TP + tx];
  for (int c = ty; c < C; c += G) {
    const float v = (__bfloat162float(tile[c * TP + tx]) - mean) * rstd;
    y[base + (size_t)c * P] = __float2bfloat16(v * __ldg(w + c) + __ldg(b + c));
  }
}

template <int TP>
int launch(const void* x, const void* w, const void* b, void* y, int N, int C, int P,
           float eps, cudaStream_t stream) {
  constexpr int G = kThreads / TP;
  const size_t smem = (size_t)(G + 2) * TP * sizeof(float) + (size_t)C * TP * 2;
  if (smem > 232448) return 1000;         // the most shared memory a block has
  auto kernel = layernorm_nchw_kernel<TP>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (long long)N * ((P + TP - 1) / TP);
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<__nv_bfloat16*>(y), C, P, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Threads of a block (the wrapper's tile rule reads it).
int layernorm_nchw_threads() { return kThreads; }

// x, y: (N, C, P) bf16, contiguous; w, b: (C,) f32.  tile: pixels a block,
// 32, 16 or 8.  One launch on `stream`.  Returns 0 on success, else the
// cudaError_t of the refused launch; 1000 for arguments the kernel does not
// take.
int layernorm_nchw_launch(const void* x, const void* w, const void* b, void* y, int N,
                          int C, int P, float eps, int tile, void* stream) {
  if (N < 1 || C < 1 || P < 1) return 1000;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 32: return launch<32>(x, w, b, y, N, C, P, eps, s);
    case 16: return launch<16>(x, w, b, y, N, C, P, eps, s);
    case 8: return launch<8>(x, w, b, y, N, C, P, eps, s);
    default: return 1000;
  }
}

}  // extern "C"
