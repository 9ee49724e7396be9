// 3x3 / stride-1 / pad-1 max, argmax and min pools for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/maxpool/kernel.py
// (_maxarg_kernel, launched by maxargmaxpool3x3 / maxpool3x3 / minpool3x3).
// Its plain PyTorch version is src/repro_torch/kernels/maxpool/ref.py,
// which this kernel must equal bitwise for every dtype and shape.
//
// What bounds it on an H100: memory.  Each output reads a 3x3 window and
// does at most 8 compares; the least traffic is one read of each pixel and
// one write of each output, so maxargmaxpool3x3 at 4096^2 float32 moves
// n * (4 + 4 + 4) B = 201 MB, ~60 us at 3.35 TB/s.
//
// Design: one thread per output pixel (grid-stride, batch folded into the
// flat index) reads its window straight from device memory; neighbouring
// threads read neighbouring addresses, so the halo comes from L1/L2 and
// there are no row-shifted copies (the TPU kernel needed three because a
// BlockSpec cannot overlap).  Out-of-image cells are skipped, never
// compared against a fill value: uint8's fill 0 and int32's minimum are
// real pixel values, and the reference's argmax never picks a cell outside
// the image.  The window is walked in ascending flat-index order, so a
// value tie goes to the later (larger) index.  Pooled values order -0.0
// below +0.0, as jnp.maximum / jnp.minimum do.  Templated on dtype, on
// max/min and on whether the argmax is written.
//
// No fast-math: bfloat16 compares through __bfloat162float and subnormals
// compare exactly, as in the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int as_cmp(uint8_t v) { return v; }
__device__ __forceinline__ int as_cmp(int16_t v) { return v; }
__device__ __forceinline__ int as_cmp(int32_t v) { return v; }
__device__ __forceinline__ float as_cmp(float v) { return v; }
__device__ __forceinline__ float as_cmp(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// a > b with -0.0 below +0.0 (integers: plain >).
__device__ __forceinline__ bool greater(int a, int b) { return a > b; }
__device__ __forceinline__ bool greater(float a, float b) {
  // On a tie, only -0.0 vs +0.0 differ: test the sign bits directly.
  return a > b || (a == b && __float_as_int(b) < 0 && __float_as_int(a) >= 0);
}

template <typename T, bool kMin, bool kArg>
__global__ void pool3x3_kernel(const T* __restrict__ img, long long total,
                               int H, int W, T* __restrict__ val,
                               int* __restrict__ arg) {
  const long long n = (long long)H * W;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const long long b = t / n;
    const int g = (int)(t - b * n);
    const int r = g / W;
    const int c = g - r * W;
    const T* im = img + b * n;
    T best_raw = im[g];                  // pooled value, original bits
    auto best_cmp = as_cmp(best_raw);
    auto arg_cmp = best_cmp;             // argmax value (plain > / ==)
    int arg_i = g;
    for (int dr = -1; dr <= 1; ++dr) {
      const int rr = r + dr;
      if (rr < 0 || rr >= H) continue;
      for (int dc = -1; dc <= 1; ++dc) {
        const int cc = c + dc;
        if (cc < 0 || cc >= W || (dr == 0 && dc == 0)) continue;
        const int q = rr * W + cc;
        const T raw = im[q];
        const auto v = as_cmp(raw);
        if (kMin ? greater(best_cmp, v) : greater(v, best_cmp)) {
          best_cmp = v;
          best_raw = raw;
        }
        if (kArg && (v > arg_cmp || (v == arg_cmp && q > arg_i))) {
          arg_cmp = v;
          arg_i = q;
        }
      }
    }
    val[t] = best_raw;
    if (kArg) arg[t] = arg_i;
  }
}

template <typename T>
cudaError_t launch_typed(int mode, const void* image, long long total, int H,
                         int W, void* val, void* arg, cudaStream_t st) {
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 132LL * 64 ? want : 132LL * 64);
  const T* im = static_cast<const T*>(image);
  T* out = static_cast<T*>(val);
  int* ai = static_cast<int*>(arg);
  switch (mode) {
    case 0:
      pool3x3_kernel<T, false, true><<<blocks, threads, 0, st>>>(
          im, total, H, W, out, ai);
      break;
    case 1:
      pool3x3_kernel<T, false, false><<<blocks, threads, 0, st>>>(
          im, total, H, W, out, ai);
      break;
    case 2:
      pool3x3_kernel<T, true, false><<<blocks, threads, 0, st>>>(
          im, total, H, W, out, ai);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 uint8, 1 int16, 2 int32, 3 float32, 4 bfloat16.
// mode: 0 max + argmax, 1 max, 2 min.
// image, val (batch, H, W) contiguous of the dtype; arg (batch, H, W) int32
// (unused unless mode 0).
extern "C" int maxpool_launch(int dtype, int mode, const void* image,
                              int batch, int H, int W, void* val, void* arg,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = (long long)batch * H * W;
  if (total == 0) return 0;
  switch (dtype) {
    case 0:
      return (int)launch_typed<uint8_t>(mode, image, total, H, W, val, arg,
                                        st);
    case 1:
      return (int)launch_typed<int16_t>(mode, image, total, H, W, val, arg,
                                        st);
    case 2:
      return (int)launch_typed<int32_t>(mode, image, total, H, W, val, arg,
                                        st);
    case 3:
      return (int)launch_typed<float>(mode, image, total, H, W, val, arg, st);
    case 4:
      return (int)launch_typed<__nv_bfloat16>(mode, image, total, H, W, val,
                                              arg, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* maxpool_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
