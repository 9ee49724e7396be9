// Fused PixHomology phase A for Hopper (sm_90a): steepest-ascent pointers,
// in-strip pointer snap, and the strictly-higher 8-neighbor bitmask.
//
// Replaces the TPU kernel src/repro/kernels/ph_phase_a/kernel.py
// (_phase_a_kernel, launched by phase_a).  Its plain PyTorch version is
// src/repro_torch/kernels/ph_phase_a/ref.py:phase_a, which this kernel
// must equal bitwise for every dtype, shape and strip height.
//
// What bounds it on an H100: memory.  The work is a 3x3 stencil with a
// handful of compares per pixel; the least traffic is one read of each
// pixel and 8 bytes written per pixel (ptr + mask), so at 4096^2 float32
// about 201 MB, ~60 us at 3.35 TB/s.
//
// Design:
//  (a) pointer_mask_kernel: one thread per pixel reads its 3x3 window
//      straight from device memory (neighbouring threads read neighbouring
//      addresses, so the halo comes from L1/L2, not extra HBM planes as the
//      TPU kernel needed for BlockSpec), and writes the global-flat hop and
//      the 8-bit mask.  Out-of-image neighbours are skipped, never compared
//      against a fill value (uint8's fill 0 is a real pixel value).
//  (b) snap_kernel: one block per strip of S rows.  The strip's pointers
//      are pointer-jumped in place (m[i] = m[m[i]]) until a block-wide
//      __syncthreads_or reports no change; escapes are frozen.  Hops ascend
//      the strict total order, so the in-strip hop graph is a forest; any
//      value a thread reads, old or new, is an ancestor on the same chain,
//      so in-place jumping converges to the unique terminal node that the
//      reference's whole-array doubling reaches, in O(log depth) rounds
//      (never one hop per round, which a column ramp makes O(n * W)).
//      The strip's pointers live in shared memory when S*W*4 bytes fit the
//      227 KB a block may use, else in the output buffer itself (each
//      thread's final write touches only its own slot).
//
// No fast-math: comparisons must match the plain version exactly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr size_t kMaxSharedBytes = 232448;   // 227 KB per block on sm_90

// Comparable views: exact and monotone for every supported dtype.
__device__ __forceinline__ int as_cmp(uint8_t v) { return v; }
__device__ __forceinline__ int as_cmp(int16_t v) { return v; }
__device__ __forceinline__ int as_cmp(int32_t v) { return v; }
__device__ __forceinline__ float as_cmp(float v) { return v; }
__device__ __forceinline__ float as_cmp(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void pointer_mask_kernel(const T* __restrict__ img,
                                    long long total, int H, int W,
                                    int* __restrict__ hop,
                                    int* __restrict__ mask) {
  // NEIGHBOR_OFFSETS order.
  const int dr[8] = {-1, -1, -1, 0, 0, 1, 1, 1};
  const int dc[8] = {-1, 0, 1, -1, 1, -1, 0, 1};
  const long long n = (long long)H * W;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const long long b = t / n;
    const int g = (int)(t - b * n);
    const int r = g / W;                 // g >= 0, so / is floor division
    const int c = g - r * W;
    const T* im = img + b * n;
    const auto x = as_cmp(im[g]);
    auto best_v = x;
    int best_i = g;
    int bits = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int rr = r + dr[j];
      const int cc = c + dc[j];
      if (rr < 0 || rr >= H || cc < 0 || cc >= W) continue;
      const int q = rr * W + cc;
      const auto v = as_cmp(im[q]);
      if (v > best_v || (v == best_v && q > best_i)) {
        best_v = v;
        best_i = q;
      }
      // Offsets 4..7 follow (0, 0) in flat order: a value tie is higher.
      if (v > x || (j >= 4 && v == x)) bits |= 1 << j;
    }
    hop[t] = best_i;
    mask[t] = bits;
  }
}

__global__ void snap_kernel(const int* __restrict__ hop, int H, int W, int S,
                            int use_shared, int* ptr) {
  extern __shared__ int smem[];
  const long long n = (long long)H * W;
  const int r0 = blockIdx.x * S;
  const int rows = min(S, H - r0);
  const int base = r0 * W;               // flat index of the strip's start
  const int len = rows * W;
  const int* hp = hop + blockIdx.y * n;
  int* out = ptr + blockIdx.y * n;
  int* m = use_shared ? smem : out + base;   // strip-local pointers

  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const int l = hp[base + i] - base;
    m[i] = (l < 0 || l >= len) ? i : l;      // freeze escapes
  }
  __syncthreads();
  for (;;) {
    int changed = 0;
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      const int v = m[i];
      const int u = m[v];
      if (u != v) {
        m[i] = u;
        changed = 1;
      }
    }
    if (!__syncthreads_or(changed)) break;
  }
  // Half-hop: an escape's hop leaves the strip; a root's hop is itself.
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const int mi = m[i];
    const int hm = hp[base + mi];
    const int l = hm - base;
    out[base + i] = (l < 0 || l >= len) ? hm : base + mi;
  }
}

}  // namespace

// dtype: 0 uint8, 1 int16, 2 int32, 3 float32, 4 bfloat16.
// image (batch, H, W) contiguous; hop, ptr, mask (batch, H*W) int32.
// S must already be clamped to [1, H].
extern "C" int phase_a_launch(int dtype, const void* image, int batch, int H,
                              int W, int S, void* hop, void* ptr, void* mask,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = (long long)batch * H * W;
  if (total == 0) return 0;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 132LL * 64 ? want : 132LL * 64);
  int* hp = static_cast<int*>(hop);
  int* mk = static_cast<int*>(mask);
  switch (dtype) {
    case 0:
      pointer_mask_kernel<uint8_t><<<blocks, threads, 0, st>>>(
          static_cast<const uint8_t*>(image), total, H, W, hp, mk);
      break;
    case 1:
      pointer_mask_kernel<int16_t><<<blocks, threads, 0, st>>>(
          static_cast<const int16_t*>(image), total, H, W, hp, mk);
      break;
    case 2:
      pointer_mask_kernel<int32_t><<<blocks, threads, 0, st>>>(
          static_cast<const int32_t*>(image), total, H, W, hp, mk);
      break;
    case 3:
      pointer_mask_kernel<float><<<blocks, threads, 0, st>>>(
          static_cast<const float*>(image), total, H, W, hp, mk);
      break;
    case 4:
      pointer_mask_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(image), total, H, W, hp, mk);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t bytes = (size_t)S * W * sizeof(int);
  const int use_shared = bytes <= kMaxSharedBytes;
  const size_t smem = use_shared ? bytes : 0;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(snap_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((H + S - 1) / S, batch);
  snap_kernel<<<grid, 1024, smem, st>>>(hp, H, W, S, use_shared,
                                         static_cast<int*>(ptr));
  return (int)cudaGetLastError();
}

extern "C" const char* phase_a_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
