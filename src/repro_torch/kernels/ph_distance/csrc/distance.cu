// Pairwise persistence-diagram distances for Hopper (sm_90a): sliced
// Wasserstein and the bottleneck lower bound over the (B, B) pair grid.
//
// Replaces the TPU kernel src/repro/kernels/ph_distance/kernel.py
// (_dist_kernel, launched by distance_matrix).  Its plain PyTorch version
// is src/repro_torch/kernels/ph_distance/ref.py:distance_matrix: bn must
// equal it bitwise, sw within rtol 1e-5 (the sum is reassociated).
//
// Per pair (i, j) and direction k the TPU kernel sorts two augmented
// 2F-vectors, va = sort(pts_i[k] ++ diag_j[k]) and vb = sort(pts_j[k] ++
// diag_i[k]), in VMEM and sums |va - vb|.  At F = 65,536 one such vector
// is 512 KB, more than the 227 KB of shared memory a block may use, so it
// cannot be sorted whole on chip here.  Design:
//  (1) sort each diagram's rows once: the B*K rows of pts and of diag are
//      copied into scratch rows of P = next_pow2(F) floats (pad slots
//      +inf, sorted to the end and never read) and bitonic-sorted: chunks
//      of 4096 in shared memory, the strides >= 4096 of the later merge
//      stages as one global compare-exchange launch each.
//  (2) for each pair i < j and direction k one block forms va and vb by
//      merge path straight from the sorted rows (no 2F-vector is ever
//      written): each thread binary-searches where its slice of output
//      positions starts in both merges, then walks its slice, adding
//      |va[t] - vb[t]| (the float32 difference, as the plain version
//      takes it) into a double.  The block sums the thread partials in a
//      fixed tree: w1[i, j, k].
//  (3) one thread per pair sums w1 over k in order and divides by K; one
//      block per pair takes 0.5 * max |prof_i - prof_j| (a max of exact
//      differences: bitwise equal to the plain version in any order).
// Every reduction has a fixed order and there are no float atomics, so the
// result is the same on every run; pair (i, j) and (j, i) share one
// computation (exact symmetry) and the diagonal is exactly 0.
//
// What bounds it on an H100: memory.  The least traffic is one read of
// the tables, 2*B*K*F*4 + B*F*4 bytes (~52 MB at B = 6, K = 16,
// F = 65,536, ~16 us at 3.35 TB/s); the merge walk does B^2*K*2*2F
// element steps (151 M, a few us at the float32 rate).  The sort makes
// ~15 passes over the 50 MB of scratch, which sits in the 50 MB L2 only
// in part.
//
// No fast-math: comparisons and differences must match the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 4096;       // sort chunk held in shared memory
constexpr int kSortThreads = 1024;
constexpr int kMergeThreads = 256;

__device__ __forceinline__ void compare_exchange(float* s, long long i,
                                                 long long l, bool asc) {
  const float a = s[i];
  const float b = s[l];
  if (asc ? (a > b) : (a < b)) {
    s[i] = b;
    s[l] = a;
  }
}

// Scratch row r (of 2*R rows of P floats): pts rows first, then diag rows.
__global__ void fill_rows_kernel(const float* __restrict__ pts,
                                 const float* __restrict__ diag, int R, int F,
                                 int P, float* __restrict__ rows) {
  const long long total = 2LL * R * P;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const long long r = t / P;
    const int idx = (int)(t - r * P);
    const float* src = r < R ? pts + r * F : diag + (r - R) * F;
    rows[t] = idx < F ? src[idx] : INFINITY;
  }
}

// Bitonic stages k in [k_lo, k_hi] (all strides j < chunk) on one chunk
// per block, in shared memory.  The direction of a compare-exchange
// depends on the element's index within its row.
__global__ void sort_chunk_kernel(float* __restrict__ rows, int P, int chunk,
                                  int k_lo, int k_hi) {
  extern __shared__ float s[];
  const long long base = (long long)blockIdx.x * chunk;  // rows are whole
  const int in_row = (int)(base % P);
  for (int t = threadIdx.x; t < chunk; t += blockDim.x) s[t] = rows[base + t];
  __syncthreads();
  for (int k = k_lo; k <= k_hi; k <<= 1) {
    for (int j = min(k, chunk) >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < chunk / 2; p += blockDim.x) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        compare_exchange(s, i, i + j, ((in_row + i) & k) == 0);
      }
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < chunk; t += blockDim.x) rows[base + t] = s[t];
}

// One bitonic compare-exchange step of stride j (>= chunk) in stage k.
__global__ void sort_global_step_kernel(float* __restrict__ rows, int n_rows,
                                        int P, int k, int j) {
  const long long half = P / 2;
  const long long total = (long long)n_rows * half;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const long long r = t / half;
    const long long p = t - r * half;
    const long long i = ((p & ~(long long)(j - 1)) << 1) | (p & (j - 1));
    compare_exchange(rows + r * P, i, i + j, (i & k) == 0);
  }
}

// How many of the first t outputs of the stable merge of sorted x (nx)
// and y (ny) come from x (x wins ties).
__device__ __forceinline__ int merge_split(const float* __restrict__ x,
                                           int nx,
                                           const float* __restrict__ y,
                                           int ny, int t) {
  int lo = max(0, t - ny);
  int hi = min(t, nx);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (x[mid] <= y[t - 1 - mid]) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ float merge_next(const float* __restrict__ x,
                                            int& a, const float* __restrict__ y,
                                            int& b, int n) {
  if (a < n && (b >= n || x[a] <= y[b])) return x[a++];
  return y[b++];
}

// grid (B*B, K): w1[(i*B + j)*K + k] for i < j (0 on the diagonal).
__global__ void w1_kernel(const float* __restrict__ rows, int B, int K,
                          int F, int P, float* __restrict__ w1) {
  const int i = blockIdx.x / B;
  const int j = blockIdx.x - i * B;
  const int k = blockIdx.y;
  if (i > j) return;
  if (i == j) {
    if (threadIdx.x == 0) w1[(long long)blockIdx.x * K + k] = 0.0f;
    return;
  }
  const long long R = (long long)B * K;
  const float* pts_i = rows + ((long long)i * K + k) * P;
  const float* pts_j = rows + ((long long)j * K + k) * P;
  const float* diag_i = rows + (R + (long long)i * K + k) * P;
  const float* diag_j = rows + (R + (long long)j * K + k) * P;

  const int L = 2 * F;
  const int per = (L + blockDim.x - 1) / blockDim.x;
  const int t0 = min(L, (int)threadIdx.x * per);
  const int t1 = min(L, t0 + per);
  double acc = 0.0;
  if (t0 < t1) {
    int a = merge_split(pts_i, F, diag_j, F, t0);
    int b = t0 - a;
    int c = merge_split(pts_j, F, diag_i, F, t0);
    int d = t0 - c;
    for (int t = t0; t < t1; ++t) {
      const float va = merge_next(pts_i, a, diag_j, b, F);
      const float vb = merge_next(pts_j, c, diag_i, d, F);
      acc += (double)fabsf(va - vb);
    }
  }
  __shared__ double part[kMergeThreads];
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) part[threadIdx.x] += part[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) w1[(long long)blockIdx.x * K + k] = (float)part[0];
}

// One thread per pair i <= j: sw = (sum_k w1) / K, mirrored.
__global__ void sw_kernel(const float* __restrict__ w1, int B, int K,
                          float* __restrict__ sw) {
  const int pr = blockIdx.x * blockDim.x + threadIdx.x;
  if (pr >= B * B) return;
  const int i = pr / B;
  const int j = pr - i * B;
  if (i > j) return;
  float s = 0.0f;
  for (int k = 0; k < K; ++k) s += w1[(long long)pr * K + k];
  const float v = s / (float)K;
  sw[i * B + j] = v;
  sw[j * B + i] = v;
}

// One block per pair i <= j: bn = 0.5 * max |prof_i - prof_j|, mirrored.
__global__ void bn_kernel(const float* __restrict__ prof, int B, int F,
                          float* __restrict__ bn) {
  const int i = blockIdx.x / B;
  const int j = blockIdx.x - i * B;
  if (i > j) return;
  const float* pa = prof + (long long)i * F;
  const float* pb = prof + (long long)j * F;
  float m = 0.0f;                        // every |difference| is >= +0
  for (int t = threadIdx.x; t < F; t += blockDim.x)
    m = fmaxf(m, fabsf(pa[t] - pb[t]));
  __shared__ float part[kMergeThreads];
  part[threadIdx.x] = m;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s)
      part[threadIdx.x] = fmaxf(part[threadIdx.x], part[threadIdx.x + s]);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float v = 0.5f * part[0];
    bn[i * B + j] = v;
    bn[j * B + i] = v;
  }
}

int grid_for(long long work, int threads) {
  const long long want = (work + threads - 1) / threads;
  return (int)(want < 132LL * 64 ? (want > 0 ? want : 1) : 132LL * 64);
}

}  // namespace

// pts, diag: (B, K, F) float32; prof: (B, F) float32, all contiguous.
// rows: scratch of 2*B*K*P floats, P = next power of two >= F (P >= 1);
// w1: scratch of B*B*K floats; sw, bn: (B, B) float32 outputs.
extern "C" int distance_launch(const void* pts, const void* diag,
                               const void* prof, int B, int K, int F, int P,
                               void* rows, void* w1, void* sw, void* bn,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (F <= 0 || P < F || (P & (P - 1)) != 0 || K <= 0)
    return (int)cudaErrorInvalidValue;
  float* r = static_cast<float*>(rows);
  const int R = B * K;
  const int n_rows = 2 * R;
  fill_rows_kernel<<<grid_for(2LL * R * P, 256), 256, 0, st>>>(
      static_cast<const float*>(pts), static_cast<const float*>(diag), R, F,
      P, r);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int chunk = P < kChunk ? P : kChunk;
  const int n_chunks = (int)((long long)n_rows * P / chunk);
  const size_t smem = (size_t)chunk * sizeof(float);
  if (chunk >= 2) {
    sort_chunk_kernel<<<n_chunks, kSortThreads, smem, st>>>(r, P, chunk, 2,
                                                            chunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  for (int k = 2 * chunk; k <= P; k <<= 1) {
    for (int j = k >> 1; j >= chunk; j >>= 1) {
      sort_global_step_kernel<<<grid_for((long long)n_rows * (P / 2), 256),
                                256, 0, st>>>(r, n_rows, P, k, j);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    sort_chunk_kernel<<<n_chunks, kSortThreads, smem, st>>>(r, P, chunk, k,
                                                            k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  float* w = static_cast<float*>(w1);
  w1_kernel<<<dim3(B * B, K), kMergeThreads, 0, st>>>(r, B, K, F, P, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sw_kernel<<<(B * B + 127) / 128, 128, 0, st>>>(w, B, K,
                                                 static_cast<float*>(sw));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_kernel<<<B * B, kMergeThreads, 0, st>>>(static_cast<const float*>(prof),
                                             B, F, static_cast<float*>(bn));
  return (int)cudaGetLastError();
}

extern "C" const char* distance_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
