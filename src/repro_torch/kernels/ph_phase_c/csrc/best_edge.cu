// Phase-C per-cluster best-edge reduction for Hopper (sm_90a): one Boruvka
// round's segmented max over the saddle-edge list.
//
// Replaces the TPU kernels src/repro/kernels/ph_phase_c/kernel.py
// (_best_kernel and _win_kernel, launched by best_edge_reduce).  Its plain
// PyTorch version is src/repro_torch/core/parallel_merge.py:best_edge_reduce
// (re-exported as kernels/ph_phase_c/ref.py), which this kernel must equal
// bitwise.
//
//   best[v] = max live key of edges touching v            (pad where none)
//   win[v]  = max edge index e touching v with key[e] == best[v]  (-1)
//
// What bounds it on an H100: memory.  Every key is read once per pass and
// the endpoints of each live edge once per pass; the per-cluster tables
// (nv entries) are small enough to stay in L2, so the scattered atomics hit
// L2, not HBM.
//
// Design: the TPU kernel walks the edge blocks in order on one core and
// keeps the accumulator in VMEM.  Here the edge blocks run in parallel, so
// the accumulation is done with atomics in three stream-ordered launches:
// init (best = pad, win = -1), pass 1 (atomicMax of the key into both
// endpoints' best), pass 2 (atomicMax of the edge index into win where the
// key equals the finished best).  Integer max is associative and
// commutative, so the result is bitwise deterministic whatever order the
// atomics land in.  Keys are int (rank keys) or long long (packed keys;
// 64-bit atomicMax exists on sm_35 and later).

#include <cuda_runtime.h>
#include <limits.h>

namespace {

template <typename K>
__global__ void init_kernel(K* __restrict__ best, int* __restrict__ win,
                            int nv, K pad) {
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < nv;
       v += gridDim.x * blockDim.x) {
    best[v] = pad;
    win[v] = -1;
  }
}

template <typename K>
__global__ void best_kernel(const K* __restrict__ key,
                            const int* __restrict__ ra,
                            const int* __restrict__ rb, long long E,
                            K* best, K pad) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < E;
       e += (long long)gridDim.x * blockDim.x) {
    const K k = key[e];
    if (k > pad) {
      atomicMax(best + ra[e], k);
      atomicMax(best + rb[e], k);
    }
  }
}

template <typename K>
__global__ void win_kernel(const K* __restrict__ key,
                           const int* __restrict__ ra,
                           const int* __restrict__ rb, long long E,
                           const K* __restrict__ best, int* win, K pad) {
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < E;
       e += (long long)gridDim.x * blockDim.x) {
    const K k = key[e];
    if (k > pad) {
      const int a = ra[e];
      const int b = rb[e];
      if (k == best[a]) atomicMax(win + a, (int)e);
      if (k == best[b]) atomicMax(win + b, (int)e);
    }
  }
}

template <typename K>
int launch(const void* key, const void* ra, const void* rb, long long E,
           void* best, void* win, int nv, K pad, cudaStream_t st) {
  const int threads = 256;
  const int cap = 132 * 32;
  const int vblocks = (int)((nv + threads - 1) / threads);
  init_kernel<K><<<vblocks < cap ? vblocks : cap, threads, 0, st>>>(
      static_cast<K*>(best), static_cast<int*>(win), nv, pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || E == 0) return (int)err;
  const long long want = (E + threads - 1) / threads;
  const int eblocks = (int)(want < cap ? want : cap);
  const K* k = static_cast<const K*>(key);
  const int* a = static_cast<const int*>(ra);
  const int* b = static_cast<const int*>(rb);
  best_kernel<K><<<eblocks, threads, 0, st>>>(k, a, b, E,
                                              static_cast<K*>(best), pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  win_kernel<K><<<eblocks, threads, 0, st>>>(
      k, a, b, E, static_cast<const K*>(best), static_cast<int*>(win), pad);
  return (int)cudaGetLastError();
}

}  // namespace

// key_bits: 32 (int32 rank keys) or 64 (int64 packed keys).
// key, ra, rb: (E,) contiguous; best: (nv,) key dtype; win: (nv,) int32.
// Every ra/rb lane must lie in [0, nv).
extern "C" int best_edge_launch(int key_bits, const void* key, const void* ra,
                                const void* rb, long long E, void* best,
                                void* win, int nv, void* stream) {
  if (nv <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (key_bits == 32)
    return launch<int>(key, ra, rb, E, best, win, nv, INT_MIN, st);
  if (key_bits == 64)
    return launch<long long>(key, ra, rb, E, best, win, nv, LLONG_MIN, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* best_edge_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
