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
// What bounds it on an H100: memory.  The least traffic is one read of the
// keys, the endpoints of the live edges and one write of the tables.  At
// the main path's first Boruvka round E = 8,388,608 int64 keys (67 MB) of
// which 2 % are live, so the key read is nearly all of it.
//
// Design: the TPU kernel walks the edge blocks in order on one core and
// keeps the accumulator in VMEM.  Here the edge blocks run in parallel and
// accumulate with atomics, and the keys are read once, as 16-byte vectors
// (kUnroll of them a thread per step, the next step's loads issued before
// this step's live lanes are handled; a scalar head up to the first
// 16-byte boundary and a scalar tail go to block 0).  Three
// stream-ordered launches, one template for int32 (rank) and int64
// (packed) keys:
//   init:   best = pad, win = -1, count = 0;
//   pass 1: every live lane atomicMax-es its key into best[ra] and best[rb]
//           and appends its edge index to a compact live list (a scan of
//           the lanes' live counts over the block, one atomicAdd per block
//           step on count);
//   pass 2: a grid-stride walk of the list only, bounded by count read on
//           the device (no host readback): atomicMax of the edge index into
//           win where the key equals the finished best.
// The list's order changes from run to run, and so does the order in
// which the atomics land; the results do not, because both passes are
// integer maxima (associative and commutative), so they are bitwise
// deterministic.  64-bit atomicMax exists on sm_35 and later.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;               // 16-byte vectors a thread per step
constexpr int kMaxBlocks = 132 * 16;

template <typename K>
struct Vec16;
template <>
struct Vec16<int> {
  using type = int4;
  static constexpr int n = 4;
  __device__ static void unpack(const int4& v, int* k) {
    k[0] = v.x; k[1] = v.y; k[2] = v.z; k[3] = v.w;
  }
};
template <>
struct Vec16<long long> {
  using type = longlong2;
  static constexpr int n = 2;
  __device__ static void unpack(const longlong2& v, long long* k) {
    k[0] = v.x; k[1] = v.y;
  }
};

// The 16-byte-aligned body of the key array: keys [head, head + VEC*n_vec).
struct Span {
  long long E, head, n_vec;
};

template <typename K>
Span span_of(const void* key, long long E) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(key);
  long long head = (long long)(((16 - (addr & 15)) & 15) / sizeof(K));
  if (head > E) head = E;
  return {E, head, (E - head) / Vec16<K>::n};
}

// Edge index of head/tail slot s (s < head + tail), or -1.
__device__ __forceinline__ long long edge_tail(const Span& sp, int vec,
                                               int s) {
  if (s < sp.head) return s;
  const long long e = sp.head + sp.n_vec * vec + (s - sp.head);
  return e < sp.E ? e : -1;
}

// One step's keys of this thread: kUnroll 16-byte vectors of the body
// from vector `base` on (pad past the end).
template <typename K>
__device__ __forceinline__ void load_step(const K* __restrict__ key,
                                          const Span& sp, long long base,
                                          K (&k)[kUnroll][Vec16<K>::n],
                                          K pad) {
  using V = Vec16<K>;
  const typename V::type* body =
      reinterpret_cast<const typename V::type*>(key + sp.head);
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long v = base + u * kThreads + threadIdx.x;
    if (v < sp.n_vec) {
      V::unpack(body[v], k[u]);
    } else {
#pragma unroll
      for (int j = 0; j < V::n; ++j) k[u][j] = pad;
    }
  }
}

// This thread's first slot of `live` consecutive list entries: a scan over
// the block and one atomicAdd on count per block (every thread of the
// block calls it together).  s_warp holds kWarps + 1 ints.
__device__ __forceinline__ int block_reserve(int live, int* count,
                                             int* s_warp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = live;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_warp[w];
      s_warp[w] = total;
      total += c;
    }
    s_warp[kWarps] = total > 0 ? atomicAdd(count, total) : 0;
  }
  __syncthreads();
  const int slot = s_warp[kWarps] + s_warp[warp] + incl - live;
  __syncthreads();                         // s_warp is reused
  return slot;
}

template <typename K>
__global__ void init_kernel(K* __restrict__ best, int* __restrict__ win,
                            int nv, K pad, int* __restrict__ count) {
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v == 0) *count = 0;
  for (int t = v; t < nv; t += gridDim.x * blockDim.x) {
    best[t] = pad;
    win[t] = -1;
  }
}

// Pass 1: best by atomicMax, live edges appended to list.  Each step of a
// block reads kUnroll vectors a thread (all loads issued before any is
// used).
template <typename K>
__global__ void __launch_bounds__(kThreads)
best_list_kernel(const K* __restrict__ key, const int* __restrict__ ra,
                 const int* __restrict__ rb, Span sp, K* best, K pad,
                 int* __restrict__ list, int* count) {
  using V = Vec16<K>;
  constexpr int VEC = V::n;
  __shared__ int s_warp[kWarps + 1];
  if (blockIdx.x == 0) {                   // head and tail, scalar
    const int s = threadIdx.x;
    const long long e = s < 2 * (VEC - 1) ? edge_tail(sp, VEC, s) : -1;
    const K k = e >= 0 ? key[e] : pad;
    const int live = k > pad;
    if (live) {
      atomicMax(best + ra[e], k);
      atomicMax(best + rb[e], k);
    }
    const int slot = block_reserve(live, count, s_warp);
    if (live) list[slot] = (int)e;
  }
  // The next step's keys load while this step's live lanes are handled.
  const long long step = (long long)kThreads * kUnroll;
  const long long stride = gridDim.x * step;
  K next[kUnroll][VEC];
  load_step(key, sp, blockIdx.x * step, next, pad);
  for (long long base = blockIdx.x * step; base < sp.n_vec; base += stride) {
    K k[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int j = 0; j < VEC; ++j) k[u][j] = next[u][j];
    load_step(key, sp, base + stride, next, pad);
    const long long v0 = base + threadIdx.x;
    int live = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long e0 = sp.head + (v0 + u * kThreads) * VEC;
      for (int j = 0; j < VEC; ++j) {
        if (k[u][j] > pad) {
          atomicMax(best + ra[e0 + j], k[u][j]);
          atomicMax(best + rb[e0 + j], k[u][j]);
          ++live;
        }
      }
    }
    int slot = block_reserve(live, count, s_warp);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long e0 = sp.head + (v0 + u * kThreads) * VEC;
      for (int j = 0; j < VEC; ++j)
        if (k[u][j] > pad) list[slot++] = (int)(e0 + j);
    }
  }
}

// Pass 2: win over the live list only.
template <typename K>
__global__ void __launch_bounds__(kThreads)
win_list_kernel(const K* __restrict__ key, const int* __restrict__ ra,
                const int* __restrict__ rb, const int* __restrict__ list,
                const int* __restrict__ count, const K* __restrict__ best,
                int* win) {
  const int n = *count;
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += gridDim.x * blockDim.x) {
    const int e = list[t];
    const K k = key[e];
    const int a = ra[e];
    const int b = rb[e];
    if (k == best[a]) atomicMax(win + a, e);
    if (k == best[b]) atomicMax(win + b, e);
  }
}

int blocks_for(long long work) {
  const long long want = (work + kThreads - 1) / kThreads;
  return (int)(want < 1 ? 1 : (want < kMaxBlocks ? want : kMaxBlocks));
}

template <typename K>
int launch(const void* key, const int* a, const int* b, long long E,
           void* best, int* w, int nv, K pad, int* list, int* cnt,
           cudaStream_t st) {
  K* bst = static_cast<K*>(best);
  const K* k = static_cast<const K*>(key);
  const Span sp = span_of<K>(key, E);
  init_kernel<K><<<blocks_for(nv), kThreads, 0, st>>>(bst, w, nv, pad, cnt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || E == 0) return (int)err;
  best_list_kernel<K><<<blocks_for(sp.n_vec / kUnroll), kThreads, 0, st>>>(
      k, a, b, sp, bst, pad, list, cnt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  win_list_kernel<K><<<blocks_for(E), kThreads, 0, st>>>(k, a, b, list, cnt,
                                                         bst, w);
  return (int)cudaGetLastError();
}

}  // namespace

// key_bits: 32 (int32 rank keys) or 64 (int64 packed keys).
// key, ra, rb: (E,) contiguous (key's base need not be 16-byte aligned);
// best: (nv,) key dtype; win: (nv,) int32; list: (E,) int32 scratch for
// the live list; count: one int32.  Every ra/rb lane must lie in [0, nv).
extern "C" int best_edge_launch(int key_bits, const void* key, const void* ra,
                                const void* rb, long long E, void* best,
                                void* win, int nv, void* list, void* count,
                                void* stream) {
  if (nv <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* a = static_cast<const int*>(ra);
  const int* b = static_cast<const int*>(rb);
  int* w = static_cast<int*>(win);
  int* l = static_cast<int*>(list);
  int* c = static_cast<int*>(count);
  if (key_bits == 32)
    return launch<int>(key, a, b, E, best, w, nv, INT_MIN, l, c, st);
  if (key_bits == 64)
    return launch<long long>(key, a, b, E, best, w, nv, LLONG_MIN, l, c, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* best_edge_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
