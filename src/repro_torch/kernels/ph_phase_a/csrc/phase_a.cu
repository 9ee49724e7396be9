// Fused PixHomology phase A for Hopper (sm_90a): steepest-ascent pointers,
// in-strip pointer snap, and the strictly-higher 8-neighbor bitmask, in one
// launch that writes ptr and mask and nothing else.
//
// Replaces the TPU kernel src/repro/kernels/ph_phase_a/kernel.py
// (_phase_a_kernel, launched by phase_a).  Its plain PyTorch version is
// src/repro_torch/kernels/ph_phase_a/ref.py:phase_a, which this kernel
// must equal bitwise for every dtype, shape, strip height and batch.
//
// What bounds it on an H100: memory, in principle.  The least traffic is
// one read of each pixel and 8 bytes written per pixel (ptr + mask), so at
// 4096^2 float32 n * 12 B = 201 MB, 60 us at 3.35 TB/s.  In practice the
// instructions a pixel costs hold it at about half of that: the 3x3
// argmax and mask are some 75 SASS instructions a float32 pixel, and the
// snap is chains of dependent shared-memory loads.  So the design keeps
// every intermediate on the chip and spends as few instructions a pixel
// as it can.
//
// Design: one block (or one cluster of blocks) per strip of S rows, batch
// on blockIdx.y.
//  (a) Stencil.  A lane takes a group of N = 16 / sizeof(T) adjacent
//      columns and walks down the strip's rows keeping rows r-1, r, r+1 in
//      registers, each read once as a 16-byte vector (scalar loads where a
//      row is not 16-byte aligned or at a ragged right edge), the next row
//      in flight while the current one is compared.  Columns c0-1 and
//      c0+N come from the neighbouring lanes by shuffle; the warp's end
//      lanes load them with the row.  Row and column come from the block
//      and the loops: no division per pixel.  Groups away from the image's
//      border take a path with no position checks; at the border,
//      out-of-image neighbours are skipped by position, never compared
//      against a fill (uint8's 0 is a real value).  Comparisons run in the
//      dtype's exact comparable view (int, or float for float32 and
//      bfloat16): the 3x3 cells in flat-index order, self between offsets
//      3 and 4, each winning on `>=` over the best so far (from a value at
//      or below every pixel), which is the plain version's (value, flat
//      index) order; a NaN never wins and a NaN pixel keeps itself, as the
//      plain version's `>` and `==` from self give.  Offsets 4-7 count a
//      value tie as higher in the mask, which is stored from registers as
//      16-byte vectors.
//  (b) Escapes without a hop array.  A pixel leaves its strip only from
//      the strip's first or last row, to a neighbour fixed by its step
//      code (dr + 1) * 3 + (dc + 1); the flat offset of a code is
//      arithmetic.  Each pixel's strip-local step goes to shared memory
//      (16-bit entries four or eight at a time); an escaping pixel is
//      frozen as its own root.
//  (c) Pointer jumping in place (m[i] = m[m[i]]) until a block-wide (or
//      cluster-wide) vote reports no change.  Hops ascend the strict total
//      order, so the in-strip hop graph is a forest; any value a thread
//      reads, old or new, is an ancestor on the same chain, so in-place
//      jumping converges to the unique terminal node that the reference's
//      whole-array doubling reaches, in O(log depth) rounds (never one hop
//      per round, which a column ramp makes O(n * W)).  m[v] == v only for
//      a terminal v, so an entry that reads that is done for good.  A
//      thread keeps four jumps' loads in flight.
//  (d) Half-hop: a terminal node is a root or a frozen escape; the
//      escape's target is decoded without touching device memory, and ptr
//      leaves as 16-byte stores.
//
// Width regimes (phase_a_launch picks; kernel.strip_layout mirrors it):
//  * S * W <= 65,536 (S = 8 up to W = 8192): strip16_kernel.  Strip-local
//    pointers are 16-bit, plus a table of min(S, 2) * W step codes of the
//    boundary rows: 2 * S * W + 2 * W bytes, 72 KB at 4096^2 / S = 8; two
//    512-thread blocks share an SM (registers, not shared memory, set the
//    two).  The half-hop reads the table: a terminal node in a boundary
//    row with a step code other than (0, 0) escapes to its neighbour in
//    the adjacent strip.  Each thread keeps a bitmask of its still-moving
//    entries (128 at most), so after a first round over every entry a
//    round visits only the chains that have not ended.
//  * Wider strips take 32-bit pointers, which never fit one block when
//    16-bit ones do not (65,537 * 4 B > 227 KB): strip32_kernel.  The
//    strip is spread by rows over a thread-block cluster of C <= 8 blocks
//    (the fewest whose ceil(S / C) rows of 4-byte entries fit a block),
//    each holding its rows' pointers in shared memory; a lookup of another
//    block's entry reads its distributed shared memory, and the vote runs
//    over the cluster.  An escape is stored as ~target (its global flat
//    index, negative), so no table is needed: jumping stops at a negative
//    entry and the half-hop is ~t.  10240 at S = 8 takes C = 2 (160 KB a
//    block, one 1024-thread block an SM), 16384 at S = 8 C = 3.  Past
//    ceil(S / 8) * W * 4 B > 227 KB (W > 57,856 at S = 8) the same kernel
//    runs one block per strip with the pointers in the output buffer
//    itself (each thread's final write touches only its own slot).
//
// Registers and shared memory per block: strip16_kernel 512 threads,
// __launch_bounds__(512, 2) (at most 64 registers; float32 and int32 spill
// nothing, the 8- and 16-wide vectors of the narrower types spill a
// little), dynamic shared memory 2 * S * W + min(S, 2) * W bytes;
// strip32_kernel 1024 threads (64 registers), 64 B of static shared memory
// (the cluster's vote) plus ceil(S / C) * W * 4 bytes dynamic in a
// cluster.  ptxas's report is in chip_smoke.py's build line.
//
// Tried and dropped, each timed on the card (probes not committed): the
// first port's two launches (a per-pixel pointer + mask kernel writing a
// global hop array and a snap kernel reading it back twice: 20 B a pixel
// instead of 12, a 64-bit division per pixel); warps that load rows r-1,
// r, r+1 for each row they take (three reads a row through L1); two to
// five rows in flight instead of one; 128-, 256-, 384- and 1024-thread
// blocks; two or eight jumps in flight; two jumps a round; writing each
// pointer as its entry settles (scattered 4-byte stores); a shared table
// of step offsets; for wider strips, clusters of blocks that fit two an SM
// and a bitmask of moving entries with its jump loop unrolled (both
// slower).
//
// No fast-math: comparisons must match the plain version exactly.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSmemBytes = 232448;      // 227 KB per block on sm_90
constexpr int kNarrowEntries = 65536;   // strips with 16-bit pointers
constexpr int kMaxCluster = 8;          // portable cluster size
constexpr int kNarrowThreads = 512;
constexpr int kNarrowBlocks = 2;        // per SM: 64 registers a thread
constexpr int kWideThreads = 1024;
constexpr int kIlp = 4;                 // jumps a thread keeps in flight
constexpr int kSelf = 4;                // step code of (0, 0)
// Shared memory kept for strip32_kernel's static array (the cluster's vote,
// 64 bytes); its launch checks the compiled size.
constexpr int kStaticBytes = 1024;
constexpr int kWords = kNarrowEntries / kNarrowThreads / 32;

// The comparable view of an element's raw bits: exact and monotone;
// lowest() is at or below every value of the view (no candidate yet).
template <typename T> struct View;
struct IntView {
  using C = int;
  static __device__ __forceinline__ C lowest() { return -2147483647 - 1; }
};
struct FloatView {
  using C = float;
  static __device__ __forceinline__ C lowest() {
    return __uint_as_float(0xff800000u);        // -inf
  }
};
template <> struct View<uint8_t> : IntView {
  static __device__ __forceinline__ C of(uint32_t b) { return (int)b; }
};
template <> struct View<int16_t> : IntView {
  static __device__ __forceinline__ C of(uint32_t b) {
    return (int)(int16_t)(uint16_t)b;
  }
};
template <> struct View<int32_t> : IntView {
  static __device__ __forceinline__ C of(uint32_t b) { return (int)b; }
};
template <> struct View<float> : FloatView {
  static __device__ __forceinline__ C of(uint32_t b) {
    return __uint_as_float(b);
  }
};
template <> struct View<__nv_bfloat16> : FloatView {
  static __device__ __forceinline__ C of(uint32_t b) {
    return __uint_as_float(b << 16);             // exact widening
  }
};

template <int S> struct BitsOf;
template <> struct BitsOf<1> { using U = uint8_t; };
template <> struct BitsOf<2> { using U = uint16_t; };
template <> struct BitsOf<4> { using U = uint32_t; };

// Element j of a 16-byte row vector, as raw bits (j is a constant after
// unrolling, so this folds to a register extract).
template <typename T>
__device__ __forceinline__ uint32_t elem(const uint4& v, int j) {
  constexpr int s = sizeof(T);
  const int byte = j * s;
  const int w = byte >> 2;
  const uint32_t word = w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w;
  if constexpr (s == 4) {
    return word;
  } else {
    return (word >> ((byte & 3) * 8)) & ((1u << (8 * s)) - 1);
  }
}

// One row of a lane's column group: its N elements and the elements just
// left and right of the group.
struct Row {
  uint4 v;
  uint32_t left, right;
};

// Issue the loads of row r for the group at c0: its N elements, and for a
// warp's end lanes the element beyond the warp (zeros outside the image or
// past the last group; those positions are never compared).
template <typename T>
__device__ __forceinline__ Row fetch(const T* im, int r, int H, int W,
                                     int c0, bool live) {
  constexpr int N = 16 / sizeof(T);
  using U = typename BitsOf<sizeof(T)>::U;
  const int lane = threadIdx.x & 31;
  Row out = {make_uint4(0, 0, 0, 0), 0, 0};
  if (!live || r < 0 || r >= H) return out;
  const U* p = reinterpret_cast<const U*>(im) + (long long)r * W + c0;
  if (lane == 0 && c0 > 0) out.left = __ldg(p - 1);
  if (lane == 31 && c0 + N < W) out.right = __ldg(p + N);
  if (c0 + N <= W && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    out.v = __ldg(reinterpret_cast<const uint4*>(p));
    return out;
  }
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (c0 + j < W)
      w[j * sizeof(T) / 4] |= (uint32_t)__ldg(p + j)
                              << ((j * sizeof(T) % 4) * 8);
  out.v = make_uint4(w[0], w[1], w[2], w[3]);
  return out;
}

// Complete a fetched row: the elements left and right of the group come
// from the neighbouring lanes (all lanes take part), or for the warp's end
// lanes from their own loads.
template <typename T>
__device__ __forceinline__ Row finish(Row row) {
  constexpr int N = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const uint32_t left = __shfl_up_sync(0xffffffffu, elem<T>(row.v, N - 1), 1);
  const uint32_t right = __shfl_down_sync(0xffffffffu, elem<T>(row.v, 0), 1);
  if (lane != 0) row.left = left;
  if (lane != 31) row.right = right;
  return row;
}

template <typename T>
__device__ __forceinline__ typename View<T>::C at(const Row& row, int k) {
  constexpr int N = 16 / sizeof(T);
  return View<T>::of(k < 0 ? row.left : k >= N ? row.right
                                               : elem<T>(row.v, k));
}

// One row of a lane's column group: the N pixels' step codes (handed to
// emit) and mask bits (stored).  kEdge: the group touches the image's
// border, so each neighbour's position is checked; inside, every
// neighbour exists.
template <typename T, bool kEdge, typename Emit>
__device__ __forceinline__ void row_pass(const Row& up, const Row& cur,
                                         const Row& dn, int r, int H, int W,
                                         int c0, int lr, int* p, Emit& emit) {
  constexpr int N = 16 / sizeof(T);
  using C = typename View<T>::C;
  const bool has_up = r > 0, has_dn = r + 1 < H;
  int bits[N], code[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int c = c0 + j;
    const bool has_l = c > 0, has_r = c + 1 < W;
    const C x = at<T>(cur, j);
    C bv = View<T>::lowest();
    int bc = -1;
    int bt = 0;
    // The 3x3 cells in flat-index order (self between offsets 3 and 4), so
    // `>=` breaks value ties by flat index.  A NaN never wins and a NaN
    // pixel keeps itself, as the plain version's `>` and `==` from self.
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (k == 4 && (x >= bv || x != x)) {
        bv = x;
        bc = kSelf;
      }
      const int dr = k < 3 ? -1 : k < 5 ? 0 : 1;
      const int dc = k < 3 ? k - 1 : k == 3 ? -1 : k == 4 ? 1 : k - 6;
      if (kEdge && !((dr < 0 ? has_up : dr > 0 ? has_dn : true) &&
                     (dc < 0 ? has_l : dc > 0 ? has_r : true)))
        continue;
      const C v = at<T>(dr < 0 ? up : dr > 0 ? dn : cur, j + dc);
      if (v >= bv) {
        bv = v;
        bc = (dr + 1) * 3 + (dc + 1);
      }
      if (k >= 4 ? v >= x : v > x) bt |= 1 << k;   // flat-index ties
    }
    bits[j] = bt;
    code[j] = bc;
  }
  emit(lr, c0, code, kEdge ? min(N, W - c0) : N);
#pragma unroll
  for (int q = 0; q < N; q += 4) {
    if (c0 + q + 4 <= W && (reinterpret_cast<uintptr_t>(p + q) & 15) == 0) {
      *reinterpret_cast<int4*>(p + q) =
          make_int4(bits[q], bits[q + 1], bits[q + 2], bits[q + 3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (c0 + q + e < W) p[q + e] = bits[q + e];
    }
  }
}

// Rows [lo, hi) of the strip at image row r0: writes the mask rows and
// calls emit(lr, c0, code, count) for each row of each column group with
// the step codes of its first `count` pixels.  A lane walks
// down the strip with rows r-1, r, r+1 of its column group in registers
// and the next row's load in flight.
template <typename T, typename Emit>
__device__ __forceinline__ void stencil(const T* im, int H, int W, int r0,
                                        int lo, int hi, int* mk, Emit emit) {
  constexpr int N = 16 / sizeof(T);
  const int groups = (W + N - 1) / N;
  const int lane = threadIdx.x & 31;
  for (int g0 = (threadIdx.x >> 5) * 32; g0 < groups;
       g0 += (blockDim.x >> 5) * 32) {
    const int c0 = (g0 + lane) * N;
    const bool live = g0 + lane < groups;
    const bool inner_cols = c0 > 0 && c0 + N < W;
    // Rows r0 + lo - 1 .. r0 + hi are read, each once.
    const Row first = fetch<T>(im, r0 + lo - 1, H, W, c0, live);
    const Row second = fetch<T>(im, r0 + lo, H, W, c0, live);
    Row next = fetch<T>(im, r0 + lo + 1, H, W, c0, live && lo < hi);
    Row up = finish<T>(first);
    Row cur = finish<T>(second);
    for (int lr = lo; lr < hi; ++lr) {
      const int r = r0 + lr;
      const Row dn = finish<T>(next);
      next = fetch<T>(im, r + 2, H, W, c0, live && lr + 2 <= hi);
      int* p = mk + (long long)lr * W + c0;
      if (inner_cols && r > 0 && r + 1 < H)
        row_pass<T, false>(up, cur, dn, r, H, W, c0, lr, p, emit);
      else if (live)
        row_pass<T, true>(up, cur, dn, r, H, W, c0, lr, p, emit);
      up = cur;
      cur = dn;
    }
  }
}

// The flat offset of a step code in rows of W columns: (code * 11) >> 5
// is code / 3 for codes 0..8.
__device__ __forceinline__ int step_of(int code, int W) {
  const int dr1 = (code * 11) >> 5;
  return (dr1 - 1) * W + (code - 3 * dr1) - 1;
}

// Whether a step from strip row lr leaves a strip of `rows` rows.
__device__ __forceinline__ bool escapes(int lr, int rows, int code) {
  return (lr == 0 && code < 3) || (lr == rows - 1 && code >= 6);
}

// N consecutive 16-bit entries of one thread, as 16-byte (or for N = 4,
// 8-byte) stores where aligned.
template <int N>
__device__ __forceinline__ void store_u16(uint16_t* p, const uint16_t (&t)[N],
                                          int count) {
  if (count == N && (reinterpret_cast<uintptr_t>(p) & (2 * N - 1)) == 0) {
    uint32_t w[N / 2];
#pragma unroll
    for (int k = 0; k < N / 2; ++k)
      w[k] = t[2 * k] | (uint32_t)t[2 * k + 1] << 16;
    if constexpr (N == 4) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
#pragma unroll
      for (int q = 0; q < N / 2; q += 4)
        *reinterpret_cast<uint4*>(p + 2 * q) =
            make_uint4(w[q], w[q + 1], w[q + 2], w[q + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (j < count) p[j] = t[j];
  }
}

// Four consecutive outputs of one thread, as a 16-byte store where aligned.
__device__ __forceinline__ void store4(int* p, int count, const int (&o)[4]) {
  if (count == 4 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    *reinterpret_cast<int4*>(p) = make_int4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < count) p[e] = o[e];
  }
}

// Strips of S * W <= 65,536 pixels: one block, 16-bit pointers and the
// boundary rows' step codes in shared memory.
template <typename T>
__global__ void __launch_bounds__(kNarrowThreads, kNarrowBlocks)
    strip16_kernel(const T* __restrict__ img, int H, int W, int S,
                   int* __restrict__ ptr, int* __restrict__ mask) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* m = reinterpret_cast<uint16_t*>(smem);
  uint8_t* tab = smem + 2 * (size_t)S * W;       // row 0, then last row
  const int r0 = blockIdx.x * S;
  const int rows = min(S, H - r0);
  const int len = rows * W;
  const int last = (rows - 1) * W;               // flat start of last row
  const long long n = (long long)H * W;
  const long long off = blockIdx.y * n + (long long)r0 * W;

  stencil<T>(img + blockIdx.y * n, H, W, r0, 0, rows, mask + off,
             [&](int lr, int c0, const auto& code, int count) {
               constexpr int N = sizeof(code) / sizeof(code[0]);
               const int i0 = lr * W + c0;
               uint16_t t[N];
#pragma unroll
               for (int j = 0; j < N; ++j)
                 t[j] = (uint16_t)(i0 + j + step_of(code[j], W));
               if (lr == 0 || lr == rows - 1) {   // boundary rows
#pragma unroll
                 for (int j = 0; j < N; ++j) {
                   if (j >= count) break;
                   if (escapes(lr, rows, code[j]))
                     t[j] = (uint16_t)(i0 + j);           // frozen
                   tab[(lr == 0 ? 0 : W) + c0 + j] = (uint8_t)code[j];
                 }
               }
               store_u16(m + i0, t, count);
             });
  __syncthreads();

  // Bit k of act[w]: entry threadIdx.x + (32 w + k) * kNarrowThreads moves.
  const int tid = threadIdx.x;
  const int mine = tid < len ? (len - tid + kNarrowThreads - 1) /
                                   kNarrowThreads
                             : 0;
  uint32_t act[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w)
    act[w] = mine >= 32 * (w + 1) ? ~0u
             : mine > 32 * w      ? (1u << (mine - 32 * w)) - 1
                                  : 0u;
  for (bool first = true;; first = false) {
    int changed = 0;
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      if (first && act[w] == ~0u) {     // every entry of the word: no scan
#pragma unroll
        for (int k0 = 0; k0 < 32; k0 += kIlp) {
          int v[kIlp], u[kIlp];
#pragma unroll
          for (int e = 0; e < kIlp; ++e)
            v[e] = m[tid + (32 * w + k0 + e) * kNarrowThreads];
#pragma unroll
          for (int e = 0; e < kIlp; ++e) u[e] = m[v[e]];
#pragma unroll
          for (int e = 0; e < kIlp; ++e) {
            if (u[e] != v[e]) {
              m[tid + (32 * w + k0 + e) * kNarrowThreads] = (uint16_t)u[e];
              changed = 1;
            } else {
              act[w] &= ~(1u << (k0 + e));
            }
          }
        }
        continue;
      }
      uint32_t a = act[w];
      while (a) {                       // kIlp entries' loads in flight
        int k[kIlp], v[kIlp], u[kIlp];
#pragma unroll
        for (int e = 0; e < kIlp; ++e) {
          k[e] = a ? __ffs(a) - 1 : -1;
          a &= a - 1;
        }
#pragma unroll
        for (int e = 0; e < kIlp; ++e)
          v[e] = k[e] < 0 ? 0 : m[tid + (32 * w + k[e]) * kNarrowThreads];
#pragma unroll
        for (int e = 0; e < kIlp; ++e) u[e] = k[e] < 0 ? 0 : m[v[e]];
#pragma unroll
        for (int e = 0; e < kIlp; ++e) {
          if (k[e] < 0) continue;
          if (u[e] != v[e]) {
            m[tid + (32 * w + k[e]) * kNarrowThreads] = (uint16_t)u[e];
            changed = 1;
          } else {
            act[w] &= ~(1u << k[e]);
          }
        }
      }
    }
    if (!__syncthreads_or(changed)) break;
  }

  // Half-hop: a terminal node in a boundary row whose step is not (0, 0)
  // escapes to its neighbour; any other terminal node is a root.
  int* out = ptr + off;
  const int base = r0 * W;
  for (int q = 4 * tid; q < len; q += 4 * kNarrowThreads) {
    int o[4];
    uint2 four = make_uint2(0, 0);                 // m[q .. q + 3]
    if (q + 4 <= len) {
      four = *reinterpret_cast<const uint2*>(m + q);
    } else {
      for (int e = 0; q + e < len; ++e)
        (e < 2 ? four.x : four.y) |= (uint32_t)m[q + e] << (16 * (e & 1));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = ((e < 2 ? four.x : four.y) >> (16 * (e & 1))) & 0xffff;
      o[e] = base + t;
      if (t < W || t >= last)
        o[e] += step_of(tab[t < W ? t : W + t - last], W);
    }
    store4(out + q, min(4, len - q), o);
  }
}

// Wider strips: 32-bit pointers, rows [rank * R, (rank + 1) * R) of the
// strip in each block of a cluster of C (distributed shared memory), or,
// with C == 1 and in_global, the whole strip in the output buffer.  An
// escape is stored as ~target.
template <typename T>
__global__ void __launch_bounds__(kWideThreads)
    strip32_kernel(const T* __restrict__ img, int H, int W, int S, int C,
                   int R, int in_global, int* __restrict__ ptr,
                   int* __restrict__ mask) {
  extern __shared__ __align__(16) int part[];    // this block's entries
  __shared__ int vote[2][kMaxCluster];
  const int rank = blockIdx.x % C;
  const int r0 = (blockIdx.x / C) * S;
  const int rows = min(S, H - r0);
  const int len = rows * W;
  const int L = R * W;                           // entries a block holds
  const int lo = min(rank * L, len), hi = min(lo + L, len);
  const long long n = (long long)H * W;
  const long long off = blockIdx.y * n + (long long)r0 * W;
  int* out = ptr + off;
  int* mine = in_global ? out : part - lo;       // indexed by strip entry
  const int base = r0 * W;

  stencil<T>(img + blockIdx.y * n, H, W, r0, rank * R,
             min(rank * R + R, rows), mask + off,
             [&](int lr, int c0, const auto& code, int count) {
               constexpr int N = sizeof(code) / sizeof(code[0]);
#pragma unroll
               for (int j = 0; j < N; ++j) {
                 if (j >= count) break;
                 const int i = lr * W + c0 + j;
                 const int t = i + step_of(code[j], W);
                 mine[i] = escapes(lr, rows, code[j]) ? ~(base + t) : t;
               }
             });
  if (C > 1) cg::this_cluster().sync(); else __syncthreads();

  for (int round = 0;; ++round) {
    int changed = 0;
    for (int i0 = lo + threadIdx.x; i0 < hi; i0 += kIlp * kWideThreads) {
      int v[kIlp], u[kIlp];
#pragma unroll
      for (int e = 0; e < kIlp; ++e) {
        const int i = i0 + e * kWideThreads;
        v[e] = i < hi ? mine[i] : -1;            // < 0: an escape, final
      }
#pragma unroll
      for (int e = 0; e < kIlp; ++e) {
        if (v[e] < 0 || (v[e] >= lo && v[e] < hi)) {
          u[e] = v[e] < 0 ? v[e] : mine[v[e]];
        } else {
          int o = 0;                             // the block holding v
#pragma unroll
          for (int k = 1; k < kMaxCluster; ++k) o += k < C && v[e] >= k * L;
          u[e] = cg::this_cluster().map_shared_rank(part, o)[v[e] - o * L];
        }
      }
#pragma unroll
      for (int e = 0; e < kIlp; ++e) {
        if (u[e] != v[e]) {
          mine[i0 + e * kWideThreads] = u[e];
          changed = 1;
        }
      }
    }
    int any = __syncthreads_or(changed);
    if (C > 1) {
      // Every block posts its vote to every block; two slots alternate so
      // a post of round t never lands on a slot still being read.
      cg::cluster_group cluster = cg::this_cluster();
      if ((int)threadIdx.x < C)
        *cluster.map_shared_rank(&vote[round & 1][rank], threadIdx.x) = any;
      cluster.sync();
      any = 0;
      for (int k = 0; k < C; ++k) any |= vote[round & 1][k];
    }
    if (!any) break;
  }

  for (int q = lo + 4 * threadIdx.x; q < hi; q += 4 * kWideThreads) {
    int o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = q + e < hi ? mine[q + e] : 0;
      o[e] = t < 0 ? ~t : base + t;
    }
    store4(out + q, min(4, hi - q), o);
  }
}

// The fewest cluster blocks whose ceil(S / C) rows of 32-bit entries fit
// one block's shared memory, or 0 when no cluster holds the strip.
int cluster_blocks(int S, int W) {
  for (int c = 2; c <= kMaxCluster && c <= S; ++c) {
    const long long bytes = (long long)((S + c - 1) / c) * W * 4;
    if (bytes + kStaticBytes <= kSmemBytes)
      return c;
  }
  return 0;
}

template <typename T>
int launch(const void* image, int batch, int H, int W, int S, int* ptr,
           int* mask, cudaStream_t st) {
  const T* img = static_cast<const T*>(image);
  const int strips = (H + S - 1) / S;
  cudaError_t err;
  if ((long long)S * W <= kNarrowEntries) {
    const int smem = 2 * S * W + (S < 2 ? S : 2) * W;
    err = cudaFuncSetAttribute(strip16_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    strip16_kernel<T><<<dim3(strips, batch), kNarrowThreads, smem, st>>>(
        img, H, W, S, ptr, mask);
    return (int)cudaGetLastError();
  }
  const int C = cluster_blocks(S, W);
  const int R = C ? (S + C - 1) / C : S;
  const size_t smem = C ? (size_t)R * W * 4 : 0;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, strip32_kernel<T>);
  if (err != cudaSuccess) return (int)err;
  if (fa.sharedSizeBytes > (size_t)kStaticBytes)
    return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(strip32_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(strips * (C ? C : 1), batch);
  cfg.blockDim = dim3(kWideThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C ? C : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, strip32_kernel<T>, img, H, W, S,
                           C ? C : 1, R, C ? 0 : 1, ptr, mask);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 uint8, 1 int16, 2 int32, 3 float32, 4 bfloat16.
// image (batch, H, W) contiguous; ptr, mask (batch, H*W) int32.
// S must already be clamped to [1, H].  One kernel launch.
extern "C" int phase_a_launch(int dtype, const void* image, int batch, int H,
                              int W, int S, void* ptr, void* mask,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((long long)batch * H * W == 0) return 0;
  int* p = static_cast<int*>(ptr);
  int* mk = static_cast<int*>(mask);
  switch (dtype) {
    case 0: return launch<uint8_t>(image, batch, H, W, S, p, mk, st);
    case 1: return launch<int16_t>(image, batch, H, W, S, p, mk, st);
    case 2: return launch<int32_t>(image, batch, H, W, S, p, mk, st);
    case 3: return launch<float>(image, batch, H, W, S, p, mk, st);
    case 4: return launch<__nv_bfloat16>(image, batch, H, W, S, p, mk, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* phase_a_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
