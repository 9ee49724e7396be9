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
// diag_i[k]), in VMEM and sums |va - vb|.  Here each of the 2*B*K rows of
// pts and diag is sorted once, and every pair forms va and vb by merging
// two sorted rows; no 2F-vector is ever written.  Two stages, each its own
// C entry (distance_launch runs both):
//
// (1) Sort: one thread-block cluster per row, the row in the cluster's
//     distributed shared memory.  A row of F = 65,536 floats is 256 KB,
//     more than one block's 227 KB, so it is spread over a cluster of
//     C = 1, 2 or 4 blocks (the fewest that hold it), each holding
//     n = 1024 * PER slots (PER = 1 .. 16 keys a thread; slots past F hold
//     +inf, which sorts last and is never written).  Block c takes every
//     C-th run of 32 elements, so that a row's capacity pads (at its end)
//     are shared evenly and the blocks finish together.  Each block
//     radix-sorts its slots in shared memory on the 32-bit monotone keys
//     of the floats: four stable 8-bit LSD passes (per-warp digit counts,
//     a scan over (digit, warp), a scatter in which the lanes of a digit
//     find each other by ballot or by an atomicOr of lane bits).  Then
//     log2(C) merge-path levels: block c finds the splits of its n outputs
//     (a 32-way warp search through map_shared_rank), copies both windows
//     from the other blocks' shared memory into its own, and merges them
//     locally, PER outputs a thread.  Shared memory is padded (one word in
//     33) so that runs of PER keys a thread hit distinct banks.  Each row
//     is read from HBM once and written once, sorted.  A row wider than
//     one cluster (F > 65,536) takes the second path of the same kernel:
//     the cluster sorts 65,536-slot tiles of the row (a power-of-two count
//     of them, pads +inf), and merge_runs_kernel merges runs pairwise,
//     level by level, through a ping-pong scratch (log2(tiles) passes),
//     the last landing in the scratch rows.  The monotone key puts -0.0
//     before +0.0; |va - vb| is the same either way.
//     On the card this radix sort was faster than an in-block merge sort
//     (a register network, then merge-path levels in shared memory); of
//     the ways to rank a digit inside a warp, __match_any_sync is slow on
//     rows of distinct values and an atomicOr alone on runs of pads, which
//     the ballot for the end lanes' digits takes instead (PERF.md, PR 15).
// (2) Merge + W1: only the pairs i < j.  pair_splits_kernel finds, one
//     warp each (32-way search, four dependent loads at F = 65,536), the
//     merge-path split of both merges at every tile edge.  w1_tiles_kernel
//     runs on a grid of (pairs, K, tiles of 7680 of the 2F merged
//     outputs): it copies the tile's windows of the four sorted rows
//     (7680 floats per merge in all) into shared memory by 16-byte
//     cp.async, then each thread finds its start there by binary search
//     and merges 15 outputs of both merges (an odd count: neighbouring
//     threads read distinct banks), adding |va - vb| (the float32
//     difference, as the plain version takes it) into a double.  x wins
//     ties, in the splits and in the walk.  The block sums its threads in
//     a fixed order into a double tile partial.  bn_chunks_kernel takes
//     max |prof_i - prof_j| over 32 column chunks of each pair;
//     finalize_kernel (a warp per pair) sums each direction's tile
//     partials in tile order (w1, rounded to float), the K w1 in order,
//     divides by K, takes bn as half the chunks' maximum (a max of exact
//     differences: bitwise equal to the plain version) and mirrors both.
// There are no float atomics and every sum has a fixed order, so the result
// is the same on every run; pair (i, j) and (j, i) share one computation
// (exact symmetry) and the diagonal is exactly 0.
//
// What bounds it on an H100: memory.  The least traffic is one read of the
// tables, 2*B*K*F*4 + B*F*4 bytes (~52 MB at B = 6, K = 16, F = 65,536,
// ~16 us at 3.35 TB/s); the merge walk does B^2*K*2*2F element steps
// (151 M, a few us at the float32 rate).  This design moves the rows
// through HBM twice more (the sorted scratch written, then read by the
// merge tiles, mostly from the 50 MB L2), and both stages are bound by
// shared-memory latency inside the blocks, not by HBM: the sort by the
// radix passes' dependent steps (one 1024-thread block an SM), the merge
// by the per-thread walks.
//
// No fast-math: comparisons and differences must match the plain version.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSortThreads = 1024;
constexpr int kLogSortThreads = 10;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kRadixWords = 2 * kSortWarps * 256 + 8;
constexpr int kMaxPer = 16;               // keys a thread of the sort
constexpr int kSlotsPerBlock = kSortThreads * kMaxPer;        // 16,384
constexpr int kMaxCluster = 4;
constexpr int kClusterSlots = kMaxCluster * kSlotsPerBlock;   // 65,536
constexpr int kRunTile = 8192;            // merged outputs per run-merge block
constexpr int kMergeThreads = 512;
constexpr int kRunPer = kRunTile / kMergeThreads;
constexpr int kPairPer = 15;              // odd: fewer bank conflicts
constexpr int kPairTile = kMergeThreads * kPairPer;           // 7680
constexpr int kWindow = kPairTile + 16;   // floats staged per merge
constexpr int kReduceThreads = 256;
constexpr int kBnChunks = 32;            // column chunks per pair for bn

// Order-preserving map of float bits to uint32 (-0.0 just below +0.0).
__device__ __forceinline__ uint32_t to_key(float f) {
  const uint32_t u = __float_as_uint(f);
  return u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
}

__device__ __forceinline__ float from_key(uint32_t k) {
  return __uint_as_float(k ^ ((k >> 31) ? 0x80000000u : 0xffffffffu));
}

// Shared-memory slot of element i in the sort kernel's buffers: one word of
// padding after every 32, so that threads reading or writing runs of 8 or 16
// consecutive elements hit distinct banks.
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// How many of the first t outputs of the merge of sorted x (nx) and y (ny)
// come from x; x wins ties.  Scalar binary search over accessors (x(i) is
// element i).
template <typename X, typename Y>
__device__ __forceinline__ int merge_split(const X& x, int nx, const Y& y,
                                           int ny, int t) {
  int lo = max(0, t - ny);
  int hi = min(t, nx);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (x(mid) <= y(t - 1 - mid)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The same split found by one whole warp: 32 probes a step, so each step
// cuts the range 32-fold.  x and y are accessors (x(i) is element i).
// Every lane returns the answer.
template <typename X, typename Y>
__device__ int merge_split_warp(const X& x, int nx, const Y& y, int ny,
                                int t) {
  const int lane = threadIdx.x & 31;
  int lo = max(0, t - ny);
  int hi = min(t, nx);
  while (lo < hi) {
    const long long r = hi - lo;
    const int m = lo + (int)((r * lane) >> 5);
    const bool take_x = x(m) <= y(t - 1 - m);
    const int c = __popc(__ballot_sync(0xffffffffu, take_x));
    const int old = lo;
    if (c > 0) lo = old + (int)((r * (c - 1)) >> 5) + 1;
    if (c < 32) hi = old + (int)((r * c) >> 5);
  }
  return lo;
}

// Accessor of a row in device memory or a plain shared-memory window.
template <typename T>
struct Ptr {
  const T* p;
  __device__ T operator()(int i) const { return p[i]; }
};

// Accessor of a window in the sort kernel's padded layout, from slot o.
struct Padded {
  const uint32_t* p;
  int o;
  __device__ uint32_t operator()(int i) const { return p[pad(o + i)]; }
};

// Accessor of a run spread over consecutive blocks of the cluster, 1 <<
// log_n slots each (padded buffer buf in every block), from block `first`.
struct ClusterRun {
  uint32_t* buf;
  int first, log_n;
  __device__ uint32_t operator()(int i) const {
    const uint32_t* p =
        cg::this_cluster().map_shared_rank(buf, first + (i >> log_n));
    return p[pad(i & ((1 << log_n) - 1))];
  }
};

// One thread's walk of the merge of two sorted sequences from output u0 on
// (x wins ties); the two heads are kept in registers.
template <typename T, typename X, typename Y>
struct Cursor {
  X x;
  Y y;
  int nx, ny, a, b;
  T xa, yb;
  __device__ Cursor(const X& x_, int nx_, const Y& y_, int ny_, int u0)
      : x(x_), y(y_), nx(nx_), ny(ny_) {
    a = merge_split(x, nx, y, ny, u0);
    b = u0 - a;
    xa = a < nx ? x(a) : T();
    yb = b < ny ? y(b) : T();
  }
  __device__ T next() {
    if (a < nx && (b >= ny || xa <= yb)) {
      const T v = xa;
      if (++a < nx) xa = x(a);
      return v;
    }
    const T v = yb;
    if (++b < ny) yb = y(b);
    return v;
  }
};

// Stable LSD radix sort of the n keys of a (n a multiple of 1024, padded
// layout) in shared memory, 8 bits a pass, ending in a (four passes).
// work holds kRadixWords words: per-warp digit counters, per-warp lane
// masks and the scan's warp sums.  A pass: each warp counts the digits of
// its contiguous segment (shared atomics); the counts become offsets in
// (digit, warp) order (a digit's column a thread, then a scan of the digit
// totals); then each warp scatters its segment 32 keys at a time in slot
// order, the lanes holding one digit finding each other (a ballot for the
// digits of lanes 0 and 31, else an atomicOr of their lane bits into the
// warp's mask of that digit), each lane ranked by the lanes below it:
// equal digits keep their order (stable).
template <int PER>
__device__ void radix_sort_block(uint32_t* a, uint32_t* b, uint32_t* work) {
  constexpr int n = kSortThreads * PER;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  uint32_t* hist = work;
  uint32_t* masks = work + kSortWarps * 256;
  uint32_t* wsum = masks + kSortWarps * 256;
  uint32_t* my = hist + warp * 256;
  uint32_t* my_mask = masks + warp * 256;
  const int base = warp * (n / kSortWarps) + lane;   // PER keys a lane
  const unsigned below = (1u << lane) - 1u;
  for (int i = tid; i < kSortWarps * 256; i += kSortThreads) masks[i] = 0;
  for (int shift = 0; shift < 32; shift += 8) {
    for (int i = tid; i < kSortWarps * 256; i += kSortThreads) hist[i] = 0;
    __syncthreads();
    // This lane's keys, in slot order, kept in registers for the scatter.
    uint32_t key[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) key[u] = a[pad(base + 32 * u)];
#pragma unroll
    for (int u = 0; u < PER; ++u)
      atomicAdd(my + ((key[u] >> shift) & 255u), 1u);
    __syncthreads();
    // Offsets in (digit, warp) order: thread d < 256 runs down its
    // digit's column, then the first 8 warps scan the 256 digit totals.
    uint32_t total = 0, incl = 0;
    if (tid < 256) {
      for (int w = 0; w < kSortWarps; ++w) {
        const uint32_t c = hist[w * 256 + tid];
        hist[w * 256 + tid] = total;
        total += c;
      }
      incl = total;
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      if (lane == 31) wsum[warp] = incl;
    }
    __syncthreads();
    if (tid < 256) {
      uint32_t digit_base = incl - total;
      for (int w = 0; w < warp; ++w) digit_base += wsum[w];
      for (int w = 0; w < kSortWarps; ++w) hist[w * 256 + tid] += digit_base;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const uint32_t k = key[u];
      const uint32_t d = (k >> shift) & 255u;
      // The digits of lanes 0 and 31 by ballot (runs of equal keys, such
      // as capacity pads, fill whole warps); the other lanes by atomicOr.
      const uint32_t d0 = __shfl_sync(0xffffffffu, d, 0);
      const uint32_t d31 = __shfl_sync(0xffffffffu, d, 31);
      const unsigned m0 = __ballot_sync(0xffffffffu, d == d0);
      const unsigned m31 = __ballot_sync(0xffffffffu, d == d31);
      const bool rest = d != d0 && d != d31;
      unsigned peers = d == d0 ? m0 : m31;
      if ((m0 | m31) != 0xffffffffu) {          // the same in every lane
        if (rest) atomicOr(my_mask + d, 1u << lane);
        __syncwarp();
        if (rest) peers = my_mask[d];
        __syncwarp();
      }
      const int leader = __ffs(peers) - 1;
      uint32_t off = 0;
      if (lane == leader) {
        off = my[d];
        if (rest) my_mask[d] = 0;
      }
      off = __shfl_sync(0xffffffffu, off, leader);
      b[pad(off + __popc(peers & below))] = k;
      if (lane == leader) my[d] = off + __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    uint32_t* t = a;
    a = b;
    b = t;
  }
}

// One cluster sorts one tile of C*n slots of one row, n = 1024 * PER.
// Row r of the 2R rows is pts[r] (r < R) or diag[r - R]; tile tt of the
// row covers elements [tt*C*n, (tt+1)*C*n); elements >= F are +inf.  The
// sorted tile goes to out + r*S + tt*C*n, its first min(C*n, S - tt*C*n)
// elements.  Shared memory: three buffers of pad(n) keys, the third also
// the radix sort's work area (at least kRadixWords).
template <int PER>
__global__ void __launch_bounds__(kSortThreads, 1)
sort_rows_kernel(const float* __restrict__ pts, const float* __restrict__ diag,
                 int R, int F, int tiles, long long S,
                 float* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  __shared__ int split[2];
  constexpr int n = kSortThreads * PER;
  constexpr int np = n + n / 32;
  constexpr int log_per = PER == 1 ? 0 : PER == 2 ? 1 : PER == 4 ? 2
                        : PER == 8 ? 3 : 4;
  uint32_t* const buf[3] = {smem, smem + np, smem + 2 * np};
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks();
  const int c = (int)cl.block_rank();
  const long long cid = blockIdx.x / C;
  const int r = (int)(cid / tiles);
  const int tt = (int)(cid - (long long)r * tiles);
  const float* src = r < R ? pts + (long long)r * F
                           : diag + (long long)(r - R) * F;
  // Block c takes every C-th run of 32 elements of the tile, so that the
  // blocks of a cluster get the same share of a row's pads (capacity pads
  // sit at the row's end) and finish their block sorts together.
  const long long tile0 = (long long)tt * C * n;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += kSortThreads) {
    const long long e =
        tile0 + ((long long)(i >> 5) * C + c) * 32 + (i & 31);
    smem[pad(i)] = to_key(e < F ? src[e] : INFINITY);
  }
  __syncthreads();
  radix_sort_block<PER>(buf[0], buf[1], buf[2]);

  // Merge levels across the cluster: runs of `half` blocks pair up, and
  // block c makes outputs [o0, o0 + n) of its group's merge.  It finds the
  // splits at both ends (a warp each), copies the windows of both runs
  // from the cluster's shared memory into its own (coalesced), then merges
  // them locally.  Buffers rotate: source, window, output.
  int s_src = 0, s_win = 1, s_out = 2;
  const int warp = threadIdx.x >> 5;
  for (int half = 1; half < C; half <<= 1) {
    cl.sync();                  // every run ready, last level's reads done
    const int g0 = (c / (2 * half)) * (2 * half);
    const int m = half * n;
    const int o0 = (c - g0) * n;
    const ClusterRun x{buf[s_src], g0, kLogSortThreads + log_per};
    const ClusterRun y{buf[s_src], g0 + half, kLogSortThreads + log_per};
    if (warp < 2) {
      const int sp = merge_split_warp(x, m, y, m, o0 + warp * n);
      if ((threadIdx.x & 31) == 0) split[warp] = sp;
    }
    __syncthreads();
    const int a0 = split[0];
    const int na = split[1] - a0;
    const int b0 = o0 - a0;
    uint32_t* win = buf[s_win];
    uint32_t v[PER];                       // all remote loads, then stores
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = threadIdx.x + u * kSortThreads;
      v[u] = i < na ? x(a0 + i) : y(b0 + i - na);
    }
#pragma unroll
    for (int u = 0; u < PER; ++u)
      win[pad(threadIdx.x + u * kSortThreads)] = v[u];
    __syncthreads();
    const int u0 = threadIdx.x * PER;
    Cursor<uint32_t, Padded, Padded> cur(Padded{win, 0}, na, Padded{win, na},
                                         n - na, u0);
    uint32_t* o = buf[s_out];
#pragma unroll
    for (int u = 0; u < PER; ++u) o[pad(u0 + u)] = cur.next();
    __syncthreads();
    const int t = s_src;
    s_src = s_out;
    s_out = s_win;
    s_win = t;
  }
  if (C > 1) cl.sync();         // no block reads this one's buffers again
  const long long limit = S - (long long)tt * C * n;
  const long long n_out = min((long long)n, limit - (long long)c * n);
  float* dst = out + (long long)r * S + tile0 + (long long)c * n;
  const uint32_t* sorted = buf[s_src];
  uint32_t v[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u)
    v[u] = sorted[pad(threadIdx.x + u * kSortThreads)];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = threadIdx.x + u * kSortThreads;
    if (i < n_out) dst[i] = from_key(v[u]);
  }
}

// Stage x[a0, a0 + na) and y[b0, b0 + nb) into shared memory by 16-byte
// cp.async: each range is widened to 16-byte boundaries (the scratch rows
// carry 4 floats of slack at their end, and their base is 16-byte
// aligned), into w (16-byte aligned, na + nb + 8 floats).  Returns, via
// xs/ys, where the two ranges start in w.
__device__ __forceinline__ void stage_window(const float* x, int a0, int na,
                                             const float* y, int b0, int nb,
                                             float* w, const float*& xs,
                                             const float*& ys) {
  const float* gx = x + a0;
  const float* gy = y + b0;
  const int ox = (int)(((uintptr_t)gx & 15) >> 2);
  const int oy = (int)(((uintptr_t)gy & 15) >> 2);
  const int vx = (ox + na + 3) >> 2;       // 16-byte vectors of each
  const int vy = (oy + nb + 3) >> 2;
  const float* ax = gx - ox;
  const float* ay = gy - oy;
  float* wy = w + 4 * vx;
  for (int i = threadIdx.x; i < vx + vy; i += blockDim.x) {
    const float* g = i < vx ? ax + 4 * i : ay + 4 * (i - vx);
    float* d = i < vx ? w + 4 * i : wy + 4 * (i - vx);
    const unsigned s = (unsigned)__cvta_generic_to_shared(d);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(g));
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  xs = w + ox;
  ys = wy + oy;
}

// Pair p of the i < j pairs, in row-major order.
__device__ __forceinline__ void pair_of(int p, int B, int& i, int& j) {
  i = 0;
  while (p >= B - 1 - i) {
    p -= B - 1 - i;
    ++i;
  }
  j = i + 1 + p;
}

// grid (pairs * K, ceil(2 * (T + 1) / 8)), 8 warps: warp q of (pair, k)
// finds the split of merge q / (T + 1) (0: pts_i with diag_j, 1: pts_j
// with diag_i) at tile start q % (T + 1), into splits.
__global__ void __launch_bounds__(256)
pair_splits_kernel(const float* __restrict__ rows, int B, int K, int F,
                   long long S, int T, int* __restrict__ splits) {
  const int q = blockIdx.y * 8 + (threadIdx.x >> 5);
  if (q >= 2 * (T + 1)) return;            // whole warps leave
  const int p = blockIdx.x / K;
  const int k = blockIdx.x - p * K;
  int i, j;
  pair_of(p, B, i, j);
  const int merge = q / (T + 1);
  const int tile = q - merge * (T + 1);
  const long long R = (long long)B * K;
  const int xi = merge ? j : i;
  const int yi = merge ? i : j;
  const Ptr<float> x{rows + ((long long)xi * K + k) * S};
  const Ptr<float> y{rows + (R + (long long)yi * K + k) * S};
  const int t = min(2 * F, tile * kPairTile);
  const int s = merge_split_warp(x, F, y, F, t);
  if ((threadIdx.x & 31) == 0)
    splits[((long long)blockIdx.x * 2 + merge) * (T + 1) + tile] = s;
}

// grid (pairs, K, T): the double sum of |va - vb| over one tile of
// kPairTile merged outputs into part[(p*K + k)*T + tile].
__global__ void __launch_bounds__(kMergeThreads)
w1_tiles_kernel(const float* __restrict__ rows, int B, int K, int F,
                long long S, int T, const int* __restrict__ splits,
                double* __restrict__ part) {
  extern __shared__ __align__(16) float win[];    // 2 x kWindow
  __shared__ double wpart[kMergeThreads / 32];
  int i, j;
  pair_of(blockIdx.x, B, i, j);
  const int k = blockIdx.y;
  const int tile = blockIdx.z;
  const long long R = (long long)B * K;
  const float* pts_i = rows + ((long long)i * K + k) * S;
  const float* pts_j = rows + ((long long)j * K + k) * S;
  const float* diag_i = rows + (R + (long long)i * K + k) * S;
  const float* diag_j = rows + (R + (long long)j * K + k) * S;
  const int t0 = tile * kPairTile;
  const int len = min(2 * F, t0 + kPairTile) - t0;
  const int* sp = splits + ((long long)blockIdx.x * K + k) * 2 * (T + 1);
  // va merges pts_i with diag_j, vb merges pts_j with diag_i.
  const int a0 = sp[tile], na = sp[tile + 1] - a0;
  const int c0 = sp[T + 1 + tile], nc = sp[T + 1 + tile + 1] - c0;
  const float *xa, *ya, *xb, *yb;
  stage_window(pts_i, a0, na, diag_j, t0 - a0, len - na, win, xa, ya);
  stage_window(pts_j, c0, nc, diag_i, t0 - c0, len - nc, win + kWindow, xb,
               yb);

  double acc = 0.0;
  const int u0 = threadIdx.x * kPairPer;
  if (u0 < len) {
    const int u1 = min(len, u0 + kPairPer);
    Cursor<float, Ptr<float>, Ptr<float>> ca(Ptr<float>{xa}, na,
                                             Ptr<float>{ya}, len - na, u0);
    Cursor<float, Ptr<float>, Ptr<float>> cb(Ptr<float>{xb}, nc,
                                             Ptr<float>{yb}, len - nc, u0);
    for (int u = u0; u < u1; ++u) {
      const float va = ca.next();
      const float vb = cb.next();
      acc += (double)fabsf(va - vb);
    }
  }
  for (int o = 16; o > 0; o >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0) wpart[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int w = 0; w < kMergeThreads / 32; ++w) s += wpart[w];
    part[((long long)blockIdx.x * K + k) * T + tile] = s;
  }
}

// grid (rows, S / kRunTile): one pass of the wide path's run merges.  Runs
// of m sorted elements (m a multiple of kRunTile) pair up: out =
// merge(src run 2g, src run 2g + 1), tile by tile.
__global__ void __launch_bounds__(kMergeThreads)
merge_runs_kernel(const float* __restrict__ src, long long S, long long m,
                  float* __restrict__ dst) {
  extern __shared__ __align__(16) float win[];    // window, then output
  __shared__ int split[2];
  const long long row = blockIdx.x;
  const long long t_row = (long long)blockIdx.y * kRunTile;
  const long long g = t_row / (2 * m);
  const Ptr<float> x{src + row * S + g * 2 * m};
  const Ptr<float> y{x.p + m};
  const int t0 = (int)(t_row - g * 2 * m);
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int s = merge_split_warp(x, (int)m, y, (int)m,
                                   t0 + warp * kRunTile);
    if ((threadIdx.x & 31) == 0) split[warp] = s;
  }
  __syncthreads();
  const int na = split[1] - split[0];
  const float *xs, *ys;
  stage_window(x.p, split[0], na, y.p, t0 - split[0], kRunTile - na, win,
               xs, ys);
  float* outw = win + kRunTile + 16;       // past the widened window
  const int u0 = threadIdx.x * kRunPer;
  Cursor<float, Ptr<float>, Ptr<float>> cur(Ptr<float>{xs}, na,
                                            Ptr<float>{ys}, kRunTile - na,
                                            u0);
  for (int u = 0; u < kRunPer; ++u) outw[u0 + u] = cur.next();
  __syncthreads();
  float* o = dst + row * S + t_row;
  for (int u = threadIdx.x; u < kRunTile; u += kMergeThreads) o[u] = outw[u];
}

// grid (pairs, kBnChunks): the largest |prof_i - prof_j| over one chunk
// of the F columns, into bn_part[p * kBnChunks + chunk].
__global__ void __launch_bounds__(kReduceThreads)
bn_chunks_kernel(const float* __restrict__ prof, int B, int F,
                 float* __restrict__ bn_part) {
  __shared__ float wmax[kReduceThreads / 32];
  int i, j;
  pair_of(blockIdx.x, B, i, j);
  const int per = (F + kBnChunks - 1) / kBnChunks;
  const int t0 = blockIdx.y * per;
  const int t1 = min(F, t0 + per);
  const float* pa = prof + (long long)i * F;
  const float* pb = prof + (long long)j * F;
  float m = 0.0f;                        // every |difference| is >= +0
#pragma unroll 4
  for (int t = t0 + threadIdx.x; t < t1; t += kReduceThreads)
    m = fmaxf(m, fabsf(pa[t] - pb[t]));
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_down_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kReduceThreads / 32; ++w) m = fmaxf(m, wmax[w]);
    bn_part[(long long)blockIdx.x * kBnChunks + blockIdx.y] = m;
  }
}

// One warp per pair i <= j.  sw: lane k sums the tile partials of
// direction k in tile order (w1, rounded to float), then lane 0 sums the K
// w1 in order and divides by K.  bn: 0.5 * the largest chunk maximum (a max
// of exact differences: bitwise equal to the plain version in any order).
// Both mirrored; 0 on the diagonal.
__global__ void finalize_kernel(const double* __restrict__ part,
                                const float* __restrict__ bn_part, int B,
                                int K, int T, float* __restrict__ sw,
                                float* __restrict__ bn) {
  __shared__ float w1[32];
  const int pr = blockIdx.x;
  const int i = pr / B;
  const int j = pr - i * B;
  const int lane = threadIdx.x;
  if (i > j) return;
  if (i == j) {
    if (lane == 0) sw[i * B + i] = bn[i * B + i] = 0.0f;
    return;
  }
  const long long p = (long long)i * B - (long long)i * (i + 1) / 2 +
                      (j - i - 1);
  float s = 0.0f;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int k = k0 + lane;
    if (k < K) {
      const double* q = part + (p * K + k) * T;
      double w = 0.0;
      for (int t = 0; t < T; ++t) w += q[t];
      w1[lane] = (float)w;
    }
    __syncwarp();
    if (lane == 0)
      for (int u = 0; u < min(32, K - k0); ++u) s += w1[u];
    __syncwarp();
  }
  float m = lane < kBnChunks ? bn_part[p * kBnChunks + lane] : 0.0f;
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_down_sync(0xffffffffu, m, o));
  if (lane == 0) {
    const float v = s / (float)K;
    sw[i * B + j] = v;
    sw[j * B + i] = v;
    const float b = 0.5f * m;
    bn[i * B + j] = b;
    bn[j * B + i] = b;
  }
}

// Tiles of kClusterSlots per row in the wide path: a power of two >= the
// tiles F needs.
long long wide_tiles(int F) {
  long long t = 1;
  while (t * kClusterSlots < F) t <<= 1;
  return t;
}

// The row stride of the sort scratch: F, or for rows wider than one
// cluster (F > 65,536) the wide path's power-of-two count of 65,536-slot
// tiles.  The binding computes the same (kernel.py:sort_width).
long long sort_width(int F) {
  return F <= kClusterSlots ? F : wide_tiles(F) * kClusterSlots;
}

// The tile count of stage 2: ceil(2F / 7680) (kernel.py:merge_tiles).
int merge_tiles(int F) {
  return (int)((2LL * F + kPairTile - 1) / kPairTile);
}

// One cluster of C blocks per (row, tile); PER keys a thread.
template <int PER>
cudaError_t launch_sort(const void* pts, const void* diag, int R, int F,
                        int C, long long clusters, long long tiles,
                        long long S, float* out, cudaStream_t st) {
  constexpr int np = kSortThreads * PER + kSortThreads * PER / 32;
  const size_t smem =
      (2 * np + (np > kRadixWords ? np : kRadixWords)) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      sort_rows_kernel<PER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * C));
  cfg.blockDim = dim3(kSortThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, sort_rows_kernel<PER>,
                           static_cast<const float*>(pts),
                           static_cast<const float*>(diag), R, F, (int)tiles,
                           S, out);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Stage 1: pts, diag: (B, K, F) float32, contiguous.  rows: scratch of
// 2*B*K*S + 4 floats, S = sort_width(F): the sorted rows.  tmp: a
// second scratch of the same size for the wide path (F > 65,536), else
// unused.
extern "C" int distance_sort_launch(const void* pts, const void* diag, int B,
                                    int K, int F, long long S, void* rows,
                                    void* tmp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (F <= 0 || K <= 0 || S != sort_width(F))
    return (int)cudaErrorInvalidValue;
  const int R = B * K;
  const long long n_rows = 2LL * R;
  int C, per = kMaxPer;
  long long tiles = 1;
  if (F <= kClusterSlots) {
    C = F <= kSlotsPerBlock ? 1 : (F <= 2 * kSlotsPerBlock ? 2 : 4);
    const int per_block = (F + C - 1) / C;
    per = 1;
    while (per * kSortThreads < per_block) per <<= 1;
  } else {
    if (tmp == nullptr) return (int)cudaErrorInvalidValue;
    C = kMaxCluster;
    tiles = wide_tiles(F);
  }
  int levels = 0;
  while ((1LL << levels) < tiles) ++levels;
  // The last merge pass must land in rows.
  float* first = static_cast<float*>((levels & 1) ? tmp : rows);
  cudaError_t err;
  switch (per) {
    case 1: err = launch_sort<1>(pts, diag, R, F, C, n_rows * tiles, tiles,
                                 S, first, st); break;
    case 2: err = launch_sort<2>(pts, diag, R, F, C, n_rows * tiles, tiles,
                                 S, first, st); break;
    case 4: err = launch_sort<4>(pts, diag, R, F, C, n_rows * tiles, tiles,
                                 S, first, st); break;
    case 8: err = launch_sort<8>(pts, diag, R, F, C, n_rows * tiles, tiles,
                                 S, first, st); break;
    default: err = launch_sort<16>(pts, diag, R, F, C, n_rows * tiles,
                                   tiles, S, first, st);
  }
  if (err != cudaSuccess) return (int)err;
  if (levels == 0) return 0;
  const size_t msmem = (2 * kRunTile + 16) * sizeof(float);
  err = cudaFuncSetAttribute(merge_runs_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)msmem);
  if (err != cudaSuccess) return (int)err;
  float* src = first;
  float* dst = static_cast<float*>(src == rows ? tmp : rows);
  for (long long m = kClusterSlots; m < S; m <<= 1) {
    merge_runs_kernel<<<dim3((unsigned)n_rows, (unsigned)(S / kRunTile)),
                        kMergeThreads, msmem, st>>>(src, S, m, dst);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    float* t = src;
    src = dst;
    dst = t;
  }
  return 0;
}

// Stage 2: rows sorted by stage 1 (stride S); prof: (B, F) float32,
// contiguous.  With pairs = B*(B-1)/2 and T = merge_tiles(F), splits holds
// pairs*K*2*(T+1) ints and part pairs*K*T doubles, then pairs*32 floats of
// bn chunk maxima; sw, bn: (B, B) float32 outputs.
extern "C" int distance_pairs_launch(const void* rows, const void* prof,
                                     int B, int K, int F, long long S,
                                     void* splits, void* part, void* sw,
                                     void* bn, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  const int T = merge_tiles(F);
  const long long pairs = (long long)B * (B - 1) / 2;
  const float* r = static_cast<const float*>(rows);
  int* sp = static_cast<int*>(splits);
  double* q = static_cast<double*>(part);
  float* bq = reinterpret_cast<float*>(q + (pairs > 0 ? pairs * K * T : 0));
  cudaError_t err;
  if (pairs > 0) {
    pair_splits_kernel<<<dim3((unsigned)(pairs * K), (2 * (T + 1) + 7) / 8),
                         256, 0, st>>>(r, B, K, F, S, T, sp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t smem = 2 * kWindow * sizeof(float);
    err = cudaFuncSetAttribute(w1_tiles_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    w1_tiles_kernel<<<dim3((unsigned)pairs, K, T), kMergeThreads, smem,
                      st>>>(r, B, K, F, S, T, sp, q);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (pairs > 0) {
    bn_chunks_kernel<<<dim3((unsigned)pairs, kBnChunks), kReduceThreads, 0,
                       st>>>(static_cast<const float*>(prof), B, F, bq);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  finalize_kernel<<<B * B, 32, 0, st>>>(q, bq, B, K, T,
                                        static_cast<float*>(sw),
                                        static_cast<float*>(bn));
  return (int)cudaGetLastError();
}

// Both stages on one stream.
extern "C" int distance_launch(const void* pts, const void* diag,
                               const void* prof, int B, int K, int F,
                               long long S, void* rows, void* tmp,
                               void* splits, void* part, void* sw, void* bn,
                               void* stream) {
  const int err = distance_sort_launch(pts, diag, B, K, F, S, rows, tmp,
                                       stream);
  if (err != 0) return err;
  return distance_pairs_launch(rows, prof, B, K, F, S, splits, part, sw, bn,
                               stream);
}

extern "C" const char* distance_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
