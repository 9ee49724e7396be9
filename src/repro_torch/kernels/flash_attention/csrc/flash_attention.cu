// Grouped-query flash attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_fwd, _fa_kernel).  Its plain PyTorch version is
// src/repro_torch/kernels/flash_attention/ref.py, which this kernel is held
// to within the working type's tolerance (float32 2e-5, bfloat16 2e-2).
//
// What bounds it on an H100: operations.  At the LM slice's prefill shape
// (B = 4, H = 32, KV = 8, S = 1024, hd = 128, bfloat16, causal) the two
// products over the visible (query, key) pairs do 34.4 GFLOP, 0.035 ms at
// 989 TFLOP/s; reading q, k, v once and writing o once moves 84 MB, 0.025
// ms at 3.35 TB/s.
//
// Numerics, shared by both paths: the running max, normaliser and output
// accumulator of each row stay in float32 registers (online softmax); the
// scores are scaled after Q K^T; the probabilities are rounded to v's type
// before the P.V product, as kernel.py:84-86 does, and the normaliser sums
// them unrounded.  The KV head is h / (H / KV), so grouped query heads read
// one K/V stream, never a repeated one.  Causal, window (kpos > qpos -
// window) and the ragged tails of Sq and Skv are masked per element; whole
// KV tiles above the diagonal or older than the window are never loaded
// (kernel.py:49-58), and the heaviest causal query tiles run first.  A
// fully masked row yields 0.  No atomics, a fixed key order: deterministic.
//
// bfloat16 (the LM's type) is a warp-specialised Hopper pipeline.  A block
// of three warpgroups owns 128 query rows of one (batch, head):
//   * warpgroup 0 is the producer: it gives most of its registers back
//     (setmaxnreg); one of its threads issues the TMA loads
//     (cp.async.bulk.tensor) of the Q tile and of the K tiles, another
//     those of the V tiles, into a ring of three stages (two at hd 256)
//     in shared memory, each stage with a full and an empty mbarrier;
//   * warpgroups 1 and 2 are consumers of 64 rows each (setmaxnreg takes
//     the producer's registers).  S = Q K^T is wgmma m64nNk16 with Q and K
//     read from shared memory (both K-major: hd is contiguous); the online
//     softmax runs on the accumulator fragment (a row's values sit on the
//     four lanes of a quad, rows r and r + 8 in one thread), as one FFMA
//     and one exp2f per score (no fast-math: subnormals kept); the
//     probabilities, rounded to bfloat16, are wgmma's A operand straight
//     from registers, so O += P V never stages P in shared memory; V is
//     read as an MN-major B operand, without a transposed copy.  Step t
//     issues S of tile t and O += P V of tile t - 1 back to back, so the
//     softmax of tile t runs while the tensor cores do that P V.  O is
//     scaled by 1 / l, written in bfloat16 over the consumer's (spent)
//     rows of the Q tile and stored by TMA.
// Tiles are 128-byte swizzled: a row of hd > 64 moves as 64-column boxes
// (one 1024-byte aligned region each), which is how the descriptors step
// through it.  TMA zero-fills rows past Sq or Skv on loads and drops them
// on stores, so ragged tails need no padding.  Keys per tile: 128 (hd 64
// and 128), 64 (hd 256, whose O accumulator alone is 128 registers a
// thread).  Blocks run longest first across the whole grid.
//
// float32 must stay exact float32 (tf32 would miss the 2e-5 tolerance), so
// it runs scalar FMAs: one block of 8 warps per (batch, head, 64 query
// rows), a warp scoring 8 rows, a lane keys `lane` and `lane + 32` and
// owning output dims `lane + 32 j`, K and V staged in shared memory, P
// passing through a warp-private slice of it; expf and divisions as
// written.
//
// q, k, v and o are given by pointer and strides (the last dim
// contiguous), so the model's (B, S, heads, hd) tensors pass as transposed
// views; the bfloat16 path also needs a 16-byte aligned base and strides
// (TMA's rule; the wrapper copies a tensor that lacks them).  The TMA
// descriptor's encoder, cuTensorMapEncodeTiled, lives in libcuda; the
// runtime hands out its address (cudaGetDriverEntryPoint), so the library
// needs no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBlockQ = 64;                      // float32: query rows
constexpr int kBlockK = 64;                      // float32: keys per tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_sh, q_ss;                    // element strides; dim
  long long k_sb, k_sh, k_ss;                    // stride is 1
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int B, H, KV, Sq, Skv;
  int causal;
  int window;                                    // <= 0: no window
  int q_off;                                     // position of query row 0
  float scale;
};

// The KV tiles [begin, end) that some row of the query tile at q0 sees.
// Row r sits at position r + q_off (a query block of a longer sequence);
// keys sit at 0 .. Skv - 1.  The kernels take q_off as 0 at compile time
// unless the launch has one (kOff), so a whole sequence runs the code of
// a kernel without the offset.
template <int BM, int BN>
__device__ __forceinline__ int2 kv_tiles(const Params& p, int q0,
                                         int q_off) {
  const int q_last = min(q0 + BM, p.Sq) - 1 + q_off;
  int end = (p.Skv + BN - 1) / BN;
  if (p.causal) end = max(min(end, q_last / BN + 1), 0);
  int begin = 0;
  if (p.window > 0 && q0 + q_off - p.window + 1 > 0)
    begin = (q0 + q_off - p.window + 1) / BN;
  return make_int2(begin, end);
}

// Key kc against the query at position pos.
__device__ __forceinline__ bool visible(const Params& p, int pos, int kc) {
  bool vis = kc < p.Skv;
  if (p.causal) vis = vis && kc <= pos;
  if (p.window > 0) vis = vis && kc > pos - p.window;
  return vis;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// ---------------------------------------------------------------------------
// Hopper primitives: mbarrier, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// One arrival that also expects `bytes` of TMA transactions.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// One box of a 4-D tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box of shared memory into a 4-D tensor map (rows past its extent are
// dropped); completes in the thread's bulk group.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accesses of an accumulator across the
// asynchronous wgmma that reads or writes it.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// A shared-memory matrix descriptor for a 128-byte swizzled tile whose
// 1024-byte atoms hold 8 rows of 128 bytes.  K-major operands (Q, K) step
// 8-row groups by sbo = 1024 (lbo unused); the MN-major operand (V) steps
// 8-key groups by sbo = 1024 and 64-column chunks of hd by lbo.
__device__ __forceinline__ uint64_t smem_desc(const void* ptr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(ptr) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         1ull << 62;                              // 128-byte swizzle
}

// wgmma m64nNk16, bfloat16 in, float32 accumulators: the thread's
// d[4j + e] holds row 16 w + g + 8 (e >> 1), column 8 j + 2 (lane % 4) +
// (e & 1) of the warpgroup's 64 x N tile (w = warp, g = lane / 4).  N is
// the key tile (S = Q K^T, 64 or 128) or hd (O += P V, 64, 128 or 256).
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  // d (+)= A (smem, K-major) . B (smem, K-major); scale_d 0 overwrites d.
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }

  // d += A (registers, the m64k16 fragment) . B (smem, MN-major).
  __device__ __forceinline__ static void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  // d (+)= A (smem, K-major) . B (smem, K-major); scale_d 0 overwrites d.
  __device__ __forceinline__ static void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }

  // d += A (registers, the m64k16 fragment) . B (smem, MN-major).
  __device__ __forceinline__ static void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<256> {    // O += P V at hd 256 only
  // d += A (registers, the m64k16 fragment) . B (smem, MN-major).
  __device__ __forceinline__ static void rs(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, "
        "%116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
          "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
          "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
          "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
          "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// ---------------------------------------------------------------------------
// bfloat16: warp-specialised wgmma + TMA pipeline
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 384;                  // producer + 2 consumers
constexpr int kConsumerWarps = 8;

template <int HD>
struct WgCfg {
  static constexpr int BM = 128;                 // query rows per block
  static constexpr int BN = HD == 256 ? 64 : 128;  // keys per tile
  // Stages of the K and V ring: three where they fit in shared memory.
  static constexpr int kStages = HD == 256 ? 2 : 3;
  static constexpr int kChunks = HD / 64;        // 128-byte column boxes
  static constexpr int kQBytes = BM * HD * 2;
  static constexpr int kTileBytes = BN * HD * 2;  // one K or V tile
  static constexpr int kBarriers = 1 + 4 * kStages;
  // + 1024: the dynamic base is rounded up to a swizzle atom.
  static constexpr int kSmemBytes =
      1024 + kQBytes + 2 * kStages * kTileBytes + kBarriers * 8;
};

template <int HD, bool kOff>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_o,
                           const Params p) {
  using C = WgCfg<HD>;
  constexpr int BM = C::BM, BN = C::BN, S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sK = sQ + C::kQBytes;                 // stage s at s * kTileBytes
  uint8_t* sV = sK + S * C::kTileBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + S * C::kTileBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + S;
  uint64_t* k_empty = v_full + S;
  uint64_t* v_empty = k_empty + S;

  // Blocks start in index order, so the query tile is the slowest index,
  // last tile first: every (batch, head)'s heaviest causal tile starts
  // before any lighter one (longest job first across the whole grid).
  const int n_bh = p.B * p.H;
  const int bh = blockIdx.x % n_bh;
  const int q0 = (gridDim.x / n_bh - 1 - blockIdx.x / n_bh) * BM;
  const int h = bh % p.H;
  const int b = bh / p.H;
  const int kvh = h / (p.H / p.KV);
  const int q_off = kOff ? p.q_off : 0;
  const int2 tiles = kv_tiles<BM, BN>(p, q0, q_off);
  const int n_tiles = max(tiles.y - tiles.x, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], kConsumerWarps);
      mbar_init(&v_empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: one thread loads Q and the K tiles, another the
    // V tiles, each as soon as the consumers free a stage.
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c)
        tma_load_4d(sQ + c * BM * 128, &tm_q, q_full, c * 64, q0, h, b);
    }
    if (threadIdx.x == 0 || threadIdx.x == 32) {
      const bool is_k = threadIdx.x == 0;
      const CUtensorMap* map = is_k ? &tm_k : &tm_v;
      uint8_t* ring = is_k ? sK : sV;
      uint64_t* full = is_k ? k_full : v_full;
      uint64_t* empty = is_k ? k_empty : v_empty;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % S;
        mbar_wait(&empty[s], ((i / S) & 1) ^ 1);   // the first pass is free
        mbar_expect_tx(&full[s], C::kTileBytes);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c)
          tma_load_4d(ring + s * C::kTileBytes + c * BN * 128, map, &full[s],
                      c * 64, (tiles.x + i) * BN, kvh, b);
      }
    }
    return;
  }

  // Consumer warpgroups: 64 query rows each.
  setmaxnreg_inc<240>();
  const int wg = (threadIdx.x >> 7) - 1;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;            // fragment row (and row + 8)
  const int qd = lane & 3;            // fragment column pair
  const int r_lo = q0 + wg * 64;      // the warpgroup's first row
  const int row = r_lo + warp * 16 + g;
  const float scale_log2 = p.scale * 1.4426950408889634f;
  uint8_t* sQw = sQ + wg * 64 * 128;  // this warpgroup's rows of each box

  // No row of this warpgroup sees tile i: its steps only wait and release.
  auto none = [&](int i) {
    const int k0 = (tiles.x + i) * BN;
    return r_lo >= p.Sq || (p.causal && k0 > r_lo + q_off + 63) ||
           (p.window > 0 && k0 + BN - 1 <= r_lo + q_off - p.window);
  };

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float sc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float corr[2] = {0.f, 0.f};
  uint32_t pa[BN / 16][4];

  // S = Q K^T of tile i, issued (not waited for).
  auto issue_qk = [&](int i) {
    const uint8_t* sKs = sK + (i % S) * C::kTileBytes;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int off = (kk & 3) * 32;      // 16 columns = 32 bytes
      Wgmma<BN>::ss(sc,
                    smem_desc(sQw + (kk >> 2) * BM * 128 + off, 16, 1024),
                    smem_desc(sKs + (kk >> 2) * BN * 128 + off, 16, 1024),
                    kk > 0);
    }
    wgmma_commit();
  };
  // O += P V of tile i, issued.
  auto issue_pv = [&](int i) {
    const uint8_t* sVs = sV + (i % S) * C::kTileBytes;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      Wgmma<HD>::rs(o, pa[kk], smem_desc(sVs + kk * 16 * 128, BN * 128,
                                         1024));
    wgmma_commit();
  };
  // Online softmax of tile i's scores, in place; sets corr, the factor
  // that rescales O and l to the new row maxima.  The maxima are taken on
  // the raw scores (the scale is positive); each probability is then
  // 2^(s * scale * log2e - m * scale * log2e), one FFMA and one exp2f.  Only
  // tiles that cross a mask edge (the diagonal, the window's edge, the
  // end of Skv) test each element.
  auto softmax_tile = [&](auto mask_type, int i) {
    constexpr bool masked = decltype(mask_type)::value;
    const int k0 = (tiles.x + i) * BN;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (masked && !visible(p, row + q_off + (e >> 1) * 8,
                               k0 + 8 * j + 2 * qd + (e & 1)))
          sc[4 * j + e] = -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
      }
    float mu[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // An empty row so far keeps its offset at 0 (no -inf - -inf).
      mu[r] = m_new == -INFINITY ? 0.f : m_new * scale_log2;
      corr[r] = exp2f(m[r] * scale_log2 - mu[r]);   // 0 while empty
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv =
            exp2f(fmaf(sc[4 * j + e], scale_log2, -mu[e >> 1]));
        sum[e >> 1] += pv;
        sc[4 * j + e] = pv;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
  };
  auto softmax = [&](int i) {
    const int k0 = (tiles.x + i) * BN;
    // Every row sees every key of the tile: no per-element mask.
    const bool full = k0 + BN <= p.Skv &&
                      (!p.causal || k0 + BN - 1 <= r_lo + q_off) &&
                      (p.window <= 0 || k0 > r_lo + q_off + 63 - p.window);
    if (full)
      softmax_tile(std::false_type(), i);
    else
      softmax_tile(std::true_type(), i);
  };
  auto rescale = [&]() {                // O *= corr
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[4 * j] *= corr[0];
      o[4 * j + 1] *= corr[0];
      o[4 * j + 2] *= corr[1];
      o[4 * j + 3] *= corr[1];
    }
  };
  // P: score n-blocks 2kk and 2kk + 1, rounded to bfloat16, are the A
  // fragment of keys 16kk .. 16kk + 15.
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  };

  // Step t = 0 .. n_tiles issues S of tile t and O += P V of tile t - 1,
  // where this warpgroup's rows see them; the softmax of tile t then runs
  // while the tensor cores do that P V (and the other warpgroup's
  // products).  Every step waits for and releases its tiles, so both
  // consumers free each stage in the ring's order.
  mbar_wait(q_full, 0);
  for (int t = 0; t <= n_tiles; ++t) {
    const bool qk = t < n_tiles && !none(t);
    const bool pv = t > 0 && !none(t - 1);
    if (t < n_tiles) mbar_wait(&k_full[t % S], (t / S) & 1);
    if (t > 0) mbar_wait(&v_full[(t - 1) % S], ((t - 1) / S) & 1);
    if (qk) {
      fence_operands(sc);
      wgmma_fence();
      issue_qk(t);
    }
    if (pv) {
      rescale();                        // to tile t - 1's row maxima
      fence_operands(o);
      wgmma_fence();
      issue_pv(t - 1);
    }
    if (qk) {
      if (pv)
        wgmma_wait<1>();                // S of tile t is done
      else
        wgmma_wait<0>();
      fence_operands(sc);
    }
    if (t < n_tiles && lane == 0) mbar_arrive(&k_empty[t % S]);
    if (qk) softmax(t);
    if (pv) {
      wgmma_wait<0>();                  // P V of tile t - 1 is done
      fence_operands(o);
    }
    if (t > 0 && lane == 0) mbar_arrive(&v_empty[(t - 1) % S]);
    if (qk) pack();
  }

  // O / l in bfloat16, through this warpgroup's rows of the Q tile (no
  // longer read) in the 128-byte swizzled layout, then one TMA store per
  // 64-column box; TMA drops rows past Sq.
  if (r_lo >= p.Sq) return;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);   // a row that saw no key: 0
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = warp * 16 + g + 8 * r;         // row within the 64
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int unit = (j & 7) ^ (rr & 7);        // the swizzled 16 bytes
      *reinterpret_cast<uint32_t*>(sQw + (j >> 3) * BM * 128 + rr * 128 +
                                   unit * 16 + qd * 4) =
          pack_bf16(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
  if ((threadIdx.x & 127) == 0) {
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c)
      tma_store_4d(&tm_o, sQw + c * BM * 128, c * 64, r_lo, h, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// float32: scalar FMAs out of shared memory
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kBlockQ / kWarps;          // query rows per warp

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int HD>
constexpr int f32_smem_bytes() {
  return (kBlockQ * HD + kBlockK * (HD + 4) + kBlockK * HD +
          kBlockQ * kBlockK) * 4;
}

template <int HD, bool kOff>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32_kernel(const Params p) {
  constexpr int KP = HD + 4;          // padded K row: conflict-free float4
  constexpr int DJ = HD / 32;         // output dims per lane
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);   // kBlockQ x HD
  float* sK = sQ + kBlockQ * HD;                 // kBlockK x KP
  float* sV = sK + kBlockK * KP;                 // kBlockK x HD
  float* sP = sV + kBlockK * HD;                 // kBlockQ x kBlockK

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;   // heavy first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r0 = warp * kRows;

  const float* Q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* K =
      static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* V =
      static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  float* O = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < kBlockQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int qr = q0 + r;
    sQ[i] = qr < p.Sq ? Q[qr * p.q_ss + d] : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][DJ];
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[rr][j] = 0.f;
  }

  const int q_off = kOff ? p.q_off : 0;
  const int2 tiles = kv_tiles<kBlockQ, kBlockK>(p, q0, q_off);
  for (int kt = tiles.x; kt < tiles.y; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();                  // the previous tile is consumed
    for (int i = tid; i < kBlockK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const int kr = k0 + r;
      const bool ok = kr < p.Skv;
      sK[r * KP + d] = ok ? K[kr * p.k_ss + d] : 0.f;
      sV[r * HD + d] = ok ? V[kr * p.v_ss + d] : 0.f;
    }
    __syncthreads();

    // Scores of keys (lane, lane + 32) against the warp's rows.
    float s[kRows][2];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) s[rr][0] = s[rr][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(&sK[lane * KP + d]);
      const float4 kb =
          *reinterpret_cast<const float4*>(&sK[(lane + 32) * KP + d]);
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const float4 qv =
            *reinterpret_cast<const float4*>(&sQ[(r0 + rr) * HD + d]);
        s[rr][0] = fmaf(qv.x, ka.x, s[rr][0]);
        s[rr][0] = fmaf(qv.y, ka.y, s[rr][0]);
        s[rr][0] = fmaf(qv.z, ka.z, s[rr][0]);
        s[rr][0] = fmaf(qv.w, ka.w, s[rr][0]);
        s[rr][1] = fmaf(qv.x, kb.x, s[rr][1]);
        s[rr][1] = fmaf(qv.y, kb.y, s[rr][1]);
        s[rr][1] = fmaf(qv.z, kb.z, s[rr][1]);
        s[rr][1] = fmaf(qv.w, kb.w, s[rr][1]);
      }
    }

    // Online softmax per row; P to the warp's slice of shared memory.
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) {
      const int qr = q0 + r0 + rr;
      float sc[2];
#pragma unroll
      for (int c = 0; c < 2; ++c)
        sc[c] = visible(p, qr + q_off, k0 + lane + 32 * c)
                    ? s[rr][c] * p.scale : -INFINITY;
      const float m_new = fmaxf(m[rr], warp_max(fmaxf(sc[0], sc[1])));
      float p0 = 0.f, p1 = 0.f, corr = 1.f;
      if (m_new != -INFINITY) {
        corr = expf(m[rr] - m_new);   // 0 while the row was empty
        p0 = sc[0] == -INFINITY ? 0.f : expf(sc[0] - m_new);
        p1 = sc[1] == -INFINITY ? 0.f : expf(sc[1] - m_new);
      }
      l[rr] = l[rr] * corr + warp_sum(p0 + p1);
      m[rr] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[rr][j] *= corr;
      sP[(r0 + rr) * kBlockK + lane] = p0;
      sP[(r0 + rr) * kBlockK + lane + 32] = p1;
    }
    __syncwarp();

    // acc += P . V over the tile's keys, 4 keys at a time.
#pragma unroll 2
    for (int kk = 0; kk < kBlockK; kk += 4) {
      float vv[4][DJ];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int j = 0; j < DJ; ++j)
          vv[u][j] = sV[(kk + u) * HD + j * 32 + lane];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr) {
        const float4 pv =
            *reinterpret_cast<const float4*>(&sP[(r0 + rr) * kBlockK + kk]);
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          float a = acc[rr][j];
          a = fmaf(pv.x, vv[0][j], a);
          a = fmaf(pv.y, vv[1][j], a);
          a = fmaf(pv.z, vv[2][j], a);
          a = fmaf(pv.w, vv[3][j], a);
          acc[rr][j] = a;
        }
      }
    }
    __syncwarp();                     // sP is rewritten by the next tile
  }

#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const int qr = q0 + r0 + rr;
    if (qr >= p.Sq) continue;
    const float den = fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      O[qr * p.o_ss + j * 32 + lane] = acc[rr][j] / den;
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A (batch, heads, seq, hd) bfloat16 tensor with element strides (sb, sh,
// ss) as the 4-D map (hd, seq, heads, batch) of 64 x `rows` boxes, 128-byte
// swizzled; rows past `seq` read as zeros.
cudaError_t encode_map(CUtensorMap* map, const void* ptr, int hd, int seq,
                       int heads, int batch, long long sb, long long sh,
                       long long ss, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)seq,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  // A dim of extent 1 is never stepped: give it the packed stride.
  const long long packed[3] = {hd, (long long)hd * seq,
                               (long long)hd * seq * heads};
  const long long given[3] = {ss, sh, sb};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = 2 * (dims[i + 1] == 1 ? packed[i] : given[i]);
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HD>
cudaError_t launch_wgmma(const Params& p, int B, cudaStream_t st) {
  using C = WgCfg<HD>;
  CUtensorMap tq, tk, tv, to;
  cudaError_t err = encode_map(&tq, p.q, HD, p.Sq, p.H, B, p.q_sb, p.q_sh,
                               p.q_ss, C::BM);
  if (err != cudaSuccess) return err;
  err = encode_map(&to, p.o, HD, p.Sq, p.H, B, p.o_sb, p.o_sh, p.o_ss, 64);
  if (err != cudaSuccess) return err;
  if (p.Skv == 0) {                  // no KV tile is loaded
    tk = tv = tq;
  } else {
    err = encode_map(&tk, p.k, HD, p.Skv, p.KV, B, p.k_sb, p.k_sh, p.k_ss,
                     C::BN);
    if (err != cudaSuccess) return err;
    err = encode_map(&tv, p.v, HD, p.Skv, p.KV, B, p.v_sb, p.v_sh, p.v_ss,
                     C::BN);
    if (err != cudaSuccess) return err;
  }
  auto kernel = p.q_off ? flash_fwd_wgmma_kernel<HD, true>
                        : flash_fwd_wgmma_kernel<HD, false>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmemBytes);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((p.Sq + C::BM - 1) / C::BM) * p.H * B;
  if (blocks >= (1ll << 31)) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kWgThreads, C::kSmemBytes, st>>>(tq, tk, tv, to,
                                                               p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32(const Params& p, int B, cudaStream_t st) {
  const int bytes = f32_smem_bytes<HD>();
  auto kernel = p.q_off ? flash_fwd_f32_kernel<HD, true>
                        : flash_fwd_f32_kernel<HD, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBlockQ - 1) / kBlockQ, p.H, B);
  kernel<<<grid, kThreads, bytes, st>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(int dtype, const Params& p, int B, cudaStream_t st) {
  return dtype == 0 ? launch_f32<HD>(p, B, st) : launch_wgmma<HD>(p, B, st);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and o share it).  hd: 64, 128 or
// 256.  strides: 12 element strides, (batch, head, seq) of q, k, v, o in
// that order; the head dim is contiguous (bfloat16: base and strides
// 16-byte aligned, TMA's rule).
// q (B, H, Sq, hd), k/v (B, KV, Skv, hd), o (B, H, Sq, hd).  window <= 0
// means none.  q_off >= 0: query row r sits at position r + q_off.
extern "C" int flash_attention_fwd_launch(int dtype, int hd, const void* q,
                                          const void* k, const void* v,
                                          void* o, const long long* strides,
                                          int B, int H, int KV, int Sq,
                                          int Skv, int causal, int window,
                                          int q_off, float scale,
                                          void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  if (KV <= 0 || H % KV != 0 || Skv < 0 || q_off < 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_sb = strides[0];
  p.q_sh = strides[1];
  p.q_ss = strides[2];
  p.k_sb = strides[3];
  p.k_sh = strides[4];
  p.k_ss = strides[5];
  p.v_sb = strides[6];
  p.v_sh = strides[7];
  p.v_ss = strides[8];
  p.o_sb = strides[9];
  p.o_sh = strides[10];
  p.o_ss = strides[11];
  p.B = B;
  p.H = H;
  p.KV = KV;
  p.Sq = Sq;
  p.Skv = Skv;
  p.causal = causal;
  p.window = window;
  p.q_off = q_off;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return (int)launch_hd<64>(dtype, p, B, st);
    case 128:
      return (int)launch_hd<128>(dtype, p, B, st);
    case 256:
      return (int)launch_hd<256>(dtype, p, B, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
