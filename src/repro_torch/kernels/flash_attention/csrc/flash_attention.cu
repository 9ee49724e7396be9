// Grouped-query flash attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_fwd, _fa_kernel).  Its plain PyTorch version is
// src/repro_torch/kernels/flash_attention/ref.py, which this kernel is held
// to within the working type's tolerance (float32 2e-5, bfloat16 2e-2).
//
// What bounds it on an H100: operations.  At the LM slice's prefill shape
// (B = 4, H = 32, KV = 8, S = 1024, hd = 128, bfloat16, causal) the two
// products do 4 * B * H * S^2 * hd / 2 = 34.4 GFLOP, 0.035 ms at 989
// TFLOP/s; reading q, k, v once and writing o once moves 84 MB, 0.025 ms
// at 3.35 TB/s.
//
// Design, shared by both paths: one block per (batch, head, tile of 64
// query rows), heaviest causal tiles first; a loop inside the block walks
// the 64-key tiles of K and V in order (the Pallas grid's sequential KV
// axis), staging each tile in shared memory.  The running max, normaliser
// and output accumulator of each row stay in float32 registers (online
// softmax); the probabilities are rounded to v's type before the P.V
// product, as kernel.py:84-86 does, and the normaliser sums them unrounded.
// The KV head is h / (H / KV), so grouped query heads read one K/V stream,
// never a repeated one.  Causal, window (kpos > qpos - window) and the
// ragged tails of Sq and Skv are masked per element; whole tiles above the
// diagonal or older than the window are never loaded (kernel.py:49-58).  A
// fully masked row yields 0.  No atomics, a fixed key order: deterministic.
//
// bfloat16 (the LM's type) runs on the tensor cores: 4 warps, 16 query
// rows each; S = Q K^T and O += P V are mma.sync m16n8k16 bf16 products
// with float32 accumulators (bfloat16 products are exact in float32, as
// with the reference's preferred_element_type); Q, K and V fragments come
// from padded shared-memory rows by ldmatrix (V transposed); the score
// fragments, rounded to bfloat16, are P's A fragments directly, so P never
// touches shared memory.  float32 must stay exact float32 (tf32 would miss
// the 2e-5 tolerance), so it runs scalar FMAs: 8 warps of 8 rows, a lane
// scoring keys `lane` and `lane + 32` and owning output dims `lane + 32 j`,
// P passing through a warp-private slice of shared memory.  Neither path
// uses wgmma or TMA yet; that is later work.
//
// q, k, v and o are given by pointer and strides (the last dim
// contiguous), so the model's (B, S, heads, hd) tensors pass as transposed
// views; the bfloat16 path also needs 16-byte aligned rows (the wrapper
// copies a tensor that lacks them).  No fast-math: expf and division as
// written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;                      // query rows per block
constexpr int kBlockK = 64;                      // keys per KV tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_sh, q_ss;                    // element strides; dim
  long long k_sb, k_sh, k_ss;                    // stride is 1
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int H, KV, Sq, Skv;
  int causal;
  int window;                                    // <= 0: no window
  float scale;
};

// The KV tiles [begin, end) that some row of the query tile at q0 sees.
__device__ __forceinline__ int2 kv_tiles(const Params& p, int q0) {
  const int q_last = min(q0 + kBlockQ, p.Sq) - 1;
  int end = (p.Skv + kBlockK - 1) / kBlockK;
  if (p.causal) end = min(end, q_last / kBlockK + 1);
  int begin = 0;
  if (p.window > 0 && q0 - p.window + 1 > 0)
    begin = (q0 - p.window + 1) / kBlockK;
  return make_int2(begin, end);
}

__device__ __forceinline__ bool visible(const Params& p, int qr, int kc) {
  bool vis = kc < p.Skv;
  if (p.causal) vis = vis && kc <= qr;
  if (p.window > 0) vis = vis && kc > qr - p.window;
  return vis;
}

// ---------------------------------------------------------------------------
// bfloat16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;                     // 16 query rows each
constexpr int kMmaThreads = kMmaWarps * 32;

template <int HD>
constexpr int mma_smem_bytes() {
  return (kBlockQ + 2 * kBlockK) * (HD + 8) * 2;
}

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void ldsm_x4(const void* ptr, unsigned& r0,
                                        unsigned& r1, unsigned& r2,
                                        unsigned& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_addr(ptr)));
}

__device__ __forceinline__ void ldsm_x4_trans(const void* ptr, unsigned& r0,
                                              unsigned& r1, unsigned& r2,
                                              unsigned& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_addr(ptr)));
}

// d += a (16x16, row) . b (16x8, col), bfloat16 in, float32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], unsigned a0,
                                         unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// rows x HD of src (row stride `stride`, rows >= valid read as 0) into
// shared rows of HD + 8, 16 bytes at a time.
template <int HD>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long stride, int row0,
                                           int valid) {
  constexpr int kChunks = HD / 8;
  for (int i = threadIdx.x; i < 64 * kChunks; i += kMmaThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < valid)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * (HD + 8) + c) = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_mma_kernel(const Params p) {
  constexpr int RS = HD + 8;          // padded row: conflict-free ldmatrix
  constexpr int NT = HD / 8;          // output n-tiles of 8 dims
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* sK = sQ + kBlockQ * RS;
  __nv_bfloat16* sV = sK + kBlockK * RS;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;   // heavy first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;            // fragment row (and row + 8)
  const int t = lane & 3;             // fragment column pair
  const int wr = warp * 16;           // the warp's first row in the tile

  using bf16 = __nv_bfloat16;
  const bf16* Q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* K = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* V = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  bf16* O = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;

  stage_rows<HD>(sQ, Q, p.q_ss, q0, p.Sq);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int2 tiles = kv_tiles(p, q0);
  for (int kt = tiles.x; kt < tiles.y; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();                  // the previous tile is consumed
    stage_rows<HD>(sK, K, p.k_ss, k0, p.Skv);
    stage_rows<HD>(sV, V, p.v_ss, k0, p.Skv);
    __syncthreads();

    // S (16 rows x 64 keys per warp) = Q K^T: 8 n-tiles of 8 keys.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 32) {
      unsigned a[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
        ldsm_x4(sQ + (wr + (lane & 7) + ((lane >> 3) & 1) * 8) * RS + kk +
                    u * 16 + (lane >> 4) * 8,
                a[u][0], a[u][1], a[u][2], a[u][3]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        unsigned b0, b1, b2, b3;
        ldsm_x4(sK + (j * 8 + (lane & 7)) * RS + kk + (lane >> 3) * 8, b0,
                b1, b2, b3);
        mma_bf16(s[j], a[0][0], a[0][1], a[0][2], a[0][3], b0, b1);
        mma_bf16(s[j], a[1][0], a[1][1], a[1][2], a[1][3], b2, b3);
      }
    }

    // Online softmax over the fragment rows g and g + 8.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qr = q0 + wr + g + (i >> 1) * 8;
        const int kc = k0 + j * 8 + 2 * t + (i & 1);
        s[j][i] = visible(p, qr, kc) ? s[j][i] * p.scale : -INFINITY;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[j][i]);
      }
    float m_new[2], corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_new[r] = fmaxf(m[r], mx[r]);
      corr[r] = m_new[r] == -INFINITY ? 1.f : expf(m[r] - m_new[r]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = s[j][i];
        s[j][i] = x == -INFINITY ? 0.f : expf(x - m_new[i >> 1]);
        sum[i >> 1] += s[j][i];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * corr[r] + sum[r];
      m[r] = m_new[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // O += P V: the score fragments of n-tiles 2kk, 2kk + 1, rounded to
    // bfloat16, are the A fragment of keys 16kk..16kk+15.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const unsigned a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const unsigned a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const unsigned a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const unsigned a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        unsigned b0, b1, b2, b3;
        ldsm_x4_trans(sV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               RS + j * 8 + (lane >> 4) * 8,
                      b0, b1, b2, b3);
        mma_bf16(acc[j], a0, a1, a2, a3, b0, b1);
        mma_bf16(acc[j + 1], a0, a1, a2, a3, b2, b3);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qr = q0 + wr + g + r * 8;
    if (qr >= p.Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(acc[j][2 * r] / den,
                                                     acc[j][2 * r + 1] / den);
      *reinterpret_cast<__nv_bfloat162*>(O + qr * p.o_ss + j * 8 + 2 * t) = v;
    }
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

template <int HD>
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

  const int2 tiles = kv_tiles(p, q0);
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
        sc[c] = visible(p, qr, k0 + lane + 32 * c) ? s[rr][c] * p.scale
                                                   : -INFINITY;
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

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, int bytes, const Params& p,
                   int B, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBlockQ - 1) / kBlockQ, p.H, B);
  kernel<<<grid, threads, bytes, st>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(int dtype, const Params& p, int B, cudaStream_t st) {
  if (dtype == 0)
    return launch(flash_fwd_f32_kernel<HD>, kThreads, f32_smem_bytes<HD>(),
                  p, B, st);
  return launch(flash_fwd_mma_kernel<HD>, kMmaThreads, mma_smem_bytes<HD>(),
                p, B, st);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and o share it).  hd: 64, 128 or
// 256.  strides: 12 element strides, (batch, head, seq) of q, k, v, o in
// that order; the head dim is contiguous (bfloat16: rows 16-byte aligned).
// q (B, H, Sq, hd), k/v (B, KV, Skv, hd), o (B, H, Sq, hd).  window <= 0
// means none.
extern "C" int flash_attention_fwd_launch(int dtype, int hd, const void* q,
                                          const void* k, const void* v,
                                          void* o, const long long* strides,
                                          int B, int H, int KV, int Sq,
                                          int Skv, int causal, int window,
                                          float scale, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  if (KV <= 0 || H % KV != 0 || Skv < 0 || (dtype != 0 && dtype != 1))
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
  p.H = H;
  p.KV = KV;
  p.Sq = Sq;
  p.Skv = Skv;
  p.causal = causal;
  p.window = window;
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
