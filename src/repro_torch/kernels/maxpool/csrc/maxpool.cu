// 3x3 / stride-1 / pad-1 max, argmax and min pools for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/maxpool/kernel.py
// (_maxarg_kernel, launched by maxargmaxpool3x3 / maxpool3x3 / minpool3x3).
// Its plain PyTorch version is src/repro_torch/kernels/maxpool/ref.py,
// which this kernel must equal bitwise for every dtype and shape.
//
// What bounds it on an H100: memory.  Each output needs a 3x3 window and
// at most 8 compares; the least traffic is one read of each pixel and one
// write of each output, so maxargmaxpool3x3 at 4096^2 float32 moves
// n * (4 + 4 + 4) B = 201 MB, ~60 us at 3.35 TB/s.  So every pixel should
// leave device memory once, in wide coalesced accesses.
//
// Design: a 2-D grid of output tiles of 32 rows by 32 * VEC columns (VEC =
// 16 / sizeof(T): one 16-byte vector per thread), the batch index on
// blockIdx.z; no divisions on the inner path.  A block of 256 threads
// stages its tile plus a one-pixel halo in shared memory (16-byte loads
// where the image's base and rows allow it, scalar loads elsewhere), then
// each thread pools VEC consecutive columns of 4 rows.  It reads each
// staged row once, as one 16-byte vector, keeps a window of three rows in
// registers as it walks down, and takes the columns on either side from
// the neighbouring lanes by shuffle (the warp's end lanes from the halo).
// The window is pooled in two separable passes:
//   * vertical: for each column, the best of rows r-1, r, r+1;
//   * horizontal: for each output, the best of the vertical results of
//     columns c-1, c, c+1.
// Both orders reduce exactly in two passes because they are total orders,
// and both compare integer keys, one instruction a comparison:
//   * the pooled value orders -0.0 below +0.0 (`greater` in ref.py), as
//     jnp.maximum / jnp.minimum do: a float's key is its bits with the
//     magnitude bits of a negative value flipped, an integer is its own
//     key; equal keys have equal bits, and the key maps back to them;
//   * the argmax orders (value, flat index): plain > / ==, so its key
//     also ties -0.0 with +0.0, and a tie goes to the larger flat index.
//     The vertical pass keeps the largest row among tied cells; the
//     horizontal pass compares full flat indices (row * W + col), so a
//     tied cell at row r+1 of the left column beats one at row r of the
//     right column.
// Out-of-image cells are skipped by their position, never compared against
// a fill value: uint8's 0 and int32's minimum are real pixel values, and
// the reference's argmax never picks a cell outside the image (halo cells
// outside the image are left unwritten in shared memory and never win).
// Each thread stores its VEC values and VEC argmaxes with 16-byte stores
// where aligned, scalar stores at a ragged right edge.  Templated on dtype,
// on max/min and on whether the argmax is written.
//
// No fast-math: bfloat16 widens exactly to float32 and subnormals keep
// their order, as in the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;      // 32 column groups x 8 row groups
constexpr int kRowsPerThread = 4;
constexpr int kTileRows = 8 * kRowsPerThread;

// The pooled value's key: the order of `greater` (-0.0 below +0.0) as a
// signed integer order, and back.
__device__ __forceinline__ int pool_key(float x) {
  const int bits = __float_as_int(x);
  return bits ^ ((bits >> 31) & 0x7fffffff);
}
__device__ __forceinline__ int pool_key(__nv_bfloat16 x) {
  return pool_key(__bfloat162float(x));          // exact
}
__device__ __forceinline__ int pool_key(uint8_t x) { return x; }
__device__ __forceinline__ int pool_key(int16_t x) { return x; }
__device__ __forceinline__ int pool_key(int32_t x) { return x; }

template <typename T>
__device__ __forceinline__ T from_pool_key(int k) {
  return static_cast<T>(k);
}
template <>
__device__ __forceinline__ float from_pool_key<float>(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_pool_key<__nv_bfloat16>(int k) {
  return __float2bfloat16(from_pool_key<float>(k));   // exact
}

// The argmax's key from the pooled value's: plain > and ==, so -0.0 (pool
// key -1) ties +0.0 (0).
template <typename T>
__device__ __forceinline__ int arg_key(int pool) {
  return std::is_integral<T>::value || pool != -1 ? pool : 0;
}

// Four blocks an SM (64 registers) for 4-byte types; the 8- and 16-wide
// vectors of the narrower types need more registers.
template <typename T, bool kMin, bool kArg>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 4 : 2)
    pool3x3_kernel(const T* __restrict__ img, int batch, int H, int W,
                   int load_vec, int store_vec, T* __restrict__ val,
                   int* __restrict__ arg) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int TW = 32 * VEC;             // tile columns
  constexpr int RS = TW + 2 * VEC;         // shared row: halo, tile, halo
  __shared__ __align__(16) T tile[kTileRows + 2][RS];

  const int c0 = blockIdx.x * TW;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const long long n = (long long)H * W;
  const int row_tiles = (H + kTileRows - 1) / kTileRows;

  // Grid-stride over images and row tiles past the grid's y and z limits.
  for (int b = blockIdx.z; b < batch; b += gridDim.z)
  for (int rt = blockIdx.y; rt < row_tiles; rt += gridDim.y) {
    const T* im = img + b * n;
    const int r0 = rt * kTileRows;
    if (b != (int)blockIdx.z || rt != (int)blockIdx.y)
      __syncthreads();                         // the last tile is read

    // Stage rows r0-1 .. r0+kTileRows of columns c0 .. c0+TW-1 (tile
    // column VEC + c), then the halo columns c0-1 and c0+TW.
    for (int i = threadIdx.x; i < (kTileRows + 2) * 32; i += kThreads) {
      const int tr = i >> 5;
      const int gr = r0 - 1 + tr;
      const int gc = c0 + (i & 31) * VEC;
      if (gr < 0 || gr >= H || gc >= W) continue;
      T* dst = &tile[tr][VEC + (i & 31) * VEC];
      const T* src = im + (long long)gr * W + gc;
      if (load_vec && gc + VEC <= W) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          if (gc + e < W) dst[e] = src[e];
      }
    }
    for (int i = threadIdx.x; i < 2 * (kTileRows + 2); i += kThreads) {
      const int tr = i >> 1;
      const int gr = r0 - 1 + tr;
      const int gc = (i & 1) ? c0 + TW : c0 - 1;
      if (gr < 0 || gr >= H || gc < 0 || gc >= W) continue;
      tile[tr][(i & 1) ? VEC + TW : VEC - 1] = im[(long long)gr * W + gc];
    }
    __syncthreads();

    // Each lane pools columns cb .. cb+VEC-1 of rows r0 + 4 ty .. + 3.
    // Its window holds the keys of rows r-1, r, r+1 of columns cb-1 ..
    // cb+VEC: the lane's own 16 bytes of each row, the neighbours' edge
    // keys by shuffle, and at the warp's two ends the tile's halo columns.
    const int cb = c0 + tx * VEC;              // this thread's first column
    int pk[3][VEC + 2];                        // pooled-value keys
    auto load_row = [&](int (&p)[VEC + 2], int tr) {
      const uint4 v =
          *reinterpret_cast<const uint4*>(&tile[tr][VEC + tx * VEC]);
      T raw[VEC];
      memcpy(raw, &v, 16);
#pragma unroll
      for (int e = 0; e < VEC; ++e) p[1 + e] = pool_key(raw[e]);
      T halo = raw[0];
      if (tx == 0) halo = tile[tr][VEC - 1];
      if (tx == 31) halo = tile[tr][VEC + TW];
      p[0] = __shfl_up_sync(0xffffffffu, p[VEC], 1);   // lane tx-1's last
      p[VEC + 1] = __shfl_down_sync(0xffffffffu, p[1], 1);  // tx+1's first
      if (tx == 0) p[0] = pool_key(halo);
      if (tx == 31) p[VEC + 1] = pool_key(halo);
    };
    load_row(pk[0], ty * kRowsPerThread);
    load_row(pk[1], ty * kRowsPerThread + 1);
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int tr = 1 + ty * kRowsPerThread + k;
      const int r = r0 + tr - 1;
      if (r >= H) break;                       // warp-uniform
      const int up = k % 3, mid = (k + 1) % 3, down = (k + 2) % 3;
      load_row(pk[down], tr + 1);
      const bool up_in = r > 0, down_in = r + 1 < H;
      // Vertical pass over columns cb-1 .. cb+VEC: the pooled key, and the
      // argmax's key and row (a row outside the image never takes part).
      int vp[VEC + 2], va[VEC + 2], vr[VEC + 2];
#pragma unroll
      for (int j = 0; j < VEC + 2; ++j) {
        int p = pk[mid][j], a = arg_key<T>(p), row = r;
        if (up_in) {
          p = kMin ? min(p, pk[up][j]) : max(p, pk[up][j]);
          const int a_up = arg_key<T>(pk[up][j]);
          if (a_up > a) {                      // row r-1 wins only above
            a = a_up;
            row = r - 1;
          }
        }
        if (down_in) {
          p = kMin ? min(p, pk[down][j]) : max(p, pk[down][j]);
          const int a_down = arg_key<T>(pk[down][j]);
          if (a_down >= a) {                   // row r+1 also wins a tie
            a = a_down;
            row = r + 1;
          }
        }
        vp[j] = p;
        va[j] = a;
        vr[j] = row;
      }
      // Horizontal pass: output cb+i from columns cb+i-1, cb+i, cb+i+1,
      // a column outside the image never taking part.
      uint4 packed;                            // VEC values, 16 bytes
      T* out = reinterpret_cast<T*>(&packed);
      int idx[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const int gc = cb + i;
        int p = vp[i + 1], a = va[i + 1], best = vr[i + 1] * W + gc;
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          const int j = side ? i + 2 : i;
          const int cc = side ? gc + 1 : gc - 1;
          if (cc < 0 || cc >= W) continue;
          p = kMin ? min(p, vp[j]) : max(p, vp[j]);
          const int ci = vr[j] * W + cc;
          if (kArg && (va[j] > a || (va[j] == a && ci > best))) {
            a = va[j];
            best = ci;
          }
        }
        out[i] = from_pool_key<T>(p);
        idx[i] = best;
      }
      if (cb >= W) continue;                   // a lane past the image
      const long long o = (long long)r * W + cb + b * n;
      if (store_vec && cb + VEC <= W) {
        *reinterpret_cast<uint4*>(val + o) = packed;
        if (kArg) {
#pragma unroll
          for (int q = 0; q < VEC; q += 4)
            *reinterpret_cast<int4*>(arg + o + q) =
                make_int4(idx[q], idx[q + 1], idx[q + 2], idx[q + 3]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          if (cb + i < W) {
            val[o + i] = out[i];
            if (kArg) arg[o + i] = idx[i];
          }
      }
    }
  }
}

template <typename T>
cudaError_t launch_typed(int mode, const void* image, int batch, int H,
                         int W, void* val, void* arg, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const int row_tiles = (H + kTileRows - 1) / kTileRows;
  const dim3 grid((W + 32 * VEC - 1) / (32 * VEC),
                  row_tiles < 65535 ? row_tiles : 65535,
                  batch < 65535 ? batch : 65535);
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int rows_vec = W % VEC == 0;
  const int load_vec = rows_vec && aligned(image);
  const int store_vec =
      rows_vec && aligned(val) && (mode != 0 || aligned(arg));
  const T* im = static_cast<const T*>(image);
  T* out = static_cast<T*>(val);
  int* ai = static_cast<int*>(arg);
  switch (mode) {
    case 0:
      pool3x3_kernel<T, false, true><<<grid, kThreads, 0, st>>>(
          im, batch, H, W, load_vec, store_vec, out, ai);
      break;
    case 1:
      pool3x3_kernel<T, false, false><<<grid, kThreads, 0, st>>>(
          im, batch, H, W, load_vec, store_vec, out, ai);
      break;
    case 2:
      pool3x3_kernel<T, true, false><<<grid, kThreads, 0, st>>>(
          im, batch, H, W, load_vec, store_vec, out, ai);
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
  if ((long long)batch * H * W == 0) return 0;
  switch (dtype) {
    case 0:
      return (int)launch_typed<uint8_t>(mode, image, batch, H, W, val, arg,
                                        st);
    case 1:
      return (int)launch_typed<int16_t>(mode, image, batch, H, W, val, arg,
                                        st);
    case 2:
      return (int)launch_typed<int32_t>(mode, image, batch, H, W, val, arg,
                                        st);
    case 3:
      return (int)launch_typed<float>(mode, image, batch, H, W, val, arg, st);
    case 4:
      return (int)launch_typed<__nv_bfloat16>(mode, image, batch, H, W, val,
                                              arg, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* maxpool_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
