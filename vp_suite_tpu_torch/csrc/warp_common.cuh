// Pieces shared by the warp kernels (warp_sample.cu, warp_ret.cu, warp_contract.cu): type
// conversions, the four bilinear taps of a sample, the f32 bodies' product into a 64x64 f32 tile on
// FMAs, and the device's limits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace warpk {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The four taps of one sample in the order (y0,x0), (y0,x1), (y1,x0), (y1,x1): pixel offsets into the
// batch item's image, whether each lies inside it, and weights wy*wx*valid.
struct Taps {
  int off[4];
  bool valid[4];
  float wt[4];
  float wy0, wy1, wx0, wx1;
};

__device__ __forceinline__ Taps make_taps(float iy, float ix, int h, int w) {
  Taps t;
  const float fy = floorf(iy), fx = floorf(ix);
  t.wy1 = iy - fy;
  t.wy0 = 1.0f - t.wy1;
  t.wx1 = ix - fx;
  t.wx0 = 1.0f - t.wx1;
  const bool vy0 = fy >= 0.0f && fy <= float(h - 1);
  const bool vy1 = fy + 1.0f >= 0.0f && fy + 1.0f <= float(h - 1);
  const bool vx0 = fx >= 0.0f && fx <= float(w - 1);
  const bool vx1 = fx + 1.0f >= 0.0f && fx + 1.0f <= float(w - 1);
  // integer indices only where they lie in the image: a far flow's floor need not fit an int
  const int y0 = vy0 ? int(fy) : 0, y1 = vy1 ? int(fy) + 1 : 0;
  const int x0 = vx0 ? int(fx) : 0, x1 = vx1 ? int(fx) + 1 : 0;
  t.valid[0] = vy0 && vx0;
  t.valid[1] = vy0 && vx1;
  t.valid[2] = vy1 && vx0;
  t.valid[3] = vy1 && vx1;
  t.off[0] = y0 * w + x0;
  t.off[1] = y0 * w + x1;
  t.off[2] = y1 * w + x0;
  t.off[3] = y1 * w + x1;
  const float wy[4] = {t.wy0, t.wy0, t.wy1, t.wy1}, wx[4] = {t.wx0, t.wx1, t.wx0, t.wx1};
#pragma unroll
  for (int k = 0; k < 4; ++k) t.wt[k] = wy[k] * wx[k] * (t.valid[k] ? 1.0f : 0.0f);
  return t;
}

// ---- the 64x64 tile product of the f32 bodies (warp_ret.cu, warp_contract.cu) ----------------
//
// C[i, j] += sum_k A(i, k) * B(k, j) for i, j < 64, with the operands in shared memory: A(i, k) is
// sA[i*lda + k] (A_COL false) or sA[k*lda + i] (A_COL true), B(k, j) is sB[k*ldb + j] (B_COL false)
// or sB[j*ldb + k] (B_COL true), the arrays 128-byte aligned. The sum stays in registers across
// calls; tile_store writes it to shared memory. (The bf16 kernels are wgmma kernels of their own.)

constexpr int TILE = 64;
constexpr int TILE_THREADS = 256;
constexpr int LDC = TILE + 4;  // row stride of the f32 tile in shared memory

template <typename T> struct Pad;
template <> struct Pad<float> { static constexpr int value = 4; };  // rows 16-byte aligned

__host__ __device__ constexpr int round_up(int n, int m) { return (n + m - 1) / m * m; }
__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

template <typename T> struct TileAcc;
// f32: thread (r, cc) = (tid / 16, tid % 16) holds rows r + 16m and columns cc + 16q.
template <> struct TileAcc<float> { float v[4][4]; };
__device__ __forceinline__ void tile_zero(TileAcc<float>& acc) {
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc.v[m][q] = 0.0f;
}

template <bool A_COL, bool B_COL>
__device__ __forceinline__ void tile_mma(const float* sA, int lda, const float* sB, int ldb, int K,
                                         TileAcc<float>& acc) {
  const int r = threadIdx.x / 16, cc = threadIdx.x % 16;
  for (int k = 0; k < K; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) a[m] = A_COL ? sA[k * lda + r + 16 * m] : sA[(r + 16 * m) * lda + k];
#pragma unroll
    for (int q = 0; q < 4; ++q) b[q] = B_COL ? sB[(cc + 16 * q) * ldb + k] : sB[k * ldb + cc + 16 * q];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc.v[m][q] = fmaf(a[m], b[q], acc.v[m][q]);
  }
}

// Writes the tile to sC [64][LDC] f32. The caller synchronises before reading it.
__device__ __forceinline__ void tile_store(const TileAcc<float>& acc, float* sC) {
  const int r = threadIdx.x / 16, cc = threadIdx.x % 16;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q) sC[(r + 16 * m) * LDC + cc + 16 * q] = acc.v[m][q];
}

// Allows `bytes` of dynamic shared memory for `kernel` and launches it on `grid` blocks; returns the
// launch's error.
template <typename... KernelArgs, typename... Args>
cudaError_t launch_tiles(void (*kernel)(KernelArgs...), int64_t grid, size_t bytes,
                         cudaStream_t stream, Args... args) {
  if (grid <= 0 || grid > 0x7fffffff) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<unsigned(grid), TILE_THREADS, bytes, stream>>>(args...);
  return cudaGetLastError();
}

// The current device's SM count, the shared memory a block may opt into and an SM's shared memory.
inline cudaError_t device_limits(int* sms, int* smem_max, int* smem_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  return err;
}

inline int finish(cudaError_t err) {
  if (err != cudaSuccess) cudaGetLastError();  // clear it, so later launches do not report it
  return int(err);
}

}  // namespace warpk
