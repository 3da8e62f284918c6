// Pieces shared by the ConvLSTM scan kernels (convlstm_scan.cu, convlstm_scan_bwd.cu): the tile
// geometry, per-type shared-memory padding, conversions and the haloed patch load.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace convlstm {

constexpr int TILE_W = 16;               // output pixels per tile row (one WMMA row block)
constexpr int TILE_H = 4;                // output rows per tile
constexpr int TILE_P = TILE_W * TILE_H;  // 64 output pixels
constexpr int HALO_W = TILE_W + 2;
constexpr int HALO_H = TILE_H + 2;
constexpr int HALO_P = HALO_W * HALO_H;  // 108 haloed input pixels
constexpr int JC = 16;                   // hidden channels per tile
constexpr int THREADS = 256;             // 8 warps; thread (r, cc) owns pixel column r, channel cc

template <typename T> struct Traits;
template <> struct Traits<float> {
  static constexpr int PAD = 4;   // shared-memory row padding in elements (rows stay 16-byte aligned)
  static constexpr int VEC = 4;   // elements per 16-byte load
};
template <> struct Traits<__nv_bfloat16> {
  static constexpr int PAD = 16;  // rows stay 32-byte aligned, as WMMA loads require
  static constexpr int VEC = 8;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

// Tile `tile` of a step, in the order (batch item, tile row, tile column, channel block).
struct TileIndex {
  int bi, y0, x0, j0;
};
__device__ __forceinline__ TileIndex tile_index(int tile, int tiles_x, int tiles_y, int tiles_j) {
  const int tj = tile % tiles_j;
  tile /= tiles_j;
  const int tx = tile % tiles_x;
  tile /= tiles_x;
  const int ty = tile % tiles_y;
  return TileIndex{tile / tiles_y, ty * TILE_H, tx * TILE_W, tj * JC};
}

// Loads the haloed HALO_H x HALO_W patch around the tile at (y0, x0) into sA (row stride lda):
// `width` channels starting at channel `c0` of an image `src` with `ld` channels per pixel; zeros
// outside the image.
template <typename T>
__device__ __forceinline__ void load_patch(T* sA, int lda, const T* src, int ld, int c0, int width,
                                           int y0, int x0, int sh, int sw) {
  constexpr int V = Traits<T>::VEC;
  const int vec_per_px = width / V;
  for (int idx = threadIdx.x; idx < HALO_P * vec_per_px; idx += THREADS) {
    const int hp = idx / vec_per_px, v = idx % vec_per_px;
    const int gy = y0 + hp / HALO_W - 1, gx = x0 + hp % HALO_W - 1;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < sh && gx >= 0 && gx < sw)
      val = *reinterpret_cast<const uint4*>(src + (size_t(gy) * sw + gx) * ld + c0 + v * V);
    *reinterpret_cast<uint4*>(sA + hp * lda + v * V) = val;
  }
}

}  // namespace convlstm
