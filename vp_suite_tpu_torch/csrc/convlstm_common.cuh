// Pieces shared by the ConvLSTM scan kernels (convlstm_scan.cu, convlstm_scan_bwd.cu): the f32
// kernels' tile geometry, shared-memory padding and haloed patch load; the cooperative launch;
// and, on the generic pieces of hopper_common.cuh (copies, ldmatrix, wgmma), what both scans'
// bf16 kernels share: the 16x8 pixel tile, asynchronous copies into a ring of haloed patch
// stages, ldmatrix A fragments at a tap's offset, and the backward's resident weight slice in
// wgmma's shared-memory layout (the forward stages its own, gate-major, in convlstm_scan.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace convlstm {

using namespace hopper;

constexpr int TILE_W = 16;               // output pixels per tile row
constexpr int TILE_H = 4;                // output rows per tile
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

// ---- Hopper building blocks (sm_90a) ----------------------------------------------------------

// The pixel tile of both scans' bf16 kernels: 16x8 output pixels, one 64-pixel wgmma M block per
// warpgroup (four rows of 16), and its haloed 18x10 input patch.
constexpr int PT_W = 16;
constexpr int PT_H = 8;
constexpr int PT_HALO_W = PT_W + 2;
constexpr int PT_HALO_P = PT_HALO_W * (PT_H + 2);  // 180 haloed pixels
// A ring stage holds 32 channels (two k16 steps) of the haloed patch: of the backward's 4enc dz
// channels, a multiple of 64, so its stages are always full; of the forward's enc h channels, a
// multiple of 16, so where enc is an odd multiple of 16 the last stage holds 16 and zeros. Its
// rows are padded to 80 bytes, so the eight row addresses of an ldmatrix fall in eight different
// bank quads.
constexpr int STAGE_CH = 32;
constexpr int STAGE_LD = STAGE_CH + 8;
constexpr size_t STAGE_BYTES = align128(size_t(PT_HALO_P) * STAGE_LD * 2);

// Starts the copy of ring stage `chunk` of the tile at (bi, y0, x0): channels chunk*STAGE_CH ..
// +STAGE_CH-1 of the haloed PT_H x PT_W patch of `src` ([b, sh, sw, ld]), zeros outside the
// image and at channels ld and beyond, into `stage` ([PT_HALO_P][STAGE_LD]). STAGE_CH/8 16-byte
// copies per haloed pixel, over all threads.
__device__ __forceinline__ void load_stage_async(__nv_bfloat16* stage, const __nv_bfloat16* src,
                                                 int ld, int chunk, int bi, int y0, int x0, int sh,
                                                 int sw) {
  constexpr int PARTS = STAGE_CH / 8;
  for (int idx = threadIdx.x; idx < PARTS * PT_HALO_P; idx += blockDim.x) {
    const int hp = idx / PARTS, part = idx % PARTS;
    const int gy = y0 + hp / PT_HALO_W - 1, gx = x0 + hp % PT_HALO_W - 1;
    const int ch = chunk * STAGE_CH + part * 8;
    const bool in = gy >= 0 && gy < sh && gx >= 0 && gx < sw && ch < ld;
    const __nv_bfloat16* g = in ? src + ((size_t(bi) * sh + gy) * sw + gx) * ld + ch : src;
    cp_async16(stage + hp * STAGE_LD + part * 8, g, in);
  }
}

// Two adjacent bf16 values at element i of `base`, and as f32.
__device__ __forceinline__ uint32_t ld_u32(const void* base, size_t i) {
  return *reinterpret_cast<const uint32_t*>(static_cast<const __nv_bfloat16*>(base) + i);
}
__device__ __forceinline__ float2 bf2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// Pixel tile `tile` of a step, in the order (batch item, tile row, tile column), of a kernel
// whose parameters P give the tile counts.
template <typename P>
__device__ __forceinline__ TileIndex pixel_tile(int tile, const P& p) {
  const int tx = tile % p.tiles_x;
  tile /= p.tiles_x;
  return TileIndex{tile / p.tiles_y, (tile % p.tiles_y) * PT_H, tx * PT_W, 0};
}

// Launches `kernel(p)` cooperatively with `smem` bytes of dynamic shared memory: as many blocks
// as fit on the card at once, at most max_blocks, rounded down to a multiple of `multiple`.
template <typename K, typename P>
cudaError_t launch_cooperative(K kernel, size_t smem, int max_blocks, int multiple, P p,
                               int threads, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  int grid = max_blocks < per_sm * sms ? max_blocks : per_sm * sms;
  grid -= grid % multiple;
  if (grid < 1) return cudaErrorInvalidConfiguration;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid), dim3(threads),
                                    args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The A fragment of the k16 step at stage channel k0 for a warp's 16 output pixels (one tile
// row) at offset (oy, ox) into the haloed patch: output pixel (row, m) reads the patch at
// (row + oy, m + ox), so the conv's tap (dy, dx) is the offset (dy, dx). Lanes 0-15 address rows
// m = 0..15 at channels k0 .. k0+7, lanes 16-31 the same rows at k0+8 .. k0+15: the mma/wgmma A
// layout, a0..a3 = (m 0-7 | 8-15) x (k 0-7 | 8-15).
__device__ __forceinline__ void load_a_at(uint32_t (&a)[4], const __nv_bfloat16* stage, int row,
                                          int oy, int ox, int k0, int lane) {
  const int m = lane & 15;
  const int hp = (row + oy) * PT_HALO_W + m + ox;
  ldmatrix_x4(a, stage + hp * STAGE_LD + k0 + (lane >> 4) * 8);
}
// The same at tap (dy, dx) of the transposed conv, which reads the flipped tap (2 - dy, 2 - dx).
__device__ __forceinline__ void load_a_tap(uint32_t (&a)[4], const __nv_bfloat16* stage, int row,
                                           int dy, int dx, int k0, int lane) {
  load_a_at(a, stage, row, 2 - dy, 2 - dx, k0, lane);
}

// The backward's resident weights in wgmma's K-major, unswizzled shared-memory layout. For
// output-channel block j0 .. j0+NC-1 and all nine taps and 4enc input channels, the 8x8 core matrix
// (tap, input channels 8kq .. 8kq+7, output channels j0 + 8ng .. +7) is 128 contiguous bytes,
// one 16-byte row per output channel, at ((tap * KQ + kq) * NG + ng) * 128, KQ = 4enc/8,
// NG = NC/8: K-adjacent core matrices are NG*128 bytes apart (the descriptor's leading byte
// offset), N-adjacent ones 128 (its stride byte offset). `w` is [3, 3, enc, 4enc].
__device__ __forceinline__ void load_weights_async(__nv_bfloat16* sW, const __nv_bfloat16* w,
                                                   int enc, int j0, int nc) {
  const int kq_n = 4 * enc / 8, ng_n = nc / 8;
  const int total = 9 * kq_n * nc;  // one 16-byte row per (tap, kq, output channel)
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int n = idx % nc;
    const int kq = (idx / nc) % kq_n;
    const int tap = idx / (nc * kq_n);
    const __nv_bfloat16* src = w + (size_t(tap) * enc + j0 + n) * 4 * enc + kq * 8;
    cp_async16(sW + (((tap * kq_n + kq) * ng_n + n / 8) * 64 + (n % 8) * 8), src, true);
  }
}



}  // namespace convlstm
