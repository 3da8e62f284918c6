// Pieces shared by the ConvLSTM scan kernels (convlstm_scan.cu, convlstm_scan_bwd.cu): the tile
// geometry, per-type shared-memory padding, conversions and the haloed patch load; and the
// Hopper building blocks of the bf16 scan backward: asynchronous copies into a ring of haloed
// patch stages, ldmatrix fragments, weights resident in wgmma's shared-memory layout, and wgmma.
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

// ---- Hopper building blocks (sm_90a) ----------------------------------------------------------

// The pixel tile of the bf16 scan backward: 16x8 output pixels, one 64-pixel wgmma M block per
// warpgroup (four rows of 16), and its haloed 18x10 input patch.
constexpr int PT_W = 16;
constexpr int PT_H = 8;
constexpr int PT_HALO_W = PT_W + 2;
constexpr int PT_HALO_P = PT_HALO_W * (PT_H + 2);  // 180 haloed pixels
// A ring stage holds 32 of the 4enc dz channels (two k16 steps) of the haloed patch; its rows
// are padded to 80 bytes, so the eight row addresses of an ldmatrix fall in eight different bank
// quads. enc is a multiple of 16, so 4enc is one of 64 and stages never straddle its end.
constexpr int STAGE_CH = 32;
constexpr int STAGE_LD = STAGE_CH + 8;
constexpr size_t STAGE_BYTES = align128(size_t(PT_HALO_P) * STAGE_LD * 2);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared (L2 only); zero-fills the 16 bytes when !valid
// (src is then not read, but must be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts the copy of ring stage `chunk` of the tile at (bi, y0, x0): channels chunk*STAGE_CH ..
// +STAGE_CH-1 of the haloed PT_H x PT_W patch of `src` ([b, sh, sw, ld]), zeros outside the
// image, into `stage` ([PT_HALO_P][STAGE_LD]). STAGE_CH/8 16-byte copies per haloed pixel, over
// all threads.
__device__ __forceinline__ void load_stage_async(__nv_bfloat16* stage, const __nv_bfloat16* src,
                                                 int ld, int chunk, int bi, int y0, int x0, int sh,
                                                 int sw) {
  constexpr int PARTS = STAGE_CH / 8;
  for (int idx = threadIdx.x; idx < PARTS * PT_HALO_P; idx += blockDim.x) {
    const int hp = idx / PARTS, part = idx % PARTS;
    const int gy = y0 + hp / PT_HALO_W - 1, gx = x0 + hp % PT_HALO_W - 1;
    const bool in = gy >= 0 && gy < sh && gx >= 0 && gx < sw;
    const __nv_bfloat16* g =
        in ? src + ((size_t(bi) * sh + gy) * sw + gx) * ld + chunk * STAGE_CH + part * 8 : src;
    cp_async16(stage + hp * STAGE_LD + part * 8, g, in);
  }
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of row l%8 of matrix l/8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// The A fragment of the k16 step at stage channel k0 for a warp's 16 output pixels (one tile
// row) at tap (dy, dx) of the transposed conv: output pixel (row, m) reads the haloed patch at
// (row + 2 - dy, m + 2 - dx), the flipped tap. Lanes 0-15 address rows m = 0..15 at channels
// k0 .. k0+7, lanes 16-31 the same rows at k0+8 .. k0+15: the mma/wgmma A layout,
// a0..a3 = (m 0-7 | 8-15) x (k 0-7 | 8-15).
__device__ __forceinline__ void load_a_tap(uint32_t (&a)[4], const __nv_bfloat16* stage, int row,
                                           int dy, int dx, int k0, int lane) {
  const int m = lane & 15;
  const int hp = (row + 2 - dy) * PT_HALO_W + m + 2 - dx;
  ldmatrix_x4(a, stage + hp * STAGE_LD + k0 + (lane >> 4) * 8);
}

// Resident weights in wgmma's K-major, unswizzled shared-memory layout. For output-channel
// block j0 .. j0+NC-1 and all nine taps and 4enc input channels, the 8x8 core matrix
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

// wgmma shared-memory matrix descriptor, no swizzle: start address, leading byte offset (between
// K-adjacent core matrices) and stride byte offset (between M/N-adjacent ones), in 16-byte units.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return uint64_t((smem_u32(p) & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of an accumulator register across wgmma's fences.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x N] += A[64 x 16] * B[16 x N] over a warpgroup, bf16 in, f32 accumulators; A from
// registers (each warp its 16 rows, the mma.m16n8k16 A layout), B from shared memory through a
// K-major descriptor. Accumulator d[4j + 2h + e] of lane l holds row 16*warp + l/4 + 8h, column
// 8j + 2(l%4) + e.
template <int N>
struct Wgmma;
template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float (&d)[8], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <>
struct Wgmma<24> {
  static __device__ __forceinline__ void mma(float (&d)[12], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, %16, "
        "p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};
template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

}  // namespace convlstm
