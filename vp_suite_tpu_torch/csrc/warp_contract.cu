// Warp by prebuilt factor matrices, for Hopper (sm_90a): forward and backward.
//
// Replaces the JAX package's TPU kernels in ops/pallas_warp.py, reached through warp_contract: the
// forward _warp_kernel (K9a, through _warp_contract_pallas), and the backward _warp_bwd_dimg_kernel
// (K9b) and _warp_bwd_dab_kernel (K9c), both through _warp_bwd_pallas.
//
// Function, for batch item bi, flow l, output pixel p and channel c, with any real factors A, Bm:
//   out[bi, l, p, c] = sum_{y, x} A[bi, l, p, y] * Bm[bi, l, p, x] * img[bi, y, x, c]
// i.e. one GEMM per batch item against M[r, q] = A[r, y] * Bm[r, x], rows r = (l, p), columns
// q = y*w + x. M is formed in the input type (a bf16 product is rounded, as the TPU kernel forms
// it), products are summed in f32 and out is rounded once. The backward, from g = d out [b, L, P, c]:
//   d_img[bi, y, x, c] = sum_{l, p} M[p, (y, x)] * g[bi, l, p, c]          (K9b)
//   T_y[p, x] = sum_c g[p, c] * img[y, x, c]                               (f32)
//   d_A[p, y] = sum_x Bm[p, x] * T_y[p, x],  d_Bm[p, x] = sum_y A[p, y] * T_y[p, x]   (K9c)
// all in f32, rounded once to the inputs' type.
//
// Layout, the JAX package's: A [b, L, P, h], Bm [b, L, P, w], img [b, h, w, c], out and g
// [b, L, P, c], all of one type.
//
// Bound: operations. The forward is 2*b*L*P*h*w*c operations, 0.89 TFLOP at b=32, L=13, 64x64,
// c=64 (0.90 ms of bf16 tensor time), against some 650 MB of A, Bm and out in bf16; the backward
// twice that. No atomics in either type: every output element is owned by one block, so all three
// results are the same from run to run.
//
// bf16 (the Hopper design): three GEMMs whose factor-product operand never exists in memory.
// Threads: two warpgroups. Each block streams its batch item's image (the forward, d_A/d_Bm) or its
// g (d_img) from L2 through a ring of STAGES = 4 stages filled by cp.async, in the shared-memory
// layouts wgmma reads through descriptors, and multiplies on wgmma (m64nNk16, f32 accumulators).
// What one block streams is fixed by the item, so blocks are as tall as the registers allow, and
// the blocks of one item run next to each other in launch order (its image is 512 KB at 64x64x64,
// all 32 items' 16 MB, within the 50 MB L2).
// - Forward (K9a): a block per (item, tile of 256 rows r, or 128 at c > 96; channel pass of up to
//   128 channels): N = the pass's channels, padded to 16/32/64/96/128; K = q in slabs of 64
//   consecutive image pixels, [64][N] as they lie in memory, so B is MN-major (wgmma's transpose
//   bit). The A operand is built in registers in the m16n8k16 layout: where w is 16, 32 or 64, a
//   thread's fragment columns keep their image column x from slab to slab, so its Bm pairs stay in
//   registers for the whole block (w/2 of them at two m64 tiles) and each k16 step reads one A
//   value per row from the block's A tile (staged once in shared memory) and forms 8 products by
//   __hmul2; for any other w each element is gathered (A from the tile, Bm from global memory).
//   The products run software-pipelined (slab_loop): slab u's fragments are built while slab
//   u-1's wgmmas run. The epilogue rounds the accumulators to bf16 pairs in registers and stores
//   them to out. L2 traffic: 13,312 blocks x 512 KB = 6.8 GB per call at 64x64x64 with 128-row
//   blocks; 3.5 GB with these 256-row blocks (two m64 tiles per warpgroup).
// - d_img (K9b): a block per (item, tile of 256 image pixels q, or 128 at c > 96; channel pass),
//   K = all L*P rows r in slabs of 64 (g's slab is MN-major B, as the forward's image slab).
//   Where w is 16, 32 or 64 and h % 8 == 0, a warp's 16 pixels lie on one image row, the ring also
//   carries the slab's Bm rows and the A columns of the block's image rows, and M^T's fragment is
//   ldmatrix.trans of the Bm rows scaled by the A pair of its columns (__hmul2); otherwise each
//   element is gathered from global memory. The same pipelined slab loop as the forward's. g per
//   item is L*P*c*2 = 6.8 MB at 64x64x64, read by every pixel tile, and so are the Bm rows: 7.2 GB
//   per call with 256-pixel tiles.
// - d_A and d_Bm (K9c): a block per (item, 128 rows r); for each image row y, T_y = g img_y^T on
//   wgmma (M = rows, N = w padded to 16/32/64/96/128, K = c in chunks of up to 128; the image row is
//   K-major B), g's fragments held in registers across y, and YR image rows (2 at N = 64, else
//   1) a ring stage, so that one barrier and one wgmma wait serve YR rows. The epilogue stays
//   in registers: Bm's pairs and the d_Bm sums in the accumulators' layout, d_A[r, y] a quad
//   reduction by two shuffles, stored into the A tile in place of the A value it replaces and
//   written out once at the end. 7.0 GB of image rows from L2 per call at 64x64x64.
// On an H100 the ring's copies, not the products, set the pace of all three (PERF.md, Findings).
// Every shape has a plan (c a multiple of 8 and 16-byte-aligned operands: the wrappers pad c and
// copy unaligned operands). Where h is too tall for the forward's A tile beside its ring (some
// 436 rows at 256-row blocks), the block stages the tile in parts of yc columns and walks each
// part's slabs; where w > 128, or d_A / d_Bm's g or A tile does not fit (c or h too large),
// d_A / d_Bm take the general kernel (contract_dab_general_bf16_kernel: column chunks of 128,
// channel chunks of g staged one at a time, A read from global memory), whose sums of several
// parts go through f32 scratch that the wrapper allocates. The layer shapes keep the tuned
// branches above.
//
// f32 keeps the first port's FMA bodies: a 64x64 f32 tile per block built in shared memory from the
// factors, 64 rows at a time (warp_common.cuh). wgmma has no f32 x f32 form, only tf32, whose
// 10-bit mantissas would break the f32 tolerance (5e-5 of the largest) that the plain versions are
// held to.
#include <algorithm>

#include "hopper_common.cuh"
#include "warp_common.cuh"

namespace {

using namespace hopper;
using namespace warpk;

// ---- f32: the first port's FMA bodies, unchanged (templates, now instantiated for float only) ----

struct FacDims {
  int b, L, P, h, w, c;
};

template <typename T>
struct FwdLayout {
  int wpad, ldm, ldi;
  size_t m, img, c, bytes;
  __host__ __device__ explicit FwdLayout(int w) {
    wpad = round_up(w, 16);
    ldm = wpad + Pad<T>::value;
    ldi = TILE + Pad<T>::value;
    m = 0;
    img = m + align128(size_t(TILE) * ldm * sizeof(T));
    c = img + align128(size_t(wpad) * ldi * sizeof(T));
    bytes = c + align128(size_t(TILE) * LDC * sizeof(float));
  }
};

template <typename T>
__global__ void __launch_bounds__(TILE_THREADS)
    contract_fwd_kernel(const T* __restrict__ A, const T* __restrict__ Bm, const T* __restrict__ img,
                        T* __restrict__ out, FacDims d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdLayout<T> lay(d.w);
  T* sM = reinterpret_cast<T*>(smem + lay.m);
  T* sI = reinterpret_cast<T*>(smem + lay.img);
  float* sC = reinterpret_cast<float*>(smem + lay.c);

  const int n_cc = (d.c + TILE - 1) / TILE, n_pt = (d.P + TILE - 1) / TILE;
  int id = blockIdx.x;
  const int c0 = (id % n_cc) * TILE;
  id /= n_cc;
  const int p0 = (id % n_pt) * TILE;
  const int bl = id / n_pt, bi = bl / d.L;   // bl = bi * L + l
  const size_t row0 = size_t(bl) * d.P;      // row of (bi, l, p = 0) in A, Bm and out

  TileAcc<T> acc;
  tile_zero(acc);
  for (int y = 0; y < d.h; ++y) {
    __syncthreads();  // the previous row's product is done with shared memory
    for (int idx = threadIdx.x; idx < TILE * lay.wpad; idx += TILE_THREADS) {
      const int i = idx / lay.wpad, x = idx % lay.wpad, p = p0 + i;
      float v = 0.0f;
      if (p < d.P && x < d.w) v = to_f(A[(row0 + p) * d.h + y]) * to_f(Bm[(row0 + p) * d.w + x]);
      sM[i * lay.ldm + x] = from_f<T>(v);
    }
    for (int idx = threadIdx.x; idx < lay.wpad * TILE; idx += TILE_THREADS) {
      const int x = idx / TILE, j = idx % TILE;
      sI[x * lay.ldi + j] = x < d.w && c0 + j < d.c
                                ? img[((size_t(bi) * d.h + y) * d.w + x) * d.c + c0 + j]
                                : from_f<T>(0.0f);
    }
    __syncthreads();
    tile_mma<false, false>(sM, lay.ldm, sI, lay.ldi, lay.wpad, acc);
  }
  tile_store(acc, sC);
  __syncthreads();
  for (int idx = threadIdx.x; idx < TILE * TILE; idx += TILE_THREADS) {
    const int i = idx / TILE, j = idx % TILE, p = p0 + i;
    if (p < d.P && c0 + j < d.c) out[(row0 + p) * d.c + c0 + j] = from_f<T>(sC[i * LDC + j]);
  }
}

template <typename T>
struct DimgLayout {
  int ld;
  size_t m, g, c, bytes;
  __host__ __device__ DimgLayout() {
    ld = TILE + Pad<T>::value;
    m = 0;
    g = m + align128(size_t(TILE) * ld * sizeof(T));
    c = g + align128(size_t(TILE) * ld * sizeof(T));
    bytes = c + align128(size_t(TILE) * LDC * sizeof(float));
  }
};

template <typename T>
__global__ void __launch_bounds__(TILE_THREADS)
    contract_bwd_img_kernel(const T* __restrict__ A, const T* __restrict__ Bm,
                            const T* __restrict__ g, T* __restrict__ d_img, FacDims d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const DimgLayout<T> lay;
  T* sM = reinterpret_cast<T*>(smem + lay.m);   // sM[p][i] = M[p, image pixel q0 + i]
  T* sG = reinterpret_cast<T*>(smem + lay.g);
  float* sC = reinterpret_cast<float*>(smem + lay.c);

  const int hw = d.h * d.w;
  const int n_cc = (d.c + TILE - 1) / TILE, n_q = (hw + TILE - 1) / TILE;
  int id = blockIdx.x;
  const int c0 = (id % n_cc) * TILE;
  id /= n_cc;
  const int q0 = (id % n_q) * TILE;
  const int bi = id / n_q;

  TileAcc<T> acc;
  tile_zero(acc);
  for (int l = 0; l < d.L; ++l) {
    const size_t row0 = (size_t(bi) * d.L + l) * d.P;
    for (int p0 = 0; p0 < d.P; p0 += TILE) {
      __syncthreads();  // the previous tile's product is done with shared memory
      for (int idx = threadIdx.x; idx < TILE * TILE; idx += TILE_THREADS) {
        const int k = idx / TILE, i = idx % TILE, p = p0 + k, q = q0 + i;
        float v = 0.0f;
        if (p < d.P && q < hw)
          v = to_f(A[(row0 + p) * d.h + q / d.w]) * to_f(Bm[(row0 + p) * d.w + q % d.w]);
        sM[k * lay.ld + i] = from_f<T>(v);
        const int j = i;
        sG[k * lay.ld + j] =
            p < d.P && c0 + j < d.c ? g[(row0 + p) * d.c + c0 + j] : from_f<T>(0.0f);
      }
      __syncthreads();
      tile_mma<true, false>(sM, lay.ld, sG, lay.ld, TILE, acc);
    }
  }
  tile_store(acc, sC);
  __syncthreads();
  for (int idx = threadIdx.x; idx < TILE * TILE; idx += TILE_THREADS) {
    const int i = idx / TILE, j = idx % TILE, q = q0 + i;
    if (q < hw && c0 + j < d.c)
      d_img[(size_t(bi) * hw + q) * d.c + c0 + j] = from_f<T>(sC[i * LDC + j]);
  }
}

template <typename T>
struct DabLayout {
  int cpad, ld;
  size_t g, img, c, dbm, bytes;
  __host__ __device__ DabLayout(int w, int c_) {
    cpad = round_up(c_, 16);
    ld = cpad + Pad<T>::value;
    g = 0;
    img = g + align128(size_t(TILE) * ld * sizeof(T));
    c = img + align128(size_t(TILE) * ld * sizeof(T));
    dbm = c + align128(size_t(TILE) * LDC * sizeof(float));
    bytes = dbm + align128(size_t(TILE) * w * sizeof(float));
  }
};

template <typename T>
__global__ void __launch_bounds__(TILE_THREADS)
    contract_bwd_ab_kernel(const T* __restrict__ A, const T* __restrict__ Bm,
                           const T* __restrict__ img, const T* __restrict__ g, T* __restrict__ d_A,
                           T* __restrict__ d_Bm, FacDims d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const DabLayout<T> lay(d.w, d.c);
  T* sG = reinterpret_cast<T*>(smem + lay.g);
  T* sI = reinterpret_cast<T*>(smem + lay.img);   // sI[x][k] = img[bi, y, x0 + x, k]
  float* sC = reinterpret_cast<float*>(smem + lay.c);
  float* sDBm = reinterpret_cast<float*>(smem + lay.dbm);

  const int n_pt = (d.P + TILE - 1) / TILE;
  const int p0 = (blockIdx.x % n_pt) * TILE, bl = blockIdx.x / n_pt, bi = bl / d.L;
  const size_t row0 = size_t(bl) * d.P;
  // thread (i, part): pixel p0 + i, columns part*16 .. part*16 + 15 of each 64-column block
  const int i = threadIdx.x / 4, part = threadIdx.x % 4, p = p0 + i;
  const bool live = p < d.P;

  for (int idx = threadIdx.x; idx < TILE * lay.cpad; idx += TILE_THREADS) {
    const int r = idx / lay.cpad, k = idx % lay.cpad;
    sG[r * lay.ld + k] = p0 + r < d.P && k < d.c ? g[(row0 + p0 + r) * d.c + k] : from_f<T>(0.0f);
  }
  for (int idx = threadIdx.x; idx < TILE * d.w; idx += TILE_THREADS) sDBm[idx] = 0.0f;

  for (int y = 0; y < d.h; ++y) {
    const float a = live ? to_f(A[(row0 + p) * d.h + y]) : 0.0f;
    float da = 0.0f;
    for (int x0 = 0; x0 < d.w; x0 += TILE) {
      __syncthreads();  // sI and sC are free again
      for (int idx = threadIdx.x; idx < TILE * lay.cpad; idx += TILE_THREADS) {
        const int x = idx / lay.cpad, k = idx % lay.cpad;
        sI[x * lay.ld + k] = x0 + x < d.w && k < d.c
                                 ? img[((size_t(bi) * d.h + y) * d.w + x0 + x) * d.c + k]
                                 : from_f<T>(0.0f);
      }
      __syncthreads();
      TileAcc<T> acc;
      tile_zero(acc);
      tile_mma<false, true>(sG, lay.ld, sI, lay.ld, lay.cpad, acc);
      tile_store(acc, sC);
      __syncthreads();
      if (live) {
        for (int j = part * 16; j < part * 16 + 16 && x0 + j < d.w; ++j) {
          const float t = sC[i * LDC + j];
          da = fmaf(to_f(Bm[(row0 + p) * d.w + x0 + j]), t, da);
          sDBm[i * d.w + x0 + j] = fmaf(a, t, sDBm[i * d.w + x0 + j]);
        }
      }
    }
    // the four threads of a pixel are neighbouring lanes of one warp
    da += __shfl_xor_sync(0xffffffffu, da, 1);
    da += __shfl_xor_sync(0xffffffffu, da, 2);
    if (live && part == 0) d_A[(row0 + p) * d.h + y] = from_f<T>(da);
  }
  // each thread stores the columns it accumulated itself, so no barrier is needed
  if (live)
    for (int x0 = 0; x0 < d.w; x0 += TILE)
      for (int j = part * 16; j < part * 16 + 16 && x0 + j < d.w; ++j)
        d_Bm[(row0 + p) * d.w + x0 + j] = from_f<T>(sDBm[i * d.w + x0 + j]);
}

// ---- bf16: wgmma on factor products built in registers -----------------------------------------

using bf16 = __nv_bfloat16;

constexpr int BF_THREADS = TILE_THREADS;  // two warpgroups (launch_tiles launches this many)
constexpr int SLAB = 64;         // K of one ring stage: image pixels (forward), rows (d_img)
constexpr int STAGES = 4;        // ring depth
constexpr int KCH = 128;         // d_A / d_Bm: channels per product chunk (its K)

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) { return *reinterpret_cast<uint32_t*>(&v); }
__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t v) {
  return *reinterpret_cast<__nv_bfloat162*>(&v);
}
// The bf16 product of two pairs, each half rounded once from the exact product (as the TPU kernel
// forms M = A * Bm in the input type).
__device__ __forceinline__ uint32_t mul2(uint32_t a, __nv_bfloat162 b) {
  return as_u32(__hmul2(as_bf2(a), b));
}
__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) { return as_u32(__halves2bfloat162(lo, hi)); }

// The plan of one call's three bf16 kernels (vp_warp_contract_geometry reports it; the Python
// mirror is kernels/k9_variants.py's plan). Rows are (flow, output pixel) pairs r = l*P + p of
// one batch item, all L*P of them sharing the item's image.
struct Plan {
  int np;          // wgmma N of the forward and d_img: channels of a pass, padded to 16/32/64/96/128
  int passes;      // channel passes (c > 128 only)
  int mt;          // m64 tiles per warpgroup in the forward and d_img: 2, or 1 at np = 128
  int fwd_w;       // the forward's Bm branch: w (16, 32, 64: Bm in registers) or 0 (gathered; and
                   // wherever the A tile is staged in parts)
  int dimg_w;      // d_img's branch: w (16, 32, 64 with h % 8 == 0: staged slabs) or 0 (gathered)
  int ny;          // d_img: A columns of a block's image rows (128 * mt / w; 0 when gathered)
  int hs;          // row stride of d_A / d_Bm's A tile in shared memory: h rounded up to 4, plus 2
  int yc;          // the forward's A tile: columns of one part (a multiple of 4; its row stride yc + 2)
  int yparts;      // the forward's A tile: parts of yc columns (1 where the whole tile fits)
  int dab_n;       // d_A / d_Bm: wgmma N, w padded to 16/32/64/96/128, at most 128
  int kch;         // d_A / d_Bm: channels of a product chunk, c padded to 16, at most KCH
  int chunks;      // d_A / d_Bm: channel chunks
  int cs;          // row stride of d_A / d_Bm's g tile: c padded to 16, plus 8
  int yr;          // d_A / d_Bm: image rows of a ring stage (2 at N = 64, else 1)
  int dab_general; // d_A / d_Bm take the kernel for any shape (w > 128, or tiles too large)
  int xchunks;     // d_A / d_Bm: column chunks of dab_n (w > 128 only)
  size_t fwd_smem, dimg_smem, dab_smem;
  int64_t fwd_blocks, dimg_blocks, dab_blocks;
  int64_t scratch; // f32 elements the backward's general d_A / d_Bm kernel accumulates in (or 0)
};

__host__ __device__ constexpr int pad_n(int n) {
  return n <= 16 ? 16 : n <= 32 ? 32 : n <= 64 ? 64 : n <= 96 ? 96 : 128;
}
// m64 tiles per warpgroup of the forward and d_img at channel padding np: two (256-row blocks)
// while the accumulators fit the registers, one at np = 128.
__host__ __device__ constexpr int mt_for(int np) { return np <= 96 ? 2 : 1; }
// Image rows per ring stage of d_A / d_Bm at wgmma width n: two at n = 64 (w = 64), else one
// (measured on an H100: PERF.md, Findings).
__host__ __device__ constexpr int yr_for(int n) { return n == 64 ? 2 : 1; }
// Warpgroups of a d_A / d_Bm block, one m64 tile of rows each.
constexpr int DAB_WG = 2;
constexpr int DAB_ROWS = 64 * DAB_WG, DAB_THREADS = 128 * DAB_WG;
// Shared memory a block may opt into on an H100.
constexpr size_t SMEM_MAX = 232448;

Plan make_plan(const FacDims& d) {
  Plan p;
  const int64_t rows = int64_t(d.L) * d.P, hw = int64_t(d.h) * d.w;
  p.np = pad_n(d.c);
  p.passes = (d.c + p.np - 1) / p.np;
  p.mt = mt_for(p.np);
  const bool w_reg = d.w == 16 || d.w == 32 || d.w == 64;
  p.dimg_w = w_reg && d.h % 8 == 0 ? d.w : 0;
  p.ny = p.dimg_w ? 128 * p.mt / d.w : 0;
  p.hs = round_up(d.h, 4) + 2;
  p.dab_n = pad_n(std::min(d.w, 128));
  p.kch = std::min(round_up(d.c, 16), KCH);
  p.chunks = (d.c + p.kch - 1) / p.kch;
  p.cs = round_up(d.c, 16) + 8;
  const int rb = 128 * p.mt;
  const size_t slab = size_t(SLAB) * p.np * 2;
  // the forward's A tile: all h columns where they fit beside the ring, else parts of the most
  // columns that fit (a multiple of 4, so that a part starts on a slab at w = 16, 32 and 64)
  const int yc_max = int((SMEM_MAX - STAGES * slab) / (size_t(rb) * 2) - 2) / 4 * 4;
  p.yc = std::min(round_up(d.h, 4), yc_max);
  p.yparts = (d.h + p.yc - 1) / p.yc;
  p.fwd_w = w_reg && p.yparts == 1 ? d.w : 0;
  p.fwd_smem = STAGES * slab + align128(size_t(rb) * (p.yc + 2) * 2);
  p.dimg_smem = STAGES * (slab + (p.dimg_w ? align128(size_t(SLAB) * (d.w + 8) * 2) +
                                                 align128(size_t(SLAB) * p.ny * 2)
                                           : 0));
  // d_A / d_Bm: the kernel above where w <= 128 and its g and A tiles fit, else the general one
  // (one image row a stage, g's channels one chunk at a time, no A tile)
  p.yr = yr_for(p.dab_n);
  p.dab_smem = STAGES * align128(size_t(p.yr) * p.dab_n * p.kch * 2) +
               align128(size_t(DAB_ROWS) * p.cs * 2) + align128(size_t(DAB_ROWS) * p.hs * 2);
  p.dab_general = d.w > 128 || p.dab_smem > SMEM_MAX;
  p.xchunks = (d.w + p.dab_n - 1) / p.dab_n;
  if (p.dab_general) {
    p.yr = 1;
    p.dab_smem = STAGES * align128(size_t(p.dab_n) * p.kch * 2) +
                 align128(size_t(DAB_ROWS) * (p.kch + 8) * 2);
  }
  p.fwd_blocks = d.b * p.passes * ((rows + rb - 1) / rb);
  p.dimg_blocks = d.b * p.passes * ((hw + rb - 1) / rb);
  p.dab_blocks = d.b * ((rows + DAB_ROWS - 1) / DAB_ROWS);
  p.scratch = p.dab_general && (p.xchunks > 1 || p.chunks > 1) ? d.b * rows * (d.h + d.w) : 0;
  return p;
}

// Where a thread's fragment rows lie in its block's tile of 128 * MT rows: warpgroup wg owns
// rows wg*64*MT .. +64*MT, its m64 tile mt the 64 from wg*64*MT + mt*64, warp wi 16 of those,
// and the lane rows g and g + 8 (the m16n8k16 and wgmma accumulator layouts).
template <int MT>
__device__ __forceinline__ int frag_row(int mt, int half) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  return (warp / 4) * 64 * MT + mt * 64 + (warp % 4) * 16 + lane / 4 + 8 * half;
}

// Starts the copy of the K slab k0 .. k0+SLAB-1 of src ([k_end, ld] bf16, ld % 8 == 0), columns
// c0 .. c0+NP-1, into `stage` as wgmma's MN-major B: core matrix (k/8, n/8) holds eight 16-byte
// rows, one per k, at ((k/8) * NP/8 + n/8) * 128 bytes, so K-adjacent core matrices are NP*16
// bytes apart (the descriptor's leading byte offset) and N-adjacent ones 128 (its stride).
// Zeros past k_end and past ld.
template <int NP>
__device__ __forceinline__ void load_slab_mn(bf16* stage, const bf16* src, int ld, int k0, int k_end,
                                             int c0) {
  constexpr int NG = NP / 8;
  for (int idx = threadIdx.x; idx < SLAB * NG; idx += BF_THREADS) {
    const int k = k0 + (idx / (8 * NG)) * 8 + idx % 8, ch = c0 + ((idx / 8) % NG) * 8;
    const bool in = k < k_end && ch < ld;
    cp_async16(stage + idx * 8, in ? src + size_t(k) * ld + ch : src, in);
  }
}

// Columns y0 .. y0+yn-1 of rows r0 .. r0+rb-1 of a row-major [rows, h] factor into sA [rb][hs],
// zeros past the last row; plain loads, BATCH of them in flight per thread: 16-byte vectors where
// the tile is whole rows of whole vectors (y0 = 0, yn = h, h % 8 == 0; hs = h + 2 keeps 4-byte
// stores aligned), else single elements.
__device__ __forceinline__ void load_factor_tile(bf16* sA, const bf16* src, int r0, int rows,
                                                 int rb, int h, int hs, int y0 = 0, int yn = -1) {
  constexpr int BATCH = 8;
  if (yn >= 0 && !(y0 == 0 && yn == h)) {
    const int nr = max(0, min(rb, rows - r0));
    src += size_t(r0) * h + y0;
    for (int i0 = threadIdx.x; i0 < rb * yn; i0 += BATCH * blockDim.x) {
      bf16 val[BATCH];
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const int idx = i0 + i * blockDim.x, r = idx / yn;
        val[i] = r < nr ? src[size_t(r) * h + idx - r * yn] : __float2bfloat16(0.0f);
      }
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const int idx = i0 + i * blockDim.x;
        if (idx >= rb * yn) break;
        sA[(idx / yn) * hs + idx % yn] = val[i];
      }
    }
    return;
  }
  const int n = max(0, min(rb, rows - r0)) * h;
  src += size_t(r0) * h;
  if (h % 8 == 0) {
    const int hv = h / 8, nv = rb * hv;
    for (int v0 = threadIdx.x; v0 < nv; v0 += BATCH * blockDim.x) {
      uint4 val[BATCH];
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const int v = v0 + i * blockDim.x;
        val[i] = v * 8 < n ? reinterpret_cast<const uint4*>(src)[v] : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const int v = v0 + i * blockDim.x;
        if (v >= nv) break;
        uint32_t* dst = reinterpret_cast<uint32_t*>(sA + (v / hv) * hs + (v % hv) * 8);
        dst[0] = val[i].x, dst[1] = val[i].y, dst[2] = val[i].z, dst[3] = val[i].w;
      }
    }
    return;
  }
  for (int i0 = threadIdx.x; i0 < rb * h; i0 += BATCH * blockDim.x) {
    bf16 val[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int idx = i0 + i * blockDim.x;
      val[i] = idx < n ? src[idx] : __float2bfloat16(0.0f);
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int idx = i0 + i * blockDim.x;
      if (idx >= rb * h) break;
      sA[(idx / h) * hs + idx % h] = val[i];
    }
  }
}

template <int NP, int MT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][NP / 2]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) acc[mt][i] = 0.0f;
}

constexpr int AHEAD = STAGES - 2;  // slabs whose copies run ahead of the one being multiplied

template <int MT>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[4][MT][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int k = 0; k < 4; ++k) asm volatile("" : "+r"(a[j][mt][k])::"memory");
}

// The forward's and d_img's products over all slabs: acc[mt] += A-fragments x slab (MN-major B,
// four k16 steps a slab), software-pipelined. Slab u's fragments are built and its wgmmas issued
// while slab u-1's still run, so the tensor cores have work across the build, the barrier and the
// copies' issue; the two fragment sets alternate, and a set is released only after the wait that
// retires its wgmmas (its registers stay live until then). The ring runs AHEAD slabs ahead: the
// stage refilled at slab u is slab u-2's, whose products every warp has waited for before the
// barrier. The caller has started the copies of the first AHEAD slabs (slab_prologue), one
// commit group each. fetch(s, stage) starts slab s's copies into `stage`; build(frags, s, stage)
// forms slab s's fragments.
template <typename Fetch>
__device__ __forceinline__ void slab_prologue(int n_slabs, unsigned char* ring, int stage_bytes,
                                              Fetch&& fetch) {
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < n_slabs) fetch(s, ring + s * stage_bytes);
    cp_async_commit();
  }
}

template <int NP, int MT, typename Fetch, typename Build>
__device__ __forceinline__ void slab_loop(float (&acc)[MT][NP / 2], int n_slabs,
                                          unsigned char* ring, int stage_bytes, Fetch&& fetch,
                                          Build&& build) {
  uint32_t fa[4][MT][4], fb[4][MT][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int k = 0; k < 4; ++k) fa[j][mt][k] = fb[j][mt][k] = 0u;
  auto step = [&](int u, uint32_t (&frags)[4][MT][4], uint32_t (&prev)[4][MT][4]) {
    cp_async_wait<AHEAD - 1>();  // this thread's copies of slab u have landed
    fence_proxy_async();         // ... for wgmma's reads too
    __syncthreads();             // everyone's have, and slab u-2's stage is free again
    if (u + AHEAD < n_slabs) fetch(u + AHEAD, ring + ((u + AHEAD) % STAGES) * stage_bytes);
    cp_async_commit();
    const unsigned char* st = ring + (u % STAGES) * stage_bytes;
    build(frags, u, st);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        Wgmma<NP>::template mma<1>(
            acc[mt], frags[j][mt],
            wgmma_desc(reinterpret_cast<const bf16*>(st) + j * 2 * NP * 8, NP * 16, 128));
    wgmma_commit();
    wgmma_wait<1>();  // slab u-1's products are done: its fragment set is free
    fence_frags<MT>(prev);
  };
  for (int u = 0; u < n_slabs; u += 2) {
    step(u, fa, fb);
    if (u + 1 < n_slabs) step(u + 1, fb, fa);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) fence_regs(acc[mt]);
  cp_async_wait<0>();
}

// Rounds the accumulators to bf16 pairs and stores them at dst + row * ld + c0 + column for the
// rows (of the tile starting at row0) below n_rows and the columns below ld.
template <int NP, int MT>
__device__ __forceinline__ void store_acc(float (&acc)[MT][NP / 2], bf16* dst, int64_t row0,
                                          int64_t n_rows, int ld, int c0) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t r = row0 + frag_row<MT>(mt, half);
      if (r >= n_rows) continue;
#pragma unroll
      for (int j = 0; j < NP / 8; ++j) {
        const int col = c0 + 8 * j + 2 * t;
        if (col < ld)
          *reinterpret_cast<__nv_bfloat162*>(dst + r * ld + col) =
              __floats2bfloat162_rn(acc[mt][4 * j + 2 * half], acc[mt][4 * j + 2 * half + 1]);
      }
    }
}

// K9a: out[r, c] = sum_q M[r, q] img[q, c] for one batch item, a block per (tile of 128*MT rows,
// channel pass); q walks the image in slabs of 64 consecutive pixels through the ring. W > 0:
// w == W divides 64, so a thread's fragment columns k keep their image column x from slab to
// slab and its Bm pairs stay in registers; W == 0: any w, M gathered element by element. PARTS
// (W == 0 only): where h is too tall for the block's A tile, the tile holds yc columns of A (image
// rows ya .. ya+yc-1) at a time and the block walks the parts, each over the slabs its rows cover
// (a slab that straddles two parts is taken by both, each with the other's columns zeroed).
template <int NP, int MT, int W, bool PARTS = false>
__global__ void __launch_bounds__(BF_THREADS, 1)
    contract_fwd_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ Bm,
                             const bf16* __restrict__ img, bf16* __restrict__ out, FacDims d, int yc) {
  static_assert(!PARTS || W == 0, "the A tile in parts takes the gathered branch");
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int RB = 128 * MT, STAGE_BYTES = SLAB * NP * 2, XG = W > 0 ? W / 16 : 1;
  const int hs = yc + 2;
  bf16* sA = reinterpret_cast<bf16*>(smem + STAGES * STAGE_BYTES);  // [RB][hs]: a part of the block's rows of A

  const int rows = d.L * d.P, hw = d.h * d.w;
  const int n_rt = (rows + RB - 1) / RB, passes = (d.c + NP - 1) / NP;
  int id = blockIdx.x;  // (batch item, pass, row tile), row tiles fastest: one item's blocks together
  const int r0 = (id % n_rt) * RB;
  id /= n_rt;
  const int c0 = (id % passes) * NP, bi = id / passes;
  const bf16* img_b = img + size_t(bi) * hw * d.c;
  const size_t row_base = size_t(bi) * rows;
  const int lane = threadIdx.x % 32, t = lane % 4;
  int s_base = 0, ya = 0, yn = d.h;  // PARTS: the current part's first slab and image rows

  auto fetch = [&](int s, unsigned char* stage) {
    load_slab_mn<NP>(reinterpret_cast<bf16*>(stage), img_b, d.c, (s_base + s) * SLAB, hw, c0);
  };

  // W > 0: Bm pairs at the thread's rows (half 0: g, 1: g + 8), x = 16 xg + 2t (+8 for e = 1),
  // loaded once the first copies are under way
  uint32_t bm[MT][2][XG][2];
  int lr[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) lr[mt][half] = frag_row<MT>(mt, half);
  auto load_bm = [&]() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if constexpr (W > 0) {
          const int r = r0 + lr[mt][half];
          const bf16* src = Bm + (row_base + r) * W + 2 * t;
#pragma unroll
          for (int xg = 0; xg < XG; ++xg)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              bm[mt][half][xg][e] = r < rows ? *reinterpret_cast<const uint32_t*>(src + 16 * xg + 8 * e) : 0u;
        }
      }
  };

  // M's fragments of slab s: a[j][mt] = (rows lr, columns q = 64s + 16j + 2t, +1 | +8, +9)
  auto build = [&](uint32_t (&a)[4][MT][4], int s, const unsigned char*) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q0 = (s_base + s) * SLAB + 16 * j;
      if constexpr (W > 0) {
        // all 16 columns of the step lie on image row q0 / W; past the image (the zero-filled end
        // of the last slab) any row of A will do
        const int y = min(q0 / W, d.h - 1), xg = j % XG;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const __nv_bfloat162 lo = __bfloat162bfloat162(sA[lr[mt][0] * hs + y]);
          const __nv_bfloat162 hi = __bfloat162bfloat162(sA[lr[mt][1] * hs + y]);
          a[j][mt][0] = mul2(bm[mt][0][xg][0], lo);
          a[j][mt][1] = mul2(bm[mt][1][xg][0], hi);
          a[j][mt][2] = mul2(bm[mt][0][xg][1], lo);
          a[j][mt][3] = mul2(bm[mt][1][xg][1], hi);
        }
      } else {
        // columns 2t, 2t+1, 2t+8, 2t+9, clamped into the image; with PARTS a column on another
        // part's image row reads zero
        int yq[4], xq[4];
        bool in[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int q = min(q0 + 2 * t + (k & 1) + 8 * (k >> 1), hw - 1);
          yq[k] = q / d.w;
          xq[k] = q - yq[k] * d.w;
          in[k] = !PARTS || unsigned(yq[k] - ya) < unsigned(yn);
          if constexpr (PARTS) yq[k] = in[k] ? yq[k] - ya : 0;
        }
        const bf16 zero = __float2bfloat16(0.0f);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = min(r0 + lr[mt][half], rows - 1);  // sA is zero past the last row
            const bf16* arow = sA + lr[mt][half] * hs;
            const bf16* brow = Bm + (row_base + r) * d.w;
#pragma unroll
            for (int e = 0; e < 2; ++e)
              a[j][mt][half + 2 * e] = as_u32(__hmul2(
                  __halves2bfloat162(in[2 * e] ? arow[yq[2 * e]] : zero,
                                     in[2 * e + 1] ? arow[yq[2 * e + 1]] : zero),
                  __halves2bfloat162(brow[xq[2 * e]], brow[xq[2 * e + 1]])));
          }
      }
    }
  };

  float acc[MT][NP / 2];
  if constexpr (PARTS) {
    zero_acc<NP, MT>(acc);
    for (ya = 0; ya < d.h; ya += yc) {
      yn = min(yc, d.h - ya);
      s_base = ya * d.w / SLAB;
      const int s_end = ((ya + yn) * d.w + SLAB - 1) / SLAB;
      if (ya > 0) __syncthreads();  // every warp is done with the last part's A tile and stages
      slab_prologue(s_end - s_base, smem, STAGE_BYTES, fetch);
      load_factor_tile(sA, A + row_base * d.h, r0, rows, RB, d.h, hs, ya, yn);
      slab_loop<NP, MT>(acc, s_end - s_base, smem, STAGE_BYTES, fetch, build);
    }
  } else {
    const int n_slabs = (hw + SLAB - 1) / SLAB;
    slab_prologue(n_slabs, smem, STAGE_BYTES, fetch);
    load_factor_tile(sA, A + row_base * d.h, r0, rows, RB, d.h, hs);
    load_bm();
    zero_acc<NP, MT>(acc);
    slab_loop<NP, MT>(acc, n_slabs, smem, STAGE_BYTES, fetch, build);
  }
  store_acc<NP, MT>(acc, out + row_base * d.c, r0, rows, d.c, c0);
}

// K9b: d_img[q, c] = sum_r M[r, q] g[r, c] for one batch item, a block per (tile of 128*MT image
// pixels q, channel pass); r walks all L*P rows in slabs of 64 through the ring. W > 0: w == W
// divides 64 and h % 8 == 0, so a warp's 16 pixels lie on one image row and the ring also
// carries the slab's Bm rows [64][W + 8] and the A columns of the block's image rows [64][ny]:
// M^T's fragment is ldmatrix.trans of the Bm rows times the A pair of its columns. W == 0: any w,
// M^T gathered element by element.
template <int NP, int MT, int W>
__global__ void __launch_bounds__(BF_THREADS, 1)
    contract_dimg_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ Bm,
                              const bf16* __restrict__ g, bf16* __restrict__ d_img, FacDims d) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int QB = 128 * MT, NY = W > 0 ? QB / W : 0, WS = W + 8, WD = W > 0 ? W : 1;
  constexpr int G_BYTES = SLAB * NP * 2;
  constexpr int BM_BYTES = W > 0 ? int(align128(size_t(SLAB) * WS * 2)) : 0;
  constexpr int A_BYTES = W > 0 ? int(align128(size_t(SLAB) * NY * 2)) : 0;
  constexpr int STAGE_BYTES = G_BYTES + BM_BYTES + A_BYTES;
  constexpr int A_CHUNK = NY * 2 < 16 ? NY * 2 : 16;  // bytes of one copy of a row's A columns

  const int rows = d.L * d.P, hw = d.h * d.w;
  const int n_qt = (hw + QB - 1) / QB, passes = (d.c + NP - 1) / NP;
  int id = blockIdx.x;
  const int q0 = (id % n_qt) * QB;
  id /= n_qt;
  const int c0 = (id % passes) * NP, bi = id / passes;
  const size_t row_base = size_t(bi) * rows;
  const bf16* g_b = g + row_base * d.c;
  const bf16* A_b = A + row_base * d.h;
  const bf16* Bm_b = Bm + row_base * d.w;
  const int y0 = W > 0 ? q0 / WD : 0;
  const int lane = threadIdx.x % 32, t = lane % 4;
  const int n_slabs = (rows + SLAB - 1) / SLAB;

  auto fetch = [&](int s, unsigned char* st) {
    const int k0 = s * SLAB;
    load_slab_mn<NP>(reinterpret_cast<bf16*>(st), g_b, d.c, k0, rows, c0);
    if constexpr (W > 0) {
      bf16* sB = reinterpret_cast<bf16*>(st + G_BYTES);
      for (int idx = threadIdx.x; idx < SLAB * (W / 8); idx += BF_THREADS) {
        const int r = idx / (W / 8), part = idx % (W / 8);
        const bool in = k0 + r < rows;
        cp_async16(sB + r * WS + part * 8, in ? Bm_b + size_t(k0 + r) * W + part * 8 : Bm_b, in);
      }
      bf16* sAc = reinterpret_cast<bf16*>(st + G_BYTES + BM_BYTES);
      constexpr int PARTS = NY * 2 / A_CHUNK, PER = A_CHUNK / 2;
      for (int idx = threadIdx.x; idx < SLAB * PARTS; idx += BF_THREADS) {
        const int r = idx / PARTS, y = y0 + (idx % PARTS) * PER;
        const bool in = k0 + r < rows && y < d.h;
        cp_async_ca<A_CHUNK>(sAc + r * NY + (idx % PARTS) * PER,
                             in ? A_b + size_t(k0 + r) * d.h + y : A_b, in);
      }
    }
  };
  slab_prologue(n_slabs, smem, STAGE_BYTES, fetch);

  // the thread's pixels: W > 0, each warp's 16 (x_b .. x_b + 15 on image row y0 + ys); W == 0,
  // its fragment rows g and g + 8, clamped into the image
  int ys[MT], xb[MT], yq[MT][2], xq[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int qw = q0 + frag_row<MT>(mt, 0) - lane / 4;
    ys[mt] = W > 0 ? qw / WD - y0 : 0;
    xb[mt] = W > 0 ? qw % WD : 0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = min(q0 + frag_row<MT>(mt, half), hw - 1);
      yq[mt][half] = q / d.w;
      xq[mt][half] = q - yq[mt][half] * d.w;
    }
  }
  // ldmatrix.trans: lane l addresses row l%8 of matrix l/8, whose (r, x) offsets are
  // ((l/16) * 8, ((l/8) % 2) * 8): the four 8x8 blocks of the [16 r x 16 x] tile in the order
  // of the A fragment's registers once transposed
  const int lm_r = (lane / 16) * 8 + lane % 8, lm_x = ((lane / 8) % 2) * 8;

  // M^T's fragments of slab s: a[j][mt] = (pixel rows, columns r = 64s + 16j + 2t, +1 | +8, +9)
  auto build = [&](uint32_t (&a)[4][MT][4], int s, const unsigned char* st) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (W > 0) {
        const bf16* sB = reinterpret_cast<const bf16*>(st + G_BYTES);
        const bf16* sAc = reinterpret_cast<const bf16*>(st + G_BYTES + BM_BYTES);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint32_t f[4];
          ldmatrix_x4_trans(f, sB + (16 * j + lm_r) * WS + xb[mt] + lm_x);
          const bf16* ac = sAc + (16 * j + 2 * t) * NY + ys[mt];
          const __nv_bfloat162 lo = __halves2bfloat162(ac[0], ac[NY]);
          const __nv_bfloat162 hi = __halves2bfloat162(ac[8 * NY], ac[9 * NY]);
          a[j][mt][0] = mul2(f[0], lo);
          a[j][mt][1] = mul2(f[1], lo);
          a[j][mt][2] = mul2(f[2], hi);
          a[j][mt][3] = mul2(f[3], hi);
        }
      } else {
        int rk[4];  // rows 2t, 2t+1, 2t+8, 2t+9 of the step, clamped (g is zero past the last)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          rk[k] = min(s * SLAB + 16 * j + 2 * t + (k & 1) + 8 * (k >> 1), rows - 1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int ra = rk[2 * e], rb = rk[2 * e + 1];
              a[j][mt][half + 2 * e] = as_u32(__hmul2(
                  __halves2bfloat162(A_b[size_t(ra) * d.h + yq[mt][half]],
                                     A_b[size_t(rb) * d.h + yq[mt][half]]),
                  __halves2bfloat162(Bm_b[size_t(ra) * d.w + xq[mt][half]],
                                     Bm_b[size_t(rb) * d.w + xq[mt][half]])));
            }
      }
    }
  };

  float acc[MT][NP / 2];
  zero_acc<NP, MT>(acc);
  slab_loop<NP, MT>(acc, n_slabs, smem, STAGE_BYTES, fetch, build);
  store_acc<NP, MT>(acc, d_img + size_t(bi) * hw * d.c, q0, hw, d.c, c0);
}

// K9c: for a block's DAB_ROWS rows r and each image row y, T_y[r, x] = sum_c g[r, c] img[y, x, c] on
// wgmma (M = rows, N = x, padded to N; K = c in chunks of up to KCH), then in registers d_A[r, y] =
// sum_x Bm[r, x] T_y[r, x] (a quad reduction) and d_Bm[r, x] += A[r, y] T_y[r, x]. g's fragments
// stay in registers across y (one chunk), Bm's pairs and the d_Bm sums stay in the accumulators'
// layout; d_A goes into the A tile in place of the A value it replaces. Image rows stream through
// the ring in wgmma's K-major layout, YR rows (one chunk of channels each) a stage, so that one
// barrier and one wgmma wait serve YR rows' products.
template <int N, int YR>
__global__ void __launch_bounds__(DAB_THREADS, DAB_WG == 1 ? 2 : 1)
    contract_dab_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ Bm,
                             const bf16* __restrict__ img, const bf16* __restrict__ g,
                             bf16* __restrict__ d_A, bf16* __restrict__ d_Bm, FacDims d, int hs,
                             int kch, int cs) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int RB = DAB_ROWS, NX = N / 8;
  const int kq_n = kch / 8;
  const size_t row_elems = size_t(N) * kch, stage_elems = align128(YR * row_elems * 2) / 2;
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* sG = ring + STAGES * stage_elems;                              // [RB][cs]
  bf16* sA = sG + align128(size_t(RB) * cs * 2) / 2;                   // [RB][hs]: A, then d_A

  const int rows = d.L * d.P, hw = d.h * d.w;
  const int n_rt = (rows + RB - 1) / RB;
  const int r0 = (blockIdx.x % n_rt) * RB, bi = blockIdx.x / n_rt;
  const size_t row_base = size_t(bi) * rows;
  const bf16* img_b = img + size_t(bi) * hw * d.c;
  const int lane = threadIdx.x % 32, t = lane % 4;
  const int chunks = (d.c + kch - 1) / kch, n_items = (d.h + YR - 1) / YR * chunks;
  const int cpad = round_up(d.c, 16);

  // item it = (image rows YR*(it / chunks) + i, i < YR; channel chunk it % chunks): each row
  // [N x-rows][kch] K-major, core matrix (x/8, ch/8) at ((ch/8) * N/8 + x/8) * 128 bytes, so
  // N-adjacent core matrices are 128 bytes apart (the stride byte offset) and K-adjacent ones N*16
  // (the leading byte offset): a k16 step's core matrices lie in consecutive banks. Two threads
  // copy the two 16-byte halves of a 32-byte sector of one pixel; the index math divides by
  // constants only (a slice is the 2N copies of two adjacent 8-channel groups). Zeros past w,
  // past c and past the last image row.
  auto fetch = [&](int it) {
    constexpr int SLICE = 16 * NX;
    bf16* stage = ring + (it % STAGES) * stage_elems;
    const int y0 = it / chunks * YR, ch0 = (it % chunks) * kch;
#pragma unroll
    for (int i = 0; i < YR; ++i) {
      const int y = y0 + i;
      const bf16* row = img_b + size_t(y < d.h ? y : 0) * d.w * d.c;
      for (int idx = threadIdx.x; idx < kq_n / 2 * SLICE; idx += DAB_THREADS) {
        const int e = idx % SLICE, xg = e / 16, x = xg * 8 + (e / 2) % 8;
        const int kq = (idx / SLICE) * 2 + e % 2, ch = ch0 + kq * 8;
        const bool in = x < d.w && ch < d.c && y < d.h;
        cp_async16(stage + i * row_elems + ((kq * NX + xg) * 8 + x % 8) * 8,
                   in ? row + size_t(x) * d.c + ch : img_b, in);
      }
    }
  };
  // g's rows r0 .. r0+RB-1 [RB][cs], zeros past the last row and past c: in the first group
  for (int idx = threadIdx.x; idx < RB * (cpad / 8); idx += DAB_THREADS) {
    const int r = idx / (cpad / 8), ch = (idx % (cpad / 8)) * 8;
    const bool in = r0 + r < rows && ch < d.c;
    cp_async16(sG + r * cs + ch, in ? g + (row_base + r0 + r) * d.c + ch : g, in);
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_items) fetch(s);
    cp_async_commit();
  }
  load_factor_tile(sA, A + row_base * d.h, r0, rows, RB, d.h, hs);

  const int lr[2] = {frag_row<1>(0, 0), frag_row<1>(0, 1)};
  // Bm pairs in the accumulators' layout: bmv[j][half] = Bm[r, 8j + 2t .. +1], zeros past w
  uint32_t bmv[NX][2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + lr[half];
    const bf16* src = Bm + (row_base + min(r, rows - 1)) * d.w;
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      const int x = 8 * j + 2 * t;
      const bf16 zero = __float2bfloat16(0.0f);
      bmv[j][half] = pack2(r < rows && x < d.w ? src[x] : zero, r < rows && x + 1 < d.w ? src[x + 1] : zero);
    }
  }
  float acc[YR][N / 2], dbm[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) dbm[i] = 0.0f;
  uint32_t gf[KCH / 16][4];  // g's fragments of the current chunk: rows lr, k16 step k

  for (int it = 0; it < n_items; ++it) {
    const int y0 = it / chunks * YR, chunk = it % chunks;
    const int ks = min(kch, cpad - chunk * kch) / 16;
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();
    if (it + STAGES - 1 < n_items) fetch(it + STAGES - 1);
    cp_async_commit();
    if (chunks > 1 || it == 0) {  // g's fragments of this chunk: once, where there is one chunk
#pragma unroll
      for (int k = 0; k < KCH / 16; ++k)
        if (k < ks)
          ldmatrix_x4(gf[k], sG + (lr[0] - lane / 4 + lane % 16) * cs + chunk * kch + 16 * k +
                                 (lane / 16) * 8);
    }
    if (chunk == 0) {
#pragma unroll
      for (int i = 0; i < YR; ++i)
#pragma unroll
        for (int e = 0; e < N / 2; ++e) acc[i][e] = 0.0f;
    }
    const bf16* stage = ring + (it % STAGES) * stage_elems;
#pragma unroll
    for (int i = 0; i < YR; ++i) fence_regs(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < YR; ++i)
#pragma unroll
      for (int k = 0; k < KCH / 16; ++k)
        if (k < ks)
          Wgmma<N>::mma(acc[i], gf[k], wgmma_desc(stage + i * row_elems + k * 16 * N, N * 16, 128));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < YR; ++i) fence_regs(acc[i]);
    if (chunk == chunks - 1) {
#pragma unroll
      for (int i = 0; i < YR; ++i) {
        const int y = y0 + i;
        if (y >= d.h) break;
        // the epilogue of image row y: all in registers, the A value read where d_A then goes
        bf16* a_lo = sA + lr[0] * hs + y;
        bf16* a_hi = sA + lr[1] * hs + y;
        const float av[2] = {__bfloat162float(*a_lo), __bfloat162float(*a_hi)};
        float da[2] = {0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < NX; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float2 b = __bfloat1622float2(as_bf2(bmv[j][half]));
            const float t0 = acc[i][4 * j + 2 * half], t1 = acc[i][4 * j + 2 * half + 1];
            da[half] = fmaf(b.x, t0, fmaf(b.y, t1, da[half]));
            dbm[4 * j + 2 * half] = fmaf(av[half], t0, dbm[4 * j + 2 * half]);
            dbm[4 * j + 2 * half + 1] = fmaf(av[half], t1, dbm[4 * j + 2 * half + 1]);
          }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          da[half] += __shfl_xor_sync(0xffffffffu, da[half], 1);
          da[half] += __shfl_xor_sync(0xffffffffu, da[half], 2);
        }
        if (t == 0) {  // after the shuffles: every lane of the quad has read the A value
          *a_lo = __float2bfloat16(da[0]);
          *a_hi = __float2bfloat16(da[1]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // d_A's tile is complete
  {  // 16-byte vectors where a row is whole vectors, as the tile was loaded
    const int n = max(0, min(RB, rows - r0)) * d.h;
    bf16* dst = d_A + (row_base + r0) * d.h;
    if (d.h % 8 == 0) {
      const int hv = d.h / 8;
      for (int v = threadIdx.x; v * 8 < n; v += DAB_THREADS) {
        const uint32_t* src = reinterpret_cast<const uint32_t*>(sA + (v / hv) * hs + (v % hv) * 8);
        reinterpret_cast<uint4*>(dst)[v] = make_uint4(src[0], src[1], src[2], src[3]);
      }
    } else {
      for (int idx = threadIdx.x; idx < n; idx += DAB_THREADS) dst[idx] = sA[(idx / d.h) * hs + idx % d.h];
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + lr[half];
    if (r >= rows) continue;
    bf16* dst = d_Bm + (row_base + r) * d.w;
#pragma unroll
    for (int j = 0; j < NX; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 8 * j + 2 * t + e;
        if (x < d.w) dst[x] = __float2bfloat16(dbm[4 * j + 2 * half + e]);
      }
  }
}

// K9c for any w, h and c (the plan's dab_general: w > 128, or g's or A's tile too large for the
// kernel above): a block per (item, 128 rows r), one warpgroup per m64 tile, as above; it walks
// g's channel chunks, in each the column chunks of N image columns, in each all image rows y,
// one image row (N columns, kch channels, K-major) a ring stage. g's chunk is staged in shared
// memory once per chunk and its fragments held in registers; A's values are read from global
// memory as the epilogue needs them. The epilogue of a (chunk, column chunk, y) adds its part of
// d_A[r, y] (a quad reduction) and of d_Bm[r, x] (in registers over y): where a sum has several
// parts (column or channel chunks), the thread that owns the element keeps it in f32 in `scratch`
// ([b*L*P][h] for d_A, then [b*L*P][w] for d_Bm) and rounds it into d_A / d_Bm at its last part.
template <int N>
__global__ void __launch_bounds__(DAB_THREADS, 1)
    contract_dab_general_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ Bm,
                                     const bf16* __restrict__ img, const bf16* __restrict__ g,
                                     bf16* __restrict__ d_A, bf16* __restrict__ d_Bm,
                                     float* __restrict__ scratch, FacDims d, int kch) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int RB = DAB_ROWS, NX = N / 8;
  const int kq_n = kch / 8, gs = kch + 8;
  const size_t stage_elems = align128(size_t(N) * kch * 2) / 2;
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* sG = ring + STAGES * stage_elems;  // [RB][gs]: g's rows, the current chunk's channels

  const int rows = d.L * d.P, hw = d.h * d.w;
  const int n_rt = (rows + RB - 1) / RB;
  const int r0 = (blockIdx.x % n_rt) * RB, bi = blockIdx.x / n_rt;
  const size_t row_base = size_t(bi) * rows;
  const bf16* img_b = img + size_t(bi) * hw * d.c;
  const int lane = threadIdx.x % 32, t = lane % 4;
  const int cpad = round_up(d.c, 16), chunks = (d.c + kch - 1) / kch;
  const int xchunks = (d.w + N - 1) / N, n_items = chunks * xchunks * d.h;
  float* acc_A = scratch;
  float* acc_Bm = scratch + size_t(d.b) * rows * d.h;

  // item it = ((chunk * xchunks + xc) * h + y): image row y, the chunk's kch channels, the
  // column chunk's N columns, in the layout of the kernel above (zeros past w and past c)
  auto fetch = [&](int it) {
    constexpr int SLICE = 16 * NX;
    bf16* stage = ring + (it % STAGES) * stage_elems;
    const int y = it % d.h, x0 = (it / d.h) % xchunks * N, ch0 = it / (d.h * xchunks) * kch;
    const bf16* row = img_b + size_t(y) * d.w * d.c;
    for (int idx = threadIdx.x; idx < kq_n / 2 * SLICE; idx += DAB_THREADS) {
      const int e = idx % SLICE, xg = e / 16, x = x0 + xg * 8 + (e / 2) % 8;
      const int kq = (idx / SLICE) * 2 + e % 2, ch = ch0 + kq * 8;
      const bool in = x < d.w && ch < d.c;
      cp_async16(stage + ((kq * NX + xg) * 8 + x % 8) * 8, in ? row + size_t(x) * d.c + ch : img_b,
                 in);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_items) fetch(s);
    cp_async_commit();
  }

  const int lr[2] = {frag_row<1>(0, 0), frag_row<1>(0, 1)};
  uint32_t gf[KCH / 16][4];
  uint32_t bmv[NX][2];
  float acc[N / 2], dbm[N / 2];
  int it = 0;
  for (int chunk = 0; chunk < chunks; ++chunk) {
    const int ch0 = chunk * kch, ks = min(kch, cpad - ch0) / 16;
    const bool last_chunk = chunk == chunks - 1;
    __syncthreads();  // every warp holds the last chunk's g fragments
    for (int idx = threadIdx.x; idx < RB * kq_n; idx += DAB_THREADS) {
      const int r = idx / kq_n, ch = ch0 + (idx % kq_n) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < rows && ch < d.c)
        v = *reinterpret_cast<const uint4*>(g + (row_base + r0 + r) * d.c + ch);
      *reinterpret_cast<uint4*>(sG + r * gs + ch - ch0) = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KCH / 16; ++k)
      if (k < ks) ldmatrix_x4(gf[k], sG + (lr[0] - lane / 4 + lane % 16) * gs + 16 * k + (lane / 16) * 8);

    for (int xc = 0; xc < xchunks; ++xc) {
      const int x0 = xc * N;
      const bool last = last_chunk && xc == xchunks - 1;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + lr[half];
        const bf16* src = Bm + (row_base + min(r, rows - 1)) * d.w;
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          const int x = x0 + 8 * j + 2 * t;
          const bf16 zero = __float2bfloat16(0.0f);
          bmv[j][half] = pack2(r < rows && x < d.w ? src[x] : zero, r < rows && x + 1 < d.w ? src[x + 1] : zero);
        }
      }
#pragma unroll
      for (int i = 0; i < N / 2; ++i) dbm[i] = 0.0f;

      for (int y = 0; y < d.h; ++y, ++it) {
        cp_async_wait<STAGES - 2>();
        fence_proxy_async();
        __syncthreads();
        if (it + (STAGES - 1) < n_items) fetch(it + (STAGES - 1));
        cp_async_commit();
        const bf16* stage = ring + (it % STAGES) * stage_elems;
#pragma unroll
        for (int e = 0; e < N / 2; ++e) acc[e] = 0.0f;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < KCH / 16; ++k)
          if (k < ks) Wgmma<N>::mma(acc, gf[k], wgmma_desc(stage + k * 16 * N, N * 16, 128));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        float av[2], da[2] = {0.0f, 0.0f};
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = r0 + lr[half];
          av[half] = r < rows ? __bfloat162float(A[(row_base + r) * d.h + y]) : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < NX; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float2 b = __bfloat1622float2(as_bf2(bmv[j][half]));
            const float t0 = acc[4 * j + 2 * half], t1 = acc[4 * j + 2 * half + 1];
            da[half] = fmaf(b.x, t0, fmaf(b.y, t1, da[half]));
            dbm[4 * j + 2 * half] = fmaf(av[half], t0, dbm[4 * j + 2 * half]);
            dbm[4 * j + 2 * half + 1] = fmaf(av[half], t1, dbm[4 * j + 2 * half + 1]);
          }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          da[half] += __shfl_xor_sync(0xffffffffu, da[half], 1);
          da[half] += __shfl_xor_sync(0xffffffffu, da[half], 2);
          const int r = r0 + lr[half];
          if (t == 0 && r < rows) {
            const size_t i = (row_base + r) * d.h + y;
            const float v = chunk > 0 || xc > 0 ? acc_A[i] + da[half] : da[half];
            if (last)
              d_A[i] = __float2bfloat16(v);
            else
              acc_A[i] = v;
          }
        }
      }
      // d_Bm of the column chunk
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + lr[half];
        if (r >= rows) continue;
#pragma unroll
        for (int j = 0; j < NX; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int x = x0 + 8 * j + 2 * t + e;
            if (x >= d.w) continue;
            const size_t i = (row_base + r) * d.w + x;
            const float v = chunk > 0 ? acc_Bm[i] + dbm[4 * j + 2 * half + e] : dbm[4 * j + 2 * half + e];
            if (last_chunk)
              d_Bm[i] = __float2bfloat16(v);
            else
              acc_Bm[i] = v;
          }
      }
    }
  }
  cp_async_wait<0>();
}

// The bf16 kernels read 16-byte vectors of channels, so there c is a multiple of 8 (the wrappers
// pad it).
bool valid_dims(const FacDims& d, bool bf16) {
  return d.b > 0 && d.L > 0 && d.P > 0 && d.h > 0 && d.w > 0 && d.c > 0 && (!bf16 || d.c % 8 == 0) &&
         int64_t(d.h) * d.w < (int64_t(1) << 31) && int64_t(d.L) * d.P < (int64_t(1) << 31);
}

template <int NP, int MT>
cudaError_t fwd_bf16(const Plan& p, const bf16* A, const bf16* Bm, const bf16* img, bf16* out,
                     FacDims d, cudaStream_t st) {
  if (p.yparts > 1)
    return launch_tiles(contract_fwd_bf16_kernel<NP, MT, 0, true>, p.fwd_blocks, p.fwd_smem, st, A, Bm, img, out, d, p.yc);
  switch (p.fwd_w) {
    case 16: return launch_tiles(contract_fwd_bf16_kernel<NP, MT, 16>, p.fwd_blocks, p.fwd_smem, st, A, Bm, img, out, d, p.yc);
    case 32: return launch_tiles(contract_fwd_bf16_kernel<NP, MT, 32>, p.fwd_blocks, p.fwd_smem, st, A, Bm, img, out, d, p.yc);
    case 64: return launch_tiles(contract_fwd_bf16_kernel<NP, MT, 64>, p.fwd_blocks, p.fwd_smem, st, A, Bm, img, out, d, p.yc);
    default: return launch_tiles(contract_fwd_bf16_kernel<NP, MT, 0>, p.fwd_blocks, p.fwd_smem, st, A, Bm, img, out, d, p.yc);
  }
}

template <int NP, int MT>
cudaError_t dimg_bf16(const Plan& p, const bf16* A, const bf16* Bm, const bf16* g, bf16* d_img,
                      FacDims d, cudaStream_t st) {
  switch (p.dimg_w) {
    case 16: return launch_tiles(contract_dimg_bf16_kernel<NP, MT, 16>, p.dimg_blocks, p.dimg_smem, st, A, Bm, g, d_img, d);
    case 32: return launch_tiles(contract_dimg_bf16_kernel<NP, MT, 32>, p.dimg_blocks, p.dimg_smem, st, A, Bm, g, d_img, d);
    case 64: return launch_tiles(contract_dimg_bf16_kernel<NP, MT, 64>, p.dimg_blocks, p.dimg_smem, st, A, Bm, g, d_img, d);
    default: return launch_tiles(contract_dimg_bf16_kernel<NP, MT, 0>, p.dimg_blocks, p.dimg_smem, st, A, Bm, g, d_img, d);
  }
}

template <int N>
cudaError_t dab_bf16(const Plan& p, const bf16* A, const bf16* Bm, const bf16* img, const bf16* g,
                     bf16* d_A, bf16* d_Bm, float* scratch, FacDims d, cudaStream_t st) {
  if (p.dab_blocks > 0x7fffffff || (p.scratch > 0 && scratch == nullptr)) return cudaErrorInvalidValue;
  if (p.dab_general) {
    const auto kernel = contract_dab_general_bf16_kernel<N>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           int(p.dab_smem));
    if (err != cudaSuccess) return err;
    kernel<<<unsigned(p.dab_blocks), DAB_THREADS, p.dab_smem, st>>>(A, Bm, img, g, d_A, d_Bm,
                                                                    scratch, d, p.kch);
    return cudaGetLastError();
  }
  const auto kernel = contract_dab_bf16_kernel<N, yr_for(N)>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(p.dab_smem));
  if (err != cudaSuccess) return err;
  kernel<<<unsigned(p.dab_blocks), DAB_THREADS, p.dab_smem, st>>>(A, Bm, img, g, d_A, d_Bm, d, p.hs,
                                                                  p.kch, p.cs);
  return cudaGetLastError();
}

// Calls fn<NP, MT>(...) for the plan's channel padding.
#define VP_BY_NP(fn, p, ...)                                          \
  ((p).np == 16   ? fn<16, mt_for(16)>((p), __VA_ARGS__)              \
   : (p).np == 32 ? fn<32, mt_for(32)>((p), __VA_ARGS__)              \
   : (p).np == 64 ? fn<64, mt_for(64)>((p), __VA_ARGS__)              \
   : (p).np == 96 ? fn<96, mt_for(96)>((p), __VA_ARGS__)              \
                  : fn<128, mt_for(128)>((p), __VA_ARGS__))
#define VP_BY_N(fn, p, ...)                                     \
  ((p).dab_n == 16   ? fn<16>((p), __VA_ARGS__)                 \
   : (p).dab_n == 32 ? fn<32>((p), __VA_ARGS__)                 \
   : (p).dab_n == 64 ? fn<64>((p), __VA_ARGS__)                 \
   : (p).dab_n == 96 ? fn<96>((p), __VA_ARGS__)                 \
                     : fn<128>((p), __VA_ARGS__))

template <typename T>
cudaError_t launch_fwd(const void* A, const void* Bm, const void* img, void* out, FacDims d,
                       cudaStream_t stream) {
  const int64_t grid = int64_t(d.b) * d.L * ((d.P + TILE - 1) / TILE) * ((d.c + TILE - 1) / TILE);
  return launch_tiles(contract_fwd_kernel<T>, grid, FwdLayout<T>(d.w).bytes, stream,
                      static_cast<const T*>(A), static_cast<const T*>(Bm),
                      static_cast<const T*>(img), static_cast<T*>(out), d);
}

template <typename T>
cudaError_t launch_bwd(const void* A, const void* Bm, const void* img, const void* g, void* d_A,
                       void* d_Bm, void* d_img, float*, FacDims d, cudaStream_t stream) {
  const int64_t hw = int64_t(d.h) * d.w;
  cudaError_t err = launch_tiles(
      contract_bwd_img_kernel<T>, int64_t(d.b) * ((hw + TILE - 1) / TILE) * ((d.c + TILE - 1) / TILE),
      DimgLayout<T>().bytes, stream, static_cast<const T*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(g), static_cast<T*>(d_img), d);
  if (err != cudaSuccess) return err;
  return launch_tiles(contract_bwd_ab_kernel<T>, int64_t(d.b) * d.L * ((d.P + TILE - 1) / TILE),
                      DabLayout<T>(d.w, d.c).bytes, stream, static_cast<const T*>(A),
                      static_cast<const T*>(Bm), static_cast<const T*>(img),
                      static_cast<const T*>(g), static_cast<T*>(d_A), static_cast<T*>(d_Bm), d);
}

template <>
cudaError_t launch_fwd<bf16>(const void* A, const void* Bm, const void* img, void* out, FacDims d,
                             cudaStream_t stream) {
  const Plan p = make_plan(d);
  return VP_BY_NP(fwd_bf16, p, static_cast<const bf16*>(A), static_cast<const bf16*>(Bm),
                  static_cast<const bf16*>(img), static_cast<bf16*>(out), d, stream);
}

template <>
cudaError_t launch_bwd<bf16>(const void* A, const void* Bm, const void* img, const void* g,
                             void* d_A, void* d_Bm, void* d_img, float* scratch, FacDims d,
                             cudaStream_t stream) {
  const Plan p = make_plan(d);
  const bf16 *a = static_cast<const bf16*>(A), *bm = static_cast<const bf16*>(Bm);
  cudaError_t err = VP_BY_NP(dimg_bf16, p, a, bm, static_cast<const bf16*>(g),
                             static_cast<bf16*>(d_img), d, stream);
  if (err != cudaSuccess) return err;
  return VP_BY_N(dab_bf16, p, a, bm, static_cast<const bf16*>(img), static_cast<const bf16*>(g),
                 static_cast<bf16*>(d_A), static_cast<bf16*>(d_Bm), scratch, d, stream);
}

}  // namespace

extern "C" {

// The forward on `stream`: out [b, L, P, c] from A [b, L, P, h], Bm [b, L, P, w] and img [b, h, w, c],
// all bf16 when is_bf16 is set, else f32, contiguous. Returns a cudaError_t (0 on success).
int vp_warp_contract_fwd(int is_bf16, const void* A, const void* Bm, const void* img, void* out,
                         int b, int L, int P, int h, int w, int c, void* stream) {
  const FacDims d{b, L, P, h, w, c};
  if (!valid_dims(d, is_bf16)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return finish(is_bf16 ? launch_fwd<__nv_bfloat16>(A, Bm, img, out, d, st)
                        : launch_fwd<float>(A, Bm, img, out, d, st));
}

// The backward on `stream`, two launches: d_img [b, h, w, c], d_A [b, L, P, h] and d_Bm [b, L, P, w]
// from g [b, L, P, c], all in the inputs' type and contiguous. In bf16, `scratch` holds the plan's
// `scratch` f32 elements where that is not 0 (vp_warp_contract_geometry), else it may be null.
// Returns a cudaError_t.
int vp_warp_contract_bwd(int is_bf16, const void* A, const void* Bm, const void* img, const void* g,
                         void* d_A, void* d_Bm, void* d_img, float* scratch, int b, int L, int P,
                         int h, int w, int c, void* stream) {
  const FacDims d{b, L, P, h, w, c};
  if (!valid_dims(d, is_bf16)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return finish(is_bf16 ? launch_bwd<__nv_bfloat16>(A, Bm, img, g, d_A, d_Bm, d_img, scratch, d, st)
                        : launch_bwd<float>(A, Bm, img, g, d_A, d_Bm, d_img, scratch, d, st));
}

// The bf16 kernels' plan for these dimensions (c a multiple of 8) into out[0..22]: np, passes, mt,
// fwd_w, dimg_w, ny, hs, yc, yparts, dab_n, kch, chunks, cs, yr, dab_general, xchunks, fwd_smem,
// dimg_smem, dab_smem, fwd_blocks, dimg_blocks, dab_blocks, scratch. Returns a cudaError_t.
int vp_warp_contract_geometry(int b, int L, int P, int h, int w, int c, int64_t* out) {
  const FacDims d{b, L, P, h, w, c};
  if (!valid_dims(d, true)) return cudaErrorInvalidValue;
  const Plan p = make_plan(d);
  const int64_t v[] = {p.np, p.passes, p.mt, p.fwd_w, p.dimg_w, p.ny, p.hs, p.yc, p.yparts,
                       p.dab_n, p.kch, p.chunks, p.cs, p.yr, p.dab_general, p.xchunks,
                       int64_t(p.fwd_smem), int64_t(p.dimg_smem), int64_t(p.dab_smem),
                       p.fwd_blocks, p.dimg_blocks, p.dab_blocks, p.scratch};
  for (int i = 0; i < int(sizeof(v) / sizeof(v[0])); ++i) out[i] = v[i];
  return 0;
}

const char* vp_cuda_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

}  // extern "C"
