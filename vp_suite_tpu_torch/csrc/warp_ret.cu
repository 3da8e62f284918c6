// Multi-flow bilinear warp fused with TrajGRU's 1x1 `ret` conv, for Hopper (sm_90a): forward and
// backward.
//
// Replaces the JAX package's TPU kernels in ops/pallas_warp.py, reached through warp_ret: the forward
// _make_warpret_fwd_kernel (K8a), and the backward _make_warpret_dimg_kernel (K8b, d_img) and
// _make_warpret_didx_dw_kernel (K8c, d_iy, d_ix and d_W).
//
// Function, for batch item bi, output pixel p and output channel o, with warp_l the bilinear warp of
// img along flow l (warp_common.cuh's taps; zero outside the image):
//   out[bi, p, o] = bias[o] + sum_l sum_k W[l, k, o] * warp_l[bi, p, k]
// The samples warp_l are summed in f32 over their four taps and rounded to the activation type, W
// is in the activation type (the caller rounds it), products are summed in f32, the bias (f32) is
// added in f32 and out is rounded once. The backward, from g = d out [b, P, O]:
//   g_l[bi, p, k] = sum_o g[bi, p, o] * W[l, k, o]   (f32 sum, rounded to the activation type)
//   d_img, d_iy, d_ix: the warp's backward (warp_sample.cu) of g_l, d_img summed in f32
//   d_W[l, k, o] = sum_{bi, p} warp_l[bi, p, k] * g[bi, p, o]   (f32)
// d_bias, the sum of g over (bi, p), is left to the caller, as the JAX package takes it outside.
//
// Layout: pixel-major. iy, ix [b, P, L] f32, img [b, h, w, f], W [L, f, O], out and g [b, P, O]; P
// is any number of output pixels (pixel p is placed on image row p / w for the bands below).
//
// Bound: operations. The forward's contraction over (l, k) is 2*b*P*L*f*O operations, 41.9 GFLOP
// (42 us of bf16 tensor time) at b=32, 64x64, L=13, f=64, O=192, against some 24 MB of image,
// indices and output; the backward needs two such products (g_l and d_W) beside its gathers and its
// scatter. What the fusion keeps out of device memory is the [b, P, L, f] warp tensor (218 MB per
// call at 64x64x64 in bf16), and, in the backward, g_l (as large).
//
// bf16 (the Hopper design; the plan, make_plan below, is mirrored by kernels/k8_variants.py):
// - Forward: one launch, a block per (item, tile of 128 output pixels, or 64 where that leaves SMs
//   idle; all O, up to 288 channels, in one pass). The block stages its band of image rows (the
//   tile's rows and R = 6 above and below at w >= 48, else 4; full width, all channels) in shared
//   memory once by cp.async, as the warp forward does (warp_sample.cu). Its K walks the L flows in
//   items of 32 channels: W_l's rows stream through a cp.async ring as wgmma's MN-major B, and
//   each thread builds the warp tile straight into wgmma's A registers, from its two pixels' taps
//   (once per flow) and one 16-byte band read per tap and 8 channels. The f32 accumulators [tile,
//   O] stay in registers across all L flows (144 a thread at O = 288); the epilogue adds the bias.
//   W is re-read from L2 by every block: 13 x 24.6 KB per 128-pixel tile at 64x64x64.
// - Backward, pass 1 (K8b and K8c's index half): a block per (item, tile of 128 output pixels),
//   the g tile and the tile's indices staged once and g's A fragments (K = O) held in registers.
//   For each pass of 32 channels it stages the band of image rows, then for each flow forms
//   g_l = g W_l^T on wgmma (N = 32, W_l^T's columns through a ring), and an epilogue rounds g_l in
//   registers and uses it at once: d_iy and d_ix from the taps' band values, reduced over the quad
//   by shuffles; g_l * weight into d_img by float4 atomics, 8 channels a thread and tap. No g_l in
//   memory. A shared window of d_img sums (the warp backward's compare-and-swaps) was measured
//   slower here than the global float4 atomics and dropped. Past O = 288 K walks chunks of 288
//   channels, reloading g's fragments; where the tiles do not fit in shared memory the plan takes
//   one warpgroup, then reads the indices from global memory, then streams g by chunks beside
//   W^T, so that every shape fits.
// - Backward, pass 2 (K8c's d_W): d_W sums over all b*P pixels, and blocks run in no order, so a
//   block per (one or two flows, item, part of the item's pixels) accumulates d_W_l^T [O, f] on wgmma over
//   64-pixel chunks: A = g^T by ldmatrix.trans of the g chunk (cp.async ring), B = the chunk's warp
//   tile built by all threads into shared memory from a band of image rows that slides down the
//   item with the chunks. It writes one partial [slice, L, f, O]; a third launch sums the partials
//   in order, so d_W is the same from run to run (d_img's order follows the atomics).
// What sets the pace on an H100 (PERF.md, Findings; kernels/k8_variants.py's cuts): the forward's W
// stream and its gather each take some 0.24 ms at 64x64x64 alone and barely overlap (0.58 ms),
// W being re-read from L2 by every 128-pixel tile (328 MB per call); pass 1's d_img atomics and
// its latency-bound epilogue (one block an SM), and pass 2's g re-read once per flow pair, where
// the unfused path (the warp kernel and cuBLAS) reads each once. So the fused kernels run 2-2.5
// times slower than warp_flow_ret on this card, where the warp tensor's HBM round trip costs less
// than these L2 streams.
// f32 keeps the first port's bodies (a 64x64 f32 tile per block, gathered into shared memory and
// multiplied on FMAs; K now in blocks of 64 channels, so that any f and O fit): wgmma has no f32 x
// f32 form, only tf32, whose 10-bit mantissas would break the f32 tolerance (1e-5 of the largest)
// that the plain versions are held to.
#include <algorithm>

#include "hopper_common.cuh"
#include "warp_common.cuh"

namespace {

using namespace hopper;
using namespace warpk;

struct RetDims {
  int b, P, L, h, w, f, O;
};

// ---- f32: the first port's bodies, unchanged (templates, now instantiated for float only) ----

__device__ __forceinline__ int sample_index(const RetDims& d, int bi, int p, int l) {
  return (bi * d.P + p) * d.L + l;
}

// The taps of the 64 samples (p0 + i, flow l) of batch item bi into sOff (-1: the tap reads zero)
// and sWt; pixels past P get no taps. Threads 0..63 write; the caller synchronises.
__device__ __forceinline__ void load_taps(int* sOff, float* sWt, const float* iy, const float* ix,
                                          const RetDims& d, int bi, int p0, int l) {
  const int i = threadIdx.x;
  if (i >= TILE) return;
  const int p = p0 + i;
  if (p < d.P) {
    const int s = sample_index(d, bi, p, l);
    const Taps t = make_taps(__ldg(iy + s), __ldg(ix + s), d.h, d.w);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      sOff[i * 4 + k] = t.valid[k] ? t.off[k] : -1;
      sWt[i * 4 + k] = t.wt[k];
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      sOff[i * 4 + k] = -1;
      sWt[i * 4 + k] = 0.0f;
    }
  }
}

// sA[i * lda + j] = the warp sample of pixel p0 + i at channel k0 + j, summed in f32 over its taps
// and rounded, for j < width; zero past f.
template <typename T>
__device__ __forceinline__ void gather_tile(T* sA, int lda, int width, const T* img_item,
                                            const int* sOff, const float* sWt, int f, int k0) {
  for (int idx = threadIdx.x; idx < TILE * width; idx += TILE_THREADS) {
    const int i = idx / width, j = idx % width, k = k0 + j;
    float acc = 0.0f;
    if (k < f) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int off = sOff[i * 4 + t];
        if (off >= 0) acc = fmaf(sWt[i * 4 + t], to_f(img_item[size_t(off) * f + k]), acc);
      }
    }
    sA[i * lda + j] = from_f<T>(acc);
  }
}

// The f32 kernels' tiles are 64 x 64 whatever f and O: K walks f (and, in pass 1, O) in blocks of
// 64, so that every shape fits in shared memory.
template <typename T>
struct FwdLayout {
  int lda, ldb;
  size_t a, b, c, taps, bytes;
  __host__ __device__ FwdLayout() {
    lda = TILE + Pad<T>::value;
    ldb = TILE + Pad<T>::value;
    a = 0;
    b = a + align128(size_t(TILE) * lda * sizeof(T));
    c = b + align128(size_t(TILE) * ldb * sizeof(T));
    taps = c + align128(size_t(TILE) * LDC * sizeof(float));
    bytes = taps + align128(size_t(TILE) * 4 * (sizeof(int) + sizeof(float)));
  }
};

template <typename T>
__global__ void __launch_bounds__(TILE_THREADS)
    warp_ret_fwd_kernel(const float* __restrict__ iy, const float* __restrict__ ix,
                        const T* __restrict__ img, const T* __restrict__ w,
                        const float* __restrict__ bias, T* __restrict__ out, RetDims d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdLayout<T> lay;
  T* sA = reinterpret_cast<T*>(smem + lay.a);
  T* sB = reinterpret_cast<T*>(smem + lay.b);
  float* sC = reinterpret_cast<float*>(smem + lay.c);
  int* sOff = reinterpret_cast<int*>(smem + lay.taps);
  float* sWt = reinterpret_cast<float*>(sOff + TILE * 4);

  const int n_oc = (d.O + TILE - 1) / TILE, n_pt = (d.P + TILE - 1) / TILE;
  int id = blockIdx.x;
  const int o0 = (id % n_oc) * TILE;
  id /= n_oc;
  const int p0 = (id % n_pt) * TILE;
  const int bi = id / n_pt;
  const T* img_item = img + size_t(bi) * d.h * d.w * d.f;

  TileAcc<T> acc;
  tile_zero(acc);
  const int fpad = round_up(d.f, 16);
  for (int l = 0; l < d.L; ++l) {
    for (int k0 = 0; k0 < fpad; k0 += TILE) {
      const int kw = min(TILE, fpad - k0);
      __syncthreads();  // the previous block's product is done with shared memory
      if (k0 == 0) load_taps(sOff, sWt, iy, ix, d, bi, p0, l);
      for (int idx = threadIdx.x; idx < kw * TILE; idx += TILE_THREADS) {
        const int k = k0 + idx / TILE, j = idx % TILE, o = o0 + j;
        sB[(k - k0) * lay.ldb + j] =
            k < d.f && o < d.O ? w[(size_t(l) * d.f + k) * d.O + o] : from_f<T>(0.0f);
      }
      __syncthreads();
      gather_tile(sA, lay.lda, kw, img_item, sOff, sWt, d.f, k0);
      __syncthreads();
      tile_mma<false, false>(sA, lay.lda, sB, lay.ldb, kw, acc);
    }
  }
  tile_store(acc, sC);
  __syncthreads();
  for (int idx = threadIdx.x; idx < TILE * TILE; idx += TILE_THREADS) {
    const int i = idx / TILE, j = idx % TILE, p = p0 + i, o = o0 + j;
    if (p < d.P && o < d.O)
      out[(size_t(bi) * d.P + p) * d.O + o] = from_f<T>(sC[i * LDC + j] + bias[o]);
  }
}

template <typename T>
struct BwdLayout {
  int ld;
  size_t g, wt, c, gl, bytes;
  __host__ __device__ BwdLayout() {
    ld = TILE + Pad<T>::value;
    g = 0;
    wt = g + align128(size_t(TILE) * ld * sizeof(T));
    c = wt + align128(size_t(TILE) * ld * sizeof(T));
    gl = c + align128(size_t(TILE) * LDC * sizeof(float));
    bytes = gl + align128(size_t(TILE) * TILE * sizeof(T));
  }
};

// Pass 1: d_img (f32, zeroed by the caller), d_iy and d_ix; for each flow and block of 64 channels,
// g_l's block from g's and W_l's blocks of 64 output channels, then its warp backward.
template <typename T>
__global__ void __launch_bounds__(TILE_THREADS)
    warp_ret_bwd_img_kernel(const float* __restrict__ iy, const float* __restrict__ ix,
                            const T* __restrict__ img, const T* __restrict__ w,
                            const T* __restrict__ g, float* __restrict__ d_img,
                            float* __restrict__ d_iy, float* __restrict__ d_ix, RetDims d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdLayout<T> lay;
  T* sG = reinterpret_cast<T*>(smem + lay.g);
  T* sW = reinterpret_cast<T*>(smem + lay.wt);
  float* sC = reinterpret_cast<float*>(smem + lay.c);
  T* sGl = reinterpret_cast<T*>(smem + lay.gl);

  const int n_pt = (d.P + TILE - 1) / TILE;
  const int p0 = (blockIdx.x % n_pt) * TILE, bi = blockIdx.x / n_pt;
  const size_t img_item = size_t(bi) * d.h * d.w * d.f;
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;

  for (int l = 0; l < d.L; ++l) {
    for (int k0 = 0; k0 < d.f; k0 += TILE) {
      // g_l's channels k0 .. k0 + 63 = g W_l^T over 64 output channels at a time
      TileAcc<T> acc;
      tile_zero(acc);
      for (int o0 = 0; o0 < d.O; o0 += TILE) {
        __syncthreads();  // sG, sW (and sGl, sC) free again
        for (int idx = threadIdx.x; idx < TILE * TILE; idx += TILE_THREADS) {
          const int j = idx / TILE, o = idx % TILE, k = k0 + j, p = p0 + j;
          sW[j * lay.ld + o] =
              k < d.f && o0 + o < d.O ? w[(size_t(l) * d.f + k) * d.O + o0 + o] : from_f<T>(0.0f);
          sG[j * lay.ld + o] =
              p < d.P && o0 + o < d.O ? g[(size_t(bi) * d.P + p) * d.O + o0 + o] : from_f<T>(0.0f);
        }
        __syncthreads();
        tile_mma<false, true>(sG, lay.ld, sW, lay.ld, TILE, acc);
      }
      tile_store(acc, sC);
      __syncthreads();
      for (int idx = threadIdx.x; idx < TILE * TILE; idx += TILE_THREADS) {
        const int i = idx / TILE, j = idx % TILE;
        sGl[i * TILE + j] = from_f<T>(sC[i * LDC + j]);
      }
      __syncthreads();
      // the warp's backward of those channels of g_l: one warp per sample (p is the same for all
      // lanes of a warp; the warp that owns a sample owns it for every k0)
      for (int i = wi; i < TILE; i += TILE_THREADS / 32) {
        const int p = p0 + i;
        if (p >= d.P) break;
        const int s = sample_index(d, bi, p, l);
        const Taps t = make_taps(__ldg(iy + s), __ldg(ix + s), d.h, d.w);
        float dy = 0.0f, dx = 0.0f;
        for (int k = k0 + lane; k < min(d.f, k0 + TILE); k += 32) {
          const float gv = to_f(sGl[i * TILE + k - k0]);
          float v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            v[q] = t.valid[q] ? to_f(img[img_item + size_t(t.off[q]) * d.f + k]) : 0.0f;
          dy += gv * (t.wx0 * (v[2] - v[0]) + t.wx1 * (v[3] - v[1]));
          dx += gv * (t.wy0 * (v[1] - v[0]) + t.wy1 * (v[3] - v[2]));
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (t.valid[q]) atomicAdd(d_img + img_item + size_t(t.off[q]) * d.f + k, gv * t.wt[q]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          dy += __shfl_xor_sync(0xffffffffu, dy, o);
          dx += __shfl_xor_sync(0xffffffffu, dx, o);
        }
        if (lane == 0) {
          d_iy[s] = k0 > 0 ? d_iy[s] + dy : dy;
          d_ix[s] = k0 > 0 ? d_ix[s] + dx : dx;
        }
      }
    }
  }
}

template <typename T>
struct DwLayout {
  int ld;
  size_t a, g, c, taps, bytes;
  __host__ __device__ DwLayout() {
    ld = TILE + Pad<T>::value;
    a = 0;
    g = a + align128(size_t(TILE) * ld * sizeof(T));
    c = g + align128(size_t(TILE) * ld * sizeof(T));
    taps = c + align128(size_t(TILE) * LDC * sizeof(float));
    bytes = taps + align128(size_t(TILE) * 4 * (sizeof(int) + sizeof(float)));
  }
};

// Pass 2: partial[s, l, k, o] = sum over the pixel tiles s, s + S, ... of warp_l^T g.
template <typename T>
__global__ void __launch_bounds__(TILE_THREADS)
    warp_ret_bwd_dw_kernel(const float* __restrict__ iy, const float* __restrict__ ix,
                           const T* __restrict__ img, const T* __restrict__ g,
                           float* __restrict__ partial, int n_slices, RetDims d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const DwLayout<T> lay;
  T* sA = reinterpret_cast<T*>(smem + lay.a);
  T* sG = reinterpret_cast<T*>(smem + lay.g);
  float* sC = reinterpret_cast<float*>(smem + lay.c);
  int* sOff = reinterpret_cast<int*>(smem + lay.taps);
  float* sWt = reinterpret_cast<float*>(sOff + TILE * 4);

  const int n_kc = (d.f + TILE - 1) / TILE, n_oc = (d.O + TILE - 1) / TILE;
  const int n_pt = (d.P + TILE - 1) / TILE, n_tiles = d.b * n_pt;
  int id = blockIdx.x;
  const int o0 = (id % n_oc) * TILE;
  id /= n_oc;
  const int k0 = (id % n_kc) * TILE;
  id /= n_kc;
  const int l = id % d.L, s = id / d.L;

  TileAcc<T> acc;
  tile_zero(acc);
  for (int tile = s; tile < n_tiles; tile += n_slices) {
    const int bi = tile / n_pt, p0 = (tile % n_pt) * TILE;
    __syncthreads();  // the previous tile's product is done with shared memory
    load_taps(sOff, sWt, iy, ix, d, bi, p0, l);
    for (int idx = threadIdx.x; idx < TILE * TILE; idx += TILE_THREADS) {
      const int i = idx / TILE, o = idx % TILE, p = p0 + i;
      sG[i * lay.ld + o] =
          p < d.P && o0 + o < d.O ? g[(size_t(bi) * d.P + p) * d.O + o0 + o] : from_f<T>(0.0f);
    }
    __syncthreads();
    gather_tile(sA, lay.ld, TILE, img + size_t(bi) * d.h * d.w * d.f, sOff, sWt, d.f, k0);
    __syncthreads();
    tile_mma<true, false>(sA, lay.ld, sG, lay.ld, TILE, acc);
  }
  tile_store(acc, sC);
  __syncthreads();
  float* dst = partial + (size_t(s) * d.L + l) * d.f * d.O;
  for (int idx = threadIdx.x; idx < TILE * TILE; idx += TILE_THREADS) {
    const int i = idx / TILE, j = idx % TILE;
    if (k0 + i < d.f && o0 + j < d.O) dst[size_t(k0 + i) * d.O + o0 + j] = sC[i * LDC + j];
  }
}

// ---- bf16: the Hopper kernels ------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int KCH = 32;             // forward: K of one item, 32 channels of one flow (two k16 steps)
constexpr int W_STAGES = 4;         // forward: ring of W stages
constexpr int W_AHEAD = W_STAGES - 2;
constexpr int CW = 32;              // pass 1: channels of a pass, its wgmma N
constexpr int P1_STAGES = 2;        // pass 1: ring of W^T stages, one flow's each
constexpr int KSMAX = 18;           // pass 1: g's k16 steps held in registers at once, a chunk of O
constexpr int CHUNK = 64;           // pass 2: output pixels of a K chunk
constexpr int G_STAGES = 3;         // pass 2: ring of g chunks (with their band rows and indices)
// pass 2: the ring's iy, ix of each chunk and of each of the block's fl flows
__host__ __device__ constexpr int idx_bytes(int fl) { return G_STAGES * fl * 2 * CHUNK * 4; }

__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// acc[0 .. 8) += wt * the 8 bf16 values of raw.
__device__ __forceinline__ void fma8(float (&acc)[8], float wt, const uint4& raw) {
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(e[i]);
    acc[2 * i] = fmaf(wt, v.x, acc[2 * i]);
    acc[2 * i + 1] = fmaf(wt, v.y, acc[2 * i + 1]);
  }
}

template <int R, int C>
__device__ __forceinline__ void fence_u32(uint32_t (&a)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// The plan of one call's bf16 kernels (vp_warp_ret_geometry reports it; the Python mirror is
// kernels/k8_variants.py's plan). f and O are multiples of 8 (the wrappers pad them).
struct RetPlan {
  int fpad;        // forward: f padded to 32, its K items' channels and its band's pixel stride
  int fwd_wg;      // forward: warpgroups of a block, one m64 tile of output pixels each
  int fwd_onb;     // forward: n96 products of a pass of output channels (1-3)
  int fwd_opasses; // forward: passes over O (a grid dimension)
  int fwd_R;       // forward: band radius in rows
  int fwd_rows;    // forward: band rows (0: every tap reads global memory)
  int fwd_tiles;   // forward: pixel tiles of one item
  int p1_wg;       // pass 1: warpgroups of a block
  int p1_passes;   // pass 1: channel passes of CW
  int p1_ks;       // pass 1: k16 steps over O (O padded to 16)
  int p1_R;        // pass 1: band radius in rows
  int p1_rows;     // pass 1: band rows (0: every tap reads global memory)
  int p1_tiles;    // pass 1: pixel tiles of one item
  int p1_gtile;    // pass 1: 1: the whole g tile staged once; 0: g streamed a chunk of O an item
  int p1_sidx;     // pass 1: 1: the tile's indices of all flows staged; 0: read from global memory
  int p2_nb;       // pass 2: wgmma N, a channel pass (f padded to 32, 64, 96 or 128)
  int p2_fpasses;  // pass 2: channel passes
  int p2_mt;       // pass 2: m64 tiles of output channels per warpgroup
  int p2_opasses;  // pass 2: passes over O of 128 * p2_mt
  int p2_os;       // pass 2: row stride of a g chunk in shared memory
  int p2_R;        // pass 2: band radius in rows
  int p2_rows;     // pass 2: rows of the band ring (0: every tap reads global memory)
  int p2_parts;    // pass 2: parts of an item's chunks, each a block and a d_W partial
  int p2_fl;       // pass 2: flows of a block (2 where their accumulators fit: p2_mt * p2_nb <= 128)
  size_t fwd_smem, p1_smem, p2_smem;
  int64_t fwd_blocks, p1_blocks, p2_blocks;
};

// The most image rows that a run of `len` output pixels starting at a multiple of `step` spans (a
// pixel p lies on row p / w, as if the output were the image), over an item's runs.
int max_span(int P, int w, int step, int len) {
  int64_t best = 1;
  const int64_t runs = std::min<int64_t>((P + step - 1) / step, w);  // the pattern repeats every w
  for (int64_t k = 0; k < runs; ++k) {
    const int64_t p0 = k * step, p1 = std::min<int64_t>(p0 + len, P) - 1;
    best = std::max(best, p1 / w - p0 / w + 1);
  }
  return int(best);
}

// The tiling on a card of `sms` SMs whose blocks may opt into `smem_max` bytes of shared memory.
// Forward: tiles of 128 pixels and all O in one pass where O <= 288, while that gives at least one
// block per SM, else one warpgroup's 64 pixels, then fewer n96 products a pass. Its band: the
// tile's rows and R above and below (R = 6 at w >= 48, else 4), at the full width, all fpad
// channels; R, then the rows, shrink until the band fits beside the W ring. Pass 1: tiles of 128
// pixels (64 where that gives fewer blocks than SMs), its band as the forward's, for CW channels;
// where the g tile, the W^T ring (chunks of KSMAX k16 steps of O) and the indices do not fit, one
// warpgroup, then the indices read from global memory, g streamed by chunks beside W^T, or both.
// Pass 2: chunks of 64 pixels, a block per (flows, item, part), the band a ring of the rows two
// chunks and R above and below span (R shrinks; none where even R = 0 does not fit).
RetPlan make_plan(const RetDims& d, int n_slices, int sms, int smem_max) {
  RetPlan p;
  p.fpad = round_up(d.f, KCH);
  p.fwd_onb = std::min(3, (d.O + 95) / 96);
  p.fwd_wg = 2;
  auto fwd_count = [&]() {
    p.fwd_opasses = (d.O + 96 * p.fwd_onb - 1) / (96 * p.fwd_onb);
    p.fwd_tiles = (d.P + 64 * p.fwd_wg - 1) / (64 * p.fwd_wg);
    return int64_t(d.b) * p.fwd_tiles * p.fwd_opasses;
  };
  while (fwd_count() < sms && (p.fwd_wg > 1 || p.fwd_onb > 1)) {
    if (p.fwd_wg > 1)
      p.fwd_wg = 1;
    else
      --p.fwd_onb;
  }
  p.fwd_blocks = fwd_count();
  const size_t ring = size_t(W_STAGES) * KCH * 96 * p.fwd_onb * 2;
  const int span = max_span(d.P, d.w, 64 * p.fwd_wg, 64 * p.fwd_wg);
  auto band = [&](int rows) { return align128(size_t(rows) * d.w * p.fpad * 2); };
  p.fwd_R = d.w >= 48 ? 6 : 4;
  while (p.fwd_R > 0 && ring + band(std::min(d.h, span + 2 * p.fwd_R)) > size_t(smem_max)) --p.fwd_R;
  p.fwd_rows = std::min(d.h, span + 2 * p.fwd_R);
  while (p.fwd_rows > 0 && ring + band(p.fwd_rows) > size_t(smem_max)) --p.fwd_rows;
  p.fwd_smem = band(p.fwd_rows) + ring;

  p.p1_passes = (d.f + CW - 1) / CW;
  p.p1_ks = round_up(d.O, 16) / 16;
  const int kc = std::min(p.p1_ks, KSMAX);
  auto fixed1_of = [&]() {
    const size_t tp = 64 * p.p1_wg;
    return (p.p1_gtile ? align128(tp * (16 * p.p1_ks + 8) * 2) : 2 * align128(tp * (16 * kc + 8) * 2)) +
           size_t(P1_STAGES) * 16 * kc * CW * 2 + (p.p1_sidx ? align128(2 * tp * d.L * 4) : 0);
  };
  // (p1_wg, p1_gtile, p1_sidx): the first that fits of the tiling by the block count, one
  // warpgroup, then the indices from global memory, g streamed, both
  const int wg0 = int64_t(d.b) * ((d.P + 127) / 128) < sms ? 1 : 2;
  const int tries[5][3] = {{wg0, 1, 1}, {1, 1, 1}, {1, 1, 0}, {1, 0, 1}, {1, 0, 0}};
  for (const auto& t : tries) {
    p.p1_wg = t[0];
    p.p1_gtile = t[1];
    p.p1_sidx = t[2];
    if (fixed1_of() <= size_t(smem_max)) break;
  }
  const size_t fixed1 = fixed1_of();
  p.p1_tiles = (d.P + 64 * p.p1_wg - 1) / (64 * p.p1_wg);
  p.p1_blocks = int64_t(d.b) * p.p1_tiles;
  auto band1 = [&](int rows) { return align128(size_t(rows) * d.w * CW * 2); };
  const int span1 = max_span(d.P, d.w, 64 * p.p1_wg, 64 * p.p1_wg);
  p.p1_R = d.w >= 48 ? 6 : 4;
  while (p.p1_R > 0 && fixed1 + band1(std::min(d.h, span1 + 2 * p.p1_R)) > size_t(smem_max)) --p.p1_R;
  p.p1_rows = std::min(d.h, span1 + 2 * p.p1_R);
  while (p.p1_rows > 0 && fixed1 + band1(p.p1_rows) > size_t(smem_max)) --p.p1_rows;
  p.p1_smem = band1(p.p1_rows) + fixed1;

  p.p2_nb = d.f <= 32 ? 32 : d.f <= 64 ? 64 : d.f <= 96 ? 96 : 128;
  p.p2_fpasses = (d.f + p.p2_nb - 1) / p.p2_nb;
  p.p2_mt = std::min(std::min(3, (d.O + 127) / 128), p.p2_nb == 128 ? 2 : 3);
  p.p2_opasses = (d.O + 128 * p.p2_mt - 1) / (128 * p.p2_mt);
  p.p2_os = std::min(128 * p.p2_mt, d.O) + 8;
  p.p2_parts = n_slices / d.b;
  p.p2_fl = p.p2_mt * p.p2_nb <= 128 ? 2 : 1;
  // the last m64 tile's rows past O read up to 256 * p2_mt bytes past the last g stage
  const size_t fixed2 = idx_bytes(p.p2_fl) + size_t(G_STAGES) * align128(size_t(CHUNK) * p.p2_os * 2) +
                        256 * p.p2_mt + size_t(2) * p.p2_fl * CHUNK * p.p2_nb * 2;
  auto band2 = [&](int rows) { return align128(size_t(rows) * d.w * p.p2_nb * 2); };
  const int span2 = max_span(d.P, d.w, CHUNK, 2 * CHUNK);
  p.p2_R = d.w >= 48 ? 6 : 4;
  while (p.p2_R > 0 && fixed2 + band2(std::min(d.h, span2 + 2 * p.p2_R)) > size_t(smem_max)) --p.p2_R;
  p.p2_rows = std::min(d.h, span2 + 2 * p.p2_R);
  if (fixed2 + band2(p.p2_rows) > size_t(smem_max)) p.p2_rows = 0;
  p.p2_smem = band2(p.p2_rows) + fixed2;
  p.p2_blocks = int64_t((d.L + p.p2_fl - 1) / p.p2_fl) * n_slices * p.p2_fpasses * p.p2_opasses;
  return p;
}

// The forward: a block per (batch item, tile of 64*WG output pixels, pass of 96*ONB output
// channels). The block copies its band of image rows (the tile's rows and R above and below, at
// the full width, fpad channels per pixel) into shared memory once by cp.async. Its K walks the L
// flows in items of KCH channels; W_l's rows of an item stream through a ring of W_STAGES stages
// as wgmma's MN-major B (N = the pass's channels, K rows permuted as below). Each thread builds its
// two fragment rows' samples straight into wgmma's A registers: the taps of its two output pixels
// (computed once per flow), each tap's 8 channels one 16-byte load from the band (or, outside it,
// from global memory), summed in f32 and rounded to bf16 pairs. A k16 step's columns 2t, 2t+1,
// 2t+8, 2t+9 of thread t are channels 8t .. 8t+3 (step 0) and 8t+4 .. 8t+7 (step 1) of the item, so
// that one load serves both steps; the W stage holds its rows in that order. The products run
// pipelined (item u's fragments are built while item u-1's wgmmas run), the accumulators [64*WG x
// 96*ONB] stay in registers over all L flows, and the epilogue adds the bias and rounds once.
template <int WG, int ONB>
__global__ void __launch_bounds__(128 * WG, 1)
    warp_ret_fwd_bf16_kernel(const float* __restrict__ iy, const float* __restrict__ ix,
                             const bf16* __restrict__ img, const bf16* __restrict__ w,
                             const float* __restrict__ bias, bf16* __restrict__ out, RetDims d,
                             RetPlan q) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int TP = 64 * WG, NT = 128 * WG, ON = 96 * ONB, NG = ON / 8, STAGE = KCH * ON;
  const int fp = q.fpad, KC = fp / KCH, n_items = d.L * KC;
  bf16* band = reinterpret_cast<bf16*>(smem);  // [rows * w][fp]
  bf16* ring = reinterpret_cast<bf16*>(smem + align128(size_t(q.fwd_rows) * d.w * fp * 2));
  const int bi = blockIdx.x / q.fwd_tiles, p0 = (blockIdx.x % q.fwd_tiles) * TP;
  const int o0 = blockIdx.y * ON;
  const int row0 = max(0, min(p0 / d.w - q.fwd_R, d.h - q.fwd_rows));
  const int band_off = row0 * d.w, band_px = q.fwd_rows * d.w;
  const bf16* img_b = img + size_t(bi) * d.h * d.w * d.f;
  const int lane = threadIdx.x % 32, t = lane % 4;
  const int wrow = (threadIdx.x / 32) * 16 + lane / 4;  // the thread's first fragment row

  // item u = (flow u / KC, channels KCH * (u % KC) ..): row k of the stage is channel
  // 8 ((k%8)/2) + 4 (k/16) + 2 ((k%16)/8) + k%2 of the item; core matrix (k/8, n/8) at
  // ((k/8) * NG + n/8) * 128 bytes, eight 16-byte rows (one per k) of 8 output channels
  auto fetch = [&](int u) {
    bf16* st = ring + (u % W_STAGES) * STAGE;
    const int l = u / KC, kc = u % KC;
    for (int idx = threadIdx.x; idx < KCH * NG; idx += NT) {
      const int k = (idx / (8 * NG)) * 8 + idx % 8, n8 = (idx / 8) % NG, kk = k % 16;
      const int ch = kc * KCH + 8 * ((kk % 8) / 2) + 4 * (k / 16) + 2 * (kk / 8) + kk % 2;
      const int o = o0 + n8 * 8;
      const bool in = ch < d.f && o < d.O;
      cp_async16(st + ((k / 8) * NG + n8) * 64 + (k % 8) * 8,
                 in ? w + (size_t(l) * d.f + ch) * d.O + o : w, in);
    }
  };
  for (int u = threadIdx.x; u < band_px * (fp / 8); u += NT) {
    const int px = u / (fp / 8), c8 = (u % (fp / 8)) * 8;
    const bool in = c8 < d.f;
    cp_async16(band + size_t(px) * fp + c8, in ? img_b + size_t(band_off + px) * d.f + c8 : img_b, in);
  }
#pragma unroll
  for (int u = 0; u < W_AHEAD; ++u) {  // the band lands with the first stage
    if (u < n_items) fetch(u);
    cp_async_commit();
  }

  // the taps of the current flow at the thread's two pixels (offset -1: the tap reads zero),
  // and the next flow's indices, loaded a flow ahead
  int toff[2][4];
  float twt[2][4], ny[2], nx[2];
  auto load_idx = [&](int l) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + wrow + 8 * h;
      const size_t s = (size_t(bi) * d.P + p) * d.L + l;
      ny[h] = p < d.P && l < d.L ? __ldg(iy + s) : 0.0f;
      nx[h] = p < d.P && l < d.L ? __ldg(ix + s) : 0.0f;
    }
  };
  load_idx(0);

  auto build = [&](uint32_t (&a)[2][4], int u) {
    const int kc = u % KC, cb = kc * KCH + 8 * t;
    if (kc == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const Taps tp = make_taps(ny[h], nx[h], d.h, d.w);
        const bool live = p0 + wrow + 8 * h < d.P;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          toff[h][k] = live && tp.valid[k] ? tp.off[k] : -1;
          twt[h][k] = tp.wt[k];
        }
      }
      load_idx(u / KC + 1);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int off = toff[h][k];
        if (off < 0) continue;
        const int bp = off - band_off;
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);
        if (unsigned(bp) < unsigned(band_px))  // in the band: shared memory
          raw = *reinterpret_cast<const uint4*>(band + size_t(bp) * fp + cb);
        else if (cb < d.f)  // out of the band: global memory
          raw = __ldg(reinterpret_cast<const uint4*>(img_b + size_t(off) * d.f + cb));
        fma8(v, twt[h][k], raw);
      }
      a[0][h] = pack_bf2(v[0], v[1]);
      a[0][h + 2] = pack_bf2(v[2], v[3]);
      a[1][h] = pack_bf2(v[4], v[5]);
      a[1][h + 2] = pack_bf2(v[6], v[7]);
    }
  };

  float acc[ONB][48];
#pragma unroll
  for (int nb = 0; nb < ONB; ++nb)
#pragma unroll
    for (int i = 0; i < 48; ++i) acc[nb][i] = 0.0f;
  uint32_t fa[2][4], fb[2][4];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) fa[s][i] = fb[s][i] = 0u;
  // item u's fragments are built and its wgmmas issued while item u-1's still run; the stage
  // refilled at item u is item u-2's, which every warpgroup has waited for before the barrier
  auto step = [&](int u, uint32_t (&frags)[2][4], uint32_t (&prev)[2][4]) {
    cp_async_wait<W_AHEAD - 1>();  // this thread's copies of item u (and the band) have landed
    fence_proxy_async();
    __syncthreads();               // everyone's have, and item u-2's stage is free again
    if (u + W_AHEAD < n_items) fetch(u + W_AHEAD);
    cp_async_commit();
    build(frags, u);
    const bf16* st = ring + (u % W_STAGES) * STAGE;
#pragma unroll
    for (int nb = 0; nb < ONB; ++nb) fence_regs(acc[nb]);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int nb = 0; nb < ONB; ++nb)
        Wgmma<96>::template mma<1>(acc[nb], frags[s], wgmma_desc(st + s * ON * 16 + nb * 96 * 8, ON * 16, 128));
    wgmma_commit();
    wgmma_wait<1>();  // item u-1's products are done: its fragment set is free
    fence_u32(prev);
  };
  for (int u = 0; u < n_items; u += 2) {
    step(u, fa, fb);
    if (u + 1 < n_items) step(u + 1, fb, fa);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int nb = 0; nb < ONB; ++nb) fence_regs(acc[nb]);
  cp_async_wait<0>();

  // out = acc + bias, rounded once; accumulator acc[nb][4j + 2h + e] is row wrow + 8h, channel
  // o0 + 96 nb + 8j + 2t + e
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = p0 + wrow + 8 * h;
    if (p >= d.P) continue;
    bf16* dst = out + (size_t(bi) * d.P + p) * d.O;
#pragma unroll
    for (int nb = 0; nb < ONB; ++nb)
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const int o = o0 + 96 * nb + 8 * j + 2 * t;
        if (o < d.O)
          *reinterpret_cast<uint32_t*>(dst + o) =
              pack_bf2(acc[nb][4 * j + 2 * h] + bias[o], acc[nb][4 * j + 2 * h + 1] + bias[o + 1]);
      }
  }
}

// Pass 1 (K8b and K8c's index half): a block per (batch item, tile of 64*WG output pixels). The
// g tile [pixels][O] and the tile's indices of all flows are staged once, and g's A fragments
// (K = O) held in registers. For each pass
// of CW channels the block copies the band of image rows around its tile (the tile's rows and R
// above and below, full width, the pass's channels); then, for each flow l, g_l = g W_l^T for the
// pass's channels on wgmma (N = CW, W_l^T's columns streamed through a ring as K-major B, columns
// permuted so that thread t's accumulators are channels 8t .. 8t+7), and the epilogue uses it at
// once (ptxas serializes a second accumulator set's wgmmas with it, so there is none): g_l rounded
// to bf16 in registers; per sample its four taps' 8 channels
// read from the band (outside it, global memory) for d_iy and d_ix, reduced over the quad by
// shuffles; each tap's g_l * weight added into d_img by two float4 atomics (red.global.add.v4.f32:
// measured faster here than a shared window of f32 sums updated by 128-bit compare-and-swaps, the
// warp backward's design; PERF.md, Findings). d_iy and d_ix sum over the passes in place (the
// thread that owns a sample owns it in every pass).
// Past O = 288 (KSMAX k16 steps) a ring item is one chunk of O of one flow: a W^T stage holds the
// chunk's rows, g's fragments are reloaded per item (from the staged g tile, or, where it does not
// fit (q.p1_gtile = 0), from a chunk of g fetched with the W^T stage into a second ring), and the
// epilogue runs after the flow's last chunk. Where the indices do not fit (q.p1_sidx = 0) the
// epilogue reads them from global memory.
template <int WG>
__global__ void __launch_bounds__(128 * WG, 1)
    warp_ret_bwd_img_bf16_kernel(const float* __restrict__ iy, const float* __restrict__ ix,
                                 const bf16* __restrict__ img, const bf16* __restrict__ w,
                                 const bf16* __restrict__ g, float* __restrict__ d_img,
                                 float* __restrict__ d_iy, float* __restrict__ d_ix, RetDims d,
                                 RetPlan q) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int TP = 64 * WG, NT = 128 * WG;
  // K = O in chunks of KSMAX k16 steps (one chunk at O <= 288), each kc steps a stage
  const int ks = q.p1_ks, kc = min(ks, KSMAX), nch = (ks + KSMAX - 1) / KSMAX, n_items = d.L * nch;
  const int gs = (q.p1_gtile ? 16 * ks : 16 * kc) + 8, stage = 16 * kc * CW;
  const int gstage = int(align128(size_t(TP) * gs * 2) / 2);
  const int band_px = q.p1_rows * d.w;
  bf16* band = reinterpret_cast<bf16*>(smem);                      // [band_px][CW]
  bf16* sG = band + align128(size_t(band_px) * CW * 2) / 2;        // [TP][gs], or 2 stages of a chunk
  bf16* ring = sG + (q.p1_gtile ? 1 : 2) * gstage;                 // P1_STAGES x stage
  float* sidx = reinterpret_cast<float*>(ring + P1_STAGES * stage);  // [iy, ix][TP][L]
  const int bi = blockIdx.x / q.p1_tiles, p0 = (blockIdx.x % q.p1_tiles) * TP;
  const int row0 = max(0, min(p0 / d.w - q.p1_R, d.h - q.p1_rows));
  const int band_off = row0 * d.w;
  const size_t item = size_t(bi) * d.h * d.w * d.f;
  const bf16* img_b = img + item;
  float* dimg_b = d_img + item;
  const int lane = threadIdx.x % 32, t = lane % 4;
  const int wrow = (threadIdx.x / 32) * 16 + lane / 4;

  // item u = (flow u / nch, chunk u % nch of O): W_l^T's rows of the chunk for the pass at c0,
  // K-major: core matrix (k/8, n/8) at ((k/8) * 4 + n/8) * 128 bytes, eight 16-byte rows (one per
  // column n, 8 values of k = o); column n is channel c0 + 8 ((n%8)/2) + 2 (n/8) + n%2
  auto fetch = [&](int c0, int u) {
    const int l = u / nch, o0 = (u % nch) * 16 * KSMAX;
    bf16* st = ring + (u % P1_STAGES) * stage;
    for (int idx = threadIdx.x; idx < CW * 2 * kc; idx += NT) {
      const int n = idx % CW, kq = idx / CW;
      const int ch = c0 + 8 * ((n % 8) / 2) + 2 * (n / 8) + n % 2;
      const bool in = ch < d.f && o0 + kq * 8 < d.O;
      cp_async16(st + ((kq * (CW / 8) + n / 8) * 8 + n % 8) * 8,
                 in ? w + (size_t(l) * d.f + ch) * d.O + o0 + kq * 8 : w, in);
    }
    if (!q.p1_gtile) {  // the chunk of g, zeros past P and past O
      bf16* gu = sG + (u % 2) * gstage;
      for (int idx = threadIdx.x; idx < TP * 2 * kc; idx += NT) {
        const int r = idx / (2 * kc), k8 = (idx % (2 * kc)) * 8;
        const bool in = p0 + r < d.P && o0 + k8 < d.O;
        cp_async16(gu + r * gs + k8, in ? g + (size_t(bi) * d.P + p0 + r) * d.O + o0 + k8 : g, in);
      }
    }
  };
  uint32_t gf[KSMAX][4];
  // g's fragments of n_s k16 steps from column 0 of gb
  auto load_gf = [&](const bf16* gb, int n_s) {
#pragma unroll
    for (int s = 0; s < KSMAX; ++s)
      if (s < n_s)
        ldmatrix_x4(gf[s], gb + ((threadIdx.x / 32) * 16 + lane % 16) * gs + 16 * s + (lane / 16) * 8);
  };
  // acc += g_l's columns of the pass over n_s k16 steps of O
  auto products = [&](float (&acc)[16], const bf16* st, int n_s) {
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < KSMAX; ++s)
      if (s < n_s)
        Wgmma<CW>::mma(acc, gf[s], wgmma_desc(st + s * 16 * CW, CW * 16, 128));
    wgmma_commit();
  };

  // the epilogue of flow l for the pass at c0: acc[4j + 2h + e] is g_l at row wrow + 8h, channel
  // c0 + 8t + 2j + e
  auto epilogue = [&](int l, int c0, float (&acc)[16]) {
    const int cb = c0 + 8 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + wrow + 8 * h;
      const bool live = p < d.P;
      const size_t s = (size_t(bi) * d.P + p) * d.L + l;
      float dy = 0.0f, dx = 0.0f;
      if (live) {
        const int r = (wrow + 8 * h) * d.L + l;
        const Taps tp = q.p1_sidx ? make_taps(sidx[r], sidx[TP * d.L + r], d.h, d.w)
                                  : make_taps(__ldg(iy + s), __ldg(ix + s), d.h, d.w);
        float gl[8], val[4][8];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            gl[2 * j + e] = __bfloat162float(__float2bfloat16(acc[4 * j + 2 * h + e]));
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int i = 0; i < 8; ++i) val[k][i] = 0.0f;
          if (!tp.valid[k]) continue;
          if (cb >= d.f) continue;  // the pass's channels past f: g_l and the image are zero
          const int bp = tp.off[k] - band_off;
          const uint4 raw =
              unsigned(bp) < unsigned(band_px)
                  ? *reinterpret_cast<const uint4*>(band + size_t(bp) * CW + 8 * t)
                  : __ldg(reinterpret_cast<const uint4*>(img_b + size_t(tp.off[k]) * d.f + cb));
          fma8(val[k], 1.0f, raw);
          const float wt = tp.wt[k];
          float4* dst = reinterpret_cast<float4*>(dimg_b + size_t(tp.off[k]) * d.f + cb);
          atomicAdd(dst, make_float4(gl[0] * wt, gl[1] * wt, gl[2] * wt, gl[3] * wt));
          atomicAdd(dst + 1, make_float4(gl[4] * wt, gl[5] * wt, gl[6] * wt, gl[7] * wt));
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          dy += gl[i] * (tp.wx0 * (val[2][i] - val[0][i]) + tp.wx1 * (val[3][i] - val[1][i]));
          dx += gl[i] * (tp.wy0 * (val[1][i] - val[0][i]) + tp.wy1 * (val[3][i] - val[2][i]));
        }
      }
      dy += __shfl_xor_sync(0xffffffffu, dy, 1);
      dx += __shfl_xor_sync(0xffffffffu, dx, 1);
      dy += __shfl_xor_sync(0xffffffffu, dy, 2);
      dx += __shfl_xor_sync(0xffffffffu, dx, 2);
      if (live && t == 0) {
        d_iy[s] = c0 > 0 ? d_iy[s] + dy : dy;
        d_ix[s] = c0 > 0 ? d_ix[s] + dx : dx;
      }
    }
  };

  for (int pc = 0; pc < q.p1_passes; ++pc) {
    const int c0 = pc * CW;
    for (int u = threadIdx.x; u < band_px * (CW / 8); u += NT) {
      const int px = u / (CW / 8), c8 = (u % (CW / 8)) * 8;
      const bool in = c0 + c8 < d.f;
      cp_async16(band + size_t(px) * CW + c8,
                 in ? img_b + size_t(band_off + px) * d.f + c0 + c8 : img_b, in);
    }
    if (pc == 0 && q.p1_gtile) {  // the g tile, zeros past P and past O
      for (int idx = threadIdx.x; idx < TP * 2 * ks; idx += NT) {
        const int r = idx / (2 * ks), k8 = (idx % (2 * ks)) * 8;
        const bool in = p0 + r < d.P && k8 < d.O;
        cp_async16(sG + r * gs + k8, in ? g + (size_t(bi) * d.P + p0 + r) * d.O + k8 : g, in);
      }
    }
    if (pc == 0 && q.p1_sidx) {  // the tile's indices
      for (int idx = threadIdx.x; idx < 2 * TP * d.L; idx += NT) {
        const int e = idx % (TP * d.L);
        const float* src = idx < TP * d.L ? iy : ix;
        const bool in = p0 + e / d.L < d.P;
        cp_async_ca<4>(sidx + idx, in ? src + (size_t(bi) * d.P + p0) * d.L + e : src, in);
      }
    }
    fetch(c0, 0);
    cp_async_commit();
    float acc[16];
    for (int u = 0; u < n_items; ++u) {
      const int c = u % nch, n_s = min(KSMAX, ks - c * KSMAX);
      cp_async_wait<0>();  // item u's stages (and the band, g tile and indices) have landed
      fence_proxy_async();
      __syncthreads();     // everyone's have, and item u-1's stages are free
      if (nch > 1 || (pc == 0 && u == 0))  // one chunk holds all of O: its fragments load once
        load_gf(q.p1_gtile ? sG + c * 16 * KSMAX : sG + (u % 2) * gstage, n_s);
      if (u + 1 < n_items) fetch(c0, u + 1);
      cp_async_commit();
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
      }
      products(acc, ring + (u % P1_STAGES) * stage, n_s);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_u32(gf);
      if (c == nch - 1) epilogue(u / nch, c0, acc);
    }
    __syncthreads();  // every epilogue is done with the band
  }
}

// Pass 2 (K8c's d_W): a block per (FL flows from l0, batch item, part of the item's 64-pixel chunks,
// pass of NB channels and of 128*MT output channels) accumulates d_W_l^T [O rows, NB channels] =
// g^T warp_l of each of its flows over its chunks on wgmma: A = g^T, fragments by ldmatrix.trans
// of the g chunk (staged [64 pixels][O] through a ring by cp.async, read once for the FL flows),
// B = the chunk's warp tile of a flow [64 pixels (K)][NB] built by all threads into shared memory
// (MN-major: 16 bytes a pixel's 8 channels), each 8 channels of a sample one 16-byte load per tap
// from the band, summed in f32 and rounded. The band is a ring of image rows that slides down the
// item with the chunks: it holds the rows that a chunk and R above and below span, fetched two
// chunks ahead with the g chunk; a tap outside reads global memory. The block writes each flow's
// sum as one partial [slice = item * parts + part, l, f, O]; sum_slices_kernel adds the partials in
// order.
template <int MT, int NB, int FL>
__global__ void __launch_bounds__(256, 1)
    warp_ret_bwd_dw_bf16_kernel(const float* __restrict__ iy, const float* __restrict__ ix,
                                const bf16* __restrict__ img, const bf16* __restrict__ g,
                                float* __restrict__ partial, RetDims d, RetPlan q) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int NV = NB / 8, NI = CHUNK * NV / 256;  // 8-channel vectors of a pixel; per thread
  const int BR = q.p2_rows, os = q.p2_os;
  const size_t gstage = align128(size_t(CHUNK) * os * 2) / 2;
  float* sidx = reinterpret_cast<float*>(smem);  // G_STAGES x FL x [iy, ix][CHUNK]: the indices
  bf16* band = reinterpret_cast<bf16*>(smem + idx_bytes(FL));                       // [BR * w][NB]
  bf16* bst = band + align128(size_t(BR) * d.w * NB * 2) / 2;                       // 2 x FL x [CHUNK][NB]
  bf16* gst = bst + 2 * FL * CHUNK * NB;                                             // G_STAGES x gstage
  const int parts = q.p2_parts;
  int id = blockIdx.x;
  const int part = id % parts;
  id /= parts;
  const int bi = id % d.b, l0 = id / d.b * FL, slice = bi * parts + part;
  const int c0 = (blockIdx.y / q.p2_opasses) * NB, o0 = (blockIdx.y % q.p2_opasses) * 128 * MT;
  const int OW = min(128 * MT, d.O - o0);
  const int n_chunks = (d.P + CHUNK - 1) / CHUNK, per = (n_chunks + parts - 1) / parts;
  const int u0 = part * per, u1 = min(n_chunks, u0 + per);
  const bf16* img_b = img + size_t(bi) * d.h * d.w * d.f;
  const int lane = threadIdx.x % 32, t = lane % 4, wg = threadIdx.x / 128, wi = (threadIdx.x / 32) % 4;

  // the rows chunk u's samples may read from the band: its rows and R above and below
  auto rows_of = [&](int u, int& lo, int& hi) {
    const int pa = u * CHUNK, pb = min(pa + CHUNK, d.P) - 1;
    lo = min(d.h, max(0, pa / d.w - q.p2_R));
    hi = BR ? max(lo, min(d.h, pb / d.w + 1 + q.p2_R)) : lo;
  };
  int have = 0;  // the band holds (or is fetching) the rows below `have` that chunks still need
  auto fetch = [&](int u) {
    bf16* gsu = gst + (u % G_STAGES) * gstage;
    const int pa = u * CHUNK;
    if (threadIdx.x < 2 * CHUNK * FL) {
      const int p = pa + threadIdx.x % CHUNK, l = l0 + threadIdx.x / (2 * CHUNK);
      const float* src = threadIdx.x % (2 * CHUNK) < CHUNK ? iy : ix;
      const bool in = p < d.P && l < d.L;
      cp_async_ca<4>(sidx + (u % G_STAGES) * FL * 2 * CHUNK + threadIdx.x,
                     in ? src + (size_t(bi) * d.P + p) * d.L + l : src, in);
    }
    for (int idx = threadIdx.x; idx < CHUNK * (OW / 8); idx += 256) {
      const int px = idx / (OW / 8), n8 = (idx % (OW / 8)) * 8;
      const bool in = pa + px < d.P;
      cp_async16(gsu + px * os + n8, in ? g + (size_t(bi) * d.P + pa + px) * d.O + o0 + n8 : g, in);
    }
    int lo, hi;
    rows_of(u, lo, hi);
    const int from = max(have, lo), n = max(0, hi - from) * d.w * NV;
    for (int idx = threadIdx.x; idx < n; idx += 256) {
      const int rr = from + idx / (d.w * NV), rem = idx % (d.w * NV), x = rem / NV, c8 = (rem % NV) * 8;
      const bool in = c0 + c8 < d.f;
      cp_async16(band + (size_t(rr % BR) * d.w + x) * NB + c8,
                 in ? img_b + (size_t(rr) * d.w + x) * d.f + c0 + c8 : img_b, in);
    }
    have = max(have, hi);
  };
  // chunk u's warp tile of flow l0 + fl into B stage (u % 2, fl): item (pixel px, vector v) of
  // thread i's list
  auto build = [&](int u, int fl) {
    bf16* bs = bst + ((u % 2) * FL + fl) * CHUNK * NB;
    const float* si = sidx + ((u % G_STAGES) * FL + fl) * 2 * CHUNK;
    int lo, hi;
    rows_of(u, lo, hi);
    const int lo_slot = BR ? (lo % BR) * d.w : 0, span_px = (hi - lo) * d.w;
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int idx = threadIdx.x + 256 * i, px = idx / NV, v = idx % NV, p = u * CHUNK + px;
      const int ch = c0 + 8 * v;
      float acc8[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (p < d.P) {
        const Taps tp = make_taps(si[px], si[CHUNK + px], d.h, d.w);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!tp.valid[k]) continue;
          const int rel = tp.off[k] - lo * d.w;
          uint4 raw = make_uint4(0u, 0u, 0u, 0u);
          if (unsigned(rel) < unsigned(span_px)) {  // in the band: shared memory
            int bp = rel + lo_slot;
            if (bp >= BR * d.w) bp -= BR * d.w;
            raw = *reinterpret_cast<const uint4*>(band + size_t(bp) * NB + 8 * v);
          } else if (ch < d.f) {  // out of the band: global memory
            raw = __ldg(reinterpret_cast<const uint4*>(img_b + size_t(tp.off[k]) * d.f + ch));
          }
          fma8(acc8, tp.wt[k], raw);
        }
      }
      *reinterpret_cast<uint4*>(bs + ((px / 8) * NV + v) * 64 + (px % 8) * 8) =
          make_uint4(pack_bf2(acc8[0], acc8[1]), pack_bf2(acc8[2], acc8[3]),
                     pack_bf2(acc8[4], acc8[5]), pack_bf2(acc8[6], acc8[7]));
    }
  };

  float acc[FL][MT][NB / 2];
#pragma unroll
  for (int fl = 0; fl < FL; ++fl)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < NB / 2; ++i) acc[fl][mt][i] = 0.0f;
  uint32_t af[4][MT][4];
  // ldmatrix.trans: lane l addresses row l%8 of matrix l/8, at (pixel, channel) offsets
  // ((l/16) * 8, ((l/8) % 2) * 8) of a k16 step's [16 pixels][16 channels] block
  const int lm_r = (lane / 16) * 8 + lane % 8, lm_x = ((lane / 8) % 2) * 8;
  if (u0 < u1) {
    fetch(u0);
    cp_async_commit();
    if (u0 + 1 < u1) fetch(u0 + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    for (int u = u0; u < u1; ++u) {
#pragma unroll
      for (int fl = 0; fl < FL; ++fl)
        if (l0 + fl < d.L) build(u, fl);
      wgmma_wait<0>();     // chunk u-1's products are done: its B stages and fragments are free
#pragma unroll
      for (int fl = 0; fl < FL; ++fl)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) fence_regs(acc[fl][mt]);
      cp_async_wait<0>();  // this thread's copies of chunk u+1 have landed
      fence_proxy_async();
      __syncthreads();     // everyone's, and chunk u's B tile is built
      if (u + 2 < u1) fetch(u + 2);
      cp_async_commit();
      const bf16* gsu = gst + (u % G_STAGES) * gstage;
      // every m64 tile and flow, unconditionally (a wgmma under a branch serializes them all):
      // rows past O read the stage's tail and the slack after the ring, and a flow past L a
      // stale B tile; neither is written out
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldmatrix_x4_trans(af[s][mt], gsu + (16 * s + lm_r) * os + (wg * MT + mt) * 64 + wi * 16 + lm_x);
      wgmma_fence();
#pragma unroll
      for (int fl = 0; fl < FL; ++fl)
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            Wgmma<NB>::template mma<1>(acc[fl][mt], af[s][mt],
                                       wgmma_desc(bst + ((u % 2) * FL + fl) * CHUNK * NB + s * NB * 16,
                                                  NB * 16, 128));
      wgmma_commit();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int fl = 0; fl < FL; ++fl)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) fence_regs(acc[fl][mt]);
    cp_async_wait<0>();
  }
  // acc[fl][mt][4j + 2h + e]: flow l0 + fl, output channel o0 + (wg*MT + mt)*64 + 16 wi + lane/4 +
  // 8h, channel c0 + 8j + 2t + e
#pragma unroll
  for (int fl = 0; fl < FL; ++fl) {
    if (l0 + fl >= d.L) continue;
    float* dst = partial + (size_t(slice) * d.L + l0 + fl) * d.f * d.O;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = o0 + (wg * MT + mt) * 64 + wi * 16 + lane / 4 + 8 * h;
        if (o >= d.O) continue;
#pragma unroll
        for (int j = 0; j < NB / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ch = c0 + 8 * j + 2 * t + e;
            if (ch < d.f) dst[size_t(ch) * d.O + o] = acc[fl][mt][4 * j + 2 * h + e];
          }
      }
  }
}

// d_w[i] = sum over s in order of partial[s, i].
__global__ void sum_slices_kernel(const float* __restrict__ partial, float* __restrict__ d_w,
                                  int n_slices, int64_t n) {
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += int64_t(gridDim.x) * blockDim.x) {
    float acc = 0.0f;
    for (int s = 0; s < n_slices; ++s) acc += partial[s * n + i];
    d_w[i] = acc;
  }
}

bool valid_dims(const RetDims& d) {
  return d.b > 0 && d.P > 0 && d.L > 0 && d.h > 0 && d.w > 0 && d.f > 0 && d.O > 0 &&
         int64_t(d.h) * d.w * d.f < (int64_t(1) << 31) &&   // offsets within an item are int
         int64_t(d.b) * d.P * d.L < (int64_t(1) << 31);      // sample indices are int
}

// The bf16 kernels read and write 16-byte vectors of channels: f and O multiples of 8 (the
// wrappers pad them), and the backward's d_W partials one slice per (item, part).
bool valid_bf16(const RetDims& d, int n_slices) {
  return d.f % 8 == 0 && d.O % 8 == 0 && n_slices >= d.b && n_slices % d.b == 0;
}

cudaError_t plan_here(const RetDims& d, int n_slices, RetPlan* p) {
  int sms = 0, smem_max = 0, smem_sm = 0;
  const cudaError_t err = device_limits(&sms, &smem_max, &smem_sm);
  if (err != cudaSuccess) return err;
  *p = make_plan(d, n_slices, sms, smem_max);
  return cudaSuccess;
}

// Allows `smem` bytes of dynamic shared memory for `kernel` and launches it; returns the error.
template <typename... KernelArgs, typename... Args>
cudaError_t launch(void (*kernel)(KernelArgs...), dim3 grid, int threads, size_t smem,
                   cudaStream_t stream, Args... args) {
  if (grid.x == 0 || grid.y == 0 || grid.y > 65535) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int WG, int ONB>
cudaError_t fwd_k(const RetPlan& q, const float* iy, const float* ix, const bf16* img, const bf16* w,
                  const float* bias, bf16* out, RetDims d, cudaStream_t st) {
  if (q.fwd_blocks / q.fwd_opasses > 0x7fffffff) return cudaErrorInvalidValue;
  return launch(warp_ret_fwd_bf16_kernel<WG, ONB>,
                dim3(unsigned(q.fwd_blocks / q.fwd_opasses), unsigned(q.fwd_opasses)), 128 * WG,
                q.fwd_smem, st, iy, ix, img, w, bias, out, d, q);
}

template <int WG>
cudaError_t fwd_wg(const RetPlan& q, const float* iy, const float* ix, const bf16* img,
                   const bf16* w, const float* bias, bf16* out, RetDims d, cudaStream_t st) {
  switch (q.fwd_onb) {
    case 1: return fwd_k<WG, 1>(q, iy, ix, img, w, bias, out, d, st);
    case 2: return fwd_k<WG, 2>(q, iy, ix, img, w, bias, out, d, st);
    default: return fwd_k<WG, 3>(q, iy, ix, img, w, bias, out, d, st);
  }
}

template <int MT, int NB>
cudaError_t dw_k(const RetPlan& q, const float* iy, const float* ix, const bf16* img, const bf16* g,
                 float* partial, RetDims d, cudaStream_t st) {
  const int64_t x = q.p2_blocks / (q.p2_fpasses * q.p2_opasses);
  if (x > 0x7fffffff) return cudaErrorInvalidValue;
  const dim3 grid(unsigned(x), unsigned(q.p2_fpasses * q.p2_opasses));
  if constexpr (MT * NB <= 128)
    if (q.p2_fl == 2)
      return launch(warp_ret_bwd_dw_bf16_kernel<MT, NB, 2>, grid, 256, q.p2_smem, st, iy, ix, img,
                    g, partial, d, q);
  return launch(warp_ret_bwd_dw_bf16_kernel<MT, NB, 1>, grid, 256, q.p2_smem, st, iy, ix, img, g,
                partial, d, q);
}

template <int NB>
cudaError_t dw_nb(const RetPlan& q, const float* iy, const float* ix, const bf16* img,
                  const bf16* g, float* partial, RetDims d, cudaStream_t st) {
  switch (q.p2_mt) {
    case 1: return dw_k<1, NB>(q, iy, ix, img, g, partial, d, st);
    case 2: return dw_k<2, NB>(q, iy, ix, img, g, partial, d, st);
    default:
      if constexpr (NB < 128) return dw_k<3, NB>(q, iy, ix, img, g, partial, d, st);
      return cudaErrorInvalidValue;
  }
}

cudaError_t launch_fwd_bf16(const float* iy, const float* ix, const bf16* img, const bf16* w,
                            const float* bias, bf16* out, RetDims d, cudaStream_t st) {
  RetPlan q;
  cudaError_t err = plan_here(d, d.b, &q);
  if (err != cudaSuccess) return err;
  return q.fwd_wg == 1 ? fwd_wg<1>(q, iy, ix, img, w, bias, out, d, st)
                       : fwd_wg<2>(q, iy, ix, img, w, bias, out, d, st);
}

cudaError_t launch_bwd_bf16(const float* iy, const float* ix, const bf16* img, const bf16* w,
                            const bf16* g, float* d_img, float* d_iy, float* d_ix, float* partial,
                            float* d_w, int n_slices, RetDims d, cudaStream_t st) {
  RetPlan q;
  cudaError_t err = plan_here(d, n_slices, &q);
  if (err != cudaSuccess) return err;
  if (q.p1_blocks > 0x7fffffff) return cudaErrorInvalidValue;
  err = q.p1_wg == 1
            ? launch(warp_ret_bwd_img_bf16_kernel<1>, dim3(unsigned(q.p1_blocks)), 128, q.p1_smem, st,
                     iy, ix, img, w, g, d_img, d_iy, d_ix, d, q)
            : launch(warp_ret_bwd_img_bf16_kernel<2>, dim3(unsigned(q.p1_blocks)), 256, q.p1_smem, st,
                     iy, ix, img, w, g, d_img, d_iy, d_ix, d, q);
  if (err != cudaSuccess) return err;
  switch (q.p2_nb) {
    case 32: err = dw_nb<32>(q, iy, ix, img, g, partial, d, st); break;
    case 64: err = dw_nb<64>(q, iy, ix, img, g, partial, d, st); break;
    case 96: err = dw_nb<96>(q, iy, ix, img, g, partial, d, st); break;
    default: err = dw_nb<128>(q, iy, ix, img, g, partial, d, st); break;
  }
  if (err != cudaSuccess) return err;
  const int64_t n = int64_t(d.L) * d.f * d.O;
  sum_slices_kernel<<<unsigned((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096), 256, 0, st>>>(
      partial, d_w, n_slices, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd(const float* iy, const float* ix, const void* img, const void* w,
                       const float* bias, void* out, RetDims d, cudaStream_t stream) {
  const int64_t grid = int64_t(d.b) * ((d.P + TILE - 1) / TILE) * ((d.O + TILE - 1) / TILE);
  return launch_tiles(warp_ret_fwd_kernel<T>, grid, FwdLayout<T>().bytes, stream, iy, ix,
                      static_cast<const T*>(img), static_cast<const T*>(w), bias,
                      static_cast<T*>(out), d);
}

template <typename T>
cudaError_t launch_bwd(const float* iy, const float* ix, const void* img, const void* w,
                       const void* g, float* d_img, float* d_iy, float* d_ix, float* partial,
                       float* d_w, int n_slices, RetDims d, cudaStream_t stream) {
  const int n_pt = (d.P + TILE - 1) / TILE;
  cudaError_t err = launch_tiles(warp_ret_bwd_img_kernel<T>, int64_t(d.b) * n_pt,
                                 BwdLayout<T>().bytes, stream, iy, ix,
                                 static_cast<const T*>(img), static_cast<const T*>(w),
                                 static_cast<const T*>(g), d_img, d_iy, d_ix, d);
  if (err != cudaSuccess) return err;
  const int64_t blocks = int64_t(n_slices) * d.L * ((d.f + TILE - 1) / TILE) * ((d.O + TILE - 1) / TILE);
  err = launch_tiles(warp_ret_bwd_dw_kernel<T>, blocks, DwLayout<T>().bytes, stream, iy, ix,
                     static_cast<const T*>(img), static_cast<const T*>(g), partial, n_slices, d);
  if (err != cudaSuccess) return err;
  const int64_t n = int64_t(d.L) * d.f * d.O;
  sum_slices_kernel<<<unsigned((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096), 256, 0, stream>>>(
      partial, d_w, n_slices, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The forward on `stream`: out [b, P, O] from iy, ix [b, P, L] (f32), img [b, h, w, f], W [L, f, O]
// and bias [O] (f32); img, W and out are bf16 when is_bf16 is set (f and O multiples of 8, 16-byte
// aligned), else f32. All contiguous. Returns a cudaError_t (0 on success).
int vp_warp_ret_fwd(int is_bf16, const float* iy, const float* ix, const void* img, const void* w,
                    const float* bias, void* out, int b, int P, int L, int h, int wd, int f, int O,
                    void* stream) {
  const RetDims d{b, P, L, h, wd, f, O};
  if (!valid_dims(d) || (is_bf16 && !valid_bf16(d, b))) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return finish(is_bf16 ? launch_fwd_bf16(iy, ix, static_cast<const bf16*>(img),
                                          static_cast<const bf16*>(w), bias, static_cast<bf16*>(out),
                                          d, st)
                        : launch_fwd<float>(iy, ix, img, w, bias, out, d, st));
}

// The backward on `stream`, three launches: adds into d_img [b, h, w, f] (f32, zeroed by the
// caller), writes d_iy, d_ix [b, P, L] and d_w [L, f, O] (f32) from g [b, P, O] in img's type,
// using partial [n_slices, L, f, O] (f32) as scratch; in bf16 n_slices is b times the parts of an
// item's pixels that pass 2 splits into. All contiguous. Returns a cudaError_t.
int vp_warp_ret_bwd(int is_bf16, const float* iy, const float* ix, const void* img, const void* w,
                    const void* g, float* d_img, float* d_iy, float* d_ix, float* partial,
                    float* d_w, int n_slices, int b, int P, int L, int h, int wd, int f, int O,
                    void* stream) {
  const RetDims d{b, P, L, h, wd, f, O};
  if (!valid_dims(d) || n_slices < 1 || (is_bf16 && !valid_bf16(d, n_slices)))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return finish(is_bf16 ? launch_bwd_bf16(iy, ix, static_cast<const bf16*>(img),
                                          static_cast<const bf16*>(w), static_cast<const bf16*>(g),
                                          d_img, d_iy, d_ix, partial, d_w, n_slices, d, st)
                        : launch_bwd<float>(iy, ix, img, w, g, d_img, d_iy, d_ix, partial, d_w,
                                            n_slices, d, st));
}

// The bf16 kernels' plan on the current device for these dimensions (f and O multiples of 8,
// n_slices a multiple of b) into out[0..29]: fpad, fwd_wg, fwd_onb, fwd_opasses, fwd_R, fwd_rows,
// fwd_tiles, p1_wg, p1_passes, p1_ks, p1_R, p1_rows, p1_tiles, p1_gtile, p1_sidx, p2_nb,
// p2_fpasses, p2_mt, p2_opasses, p2_os, p2_R, p2_rows, p2_parts, p2_fl, fwd_smem, p1_smem, p2_smem, fwd_blocks,
// p1_blocks, p2_blocks. Returns a cudaError_t.
int vp_warp_ret_geometry(int b, int P, int L, int h, int wd, int f, int O, int n_slices,
                         int64_t* out) {
  const RetDims d{b, P, L, h, wd, f, O};
  if (!valid_dims(d) || !valid_bf16(d, n_slices)) return cudaErrorInvalidValue;
  RetPlan p;
  const cudaError_t err = plan_here(d, n_slices, &p);
  if (err != cudaSuccess) return finish(err);
  const int64_t v[] = {p.fpad, p.fwd_wg, p.fwd_onb, p.fwd_opasses, p.fwd_R, p.fwd_rows,
                       p.fwd_tiles, p.p1_wg, p.p1_passes, p.p1_ks, p.p1_R, p.p1_rows, p.p1_tiles,
                       p.p1_gtile, p.p1_sidx, p.p2_nb, p.p2_fpasses, p.p2_mt, p.p2_opasses, p.p2_os, p.p2_R, p.p2_rows,
                       p.p2_parts, p.p2_fl, int64_t(p.fwd_smem), int64_t(p.p1_smem), int64_t(p.p2_smem),
                       p.fwd_blocks, p.p1_blocks, p.p2_blocks};
  for (int i = 0; i < int(sizeof(v) / sizeof(v[0])); ++i) out[i] = v[i];
  return 0;
}

const char* vp_cuda_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

}  // extern "C"
