// Multi-flow bilinear warp (TrajGRU's L trajectory warps) for Hopper (sm_90a): forward and backward.
//
// Replaces the JAX package's TPU kernels in ops/pallas_warp.py, reached through warp_sample: the
// forward _make_band_fwd_kernel (K5, the default clamp mode, which runs on indices that _clamp_rows
// has already saturated) and _make_fused_fwd_kernel (K7a, the dense form); the backward pairs
// _make_band_dimg_kernel + _make_band_didx_kernel (K6a, K6b) and _make_fused_dimg_kernel +
// _make_fused_didx_kernel (K7b, K7c).
//
// Function, for batch item bi, output pixel p and flow l, with the fractional source indices
// iy = iy[bi, p, l] and ix = ix[bi, p, l] (f32):
//   y0 = floor(iy), x0 = floor(ix), wy1 = iy - y0, wy0 = 1 - wy1, wx1 = ix - x0, wx0 = 1 - wx1
//   out[bi, p, l, :] = sum over the taps (y, x) in {y0, y0+1} x {x0, x0+1} of wy * wx * img[bi, y, x, :]
// where a tap outside the image reads zero: torch grid_sample(align_corners=False,
// padding_mode='zeros') in index space. Weights and sums are f32; out is rounded to img's type.
// The backward, from g = d out [b, P, L, c], with I the taps' values (zero outside the image):
//   d_img[bi, y, x, :] += g * wy * wx                                    (each tap inside the image)
//   d_iy = sum_c g * (wx0 * (I[y1,x0] - I[y0,x0]) + wx1 * (I[y1,x1] - I[y0,x1]))
//   d_ix = sum_c g * (wy0 * (I[y0,x1] - I[y0,x0]) + wy1 * (I[y1,x1] - I[y1,x0]))
// floor carries no gradient and the validity masks are constants, as in the TPU kernels' VJP.
//
// The TPU kernels contract one-hot factor matrices on the MXU, because gathers are
// serialization-bound there, and the band kernels cut that contraction to the rows near each output
// tile. Both are tilings of the same function, which a direct 4-tap gather computes exactly for any
// flow, so one forward and one backward kernel here are the counterparts of all six.
//
// Layout: pixel-major. iy, ix [b, P, L] (P = h*w output pixels), img [b, h, w, c], out and g
// [b, P, L, c]: each tap's c channels are contiguous in the NHWC image, and out reshaped to
// [b*P, L*c] is the input of TrajGRU's 1x1 ret conv as one GEMM, with no transpose. On an image
// slab (spatial parallelism: this process's output pixels are image rows row0 .. row0 + P/w - 1 of
// the whole gathered image) P = (h/n)*w and row0 places the tiles' bands; it changes no result.
//
// Bound: bytes. The forward writes b*P*L*c outputs once (218 MB in bf16 at b=32, 64x64, L=13, c=64)
// and reads the indices and the image once (16.8 MB there). The backward reads g once and the image
// and indices again, and scatters into an f32 d_img (33.6 MB there) that stays in L2.
//
// Forward: a gather of 4L taps per output pixel would read the image 52 times (873 MB of 16-byte
// tap reads from L2 at 64x64x64, 3.5 times the bytes bound). The TPU's band kernel
// (_make_band_fwd_kernel) contracts each output tile with only the band of image rows around it;
// here that band is staged once per block in shared memory:
// - one block per (batch item, tile of out_rows output rows, channel pass); its band holds `rows`
//   image rows (the tile's rows and R above and below, clamped into the image) at the full width,
//   for the pass's cw channels (all c where the band fits, else the fewest passes that fit), in the
//   image's type, copied in by cp.async and waited for once;
// - a sample's vectors of V channels (16 bytes when c and the pointers allow it) go to G lanes, two
//   each where their number is even (VPL), so that the index work of a sample (its four taps from
//   iy/ix, loaded one sample ahead) is shared by two vectors; the block's samples (tile pixel, flow)
//   times G are spread over the threads in order, so neighbouring lanes write neighbouring addresses
//   of the pixel-major output; each lane reads each tap inside the band from shared memory and one
//   outside it (a flow that leaves the band: the port is exact for any flow, unlike the TPU's clamp
//   mode) from global memory, sums in f32 and rounds once;
// - the output goes out with streaming stores (st.global.cs), so that it does not evict from L2 the
//   image rows that other blocks' bands still have to copy.
// What bounds it on an H100 (PERF.md, Findings): with the output write cut out it still takes some
// 90% of its time, so the tap arithmetic and its latency (one block of 1024 threads per SM at
// 64x64x64) set the pace, not the write; a few taps outside the band (4-5% on flows that send a
// tenth of the samples far away) cost a quarter more, as each stalls its warp on L2. Any tiling is
// exact: output pixel p is taken to lie in image row row0 + p / w (a slab's rows; where P != h*w
// in grid_sample, as if the pixel index were row-major in the image), and where not even one row
// of one vector fits in shared memory every tap reads global memory.
//
// Backward: the scatter of g * weight into d_img is what costs (4*c f32 adds per sample, 436 M at
// 64x64x64, b=32, L=13). The TPU's band kernels (_make_band_dimg_kernel) add each output tile's
// contribution into the band of image rows around the tile; here that band is a window of f32
// accumulators in shared memory, so the adds that land in it meet there, and global memory sees one
// float4 atomic per window element (the flush) instead of one scalar atomic per sample and channel:
// - one block per (batch item, tile of out_rows output rows); its window holds `rows` image rows
//   (the tile's rows and R above and below, clamped into the image) at the full width, for one chunk
//   of cw <= 64 channels at a time; the block loops over the chunks and, in each, over all L flows
//   of its pixels;
// - a group of G lanes (a power of two) takes one sample, each lane a vector of V channels (16
//   bytes when c and the pointers allow it), read as whole vectors from g and the four taps; each
//   tap's g * weight goes into the window by 128-bit compare-and-swaps (cas128: this card has no
//   shared-memory f32 add, and atomicAdd there is a compare-and-swap loop of one float); a tap
//   outside the window (a flow that leaves the band: the port is exact for any flow, unlike the
//   TPU's clamp mode) goes straight to global memory, as float4 atomics where c % 4 == 0;
// - d_iy and d_ix are per-lane sums reduced over the group by shuffles, summed over the chunks in
//   d_iy/d_ix itself (the block owns its samples);
// - after a barrier the block adds its window into d_img with float4 atomics (neighbouring windows
//   overlap) and zeroes it for the next chunk.
// What bounds it on an H100 (PERF.md, Findings): global f32 atomics move under 2 TB/s of payload,
// which is why the window takes the adds it can; the window's compare-and-swaps then take about half
// the time, the tap reads and index gradients the other half.
// Any tiling is exact: output pixel p is taken to lie in image row row0 + p / w (a slab's rows; where
// P != h*w in grid_sample, as if the pixel index were row-major in the image), and where not even
// one row fits in shared memory every tap goes to global memory. d_img is f32 (the caller zeroes
// it and rounds it to img's type afterwards); its summation order follows the atomics and varies
// from run to run.
#include "warp_common.cuh"

#include <algorithm>

namespace {

using namespace warpk;

template <typename T, int V> struct alignas(sizeof(T) * V) Vec { T v[V]; };

struct Dims {
  int b, P, L, h, w, c;
  int r0;  // the image row of output pixel 0 (a slab's first row; 0 for the whole image)
};

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The widest vector of channels (at most 16 bytes) that divides c and to which both tensors are
// aligned.
template <typename T>
int vec_width(const Dims& d, const void* a, const void* b) {
  int V = 16 / int(sizeof(T));
  while (V > 1 && (d.c % V || reinterpret_cast<uintptr_t>(a) % (V * sizeof(T)) ||
                   reinterpret_cast<uintptr_t>(b) % (V * sizeof(T))))
    V /= 2;
  return V;
}

// ---- forward -------------------------------------------------------------------------------

constexpr int FWD_TILE_ROWS = 8;     // output rows of a tile, halved while the grid has fewer blocks than SMs
constexpr bool STREAM_STORES = true;  // the output as st.global.cs
constexpr int VPL_MAX = 2;            // vectors of a sample per lane, at most

// One launch's tiling (fwd_geometry).
struct FwdGeom {
  int tile_px;  // output pixels of a tile (out_rows * w, at most P)
  int tiles;    // tiles of one batch item
  int R;        // band radius in rows
  int rows;     // band rows (0: no band, every tap reads global memory)
  int cw;       // channels of a pass, a multiple of V (the last pass may be narrower)
  int passes;   // channel passes, the grid's second dimension
  int vpl;      // vectors of a sample per lane (a power of two that divides every pass's vectors)
  int threads;  // threads per block: 1024 where the band leaves room for one block per SM, else 512
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// BYTES bytes from global memory into shared memory: by cp.async where BYTES allows (4, 8 or 16;
// 16 past L1), to be waited for with cp_async_wait_all; else by a plain load and store.
template <int BYTES>
__device__ __forceinline__ void copy_to_shared(void* dst, const void* src) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  else if constexpr (BYTES == 8 || BYTES == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "n"(BYTES)
                 : "memory");
  else
    *static_cast<unsigned short*>(dst) = *static_cast<const unsigned short*>(src);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// *p = v, as a streaming store (st.global.cs: evict first) when STREAM_STORES is set. Nothing in
// the kernel reads the output, so the stores need no memory clobber.
template <typename VT>
__device__ __forceinline__ void store_out(VT* p, const VT& v) {
  static_assert(sizeof(VT) == 16 || sizeof(VT) == 8 || sizeof(VT) == 4 || sizeof(VT) == 2);
  if constexpr (!STREAM_STORES) {
    *p = v;
  } else if constexpr (sizeof(VT) == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(&v);
    asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "r"(u.x), "r"(u.y),
                 "r"(u.z), "r"(u.w));
  } else if constexpr (sizeof(VT) == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(&v);
    asm volatile("st.global.cs.v2.u32 [%0], {%1, %2};\n" ::"l"(p), "r"(u.x), "r"(u.y));
  } else if constexpr (sizeof(VT) == 4) {
    asm volatile("st.global.cs.u32 [%0], %1;\n" ::"l"(p), "r"(*reinterpret_cast<const unsigned*>(&v)));
  } else {
    asm volatile("st.global.cs.u16 [%0], %1;\n" ::"l"(p), "h"(*reinterpret_cast<const unsigned short*>(&v)));
  }
}

// The forward of one (batch item, tile of output pixels, channel pass) block, NT threads. The band
// holds image rows [row0, row0 + rows) at the full width for the pass's channels [c0, c0 + cw), in
// img's type, channel-contiguous per pixel with a pitch of cw. A sample's nv vectors of V channels
// go to G = nv / VPL lanes, VPL vectors each (lane j: vectors j, j + G, ..., the order rotated by
// the sample's parity, so that two samples in one quarter-warp read different banks where nv = 2G
// and G = 4), which share the sample's taps. The block's n_samp samples times G lanes are taken in
// order, NT at a time: thread t takes item t, t + NT, ..., item i being lane i % G of sample i / G
// (stepped without a division in the loop), each loading its next item's indices ahead.
template <typename T, int V, int VPL, int NT>
__global__ void __launch_bounds__(NT)
    warp_fwd_kernel(const float* __restrict__ iy, const float* __restrict__ ix,
                    const T* __restrict__ img, T* __restrict__ out, Dims d, FwdGeom q) {
  using VT = Vec<T, V>;
  extern __shared__ float4 smem4[];
  T* band = reinterpret_cast<T*>(smem4);  // [rows * w pixels][cw channels]
  const int bi = blockIdx.x / q.tiles;
  const int p0 = (blockIdx.x - bi * q.tiles) * q.tile_px;
  const int c0 = blockIdx.y * q.cw;
  const int nv = min(q.cw, d.c - c0) / V;  // c % V == 0, so every vector is whole
  const int G = nv / VPL;                  // the geometry makes nv a multiple of VPL
  const int n_samp = min(q.tile_px, d.P - p0) * d.L;
  // the band: rows [row0, row0 + rows), the tile's image rows r0 + p0 / w .. and R above, clamped
  const int row0 = max(0, min(d.r0 + p0 / d.w - q.R, d.h - q.rows));
  const int band_off = row0 * d.w, band_px = q.rows * d.w;
  const T* src = img + int64_t(bi) * d.h * d.w * d.c + c0;

  {
    const T* from = src + int64_t(row0) * d.w * d.c;
    const int units = band_px * nv;
    for (int u = threadIdx.x; u < units; u += NT) {
      const int px = u / nv, j = u - px * nv;
      copy_to_shared<sizeof(VT)>(band + px * q.cw + j * V, from + int64_t(px) * d.c + j * V);
    }
    cp_async_wait_all();  // this thread's copies have landed
    __syncthreads();      // and every other thread's
  }

  const int64_t s0 = (int64_t(bi) * d.P + p0) * d.L;  // the tile's first sample
  const float* ty = iy + s0;
  const float* tx = ix + s0;
  T* dst = out + s0 * d.c + c0;
  const int ds = NT / G, dj = NT - ds * G;
  int s = threadIdx.x / G, j = threadIdx.x - s * G;
  float ny = 0.0f, nx = 0.0f;
  if (s < n_samp) {
    ny = __ldg(ty + s);
    nx = __ldg(tx + s);
  }
  while (s < n_samp) {
    const float cy = ny, cx = nx;
    const int cs = s;
    int ch[VPL];  // the lane's channels in the pass
#pragma unroll
    for (int u = 0; u < VPL; ++u) ch[u] = (((u + cs) & (VPL - 1)) * G + j) * V;
    s += ds;
    j += dj;
    if (j >= G) {
      j -= G;
      ++s;
    }
    if (s < n_samp) {  // the next sample's indices, loaded while this one is summed
      ny = __ldg(ty + s);
      nx = __ldg(tx + s);
    }
    const Taps t = make_taps(cy, cx, d.h, d.w);
    float acc[VPL][V];
#pragma unroll
    for (int u = 0; u < VPL; ++u)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[u][v] = 0.0f;
    // acc += wt * the lane's vectors of the tap at p (in the band or in global memory)
    auto add = [&](const T* p, float wt) {
      VT val[VPL];
#pragma unroll
      for (int u = 0; u < VPL; ++u) val[u] = *reinterpret_cast<const VT*>(p + ch[u]);
#pragma unroll
      for (int u = 0; u < VPL; ++u)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[u][v] = fmaf(wt, to_f(val[u].v[v]), acc[u][v]);
    };
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!t.valid[k]) continue;  // a tap outside the image reads zero
      const int px = t.off[k] - band_off;
      if (unsigned(px) < unsigned(band_px))  // in the band: shared memory
        add(band + px * q.cw, t.wt[k]);
      else  // out of the band: global memory
        add(src + int64_t(t.off[k]) * d.c, t.wt[k]);
    }
#pragma unroll
    for (int u = 0; u < VPL; ++u) {
      VT res;
#pragma unroll
      for (int v = 0; v < V; ++v) res.v[v] = from_f<T>(acc[u][v]);
      store_out(reinterpret_cast<VT*>(dst + int64_t(cs) * d.c + ch[u]), res);
    }
  }
}

// The forward's tiling on the current device, for elements of esize bytes and vectors of V. R: 6
// rows at w >= 48, else 4 (the backward's). Tiles of FWD_TILE_ROWS rows, halved while b * tiles falls
// short of one block per SM. The band, the tile's rows plus R above and below clamped to h, at the
// full width: all c channels where it fits in shared memory, else the fewest channel passes (each
// a multiple of V) that fit; then R shrinks to 4, then the tiles, then the band itself (to none at
// all). Vectors per lane: the most, up to VPL_MAX, that divides every pass's vectors. Threads: 1024
// where the band leaves room for only one block per SM, else 512.
cudaError_t fwd_geometry(const Dims& d, int V, int esize, FwdGeom* g, size_t* smem) {
  int sms = 0, smem_max = 0, smem_sm = 0;
  const cudaError_t err = device_limits(&sms, &smem_max, &smem_sm);
  if (err != cudaSuccess) return err;
  g->R = d.w >= 48 ? 6 : 4;
  auto tile_px = [&](int out_rows) { return std::min<int64_t>(int64_t(out_rows) * d.w, d.P); };
  auto tiles = [&](int out_rows) { return (d.P + tile_px(out_rows) - 1) / tile_px(out_rows); };
  auto band_bytes = [&](int rows, int cw) {
    return int64_t(std::min(rows, d.h)) * d.w * cw * esize;
  };
  auto pass_cw = [&](int n) { return (d.c + n * V - 1) / (n * V) * V; };  // c / n, rounded up to V
  int out_rows = FWD_TILE_ROWS;
  while (out_rows > 1 && d.b * tiles(out_rows) < sms) out_rows /= 2;
  int passes = 1;
  while (band_bytes(out_rows + 2 * g->R, pass_cw(passes)) > smem_max && pass_cw(passes) > V) ++passes;
  g->cw = pass_cw(passes);
  while (band_bytes(out_rows + 2 * g->R, g->cw) > smem_max && (g->R > 4 || out_rows > 1)) {
    if (g->R > 4)
      --g->R;
    else
      out_rows /= 2;
  }
  g->tile_px = int(tile_px(out_rows));
  g->tiles = int(tiles(out_rows));
  int rows = std::min(d.h, out_rows + 2 * g->R);
  while (rows > 0 && band_bytes(rows, g->cw) > smem_max) --rows;
  g->rows = rows;
  g->passes = (d.c + g->cw - 1) / g->cw;
  const int nv_full = g->cw / V, nv_last = (d.c - (g->passes - 1) * g->cw) / V;
  g->vpl = VPL_MAX;
  while (g->vpl > 1 && (nv_full % g->vpl || nv_last % g->vpl)) g->vpl /= 2;
  *smem = size_t(rows) * g->cw * d.w * esize;
  g->threads = 2 * (*smem + 1024) > size_t(smem_sm) ? 1024 : 512;
  return int64_t(d.b) * g->tiles > 0x7fffffff || g->passes > 65535 ? cudaErrorInvalidValue
                                                                    : cudaSuccess;
}

template <typename T, int V, int VPL, int NT>
cudaError_t launch_fwd_k(const float* iy, const float* ix, const void* img, void* out, Dims d,
                         const FwdGeom& q, size_t smem, cudaStream_t stream) {
  auto kernel = warp_fwd_kernel<T, V, VPL, NT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(unsigned(int64_t(d.b) * q.tiles), unsigned(q.passes)), NT, smem, stream>>>(
      iy, ix, static_cast<const T*>(img), static_cast<T*>(out), d, q);
  return cudaGetLastError();
}

template <typename T, int V, int VPL>
cudaError_t launch_fwd_p(const float* iy, const float* ix, const void* img, void* out, Dims d,
                         const FwdGeom& q, size_t smem, cudaStream_t stream) {
  return q.threads == 1024 ? launch_fwd_k<T, V, VPL, 1024>(iy, ix, img, out, d, q, smem, stream)
                           : launch_fwd_k<T, V, VPL, 512>(iy, ix, img, out, d, q, smem, stream);
}

template <typename T, int V>
cudaError_t launch_fwd_v(const float* iy, const float* ix, const void* img, void* out, Dims d,
                         cudaStream_t stream) {
  FwdGeom q;
  size_t smem = 0;
  cudaError_t err = fwd_geometry(d, V, int(sizeof(T)), &q, &smem);
  if (err != cudaSuccess) return err;
  if constexpr (VPL_MAX >= 4)
    if (q.vpl == 4) return launch_fwd_p<T, V, 4>(iy, ix, img, out, d, q, smem, stream);
  return q.vpl == 2 ? launch_fwd_p<T, V, 2>(iy, ix, img, out, d, q, smem, stream)
                    : launch_fwd_p<T, V, 1>(iy, ix, img, out, d, q, smem, stream);
}

template <typename T>
cudaError_t launch_fwd(const float* iy, const float* ix, const void* img, void* out, Dims d,
                       cudaStream_t stream) {
  switch (vec_width<T>(d, img, out)) {
    case 8:
      if constexpr (sizeof(T) == 2) return launch_fwd_v<T, 8>(iy, ix, img, out, d, stream);
      return cudaErrorInvalidValue;
    case 4:
      return launch_fwd_v<T, 4>(iy, ix, img, out, d, stream);
    case 2:
      return launch_fwd_v<T, 2>(iy, ix, img, out, d, stream);
    default:
      return launch_fwd_v<T, 1>(iy, ix, img, out, d, stream);
  }
}

// ---- backward ------------------------------------------------------------------------------

constexpr int CW_MAX = 64;     // channels of one pass: 256 bytes of f32 accumulators per window pixel
constexpr int TILE_ROWS = 8;   // output rows of a tile, halved while the grid has fewer blocks than SMs

// One launch's tiling (bwd_geometry).
struct BwdGeom {
  int tile_px;  // output pixels of a tile (out_rows * w, at most P)
  int tiles;    // tiles of one batch item
  int R;        // band radius in rows
  int rows;     // window rows (0: no window, every tap goes to global memory)
  int G;        // lanes per sample, a power of two
  int cw;       // channels per pass, G * V
  int v4;       // global adds as float4 (c % 4 == 0 and d_img 16-byte aligned)
  int threads;  // threads per block: 1024 where the window leaves room for one block per SM, else 512
};

// d_img[p .. p+V) += gf * wt, by float4 atomics (red.global.add.v4.f32) when v4 allows, else scalar.
template <int V>
__device__ __forceinline__ void add_global(float* p, const float (&gf)[V], float wt, int v4) {
  if constexpr (V % 4 == 0) {
    if (v4) {
#pragma unroll
      for (int u = 0; u < V; u += 4)
        atomicAdd(reinterpret_cast<float4*>(p + u),
                  make_float4(gf[u] * wt, gf[u + 1] * wt, gf[u + 2] * wt, gf[u + 3] * wt));
      return;
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) atomicAdd(p + v, gf[v] * wt);
}

// 4 floats at a 16-byte-aligned shared address += add by one 128-bit compare-and-swap
// (atom.shared.cas.b128, sm_90); false, with `expect` updated to what was there, if another thread
// changed them first. A shared f32 atomicAdd compiles to a compare-and-swap loop of one float on this
// card (ATOMS.CAST.SPIN); this moves four floats a swap.
__device__ __forceinline__ bool cas128(float* p, float4& expect, const float4& add) {
  const float4 want =
      make_float4(expect.x + add.x, expect.y + add.y, expect.z + add.z, expect.w + add.w);
  const unsigned long long e0 = uint64_t(__float_as_uint(expect.y)) << 32 | __float_as_uint(expect.x);
  const unsigned long long e1 = uint64_t(__float_as_uint(expect.w)) << 32 | __float_as_uint(expect.z);
  const unsigned long long w0 = uint64_t(__float_as_uint(want.y)) << 32 | __float_as_uint(want.x);
  const unsigned long long w1 = uint64_t(__float_as_uint(want.w)) << 32 | __float_as_uint(want.z);
  unsigned long long s0, s1;
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "{\n\t.reg .b128 d, e, s;\n\t"
      "mov.b128 e, {%2, %3};\n\t"
      "mov.b128 s, {%4, %5};\n\t"
      "atom.shared.cas.b128 d, [%6], e, s;\n\t"
      "mov.b128 {%0, %1}, d;\n\t}"
      : "=l"(s0), "=l"(s1)
      : "l"(e0), "l"(e1), "l"(w0), "l"(w1), "r"(addr)
      : "memory");
  expect = make_float4(__uint_as_float(unsigned(s0)), __uint_as_float(unsigned(s0 >> 32)),
                       __uint_as_float(unsigned(s1)), __uint_as_float(unsigned(s1 >> 32)));
  return s0 == e0 && s1 == e1;
}

// window[0 .. V) += gf * wt in shared memory, atomically: 16 bytes a compare-and-swap where V allows,
// all of them issued before any is retried; else f32 atomicAdd.
template <int V>
__device__ __forceinline__ void add_window(float* p, const float (&gf)[V], float wt) {
  if constexpr (V % 4 == 0) {
    float4 old[V / 4], add[V / 4];
#pragma unroll
    for (int u = 0; u < V / 4; ++u) {
      old[u] = *reinterpret_cast<const float4*>(p + 4 * u);
      add[u] = make_float4(gf[4 * u] * wt, gf[4 * u + 1] * wt, gf[4 * u + 2] * wt,
                           gf[4 * u + 3] * wt);
    }
    unsigned left = (1u << (V / 4)) - 1;
    while (left) {
#pragma unroll
      for (int u = 0; u < V / 4; ++u)
        if ((left >> u & 1) && cas128(p + 4 * u, old[u], add[u])) left &= ~(1u << u);
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) atomicAdd(p + v, gf[v] * wt);
  }
}

// The backward of one (batch item, tile of output pixels) block, NT threads. The window holds image
// rows [row0, row0 + rows) at the full width for one chunk of cw channels at a time, as f32 sums in
// shared memory, channel-contiguous per pixel. Per chunk, G lanes take a sample, V channels each
// (16-byte vectors when c and the pointers allow it): d_iy and d_ix from g and the four taps, reduced
// over the group by shuffles and summed over the chunks in d_iy/d_ix; each tap's g * weight into the
// window (add_window) or, outside it, into d_img in global memory (add_global). Then the flush: the
// window added into d_img with float4 atomics (neighbouring windows overlap) and zeroed.
template <typename T, int V, int NT>
__global__ void __launch_bounds__(NT)
    warp_bwd_kernel(const float* __restrict__ iy, const float* __restrict__ ix,
                    const T* __restrict__ img, const T* __restrict__ g, float* __restrict__ d_img,
                    float* __restrict__ d_iy, float* __restrict__ d_ix, Dims d, BwdGeom q) {
  extern __shared__ float4 smem4[];
  float* win = reinterpret_cast<float*>(smem4);  // [rows * w pixels][cw channels]
  const int bi = blockIdx.x / q.tiles;
  const int p0 = (blockIdx.x - bi * q.tiles) * q.tile_px;
  const int n_samp = min(q.tile_px, d.P - p0) * d.L;
  // the window: rows [row0, row0 + rows), the tile's image rows r0 + p0 / w .. and R above, clamped
  const int row0 = max(0, min(d.r0 + p0 / d.w - q.R, d.h - q.rows));
  const int win_off = row0 * d.w, win_px = q.rows * d.w;
  const int64_t item = int64_t(bi) * d.h * d.w * d.c;
  const T* src = img + item;
  float* dst = d_img + item;
  const int64_t s0 = (int64_t(bi) * d.P + p0) * d.L;  // the tile's first sample
  const int G = q.G, cw = q.cw;
  const int j = threadIdx.x & (G - 1), grp = threadIdx.x / G, n_grp = NT / G;

  for (int e = threadIdx.x; e < win_px * cw; e += NT) win[e] = 0.0f;
  __syncthreads();

  for (int c0 = 0; c0 < d.c; c0 += cw) {
    const int ch = c0 + j * V;
    const bool lane_on = ch < d.c;  // c % V == 0, so the lane's whole vector is in range
    // The rounds are uniform over the block, so every lane reaches the shuffles. Group grp takes
    // samples [grp * rounds, (grp + 1) * rounds): the groups of one round work on samples spread
    // over the tile, not on the L flows of one pixel, which small flows send to the same taps, where
    // the compare-and-swaps of concurrent groups would fail and retry.
    const int rounds = (n_samp + n_grp - 1) / n_grp;
    for (int r = 0; r < rounds; ++r) {
      const int i = r + grp * rounds;
      const int64_t s = s0 + i;
      const bool on = i < n_samp;
      float prev_y = 0.0f, prev_x = 0.0f, dy = 0.0f, dx = 0.0f;
      if (on && j == 0 && c0 > 0) {  // this block's sum over the earlier chunks
        prev_y = d_iy[s];
        prev_x = d_ix[s];
      }
      if (on && lane_on) {
        const Taps t = make_taps(__ldg(iy + s), __ldg(ix + s), d.h, d.w);
        const Vec<T, V> gv = *reinterpret_cast<const Vec<T, V>*>(g + s * d.c + ch);
        Vec<T, V> tv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (t.valid[k]) {
            tv[k] = *reinterpret_cast<const Vec<T, V>*>(src + int64_t(t.off[k]) * d.c + ch);
          } else {
#pragma unroll
            for (int v = 0; v < V; ++v) tv[k].v[v] = from_f<T>(0.0f);
          }
        }
        float gf[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          gf[v] = to_f(gv.v[v]);
          const float v00 = to_f(tv[0].v[v]), v01 = to_f(tv[1].v[v]);
          const float v10 = to_f(tv[2].v[v]), v11 = to_f(tv[3].v[v]);
          dy += gf[v] * (t.wx0 * (v10 - v00) + t.wx1 * (v11 - v01));
          dx += gf[v] * (t.wy0 * (v01 - v00) + t.wy1 * (v11 - v10));
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!t.valid[k]) continue;
          const int px = t.off[k] - win_off;
          if (unsigned(px) < unsigned(win_px))  // in the band: the shared window
            add_window<V>(win + px * cw + j * V, gf, t.wt[k]);
          else  // out of the band: global memory
            add_global<V>(dst + int64_t(t.off[k]) * d.c + ch, gf, t.wt[k], q.v4);
        }
      }
      for (int o = G >> 1; o > 0; o >>= 1) {
        dy += __shfl_xor_sync(0xffffffffu, dy, o);
        dx += __shfl_xor_sync(0xffffffffu, dx, o);
      }
      if (on && j == 0) {
        d_iy[s] = prev_y + dy;
        d_ix[s] = prev_x + dx;
      }
    }
    __syncthreads();  // the window is complete
    // flush: add the window into d_img and zero it for the next chunk
    if (q.v4) {
      const int units = cw / 4;
      for (int e = threadIdx.x; e < win_px * units; e += NT) {
        const int px = e / units, cl = (e - px * units) * 4;
        float4* at = reinterpret_cast<float4*>(win + px * cw + cl);
        const float4 a = *at;
        *at = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (c0 + cl < d.c && (a.x != 0.0f || a.y != 0.0f || a.z != 0.0f || a.w != 0.0f))
          atomicAdd(reinterpret_cast<float4*>(dst + int64_t(win_off + px) * d.c + c0 + cl), a);
      }
    } else {
      for (int e = threadIdx.x; e < win_px * cw; e += NT) {
        const int px = e / cw, cl = e - px * cw;
        const float a = win[e];
        win[e] = 0.0f;
        if (c0 + cl < d.c && a != 0.0f) atomicAdd(dst + int64_t(win_off + px) * d.c + c0 + cl, a);
      }
    }
    __syncthreads();  // the window is zero again
  }
}

bool valid_dims(const Dims& d) {
  return d.b > 0 && d.P > 0 && d.L > 0 && d.h > 0 && d.w > 0 && d.c > 0 && d.r0 >= 0 &&
         d.r0 <= d.h &&
         int64_t(d.h) * d.w * d.c < (int64_t(1) << 31);  // tap offsets within an item are int
}

// The backward's tiling on the current device. Channels per pass, cw = G * V with G a power of two
// (at most 32):
// the fewest passes of at most CW_MAX channels, and passes of 32 where c is not a multiple of a wider
// pass (96 channels: three passes of 32, not 64 and a half-idle 32). R: 6 rows at w >= 48, else 4
// (the TPU kernels' 6 at 64 and 4 at 32). Tiles of TILE_ROWS rows, halved while b * tiles falls short
// of one block per SM. The window, the tile's rows plus R above and below clamped to h, must fit in
// shared memory: R shrinks to 4, then the tiles, then the window itself (to none at all).
// Threads: 1024 (64 registers each, so one block per SM) where the window leaves room for only one
// block per SM anyway, else 512, so that two or more blocks share an SM.
cudaError_t bwd_geometry(const Dims& d, int V, bool d_img_aligned16, BwdGeom* q, size_t* smem) {
  int sms = 0, smem_max = 0, smem_sm = 0;
  const cudaError_t err = device_limits(&sms, &smem_max, &smem_sm);
  if (err != cudaSuccess) return err;
  q->G = 1;
  while (q->G * V < d.c && 2 * q->G * V <= CW_MAX && 2 * q->G <= 32) q->G *= 2;  // a group fits a warp
  while (q->G * V > 32 && d.c % (q->G * V)) q->G /= 2;
  q->cw = q->G * V;
  q->v4 = d.c % 4 == 0 && d_img_aligned16;
  q->R = d.w >= 48 ? 6 : 4;
  auto tile_px = [&](int out_rows) { return std::min<int64_t>(int64_t(out_rows) * d.w, d.P); };
  auto window_bytes = [&](int rows) {
    return int64_t(std::min(rows, d.h)) * d.w * q->cw * int64_t(sizeof(float));
  };
  int out_rows = TILE_ROWS;
  while (out_rows > 1 && d.b * ((d.P + tile_px(out_rows) - 1) / tile_px(out_rows)) < sms)
    out_rows /= 2;
  while (window_bytes(out_rows + 2 * q->R) > smem_max && (q->R > 4 || out_rows > 1)) {
    if (q->R > 4)
      --q->R;
    else
      out_rows /= 2;
  }
  q->tile_px = int(tile_px(out_rows));
  q->tiles = int((d.P + q->tile_px - 1) / q->tile_px);
  int rows = std::min(d.h, out_rows + 2 * q->R);
  while (rows > 0 && window_bytes(rows) > smem_max) --rows;
  q->rows = rows;
  *smem = size_t(rows) * d.w * q->cw * sizeof(float);
  q->threads = 2 * (*smem + 1024) > size_t(smem_sm) ? 1024 : 512;
  return int64_t(d.b) * q->tiles > 0x7fffffff ? cudaErrorInvalidValue : cudaSuccess;
}

template <typename T, int V, int NT>
cudaError_t launch_bwd_k(const float* iy, const float* ix, const void* img, const void* g,
                         float* d_img, float* d_iy, float* d_ix, Dims d, const BwdGeom& q,
                         size_t smem, cudaStream_t stream) {
  auto kernel = warp_bwd_kernel<T, V, NT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<unsigned(int64_t(d.b) * q.tiles), NT, smem, stream>>>(
      iy, ix, static_cast<const T*>(img), static_cast<const T*>(g), d_img, d_iy, d_ix, d, q);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_bwd_v(const float* iy, const float* ix, const void* img, const void* g,
                         float* d_img, float* d_iy, float* d_ix, Dims d, cudaStream_t stream) {
  BwdGeom q;
  size_t smem = 0;
  cudaError_t err = bwd_geometry(d, V, aligned16(d_img), &q, &smem);
  if (err != cudaSuccess) return err;
  return q.threads == 1024
             ? launch_bwd_k<T, V, 1024>(iy, ix, img, g, d_img, d_iy, d_ix, d, q, smem, stream)
             : launch_bwd_k<T, V, 512>(iy, ix, img, g, d_img, d_iy, d_ix, d, q, smem, stream);
}

template <typename T>
cudaError_t launch_bwd(const float* iy, const float* ix, const void* img, const void* g,
                       float* d_img, float* d_iy, float* d_ix, Dims d, cudaStream_t stream) {
  switch (vec_width<T>(d, img, g)) {
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch_bwd_v<T, 8>(iy, ix, img, g, d_img, d_iy, d_ix, d, stream);
      return cudaErrorInvalidValue;
    case 4:
      return launch_bwd_v<T, 4>(iy, ix, img, g, d_img, d_iy, d_ix, d, stream);
    case 2:
      return launch_bwd_v<T, 2>(iy, ix, img, g, d_img, d_iy, d_ix, d, stream);
    default:
      return launch_bwd_v<T, 1>(iy, ix, img, g, d_img, d_iy, d_ix, d, stream);
  }
}

}  // namespace

extern "C" {

// The forward on `stream`: out [b, P, L, c] from iy, ix [b, P, L] (f32) and img [b, h, w, c]; img
// and out are bf16 when is_bf16 is set, else f32. All contiguous. row0 (0 <= row0 <= h): the image
// row of output pixel 0, which places the tiles' bands. Returns a cudaError_t (0 on success).
int vp_warp_sample_fwd(int is_bf16, const float* iy, const float* ix, const void* img, void* out,
                       int b, int P, int L, int h, int w, int c, int row0, void* stream) {
  const Dims d{b, P, L, h, w, c, row0};
  if (!valid_dims(d)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return finish(is_bf16 ? launch_fwd<__nv_bfloat16>(iy, ix, img, out, d, st)
                        : launch_fwd<float>(iy, ix, img, out, d, st));
}

// The backward on `stream`: adds into d_img [b, h, w, c] (f32, zeroed by the caller) and writes
// d_iy, d_ix [b, P, L] (f32) from g [b, P, L, c] in img's type (bf16 when is_bf16 is set, else f32).
// All contiguous. row0 as for the forward. Returns a cudaError_t (0 on success).
int vp_warp_sample_bwd(int is_bf16, const float* iy, const float* ix, const void* img,
                       const void* g, float* d_img, float* d_iy, float* d_ix, int b, int P, int L,
                       int h, int w, int c, int row0, void* stream) {
  const Dims d{b, P, L, h, w, c, row0};
  if (!valid_dims(d)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return finish(is_bf16 ? launch_bwd<__nv_bfloat16>(iy, ix, img, g, d_img, d_iy, d_ix, d, st)
                        : launch_bwd<float>(iy, ix, img, g, d_img, d_iy, d_ix, d, st));
}

// The backward's tiling for operands of these sizes on the current device, assuming vector-aligned
// tensors: out[0..8] = {tile_px, tiles, R, rows, G, cw, V, shared bytes, threads per block}. For reports of where the
// taps land (which share leaves the band); the kernel computes the same. Returns a cudaError_t.
int vp_warp_bwd_geometry(int is_bf16, int b, int P, int L, int h, int w, int c, int* out) {
  const Dims d{b, P, L, h, w, c, 0};
  if (!valid_dims(d)) return cudaErrorInvalidValue;
  int V = is_bf16 ? 8 : 4;
  while (V > 1 && c % V) V /= 2;
  BwdGeom q;
  size_t smem = 0;
  const cudaError_t err = bwd_geometry(d, V, true, &q, &smem);
  if (err != cudaSuccess) return finish(err);
  const int vals[9] = {q.tile_px, q.tiles, q.R, q.rows, q.G, q.cw, V, int(smem), q.threads};
  for (int k = 0; k < 9; ++k) out[k] = vals[k];
  return 0;
}

// The forward's tiling for operands of these sizes on the current device, assuming vector-aligned
// tensors: out[0..9] = {tile_px, tiles, R, rows, cw, passes, vpl, V, shared bytes, threads per
// block}.
// For reports of where the taps land (which share leaves the band); the kernel computes the same.
// Returns a cudaError_t.
int vp_warp_fwd_geometry(int is_bf16, int b, int P, int L, int h, int w, int c, int* out) {
  const Dims d{b, P, L, h, w, c, 0};
  if (!valid_dims(d)) return cudaErrorInvalidValue;
  const int esize = is_bf16 ? 2 : 4;
  int V = 16 / esize;
  while (V > 1 && c % V) V /= 2;
  FwdGeom q;
  size_t smem = 0;
  const cudaError_t err = fwd_geometry(d, V, esize, &q, &smem);
  if (err != cudaSuccess) return finish(err);
  const int vals[10] = {q.tile_px, q.tiles, q.R, q.rows, q.cw, q.passes, q.vpl, V, int(smem),
                        q.threads};
  for (int k = 0; k < 10; ++k) out[k] = vals[k];
  return 0;
}

const char* vp_cuda_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

}  // extern "C"
