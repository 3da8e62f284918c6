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
// is any number of output pixels.
//
// Bound: operations. The forward's two contractions over (l, k) are 2*b*P*L*f*O operations, 41.9
// GFLOP at b=32, 64x64, L=13, f=64, O=192, against about 81 MB of image, indices and output; the
// backward needs two such products (g_l and d_W) beside its gathers and its scatter.
//
// Design, simple first. What K8 keeps out of device memory is the [b, P, L, f] warp tensor (218 MB
// per call at 64x64x64 in bf16), and so does this one: a block gathers one flow's warp for a
// 64-pixel tile into shared memory, rounds it, and contracts it at once with W_l on the tensor
// cores (bf16, WMMA) or on FMAs (f32), into a 64x64 f32 tile (warp_common.cuh) that stays in
// registers across all L flows.
// - Forward: one block per (batch item, 64 pixels, 64 output channels); the gather is repeated for
//   each block of output channels.
// - Backward, pass 1 (K8b and K8c's index half): one block per (batch item, 64 pixels) keeps the g
//   tile in shared memory; for each flow it forms g_l in 64-channel blocks, rounds it into shared
//   memory, and one warp per sample scatters g_l * weight into d_img with f32 atomics and reduces
//   d_iy and d_ix with shuffles, as warp_sample.cu's backward does. d_img's summation order follows
//   the atomics and varies from run to run.
// - Backward, pass 2 (K8c's d_W): d_W sums over all b*P pixels, and blocks run in no order, so no
//   block can own it as the TPU's in-order grid did. A block owns (flow, 64 f-channels, 64 output
//   channels, slice s) and walks the pixel tiles s, s + S, s + 2S, ...: it gathers warp_l's tile
//   again, as the TPU kernel recomputes it, and accumulates warp_l^T * g in registers; it writes one
//   partial [S, L, f, O] and a third launch sums the S partials in order. No atomics: d_W is the
//   same from run to run (f32 sums, within a block in tile order, then over slices in order).
#include "warp_common.cuh"

namespace {

using namespace warpk;

struct RetDims {
  int b, P, L, h, w, f, O;
};

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

template <typename T>
struct FwdLayout {
  int fpad, lda, ldb;
  size_t a, b, c, taps, bytes;
  __host__ __device__ explicit FwdLayout(int f) {
    fpad = round_up(f, 16);
    lda = fpad + Pad<T>::value;
    ldb = TILE + Pad<T>::value;
    a = 0;
    b = a + align128(size_t(TILE) * lda * sizeof(T));
    c = b + align128(size_t(fpad) * ldb * sizeof(T));
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
  const FwdLayout<T> lay(d.f);
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
  for (int l = 0; l < d.L; ++l) {
    __syncthreads();  // the previous flow's product is done with shared memory
    load_taps(sOff, sWt, iy, ix, d, bi, p0, l);
    for (int idx = threadIdx.x; idx < lay.fpad * TILE; idx += TILE_THREADS) {
      const int k = idx / TILE, j = idx % TILE, o = o0 + j;
      sB[k * lay.ldb + j] = k < d.f && o < d.O ? w[(size_t(l) * d.f + k) * d.O + o] : from_f<T>(0.0f);
    }
    __syncthreads();
    gather_tile(sA, lay.lda, lay.fpad, img_item, sOff, sWt, d.f, 0);
    __syncthreads();
    tile_mma<false, false>(sA, lay.lda, sB, lay.ldb, lay.fpad, acc);
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
  int opad, ldg, ldw;
  size_t g, wt, c, gl, bytes;
  __host__ __device__ BwdLayout(int f, int O) {
    opad = round_up(O, TILE);
    ldg = opad + Pad<T>::value;
    ldw = TILE + Pad<T>::value;
    g = 0;
    wt = g + align128(size_t(TILE) * ldg * sizeof(T));
    c = wt + align128(size_t(TILE) * ldw * sizeof(T));
    gl = c + align128(size_t(TILE) * LDC * sizeof(float));
    bytes = gl + align128(size_t(TILE) * f * sizeof(T));
  }
};

// Pass 1: d_img (f32, zeroed by the caller), d_iy and d_ix.
template <typename T>
__global__ void __launch_bounds__(TILE_THREADS)
    warp_ret_bwd_img_kernel(const float* __restrict__ iy, const float* __restrict__ ix,
                            const T* __restrict__ img, const T* __restrict__ w,
                            const T* __restrict__ g, float* __restrict__ d_img,
                            float* __restrict__ d_iy, float* __restrict__ d_ix, RetDims d) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdLayout<T> lay(d.f, d.O);
  T* sG = reinterpret_cast<T*>(smem + lay.g);
  T* sW = reinterpret_cast<T*>(smem + lay.wt);
  float* sC = reinterpret_cast<float*>(smem + lay.c);
  T* sGl = reinterpret_cast<T*>(smem + lay.gl);

  const int n_pt = (d.P + TILE - 1) / TILE;
  const int p0 = (blockIdx.x % n_pt) * TILE, bi = blockIdx.x / n_pt;
  const size_t img_item = size_t(bi) * d.h * d.w * d.f;
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;

  for (int idx = threadIdx.x; idx < TILE * lay.opad; idx += TILE_THREADS) {
    const int i = idx / lay.opad, o = idx % lay.opad, p = p0 + i;
    sG[i * lay.ldg + o] = p < d.P && o < d.O ? g[(size_t(bi) * d.P + p) * d.O + o] : from_f<T>(0.0f);
  }
  for (int l = 0; l < d.L; ++l) {
    // g_l = g W_l^T, 64 f-channels at a time, over 64 output channels at a time
    for (int k0 = 0; k0 < d.f; k0 += TILE) {
      TileAcc<T> acc;
      tile_zero(acc);
      for (int o0 = 0; o0 < lay.opad; o0 += TILE) {
        __syncthreads();  // sW (and sGl, sC) free again
        for (int idx = threadIdx.x; idx < TILE * TILE; idx += TILE_THREADS) {
          const int j = idx / TILE, o = idx % TILE, k = k0 + j;
          sW[j * lay.ldw + o] =
              k < d.f && o0 + o < d.O ? w[(size_t(l) * d.f + k) * d.O + o0 + o] : from_f<T>(0.0f);
        }
        __syncthreads();
        tile_mma<false, true>(sG + o0, lay.ldg, sW, lay.ldw, TILE, acc);
      }
      tile_store(acc, sC);
      __syncthreads();
      for (int idx = threadIdx.x; idx < TILE * TILE; idx += TILE_THREADS) {
        const int i = idx / TILE, j = idx % TILE;
        if (k0 + j < d.f) sGl[i * d.f + k0 + j] = from_f<T>(sC[i * LDC + j]);
      }
    }
    __syncthreads();
    // the warp's backward of g_l: one warp per sample (p is the same for all lanes of a warp)
    for (int i = wi; i < TILE; i += TILE_THREADS / 32) {
      const int p = p0 + i;
      if (p >= d.P) break;
      const int s = sample_index(d, bi, p, l);
      const Taps t = make_taps(__ldg(iy + s), __ldg(ix + s), d.h, d.w);
      float dy = 0.0f, dx = 0.0f;
      for (int k = lane; k < d.f; k += 32) {
        const float gv = to_f(sGl[i * d.f + k]);
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
        d_iy[s] = dy;
        d_ix[s] = dx;
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

template <typename T>
cudaError_t launch_fwd(const float* iy, const float* ix, const void* img, const void* w,
                       const float* bias, void* out, RetDims d, cudaStream_t stream) {
  const int64_t grid = int64_t(d.b) * ((d.P + TILE - 1) / TILE) * ((d.O + TILE - 1) / TILE);
  return launch_tiles(warp_ret_fwd_kernel<T>, grid, FwdLayout<T>(d.f).bytes, stream, iy, ix,
                      static_cast<const T*>(img), static_cast<const T*>(w), bias,
                      static_cast<T*>(out), d);
}

template <typename T>
cudaError_t launch_bwd(const float* iy, const float* ix, const void* img, const void* w,
                       const void* g, float* d_img, float* d_iy, float* d_ix, float* partial,
                       float* d_w, int n_slices, RetDims d, cudaStream_t stream) {
  const int n_pt = (d.P + TILE - 1) / TILE;
  cudaError_t err = launch_tiles(warp_ret_bwd_img_kernel<T>, int64_t(d.b) * n_pt,
                                 BwdLayout<T>(d.f, d.O).bytes, stream, iy, ix,
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
// and bias [O] (f32); img, W and out are bf16 when is_bf16 is set, else f32. All contiguous.
// Returns a cudaError_t (0 on success).
int vp_warp_ret_fwd(int is_bf16, const float* iy, const float* ix, const void* img, const void* w,
                    const float* bias, void* out, int b, int P, int L, int h, int wd, int f, int O,
                    void* stream) {
  const RetDims d{b, P, L, h, wd, f, O};
  if (!valid_dims(d)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return finish(is_bf16 ? launch_fwd<__nv_bfloat16>(iy, ix, img, w, bias, out, d, st)
                        : launch_fwd<float>(iy, ix, img, w, bias, out, d, st));
}

// The backward on `stream`, three launches: adds into d_img [b, h, w, f] (f32, zeroed by the
// caller), writes d_iy, d_ix [b, P, L] and d_w [L, f, O] (f32) from g [b, P, O] in img's type,
// using partial [n_slices, L, f, O] (f32) as scratch. All contiguous. Returns a cudaError_t.
int vp_warp_ret_bwd(int is_bf16, const float* iy, const float* ix, const void* img, const void* w,
                    const void* g, float* d_img, float* d_iy, float* d_ix, float* partial,
                    float* d_w, int n_slices, int b, int P, int L, int h, int wd, int f, int O,
                    void* stream) {
  const RetDims d{b, P, L, h, wd, f, O};
  if (!valid_dims(d) || n_slices < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return finish(is_bf16 ? launch_bwd<__nv_bfloat16>(iy, ix, img, w, g, d_img, d_iy, d_ix, partial,
                                                    d_w, n_slices, d, st)
                        : launch_bwd<float>(iy, ix, img, w, g, d_img, d_iy, d_ix, partial, d_w,
                                            n_slices, d, st));
}

const char* vp_cuda_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

}  // extern "C"
