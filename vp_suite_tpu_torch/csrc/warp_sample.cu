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
// [b*P, L*c] is the input of TrajGRU's 1x1 ret conv as one GEMM, with no transpose.
//
// Bound: bytes. The forward writes b*P*L*c outputs once (218 MB in bf16 at b=32, 64x64, L=13, c=64)
// and reads the indices once; the image (16.8 MB there) is read 4L times, mostly from the 50 MB L2.
// The backward reads g once and the image and indices again, and scatters into an f32 d_img
// (33.6 MB there) that stays in L2 under the atomics.
//
// Design, simple first: the forward gives each thread 16 bytes of channels of one sample (8 bf16 or
// 4 f32, when c and the pointers allow it, else one channel), so every tap is read and every output
// written as whole vectors, neighbouring threads on neighbouring addresses. The backward gives each
// sample one warp: the lanes stride over the channels, accumulate their share of d_iy and d_ix, and
// add g * weight into d_img with f32 atomics; a shuffle reduction gives the index gradients. d_img is
// f32 (the caller zeroes it and rounds it to img's type afterwards); its summation order follows the
// atomics and varies from run to run.
#include "warp_common.cuh"

namespace {

using namespace warpk;

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 16;  // cap of the grid-stride launch

template <typename T, int V> struct alignas(sizeof(T) * V) Vec { T v[V]; };

struct Dims {
  int b, P, L, h, w, c;
};

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
    warp_fwd_kernel(const float* __restrict__ iy, const float* __restrict__ ix,
                    const T* __restrict__ img, T* __restrict__ out, Dims d) {
  const int chunks = d.c / V;
  const int64_t per_item = int64_t(d.P) * d.L;
  const int64_t img_item = int64_t(d.h) * d.w * d.c;
  const int64_t n = int64_t(d.b) * per_item * chunks;
  for (int64_t i = int64_t(blockIdx.x) * THREADS + threadIdx.x; i < n;
       i += int64_t(gridDim.x) * THREADS) {
    const int64_t s = i / chunks;
    const int ch = int(i - s * chunks) * V;
    const Taps t = make_taps(__ldg(iy + s), __ldg(ix + s), d.h, d.w);
    const T* src = img + (s / per_item) * img_item + ch;
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      Vec<T, V> val;
      if (t.valid[k]) {
        val = *reinterpret_cast<const Vec<T, V>*>(src + int64_t(t.off[k]) * d.c);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) val.v[v] = from_f<T>(0.0f);
      }
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = fmaf(t.wt[k], to_f(val.v[v]), acc[v]);
    }
    Vec<T, V> res;
#pragma unroll
    for (int v = 0; v < V; ++v) res.v[v] = from_f<T>(acc[v]);
    *reinterpret_cast<Vec<T, V>*>(out + s * d.c + ch) = res;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    warp_bwd_kernel(const float* __restrict__ iy, const float* __restrict__ ix,
                    const T* __restrict__ img, const T* __restrict__ g, float* __restrict__ d_img,
                    float* __restrict__ d_iy, float* __restrict__ d_ix, Dims d) {
  const int lane = threadIdx.x & 31;
  const int64_t per_item = int64_t(d.P) * d.L;
  const int64_t img_item = int64_t(d.h) * d.w * d.c;
  const int64_t n = int64_t(d.b) * per_item;
  // one warp per sample; s is the same for all lanes of a warp, so the shuffles see full warps
  for (int64_t s = (int64_t(blockIdx.x) * THREADS + threadIdx.x) >> 5; s < n;
       s += (int64_t(gridDim.x) * THREADS) >> 5) {
    const Taps t = make_taps(__ldg(iy + s), __ldg(ix + s), d.h, d.w);
    const int64_t item = (s / per_item) * img_item;
    const T* src = img + item;
    float* dst = d_img + item;
    const T* gs = g + s * d.c;
    float dy = 0.0f, dx = 0.0f;
    for (int ch = lane; ch < d.c; ch += 32) {
      const float gv = to_f(gs[ch]);
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = t.valid[k] ? to_f(src[int64_t(t.off[k]) * d.c + ch]) : 0.0f;
      dy += gv * (t.wx0 * (v[2] - v[0]) + t.wx1 * (v[3] - v[1]));
      dx += gv * (t.wy0 * (v[1] - v[0]) + t.wy1 * (v[3] - v[2]));
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (t.valid[k]) atomicAdd(dst + int64_t(t.off[k]) * d.c + ch, gv * t.wt[k]);
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

bool valid_dims(const Dims& d) {
  return d.b > 0 && d.P > 0 && d.L > 0 && d.h > 0 && d.w > 0 && d.c > 0 &&
         int64_t(d.h) * d.w * d.c < (int64_t(1) << 31);  // tap offsets within an item are int
}

cudaError_t grid_for(int64_t threads, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t need = (threads + THREADS - 1) / THREADS, cap = int64_t(sms) * BLOCKS_PER_SM;
  *grid = int(need < cap ? need : cap);
  return cudaSuccess;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
cudaError_t launch_fwd(const float* iy, const float* ix, const void* img, void* out, Dims d,
                       cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = d.c % V == 0 && aligned16(img) && aligned16(out);
  int grid = 0;
  cudaError_t err = grid_for(int64_t(d.b) * d.P * d.L * (vec ? d.c / V : d.c), &grid);
  if (err != cudaSuccess) return err;
  if (vec)
    warp_fwd_kernel<T, V><<<grid, THREADS, 0, stream>>>(iy, ix, static_cast<const T*>(img),
                                                       static_cast<T*>(out), d);
  else
    warp_fwd_kernel<T, 1><<<grid, THREADS, 0, stream>>>(iy, ix, static_cast<const T*>(img),
                                                       static_cast<T*>(out), d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const float* iy, const float* ix, const void* img, const void* g,
                       float* d_img, float* d_iy, float* d_ix, Dims d, cudaStream_t stream) {
  int grid = 0;
  cudaError_t err = grid_for(int64_t(d.b) * d.P * d.L * 32, &grid);
  if (err != cudaSuccess) return err;
  warp_bwd_kernel<T><<<grid, THREADS, 0, stream>>>(iy, ix, static_cast<const T*>(img),
                                                   static_cast<const T*>(g), d_img, d_iy, d_ix, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The forward on `stream`: out [b, P, L, c] from iy, ix [b, P, L] (f32) and img [b, h, w, c]; img
// and out are bf16 when is_bf16 is set, else f32. All contiguous. Returns a cudaError_t (0 on
// success).
int vp_warp_sample_fwd(int is_bf16, const float* iy, const float* ix, const void* img, void* out,
                       int b, int P, int L, int h, int w, int c, void* stream) {
  const Dims d{b, P, L, h, w, c};
  if (!valid_dims(d)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return finish(is_bf16 ? launch_fwd<__nv_bfloat16>(iy, ix, img, out, d, st)
                        : launch_fwd<float>(iy, ix, img, out, d, st));
}

// The backward on `stream`: adds into d_img [b, h, w, c] (f32, zeroed by the caller) and writes
// d_iy, d_ix [b, P, L] (f32) from g [b, P, L, c] in img's type (bf16 when is_bf16 is set, else f32).
// All contiguous. Returns a cudaError_t (0 on success).
int vp_warp_sample_bwd(int is_bf16, const float* iy, const float* ix, const void* img,
                       const void* g, float* d_img, float* d_iy, float* d_ix, int b, int P, int L,
                       int h, int w, int c, void* stream) {
  const Dims d{b, P, L, h, w, c};
  if (!valid_dims(d)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return finish(is_bf16 ? launch_bwd<__nv_bfloat16>(iy, ix, img, g, d_img, d_iy, d_ix, d, st)
                        : launch_bwd<float>(iy, ix, img, g, d_img, d_iy, d_ix, d, st));
}

const char* vp_cuda_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

}  // extern "C"
