// Warp by prebuilt factor matrices, for Hopper (sm_90a): forward and backward.
//
// Replaces the JAX package's TPU kernels in ops/pallas_warp.py, reached through warp_contract: the
// forward _warp_kernel (K9a, through _warp_contract_pallas), and the backward _warp_bwd_dimg_kernel
// (K9b) and _warp_bwd_dab_kernel (K9c), both through _warp_bwd_pallas.
//
// Function, for batch item bi, flow l, output pixel p and channel c, with any real factors A, Bm:
//   out[bi, l, p, c] = sum_{y, x} A[bi, l, p, y] * Bm[bi, l, p, x] * img[bi, y, x, c]
// i.e. one GEMM per (bi, l) against M[p, (y, x)] = A[p, y] * Bm[p, x]. M is formed in the input type
// (a bf16 product is rounded, as the TPU kernel forms it), products are summed in f32 and out is
// rounded once. The backward, from g = d out [b, L, P, c]:
//   d_img[bi, y, x, c] = sum_{l, p} M[p, (y, x)] * g[bi, l, p, c]          (K9b)
//   T_y[p, x] = sum_c g[p, c] * img[y, x, c]                               (f32)
//   d_A[p, y] = sum_x Bm[p, x] * T_y[p, x],  d_Bm[p, x] = sum_y A[p, y] * T_y[p, x]   (K9c)
// all in f32, rounded once to the inputs' type.
//
// Layout, the JAX package's: A [b, L, P, h], Bm [b, L, P, w], img [b, h, w, c], out and g
// [b, L, P, c], all of one type.
//
// Bound: operations. The forward is 2*b*L*P*h*w*c operations, 0.89 TFLOP at b=32, L=13, 64x64,
// c=64, against some 650 MB of A, Bm and out in bf16; the backward twice that.
//
// Design, simple first: each kernel is a GEMM whose one operand a block builds in shared memory
// from the factors, 64 rows at a time, and contracts on the tensor cores (bf16, WMMA) or on FMAs
// (f32) into a 64x64 f32 tile in registers (warp_common.cuh). No atomics: every output element is
// owned by one block, so all three results are the same from run to run.
// - Forward: a block owns (bi, l, 64 pixels, 64 channels); for each image row y it builds
//   M[:, y, :] = A[:, y] * Bm [64, w], stages row y of the image [w, 64 channels] and accumulates.
// - d_img: a block owns (bi, 64 flattened image pixels (y, x), 64 channels) and walks every (l,
//   64-pixel tile), building M^T's rows for its image pixels and staging g's tile.
// - d_A and d_Bm: a block owns (bi, l, 64 pixels) and keeps g's tile [64, c] in shared memory; for
//   each y (and 64 columns x at a time) it forms T_y = g img_y^T on the tensor cores, then reduces
//   T_y against Bm into d_A[:, y] and adds A[:, y] * T_y into d_Bm, which stays in shared memory
//   (f32) across y, as the TPU kernel's one T does.
#include "warp_common.cuh"

namespace {

using namespace warpk;

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

bool valid_dims(const FacDims& d) {
  return d.b > 0 && d.L > 0 && d.P > 0 && d.h > 0 && d.w > 0 && d.c > 0 &&
         int64_t(d.h) * d.w < (int64_t(1) << 31);
}

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
                       void* d_Bm, void* d_img, FacDims d, cudaStream_t stream) {
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

}  // namespace

extern "C" {

// The forward on `stream`: out [b, L, P, c] from A [b, L, P, h], Bm [b, L, P, w] and img [b, h, w, c],
// all bf16 when is_bf16 is set, else f32, contiguous. Returns a cudaError_t (0 on success).
int vp_warp_contract_fwd(int is_bf16, const void* A, const void* Bm, const void* img, void* out,
                         int b, int L, int P, int h, int w, int c, void* stream) {
  const FacDims d{b, L, P, h, w, c};
  if (!valid_dims(d)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return finish(is_bf16 ? launch_fwd<__nv_bfloat16>(A, Bm, img, out, d, st)
                        : launch_fwd<float>(A, Bm, img, out, d, st));
}

// The backward on `stream`, two launches: d_img [b, h, w, c], d_A [b, L, P, h] and d_Bm [b, L, P, w]
// from g [b, L, P, c], all in the inputs' type and contiguous. Returns a cudaError_t.
int vp_warp_contract_bwd(int is_bf16, const void* A, const void* Bm, const void* img, const void* g,
                         void* d_A, void* d_Bm, void* d_img, int b, int L, int P, int h, int w,
                         int c, void* stream) {
  const FacDims d{b, L, P, h, w, c};
  if (!valid_dims(d)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return finish(is_bf16 ? launch_bwd<__nv_bfloat16>(A, Bm, img, g, d_A, d_Bm, d_img, d, st)
                        : launch_bwd<float>(A, Bm, img, g, d_A, d_Bm, d_img, d, st));
}

const char* vp_cuda_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

}  // extern "C"
