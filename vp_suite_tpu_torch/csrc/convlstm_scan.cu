// Whole-recurrence ConvLSTM forward scan (peephole ConvLSTM, Shi et al.) for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel ops/pallas_convlstm.py:_make_scan_kernel, reached
// through _fwd_call with save_gates=False (public entry convlstm_scan_fused).
//
// For each step t, batch item, pixel (y, x) and hidden channel j, with gates g in (i, f, c, o):
//   z_g = sum_{dy,dx,k} h_{t-1}[y+dy-1, x+dx-1, k] * W[dy, dx, k, g*enc + j] + bias[g*enc + j]
//         (+ i2h[t, b, y, x, g*enc + j] when the input half is given)
//   i = s(z_i + wci*c), f = s(z_f + wcf*c), c' = f*c + i*tanh(z_c), o = s(z_o + wco*c'),
//   h = o*tanh(c')
// The 3x3 taps read zeros outside the image. Products are taken in the activation type (bf16
// or f32) and summed in f32, the gate math is f32, the cell carry c stays f32 and h is rounded
// to the activation type: the TPU kernel's rules.
//
// Bound: the hidden convolution, 2*sh*sw*9enc*4enc operations per step and batch item, makes
// the scan compute-bound on this card. At b=32 and 64x64x64 one step is 38.7 GFLOP against
// some 30 MB of h, c and i2h traffic.
//
// Design: one cooperative launch covers all T steps. A work tile is 16x4 output pixels by 16
// hidden channels of one batch item, with all four gates of those channels (64 GEMM columns,
// K = 9*enc). Persistent blocks walk the tiles of a step; the grid then synchronises before the
// next step reads the h that this one wrote. One item's carry does not fit a block's shared
// memory at 64x64 or 32x32, so the carry stays in global memory, where the 50 MB L2 holds it:
// step t reads h_{t-1} from h_seq[t-1] (or h0) and writes h_seq[t], so the output doubles as the
// h double buffer, and the f32 cell state is updated in place in the caller's c buffer (each
// element is read and written by one thread within one step). A tile loads its haloed 18x6
// patch of h_{t-1} once into shared memory, where all nine taps read it, and stages one tap's
// weight slice at a time. bf16 contracts on the tensor cores through WMMA 16x16x16 fragments
// with f32 accumulation; f32 contracts with FMAs, so that it can be held tightly against the
// plain version.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TILE_W = 16;               // output pixels per tile row (one WMMA row block)
constexpr int TILE_H = 4;                // output rows per tile
constexpr int TILE_P = TILE_W * TILE_H;  // 64 output pixels
constexpr int HALO_W = TILE_W + 2;
constexpr int HALO_H = TILE_H + 2;
constexpr int HALO_P = HALO_W * HALO_H;  // 108 haloed input pixels
constexpr int JC = 16;                   // hidden channels per tile
constexpr int TN = 4 * JC;               // GEMM columns per tile: gates i, f, c, o of JC channels
constexpr int LDC = TN + 4;              // row stride of the f32 accumulator tile
constexpr int THREADS = 256;             // 8 warps; thread (r, cc) owns pixel column r, channel cc

struct ScanParams {
  const void* i2h;    // [T, b, sh, sw, 4enc] or nullptr (decode mode)
  const void* h0;     // [b, sh, sw, enc]
  float* c;           // [b, sh, sw, enc] f32: c0 on entry, c_last on exit
  const void* w;      // [3, 3, enc, 4enc]
  const float* bias;  // [4enc]
  const void* wci;    // [sh, sw, enc]
  const void* wcf;
  const void* wco;
  void* h_seq;        // [T, b, sh, sw, enc]
  int T, b, sh, sw, enc;
  int tiles_x, tiles_y, tiles_j, n_tiles;
};

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

template <typename T>
__host__ __device__ size_t smem_a_bytes(int enc) {
  return align128(size_t(HALO_P) * (enc + Traits<T>::PAD) * sizeof(T));
}
template <typename T>
__host__ __device__ size_t smem_b_bytes(int enc) {
  return align128(size_t(enc) * (TN + Traits<T>::PAD) * sizeof(T));
}
template <typename T>
size_t smem_bytes(int enc) {
  return smem_a_bytes<T>(enc) + smem_b_bytes<T>(enc) + align128(size_t(TILE_P) * LDC * sizeof(float));
}

// Stages tap `tap`'s weights for the tile's channels: sB[k][g*JC + jj] = W[tap][k][g*enc + j0 + jj].
template <typename T>
__device__ __forceinline__ void load_b_tap(T* sB, const T* w, int tap, int j0, int enc, int ldb) {
  constexpr int V = Traits<T>::VEC;
  constexpr int VPG = JC / V;
  const int total = enc * 4 * VPG;
  for (int idx = threadIdx.x; idx < total; idx += THREADS) {
    const int v = idx % VPG;
    const int g = (idx / VPG) % 4;
    const int k = idx / (VPG * 4);
    const T* src = w + (size_t(tap) * enc + k) * 4 * enc + g * enc + j0 + v * V;
    *reinterpret_cast<uint4*>(sB + k * ldb + g * JC + v * V) = *reinterpret_cast<const uint4*>(src);
  }
}

// f32: FMA contraction. Thread (r, cc) accumulates pixels (m, r) for m < TILE_H and column
// q*JC + cc (gate q of channel cc) straight into z.
__device__ __forceinline__ void tile_gemm(const float* sA, float* sB, const float* w, int j0, int enc,
                                          int lda, int ldb, int r, int cc, float (&z)[TILE_H][4],
                                          float* /*sC*/) {
  for (int tap = 0; tap < 9; ++tap) {
    __syncthreads();
    load_b_tap(sB, w, tap, j0, enc, ldb);
    __syncthreads();
    const int dy = tap / 3, dx = tap % 3;
    const float* a0 = sA + (dy * HALO_W + r + dx) * lda;
    for (int k = 0; k < enc; ++k) {
      float a[TILE_H], bb[4];
#pragma unroll
      for (int m = 0; m < TILE_H; ++m) a[m] = a0[m * HALO_W * lda + k];
#pragma unroll
      for (int q = 0; q < 4; ++q) bb[q] = sB[k * ldb + q * JC + cc];
#pragma unroll
      for (int m = 0; m < TILE_H; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q) z[m][q] = fmaf(a[m], bb[q], z[m][q]);
    }
  }
}

// bf16: tensor-core contraction. Warp w owns tile row w/2 (16 pixels) and the two gates
// 2*(w%2), 2*(w%2)+1; the accumulators go through shared memory to the thread layout above.
__device__ __forceinline__ void tile_gemm(const __nv_bfloat16* sA, __nv_bfloat16* sB,
                                          const __nv_bfloat16* w, int j0, int enc, int lda, int ldb,
                                          int r, int cc, float (&z)[TILE_H][4], float* sC) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32;
  const int mi = warp >> 1, q0 = (warp & 1) * 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
  for (int tap = 0; tap < 9; ++tap) {
    __syncthreads();
    load_b_tap(sB, w, tap, j0, enc, ldb);
    __syncthreads();
    const int dy = tap / 3, dx = tap % 3;
    const __nv_bfloat16* a_base = sA + ((mi + dy) * HALO_W + dx) * lda;
    for (int k0 = 0; k0 < enc; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, a_base + k0, lda);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
        wmma::load_matrix_sync(bf, sB + k0 * ldb + (q0 + q) * JC, ldb);
        wmma::mma_sync(acc[q], a, bf, acc[q]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q)
    wmma::store_matrix_sync(sC + mi * TILE_W * LDC + (q0 + q) * JC, acc[q], LDC, wmma::mem_row_major);
  __syncthreads();
#pragma unroll
  for (int m = 0; m < TILE_H; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q) z[m][q] = sC[(m * TILE_W + r) * LDC + q * JC + cc];
}

template <typename T>
__global__ void __launch_bounds__(THREADS) convlstm_scan_kernel(ScanParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int enc = p.enc;
  const int lda = enc + Traits<T>::PAD;
  const int ldb = TN + Traits<T>::PAD;
  T* sA = reinterpret_cast<T*>(smem);
  T* sB = reinterpret_cast<T*>(smem + smem_a_bytes<T>(enc));
  float* sC = reinterpret_cast<float*>(smem + smem_a_bytes<T>(enc) + smem_b_bytes<T>(enc));
  const int r = threadIdx.x / JC;
  const int cc = threadIdx.x % JC;
  constexpr int V = Traits<T>::VEC;
  const int vec_per_px = enc / V;
  const size_t plane = size_t(p.sh) * p.sw * enc;
  const T* wci = static_cast<const T*>(p.wci);
  const T* wcf = static_cast<const T*>(p.wcf);
  const T* wco = static_cast<const T*>(p.wco);
  cg::grid_group grid = cg::this_grid();

  for (int t = 0; t < p.T; ++t) {
    const T* h_prev = t == 0 ? static_cast<const T*>(p.h0)
                             : static_cast<const T*>(p.h_seq) + size_t(t - 1) * p.b * plane;
    T* h_out = static_cast<T*>(p.h_seq) + size_t(t) * p.b * plane;
    const T* x_t = p.i2h ? static_cast<const T*>(p.i2h) + size_t(t) * p.b * plane * 4 : nullptr;
    for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
      int rest = tile;
      const int tj = rest % p.tiles_j;
      rest /= p.tiles_j;
      const int tx = rest % p.tiles_x;
      rest /= p.tiles_x;
      const int ty = rest % p.tiles_y;
      const int bi = rest / p.tiles_y;
      const int y0 = ty * TILE_H, x0 = tx * TILE_W, j0 = tj * JC;
      const T* hb = h_prev + size_t(bi) * plane;

      __syncthreads();  // the previous tile is done with shared memory
      for (int idx = threadIdx.x; idx < HALO_P * vec_per_px; idx += THREADS) {
        const int hp = idx / vec_per_px, v = idx % vec_per_px;
        const int gy = y0 + hp / HALO_W - 1, gx = x0 + hp % HALO_W - 1;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (gy >= 0 && gy < p.sh && gx >= 0 && gx < p.sw)
          val = *reinterpret_cast<const uint4*>(hb + (size_t(gy) * p.sw + gx) * enc + v * V);
        *reinterpret_cast<uint4*>(sA + hp * lda + v * V) = val;
      }

      float z[TILE_H][4];
#pragma unroll
      for (int m = 0; m < TILE_H; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q) z[m][q] = 0.0f;
      tile_gemm(sA, sB, static_cast<const T*>(p.w), j0, enc, lda, ldb, r, cc, z, sC);

      const int j = j0 + cc;
#pragma unroll
      for (int m = 0; m < TILE_H; ++m) {
        const int gy = y0 + m, gx = x0 + r;
        if (gy >= p.sh || gx >= p.sw) continue;
        const size_t pk = size_t(gy) * p.sw + gx;                 // pixel within the image
        const size_t pix = size_t(bi) * p.sh * p.sw + pk;          // pixel within the batch
        float zg[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          zg[q] = z[m][q] + p.bias[q * enc + j];
          if (x_t) zg[q] += to_f(x_t[pix * 4 * enc + q * enc + j]);
        }
        const size_t ci = pix * enc + j;
        const size_t pi = pk * enc + j;
        const float c_prev = p.c[ci];
        const float ig = sigmoid_f(zg[0] + to_f(wci[pi]) * c_prev);
        const float fg = sigmoid_f(zg[1] + to_f(wcf[pi]) * c_prev);
        const float c_new = fg * c_prev + ig * tanhf(zg[2]);
        const float og = sigmoid_f(zg[3] + to_f(wco[pi]) * c_new);
        p.c[ci] = c_new;
        h_out[ci] = from_f<T>(og * tanhf(c_new));
      }
    }
    grid.sync();  // h_seq[t] is complete before step t + 1 reads it
  }
}

template <typename T>
int blocks_per_sm(int enc) {
  const size_t smem = smem_bytes<T>(enc);
  cudaError_t err = cudaFuncSetAttribute(convlstm_scan_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return -int(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, convlstm_scan_kernel<T>, THREADS, smem);
  if (err != cudaSuccess) return -int(err);
  return per_sm;
}

template <typename T>
cudaError_t launch(ScanParams p, cudaStream_t stream) {
  const int per_sm = blocks_per_sm<T>(p.enc);
  if (per_sm < 0) return cudaError_t(-per_sm);
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int grid = p.n_tiles < per_sm * sms ? p.n_tiles : per_sm * sms;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(convlstm_scan_kernel<T>), dim3(grid),
                                    dim3(THREADS), args, smem_bytes<T>(p.enc), stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Runs the whole scan on `stream`. Returns a cudaError_t (0 on success). All tensors are
// contiguous; i2h, h0, w, wci, wcf, wco and h_seq are bf16 when is_bf16 is set, else f32.
int vp_convlstm_scan_fwd(int is_bf16, const void* i2h, const void* h0, float* c, const void* w,
                         const float* bias, const void* wci, const void* wcf, const void* wco,
                         void* h_seq, int T, int b, int sh, int sw, int enc, void* stream) {
  if (T < 1 || b < 1 || sh < 1 || sw < 1 || enc < JC || enc % JC != 0) return cudaErrorInvalidValue;
  ScanParams p{i2h, h0, c, w, bias, wci, wcf, wco, h_seq, T, b, sh, sw, enc, 0, 0, 0, 0};
  p.tiles_x = (sw + TILE_W - 1) / TILE_W;
  p.tiles_y = (sh + TILE_H - 1) / TILE_H;
  p.tiles_j = enc / JC;
  p.n_tiles = b * p.tiles_y * p.tiles_x * p.tiles_j;
  cudaError_t err = is_bf16 ? launch<__nv_bfloat16>(p, static_cast<cudaStream_t>(stream))
                            : launch<float>(p, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) cudaGetLastError();  // clear it, so later launches do not report it
  return int(err);
}

const char* vp_cuda_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

}  // extern "C"
