// Whole-recurrence ConvLSTM forward scan (peephole ConvLSTM, Shi et al.) for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel ops/pallas_convlstm.py:_make_scan_kernel, reached
// through _fwd_call (public entry convlstm_scan_fused): its inference form (save_gates=False,
// K3) and its training form (save_gates=True, K3s), which also streams out the residuals that
// the reverse-time backward (convlstm_scan_bwd.cu) consumes.
//
// For each step t, batch item, pixel (y, x) and hidden channel j, with gates g in (i, f, c, o):
//   z_g = sum_{dy,dx,k} h_{t-1}[y+dy-1, x+dx-1, k] * W[dy, dx, k, g*enc + j] + bias[g*enc + j]
//         (+ i2h[t, b, y, x, g*enc + j] when the input half is given)
//   i = s(z_i + wci*c), f = s(z_f + wcf*c), c' = f*c + i*tanh(z_c), o = s(z_o + wco*c'),
//   h = o*tanh(c')
// The 3x3 taps read zeros outside the image. Products are taken in the activation type (bf16
// or f32) and summed in f32, the gate math is f32, the cell carry c stays f32 and h is rounded
// to the activation type: the TPU kernel's rules. With residuals asked for, step t also writes
// z [T, b, sh, sw, 4enc] (the conv layout: gate g of channel j at g*enc + j, so the backward's
// d_i2h is z's gradient as it stands) and the pre-update cell c_{t-1} [T, b, sh, sw, enc], both
// rounded to the activation type; h_seq is the same bit for bit either way.
//
// Bound: the hidden convolution, 2*sh*sw*9enc*4enc operations per step and batch item, makes
// the scan compute-bound on this card. At b=32 and 64x64x64 one step is 38.7 GFLOP against
// some 30 MB of h, c and i2h traffic (and 40 MB more of residuals when they are saved).
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
#include <mma.h>

#include "convlstm_common.cuh"

namespace cg = cooperative_groups;
using namespace convlstm;

namespace {

constexpr int TN = 4 * JC;       // GEMM columns per tile: gates i, f, c, o of JC channels
constexpr int LDC = TN + 4;      // row stride of the f32 accumulator tile

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
  void* z_seq;        // [T, b, sh, sw, 4enc] gate pre-activations, or nullptr (no residuals)
  void* c_prev_seq;   // [T, b, sh, sw, enc] pre-update cells, or nullptr
  int T, b, sh, sw, enc;
  int tiles_x, tiles_y, tiles_j, n_tiles;
};

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

// Resident blocks per SM that the register budget must allow: three in bf16 (at most 85
// registers a thread; with more, occupancy falls to two blocks and the scan runs some 12%
// slower), two in f32, where shared memory allows no more at enc=96.
template <typename T> struct MinBlocks { static constexpr int value = 2; };
template <> struct MinBlocks<__nv_bfloat16> { static constexpr int value = 3; };

template <typename T>
__global__ void __launch_bounds__(THREADS, MinBlocks<T>::value) convlstm_scan_kernel(ScanParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int enc = p.enc;
  const int lda = enc + Traits<T>::PAD;
  const int ldb = TN + Traits<T>::PAD;
  T* sA = reinterpret_cast<T*>(smem);
  T* sB = reinterpret_cast<T*>(smem + smem_a_bytes<T>(enc));
  float* sC = reinterpret_cast<float*>(smem + smem_a_bytes<T>(enc) + smem_b_bytes<T>(enc));
  const int r = threadIdx.x / JC;
  const int cc = threadIdx.x % JC;
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
    T* z_out = p.z_seq ? static_cast<T*>(p.z_seq) + size_t(t) * p.b * plane * 4 : nullptr;
    T* cp_out = p.z_seq ? static_cast<T*>(p.c_prev_seq) + size_t(t) * p.b * plane : nullptr;
    for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
      const TileIndex ti = tile_index(tile, p.tiles_x, p.tiles_y, p.tiles_j);
      __syncthreads();  // the previous tile is done with shared memory
      load_patch(sA, lda, h_prev + size_t(ti.bi) * plane, enc, 0, enc, ti.y0, ti.x0, p.sh, p.sw);

      float z[TILE_H][4];
#pragma unroll
      for (int m = 0; m < TILE_H; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q) z[m][q] = 0.0f;
      tile_gemm(sA, sB, static_cast<const T*>(p.w), ti.j0, enc, lda, ldb, r, cc, z, sC);

      const int j = ti.j0 + cc;
#pragma unroll
      for (int m = 0; m < TILE_H; ++m) {
        const int gy = ti.y0 + m, gx = ti.x0 + r;
        if (gy >= p.sh || gx >= p.sw) continue;
        const size_t pk = size_t(gy) * p.sw + gx;                 // pixel within the image
        const size_t pix = size_t(ti.bi) * p.sh * p.sw + pk;       // pixel within the batch
        float zg[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          zg[q] = z[m][q] + p.bias[q * enc + j];
          if (x_t) zg[q] += to_f(x_t[pix * 4 * enc + q * enc + j]);
        }
        const size_t ci = pix * enc + j;
        const size_t pi = pk * enc + j;
        const float c_prev = p.c[ci];
        if (z_out) {
#pragma unroll
          for (int q = 0; q < 4; ++q) z_out[pix * 4 * enc + q * enc + j] = from_f<T>(zg[q]);
          cp_out[ci] = from_f<T>(c_prev);
        }
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
// contiguous; i2h, h0, w, wci, wcf, wco, h_seq, z_seq and c_prev_seq are bf16 when is_bf16 is
// set, else f32. z_seq and c_prev_seq are both given (training residuals) or both null.
int vp_convlstm_scan_fwd(int is_bf16, const void* i2h, const void* h0, float* c, const void* w,
                         const float* bias, const void* wci, const void* wcf, const void* wco,
                         void* h_seq, void* z_seq, void* c_prev_seq, int T, int b, int sh, int sw,
                         int enc, void* stream) {
  if (T < 1 || b < 1 || sh < 1 || sw < 1 || enc < JC || enc % JC != 0) return cudaErrorInvalidValue;
  if ((z_seq == nullptr) != (c_prev_seq == nullptr)) return cudaErrorInvalidValue;
  ScanParams p{i2h, h0, c, w, bias, wci, wcf, wco, h_seq, z_seq, c_prev_seq,
               T, b, sh, sw, enc, 0, 0, 0, 0};
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
