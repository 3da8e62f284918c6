// Reverse-time backward of the whole-recurrence ConvLSTM scan (K4) for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel ops/pallas_convlstm.py:_make_bwd_kernel, reached
// through _scan_fused_bwd. It consumes the residuals that the forward scan (convlstm_scan.cu)
// saves: the gate pre-activations z [T, b, sh, sw, 4enc] and the pre-update cells c_prev
// [T, b, sh, sw, enc], both in the activation type.
//
// Walking t from T-1 down to 0, with the carries dh (from step t+1's hidden conv) and dc in f32:
//   dh  = dh_carry + dh_seq[t]
//   i, f, g = tanh(z_c), c', o, tanh(c')  recomputed in f32 from z_t and c_prev_t
//   dz_o = dh*tanh(c')*o*(1-o);   dc2 = dc_carry + dh*o*(1 - tanh(c')^2) + dz_o*wco
//   dz_i = dc2*g*i*(1-i);  dz_f = dc2*c*f*(1-f);  dz_c = dc2*i*(1-g^2)
//   dz_t is rounded to the activation type, stored, and convolved from the rounded values:
//   dc_carry = dc2*f + dz_i*wci + dz_f*wcf   (f32, from the unrounded dz)
//   dh_carry[y, x, k] = sum_{dy,dx,n} dz_t[y-dy+1, x-dx+1, n] * W[dy, dx, k, n]
// (the transposed 3x3 conv: flipped taps, W read with its two channel axes swapped), and emits
// dz_seq, dh0 = dh_carry after step 0 and dc0 = dc_carry after step 0, both in f32. The weight,
// bias and peephole gradients are bulk contractions outside, as in the TPU version.
//
// Bound: the transposed conv, 2*sh*sw*9*4enc*enc operations per step and batch item (the
// forward's count), makes it compute-bound on this card; the gate backward is a few streams of
// elementwise traffic per step.
//
// Design: one cooperative launch, the forward's tiling (16x4 output pixels by 16 channels of one
// batch item, persistent blocks, carries in global memory where L2 holds them) and one grid
// barrier per step. dh_carry at a pixel needs dz_t over its 3x3 neighbourhood, so dz_t must be
// complete everywhere before any tile convolves it. A prologue runs the gate backward of step
// T-1 and writes dz_{T-1}; then, per step t, each tile convolves dz_t into dh_carry for its own
// pixels and channels and, in the same threads, runs the gate backward of step t-1 for exactly
// those pixels and channels, so dh_carry never leaves registers (only dh0 is stored). The
// contraction runs over the four gates one at a time: the tile's haloed 18x6 patch of gate g of
// dz_t and the nine taps' [enc x 16] weight slices of that gate are staged in shared memory, then
// all nine taps read them. bf16 contracts on the tensor cores through WMMA 16x16x16 fragments
// (f32 accumulation; the eight warps split the four tile rows and the two halves of K); f32
// contracts with FMAs, so that it can be held tightly against the plain version.
#include <cooperative_groups.h>
#include <mma.h>

#include "convlstm_common.cuh"

namespace cg = cooperative_groups;
using namespace convlstm;

namespace {

constexpr int LDC = JC + 4;  // row stride of the f32 accumulator tiles

struct BwdParams {
  const void* z;       // [T, b, sh, sw, 4enc] gate pre-activations
  const void* c_prev;  // [T, b, sh, sw, enc] pre-update cells
  const void* dh_seq;  // [T, b, sh, sw, enc] gradient of h_seq
  float* dc;           // [b, sh, sw, enc] f32: dc_last on entry, dc0 on exit
  const void* w;       // [3, 3, enc, 4enc]
  const void* wci;     // [sh, sw, enc]
  const void* wcf;
  const void* wco;
  void* dz;            // [T, b, sh, sw, 4enc] out: gradient of z
  float* dh0;          // [b, sh, sw, enc] out
  int T, b, sh, sw, enc;
  int tiles_x, tiles_y, tiles_j, n_tiles;
};

template <typename T>
__host__ __device__ size_t smem_a_bytes(int enc) {
  return align128(size_t(HALO_P) * (enc + Traits<T>::PAD) * sizeof(T));
}
template <typename T>
__host__ __device__ size_t smem_b_bytes(int enc) {
  return align128(size_t(9) * JC * (enc + Traits<T>::PAD) * sizeof(T));
}
template <typename T>
size_t smem_bytes(int enc) {
  return smem_a_bytes<T>(enc) + smem_b_bytes<T>(enc) + align128(size_t(2) * TILE_P * LDC * sizeof(float));
}

// Stages gate g's weights of the tile's output channels for all nine taps:
// sB[tap][kk][n] = W[tap][j0 + kk][g*enc + n].
template <typename T>
__device__ __forceinline__ void load_b_gate(T* sB, const T* w, int g, int j0, int enc, int ldb) {
  constexpr int V = Traits<T>::VEC;
  const int vpr = enc / V;
  for (int idx = threadIdx.x; idx < 9 * JC * vpr; idx += THREADS) {
    const int v = idx % vpr;
    const int row = idx / vpr;  // tap * JC + kk
    const int kk = row % JC, tap = row / JC;
    const T* src = w + (size_t(tap) * enc + j0 + kk) * 4 * enc + g * enc + v * V;
    *reinterpret_cast<uint4*>(sB + row * ldb + v * V) = *reinterpret_cast<const uint4*>(src);
  }
}

// f32: FMA contraction of one gate. Thread (r, cc) accumulates output pixels (m, r), channel cc.
__device__ __forceinline__ void gate_gemm(const float* sA, const float* sB, int enc, int lda, int ldb,
                                          int r, int cc, float (&acc)[TILE_H]) {
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
    const float* a0 = sA + ((2 - dy) * HALO_W + r + 2 - dx) * lda;
    const float* b0 = sB + (tap * JC + cc) * ldb;
    for (int n = 0; n < enc; ++n) {
      const float bb = b0[n];
#pragma unroll
      for (int m = 0; m < TILE_H; ++m) acc[m] = fmaf(a0[m * HALO_W * lda + n], bb, acc[m]);
    }
  }
}

// bf16: tensor-core contraction of one gate into the warp's fragment. Warp w owns tile row w%4
// and the 16-channel K chunks kh, kh+2, kh+4, ... of the gate, kh = w/4.
__device__ __forceinline__ void gate_gemm(
    const __nv_bfloat16* sA, const __nv_bfloat16* sB, int enc, int lda, int ldb,
    nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>& acc) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32;
  const int mi = warp & 3, kh = warp >> 2;
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
    const __nv_bfloat16* a_base = sA + ((mi + 2 - dy) * HALO_W + 2 - dx) * lda;
    const __nv_bfloat16* b_base = sB + tap * JC * ldb;
    for (int k0 = kh * 16; k0 < enc; k0 += 32) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf;
      wmma::load_matrix_sync(a, a_base + k0, lda);
      wmma::load_matrix_sync(bf, b_base + k0, ldb);  // element (n, kk) at b_base[kk*ldb + n]
      wmma::mma_sync(acc, a, bf, acc);
    }
  }
}

// dh_carry for the tile's 64 pixels x 16 channels: the transposed conv of dz_t of item bi.
// Returns thread (r, cc)'s pixels (m, r), m < TILE_H, of channel j0 + cc in acc.
__device__ __forceinline__ void transposed_conv(const float* dz_b, const float* w, const TileIndex& ti,
                                                const BwdParams& p, float* sA, float* sB, float* /*sC*/,
                                                int r, int cc, float (&acc)[TILE_H]) {
  const int enc = p.enc, lda = enc + Traits<float>::PAD, ldb = lda;
#pragma unroll
  for (int m = 0; m < TILE_H; ++m) acc[m] = 0.0f;
  for (int g = 0; g < 4; ++g) {
    __syncthreads();  // the previous gate (or tile) is done with shared memory
    load_patch(sA, lda, dz_b, 4 * enc, g * enc, enc, ti.y0, ti.x0, p.sh, p.sw);
    load_b_gate(sB, w, g, ti.j0, enc, ldb);
    __syncthreads();
    gate_gemm(sA, sB, enc, lda, ldb, r, cc, acc);
  }
}

__device__ __forceinline__ void transposed_conv(const __nv_bfloat16* dz_b, const __nv_bfloat16* w,
                                                const TileIndex& ti, const BwdParams& p,
                                                __nv_bfloat16* sA, __nv_bfloat16* sB, float* sC,
                                                int r, int cc, float (&acc)[TILE_H]) {
  using namespace nvcuda;
  const int enc = p.enc, lda = enc + Traits<__nv_bfloat16>::PAD, ldb = lda;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> frag;
  wmma::fill_fragment(frag, 0.0f);
  for (int g = 0; g < 4; ++g) {
    __syncthreads();
    load_patch(sA, lda, dz_b, 4 * enc, g * enc, enc, ti.y0, ti.x0, p.sh, p.sw);
    load_b_gate(sB, w, g, ti.j0, enc, ldb);
    __syncthreads();
    gate_gemm(sA, sB, enc, lda, ldb, frag);
  }
  const int warp = threadIdx.x / 32;
  const int mi = warp & 3, kh = warp >> 2;
  wmma::store_matrix_sync(sC + (kh * TILE_P + mi * TILE_W) * LDC, frag, LDC, wmma::mem_row_major);
  __syncthreads();
#pragma unroll
  for (int m = 0; m < TILE_H; ++m) {
    const int row = m * TILE_W + r;
    acc[m] = sC[row * LDC + cc] + sC[(TILE_P + row) * LDC + cc];
  }
}

// Gate backward of step t at one pixel and channel j, given the gradient dh_in that reaches h_t
// through step t+1; writes dz_t there and updates dc in place.
template <typename T>
__device__ __forceinline__ void gate_backward(const BwdParams& p, int t, size_t pix, size_t pk, int j,
                                              float dh_in) {
  const int enc = p.enc;
  const size_t step_px = size_t(p.b) * p.sh * p.sw;
  const size_t zi = (size_t(t) * step_px + pix) * 4 * enc + j;
  const size_t si = (size_t(t) * step_px + pix) * enc + j;
  const size_t pi = pk * enc + j;
  const size_t di = pix * enc + j;
  const T* z = static_cast<const T*>(p.z);
  const float zi_ = to_f(z[zi]), zf = to_f(z[zi + enc]), zc = to_f(z[zi + 2 * enc]),
              zo = to_f(z[zi + 3 * enc]);
  const float c = to_f(static_cast<const T*>(p.c_prev)[si]);
  const float wci = to_f(static_cast<const T*>(p.wci)[pi]);
  const float wcf = to_f(static_cast<const T*>(p.wcf)[pi]);
  const float wco = to_f(static_cast<const T*>(p.wco)[pi]);
  const float ig = sigmoid_f(zi_ + wci * c);
  const float fg = sigmoid_f(zf + wcf * c);
  const float g = tanhf(zc);
  const float c_new = fg * c + ig * g;
  const float og = sigmoid_f(zo + wco * c_new);
  const float t2 = tanhf(c_new);
  const float dh = dh_in + to_f(static_cast<const T*>(p.dh_seq)[si]);
  const float dzo = dh * t2 * og * (1.0f - og);
  const float dc2 = p.dc[di] + dh * og * (1.0f - t2 * t2) + dzo * wco;
  const float dzi = dc2 * g * ig * (1.0f - ig);
  const float dzf = dc2 * c * fg * (1.0f - fg);
  const float dgc = dc2 * ig * (1.0f - g * g);
  T* dz = static_cast<T*>(p.dz);
  dz[zi] = from_f<T>(dzi);
  dz[zi + enc] = from_f<T>(dzf);
  dz[zi + 2 * enc] = from_f<T>(dgc);
  dz[zi + 3 * enc] = from_f<T>(dzo);
  p.dc[di] = dc2 * fg + dzi * wci + dzf * wcf;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) convlstm_scan_bwd_kernel(BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int enc = p.enc;
  T* sA = reinterpret_cast<T*>(smem);
  T* sB = reinterpret_cast<T*>(smem + smem_a_bytes<T>(enc));
  float* sC = reinterpret_cast<float*>(smem + smem_a_bytes<T>(enc) + smem_b_bytes<T>(enc));
  const int r = threadIdx.x / JC;
  const int cc = threadIdx.x % JC;
  const size_t item = size_t(p.sh) * p.sw * 4 * enc;  // dz elements per batch item and step
  cg::grid_group grid = cg::this_grid();

  // prologue: the gate backward of the last step, which no later step feeds
  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    const TileIndex ti = tile_index(tile, p.tiles_x, p.tiles_y, p.tiles_j);
#pragma unroll
    for (int m = 0; m < TILE_H; ++m) {
      const int gy = ti.y0 + m, gx = ti.x0 + r;
      if (gy >= p.sh || gx >= p.sw) continue;
      const size_t pk = size_t(gy) * p.sw + gx;
      gate_backward<T>(p, p.T - 1, size_t(ti.bi) * p.sh * p.sw + pk, pk, ti.j0 + cc, 0.0f);
    }
  }
  grid.sync();  // dz_{T-1} is complete before any tile convolves it

  for (int t = p.T - 1; t >= 0; --t) {
    const T* dz_t = static_cast<const T*>(p.dz) + size_t(t) * p.b * item;
    for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
      const TileIndex ti = tile_index(tile, p.tiles_x, p.tiles_y, p.tiles_j);
      float acc[TILE_H];
      transposed_conv(dz_t + size_t(ti.bi) * item, static_cast<const T*>(p.w), ti, p, sA, sB, sC,
                      r, cc, acc);
#pragma unroll
      for (int m = 0; m < TILE_H; ++m) {
        const int gy = ti.y0 + m, gx = ti.x0 + r;
        if (gy >= p.sh || gx >= p.sw) continue;
        const size_t pk = size_t(gy) * p.sw + gx;
        const size_t pix = size_t(ti.bi) * p.sh * p.sw + pk;
        if (t > 0)
          gate_backward<T>(p, t - 1, pix, pk, ti.j0 + cc, acc[m]);
        else
          p.dh0[pix * enc + ti.j0 + cc] = acc[m];
      }
    }
    if (t > 0) grid.sync();  // dz_{t-1} is complete before step t-1 convolves it
  }
}

template <typename T>
int blocks_per_sm(int enc) {
  const size_t smem = smem_bytes<T>(enc);
  cudaError_t err = cudaFuncSetAttribute(convlstm_scan_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return -int(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, convlstm_scan_bwd_kernel<T>, THREADS,
                                                      smem);
  if (err != cudaSuccess) return -int(err);
  return per_sm;
}

template <typename T>
cudaError_t launch(BwdParams p, cudaStream_t stream) {
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
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(convlstm_scan_bwd_kernel<T>),
                                    dim3(grid), dim3(THREADS), args, smem_bytes<T>(p.enc), stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Runs the whole reverse-time walk on `stream`. Returns a cudaError_t (0 on success). All tensors
// are contiguous; z, c_prev, dh_seq, w, wci, wcf, wco and dz are bf16 when is_bf16 is set, else
// f32; dc (in place) and dh0 are f32.
int vp_convlstm_scan_bwd(int is_bf16, const void* z, const void* c_prev, const void* dh_seq, float* dc,
                         const void* w, const void* wci, const void* wcf, const void* wco, void* dz,
                         float* dh0, int T, int b, int sh, int sw, int enc, void* stream) {
  if (T < 1 || b < 1 || sh < 1 || sw < 1 || enc < JC || enc % JC != 0) return cudaErrorInvalidValue;
  BwdParams p{z, c_prev, dh_seq, dc, w, wci, wcf, wco, dz, dh0, T, b, sh, sw, enc, 0, 0, 0, 0};
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
