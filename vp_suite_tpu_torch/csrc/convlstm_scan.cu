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
// rounded to the activation type; h_seq and c_last are the same bit for bit either way.
//
// Bound: per step and batch item the hidden conv is 2*sh*sw*9enc*4enc operations; a step reads
// i2h (8 bytes per pixel and hidden channel in bf16) and writes h (2), and K3s also writes z (8)
// and c_prev (2). At b=32 and 64x64x64 one step is 38.7 GFLOP, 39 us of bf16 tensor time,
// against 84 MB (25 us of HBM time) for K3 and 168 MB (50 us) for K3s: operations bound K3 and
// bytes bound K3s there (chip_smoke.py's scan_cost). The f32 cell carry (33.5 MB at 64x64, read
// and written each step) stays largely in L2 and is counted once.
//
// Both instantiations share the structure: one cooperative launch covers all T steps, and the
// grid synchronises once per step, before the next step reads the h that this one wrote. One
// item's carry does not fit a block's shared memory at 64x64 or 32x32, so the carry stays in
// global memory, where the 50 MB L2 holds it: step t reads h_{t-1} from h_seq[t-1] (or h0) and
// writes h_seq[t], so the output doubles as the h double buffer, and the f32 cell state is
// updated in place in the caller's c buffer (each element is read and written by one thread,
// the same one at every step).
//
// bf16 (the serving and training path) is built from the Hopper pieces of convlstm_common.cuh,
// as K4's bf16 kernel (convlstm_scan_bwd.cu) is:
//   - Resident weights. Each persistent block owns one block of NC hidden channels for the whole
//     launch and stages its B once: all nine taps, the enc input channels and the four gates of
//     its channels, N = 4*NC columns ordered gate-major (n = g*NC + jj), in wgmma's unswizzled
//     K-major layout by a transposing load (W keeps N contiguous; load_weights_gates). Shared
//     memory holds 72*enc*NC bytes of weights, a ring of STAGES = 4 stages of 14,464 bytes and
//     the 16*NC bytes of the block's bias, within the 232,448 bytes a block may use. NC is the
//     largest of 32, 24, 16, 8 that divides enc and fits: enc=64 takes 32 (147,456 + 57,856 +
//     512 bytes), enc=96 takes 24 (165,888 + 57,856 + 384; 32 would need 221,184 of weights),
//     enc=48 24, enc=32 32, enc=16 16; above enc=288 not even NC=8 fits. h_{t-1} is read enc/NC
//     times per step (twice at enc=64, four times at 96).
//   - An asynchronous ring of h stages. A work item is a 16x8 pixel tile (one 64-pixel wgmma M
//     block per warpgroup; its 18x10 haloed patch reads 1.41 pixels per pixel, against 1.69 for
//     a 16x4 tile) of one batch item. Its enc channels of h_{t-1} stream through the ring in
//     stages of 32 channels ([180 haloed pixels][40], rows padded to 80 bytes), filled by
//     cp.async.cg (through L2 only: other SMs wrote h_{t-1} before the grid barrier) with zeros
//     outside the image; where enc is an odd multiple of 16 the last stage holds 16 channels and
//     zeros, and its second k16 step is skipped. The block walks its tiles' stages as one
//     sequence, so the next tile's first stages are in flight during a tile's last products and
//     its epilogue.
//   - wgmma. M = pixels, N = 4*NC, K = (tap, h channel): A (16 pixels x 16 channels per warp)
//     comes from the stage by ldmatrix at the tap's offset (unflipped, unlike the backward's
//     transposed conv), B is the resident slice through a descriptor. Eighteen m64nNk16
//     products per stage and warpgroup.
//   - A register-local epilogue. Gate-major N puts all four gates of a pixel and channel in one
//     lane's accumulators, so the f32 accumulators stay in registers into the cell update: no
//     shared memory and no barrier between them. A lane owns two pixels and NC/8 pairs of
//     adjacent channels (bf16x2 and float2 accesses), and loads all their operands before it
//     computes. When a tile starts, each warp asks L2 (cp.async.bulk.prefetch) for the rows of
//     i2h and c that its epilogue will read (kernels/k3_variants.py's no_l2_prefetch times the
//     kernel without it).
// f32 contracts with FMAs on 16x4-pixel by 16-channel tiles, restaging one tap's weights at a
// time, so that it can be held tightly against the plain version.
#include <cooperative_groups.h>

#include "convlstm_common.cuh"

namespace cg = cooperative_groups;
using namespace convlstm;

namespace {

using bf16 = __nv_bfloat16;

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
  int tiles_x, tiles_y, tiles_j, n_tiles;  // f32: 16x4x16 tiles; bf16: 16x8 pixel tiles
};

// One cell update in f32 from the gate pre-activations, the pre-update cell and the peepholes;
// returns (c', h) with h not yet rounded.
__device__ __forceinline__ float2 cell(float zi, float zf, float zc, float zo, float c, float wci,
                                       float wcf, float wco) {
  const float ig = sigmoid_f(zi + wci * c);
  const float fg = sigmoid_f(zf + wcf * c);
  const float c_new = fg * c + ig * tanhf(zc);
  const float og = sigmoid_f(zo + wco * c_new);
  return make_float2(c_new, og * tanhf(c_new));
}

// ---- f32: FMA contraction on 16x4-pixel by 16-channel tiles ------------------------------------

constexpr int TN = 4 * JC;  // GEMM columns per tile: gates i, f, c, o of JC channels

__host__ __device__ size_t f32_smem_a_bytes(int enc) {
  return align128(size_t(HALO_P) * (enc + Traits<float>::PAD) * 4);
}
size_t f32_smem_bytes(int enc) {
  return f32_smem_a_bytes(enc) + align128(size_t(enc) * (TN + Traits<float>::PAD) * 4);
}

// Stages tap `tap`'s weights for the tile's channels: sB[k][g*JC + jj] = W[tap][k][g*enc + j0 + jj].
__device__ __forceinline__ void load_b_tap(float* sB, const float* w, int tap, int j0, int enc, int ldb) {
  constexpr int V = Traits<float>::VEC;
  constexpr int VPG = JC / V;
  const int total = enc * 4 * VPG;
  for (int idx = threadIdx.x; idx < total; idx += THREADS) {
    const int v = idx % VPG;
    const int g = (idx / VPG) % 4;
    const int k = idx / (VPG * 4);
    const float* src = w + (size_t(tap) * enc + k) * 4 * enc + g * enc + j0 + v * V;
    *reinterpret_cast<uint4*>(sB + k * ldb + g * JC + v * V) = *reinterpret_cast<const uint4*>(src);
  }
}

// Thread (r, cc) accumulates pixels (m, r) for m < TILE_H and column q*JC + cc (gate q of channel
// cc) straight into z.
__device__ __forceinline__ void tile_gemm_f32(const float* sA, float* sB, const float* w, int j0,
                                              int enc, int lda, int ldb, int r, int cc,
                                              float (&z)[TILE_H][4]) {
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

// Two resident blocks per SM: shared memory allows no more at enc=96.
__global__ void __launch_bounds__(THREADS, 2) scan_fwd_f32_kernel(ScanParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int enc = p.enc;
  const int lda = enc + Traits<float>::PAD;
  const int ldb = TN + Traits<float>::PAD;
  float* sA = reinterpret_cast<float*>(smem);
  float* sB = reinterpret_cast<float*>(smem + f32_smem_a_bytes(enc));
  const int r = threadIdx.x / JC;
  const int cc = threadIdx.x % JC;
  const size_t plane = size_t(p.sh) * p.sw * enc;
  const float* wci = static_cast<const float*>(p.wci);
  const float* wcf = static_cast<const float*>(p.wcf);
  const float* wco = static_cast<const float*>(p.wco);
  cg::grid_group grid = cg::this_grid();

  for (int t = 0; t < p.T; ++t) {
    const float* h_prev = t == 0 ? static_cast<const float*>(p.h0)
                                 : static_cast<const float*>(p.h_seq) + size_t(t - 1) * p.b * plane;
    float* h_out = static_cast<float*>(p.h_seq) + size_t(t) * p.b * plane;
    const float* x_t = p.i2h ? static_cast<const float*>(p.i2h) + size_t(t) * p.b * plane * 4 : nullptr;
    float* z_out = p.z_seq ? static_cast<float*>(p.z_seq) + size_t(t) * p.b * plane * 4 : nullptr;
    float* cp_out = p.z_seq ? static_cast<float*>(p.c_prev_seq) + size_t(t) * p.b * plane : nullptr;
    for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
      const TileIndex ti = tile_index(tile, p.tiles_x, p.tiles_y, p.tiles_j);
      __syncthreads();  // the previous tile is done with shared memory
      load_patch(sA, lda, h_prev + size_t(ti.bi) * plane, enc, 0, enc, ti.y0, ti.x0, p.sh, p.sw);

      float z[TILE_H][4];
#pragma unroll
      for (int m = 0; m < TILE_H; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q) z[m][q] = 0.0f;
      tile_gemm_f32(sA, sB, static_cast<const float*>(p.w), ti.j0, enc, lda, ldb, r, cc, z);

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
          if (x_t) zg[q] += x_t[pix * 4 * enc + q * enc + j];
        }
        const size_t ci = pix * enc + j;
        const size_t pi = pk * enc + j;
        const float c_prev = p.c[ci];
        if (z_out) {
#pragma unroll
          for (int q = 0; q < 4; ++q) z_out[pix * 4 * enc + q * enc + j] = zg[q];
          cp_out[ci] = c_prev;
        }
        const float2 ch = cell(zg[0], zg[1], zg[2], zg[3], c_prev, wci[pi], wcf[pi], wco[pi]);
        p.c[ci] = ch.x;
        h_out[ci] = ch.y;
      }
    }
    grid.sync();  // h_seq[t] is complete before step t + 1 reads it
  }
}

// ---- bf16: resident weights, h stages by cp.async, wgmma ---------------------------------------

constexpr int BF_THREADS = 256;  // two warpgroups: warp w owns tile row w (16 pixels)
constexpr int STAGES = 4;        // ring depth

__host__ __device__ constexpr size_t bf16_weight_bytes(int enc, int nc) { return size_t(72) * enc * nc; }
constexpr size_t bf16_smem_bytes(int enc, int nc) {
  return bf16_weight_bytes(enc, nc) + STAGES * STAGE_BYTES + align128(size_t(16) * nc);
}

// Stages the block's B: for hidden channels j0 .. j0+nc-1, element (k, n) with k = (tap, input
// channel c) and n = g*nc + jj is W[tap][c][g*enc + j0 + jj]. In wgmma's K-major layout the 8x8
// core matrix (tap, input channels 8kq .. 8kq+7, columns 8ng .. 8ng+7) is 128 contiguous bytes,
// one 16-byte row per column, at ((tap * KQ + kq) * NGT + ng) * 128, KQ = enc/8, NGT = nc/2:
// K-adjacent core matrices are NGT*128 bytes apart (the descriptor's leading byte offset),
// N-adjacent ones 128 (its stride byte offset), as in load_weights_async. W keeps N contiguous,
// so each thread reads a core matrix's 8x8 block as eight 16-byte rows of W (one per input
// channel), transposes it in registers and stores eight 16-byte rows (one per column). `w` is
// [3, 3, enc, 4enc]. Generic-proxy stores: fence.proxy.async before wgmma reads them.
__device__ __forceinline__ void load_weights_gates(bf16* sW, const bf16* w, int enc, int j0, int nc) {
  const int kq_n = enc / 8, ngt = nc / 2, ng_gate = nc / 8;
  for (int idx = threadIdx.x; idx < 9 * kq_n * ngt; idx += blockDim.x) {
    const int ng = idx % ngt;
    const int kq = (idx / ngt) % kq_n;
    const int tap = idx / (ngt * kq_n);
    const int col = (ng / ng_gate) * enc + j0 + (ng % ng_gate) * 8;
    const bf16* src = w + (size_t(tap) * enc + kq * 8) * 4 * enc + col;
    uint32_t r[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint4 v = *reinterpret_cast<const uint4*>(src + size_t(i) * 4 * enc);
      r[i][0] = v.x, r[i][1] = v.y, r[i][2] = v.z, r[i][3] = v.w;
    }
    uint4* dst = reinterpret_cast<uint4*>(sW + ((tap * kq_n + kq) * ngt + ng) * 64);
#pragma unroll
    for (int n = 0; n < 8; ++n) {  // row n: column n of the eight input channels
      const uint32_t sel = n % 2 ? 0x7632 : 0x5410;
      dst[n] = make_uint4(__byte_perm(r[0][n / 2], r[1][n / 2], sel),
                          __byte_perm(r[2][n / 2], r[3][n / 2], sel),
                          __byte_perm(r[4][n / 2], r[5][n / 2], sel),
                          __byte_perm(r[6][n / 2], r[7][n / 2], sel));
    }
  }
}

// The products of one stage: NK k16 steps (2, or 1 for a half stage) of all nine taps, on the
// block's weights at input channels 8*kq0 and on; acc += A * B over the warpgroup.
template <int NC, int NK>
__device__ __forceinline__ void stage_products(float (&acc)[2 * NC], const bf16* stage,
                                               const bf16* sW, int row, int lane, int kq0,
                                               int kq_n) {
  constexpr int NGT = NC / 2;
  uint32_t a[NK][9][4];
#pragma unroll
  for (int k = 0; k < NK; ++k)
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) load_a_at(a[k][tap], stage, row, tap / 3, tap % 3, 16 * k, lane);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < NK; ++k)
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
      Wgmma<4 * NC>::mma(acc, a[k][tap],
                         wgmma_desc(sW + (tap * kq_n + kq0 + 2 * k) * NGT * 64, NGT * 128, 128));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// What the cell update of one pixel and channel pair (j, j+1) reads besides its accumulators.
struct PairIn {
  uint32_t x[4];         // bf16 pairs: i2h of the four gates (unread in decode mode)
  uint32_t wci, wcf, wco;  // the peepholes
  float2 c;                // the pre-update cell
};

// A lane's share of a tile, in the wgmma accumulator layout: tile row `row` (its warp), pixels
// x0 + l/4 + 8h, h < 2, and columns 8j + 2(l%4) + e, e < 2, in acc[4j + 2h + e]; with gate-major
// columns, j = g*NC/8 + jl holds gate g of channel j0 + 8jl + 2(l%4) + e, so the lane owns all
// four gates of NC/8 channel pairs at each of its two pixels. row_pix is the row's first pixel
// and row_n its pixels inside the image.
template <int NC>
struct LaneTile {
  static constexpr int NG = NC / 8;
  size_t pix[2];
  bool valid[2];
  size_t row_pix;
  int row_n;

  __device__ __forceinline__ void locate(const ScanParams& p, const TileIndex& ti, int row, int lane) {
    const int gy = ti.y0 + row;
    row_pix = (size_t(ti.bi) * p.sh + gy) * p.sw + ti.x0;
    row_n = gy < p.sh ? min(PT_W, p.sw - ti.x0) : 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gx = ti.x0 + (lane >> 2) + 8 * h;
      valid[h] = gy < p.sh && gx < p.sw;
      pix[h] = (size_t(ti.bi) * p.sh + gy) * p.sw + gx;
    }
  }
  // Lanes 0 and 1 ask L2 for the warp's tile row of i2h (step t) and of c: each is one contiguous
  // range of the row's row_n pixels.
  __device__ __forceinline__ void prefetch(const ScanParams& p, int t, int lane) const {
    if (row_n <= 0 || lane >= 2 || (lane == 0 && !p.i2h)) return;
    const void* src = lane == 0
        ? static_cast<const void*>(static_cast<const bf16*>(p.i2h) +
                                   (size_t(t) * p.b * p.sh * p.sw + row_pix) * 4 * p.enc)
        : static_cast<const void*>(p.c + row_pix * p.enc);
    const int bytes = row_n * p.enc * (lane == 0 ? 8 : 4);
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src), "r"(bytes) : "memory");
  }
  // The cell update of step t at the lane's pixels and channel pairs: all operands are loaded
  // first, then each pair is computed and stored (bf16x2 and float2 accesses).
  __device__ __forceinline__ void finish(const ScanParams& p, int t, int j0, int lane,
                                         const float (&acc)[2 * NC], const float* sBias) const {
    const int enc = p.enc;
    const size_t step_px = size_t(t) * p.b * p.sh * p.sw;
    PairIn in[2][NG];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!valid[h]) continue;
      const size_t pk = pix[h] % (size_t(p.sh) * p.sw);
#pragma unroll
      for (int jl = 0; jl < NG; ++jl) {
        const int j = j0 + 8 * jl + 2 * (lane & 3);
        PairIn& v = in[h][jl];
        if (p.i2h) {
#pragma unroll
          for (int g = 0; g < 4; ++g)
            v.x[g] = ld_u32(p.i2h, (step_px + pix[h]) * 4 * enc + g * enc + j);
        }
        v.c = *reinterpret_cast<const float2*>(p.c + pix[h] * enc + j);
        v.wci = ld_u32(p.wci, pk * enc + j);
        v.wcf = ld_u32(p.wcf, pk * enc + j);
        v.wco = ld_u32(p.wco, pk * enc + j);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!valid[h]) continue;
      const size_t sp = step_px + pix[h];
#pragma unroll
      for (int jl = 0; jl < NG; ++jl) {
        const int jj = 8 * jl + 2 * (lane & 3), j = j0 + jj;
        const PairIn& v = in[h][jl];
        float2 z[4];  // z = conv + bias (+ i2h), in that order
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float2 bb = *reinterpret_cast<const float2*>(sBias + g * NC + jj);
          const int ai = 4 * (g * NG + jl) + 2 * h;
          z[g] = make_float2(acc[ai] + bb.x, acc[ai + 1] + bb.y);
          if (p.i2h) {
            const float2 x = bf2(v.x[g]);
            z[g].x += x.x;
            z[g].y += x.y;
          }
        }
        if (p.z_seq) {
          __nv_bfloat162* zo =
              reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.z_seq) + sp * 4 * enc + j);
#pragma unroll
          for (int g = 0; g < 4; ++g) zo[g * enc / 2] = __floats2bfloat162_rn(z[g].x, z[g].y);
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.c_prev_seq) + sp * enc + j) =
              __floats2bfloat162_rn(v.c.x, v.c.y);
        }
        const float2 wci = bf2(v.wci), wcf = bf2(v.wcf), wco = bf2(v.wco);
        const float2 a = cell(z[0].x, z[1].x, z[2].x, z[3].x, v.c.x, wci.x, wcf.x, wco.x);
        const float2 b = cell(z[0].y, z[1].y, z[2].y, z[3].y, v.c.y, wci.y, wcf.y, wco.y);
        *reinterpret_cast<float2*>(p.c + pix[h] * enc + j) = make_float2(a.x, b.x);
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.h_seq) + sp * enc + j) =
            __floats2bfloat162_rn(a.y, b.y);
      }
    }
  }
};

template <int NC>
__global__ void __launch_bounds__(BF_THREADS, 1) scan_fwd_bf16_kernel(ScanParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int enc = p.enc;
  bf16* sW = reinterpret_cast<bf16*>(smem);
  bf16* ring = reinterpret_cast<bf16*>(smem + bf16_weight_bytes(enc, NC));
  float* sBias = reinterpret_cast<float*>(smem + bf16_weight_bytes(enc, NC) + STAGES * STAGE_BYTES);
  const int lane = threadIdx.x & 31, row = threadIdx.x >> 5;
  // block -> (hidden-channel block, rank among the blocks of that channel block)
  const int j0 = (blockIdx.x % p.tiles_j) * NC;
  const int q = blockIdx.x / p.tiles_j, nq = gridDim.x / p.tiles_j;
  const int n_my = q < p.n_tiles ? (p.n_tiles - q + nq - 1) / nq : 0;
  const int spt = (enc + STAGE_CH - 1) / STAGE_CH;  // stages per tile and step
  const int kq_n = enc / 8;
  const size_t plane = size_t(p.b) * p.sh * p.sw * enc;  // elements of h per step
  cg::grid_group grid = cg::this_grid();
  LaneTile<NC> lt;
  float acc[2 * NC];

  load_weights_gates(sW, static_cast<const bf16*>(p.w), enc, j0, NC);
  for (int i = threadIdx.x; i < 4 * NC; i += blockDim.x)  // gate-major, as the columns
    sBias[i] = p.bias[(i / NC) * enc + j0 + i % NC];
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // wgmma reads the weights
  __syncthreads();

  for (int t = 0; t < p.T; ++t) {
    const bf16* h_prev = t == 0 ? static_cast<const bf16*>(p.h0)
                                : static_cast<const bf16*>(p.h_seq) + size_t(t - 1) * plane;
    const int n_items = n_my * spt;  // (tile, stage) pairs of this block in this step
    auto fetch = [&](int idx) {
      const TileIndex ti = pixel_tile(q + (idx / spt) * nq, p);
      load_stage_async(ring + (idx % STAGES) * (STAGE_BYTES / sizeof(bf16)), h_prev, enc, idx % spt,
                       ti.bi, ti.y0, ti.x0, p.sh, p.sw);
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < n_items) fetch(s);
      cp_async_commit();
    }
    for (int it = 0; it < n_items; ++it) {
      const int chunk = it % spt;
      if (chunk == 0) {  // a new tile
        lt.locate(p, pixel_tile(q + (it / spt) * nq, p), row, lane);
        lt.prefetch(p, t, lane);  // the epilogue's rows start on their way
#pragma unroll
        for (int i = 0; i < 2 * NC; ++i) acc[i] = 0.0f;
      }
      cp_async_wait<STAGES - 2>();  // this thread's copies of stage `it` have landed
      __syncthreads();              // everyone's have, and stage it-1's slot is free again
      if (it + STAGES - 1 < n_items) fetch(it + STAGES - 1);
      cp_async_commit();
      const bf16* stage = ring + (it % STAGES) * (STAGE_BYTES / sizeof(bf16));
      if (chunk * STAGE_CH + 16 < enc)
        stage_products<NC, 2>(acc, stage, sW, row, lane, 4 * chunk, kq_n);
      else  // a half stage: enc is an odd multiple of 16
        stage_products<NC, 1>(acc, stage, sW, row, lane, 4 * chunk, kq_n);
      if (chunk == spt - 1) lt.finish(p, t, j0, lane, acc, sBias);
    }
    cp_async_wait<0>();
    grid.sync();  // h_seq[t] is complete before step t + 1 reads it
  }
}

// ---- launch ------------------------------------------------------------------------------------

template <int NC>
cudaError_t launch_bf16(ScanParams p, cudaStream_t stream) {
  p.tiles_x = (p.sw + PT_W - 1) / PT_W;
  p.tiles_y = (p.sh + PT_H - 1) / PT_H;
  p.tiles_j = p.enc / NC;
  p.n_tiles = p.b * p.tiles_y * p.tiles_x;
  return launch_cooperative(scan_fwd_bf16_kernel<NC>, bf16_smem_bytes(p.enc, NC),
                            p.tiles_j * p.n_tiles, p.tiles_j, p, BF_THREADS, stream);
}

cudaError_t launch_bf16_any(ScanParams p, cudaStream_t stream) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  // the widest hidden-channel block whose resident weights leave room for the stages
  const int widths[] = {32, 24, 16, 8};
  for (int nc : widths) {
    if (p.enc % nc != 0 || bf16_smem_bytes(p.enc, nc) > size_t(max_smem)) continue;
    switch (nc) {
      case 32: return launch_bf16<32>(p, stream);
      case 24: return launch_bf16<24>(p, stream);
      case 16: return launch_bf16<16>(p, stream);
      default: return launch_bf16<8>(p, stream);
    }
  }
  return cudaErrorInvalidValue;  // enc too wide for one channel block's weights to stay resident
}

cudaError_t launch_f32(ScanParams p, cudaStream_t stream) {
  p.tiles_x = (p.sw + TILE_W - 1) / TILE_W;
  p.tiles_y = (p.sh + TILE_H - 1) / TILE_H;
  p.tiles_j = p.enc / JC;
  p.n_tiles = p.b * p.tiles_y * p.tiles_x * p.tiles_j;
  return launch_cooperative(scan_fwd_f32_kernel, f32_smem_bytes(p.enc), p.n_tiles, 1, p, THREADS,
                            stream);
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
  cudaError_t err = is_bf16 ? launch_bf16_any(p, static_cast<cudaStream_t>(stream))
                            : launch_f32(p, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) cudaGetLastError();  // clear it, so later launches do not report it
  return int(err);
}

const char* vp_cuda_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

}  // extern "C"
