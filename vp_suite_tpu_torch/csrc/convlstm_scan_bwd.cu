// Reverse-time backward of the whole-recurrence ConvLSTM scan (K4) for Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel ops/pallas_convlstm.py:_make_bwd_kernel, reached
// through _scan_fused_bwd. It consumes the residuals that the forward scan (convlstm_scan.cu)
// saves: the gate pre-activations z [T, b, sh, sw, 4enc] and the pre-update cells c_prev
// [T, b, sh, sw, enc], both in the activation type.
//
// Walking t from T-1 down to 0, with the carries dh (from step t+1's hidden conv; at T-1 the
// gradient of h_last, converted to f32) and dc in f32:
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
// Bound: per step the transposed conv is 2*b*sh*sw*9*4enc*enc operations (39 us of bf16 tensor
// time at b=32, 64x64x64), against 20 bytes of z, c_prev, dh_seq and dz traffic per pixel and
// channel (50 us of HBM time there): bytes bound the largest layer, operations the others.
//
// Both instantiations share the structure: one cooperative launch, persistent blocks, one grid
// barrier per step (dh_carry at a pixel needs dz_t over its 3x3 neighbourhood, so dz_t must be
// complete everywhere before any tile convolves it), the carries in global memory where L2
// holds them. A prologue runs the gate backward of step T-1; then, per step t, each tile
// convolves dz_t into dh_carry for its own pixels and channels and, in the same threads, runs the
// gate backward of step t-1 for exactly those pixels and channels, so dh_carry never leaves
// registers (only dh0 is stored).
//
// bf16 (the training path): what held the earlier design back was data movement into the SM,
// not the tensor cores. It restaged a tile's weight slice for every gate and tile (74-111 KB per
// tile and step: some 600 MB of L2 traffic per step at 64x64x64, against 67 MB of dz_t), loaded
// the haloed dz patch with blocking loads between two barriers, and ran 16x16x16 WMMA whose
// accumulators went through shared memory. Now:
//   - Resident weights. Each block owns one block of NC output channels for the whole launch and
//     stages its slice of W once, all nine taps and four gates (72*enc*NC bytes), in wgmma's
//     unswizzled K-major layout (convlstm_common.cuh:load_weights_async). NC is the largest of
//     32, 24, 16, 8 that divides enc and leaves room for the ring in the 227 KB a block may use:
//     enc=64 takes 32 (147 KB of weights), enc=96 takes 24 (166 KB; 32 would need 221 KB), enc=16
//     and 32 take 16 and 32. The dz patch is read enc/NC times per step (2 at enc=64, 4 at 96).
//   - An asynchronous dz ring. A work item is a 16x8 pixel tile (one 64-pixel wgmma M block per
//     warpgroup; its 18x10 haloed patch re-reads 1.41 pixels per pixel, against 1.69 for the
//     earlier 16x4) of one batch item. Its 4enc dz channels stream through a ring of STAGES
//     stages of 32 channels each (14.1 KB), filled by cp.async with zero-fill outside the image;
//     the block walks its tiles' stages as one sequence, so the next tile's first stages are in
//     flight during a tile's last products and its epilogue.
//   - wgmma. Orientation M = pixels, N = output channels, K = (tap, dz channel): the tap shift
//     is a per-row address, so A (16 pixels x 16 channels per warp) comes from the stage by
//     ldmatrix with the flipped tap's offset, and B is the resident slice through a descriptor.
//     The transposed orientation (M = channels) would need M = enc in blocks of 64, which 96
//     does not fill. Eighteen m64nNCk16 products per stage and warpgroup; the f32 accumulators
//     stay in registers into the fused gate-backward epilogue, whose lanes own two pixels and
//     pairs of adjacent channels (bf16x2 and float2 accesses).
//   - When a tile starts, each warp asks L2 (cp.async.bulk.prefetch) for the rows of z, c_prev,
//     dh_seq and dc that its epilogue will read, so that the epilogue's loads hit L2
//     (kernels/k4_variants.py's no_l2_prefetch times the kernel without it).
// f32 contracts with FMAs on the earlier 16x4 by 16-channel tiles, restaging per gate, so that
// it can be held tightly against the plain version.
#include <cooperative_groups.h>

#include "convlstm_common.cuh"

namespace cg = cooperative_groups;
using namespace convlstm;

namespace {

using bf16 = __nv_bfloat16;

struct BwdParams {
  const void* z;       // [T, b, sh, sw, 4enc] gate pre-activations
  const void* c_prev;  // [T, b, sh, sw, enc] pre-update cells
  const void* dh_seq;  // [T, b, sh, sw, enc] gradient of h_seq
  const void* dh_last; // [b, sh, sw, enc] gradient of h_last, or nullptr (zeros)
  float* dc;           // [b, sh, sw, enc] f32: dc_last on entry, dc0 on exit
  const void* w;       // [3, 3, enc, 4enc]
  const void* wci;     // [sh, sw, enc]
  const void* wcf;
  const void* wco;
  void* dz;            // [T, b, sh, sw, 4enc] out: gradient of z
  float* dh0;          // [b, sh, sw, enc] out
  int T, b, sh, sw, enc;
  int tiles_x, tiles_y, tiles_j, n_tiles;  // f32: 16x4x16 tiles; bf16: 16x8 pixel tiles
};

struct GateGrad {
  float dzi, dzf, dzc, dzo, dc;
};

// The gate backward at one pixel and channel, in f32: gate pre-activations, pre-update cell,
// peepholes, the gradient dh reaching h_t and the incoming dc carry; returns dz and the dc carry.
__device__ __forceinline__ GateGrad gate_grad(float zi, float zf, float zc, float zo, float c,
                                              float wci, float wcf, float wco, float dh, float dc) {
  const float ig = sigmoid_f(zi + wci * c);
  const float fg = sigmoid_f(zf + wcf * c);
  const float g = tanhf(zc);
  const float c_new = fg * c + ig * g;
  const float og = sigmoid_f(zo + wco * c_new);
  const float t2 = tanhf(c_new);
  const float dzo = dh * t2 * og * (1.0f - og);
  const float dc2 = dc + dh * og * (1.0f - t2 * t2) + dzo * wco;
  const float dzi = dc2 * g * ig * (1.0f - ig);
  const float dzf = dc2 * c * fg * (1.0f - fg);
  const float dgc = dc2 * ig * (1.0f - g * g);
  return GateGrad{dzi, dzf, dgc, dzo, dc2 * fg + dzi * wci + dzf * wcf};
}

// ---- f32: FMA contraction on 16x4-pixel by 16-channel tiles ------------------------------------

__host__ __device__ size_t f32_smem_a_bytes(int enc) {
  return align128(size_t(HALO_P) * (enc + Traits<float>::PAD) * 4);
}
size_t f32_smem_bytes(int enc) {
  return f32_smem_a_bytes(enc) + align128(size_t(9) * JC * (enc + Traits<float>::PAD) * 4);
}

// Stages gate g's weights of the tile's output channels for all nine taps:
// sB[tap][kk][n] = W[tap][j0 + kk][g*enc + n].
__device__ __forceinline__ void load_b_gate(float* sB, const float* w, int g, int j0, int enc, int ldb) {
  constexpr int V = Traits<float>::VEC;
  const int vpr = enc / V;
  for (int idx = threadIdx.x; idx < 9 * JC * vpr; idx += THREADS) {
    const int v = idx % vpr;
    const int row = idx / vpr;  // tap * JC + kk
    const int kk = row % JC, tap = row / JC;
    const float* src = w + (size_t(tap) * enc + j0 + kk) * 4 * enc + g * enc + v * V;
    *reinterpret_cast<uint4*>(sB + row * ldb + v * V) = *reinterpret_cast<const uint4*>(src);
  }
}

// dh_carry for the tile's 64 pixels x 16 channels: the transposed conv of dz_t of item bi, one
// gate at a time. Thread (r, cc) accumulates output pixels (m, r), m < TILE_H, of channel j0 + cc.
__device__ __forceinline__ void transposed_conv_f32(const float* dz_b, const float* w,
                                                    const TileIndex& ti, const BwdParams& p,
                                                    float* sA, float* sB, int r, int cc,
                                                    float (&acc)[TILE_H]) {
  const int enc = p.enc, lda = enc + Traits<float>::PAD, ldb = lda;
#pragma unroll
  for (int m = 0; m < TILE_H; ++m) acc[m] = 0.0f;
  for (int g = 0; g < 4; ++g) {
    __syncthreads();  // the previous gate (or tile) is done with shared memory
    load_patch(sA, lda, dz_b, 4 * enc, g * enc, enc, ti.y0, ti.x0, p.sh, p.sw);
    load_b_gate(sB, w, g, ti.j0, enc, ldb);
    __syncthreads();
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
}

// Gate backward of step t at one pixel and channel j, given the gradient dh_in that reaches h_t
// through step t+1; writes dz_t there and updates dc in place.
__device__ __forceinline__ void gate_backward_f32(const BwdParams& p, int t, size_t pix, size_t pk,
                                                  int j, float dh_in) {
  const int enc = p.enc;
  const size_t step_px = size_t(p.b) * p.sh * p.sw;
  const size_t zi = (size_t(t) * step_px + pix) * 4 * enc + j;
  const size_t si = (size_t(t) * step_px + pix) * enc + j;
  const size_t pi = pk * enc + j;
  const float* z = static_cast<const float*>(p.z);
  const float dh = dh_in + static_cast<const float*>(p.dh_seq)[si];
  const GateGrad gg = gate_grad(z[zi], z[zi + enc], z[zi + 2 * enc], z[zi + 3 * enc],
                                static_cast<const float*>(p.c_prev)[si],
                                static_cast<const float*>(p.wci)[pi],
                                static_cast<const float*>(p.wcf)[pi],
                                static_cast<const float*>(p.wco)[pi], dh, p.dc[pix * enc + j]);
  float* dz = static_cast<float*>(p.dz);
  dz[zi] = gg.dzi;
  dz[zi + enc] = gg.dzf;
  dz[zi + 2 * enc] = gg.dzc;
  dz[zi + 3 * enc] = gg.dzo;
  p.dc[pix * enc + j] = gg.dc;
}

__global__ void __launch_bounds__(THREADS) scan_bwd_f32_kernel(BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int enc = p.enc;
  float* sA = reinterpret_cast<float*>(smem);
  float* sB = reinterpret_cast<float*>(smem + f32_smem_a_bytes(enc));
  const int r = threadIdx.x / JC;
  const int cc = threadIdx.x % JC;
  const size_t item = size_t(p.sh) * p.sw * 4 * enc;  // dz elements per batch item and step
  const float* dh_last = static_cast<const float*>(p.dh_last);
  cg::grid_group grid = cg::this_grid();

  // prologue: the gate backward of the last step, fed by the gradient of h_last
  for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    const TileIndex ti = tile_index(tile, p.tiles_x, p.tiles_y, p.tiles_j);
#pragma unroll
    for (int m = 0; m < TILE_H; ++m) {
      const int gy = ti.y0 + m, gx = ti.x0 + r;
      if (gy >= p.sh || gx >= p.sw) continue;
      const size_t pk = size_t(gy) * p.sw + gx;
      const size_t pix = size_t(ti.bi) * p.sh * p.sw + pk;
      const int j = ti.j0 + cc;
      gate_backward_f32(p, p.T - 1, pix, pk, j, dh_last ? dh_last[pix * enc + j] : 0.0f);
    }
  }
  grid.sync();  // dz_{T-1} is complete before any tile convolves it

  for (int t = p.T - 1; t >= 0; --t) {
    const float* dz_t = static_cast<const float*>(p.dz) + size_t(t) * p.b * item;
    for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
      const TileIndex ti = tile_index(tile, p.tiles_x, p.tiles_y, p.tiles_j);
      float acc[TILE_H];
      transposed_conv_f32(dz_t + size_t(ti.bi) * item, static_cast<const float*>(p.w), ti, p, sA,
                          sB, r, cc, acc);
#pragma unroll
      for (int m = 0; m < TILE_H; ++m) {
        const int gy = ti.y0 + m, gx = ti.x0 + r;
        if (gy >= p.sh || gx >= p.sw) continue;
        const size_t pk = size_t(gy) * p.sw + gx;
        const size_t pix = size_t(ti.bi) * p.sh * p.sw + pk;
        if (t > 0)
          gate_backward_f32(p, t - 1, pix, pk, ti.j0 + cc, acc[m]);
        else
          p.dh0[pix * enc + ti.j0 + cc] = acc[m];
      }
    }
    if (t > 0) grid.sync();  // dz_{t-1} is complete before step t-1 convolves it
  }
}

// ---- bf16: resident weights, cp.async dz ring, wgmma -------------------------------------------

constexpr int BF_THREADS = 256;  // two warpgroups: warp w owns tile row w (16 pixels)
constexpr int STAGES = 4;        // ring depth

__host__ __device__ constexpr size_t bf16_weight_bytes(int enc, int nc) { return size_t(72) * enc * nc; }
constexpr size_t bf16_smem_bytes(int enc, int nc) {
  return bf16_weight_bytes(enc, nc) + STAGES * STAGE_BYTES;
}

// What the gate backward of step t needs at one pixel and channel pair (j, j+1), apart from the
// gradient that reaches h_t through step t+1.
struct PairIn {
  uint32_t z[4], c, dhs, wci, wcf, wco;  // bf16 pairs
  float2 dc;
};

__device__ __forceinline__ PairIn load_pair(const BwdParams& p, int t, size_t pix, size_t pk, int j) {
  const int enc = p.enc;
  const size_t zi = (size_t(t) * p.b * p.sh * p.sw + pix) * 4 * enc + j;
  const size_t si = (size_t(t) * p.b * p.sh * p.sw + pix) * enc + j;
  PairIn in;
#pragma unroll
  for (int g = 0; g < 4; ++g) in.z[g] = ld_u32(p.z, zi + g * enc);
  in.c = ld_u32(p.c_prev, si);
  in.dhs = ld_u32(p.dh_seq, si);
  in.wci = ld_u32(p.wci, pk * enc + j);
  in.wcf = ld_u32(p.wcf, pk * enc + j);
  in.wco = ld_u32(p.wco, pk * enc + j);
  in.dc = *reinterpret_cast<const float2*>(p.dc + pix * enc + j);
  return in;
}

// The gate backward of step t at one pixel and channels (j, j+1), given the gradients dh_a, dh_b
// that reach h_t through step t+1: writes dz_t there and updates dc in place.
__device__ __forceinline__ void finish_pair(const BwdParams& p, int t, size_t pix, int j,
                                            const PairIn& in, float dh_a, float dh_b) {
  const int enc = p.enc;
  const float2 zi = bf2(in.z[0]), zf = bf2(in.z[1]), zc = bf2(in.z[2]), zo = bf2(in.z[3]);
  const float2 c = bf2(in.c), dhs = bf2(in.dhs), wci = bf2(in.wci), wcf = bf2(in.wcf),
               wco = bf2(in.wco);
  const GateGrad a = gate_grad(zi.x, zf.x, zc.x, zo.x, c.x, wci.x, wcf.x, wco.x, dh_a + dhs.x, in.dc.x);
  const GateGrad b = gate_grad(zi.y, zf.y, zc.y, zo.y, c.y, wci.y, wcf.y, wco.y, dh_b + dhs.y, in.dc.y);
  __nv_bfloat162* dz = reinterpret_cast<__nv_bfloat162*>(
      static_cast<bf16*>(p.dz) + (size_t(t) * p.b * p.sh * p.sw + pix) * 4 * enc + j);
  dz[0] = __floats2bfloat162_rn(a.dzi, b.dzi);
  dz[enc / 2] = __floats2bfloat162_rn(a.dzf, b.dzf);
  dz[enc] = __floats2bfloat162_rn(a.dzc, b.dzc);
  dz[3 * enc / 2] = __floats2bfloat162_rn(a.dzo, b.dzo);
  *reinterpret_cast<float2*>(p.dc + pix * enc + j) = make_float2(a.dc, b.dc);
}

// A lane's share of a tile, in the wgmma accumulator layout: tile row `row` (its warp), pixels
// x0 + l/4 + 8h, h < 2, and channels j0 + 8j + 2(l%4) + e, e < 2, whose dh_carry is acc[4j + 2h + e];
// row_pix is the row's first pixel and row_n its pixels inside the image.
template <int NC>
struct LaneTile {
  static constexpr int NG = NC / 8;
  size_t pix[2];
  bool valid[2];
  size_t row_pix;
  int row_n;

  __device__ __forceinline__ void locate(const BwdParams& p, const TileIndex& ti, int row, int lane) {
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
  // Lanes 0-3 ask L2 for the warp's tile row of z, c_prev, dh_seq (step t) and dc: each is one
  // contiguous range of the row's row_n pixels.
  __device__ __forceinline__ void prefetch(const BwdParams& p, int t, int lane) const {
    if (row_n <= 0 || lane >= 4) return;
    const size_t px = size_t(t) * p.b * p.sh * p.sw + row_pix;
    const void* src;
    int bytes = row_n * p.enc * 2;
    if (lane == 0) {
      src = static_cast<const bf16*>(p.z) + px * 4 * p.enc;
      bytes *= 4;
    } else if (lane == 1) {
      src = static_cast<const bf16*>(p.c_prev) + px * p.enc;
    } else if (lane == 2) {
      src = static_cast<const bf16*>(p.dh_seq) + px * p.enc;
    } else {
      src = p.dc + row_pix * p.enc;
      bytes *= 2;
    }
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src), "r"(bytes) : "memory");
  }
  // The gate backward of step t at the lane's pixels and channels: all operands are loaded
  // first, then each pair is computed and stored.
  __device__ __forceinline__ void finish(const BwdParams& p, int t, int j0, int lane,
                                         const float (&acc)[NC / 2]) const {
    PairIn in[2][NG];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!valid[h]) continue;
      const size_t pk = pix[h] % (size_t(p.sh) * p.sw);
#pragma unroll
      for (int j = 0; j < NG; ++j) in[h][j] = load_pair(p, t, pix[h], pk, j0 + 8 * j + 2 * (lane & 3));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!valid[h]) continue;
#pragma unroll
      for (int j = 0; j < NG; ++j)
        finish_pair(p, t, pix[h], j0 + 8 * j + 2 * (lane & 3), in[h][j], acc[4 * j + 2 * h],
                    acc[4 * j + 2 * h + 1]);
    }
  }
  __device__ __forceinline__ void store_dh0(const BwdParams& p, int j0, int lane,
                                            const float (&acc)[NC / 2]) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!valid[h]) continue;
#pragma unroll
      for (int j = 0; j < NG; ++j)
        *reinterpret_cast<float2*>(p.dh0 + pix[h] * p.enc + j0 + 8 * j + 2 * (lane & 3)) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
};

template <int NC>
__global__ void __launch_bounds__(BF_THREADS, 1) scan_bwd_bf16_kernel(BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int NACC = NC / 2, NG = NC / 8;
  const int enc = p.enc;
  bf16* sW = reinterpret_cast<bf16*>(smem);
  bf16* ring = reinterpret_cast<bf16*>(smem + bf16_weight_bytes(enc, NC));
  const int lane = threadIdx.x & 31, row = threadIdx.x >> 5;
  // block -> (output-channel block, rank among the blocks of that channel block)
  const int j0 = (blockIdx.x % p.tiles_j) * NC;
  const int q = blockIdx.x / p.tiles_j, nq = gridDim.x / p.tiles_j;
  const int n_my = q < p.n_tiles ? (p.n_tiles - q + nq - 1) / nq : 0;
  const int spt = 4 * enc / STAGE_CH;  // ring stages per tile and step
  const int kq_n = 4 * enc / 8;
  const size_t item = size_t(p.sh) * p.sw * 4 * enc;
  cg::grid_group grid = cg::this_grid();
  LaneTile<NC> lt;
  float acc[NACC];

  // the block's weight slice arrives while the prologue runs
  load_weights_async(sW, static_cast<const bf16*>(p.w), enc, j0, NC);
  cp_async_commit();

  // prologue: the gate backward of the last step, fed by the gradient of h_last
  for (int i = 0; i < n_my; ++i) {
    lt.locate(p, pixel_tile(q + i * nq, p), row, lane);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        float2 v = make_float2(0.0f, 0.0f);
        if (p.dh_last && lt.valid[h])
          v = bf2(ld_u32(p.dh_last, lt.pix[h] * enc + j0 + 8 * j + 2 * (lane & 3)));
        acc[4 * j + 2 * h] = v.x;
        acc[4 * j + 2 * h + 1] = v.y;
      }
    }
    lt.finish(p, p.T - 1, j0, lane, acc);
  }
  cp_async_wait<0>();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // wgmma reads the weights
  __syncthreads();
  grid.sync();  // dz_{T-1} is complete before any tile convolves it

  for (int t = p.T - 1; t >= 0; --t) {
    const bf16* dz_t = static_cast<const bf16*>(p.dz) + size_t(t) * p.b * item;
    const int n_items = n_my * spt;  // (tile, stage) pairs of this block in this step
    auto fetch = [&](int idx) {
      const TileIndex ti = pixel_tile(q + (idx / spt) * nq, p);
      load_stage_async(ring + (idx % STAGES) * (STAGE_BYTES / sizeof(bf16)), dz_t, 4 * enc,
                       idx % spt, ti.bi, ti.y0, ti.x0, p.sh, p.sw);
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < n_items) fetch(s);
      cp_async_commit();
    }
    for (int it = 0; it < n_items; ++it) {
      const int chunk = it % spt;
      if (chunk == 0) {  // a new tile: its epilogue's operands start on their way
        lt.locate(p, pixel_tile(q + (it / spt) * nq, p), row, lane);
        if (t > 0) lt.prefetch(p, t - 1, lane);
#pragma unroll
        for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;
      }
      cp_async_wait<STAGES - 2>();  // this thread's copies of stage `it` have landed
      __syncthreads();              // everyone's have, and stage it-1's slot is free again
      if (it + STAGES - 1 < n_items) fetch(it + STAGES - 1);
      cp_async_commit();
      const bf16* stage = ring + (it % STAGES) * (STAGE_BYTES / sizeof(bf16));
      uint32_t a[2][9][4];
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) load_a_tap(a[k][tap], stage, row, tap / 3, tap % 3, 16 * k, lane);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
          Wgmma<NC>::mma(acc, a[k][tap],
                         wgmma_desc(sW + (tap * kq_n + 2 * (2 * chunk + k)) * NG * 64, NG * 128, 128));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (chunk == spt - 1) {
        if (t > 0)
          lt.finish(p, t - 1, j0, lane, acc);
        else
          lt.store_dh0(p, j0, lane, acc);
      }
    }
    cp_async_wait<0>();
    if (t > 0) grid.sync();  // dz_{t-1} is complete before step t-1 convolves it
  }
}

// ---- launch ------------------------------------------------------------------------------------

template <int NC>
cudaError_t launch_bf16(BwdParams p, cudaStream_t stream) {
  p.tiles_x = (p.sw + PT_W - 1) / PT_W;
  p.tiles_y = (p.sh + PT_H - 1) / PT_H;
  p.tiles_j = p.enc / NC;
  p.n_tiles = p.b * p.tiles_y * p.tiles_x;
  return launch_cooperative(scan_bwd_bf16_kernel<NC>, bf16_smem_bytes(p.enc, NC),
                            p.tiles_j * p.n_tiles, p.tiles_j, p, BF_THREADS, stream);
}

cudaError_t launch_bf16_any(BwdParams p, cudaStream_t stream) {
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  // the widest output-channel block whose resident weights leave room for the ring
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

cudaError_t launch_f32(BwdParams p, cudaStream_t stream) {
  p.tiles_x = (p.sw + TILE_W - 1) / TILE_W;
  p.tiles_y = (p.sh + TILE_H - 1) / TILE_H;
  p.tiles_j = p.enc / JC;
  p.n_tiles = p.b * p.tiles_y * p.tiles_x * p.tiles_j;
  return launch_cooperative(scan_bwd_f32_kernel, f32_smem_bytes(p.enc), p.n_tiles, 1, p, THREADS,
                            stream);
}

}  // namespace

extern "C" {

// Runs the whole reverse-time walk on `stream`. Returns a cudaError_t (0 on success). All tensors
// are contiguous; z, c_prev, dh_seq, dh_last, w, wci, wcf, wco and dz are bf16 when is_bf16 is
// set, else f32; dc (in place) and dh0 are f32. dh_last may be null (zeros).
int vp_convlstm_scan_bwd(int is_bf16, const void* z, const void* c_prev, const void* dh_seq,
                         const void* dh_last, float* dc, const void* w, const void* wci,
                         const void* wcf, const void* wco, void* dz, float* dh0, int T, int b,
                         int sh, int sw, int enc, void* stream) {
  if (T < 1 || b < 1 || sh < 1 || sw < 1 || enc < JC || enc % JC != 0) return cudaErrorInvalidValue;
  BwdParams p{z, c_prev, dh_seq, dh_last, dc, w, wci, wcf, wco, dz, dh0, T, b, sh, sw, enc,
              0, 0, 0, 0};
  cudaError_t err = is_bf16 ? launch_bf16_any(p, static_cast<cudaStream_t>(stream))
                            : launch_f32(p, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) cudaGetLastError();  // clear it, so later launches do not report it
  return int(err);
}

const char* vp_cuda_error_string(int err) { return cudaGetErrorString(cudaError_t(err)); }

}  // extern "C"
