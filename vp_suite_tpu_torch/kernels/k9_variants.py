r"""Variants of K9's bf16 kernels (``csrc/warp_contract.cu``) side by side on one CUDA card.

    python3 -m vp_suite_tpu_torch.kernels.k9_variants [--parent DIR] [VARIANT ...]

Each variant is the factor-contraction library's source with one named edit
(:data:`EDITS`), compiled with :mod:`~vp_suite_tpu_torch.kernels.build`'s flags
into ``kernels/_build/k9_variants/`` (:mod:`~vp_suite_tpu_torch.kernels.k4_variants`
builds them) and called through the same C entries. The script holds every
variant to ``chip_smoke.py``'s K9 check in bf16: the forward and the three
gradients of a backward call against ``warp_contract_reference`` and
``warp_contract_backward_reference``, each within :data:`REL_BF16` of its
largest value, at EF-TrajGRU's three layer shapes (b=32, L=13, dense random
factors at the scale of the one-hot ones) and at :data:`SMALL` shapes that
take the kernels' other branches (w not 16/32/64, h not a multiple of 8, a
part-filled last slab, two channel passes and chunks). It then times the
forward call and the backward call (two launches) of each variant with CUDA
events at the three layer shapes, in turns: parent, kernel, variants,
parent, beside ``torch.einsum`` and, for the backward, ``torch.autograd.grad``
through it (a comparison: no one PyTorch call gives the three gradients).
``--parent`` names a checkout of an earlier commit whose K9 is timed too. The
timing-only variants (``no_build``, ``no_epilogue``, ``no_dimg``,
``no_dab``, ``no_slab_*``, ``no_row_*``) skip part of the work and are wrong by design; ``rows128``
(128-row / 128-pixel blocks), ``yr1`` / ``yr4`` (one image row a stage
in d_A / d_Bm, or four at N <= 32), ``rows_k_contiguous`` (its first layout of the image rows),
``dab_wg1`` (its blocks of one warpgroup), ``dab_general`` (the general d_A /
d_Bm kernel, for w > 128 or tiles too large, at every shape) and ``stages6`` / ``stages8``
(deeper rings) must pass the check; the faults (:data:`FAULTS`) must fail it; the
race (:data:`RACES`) is reported. It also prints each shape's plan
(:func:`plan`, :data:`GEOMETRY_KEYS`) and the bytes each kernel streams
from L2 (:func:`l2_bytes`).
"""
import argparse
import ctypes
import math
import subprocess
import time
from pathlib import Path

import torch

from vp_suite_tpu_torch.kernels import build
from vp_suite_tpu_torch.kernels.k3_variants import _worse
from vp_suite_tpu_torch.kernels.k4_variants import apply_edits, build_variants, event_ms
from vp_suite_tpu_torch.ops.warp import warp_contract_backward_reference, warp_contract_reference

#: chip_smoke.py's FACTOR_REL_BF16: both sides round each result once and a sum
#: taken in another order flips some roundings; the kernels round M = A*Bm to bf16.
REL_BF16 = 2 ** -6

_GATHER_Q = "          const int q = min(q0 + 2 * t + (k & 1) + 8 * (k >> 1), hw - 1);\n"
_FWD_BUILD = """          a[j][mt][0] = mul2(bm[mt][0][xg][0], lo);
          a[j][mt][1] = mul2(bm[mt][1][xg][0], hi);
          a[j][mt][2] = mul2(bm[mt][0][xg][1], lo);
          a[j][mt][3] = mul2(bm[mt][1][xg][1], hi);
"""
_DIMG_BUILD = """          a[j][mt][0] = mul2(f[0], lo);
          a[j][mt][1] = mul2(f[1], lo);
          a[j][mt][2] = mul2(f[2], hi);
          a[j][mt][3] = mul2(f[3], hi);
"""
_CONST_FRAG = "          a[j][mt][0] = a[j][mt][1] = a[j][mt][2] = a[j][mt][3] = 0x3c003c00u;\n"
_SLAB_COPY = "    cp_async16(stage + idx * 8, in ? src + size_t(k) * ld + ch : src, in);\n"

#: name -> the (old, new) text replacements that make the variant; each old text
#: occurs exactly once in the kernels' source.
EDITS = {
    # timing only: M's fragments (forward) and M^T's (d_img) from a constant, on the fast
    # branches: no factor reads, no products; the epilogue of d_A / d_Bm skipped
    "no_build": [(_FWD_BUILD, _CONST_FRAG),
                 (_DIMG_BUILD, _CONST_FRAG),
                 ("          ldmatrix_x4_trans(f, sB + (16 * j + lm_r) * WS + xb[mt] + lm_x);\n",
                  "          f[0] = f[1] = f[2] = f[3] = 0u;\n")],
    "no_epilogue": [("    if (chunk == chunks - 1) {\n", "    if (chunk == chunks - 1 && d.b < 0) {\n")],
    # timing only: no ring copies (the products read stale stages), or no products, in the
    # forward and d_img (no_slab_*) or in d_A / d_Bm (no_row_*)
    "no_slab_copies": [("    if (u + AHEAD < n_slabs) fetch(", "    if (n_slabs < 0) fetch(")],
    "no_slab_products": [("        Wgmma<NP>::template mma<1>(\n", "        if (n_slabs < 0) Wgmma<NP>::template mma<1>(\n")],
    "no_row_copies": [("    if (it + STAGES - 1 < n_items) fetch(it + STAGES - 1);\n",
                       "    if (n_items < 0) fetch(it + STAGES - 1);\n")],
    # the fence that orders the ring's cp.async writes before wgmma's async-proxy reads dropped
    # (forward and d_img; d_A / d_Bm)
    "no_proxy_fence": [("    fence_proxy_async();         // ... for wgmma's reads too\n", ""),
                       ("    cp_async_wait<STAGES - 2>();\n    fence_proxy_async();\n",
                        "    cp_async_wait<STAGES - 2>();\n")],
    # the MN-major slabs copied with cp.async's three-operand form (no zero-fill operand: wrong
    # where a slab is padded, right at the layer shapes), or a warp reading 512 contiguous bytes
    # (four pixel rows; eight threads then write eight core matrices in one bank group)
    "plain_cp_async": [(_SLAB_COPY, '    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(smem_u32(stage + idx * 8)), '
                                    '"l"(in ? src + size_t(k) * ld + ch : src) : "memory");\n')],
    "row_reads": [("    const int k = k0 + (idx / (8 * NG)) * 8 + idx % 8, ch = c0 + ((idx / 8) % NG) * 8;\n",
                   "    const int k = k0 + idx / NG, ch = c0 + (idx % NG) * 8;\n"),
                  (_SLAB_COPY, _SLAB_COPY.replace("stage + idx * 8", "stage + ((((k - k0) / 8) * NG + (ch - c0) / 8) * 8 + (k - k0) % 8) * 8"))],
    "no_row_products": [("        if (k < ks)\n          Wgmma<N>::mma(", "        if (k < ks && n_items < 0)\n          Wgmma<N>::mma(")],
    # timing only: the backward call without its d_img launch, or without its d_A / d_Bm launch
    "no_dimg": [("  cudaError_t err = VP_BY_NP(dimg_bf16,", "  cudaError_t err = d.b > 0 ? cudaSuccess : VP_BY_NP(dimg_bf16,")],
    "no_dab": [("  return VP_BY_N(dab_bf16,", "  if (d.b > 0) return err;\n  return VP_BY_N(dab_bf16,")],
    # one image row per ring stage of d_A / d_Bm (one barrier and one wgmma wait per row)
    "yr1": [("__host__ __device__ constexpr int yr_for(int n) { return n == 64 ? 2 : 1; }",
             "__host__ __device__ constexpr int yr_for(int n) { return 1; }")],
    # four image rows a stage at N <= 32 (the first choice), two at 64
    "yr4": [("__host__ __device__ constexpr int yr_for(int n) { return n == 64 ? 2 : 1; }",
             "__host__ __device__ constexpr int yr_for(int n) { return n <= 32 ? 4 : n <= 64 ? 2 : 1; }")],
    # d_A / d_Bm's image rows with K-adjacent core matrices next to each other (N-adjacent ones
    # kch*16 bytes apart), the layout the first version of this kernel had
    "rows_k_contiguous": [("      cp_async16(stage + i * row_elems + ((kq * NX + xg) * 8 + x % 8) * 8,",
                           "      cp_async16(stage + i * row_elems + ((xg * kq_n + kq) * 8 + x % 8) * 8,"),
                          ("wgmma_desc(stage + i * row_elems + k * 16 * N, N * 16, 128)",
                           "wgmma_desc(stage + i * row_elems + k * 128, 128, kch * 16)")],
    # rings of 6 and 8 stages (4 and 6 slabs of copies in flight ahead of the products)
    "stages6": [("constexpr int STAGES = 4;        // ring depth", "constexpr int STAGES = 6;        // ring depth")],
    "stages8": [("constexpr int STAGES = 4;        // ring depth", "constexpr int STAGES = 8;        // ring depth")],
    # d_A / d_Bm by the general kernel at every shape (the one for w > 128 or tiles too large:
    # one image row a stage, g's channels a chunk at a time, no A tile)
    "dab_general": [("  p.dab_general = d.w > 128 || p.dab_smem > SMEM_MAX;\n", "  p.dab_general = 1;\n")],
    # d_A / d_Bm in blocks of one warpgroup (64 rows), two blocks an SM
    "dab_wg1": [("constexpr int DAB_WG = 2;", "constexpr int DAB_WG = 1;")],
    # the pixel tile not kept: one m64 tile per warpgroup (128-row forward, 128-pixel d_img blocks)
    "rows128": [("__host__ __device__ constexpr int mt_for(int np) { return np <= 96 ? 2 : 1; }",
                 "__host__ __device__ constexpr int mt_for(int np) { return 1; }")],
    # faults: a gathered fragment column one pixel off (the forward's other branch); the
    # forward's Bm pairs of the next 16 image columns (its register branch); the slabs' padding
    # past the image (forward) or the last row (d_img) copied from the first row instead of
    # zero-filled; the race: the ring's cp.async wait dropped (forward and d_img)
    "frag_column_off_by_one": [(_GATHER_Q, _GATHER_Q.replace("8 * (k >> 1), hw", "8 * (k >> 1) + 1, hw"))],
    "bm_group_off": [("        const int y = min(q0 / W, d.h - 1), xg = j % XG;\n",
                      "        const int y = min(q0 / W, d.h - 1), xg = (j + 1) % XG;\n")],
    "last_slab_not_zero_filled": [(_SLAB_COPY, _SLAB_COPY.replace(" : src, in);", " : src, true);"))],
    "ring_no_wait": [("    cp_async_wait<AHEAD - 1>();  // this thread's copies of slab u have landed\n", "")],
}
#: the variants that must fail the check
FAULTS = ("frag_column_off_by_one", "bm_group_off", "last_slab_not_zero_filled")
#: a race the check may not see (a dropped cp.async wait passed on an H100 in some runs of
#: K3's, K4's and the warp forward's checks)
RACES = ("ring_no_wait",)

B, L = 32, 13
#: EF-TrajGRU's layer shapes (side, channels)
SHAPES = [(64, 64), (32, 96), (16, 96)]
#: (b, L, P, h, w, c) that take the other branches: w = 16 with c = 24 (one pass of 32 padded
#: channels); the ragged 9x11 image (gathered fragments, P < one tile); h % 8 != 0 at w = 16 with
#: a part-filled last slab (gathered d_img); two channel passes and chunks at c = 136, P not a
#: multiple of the tile
SMALL = [(2, 3, 256, 16, 16, 24), (2, 3, 50, 9, 11, 24), (2, 3, 96, 6, 16, 64),
         (2, 2, 200, 8, 32, 136)]
#: one H100 SXM: shared memory a block may opt into
SMEM_MAX = 232448
GEOMETRY_KEYS = ("np", "passes", "mt", "fwd_w", "dimg_w", "ny", "hs", "yc", "yparts", "dab_n",
                 "kch", "chunks", "cs", "yr", "dab_general", "xchunks", "fwd_smem", "dimg_smem",
                 "dab_smem", "fwd_blocks", "dimg_blocks", "dab_blocks", "scratch")


def variant_source(name: str) -> str:
    return apply_edits("warp_contract.cu", EDITS, name)


def _declare(lib, text):
    r"""Declares the entries; ``lib.takes_scratch`` says whether the backward's
    entry has the scratch argument (an earlier commit's has not)."""
    lib.takes_scratch = "float* scratch, int b" in text
    lib.vp_warp_contract_fwd.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 \
        + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.vp_warp_contract_bwd.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * (7 + lib.takes_scratch) \
        + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.vp_warp_contract_fwd.restype = lib.vp_warp_contract_bwd.restype = ctypes.c_int
    return lib


def _pad_n(n):
    return 16 if n <= 16 else 32 if n <= 32 else 64 if n <= 64 else 96 if n <= 96 else 128


def _up(n, m):
    return -(-n // m) * m


def _a128(n):
    return _up(n, 128)


def plan(b, L, P, h, w, c):
    r"""The plan that ``csrc/warp_contract.cu``'s ``make_plan`` computes for
    the bf16 kernels (c a multiple of 8, as the wrappers pad it), as
    :func:`geometry` returns it: a dict of :data:`GEOMETRY_KEYS`. Every
    shape has one: the forward's A tile in parts of ``yc`` columns where h is
    too tall for it, d_A / d_Bm by the general kernel (``dab_general``) where
    w > 128 or their tiles do not fit, accumulating in ``scratch`` f32
    elements where their sums have several parts."""
    rows, hw = L * P, h * w
    np_ = _pad_n(c)
    mt = 2 if np_ <= 96 else 1
    w_reg = w in (16, 32, 64)
    dimg_w = w if w_reg and h % 8 == 0 else 0
    ny = 128 * mt // w if dimg_w else 0
    hs = _up(h, 4) + 2
    dab_n = _pad_n(min(w, 128))
    kch = min(_up(c, 16), 128)
    chunks = -(-c // kch)
    cs = _up(c, 16) + 8
    rb = 128 * mt
    slab = 64 * np_ * 2
    yc = min(_up(h, 4), ((SMEM_MAX - 4 * slab) // (rb * 2) - 2) // 4 * 4)
    fwd_w = w if w_reg and h <= yc else 0
    yr = 2 if dab_n == 64 else 1
    dab_smem = 4 * _a128(yr * dab_n * kch * 2) + _a128(128 * cs * 2) + _a128(128 * hs * 2)
    general = int(w > 128 or dab_smem > SMEM_MAX)
    xchunks = -(-w // dab_n)
    if general:
        yr = 1
        dab_smem = 4 * _a128(dab_n * kch * 2) + _a128(128 * (kch + 8) * 2)
    return dict(np=np_, passes=-(-c // np_), mt=mt, fwd_w=fwd_w, dimg_w=dimg_w, ny=ny, hs=hs,
                yc=yc, yparts=-(-h // yc), dab_n=dab_n, kch=kch, chunks=chunks, cs=cs, yr=yr,
                dab_general=general, xchunks=xchunks,
                fwd_smem=4 * slab + _a128(rb * (yc + 2) * 2),
                dimg_smem=4 * (slab + (_a128(64 * (w + 8) * 2) + _a128(64 * ny * 2) if dimg_w else 0)),
                dab_smem=dab_smem,
                fwd_blocks=b * -(-c // np_) * -(-rows // rb),
                dimg_blocks=b * -(-c // np_) * -(-hw // rb),
                dab_blocks=b * -(-rows // 128),
                scratch=b * rows * (h + w) if general and (xchunks > 1 or chunks > 1) else 0)


def l2_bytes(b, L, P, h, w, c):
    r"""Bytes each bf16 kernel copies into shared memory from L2 per call
    (every block streams its item's whole image or g, padding included):
    ``{"fwd": ..., "dimg": ..., "dab": ...}``."""
    p = plan(b, L, P, h, w, c)
    fwd = p["fwd_blocks"] * -(-h * w // 64) * 64 * p["np"] * 2
    g_slabs = -(-L * P // 64) * 64
    dimg = p["dimg_blocks"] * g_slabs * (p["np"] + (w + p["ny"] if p["dimg_w"] else 0)) * 2
    dab = p["dab_blocks"] * -(-h // p["yr"]) * p["yr"] * p["chunks"] * p["xchunks"] * p["dab_n"] \
        * p["kch"] * 2
    return dict(fwd=fwd, dimg=dimg, dab=dab)


def geometry(lib, b, L, P, h, w, c):
    r"""The bf16 kernels' plan from ``lib``'s ``vp_warp_contract_geometry``, a
    dict of :data:`GEOMETRY_KEYS`."""
    out = (ctypes.c_int64 * len(GEOMETRY_KEYS))()
    fn = lib.vp_warp_contract_geometry
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int64)]
    fn.restype = ctypes.c_int
    err = fn(b, L, P, h, w, c, out)
    if err:
        raise RuntimeError(f"vp_warp_contract_geometry failed ({err})")
    return dict(zip(GEOMETRY_KEYS, out))


def args_at(gen, b, Lf, P, h, w, c):
    r"""Dense random bf16 factors at the scale of the one-hot ones, an image
    of order 1 and a cotangent of 1e-2 (``chip_smoke.py``'s K9 operands)."""
    dev = torch.device("cuda")

    def rnd(*s, scale=1.0):
        return (torch.randn(*s, generator=gen, device=dev) * scale).bfloat16()

    return (rnd(b, Lf, P, h, scale=h ** -0.5), rnd(b, Lf, P, w, scale=w ** -0.5),
            rnd(b, h, w, c), rnd(b, Lf, P, c, scale=1e-2))


def run_fwd(lib, A, Bm, img, out):
    b, Lf, P, h = A.shape
    _, _, w, c = img.shape
    err = lib.vp_warp_contract_fwd(1, A.data_ptr(), Bm.data_ptr(), img.data_ptr(), out.data_ptr(),
                                   b, Lf, P, h, w, c, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K9 forward variant launch failed ({err})")


def run_bwd(lib, A, Bm, img, g, outs, scratch=None):
    b, Lf, P, h = A.shape
    _, _, w, c = img.shape
    extra = [None if scratch is None else scratch.data_ptr()] if lib.takes_scratch else []
    err = lib.vp_warp_contract_bwd(1, A.data_ptr(), Bm.data_ptr(), img.data_ptr(), g.data_ptr(),
                                   *(o.data_ptr() for o in outs), *extra, b, Lf, P, h, w, c,
                                   torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K9 backward variant launch failed ({err})")


def scratch_for(A, img):
    r"""f32 scratch of the most elements any plan asks for at these sizes
    (b * L * P * (h + w)), so that a variant that moves a shape onto the general
    d_A / d_Bm kernel has it."""
    b, Lf, P, h = A.shape
    return torch.empty(b * Lf * P * (h + img.shape[2]), dtype=torch.float32, device=A.device)


def rel(got, want):
    r"""Largest ``|got - want|`` over the largest ``|want|``; nan if any is nan."""
    diff = (got.float() - want.float()).abs()
    if bool(torch.isnan(diff).any()):
        return math.nan
    return diff.max().item() / (want.float().abs().max().item() or 1.0)


def check(libs, gen):
    r"""Each variant's largest error over :data:`REL_BF16` of out, d_A, d_Bm
    and d_img at the layer shapes and :data:`SMALL`; prints one line per shape
    and returns ``{name: largest error / its limit}``."""
    worst = {name: 0.0 for name in libs if name != "parent"}
    shapes = [(B, L, s * s, s, s, c) for s, c in SHAPES] + SMALL
    for b, Lf, P, h, w, c in shapes:
        A, Bm, img, g = args_at(gen, b, Lf, P, h, w, c)
        want = [warp_contract_reference(A, Bm, img),
                *warp_contract_backward_reference(A, Bm, img, g)]
        line = []
        for name in worst:
            got = [torch.full_like(x, math.nan) for x in want]
            try:  # a variant may refuse a shape (its tiles do not fit): its outputs stay nan
                run_fwd(libs[name], A, Bm, img, got[0])
                run_bwd(libs[name], A, Bm, img, g, got[1:], scratch_for(A, img))
            except RuntimeError as e:
                print(f"[check] {name} at b={b} L={Lf} P={P} {h}x{w}x{c}: {e}")
            torch.cuda.synchronize()
            errs = [rel(x, y) / REL_BF16 for x, y in zip(got, want)]
            ratio = 0.0
            for e in errs:
                ratio = _worse(ratio, e)
            worst[name] = _worse(worst[name], ratio)
            line.append(f"{name} " + "/".join(f"{e:.3g}" for e in errs))
        print(f"[check] b={b} L={Lf} P={P} {h}x{w}x{c} bf16: out/d_A/d_Bm/d_img error over "
              f"{REL_BF16:.3g} of the largest: " + ", ".join(line))
        del want, A, Bm, img, g
    for name, ratio in worst.items():
        tag = " (a fault: must fail)" if name in FAULTS else " (a race)" if name in RACES else ""
        print(f"[check] {name}: largest error {ratio:.3g} x the limit; "
              f"{'passes' if ratio <= 1.0 else 'fails'} the smoke's K9 check{tag}")
    return worst


def einsum_ms(A, Bm, img, g):
    r"""``torch.einsum("blpy,blpx,byxc->blpc", ...)`` forward and
    ``torch.autograd.grad`` through it, ms each, or the reason it failed."""
    out = []
    leaves = [a.detach().requires_grad_() for a in (A, Bm, img)]
    for fn in (lambda: torch.einsum("blpy,blpx,byxc->blpc", A, Bm, img),
               lambda: torch.autograd.grad(torch.einsum("blpy,blpx,byxc->blpc", *leaves),
                                           leaves, g)):
        try:
            out.append(f"{event_ms(fn, warmup=1, iters=3):.3f} ms")
        except torch.cuda.OutOfMemoryError as e:
            torch.cuda.empty_cache()
            out.append(str(e).splitlines()[0][:80])
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="a checkout of an earlier commit, whose K9 is timed too")
    ap.add_argument("variants", nargs="*",
                    help=f"any of {', '.join(EDITS)} (default: all; 'kernel': none)")
    args = ap.parse_args()
    unknown = [v for v in args.variants if v not in EDITS and v != "kernel"]
    if unknown:
        ap.error(f"unknown variants {unknown}")
    if not torch.cuda.is_available():
        raise SystemExit("k9_variants: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    sources = {"kernel": (variant_source("kernel"), build.CSRC)}
    sources.update({v: (variant_source(v), build.CSRC)
                    for v in (args.variants or EDITS) if v != "kernel"})
    if args.parent:
        pcsrc = args.parent.resolve() / "vp_suite_tpu_torch" / "csrc"
        sources["parent"] = ((pcsrc / "warp_contract.cu").read_text(), pcsrc)
    t0 = time.time()
    libs = build_variants(sources, _declare, "k9_variants")
    print(f"[build] {len(libs)} variants in {time.time() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, Lf, P, h, w, c in [(B, L, s * s, s, s, c) for s, c in SHAPES] + SMALL:
        got, want = geometry(libs["kernel"], b, Lf, P, h, w, c), plan(b, Lf, P, h, w, c)
        print(f"[plan] b={b} L={Lf} P={P} {h}x{w}x{c}: {got}"
              + ("" if got == want else f" (the Python mirror says {want})")
              + f"; from L2 {l2_bytes(b, Lf, P, h, w, c)}")
    worst = check(libs, gen)
    bad = [n for n, r in worst.items() if n in FAULTS and r <= 1.0]
    order = (["parent"] if args.parent else []) + [n for n in libs if n != "parent"] \
        + (["parent"] if args.parent else [])
    totals = {}
    for side, ch in SHAPES:
        A, Bm, img, g = args_at(gen, B, L, side * side, side, side, ch)
        out = torch.empty(B, L, side * side, ch, dtype=img.dtype, device=img.device)
        grads = [torch.empty_like(A), torch.empty_like(Bm), torch.empty_like(img)]
        scratch = scratch_for(A, img)
        line = []
        for i, name in enumerate(order):
            fwd = event_ms(lambda: run_fwd(libs[name], A, Bm, img, out), warmup=1, iters=5)
            bwd = event_ms(lambda: run_bwd(libs[name], A, Bm, img, g, grads, scratch), warmup=1,
                           iters=5)
            key = f"{name} (again)" if name == "parent" and i else name
            tot = totals.setdefault(key, [0.0, 0.0])
            tot[0] += fwd
            tot[1] += bwd
            line.append(f"{name} {fwd:.3f} / {bwd:.3f}")
        lib_f, lib_b = einsum_ms(A, Bm, img, g)
        print(f"[time] {side}x{side}x{ch} b={B} L={L} bf16, ms per forward / backward call: "
              + ", ".join(line) + f"; torch.einsum {lib_f}, autograd.grad through it {lib_b}")
        del A, Bm, img, g, out, grads, scratch
        torch.cuda.empty_cache()
    print("[time] over the three shapes, forward / backward ms: "
          + ", ".join(f"{k} {v[0]:.3f} / {v[1]:.3f}" for k, v in totals.items()))
    if bad:
        raise SystemExit(f"k9_variants: the faults {bad} pass the smoke's K9 check")


if __name__ == "__main__":
    main()
