r"""Variants of K8's bf16 kernels (``csrc/warp_ret.cu``) side by side on one CUDA card.

    python3 -m vp_suite_tpu_torch.kernels.k8_variants [--parent DIR] [VARIANT ...]

Each variant is the fused warp + ``ret`` library's source with one named edit
(:data:`EDITS`), compiled with :mod:`~vp_suite_tpu_torch.kernels.build`'s flags
into ``kernels/_build/k8_variants/`` (:mod:`~vp_suite_tpu_torch.kernels.k4_variants`
builds them) and called through the same C entries. The script holds every
variant to ``chip_smoke.py``'s K8 check in bf16: the forward and the five
gradients of a backward call against ``warp_ret_reference`` and
``warp_ret_backward_reference``, each within :data:`REL_BF16` of its largest
value, at EF-TrajGRU's three layer shapes (b=32, L=13, O=3f, flows of a few
pixels with a tenth sent far) and at :data:`SMALL` shapes that take the
kernels' other branches. It then times the forward call and the backward call
(three launches) of each variant with CUDA events at the three layer shapes,
in turns: parent, kernel, variants, kernel, parent, beside ``warp_flow_ret`` (the warp
kernel and cuBLAS GEMMs, forward and backward through autograd, the unfused
path TrajGRU runs). ``--parent`` names a checkout of an earlier commit whose
K8 is timed too. The timing-only variants (``no_gather``, ``no_products``,
``no_w_ring``, ``no_img_adds``, ``no_index_grads``, ``no_pass1``, ``no_dw``)
skip part of the work and are wrong by design; ``no_band`` / ``no_band1`` /
``no_band2`` (every tap of the forward / pass 1 / pass 2 from global memory),
``wg1`` (the forward in 64-pixel tiles), ``w_stages6`` (a deeper W ring) and
``fl1`` (pass 2 one flow a block) must pass the check; the
faults (:data:`FAULTS`) must fail it; the race (:data:`RACES`) is reported. A W
stage not zero-filled past f or O is no fault here: the band, the g tile and
the fragments built from them are zero there too, and the outputs past O are
not written. It also prints each shape's plan (:func:`plan`,
:data:`GEOMETRY_KEYS`).
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
from vp_suite_tpu_torch.ops.warp import warp_ret_backward_reference, warp_ret_reference

#: chip_smoke.py's FACTOR_REL_BF16: both sides round each result once, and the
#: samples and g_l, and a sum taken in another order flips some roundings.
REL_BF16 = 2 ** -6

_FWD_MMA = "        Wgmma<96>::template mma<1>(acc[nb], frags[s], wgmma_desc("
_P1_MMA = "        Wgmma<CW>::mma(acc, gf[s], "
_P2_MMA = "            Wgmma<NB>::template mma<1>(acc[fl][mt], af[s][mt],\n"
_P1_PERM = "      const int ch = c0 + 8 * ((n % 8) / 2) + 2 * (n / 8) + n % 2;\n"

#: name -> the (old, new) text replacements that make the variant; each old text
#: occurs exactly once in the kernels' source.
EDITS = {
    # timing only: no tap reads in the forward's and pass 2's builds (zero samples); no products
    # (forward, pass 1, pass 2); no W ring copies after the first two (stale stages)
    "no_gather": [("          toff[h][k] = live && tp.valid[k] ? tp.off[k] : -1;\n",
                   "          toff[h][k] = -1;\n"),
                  ("      if (p < d.P) {\n        const Taps tp = make_taps(si[px], si[CHUNK + px], d.h, d.w);\n",
                   "      if (p < 0) {\n        const Taps tp = make_taps(si[px], si[CHUNK + px], d.h, d.w);\n")],
    "no_products": [(_FWD_MMA, "        if (n_items < 0) " + _FWD_MMA.lstrip()),
                    (_P1_MMA, "        if (ks < 0) " + _P1_MMA.lstrip()),
                    (_P2_MMA, "            if (u0 < 0) " + _P2_MMA.lstrip())],
    "no_w_ring": [("    if (u + W_AHEAD < n_items) fetch(u + W_AHEAD);\n",
                   "    if (n_items < 0) fetch(u + W_AHEAD);\n")],
    # timing only, pass 1: no d_img adds; no index gradients
    "no_img_adds": [("          atomicAdd(dst, make_float4(gl[0] * wt, gl[1] * wt, gl[2] * wt, gl[3] * wt));\n"
                     "          atomicAdd(dst + 1, make_float4(gl[4] * wt, gl[5] * wt, gl[6] * wt, gl[7] * wt));\n",
                     "")],
    "no_index_grads": [("          dy += gl[i] * (tp.wx0 * (val[2][i] - val[0][i]) + tp.wx1 * (val[3][i] - val[1][i]));\n"
                        "          dx += gl[i] * (tp.wy0 * (val[1][i] - val[0][i]) + tp.wy1 * (val[3][i] - val[2][i]));\n",
                        "")],
    # timing only: the backward call without pass 1, or without pass 2
    "no_pass1": [("  err = q.p1_wg == 1\n", "  err = d.b > 0 ? cudaSuccess : q.p1_wg == 1\n")],
    "no_dw": [("  switch (q.p2_nb) {\n", "  if (d.b < 0) switch (q.p2_nb) {\n")],
    # designs that must pass: no band in the forward, in pass 1 or in pass 2; the forward in 64-pixel
    # tiles
    "no_band": [("  p.fwd_rows = std::min(d.h, span + 2 * p.fwd_R);\n", "  p.fwd_rows = 0;\n")],
    "no_band1": [("  p.p1_rows = std::min(d.h, span1 + 2 * p.p1_R);\n", "  p.p1_rows = 0;\n")],
    "no_band2": [("  if (fixed2 + band2(p.p2_rows) > size_t(smem_max)) p.p2_rows = 0;\n",
                  "  p.p2_rows = 0;\n")],
    "wg1": [("  p.fwd_wg = 2;\n", "  p.fwd_wg = 1;\n")],
    # the forward's W ring six stages deep (four items of copies ahead of the products)
    "w_stages6": [("constexpr int W_STAGES = 4;", "constexpr int W_STAGES = 6;")],
    # pass 2 with one flow a block everywhere (g read once per flow)
    "fl1": [("  p.p2_fl = p.p2_mt * p.p2_nb <= 128 ? 2 : 1;\n", "  p.p2_fl = 1;\n")],
    # faults: a tap weight of the forward's build taken from the next tap; g_l's columns paired
    # with the wrong channels of a pair (pass 1); pass 2's band ring read one slot off; the
    # forward's W rows one channel off within a pair
    "tap_weight_off": [("        fma8(v, twt[h][k], raw);\n", "        fma8(v, twt[h][(k + 1) % 4], raw);\n")],
    "g_l_column_off_by_one": [(_P1_PERM, _P1_PERM.replace("n % 2;", "(n + 1) % 2;"))],
    "band_slot_off": [("    const int lo_slot = BR ? (lo % BR) * d.w : 0,",
                       "    const int lo_slot = BR ? ((lo + 1) % BR) * d.w : 0,")],
    "w_rows_off": [("      const int ch = kc * KCH + 8 * ((kk % 8) / 2) + 4 * (k / 16) + 2 * (kk / 8) + kk % 2;\n",
                    "      const int ch = kc * KCH + 8 * ((kk % 8) / 2) + 4 * (k / 16) + 2 * (kk / 8) + (kk + 1) % 2;\n")],
    # the race: the forward's ring wait dropped
    "ring_no_wait": [("    cp_async_wait<W_AHEAD - 1>();  // this thread's copies of item u (and the band) have landed\n", "")],
}
#: the variants that must fail the check
FAULTS = ("tap_weight_off", "g_l_column_off_by_one", "band_slot_off", "w_rows_off")
#: a race the check may not see (a dropped cp.async wait passed on an H100 in some runs of
#: K3's, K4's and K9's checks)
RACES = ("ring_no_wait",)

B, L = 32, 13
#: EF-TrajGRU's layer shapes (side, channels f); O = 3f
SHAPES = [(64, 64), (32, 96), (16, 96)]
#: (b, L, P, h, w, f, O) that take the other branches: f = 24 (one 32-channel item and pass, one
#: n96 product past O = 72); the ragged 9x11 image (P < a tile); P = 1000 != h*w; w = 200 (a band
#: of few rows); h = 512; f = 160 (two pass-2 channel passes, five pass-1 passes) and O = 400 (two
#: forward and pass-2 O passes)
SMALL = [(2, 3, 256, 16, 16, 24, 72), (2, 3, 50, 9, 11, 24, 72), (2, 3, 1000, 32, 32, 64, 192),
         (1, 3, 400, 2, 200, 24, 72), (2, 3, 128, 512, 16, 24, 72), (2, 2, 256, 16, 16, 160, 400)]
#: one H100 SXM: SMs, and shared memory a block may opt into
H100_LIMITS = (132, 232448)
GEOMETRY_KEYS = ("fpad", "fwd_wg", "fwd_onb", "fwd_opasses", "fwd_R", "fwd_rows", "fwd_tiles",
                 "p1_wg", "p1_passes", "p1_ks", "p1_R", "p1_rows", "p1_tiles", "p1_gtile",
                 "p1_sidx", "p2_nb",
                 "p2_fpasses", "p2_mt", "p2_opasses", "p2_os", "p2_R", "p2_rows", "p2_parts",
                 "p2_fl", "fwd_smem", "p1_smem", "p2_smem", "fwd_blocks", "p1_blocks", "p2_blocks")


def variant_source(name: str) -> str:
    return apply_edits("warp_ret.cu", EDITS, name)


def _declare(lib, text):
    lib.vp_warp_ret_fwd.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    lib.vp_warp_ret_bwd.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 10 \
        + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.vp_warp_ret_fwd.restype = lib.vp_warp_ret_bwd.restype = ctypes.c_int
    return lib


def _up(n, m):
    return -(-n // m) * m


def _a128(n):
    return _up(n, 128)


def slices(b, P, L, sms=H100_LIMITS[0]):
    r"""The d_W partials of a bf16 backward call (``ops.warp._dw_slices``):
    ``b`` times the parts of an item's 64-pixel chunks."""
    return b * max(1, min(-(-P // 64), -(-4 * sms // (b * L))))


def max_span(P, w, step, length):
    r"""The most image rows a run of ``length`` output pixels starting at a
    multiple of ``step`` spans (``csrc/warp_ret.cu``'s ``max_span``)."""
    best = 1
    for k in range(min(-(-P // step), w)):
        p0, p1 = k * step, min(k * step + length, P) - 1
        best = max(best, p1 // w - p0 // w + 1)
    return best


def plan(b, P, L, h, w, f, O, n_slices=None, limits=H100_LIMITS):
    r"""The plan that ``csrc/warp_ret.cu``'s ``make_plan`` computes for the
    bf16 kernels on a card of ``limits`` = (SMs, shared bytes a block may opt
    into), f and O multiples of 8 (the wrappers pad them) and ``n_slices``
    d_W partials (default: :func:`slices`), as :func:`geometry` returns it: a
    dict of :data:`GEOMETRY_KEYS`."""
    sms, smem_max = limits
    n_slices = n_slices or slices(b, P, L, sms)
    p = dict(fpad=_up(f, 32))
    onb, wg = min(3, -(-O // 96)), 2

    def count():
        return b * -(-P // (64 * wg)) * -(-O // (96 * onb))
    while count() < sms and (wg > 1 or onb > 1):
        if wg > 1:
            wg = 1
        else:
            onb -= 1
    ring = 4 * 32 * 96 * onb * 2
    span = max_span(P, w, 64 * wg, 64 * wg)
    R = 6 if w >= 48 else 4
    while R > 0 and ring + _a128(min(h, span + 2 * R) * w * p["fpad"] * 2) > smem_max:
        R -= 1
    rows = min(h, span + 2 * R)
    while rows > 0 and ring + _a128(rows * w * p["fpad"] * 2) > smem_max:
        rows -= 1
    p.update(fwd_wg=wg, fwd_onb=onb, fwd_opasses=-(-O // (96 * onb)), fwd_R=R, fwd_rows=rows,
             fwd_tiles=-(-P // (64 * wg)))
    fwd_smem = _a128(rows * w * p["fpad"] * 2) + ring

    ks = _up(O, 16) // 16
    kc = min(ks, 18)

    def fixed1_of(wg1, gtile, sidx):
        gbytes = _a128(64 * wg1 * (16 * ks + 8) * 2) if gtile else 2 * _a128(64 * wg1 * (16 * kc + 8) * 2)
        return gbytes + 2 * 16 * kc * 32 * 2 + (_a128(2 * 64 * wg1 * L * 4) if sidx else 0)
    tries = [(1 if b * -(-P // 128) < sms else 2, 1, 1), (1, 1, 1), (1, 1, 0), (1, 0, 1), (1, 0, 0)]
    wg1, gtile, sidx = next((t for t in tries if fixed1_of(*t) <= smem_max), tries[-1])
    fixed1 = fixed1_of(wg1, gtile, sidx)

    def band1(r):
        return _a128(r * w * 32 * 2)
    span1 = max_span(P, w, 64 * wg1, 64 * wg1)
    R1 = 6 if w >= 48 else 4
    while R1 > 0 and fixed1 + band1(min(h, span1 + 2 * R1)) > smem_max:
        R1 -= 1
    rows1 = min(h, span1 + 2 * R1)
    while rows1 > 0 and fixed1 + band1(rows1) > smem_max:
        rows1 -= 1
    p.update(p1_wg=wg1, p1_passes=-(-f // 32), p1_ks=ks, p1_R=R1, p1_rows=rows1,
             p1_tiles=-(-P // (64 * wg1)), p1_gtile=gtile, p1_sidx=sidx)

    nb = 32 if f <= 32 else 64 if f <= 64 else 96 if f <= 96 else 128
    mt = min(3, -(-O // 128), 2 if nb == 128 else 3)
    os_ = min(128 * mt, O) + 8
    fl = 2 if mt * nb <= 128 else 1
    fixed2 = 3 * fl * 2 * 64 * 4 + 3 * _a128(64 * os_ * 2) + 256 * mt + 2 * fl * 64 * nb * 2
    span2 = max_span(P, w, 64, 128)
    R2 = 6 if w >= 48 else 4
    while R2 > 0 and fixed2 + _a128(min(h, span2 + 2 * R2) * w * nb * 2) > smem_max:
        R2 -= 1
    rows2 = min(h, span2 + 2 * R2)
    if fixed2 + _a128(rows2 * w * nb * 2) > smem_max:
        rows2 = 0
    p.update(p2_nb=nb, p2_fpasses=-(-f // nb), p2_mt=mt, p2_opasses=-(-O // (128 * mt)),
             p2_os=os_, p2_R=R2, p2_rows=rows2, p2_parts=n_slices // b, p2_fl=fl,
             fwd_smem=fwd_smem, p1_smem=band1(rows1) + fixed1,
             p2_smem=_a128(rows2 * w * nb * 2) + fixed2,
             fwd_blocks=count(), p1_blocks=b * -(-P // (64 * wg1)),
             p2_blocks=-(-L // fl) * n_slices * -(-f // nb) * -(-O // (128 * mt)))
    return p


def geometry(lib, b, P, L, h, w, f, O, n_slices=None):
    r"""The bf16 kernels' plan on the current card from ``lib``'s
    ``vp_warp_ret_geometry``, a dict of :data:`GEOMETRY_KEYS`."""
    n_slices = n_slices or slices(b, P, L, torch.cuda.get_device_properties(0).multi_processor_count)
    out = (ctypes.c_int64 * len(GEOMETRY_KEYS))()
    fn = lib.vp_warp_ret_geometry
    fn.argtypes = [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_int64)]
    fn.restype = ctypes.c_int
    err = fn(b, P, L, h, w, f, O, n_slices, out)
    if err:
        raise RuntimeError(f"vp_warp_ret_geometry failed ({err})")
    return dict(zip(GEOMETRY_KEYS, out))


def args_at(gen, b, Lf, P, h, w, f, O):
    r"""K8's operands as ``chip_smoke.py``'s ``ret_args`` makes them, in bf16:
    indices a few pixels off each output pixel (N(0, 2)) with a tenth of the
    row components sent 0.6 of the image away, an image of order 1, ``ret``
    weights at the conv's init scale, a bias and a cotangent of 1e-2."""
    dev = torch.device("cuda")

    def rnd(*s, scale=1.0):
        return torch.randn(*s, generator=gen, device=dev) * scale

    px = torch.arange(P, device=dev)
    far = (rnd(b, P, Lf) > 1.2816).float() * torch.sign(rnd(b, P, Lf)) * 0.6 * h
    iy = (px // w).float().view(1, P, 1) + rnd(b, P, Lf, scale=2.0) + far
    ix = (px % w).float().view(1, P, 1) + rnd(b, P, Lf, scale=2.0)
    return (iy, ix, rnd(b, h, w, f).bfloat16(), rnd(Lf, f, O, scale=(Lf * f) ** -0.5).bfloat16(),
            rnd(O, scale=0.1), rnd(b, P, O, scale=1e-2).bfloat16())


def run_fwd(lib, iy, ix, img, w, bias, out):
    b, P, Lf = iy.shape
    _, h, wd, f = img.shape
    err = lib.vp_warp_ret_fwd(1, iy.data_ptr(), ix.data_ptr(), img.data_ptr(), w.data_ptr(),
                              bias.data_ptr(), out.data_ptr(), b, P, Lf, h, wd, f, w.shape[-1],
                              torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K8 forward variant launch failed ({err})")


def run_bwd(lib, iy, ix, img, w, g, outs, partial):
    r"""One backward call into ``outs`` = (d_img f32, zeroed here; d_iy; d_ix;
    d_w f32)."""
    b, P, Lf = iy.shape
    _, h, wd, f = img.shape
    d_img, d_iy, d_ix, d_w = outs
    d_img.zero_()
    err = lib.vp_warp_ret_bwd(1, iy.data_ptr(), ix.data_ptr(), img.data_ptr(), w.data_ptr(),
                              g.data_ptr(), d_img.data_ptr(), d_iy.data_ptr(), d_ix.data_ptr(),
                              partial.data_ptr(), d_w.data_ptr(), partial.shape[0], b, P, Lf, h,
                              wd, f, w.shape[-1], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K8 backward variant launch failed ({err})")


def rel(got, want):
    r"""Largest ``|got - want|`` over the largest ``|want|``; nan if any is nan."""
    diff = (got.float() - want.float()).abs()
    if bool(torch.isnan(diff).any()):
        return math.nan
    return diff.max().item() / (want.float().abs().max().item() or 1.0)


def _buffers(iy, img, w):
    b, P, Lf = iy.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    f32 = dict(dtype=torch.float32, device=img.device)
    return ([torch.empty(b, P, w.shape[-1], dtype=img.dtype, device=img.device)],
            [torch.empty(img.shape, **f32), torch.empty(iy.shape, **f32),
             torch.empty(iy.shape, **f32), torch.empty(w.shape, **f32)],
            torch.empty((slices(b, P, Lf, sms), *w.shape), **f32))


def check(libs, gen):
    r"""Each variant's largest error over :data:`REL_BF16` of out, d_iy, d_ix,
    d_img and d_w at the layer shapes and :data:`SMALL`; prints one line per
    shape and returns ``{name: largest error / its limit}``."""
    worst = {name: 0.0 for name in libs if name != "parent"}
    shapes = [(B, L, s * s, s, s, c, 3 * c) for s, c in SHAPES] + SMALL
    for b, Lf, P, h, w, f, O in shapes:
        iy, ix, img, wt, bias, g = args_at(gen, b, Lf, P, h, w, f, O)
        want = [warp_ret_reference(iy, ix, img, wt, bias),
                *warp_ret_backward_reference(iy, ix, img, wt, bias, g)[:4]]
        want[3] = want[3].float()  # d_img: the kernels' f32 sum, before the wrapper rounds it
        line = []
        for name in worst:
            (out,), grads, partial = _buffers(iy, img, wt)
            out.fill_(math.nan)
            try:  # a variant may refuse a shape: its outputs stay nan
                run_fwd(libs[name], iy, ix, img, wt, bias, out)
                run_bwd(libs[name], iy, ix, img, wt, g, grads, partial)
            except RuntimeError as e:
                print(f"[check] {name} at b={b} L={Lf} P={P} {h}x{w} f={f} O={O}: {e}")
                grads = [x.fill_(math.nan) for x in grads]
            torch.cuda.synchronize()
            got = [out, grads[1], grads[2], grads[0], grads[3]]
            errs = [rel(x, y) / REL_BF16 for x, y in zip(got, want)]
            ratio = 0.0
            for e in errs:
                ratio = _worse(ratio, e)
            worst[name] = _worse(worst[name], ratio)
            line.append(f"{name} " + "/".join(f"{e:.3g}" for e in errs))
        print(f"[check] b={b} L={Lf} P={P} {h}x{w} f={f} O={O} bf16: out/d_iy/d_ix/d_img/d_w error "
              f"over {REL_BF16:.3g} of the largest: " + ", ".join(line))
        del want, iy, ix, img, wt, bias, g
    for name, ratio in worst.items():
        tag = " (a fault: must fail)" if name in FAULTS else " (a race)" if name in RACES else ""
        print(f"[check] {name}: largest error {ratio:.3g} x the limit; "
              f"{'passes' if ratio <= 1.0 else 'fails'} the smoke's K8 check{tag}")
    return worst


def flow_ret_ms(gen, side, ch):
    r"""``warp_flow_ret`` forward, and forward and backward through autograd,
    eager, ms each, on flows and weights of the layer shape."""
    from vp_suite_tpu_torch.ops.grid_sample import warp_flow_ret
    dev = torch.device("cuda")
    flows = torch.randn(B, side, side, 2 * L, generator=gen, device=dev) * 2.0
    img = torch.randn(B, side, side, ch, generator=gen, device=dev).bfloat16()
    w = torch.randn(L * ch, 3 * ch, generator=gen, device=dev) * (L * ch) ** -0.5
    bias = torch.randn(3 * ch, generator=gen, device=dev) * 0.1
    g = torch.randn(B, side, side, 3 * ch, generator=gen, device=dev).bfloat16() * 1e-2
    leaves = [a.detach().requires_grad_() for a in (img, flows, w, bias)]
    fwd = event_ms(lambda: warp_flow_ret(img, flows, w, bias), warmup=2, iters=10)
    both = event_ms(lambda: torch.autograd.grad(warp_flow_ret(*leaves).view(g.shape), leaves, g),
                    warmup=2, iters=10)
    return fwd, both - fwd


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="a checkout of an earlier commit, whose K8 is timed too")
    ap.add_argument("variants", nargs="*",
                    help=f"any of {', '.join(EDITS)} (default: all; 'kernel': none)")
    args = ap.parse_args()
    unknown = [v for v in args.variants if v not in EDITS and v != "kernel"]
    if unknown:
        ap.error(f"unknown variants {unknown}")
    if not torch.cuda.is_available():
        raise SystemExit("k8_variants: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    sources = {"kernel": (variant_source("kernel"), build.CSRC)}
    sources.update({v: (variant_source(v), build.CSRC)
                    for v in (args.variants or EDITS) if v != "kernel"})
    if args.parent:
        pcsrc = args.parent.resolve() / "vp_suite_tpu_torch" / "csrc"
        sources["parent"] = ((pcsrc / "warp_ret.cu").read_text(), pcsrc)
    t0 = time.time()
    libs = build_variants(sources, _declare, "k8_variants")
    print(f"[build] {len(libs)} variants in {time.time() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, Lf, P, h, w, f, O in [(B, L, s * s, s, s, c, 3 * c) for s, c in SHAPES] + SMALL:
        got, want = geometry(libs["kernel"], b, P, Lf, h, w, f, O), plan(b, P, Lf, h, w, f, O)
        print(f"[plan] b={b} L={Lf} P={P} {h}x{w} f={f} O={O}: {got}"
              + ("" if got == want else f" (the Python mirror says {want})"))
    worst = check(libs, gen)
    bad = [n for n, r in worst.items() if n in FAULTS and r <= 1.0]
    order = (["parent"] if args.parent else []) + [n for n in libs if n != "parent"] \
        + ["kernel"] + (["parent"] if args.parent else [])
    totals = {}
    for side, ch in SHAPES:
        iy, ix, img, wt, bias, g = args_at(gen, B, L, side * side, side, side, ch, 3 * ch)
        (out,), grads, partial = _buffers(iy, img, wt)
        line = []
        for i, name in enumerate(order):
            fwd = event_ms(lambda: run_fwd(libs[name], iy, ix, img, wt, bias, out), warmup=2, iters=10)
            bwd = event_ms(lambda: run_bwd(libs[name], iy, ix, img, wt, g, grads, partial),
                           warmup=2, iters=10)
            key = f"{name} (again)" if name in ("parent", "kernel") and name in order[:i] else name
            tot = totals.setdefault(key, [0.0, 0.0])
            tot[0] += fwd
            tot[1] += bwd
            line.append(f"{name} {fwd:.3f} / {bwd:.3f}")
        flow_f, flow_b = flow_ret_ms(gen, side, ch)
        tot = totals.setdefault("warp_flow_ret (eager)", [0.0, 0.0])
        tot[0] += flow_f
        tot[1] += flow_b
        print(f"[time] {side}x{side} f={ch} O={3 * ch} b={B} L={L} bf16, ms per forward / backward "
              f"call: " + ", ".join(line) + f"; warp_flow_ret eager {flow_f:.3f} / {flow_b:.3f}")
        del iy, ix, img, wt, bias, g, out, grads, partial
        torch.cuda.empty_cache()
    print("[time] over the three shapes, forward / backward ms: "
          + ", ".join(f"{k} {v[0]:.3f} / {v[1]:.3f}" for k, v in totals.items()))
    if bad:
        raise SystemExit(f"k8_variants: the faults {bad} pass the smoke's K8 check")


if __name__ == "__main__":
    main()
