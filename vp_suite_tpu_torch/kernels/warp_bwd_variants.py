r"""Variants of the warp backward (``csrc/warp_sample.cu``'s ``warp_bwd_kernel``) side by side on one CUDA card.

    python3 -m vp_suite_tpu_torch.kernels.warp_bwd_variants [--parent DIR] [VARIANT ...]

Each variant is the warp library's source with one named edit (:data:`EDITS`),
compiled with :mod:`~vp_suite_tpu_torch.kernels.build`'s flags into
``kernels/_build/warp_bwd_variants/`` and called through the same C entry
(:mod:`~vp_suite_tpu_torch.kernels.k4_variants` builds them). The script holds
every variant to ``chip_smoke.py``'s warp-backward check: at EF-TrajGRU's three
layer shapes (b=32, L=13), in f32 and bf16, on the smoke's operands
(:func:`warp_args`: flows of a few pixels, a tenth of the row and column
indices sent 0.6 of the image away), the largest error of ``d_iy``, ``d_ix``
and ``d_img`` over the largest of each against
``warp_sample_backward_reference`` must stay within :data:`TOL`. It then
times each variant in bf16 at the three shapes by CUDA-graph replay of the
launch with ``d_img``'s zeroing (what the wrapper adds around it, the zeroing,
is the same for all), in turns: parent, kernel, variants, parent; a train step
runs each shape 15 times. It times them on the smoke's operands and on zero
flows (``_flow_to_indices`` of zero flows, as EF-TrajGRU's flow convs give
them at initialisation: all L flows of a pixel sample the same four taps, the
case where concurrent adds meet most often). ``--parent`` names a checkout of
an earlier commit whose warp backward is timed too. It also prints each
shape's tiling and the share of the in-image taps that leave their block's
band (:func:`out_of_band_share`). The timing-only variants (``no_*``) skip
part of the work and are wrong by design; the other designs and tunings
(``shared_atomics``, ``neighbours``, ``threads*``, ``cw32``, ``tile4``,
``r4``) must pass the check; the faults (:data:`FAULTS`) must fail it.
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
from vp_suite_tpu_torch.kernels.k4_variants import apply_edits, build_variants
from vp_suite_tpu_torch.ops.grid_sample import _flow_to_indices
from vp_suite_tpu_torch.ops.warp import warp_sample_backward_reference

#: chip_smoke.py's WARP_GRAD_REL_F32 and WARP_GRAD_REL_BF16, relative to the
#: largest of each kind: sums over c and f32 atomics taken in another order;
#: in bf16 one flipped rounding of d_img (2^-7 of the largest) on top.
TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7 + 1e-5}

_WINDOW_ADD = "            add_window<V>(win + px * cw + j * V, gf, t.wt[k]);\n"
_BAND_TEST = "          if (unsigned(px) < unsigned(win_px))  // in the band: the shared window\n"
_FLUSH_ADD = "          atomicAdd(reinterpret_cast<float4*>(dst + int64_t(win_off + px) * d.c + c0 + cl), a);\n"

#: name -> the (old, new) text replacements that make the variant; each old text
#: occurs exactly once in the kernel's source.
EDITS = {
    # timing only: no window (every tap a global float4 atomic); no flush (nor zeroing between
    # chunks); no index gradients (so no tap is read: d_iy and d_ix come out 0); the taps in the
    # window dropped (the sample pass, its global atomics and the flush alone)
    "no_window": [("  q->rows = rows;\n", "  rows = 0;\n  q->rows = rows;\n")],
    "no_flush": [("    if (q.v4) {\n      const int units", "    if (d.c < 0)\n    if (q.v4) {\n      const int units")],
    "no_index_grads": [("          dy += gf[v] * (t.wx0 * (v10 - v00) + t.wx1 * (v11 - v01));\n"
                        "          dx += gf[v] * (t.wy0 * (v01 - v00) + t.wy1 * (v11 - v10));\n", ""),
                       ("      for (int o = G >> 1; o > 0; o >>= 1) {",
                        "      for (int o = G >> 1; d.c < 0 && o > 0; o >>= 1) {")],
    "no_window_adds": [(_WINDOW_ADD, "            {}\n")],
    # the window's adds as f32 atomicAdd (a compare-and-swap loop of one float each on this card)
    "shared_atomics": [("  if constexpr (V % 4 == 0) {\n    float4 old[V / 4]", "  if constexpr (V % 4 == 0 && V < 0) {\n    float4 old[V / 4]")],
    # the groups of a round take neighbouring samples (the L flows of one pixel) instead of samples
    # spread over the tile
    "neighbours": [("      const int i = r + grp * rounds;\n", "      const int i = r * n_grp + grp;\n")],
    # block size: always 512 or always 1024 threads
    "threads512": [("  q->threads = 2 * (*smem + 1024) > size_t(smem_sm) ? 1024 : 512;", "  q->threads = 512;")],
    "threads1024": [("  q->threads = 2 * (*smem + 1024) > size_t(smem_sm) ? 1024 : 512;", "  q->threads = 1024;")],
    # tuning: passes of at most 32 channels; tiles of 4 rows; a band of 4 rows
    "cw32": [("constexpr int CW_MAX = 64;", "constexpr int CW_MAX = 32;")],
    "tile4": [("constexpr int TILE_ROWS = 8;", "constexpr int TILE_ROWS = 4;")],
    "r4": [("  q->R = d.w >= 48 ? 6 : 4;", "  q->R = 4;")],
    # faults: the barrier before the flush dropped; the flush as a plain store instead of an
    # atomic add; the band test admitting one row past the window (into one spare row of shared
    # memory, which is never flushed)
    "no_sync_before_flush": [("    __syncthreads();  // the window is complete\n", "")],
    "flush_store": [(_FLUSH_ADD, "          *reinterpret_cast<float4*>(dst + int64_t(win_off + px) * d.c + c0 + cl) = a;\n")],
    "band_off_by_one": [(_BAND_TEST, _BAND_TEST.replace("unsigned(win_px)", "unsigned(win_px + d.w)")),
                        ("  *smem = size_t(rows) * d.w", "  *smem = size_t(rows + 1) * d.w")],
}
#: the variants that must fail the check
FAULTS = ("no_sync_before_flush", "flush_store", "band_off_by_one")

B, L = 32, 13
#: EF-TrajGRU's layer shapes (side, channels), each 15 warp-backward launches a train step
SHAPES = [(64, 64), (32, 96), (16, 96)]
LAUNCHES_PER_SHAPE = 15


def variant_source(name: str) -> str:
    return apply_edits("warp_sample.cu", EDITS, name)


def declare_warp_entry(lib, fn, pointers, text):
    r"""Declare ``fn`` of ``lib`` (built from ``text``): a dtype flag,
    ``pointers`` pointers, the sizes, ``row0`` where the source takes it, the
    stream. A ``--parent`` source from before ``row0`` has no such argument;
    this check and :func:`row0_args` can go once no compared tree is that old."""
    lib.row0 = "int row0" in text
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * pointers \
        + [ctypes.c_int] * (7 if lib.row0 else 6) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def row0_args(lib):
    r"""The ``row0`` argument (0: output pixels from the image's top) where
    ``lib`` takes one (:func:`declare_warp_entry`)."""
    return [0] if lib.row0 else []


def _declare_bwd(lib, text):
    return declare_warp_entry(lib, lib.vp_warp_sample_bwd, 7, text)


def geometry(lib, b, P, L, h, w, c, bf16):
    r"""The backward's tiling from ``lib``'s ``vp_warp_bwd_geometry`` (for
    vector-aligned operands on the current card): ``{tile_px, tiles, R, rows,
    G, cw, V, smem, threads}``."""
    out = (ctypes.c_int * 9)()
    fn = lib.vp_warp_bwd_geometry
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    err = fn(int(bf16), b, P, L, h, w, c, out)
    if err:
        raise RuntimeError(f"vp_warp_bwd_geometry failed ({err})")
    return dict(zip(("tile_px", "tiles", "R", "rows", "G", "cw", "V", "smem", "threads"), out))


def out_of_band_share(iy, ix, h, w, geom, row0=0):
    r"""``(taps outside their block's window, taps inside the image)`` of the
    samples ``iy``, ``ix`` ``[b, P, L]`` under the tiling ``geom``, for output
    pixels that start at image row ``row0`` (the launch's): the block of
    output pixel p holds image rows ``[first, first + rows)`` with ``first =
    max(0, min(row0 + p0 // w - R, h - rows))``, p0 the first pixel of p's
    tile. A tap in the image and outside that window is added to global
    memory directly (read from it, in the forward); only taps in the image
    are counted."""
    P = iy.shape[1]
    tile_px, R, rows = geom["tile_px"], geom["R"], geom["rows"]
    p0 = torch.arange(P, device=iy.device) // tile_px * tile_px
    first = (row0 + p0 // w - R).clamp(max=h - rows).clamp(min=0).view(1, P, 1)
    y0, x0 = torch.floor(iy.float()), torch.floor(ix.float())
    outside = total = 0
    for y in (y0, y0 + 1):
        in_y = (y >= 0) & (y <= h - 1)
        in_band = (y >= first) & (y < first + rows)
        for x in (x0, x0 + 1):
            valid = in_y & (x >= 0) & (x <= w - 1)
            total += int(valid.sum())
            outside += int((valid & ~in_band).sum())
    return outside, total


def warp_args(gen, side, ch, b=B):
    r"""``chip_smoke.py``'s ``warp_args`` in f32: ``(iy, ix, img, g)``,
    indices N(0, 2) pixels off each output pixel, a tenth of them sent 0.6 of
    the image away; an image; a cotangent of the size a mean-type loss hands
    down."""
    dev = torch.device("cuda")

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    P = side * side
    grid = torch.arange(P, device=dev)
    idx = []
    for o in ((grid // side).float().view(1, P, 1), (grid % side).float().view(1, P, 1)):
        far = (rnd(b, P, L) > 1.2816).float()
        side_sign = torch.sign(rnd(b, P, L))
        idx.append(o + rnd(b, P, L, scale=2.0) + far * side_sign * 0.6 * side)
    return (*idx, rnd(b, side, side, ch), rnd(b, P, L, ch, scale=1e-2))


def run(lib, iy, ix, img, g, out):
    r"""One launch of ``lib``'s backward into ``out = (d_img, d_iy, d_ix)``,
    with ``d_img`` zeroed first."""
    d_img, d_iy, d_ix = out
    b, P, Lf = iy.shape
    _, h, w, c = img.shape
    d_img.zero_()
    err = lib.vp_warp_sample_bwd(int(img.dtype == torch.bfloat16), iy.data_ptr(), ix.data_ptr(),
                                 img.data_ptr(), g.data_ptr(), d_img.data_ptr(), d_iy.data_ptr(),
                                 d_ix.data_ptr(), b, P, Lf, h, w, c, *row0_args(lib),
                                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"warp backward variant launch failed ({err})")


def outputs(iy, img):
    return (torch.empty(img.shape, dtype=torch.float32, device=img.device),
            torch.empty(iy.shape, dtype=torch.float32, device=img.device),
            torch.empty(iy.shape, dtype=torch.float32, device=img.device))


def graph_ms(fn, iters=20):
    r"""Mean device time of ``fn()`` in ms, replayed from a CUDA graph of
    ``iters`` calls (``chip_smoke.py``'s ``graph_ms``)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    for _ in range(2):
        graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * iters)


def check(libs, gen):
    r"""Each variant's largest error over the three shapes in f32 and bf16,
    relative to :data:`TOL`; prints one line per shape and dtype and returns
    ``{name: largest error / its limit}``."""
    worst = {name: 0.0 for name in libs if name != "parent"}
    for side, ch in SHAPES:
        base = warp_args(gen, side, ch)
        for dt in (torch.float32, torch.bfloat16):
            iy, ix, img, g = base[0], base[1], base[2].to(dt), base[3].to(dt)
            want = warp_sample_backward_reference(iy, ix, img, g)
            line = []
            for name in worst:
                out = outputs(iy, img)
                run(libs[name], iy, ix, img, g, out)
                torch.cuda.synchronize()
                got = (out[1], out[2], out[0].to(dt))
                errs = [(q.float() - w.float()).abs().max().item() / (w.float().abs().max().item() or 1.0)
                        for q, w in zip(got, want)]
                ratio = math.nan if any(map(math.isnan, errs)) else max(errs) / TOL[dt]
                worst[name] = _worse(worst[name], ratio)
                line.append(f"{name} " + "/".join(f"{e:.3g}" for e in errs))
            print(f"[check] {side}x{side}x{ch} b={B} L={L} {str(dt)[6:]}: d_iy/d_ix/d_img error over "
                  f"the largest (tol {TOL[dt]:.3g}): " + ", ".join(line))
    for name, ratio in worst.items():
        tag = " (a fault: must fail)" if name in FAULTS else ""
        passes = ratio <= 1.0  # nan fails
        print(f"[check] {name}: largest error {ratio:.3g} x the limit; "
              f"{'passes' if passes else 'fails'} the smoke's warp-backward check{tag}")
    return worst


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path,
                    help="a checkout of an earlier commit, whose warp backward is timed too")
    ap.add_argument("variants", nargs="*",
                    help=f"any of {', '.join(EDITS)} (default: all; 'kernel': none)")
    args = ap.parse_args()
    unknown = [v for v in args.variants if v not in EDITS and v != "kernel"]
    if unknown:
        ap.error(f"unknown variants {unknown}")
    if not torch.cuda.is_available():
        raise SystemExit("warp_bwd_variants: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    sources = {"kernel": (variant_source("kernel"), build.CSRC)}
    sources.update({v: (variant_source(v), build.CSRC)
                    for v in (args.variants or EDITS) if v != "kernel"})
    if args.parent:
        pcsrc = args.parent.resolve() / "vp_suite_tpu_torch" / "csrc"
        sources["parent"] = ((pcsrc / "warp_sample.cu").read_text(), pcsrc)
    t0 = time.time()
    libs = build_variants(sources, _declare_bwd, "warp_bwd_variants")
    print(f"[build] {len(libs)} variants in {time.time() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = check(libs, gen)
    bad = [n for n, r in worst.items() if n in FAULTS and r <= 1.0]
    order = (["parent"] if args.parent else []) + [n for n in libs if n != "parent"] \
        + (["parent"] if args.parent else [])
    totals = {}
    for side, ch in SHAPES:
        iy, ix, img, g = warp_args(gen, side, ch)
        img, g = img.bfloat16(), g.bfloat16()
        still = _flow_to_indices(img, torch.zeros(B, side, side, 2 * L, device=img.device))
        geom = geometry(libs["kernel"], B, side * side, L, side, side, ch, True)
        for label, (sy, sx) in (("smoke's flows", (iy, ix)), ("zero flows", still)):
            outside, total = out_of_band_share(sy, sx, side, side, geom)
            print(f"[geometry] {side}x{side}x{ch} bf16, {label}: {geom}; {outside} of {total} "
                  f"in-image taps ({outside / total:.2%}) outside their block's band")
            out = outputs(sy, img)
            line = []
            for i, name in enumerate(order):
                ms = graph_ms(lambda: run(libs[name], sy, sx, img, g, out))
                key = (label, f"{name} (again)" if name == "parent" and i else name)
                totals[key] = totals.get(key, 0.0) + LAUNCHES_PER_SHAPE * ms
                line.append(f"{name} {ms * 1e3:.1f}")
            print(f"[time] {side}x{side}x{ch} b={B} L={L} bf16, {label}, us per launch (with "
                  f"d_img's zeroing): " + ", ".join(line))
    for label in ("smoke's flows", "zero flows"):
        print(f"[time] per EF-TrajGRU train step (45 launches), {label}: "
              + ", ".join(f"{k[1]} {v:.3f} ms" for k, v in totals.items() if k[0] == label))
    if bad:
        raise SystemExit(f"warp_bwd_variants: the faults {bad} pass the smoke's warp-backward check")


if __name__ == "__main__":
    main()
