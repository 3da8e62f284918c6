r"""Variants of the warp forward (``csrc/warp_sample.cu``'s ``warp_fwd_kernel``) side by side on one CUDA card.

    python3 -m vp_suite_tpu_torch.kernels.warp_fwd_variants [--parent DIR] [VARIANT ...]

Each variant is the warp library's source with one named edit (:data:`EDITS`),
compiled with :mod:`~vp_suite_tpu_torch.kernels.build`'s flags into
``kernels/_build/warp_fwd_variants/`` and called through the same C entry
(:mod:`~vp_suite_tpu_torch.kernels.k4_variants` builds them). The script holds
every variant to ``chip_smoke.py``'s warp-forward check: at EF-TrajGRU's three
layer shapes (b=32, L=13), in f32 and bf16, on the smoke's operands
(:func:`~vp_suite_tpu_torch.kernels.warp_bwd_variants.warp_args`: flows of a
few pixels, a tenth of the row and column indices sent 0.6 of the image away),
every output must lie within :data:`ATOL_F32` of ``warp_sample_reference``'s in
f32, and within one bf16 ulp of it plus :data:`ATOL_F32` in bf16. It then
times each variant in bf16 at the three shapes by CUDA-graph replay of the
launch, in turns: parent, kernel, variants, parent; a ``predict`` runs each
shape 15 times (and a train step 15 more). It times them on the smoke's
operands and on zero flows (``_flow_to_indices`` of zero flows, as
EF-TrajGRU's flow convs give them at initialisation: every tap in the band).
``--parent`` names a checkout of an earlier commit whose warp forward is timed
too. It also prints each shape's tiling and the share of the in-image taps
that leave their block's band. The timing-only variants (``no_*``) skip part
of the work and are wrong by design; the tunings (``plain_store``, ``tile4``,
``r4``, ``halves``, ``vpl1``, ``vpl4``, ``threads512``) must pass the check; the faults
(:data:`FAULTS`) must fail it; the race (:data:`RACES`) is reported.
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
from vp_suite_tpu_torch.kernels.warp_bwd_variants import graph_ms, out_of_band_share, warp_args
from vp_suite_tpu_torch.ops.grid_sample import _flow_to_indices
from vp_suite_tpu_torch.ops.warp import warp_sample_reference

#: chip_smoke.py's WARP_ATOL_F32: the same f32 formula, products summed in
#: another order, on values of order 1; in bf16 one ulp of the value on top
#: (both sides round an f32 sum of the same four products).
ATOL_F32 = 1e-5

_BAND_TEST = "      if (unsigned(px) < unsigned(band_px))  // in the band: shared memory\n"
_STORE = "      store_out(reinterpret_cast<VT*>(dst + int64_t(cs) * d.c + ch[u]), res);\n"
_LOOP_END = "  }\n}\n\n// The forward's tiling"
_UNITS = "    const int units = band_px * nv;\n"

#: name -> the (old, new) text replacements that make the variant; each old text
#: occurs exactly once in the kernel's source.
EDITS = {
    # timing only: no band (every tap read from global memory, in the new tiling); no output
    # write (the sums are still computed)
    "no_band": [("  g->rows = rows;\n", "  rows = 0;\n  g->rows = rows;\n")],
    "no_store": [(_STORE, "      for (int k = 0; k < int(sizeof(VT) / 4); ++k)\n"
                          "        sink ^= reinterpret_cast<const unsigned*>(&res)[k];\n"),
                 ("  float ny = 0.0f, nx = 0.0f;\n", "  float ny = 0.0f, nx = 0.0f;\n  unsigned sink = 0;\n"),
                 (_LOOP_END, "  }\n  if (sink == 0x9e3779b9u) *reinterpret_cast<unsigned*>(out) = sink;\n"
                             "}\n\n// The forward's tiling")],
    # tunings: plain stores instead of streaming ones; tiles of 4 rows; a band of 4 rows; two
    # channel passes, each a block with half the band (two blocks per SM at 64x64x64 in bf16);
    # one or up to four vectors of a sample per lane (sharing its taps); always 512 threads
    "plain_store": [("constexpr bool STREAM_STORES = true;", "constexpr bool STREAM_STORES = false;")],
    "tile4": [("constexpr int FWD_TILE_ROWS = 8;", "constexpr int FWD_TILE_ROWS = 4;")],
    "r4": [("  g->R = d.w >= 48 ? 6 : 4;", "  g->R = 4;")],
    "halves": [("  int passes = 1;\n", "  int passes = d.c >= 2 * V ? 2 : 1;\n")],
    "vpl1": [("constexpr int VPL_MAX = 2;", "constexpr int VPL_MAX = 1;")],
    "vpl4": [("constexpr int VPL_MAX = 2;", "constexpr int VPL_MAX = 4;")],
    "threads512": [("  g->threads = 2 * (*smem + 1024) > size_t(smem_sm) ? 1024 : 512;",
                    "  g->threads = 512;")],
    # faults: the band test admitting one row past the band (into one spare row of shared memory,
    # which is never filled); the band copied from one row below its start (short of the image's
    # end), so every tap read from it is one row off; the band's copy one row short; the race:
    # the wait on the band's copy dropped. Each stays inside the image and the band's shared
    # memory.
    "band_row_too_wide": [(_BAND_TEST, _BAND_TEST.replace("unsigned(band_px)", "unsigned(band_px + d.w)")),
                          ("  *smem = size_t(rows) * g->cw", "  *smem = size_t(rows + 1) * g->cw")],
    "band_start_off_by_one": [("    const T* from = src + int64_t(row0) * d.w * d.c;\n",
                               "    const T* from = src + int64_t(min(row0 + 1, d.h - q.rows)) * d.w * d.c;\n")],
    "no_copy_wait": [("    cp_async_wait_all();  // this thread's copies have landed\n", "")],
    "band_short": [(_UNITS, "    const int units = (band_px - d.w) * nv;\n")],
}
#: the variants that must fail the check
FAULTS = ("band_row_too_wide", "band_start_off_by_one", "band_short")
#: a race the check may not see: the barrier after the copies can come late enough that
#: they have all landed (a dropped cp.async wait passed on an H100 in some runs, as K3's and
#: K4's did)
RACES = ("no_copy_wait",)

B, L = 32, 13
#: EF-TrajGRU's layer shapes (side, channels), each 15 warp-forward launches a predict
SHAPES = [(64, 64), (32, 96), (16, 96)]
LAUNCHES_PER_SHAPE = 15
#: one H100 SXM: SMs, shared memory a block may opt into, shared memory of an SM
H100_LIMITS = (132, 232448, 233472)
GEOMETRY_KEYS = ("tile_px", "tiles", "R", "rows", "cw", "passes", "vpl", "V", "smem", "threads")


def variant_source(name: str) -> str:
    return apply_edits("warp_sample.cu", EDITS, name)


def _declare_fwd(lib, text):
    lib.vp_warp_sample_fwd.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 \
        + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.vp_warp_sample_fwd.restype = ctypes.c_int
    return lib


def geometry(lib, b, P, L, h, w, c, bf16):
    r"""The forward's tiling from ``lib``'s ``vp_warp_fwd_geometry`` (for
    vector-aligned operands on the current card), a dict of
    :data:`GEOMETRY_KEYS`."""
    out = (ctypes.c_int * len(GEOMETRY_KEYS))()
    fn = lib.vp_warp_fwd_geometry
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    err = fn(int(bf16), b, P, L, h, w, c, out)
    if err:
        raise RuntimeError(f"vp_warp_fwd_geometry failed ({err})")
    return dict(zip(GEOMETRY_KEYS, out))


def plan(b, P, h, w, c, bf16, limits=H100_LIMITS, vpl_max=2):
    r"""The tiling that ``csrc/warp_sample.cu``'s ``fwd_geometry`` computes for
    vector-aligned operands on a card of ``limits`` = (SMs, shared bytes a
    block may opt into, shared bytes of an SM), as :func:`geometry` returns
    it."""
    sms, smem_max, smem_sm = limits
    esize = 2 if bf16 else 4
    V = 16 // esize
    while V > 1 and c % V:
        V //= 2
    R = 6 if w >= 48 else 4

    def tile_px(rows):
        return min(rows * w, P)

    def band_bytes(rows, cw):
        return min(rows, h) * w * cw * esize

    def pass_cw(n):
        return -(-c // (n * V)) * V

    out_rows = 8
    while out_rows > 1 and b * -(-P // tile_px(out_rows)) < sms:
        out_rows //= 2
    passes = 1
    while band_bytes(out_rows + 2 * R, pass_cw(passes)) > smem_max and pass_cw(passes) > V:
        passes += 1
    cw = pass_cw(passes)
    while band_bytes(out_rows + 2 * R, cw) > smem_max and (R > 4 or out_rows > 1):
        if R > 4:
            R -= 1
        else:
            out_rows //= 2
    rows = min(h, out_rows + 2 * R)
    while rows > 0 and band_bytes(rows, cw) > smem_max:
        rows -= 1
    passes = -(-c // cw)
    vpl = vpl_max
    while vpl > 1 and ((cw // V) % vpl or ((c - (passes - 1) * cw) // V) % vpl):
        vpl //= 2
    smem = rows * cw * w * esize
    return dict(tile_px=tile_px(out_rows), tiles=-(-P // tile_px(out_rows)), R=R, rows=rows, cw=cw,
                passes=passes, vpl=vpl, V=V, smem=smem,
                threads=1024 if 2 * (smem + 1024) > smem_sm else 512)


def run(lib, iy, ix, img, out):
    r"""One launch of ``lib``'s forward into ``out``."""
    b, P, Lf = iy.shape
    _, h, w, c = img.shape
    err = lib.vp_warp_sample_fwd(int(img.dtype == torch.bfloat16), iy.data_ptr(), ix.data_ptr(),
                                 img.data_ptr(), out.data_ptr(), b, P, Lf, h, w, c,
                                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"warp forward variant launch failed ({err})")


def excess(got, want):
    r"""The largest ``|got - want|`` over its limit (:data:`ATOL_F32` in f32,
    one bf16 ulp of ``want`` plus :data:`ATOL_F32` in bf16); nan if any output
    is nan."""
    diff = (got.float() - want.float()).abs()
    if want.dtype == torch.bfloat16:
        mag = want.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
        limit = torch.exp2(torch.floor(torch.log2(mag)) - 7) + ATOL_F32
    else:
        limit = torch.full_like(diff, ATOL_F32)
    return math.nan if bool(torch.isnan(diff).any()) else (diff / limit).max().item()


def check(libs, gen):
    r"""Each variant's largest error over its limit at the three shapes in f32
    and bf16; prints one line per shape and dtype and returns ``{name: largest
    error / its limit}``."""
    worst = {name: 0.0 for name in libs if name != "parent"}
    for side, ch in SHAPES:
        iy, ix, img, _ = warp_args(gen, side, ch)
        for dt in (torch.float32, torch.bfloat16):
            im = img.to(dt)
            want = warp_sample_reference(iy, ix, im)
            line = []
            for name in worst:
                got = torch.full_like(want, math.nan)
                run(libs[name], iy, ix, im, got)
                torch.cuda.synchronize()
                ratio = excess(got, want)
                worst[name] = _worse(worst[name], ratio)
                line.append(f"{name} {ratio:.3g}")
            print(f"[check] {side}x{side}x{ch} b={B} L={L} {str(dt)[6:]}: largest error over its "
                  f"limit: " + ", ".join(line))
    for name, ratio in worst.items():
        tag = " (a fault: must fail)" if name in FAULTS else " (a race)" if name in RACES else ""
        passes = ratio <= 1.0  # nan fails
        print(f"[check] {name}: largest error {ratio:.3g} x the limit; "
              f"{'passes' if passes else 'fails'} the smoke's warp-forward check{tag}")
    return worst


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path,
                    help="a checkout of an earlier commit, whose warp forward is timed too")
    ap.add_argument("variants", nargs="*",
                    help=f"any of {', '.join(EDITS)} (default: all; 'kernel': none)")
    args = ap.parse_args()
    unknown = [v for v in args.variants if v not in EDITS and v != "kernel"]
    if unknown:
        ap.error(f"unknown variants {unknown}")
    if not torch.cuda.is_available():
        raise SystemExit("warp_fwd_variants: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    sources = {"kernel": (variant_source("kernel"), build.CSRC)}
    sources.update({v: (variant_source(v), build.CSRC)
                    for v in (args.variants or EDITS) if v != "kernel"})
    if args.parent:
        pcsrc = args.parent.resolve() / "vp_suite_tpu_torch" / "csrc"
        sources["parent"] = ((pcsrc / "warp_sample.cu").read_text(), pcsrc)
    t0 = time.time()
    libs = build_variants(sources, _declare_fwd, "warp_fwd_variants")
    print(f"[build] {len(libs)} variants in {time.time() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = check(libs, gen)
    bad = [n for n, r in worst.items() if n in FAULTS and r <= 1.0]
    order = (["parent"] if args.parent else []) + [n for n in libs if n != "parent"] \
        + (["parent"] if args.parent else [])
    totals = {}
    for side, ch in SHAPES:
        iy, ix, img, _ = warp_args(gen, side, ch)
        img = img.bfloat16()
        still = _flow_to_indices(img, torch.zeros(B, side, side, 2 * L, device=img.device))
        geom = geometry(libs["kernel"], B, side * side, L, side, side, ch, True)
        for label, (sy, sx) in (("smoke's flows", (iy, ix)), ("zero flows", still)):
            outside, total = out_of_band_share(sy, sx, side, side, geom)
            print(f"[geometry] {side}x{side}x{ch} bf16, {label}: {geom}; {outside} of {total} "
                  f"in-image taps ({outside / total:.2%}) outside their block's band")
            out = torch.empty(B, side * side, L, ch, dtype=img.dtype, device=img.device)
            line = []
            for i, name in enumerate(order):
                ms = graph_ms(lambda: run(libs[name], sy, sx, img, out))
                key = (label, f"{name} (again)" if name == "parent" and i else name)
                totals[key] = totals.get(key, 0.0) + LAUNCHES_PER_SHAPE * ms
                line.append(f"{name} {ms * 1e3:.1f}")
            print(f"[time] {side}x{side}x{ch} b={B} L={L} bf16, {label}, us per launch: "
                  + ", ".join(line))
    for label in ("smoke's flows", "zero flows"):
        print(f"[time] per EF-TrajGRU predict (45 launches), {label}: "
              + ", ".join(f"{k[1]} {v:.3f} ms" for k, v in totals.items() if k[0] == label))
    if bad:
        raise SystemExit(f"warp_fwd_variants: the faults {bad} pass the smoke's warp-forward check")


if __name__ == "__main__":
    main()
