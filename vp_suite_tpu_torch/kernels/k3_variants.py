r"""Variants of K3's bf16 kernel (``csrc/convlstm_scan.cu``, K3 and K3s) side by side on one CUDA card.

    python3 -m vp_suite_tpu_torch.kernels.k3_variants [--parent DIR] [VARIANT ...]

Each variant is the forward scan's source with one named edit (:data:`EDITS`),
compiled with :mod:`~vp_suite_tpu_torch.kernels.build`'s flags into
``kernels/_build/k3_variants/`` and called through the same C entry
(:mod:`~vp_suite_tpu_torch.kernels.k4_variants` builds them). The script holds
every variant to ``chip_smoke.py``'s K3 check: at EF-ConvLSTM's three cell
shapes (b=32, bf16), in decode mode (T=10) and with an input half (T=5), the
largest error of ``h_seq`` and ``c_last`` (K3) and of ``z`` and ``c_prev``
(K3s) against ``convlstm_scan_forward_reference`` must stay within
:data:`ATOL`, and K3s must leave ``h_seq`` and ``c_last`` bit for bit as K3
gives them. It then times K3 and K3s with CUDA events at the fused path's six
launch shapes, in turns: parent, kernel, variants, parent. ``--parent`` names a
checkout of an earlier commit whose forward scan is timed too. The
timing-only variants (``no_*``) skip part of the work and are wrong by design;
the faults (:data:`FAULTS`) must fail the check; ``ring_no_wait`` asks whether
the check sees a dropped ``cp.async`` wait at all.
"""
import argparse
import ctypes
import math
import subprocess
import time
from pathlib import Path

import torch

from vp_suite_tpu_torch.kernels import build
from vp_suite_tpu_torch.kernels.k4_variants import apply_edits, build_variants, event_ms
from vp_suite_tpu_torch.ops.convlstm import convlstm_scan_forward_reference

#: chip_smoke.py's SCAN_ATOL_BF16: h is rounded to bf16 every step, and a sum
#: taken in another order flips some roundings by one ulp.
ATOL = 3e-2

_PRODUCTS = """      if (chunk * STAGE_CH + 16 < enc)
        stage_products<NC, 2>(acc, stage, sW, row, lane, 4 * chunk, kq_n);
      else  // a half stage: enc is an odd multiple of 16
        stage_products<NC, 1>(acc, stage, sW, row, lane, 4 * chunk, kq_n);
"""
_FETCH = [("      if (s < n_items) fetch(s);", "      if (p.T < 0) fetch(s);"),
          ("      if (it + STAGES - 1 < n_items) fetch(it + STAGES - 1);",
           "      if (p.T < 0) fetch(it + STAGES - 1);")]

#: name -> the (old, new) text replacements that make the variant; each old text
#: occurs exactly once in the kernel's source.
EDITS = {
    # no L2 prefetch of the epilogue's rows when a tile starts
    "no_l2_prefetch": [("        lt.prefetch(p, t, lane);  // the epilogue's rows start on their way\n", "")],
    # timing only: skip the cell-update epilogue
    "no_epilogue": [("      if (chunk == spt - 1) lt.finish(p, t, j0, lane, acc, sBias);",
                     "      if (chunk == spt - 1 && p.T < 0) lt.finish(p, t, j0, lane, acc, sBias);")],
    # timing only: skip the A fragments and the products
    "no_products": [(_PRODUCTS, "      if (p.T < 0) {\n" + _PRODUCTS + "      }\n")],
    # timing only: skip the ring's copies (the products read stale stages)
    "no_ring_copies": _FETCH,
    # faults: the transposed conv's flipped taps; the stage consumed is the one
    # refilled in the same iteration
    "flipped_taps": [("load_a_at(a[k][tap], stage, row, tap / 3, tap % 3, 16 * k, lane)",
                      "load_a_at(a[k][tap], stage, row, 2 - tap / 3, 2 - tap % 3, 16 * k, lane)")],
    "ring_ahead": [("      const bf16* stage = ring + (it % STAGES) * (STAGE_BYTES / sizeof(bf16));",
                    "      const bf16* stage = ring + ((it + STAGES - 1) % STAGES) * (STAGE_BYTES / sizeof(bf16));")],
    # a race, not a fault the check must see: the ring's cp.async wait dropped
    "ring_no_wait": [("      cp_async_wait<STAGES - 2>();  // this thread's copies of stage `it` have landed\n", "")],
}
#: the variants that must fail the check
FAULTS = ("flipped_taps", "ring_ahead")

#: the fused path's scan launches (T, b, sh, sw, enc, with input half), in chip_smoke.py's order
SHAPES = [(5, 32, 64, 64, 64, True), (5, 32, 32, 32, 96, True), (5, 32, 16, 16, 96, True),
          (10, 32, 16, 16, 96, False), (10, 32, 32, 32, 96, True), (10, 32, 64, 64, 64, True)]
#: chip_smoke.py's K3 check: each cell shape in decode mode (T=10) and with an input half (T=5)
CHECK = [(T, 32, s, s, enc, with_x) for s, enc in ((64, 64), (32, 96), (16, 96))
         for T, with_x in ((10, False), (5, True))]


def variant_source(name: str) -> str:
    return apply_edits("convlstm_scan.cu", EDITS, name)


def _declare_fwd(lib, text):
    lib.vp_convlstm_scan_fwd.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 11 \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.vp_convlstm_scan_fwd.restype = ctypes.c_int
    return lib


def _worse(a, b):
    r"""The larger of two errors, nan above all."""
    return math.nan if math.isnan(a) or math.isnan(b) else max(a, b)


def inputs(shape, gen):
    r"""``chip_smoke.py``'s ``scan_args`` in bf16: ``(i2h or None, h0, c0, w, bias, wci, wcf, wco)``."""
    T, b, sh, sw, enc, with_x = shape
    dev = torch.device("cuda")

    def rnd(*s, scale=1.0):
        return (torch.randn(*s, generator=gen, device=dev) * scale).to(torch.bfloat16)

    return (rnd(T, b, sh, sw, 4 * enc, scale=0.3) if with_x else None, rnd(b, sh, sw, enc, scale=0.3),
            rnd(b, sh, sw, enc, scale=0.3), rnd(3, 3, enc, 4 * enc, scale=(9 * enc) ** -0.5),
            rnd(4 * enc, scale=0.1).float(), *[rnd(sh, sw, enc, scale=0.1) for _ in range(3)])


class Outputs:
    r"""A launch's outputs, allocated once: ``h_seq``, the f32 cell and, with
    ``save``, ``z`` and ``c_prev``."""

    def __init__(self, a, T, save):
        b, sh, sw, enc = a[1].shape
        self.h_seq = torch.empty(T, b, sh, sw, enc, dtype=torch.bfloat16, device=a[1].device)
        self.c = torch.empty(b, sh, sw, enc, device=a[1].device)
        self.z = torch.empty(T, b, sh, sw, 4 * enc, dtype=torch.bfloat16, device=a[1].device) \
            if save else None
        self.c_prev = torch.empty_like(self.h_seq) if save else None


def run(lib, a, out):
    r"""One launch of ``lib``'s forward scan on inputs ``a`` into ``out``."""
    i2h, h0, c0, w, bias, wci, wcf, wco = a
    T, b, sh, sw, enc = out.h_seq.shape
    out.c.copy_(c0)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = lib.vp_convlstm_scan_fwd(1, ptr(i2h), h0.data_ptr(), out.c.data_ptr(), w.data_ptr(),
                                   bias.data_ptr(), wci.data_ptr(), wcf.data_ptr(), wco.data_ptr(),
                                   out.h_seq.data_ptr(), ptr(out.z), ptr(out.c_prev), T, b, sh, sw,
                                   enc, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K3 variant launch failed ({err})")


def check(libs, gen):
    r"""Each variant's largest errors over :data:`CHECK`; prints one line per
    shape and returns ``{name: (largest error, bit-identical everywhere)}``."""
    worst = {name: (0.0, True) for name in libs if name != "parent"}
    for shape in CHECK:
        a = inputs(shape, gen)
        T = shape[0]
        want = convlstm_scan_forward_reference(*a, seq_len=T, save_gates=True)
        line = []
        for name in worst:
            k3, k3s = Outputs(a, T, False), Outputs(a, T, True)
            run(libs[name], a, k3)
            run(libs[name], a, k3s)
            torch.cuda.synchronize()
            got = (k3.h_seq, k3.c.bfloat16(), k3s.z, k3s.c_prev, k3s.h_seq, k3s.c.bfloat16())
            err = 0.0
            for g, w in zip(got, want[:2] + want[2:] + want[:2]):
                err = _worse(err, (g.float() - w.float()).abs().max().item())
            same = torch.equal(k3.h_seq, k3s.h_seq) and torch.equal(k3.c, k3s.c)
            worst[name] = (_worse(worst[name][0], err), worst[name][1] and same)
            line.append(f"{name} {err:.3g}{'' if same else ' (K3s differs from K3)'}")
        print(f"[check] {shape[:5]} {'with i2h' if shape[5] else 'decode'}: largest error of h_seq, "
              "c_last, z, c_prev: " + ", ".join(line))
    for name, (err, same) in worst.items():
        passes = err <= ATOL and same  # nan fails
        tag = " (a fault: must fail)" if name in FAULTS else ""
        print(f"[check] {name}: largest error {err:.3g} = {err / ATOL:.3g} x the limit {ATOL}, "
              f"K3s bit-identical to K3: {same}; {'passes' if passes else 'fails'} the smoke's K3 "
              f"check{tag}")
    return worst


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="a checkout of an earlier commit, whose K3 is timed too")
    ap.add_argument("variants", nargs="*",
                    help=f"any of {', '.join(EDITS)} (default: all; 'kernel': none)")
    args = ap.parse_args()
    unknown = [v for v in args.variants if v not in EDITS and v != "kernel"]
    if unknown:
        ap.error(f"unknown variants {unknown}")
    if not torch.cuda.is_available():
        raise SystemExit("k3_variants: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    sources = {"kernel": (variant_source("kernel"), build.CSRC)}
    sources.update({v: (variant_source(v), build.CSRC)
                    for v in (args.variants or EDITS) if v != "kernel"})
    if args.parent:
        pcsrc = args.parent.resolve() / "vp_suite_tpu_torch" / "csrc"
        sources["parent"] = ((pcsrc / "convlstm_scan.cu").read_text(), pcsrc)
    t0 = time.time()
    libs = build_variants(sources, _declare_fwd, "k3_variants")
    print(f"[build] {len(libs)} variants in {time.time() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = check(libs, gen)
    bad = [n for n, (err, same) in worst.items() if n in FAULTS and err <= ATOL and same]
    order = (["parent"] if args.parent else []) + [n for n in libs if n != "parent"] \
        + (["parent"] if args.parent else [])
    totals = {}
    for shape in SHAPES:
        a = inputs(shape, gen)
        for form, save in (("K3", False), ("K3s", True)):
            out = Outputs(a, shape[0], save)
            line = []
            for i, name in enumerate(order):
                ms = event_ms(lambda: run(libs[name], a, out))
                key = (form, f"{name} (again)" if name == "parent" and i else name)
                totals[key] = totals.get(key, 0.0) + ms
                line.append(f"{name} {ms:.3f}")
            print(f"[time] {form} {shape[:5]} {'with i2h' if shape[5] else 'decode'} ms per launch: "
                  + ", ".join(line))
    for form, per in (("K3", "predict"), ("K3s", "train step")):
        print(f"[time] {form} per fused {per} (the six launches): "
              + ", ".join(f"{k[1]} {v:.3f} ms" for k, v in totals.items() if k[0] == form))
    if bad:
        raise SystemExit(f"k3_variants: the faults {bad} pass the smoke's K3 check")


if __name__ == "__main__":
    main()
