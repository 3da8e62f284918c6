r"""The named variants of the scan kernels (``kernels/k3_variants.py`` for K3/K3s,
``kernels/k4_variants.py`` for K4) and of the warp backward and forward
(``kernels/warp_bwd_variants.py``, ``kernels/warp_fwd_variants.py``) still
apply to the sources as they stand.

Each variant is a set of text replacements in a kernel's source; an edit whose
text no longer occurs exactly once would build a variant that is not the one
its name says. These tests need no card: they only read the sources (and count, on the CPU,
where the warp's taps land under a given tiling, and which tiling the forward takes on an H100).
"""
import itertools
import math

import numpy as np
import pytest
import torch

from vp_suite_tpu_torch.kernels import k3_variants, k4_variants, warp_bwd_variants, warp_fwd_variants

CASES = [pytest.param(k3_variants, "convlstm_scan.cu", name, id=f"K3-{name}") for name in k3_variants.EDITS] \
    + [pytest.param(k4_variants, "convlstm_scan_bwd.cu", name, id=f"K4-{name}") for name in k4_variants.EDITS] \
    + [pytest.param(warp_bwd_variants, "warp_sample.cu", name, id=f"warp_bwd-{name}")
       for name in warp_bwd_variants.EDITS] \
    + [pytest.param(warp_fwd_variants, "warp_sample.cu", name, id=f"warp_fwd-{name}")
       for name in warp_fwd_variants.EDITS]


@pytest.mark.parametrize("tool,source,name", CASES)
def test_variant_edit_anchor_occurs_once(tool, source, name):
    kernel = tool.variant_source("kernel")
    assert kernel == tool.apply_edits(source, {}, name)   # "kernel" is the source as it stands
    for old, new in tool.EDITS[name]:
        assert old != new
        assert kernel.count(old) == 1, old
    edited = tool.variant_source(name)
    assert edited != kernel
    for _, new in tool.EDITS[name]:
        assert new == "" or new in edited


def test_k3_faults_are_named_variants():
    assert k3_variants.FAULTS and set(k3_variants.FAULTS) <= set(k3_variants.EDITS)


def test_warp_bwd_faults_are_named_variants():
    assert set(warp_bwd_variants.FAULTS) == {"no_sync_before_flush", "flush_store", "band_off_by_one"}
    assert set(warp_bwd_variants.FAULTS) <= set(warp_bwd_variants.EDITS)


def test_warp_fwd_faults_are_named_variants():
    assert set(warp_fwd_variants.FAULTS) == {"band_row_too_wide", "band_start_off_by_one",
                                             "band_short"}
    assert set(warp_fwd_variants.RACES) == {"no_copy_wait"}
    assert set(warp_fwd_variants.FAULTS + warp_fwd_variants.RACES) <= set(warp_fwd_variants.EDITS)


#: (b, P, h, w, c, bf16) -> what the forward's tiling must hold on an H100: bands of
#: 20 / 12 / 10 rows in 160 / 72 / 30 KB and 256 blocks at EF-TrajGRU's three layer shapes
#: in bf16, two vectors a lane; two passes of 32 channels in f32 at 64x64x64; one vector a
#: lane where c / V is odd; R shrunk and no band where not one row of 16 bytes a pixel fits;
#: a band placed by pixel index where P != h*w.
FWD_PLANS = {
    "64x64x64-bf16": ((32, 4096, 64, 64, 64, True),
                      dict(tile_px=512, tiles=8, R=6, rows=20, cw=64, passes=1, vpl=2, V=8,
                           smem=163840, threads=1024)),
    "32x32x96-bf16": ((32, 1024, 32, 32, 96, True),
                      dict(tile_px=128, tiles=8, R=4, rows=12, cw=96, passes=1, vpl=2, V=8,
                           smem=73728, threads=512)),
    "16x16x96-bf16": ((32, 256, 16, 16, 96, True),
                      dict(tile_px=32, tiles=8, R=4, rows=10, cw=96, passes=1, vpl=2, V=8,
                           smem=30720, threads=512)),
    "64x64x64-f32": ((32, 4096, 64, 64, 64, False),
                     dict(tile_px=512, tiles=8, R=6, rows=20, cw=32, passes=2, vpl=2, V=4,
                          smem=163840, threads=1024)),
    "32x32x96-f32": ((32, 1024, 32, 32, 96, False),
                     dict(tile_px=128, tiles=8, R=4, rows=12, cw=96, passes=1, vpl=2, V=4,
                          smem=147456, threads=1024)),
    "c20-bf16": ((2, 2560, 40, 64, 20, True),
                 dict(tile_px=64, tiles=40, R=6, rows=13, cw=20, passes=1, vpl=1, V=4,
                      smem=33280, threads=512)),
    "no-band": ((1, 30000, 2, 15000, 8, True),
                dict(tile_px=15000, tiles=2, R=4, rows=0, cw=8, passes=1, vpl=1, V=8,
                     smem=0, threads=512)),
    "P-not-hw": ((2, 130, 24, 40, 16, False),
                 dict(tile_px=40, tiles=4, R=4, rows=9, cw=16, passes=1, vpl=2, V=4,
                      smem=23040, threads=512)),
}


@pytest.mark.parametrize("case", list(FWD_PLANS))
def test_warp_fwd_plan_on_an_h100(case):
    args, want = FWD_PLANS[case]
    got = warp_fwd_variants.plan(*args)
    assert got == want
    b, P, h, w, c, bf16 = args
    assert got["smem"] <= warp_fwd_variants.H100_LIMITS[1]
    assert got["passes"] * got["cw"] >= c > (got["passes"] - 1) * got["cw"]
    assert (got["cw"] // got["V"]) % got["vpl"] == 0


def _out_of_band_loop(iy, ix, h, w, geom):
    r"""The count of :func:`warp_bwd_variants.out_of_band_share`, one tap at a time."""
    outside = total = 0
    b, P, L = iy.shape
    for bi, p, l in itertools.product(range(b), range(P), range(L)):
        p0 = p // geom["tile_px"] * geom["tile_px"]
        row0 = max(0, min(p0 // w - geom["R"], h - geom["rows"]))
        y0, x0 = math.floor(iy[bi, p, l]), math.floor(ix[bi, p, l])
        for y, x in itertools.product((y0, y0 + 1), (x0, x0 + 1)):
            if 0 <= y < h and 0 <= x < w:
                total += 1
                outside += not row0 <= y < row0 + geom["rows"]
    return outside, total


@pytest.mark.parametrize("h,w,P,tile_px,R,rows", [(10, 6, 60, 12, 2, 6), (10, 6, 60, 6, 1, 3),
                                                   (7, 5, 23, 10, 4, 7), (9, 4, 36, 8, 2, 0)],
                         ids=["band", "one-row-tiles", "ragged-P-whole-image", "no-window"])
def test_out_of_band_share_counts_each_tap(h, w, P, tile_px, R, rows):
    rng = np.random.default_rng(3)
    b, L = 2, 3
    iy = rng.normal(0.0, 3.0, (b, P, L)) + np.repeat(np.arange(P) // w, L).reshape(1, P, L)
    ix = rng.uniform(-2.0, w + 1.0, (b, P, L))
    iy, ix = (torch.from_numpy(a.astype(np.float32)) for a in (iy, ix))
    geom = dict(tile_px=tile_px, R=R, rows=rows)
    got = warp_bwd_variants.out_of_band_share(iy, ix, h, w, geom)
    assert got == _out_of_band_loop(iy.numpy(), ix.numpy(), h, w, geom)
    assert 0 < got[1] and (got[0] == got[1] if rows == 0 else got[0] < got[1])


def test_a_stale_anchor_raises():
    with pytest.raises(ValueError, match="occurs 0 times"):
        k3_variants.apply_edits("convlstm_scan.cu", {"stale": [("no such text", "x")]}, "stale")
