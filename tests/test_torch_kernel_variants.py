r"""The named variants of the scan kernels (``kernels/k3_variants.py`` for K3/K3s,
``kernels/k4_variants.py`` for K4) and of the warp backward
(``kernels/warp_bwd_variants.py``) still apply to the sources as they stand.

Each variant is a set of text replacements in a kernel's source; an edit whose
text no longer occurs exactly once would build a variant that is not the one
its name says. These tests need no card: they only read the sources (and count, on the CPU,
where the warp backward's taps land under a given tiling).
"""
import itertools
import math

import numpy as np
import pytest
import torch

from vp_suite_tpu_torch.kernels import k3_variants, k4_variants, warp_bwd_variants

CASES = [pytest.param(k3_variants, "convlstm_scan.cu", name, id=f"K3-{name}") for name in k3_variants.EDITS] \
    + [pytest.param(k4_variants, "convlstm_scan_bwd.cu", name, id=f"K4-{name}") for name in k4_variants.EDITS] \
    + [pytest.param(warp_bwd_variants, "warp_sample.cu", name, id=f"warp_bwd-{name}")
       for name in warp_bwd_variants.EDITS]


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
