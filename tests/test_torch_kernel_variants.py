r"""The named variants of the scan kernels (``kernels/k3_variants.py`` for K3/K3s,
``kernels/k4_variants.py`` for K4) still apply to the sources as they stand.

Each variant is a set of text replacements in a kernel's source; an edit whose
text no longer occurs exactly once would build a variant that is not the one
its name says. These tests need no card: they only read the sources.
"""
import pytest

from vp_suite_tpu_torch.kernels import k3_variants, k4_variants

CASES = [pytest.param(k3_variants, "convlstm_scan.cu", name, id=f"K3-{name}") for name in k3_variants.EDITS] \
    + [pytest.param(k4_variants, "convlstm_scan_bwd.cu", name, id=f"K4-{name}") for name in k4_variants.EDITS]


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


def test_a_stale_anchor_raises():
    with pytest.raises(ValueError, match="occurs 0 times"):
        k3_variants.apply_edits("convlstm_scan.cu", {"stale": [("no such text", "x")]}, "stale")
