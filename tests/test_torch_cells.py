r"""The port's ConvLSTM gate block against the JAX package's.

``vp_suite_tpu_torch.ops.cells.convlstm_gate_reference`` (what the port's
``convlstm_gate_fuse`` computes on CPU tensors, and what its Triton kernel is
held against on the card) must match the JAX Pallas kernel, run here in
interpret mode, and the JAX plain reference. f32: atol 1e-5. bf16 inputs:
both sides compute in f32 and round once, so they agree to 1 bf16 ulp.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vp_suite_tpu_torch.ops import cells

torch.set_num_threads(1)


@pytest.fixture()
def pallas_interpret():
    orig = pl.pallas_call

    def patched(*args, **kw):
        kw["interpret"] = True
        return orig(*args, **kw)

    pl.pallas_call = patched
    import vp_suite_tpu.ops.pallas_cells as pc
    importlib.reload(pc)
    yield pc
    pl.pallas_call = orig
    importlib.reload(pc)


def _data(c=8, h=16, w=16, b=2, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, h, w, 4 * c), (b, h, w, c), (h, w, c), (h, w, c), (h, w, c))]


def _bf16_ulp(x):
    r"""Spacing of bf16 numbers at |x| (8 significant bits)."""
    x = np.maximum(np.abs(x.astype(np.float64)), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def test_gate_reference_matches_jax_f32(pallas_interpret):
    pc = pallas_interpret
    arrs = _data()
    h_fuse, c_fuse = pc.convlstm_gate_fuse(*map(jnp.asarray, arrs))
    h_ref, c_ref = pc.convlstm_gate_reference(*map(jnp.asarray, arrs))
    h, c = cells.convlstm_gate_reference(*map(torch.from_numpy, arrs))
    assert h.dtype == c.dtype == torch.float32
    for ours, theirs in ((h, h_fuse), (c, c_fuse), (h, h_ref), (c, c_ref)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0, atol=1e-5)


def test_gate_reference_matches_jax_bf16(pallas_interpret):
    pc = pallas_interpret
    arrs = _data(seed=1)
    h_fuse, c_fuse = pc.convlstm_gate_fuse(*(jnp.asarray(a, jnp.bfloat16) for a in arrs))
    h, c = cells.convlstm_gate_reference(*(torch.from_numpy(a).bfloat16() for a in arrs))
    assert h.dtype == c.dtype == torch.bfloat16
    for ours, theirs in ((h, h_fuse), (c, c_fuse)):
        ours = ours.float().numpy()
        theirs = np.asarray(theirs.astype(jnp.float32))
        assert np.all(np.abs(ours - theirs) <= _bf16_ulp(theirs)), \
            np.abs(ours - theirs).max()


def test_gate_fuse_on_cpu_is_the_reference():
    arrs = [torch.from_numpy(a) for a in _data(c=4, h=8, w=8, seed=2)]
    before = cells.convlstm_gate_fuse.launches
    for got, want in zip(cells.convlstm_gate_fuse(*arrs), cells.convlstm_gate_reference(*arrs)):
        assert torch.equal(got, want)
    assert cells.convlstm_gate_fuse.launches == before


@pytest.mark.parametrize("bad", ["gates", "peephole", "rank"])
def test_gate_fuse_rejects_bad_shapes(bad):
    gates, c, wci, wcf, wco = (torch.from_numpy(a) for a in _data(c=4, h=8, w=8))
    if bad == "gates":
        gates = gates[..., :-1]
    elif bad == "peephole":
        wco = wco[:-1]
    else:
        c = c[0]
    with pytest.raises(ValueError):
        cells.convlstm_gate_fuse(gates, c, wci, wcf, wco)
