r"""The port's prebuilt-factor warp (``vp_suite_tpu_torch.ops.warp.warp_contract``)
and ``_onehot_factor`` against the JAX package's, on the CPU.

- ``warp_contract_reference`` equals JAX ``pallas_warp.warp_contract`` on the
  CPU (its einsum form) to 1e-4, on dense random factors, at 16x16 and on a
  ragged case (a 9x11 image, P = 50), and equals the TPU kernel K9a
  (``_warp_contract_pallas`` in Pallas interpret mode) at 16x16.
- ``WarpContractFunction``'s three gradients equal ``jax.vjp(warp_contract)``
  to 1e-4 and, with the plain backward, autograd of the plain forward; the
  plain backward equals K9b/K9c (``_warp_bwd_pallas`` in interpret mode) at
  16x16.
- ``_onehot_factor`` gives JAX's factors bit for bit, and ``warp_contract`` on
  one-hot factors is the port's ``warp_sample``.
- On CPU tensors no kernel is launched, and bad operands raise.

Layout, the JAX package's: ``A [b, L, P, h]``, ``Bm [b, L, P, w]``, ``img [b,
h, w, c]``, out ``[b, L, P, c]``.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vp_suite_tpu.ops import pallas_warp as pw
from vp_suite_tpu_torch.ops import warp
from vp_suite_tpu_torch.ops.grid_sample import _onehot_factor

jgs = importlib.import_module("vp_suite_tpu.ops.grid_sample")

torch.set_num_threads(1)

#: (h, w, P): a square image with P = h*w, and a ragged one with P != h*w.
SHAPES = {"16x16": (16, 16, 256), "ragged": (9, 11, 50)}
NAMES = ("d_A", "d_Bm", "d_img")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(seed, h, w, P, b=2, L=3, c=8):
    r"""Dense random factors, an image and a cotangent, as
    ``tests/test_pallas.py`` makes them."""
    rng = np.random.default_rng(seed)
    return [rng.random(s).astype(np.float32)
            for s in ((b, L, P, h), (b, L, P, w), (b, h, w, c), (b, L, P, c))]


def _interpret(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_reference_and_gradients_match_jax(shape):
    A, Bm, img, g = _inputs(0, *SHAPES[shape])

    def run(args, g):
        out, vjp = jax.vjp(pw.warp_contract, *args)
        return out, vjp(g)
    with jax.default_matmul_precision("highest"):
        want, want_grads = jax.jit(run)(tuple(map(jnp.asarray, (A, Bm, img))), jnp.asarray(g))
    args = [_t(a).requires_grad_() for a in (A, Bm, img)]
    got = warp.warp_contract(*args)
    assert got.shape == g.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-4)
    got.backward(_t(g))
    for a, w, name in zip(args, want_grads, NAMES):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), rtol=0, atol=1e-4, err_msg=name)


def test_reference_and_backward_match_the_pallas_kernels(monkeypatch):
    A, Bm, img, g = _inputs(1, *SHAPES["16x16"])
    _interpret(monkeypatch)
    jargs = tuple(map(jnp.asarray, (A, Bm, img)))
    with jax.default_matmul_precision("highest"):
        want = pw._warp_contract_pallas(*jargs)
        want_grads = pw._warp_bwd_pallas(*jargs, jnp.asarray(g))
    args = [_t(a) for a in (A, Bm, img)]
    np.testing.assert_allclose(warp.warp_contract_reference(*args).numpy(), np.asarray(want),
                               rtol=0, atol=1e-4)
    for q, w, name in zip(warp.warp_contract_backward_reference(*args, _t(g)), want_grads, NAMES):
        np.testing.assert_allclose(q.numpy(), np.asarray(w), rtol=0, atol=1e-4, err_msg=name)


def test_function_and_plain_backward_match_autograd_of_plain_forward():
    A, Bm, img, g = _inputs(2, *SHAPES["ragged"])
    args = [_t(a).requires_grad_() for a in (A, Bm, img)]
    want = torch.autograd.grad(warp.warp_contract_reference(*args), args, _t(g))
    through_fn = torch.autograd.grad(warp.warp_contract(*args), args, _t(g))
    plain = warp.warp_contract_backward_reference(*(a.detach() for a in args), _t(g))
    for a, w, q, d, name in zip(args, want, through_fn, plain, NAMES):
        assert d.dtype == q.dtype == torch.float32 and d.shape == q.shape == a.shape, name
        torch.testing.assert_close(q, w, rtol=0, atol=1e-5, msg=name)
        torch.testing.assert_close(d, w, rtol=0, atol=1e-5, msg=name)


def test_onehot_factors_match_jax_and_give_the_warp():
    rng = np.random.default_rng(3)
    b, L, h, w, c, P = 2, 3, 9, 11, 4, 50
    iy = (rng.random((b, L, P)) * (h + 4) - 2).astype(np.float32)
    ix = (rng.random((b, L, P)) * (w + 4) - 2).astype(np.float32)
    iy[0, 0, :3] = [-1.0, 0.0, h - 1.0]      # exact integers at and beyond the border
    img = rng.standard_normal((b, h, w, c)).astype(np.float32)
    for i, n in ((iy, h), (ix, w)):
        want = jgs._onehot_factor(jnp.asarray(i), n, jnp.float32)
        got = _onehot_factor(_t(i), n, torch.float32)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = warp.warp_contract(_onehot_factor(_t(iy), h, torch.float32),
                             _onehot_factor(_t(ix), w, torch.float32), _t(img))
    want = warp.warp_sample(_t(iy.transpose(0, 2, 1)), _t(ix.transpose(0, 2, 1)), _t(img))
    torch.testing.assert_close(got.transpose(1, 2), want, rtol=0, atol=1e-5)


def test_cpu_launches_no_kernel_and_bad_operands_raise():
    A, Bm, img, g = _inputs(4, *SHAPES["ragged"])
    warp.warp_contract_forward.launches = warp.warp_contract_backward.launches = 0
    args = [_t(a).requires_grad_() for a in (A, Bm, img)]
    warp.warp_contract(*args).backward(_t(g))
    assert warp.warp_contract_forward.launches == 0 and warp.warp_contract_backward.launches == 0
    a = [x.detach() for x in args]
    with pytest.raises(ValueError, match=r"A must be \[b, L, P, h\]"):
        warp.warp_contract(a[0][..., :-1], a[1], a[2])
    with pytest.raises(ValueError, match=r"Bm must be \[b, L, P, w\]"):
        warp.warp_contract(a[0], a[1][..., :-1], a[2])
    with pytest.raises(ValueError, match=r"g must be \[b, L, P, c\]"):
        warp.warp_contract_backward(*a, _t(g)[..., :-1])
    with pytest.raises(ValueError, match="runs on CPU or CUDA tensors"):
        warp.warp_contract_forward(*(x.to("meta") for x in a))
