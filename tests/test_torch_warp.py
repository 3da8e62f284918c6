r"""The port's multi-flow bilinear warp (``vp_suite_tpu_torch/ops/warp.py``)
and the grid-sample helpers around it (``ops/grid_sample.py``) against the
JAX package, on the CPU.

- ``warp_sample_reference`` equals JAX ``pallas_warp.warp_sample`` on the CPU
  (its exact one-hot einsum path) to 1e-5, with flows that cross the border;
  it equals the TPU band kernel K5 (``_warp_sample_pallas_band`` in Pallas
  interpret mode) on row indices that ``_clamp_rows`` has saturated, which are
  the inputs clamp mode gives K5, so the exact gather computes K5's function
  on K5's inputs; and it equals ``F.grid_sample``.
- ``WarpFunction``'s three gradients equal ``jax.vjp(warp_sample)`` to 1e-4,
  and the plain backward equals autograd of the plain forward.
- ``_flow_to_indices`` gives JAX's indices bit for bit (an index one ulp from
  an integer would move the index gradient by O(1)); ``warp_flow_ret`` (with
  its gradients), ``warp_flow_multi``, ``warp_flow`` and ``grid_sample`` equal
  JAX's.
- On CPU tensors no kernel is launched, and bad operands raise.

Layouts: the port is pixel-major (indices ``[b, P, L]``, warps ``[b, P, L,
c]``, ``ret``'s output ``[b, h, w, O]``); JAX's indices are ``[b, L, P]``, its
warps ``[b, L, c, P]`` and ``ret``'s output ``[b, O, P]``, transposed here to
compare.
"""
import contextlib
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl

from vp_suite_tpu.ops import pallas_warp as pw
from vp_suite_tpu_torch.ops import grid_sample as tgs
from vp_suite_tpu_torch.ops import warp

jgs = importlib.import_module("vp_suite_tpu.ops.grid_sample")

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_vjp(fn, args, g):
    r"""``(fn(*args), the VJP of fn at args applied to g)``, jitted (JAX's
    eager dispatch costs seconds here), in f32 at the highest precision."""
    def run(args, g):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(g)
    with jax.default_matmul_precision("highest"):
        return jax.jit(run)(tuple(map(jnp.asarray, args)), jnp.asarray(g))


def _pixel_major(a):
    r"""JAX's ``[b, L, P]`` indices or ``[b, L, c, P]`` warps, pixel-major."""
    a = np.asarray(a)
    return a.transpose(0, 2, 1) if a.ndim == 3 else a.transpose(0, 3, 1, 2)


def _inputs(seed, b=2, h=16, w=16, c=8, L=4):
    r"""JAX-layout indices ``[b, L, P]`` a few pixels off each output pixel,
    a tenth of them sent out of the image, an image and a cotangent."""
    rng = np.random.default_rng(seed)
    P = h * w
    oy = np.repeat(np.arange(h, dtype=np.float32), w)
    ox = np.tile(np.arange(w, dtype=np.float32), h)
    far = rng.random((2, b, L, P)) < 0.1
    jump = rng.choice([-1.0, 1.0], (2, b, L, P)) * np.array([h, w])[:, None, None, None] * 0.6
    iy = oy + rng.normal(0.0, 2.0, (b, L, P)) + far[0] * jump[0]
    ix = ox + rng.normal(0.0, 2.0, (b, L, P)) + far[1] * jump[1]
    img = rng.standard_normal((b, h, w, c))
    g = rng.standard_normal((b, L, c, P))
    return [a.astype(np.float32) for a in (iy, ix, img, g)]


@pytest.mark.parametrize("shape", [(16, 16), (12, 20)], ids=["16x16", "12x20"])
def test_reference_matches_jax_warp_sample(shape):
    iy, ix, img, _ = _inputs(0, h=shape[0], w=shape[1])
    assert (iy < 0).any() and (iy > shape[0] - 1).any() and (ix < 0).any()
    with jax.default_matmul_precision("highest"):
        want = jax.jit(pw.warp_sample)(jnp.asarray(iy), jnp.asarray(ix), jnp.asarray(img))
    got = warp.warp_sample_reference(_t(_pixel_major(iy)), _t(_pixel_major(ix)), _t(img))
    assert got.shape == (2, shape[0] * shape[1], 4, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _pixel_major(want), rtol=0, atol=1e-5)


@contextlib.contextmanager
def _band_geometry(monkeypatch, pt, r):
    r"""K5's geometry at the tests' 16x16 size (``tests/test_pallas.py``'s
    ``_with_band_geometry``: ``pt``-pixel tiles, band radius ``r``) with every
    ``pallas_call`` in interpret mode."""
    orig = pl.pallas_call
    monkeypatch.setattr(pw, "_PT", pt)
    monkeypatch.setattr(pw, "_BAND_R", r)
    monkeypatch.setattr(pl, "pallas_call", lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    yield


def test_reference_matches_band_kernel_on_clamped_rows(monkeypatch):
    iy, ix, img, _ = _inputs(1)
    with _band_geometry(monkeypatch, 64, 2):
        clamped = pw._clamp_rows(jnp.asarray(iy), img.shape[2])
        assert bool(pw._band_pred(clamped, img.shape[2])) and not bool(
            pw._band_pred(jnp.asarray(iy), img.shape[2]))
        with jax.default_matmul_precision("highest"):
            want = pw._warp_sample_pallas_band(clamped, jnp.asarray(ix), jnp.asarray(img))
    got = warp.warp_sample_reference(_t(_pixel_major(clamped)), _t(_pixel_major(ix)), _t(img))
    np.testing.assert_allclose(got.numpy(), _pixel_major(want), rtol=0, atol=1e-5)


def test_reference_matches_torch_grid_sample():
    iy, ix, img, _ = _inputs(2, h=12, w=20)
    b, L, P = iy.shape
    h, w = img.shape[1:3]
    grid = np.stack([(2 * ix + 1) / w - 1, (2 * iy + 1) / h - 1], axis=-1)   # [b, L, P, 2]
    want = F.grid_sample(_t(img).permute(0, 3, 1, 2), _t(grid), mode="bilinear",
                         padding_mode="zeros", align_corners=False)   # [b, c, L, P]
    got = warp.warp_sample_reference(_t(_pixel_major(iy)), _t(_pixel_major(ix)), _t(img))
    np.testing.assert_allclose(got.numpy(), want.permute(0, 3, 2, 1).numpy(), rtol=0, atol=1e-5)


def test_gradients_match_jax_vjp():
    iy, ix, img, g = _inputs(3, h=12, w=20)
    _, want = _jax_vjp(pw.warp_sample, (iy, ix, img), g)
    args = [_t(_pixel_major(a)).requires_grad_() for a in (iy, ix)] + [_t(img).requires_grad_()]
    warp.warp_sample(*args).backward(_t(_pixel_major(g)))
    for got, w, name in zip(args, want, ("d_iy", "d_ix", "d_img")):
        w = np.asarray(w) if name == "d_img" else _pixel_major(w)
        np.testing.assert_allclose(got.grad.numpy(), w, rtol=0, atol=1e-4, err_msg=name)


def test_plain_backward_matches_autograd_of_plain_forward():
    iy, ix, img, g = _inputs(4)
    args = [_t(_pixel_major(a)).requires_grad_() for a in (iy, ix)] + [_t(img).requires_grad_()]
    gp = _t(_pixel_major(g))
    warp.warp_sample_reference(*args).backward(gp)
    got = warp.warp_sample_backward_reference(*(a.detach() for a in args), gp)
    for a, d in zip(args, got):
        assert d.dtype == torch.float32 and d.shape == a.shape
        torch.testing.assert_close(d, a.grad, rtol=0, atol=1e-5)


def test_flow_to_indices_match_jax_bit_for_bit():
    rng = np.random.default_rng(5)
    img = rng.standard_normal((2, 12, 20, 3)).astype(np.float32)
    flows = rng.normal(0.0, 3.0, (2, 12, 20, 10)).astype(np.float32)
    want = jgs._flow_to_indices(jnp.asarray(img), jnp.asarray(flows))
    got = tgs._flow_to_indices(_t(img), _t(flows))
    for q, w in zip(got, want):
        assert q.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), _pixel_major(w))


def test_warp_flow_ret_and_its_gradients_match_jax():
    rng = np.random.default_rng(6)
    b, h, w, c, L, O = 2, 12, 20, 4, 3, 12
    img = rng.standard_normal((b, h, w, c)).astype(np.float32)
    flows = rng.normal(0.0, 2.0, (b, h, w, 2 * L)).astype(np.float32)
    wr = (rng.standard_normal((L, c, O)) * 0.3).astype(np.float32)
    bias = rng.standard_normal(O).astype(np.float32)
    g = rng.standard_normal((b, O, h * w)).astype(np.float32)
    want, want_grads = _jax_vjp(jgs.warp_flow_ret, (img, flows, wr, bias), g)
    args = [_t(a).requires_grad_() for a in (img, flows, wr.reshape(L * c, O), bias)]
    got = tgs.warp_flow_ret(*args)
    assert got.shape == (b, h, w, O)
    np.testing.assert_allclose(got.detach().numpy().reshape(b, h * w, O),
                               np.asarray(want).transpose(0, 2, 1), rtol=0, atol=1e-5)
    got.backward(_t(g.transpose(0, 2, 1).reshape(b, h, w, O)))
    for a, wg, name in zip(args, want_grads, ("img", "flows", "w", "bias")):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(wg).reshape(a.shape),
                                   rtol=0, atol=1e-4, err_msg=name)


def test_warp_flow_multi_warp_flow_and_grid_sample_match_jax():
    rng = np.random.default_rng(7)
    b, h, w, c, L = 2, 12, 20, 4, 3
    img = rng.standard_normal((b, h, w, c)).astype(np.float32)
    flows = rng.normal(0.0, 2.0, (b, h, w, 2 * L)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (b, 5, 7, 2)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda img, flows, grid: (
            jgs.warp_flow_multi(img, flows), jgs.warp_flow(img, flows[..., :2]),
            jgs.grid_sample(img, grid)))(jnp.asarray(img), jnp.asarray(flows), jnp.asarray(grid))
    got = (tgs.warp_flow_multi(_t(img), _t(flows)), tgs.warp_flow(_t(img), _t(flows[..., :2])),
           tgs.grid_sample(_t(img), _t(grid)))
    for q, w, shape in zip(got, want, ((b, h, w, L * c), (b, h, w, c), (b, 5, 7, c))):
        assert q.shape == shape
        np.testing.assert_allclose(q.numpy(), np.asarray(w), rtol=0, atol=1e-5)


def test_cpu_launches_no_kernel_and_bad_operands_raise():
    iy, ix, img, g = _inputs(8)
    warp.warp_sample.launches = warp.warp_sample_backward.launches = 0
    args = [_t(_pixel_major(a)).requires_grad_() for a in (iy, ix)] + [_t(img).requires_grad_()]
    warp.warp_sample(*args).backward(_t(_pixel_major(g)))
    assert warp.warp_sample.launches == 0 and warp.warp_sample_backward.launches == 0
    with pytest.raises(ValueError, match="ix must match iy"):
        warp.warp_sample(args[0], args[1][:, :-1], args[2])
    with pytest.raises(ValueError, match=r"iy must be \[b, P, L\]"):
        warp.warp_sample(args[0][0], args[1][0], args[2])
    with pytest.raises(ValueError, match=r"g must be \[b, P, L, c\]"):
        warp.warp_sample_backward(*(a.detach() for a in args), _t(g))
    with pytest.raises(ValueError, match="runs on CPU or CUDA tensors"):
        warp.warp_sample_forward(*(a.detach().to("meta") for a in args))
