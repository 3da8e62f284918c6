r"""The port's fused warp + ``ret`` (``vp_suite_tpu_torch.ops.warp.warp_ret``)
against the JAX package's ``pallas_warp.warp_ret``, on the CPU.

- ``warp_ret_reference`` equals JAX ``warp_ret`` on the CPU (its plain
  fallback) to 1e-4 at 16x16 and on a ragged case (a 9x11 image, P = 50 output
  pixels), with indices across the border, and equals the TPU kernel K8a
  (``_warpret_pallas`` in Pallas interpret mode) at 16x16.
- ``WarpRetFunction``'s five gradients equal ``jax.vjp(warp_ret)`` to 1e-4,
  and K8b/K8c (``_warpret_bwd`` in interpret mode) at 16x16; they and the
  plain backward equal autograd of the plain forward.
- The ``ret`` weights of a TrajGRU block carried from JAX by
  ``load_jax_params``, viewed ``[L, f, 3f]``, are JAX's ``ret_kernel``, and
  ``warp_ret`` on them equals the block's own ``warp_flow_ret`` h2h.
- On CPU tensors no kernel is launched, and bad operands raise.

Layouts: the port's indices are ``[b, P, L]`` and its output ``[b, P, O]``;
JAX's are ``[b, L, P]`` and ``[b, O, P]``, transposed here to compare.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from test_torch_traj_gru import KWARGS
from vp_suite_tpu.models import MODEL_CLASSES as JAX_MODELS
from vp_suite_tpu.ops import pallas_warp as pw
from vp_suite_tpu_torch.models import MODEL_CLASSES
from vp_suite_tpu_torch.ops import warp
from vp_suite_tpu_torch.ops.grid_sample import _flow_to_indices, warp_flow_ret
from vp_suite_tpu_torch.utils.jax_params import load_jax_params

torch.set_num_threads(1)

#: (h, w, P): a square image with P = h*w, and a ragged one with P != h*w.
SHAPES = {"16x16": (16, 16, 256), "ragged": (9, 11, 50)}
NAMES = ("d_iy", "d_ix", "d_img", "d_w", "d_bias")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(seed, h, w, P, b=2, L=3, f=8):
    r"""JAX-layout indices ``[b, L, P]`` anywhere within two pixels of the
    image (``tests/test_pallas.py``'s ``_fused_inputs``), an image, ret
    weights ``[L, f, 3f]``, a bias and a cotangent ``[b, 3f, P]``."""
    rng = np.random.default_rng(seed)
    iy = rng.random((b, L, P)) * (h + 4) - 2
    ix = rng.random((b, L, P)) * (w + 4) - 2
    img = rng.standard_normal((b, h, w, f))
    wr = rng.random((L, f, 3 * f)) - 0.5
    bias = rng.random(3 * f)
    g = rng.standard_normal((b, 3 * f, P))
    return [a.astype(np.float32) for a in (iy, ix, img, wr, bias, g)]


def _port_args(iy, ix, img, wr, bias):
    return [_t(iy.transpose(0, 2, 1)), _t(ix.transpose(0, 2, 1)), _t(img), _t(wr), _t(bias)]


def _jax_grads_pixel_major(grads):
    r"""JAX's five gradients in the port's layout."""
    return [np.asarray(q).transpose(0, 2, 1) if i < 2 else np.asarray(q)
            for i, q in enumerate(grads)]


@pytest.fixture()
def interpret(monkeypatch):
    r"""Every ``pallas_call`` in interpret mode, the K8 kernels forced on and
    the pixel tile at 256 (``tests/test_pallas.py``'s patches), for 16x16."""
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    monkeypatch.setattr(pw, "_warpret_eligible", lambda *a: True)
    monkeypatch.setattr(pw, "_PT", 256)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_reference_and_gradients_match_jax(shape):
    iy, ix, img, wr, bias, g = _inputs(0, *SHAPES[shape])
    assert (iy < 0).any() and (iy > SHAPES[shape][0] - 1).any() and (ix < 0).any()

    def run(args, g):
        out, vjp = jax.vjp(pw.warp_ret, *args)
        return out, vjp(g)
    with jax.default_matmul_precision("highest"):
        want, want_grads = jax.jit(run)(tuple(map(jnp.asarray, (iy, ix, img, wr, bias))),
                                        jnp.asarray(g))
    args = [a.requires_grad_() for a in _port_args(iy, ix, img, wr, bias)]
    got = warp.warp_ret(*args)
    assert got.shape == (2, SHAPES[shape][2], 24) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want).transpose(0, 2, 1),
                               rtol=0, atol=1e-4)
    got.backward(_t(g.transpose(0, 2, 1)))
    for a, w, name in zip(args, _jax_grads_pixel_major(want_grads), NAMES):
        np.testing.assert_allclose(a.grad.numpy(), w, rtol=0, atol=1e-4, err_msg=name)


def test_reference_and_gradients_match_the_pallas_kernels(interpret):
    iy, ix, img, wr, bias, g = _inputs(1, *SHAPES["16x16"])
    jargs = tuple(map(jnp.asarray, (iy, ix, img, wr, bias)))
    with jax.default_matmul_precision("highest"):
        want = pw._warpret_pallas(*jargs)
        want_grads = pw._warpret_bwd(jargs, jnp.asarray(g))
    args = _port_args(iy, ix, img, wr, bias)
    np.testing.assert_allclose(warp.warp_ret_reference(*args).numpy(),
                               np.asarray(want).transpose(0, 2, 1), rtol=0, atol=1e-4)
    got = warp.warp_ret_backward_reference(*args, _t(g.transpose(0, 2, 1)))
    for q, w, name in zip(got, _jax_grads_pixel_major(want_grads), NAMES):
        np.testing.assert_allclose(q.numpy(), w, rtol=0, atol=1e-4, err_msg=name)


def test_function_and_plain_backward_match_autograd_of_plain_forward():
    iy, ix, img, wr, bias, g = _inputs(2, *SHAPES["ragged"])
    args = [a.requires_grad_() for a in _port_args(iy, ix, img, wr, bias)]
    gp = _t(g.transpose(0, 2, 1))
    want = torch.autograd.grad(warp.warp_ret_reference(*args), args, gp)
    through_fn = torch.autograd.grad(warp.warp_ret(*args), args, gp)
    plain = warp.warp_ret_backward_reference(*(a.detach() for a in args), gp)
    for a, w, q, d, name in zip(args, want, through_fn, plain, NAMES):
        assert d.dtype == q.dtype == torch.float32 and d.shape == q.shape == a.shape, name
        torch.testing.assert_close(q, w, rtol=0, atol=1e-5, msg=name)
        torch.testing.assert_close(d, w, rtol=0, atol=1e-5, msg=name)


def test_carried_trajgru_weights_give_the_blocks_h2h():
    params = jax.jit(JAX_MODELS["trajgru"](**KWARGS).init_params)(jax.random.PRNGKey(0))
    model = load_jax_params(MODEL_CLASSES["trajgru"](**KWARGS), params)
    block = model.enc_rnns_list[0]
    f, L = block.enc_channels, block.L
    ret_w = block.ret.weight.detach().view(3 * f, L * f).t()      # as TrajGRU.forward views it
    w3 = ret_w.reshape(L, f, 3 * f)
    np.testing.assert_array_equal(
        w3.numpy(), np.asarray(params["enc_rnn1"]["ret_kernel"]).reshape(L, f, 3 * f))
    rng = np.random.default_rng(3)
    h = _t(rng.standard_normal((2, block.sh, block.sw, f)).astype(np.float32))
    flows = _t(rng.normal(0.0, 2.0, (2, block.sh, block.sw, 2 * L)).astype(np.float32))
    bias = block.ret.bias.detach()
    want = warp_flow_ret(h, -flows, ret_w, bias)                   # the block's h2h
    got = warp.warp_ret(*_flow_to_indices(h, -flows), h, w3, bias)
    torch.testing.assert_close(got.view(want.shape), want, rtol=0, atol=1e-5)


def test_cpu_launches_no_kernel_and_bad_operands_raise():
    iy, ix, img, wr, bias, g = _inputs(4, *SHAPES["ragged"])
    warp.warp_ret_forward.launches = warp.warp_ret_backward.launches = 0
    args = [a.requires_grad_() for a in _port_args(iy, ix, img, wr, bias)]
    warp.warp_ret(*args).backward(_t(g.transpose(0, 2, 1)))
    assert warp.warp_ret_forward.launches == 0 and warp.warp_ret_backward.launches == 0
    a = [x.detach() for x in args]
    with pytest.raises(ValueError, match=r"w must be \[L, f, O\]"):
        warp.warp_ret(a[0], a[1], a[2], a[3][:, :-1], a[4])
    with pytest.raises(ValueError, match=r"bias must be \[O\]"):
        warp.warp_ret(*a[:4], a[4][:-1])
    with pytest.raises(ValueError, match=r"g must be \[b, P, O\]"):
        warp.warp_ret_backward(*a, _t(g))
    with pytest.raises(ValueError, match="runs on CPU or CUDA tensors"):
        warp.warp_ret_forward(*(x.to("meta") for x in a))
