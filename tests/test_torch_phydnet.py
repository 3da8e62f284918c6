r"""PhyDNet of the port against the JAX package's, on the same weights, on the CPU.

- ``group_norm`` (torch semantics on channels-last input), the DCGAN conv and
  transposed conv at strides 1 and 2, the ndrplz ConvLSTM gates and cell,
  and the PhyCell step, plain and action-conditional, each against the JAX
  package's own function (its param factories run inside a small flax
  module), f32 to 1e-5.
- The K2M moment matrices and constraints exactly, ``k2m`` to 1e-5 (moments
  of order 50 summed in another order), the moment loss on the same weights
  (the port's ``[hid, in, kh, kw]`` layout, JAX's ``[kh, kw, in, hid]``) to
  1e-6 relative, and the GroupNorm divisor.
- The converter: the port's ``state_dict`` through the JAX package's
  importer of reference checkpoints (``torch_import.import_state_dict``) and
  back, and the JAX model's own initial params (action-conditional, every
  key) through the port and back, bit for bit.
- The model (16x16, ``convlstm_hidden_dims=(16, 64)``: ``decoder_Dr`` takes
  64 channels, so the last ConvLSTM layer has 64; 3 -> 3 frames), plain and
  action-conditional: the train-mode forward at teacher forcing 1 and 0
  (predictions to 1e-4, the moment loss to 1e-6 relative) with the gradients
  of the summed MSE plus the moment loss (2e-4 of the largest of each
  tensor), and the eval-mode forward (1e-4). Each JAX function is compiled
  once per configuration (the flag a traced argument).
- The forward's two shortcuts against the JAX model's uniform loop
  (``kernels/phydnet_variants.UniformPhyDNet``), train and eval mode.
- ``decoder_D``'s resize at a latent that does not give the image size
  (5x5 -> 20x20 -> 18x18) against the JAX package's decoder, and an image
  size that is not a multiple of 4, which both models refuse.
"""
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vp_suite_tpu.model_blocks import _functional as jax_functional
from vp_suite_tpu.model_blocks import conv_lstm_ndrplz as jax_ndrplz
from vp_suite_tpu.model_blocks import phydnet as jax_blocks
from vp_suite_tpu.models import MODEL_CLASSES as JAX_MODELS
from vp_suite_tpu.ops.image import resize_bilinear as jax_resize
from vp_suite_tpu.utils import torch_import
from vp_suite_tpu_torch.kernels.phydnet_variants import UniformPhyDNet
from vp_suite_tpu_torch.model_blocks import phydnet as blocks
from vp_suite_tpu_torch.nn.functional import group_norm
from vp_suite_tpu_torch.model_blocks.conv import DCGANConv, DCGANConvTranspose
from vp_suite_tpu_torch.model_blocks.conv_lstm_ndrplz import (ConvLSTMCellNdrplz,
                                                              convlstm_ndrplz_gates)
from vp_suite_tpu_torch.models import build_model
from vp_suite_tpu_torch.utils.jax_params import load_jax_params, phydnet_state_dict_from_jax

torch.set_num_threads(1)

B, CTX, PRED, A = 2, 3, 3, 2
KW = dict(img_shape=(3, 16, 16), action_size=0, tensor_value_range=(0.0, 1.0),
          convlstm_hidden_dims=(16, 64))
CONFIGS = {"plain": {}, "action_conditional": dict(action_conditional=True, action_size=A)}


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _np_sd(module):
    return {k: v.numpy().copy() for k, v in module.state_dict().items()}


def _perturb(module, seed):
    r"""Non-trivial norm affines (they start at 1 and 0)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() == 1:
                p.add_(torch.randn(p.shape, generator=g) * 0.1)
    return module


class _Factory(fnn.Module):
    r"""Runs one of the JAX package's param factories (``make(self)`` returns
    the step closure) on ``args``."""
    make: object

    @fnn.compact
    def __call__(self, *args):
        return self.make(self)(*args)


def _apply_factory(make, params, *args):
    with jax.default_matmul_precision("highest"):
        return np.asarray(_Factory(make).apply({"params": params}, *map(jnp.asarray, args)))


@pytest.mark.parametrize("shape,groups", [((2, 4, 4, 32), 16), ((2, 5, 3, 49), 7),
                                          ((3, 8, 64), 16)])
def test_group_norm_matches_jax(shape, groups):
    rng = np.random.default_rng(0)
    x, w, b = _rand(rng, *shape) * 3 + 1, _rand(rng, shape[-1]), _rand(rng, shape[-1])
    got = group_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), groups)
    want = jax_functional.group_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("transposed", [False, True], ids=["conv", "conv_transpose"])
@pytest.mark.parametrize("stride", [1, 2])
def test_dcgan_blocks_match_jax(transposed, stride):
    block = _perturb((DCGANConvTranspose if transposed else DCGANConv)(8, 16, stride), 1)
    sd = {f"blk.{k}": v for k, v in _np_sd(block).items()}
    params = {}
    torch_import._dcgan(params, "blk", "blk", sd, transposed)
    make = jax_functional.make_dcgan_conv_transpose if transposed \
        else jax_functional.make_dcgan_conv
    x = _rand(np.random.default_rng(2), 2, 6, 6, 8)
    with torch.no_grad():
        got = block(torch.from_numpy(x))
    want = _apply_factory(lambda m: make(m, "blk", 8, 16, stride), params, x)
    side = {(False, 1): 6, (False, 2): 3, (True, 1): 6, (True, 2): 12}[(transposed, stride)]
    assert got.shape == want.shape == (2, side, side, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_ndrplz_gates_and_cell_match_jax():
    rng = np.random.default_rng(3)
    gates, c = _rand(rng, 2, 4, 4, 32), _rand(rng, 2, 4, 4, 8)
    got = convlstm_ndrplz_gates(torch.from_numpy(gates), torch.from_numpy(c))
    want = jax_ndrplz.convlstm_ndrplz_gates(jnp.asarray(gates), jnp.asarray(c))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)

    cell = ConvLSTMCellNdrplz(5, 8, (3, 3))
    cell.conv.reset_parameters(torch.Generator().manual_seed(0))
    x, h = _rand(rng, 2, 4, 4, 5), _rand(rng, 2, 4, 4, 8)
    params = {"conv_kernel": cell.conv.weight.detach().numpy().transpose(2, 3, 1, 0),
              "conv_bias": cell.conv.bias.detach().numpy()}
    with torch.no_grad():
        got = cell(torch.from_numpy(x), (torch.from_numpy(h), torch.from_numpy(c)))
    with jax.default_matmul_precision("highest"):
        want = jax_ndrplz.ConvLSTMCellNdrplz(5, 8).apply(
            {"params": params}, jnp.asarray(x), (jnp.asarray(h), jnp.asarray(c)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ac", [False, True], ids=["plain", "action_conditional"])
def test_phycell_step_matches_jax(ac):
    cell = _perturb(blocks.PhyCellCell(16, ac, A, 9, (3, 3)), 4)
    cell.F.conv1.reset_parameters(torch.Generator().manual_seed(1))
    sd = {f"c.{k}": v for k, v in _np_sd(cell).items()}
    params = {}
    torch_import._phycell(params, "cell", "c", sd)
    rng = np.random.default_rng(5)
    frame, hidden, action = _rand(rng, 2, 4, 4, 16), _rand(rng, 2, 4, 4, 16), _rand(rng, 2, A)
    with torch.no_grad():
        got = cell(torch.from_numpy(frame), torch.from_numpy(action), torch.from_numpy(hidden))
    want = _apply_factory(lambda m: jax_blocks.make_phycell_cell(m, "cell", 16, ac, A, 9, (3, 3)),
                          params, frame, action, hidden)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("channels,kernel", [(49, (7, 7)), (9, (3, 3)), (20, (3, 5))])
def test_moment_loss_matches_jax(channels, kernel):
    assert blocks.find_divisor_for_group_norm(channels) \
        == jax_blocks.find_divisor_for_group_norm(channels)
    mats = blocks.k2m_matrices(kernel)
    for got, want in zip(mats, jax_blocks.k2m_matrices(kernel)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    con = blocks.moment_constraints(channels, kernel)
    np.testing.assert_array_equal(con.numpy(),
                                  np.asarray(jax_blocks.moment_constraints(channels, kernel)))
    rng = np.random.default_rng(6)
    kernels = _rand(rng, 5, *kernel)
    np.testing.assert_allclose(blocks.k2m(torch.from_numpy(kernels), mats).numpy(),
                               np.asarray(jax_blocks.k2m(jnp.asarray(kernels),
                                                         jax_blocks.k2m_matrices(kernel))),
                               rtol=1e-5, atol=1e-5)
    weight = _rand(rng, channels, 16, *kernel) * 0.1          # the port's [hid, in, kh, kw]
    got = blocks.moment_loss(torch.from_numpy(weight), con, mats)
    with jax.default_matmul_precision("highest"):
        want = jax_blocks.moment_loss(jnp.asarray(weight.transpose(2, 3, 1, 0)),
                                      jax_blocks.moment_constraints(channels, kernel), kernel)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _kwargs(name):
    return {**KW, **CONFIGS[name]}


def _models(name, seed=0):
    model = _perturb(build_model("phy", seed, "cpu", **_kwargs(name)), seed + 1)
    return model, JAX_MODELS["phy"](**_kwargs(name)), torch_import.import_state_dict(
        "phy", _np_sd(model))["params"]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_converter_round_trip(name):
    model, jmodel, params = _models(name)
    sd = phydnet_state_dict_from_jax(params)
    want = model.state_dict()
    assert sd.keys() == want.keys() and all(torch.equal(sd[k], want[k]) for k in want)
    other = build_model("phy", 9, "cpu", **_kwargs(name))
    load_jax_params(other, params)
    assert all(torch.equal(other.state_dict()[k], want[k]) for k in want)


def test_jax_initial_params_round_trip():
    r"""The JAX model's own initial params (the action-conditional model,
    whose tree has every key) into the port and back, bit for bit."""
    jmodel = JAX_MODELS["phy"](**_kwargs("action_conditional"))
    c, h, w = KW["img_shape"]
    init = jax.jit(lambda r: jmodel.init(r, jnp.zeros((1, 2, h, w, c)), pred_frames=1,
                                         actions=jnp.zeros((1, 3, A))))(jax.random.PRNGKey(0))
    other = build_model("phy", 9, "cpu", **_kwargs("action_conditional"))
    load_jax_params(other, init["params"])
    back = torch_import.import_state_dict("phy", other.state_dict())["params"]
    assert back.keys() == init["params"].keys()
    for k, v in init["params"].items():
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(v), err_msg=k)


def _inputs(name, seed=1):
    r"""Frames (and actions) from ``seed``. Seed 0 puts one GroupNorm output
    of the action-conditional model's last step within f32 rounding of
    LeakyReLU's kink, where the rounding picks the slope: there the port's
    f32 gradients on oneDNN miss the 2e-4 limit against JAX's, while the
    port in f64 and JAX in f32 agree within it."""
    c, h, w = KW["img_shape"]
    rng = np.random.default_rng(seed)
    x = rng.random((B, CTX + PRED, h, w, c), dtype=np.float32)
    actions = rng.random((B, CTX + PRED, A), dtype=np.float32) \
        if name == "action_conditional" else None
    return x, actions


def _loss(preds, aux, target):
    return ((preds - target) ** 2).sum(axis=(2, 3, 4)).mean() + aux["moment regularization loss"]


@functools.lru_cache(maxsize=None)
def _jax_fns(name):
    r"""The JAX model's jitted loss-and-gradients (the teacher-forcing flag
    a traced argument) and eval forward, compiled once per configuration."""
    jmodel = JAX_MODELS["phy"](**_kwargs(name))

    def loss(p, x, actions, flag):
        preds, aux = jmodel.apply({"params": p}, x, pred_frames=PRED, actions=actions,
                                  train=True, teacher_forcing=flag)
        return _loss(preds, aux, x[:, 1:]), (preds, aux)

    return (jax.jit(jax.value_and_grad(loss, has_aux=True)),
            jax.jit(lambda p, x, actions: jmodel.apply({"params": p}, x, pred_frames=PRED,
                                                       actions=actions)))


@pytest.mark.parametrize("tf", [1, 0], ids=["teacher_forcing", "free_running"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_and_gradients_match_jax(name, tf):
    model, _, params = _models(name)
    x, actions = _inputs(name)
    ja = None if actions is None else jnp.asarray(actions)
    grad_fn, eval_fn = _jax_fns(name)
    with jax.default_matmul_precision("highest"):
        (jl, (jpreds, jaux)), jgrads = grad_fn(params, jnp.asarray(x), ja, jnp.asarray(float(tf)))
        eval_preds, _ = eval_fn(params, jnp.asarray(x[:, :CTX]), ja)

    coin = torch.tensor(bool(tf))
    preds, aux = model(torch.from_numpy(x), pred_frames=PRED,
                       actions=None if actions is None else torch.from_numpy(actions),
                       train=True, teacher_forcing=coin)
    assert preds.shape == (B, CTX + PRED - 1, 16, 16, 3)
    loss = _loss(preds, aux, torch.from_numpy(x[:, 1:]))
    loss.backward()
    np.testing.assert_allclose(preds.detach().numpy(), np.asarray(jpreds), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(aux["moment regularization loss"].detach()),
                               float(jaux["moment regularization loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    want = phydnet_state_dict_from_jax(jgrads)
    for pname, p in model.named_parameters():
        g, w = p.grad.numpy(), want[pname].numpy()
        err, scale = np.abs(g - w).max(), max(np.abs(w).max(), 1.0)
        assert err <= 2e-4 * scale, f"{pname}: max |diff| {err:.3g} > 2e-4 * {scale:.3g}"

    with torch.no_grad():
        got, aux = model(torch.from_numpy(x[:, :CTX]), pred_frames=PRED,
                         actions=None if actions is None else torch.from_numpy(actions))
    assert aux is None and got.shape == (B, PRED, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(eval_preds), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_shortcuts_compute_the_uniform_loop(mode):
    r"""The library's forward (the context encoded in one batch, eval decoding
    from step ctx - 1) against ``phydnet_variants.UniformPhyDNet``, the JAX
    model's loop, in f32 with teacher forcing 0 (every step after the
    context reads the previous output)."""
    model = _perturb(build_model("phy", 0, "cpu", **_kwargs("action_conditional")), 1)
    uniform = build_model("phy", 0, "cpu", **_kwargs("action_conditional"))
    uniform.load_state_dict(model.state_dict())
    uniform.__class__ = UniformPhyDNet
    x, actions = (torch.from_numpy(a) for a in _inputs("action_conditional"))
    train = mode == "train"
    inputs = x if train else x[:, :CTX]
    with torch.no_grad():
        got, got_aux = model(inputs, pred_frames=PRED, actions=actions, train=train,
                             teacher_forcing=torch.tensor(False))
        want, want_aux = uniform(inputs, pred_frames=PRED, actions=actions, train=train,
                                 teacher_forcing=torch.tensor(False))
    assert got.shape == want.shape == (B, CTX + PRED - 1 if train else PRED, 16, 16, 3)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert got_aux == want_aux


class _JaxDecoder(fnn.Module):
    r"""The JAX model's ``decoder_Dp``/``decoder_Dr`` sum and ``decoder_D``
    (``vp_suite_tpu/models/phydnet.py``), to an image of ``size``."""
    size: tuple

    @fnn.compact
    def __call__(self, phy, conv):
        f = jax_functional
        dp = [f.make_dcgan_conv_transpose(self, f"decoder_Dp_upc{i}", 64, 64, 1) for i in (1, 2)]
        dr = [f.make_dcgan_conv_transpose(self, f"decoder_Dr_upc{i}", 64, 64, 1) for i in (1, 2)]
        d1 = f.make_dcgan_conv_transpose(self, "decoder_D_upc1", 64, 32, 2)
        d2 = f.make_dcgan_conv_transpose(self, "decoder_D_upc2", 32, 32, 1)
        d3_k, d3_b = f.make_conv_params(self, "decoder_D_upc3", 32, 3, (3, 3))
        y = dp[1](dp[0](phy)) + dr[1](dr[0](conv))
        y = f.conv_transpose2d(d2(d1(y)), d3_k, d3_b, 2, 1, 1)
        return jax.nn.sigmoid(jax_resize(y, self.size))


def test_decoder_resizes_like_jax():
    model = _perturb(build_model("phy", 0, "cpu", **{**KW, "img_shape": (3, 18, 18)}), 1)
    params = torch_import.import_state_dict("phy", _np_sd(model))["params"]
    params = {k: v for k, v in params.items() if k.startswith("decoder")}
    rng = np.random.default_rng(7)
    phy, conv = _rand(rng, 2, 5, 5, 64), _rand(rng, 2, 5, 5, 64)
    with torch.no_grad():
        got = model._decode(torch.from_numpy(phy), torch.from_numpy(conv))
    with jax.default_matmul_precision("highest"):
        want = _JaxDecoder((18, 18)).apply({"params": params}, jnp.asarray(phy),
                                           jnp.asarray(conv))
    assert got.shape == want.shape == (2, 18, 18, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_sizes_not_a_multiple_of_4_are_refused_as_in_jax():
    kw = {**KW, "img_shape": (3, 18, 18)}
    x = np.zeros((1, 2, 18, 18, 3), np.float32)
    with pytest.raises(TypeError, match="concatenate"):
        jax.eval_shape(functools.partial(JAX_MODELS["phy"](**kw).init, pred_frames=1),
                       jax.random.PRNGKey(0), jnp.asarray(x))
    with pytest.raises(RuntimeError, match="Sizes of tensors must match"):
        build_model("phy", 0, "cpu", **kw)(torch.from_numpy(x), pred_frames=1)
