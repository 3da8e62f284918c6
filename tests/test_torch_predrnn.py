r"""PredRNN++ of the port against the JAX package's, on the same weights, on the CPU.

- ``patchify`` / ``unpatchify`` against the JAX package's, and their round
  trip.
- Weights go from the port to JAX through the JAX package's own importer of
  reference checkpoints (``utils/torch_import._import_predrnn``), so the
  port's ``state_dict`` names are the reference's; the port's converter is
  its inverse (strict ``load_state_dict``).
- The forward (16x16, ``num_hidden=(8, 8, 8)``, 3 -> 3 frames, train mode)
  on a mask drawn by the JAX package's ``scheduled_sampling_mask`` and passed
  in as numpy (the two packages' random streams cannot match), and on the
  default test mask: plain, with ``layer_norm``, with reverse scheduled
  sampling and action-conditional (32x32, so that the strided input convs
  leave 2x2 states): predictions to 1e-4 and the decoupling loss to 1e-5
  relative; the gradients of the loss (summed MSE plus the decoupling loss)
  to 2e-4 of the largest of each tensor.
- The masks the port draws from a ``torch.Generator``: shapes, the test
  masks, and their means within 4 sigma of ``eta`` over 20000 draws.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vp_suite_tpu.models import MODEL_CLASSES as JAX_MODELS
from vp_suite_tpu.ops.patch import patchify as jax_patchify, unpatchify as jax_unpatchify
from vp_suite_tpu.utils.torch_import import _import_predrnn
from vp_suite_tpu_torch.models import build_model
from vp_suite_tpu_torch.ops.patch import patchify, unpatchify
from vp_suite_tpu_torch.utils.jax_params import load_jax_params, predrnn_state_dict_from_jax

torch.set_num_threads(1)

B, CTX, PRED = 2, 3, 3
CONFIGS = {
    "plain": {},
    "layer_norm": dict(layer_norm=True),
    "reverse_scheduled_sampling": dict(reverse_scheduled_sampling=True),
    "action_conditional": dict(action_conditional=True, action_size=2, img_shape=(3, 32, 32)),
}


def _kwargs(name):
    return {**dict(img_shape=(3, 16, 16), action_size=0, tensor_value_range=(0.0, 1.0),
                   num_hidden=(8, 8, 8)), **CONFIGS[name]}


def _models(name, seed=0):
    r"""The port's model (weights from ``seed``; LayerNorm affines made
    non-trivial) and the JAX model with its parameters carried from it, its
    time loop a rolled ``lax.scan`` (``scan_unroll=1``: the same function,
    compiled faster)."""
    model = build_model("predrnn-pp", seed, "cpu", **_kwargs(name))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for pname, p in model.named_parameters():
            if ".1." in pname:
                p.add_(torch.randn(p.shape, generator=g) * 0.1)
    return model, JAX_MODELS["predrnn-pp"](**_kwargs(name), scan_unroll=1), jax_params(model)


def jax_params(model):
    return _import_predrnn({k: v.numpy().copy() for k, v in model.state_dict().items()})


def _inputs(name, seed=0):
    c, h, w = _kwargs(name)["img_shape"]
    rng = np.random.default_rng(seed)
    x = rng.random((B, CTX + PRED, h, w, c), dtype=np.float32)
    actions = rng.random((B, CTX + PRED, 2), dtype=np.float32) \
        if name == "action_conditional" else None
    return x, actions


def _jax_mask(jmodel, seed=3):
    r"""A training mask of the JAX package's regime, at eta 0.5 (so that
    it mixes frames and predictions), as numpy."""
    state = {**jmodel.init_model_state(), "sampling_eta": 0.5 + jmodel.sampling_changing_rate}
    mask, _ = jmodel.scheduled_sampling_mask(state, jax.random.PRNGKey(seed), B, CTX, PRED,
                                             train=True)
    return np.asarray(mask)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _loss(preds, aux, target):
    return ((preds - target) ** 2).sum(axis=(2, 3, 4)).mean() + aux["ST-LSTM decouple loss"]


def test_patchify_matches_jax_and_round_trips():
    x = np.random.default_rng(1).standard_normal((2, 3, 8, 12, 5), dtype=np.float32)
    got = patchify(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_patchify(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(unpatchify(got, 4).numpy(), x)
    np.testing.assert_array_equal(
        unpatchify(got, 4).numpy(), np.asarray(jax_unpatchify(jnp.asarray(got.numpy()), 4)))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_converter_round_trip(name):
    model, _, variables = _models(name)
    sd = predrnn_state_dict_from_jax(variables["params"])
    want = model.state_dict()
    assert set(sd) == set(want)
    assert all(torch.equal(sd[k], want[k]) for k in want)
    other = build_model("predrnn-pp", 9, "cpu", **_kwargs(name))
    load_jax_params(other, variables["params"])
    assert all(torch.equal(other.state_dict()[k], want[k]) for k in want)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_and_gradients_match_jax(name):
    model, jmodel, variables = _models(name)
    x, actions = _inputs(name)
    mask = _jax_mask(jmodel)
    assert 0.0 < mask.mean() < 1.0

    def jax_loss(params, mask_true):
        preds, aux = jmodel.apply({"params": params}, jnp.asarray(x), pred_frames=PRED,
                                  actions=_j(actions), train=True, mask_true=mask_true)
        return _loss(preds, aux, jnp.asarray(x[:, CTX:])), (preds, aux)

    fn = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))
    with jax.default_matmul_precision("highest"):
        (jl, (jpreds, jaux)), jgrads = fn(variables["params"], jnp.asarray(mask))
        test_preds, _ = jax.jit(lambda p: jmodel.apply({"params": p}, jnp.asarray(x),
                                                       pred_frames=PRED, actions=_j(actions)))(
            variables["params"])

    preds, aux = model(torch.from_numpy(x), pred_frames=PRED, actions=_t(actions), train=True,
                       mask_true=mask)
    loss = _loss(preds, aux, torch.from_numpy(x[:, CTX:]))
    loss.backward()
    np.testing.assert_allclose(preds.detach().numpy(), np.asarray(jpreds), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(aux["ST-LSTM decouple loss"].detach()),
                               float(jaux["ST-LSTM decouple loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    want = predrnn_state_dict_from_jax(jgrads)
    for pname, p in model.named_parameters():
        g, w = p.grad.numpy(), want[pname].numpy()
        err, scale = np.abs(g - w).max(), max(np.abs(w).max(), 1.0)
        assert err <= 2e-4 * scale, f"{pname}: max |diff| {err:.3g} > 2e-4 * {scale:.3g}"

    with torch.no_grad():
        got, _ = model(torch.from_numpy(x), pred_frames=PRED, actions=_t(actions))
    np.testing.assert_allclose(got.numpy(), np.asarray(test_preds), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("rss", [False, True], ids=["standard", "reverse"])
def test_test_masks(rss):
    model = build_model("predrnn-pp", 0, "cpu",
                        **{**_kwargs("plain"), "reverse_scheduled_sampling": rss})
    jmodel = JAX_MODELS["predrnn-pp"](**{**_kwargs("plain"), "reverse_scheduled_sampling": rss})
    mask, state = model.scheduled_sampling_mask({"a": 1}, None, B, CTX, PRED, train=False)
    want, _ = jmodel.scheduled_sampling_mask(jmodel.init_model_state(), jax.random.PRNGKey(0),
                                             B, CTX, PRED, train=False)
    assert state == {"a": 1}
    np.testing.assert_array_equal(np.broadcast_to(mask.numpy(), want.shape), np.asarray(want))


def test_training_masks_follow_eta():
    n, model = 20000, build_model("predrnn-pp", 0, "cpu", **_kwargs("plain"))
    gen = torch.Generator().manual_seed(0)
    state = {"training_iteration": 10, "sampling_eta": 0.3}
    mask, new = model.scheduled_sampling_mask(state, gen, n, CTX, PRED, train=True)
    eta = new["sampling_eta"]
    assert eta == float(np.float32(0.3) - np.float32(2e-5)) and new["training_iteration"] == 10
    assert mask.shape == (n, PRED - 1, 1, 1, 1) and set(mask.unique().tolist()) <= {0.0, 1.0}
    sigma = (eta * (1 - eta) / mask.numel()) ** 0.5
    assert abs(mask.mean().item() - eta) < 4 * sigma
    mask, new = model.scheduled_sampling_mask({**state, "training_iteration": 50000}, gen, n, CTX,
                                              PRED, train=True)
    assert new["sampling_eta"] == 0.0 and not mask.any()

    rss = build_model("predrnn-pp", 0, "cpu",
                      **{**_kwargs("plain"), "reverse_scheduled_sampling": True})
    itr = 30000    # between r_sampling_step_1 and _2
    mask, new = rss.scheduled_sampling_mask({"training_iteration": itr, "sampling_eta": 1.0},
                                            gen, n, CTX, PRED, train=True)
    assert new == {"training_iteration": itr, "sampling_eta": 1.0}
    assert mask.shape == (n, CTX + PRED - 2, 1, 1, 1)
    r_eta = 1.0 - 0.5 * np.exp(-(itr - 25000) / 5000)
    eta2 = 0.5 - 0.5 / 25000 * (itr - 25000)
    for part, p in ((mask[:, :CTX - 1], r_eta), (mask[:, CTX - 1:], eta2)):
        sigma = (p * (1 - p) / part.numel()) ** 0.5
        assert abs(part.mean().item() - p) < 4 * sigma
