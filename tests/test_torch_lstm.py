r"""The encoder-LSTM-decoder (``models/lstm.py``) of the port against the JAX
package's, on the CPU, in f32 under ``jax.default_matmul_precision("highest")``,
on the port's weights carried into JAX (``lstm_params_to_jax``), at 32x32
with a bottleneck and LSTM cells of 32, 2 layers, 3 context frames.

- The converter: random JAX-layout parameters -> the port -> JAX, bit for
  bit, plain and action-conditional; ``load_jax_params`` takes them
  strictly, and the JAX package's importer of reference checkpoints reads
  the port's ``state_dict`` (its ``rnn_layers.{i}.weight_ih`` / ``weight_hh``
  / ``bias_ih`` / ``bias_hh`` in torch's ``[4h, in]`` layout) as
  ``lstm_params_to_jax`` does.
- The forward at ``pred_frames`` 1 (the first prediction alone) and 3 (two
  autoregressive steps), plain and action-conditional, to 1e-4; the
  gradients of a weighted sum over 3 frames, to 2e-4 of the largest of each
  tensor; one SGD train step through ``make_train_step`` as ``(p0 - p1) /
  lr``, to 5e-4 of the largest.
- Under ``compute_dtype=bfloat16``: every product (the linears and the
  cells' two per layer) and every sigmoid and tanh of the cells in bf16 in
  both packages (against ``jax.make_jaxpr``), the predictions bf16.
- An image of the wrong size raises ``ValueError`` on both sides (the JAX
  side by ``jax.eval_shape``).
- ``create_model`` -> ``train`` (2 epochs of 2 Adam steps, b=4, 2 -> 3
  frames) against the JAX suite's run from the same initial weights
  (validation losses to 1e-4 relative), then ``load_model``.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.overrides import TorchFunctionMode

import vp_suite_tpu.vpsuite as jax_vpsuite
from vp_suite_tpu.measure.loss_provider import PredictionLossProvider as JaxLossProvider
from vp_suite_tpu.models import MODEL_CLASSES as JAX_MODELS
from vp_suite_tpu.training import loop as jax_loop
from vp_suite_tpu.training.train_state import TrainState as JaxTrainState
from vp_suite_tpu.utils import torch_import
import vp_suite_tpu_torch.vpsuite as port_vpsuite
from vp_suite_tpu_torch import VPSuite
from vp_suite_tpu_torch.models import build_model
from vp_suite_tpu_torch.training.loop import make_train_step
from vp_suite_tpu_torch.training.train_state import create_train_state
from vp_suite_tpu_torch.utils.jax_params import (load_jax_params, lstm_params_to_jax,
                                                 lstm_state_dict_from_jax)

torch.set_num_threads(1)

MODEL_ID = "lstm"
B, CTX, A = 2, 3, 3
LR = 1e-2
SMALL = dict(bottleneck_dim=32, lstm_hidden_dim=32, lstm_num_layers=2)
KW = dict(img_shape=(3, 32, 32), action_size=0, tensor_value_range=(0.0, 1.0), **SMALL)
#: the JAX model's own knob: no rematerialization (the same function; it compiles faster)
JAX_ONLY = dict(remat=False)
CONFIGS = {"plain": {}, "action_conditional": dict(action_conditional=True, action_size=A)}


def _kwargs(name):
    return {**KW, **CONFIGS[name]}


def _pair(name):
    r"""The port's model (seed 0) and the JAX model with the port's weights."""
    model = build_model(MODEL_ID, 0, "cpu", **_kwargs(name))
    return model, JAX_MODELS[MODEL_ID](**_kwargs(name), **JAX_ONLY), \
        lstm_params_to_jax(model.state_dict())


def _inputs(name, pred_frames, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.random((B, CTX + pred_frames, 32, 32, 3), dtype=np.float32)
    actions = rng.random((B, CTX + pred_frames, A), dtype=np.float32) \
        if name == "action_conditional" else None
    return x, actions


def _jnp(a):
    return None if a is None else jnp.asarray(a)


def _tensor(a):
    return None if a is None else torch.from_numpy(a)


def assert_close_to_largest(got, want, tol, name):
    got, want = np.asarray(got), np.asarray(want)
    err, scale = np.abs(got - want).max(), max(np.abs(want).max(), 1.0)
    assert err <= tol * scale, f"{name}: max |diff| {err:.3g} > {tol} * {scale:.3g}"


@pytest.mark.parametrize("name", list(CONFIGS))
def test_converter_round_trip_is_exact(name):
    x, actions = _inputs(name, 1)
    jmodel = JAX_MODELS[MODEL_ID](**_kwargs(name))
    shapes = jax.eval_shape(lambda x, a: jmodel.init(jax.random.PRNGKey(0), x, pred_frames=1,
                                                     actions=a),
                            jnp.asarray(x[:, :CTX]), _jnp(actions))["params"]
    rng = np.random.default_rng(1)
    params = {k: rng.standard_normal(v.shape, dtype=np.float32) for k, v in shapes.items()}
    back = lstm_params_to_jax(lstm_state_dict_from_jax(params))
    assert back.keys() == params.keys()
    assert all(back[k].dtype == np.float32 and np.array_equal(back[k], params[k]) for k in params)
    model = load_jax_params(build_model(MODEL_ID, 0, "cpu", **_kwargs(name)), params)
    sd = model.state_dict()
    assert all(np.array_equal(v, params[k]) for k, v in lstm_params_to_jax(sd).items())
    imported = torch_import.import_state_dict(MODEL_ID, sd)["params"]
    assert imported.keys() == params.keys()
    assert all(np.array_equal(np.asarray(imported[k]), params[k]) for k in params)


def test_state_dict_carries_the_cells():
    sd = build_model(MODEL_ID, 0, "cpu", **_kwargs("action_conditional")).state_dict()
    in_dims = (32 + 32 // 10, 32)
    for i, in_dim in enumerate(in_dims):
        assert sd[f"rnn_layers.{i}.weight_ih"].shape == (4 * 32, in_dim)
        assert sd[f"rnn_layers.{i}.weight_hh"].shape == (4 * 32, 32)
        assert sd[f"rnn_layers.{i}.bias_ih"].shape == sd[f"rnn_layers.{i}.bias_hh"].shape == (128,)
    assert not any(k.startswith("rnn_layers.2.") for k in sd)


@pytest.mark.parametrize("pred_frames", [1, 3])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_jax(name, pred_frames):
    model, jmodel, params = _pair(name)
    x, actions = _inputs(name, pred_frames)
    with jax.default_matmul_precision("highest"):
        want, _ = jmodel.apply({"params": params}, jnp.asarray(x[:, :CTX]),
                               pred_frames=pred_frames, actions=_jnp(actions))
    with torch.no_grad():
        got, aux = model(torch.from_numpy(x[:, :CTX]), pred_frames=pred_frames,
                         actions=_tensor(actions))
    assert aux is None and got.shape == (B, pred_frames, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_gradients_match_jax(name):
    model, jmodel, params = _pair(name)
    x, actions = _inputs(name, 3, seed=2)
    g = np.random.default_rng(3).random((B, 3, 32, 32, 3), dtype=np.float32) - 0.5

    def loss(p):
        preds, _ = jmodel.apply({"params": p}, jnp.asarray(x[:, :CTX]), pred_frames=3,
                                actions=_jnp(actions), train=True)
        return jnp.sum(preds * g)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jax.grad(loss))(params)
    preds, _ = model(torch.from_numpy(x[:, :CTX]), pred_frames=3, actions=_tensor(actions),
                     train=True)
    (preds * torch.from_numpy(g)).sum().backward()
    got = lstm_params_to_jax({k: p.grad for k, p in model.named_parameters()})
    assert got.keys() == want.keys()
    for k in want:
        assert_close_to_largest(got[k], want[k], 2e-4, k)


def _run_config(name):
    return {"context_frames": CTX, "pred_frames": 3, "use_actions": name == "action_conditional"}


@functools.lru_cache(maxsize=None)
def _jax_step(name):
    r"""``(optimizer, jitted SGD train step)`` of the JAX model, built once."""
    optimizer = optax.sgd(LR)
    lp = JaxLossProvider({"losses_and_scales": {"mse": 1.0}, "img_c": 3, "device": None})
    jmodel = JAX_MODELS[MODEL_ID](**_kwargs(name), **JAX_ONLY)
    return optimizer, jax_loop.make_train_step(jmodel, _run_config(name), optimizer, lp,
                                               donate=False)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sgd_step_matches_jax(name):
    optimizer, jstep = _jax_step(name)
    model, _, params = _pair(name)
    jstate = jax.tree.map(jnp.asarray, JaxTrainState(
        params=params, extra_vars={}, opt_state=optimizer.init(params),
        step=jnp.asarray(0, jnp.int32), model_state={}, rng=jax.random.PRNGKey(0)))
    x, actions = _inputs(name, 3, seed=5)
    batch = {"frames": x} if actions is None else {"frames": x, "actions": actions}
    with jax.default_matmul_precision("highest"):
        jstate, jmetrics = jstep(jstate, jax.tree.map(jnp.asarray, batch), jnp.asarray(0.0))
    state = create_train_state(model, lr=LR, optimizer="sgd")
    before = lstm_params_to_jax(model.state_dict())
    state, metrics = make_train_step(model, _run_config(name))(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(metrics["total"]), float(jmetrics["total"]), rtol=1e-5)
    after = lstm_params_to_jax(model.state_dict())
    for k, p0 in before.items():
        assert_close_to_largest((p0 - after[k]) / LR, (p0 - np.asarray(jstate.params[k])) / LR,
                                5e-4, k)


class _Dtypes(TorchFunctionMode):
    r"""Records the dtypes of every product's operands and every sigmoid's and tanh's input."""

    def __init__(self):
        super().__init__()
        self.products, self.activations = set(), set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        dt = [str(a.dtype).removeprefix("torch.") for a in args[:2] if torch.is_tensor(a)]
        if name == "linear":
            self.products.add(tuple(dt))
        elif name in ("sigmoid", "tanh"):
            self.activations.add((name, dt[0]))
        return func(*args, **(kwargs or {}))


def _jaxpr_dtypes(jaxpr, found):
    for eqn in jaxpr.eqns:
        dt = [str(v.aval.dtype) for v in eqn.invars]
        if eqn.primitive.name == "dot_general":
            found["products"].add(tuple(dt))
            found["product_outputs"].add(str(eqn.outvars[0].aval.dtype))
        elif eqn.primitive.name in ("logistic", "tanh"):
            found["activations"].add(({"logistic": "sigmoid"}.get(eqn.primitive.name, "tanh"),
                                      dt[0]))
        for p in eqn.params.values():
            for sub in p if isinstance(p, (list, tuple)) else (p,):
                sub = getattr(sub, "jaxpr", sub)
                if hasattr(sub, "eqns"):
                    _jaxpr_dtypes(sub, found)
    return found


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bf16_flow_matches_jax(name):
    model = build_model(MODEL_ID, 0, "cpu", **_kwargs(name), compute_dtype=torch.bfloat16)
    jmodel = JAX_MODELS[MODEL_ID](**_kwargs(name), compute_dtype=jnp.bfloat16, **JAX_ONLY)
    x, actions = _inputs(name, 3)
    xb = x[:, :CTX].astype(jnp.bfloat16)
    with _Dtypes() as rec, torch.no_grad():
        preds, _ = model(torch.from_numpy(x[:, :CTX]).bfloat16(), pred_frames=3,
                         actions=_tensor(actions))
    jaxpr = jax.make_jaxpr(lambda p, x, a: jmodel.apply({"params": p}, x, pred_frames=3,
                                                         actions=a))(
        lstm_params_to_jax(model.state_dict()), jnp.asarray(xb), _jnp(actions))
    want = _jaxpr_dtypes(jaxpr.jaxpr, {"products": set(), "product_outputs": set(),
                                       "activations": set()})
    assert rec.products == want["products"] == {("bfloat16", "bfloat16")}
    assert want["product_outputs"] == {"bfloat16"}
    assert rec.activations == want["activations"] == {("sigmoid", "bfloat16"),
                                                       ("tanh", "bfloat16")}
    assert preds.dtype == torch.bfloat16 and str(jaxpr.out_avals[0].dtype) == "bfloat16"


def test_wrong_image_size_is_refused_as_in_jax():
    x = jnp.zeros((1, 2, 32, 16, 3))
    with pytest.raises(ValueError, match="does not match"):
        jax.eval_shape(lambda x: JAX_MODELS[MODEL_ID](**KW).init(jax.random.PRNGKey(0), x), x)
    with pytest.raises(ValueError, match="does not match"):
        build_model(MODEL_ID, 0, "cpu", **KW)(torch.zeros((1, 2, 32, 16, 3)))


MMF = dict(img_size=32, digit_source="synthetic", n_seqs={"train": 8, "val": 4, "test": 4})
RUN = dict(epochs=2, batch_size=4, context_frames=2, pred_frames=3, steps_per_epoch=2,
           no_vis=True, no_wandb=True, num_devices=1)


def _one_worker(mp, module):
    mp.setattr(module, "BatchLoader", functools.partial(module.BatchLoader, num_workers=1))


def _val_losses(out_dir):
    with open(out_dir / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _state_from_port(port_model):
    r"""A stand-in for the JAX suite's ``create_train_state`` that starts
    from the port model's weights."""
    def create(model, optimizer, rng, **kw):
        params = lstm_params_to_jax(port_model.state_dict())
        _, state_rng = jax.random.split(rng)
        return JaxTrainState(params=params, extra_vars={}, opt_state=optimizer.init(params),
                             step=jnp.asarray(0, jnp.int32), model_state={}, rng=state_rng)
    return create


def test_suite_train_and_load(tmp_path, monkeypatch):
    suite = VPSuite(device="cpu")
    suite.load_dataset("MMF", **MMF)
    entry = suite.create_model(MODEL_ID, **SMALL)

    with pytest.MonkeyPatch.context() as mp:
        _one_worker(mp, jax_vpsuite)
        mp.setattr(jax_vpsuite, "create_train_state", _state_from_port(entry.model))
        jax_suite = jax_vpsuite.VPSuite(device="cpu", compilation_cache=False)
        jax_suite.load_dataset("MMF", **MMF)
        jax_suite.create_model(MODEL_ID, **SMALL, **JAX_ONLY)
        with jax.default_matmul_precision("highest"):
            jax_best = jax_suite.train(out_dir=str(tmp_path / "jax"), **RUN)

    _one_worker(monkeypatch, port_vpsuite)
    best = suite.train(out_dir=str(tmp_path / "port"), **RUN)
    want, got = _val_losses(tmp_path / "jax"), _val_losses(tmp_path / "port")
    assert [m["epoch"] for m in got] == [m["epoch"] for m in want] == [0, 1]
    for w, g in zip(want, got):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(best, jax_best, rtol=1e-4)
    assert entry.state.step == 4

    loaded = VPSuite(device="cpu").load_model(str(tmp_path / "port"), "final_model")
    want_sd, got_sd = entry.model.state_dict(), loaded.model.state_dict()
    assert got_sd.keys() == want_sd.keys()
    assert all(torch.equal(got_sd[k], want_sd[k]) for k in want_sd)
    frames = np.random.default_rng(7).random((2, 2, 32, 32, 3), dtype=np.float32)
    check = VPSuite(device="cpu")
    check.models += [entry, loaded]
    torch.testing.assert_close(check.predict(frames, pred_frames=3, model_idx=0),
                               check.predict(frames, pred_frames=3, model_idx=1), rtol=0, atol=0)
