r"""MinConvRNN (``models/min_conv_rnn.py``) of the port against the JAX
package's, on the CPU, in f32 under ``jax.default_matmul_precision("highest")``,
on the port's weights carried into JAX (``min_conv_rnn_params_to_jax``).

- ``linear_recurrence_scan`` with and without ``h0`` against JAX's
  associative scan, to 1e-6 (another order of the same products).
- The converter: random JAX-layout parameters (shapes from
  ``jax.eval_shape`` of the JAX model's init) -> the port -> JAX, equal bit
  for bit, and ``load_jax_params`` takes them strictly.
- The forward in train and eval mode at ``pred_frames`` 1 (the first
  prediction alone) and 4, to 1e-4; the gradients of a summed loss, to
  2e-4 of the largest of each tensor; one SGD train step's ``(p0 - p1) /
  lr`` with ``accum_steps`` 1 and 2, to 5e-4 of the largest (each JAX step
  compiled once, :func:`_jax_step`).
- Under bf16 every convolution runs in bf16 in both packages (the model
  has no dtype of its own: the gates, ``1 - f`` and the recurrence run in
  the input's), counted against ``jax.make_jaxpr``.
- Refusals: an input of another image size (``ValueError`` on both sides,
  the JAX side by ``jax.eval_shape``); a ``context_mesh`` that is not a
  ``DeviceMesh`` (the sharded context scan itself is held in
  ``test_torch_scan_parallel.py``).
- ``create_model`` -> ``train`` (2 epochs of 2 Adam steps, b=4, 2 -> 3
  frames) against the JAX suite's run from the same initial weights
  (validation losses to 1e-4 relative), then ``load_model`` and ``test``.
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
from vp_suite_tpu.models.min_conv_rnn import linear_recurrence_scan as jax_scan
from vp_suite_tpu.training import loop as jax_loop
from vp_suite_tpu.training.train_state import TrainState as JaxTrainState
import vp_suite_tpu_torch.vpsuite as port_vpsuite
from vp_suite_tpu_torch import VPSuite
from vp_suite_tpu_torch.defaults import SETTINGS
from vp_suite_tpu_torch.models import build_model
from vp_suite_tpu_torch.models.min_conv_rnn import linear_recurrence_scan
from vp_suite_tpu_torch.training.loop import make_train_step
from vp_suite_tpu_torch.training.train_state import create_train_state
from vp_suite_tpu_torch.utils.jax_params import (load_jax_params, min_conv_rnn_params_to_jax,
                                                 min_conv_rnn_state_dict_from_jax)

torch.set_num_threads(1)

MODEL_ID = "min-conv-rnn"
LR = 1e-2
#: the JAX model's own knob: no rematerialization (the same function; it compiles faster)
JAX_ONLY = dict(remat=False)
KW = dict(img_shape=(3, 16, 16), action_size=0, tensor_value_range=(0.0, 1.0), hidden_dim=16,
          num_layers=2)
RUN_CONFIG = {"context_frames": 3, "pred_frames": 3, "use_actions": False}


def _frames(shape, seed):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _pair():
    r"""The port's model and the JAX model with the port's weights."""
    model = build_model(MODEL_ID, 0, "cpu", **KW)
    jmodel = JAX_MODELS[MODEL_ID](**KW, **JAX_ONLY)
    return model, jmodel, min_conv_rnn_params_to_jax(model.state_dict())


def assert_close_to_largest(got, want, tol, name):
    got, want = np.asarray(got), np.asarray(want)
    err, scale = np.abs(got - want).max(), max(np.abs(want).max(), 1.0)
    assert err <= tol * scale, f"{name}: max |diff| {err:.3g} > {tol} * {scale:.3g}"


@pytest.mark.parametrize("with_h0", [False, True], ids=["zeros", "h0"])
def test_linear_recurrence_scan_matches_jax(with_h0):
    rng = np.random.default_rng(0)
    f = rng.random((5, 2, 4, 4, 3), dtype=np.float32)
    u = rng.standard_normal((5, 2, 4, 4, 3), dtype=np.float32)
    h0 = rng.standard_normal((2, 4, 4, 3), dtype=np.float32) if with_h0 else None
    want = jax_scan(jnp.asarray(f), jnp.asarray(u), None if h0 is None else jnp.asarray(h0))
    got = linear_recurrence_scan(torch.from_numpy(f), torch.from_numpy(u),
                                 None if h0 is None else torch.from_numpy(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_converter_round_trip_is_exact():
    x = jnp.zeros((1, 2, 16, 16, 3))
    shapes = jax.eval_shape(lambda x: JAX_MODELS[MODEL_ID](**KW).init(jax.random.PRNGKey(0), x),
                            x)["params"]
    rng = np.random.default_rng(1)
    params = {k: rng.standard_normal(v.shape, dtype=np.float32) for k, v in shapes.items()}
    back = min_conv_rnn_params_to_jax(min_conv_rnn_state_dict_from_jax(params))
    assert back.keys() == params.keys()
    assert all(back[k].dtype == np.float32 and np.array_equal(back[k], params[k]) for k in params)
    model = load_jax_params(build_model(MODEL_ID, 0, "cpu", **KW), params)
    assert all(np.array_equal(v, params[k])
               for k, v in min_conv_rnn_params_to_jax(model.state_dict()).items())


@pytest.mark.parametrize("pred_frames", [1, 4])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_matches_jax(train, pred_frames):
    model, jmodel, params = _pair()
    x = _frames((2, 3, 16, 16, 3), 2)
    with jax.default_matmul_precision("highest"):
        want, _ = jmodel.apply({"params": params}, jnp.asarray(x), pred_frames=pred_frames,
                               train=train)
    with torch.no_grad():
        got, aux = model(torch.from_numpy(x), pred_frames=pred_frames, train=train)
    assert aux is None and got.shape == (2, pred_frames, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_gradients_match_jax():
    model, jmodel, params = _pair()
    x, g = _frames((2, 3, 16, 16, 3), 3), _frames((2, 3, 16, 16, 3), 4) - 0.5

    def loss(p):
        preds, _ = jmodel.apply({"params": p}, jnp.asarray(x), pred_frames=3, train=True)
        return jnp.sum(preds * g)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jax.grad(loss))(params)
    preds, _ = model(torch.from_numpy(x), pred_frames=3, train=True)
    (preds * torch.from_numpy(g)).sum().backward()
    got = min_conv_rnn_params_to_jax({k: p.grad for k, p in model.named_parameters()})
    assert got.keys() == want.keys()
    for k in want:
        assert_close_to_largest(got[k], want[k], 2e-4, k)


@functools.lru_cache(maxsize=None)
def _jax_step(accum_steps):
    r"""``(optimizer, jitted SGD train step)`` of the JAX model, built once."""
    optimizer = optax.sgd(LR)
    lp = JaxLossProvider({"losses_and_scales": {"mse": 1.0}, "img_c": 3, "device": None})
    jmodel = JAX_MODELS[MODEL_ID](**KW, **JAX_ONLY)
    return optimizer, jax_loop.make_train_step(jmodel, RUN_CONFIG, optimizer, lp, donate=False,
                                               accum_steps=accum_steps)


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_sgd_step_matches_jax(accum_steps):
    optimizer, jstep = _jax_step(accum_steps)
    model, _, params = _pair()
    jstate = jax.tree.map(jnp.asarray, JaxTrainState(
        params=params, extra_vars={}, opt_state=optimizer.init(params),
        step=jnp.asarray(0, jnp.int32), model_state={}, rng=jax.random.PRNGKey(0)))
    frames = _frames((4, 6, 16, 16, 3), 5)
    with jax.default_matmul_precision("highest"):
        jstate, jmetrics = jstep(jstate, {"frames": jnp.asarray(frames)}, jnp.asarray(0.0))
    state = create_train_state(model, lr=LR, optimizer="sgd")
    before = min_conv_rnn_params_to_jax(model.state_dict())
    state, metrics = make_train_step(model, RUN_CONFIG, accum_steps=accum_steps)(
        state, {"frames": torch.from_numpy(frames)})
    np.testing.assert_allclose(float(metrics["total"]), float(jmetrics["total"]), rtol=1e-5)
    after = min_conv_rnn_params_to_jax(model.state_dict())
    for k, p0 in before.items():
        assert_close_to_largest((p0 - after[k]) / LR, (p0 - np.asarray(jstate.params[k])) / LR,
                                5e-4, k)


class _ConvDtypes(TorchFunctionMode):
    r"""Records the input dtype of every convolution."""

    def __init__(self):
        super().__init__()
        self.dtypes = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in ("conv2d", "conv_transpose2d"):
            self.dtypes.append(str(args[0].dtype).removeprefix("torch."))
        return func(*args, **(kwargs or {}))


def _jaxpr_conv_dtypes(jaxpr):
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "conv_general_dilated":
            out.append(str(eqn.invars[0].aval.dtype))
        for p in eqn.params.values():
            for sub in p if isinstance(p, (list, tuple)) else (p,):
                sub = getattr(sub, "jaxpr", sub)
                if hasattr(sub, "eqns"):
                    out += _jaxpr_conv_dtypes(sub)
    return out


def test_bf16_runs_every_convolution_in_bf16():
    model, jmodel, params = _pair()
    x = _frames((1, 3, 16, 16, 3), 6)
    with _ConvDtypes() as rec, torch.no_grad():
        preds, _ = model(torch.from_numpy(x).bfloat16(), pred_frames=2)
    jaxpr = jax.make_jaxpr(lambda p, x: jmodel.apply({"params": p}, x, pred_frames=2))(
        params, jnp.asarray(x, jnp.bfloat16))
    want = _jaxpr_conv_dtypes(jaxpr.jaxpr)
    # context: 2 encoder + 2 gate convs and out per layer + 2 decoder; one more step
    assert len(want) == 2 * (2 + 3 * 2 + 2) and set(want) == {"bfloat16"}
    assert rec.dtypes == want and preds.dtype == torch.bfloat16


def test_refusals_match_jax():
    jmodel = JAX_MODELS[MODEL_ID](**KW)
    x = jnp.zeros((1, 2, 16, 12, 3))
    with pytest.raises(ValueError, match="does not match"):
        jax.eval_shape(lambda x: jmodel.init(jax.random.PRNGKey(0), x), x)
    with pytest.raises(ValueError, match="does not match"):
        build_model(MODEL_ID, 0, "cpu", **KW)(torch.zeros(1, 2, 16, 12, 3))
    with pytest.raises(ValueError, match="context_mesh"):
        build_model(MODEL_ID, 0, "cpu", **KW, context_mesh=object())


MMF = dict(img_size=16, digit_source="synthetic", n_seqs={"train": 8, "val": 4, "test": 4})
RUN = dict(epochs=2, batch_size=4, context_frames=2, pred_frames=3, steps_per_epoch=2,
           no_vis=True, no_wandb=True, num_devices=1)
SUITE_KW = dict(hidden_dim=16)


def _one_worker(mp, module):
    mp.setattr(module, "BatchLoader", functools.partial(module.BatchLoader, num_workers=1))


def _val_losses(out_dir):
    with open(out_dir / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _state_from_port(port_model):
    r"""A stand-in for the JAX suite's ``create_train_state`` that starts
    from the port model's weights."""
    def create(model, optimizer, rng, **kw):
        params = min_conv_rnn_params_to_jax(port_model.state_dict())
        _, state_rng = jax.random.split(rng)
        return JaxTrainState(params=params, extra_vars={}, opt_state=optimizer.init(params),
                             step=jnp.asarray(0, jnp.int32), model_state={}, rng=state_rng)
    return create


def test_suite_train_load_and_test(tmp_path, monkeypatch):
    suite = VPSuite(device="cpu")
    suite.load_dataset("MMF", **MMF)
    entry = suite.create_model(MODEL_ID, **SUITE_KW)

    with pytest.MonkeyPatch.context() as mp:
        _one_worker(mp, jax_vpsuite)
        mp.setattr(jax_vpsuite, "create_train_state", _state_from_port(entry.model))
        jax_suite = jax_vpsuite.VPSuite(device="cpu", compilation_cache=False)
        jax_suite.load_dataset("MMF", **MMF)
        jax_suite.create_model(MODEL_ID, **SUITE_KW, **JAX_ONLY)
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
    frames = _frames((2, 2, 16, 16, 3), 7)
    check = VPSuite(device="cpu")
    check.models += [entry, loaded]
    torch.testing.assert_close(check.predict(frames, pred_frames=3, model_idx=0),
                               check.predict(frames, pred_frames=3, model_idx=1), rtol=0, atol=0)

    monkeypatch.setattr(SETTINGS, "_run_path", tmp_path / "test_out")
    tester = VPSuite(device="cpu")
    tester.load_model(str(tmp_path / "port"), "best_model")
    tester.load_dataset("MMF", split="test", img_size=16, digit_source="synthetic", n_seqs=4)
    (results,) = tester.test(brief_test=True, context_frames=2, pred_frames=3,
                             metrics=["mse", "psnr"], no_vis=True, no_wandb=True)
    rows = results[loaded.model.NAME]
    assert len(rows) == 3 and all(len(r) == 2 and all(map(np.isfinite, r.values())) for r in rows)
    assert "CopyLastFrame" in results
