r"""The ``scheduled_sampling`` training regime (PredRNN++) and the UNet-3D and
PredRNN++ facade runs of the port against the JAX package's, on the CPU.

- One SGD train step on masks that both packages draw alike: standard
  scheduled sampling from ``training_iteration`` = ``sampling_stop_iter``
  on (all zeros; with ``reverse_input``, a batch of 2b), reverse scheduled
  sampling from ``r_sampling_step_2`` on (``r_eta`` 1 and ``eta2`` 0), and
  the first with ``accum_steps`` 2. Losses to 1e-5 relative, ``(p0 - p1) /
  lr`` to 2e-4 of the largest of each tensor, the schedules
  (``model_state``) exactly.
- The schedule's arithmetic alone, where the masks are random: after 1, 2
  and 3 steps, with and without ``reverse_input`` (one or two mask draws,
  so eta decays once or twice a step), with ``accum_steps`` 1 and 2 (the
  schedule microbatch 0 leaves), ``sampling_eta`` and
  ``training_iteration`` exactly as the JAX package's.
- The JAX models run their time loop as a rolled ``lax.scan``
  (``scan_unroll=1``, the same function; it compiles faster), and each
  JAX train step is built and compiled once per configuration and shared
  by the cases that run it (:func:`_jax_step`).
- ``create_model`` -> ``train`` (2 epochs of 2 Adam steps, b=4, 2 -> 3
  frames) for UNet-3D (``temporal_dim=2``, two levels) and PredRNN++
  (``num_hidden=(8, 8, 8)``, ``sampling_stop_iter=0`` so that every
  training mask is all zeros in both packages), with the JAX suite's state
  built from the port's initial weights: validation losses to 1e-4
  relative; then ``load_model`` restores the parameters, the BatchNorm
  statistics and the schedule, predicts what the trained entry predicts,
  and ``test`` runs on it.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import vp_suite_tpu.vpsuite as jax_vpsuite
from vp_suite_tpu.measure.loss_provider import PredictionLossProvider as JaxLossProvider
from vp_suite_tpu.models import MODEL_CLASSES as JAX_MODELS
from vp_suite_tpu.training import loop as jax_loop
from vp_suite_tpu.training.train_state import TrainState as JaxTrainState
from vp_suite_tpu.utils.torch_import import _import_predrnn, _import_unet3d
import vp_suite_tpu_torch.vpsuite as port_vpsuite
from vp_suite_tpu_torch import VPSuite
from vp_suite_tpu_torch.defaults import SETTINGS
from vp_suite_tpu_torch.models import build_model
from vp_suite_tpu_torch.training.loop import make_train_step
from vp_suite_tpu_torch.training.train_state import create_train_state
from vp_suite_tpu_torch.utils.jax_params import predrnn_state_dict_from_jax

torch.set_num_threads(1)

LR = 1e-2
KW = dict(img_shape=(3, 16, 16), action_size=0, tensor_value_range=(0.0, 1.0),
          num_hidden=(8, 8, 8))
#: the JAX models' own knob: the time loop as a rolled scan (the same function)
JAX_ONLY = dict(scan_unroll=1)
RUN_CONFIG = {"context_frames": 3, "pred_frames": 3, "use_actions": False}
#: case -> (configuration, accum_steps, training_iteration to start from)
STEP_CASES = {
    "stopped": ({}, 1, 50000),
    "reverse_late": (dict(reverse_scheduled_sampling=True, r_sampling_step_1=0,
                          r_sampling_step_2=1), 1, 1),
    "stopped_accum_steps_2": ({}, 2, 50000),
}


@functools.lru_cache(maxsize=None)
def _jax_step(cfg_items, accum_steps):
    r"""``(JAX model, optimizer, jitted SGD train step)`` of the configuration
    ``cfg_items`` (a sorted tuple of KW's overrides), built once."""
    jmodel = JAX_MODELS["predrnn-pp"](**KW, **dict(cfg_items), **JAX_ONLY)
    optimizer = optax.sgd(LR)
    lp = JaxLossProvider({"losses_and_scales": {"mse": 1.0}, "img_c": 3, "device": None})
    return jmodel, optimizer, jax_loop.make_train_step(jmodel, RUN_CONFIG, optimizer, lp,
                                                       donate=False, accum_steps=accum_steps)


def _pair(cfg, accum_steps, training_iteration=1):
    r"""The port's model, train state and step, and the JAX model's state and
    step, on the port's weights, both schedules at ``training_iteration``."""
    jmodel, optimizer, jstep = _jax_step(tuple(sorted(cfg.items())), accum_steps)
    model = build_model("predrnn-pp", 0, "cpu", **KW, **cfg)
    params = _import_predrnn({k: v.numpy().copy() for k, v in model.state_dict().items()})["params"]
    start = {**jmodel.init_model_state(), "training_iteration": training_iteration}
    # every leaf a JAX array, the schedule typed as the step returns it
    # (weakly typed from one microbatch, strongly from accum_steps' scan), so
    # that the step compiles once
    typed = {k: jnp.asarray(v, None if accum_steps == 1 else jnp.asarray(v).dtype)
             for k, v in start.items()}
    jstate = jax.tree.map(jnp.asarray, JaxTrainState(
        params=params, extra_vars={}, opt_state=optimizer.init(params),
        step=jnp.asarray(0, jnp.int32), model_state=typed, rng=jax.random.PRNGKey(0)))
    state = create_train_state(model, lr=LR, optimizer="sgd")
    state.model_state = dict(start)
    return model, state, make_train_step(model, RUN_CONFIG, accum_steps=accum_steps), jstate, jstep


def _same_schedule(port_state, jax_state):
    got, want = port_state.model_state, jax_state.model_state
    assert got["training_iteration"] == int(want["training_iteration"])
    assert got["sampling_eta"] == float(np.float32(want["sampling_eta"]))


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_scheduled_sampling_step_matches_jax(case):
    cfg, accum_steps, itr = STEP_CASES[case]
    model, state, step, jstate, jstep = _pair(cfg, accum_steps, itr)
    frames = np.random.default_rng(1).random((4, 6, 16, 16, 3), dtype=np.float32)
    with jax.default_matmul_precision("highest"):
        jstate, jmetrics = jstep(jstate, {"frames": jnp.asarray(frames)}, jnp.asarray(0.0))

    before = {k: v.clone() for k, v in model.state_dict().items()}
    state, metrics = step(state, {"frames": torch.from_numpy(frames)})
    np.testing.assert_allclose(float(metrics["total"]), float(jmetrics["total"]), rtol=1e-5)
    _same_schedule(state, jstate)
    assert state.model_state["training_iteration"] == itr + 1
    after = predrnn_state_dict_from_jax(jstate.params)
    for k, v in model.state_dict().items():
        got, want = ((before[k] - v) / LR).numpy(), ((before[k] - after[k]) / LR).numpy()
        err, scale = np.abs(got - want).max(), max(np.abs(want).max(), 1.0)
        assert err <= 2e-4 * scale, f"{k}: max |diff| {err:.3g} > 2e-4 * {scale:.3g}"


@pytest.mark.parametrize("accum_steps", [1, 2])
@pytest.mark.parametrize("reverse_input", [False, True], ids=["forward", "reverse_input"])
def test_schedule_matches_jax(reverse_input, accum_steps):
    cfg = {} if reverse_input else dict(reverse_input=False)
    _, state, step, jstate, jstep = _pair(cfg, accum_steps)
    frames = np.random.default_rng(2).random((4, 6, 16, 16, 3), dtype=np.float32)
    draws = 2 if reverse_input else 1
    eta = np.float32(1.0)
    for n in range(1, 4):
        with jax.default_matmul_precision("highest"):   # as the step test: the same compile
            jstate, _ = jstep(jstate, {"frames": jnp.asarray(frames)}, jnp.asarray(0.0))
        state, _ = step(state, {"frames": torch.from_numpy(frames)})
        _same_schedule(state, jstate)
        for _ in range(draws):
            eta = np.float32(eta - np.float32(2e-5))
        assert state.model_state == {"training_iteration": 1 + n, "sampling_eta": float(eta)}


MMF = dict(img_size=16, digit_source="synthetic", n_seqs={"train": 8, "val": 4, "test": 4})
RUN = dict(epochs=2, batch_size=4, context_frames=2, pred_frames=3, steps_per_epoch=2,
           no_vis=True, no_wandb=True, num_devices=1)
SUITE_MODELS = {"unet-3d": dict(temporal_dim=2, features=(4, 8)),
                "predrnn-pp": dict(num_hidden=(8, 8, 8), sampling_stop_iter=0)}


def _one_worker(mp, module):
    mp.setattr(module, "BatchLoader", functools.partial(module.BatchLoader, num_workers=1))


def _val_losses(out_dir):
    with open(out_dir / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _state_from_port(port_model):
    r"""A stand-in for the JAX suite's ``create_train_state`` that starts
    from the port model's weights (through the JAX package's importer of
    reference checkpoints) instead of initialising its own."""
    def create(model, optimizer, rng, **kw):
        sd = {k: v.numpy().copy() for k, v in port_model.state_dict().items()}
        if isinstance(model, JAX_MODELS["unet-3d"]):
            variables = _import_unet3d(sd)
        else:
            variables = _import_predrnn(sd)
        _, state_rng = jax.random.split(rng)
        return JaxTrainState(params=variables["params"],
                             extra_vars={k: v for k, v in variables.items() if k != "params"},
                             opt_state=optimizer.init(variables["params"]),
                             step=jnp.asarray(0, jnp.int32),
                             model_state=model.init_model_state(), rng=state_rng)
    return create


@pytest.mark.parametrize("model_id", list(SUITE_MODELS))
def test_suite_train_load_and_test(model_id, tmp_path, monkeypatch):
    suite = VPSuite(device="cpu")
    suite.load_dataset("MMF", **MMF)
    entry = suite.create_model(model_id, **SUITE_MODELS[model_id])

    with pytest.MonkeyPatch.context() as mp:
        _one_worker(mp, jax_vpsuite)
        mp.setattr(jax_vpsuite, "create_train_state", _state_from_port(entry.model))
        jax_suite = jax_vpsuite.VPSuite(device="cpu", compilation_cache=False)
        jax_suite.load_dataset("MMF", **MMF)
        jax_suite.create_model(model_id, **SUITE_MODELS[model_id],
                               **(JAX_ONLY if model_id == "predrnn-pp" else {}))
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
    if model_id == "predrnn-pp":
        assert entry.state.model_state == {"training_iteration": 5, "sampling_eta": 0.0}

    loaded = VPSuite(device="cpu").load_model(str(tmp_path / "port"), "final_model")
    want_sd, got_sd = entry.model.state_dict(), loaded.model.state_dict()
    assert got_sd.keys() == want_sd.keys()
    assert all(torch.equal(got_sd[k], want_sd[k]) for k in want_sd)
    assert loaded.state.model_state == entry.state.model_state
    frames = np.random.default_rng(4).random((2, 2, 16, 16, 3)).astype(np.float32)
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
