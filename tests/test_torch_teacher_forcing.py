r"""The ``teacher_forcing`` training regime (PhyDNet) and PhyDNet's facade run
of the port against the JAX package's, on the CPU.

- One SGD train step of PhyDNet (16x16, ``convlstm_hidden_dims=(16, 64)``,
  3 -> 3 frames, b=4) at epoch 0 (the coin is always 1: teacher forcing)
  and at epoch 400 (always 0: free running), so that no random stream has
  to match, with ``accum_steps`` 1 and 2: the losses to 1e-5 relative and
  ``(p0 - p1) / lr`` to 5e-4 of the largest of each tensor. Each JAX step
  is compiled once per ``accum_steps`` (:func:`_jax_step`; the epoch is a
  traced f32, as the JAX suite passes it).
- The coin, through a stand-in model that records what the step passes it:
  one 0-d bool tensor per microbatch on the generator's device; always 1 at
  epoch 0, always 0 at epochs 334 and 400; at epoch 200 (ratio 0.4) its
  mean over 1000 draws within 4 sigma; drawn from ``state.generator``
  (equal seeds, equal coins).
- ``create_model("phy")`` -> ``train`` (2 epochs of 2 Adam steps, b=4, 2 ->
  3 frames, ``teacher_forcing_decay=1``, so that epoch 0 is teacher-forced
  and epoch 1 free running in both packages) with the JAX suite's state
  built from the port's initial weights: validation losses to 1e-4
  relative; then ``load_model`` restores the parameters and predicts what
  the trained entry predicts, and ``test`` runs on it.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

import vp_suite_tpu.vpsuite as jax_vpsuite
from vp_suite_tpu.measure.loss_provider import PredictionLossProvider as JaxLossProvider
from vp_suite_tpu.models import MODEL_CLASSES as JAX_MODELS
from vp_suite_tpu.training import loop as jax_loop
from vp_suite_tpu.training.train_state import TrainState as JaxTrainState
from vp_suite_tpu.utils.torch_import import _import_phydnet
import vp_suite_tpu_torch.vpsuite as port_vpsuite
from vp_suite_tpu_torch import VPSuite
from vp_suite_tpu_torch.base.base_model import VPModel
from vp_suite_tpu_torch.defaults import SETTINGS
from vp_suite_tpu_torch.models import build_model
from vp_suite_tpu_torch.training.loop import make_train_step
from vp_suite_tpu_torch.training.train_state import create_train_state
from vp_suite_tpu_torch.utils.jax_params import phydnet_state_dict_from_jax

torch.set_num_threads(1)

LR = 1e-2
KW = dict(img_shape=(3, 16, 16), action_size=0, tensor_value_range=(0.0, 1.0),
          convlstm_hidden_dims=(16, 64))
RUN_CONFIG = {"context_frames": 3, "pred_frames": 3, "use_actions": False}


@functools.lru_cache(maxsize=None)
def _jax_step(accum_steps):
    r"""``(optimizer, jitted SGD train step)`` of the JAX PhyDNet, built once."""
    jmodel = JAX_MODELS["phy"](**KW)
    optimizer = optax.sgd(LR)
    lp = JaxLossProvider({"losses_and_scales": {"mse": 1.0}, "img_c": 3, "device": None})
    return optimizer, jax_loop.make_train_step(jmodel, RUN_CONFIG, optimizer, lp, donate=False,
                                               accum_steps=accum_steps)


@pytest.mark.parametrize("accum_steps", [1, 2])
@pytest.mark.parametrize("epoch", [0, 400])
def test_teacher_forcing_step_matches_jax(epoch, accum_steps):
    optimizer, jstep = _jax_step(accum_steps)
    model = build_model("phy", 0, "cpu", **KW)
    params = _import_phydnet({k: v.numpy().copy() for k, v in model.state_dict().items()})["params"]
    jstate = jax.tree.map(jnp.asarray, JaxTrainState(
        params=params, extra_vars={}, opt_state=optimizer.init(params),
        step=jnp.asarray(0, jnp.int32), model_state={}, rng=jax.random.PRNGKey(0)))
    frames = np.random.default_rng(1).random((4, 6, 16, 16, 3), dtype=np.float32)
    with jax.default_matmul_precision("highest"):
        jstate, jmetrics = jstep(jstate, {"frames": jnp.asarray(frames)},
                                 jnp.asarray(epoch, jnp.float32))

    state = create_train_state(model, lr=LR, optimizer="sgd")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state, metrics = make_train_step(model, RUN_CONFIG, accum_steps=accum_steps)(
        state, {"frames": torch.from_numpy(frames)}, epoch)
    assert set(metrics) == set(jmetrics) and state.step == 1 and state.model_state == {}
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5, err_msg=k)
    after = phydnet_state_dict_from_jax(jstate.params)
    for k, v in model.state_dict().items():
        got, want = ((before[k] - v) / LR).numpy(), ((before[k] - after[k]) / LR).numpy()
        err, scale = np.abs(got - want).max(), max(np.abs(want).max(), 1.0)
        assert err <= 5e-4 * scale, f"{k}: max |diff| {err:.3g} > 5e-4 * {scale:.3g}"


class _CoinSpy(VPModel):
    r"""A one-parameter stand-in that records the teacher-forcing flag it is given."""
    TRAIN_REGIME = "teacher_forcing"
    teacher_forcing_decay = 0.003

    def __init__(self, **hparams):
        super().__init__(**hparams)
        self.w = nn.Parameter(torch.ones(()))
        self.coins = []

    def forward(self, x, pred_frames=1, actions=None, train=False, teacher_forcing=False,
                **kwargs):
        self.coins.append(teacher_forcing)
        return x[:, 1:] * self.w, None


def _coins(epoch, steps, seed=0, accum_steps=2):
    model = _CoinSpy()
    state = create_train_state(model, lr=LR, seed=seed, optimizer="sgd")
    step = make_train_step(model, {"context_frames": 1, "pred_frames": 1},
                           accum_steps=accum_steps)
    batch = {"frames": torch.zeros((2, 2, 1, 1, 1))}
    for _ in range(steps):
        step(state, batch, epoch)
    assert len(model.coins) == accum_steps * steps
    assert all(torch.is_tensor(c) and c.shape == () and c.dtype == torch.bool
               and c.device == state.generator.device for c in model.coins)
    return torch.stack(model.coins).float()


def test_coin_per_microbatch_follows_the_ratio():
    assert bool(_coins(0, 50).all())
    assert not _coins(334, 50).any() and not _coins(400, 50).any()
    draws = _coins(200, 500)
    ratio = float(np.float32(1.0) - np.float32(200) * np.float32(0.003))
    sigma = (ratio * (1 - ratio) / draws.numel()) ** 0.5
    assert abs(draws.mean().item() - ratio) < 4 * sigma
    assert torch.equal(_coins(200, 20, seed=5), _coins(200, 20, seed=5))
    assert not torch.equal(_coins(200, 20, seed=5), _coins(200, 20, seed=6))


MMF = dict(img_size=16, digit_source="synthetic", n_seqs={"train": 8, "val": 4, "test": 4})
RUN = dict(epochs=2, batch_size=4, context_frames=2, pred_frames=3, steps_per_epoch=2,
           no_vis=True, no_wandb=True, num_devices=1)
SUITE_KW = dict(convlstm_hidden_dims=(16, 64), teacher_forcing_decay=1.0)


def _one_worker(mp, module):
    mp.setattr(module, "BatchLoader", functools.partial(module.BatchLoader, num_workers=1))


def _val_losses(out_dir):
    with open(out_dir / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _state_from_port(port_model):
    r"""A stand-in for the JAX suite's ``create_train_state`` that starts
    from the port model's weights instead of initialising its own."""
    def create(model, optimizer, rng, **kw):
        params = _import_phydnet({k: v.numpy().copy()
                                  for k, v in port_model.state_dict().items()})["params"]
        _, state_rng = jax.random.split(rng)
        return JaxTrainState(params=params, extra_vars={}, opt_state=optimizer.init(params),
                             step=jnp.asarray(0, jnp.int32), model_state={}, rng=state_rng)
    return create


def test_suite_train_load_and_test(tmp_path, monkeypatch):
    suite = VPSuite(device="cpu")
    suite.load_dataset("MMF", **MMF)
    entry = suite.create_model("phy", **SUITE_KW)

    with pytest.MonkeyPatch.context() as mp:
        _one_worker(mp, jax_vpsuite)
        mp.setattr(jax_vpsuite, "create_train_state", _state_from_port(entry.model))
        jax_suite = jax_vpsuite.VPSuite(device="cpu", compilation_cache=False)
        jax_suite.load_dataset("MMF", **MMF)
        jax_suite.create_model("phy", **SUITE_KW)
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
    assert entry.state.step == 4 and entry.state.model_state == {}

    loaded = VPSuite(device="cpu").load_model(str(tmp_path / "port"), "final_model")
    want_sd, got_sd = entry.model.state_dict(), loaded.model.state_dict()
    assert got_sd.keys() == want_sd.keys()
    assert all(torch.equal(got_sd[k], want_sd[k]) for k in want_sd)
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
