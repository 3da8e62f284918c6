r"""The compiled step's options (``use_jit``, ``donate``) and the host values
it reads as tensors, on the CPU, against the JAX package.

- The builders take the JAX package's ``use_jit`` (and ``make_train_step``
  its ``donate``) with the same defaults, and every parameter name of the
  JAX builders but ``optimizer`` (the port's state holds the optimizer); the
  port's own are ``mesh``, ``pre`` and ``post``. ``donate=False`` raises.
- On CPU tensors ``use_jit=True`` runs the eager step: for one model of each
  regime (EF-ConvLSTM, PhyDNet across the epoch where its teacher-forcing
  ratio falls to 0, PredRNN++ across the iteration where its sampling rate
  falls to 0) the train steps, ``predict`` and the eval step with
  ``use_jit=True`` and ``False`` are bit-identical, schedules included.
- The host's values enter the step as 0-d f32 tensors: PhyDNet's ratio (its
  value in f32) and PredRNN++'s rates, and with them the port matches the
  JAX package's jitted SGD step (losses to 1e-5 relative, ``(p0 - p1) / lr``
  to 5e-4 of the largest of each tensor, as the regimes' tests hold them):
  PhyDNet over epochs 0 and 400 in turn (the coin certain each time), and
  PredRNN++ under reverse scheduled sampling over its three stages (before
  ``r_sampling_step_1``, between, after ``r_sampling_step_2``), the port's
  mask draws fed the JAX step's uniform numbers.
- ``train`` builds its steps with ``use_jit=True``, and with ``False`` for
  an FVD loss.
- A checkpoint's optimizer state loads into either form of optimizer: a
  plain one's (float learning rate, host step counts, as checkpoints were
  written before the capturable form) into a capturable one with a
  learning-rate tensor, and back; ``set_learning_rate`` fills that tensor in
  place.
- The graphs' key: tensors by shape, dtype and device, floats as one static
  input, other objects by identity.
"""
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils import _pytree as pytree

from vp_suite_tpu.measure.loss_provider import PredictionLossProvider as JaxLossProvider
from vp_suite_tpu.models import MODEL_CLASSES as JAX_MODELS
from vp_suite_tpu.training import loop as jax_loop
from vp_suite_tpu.training.train_state import TrainState as JaxTrainState
from vp_suite_tpu.utils.torch_import import _import_phydnet, _import_predrnn
import vp_suite_tpu_torch.vpsuite as port_vpsuite
from vp_suite_tpu_torch import VPSuite
from vp_suite_tpu_torch.models import build_model
from vp_suite_tpu_torch.training import loop
from vp_suite_tpu_torch.training.graphs import _signature
from vp_suite_tpu_torch.training.loop import make_eval_step, make_predict_fn, make_train_step
from vp_suite_tpu_torch.training.schedule import set_learning_rate
from vp_suite_tpu_torch.training.train_state import (create_train_state, load_optimizer_state,
                                                     optimizer_state_dict)
from vp_suite_tpu_torch.utils.jax_params import (phydnet_state_dict_from_jax,
                                                 predrnn_state_dict_from_jax)

torch.set_num_threads(1)

LR = 1e-2
RUN = {"context_frames": 3, "pred_frames": 3, "use_actions": False}
BASE = dict(img_shape=(3, 16, 16), action_size=0, tensor_value_range=(0.0, 1.0))
#: one model per training regime: name -> (registry id, configuration, epochs of its steps)
REGIMES = {
    "default": ("convlstm-shi", {}, (0, 0, 0)),
    "teacher_forcing": ("phy", dict(convlstm_hidden_dims=(16, 64)), (0, 0, 334, 334)),
    "scheduled_sampling": ("predrnn-pp", dict(num_hidden=(8, 8, 8)), (0, 0, 0, 0)),
}
#: PredRNN++ under reverse scheduled sampling, whose stages the steps cross
RSS = dict(num_hidden=(8, 8, 8), reverse_scheduled_sampling=True, r_sampling_step_1=2,
           r_sampling_step_2=4, r_exp_alpha=2)
RSS_ITERATIONS = (1, 2, 3, 4)


def _frames(seed, b=4):
    return np.random.default_rng(seed).random((b, 6, 16, 16, 3), dtype=np.float32)


@pytest.mark.parametrize("name", ["make_train_step", "make_eval_step", "make_predict_fn"])
def test_builders_take_the_jax_compile_options(name):
    port = inspect.signature(getattr(loop, name)).parameters
    jax_ = inspect.signature(getattr(jax_loop, name)).parameters
    assert set(jax_) - {"optimizer"} <= set(port)
    assert set(port) - set(jax_) <= {"mesh", "pre", "post"}
    for option in ("use_jit", "donate"):
        if option in jax_:
            assert port[option].default is jax_[option].default is True


def test_donate_false_raises():
    model = build_model("convlstm-shi", 0, "cpu", **BASE)
    with pytest.raises(ValueError, match="donate=False"):
        make_train_step(model, RUN, donate=False)


def _regime_state(name, model):
    state = create_train_state(model, lr=LR, optimizer="sgd")
    if name == "scheduled_sampling":   # the rate falls to 0 at the third step
        state.model_state = {"training_iteration": model.sampling_stop_iter - 2,
                             "sampling_eta": 0.5}
    return state


@pytest.mark.parametrize("name", list(REGIMES))
def test_cpu_compiled_step_is_the_eager_step(name):
    model_id, cfg, epochs = REGIMES[name]
    models = [build_model(model_id, 0, "cpu", **BASE, **cfg) for _ in range(2)]
    states = [_regime_state(name, m) for m in models]
    steps = [make_train_step(m, RUN, use_jit=j == 0) for j, m in enumerate(models)]
    batch = {"frames": torch.from_numpy(_frames(3))}
    for epoch in epochs:
        metrics = [step(s, batch, epoch)[1] for step, s in zip(steps, states)]
        assert all(torch.equal(metrics[0][k], metrics[1][k]) for k in metrics[1])
        assert states[0].model_state == states[1].model_state
    assert not steps[0].compiled.graphs, "no graph on the CPU"
    for a, b in zip(*(m.state_dict().values() for m in models)):
        assert torch.equal(a, b)
    for make in (make_predict_fn, make_eval_step):
        args = (batch,) if make is make_predict_fn else (None, batch)
        got = [pytree.tree_flatten(make(m, RUN, use_jit=j == 0)(*args))[0]
               for j, m in enumerate(models)]
        assert all(torch.equal(a, b) for a, b in zip(*got))


def _recording_scalars(step):
    r"""Makes the compiled step ``step`` record the host values it is given."""
    seen = []
    fn = step.compiled.fn

    def recording(state, generator, batch, scalars):
        seen.append(scalars)
        return fn(state, generator, batch, scalars)
    step.compiled.fn = recording
    return seen


@functools.lru_cache(maxsize=None)
def _jax_phydnet_step():
    jmodel = JAX_MODELS["phy"](**BASE, convlstm_hidden_dims=(16, 64))
    optimizer = optax.sgd(LR)
    lp = JaxLossProvider({"losses_and_scales": {"mse": 1.0}, "img_c": 3, "device": None})
    return optimizer, jax_loop.make_train_step(jmodel, RUN, optimizer, lp, donate=False)


def test_teacher_forcing_ratio_as_a_tensor_matches_jax_across_epochs():
    optimizer, jstep = _jax_phydnet_step()
    model = build_model("phy", 0, "cpu", **BASE, convlstm_hidden_dims=(16, 64))
    params = _import_phydnet({k: v.numpy().copy() for k, v in model.state_dict().items()})["params"]
    jstate = jax.tree.map(jnp.asarray, JaxTrainState(
        params=params, extra_vars={}, opt_state=optimizer.init(params),
        step=jnp.asarray(0, jnp.int32), model_state={}, rng=jax.random.PRNGKey(0)))
    state = create_train_state(model, lr=LR, optimizer="sgd")
    step = make_train_step(model, RUN)
    seen = _recording_scalars(step)
    frames = _frames(1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for epoch in (0, 400):
        with jax.default_matmul_precision("highest"):
            jstate, jmetrics = jstep(jstate, {"frames": jnp.asarray(frames)},
                                     jnp.asarray(epoch, jnp.float32))
        _, metrics = step(state, {"frames": torch.from_numpy(frames)}, epoch)
        ratio = seen[-1]["ratio"]
        assert torch.is_tensor(ratio) and ratio.shape == () and ratio.dtype == torch.float32
        assert float(ratio) == max(0.0, float(np.float32(1) - np.float32(epoch) * np.float32(0.003)))
        for k in jmetrics:
            np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5, err_msg=k)
    after = phydnet_state_dict_from_jax(jstate.params)
    for k, v in model.state_dict().items():
        got, want = ((before[k] - v) / LR).numpy(), ((before[k] - after[k]) / LR).numpy()
        err, scale = np.abs(got - want).max(), max(np.abs(want).max(), 1.0)
        assert err <= 5e-4 * scale, f"{k}: max |diff| {err:.3g} > 5e-4 * {scale:.3g}"


@functools.lru_cache(maxsize=None)
def _jax_predrnn_step():
    jmodel = JAX_MODELS["predrnn-pp"](**BASE, **RSS, scan_unroll=1)
    optimizer = optax.sgd(LR)
    lp = JaxLossProvider({"losses_and_scales": {"mse": 1.0}, "img_c": 3, "device": None})
    return jmodel, optimizer, jax_loop.make_train_step(jmodel, RUN, optimizer, lp, donate=False)


def _jax_flips(rng, b, reverse_input):
    r"""The uniform numbers the JAX step's masks compare with the rates, in
    the order the port draws them, and the key of the next step."""
    rng, step_rng = jax.random.split(rng)
    keys = jax.random.split(step_rng, 3)[:2 if reverse_input else 1]
    flips = []
    for key in keys:
        k1, k2 = jax.random.split(key)
        flips += [jax.random.uniform(k1, (b, RUN["context_frames"] - 1)),
                  jax.random.uniform(k2, (b, RUN["pred_frames"] - 1))]
    return [torch.from_numpy(np.array(f)) for f in flips], rng


def test_sampling_rates_as_tensors_match_jax_across_stages(monkeypatch):
    jmodel, optimizer, jstep = _jax_predrnn_step()
    model = build_model("predrnn-pp", 0, "cpu", **BASE, **RSS)
    params = _import_predrnn({k: v.numpy().copy() for k, v in model.state_dict().items()})["params"]
    start = {**jmodel.init_model_state(), "training_iteration": RSS_ITERATIONS[0]}
    jstate = jax.tree.map(jnp.asarray, JaxTrainState(
        params=params, extra_vars={}, opt_state=optimizer.init(params),
        step=jnp.asarray(0, jnp.int32), model_state=start, rng=jax.random.PRNGKey(0)))
    state = create_train_state(model, lr=LR, optimizer="sgd")
    state.model_state = dict(start)
    step = make_train_step(model, RUN)
    seen = _recording_scalars(step)
    frames = _frames(2)
    queue = []
    rand = torch.rand
    monkeypatch.setattr(torch, "rand", lambda *a, **k: queue.pop(0))
    rng = jstate.rng
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for itr in RSS_ITERATIONS:
        queue[:], rng = _jax_flips(rng, 4, model.reverse_input)
        with jax.default_matmul_precision("highest"):
            jstate, jmetrics = jstep(jstate, {"frames": jnp.asarray(frames)}, jnp.asarray(0.0))
        _, metrics = step(state, {"frames": torch.from_numpy(frames)})
        assert not queue and state.model_state["training_iteration"] == itr + 1
        rates = seen[-1]["rates"]
        assert all(torch.is_tensor(r) and r.shape == () and r.dtype == torch.float32
                   for r in rates.values())
        want = model.sampling_rates({"training_iteration": itr, "sampling_eta": 1.0})[0]
        assert {k: float(v) for k, v in rates.items()} == \
            {k: float(np.float32(v)) for k, v in want.items()}
        np.testing.assert_allclose(float(metrics["total"]), float(jmetrics["total"]), rtol=1e-5)
    monkeypatch.setattr(torch, "rand", rand)
    after = predrnn_state_dict_from_jax(jstate.params)
    for k, v in model.state_dict().items():
        got, want = ((before[k] - v) / LR).numpy(), ((before[k] - after[k]) / LR).numpy()
        err, scale = np.abs(got - want).max(), max(np.abs(want).max(), 1.0)
        assert err <= 5e-4 * scale, f"{k}: max |diff| {err:.3g} > 5e-4 * {scale:.3g}"


@pytest.mark.parametrize("losses", [{"mse": 1.0}, {"mse": 1.0, "fvd": 1.0}], ids=["mse", "fvd"])
def test_train_compiles_its_steps_unless_a_loss_reads_back(losses, monkeypatch, tmp_path):
    asked = []
    for name in ("make_train_step", "make_eval_step", "make_predict_fn"):
        def recording(*args, _make=getattr(port_vpsuite, name), **kwargs):
            asked.append(kwargs["use_jit"])
            return _make(*args, **kwargs)
        monkeypatch.setattr(port_vpsuite, name, recording)
    suite = VPSuite(device="cpu")
    suite.load_dataset("MMF", img_size=16, digit_source="synthetic",
                       n_seqs={"train": 4, "val": 2, "test": 2})
    suite.create_model("convlstm-shi")
    suite.train(epochs=1, batch_size=2, context_frames=2, pred_frames=2, steps_per_epoch=2,
                no_vis=True, no_wandb=True, losses_and_scales=losses, out_dir=str(tmp_path))
    assert asked == [losses == {"mse": 1.0}] * 3


def test_optimizer_state_loads_into_either_form():
    plain_model = build_model("convlstm-shi", 0, "cpu", **BASE)
    plain = create_train_state(plain_model, lr=3e-3)
    make_train_step(plain_model, RUN)(plain, {"frames": torch.from_numpy(_frames(4, b=2))})
    saved = optimizer_state_dict(plain.optimizer)
    assert isinstance(saved["param_groups"][0]["lr"], float)

    params = list(build_model("convlstm-shi", 0, "cpu", **BASE).parameters())
    lr = torch.tensor(1e-4)
    graphable = torch.optim.Adam(params, lr=lr, capturable=True)
    load_optimizer_state(graphable, saved)
    group = graphable.param_groups[0]
    assert group["lr"] is lr and float(lr) == pytest.approx(3e-3) and group["capturable"]
    for p, q in zip(plain_model.parameters(), params):
        a, b = plain.optimizer.state[p], graphable.state[q]
        assert torch.equal(a["exp_avg"], b["exp_avg"]) and torch.equal(a["exp_avg_sq"],
                                                                        b["exp_avg_sq"])
        assert float(b["step"]) == 1.0 and b["step"].dtype == torch.float32

    back = torch.optim.Adam(list(build_model("convlstm-shi", 0, "cpu", **BASE).parameters()),
                            lr=1e-4)
    load_optimizer_state(back, optimizer_state_dict(graphable))
    assert back.param_groups[0]["lr"] == pytest.approx(3e-3)
    assert not back.param_groups[0]["capturable"]

    state = create_train_state(plain_model)
    state.optimizer = graphable
    set_learning_rate(state, 5e-4)
    assert graphable.param_groups[0]["lr"] is lr and float(lr) == pytest.approx(5e-4)


def test_graph_key():
    state = object()
    a = _signature([torch.zeros(2, 3), 0.5, state, None])
    assert a == _signature([torch.ones(2, 3), 0.7, state, None])
    assert a != _signature([torch.zeros(3, 3), 0.5, state, None])
    assert a != _signature([torch.zeros(2, 3, dtype=torch.float64), 0.5, state, None])
    assert a != _signature([torch.zeros(2, 3), 0.5, object(), None])
