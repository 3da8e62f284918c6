r"""ST-Phy (``models/st_phy.py``) of the port against the JAX package's, on the
CPU, in f32 under ``jax.default_matmul_precision("highest")``, on the port's
weights carried into JAX (``st_phy_params_to_jax``), at 2 layers of 8
channels and a 3x3 PhyCell of 9, 3 -> 2 frames (4 steps).

- The converter: random JAX-layout parameters (shapes from
  ``jax.eval_shape`` of the JAX model's init) -> the port -> JAX, bit for
  bit, plain and action-conditional; ``load_jax_params`` takes them
  strictly, and the JAX package's importer of reference checkpoints reads
  the port's ``state_dict`` as ``st_phy_params_to_jax`` does.
- The train-mode forward at teacher forcing 1 and 0 (predictions to 1e-4,
  both losses to 1e-5 relative) with the gradients of the summed MSE plus
  both losses (2e-4 of the largest of each tensor; the parameters that feed
  nothing get none in the port and zeros in JAX), and the eval-mode forward
  (1e-4): plain and action-conditional at 32x32, and plain at 35x35, where
  the decoder's 36x36 is shrunk by the antialiased resize. Each JAX function
  is compiled once per configuration (the flag a traced argument).
- The loss dict at ``moment_loss_scale=2.0``: the scale applied twice.
- One SGD train step through ``make_train_step`` (the teacher-forcing
  regime) at epoch 0 (teacher forced) and 400 (free running), plain and
  action-conditional, as ``(p0 - p1) / lr`` to 5e-4 of the largest.
- Under ``compute_dtype=bfloat16``: every convolution in bf16 in both
  packages (counted against ``jax.make_jaxpr``), the predictions bf16, both
  losses f32; the action-conditional model, which the JAX package cannot
  trace in bf16 (its PhyCell promotes the carry to f32 with the actions),
  runs every convolution and the action inflation's product in bf16.
- 16x16, whose code would be empty: the JAX model's encoder gives a 0x0
  code, the port refuses with ``ValueError``.
- ``create_model`` -> ``train`` (2 epochs of 2 Adam steps, b=4, 2 -> 3
  frames at 32x32, ``teacher_forcing_decay=1``) against the JAX suite's run
  from the same initial weights (validation losses to 1e-4 relative), then
  ``load_model``.
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
from vp_suite_tpu.model_blocks.enc import Autoencoder as JaxAutoencoder
from vp_suite_tpu.models import MODEL_CLASSES as JAX_MODELS
from vp_suite_tpu.training import loop as jax_loop
from vp_suite_tpu.training.train_state import TrainState as JaxTrainState
from vp_suite_tpu.utils import torch_import
import vp_suite_tpu_torch.vpsuite as port_vpsuite
from vp_suite_tpu_torch import VPSuite
from vp_suite_tpu_torch.models import build_model
from vp_suite_tpu_torch.training.loop import make_train_step
from vp_suite_tpu_torch.training.train_state import create_train_state
from vp_suite_tpu_torch.utils.jax_params import (load_jax_params, st_phy_params_to_jax,
                                                 st_phy_state_dict_from_jax)

torch.set_num_threads(1)

MODEL_ID = "st-phy"
B, CTX, PRED, A = 2, 3, 2, 3
LR = 1e-2
SMALL = dict(num_layers=2, st_cell_channels=8, phycell_channels=9, phycell_kernel_size=(3, 3))
KW = dict(img_shape=(3, 32, 32), action_size=0, tensor_value_range=(0.0, 1.0), **SMALL)
#: the JAX model's own knob: no rematerialization (the same function; it compiles faster)
JAX_ONLY = dict(remat=False)
CONFIGS = {"plain": {}, "action_conditional": dict(action_conditional=True, action_size=A),
           "shrink_35": dict(img_shape=(3, 35, 35))}
LOSSES = ("moment regularization loss", "memory decoupling loss")


def _kwargs(name, **extra):
    return {**KW, **CONFIGS[name], **extra}


def _pair(name, **extra):
    r"""The port's model (seed 0) and the JAX model with the port's weights."""
    model = build_model(MODEL_ID, 0, "cpu", **_kwargs(name, **extra))
    return model, JAX_MODELS[MODEL_ID](**_kwargs(name, **extra), **JAX_ONLY), \
        st_phy_params_to_jax(model.state_dict())


def _inputs(name, seed=1):
    c, h, w = _kwargs(name)["img_shape"]
    rng = np.random.default_rng(seed)
    x = rng.random((B, CTX + PRED, h, w, c), dtype=np.float32)
    actions = rng.random((B, CTX + PRED, A), dtype=np.float32) \
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


@pytest.mark.parametrize("name", ["plain", "action_conditional"])
def test_converter_round_trip_is_exact(name):
    x, actions = _inputs(name)
    jmodel = JAX_MODELS[MODEL_ID](**_kwargs(name))
    shapes = jax.eval_shape(lambda x, a: jmodel.init(jax.random.PRNGKey(0), x, pred_frames=1,
                                                     actions=a),
                            jnp.asarray(x[:, :2]), _jnp(actions))["params"]
    rng = np.random.default_rng(1)
    params = {k: rng.standard_normal(v.shape, dtype=np.float32) for k, v in shapes.items()}
    back = st_phy_params_to_jax(st_phy_state_dict_from_jax(params))
    assert back.keys() == params.keys()
    assert all(back[k].dtype == np.float32 and np.array_equal(back[k], params[k]) for k in params)
    model = load_jax_params(build_model(MODEL_ID, 0, "cpu", **_kwargs(name)), params)
    sd = model.state_dict()
    assert all(np.array_equal(v, params[k]) for k, v in st_phy_params_to_jax(sd).items())
    imported = torch_import.import_state_dict(MODEL_ID, sd)["params"]
    assert imported.keys() == params.keys()
    assert all(np.array_equal(np.asarray(imported[k]), params[k]) for k in params)


def _loss(preds, aux, target):
    return ((preds - target) ** 2).sum(axis=(2, 3, 4)).mean() + sum(aux[k] for k in LOSSES)


@functools.lru_cache(maxsize=None)
def _jax_fns(name):
    r"""The JAX model's jitted loss-and-gradients (the teacher-forcing flag a
    traced argument) and eval forward, compiled once per configuration."""
    jmodel = JAX_MODELS[MODEL_ID](**_kwargs(name), **JAX_ONLY)

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
    model, _, params = _pair(name)
    x, actions = _inputs(name)
    _, h, w = _kwargs(name)["img_shape"]
    grad_fn, eval_fn = _jax_fns(name)
    with jax.default_matmul_precision("highest"):
        (jl, (jpreds, jaux)), jgrads = grad_fn(params, jnp.asarray(x), _jnp(actions),
                                               jnp.asarray(float(tf)))
        eval_preds, _ = eval_fn(params, jnp.asarray(x[:, :CTX]), _jnp(actions))

    preds, aux = model(torch.from_numpy(x), pred_frames=PRED, actions=_tensor(actions),
                       train=True, teacher_forcing=torch.tensor(bool(tf)))
    assert preds.shape == (B, CTX + PRED - 1, h, w, 3) and set(aux) == set(LOSSES)
    loss = _loss(preds, aux, torch.from_numpy(x[:, 1:]))
    loss.backward()
    np.testing.assert_allclose(preds.detach().numpy(), np.asarray(jpreds), rtol=1e-4, atol=1e-4)
    for k in LOSSES:
        np.testing.assert_allclose(float(aux[k].detach()), float(jaux[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    got = st_phy_params_to_jax({k: torch.zeros_like(p) if p.grad is None else p.grad
                                for k, p in model.named_parameters()})
    assert got.keys() == jgrads.keys()
    for k in jgrads:
        assert_close_to_largest(got[k], jgrads[k], 2e-4, k)

    with torch.no_grad():
        got, aux = model(torch.from_numpy(x[:, :CTX]), pred_frames=PRED,
                         actions=_tensor(actions))
    assert aux is None and got.shape == (B, PRED, h, w, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(eval_preds), rtol=1e-4, atol=1e-4)


def test_moment_loss_scale_is_applied_twice_as_in_jax():
    model, jmodel, params = _pair("plain", moment_loss_scale=2.0)
    base = build_model(MODEL_ID, 0, "cpu", **_kwargs("plain"))
    x, _ = _inputs("plain")
    with jax.default_matmul_precision("highest"):
        _, jaux = jmodel.apply({"params": params}, jnp.asarray(x), pred_frames=PRED, train=True,
                               teacher_forcing=1.0)
    with torch.no_grad():
        _, aux = model(torch.from_numpy(x), pred_frames=PRED, train=True, teacher_forcing=1)
        _, base_aux = base(torch.from_numpy(x), pred_frames=PRED, train=True, teacher_forcing=1)
    assert set(aux) == set(jaux) == set(LOSSES)
    for k in LOSSES:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5, err_msg=k)
    m = "moment regularization loss"
    np.testing.assert_allclose(float(aux[m]), 4.0 * float(base_aux[m]), rtol=1e-6)


@functools.lru_cache(maxsize=None)
def _jax_step(name):
    r"""``(optimizer, jitted SGD train step)`` of the JAX model, built once."""
    optimizer = optax.sgd(LR)
    lp = JaxLossProvider({"losses_and_scales": {"mse": 1.0}, "img_c": 3, "device": None})
    jmodel = JAX_MODELS[MODEL_ID](**_kwargs(name), **JAX_ONLY)
    return optimizer, jax_loop.make_train_step(jmodel, _run_config(name), optimizer, lp,
                                               donate=False)


def _run_config(name):
    return {"context_frames": CTX, "pred_frames": PRED,
            "use_actions": name == "action_conditional"}


@pytest.mark.parametrize("epoch", [0, 400], ids=["teacher_forced", "free_running"])
@pytest.mark.parametrize("name", ["plain", "action_conditional"])
def test_sgd_step_matches_jax(name, epoch):
    optimizer, jstep = _jax_step(name)
    model, _, params = _pair(name)
    jstate = jax.tree.map(jnp.asarray, JaxTrainState(
        params=params, extra_vars={}, opt_state=optimizer.init(params),
        step=jnp.asarray(0, jnp.int32), model_state={}, rng=jax.random.PRNGKey(0)))
    x, actions = _inputs(name, seed=5)
    batch = {"frames": x} if actions is None else {"frames": x, "actions": actions}
    with jax.default_matmul_precision("highest"):
        jstate, jmetrics = jstep(jstate, jax.tree.map(jnp.asarray, batch),
                                 jnp.asarray(epoch, jnp.float32))
    state = create_train_state(model, lr=LR, optimizer="sgd")
    before = st_phy_params_to_jax(model.state_dict())
    state, metrics = make_train_step(model, _run_config(name))(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, epoch)
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5, err_msg=k)
    after = st_phy_params_to_jax(model.state_dict())
    for k, p0 in before.items():
        assert_close_to_largest((p0 - after[k]) / LR, (p0 - np.asarray(jstate.params[k])) / LR,
                                5e-4, k)


class _Dtypes(TorchFunctionMode):
    r"""Records the input dtype of every convolution and linear."""

    def __init__(self):
        super().__init__()
        self.convs, self.linears = [], []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in ("conv2d", "conv_transpose2d"):
            self.convs.append(str(args[0].dtype).removeprefix("torch."))
        elif name == "linear":
            self.linears.append(str(args[0].dtype).removeprefix("torch."))
        return func(*args, **(kwargs or {}))


def _jaxpr_dtypes(jaxpr, primitive):
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == primitive:
            out.append(str(eqn.invars[0].aval.dtype))
        for p in eqn.params.values():
            for sub in p if isinstance(p, (list, tuple)) else (p,):
                sub = getattr(sub, "jaxpr", sub)
                if hasattr(sub, "eqns"):
                    out += _jaxpr_dtypes(sub, primitive)
    return out


def _port_bf16(name):
    model = build_model(MODEL_ID, 0, "cpu", **_kwargs(name), compute_dtype=torch.bfloat16)
    x, actions = _inputs(name)
    with _Dtypes() as rec, torch.no_grad():
        preds, aux = model(torch.from_numpy(x).bfloat16(), pred_frames=PRED,
                           actions=_tensor(actions), train=True, teacher_forcing=1)
    return model, rec, preds, aux


def test_bf16_flow_matches_jax():
    model, rec, preds, aux = _port_bf16("plain")
    jmodel = JAX_MODELS[MODEL_ID](**_kwargs("plain"), compute_dtype=jnp.bfloat16, **JAX_ONLY)
    x, _ = _inputs("plain")
    jaxpr = jax.make_jaxpr(lambda p, x: jmodel.apply(
        {"params": p}, x, pred_frames=PRED, train=True, teacher_forcing=1.0))(
        st_phy_params_to_jax(model.state_dict()), jnp.asarray(x.astype(jnp.bfloat16)))
    want_convs = _jaxpr_dtypes(jaxpr.jaxpr, "conv_general_dilated")
    assert set(want_convs) == set(rec.convs) == {"bfloat16"} and len(rec.convs) > 20
    assert preds.dtype == torch.bfloat16 and str(jaxpr.out_avals[0].dtype) == "bfloat16"
    for k, aval in zip(sorted(LOSSES), jaxpr.out_avals[1:]):    # flax returns the dict sorted
        assert aux[k].dtype == torch.float32 and str(aval.dtype) == "float32", k


def test_bf16_action_conditional_runs_in_bf16():
    r"""The action-conditional model in bf16: the JAX model's PhyCell
    concatenates the f32 actions to its bf16 input, so its time loop's carry
    turns f32 and it does not trace; the port casts the actions to the
    activations' dtype, and every convolution and the inflation's product run
    in bf16."""
    jmodel = JAX_MODELS[MODEL_ID](**_kwargs("action_conditional"), compute_dtype=jnp.bfloat16,
                                  **JAX_ONLY)
    _, rec, preds, aux = _port_bf16("action_conditional")
    x, actions = _inputs("action_conditional")
    with pytest.raises(TypeError, match="carry"):
        jax.eval_shape(lambda x, a: jmodel.init(jax.random.PRNGKey(0), x, pred_frames=PRED,
                                                actions=a, train=True, teacher_forcing=1.0),
                       jnp.asarray(x.astype(jnp.bfloat16)), jnp.asarray(actions))
    assert set(rec.convs) == {"bfloat16"} and rec.linears == ["bfloat16"]
    assert preds.dtype == torch.bfloat16 and all(v.dtype == torch.float32 for v in aux.values())


def test_an_empty_code_is_refused():
    code = jax.eval_shape(lambda x: JaxAutoencoder((3, 16, 16), 8).init_with_output(
        jax.random.PRNGKey(0), x, method=JaxAutoencoder.encode)[0], jnp.zeros((1, 16, 16, 3)))
    assert code.shape == (1, 0, 0, 8)
    with pytest.raises(ValueError, match="encodes to"):
        build_model(MODEL_ID, 0, "cpu", **{**KW, "img_shape": (3, 16, 16)})


MMF = dict(img_size=32, digit_source="synthetic", n_seqs={"train": 8, "val": 4, "test": 4})
RUN = dict(epochs=2, batch_size=4, context_frames=2, pred_frames=3, steps_per_epoch=2,
           no_vis=True, no_wandb=True, num_devices=1)
SUITE_KW = dict(SMALL, teacher_forcing_decay=1.0)


def _one_worker(mp, module):
    mp.setattr(module, "BatchLoader", functools.partial(module.BatchLoader, num_workers=1))


def _val_losses(out_dir):
    with open(out_dir / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _state_from_port(port_model):
    r"""A stand-in for the JAX suite's ``create_train_state`` that starts
    from the port model's weights."""
    def create(model, optimizer, rng, **kw):
        params = st_phy_params_to_jax(port_model.state_dict())
        _, state_rng = jax.random.split(rng)
        return JaxTrainState(params=params, extra_vars={}, opt_state=optimizer.init(params),
                             step=jnp.asarray(0, jnp.int32), model_state={}, rng=state_rng)
    return create


def test_suite_train_and_load(tmp_path, monkeypatch):
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
    assert entry.state.step == 4 and entry.state.model_state == {}

    loaded = VPSuite(device="cpu").load_model(str(tmp_path / "port"), "final_model")
    want_sd, got_sd = entry.model.state_dict(), loaded.model.state_dict()
    assert got_sd.keys() == want_sd.keys()
    assert all(torch.equal(got_sd[k], want_sd[k]) for k in want_sd)
    frames = np.random.default_rng(7).random((2, 2, 32, 32, 3), dtype=np.float32)
    check = VPSuite(device="cpu")
    check.models += [entry, loaded]
    torch.testing.assert_close(check.predict(frames, pred_frames=3, model_idx=0),
                               check.predict(frames, pred_frames=3, model_idx=1), rtol=0, atol=0)
