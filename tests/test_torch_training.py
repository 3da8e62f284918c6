r"""The port's training slice against the JAX package's, on the same weights.

- The per-step ConvLSTM block (cuDNN convs and the gate's autograd Function)
  must give the gradients of the JAX block's hand-written recurrence VJP
  (``ops/scan_vjp.py``, ``remat_policy="scan_vjp"``): rtol and atol 2e-4.
- One EF-ConvLSTM train step (16x16, b=2, 3 -> 2, MSE) per configuration,
  weights carried from JAX with ``load_jax_params``: with SGD the losses agree
  to 1e-5 (relative) and the post-step parameters as ``(p0 - p1) / lr`` to
  rtol and atol 5e-4; three Adam steps give the same losses to 1e-4 (the
  fused scan's against the per-step path's, which are JAX's). Only
  SGD steps are compared parameter by parameter: Adam's first step is about
  lr * sign(g), which turns float wiggle in a gradient near 0 into 2 * lr.
- ``accum_steps=2`` (interleaved microbatches) matches JAX ``accum_steps=2``,
  and the eval step and each ported loss match JAX's.
- On CPU tensors no kernel is launched.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vp_suite_tpu.measure import LOSS_CLASSES as JAX_LOSSES
from vp_suite_tpu.measure.loss_provider import PredictionLossProvider as JaxLossProvider
from vp_suite_tpu.model_blocks.conv_lstm_shi import ConvLSTMShi as JaxConvLSTMShi
from vp_suite_tpu.models import MODEL_CLASSES as JAX_MODELS
from vp_suite_tpu.training import loop as jax_loop
from vp_suite_tpu.training.train_state import TrainState as JaxTrainState
from vp_suite_tpu_torch.measure import LOSS_CLASSES
from vp_suite_tpu_torch.model_blocks.conv_lstm_shi import ConvLSTMShi
from vp_suite_tpu_torch.models import MODEL_CLASSES
from vp_suite_tpu_torch.ops import cells, convlstm
from vp_suite_tpu_torch.training.loop import make_eval_step, make_train_step
from vp_suite_tpu_torch.training.train_state import create_train_state
from vp_suite_tpu_torch.utils.jax_params import ef_state_dict_from_jax, load_jax_params

torch.set_num_threads(1)

KWARGS = dict(img_shape=(3, 16, 16), action_size=0, tensor_value_range=(0.0, 1.0))
CTX, PRED = 3, 2
RUN_CONFIG = {"context_frames": CTX, "pred_frames": PRED, "use_actions": False}
CONFIGS = {
    "per_step": {},
    "fused_scan": dict(use_fused_scan=True, interleaved_encode=False, interleaved_forecast=False),
}
LR = 1e-3


def _frames(b, seed=0):
    return np.random.default_rng(seed).random((b, CTX + PRED, 16, 16, 3), dtype=np.float32)


def _jax_steps(name, optimizer, state, frames, n=1, **kw):
    r"""``n`` JAX train steps (one jitted step function); returns the last
    state and the losses."""
    model = JAX_MODELS["convlstm-shi"](**KWARGS, **CONFIGS[name])
    lp = JaxLossProvider({"losses_and_scales": {"mse": 1.0}, "img_c": 3, "device": None})
    step = jax_loop.make_train_step(model, RUN_CONFIG, optimizer, lp, donate=False, **kw)
    losses = []
    with jax.default_matmul_precision("highest"):
        for _ in range(n):
            state, metrics = step(state, {"frames": jnp.asarray(frames)}, jnp.asarray(0.0))
            losses.append(float(metrics["total"]))
    return state, losses


@pytest.fixture(scope="module")
def jax_init():
    r"""A JAX train state of EF-ConvLSTM, with parameters from a jitted init
    (an eager one takes seconds)."""
    model = JAX_MODELS["convlstm-shi"](**KWARGS)
    params = jax.jit(model.init_params)(jax.random.PRNGKey(0))
    return JaxTrainState(params=params, extra_vars={}, opt_state=None,
                         step=jnp.asarray(0, jnp.int32), model_state=model.init_model_state(),
                         rng=jax.random.PRNGKey(1))


def _jax_state(init, optimizer):
    return init.replace(opt_state=optimizer.init(init.params))


def _port_model(name, params):
    return load_jax_params(MODEL_CLASSES["convlstm-shi"](**KWARGS, **CONFIGS[name]), params)


def _port_steps(name, params, optimizer, frames, n=1, accum_steps=1):
    model = _port_model(name, params)
    state = create_train_state(model, lr=LR, optimizer=optimizer)
    step = make_train_step(model, RUN_CONFIG, accum_steps=accum_steps)
    losses = [float(step(state, {"frames": torch.from_numpy(frames)})[1]["total"])
              for _ in range(n)]
    assert state.step == n
    return model, losses


def _assert_same_sgd_step(model, p0, p1):
    r"""The port's post-step parameters against JAX's, as (p0 - p1) / lr."""
    before, after = ef_state_dict_from_jax(p0), ef_state_dict_from_jax(p1)
    got = model.state_dict()
    assert set(got) == set(after)
    for k, v in got.items():
        np.testing.assert_allclose(((before[k] - v) / LR).numpy(),
                                   ((before[k] - after[k]) / LR).numpy(),
                                   rtol=5e-4, atol=5e-4, err_msg=k)


@pytest.mark.parametrize("decode", [False, True], ids=["with_input", "decode"])
def test_per_step_block_grads_match_jax_scan_vjp(decode):
    t, b, sh, sw, cin, enc = 3, 2, 6, 10, 3, 4
    rng = np.random.RandomState(11)
    f32 = np.float32
    x = None if decode else rng.randn(t, b, sh, sw, cin).astype(f32)
    states = tuple((rng.randn(b, sh, sw, enc) * 0.3).astype(f32) for _ in range(2))
    r_seq = rng.randn(t, b, sh, sw, enc).astype(f32)
    r_c = rng.randn(b, sh, sw, enc).astype(f32)
    jblock = JaxConvLSTMShi(in_channels=cin, enc_channels=enc, state_h=sh, state_w=sw,
                            remat_policy="scan_vjp", time_major=True)
    params = jblock.init(jax.random.PRNGKey(1), None if x is None else jnp.asarray(x),
                         tuple(map(jnp.asarray, states)), t)["params"]
    params = {**params, **{k: jnp.asarray(rng.randn(sh, sw, enc).astype(f32) * 0.1)
                           for k in ("wci", "wcf", "wco")}}

    def jax_loss(p, xs, st):
        seq, (_, c) = jblock.apply({"params": p}, xs, st, t)
        return jnp.sum(seq * r_seq) + jnp.sum(c * r_c)

    with jax.default_matmul_precision("highest"):
        want = jax.grad(jax_loss, argnums=(0, 1, 2))(
            params, None if x is None else jnp.asarray(x), tuple(map(jnp.asarray, states)))

    block = ConvLSTMShi(cin, enc, sh, sw, hoist_i2h=True)
    with torch.no_grad():
        block._conv.weight.copy_(torch.from_numpy(np.asarray(params["conv_kernel"])
                                                  .transpose(3, 2, 0, 1).copy()))
        block._conv.bias.copy_(torch.from_numpy(np.array(params["conv_bias"])))
        for name in ("wci", "wcf", "wco"):
            getattr(block, f"W{name[1:]}").copy_(
                torch.from_numpy(np.asarray(params[name]).transpose(2, 0, 1)[None].copy()))
    xs = None if x is None else torch.from_numpy(x).requires_grad_()
    st = tuple(torch.from_numpy(s).requires_grad_() for s in states)
    seq, (_, c) = block(xs, st, t)
    ((seq * torch.from_numpy(r_seq)).sum() + (c * torch.from_numpy(r_c)).sum()).backward()

    j_params, j_x, j_st = want
    pairs = [(block._conv.weight.grad.numpy().transpose(2, 3, 1, 0), j_params["conv_kernel"]),
             (block._conv.bias.grad.numpy(), j_params["conv_bias"])]
    pairs += [(getattr(block, f"W{n[1:]}").grad.numpy()[0].transpose(1, 2, 0), j_params[n])
              for n in ("wci", "wcf", "wco")]
    pairs += [(s.grad.numpy(), js) for s, js in zip(st, j_st)]
    if x is not None:
        pairs.append((xs.grad.numpy(), j_x))
    for got, w in pairs:
        np.testing.assert_allclose(got, np.asarray(w), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_train_step_matches_jax(jax_init, name):
    frames = _frames(2)
    sgd = optax.sgd(LR)
    state = _jax_state(jax_init, sgd)
    new_state, (want,) = _jax_steps(name, sgd, state, frames)
    model, (loss,) = _port_steps(name, state.params, "sgd", frames)
    np.testing.assert_allclose(loss, want, rtol=1e-5)
    _assert_same_sgd_step(model, state.params, new_state.params)

    if name == "per_step":
        adam = optax.adam(LR)
        _, want = _jax_steps(name, adam, _jax_state(jax_init, adam), frames, n=3)
    else:
        # Adam's update does not depend on the configuration, and the SGD step
        # above holds the fused scan's gradients against JAX: its Adam losses
        # are held against the per-step path's, which the per_step case holds
        # against JAX (a second JAX compile of the fused scan would take 10 s)
        _, want = _port_steps("per_step", jax_init.params, "adam", frames, n=3)
    _, got = _port_steps(name, jax_init.params, "adam", frames, n=3)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_accumulated_step_matches_jax(jax_init):
    frames = _frames(4, seed=1)
    sgd = optax.sgd(LR)
    state = _jax_state(jax_init, sgd)
    new_state, (want,) = _jax_steps("per_step", sgd, state, frames, accum_steps=2)
    model, (loss,) = _port_steps("per_step", state.params, "sgd", frames, accum_steps=2)
    np.testing.assert_allclose(loss, want, rtol=1e-5)
    _assert_same_sgd_step(model, state.params, new_state.params)


def test_accumulation_rejects_an_indivisible_batch():
    model = MODEL_CLASSES["convlstm-shi"](**KWARGS)
    step = make_train_step(model, RUN_CONFIG, accum_steps=3)
    with pytest.raises(ValueError, match="not divisible by accum_steps"):
        step(create_train_state(model), {"frames": torch.from_numpy(_frames(4))})


def test_steps_read_the_run_defaults():
    r"""What ``run_config`` leaves out comes from the run defaults (MSE
    alone); what it gives wins, ``accum_steps`` included."""
    model = MODEL_CLASSES["convlstm-shi"](**KWARGS)
    frames = torch.from_numpy(_frames(4))
    got = make_eval_step(model, {"context_frames": CTX, "pred_frames": PRED})(None, {"frames": frames})
    assert set(got) == {"total", "mse"} and float(got["total"]) == float(got["mse"])
    step = make_train_step(model, {**RUN_CONFIG, "accum_steps": 3})
    with pytest.raises(ValueError, match="not divisible by accum_steps 3"):
        step(create_train_state(model), {"frames": frames})


def test_eval_step_matches_jax(jax_init):
    frames = _frames(2, seed=2)
    state = jax_init
    lp = JaxLossProvider({"losses_and_scales": {"mse": 1.0, "l1": 0.5}, "img_c": 3,
                          "device": None})
    jax_model = JAX_MODELS["convlstm-shi"](**KWARGS)
    with jax.default_matmul_precision("highest"):
        want = jax_loop.make_eval_step(jax_model, RUN_CONFIG, lp)(
            state, {"frames": jnp.asarray(frames)})
    model = _port_model("per_step", state.params)
    got = make_eval_step(model, {**RUN_CONFIG, "losses_and_scales": {"mse": 1.0, "l1": 0.5}})(
        None, {"frames": torch.from_numpy(frames)})
    assert set(got) == set(want) == {"total", "mse", "l1"}
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", ["l1", "mse", "smooth_l1"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(4)
    pred, target = (rng.standard_normal((2, 3, 4, 5, 3)).astype(np.float32) for _ in range(2))
    got = LOSS_CLASSES[name]()(torch.from_numpy(pred), torch.from_numpy(target))
    want = JAX_LOSSES[name]()(jnp.asarray(pred), jnp.asarray(target))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_uint8_frames_are_dequantized():
    frames = (_frames(2, seed=3) * 255).astype(np.uint8)
    model = MODEL_CLASSES["convlstm-shi"](**KWARGS)
    eval_step = make_eval_step(model, RUN_CONFIG)
    got = eval_step(None, {"frames": torch.from_numpy(frames)})
    want = eval_step(None, {"frames": torch.from_numpy(frames).float() / 255.0})
    assert float(got["total"]) == float(want["total"])


def test_other_regimes_are_not_ported():
    model = MODEL_CLASSES["convlstm-shi"](**KWARGS)
    model.TRAIN_REGIME = "teacher_forcing"
    with pytest.raises(NotImplementedError):
        make_train_step(model, RUN_CONFIG)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_no_kernel_launches_on_the_cpu(name):
    counters = [(cells.convlstm_gate_fuse, "launches"), (cells.convlstm_gate_backward, "launches"),
                (convlstm.convlstm_scan_fused, "launches"),
                (convlstm.convlstm_scan_fused, "save_gates_launches"),
                (convlstm.convlstm_scan_backward, "launches")]
    for fn, attr in counters:
        setattr(fn, attr, 0)
    model = MODEL_CLASSES["convlstm-shi"](**KWARGS, **CONFIGS[name])
    state = create_train_state(model, optimizer="sgd")
    _, metrics = make_train_step(model, RUN_CONFIG)(state, {"frames": torch.from_numpy(_frames(2))})
    assert np.isfinite(float(metrics["total"]))
    assert all(p.grad is not None for p in model.parameters())
    assert [getattr(fn, attr) for fn, attr in counters] == [0] * len(counters)
