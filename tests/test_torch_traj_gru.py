r"""The port's TrajGRU block and EF-TrajGRU against the JAX package's, on the
same weights, on the CPU.

- One TrajGRU block (time-major, with input and in decode mode): outputs and
  final state to 1e-5, and the gradients of every parameter, the inputs and
  the initial state to 2e-4 (rtol and atol), weights carried from JAX.
- Zoneout by an injected mask: JAX's ``jax.random.bernoulli`` is patched, from
  the test, to return the same keep mask that the port's block is handed.
- EF-TrajGRU at 16x16 with two TrajGRU layers (enc channels up to 8, L=3):
  ``VPSuite.predict`` with the JAX parameters carried over by
  ``load_jax_params`` equals JAX ``model.apply`` to 1e-4 in the interleaved
  and staged schedules; one f32 SGD step equals JAX's step, losses to 1e-5
  (relative) and post-step parameters as ``(p0 - p1) / lr`` to 5e-4.
- The port's ``state_dict`` maps back through the JAX package's torch importer
  to exactly the JAX parameters; on CPU tensors no warp kernel is launched.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vp_suite_tpu.measure.loss_provider import PredictionLossProvider as JaxLossProvider
from vp_suite_tpu.model_blocks.traj_gru import TrajGRU as JaxTrajGRU
from vp_suite_tpu.models import MODEL_CLASSES as JAX_MODELS
from vp_suite_tpu.training import loop as jax_loop
from vp_suite_tpu.training.train_state import TrainState as JaxTrainState
from vp_suite_tpu.utils.torch_import import import_state_dict
from vp_suite_tpu_torch import VPSuite
from vp_suite_tpu_torch.model_blocks.traj_gru import TrajGRU
from vp_suite_tpu_torch.models import MODEL_CLASSES
from vp_suite_tpu_torch.ops import warp
from vp_suite_tpu_torch.training.loop import make_train_step
from vp_suite_tpu_torch.training.train_state import create_train_state
from vp_suite_tpu_torch.utils.jax_params import ef_state_dict_from_jax, load_jax_params

torch.set_num_threads(1)

#: EF-TrajGRU cut to two layers and narrow widths at 16x16 (hidden states
#: 16x16x8 and 8x8x8, L=3 flows).
TWO = ((3, 3), (3, 3))
KWARGS = dict(
    img_shape=(3, 16, 16), action_size=0, tensor_value_range=(0.0, 1.0), num_layers=2,
    enc_c=(4, 8, 8, 8), dec_c=(8, 8, 8, 4),
    enc_conv_names=("conv1_leaky_1", "conv2_leaky_1"), enc_conv_k=(3, 3), enc_conv_s=(1, 2),
    enc_conv_p=(1, 1),
    dec_conv_names=("deconv1_leaky_1", "deconv2_leaky_1"), dec_conv_k=(4, 3), dec_conv_s=(2, 1),
    dec_conv_p=(1, 1), final_conv_1_c=4,
    **{f"{kind}_rnn_{name}": v for kind in ("enc", "dec")
       for name, v in (("z", (0.0, 0.0)), ("L", (3, 3)), ("i2h_k", TWO),
                       ("i2h_s", ((1, 1), (1, 1))), ("i2h_p", ((1, 1), (1, 1))),
                       ("h2h_k", ((5, 5), (5, 5))), ("h2h_d", ((1, 1), (1, 1))))})
SCHEDULES = {"interleaved": {}, "staged": dict(interleaved_encode=False, interleaved_forecast=False)}
CTX, PRED = 3, 2
LR = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _block_case(decode, zoneout=0.0):
    r"""A JAX TrajGRU block, its params (biases made non-zero) and inputs,
    and the port's block with the same weights."""
    t, b, h, w, cin, f, L = 3, 2, 6, 10, 3, 4, 3
    rng = np.random.RandomState(21)
    x = None if decode else rng.randn(t, b, h, w, cin).astype(np.float32)
    h0 = (rng.randn(b, h, w, f) * 0.5).astype(np.float32)
    jblock = JaxTrajGRU(in_channels=cin, enc_channels=f, state_h=h, state_w=w, L=L,
                        zoneout=zoneout, time_major=True)
    params = jblock.init({"params": jax.random.PRNGKey(3), "zoneout": jax.random.PRNGKey(4)},
                         None if x is None else jnp.asarray(x), jnp.asarray(h0), t)["params"]
    params = {k: (v + jnp.asarray(rng.randn(*v.shape).astype(np.float32) * 0.1)
                  if k.endswith("_bias") else v) for k, v in params.items()}
    block = TrajGRU(cin, f, h, w, zoneout=zoneout, L=L)
    with torch.no_grad():
        for name in ("i2h", "i2f_conv1", "h2f_conv1", "flows_conv", "ret"):
            getattr(block, name).weight.copy_(
                _t(np.asarray(params[f"{name}_kernel"]).transpose(3, 2, 0, 1)))
            getattr(block, name).bias.copy_(_t(np.asarray(params[f"{name}_bias"])))
    return jblock, params, x, h0, block, t


@pytest.mark.parametrize("decode", [False, True], ids=["with_input", "decode"])
def test_block_forward_and_gradients_match_jax(decode):
    jblock, params, x, h0, block, t = _block_case(decode)
    rng = np.random.RandomState(22)
    r_seq = rng.randn(t, *h0.shape).astype(np.float32)
    r_h = rng.randn(*h0.shape).astype(np.float32)

    def jax_loss(p, xs, st):
        seq, h = jblock.apply({"params": p}, xs, st, t)
        return jnp.sum(seq * r_seq) + jnp.sum(h * r_h), (seq, h)

    with jax.default_matmul_precision("highest"):
        (_, (want_seq, want_h)), want = jax.jit(jax.value_and_grad(
            jax_loss, argnums=(0, 1, 2), has_aux=True))(
            params, None if x is None else jnp.asarray(x), jnp.asarray(h0))
    xs = None if x is None else _t(x).requires_grad_()
    st = _t(h0).requires_grad_()
    seq, h = block(xs, st, t)
    np.testing.assert_allclose(seq.detach().numpy(), np.asarray(want_seq), rtol=0, atol=1e-5)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(want_h), rtol=0, atol=1e-5)
    ((seq * _t(r_seq)).sum() + (h * _t(r_h)).sum()).backward()
    j_params, j_x, j_st = want
    pairs = [(st.grad.numpy(), j_st, "h0")] + ([] if x is None else [(xs.grad.numpy(), j_x, "x")])
    for name in ("i2h", "i2f_conv1", "h2f_conv1", "flows_conv", "ret"):
        conv = getattr(block, name)
        if x is None and name in ("i2h", "i2f_conv1"):
            assert conv.weight.grad is None and not np.any(np.asarray(j_params[f"{name}_kernel"]))
            continue
        pairs += [(conv.weight.grad.numpy().transpose(2, 3, 1, 0), j_params[f"{name}_kernel"], name),
                  (conv.bias.grad.numpy(), j_params[f"{name}_bias"], name + " bias")]
    for got, w, name in pairs:
        np.testing.assert_allclose(got, np.asarray(w), rtol=2e-4, atol=2e-4, err_msg=name)


def test_zoneout_by_injected_mask(monkeypatch):
    jblock, params, x, h0, block, t = _block_case(False, zoneout=0.5)
    mask = np.random.default_rng(23).random((t, h0.shape[0], 1, 1, h0.shape[-1])) < 0.5
    assert mask.any() and not mask.all()
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(mask))
    with jax.default_matmul_precision("highest"):
        want_seq, want_h = jblock.apply({"params": params}, jnp.asarray(x), jnp.asarray(h0), t,
                                        rngs={"zoneout": jax.random.PRNGKey(0)})
    with torch.no_grad():
        seq, h = block(_t(x), _t(h0), t, zoneout_masks=_t(mask))
    np.testing.assert_allclose(seq.numpy(), np.asarray(want_seq), rtol=0, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), rtol=0, atol=1e-5)
    # a kept channel carries the previous state through the step
    kept = np.nonzero(mask[1, 0, 0, 0])[0][0]
    np.testing.assert_array_equal(seq[1, 0, ..., kept].numpy(), seq[0, 0, ..., kept].numpy())
    # masks drawn from the block's generator are reproducible; without one it raises
    block.generator = torch.Generator().manual_seed(0)
    with torch.no_grad():
        a, _ = block(_t(x), _t(h0), t)
        block.generator.manual_seed(0)
        b, _ = block(_t(x), _t(h0), t)
    assert torch.equal(a, b)
    block.generator = None
    with pytest.raises(ValueError, match="needs keep masks or a generator"):
        block(_t(x), _t(h0), t)


@pytest.fixture(scope="module")
def jax_params():
    model = JAX_MODELS["trajgru"](**KWARGS)
    return jax.jit(model.init_params)(jax.random.PRNGKey(0))


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_ef_trajgru_predict_matches_jax(jax_params, name):
    cfg = SCHEDULES[name]
    x = np.random.default_rng(0).random((2, CTX, 16, 16, 3)).astype(np.float32)
    jax_model = JAX_MODELS["trajgru"](**KWARGS, **cfg)
    with jax.default_matmul_precision("highest"):
        want, _ = jax.jit(lambda p, x: jax_model.apply({"params": p}, x, pred_frames=4))(
            jax_params, jnp.asarray(x))
    suite = VPSuite(device="cpu")
    entry = suite.create_model("trajgru", **KWARGS, **cfg)
    load_jax_params(entry.model, jax_params)
    warp.warp_sample.launches = 0
    got = suite.predict(x, pred_frames=4)
    assert got.shape == (2, 4, 16, 16, 3) and got.dtype == torch.float32
    assert warp.warp_sample.launches == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_sgd_step_matches_jax(jax_params):
    frames = np.random.default_rng(1).random((2, CTX + PRED, 16, 16, 3), dtype=np.float32)
    run_config = {"context_frames": CTX, "pred_frames": PRED, "use_actions": False}
    jax_model = JAX_MODELS["trajgru"](**KWARGS)
    sgd = optax.sgd(LR)
    state = JaxTrainState(params=jax_params, extra_vars={}, opt_state=sgd.init(jax_params),
                          step=jnp.asarray(0, jnp.int32), model_state=jax_model.init_model_state(),
                          rng=jax.random.PRNGKey(1))
    lp = JaxLossProvider({"losses_and_scales": {"mse": 1.0}, "img_c": 3, "device": None})
    step = jax_loop.make_train_step(jax_model, run_config, sgd, lp, donate=False)
    with jax.default_matmul_precision("highest"):
        new_state, metrics = step(state, {"frames": jnp.asarray(frames)}, jnp.asarray(0.0))

    model = load_jax_params(MODEL_CLASSES["trajgru"](**KWARGS), jax_params)
    warp.warp_sample.launches = warp.warp_sample_backward.launches = 0
    port_state = create_train_state(model, lr=LR, optimizer="sgd")
    _, port_metrics = make_train_step(model, run_config)(port_state, {"frames": _t(frames)})
    assert warp.warp_sample.launches == 0 and warp.warp_sample_backward.launches == 0
    np.testing.assert_allclose(float(port_metrics["total"]), float(metrics["total"]), rtol=1e-5)
    before, after = ef_state_dict_from_jax(jax_params), ef_state_dict_from_jax(new_state.params)
    got = model.state_dict()
    assert set(got) == set(after)
    for k, v in got.items():
        np.testing.assert_allclose(((before[k] - v) / LR).numpy(),
                                   ((before[k] - after[k]) / LR).numpy(),
                                   rtol=5e-4, atol=5e-4, err_msg=k)


def test_state_dict_round_trips_through_torch_import(jax_params):
    model = load_jax_params(MODEL_CLASSES["trajgru"](**KWARGS), jax_params)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    back = import_state_dict("trajgru", sd)["params"]
    want_leaves, want_tree = jax.tree_util.tree_flatten(jax_params)
    got_leaves, got_tree = jax.tree_util.tree_flatten(back)
    assert got_tree == want_tree
    for got, want in zip(got_leaves, want_leaves):
        assert got.shape == want.shape and np.array_equal(np.asarray(got), np.asarray(want))
