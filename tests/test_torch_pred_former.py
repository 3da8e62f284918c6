r"""PredFormer (``models/pred_former.py``) and flax's LayerNorm and attention
(``model_blocks/transformer.py``) of the port against the JAX package's, on
the CPU, in f32 under ``jax.default_matmul_precision("highest")``, on the
port's weights carried into JAX (``pred_former_params_to_jax``), at a
non-square 16x24 image with 8x8 patches (2x3 tokens a frame: a transposed
patch or head layout shows), ``dim=32``, two heads, two blocks.

- LayerNorm and attention alone (a block's, with random LayerNorm
  parameters) against flax's ``nn.LayerNorm`` and
  ``nn.MultiHeadDotProductAttention``, to 1e-5; the LayerNorm on inputs of
  variance 1e-4, where torch's epsilon (1e-5) would differ from flax's (1e-6)
  by some 5%.
- Under ``compute_dtype=bfloat16``, the dtype of every matmul, LayerNorm
  statistic, query scaling and softmax, in order, against
  ``jax.make_jaxpr``: LayerNorm statistics in f32, everything else in bf16.
- The converter: random JAX-layout parameters (shapes from
  ``jax.eval_shape`` of the JAX model's init) -> the port -> JAX, equal bit
  for bit, and ``load_jax_params`` takes them strictly.
- The forward in train and eval mode at ``pred_frames`` 1 and 3 (the window
  shifted in token space), to 1e-4; the gradients of a summed loss over 3
  frames, to 2e-4 of the largest of each tensor; one SGD train step (3 -> 3)
  as ``(p0 - p1) / lr`` with ``accum_steps`` 1 and 2, to 5e-4 of the largest
  (each JAX step compiled once, :func:`_jax_step`).
- Refusals, ``ValueError`` on both sides (the JAX side by
  ``jax.eval_shape``): an input of another image size, a patch size that
  does not divide the image, a context longer than ``max_frames``.
- ``create_model`` -> ``train`` (2 epochs of 2 Adam steps, b=4, 2 -> 3
  frames, 16x16) against the JAX suite's run from the same initial weights
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
from flax import linen as fnn
from torch.overrides import TorchFunctionMode

import vp_suite_tpu.vpsuite as jax_vpsuite
from vp_suite_tpu.measure.loss_provider import PredictionLossProvider as JaxLossProvider
from vp_suite_tpu.models import MODEL_CLASSES as JAX_MODELS
from vp_suite_tpu.training import loop as jax_loop
from vp_suite_tpu.training.train_state import TrainState as JaxTrainState
import vp_suite_tpu_torch.vpsuite as port_vpsuite
from vp_suite_tpu_torch import VPSuite
from vp_suite_tpu_torch.defaults import SETTINGS
from vp_suite_tpu_torch.models import build_model
from vp_suite_tpu_torch.training.loop import make_train_step
from vp_suite_tpu_torch.training.train_state import create_train_state
from vp_suite_tpu_torch.utils.jax_params import (load_jax_params, pred_former_params_to_jax,
                                                 pred_former_state_dict_from_jax)

torch.set_num_threads(1)

MODEL_ID = "pred-former"
LR = 1e-2
#: the JAX model's own knob: no rematerialization (the same function; it compiles faster)
JAX_ONLY = dict(remat=False)
H, W = 16, 24
KW = dict(img_shape=(3, H, W), action_size=0, tensor_value_range=(0.0, 1.0), patch_size=8,
          dim=32, depth=2, heads=2)
RUN_CONFIG = {"context_frames": 3, "pred_frames": 3, "use_actions": False}


def _to_jax(state_dict):
    return pred_former_params_to_jax(state_dict, KW["heads"])


def _frames(shape, seed):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _pair():
    r"""The port's model and the JAX model with the port's weights."""
    model = build_model(MODEL_ID, 0, "cpu", **KW)
    jmodel = JAX_MODELS[MODEL_ID](**KW, **JAX_ONLY)
    return model, jmodel, _to_jax(model.state_dict())


def assert_close_to_largest(got, want, tol, name):
    got, want = np.asarray(got), np.asarray(want)
    err, scale = np.abs(got - want).max(), max(np.abs(want).max(), 1.0)
    assert err <= tol * scale, f"{name}: max |diff| {err:.3g} > {tol} * {scale:.3g}"


def test_converter_round_trip_is_exact():
    x = jnp.zeros((1, 2, H, W, 3))
    shapes = jax.eval_shape(lambda x: JAX_MODELS[MODEL_ID](**KW).init(jax.random.PRNGKey(0), x),
                            x)["params"]
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda v: rng.standard_normal(v.shape, dtype=np.float32), shapes)
    back = _to_jax(pred_former_state_dict_from_jax(params))
    leaves = jax.tree_util.tree_leaves_with_path
    assert jax.tree.structure(back) == jax.tree.structure(params)
    assert all(np.asarray(b).dtype == np.float32 and np.array_equal(b, p)
               for (_, b), (_, p) in zip(leaves(back), leaves(params)))
    model = load_jax_params(build_model(MODEL_ID, 0, "cpu", **KW), params)
    assert all(np.array_equal(b, p) for (_, b), (_, p)
               in zip(leaves(_to_jax(model.state_dict())), leaves(params)))


@pytest.mark.parametrize("pred_frames", [1, 3])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_matches_jax(train, pred_frames):
    model, jmodel, params = _pair()
    x = _frames((2, 3, H, W, 3), 2)
    with jax.default_matmul_precision("highest"):
        want, _ = jmodel.apply({"params": params}, jnp.asarray(x), pred_frames=pred_frames,
                               train=train)
    with torch.no_grad():
        got, aux = model(torch.from_numpy(x), pred_frames=pred_frames, train=train)
    assert aux is None and got.shape == (2, pred_frames, H, W, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_gradients_match_jax():
    model, jmodel, params = _pair()
    x, g = _frames((2, 3, H, W, 3), 3), _frames((2, 3, H, W, 3), 4) - 0.5

    def loss(p):
        preds, _ = jmodel.apply({"params": p}, jnp.asarray(x), pred_frames=3, train=True)
        return jnp.sum(preds * g)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jax.grad(loss))(params)
    preds, _ = model(torch.from_numpy(x), pred_frames=3, train=True)
    (preds * torch.from_numpy(g)).sum().backward()
    got = _to_jax({k: p.grad for k, p in model.named_parameters()})
    paths = jax.tree_util.tree_leaves_with_path
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, g), (_, w) in zip(paths(got), paths(want)):
        assert_close_to_largest(g, w, 2e-4, jax.tree_util.keystr(path))


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
    frames = _frames((4, 6, H, W, 3), 5)
    with jax.default_matmul_precision("highest"):
        jstate, jmetrics = jstep(jstate, {"frames": jnp.asarray(frames)}, jnp.asarray(0.0))
    state = create_train_state(model, lr=LR, optimizer="sgd")
    before = _to_jax(model.state_dict())
    state, metrics = make_train_step(model, RUN_CONFIG, accum_steps=accum_steps)(
        state, {"frames": torch.from_numpy(frames)})
    np.testing.assert_allclose(float(metrics["total"]), float(jmetrics["total"]), rtol=1e-5)
    after = _to_jax(model.state_dict())
    paths = jax.tree_util.tree_leaves_with_path
    for (path, p0), (_, p1), (_, j1) in zip(paths(before), paths(after), paths(jstate.params)):
        assert_close_to_largest((p0 - p1) / LR, (p0 - np.asarray(j1)) / LR, 5e-4,
                                jax.tree_util.keystr(path))


class _Flow(TorchFunctionMode):
    r"""Records ``kind:dtype`` of every matmul (its input), LayerNorm statistic
    (``rsqrt``), query scaling (the only division) and softmax (its input)."""
    KINDS = {"linear": "mm", "matmul": "mm", "rsqrt": "ln", "__truediv__": "scale",
             "div": "scale", "softmax": "softmax"}

    def __init__(self):
        super().__init__()
        self.events = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kind = self.KINDS.get(getattr(func, "__name__", ""))
        if kind:
            self.events.append(f"{kind}:{str(args[0].dtype).removeprefix('torch.')}")
        return func(*args, **(kwargs or {}))


def _jaxpr_flow(jaxpr):
    r"""The same events of ``jaxpr`` and its sub-jaxprs, in order: ``dot_general``,
    ``rsqrt``, a bf16 division by a 0-d value (the query scaling; LayerNorm's
    means divide in f32) and ``exp`` (the softmax)."""
    out = []
    for eqn in jaxpr.eqns:
        name, dtype = eqn.primitive.name, str(eqn.invars[0].aval.dtype) if eqn.invars else ""
        if name == "dot_general":
            out.append(f"mm:{dtype}")
        elif name == "rsqrt":
            out.append(f"ln:{dtype}")
        elif name == "div" and dtype == "bfloat16" and eqn.invars[1].aval.shape == ():
            out.append(f"scale:{dtype}")
        elif name == "exp":
            out.append(f"softmax:{dtype}")
        for p in eqn.params.values():
            for sub in p if isinstance(p, (list, tuple)) else (p,):
                sub = getattr(sub, "jaxpr", sub)
                if hasattr(sub, "eqns"):
                    out += _jaxpr_flow(sub)
    return out


def test_bf16_flow_matches_jax():
    model = build_model(MODEL_ID, 0, "cpu", **KW, compute_dtype=torch.bfloat16)
    jmodel = JAX_MODELS[MODEL_ID](**KW, compute_dtype=jnp.bfloat16)
    x = _frames((1, 2, H, W, 3), 6)
    with _Flow() as rec, torch.no_grad():
        preds, _ = model(torch.from_numpy(x), pred_frames=2)
    jaxpr = jax.make_jaxpr(lambda p, x: jmodel.apply({"params": p}, x, pred_frames=2))(
        _to_jax(model.state_dict()), jnp.asarray(x))
    want = _jaxpr_flow(jaxpr.jaxpr)
    attention = ["mm:bfloat16"] * 3 + ["scale:bfloat16", "mm:bfloat16", "softmax:bfloat16",
                                       "mm:bfloat16", "mm:bfloat16"]
    block = ["ln:float32", *attention, "ln:float32", *attention, "ln:float32",
             "mm:bfloat16", "mm:bfloat16"]
    step = 2 * block + ["ln:float32", "mm:bfloat16", "mm:bfloat16"]   # then the new frame's embed
    assert want == ["mm:bfloat16"] + 2 * step
    assert rec.events == want and preds.dtype == torch.float32


def _perturbed_model():
    r"""A port model whose LayerNorms have random parameters, and its JAX tree."""
    model = build_model(MODEL_ID, 0, "cpu", **KW)
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".ln_" in name or name.startswith("ln_"):
                p.add_(torch.randn(p.shape, generator=gen) * 0.5)
    return model, _to_jax(model.state_dict())


def test_layer_norm_matches_flax():
    model, params = _perturbed_model()
    x = np.random.default_rng(8).standard_normal((4, 6, 32), dtype=np.float32) * 0.01 + 0.02
    want = fnn.LayerNorm().apply({"params": params["block0"]["ln_t"]}, jnp.asarray(x))
    with torch.no_grad():
        got = model.blocks[0].ln_t(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_attention_matches_flax():
    model, params = _perturbed_model()
    y = np.random.default_rng(9).standard_normal((4, 6, 32), dtype=np.float32)
    with jax.default_matmul_precision("highest"):
        want = fnn.MultiHeadDotProductAttention(num_heads=2).apply(
            {"params": params["block1"]["attn_s"]}, jnp.asarray(y), jnp.asarray(y))
    with torch.no_grad():
        got = model.blocks[1].attn_s(torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["image_size", "patch_size", "long_context"])
def test_refusals_match_jax(case):
    kw, shape, match = {
        "image_size": (KW, (1, 2, H, 16, 3), "does not match"),
        "patch_size": ({**KW, "img_shape": (3, 16, 20)}, (1, 2, 16, 20, 3), "patch_size"),
        "long_context": ({**KW, "max_frames": 4}, (1, 5, H, W, 3), "max_frames"),
    }[case]
    x = jnp.zeros(shape)
    with pytest.raises(ValueError, match=match):
        jax.eval_shape(lambda x: JAX_MODELS[MODEL_ID](**kw).init(jax.random.PRNGKey(0), x), x)
    with pytest.raises(ValueError, match=match):
        build_model(MODEL_ID, 0, "cpu", **kw)(torch.zeros(shape))


MMF = dict(img_size=16, digit_source="synthetic", n_seqs={"train": 8, "val": 4, "test": 4})
RUN = dict(epochs=2, batch_size=4, context_frames=2, pred_frames=3, steps_per_epoch=2,
           no_vis=True, no_wandb=True, num_devices=1)
SUITE_KW = dict(patch_size=8, dim=32, depth=2, heads=2)


def _one_worker(mp, module):
    mp.setattr(module, "BatchLoader", functools.partial(module.BatchLoader, num_workers=1))


def _val_losses(out_dir):
    with open(out_dir / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _state_from_port(port_model):
    r"""A stand-in for the JAX suite's ``create_train_state`` that starts
    from the port model's weights."""
    def create(model, optimizer, rng, **kw):
        params = _to_jax(port_model.state_dict())
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
