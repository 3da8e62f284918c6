r"""UNet-3D of the port against the JAX package's, on the same weights, on the CPU.

- ``Conv3d``, and the JAX package's banded lowering of it that
  ``kernels/unet3d_variants.py`` times beside it, against the JAX
  ``Conv3d`` in its NDHWC and its time-in-channels form: the replicate-padded
  3x3x3 conv and the time-collapsing ``(td, 1, 1)`` skip; ``BatchNorm``
  against flax's ``nn.BatchNorm`` (momentum 0.9) in train and eval mode,
  output and running statistics (biased variance); ``max_pool_2d`` against
  flax's ``max_pool``.
- Weights go from the port to JAX through the JAX package's own importer of
  reference checkpoints (``utils/torch_import._import_unet3d``), so the
  port's ``state_dict`` names are the reference's; the port's converter is
  its inverse (strict ``load_state_dict``).
- The model, plain and action-conditional, in train and eval mode: forward
  to 1e-4; one SGD train step (JAX ``make_train_step``) as ``(p0 - p1) / lr``
  to 2e-4 of the largest of each tensor and the BatchNorm running
  statistics after it to 1e-5, with ``accum_steps`` 1 and 2 (the
  statistics of microbatch 0 alone). The
  numerical cases use two levels, ``features=(4, 8)``: a BatchNorm over few
  values is ill-conditioned in f32 (with the default four levels at 16x16
  the bottleneck normalizes b values per channel, and the port's own f32
  forward in train mode strays from its f64 forward by more than 1e-4).
- Under ``compute_dtype=bfloat16`` the convolutions run in JAX's dtypes
  (flax's BatchNorm returns f32, so everything after the first BatchNorm
  runs in f32): counted from ``jax.make_jaxpr``, with either lowering.
- ``build_model`` leaves every BatchNorm at scale 1, bias 0, running mean 0
  and running variance 1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn
from torch.overrides import TorchFunctionMode

from vp_suite_tpu.measure.loss_provider import PredictionLossProvider as JaxLossProvider
from vp_suite_tpu.models import MODEL_CLASSES as JAX_MODELS
from vp_suite_tpu.nn.layers import Conv3d as JaxConv3d
from vp_suite_tpu.training import loop as jax_loop
from vp_suite_tpu.training.train_state import TrainState as JaxTrainState
from vp_suite_tpu.utils.torch_import import _import_unet3d
from vp_suite_tpu_torch import VPSuite
from vp_suite_tpu_torch.kernels.unet3d_variants import use_lowering
from vp_suite_tpu_torch.models import build_model
from vp_suite_tpu_torch.nn.layers import BatchNorm, Conv3d, max_pool_2d
from vp_suite_tpu_torch.training.loop import make_train_step
from vp_suite_tpu_torch.training.train_state import create_train_state
from vp_suite_tpu_torch.utils.jax_params import load_jax_params, unet3d_state_dict_from_jax

torch.set_num_threads(1)

CTX, PRED, LR = 3, 2, 1e-2
RUN_CONFIG = {"context_frames": CTX, "pred_frames": PRED, "use_actions": False}


def _kwargs(ac=False, **kw):
    return {**dict(img_shape=(3, 16, 16), action_size=2 if ac else 0,
                   tensor_value_range=(0.0, 1.0), temporal_dim=3, features=(4, 8),
                   action_conditional=ac), **kw}


def _inputs(b=2, ac=False, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((b, CTX + PRED, 16, 16, 3), dtype=np.float32)
    return x, (rng.random((b, CTX + PRED, 2), dtype=np.float32) if ac else None)


def _models(ac=False, seed=0, **kw):
    r"""The port's model (random weights and running statistics from
    ``seed``) and the JAX model with its variables carried from it."""
    model = build_model("unet-3d", seed, "cpu", **_kwargs(ac, **kw))
    g = torch.Generator().manual_seed(seed + 1)
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            buf.copy_(torch.randn(buf.shape, generator=g) * 0.1)
        elif name.endswith("running_var"):
            buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
    return model, JAX_MODELS["unet-3d"](**_kwargs(ac, **kw)), _jax_variables(model)


def _jax_variables(model):
    r"""The JAX variables of the port's model, as copies (JAX may read a
    numpy array without copying it, and the port updates its buffers in place)."""
    return _import_unet3d({k: v.numpy().copy() for k, v in model.state_dict().items()})


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("lowering", ["cudnn", "banded"])
@pytest.mark.parametrize("kind", ["3x3x3_replicate", "time_collapse"])
def test_conv3d_matches_jax(lowering, kind):
    td, cin, cout = 3, 5, 6
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, td, 7, 9, cin), dtype=np.float32)
    if kind == "time_collapse":
        cfg = dict(kernel_size=(td, 1, 1))
        port = Conv3d(cin, cout, (td, 1, 1))
    else:
        cfg = dict(kernel_size=3, padding=1, padding_mode="replicate", use_bias=False)
        port = Conv3d(cin, cout, 3, 1, 1, bias=False, padding_mode="replicate")
    port.reset_parameters(torch.Generator().manual_seed(0))
    params = {"kernel": port.weight.detach().numpy().transpose(2, 3, 4, 1, 0)}
    if port.bias is not None:
        params["bias"] = port.bias.detach().numpy()
    with use_lowering(lowering):
        got = port(torch.from_numpy(x)).detach().numpy()
    with jax.default_matmul_precision("highest"):
        want = JaxConv3d(features=cout, **cfg).apply({"params": params}, jnp.asarray(x))
        xm = jnp.asarray(x.transpose(0, 2, 3, 1, 4).reshape(2, 7, 9, td * cin))
        merged = JaxConv3d(features=cout, merged_time=td, **cfg).apply({"params": params}, xm)
    merged = np.asarray(merged).reshape(2, 7, 9, -1, cout).transpose(0, 3, 1, 2, 4)
    assert got.shape == want.shape == merged.shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, merged, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("shape", [(4, 5, 6, 3), (2, 3, 5, 6, 4)], ids=["4d", "5d"])
def test_batchnorm_matches_flax(train, shape):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(shape, dtype=np.float32) * 2 + 0.5)
    c = shape[-1]
    scale, bias = rng.random(c, dtype=np.float32) + 0.5, rng.standard_normal(c, dtype=np.float32)
    mean, var = rng.standard_normal(c, dtype=np.float32), rng.random(c, dtype=np.float32) + 0.5
    bn = BatchNorm(c)
    with torch.no_grad():
        for t, v in ((bn.weight, scale), (bn.bias, bias), (bn.running_mean, mean),
                     (bn.running_var, var)):
            t.copy_(torch.from_numpy(v))
        bn.num_batches_tracked.zero_()
    got = bn(torch.from_numpy(x), train)
    flax_bn = fnn.BatchNorm(use_running_average=not train, momentum=0.9)
    want, new = flax_bn.apply({"params": {"scale": scale, "bias": bias},
                               "batch_stats": {"mean": mean, "var": var}},
                              jnp.asarray(x), mutable=["batch_stats"])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(new["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(new["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-5)
    if train:   # torch's own BatchNorm updates with the unbiased variance
        rm, rv = torch.from_numpy(mean.copy()), torch.from_numpy(var.copy())
        F.batch_norm(torch.from_numpy(x).movedim(-1, 1), rm, rv, training=True, momentum=0.1)
        np.testing.assert_allclose(rm.numpy(), bn.running_mean.numpy(), rtol=1e-5, atol=1e-5)
        assert not np.allclose(rv.numpy(), bn.running_var.numpy(), rtol=1e-5, atol=1e-5)
    out16 = bn(torch.from_numpy(x).bfloat16(), False)
    assert out16.dtype == torch.float32


def test_max_pool_matches_flax():
    x = np.random.default_rng(3).standard_normal((2, 3, 7, 9, 4), dtype=np.float32)
    want = fnn.max_pool(jnp.asarray(x.reshape(6, 7, 9, 4)), (2, 2), (2, 2)).reshape(2, 3, 3, 4, 4)
    np.testing.assert_array_equal(max_pool_2d(torch.from_numpy(x)).numpy(), np.asarray(want))


def test_build_model_sets_the_batchnorms():
    model = build_model("unet-3d", 5, "cpu", **_kwargs(temporal_dim=2))
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    assert len(bns) == 2 * (2 + 1 + 2)
    for bn in bns:
        assert torch.equal(bn.weight, torch.ones_like(bn.weight))
        assert torch.equal(bn.bias, torch.zeros_like(bn.bias))
        assert torch.equal(bn.running_mean, torch.zeros_like(bn.running_mean))
        assert torch.equal(bn.running_var, torch.ones_like(bn.running_var))
        assert int(bn.num_batches_tracked) == 0


@pytest.mark.parametrize("ac", [False, True], ids=["plain", "action_conditional"])
def test_converter_round_trip(ac):
    model, _, variables = _models(ac)
    sd = unet3d_state_dict_from_jax(variables)
    want = model.state_dict()
    assert set(sd) == set(want)
    assert all(torch.equal(sd[k], want[k]) for k in want)
    other = build_model("unet-3d", 9, "cpu", **_kwargs(ac))
    load_jax_params(other, variables)
    assert all(torch.equal(other.state_dict()[k], want[k]) for k in want)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("ac", [False, True], ids=["plain", "action_conditional"])
def test_forward_matches_jax(ac, train):
    model, jmodel, variables = _models(ac)
    x, actions = _inputs(ac=ac)
    fn = jax.jit(lambda v, x, a: jmodel.apply(v, x, pred_frames=PRED, actions=a, train=train,
                                              mutable=["batch_stats"]))
    with jax.default_matmul_precision("highest"):
        (want, _), new = fn(variables, jnp.asarray(x[:, :CTX]), _j(actions))
    got, aux = model(torch.from_numpy(x[:, :CTX]), pred_frames=PRED, actions=_t(actions),
                     train=train)
    assert aux is None and got.shape == (2, PRED, 16, 16, 3)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    if train:   # two rollout steps, each a train-mode forward
        _assert_stats(model, new["batch_stats"])


def _assert_stats(model, jax_stats):
    want = unet3d_state_dict_from_jax({"params": _jax_variables(model)["params"],
                                       "batch_stats": jax_stats})
    got = model.state_dict()
    for k in want:
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=k)


def _jax_sgd_step(jmodel, variables, batch, accum_steps):
    optimizer = optax.sgd(LR)
    state = JaxTrainState(params=variables["params"],
                          extra_vars={"batch_stats": variables["batch_stats"]},
                          opt_state=optimizer.init(variables["params"]),
                          step=jnp.asarray(0, jnp.int32), model_state={},
                          rng=jax.random.PRNGKey(0))
    lp = JaxLossProvider({"losses_and_scales": {"mse": 1.0}, "img_c": 3, "device": None})
    step = jax_loop.make_train_step(jmodel, RUN_CONFIG, optimizer, lp, donate=False,
                                    accum_steps=accum_steps)
    with jax.default_matmul_precision("highest"):
        state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                              jnp.asarray(0.0))
    return state, float(metrics["total"])


@pytest.mark.parametrize("ac,accum_steps", [(False, 1), (True, 1), (False, 2)],
                         ids=["plain", "action_conditional", "accum_steps_2"])
def test_sgd_step_matches_jax(ac, accum_steps):
    model, jmodel, variables = _models(ac)
    x, actions = _inputs(b=4, ac=ac, seed=4)
    batch = {"frames": x, **({"actions": actions} if ac else {})}
    jstate, jloss = _jax_sgd_step(jmodel, variables, batch, accum_steps)

    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = create_train_state(model, lr=LR, optimizer="sgd")
    step = make_train_step(model, RUN_CONFIG, accum_steps=accum_steps)
    _, metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(metrics["total"]), jloss, rtol=1e-5)
    after = unet3d_state_dict_from_jax({"params": jstate.params,
                                        "batch_stats": jstate.extra_vars["batch_stats"]})
    got = model.state_dict()
    for k, v in got.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), after[k].numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=k)
        elif not k.endswith("num_batches_tracked"):
            assert_close_to_largest((before[k] - v) / LR, (before[k] - after[k]) / LR, 2e-4, k)


def assert_close_to_largest(got, want, tol, name):
    r"""``|got - want| <= tol * max(max|want|, 1)``: gradients relative to the
    largest of their tensor (the summed MSE gives gradients of order 100,
    whose f32 sums leave errors of order 1e-3 on their small elements), and
    absolute where all are below 1 (a conv bias before a BatchNorm has a
    gradient of 0, which both sides compute as f32 noise)."""
    got, want = np.asarray(got), np.asarray(want)
    err, scale = np.abs(got - want).max(), max(np.abs(want).max(), 1.0)
    assert err <= tol * scale, f"{name}: max |diff| {err:.3g} > {tol} * {scale:.3g}"


class _ConvDtypes(TorchFunctionMode):
    r"""Records the input dtype of every convolution."""

    def __init__(self):
        super().__init__()
        self.dtypes = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in ("conv2d", "conv3d", "conv_transpose2d"):
            self.dtypes.append(args[0].dtype)
        return func(*args, **(kwargs or {}))


def _jaxpr_conv_dtypes(jaxpr):
    r"""The input dtype of every convolution of ``jaxpr`` and its sub-jaxprs, in order."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "conv_general_dilated":
            out.append(str(eqn.invars[0].aval.dtype))
        for p in eqn.params.values():
            for sub in p if isinstance(p, (list, tuple)) else (p,):
                sub = getattr(sub, "jaxpr", sub)    # a ClosedJaxpr's Jaxpr
                if hasattr(sub, "eqns"):
                    out += _jaxpr_conv_dtypes(sub)
    return out


@pytest.mark.parametrize("lowering", ["cudnn", "banded"])
def test_bf16_convolutions_run_in_jax_dtypes(lowering):
    kw = dict(img_shape=(3, 16, 16), action_size=0, tensor_value_range=(0.0, 1.0), temporal_dim=3)
    model = build_model("unet-3d", 0, "cpu", **kw)
    x = np.random.default_rng(5).random((1, 3, 16, 16, 3), dtype=np.float32)
    with use_lowering(lowering), _ConvDtypes() as rec, torch.no_grad():
        model(torch.from_numpy(x).bfloat16(), pred_frames=2)
    jmodel = JAX_MODELS["unet-3d"](**kw)
    variables = _jax_variables(model)
    jaxpr = jax.make_jaxpr(lambda v, x: jmodel.apply(v, x, pred_frames=2))(
        variables, jnp.asarray(x, jnp.bfloat16))
    want = _jaxpr_conv_dtypes(jaxpr.jaxpr)
    got = [str(d).removeprefix("torch.") for d in rec.dtypes]
    assert (got.count("bfloat16"), got.count("float32")) == (1, 55)
    assert (want.count("bfloat16"), want.count("float32")) == (1, 55)
    assert got == want


def test_create_model_needs_temporal_dim():
    suite = VPSuite(device="cpu")
    suite.load_dataset("MMF", img_size=16, digit_source="synthetic", n_seqs=4)
    with pytest.raises(ValueError, match="temporal_dim"):
        suite.create_model("unet-3d")
    entry = suite.create_model("unet-3d", temporal_dim=2)
    assert entry.model.MIN_CONTEXT_FRAMES == 2 and entry.model.img_shape == (3, 16, 16)
    with pytest.raises(ValueError, match="context frames"):
        suite.predict(np.zeros((1, 16, 16, 3), np.float32))
