r"""The port's EF-ConvLSTM against the JAX package's, on the same weights.

JAX ``init_params`` at ``img_shape=(3, 16, 16)`` is carried into the port with
``vp_suite_tpu_torch.utils.jax_params.load_jax_params``; 3 context -> 4
predicted frames in f32 must agree with JAX ``model.apply`` to 1e-4 (the
repo's golden tolerance) in each schedule and cell form. The port's
``state_dict`` must also map back through the JAX package's torch importer to
exactly the JAX parameters.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vp_suite_tpu.models import MODEL_CLASSES as JAX_MODELS
from vp_suite_tpu.utils.torch_import import import_state_dict
from vp_suite_tpu_torch.models import MODEL_CLASSES
from vp_suite_tpu_torch.utils.jax_params import load_jax_params

torch.set_num_threads(1)

KWARGS = dict(img_shape=(3, 16, 16), action_size=0, tensor_value_range=(0.0, 1.0))
CONFIGS = {
    "interleaved": {},
    "staged": dict(interleaved_encode=False, interleaved_forecast=False),
    "fused_scan": dict(use_fused_scan=True),
    "hoisted_i2h": dict(hoist_i2h=True),
}


@pytest.fixture(scope="module")
def jax_params():
    model = JAX_MODELS["convlstm-shi"](**KWARGS)
    return jax.jit(model.init_params)(jax.random.PRNGKey(0))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_ef_convlstm_matches_jax(jax_params, name):
    cfg = CONFIGS[name]
    x = np.random.default_rng(0).random((2, 3, 16, 16, 3)).astype(np.float32)
    jax_model = JAX_MODELS["convlstm-shi"](**KWARGS, **cfg)
    with jax.default_matmul_precision("highest"):
        want, _ = jax.jit(lambda p, x: jax_model.apply({"params": p}, x, pred_frames=4))(
            jax_params, jnp.asarray(x))
    model = load_jax_params(MODEL_CLASSES["convlstm-shi"](**KWARGS, **cfg), jax_params)
    with torch.inference_mode():
        got, aux = model(torch.from_numpy(x), pred_frames=4)
    assert aux is None and got.shape == (2, 4, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_state_dict_round_trips_through_torch_import(jax_params):
    model = load_jax_params(MODEL_CLASSES["convlstm-shi"](**KWARGS), jax_params)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    back = import_state_dict("convlstm-shi", sd)["params"]
    want_leaves, want_tree = jax.tree_util.tree_flatten(jax_params)
    got_leaves, got_tree = jax.tree_util.tree_flatten(back)
    assert got_tree == want_tree
    for got, want in zip(got_leaves, want_leaves):
        assert got.shape == want.shape and np.array_equal(np.asarray(got), np.asarray(want))


def test_load_rejects_a_tree_of_another_shape(jax_params):
    model = MODEL_CLASSES["convlstm-shi"](**{**KWARGS, "img_shape": (3, 32, 32)})
    with pytest.raises(RuntimeError):
        load_jax_params(model, jax_params)
