r"""The port's importer of reference vp-suite checkpoints
(``utils/torch_import.py``, ``VPSuite.load_torch_model``) against the JAX
package's (``vp_suite_tpu/utils/torch_import.py``).

The port keeps the reference's parameter names and torch layouts, so a port
model stands in for a reference one: its class names are the reference's.
For each of the eight ids the reference has, a port model's ``state_dict``
goes through the JAX package's ``import_state_dict`` and through the port's
(into a freshly built port model); the two forwards agree to 1e-4 (times
the largest prediction where it exceeds 1). JAX's
``import_torch_model`` of the port module gives the port's model id and
constructor arguments. The LSTM quirk: without its cells' keys the port keeps
fresh cells. The port-only ids are refused with the JAX package's message.
The facade loads a pickled module and predicts as the source model does.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vp_suite_tpu.models import MODEL_CLASSES as JAX_MODELS
from vp_suite_tpu.training.loop import _apply_model as jax_apply_model
from vp_suite_tpu.utils import torch_import as jax_torch_import
from vp_suite_tpu_torch import VPSuite
from vp_suite_tpu_torch.models import build_model
from vp_suite_tpu_torch.training.loop import _apply_model
from vp_suite_tpu_torch.utils.torch_import import (TORCH_CLASS_TO_MODEL_ID, import_state_dict,
                                                   import_torch_model, load_torch_checkpoint,
                                                   model_from_import)

torch.set_num_threads(1)

B, CTX, PRED = 2, 3, 2
BASE = dict(img_shape=(3, 16, 16), action_size=0, tensor_value_range=(0.0, 1.0))
#: EF-TrajGRU cut to two narrow layers (as tests/test_torch_traj_gru.py)
TWO = ((3, 3), (3, 3))
TRAJGRU = dict(
    num_layers=2, enc_c=(4, 8, 8, 8), dec_c=(8, 8, 8, 4),
    enc_conv_names=("conv1_leaky_1", "conv2_leaky_1"), enc_conv_k=(3, 3), enc_conv_s=(1, 2),
    enc_conv_p=(1, 1),
    dec_conv_names=("deconv1_leaky_1", "deconv2_leaky_1"), dec_conv_k=(4, 3), dec_conv_s=(2, 1),
    dec_conv_p=(1, 1), final_conv_1_c=4,
    **{f"{kind}_rnn_{name}": v for kind in ("enc", "dec")
       for name, v in (("z", (0.0, 0.0)), ("L", (3, 3)), ("i2h_k", TWO),
                       ("i2h_s", ((1, 1), (1, 1))), ("i2h_p", ((1, 1), (1, 1))),
                       ("h2h_k", ((5, 5), (5, 5))), ("h2h_d", ((1, 1), (1, 1))))})
#: small keywords of each id the reference has
MODELS = {
    "copy": {},
    "convlstm-shi": {},
    "trajgru": TRAJGRU,
    "unet-3d": dict(temporal_dim=3, features=(4, 8)),
    "predrnn-pp": dict(num_hidden=(8, 8, 8)),
    "phy": dict(convlstm_hidden_dims=(16, 64)),
    "st-phy": dict(img_shape=(3, 32, 32), num_layers=2, st_cell_channels=8, phycell_channels=9,
                   phycell_kernel_size=(3, 3)),
    "lstm": dict(img_shape=(3, 32, 32), bottleneck_dim=32, lstm_hidden_dim=32, lstm_num_layers=2),
}


def _kwargs(model_id):
    return {**BASE, **MODELS[model_id]}


@functools.cache
def _source(model_id):
    r"""The source model: a port model from seed 3, every parameter and
    buffer moved off its initial value (LayerNorm and GroupNorm affines,
    BatchNorm statistics), so that a name mapped wrong shows."""
    model = build_model(model_id, 3, "cpu", **_kwargs(model_id))
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for t in list(model.parameters()) + [b for b in model.buffers() if b.is_floating_point()]:
            t.add_(torch.rand(t.shape, generator=g) * 0.05)
    return model


def _frames(model_id):
    _, h, w = _kwargs(model_id)["img_shape"]
    t = CTX + (PRED if JAX_MODELS[model_id].NEEDS_COMPLETE_INPUT else 0)
    return np.random.default_rng(5).random((B, t, h, w, 3), dtype=np.float32)


def _assert_close(got, want):
    r"""1e-4, times the largest |prediction| where it exceeds 1 (the LSTM's
    decoder, whose moved weights give predictions of some hundreds)."""
    np.testing.assert_allclose(got, want, atol=1e-4 * max(1.0, float(np.abs(want).max())))


def _port_forward(model, x):
    with torch.no_grad():
        return _apply_model(model, torch.from_numpy(x), pred_frames=PRED, train=False)[0].numpy()


def _jax_forward(model_id, kwargs, variables, x):
    jkw = dict(kwargs)
    if "remat" in {f.name for f in dataclasses.fields(JAX_MODELS[model_id])}:
        jkw["remat"] = False
    model = JAX_MODELS[model_id](**jkw)
    params = variables.get("params", {})
    extra = {k: v for k, v in variables.items() if k != "params"}
    (preds, _), _ = jax_apply_model(model, params, extra, jnp.asarray(x), pred_frames=PRED,
                                    train=False)
    return np.asarray(preds, np.float32)


def _numpy_state_dict(model_id):
    return {k: v.numpy().copy() for k, v in _source(model_id).state_dict().items()}


@functools.cache
def _jax_prediction(model_id):
    r"""The JAX model's forward on the source's weights, carried by the JAX
    package's ``import_state_dict``."""
    variables = jax_torch_import.import_state_dict(model_id, _numpy_state_dict(model_id))
    return _jax_forward(model_id, _kwargs(model_id), variables, _frames(model_id))


@pytest.mark.parametrize("model_id", list(MODELS))
def test_state_dict_imports_as_in_jax(model_id):
    sd = _numpy_state_dict(model_id)
    x = _frames(model_id)
    port = model_from_import(model_id, _kwargs(model_id), import_state_dict(model_id, sd),
                             device="cpu")
    got = _port_forward(port, x)
    np.testing.assert_array_equal(got, _port_forward(_source(model_id), x))
    _assert_close(got, _jax_prediction(model_id))


def test_nested_constructor_arguments_are_read():
    r"""EF-TrajGRU's per-layer kernel sizes are tuples of tuples: the port
    reads them off the module (two layers here), where the JAX importer keeps
    flat tuples only and falls back to its three-layer defaults."""
    _, port_kwargs, _ = import_torch_model(_source("trajgru"))
    _, jax_kwargs, _ = jax_torch_import.import_torch_model(_source("trajgru"))
    for name in ("enc_rnn_i2h_k", "dec_rnn_h2h_k", "enc_rnn_L", "enc_c"):
        assert port_kwargs[name] == TRAJGRU[name]
    assert "enc_rnn_i2h_k" not in jax_kwargs and jax_kwargs["enc_c"] == TRAJGRU["enc_c"]


@pytest.mark.parametrize("model_id", ["convlstm-shi", "predrnn-pp", "lstm"])
def test_torch_model_imports_as_in_jax(model_id):
    r"""JAX's ``import_torch_model`` of the module and the port's: the same id,
    the same value for every constructor argument both read, JAX's variables
    those of its state-dict path, and forwards that agree."""
    source = _source(model_id)
    jax_id, jax_kwargs, jax_variables = jax_torch_import.import_torch_model(source)
    port_id, port_kwargs, sd = import_torch_model(source)
    assert port_id == jax_id == model_id
    shared = set(jax_kwargs) & set(port_kwargs)
    assert {"img_shape", "action_size", "tensor_value_range"} <= shared
    assert {k: port_kwargs[k] for k in shared} == {k: jax_kwargs[k] for k in shared}
    want_variables = jax_torch_import.import_state_dict(model_id, _numpy_state_dict(model_id))
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: bool(jnp.array_equal(a, b)), jax_variables, want_variables))
    x = _frames(model_id)
    got = _port_forward(model_from_import(port_id, port_kwargs, sd, device="cpu"), x)
    np.testing.assert_array_equal(got, _port_forward(source, x))
    _assert_close(got, _jax_prediction(model_id))


def test_lstm_without_its_cells_keeps_fresh_ones():
    r"""The reference LSTM's cells are absent from its ``state_dict``: the port
    keeps the freshly drawn cells of the seed and takes the rest."""
    source = _source("lstm")
    sd = {k: v for k, v in source.state_dict().items() if not k.startswith("rnn_layers.")}
    assert len(sd) < len(source.state_dict())
    model = model_from_import("lstm", _kwargs("lstm"), import_state_dict("lstm", sd),
                              device="cpu", seed=7)
    fresh = build_model("lstm", 7, "cpu", **_kwargs("lstm")).state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, fresh[k] if k.startswith("rnn_layers.") else sd[k]), k
    with pytest.raises(ValueError, match="missing"):
        model_from_import("convlstm-shi", _kwargs("convlstm-shi"),
                          {k: v for k, v in _source("convlstm-shi").state_dict().items()
                           if "rnn1" not in k}, device="cpu")


@pytest.mark.parametrize("model_id", ["min-conv-rnn", "simvp", "pred-former"])
def test_port_only_ids_are_refused_as_in_jax(model_id):
    with pytest.raises(ValueError) as want:
        jax_torch_import.import_state_dict(model_id, {})
    with pytest.raises(ValueError) as got:
        import_state_dict(model_id, {})
    assert str(got.value) == str(want.value)
    assert sorted(TORCH_CLASS_TO_MODEL_ID) == sorted(jax_torch_import.TORCH_CLASS_TO_MODEL_ID)


def test_facade_loads_a_pickled_module(tmp_path):
    r"""``torch.save`` of the module, then ``load_torch_model``: the model
    predicts what the source does, with a fresh training state."""
    source = _source("convlstm-shi")
    torch.save(source, tmp_path / "best_model.pth")
    model_id, kwargs, _ = load_torch_checkpoint(tmp_path / "best_model.pth")
    assert model_id == "convlstm-shi" and kwargs["img_shape"] == (3, 16, 16)
    suite = VPSuite(device="cpu")
    entry = suite.load_torch_model(str(tmp_path))
    assert entry.model_id == "convlstm-shi" and entry.state.step == 0
    assert entry.state.optimizer.param_groups[0]["lr"] == 1e-4
    x = _frames("convlstm-shi")
    got = suite.predict(x, pred_frames=PRED)
    assert torch.equal(got, torch.from_numpy(_port_forward(source, x)))
