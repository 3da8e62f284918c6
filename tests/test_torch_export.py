r"""The port's serving export (``serving/export.py``, ``torch.export``) against
in-process prediction and against the JAX package's StableHLO artifacts.

The seven cases of ``tests/test_serving.py``: the saved and loaded program
reproduces the port's own prediction to 1e-6 and the JAX package's exported
artifact, on the port's weights carried into JAX by its
``utils/torch_import.import_state_dict`` (the port keeps the reference's
parameter names and layouts), to 1e-4; a ``NEEDS_COMPLETE_INPUT`` model, a
batch-polymorphic program, an action-conditional one (``(frames, actions)``),
a bf16 serving graph, the facade's ``export_model``, and the refusal without
a model. And the exported graphs hold the kernels' operators, not their plain
decomposition: EF-ConvLSTM per-step ``convlstm_gate_forward`` (K1), fused
``convlstm_scan_forward`` (K3), EF-TrajGRU ``warp_sample_forward``. Each of
the ten kernel operators has a CPU and a CUDA kernel at the dispatcher and a
fake implementation that gives the CPU kernel's output shapes and dtypes.
"""
import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vp_suite_tpu.models import MODEL_CLASSES as JAX_MODELS
from vp_suite_tpu.serving import export_predictor as jax_export_predictor
from vp_suite_tpu.utils.torch_import import import_state_dict
from vp_suite_tpu_torch import VPSuite
from vp_suite_tpu_torch.defaults import SETTINGS
from vp_suite_tpu_torch.models import build_model
from vp_suite_tpu_torch.serving import export_predictor, load_predictor, save_predictor
from vp_suite_tpu_torch.training.loop import _apply_model

torch.set_num_threads(1)

IMG, CTX, PRED, B = 16, 2, 3, 2
BASE = dict(img_shape=(3, IMG, IMG), action_size=0, tensor_value_range=(0.0, 1.0))
FUSED = dict(use_fused_scan=True, interleaved_encode=False, interleaved_forecast=False)
PREDRNN = dict(num_layers=2, num_hidden=(8, 8))
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
LSTM_AC = dict(img_shape=(3, 32, 32), action_size=2, action_conditional=True, bottleneck_dim=32,
               lstm_hidden_dim=32, lstm_num_layers=2)


def _model(model_id, **kw):
    return build_model(model_id, 0, "cpu", **{**BASE, **kw})


def _frames(seed, b, t, img=IMG):
    return np.random.RandomState(seed).rand(b, t, img, img, 3).astype(np.float32)


def _in_process(model, x, actions=None):
    kw = {} if actions is None else {"actions": torch.from_numpy(actions)}
    with torch.no_grad():
        preds, _ = _apply_model(model, torch.from_numpy(x), pred_frames=PRED, train=False, **kw)
    return preds.numpy()


def _jax_artifact(model_id, model, batch_size=B, **kw):
    r"""The JAX package's exported predictor of the same model, its weights
    carried from the port's ``state_dict``."""
    variables = import_state_dict(model_id, model.state_dict())
    state = types.SimpleNamespace(params=variables["params"],
                                  extra_vars={k: v for k, v in variables.items() if k != "params"})
    jax_model = JAX_MODELS[model_id](**{**BASE, **kw})
    return jax_export_predictor(jax_model, state, CTX, PRED, batch_size=batch_size)


@functools.cache
def _convlstm():
    return _model("convlstm-shi")


def _graph_targets(exported):
    return {str(n.target) for n in exported.graph.nodes if n.op == "call_function"}


def test_export_roundtrip_matches_in_process(tmp_path):
    model = _convlstm()
    path = save_predictor(export_predictor(model, None, CTX, PRED, batch_size=B),
                          tmp_path / "predictor.pt2")
    assert path.stat().st_size > 0
    predict = load_predictor(path)
    x = _frames(0, B, CTX)
    out = predict(torch.from_numpy(x))
    assert out.shape == (B, PRED, IMG, IMG, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), _in_process(model, x), atol=1e-6)
    jax_out = _jax_artifact("convlstm-shi", model).call(jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_out), atol=1e-4)


def test_export_needs_complete_input_model(tmp_path):
    r"""A NEEDS_COMPLETE_INPUT model (PredRNN++) takes the whole ctx + pred
    window; the exported signature reflects that."""
    model = _model("predrnn-pp", **PREDRNN)
    predict = load_predictor(save_predictor(export_predictor(model, None, CTX, PRED,
                                                             batch_size=B), tmp_path / "p.pt2"))
    x = _frames(1, B, CTX + PRED)
    out = predict(torch.from_numpy(x))
    assert out.shape[:2] == (B, PRED) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), _in_process(model, x), atol=1e-6)
    jax_out = _jax_artifact("predrnn-pp", model, **PREDRNN).call(jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_out), atol=1e-4)


def test_export_batch_polymorphic(tmp_path):
    r"""batch_size=None exports one program with a symbolic batch dimension;
    it serves several batch sizes and matches the in-process forward."""
    model = _convlstm()
    exported = export_predictor(model, None, CTX, PRED, batch_size=None)
    predict = load_predictor(save_predictor(exported, tmp_path / "poly.pt2"))
    jax_exported = _jax_artifact("convlstm-shi", model, batch_size=None)
    for b in (1, 3):
        x = _frames(5, b, CTX)
        out = predict(torch.from_numpy(x))
        assert out.shape == (b, PRED, IMG, IMG, 3)
        np.testing.assert_allclose(out.numpy(), _in_process(model, x), atol=1e-6)
        if b == 3:
            np.testing.assert_allclose(out.numpy(), np.asarray(jax_exported.call(jnp.asarray(x))),
                                       atol=1e-4)


def test_export_action_conditional(tmp_path):
    r"""An action-conditional program takes (frames, actions) and matches
    the in-process forward; the actions change the predictions."""
    model = _model("lstm", **LSTM_AC)
    predict = load_predictor(save_predictor(export_predictor(model, None, CTX, PRED,
                                                             batch_size=B), tmp_path / "ac.pt2"))
    rng = np.random.RandomState(6)
    x = rng.rand(B, CTX, 32, 32, 3).astype(np.float32)
    a = rng.rand(B, CTX + PRED, 2).astype(np.float32)
    out = predict(torch.from_numpy(x), torch.from_numpy(a))
    assert out.shape == (B, PRED, 32, 32, 3)
    np.testing.assert_allclose(out.numpy(), _in_process(model, x, a), atol=1e-6)
    jax_out = _jax_artifact("lstm", model, **LSTM_AC).call(jnp.asarray(x), jnp.asarray(a))
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_out), atol=1e-4)
    out2 = predict(torch.from_numpy(x), torch.from_numpy(a + 1.0))
    assert (out - out2).abs().max() > 1e-6


def test_export_bf16_compute_dtype(tmp_path):
    r"""compute_dtype=bfloat16 bakes a bf16 serving graph; input and output
    stay f32 and track the f32 program within bf16's tolerance; the model
    keeps its own dtype."""
    model = _convlstm()
    x = torch.from_numpy(_frames(2, B, CTX))
    f32 = load_predictor(save_predictor(export_predictor(model, None, CTX, PRED, batch_size=B),
                                        tmp_path / "f32.pt2"))(x)
    bf16 = load_predictor(save_predictor(
        export_predictor(model, None, CTX, PRED, batch_size=B, compute_dtype=torch.bfloat16),
        tmp_path / "bf16.pt2"))(x)
    assert bf16.dtype == torch.float32 and model.compute_dtype == torch.float32
    assert 0.0 < (f32 - bf16).abs().max() < 0.05


def test_facade_export(tmp_path, monkeypatch):
    monkeypatch.setattr(SETTINGS, "_run_path", tmp_path)
    suite = VPSuite(device="cpu")
    suite.load_dataset("MMF", img_size=IMG, digit_source="synthetic", n_seqs=8)
    suite.create_model("convlstm-shi")
    path = suite.export_model(tmp_path / "m.pt2", context_frames=CTX, pred_frames=PRED,
                              batch_size=1)
    out = load_predictor(path)(torch.zeros(1, CTX, IMG, IMG, 3))
    assert out.shape == (1, PRED, IMG, IMG, 3)
    want = suite.predict(np.zeros((1, CTX, IMG, IMG, 3), np.float32), pred_frames=PRED)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-6)


def test_export_without_model_raises(tmp_path):
    with pytest.raises(ValueError, match="No model"):
        VPSuite(device="cpu").export_model(tmp_path / "x.pt2", context_frames=2, pred_frames=2)


@pytest.mark.parametrize("name,model_id,kw,op,plain", [
    ("per_step", "convlstm-shi", {}, "convlstm_gate_forward", ("aten.sigmoid", "aten.tanh")),
    ("fused_scan", "convlstm-shi", FUSED, "convlstm_scan_forward", ("aten.sigmoid", "aten.tanh")),
    ("trajgru", "trajgru", TRAJGRU, "warp_sample_forward", ("aten.floor", "aten.index"))],
    ids=["per_step", "fused_scan", "trajgru"])
def test_exported_graph_holds_the_kernel_operators(name, model_id, kw, op, plain):
    r"""The graph calls the kernel's operator (K1, K3, the warp forward) and
    none of its plain version's elementwise or gather ops, which the model
    around the kernel does not use either."""
    model = _convlstm() if name == "per_step" else _model(model_id, **kw)
    targets = _graph_targets(export_predictor(model, None, CTX, PRED, batch_size=B))
    assert f"vp_suite_tpu_torch.{op}.default" in targets
    assert not [t for t in targets if t.split(".")[0:2] in [p.split(".") for p in plain]]


def _operator_cases():
    r"""``(name, args)``: each kernel operator on small CPU operands."""
    g = torch.Generator().manual_seed(9)

    def r(*shape):
        return torch.randn(*shape, generator=g)
    b, h, w, c, L, T = 2, 4, 5, 16, 3, 3
    P = h * w
    gates, cell, peep = r(b, h, w, 4 * c), r(b, h, w, c), [r(h, w, c) * 0.1 for _ in range(3)]
    scan = (None, r(b, h, w, c), r(b, h, w, c), r(3, 3, c, 4 * c) * 0.1, r(4 * c), *peep, T)
    _, _, z, c_prev = torch.ops.vp_suite_tpu_torch.convlstm_scan_forward.default(*scan, True)
    iy, ix, img = torch.rand(b, P, L, generator=g) * h, torch.rand(b, P, L, generator=g) * w, \
        r(b, h, w, c)
    wr, br, A, Bm = r(L, c, 5), r(5), r(b, L, P, h), r(b, L, P, w)
    sym = r(b, 5, 5)
    return {
        "convlstm_gate_forward": (gates, cell, *peep),
        "convlstm_gate_backward": (gates, cell, *peep, cell, cell),
        "convlstm_scan_forward": scan + (True,),
        "convlstm_scan_backward": (z, c_prev, r(T, b, h, w, c), cell, scan[3], *peep, None),
        "warp_sample_forward": (iy, ix, img),
        "warp_sample_backward": (iy, ix, img, r(b, P, L, c)),
        "warp_ret_forward": (iy, ix, img, wr, br),
        "warp_ret_backward": (iy, ix, img, wr, br, r(b, P, 5)),
        "warp_contract_forward": (A, Bm, img),
        "warp_contract_backward": (A, Bm, img, r(b, L, P, c)),
        "sym_eig": (sym @ sym.transpose(-1, -2),),
    }


OPERATORS = ["convlstm_gate_forward", "convlstm_gate_backward", "convlstm_scan_forward",
             "convlstm_scan_backward", "warp_sample_forward", "warp_sample_backward",
             "warp_ret_forward", "warp_ret_backward", "warp_contract_forward",
             "warp_contract_backward", "sym_eig"]


@pytest.mark.parametrize("name", OPERATORS)
def test_operator_kernels_and_fake(name):
    r"""Each kernel operator has a CPU and a CUDA kernel at the dispatcher and
    a fake implementation that gives the CPU kernel's shapes and dtypes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    op = getattr(torch.ops.vp_suite_tpu_torch, name).default
    for key in ("CPU", "CUDA"):
        assert torch._C._dispatch_has_kernel_for_dispatch_key(op.name(), key)
    args = _operator_cases()[name]
    want = op(*args)
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args))
    want, fake = (list(want), list(fake)) if isinstance(want, (tuple, list)) else ([want], [fake])
    assert [(tuple(t.shape), t.dtype) for t in fake] == [(tuple(t.shape), t.dtype) for t in want]
