r"""Rematerialisation in the port (``vp_suite_tpu_torch.nn.remat``) against
the JAX package's ``remat`` on the CPU, f32.

- ``remat`` and ``remat_policy``: every registry id takes ``remat`` (and
  EF-ConvLSTM ``remat_policy``) with the JAX package's defaults, in its
  ``config``; ``scan_unroll`` and ``use_pallas`` still raise.
- The numbers do not change: a train step's loss and every parameter's
  gradient are bit-identical with ``remat`` on and off, for every model, and
  under each ConvLSTMShi policy (per step, hoisted and raw) against cells
  with ``remat=False``.
- What autograd keeps: for ConvLSTMShi (``"gates"``, ``"full"``, and
  ``"scan_vjp"`` on a layer that takes raw inputs and on a decode layer, each
  in its raw, hoisted and decode forms) and for TrajGRU, the activations the
  port keeps (what reaches ``torch.autograd.graph.saved_tensors_hooks``
  outside the checkpointed regions, and what the regions keep, reported by
  ``remat.observe``; once per storage, a stacked ``[t, b, ...]`` storage as
  its ``t`` steps; parameters and the input sequence left out) against the
  residuals ``jax.ad_checkpoint``'s ``saved_residuals`` lists for the JAX
  block on the same shapes (stacked ``[t, b, ...]`` residuals as ``t`` steps;
  parameters and the input sequence left out), each activation as ``(batch,
  elements per sample)``: TrajGRU's kernels lay the warp tensor and the
  input half out channel-major in JAX, channels-last in the port. The one
  difference is named: JAX's hand-written recurrence VJP (``scan_vjp``) keeps
  the layer's output sequence, its last step ``h_T`` included, which its
  backward never reads; the port's autograd keeps ``h_0 .. h_{T-1}``.
- For every other model the kept bytes fall with ``remat`` on (UNet-3D and
  CopyLastFrame keep the same).
- The recompute is real: under ``"gates"`` the backward runs the gate
  operator (K1's plain version here) once more per step, and the gate conv
  not; TrajGRU's backward runs the warp forward no more than without remat.
- A forward without a gradient (``predict``) runs the same ops with
  ``remat`` on and off.
"""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.ad_checkpoint import saved_residuals
from torch.utils._python_dispatch import TorchDispatchMode

from vp_suite_tpu.model_blocks.conv_lstm_shi import ConvLSTMShi as JaxConvLSTMShi
from vp_suite_tpu.model_blocks.traj_gru import TrajGRU as JaxTrajGRU
from vp_suite_tpu.models import MODEL_CLASSES as JAX_MODELS
from vp_suite_tpu_torch import VPSuite
from vp_suite_tpu_torch.model_blocks.conv_lstm_ndrplz import ConvLSTMNdrplz
from vp_suite_tpu_torch.model_blocks.conv_lstm_shi import ConvLSTMShi
from vp_suite_tpu_torch.model_blocks.traj_gru import TrajGRU
from vp_suite_tpu_torch.models import build_model
from vp_suite_tpu_torch.nn import remat
from vp_suite_tpu_torch.training.loop import make_predict_fn, make_train_step
from vp_suite_tpu_torch.training.train_state import create_train_state

torch.set_num_threads(1)

B, CTX, PRED = 2, 3, 3
BASE = dict(img_shape=(3, 16, 16), action_size=0, tensor_value_range=(0.0, 1.0))
#: registry id and small keywords (SimVP's horizon takes three chunks, so its body is
#: checkpointed; JAX checkpoints it only then)
MODELS = {
    "copy": {},
    "convlstm-shi": {},
    "trajgru": {},
    "unet-3d": dict(temporal_dim=3, features=(4, 8)),
    "predrnn-pp": dict(num_hidden=(8, 8, 8)),
    "phy": dict(convlstm_hidden_dims=(16, 64)),
    "min-conv-rnn": dict(hidden_dim=16),
    "simvp": dict(hid_s=8, hid_t=16, n_trans=2, in_frames=3, out_frames=1),
    "pred-former": dict(patch_size=8, dim=32, depth=2, heads=2),
    "st-phy": dict(img_shape=(3, 32, 32), num_layers=2, st_cell_channels=8,
                   phycell_channels=9, phycell_kernel_size=(3, 3)),
    "lstm": dict(img_shape=(3, 32, 32), bottleneck_dim=32, lstm_hidden_dim=32,
                 lstm_num_layers=2),
}
RUN = {"context_frames": CTX, "pred_frames": PRED, "use_actions": False}


def _frames(img_shape, seed=0):
    _, h, w = img_shape
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.random((B, CTX + PRED, h, w, 3), dtype=np.float32))


class _Ops(TorchDispatchMode):
    r"""Counts the ops that run, by name."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func.name()] += 1
        return func(*args, **(kwargs or {}))


# ---- the hyperparameters --------------------------------------------------------------------

def test_create_model_takes_remat_with_the_jax_defaults():
    suite = VPSuite(device="cpu")
    for model_id, kw in MODELS.items():
        kw = {**BASE, **kw}
        jax_fields = {f.name: f.default for f in dataclasses.fields(JAX_MODELS[model_id])}
        config = suite.create_model(model_id, **kw).config
        assert config["remat"] is jax_fields["remat"] is True, model_id
        assert ("remat_policy" in config) == ("remat_policy" in jax_fields), model_id
        if "remat_policy" in config:
            assert config["remat_policy"] == jax_fields["remat_policy"] == "gates"
        for remat_on in (False, True):
            entry = suite.create_model(model_id, remat=remat_on, **kw)
            assert entry.model.remat is remat_on and entry.config["remat"] is remat_on
        for refused in ("scan_unroll", "use_pallas"):
            with pytest.raises(TypeError, match="unknown hyperparameters"):
                suite.create_model(model_id, **{refused: 1}, **kw)
    entry = suite.create_model("convlstm-shi", remat_policy="full", **BASE)
    assert entry.config["remat_policy"] == "full"
    assert {cell.remat_policy for cell in _cells(entry.model)} == {"full"}


def _cells(model):
    return [m for m in model.modules() if isinstance(m, ConvLSTMShi)]


# ---- the numbers do not change ----------------------------------------------------------------

def _step(model_id, remat_on, **kw):
    r"""Loss and gradients of one SGD train step (f32, CPU)."""
    kw = {**BASE, **MODELS[model_id], **kw}
    model = build_model(model_id, 0, "cpu", remat=remat_on, **kw)
    if remat_on is None:    # EF-ConvLSTM's cells with remat off (the model's never reaches them)
        for cell in _cells(model):
            cell.remat = False
    state = create_train_state(model, lr=1e-2, optimizer="sgd")
    _, metrics = make_train_step(model, RUN)(state, {"frames": _frames(kw["img_shape"])})
    return metrics["total"], {n: p.grad for n, p in model.named_parameters()}


STEP_CASES = [pytest.param(m, {}, id=m) for m in MODELS if m not in ("copy", "convlstm-shi")] \
    + [pytest.param("convlstm-shi", dict(remat_policy=p, hoist_i2h=h),
                    id=f"convlstm-shi-{p}{'-hoisted' if h else ''}")
       for p in ("gates", "full", "scan_vjp") for h in (False, True)]


@pytest.mark.parametrize("model_id,kw", STEP_CASES)
def test_loss_and_gradients_are_bit_identical(model_id, kw):
    off = None if model_id == "convlstm-shi" else False
    loss_off, grads_off = _step(model_id, off, **kw)
    loss_on, grads_on = _step(model_id, True, **kw)
    assert torch.equal(loss_on, loss_off)
    assert grads_on.keys() == grads_off.keys()
    for name, g in grads_on.items():
        assert (g is None) == (grads_off[name] is None), name
        assert g is None or torch.equal(g, grads_off[name]), name


# ---- what autograd keeps, against JAX's residuals --------------------------------------------

T, S, CIN, ENC = 4, 6, 3, 5


def _per_sample(shape):
    return shape[0], int(np.prod(shape[1:]))


def _jax_kept(block, x, states):
    r"""JAX's residuals of the block's forward: ``{(batch, elements per
    sample): count}``, a stacked ``[t, b, ...]`` residual as ``t`` steps; the
    parameters and the input sequence (``from the argument``) left out."""
    params = jax.eval_shape(lambda x, s: block.init(jax.random.PRNGKey(0), x, s, T), x, states)

    def loss(p, x, s):
        out, last = block.apply(p, x, s, T)
        return out.sum() + sum(leaf.sum() for leaf in jax.tree_util.tree_leaves(last))
    kept = collections.Counter()
    for aval, source in saved_residuals(loss, params, x, states):
        shape = tuple(aval.shape)
        if "argument p[" in source or "argument x" in source:
            continue
        if len(shape) >= 3 and shape[:2] == (T, B):
            kept[_per_sample(shape[1:])] += T
        elif len(shape) >= 2 and shape[0] == B:
            kept[_per_sample(shape)] += 1
    return kept


def _port_kept(fn, leave_out):
    r"""What the port keeps for the backward of ``fn()``: ``{(batch, elements
    per sample): count}``, once per storage, a storage that holds ``k`` times
    a tensor's elements as ``k`` of them; ``leave_out``'s storages (parameters,
    the input sequence) left out."""
    packed = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: packed.append(t) or t, lambda t: t), \
            remat.observe() as seen:
        fn()
    skip = {t.untyped_storage().data_ptr() for t in leave_out}
    kept, seen_ptrs = collections.Counter(), set()
    for t in packed + seen:
        ptr = t.untyped_storage().data_ptr()
        if ptr in skip or ptr in seen_ptrs or t.dim() < 2 or t.shape[0] != B:
            continue
        seen_ptrs.add(ptr)
        kept[_per_sample(t.shape)] += t.untyped_storage().nbytes() // (t.numel() * t.itemsize)
    return kept


def _port_bytes(fn, leave_out):
    packed = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: packed.append(t) or t, lambda t: t), \
            remat.observe() as seen:
        fn()
    skip = {t.untyped_storage().data_ptr() for t in leave_out}
    storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in packed + seen if t.untyped_storage().data_ptr() not in skip}
    return sum(storages.values())


def _block_inputs(form, state_shapes):
    rng = np.random.default_rng(3)
    x = None if form == "decode" else torch.from_numpy(
        rng.standard_normal((T, B, S, S, CIN), dtype=np.float32))
    states = None if form != "decode" else tuple(
        torch.from_numpy(rng.standard_normal(s, dtype=np.float32)) for s in state_shapes)
    jx = None if x is None else jax.ShapeDtypeStruct(x.shape, jnp.float32)
    jstates = None if states is None else tuple(
        jax.ShapeDtypeStruct(s.shape, jnp.float32) for s in states)
    return x, states, jx, jstates


#: (form, policy) -> how many ``h``-shaped activations JAX keeps beyond the port
SHI_CASES = {(form, policy): int(policy == "scan_vjp" and form != "raw")
             for form in ("raw", "hoisted", "decode") for policy in ("gates", "full", "scan_vjp")}


@pytest.mark.parametrize("form,policy", list(SHI_CASES), ids=[f"{f}-{p}" for f, p in SHI_CASES])
def test_conv_lstm_shi_keeps_what_jax_keeps(form, policy):
    hoist = form == "hoisted"
    x, states, jx, jstates = _block_inputs(form, [(B, S, S, ENC)] * 2)
    block = ConvLSTMShi(CIN, ENC, S, S, hoist_i2h=hoist, remat_policy=policy)
    port = _port_kept(lambda: block(x, states, T),
                      list(block.parameters()) + ([] if x is None else [x]))
    want = _jax_kept(JaxConvLSTMShi(in_channels=CIN, enc_channels=ENC, state_h=S, state_w=S,
                                    remat_policy=policy, hoist_i2h=hoist, time_major=True),
                     jx, jstates)
    port[_per_sample((B, S, S, ENC))] += SHI_CASES[(form, policy)]
    assert port == want


@pytest.mark.parametrize("form", ["raw", "decode"])
def test_traj_gru_keeps_what_jax_keeps(form):
    x, states, jx, jstates = _block_inputs(form, [(B, S, S, ENC)])
    states, jstates = states and states[0], jstates and jstates[0]
    block = TrajGRU(CIN, ENC, S, S, L=4)
    port = _port_kept(lambda: block(x, states, T),
                      list(block.parameters()) + ([] if x is None else [x]))
    want = _jax_kept(JaxTrajGRU(in_channels=CIN, enc_channels=ENC, state_h=S, state_w=S, L=4,
                                time_major=True), jx, jstates)
    assert port == want
    # the flows and the warp tensor are among them
    assert port[_per_sample((B, S, S, 8))] == T and port[_per_sample((B, S * S, 4, ENC))] == T


def _model_bytes(model_id, remat_on):
    kw = {**BASE, **MODELS[model_id]}
    model = build_model(model_id, 0, "cpu", remat=remat_on, **kw).train()
    x = _frames(kw["img_shape"])
    needs_all = model.NEEDS_COMPLETE_INPUT or model.TRAIN_REGIME == "teacher_forcing"
    x = x if needs_all else x[:, :CTX]
    return _port_bytes(lambda: model(x, pred_frames=PRED, train=True),
                       list(model.parameters()) + [x])


@pytest.mark.parametrize("model_id", [m for m in MODELS if m not in ("convlstm-shi", "trajgru")])
def test_other_models_keep_fewer_bytes(model_id):
    on, off = _model_bytes(model_id, True), _model_bytes(model_id, False)
    if model_id in ("copy", "unet-3d"):
        assert on == off
    else:
        assert 0 < on < off, (on, off)


def test_conv_lstm_ndrplz_block_keeps_fewer_bytes():
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((T, B, S, S, CIN),
                                                                   dtype=np.float32))
    got = {}
    for remat_on in (False, True):
        block = ConvLSTMNdrplz(CIN, 4, (3, 3), 2, remat=remat_on)
        got[remat_on] = _port_bytes(lambda: block(x), list(block.parameters()) + [x])
    assert 0 < got[True] < got[False]


# ---- the recompute is real ---------------------------------------------------------------------

def _backward_ops(block, x, states):
    out, _ = block(x, states, T)
    with _Ops() as ops:
        out.square().sum().backward()
    return ops.counts


@pytest.mark.parametrize("form", ["raw", "hoisted", "decode"])
def test_gates_policy_runs_the_gate_operator_again(form):
    x, states, _, _ = _block_inputs(form, [(B, S, S, ENC)] * 2)
    hoist = form == "hoisted"
    off = _backward_ops(ConvLSTMShi(CIN, ENC, S, S, hoist_i2h=hoist, remat=False), x, states)
    gates = _backward_ops(ConvLSTMShi(CIN, ENC, S, S, hoist_i2h=hoist), x, states)
    full = _backward_ops(ConvLSTMShi(CIN, ENC, S, S, hoist_i2h=hoist, remat_policy="full"),
                         x, states)
    fwd, conv = "vp_suite_tpu_torch::convlstm_gate_forward", "aten::convolution"
    assert off[fwd] == 0 and gates[fwd] == full[fwd] == T
    assert off[conv] == gates[conv] == 0 and full[conv] == T
    assert off["vp_suite_tpu_torch::convlstm_gate_backward"] \
        == gates["vp_suite_tpu_torch::convlstm_gate_backward"] == T


def test_traj_gru_does_not_run_the_warp_forward_again():
    x, _, _, _ = _block_inputs("raw", [])
    counts = {r: _backward_ops(TrajGRU(CIN, ENC, S, S, L=2, remat=r), x, None)
              for r in (False, True)}
    assert counts[True]["vp_suite_tpu_torch::warp_sample_forward"] \
        == counts[False]["vp_suite_tpu_torch::warp_sample_forward"] == 0
    assert counts[True]["vp_suite_tpu_torch::warp_sample_backward"] == T
    # the flow net's first conv runs again, the flow conv does not
    assert counts[True]["aten::convolution"] == T and counts[False]["aten::convolution"] == 0


@pytest.mark.parametrize("model_id", ["convlstm-shi", "trajgru", "predrnn-pp", "pred-former"])
def test_predict_runs_the_same_ops(model_id):
    kw = {**BASE, **MODELS[model_id]}
    frames = _frames(kw["img_shape"])
    counts = {}
    for remat_on in (False, True):
        model = build_model(model_id, 0, "cpu", remat=remat_on, **kw)
        for cell in _cells(model):
            cell.remat = remat_on
        predict = make_predict_fn(model, RUN)
        with _Ops() as ops:
            predict({"frames": frames})
        counts[remat_on] = ops.counts
    assert counts[True] == counts[False]
