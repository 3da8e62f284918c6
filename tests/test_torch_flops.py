r"""The port's FLOP counter (``utils/flops.py``) against the JAX package's
jaxpr walker (``vp_suite_tpu/utils/flops.py``), traced on the CPU.

- The JAX counter's own cases (``tests/test_flops.py``): a loop of products,
  a convolution, a backward, a nested call.
- Each kernel operator's formula, and the formula against the products of the
  operator's plain version where the two compute the same ones.
- ``predict`` and the train step of every registry model at a small size
  (b=2, 3 -> 3) against the JAX count of the same model and shapes, both
  with ``remat=False`` (EF-ConvLSTM's cells checkpoint whatever the model's
  ``remat`` says, in both packages; their recompute, the gate block's
  elementwise work, counts 0), and the train step with ``remat=True`` on both
  sides, whose counts include the backward's recompute in both. The
  two counters differ in how they count a convolution that XLA lowers with
  an input dilation: JAX counts a transposed convolution over its output
  (the zeros of the dilated input included), and the input gradient of a
  strided convolution over the gradient dilated by the stride; PyTorch's
  counter counts both over the undilated tensor. :func:`count_as_jax` counts
  the port's call with JAX's convention for those; the rest of each
  difference is named in :data:`DIFFERENCES` (and, with ``remat``, in
  :data:`REMAT_DIFFERENCES`), and computed where a part of the JAX package
  alone accounts for it.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode, conv_flop_count

from vp_suite_tpu.measure.loss_provider import PredictionLossProvider as JaxLossProvider
from vp_suite_tpu.models import MODEL_CLASSES as JAX_MODELS
from vp_suite_tpu.ops.pallas_warp import warp_sample as jax_warp_sample
from vp_suite_tpu.training import loop as jax_loop
from vp_suite_tpu.training.train_state import create_train_state as jax_create_train_state
from vp_suite_tpu.utils.flops import count_flops as jax_count_flops
from vp_suite_tpu_torch.models import build_model
from vp_suite_tpu_torch.ops import cells, convlstm, warp
from vp_suite_tpu_torch.training.loop import make_predict_fn, make_train_step
from vp_suite_tpu_torch.training.train_state import create_train_state
from vp_suite_tpu_torch.utils.flops import count_flops

torch.set_num_threads(1)
aten = torch.ops.aten


# ---- the JAX counter's own cases ------------------------------------------------------------

def test_loop_of_products_counts_each():
    x = torch.ones(128, 128)

    def f(x):
        for _ in range(10):
            x = x @ x
        return x
    assert count_flops(f, x) == 10 * 2 * 128 ** 3


def test_conv_flops():
    x, k = torch.ones(2, 3, 8, 8), torch.ones(16, 3, 3, 3)
    assert count_flops(torch.nn.functional.conv2d, x, k, padding=1) == 2 * 2 * 64 * 16 * 9 * 3


def test_backward_is_counted():
    r"""fwd + the two backward products (JAX's case adds a remat recompute,
    which the port does not do)."""
    w = torch.ones(64, 64, requires_grad=True)

    def h(w):
        out = w
        for _ in range(4):
            out = torch.tanh(out @ w)
        out.sum().backward()
    fwd = 4 * 2 * 64 ** 3
    assert count_flops(h, w) == 3 * fwd


def test_nested_function_is_traversed():
    def inner(a, b):
        return a @ b
    assert count_flops(lambda a, b: inner(a, b), torch.ones(32, 64), torch.ones(64, 16)) \
        == 2 * 32 * 64 * 16


# ---- the kernel operators --------------------------------------------------------------------

def _plain_products(fn, *args):
    r"""FLOPs of PyTorch's products inside ``fn`` (the operators' plain
    versions, called directly)."""
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


def test_scan_operators_count_the_hidden_convolution():
    r"""K3 and K3s count ``2 T b sh sw 9 enc 4enc``, the products of their plain
    version's ``F.conv2d``; K4 the same, those of its ``F.conv_transpose2d``."""
    g = torch.Generator().manual_seed(0)
    T, b, sh, sw, enc = 3, 2, 6, 5, 8
    h0, c0 = torch.randn(b, sh, sw, enc, generator=g), torch.randn(b, sh, sw, enc, generator=g)
    hk, bias = torch.randn(3, 3, enc, 4 * enc, generator=g) * 0.1, torch.zeros(4 * enc)
    peep = [torch.randn(sh, sw, enc, generator=g) * 0.1 for _ in range(3)]
    want = 2 * T * b * sh * sw * 9 * enc * 4 * enc
    args = (None, h0, c0, hk, bias, *peep, T)
    assert count_flops(convlstm.convlstm_scan_forward, *args) == want
    assert count_flops(convlstm.convlstm_scan_forward, *args, save_gates=True) == want
    assert _plain_products(convlstm.convlstm_scan_forward_reference, *args) == want
    _, _, z, c_prev = convlstm.convlstm_scan_forward(*args, save_gates=True)
    bwd = (z, c_prev, torch.randn(T, b, sh, sw, enc, generator=g), c0, hk, *peep)
    assert count_flops(convlstm.convlstm_scan_backward, *bwd) == want
    assert _plain_products(convlstm.convlstm_scan_backward_reference, *bwd) == want


def test_warp_ret_and_contract_count_their_contractions():
    r"""K8: ``2 b P L f O`` forward (its plain version's product) and twice
    that backward; K9: ``2 b L P h w c`` forward, the plain version's first
    contraction (``A img`` over y; its second, over x, is h times smaller),
    and twice that backward."""
    g = torch.Generator().manual_seed(1)
    b, h, w, f, L, O = 2, 5, 6, 4, 3, 7
    P = h * w
    iy, ix = torch.rand(b, P, L, generator=g) * h, torch.rand(b, P, L, generator=g) * w
    img = torch.randn(b, h, w, f, generator=g)
    wr, br = torch.randn(L, f, O, generator=g), torch.randn(O, generator=g)
    ret = 2 * b * P * L * f * O
    assert count_flops(warp.warp_ret_forward, iy, ix, img, wr, br) == ret
    assert _plain_products(warp.warp_ret_reference, iy, ix, img, wr, br) == ret
    assert count_flops(warp.warp_ret_backward, iy, ix, img, wr, br,
                       torch.randn(b, P, O, generator=g)) == 2 * ret
    A, Bm = torch.randn(b, L, P, h, generator=g), torch.randn(b, L, P, w, generator=g)
    contract = 2 * b * L * P * h * w * f
    assert count_flops(warp.warp_contract_forward, A, Bm, img) == contract
    assert _plain_products(warp.warp_contract_reference, A, Bm, img) \
        == contract + 2 * b * L * P * w * f
    assert count_flops(warp.warp_contract_backward, A, Bm, img,
                       torch.randn(b, L, P, f, generator=g)) == 2 * contract


def test_gate_and_warp_operators_count_zero():
    r"""K1, K2 and the warp are elementwise or gathers: 0, as the JAX
    counter's count of its CPU gate path; the operator hides its plain
    version's work from the counter (whose einsums would count)."""
    g = torch.Generator().manual_seed(2)
    c = torch.randn(2, 4, 4, 8, generator=g)
    gates, peep = torch.randn(2, 4, 4, 32, generator=g), [torch.randn(4, 4, 8) for _ in range(3)]
    assert count_flops(cells.convlstm_gate_forward, gates, c, *peep) == 0
    assert count_flops(cells.convlstm_gate_backward, gates, c, *peep, c, c) == 0
    iy = ix = torch.rand(2, 16, 3, generator=g) * 4
    assert count_flops(warp.warp_sample_forward, iy, ix, c) == 0
    assert count_flops(warp.warp_sample_backward, iy, ix, c, torch.randn(2, 16, 3, 8)) == 0


# ---- the registry models against the JAX package --------------------------------------------

B, CTX, PRED = 2, 3, 3
BASE = dict(img_shape=(3, 16, 16), action_size=0, tensor_value_range=(0.0, 1.0))
#: registry id and small keywords of each configuration (the JAX models' ``remat`` off)
MODELS = {
    "copy": ("copy", {}),
    "convlstm-shi": ("convlstm-shi", {}),
    "convlstm-shi-fused": ("convlstm-shi", dict(use_fused_scan=True, interleaved_encode=False,
                                                interleaved_forecast=False)),
    "trajgru": ("trajgru", {}),
    "unet-3d": ("unet-3d", dict(temporal_dim=3, features=(4, 8))),
    "predrnn-pp": ("predrnn-pp", dict(num_hidden=(8, 8, 8))),
    "phy": ("phy", dict(convlstm_hidden_dims=(16, 64))),
    "min-conv-rnn": ("min-conv-rnn", dict(hidden_dim=16)),
    "simvp": ("simvp", dict(hid_s=8, hid_t=16, n_trans=2, in_frames=3)),
    "pred-former": ("pred-former", dict(patch_size=8, dim=32, depth=2, heads=2)),
    "st-phy": ("st-phy", dict(img_shape=(3, 32, 32), num_layers=2, st_cell_channels=8,
                              phycell_channels=9, phycell_kernel_size=(3, 3))),
    "lstm": ("lstm", dict(img_shape=(3, 32, 32), bottleneck_dim=32, lstm_hidden_dim=32,
                          lstm_num_layers=2)),
}
RUN_CONFIG = {"context_frames": CTX, "pred_frames": PRED, "use_actions": False}


def _jax_conv(x, w, bias, stride, padding, dilation, transposed, *args, out_shape=None,
              **kwargs):
    r"""A forward convolution as the JAX counter counts it: a transposed one
    over its output."""
    if transposed:
        return 2 * math.prod(out_shape) * math.prod(w[2:]) * w[0]
    return conv_flop_count(x, w, out_shape, False)


def _jax_conv_backward(grad_out, x, w, bias, stride, padding, dilation, transposed,
                       output_padding, groups, mask, out_shape, **kwargs):
    r"""A convolution's gradients as the JAX counter counts them: the input
    gradient of a strided convolution over the input's size (the gradient
    dilated by the stride), a transposed convolution's weight gradient over
    its output's size."""
    def t(shape):
        return [shape[1], shape[0], *shape[2:]]
    count, k = 0, math.prod(w)
    if mask[0]:
        count += conv_flop_count(grad_out, w, out_shape[0], not transposed)
        if not transposed and any(s > 1 for s in stride):
            count += 2 * grad_out[0] * k * (math.prod(x[2:]) - math.prod(grad_out[2:]))
    if mask[1]:
        if transposed:
            count += 2 * grad_out[0] * k * math.prod(grad_out[2:])
        else:
            count += conv_flop_count(t(x), t(grad_out), t(out_shape[1]), False)
    return count


def count_as_jax(fn, *args):
    r""":func:`count_flops` with the JAX counter's convention for the
    convolutions that XLA lowers with an input dilation."""
    mapping = {aten.convolution: _jax_conv, aten.convolution_backward: _jax_conv_backward}
    with FlopCounterMode(display=False, custom_mapping=mapping) as counter:
        fn(*args)
    return counter.get_total_flops()


def _frames(img_shape):
    _, h, w = img_shape
    return np.random.default_rng(0).random((B, CTX + PRED, h, w, 3), dtype=np.float32)


@functools.cache
def _port_counts(name, remat=False):
    model_id, kw = MODELS[name]
    kw = {**BASE, **kw}
    model = build_model(model_id, 0, "cpu", remat=remat, **kw)
    batch = {"frames": torch.from_numpy(_frames(kw["img_shape"])),
             "actions": torch.zeros(B, CTX + PRED, 1)}
    predict = make_predict_fn(model, RUN_CONFIG)
    counts = {"predict": (count_flops(predict, batch), count_as_jax(predict, batch))}
    if model.TRAINABLE:
        step = make_train_step(model, RUN_CONFIG)
        counts["train"] = (count_flops(step, create_train_state(model), batch, 0),
                           count_as_jax(step, create_train_state(model), batch, 0))
    return counts


@functools.cache
def _jax_counts(name, remat=False):
    r"""The JAX counts of ``predict`` and the train step, traced on abstract
    parameters (``jax.eval_shape`` of the state: nothing is initialised)."""
    model_id, kw = MODELS[name]
    kw = {**BASE, **kw, "remat": remat}
    model = JAX_MODELS[model_id](**kw)
    optimizer = optax.adam(1e-4)
    state = jax.eval_shape(lambda: jax_create_train_state(
        model, optimizer, jax.random.PRNGKey(0), context_frames=CTX, pred_frames=PRED))
    batch = {"frames": jnp.asarray(_frames(kw["img_shape"])),
             "actions": jnp.zeros((B, CTX + PRED, 1))}
    counts = {"predict": jax_count_flops(jax_loop.make_predict_fn(model, RUN_CONFIG),
                                         state, batch)}
    if model.TRAINABLE:
        loss = JaxLossProvider({"losses_and_scales": {"mse": 1.0}, "img_c": 3, "device": None})
        step = jax_loop.make_train_step(model, RUN_CONFIG, optimizer, loss, donate=False)
        counts["train"] = jax_count_flops(step, state, batch, jnp.asarray(0.0))
    return counts


def _warp_contraction(mode):
    r"""What the JAX package's CPU warp adds: it contracts dense one-hot
    factor matrices (``pallas_warp.py:440-443``, counted by the JAX counter's
    own walk of its ``warp_sample``, forward and VJP) where the port gathers
    (0): at EF-TrajGRU's three layer shapes (16x16x64, 8x8x96, 4x4x96, L=13),
    six calls each (3 encoder and 3 forecaster steps)."""
    total = 0
    for h, c in ((16, 64), (8, 96), (4, 96)):
        idx = jnp.ones((B, 13, h * h))
        img = jnp.ones((B, h, h, c))
        if mode == "predict":
            total += 6 * jax_count_flops(jax_warp_sample, idx, idx, img)
        else:
            def with_vjp(iy, ix, img):
                out, vjp = jax.vjp(jax_warp_sample, iy, ix, img)
                return vjp(out)
            total += 6 * jax_count_flops(with_vjp, idx, idx, img)
    return total


def _lstm_resizes():
    r"""What the JAX LSTM adds in ``predict``: its decoder's 25x25 output is
    resized to 32x32 by ``jax.image.resize``, which contracts with
    interpolation weights (counted as products); the port resizes without a
    product. Three decoded frames (the context's last and two forecasts:
    ``scale_and_translate`` per frame of b=2)."""
    one = jax_count_flops(lambda x: jax.image.resize(x, (B, 32, 32, 3), "bilinear"),
                          jnp.ones((B, 25, 25, 3)))
    return 3 * one


#: ``(model, mode) -> (the JAX count minus the port's under JAX's convolution
#: convention, the cause)``. A number is what the named part of the JAX model
#: counts beyond the port at these shapes, measured with both counters; a
#: function computes it from the JAX package alone.
DIFFERENCES = {
    ("trajgru", "predict"): (lambda: _warp_contraction("predict"),
                             "the JAX CPU warp's one-hot factor contraction"),
    ("trajgru", "train"): (lambda: _warp_contraction("train") + 77004800,
                           "the JAX CPU warp's one-hot factor contraction and its VJP, plus "
                           "the gradients of the first scan step's initial state (a lax.scan "
                           "body is the same at every step; PyTorch skips gradients of a "
                           "constant)"),
    ("lstm", "predict"): (_lstm_resizes, "jax.image.resize's interpolation products"),
    ("lstm", "train"): (lambda: 3315968, "jax.image.resize's interpolation products and their "
                        "gradients"),
    ("convlstm-shi-fused", "train"): (lambda: 1542979584,
                                      "the JAX counter counts its Pallas scan kernels' bodies "
                                      "times their grids (flops.py:71-72), tiles included; the "
                                      "port counts the hidden convolution (K3s, K4)"),
    ("unet-3d", "train"): (lambda: 6873984,
                           "the JAX UNet-3D merges time into channels, so its Conv3d input "
                           "gradients are convolutions of other shapes than cuDNN's"),
    ("predrnn-pp", "train"): (lambda: 11673600,
                              "a lax.scan body computes the input gradient at the first step "
                              "too, where the input is data; PyTorch's autograd skips it"),
    ("phy", "predict"): (lambda: 34799616,
                         "the port's PhyDNet takes shortcuts past work that reaches no "
                         "prediction (the context encoded in one batch, no decode of the "
                         "context's reconstructions)"),
    ("phy", "train"): (lambda: 12488704, "as in predict, and the first scan step's gradients"),
    ("st-phy", "predict"): (lambda: 513708032,
                            "the JAX ST-Phy decodes every step's frame, the port only the "
                            "predicted ones (the context's reconstructions reach no output of "
                            "predict)"),
    ("st-phy", "train"): (lambda: 4036096, "the first scan step's gradients (ST-Phy's dead "
                          "layers, trap v, are skipped by both counts' products)"),
}


#: ``model -> (what the JAX train step's recompute counts beyond the port's with remat on
#: both sides, the cause)``, beyond the model's entry in :data:`DIFFERENCES`. Elsewhere the
#: two recomputes count the same products.
REMAT_DIFFERENCES = {
    "phy": (39591936, "the JAX step encodes each context frame inside its checkpointed step, "
                      "so its backward encodes them again; the port encodes the context in "
                      "one batch before its steps"),
    "st-phy": (1209200640, "the JAX step decodes each step's frame inside its checkpointed "
                           "step, so its backward decodes them again; the port decodes the "
                           "latents in one batch after its steps"),
}


@pytest.mark.parametrize("name", [n for n in MODELS if n != "copy"])
def test_train_counts_with_remat_match_jax(name):
    r"""Both train steps with ``remat=True``: each count includes its
    backward's recompute, and they differ by the entries of
    :data:`DIFFERENCES` and :data:`REMAT_DIFFERENCES`; the port's recompute
    adds products wherever JAX's does."""
    _, as_jax = _port_counts(name, True)["train"]
    want = _jax_counts(name, True)["train"]
    extra = DIFFERENCES.get((name, "train"), (lambda: 0, "none"))[0]()
    recompute, cause = REMAT_DIFFERENCES.get(name, (0, "none"))
    assert want - as_jax == extra + recompute, f"{name}: {cause}"
    port_rise = as_jax - _port_counts(name)["train"][1]
    jax_rise = want - _jax_counts(name)["train"]
    assert port_rise == jax_rise - recompute and (port_rise > 0) == (jax_rise > 0)


@pytest.mark.parametrize("name", list(MODELS))
def test_counts_match_jax(name):
    port, jax_counts = _port_counts(name), _jax_counts(name)
    assert set(port) == set(jax_counts)
    for mode, want in jax_counts.items():
        plain, as_jax = port[mode]
        extra, cause = DIFFERENCES.get((name, mode), (lambda: 0, "none"))
        assert want - as_jax == extra(), f"{name} {mode}: {cause}"
        assert plain <= as_jax


def test_dilated_convolutions_are_the_only_convention_difference():
    r"""EF-ConvLSTM's forecaster upsamples by transposed convolutions of stride
    2 and its encoder downsamples by strided ones: PyTorch's count is lower
    than JAX's by exactly what the dilation zeros add, and with JAX's
    convention the two agree."""
    port = _port_counts("convlstm-shi")
    jax_counts = _jax_counts("convlstm-shi")
    for mode in ("predict", "train"):
        plain, as_jax = port[mode]
        assert plain < as_jax == jax_counts[mode]
