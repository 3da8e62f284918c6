r"""The InceptionI3d feature extractor of the FVD measure, the JAX package's
``i3d_features``: Inception-v1 inflated to 3-D, TF-'SAME' padding,
BatchNorm (eps 1e-3) in inference mode, and the 400 logits of the
classification head, averaged over time, as features.

TF-'SAME' pads ``max((ceil(n / s) - 1) * s + k - n, 0)`` in all, the smaller
half before: asymmetric where that sum is odd (``Conv3d_1a_7x7`` on 224 pads
2 before and 3 after), which ``padding=`` of PyTorch's convolutions cannot
express. So the input is padded explicitly: zeros before a convolution,
``-inf`` before a max-pool.

Parameters: a converted checkpoint at the port's
``resources/i3d_rgb_imagenet.npz`` (DHWIO kernels, the JAX package's layout)
where one is present and the input has 3 channels; otherwise deterministic
random ones, drawn with the JAX package's ``numpy.random.default_rng(0)``
calls in the same order, so both packages hold the same numbers. Nothing is
downloaded.
"""
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from vp_suite_tpu_torch.base.base_measure import full_precision
from vp_suite_tpu_torch.utils.jax_params import i3d_params_from_jax

# (name, kind, cfg): conv = (out_c, kernel(t,h,w), stride); pool = (kernel, stride)
# inception cfg = [b0, b1a, b1b, b2a, b2b, b3b] output channels
_I3D_LAYERS = [
    ("Conv3d_1a_7x7", "conv", (64, (7, 7, 7), (2, 2, 2))),
    ("MaxPool3d_2a_3x3", "pool", ((1, 3, 3), (1, 2, 2))),
    ("Conv3d_2b_1x1", "conv", (64, (1, 1, 1), (1, 1, 1))),
    ("Conv3d_2c_3x3", "conv", (192, (3, 3, 3), (1, 1, 1))),
    ("MaxPool3d_3a_3x3", "pool", ((1, 3, 3), (1, 2, 2))),
    ("Mixed_3b", "mixed", [64, 96, 128, 16, 32, 32]),
    ("Mixed_3c", "mixed", [128, 128, 192, 32, 96, 64]),
    ("MaxPool3d_4a_3x3", "pool", ((3, 3, 3), (2, 2, 2))),
    ("Mixed_4b", "mixed", [192, 96, 208, 16, 48, 64]),
    ("Mixed_4c", "mixed", [160, 112, 224, 24, 64, 64]),
    ("Mixed_4d", "mixed", [128, 128, 256, 24, 64, 64]),
    ("Mixed_4e", "mixed", [112, 144, 288, 32, 64, 64]),
    ("Mixed_4f", "mixed", [256, 160, 320, 32, 128, 128]),
    ("MaxPool3d_5a_2x2", "pool", ((2, 2, 2), (2, 2, 2))),
    ("Mixed_5b", "mixed", [256, 160, 320, 32, 128, 128]),
    ("Mixed_5c", "mixed", [384, 192, 384, 48, 128, 128]),
]

_WEIGHTS_FP = Path(__file__).parent.parent.parent / "resources" / "i3d_rgb_imagenet.npz"


def same_pads(n, k, s):
    r"""TF-'SAME' padding ``(before, after)`` of an axis of size ``n`` for a
    window ``k`` at stride ``s``."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x, kernel, stride, value):
    r"""Pads ``x`` ``[b, c, t, h, w]`` as TF-'SAME' would before a window of
    ``kernel`` (t, h, w) at ``stride``."""
    pads = []
    for n, k, s in reversed(list(zip(x.shape[2:], kernel, stride))):
        pads += same_pads(n, k, s)   # F.pad lists the last axis first
    return F.pad(x, pads, value=value) if any(pads) else x


def _conv_same(x, kernel, stride):
    return F.conv3d(_pad_same(x, kernel.shape[2:], stride, 0.0), kernel, stride=stride)


def _bn_eval(x, p, prefix, eps=1e-3):
    def vec(name):
        return p[f"{prefix}_bn_{name}"][:, None, None, None]
    return (x - vec("mean")) * torch.rsqrt(vec("var") + eps) * vec("scale") + vec("bias")


def _unit3d(x, p, prefix, stride=(1, 1, 1)):
    x = _conv_same(x, p[f"{prefix}_kernel"], stride)
    if f"{prefix}_bias" in p:
        x = x + p[f"{prefix}_bias"][:, None, None, None]
    return F.relu(_bn_eval(x, p, prefix))


def _maxpool_same(x, kernel, stride):
    return F.max_pool3d(_pad_same(x, kernel, stride, float("-inf")), kernel, stride)


def _mixed(x, p, name):
    b0 = _unit3d(x, p, f"{name}_b0")
    b1 = _unit3d(_unit3d(x, p, f"{name}_b1a"), p, f"{name}_b1b")
    b2 = _unit3d(_unit3d(x, p, f"{name}_b2a"), p, f"{name}_b2b")
    b3 = _unit3d(_maxpool_same(x, (3, 3, 3), (1, 1, 1)), p, f"{name}_b3b")
    return torch.cat([b0, b1, b2, b3], dim=1)


def i3d_features(x, params):
    r"""I3D logits features.

    Args:
        x: ``[b, t, h, w, c]`` video, t in [9, 16], 224x224.
        params: the port's parameter dict (:func:`load_params`), on ``x``'s
            device and in its dtype.

    Returns: ``[b, num_classes]``, the logits averaged over time.
    """
    p = params
    x = x.permute(0, 4, 1, 2, 3)
    with full_precision():
        for name, kind, cfg in _I3D_LAYERS:
            if kind == "conv":
                x = _unit3d(x, p, name, cfg[2])
            elif kind == "pool":
                x = _maxpool_same(x, *cfg)
            else:
                x = _mixed(x, p, name)
        # average pool (2, 7, 7) at stride 1, VALID; the 1x1x1 logits conv
        x = F.avg_pool3d(x, (2, 7, 7), stride=1)
        x = _conv_same(x, p["logits_kernel"], (1, 1, 1)) + p["logits_bias"][:, None, None, None]
    x = x.mean(dim=(3, 4))      # [b, classes, t']
    return x.squeeze(2) if x.shape[2] == 1 else x.mean(dim=2)


def _unit_param_shapes(name, in_c, out_c, kernel, bn=True, bias=False):
    shapes = {f"{name}_kernel": (*kernel, in_c, out_c)}
    if bias:
        shapes[f"{name}_bias"] = (out_c,)
    if bn:
        shapes[f"{name}_bn_mean"] = (out_c,)
        shapes[f"{name}_bn_var"] = (out_c,)
        shapes[f"{name}_bn_scale"] = (out_c,)
        shapes[f"{name}_bn_bias"] = (out_c,)
    return shapes


def param_shapes(in_channels=3, num_classes=400):
    r"""The shapes of all of the network's parameters, kernels in the JAX
    package's DHWIO layout, in the order the random parameters are drawn."""
    shapes = {}
    c = in_channels
    for name, kind, cfg in _I3D_LAYERS:
        if kind == "conv":
            out_c, kernel, _ = cfg
            shapes.update(_unit_param_shapes(name, c, out_c, kernel))
            c = out_c
        elif kind == "mixed":
            b = cfg
            shapes.update(_unit_param_shapes(f"{name}_b0", c, b[0], (1, 1, 1)))
            shapes.update(_unit_param_shapes(f"{name}_b1a", c, b[1], (1, 1, 1)))
            shapes.update(_unit_param_shapes(f"{name}_b1b", b[1], b[2], (3, 3, 3)))
            shapes.update(_unit_param_shapes(f"{name}_b2a", c, b[3], (1, 1, 1)))
            shapes.update(_unit_param_shapes(f"{name}_b2b", b[3], b[4], (3, 3, 3)))
            shapes.update(_unit_param_shapes(f"{name}_b3b", c, b[5], (1, 1, 1)))
            c = b[0] + b[2] + b[4] + b[5]
    shapes["logits_kernel"] = (1, 1, 1, c, num_classes)
    shapes["logits_bias"] = (num_classes,)
    return shapes


def random_params(seed=0, in_channels=3, num_classes=400):
    r"""Deterministic random parameters (numpy, DHWIO kernels): He-normal
    kernels, unit BatchNorm variances and scales, zero means and biases."""
    rng = np.random.default_rng(seed)
    params = {}
    for name, shape in param_shapes(in_channels, num_classes).items():
        if name.endswith("_bn_var") or name.endswith("_bn_scale"):
            params[name] = np.ones(shape, dtype=np.float32)
        elif name.endswith("_bn_mean") or name.endswith("_bn_bias") or name.endswith("_bias"):
            params[name] = np.zeros(shape, dtype=np.float32)
        else:
            fan_in = int(np.prod(shape[:-1]))
            params[name] = (rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
    return params


_CACHE = {}


def load_params(in_channels=3):
    r"""``(params, pretrained)``: the port's parameter dict (f32 CPU tensors,
    kernels OIDHW) from the converted checkpoint where one is present (3
    channels only), else from :func:`random_params`."""
    if in_channels not in _CACHE:
        if _WEIGHTS_FP.exists() and in_channels == 3:
            data = np.load(_WEIGHTS_FP)
            params, pretrained = {k: data[k] for k in data.files}, True
        else:
            params, pretrained = random_params(in_channels=in_channels), False
        _CACHE[in_channels] = (i3d_params_from_jax(params), pretrained)
    return _CACHE[in_channels]
