r"""The LPIPS network (AlexNet backbone and linear calibration heads), the
JAX package's ``LPIPSNet``:

1. input in [0, 1] -> [-1, 1] -> per-channel shift and scale;
2. AlexNet's conv stack, features taken after each of its 5 ReLUs;
3. each feature map normalised to unit length over its channels;
4. squared differences, weighted per channel by the 'linear' heads,
   averaged over the image;
5. summed over the layers.

Parameters: a converted checkpoint at the port's
``resources/lpips_alexnet.npz`` (HWIO kernels, the JAX package's layout),
where one is present; otherwise deterministic random ones, drawn with the
JAX package's ``numpy.random.default_rng(0)`` calls in the same order, so
both packages hold the same numbers (``pretrained`` is then False). Nothing
is downloaded.
"""
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from vp_suite_tpu_torch.base.base_measure import full_precision, placed
from vp_suite_tpu_torch.utils.jax_params import lpips_params_from_jax

_ALEX_CFG = [
    # (out_c, kernel, stride, pad, maxpool_before)
    (64, 11, 4, 2, False),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, True),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, False),
]

_SHIFT = np.array([-0.030, -0.088, -0.188], dtype=np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], dtype=np.float32)

_WEIGHTS_FP = Path(__file__).parent.parent / "resources" / "lpips_alexnet.npz"


def _random_params(seed=0):
    r"""Deterministic random AlexNet kernels (HWIO) and uniform linear heads;
    returns ``(params, pretrained=False)``."""
    rng = np.random.default_rng(seed)
    params = {}
    in_c = 3
    for i, (out_c, k, s, p, _) in enumerate(_ALEX_CFG):
        fan_in = in_c * k * k
        std = float(np.sqrt(2.0 / fan_in))
        params[f"conv{i}_kernel"] = rng.standard_normal((k, k, in_c, out_c)).astype(np.float32) * std
        params[f"conv{i}_bias"] = np.zeros((out_c,), dtype=np.float32)
        params[f"lin{i}"] = np.full((out_c,), 1.0 / out_c, dtype=np.float32)
        in_c = out_c
    return params, False


def _load_params():
    if _WEIGHTS_FP.exists():
        data = np.load(_WEIGHTS_FP)
        return {k: data[k] for k in data.files}, True
    return _random_params()


_CACHE = {}


class LPIPSNet:
    r"""LPIPS distance of ``[n, h, w, 3]`` images in [0, 1], computed in the
    images' dtype on their device (the parameters are copied there once per
    device and dtype)."""

    def __init__(self):
        if "params" not in _CACHE:
            params, pretrained = _load_params()
            _CACHE["params"] = lpips_params_from_jax(params)
            _CACHE["pretrained"] = pretrained
        self.params = _CACHE["params"]      #: CPU f32 tensors, conv kernels OIHW
        self.pretrained = _CACHE["pretrained"]
        self._placed = {}

    def features(self, x):
        r"""``x`` ``[n, h, w, 3]`` in [0, 1] -> the 5 feature maps ``[n, c, h', w']``."""
        p = placed(self.params, self._placed, x)
        x = 2.0 * x - 1.0
        x = (x - torch.as_tensor(_SHIFT, dtype=x.dtype, device=x.device)) \
            / torch.as_tensor(_SCALE, dtype=x.dtype, device=x.device)
        x = x.permute(0, 3, 1, 2)
        feats = []
        with full_precision():
            for i, (_, _, s, pad, pool_before) in enumerate(_ALEX_CFG):
                if pool_before:
                    x = F.max_pool2d(x, 3, 2)
                x = F.conv2d(x, p[f"conv{i}_kernel"], stride=s, padding=pad)
                x = F.relu(x + p[f"conv{i}_bias"][:, None, None])
                feats.append(x)
        return feats

    def per_image(self, pred, target):
        r"""Per-image LPIPS distances ``[n]``."""
        p = placed(self.params, self._placed, pred)
        total = 0.0
        for i, (a, b) in enumerate(zip(self.features(pred), self.features(target))):
            na = a * torch.rsqrt((a * a).sum(dim=1, keepdim=True) + 1e-10)
            nb = b * torch.rsqrt((b * b).sum(dim=1, keepdim=True) + 1e-10)
            d = (na - nb) ** 2
            lin = p[f"lin{i}"].clamp_min(0.0)[:, None, None]
            total = total + (d * lin).sum(dim=1).mean(dim=(1, 2))
        return total

    def __call__(self, pred, target):
        return self.per_image(pred, target).mean()
