r"""NHWC convolution and normalization helpers with torch ``Conv2d`` /
``ConvTranspose2d`` / ``Conv3d`` / ``LayerNorm`` semantics.

Activations stay channels-last (``[n, h, w, c]`` or ``[n, d, h, w, c]``,
contiguous) across the port, which is the layout the kernels take.
``x.permute(0, 3, 1, 2)`` of such a tensor is an NCHW view in ``channels_last``
memory format, so cuDNN runs its NHWC kernels and the result permutes back
without a copy (``channels_last_3d`` likewise for 3-D convs). Weights keep
torch's layouts (conv ``[out, in, kh, kw]``, convT ``[in, out, kh, kw]``,
conv3d ``[out, in, kt, kh, kw]``) and are cast to the activation dtype at
use, so f32 params serve bf16 activations (so are the norms' affine
parameters).

Given a tp-sharded weight (this process's shard of the out-channels, as
``parallel.tensor.local_param`` hands it out), the convolutions and
``linear`` compute column-parallel: this process's out-channels only,
gathered over ``tp`` (``conv2d`` with ``gather_output=False`` leaves them
local).
"""
import functools

import torch
import torch.nn.functional as F

from vp_suite_tpu_torch.parallel.tensor import column_parallel, tp_spec


def _ntuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


def _pad_channels_first(x, padding, padding_mode):
    r"""``x`` (an NC... view) padded by ``padding`` per spatial dim in
    ``padding_mode`` (``"zeros"``: returns ``x`` and the conv's own padding)."""
    if padding_mode == "zeros" or not any(padding):
        return x, padding
    if padding_mode != "replicate":
        raise ValueError(f"unknown padding mode: {padding_mode}")
    pads = [p for pp in reversed(padding) for p in (pp, pp)]
    fmt = torch.channels_last if x.dim() == 4 else torch.channels_last_3d
    return F.pad(x, pads, mode="replicate").contiguous(memory_format=fmt), (0,) * len(padding)


def _cast(t, x):
    return None if t is None else t.to(x.dtype)


def _conv2d(x, weight, bias, stride, padding, padding_mode):
    xc, padding = _pad_channels_first(x.permute(0, 3, 1, 2), _ntuple(padding, 2), padding_mode)
    y = F.conv2d(xc, weight.to(x.dtype), _cast(bias, x), stride, padding)
    return y.permute(0, 2, 3, 1).contiguous()


def conv2d(x, weight, bias=None, stride=1, padding=0, padding_mode="zeros",
           gather_output=True):
    r"""NHWC conv: ``x`` ``[n, h, w, in]``, ``weight`` ``[out, in, kh, kw]``;
    ``padding_mode`` is ``"zeros"`` or ``"replicate"``."""
    if tp_spec(weight) is not None:
        return column_parallel(functools.partial(_conv2d, stride=stride, padding=padding,
                                                 padding_mode=padding_mode),
                               x, weight, bias, gather_output)
    return _conv2d(x, weight, bias, stride, padding, padding_mode)


def _conv_transpose2d(x, weight, bias, stride, padding, output_padding):
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), _cast(bias, x), stride,
                           padding, output_padding)
    return y.permute(0, 2, 3, 1).contiguous()


def conv_transpose2d(x, weight, bias=None, stride=1, padding=0, output_padding=0):
    r"""NHWC transposed conv: ``x`` ``[n, h, w, in]``, ``weight`` ``[in, out, kh, kw]``."""
    if tp_spec(weight) is not None:
        return column_parallel(functools.partial(_conv_transpose2d, stride=stride,
                                                 padding=padding, output_padding=output_padding),
                               x, weight, bias)
    return _conv_transpose2d(x, weight, bias, stride, padding, output_padding)


def _conv3d(x, weight, bias, stride, padding, padding_mode):
    stride, padding = _ntuple(stride, 3), _ntuple(padding, 3)
    xc, padding = _pad_channels_first(x.permute(0, 4, 1, 2, 3), padding, padding_mode)
    y = F.conv3d(xc, weight.to(x.dtype), _cast(bias, x), stride, padding)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def conv3d(x, weight, bias=None, stride=1, padding=0, padding_mode="zeros"):
    r"""NDHWC conv: ``x`` ``[n, d, h, w, in]``, ``weight`` ``[out, in, kt, kh,
    kw]``; ``padding_mode`` is ``"zeros"`` or ``"replicate"``. ``F.conv3d`` on
    a ``channels_last_3d`` view; the JAX package lowers UNet-3D's 3-D convs to
    one 2-D conv over time-in-channels instead, the same function
    (``kernels/unet3d_variants.py`` times the two on the card)."""
    if tp_spec(weight) is not None:
        return column_parallel(functools.partial(_conv3d, stride=stride, padding=padding,
                                                 padding_mode=padding_mode), x, weight, bias)
    return _conv3d(x, weight, bias, stride, padding, padding_mode)


def linear(x, weight, bias=None):
    r"""``F.linear`` in ``x``'s dtype (``weight`` ``[out, in]``)."""
    if tp_spec(weight) is not None:
        return column_parallel(_linear, x, weight, bias)
    return _linear(x, weight, bias)


def _linear(x, weight, bias):
    return F.linear(x, weight.to(x.dtype), _cast(bias, x))


def layer_norm_chw(x, weight, bias, eps=1e-5):
    r"""torch's ``LayerNorm([c, h, w])`` on NHWC ``x``: each sample normalized
    over all of ``(h, w, c)``; ``weight`` and ``bias`` in torch's ``[c, h, w]``
    layout, cast to the activation dtype as the JAX package casts them."""
    return F.layer_norm(x, x.shape[-3:], weight.permute(1, 2, 0).to(x.dtype),
                        bias.permute(1, 2, 0).to(x.dtype), eps)


def group_norm(x, weight, bias, num_groups, eps=1e-5):
    r"""torch's ``GroupNorm`` on channels-last ``x`` ``[n, ..., c]``: each
    sample normalized over each group of ``c / num_groups`` channels and all
    positions, by the biased variance; ``weight`` and ``bias`` ``[c]``."""
    perm = (0, x.dim() - 1, *range(1, x.dim() - 1))
    y = F.group_norm(x.permute(perm), num_groups, weight.to(x.dtype), bias.to(x.dtype), eps)
    return y.permute(0, *range(2, x.dim()), 1).contiguous()


def dcgan_step(x, weight, bias, gn_weight, gn_bias, stride, transposed=False):
    r"""DCGAN's 3x3 conv (padding 1) -> ``GroupNorm(16)`` -> ``LeakyReLU(0.2)``
    on ``[n, h, w, c]``; ``transposed`` takes a transposed conv (``weight``
    ``[in, out, 3, 3]``, output padding 1 at stride 2, so that it doubles the
    size)."""
    if transposed:
        y = conv_transpose2d(x, weight, bias, stride, 1, int(stride == 2))
    else:
        y = conv2d(x, weight, bias, stride, 1)
    return F.leaky_relu(group_norm(y, gn_weight, gn_bias, 16), 0.2)
