r"""Layers over channels-last activations, holding torch-layout parameters.

``Conv2d``, ``ConvTranspose2d``, ``Conv3d``, ``Dense`` (``nn.Linear``),
``GroupNorm`` and ``LayerNormCHW`` (``nn.LayerNorm([c, h, w])``) are torch's own modules (same
parameters, ``state_dict`` keys and default init) with a channels-last
``forward``; ``BatchNorm`` is flax's ``nn.BatchNorm`` under torch's
``BatchNorm2d/3d`` names.
``reset_parameters`` takes an optional ``torch.Generator``, so a model's init
is a function of its seed alone: torch's default, kaiming-uniform with
a=sqrt(5), which is U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias,
with torch's fan_in (``weight.shape[1] * kh * kw`` for both conv kinds,
``in * kt * kh * kw`` in 3-D, ``in`` for ``Dense``); norms start at scale 1,
bias 0 (and running mean 0, running variance 1).
"""
import math

import torch
import torch.nn.functional as F
from torch import nn

from vp_suite_tpu_torch.nn.functional import (conv2d, conv3d, conv_transpose2d,
                                                         group_norm, layer_norm_chw)


def torch_default_init_(weight, bias=None, generator=None):
    r"""torch's default conv init, drawn from ``generator``."""
    fan_in = weight.shape[1] * weight[0][0].numel()
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    with torch.no_grad():
        weight.uniform_(-bound, bound, generator=generator)
        if bias is not None:
            bias.uniform_(-bound, bound, generator=generator)


class Conv2d(nn.Conv2d):
    r"""``nn.Conv2d`` on ``[n, h, w, c]`` input."""

    def reset_parameters(self, generator=None):
        torch_default_init_(self.weight, self.bias, generator)

    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self.stride, self.padding, self.padding_mode)


class ConvTranspose2d(nn.ConvTranspose2d):
    r"""``nn.ConvTranspose2d`` on ``[n, h, w, c]`` input."""

    def reset_parameters(self, generator=None):
        torch_default_init_(self.weight, self.bias, generator)

    def forward(self, x):
        return conv_transpose2d(x, self.weight, self.bias, self.stride, self.padding,
                                self.output_padding)


class Conv3d(nn.Conv3d):
    r"""``nn.Conv3d`` on ``[n, d, h, w, c]`` input."""

    def reset_parameters(self, generator=None):
        torch_default_init_(self.weight, self.bias, generator)

    def forward(self, x):
        return conv3d(x, self.weight, self.bias, self.stride, self.padding, self.padding_mode)


class Dense(nn.Linear):
    r"""``nn.Linear``, run in its input's dtype."""

    def reset_parameters(self, generator=None):
        torch_default_init_(self.weight, self.bias, generator)

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype))


class LayerNormCHW(nn.LayerNorm):
    r"""``nn.LayerNorm([c, h, w])`` (parameters ``[c, h, w]``) on ``[n, h, w, c]`` input."""

    def reset_parameters(self, generator=None):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return layer_norm_chw(x, self.weight, self.bias, self.eps)


class GroupNorm(nn.GroupNorm):
    r"""``nn.GroupNorm`` on ``[n, ..., c]`` input."""

    def reset_parameters(self, generator=None):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps)


class BatchNorm(nn.Module):
    r"""flax's ``nn.BatchNorm`` over the last axis of channels-last input
    (the JAX package's), under torch's ``BatchNorm2d/3d`` names (``weight``,
    ``bias``, ``running_mean``, ``running_var``, ``num_batches_tracked``), so
    reference checkpoints load.

    ``forward(x, train)``: with ``train`` the batch's own statistics over
    every axis but the last, in f32 (f64 for f64 input) and as flax computes
    them (the variance as ``E[x^2] - E[x]^2``, at least 0), and the running
    ones updated as
    ``r = momentum * r + (1 - momentum) * batch`` with the BIASED batch
    variance (flax's momentum 0.9 is torch's 0.1; torch would update with the
    unbiased one); without it the running statistics. ``module.training``
    plays no part. The output is f32 for bf16 or f32 input (flax promotes to
    its f32 statistics and parameters), so a bf16 model runs what follows a
    BatchNorm in f32, as the JAX package does. ``num_batches_tracked`` is
    kept for the names only: the momentum is fixed, and it stays 0."""

    def __init__(self, num_features, momentum=0.9, eps=1e-5):
        super().__init__()
        self.num_features, self.momentum, self.eps = num_features, momentum, eps
        self.weight = nn.Parameter(torch.empty(num_features))
        self.bias = nn.Parameter(torch.empty(num_features))
        self.register_buffer("running_mean", torch.empty(num_features))
        self.register_buffer("running_var", torch.empty(num_features))
        self.register_buffer("num_batches_tracked", torch.empty((), dtype=torch.long))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)
            self.num_batches_tracked.zero_()

    def forward(self, x, train: bool = False):
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        if train:
            dims = tuple(range(x.dim() - 1))
            mean = x.mean(dim=dims)
            var = (x.square().mean(dim=dims) - mean.square()).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1.0 - m)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


def max_pool_2d(x, window=2, strides=None, padding=0):
    r"""Max pooling over ``(h, w)`` of ``[..., h, w, c]``; ``strides``
    defaults to ``window``; ``padding`` pads with -inf (sizes are floored)."""
    *lead, h, w, c = x.shape
    y = F.max_pool2d(x.reshape(-1, h, w, c).permute(0, 3, 1, 2), window, strides, padding)
    return y.permute(0, 2, 3, 1).reshape(*lead, *y.shape[2:], c)
