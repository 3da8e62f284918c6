r"""Conv layers over NHWC activations, holding torch-layout parameters.

``Conv2d`` and ``ConvTranspose2d`` are torch's own modules (same parameters,
``state_dict`` keys and default init) with an NHWC ``forward``.
``reset_parameters`` takes an optional ``torch.Generator``, so a model's init
is a function of its seed alone: torch's default, kaiming-uniform with
a=sqrt(5), which is U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias,
with torch's fan_in (``weight.shape[1] * kh * kw`` for both layer kinds).
"""
import math

import torch
from torch import nn

from vp_suite_tpu_torch.model_blocks._functional import conv2d, conv_transpose2d


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
        return conv2d(x, self.weight, self.bias, self.stride, self.padding)


class ConvTranspose2d(nn.ConvTranspose2d):
    r"""``nn.ConvTranspose2d`` on ``[n, h, w, c]`` input."""

    def reset_parameters(self, generator=None):
        torch_default_init_(self.weight, self.bias, generator)

    def forward(self, x):
        return conv_transpose2d(x, self.weight, self.bias, self.stride, self.padding,
                                self.output_padding)
