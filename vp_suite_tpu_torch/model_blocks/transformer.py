r"""flax's ``nn.LayerNorm``, ``nn.Dense`` and ``nn.MultiHeadDotProductAttention``
as the JAX package's PredFormer uses them, on tensors of any leading shape.

They follow flax's definitions, not torch's defaults:

- **LayerNorm**: epsilon 1e-6 (torch's is 1e-5); the mean and the variance
  (``E[x^2] - E[x]^2``, at least 0) in f32 also for bf16 input, the
  normalization and the affine parameters in f32, one rounding to the
  input's dtype at the end.
- **Dense**: flax's init, lecun-normal weights (a normal of std
  ``sqrt(1 / fan_in) / 0.8796``, truncated at two of them) and zero biases,
  in torch's ``[out, in]`` layout; computed in its input's dtype.
- **Attention**: separate ``query``, ``key``, ``value`` and ``out``
  projections with biases (flax's ``DenseGeneral`` kernels ``[d, heads,
  head_dim]`` and ``[heads, head_dim, d]`` held as ``[heads * head_dim, d]``
  and ``[d, heads * head_dim]``); the query is divided by
  ``sqrt(head_dim)`` BEFORE the product, and the softmax runs in the input's
  dtype (bf16 under bf16). It is composed of matmuls and ``softmax`` (cuBLAS
  on the card), not ``F.scaled_dot_product_attention``, whose backends scale
  after the product.
"""
import math

import torch
from torch import nn

from vp_suite_tpu_torch.nn.layers import Dense

#: flax's ``lecun_normal``: the std of a standard normal truncated at +-2
TRUNCATED_STD = 0.87962566103423978


class LayerNorm(nn.Module):
    r"""flax's ``nn.LayerNorm`` over the last axis (``weight`` is flax's
    ``scale``), returned in the input's dtype."""

    def __init__(self, dim, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(-1, keepdim=True)
        var = (xf.square().mean(-1, keepdim=True) - mean.square()).clamp_min(0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(x.dtype)


class LecunDense(Dense):
    r"""``Dense`` with flax's default init: lecun-normal weight, zero bias."""

    def reset_parameters(self, generator=None):
        std = math.sqrt(1.0 / self.in_features) / TRUNCATED_STD
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            self.bias.zero_()


class MultiHeadDotProductAttention(nn.Module):
    r"""flax's ``nn.MultiHeadDotProductAttention`` as self-attention over the
    second-to-last axis of ``[batch, length, dim]``."""

    def __init__(self, dim, heads):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} must be divisible by the number of heads ({heads})")
        self.heads = heads
        self.query = LecunDense(dim, dim)
        self.key = LecunDense(dim, dim)
        self.value = LecunDense(dim, dim)
        self.out = LecunDense(dim, dim)

    def forward(self, x):
        b, n, d = x.shape
        h, hd = self.heads, d // self.heads
        q, k, v = (proj(x).view(b, n, h, hd).transpose(1, 2)      # [b, h, n, hd]
                   for proj in (self.query, self.key, self.value))
        weights = torch.softmax(torch.matmul(q / math.sqrt(hd), k.transpose(-2, -1)), dim=-1)
        y = torch.matmul(weights, v)
        return self.out(y.transpose(1, 2).reshape(b, n, d))
