r"""PhyDNet's building blocks (the JAX package's ``model_blocks/phydnet.py``):
the PhyCell, a PDE-constrained cell whose physical predictor F is a conv ->
GroupNorm -> 1x1 conv and whose correction is a sigmoid gate, and the
kernel-to-moment transform (K2M) of the moment-regularization loss.

The reference keeps a cell's hidden state on the module; here it is passed
in and returned, as the JAX package's step closures do. Modules and
``state_dict`` keys carry the reference's names (``F.conv1``, ``F.bn1``,
``F.conv2``, ``convgate``, ``frame_action_conv``, ``hidden_action_conv``;
a stack's ``cell_list.{j}``).
"""
import math
from collections import OrderedDict

import numpy as np
import torch
from torch import nn

from vp_suite_tpu_torch.base.base_model_block import VPModelBlock
from vp_suite_tpu_torch.nn.layers import Conv2d, GroupNorm


def find_divisor_for_group_norm(x: int):
    r"""The number of GroupNorm groups for ``x`` channels: ``x // d`` for the
    largest divisor ``d`` of ``x`` not above sqrt(x) (7 for 49)."""
    sq = math.floor(math.sqrt(x))
    while True:
        if x // sq == x / sq:
            return x // sq
        sq -= 1


def inflate_action(action, h, w, dtype):
    r"""``action`` ``[b, a]`` broadcast over an ``h x w`` grid, ``[b, h, w, a]``."""
    return action[:, None, None, :].to(dtype).expand(action.shape[0], h, w, action.shape[-1])


class PhyCellCell(VPModelBlock):
    r"""One PhyCell layer: ``forward(frame, action, hidden) -> next hidden``,
    all ``[b, h, w, input_dim]``. With ``action_conditional`` the frame and
    the hidden state first pass through 1x1 convs over their concatenation
    with the action."""
    NAME = "PhyCell Cell"
    PAPER_REFERENCE = "https://arxiv.org/abs/2003.01460"
    CODE_REFERENCE = "https://github.com/vincent-leguen/PhyDNet"

    def __init__(self, input_dim, action_conditional, action_size, hidden_dim, kernel_size,
                 bias=True):
        super().__init__()
        self.action_conditional = action_conditional
        kh, kw = kernel_size
        self.F = nn.Sequential(OrderedDict(
            conv1=Conv2d(input_dim, hidden_dim, kernel_size, 1, (kh // 2, kw // 2)),
            bn1=GroupNorm(find_divisor_for_group_norm(hidden_dim), hidden_dim),
            conv2=Conv2d(hidden_dim, input_dim, 1, 1, 0)))
        self.convgate = Conv2d(2 * input_dim, input_dim, 3, 1, 1, bias=bias)
        if action_conditional:
            self.frame_action_conv = Conv2d(input_dim + action_size, input_dim, 1, 1, 0)
            self.hidden_action_conv = Conv2d(input_dim + action_size, input_dim, 1, 1, 0)

    def forward(self, frame, action, hidden):
        if self.action_conditional:
            a = inflate_action(action, *frame.shape[1:3], frame.dtype)
            frame = self.frame_action_conv(torch.cat([frame, a], dim=-1))
            hidden = self.hidden_action_conv(torch.cat([hidden, a], dim=-1))
        gate = torch.sigmoid(self.convgate(torch.cat([frame, hidden], dim=-1)))
        hidden_tilde = hidden + self.F(hidden)                    # prediction
        return hidden_tilde + gate * (frame - hidden_tilde)       # correction


class PhyCell(VPModelBlock):
    r"""A stack of :class:`PhyCellCell` layers (``cell_list``), each fed the
    hidden state the layer below it just computed."""
    NAME = "PhyCell"
    PAPER_REFERENCE = "https://arxiv.org/abs/2003.01460"

    def __init__(self, input_dim, action_conditional, action_size, hidden_dim, n_layers,
                 kernel_size):
        super().__init__()
        self.cell_list = nn.ModuleList([
            PhyCellCell(input_dim, action_conditional, action_size, hidden_dim, kernel_size)
            for _ in range(n_layers)])

    def forward(self, x, action, hiddens):
        r"""``x`` and each of ``hiddens`` ``[b, h, w, input_dim]`` -> the new
        hidden states, a list."""
        new = []
        for cell, hidden in zip(self.cell_list, hiddens):
            new.append(cell(new[-1] if new else x, action, hidden))
        return new


def k2m_matrices(shape, device=None):
    r"""The moment matrices of each kernel axis: row ``i`` of the ``l x l``
    matrix is ``(arange(l) - (l - 1) // 2) ** i / i!``, in f64 rounded to f32."""
    mats = []
    for l in shape:
        m = np.zeros((l, l))
        for i in range(l):
            m[i] = ((np.arange(l) - (l - 1) // 2) ** i) / math.factorial(i)
        mats.append(torch.tensor(m, dtype=torch.float32, device=device))
    return mats


def k2m(kernels, mats):
    r"""The moments ``[n, kh, kw]`` of the 2-D kernels ``[n, kh, kw]``:
    ``out[n, i, j] = sum_{p, q} M0[i, p] M1[j, q] k[n, p, q]``."""
    return torch.einsum("ip,jq,...pq->...ij", mats[0], mats[1], kernels)


def moment_constraints(channels, kernel_size, device=None):
    r"""``[channels, kh, kw]``: channel ``n`` (of the first ``kh * kw``)
    targets the moment ``(n // kw, n % kw)``."""
    kh, kw = kernel_size
    con = np.zeros((channels, kh, kw), dtype=np.float32)
    for n in range(min(channels, kh * kw)):
        con[n, n // kw, n % kw] = 1.0
    return torch.tensor(con, device=device)


def moment_loss(weight, constraints, mats):
    r"""The moment-regularization loss of the PhyCell's first F conv: for
    each input channel, the mean squared difference of its filters' moments
    (``weight`` ``[hidden, in, kh, kw]``, torch's layout) from
    ``constraints`` ``[hidden, kh, kw]``, summed over the input channels. It
    reads the parameter itself, so it is f32 under bf16 activations too."""
    moments = k2m(weight.permute(1, 0, 2, 3), mats)   # [in, hidden, kh, kw]
    return (moments - constraints).square().mean(dim=(1, 2, 3)).sum()
