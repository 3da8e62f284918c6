r"""The Spatio-Temporal LSTM cell of PredRNN-V2 (the JAX package's
``model_blocks/predrnn.py``), on channels-last activations.

Gate convolutions on x (7 ways), h (4) and the spatial memory m (3), a
temporal cell c and the memory m, each with its own gates, an output gate
over both and a 1x1 conv that merges them; ``forget_bias`` 1.0. The plain
cell's convs have no bias; the action-conditional cell's have one, and its
``conv_a`` over the action features modulates the h gates. With
``layer_norm``, each gate conv is followed by ``LayerNorm([c, h, w])``. The
parameters keep the reference's names: ``conv_x.0`` (and ``conv_x.1``, the
LayerNorm), ``conv_h``, ``conv_a``, ``conv_m``, ``conv_o``, ``conv_last``.
"""
import torch
from torch import nn

from vp_suite_tpu_torch.base.base_model_block import VPModelBlock
from vp_suite_tpu_torch.nn.layers import Conv2d, LayerNormCHW


class SpatioTemporalLSTMCell(VPModelBlock):
    NAME = "Spatio-Temporal LSTM Cell"
    PAPER_REFERENCE = "https://arxiv.org/abs/2103.09504"
    FORGET_BIAS = 1.0

    def __init__(self, in_channel, num_hidden, height, width, filter_size, stride,
                 layer_norm, action_conditional=False):
        super().__init__()
        self.num_hidden = num_hidden
        self.action_conditional = action_conditional

        def gates(cin, cout):
            layers = [Conv2d(cin, cout, filter_size, stride, filter_size // 2,
                             bias=action_conditional)]
            if layer_norm:
                layers.append(LayerNormCHW([cout, height, width]))
            return nn.Sequential(*layers)

        self.conv_x = gates(in_channel, 7 * num_hidden)
        self.conv_h = gates(num_hidden, 4 * num_hidden)
        if action_conditional:
            self.conv_a = gates(num_hidden, 4 * num_hidden)
        self.conv_m = gates(num_hidden, 3 * num_hidden)
        self.conv_o = gates(2 * num_hidden, num_hidden)
        self.conv_last = Conv2d(2 * num_hidden, num_hidden, 1, 1, 0, bias=action_conditional)

    def forward(self, x, h, c, m, a=None):
        r"""One step on ``[b, h, w, ch]`` tensors; returns ``(h, c, m, delta_c,
        delta_m)``, the deltas for the decoupling loss."""
        nh, fb = self.num_hidden, self.FORGET_BIAS
        i_x, f_x, g_x, i_xp, f_xp, g_xp, o_x = torch.split(self.conv_x(x), nh, dim=-1)
        h_concat = self.conv_h(h)
        if self.action_conditional:
            h_concat = h_concat * self.conv_a(a)
        i_h, f_h, g_h, o_h = torch.split(h_concat, nh, dim=-1)
        i_m, f_m, g_m = torch.split(self.conv_m(m), nh, dim=-1)

        delta_c = torch.sigmoid(i_x + i_h) * torch.tanh(g_x + g_h)
        c_new = torch.sigmoid(f_x + f_h + fb) * c + delta_c
        delta_m = torch.sigmoid(i_xp + i_m) * torch.tanh(g_xp + g_m)
        m_new = torch.sigmoid(f_xp + f_m + fb) * m + delta_m

        mem = torch.cat([c_new, m_new], dim=-1)
        o_t = torch.sigmoid(o_x + o_h + self.conv_o(mem))
        h_new = o_t * torch.tanh(self.conv_last(mem))
        return h_new, c_new, m_new, delta_c, delta_m
