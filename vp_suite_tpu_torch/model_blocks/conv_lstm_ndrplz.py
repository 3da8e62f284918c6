r"""The ndrplz ConvLSTM cell (the JAX package's
``model_blocks/conv_lstm_ndrplz.py``): one 4-way gate conv over
``concat(x, h)``, gate order (i, f, o, g), no peepholes. Shi's cell, which
K1/K3 compute, is another function (peepholes, another gate order), so this
cell runs on cuDNN's conv and elementwise launches. The multi-layer
sequence wrapper (``ConvLSTMNdrplz``) comes with the models that use it.
"""
import torch

from vp_suite_tpu_torch.base.base_model_block import VPModelBlock
from vp_suite_tpu_torch.nn.layers import Conv2d


def convlstm_ndrplz_gates(gates, c):
    r"""``(h_new, c_new)`` from the gate pre-activations ``[..., 4 * hid]``
    (i, f, o, g) and the cell state ``c`` ``[..., hid]``."""
    hid = c.shape[-1]
    i, f, o = torch.sigmoid(gates[..., :3 * hid]).chunk(3, dim=-1)
    c_new = f * c + i * torch.tanh(gates[..., 3 * hid:])
    return o * torch.tanh(c_new), c_new


class ConvLSTMCellNdrplz(VPModelBlock):
    r"""One step of the ndrplz ConvLSTM cell on ``[b, h, w, c]``; its conv is
    ``conv`` (the reference's name)."""
    NAME = "ConvLSTM Cell (Palazzi, Abati)"
    CODE_REFERENCE = "https://github.com/ndrplz/ConvLSTM_pytorch"
    MATCHES_REFERENCE = "Yes (Code Reference)"

    def __init__(self, input_dim, hidden_dim, kernel_size=(3, 3), bias=True):
        super().__init__()
        kh, kw = kernel_size
        self.conv = Conv2d(input_dim + hidden_dim, 4 * hidden_dim, kernel_size, 1,
                           (kh // 2, kw // 2), bias=bias)

    def forward(self, x, state):
        r"""``x`` ``[b, h, w, in]``, ``state`` ``(h, c)`` each ``[b, h, w,
        hid]`` -> ``(h_new, c_new)``."""
        h, c = state
        return convlstm_ndrplz_gates(self.conv(torch.cat([x, h], dim=-1)), c)
