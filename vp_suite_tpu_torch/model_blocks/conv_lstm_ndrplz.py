r"""The ndrplz ConvLSTM cell (the JAX package's
``model_blocks/conv_lstm_ndrplz.py``): one 4-way gate conv over
``concat(x, h)``, gate order (i, f, o, g), no peepholes. Shi's cell, which
K1/K3 compute, is another function (peepholes, another gate order), so this
cell runs on cuDNN's conv and elementwise launches.

The cell's gate pre-activations are named ``"convlstm_gates"``
(``nn.remat.named``), as in PhyDNet's JAX step, so that a step checkpointed
with that name keeps them.

``ConvLSTMNdrplz`` stacks such cells over a sequence, layer by layer: each
layer runs the whole sequence that the layer below it produced, with the
input half of its gate conv (the weight's first ``in`` input channels) run
once over all steps, and only the hidden half inside the time loop. Its
``remat`` (default True, the JAX block's) checkpoints each step under
training, whole (``conv_lstm_ndrplz.py:125-126``).
"""
import torch
from torch import nn

from vp_suite_tpu_torch.base.base_model_block import VPModelBlock
from vp_suite_tpu_torch.nn import remat
from vp_suite_tpu_torch.nn.functional import conv2d
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
        gates = remat.named("convlstm_gates", self.conv, torch.cat([x, h], dim=-1))
        return convlstm_ndrplz_gates(gates, c)


class ConvLSTMNdrplz(VPModelBlock):
    r"""Multi-layer ndrplz ConvLSTM over a sequence: ``hidden_dim`` and
    ``kernel_size`` are one value for every layer or a list of
    ``num_layers``; the cells are ``cell_list.{i}``."""
    NAME = "ConvLSTM (Palazzi, Abati)"
    CODE_REFERENCE = "https://github.com/ndrplz/ConvLSTM_pytorch"
    MATCHES_REFERENCE = "Yes (Code Reference)"

    def __init__(self, input_dim, hidden_dim, kernel_size, num_layers, batch_first=False,
                 bias=True, return_all_layers=False, remat=True):
        super().__init__()
        self.remat = remat
        hidden_dims = [hidden_dim] * num_layers if isinstance(hidden_dim, int) \
            else list(hidden_dim)
        kernel_sizes = [kernel_size] * num_layers if isinstance(kernel_size[0], int) \
            else list(kernel_size)
        if not len(kernel_sizes) == len(hidden_dims) == num_layers:
            raise ValueError("Inconsistent list length.")
        self.batch_first, self.return_all_layers = batch_first, return_all_layers
        in_dims = [input_dim] + hidden_dims[:-1]
        self.cell_list = nn.ModuleList([ConvLSTMCellNdrplz(i, h, tuple(k), bias)
                                        for i, h, k in zip(in_dims, hidden_dims, kernel_sizes)])

    def forward(self, input_tensor, hidden_state=None):
        r"""``input_tensor`` ``[t, b, h, w, c]`` (``[b, t, h, w, c]`` with
        ``batch_first``) -> ``(layer_outputs, last_states)``: each layer's
        output sequence ``[b, t, h, w, hid]`` and its last ``(h, c)``, of the
        last layer only unless ``return_all_layers``."""
        if not self.batch_first:
            input_tensor = input_tensor.transpose(0, 1)
        if hidden_state is not None:
            raise NotImplementedError("stateful ConvLSTM not supported (parity with reference)")
        b, t = input_tensor.shape[:2]
        cur = input_tensor
        layer_outputs, last_states = [], []
        for cell in self.cell_list:
            conv, in_dim = cell.conv, cur.shape[-1]
            i2h = conv2d(cur.flatten(0, 1), conv.weight[:, :in_dim], conv.bias, 1,
                         conv.padding).unflatten(0, (b, t))
            h_weight = conv.weight[:, in_dim:]
            h = c = cur.new_zeros((b, *cur.shape[2:4], h_weight.shape[1]))
            outs = []

            def step(h, c, x, h_weight=h_weight, padding=conv.padding):
                return convlstm_ndrplz_gates(x + conv2d(h, h_weight, None, 1, padding), c)

            for s in range(t):
                h, c = remat.checkpoint(step, h, c, i2h[:, s]) if self.remat \
                    else step(h, c, i2h[:, s])
                outs.append(h)
            cur = torch.stack(outs, dim=1)
            layer_outputs.append(cur)
            last_states.append((h, c))
        if not self.return_all_layers:
            layer_outputs, last_states = layer_outputs[-1:], last_states[-1:]
        return layer_outputs, last_states
