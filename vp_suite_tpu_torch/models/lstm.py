r"""The encoder-LSTM-decoder model (the JAX package's ``models/lstm.py``): a
conv encoder (a 7x7/s2 conv, then two 3x3/s2 convs with replicate padding)
and a linear bottleneck, stacked LSTM cells on the latent, and a linear and
three transposed convs back to a frame, resized to the image size.

The context is encoded in one batch and warms the cells up, step by step;
the first prediction is decoded from the top cell's ``h``, and each one
after it encodes the prediction before it, steps the cells and decodes. The
cells are stacked: each layer reads the ``h`` the layer below it just
computed (the JAX package's documented repair of the reference, whose
warm-up feeds every layer the same input and whose cells are never
registered). With ``action_conditional``, a linear inflation of each step's
action (``bottleneck_dim // 10`` wide) is concatenated to the latent.

The cells are registered (``rnn_layers.{i}``, torch's ``nn.LSTMCell``
parameters ``weight_ih`` ``[4h, in]``, ``weight_hh``, ``bias_ih``,
``bias_hh``, gate order i, f, g, o) and compute in the activations' dtype,
their parameters cast at use, as the JAX package does. The flattened code
is ``(h, w, c)``-major, the JAX package's layout, so ``to_linear``'s and
``from_linear``'s weights are the JAX kernels transposed.

``remat`` checkpoints each autoregressive step (encode, cells, decode) under
training, as the JAX model checkpoints its ``ar_body`` (``lstm.py:178-179``);
the warm-up over the context is not checkpointed, as in JAX.
"""
import math

import torch
import torch.nn.functional as F
from torch import nn

from vp_suite_tpu_torch.base.base_model import VPModel
from vp_suite_tpu_torch.nn import remat
from vp_suite_tpu_torch.base.base_model_block import VPModelBlock
from vp_suite_tpu_torch.nn.layers import Conv2d, ConvTranspose2d, Dense
from vp_suite_tpu_torch.ops.image import resize_bilinear
from vp_suite_tpu_torch.utils.models import conv_output_shape


class LSTMCell(VPModelBlock):
    r"""``nn.LSTMCell``'s parameters and math, run in the input's dtype:
    ``forward(x, (h, c)) -> (h, c)``."""
    NAME = "LSTM Cell"

    def __init__(self, input_size, hidden_size):
        super().__init__()
        self.hidden_size = hidden_size
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden_size, input_size))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden_size, hidden_size))
        self.bias_ih = nn.Parameter(torch.empty(4 * hidden_size))
        self.bias_hh = nn.Parameter(torch.empty(4 * hidden_size))

    def reset_parameters(self, generator=None):
        r"""torch's init: every parameter U(-1/sqrt(hidden), 1/sqrt(hidden))."""
        bound = 1.0 / math.sqrt(self.hidden_size)
        with torch.no_grad():
            for p in (self.weight_ih, self.weight_hh, self.bias_ih, self.bias_hh):
                p.uniform_(-bound, bound, generator=generator)

    def forward(self, x, state):
        h, c = state
        dt = x.dtype
        gates = F.linear(x, self.weight_ih.to(dt), self.bias_ih.to(dt)) \
            + F.linear(h, self.weight_hh.to(dt)) + self.bias_hh.to(dt)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c


class LSTM(VPModel):
    NAME = "NonConvLSTM"
    MATCHES_REFERENCE = "No (reference implementation is broken; see docstring)"
    CAN_HANDLE_ACTIONS = True

    bottleneck_dim = 1024
    lstm_hidden_dim = 1024
    lstm_num_layers = 3

    def __init__(self, **hparams):
        super().__init__(**hparams)
        c = self.img_c
        hw = (self.img_h, self.img_w)
        for k, s, p in ((7, 2, 3), (3, 2, 1), (3, 2, 1)):
            hw = conv_output_shape(hw, k, s, p)
        self.enc_shape = (*hw, 256)
        enc_numel = math.prod(self.enc_shape)
        self.enc1 = Conv2d(c, 64, 7, 2, 3)
        self.enc2 = Conv2d(64, 128, 3, 2, 1, padding_mode="replicate")
        self.enc3 = Conv2d(128, 256, 3, 2, 1, padding_mode="replicate")
        self.to_linear = Dense(enc_numel, self.bottleneck_dim)
        in_dim = self.bottleneck_dim
        if self.action_conditional:
            self.action_inflate = Dense(self.action_size, self.bottleneck_dim // 10)
            in_dim += self.bottleneck_dim // 10
        cells = []
        for _ in range(self.lstm_num_layers):
            cells.append(LSTMCell(in_dim, self.lstm_hidden_dim))
            in_dim = self.lstm_hidden_dim
        self.rnn_layers = nn.ModuleList(cells)
        self.from_linear = Dense(self.lstm_hidden_dim, enc_numel)
        self.dec1 = ConvTranspose2d(256, 128, 3, 2, 1)
        self.dec2 = ConvTranspose2d(128, 64, 3, 2, 1)
        self.dec3 = ConvTranspose2d(64, c, 7, 2, 3)

    def _encode(self, frames):
        r"""``[n, h, w, c]`` -> ``[n, bottleneck_dim]``."""
        y = self.enc3(self.enc2(self.enc1(frames).relu()).relu()).relu()
        return self.to_linear(y.flatten(1))

    def _decode(self, latent):
        r"""``[n, hidden]`` -> ``[n, h, w, c]``."""
        y = self.from_linear(latent).unflatten(1, self.enc_shape)
        y = self.dec3(self.dec2(self.dec1(y).relu()).relu())
        return resize_bilinear(y, (self.img_h, self.img_w))

    def _step(self, states, latent, action):
        r"""One step of the stacked cells; returns the new states."""
        cur = latent
        if self.action_conditional:
            cur = torch.cat([cur, self.action_inflate(action.to(cur.dtype))], dim=-1)
        new = []
        for cell, state in zip(self.rnn_layers, states):
            new.append(cell(cur, state))
            cur = new[-1][0]
        return new

    def forward(self, x, pred_frames: int = 1, actions=None, train: bool = False, **kwargs):
        r"""``x`` ``[b, t, h, w, c]``, the context -> (``[b, pred_frames, h,
        w, c]``, None), in train and eval mode alike."""
        b, t = x.shape[:2]
        want = (self.img_h, self.img_w, self.img_c)
        if tuple(x.shape[2:]) != want:
            raise ValueError(f"input image does not match specified size "
                             f"(input: {tuple(x.shape[2:])}, required (h,w,c): {want})")
        if self.action_conditional and (actions is None or actions.shape[-1] != self.action_size):
            raise ValueError("Given actions are None or of the wrong size!")
        enc = self._encode(x.transpose(0, 1).flatten(0, 1)).unflatten(0, (t, b))
        zeros = x.new_zeros((b, self.lstm_hidden_dim))
        states = [(zeros, zeros)] * self.lstm_num_layers
        for step in range(t):
            states = self._step(states, enc[step],
                                actions[:, step] if self.action_conditional else None)
        preds = [self._decode(states[-1][0])]
        for step in range(t, t + pred_frames - 1):
            action = actions[:, step] if self.action_conditional else None
            if self.remat:
                states, pred = remat.checkpoint(self._ar_step, states, preds[-1], action)
            else:
                states, pred = self._ar_step(states, preds[-1], action)
            preds.append(pred)
        return torch.stack(preds, dim=1), None

    def _ar_step(self, states, prev, action):
        r"""One autoregressive step: encode the previous prediction, step the
        cells, decode; returns the new states and the prediction (JAX's
        ``ar_body``, the region that ``remat`` checkpoints)."""
        states = self._step(states, self._encode(prev), action)
        return states, self._decode(states[-1][0])
