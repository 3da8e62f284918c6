r"""PhyDNet (the JAX package's ``models/phydnet.py``): a DCGAN encoder feeds
two branches, a PDE-constrained PhyCell and a ConvLSTM (the ndrplz cell),
whose decodings are summed and decoded to a frame through a sigmoid; in
train mode a moment-regularization loss on the PhyCell's first F conv, and
the teacher-forcing training regime.

One time loop of ``ctx + pred - 1`` steps carries both branches' states and
the previous output. Step ``t`` reads ``g * x_t + (1 - g) * prev_out``,
with ``g`` 1 for the context steps and, after them, the teacher-forcing
flag in train mode (the train step's coin, a 0-d 0/1 tensor, blended on
the card without a host sync) and 0 otherwise. Where ``g`` is a Python 0 or
1 the step reads the one operand directly (the same value), so the context
frames are encoded in one batch of ``ctx * b``, and an eval rollout decodes
only from step ``ctx - 1`` on: the earlier outputs feed nothing. (The JAX
model's ``prev_out`` starts as zeros; with a context of at least one frame
step 0 never reads it.) Branch states start as zeros. Train mode returns
every step's output (frames 2 to ``ctx + pred``), eval mode the last
``pred``.

Actions (``action_conditional``) are cast to the activations' dtype and
broadcast over the 16x16 grid of the ConvLSTM's input and the PhyCell's
action convs. ``decoder_D`` ends in ``ops.image.resize_bilinear`` to the
image size, which is the identity wherever the model runs: the encoder
keeps ``h // 4`` only where ``h`` is a multiple of 4, and at other sizes the
branch states, made at ``h // 4``, do not fit its output (the JAX model
fails alike). ``remat`` checkpoints each step under training with the JAX
model's policy (``phydnet.py:133-136, 177-180``): the ConvLSTM cells' gate
pre-activations (``"convlstm_gates"``) are kept with the step's inputs, and
the rest of the step (the encoding of a frame after the context, both
branches, the decoding) runs again in the backward; the teacher-forcing coin
is drawn outside. The JAX package's ``scan_unroll`` has no counterpart:
eager PyTorch has no loop to unroll.
"""
import torch
from torch import nn

from vp_suite_tpu_torch.base.base_model import VPModel
from vp_suite_tpu_torch.model_blocks.conv_lstm_ndrplz import ConvLSTMCellNdrplz
from vp_suite_tpu_torch.model_blocks.enc import (DCGANDecoder, DCGANEncoder, DecoderSplit,
                                                 EncoderSplit)
from vp_suite_tpu_torch.model_blocks.phydnet import (PhyCell, inflate_action, k2m_matrices,
                                                     moment_constraints, moment_loss)
from vp_suite_tpu_torch.nn import remat


class _CellList(nn.Module):
    r"""The ConvLSTM branch's cells under the reference's ``cell_list``."""

    def __init__(self, cells):
        super().__init__()
        self.cell_list = nn.ModuleList(cells)


class PhyDNet(VPModel):
    NAME = "PhyDNet"
    PAPER_REFERENCE = "https://arxiv.org/abs/2003.01460"
    CODE_REFERENCE = "https://github.com/vincent-leguen/PhyDNet"
    MATCHES_REFERENCE = "Not Yet"
    CAN_HANDLE_ACTIONS = True
    TRAIN_REGIME = "teacher_forcing"

    phycell_n_layers = 1
    phycell_channels = 49
    phycell_kernel_size = (7, 7)
    convlstm_n_layers = 3            #: kept for the configuration; the hidden dims set the depth
    convlstm_hidden_dims = (128, 128, 64)
    convlstm_kernel_size = (3, 3)
    moment_loss_scale = 1.0
    teacher_forcing_decay = 0.003

    def __init__(self, **hparams):
        super().__init__(**hparams)
        c, ac = self.img_c, self.action_conditional
        self.encoder_E = DCGANEncoder(c, 32)
        self.encoder_Ep = EncoderSplit(64, 64)
        self.encoder_Er = EncoderSplit(64, 64)
        self.decoder_Dp = DecoderSplit(64, 64)
        self.decoder_Dr = DecoderSplit(64, 64)
        self.decoder_D = DCGANDecoder((self.img_h, self.img_w), c, 32)
        self.phycell = PhyCell(64, ac, self.action_size, self.phycell_channels,
                               self.phycell_n_layers, self.phycell_kernel_size)
        cells, in_dim = [], 64 + (self.action_size if ac else 0)
        for hid in self.convlstm_hidden_dims:
            cells.append(ConvLSTMCellNdrplz(in_dim, hid, self.convlstm_kernel_size))
            in_dim = hid
        self.convcell = _CellList(cells)
        # the moment loss's constants, on the model's device (not in the state_dict)
        kh, kw = self.phycell_kernel_size
        self.register_buffer("moment_m0", torch.empty(kh, kh), persistent=False)
        self.register_buffer("moment_m1", torch.empty(kw, kw), persistent=False)
        self.register_buffer("moment_constraints", torch.empty(self.phycell_channels, kh, kw),
                             persistent=False)

    def reset_parameters(self, generator=None):
        super().reset_parameters(generator)
        with torch.no_grad():
            m0, m1 = k2m_matrices(self.phycell_kernel_size)
            self.moment_m0.copy_(m0)
            self.moment_m1.copy_(m1)
            self.moment_constraints.copy_(moment_constraints(self.phycell_channels,
                                                             self.phycell_kernel_size))

    def _encode(self, frames):
        z = self.encoder_E(frames)
        return self.encoder_Ep(z), self.encoder_Er(z)

    def _recur(self, inp_phys, inp_conv, action, phy_h, conv_h, conv_c):
        r"""One step of both branches: the new PhyCell states and ConvLSTM
        ``h`` and ``c``, lists."""
        phy_h = self.phycell(inp_phys, action, phy_h)
        cur = inp_conv
        if self.action_conditional:
            cur = torch.cat([cur, inflate_action(action, *cur.shape[1:3], cur.dtype)], dim=-1)
        new_h, new_c = [], []
        for cell, h, c in zip(self.convcell.cell_list, conv_h, conv_c):
            cur, c = cell(cur, (h, c))
            new_h.append(cur)
            new_c.append(c)
        return phy_h, new_h, new_c

    def _decode(self, phy, conv):
        return torch.sigmoid(self.decoder_D(self.decoder_Dp(phy) + self.decoder_Dr(conv)))

    def _step(self, carry, inputs, action, decode):
        r"""One step: ``inputs`` are the context's encodings ``(phys, conv)``,
        a frame ``(frame,)`` or its blend ``(x_t, out, g)``; returns the new
        PhyCell states, ConvLSTM ``h`` and ``c`` and, where ``decode``, the
        decoded frame (JAX's ``step``, the region that ``remat``
        checkpoints)."""
        if len(inputs) == 3:
            x_t, out, g = inputs
            inputs = (g * x_t + (1 - g) * out,)
        inp_phys, inp_conv = inputs if len(inputs) == 2 else self._encode(inputs[0])
        phy_h, conv_h, conv_c = self._recur(inp_phys, inp_conv, action, *carry)
        return phy_h, conv_h, conv_c, self._decode(phy_h[-1], conv_h[-1]) if decode else None

    def forward(self, x, pred_frames: int = 1, actions=None, train: bool = False,
                teacher_forcing=False, **kwargs):
        r"""``x`` ``[b, t, h, w, c]`` (in train mode context and targets, else
        the context) -> ``(frames, aux)``: ``[b, ctx + pred - 1, ...]`` in
        train mode with ``{"moment regularization loss": ...}``, else
        ``[b, pred, ...]`` and None. ``teacher_forcing`` (train mode only) is
        a Python number or a 0-d tensor."""
        b, t = x.shape[:2]
        ctx = t - pred_frames if train else t
        n_steps = ctx + pred_frames - 1
        if self.action_conditional:
            if actions is None or actions.shape[-1] != self.action_size:
                raise ValueError("Given actions are None or of the wrong size!")
        g = teacher_forcing if train else 0
        if torch.is_tensor(g):
            g = g.to(x.dtype)

        eh, ew = self.img_h // 4, self.img_w // 4
        phy_h = [x.new_zeros((b, eh, ew, 64)) for _ in range(self.phycell_n_layers)]
        conv_h = [x.new_zeros((b, eh, ew, hid)) for hid in self.convlstm_hidden_dims]
        conv_c = list(conv_h)
        # the context's encodings in one batch, time-major
        ctx_phys, ctx_conv = (e.unflatten(0, (ctx, b)) for e in
                              self._encode(x[:, :ctx].transpose(0, 1).flatten(0, 1)))
        first_decoded = 0 if train else ctx - 1
        out, outs = None, []     # a step after the context reads the one before it
        for step in range(n_steps):
            if step < ctx:
                inputs = (ctx_phys[step], ctx_conv[step])
            elif torch.is_tensor(g) or g not in (0, 1):
                inputs = (x[:, step], out, g)
            else:
                inputs = (x[:, step] if g else out,)
            action = actions[:, step] if self.action_conditional else None
            carry = (phy_h, conv_h, conv_c)
            decode = step >= first_decoded
            if self.remat:
                phy_h, conv_h, conv_c, new = remat.checkpoint(
                    self._step, carry, inputs, action, decode, saved=("convlstm_gates",))
            else:
                phy_h, conv_h, conv_c, new = self._step(carry, inputs, action, decode)
            if decode:
                out = new
                outs.append(out)
        preds = torch.stack(outs, dim=1)
        if not train:
            return preds, None
        m_loss = moment_loss(self.phycell.cell_list[0].F.conv1.weight, self.moment_constraints,
                             (self.moment_m0, self.moment_m1))
        return preds, {"moment regularization loss": self.moment_loss_scale * m_loss}
