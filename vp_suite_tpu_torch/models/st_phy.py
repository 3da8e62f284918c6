r"""ST-Phy (the JAX package's ``models/st_phy.py``): PhyDNet's PhyCell beside
PredRNN-V2's spatio-temporal LSTM cell, on the codes of an
:class:`~vp_suite_tpu_torch.model_blocks.enc.Autoencoder`; a
memory-decoupling loss through a shared adapter, the moment loss on the
first PhyCell, and the teacher-forcing training regime.

Each of the ``ctx + pred - 1`` steps reads a code ``g * enc_t + (1 - g) *
x_gen``: the encoded frame ``t`` and the previous step's latent, with ``g``
1 over the context and, after it, the teacher-forcing flag in train mode
(the train step's coin, a 0-d tensor blended on the card) and 0 otherwise.
Every layer reads that code: layer ``i`` steps its PhyCell and its ST-LSTM
cell (``layer_norm``, 5x5 filters), the ST-LSTM cells pass one spatial memory
from layer to layer, and the layer's 1x1 ``hidden_conv`` over ``concat(st_h,
phy_h)`` gives the latent. As in the JAX package, each layer's latent
replaces the one before it, so only the last layer's PhyCell and hidden conv
reach an output; the others' are not run (their parameters stay, and the
first PhyCell's F conv still carries the moment loss). Where ``g`` is a
Python 0 or 1 the step reads the one operand directly, the same value.

The frames a step reads are encoded in one batch before the loop (the
context alone in eval mode, where the steps after it read the latent), the
action path (a bias-free linear read channel-major as ``(iad, h, w)``, then a
5x1 and a 1x5 conv, summed) runs once over all steps, and the latents are
decoded in one batch after it: train mode returns every step's frame, eval
mode those from step ``ctx - 1`` on. In train mode the decoupling term of
each layer and step (the mean over samples and channels of ``|sum over
pixels|`` of the adapted, pixel-normalized deltas) is summed in f32 and
divided by ``num_layers * n_steps``. The moment loss carries the JAX
package's scale twice (``moment_loss_scale ** 2`` times the base value).

``remat`` checkpoints each step under training with the JAX model's policy
(``st_phy.py:177-179``): the ST-LSTM cells' gate pre-activations
(``"st_gates"``) are kept with the step's inputs, and the rest of the step
runs again in the backward; the teacher-forcing coin is drawn outside. The
JAX package's ``scan_unroll`` has no counterpart: eager PyTorch has no loop
to unroll.
"""
import torch
from torch import nn

from vp_suite_tpu_torch.base.base_model import VPModel
from vp_suite_tpu_torch.model_blocks.enc import Autoencoder
from vp_suite_tpu_torch.model_blocks.phydnet import (PhyCellCell, k2m_matrices,
                                                     moment_constraints, moment_loss)
from vp_suite_tpu_torch.model_blocks.predrnn import SpatioTemporalLSTMCell
from vp_suite_tpu_torch.nn import remat
from vp_suite_tpu_torch.nn.layers import Conv2d, Dense


class STPhy(VPModel):
    NAME = "ST-Phy"
    PAPER_REFERENCE = "https://arxiv.org/abs/2003.01460"
    CAN_HANDLE_ACTIONS = True
    TRAIN_REGIME = "teacher_forcing"

    num_layers = 3
    phycell_channels = 49
    phycell_kernel_size = (7, 7)
    st_cell_channels = 64
    inflated_action_dim = 3
    decoupling_loss_scale = 100.0
    moment_loss_scale = 1.0
    teacher_forcing_decay = 0.003

    def __init__(self, **hparams):
        super().__init__(**hparams)
        stc, ac, n = self.st_cell_channels, self.action_conditional, self.num_layers
        self.autoencoder = Autoencoder(self.img_shape, stc)
        _, _, eh, ew = self.autoencoder.encoded_shape
        if eh < 1 or ew < 1:
            raise ValueError(f"image size {self.img_shape[1:]} encodes to {(eh, ew)}")
        self.enc_hw = (eh, ew)
        self.st_cell_list = nn.ModuleList([
            SpatioTemporalLSTMCell(stc, stc, eh, ew, 5, 1, True, action_conditional=ac)
            for _ in range(n)])
        self.phycell_list = nn.ModuleList([
            PhyCellCell(stc, ac, self.action_size, self.phycell_channels,
                        self.phycell_kernel_size) for _ in range(n)])
        self.hidden_conv_list = nn.ModuleList([
            Conv2d(2 * stc, stc, 1, 1, 0, bias=i < n - 1) for i in range(n)])
        self.adapter = Conv2d(stc, stc, 1, 1, 0, bias=False)
        if ac:
            iad = self.inflated_action_dim
            self.action_inflate = Dense(self.action_size, iad * eh * ew, bias=False)
            self.action_conv_h = Conv2d(iad, stc, (5, 1), 1, (2, 0), bias=False)
            self.action_conv_w = Conv2d(iad, stc, (1, 5), 1, (0, 2), bias=False)
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

    def _inflated_actions(self, actions, dtype):
        r"""``[n, b, a]`` actions -> ``[n, b, eh, ew, stc]``."""
        n, b = actions.shape[:2]
        a = self.action_inflate(actions.flatten(0, 1).to(dtype))
        a = a.unflatten(1, (self.inflated_action_dim, *self.enc_hw))
        a = a.permute(0, 2, 3, 1).contiguous()
        return (self.action_conv_h(a) + self.action_conv_w(a)).unflatten(0, (n, b))

    def _normalized_adapter(self, delta):
        v = self.adapter(delta).flatten(1, 2)                     # [b, hw, c]
        return v / v.square().sum(dim=1, keepdim=True).sqrt().clamp_min(1e-12)

    def _step(self, carry, code, action, inflated, train):
        r"""One step: ``carry`` ``(st_h, st_c, phy_h, memory, decoupling
        sum)``, ``code`` the step's code ``(enc_t,)`` or its blend ``(enc_t,
        x_gen, g)``; returns the new carry and the latent (JAX's ``step``,
        the region that ``remat`` checkpoints)."""
        st_h, st_c, phy_h, memory, decoupling = carry
        st_h, st_c, last = list(st_h), list(st_c), self.num_layers - 1
        if len(code) == 3:
            enc_t, x_gen, g = code
            code = g * enc_t + (1 - g) * x_gen
        else:
            code = code[0]
        for i, cell in enumerate(self.st_cell_list):
            st_h[i], st_c[i], memory, d_c, d_m = cell(code, st_h[i], st_c[i], memory, inflated)
            if train:
                term = self._normalized_adapter(d_c) * self._normalized_adapter(d_m)
                decoupling = decoupling + term.sum(dim=1).abs().mean()
        phy_h = self.phycell_list[last](code, action, phy_h)
        x_gen = self.hidden_conv_list[last](torch.cat([st_h[last], phy_h], dim=-1))
        return st_h, st_c, phy_h, memory, decoupling, x_gen

    def forward(self, x, pred_frames: int = 1, actions=None, train: bool = False,
                teacher_forcing=False, **kwargs):
        r"""``x`` ``[b, t, h, w, c]`` (in train mode context and targets, else
        the context) -> ``(frames, aux)``: ``[b, ctx + pred - 1, ...]`` in
        train mode with the moment and memory decoupling losses, else ``[b,
        pred, ...]`` and None. ``teacher_forcing`` (train mode only) is a
        Python number or a 0-d tensor."""
        b, t = x.shape[:2]
        ctx = t - pred_frames if train else t
        n_steps = ctx + pred_frames - 1
        ac = self.action_conditional
        if ac and (actions is None or actions.shape[-1] != self.action_size):
            raise ValueError("Given actions are None or of the wrong size!")
        g = teacher_forcing if train else 0
        blend = torch.is_tensor(g) or g not in (0, 1)
        if torch.is_tensor(g):
            g = g.to(x.dtype)
        n_enc = n_steps if train and (blend or g) else ctx
        enc = self.autoencoder.encode(x[:, :n_enc].transpose(0, 1).flatten(0, 1))
        enc = enc.unflatten(0, (n_enc, b))                         # time-major codes
        if ac:
            act = actions[:, :n_steps].transpose(0, 1)
            inflated = self._inflated_actions(act, x.dtype)

        zeros = x.new_zeros((b, *self.enc_hw, self.st_cell_channels))
        st_h, st_c = [zeros] * self.num_layers, [zeros] * self.num_layers
        phy_h, memory, x_gen = zeros, zeros, zeros
        decoupling = torch.zeros((), dtype=torch.float32, device=x.device)
        latents = []
        for step in range(n_steps):
            if step < ctx or (not blend and g):
                code = (enc[step],)
            elif blend:
                code = (enc[step], x_gen, g)
            else:
                code = (x_gen,)
            carry = (st_h, st_c, phy_h, memory, decoupling)
            xs = (act[step], inflated[step]) if ac else (None, None)
            if self.remat:
                carry = remat.checkpoint(self._step, carry, code, *xs, train,
                                         saved=("st_gates",))
            else:
                carry = self._step(carry, code, *xs, train)
            st_h, st_c, phy_h, memory, decoupling, x_gen = carry
            latents.append(x_gen)
        if not train:
            latents = latents[ctx - 1:]
        frames = self.autoencoder.decode(torch.stack(latents).flatten(0, 1))
        preds = frames.unflatten(0, (len(latents), b)).transpose(0, 1)
        if not train:
            return preds, None
        base = moment_loss(self.phycell_list[0].F.conv1.weight, self.moment_constraints,
                           (self.moment_m0, self.moment_m1))
        scale = self.moment_loss_scale
        return preds, {
            "moment regularization loss": scale * (scale * base),
            "memory decoupling loss": self.decoupling_loss_scale
            * (decoupling / (self.num_layers * n_steps)),
        }
