r"""PredRNN++ (PredRNN-V2; the JAX package's ``models/predrnn_v2.py``):
stacked ST-LSTM cells with a spatiotemporal memory that zigzags through the
layers, on 4x4 patches (space to depth), with the memory-decoupling loss and
the scheduled-sampling training regime.

The model takes the complete sequence (``NEEDS_COMPLETE_INPUT``): step ``t``
of the ``T - 1`` steps reads ``mask * frame_t + (1 - mask) * x_gen``, the
previous step's prediction, where the sampling mask is ones for the warm-up
steps (the context, or the first step under reverse scheduled sampling)
followed by ``mask_true``; without ``mask_true`` it is the test mask. The
training schedules (``training_iteration``, ``sampling_eta``) live in the
train state's ``model_state``: :meth:`PredRNN_V2.sampling_rates` advances
the schedule on the host, with the JAX package's f32 arithmetic, and
:meth:`PredRNN_V2.scheduled_sampling_mask` draws a mask with those rates
from a ``torch.Generator`` (the train step passes the rates as 0-d tensors,
which a captured step reads anew at every replay).

With ``action_conditional`` (which forces ``conv_actions_on_input`` and
reverse scheduled sampling, as in the reference), two strided convs embed
the frame patches and the actions before the cells and two transposed convs
(with residuals from the input convs when ``residual_on_action_conv``) map
back. The time loop is a Python loop; the JAX package's ``remat`` and
``scan_unroll`` have no counterpart.
"""
import math

import numpy as np
import torch
from torch import nn

from vp_suite_tpu_torch.base.base_model import VPModel
from vp_suite_tpu_torch.model_blocks.predrnn import SpatioTemporalLSTMCell
from vp_suite_tpu_torch.nn.layers import Conv2d, ConvTranspose2d
from vp_suite_tpu_torch.ops.patch import patchify, unpatchify
from vp_suite_tpu_torch.utils.models import conv_output_shape


class PredRNN_V2(VPModel):
    NAME = "PredRNN++"
    PAPER_REFERENCE = "https://arxiv.org/abs/2103.09504"
    CODE_REFERENCE = "https://github.com/thuml/predrnn-pytorch"
    MATCHES_REFERENCE = "Yes"
    CAN_HANDLE_ACTIONS = False
    NEEDS_COMPLETE_INPUT = True
    TRAIN_REGIME = "scheduled_sampling"

    patch_size = 4
    num_layers = 3
    num_hidden = (128, 128, 128, 128)
    filter_size = 5
    stride = 1
    inflated_action_dim = 3
    layer_norm = False
    conv_actions_on_input = True
    residual_on_action_conv = True
    reverse_input = True
    decoupling_loss_scale = 100.0
    scheduled_sampling = True
    sampling_stop_iter = 50000
    sampling_changing_rate = 2e-5
    reverse_scheduled_sampling = False
    r_sampling_step_1 = 25000
    r_sampling_step_2 = 50000
    r_exp_alpha = 5000

    @property
    def patch_c(self):
        return self.patch_size * self.patch_size * self.img_c

    @property
    def patch_h(self):
        return self.img_h // self.patch_size

    @property
    def patch_w(self):
        return self.img_w // self.patch_size

    @property
    def _rss(self):
        return True if self.action_conditional else self.reverse_scheduled_sampling

    @property
    def rnn_h(self):
        return self.patch_h // 4 if self.action_conditional else self.patch_h

    @property
    def rnn_w(self):
        return self.patch_w // 4 if self.action_conditional else self.patch_w

    def __init__(self, **hparams):
        super().__init__(**hparams)
        nh, pc, ac = list(self.num_hidden), self.patch_c, self.action_conditional
        cells = []
        for i in range(self.num_layers):
            in_channel = (nh[0] if ac else pc) if i == 0 else nh[i - 1]
            cells.append(SpatioTemporalLSTMCell(in_channel, nh[i], self.rnn_h, self.rnn_w,
                                                self.filter_size, self.stride, self.layer_norm,
                                                action_conditional=ac))
        self.cell_list = nn.ModuleList(cells)
        if ac:
            fs, fp = self.filter_size, self.filter_size // 2
            self.conv_input1 = Conv2d(pc, nh[0] // 2, fs, 2, fp, bias=False)
            self.conv_input2 = Conv2d(nh[0] // 2, nh[0], fs, 2, fp, bias=False)
            self.action_conv_input1 = Conv2d(self.action_size, nh[0] // 2, fs, 2, fp, bias=False)
            self.action_conv_input2 = Conv2d(nh[0] // 2, nh[0], fs, 2, fp, bias=False)
            # static output paddings, so that the deconvs invert the strided convs
            mid = conv_output_shape((self.patch_h, self.patch_w), fs, 2, fp)
            op1 = (mid[0] - ((self.rnn_h - 1) * 2 - 2 * fp + fs),
                   mid[1] - ((self.rnn_w - 1) * 2 - 2 * fp + fs))
            op2 = (self.patch_h - ((mid[0] - 1) * 2 - 2 * fp + fs),
                   self.patch_w - ((mid[1] - 1) * 2 - 2 * fp + fs))
            self.deconv_output1 = ConvTranspose2d(nh[-1], nh[-1] // 2, fs, 2, fp, op1, bias=False)
            self.deconv_output2 = ConvTranspose2d(nh[-1] // 2, pc, fs, 2, fp, op2, bias=False)
        else:
            self.conv_last = Conv2d(nh[self.num_layers - 1], pc, 1, 1, 0, bias=False)
        adapter_c = nh[self.num_layers - 1] if ac else nh[0]
        self.adapter = Conv2d(adapter_c, adapter_c, 1, 1, 0, bias=False)

    def init_model_state(self):
        return {"training_iteration": 1, "sampling_eta": 1.0}

    def sampling_rates(self, model_state):
        r"""``(rates, model_state)`` of the next training draw, computed on the
        host: ``{"r_eta": ..., "eta": ...}`` under reverse scheduled sampling
        (from ``training_iteration``), ``{"eta": ...}`` under standard
        scheduled sampling, which decays ``sampling_eta`` before each draw (0
        from ``sampling_stop_iter`` on) and keeps it in the returned schedule,
        and ``{}`` without scheduled sampling. ``training_iteration`` advances
        in the train step, once per step."""
        itr = model_state["training_iteration"]
        if self._rss:
            s1, s2 = self.r_sampling_step_1, self.r_sampling_step_2
            if itr < s1:
                r_eta, eta = 0.5, 0.5
            elif itr < s2:
                r_eta = 1.0 - 0.5 * math.exp(-(itr - s1) / self.r_exp_alpha)
                eta = 0.5 - (0.5 / (s2 - s1)) * (itr - s1)
            else:
                r_eta, eta = 1.0, 0.0
            return {"r_eta": r_eta, "eta": eta}, model_state
        if not self.scheduled_sampling:
            return {}, model_state
        eta = 0.0 if itr >= self.sampling_stop_iter else \
            float(np.float32(model_state["sampling_eta"]) - np.float32(self.sampling_changing_rate))
        return {"eta": eta}, {**model_state, "sampling_eta": eta}

    def scheduled_sampling_mask(self, model_state, generator, batch_size, context_frames,
                                pred_frames, train: bool, device=None, rates=None):
        r"""``(mask_true, model_state)``: the mask ``[b, steps, 1, 1, 1]``
        (it broadcasts over the patches) and the schedule after it. Drawn from
        ``generator`` (on the device the mask goes to) when ``train``, as
        ``flips < rate``, with ``rates`` where given (:meth:`sampling_rates`'
        dict, its values floats or 0-d f32 tensors; ``model_state`` then comes
        back as it went in) and else with :meth:`sampling_rates` of
        ``model_state``; the test mask otherwise (ones for the context under
        reverse scheduled sampling, zeros for the predicted steps), on
        ``device``."""
        if not train:
            steps = context_frames + pred_frames - 2 if self._rss else pred_frames - 1
            mask = torch.zeros((batch_size, steps, 1, 1, 1), device=device)
            if self._rss:
                mask[:, :context_frames - 1] = 1.0
            return mask, model_state
        if rates is None:
            rates, model_state = self.sampling_rates(model_state)

        def flips(n):
            return torch.rand((batch_size, n), generator=generator, device=generator.device)

        if self._rss:
            r_mask = (flips(context_frames - 1) < rates["r_eta"]).float()
            mask = torch.cat([r_mask, (flips(pred_frames - 1) < rates["eta"]).float()], dim=1)
        elif not self.scheduled_sampling:
            return torch.zeros((batch_size, pred_frames - 1, 1, 1, 1),
                               device=generator.device), model_state
        else:
            mask = (flips(pred_frames - 1) < rates["eta"]).float()
        return mask[:, :, None, None, None], model_state

    def _normalized_adapter(self, delta):
        v = self.adapter(delta)
        v = v.reshape(v.shape[0], -1, v.shape[-1])                 # [b, hw, c]
        return v / v.square().sum(dim=1, keepdim=True).sqrt().clamp_min(1e-12)

    def forward(self, x, pred_frames: int = 1, actions=None, train: bool = False,
                mask_true=None, **kwargs):
        r"""``x`` ``[b, T, h, w, c]``, the context and the ``pred_frames``
        frames after it -> (the predictions of those frames, ``{"ST-LSTM
        decouple loss": ...}``). ``mask_true`` (a tensor or a numpy array)
        broadcasts to ``[b, steps, hp, wp, patch_c]``."""
        b, total = x.shape[:2]
        context_frames = total - pred_frames
        if context_frames < 1:
            raise ValueError(f"Model {self.NAME} needs input sequences that also include "
                             f"the target frames!")
        nh, ac = list(self.num_hidden), self.action_conditional
        x_patch = patchify(x, self.patch_size)
        if ac:
            if actions is None or actions.shape[-1] != self.action_size:
                raise ValueError("Given actions are None or of the wrong size!")
            a_patch = actions[:, :, None, None, :].expand(
                b, actions.shape[1], self.patch_h, self.patch_w, self.action_size)
        if mask_true is None:
            mask_true, _ = self.scheduled_sampling_mask(None, None, b, context_frames,
                                                        pred_frames, train=False, device=x.device)
        if not torch.is_tensor(mask_true):    # a numpy mask, copied
            mask_true = torch.tensor(np.asarray(mask_true))
        mask_true = mask_true.to(x.device, x.dtype)
        ones = mask_true.new_ones((b, 1 if self._rss else context_frames, *mask_true.shape[2:]))
        mask = torch.cat([ones, mask_true], dim=1)

        def zeros(c, h=self.rnn_h, w=self.rnn_w):
            return x.new_zeros((b, h, w, c))

        h_t = [zeros(nh[i]) for i in range(self.num_layers)]
        c_t = [zeros(nh[i]) for i in range(self.num_layers)]
        memory = zeros(nh[0])
        x_gen = zeros(self.patch_c, self.patch_h, self.patch_w)
        dl_sum = x.new_zeros((), dtype=torch.float32)
        x_gens = []
        for t in range(total - 1):
            m_t = mask[:, t]
            net = m_t * x_patch[:, t] + (1.0 - m_t) * x_gen
            action = None
            if ac:
                input_net1 = self.conv_input1(net)
                net = input_net2 = self.conv_input2(input_net1)
                action = self.action_conv_input2(self.action_conv_input1(a_patch[:, t]))
            for i, cell in enumerate(self.cell_list):
                h_t[i], c_t[i], memory, dc, dm = cell(net, h_t[i], c_t[i], memory, action)
                cos = (self._normalized_adapter(dc) * self._normalized_adapter(dm)).sum(dim=1)
                dl_sum = dl_sum + cos.abs().mean()
                net = h_t[i]
            if ac and self.residual_on_action_conv:
                y = self.deconv_output1(h_t[-1] + input_net2)
                x_gen = self.deconv_output2(y + input_net1)
            elif ac:
                x_gen = self.deconv_output2(self.deconv_output1(h_t[-1]))
            else:
                x_gen = self.conv_last(h_t[-1])
            x_gens.append(x_gen)

        predictions = unpatchify(torch.stack(x_gens[-pred_frames:], dim=1), self.patch_size)
        decouple_loss = dl_sum / (self.num_layers * (total - 1))
        return predictions, {"ST-LSTM decouple loss": self.decoupling_loss_scale * decouple_loss}
