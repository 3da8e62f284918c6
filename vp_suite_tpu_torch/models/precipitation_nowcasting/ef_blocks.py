r"""Encoder-Forecaster skeleton (Shi et al.).

Multi-stage encoder (conv subnet, then a recurrent block, per stage) and
forecaster (recurrent block, then a deconv subnet, per stage, in reverse),
with per-layer hyperparameter validation and conv-arithmetic state sizing,
as in the reference vp-suite's ``ef_blocks.py``. The whole stack runs
time-major (``[t, b, h, w, c]``) between one transpose at each end.

Two schedules compute the same function: *staged* (each stage's conv subnet
batched over all ``t*b`` frames between whole-sequence recurrences) and
*interleaved* (one loop over time that runs every stage's conv and cell step
per frame). ``interleaved_encode`` / ``interleaved_forecast`` pick one;
``None`` resolves as the JAX package does (:meth:`_resolve_interleave`).

``state_dict`` names follow the reference: ``encoder.stage{k}``,
``encoder.rnn{k}``, and for forecaster block ``n`` (0-based, deepest first)
``forecaster.rnn{num_layers-n}`` / ``forecaster.stage{num_layers-n}``.
"""
import torch
import torch.nn.functional as F
from torch import nn

from vp_suite_tpu_torch.base.base_model import VPModel
from vp_suite_tpu_torch.nn.layers import Conv2d, ConvTranspose2d
from vp_suite_tpu_torch.utils.models import conv_output_shape, convtransp_output_shape


class ConvStage(nn.Module):
    r"""A conv subnet stage built from string-keyed layer specs
    ``(name, (in_c, out_c, k, s, p))``, as the reference's ``_make_layers``.
    Names choose the op and activation: 'deconv*' or 'conv*', and 'identity'
    (skipped); '*leaky*' adds LeakyReLU(0.2), '*relu*' ReLU. Input and output
    are ``[n, h, w, c]``."""

    def __init__(self, layers):
        super().__init__()
        self.layer_names = []
        for name, v in layers:
            if "identity" in name:
                continue
            if "deconv" in name:
                self.add_module(name, ConvTranspose2d(v[0], v[1], v[2], v[3], v[4]))
            elif "conv" in name:
                self.add_module(name, Conv2d(v[0], v[1], v[2], v[3], v[4]))
            else:
                raise NotImplementedError(f"unknown or unported layer spec name: {name}")
            self.layer_names.append(name)

    def forward(self, x):
        for name in self.layer_names:
            x = getattr(self, name)(x)
            if "relu" in name:
                x = F.relu(x)
            elif "leaky" in name:
                x = F.leaky_relu(x, negative_slope=0.2)
        return x


def apply_stage_batched(stage, x):
    r"""Applies a ConvStage to ``[t, b, h, w, c]`` as one batched ``[t*b]`` conv."""
    t, b = x.shape[:2]
    y = stage(x.reshape(t * b, *x.shape[2:]))
    return y.reshape(t, b, *y.shape[1:])


class EncoderForecasterBase(VPModel):
    r"""Abstract Encoder-Forecaster model; subclasses provide the conv specs
    and recurrent blocks through :meth:`_build_encoder_decoder`."""
    NAME = "Encoder-Forecaster Structure (Shi et al.)"

    num_layers = 3
    interleaved_forecast = None  #: per-step forecaster loop (None: auto)
    interleaved_encode = None    #: per-step encoder loop (None: auto)

    _INTERLEAVE_MAX_STEPS = 20

    def __init__(self, **hparams):
        super().__init__(**hparams)
        (self.enc_rnn_state_h, self.enc_rnn_state_w,
         self.dec_rnn_state_h, self.dec_rnn_state_w) = self._compute_state_sizes()
        enc_convs, enc_rnns, dec_convs, dec_rnns = self._build_encoder_decoder()
        n = self.num_layers
        self.encoder = nn.Module()
        self.forecaster = nn.Module()
        for i, (spec, rnn) in enumerate(zip(enc_convs, enc_rnns)):
            self.encoder.add_module(f"stage{i + 1}", ConvStage(tuple(spec.items())))
            self.encoder.add_module(f"rnn{i + 1}", rnn)
        for i, (rnn, spec) in enumerate(zip(dec_rnns, dec_convs)):
            self.forecaster.add_module(f"rnn{n - i}", rnn)
            self.forecaster.add_module(f"stage{n - i}", ConvStage(tuple(spec.items())))
        # execution order: encoder 1..n, forecaster deepest (index 0) first
        self.enc_stages = [getattr(self.encoder, f"stage{i + 1}") for i in range(n)]
        self.enc_rnns_list = list(enc_rnns)
        self.dec_stages = [getattr(self.forecaster, f"stage{n - i}") for i in range(n)]
        self.dec_rnns_list = list(dec_rnns)

    def _resolve_interleave(self, flag, rnns, n_steps: int) -> bool:
        r"""An explicit True/False wins; None interleaves iff the sequence has
        at most 20 steps and no block draws zoneout masks."""
        if flag is not None:
            return flag
        if n_steps > self._INTERLEAVE_MAX_STEPS:
            return False
        return all(getattr(rnn, "zoneout", 0.0) == 0.0 for rnn in rnns)

    def _per_layer_params(self):
        return [(name, getattr(self, name)) for name in self.hparam_names()
                if name.startswith("enc_") or name.startswith("dec_")]

    def _compute_state_sizes(self):
        for param, val in self._per_layer_params():
            if param in ("enc_c", "dec_c"):
                ok = len(val) == 2 * self.num_layers
            else:
                ok = len(val) == self.num_layers
            if not ok:
                raise AttributeError(f"Specified {self.num_layers} layers, but len of "
                                     f"attribute '{param}' doesn't match that ({val}).")

        next_h, next_w = self.img_h, self.img_w
        enc_rnn_state_h, enc_rnn_state_w = [], []
        for n in range(self.num_layers):
            next_h, next_w = conv_output_shape((next_h, next_w), self.enc_conv_k[n],
                                               self.enc_conv_s[n], self.enc_conv_p[n])
            enc_rnn_state_h.append(next_h)
            enc_rnn_state_w.append(next_w)

        dec_rnn_state_h, dec_rnn_state_w = [next_h], [next_w]
        for n in range(self.num_layers - 1):
            next_h, next_w = convtransp_output_shape((next_h, next_w), self.dec_conv_k[n],
                                                     self.dec_conv_s[n], self.dec_conv_p[n])
            dec_rnn_state_h.append(next_h)
            dec_rnn_state_w.append(next_w)

        final_h, final_w = convtransp_output_shape((next_h, next_w), self.dec_conv_k[-1],
                                                   self.dec_conv_s[-1], self.dec_conv_p[-1])
        if (self.img_h, self.img_w) != (final_h, final_w):
            hidden_sizes = list(zip(enc_rnn_state_h, enc_rnn_state_w)) \
                + list(zip(dec_rnn_state_h, dec_rnn_state_w))
            raise AttributeError(f"Model layer hyperparameters yield wrong output size: "
                                 f"{(final_h, final_w)} (expected: {(self.img_h, self.img_w)}). "
                                 f"All hidden sizes: {hidden_sizes}")
        return enc_rnn_state_h, enc_rnn_state_w, dec_rnn_state_h, dec_rnn_state_w

    def _build_encoder_decoder(self):
        raise NotImplementedError

    def encode(self, x):
        r"""Encoder over time-major ``x`` ``[t, b, h, w, c]``; returns each
        stage's final ``(h, c)``."""
        t = x.shape[0]
        if self._resolve_interleave(self.interleaved_encode, self.enc_rnns_list, t):
            states = [None] * len(self.enc_rnns_list)
            for ti in range(t):
                cur = x[ti:ti + 1]
                for i, (stage, rnn) in enumerate(zip(self.enc_stages, self.enc_rnns_list)):
                    cur = apply_stage_batched(stage, cur)
                    cur, states[i] = rnn(cur, states[i], 1)
            return tuple(states)
        hidden_states = []
        cur = x
        for stage, rnn in zip(self.enc_stages, self.enc_rnns_list):
            cur = apply_stage_batched(stage, cur)
            cur, state = rnn(cur, None, t)
            hidden_states.append(state)
        return tuple(hidden_states)

    def forecast(self, hidden_states, pred_frames: int):
        r"""Forecaster: reversed stages, each block seeded with the encoder's
        state of its size, zero input on the deepest; time-major output."""
        n = self.num_layers
        if self._resolve_interleave(self.interleaved_forecast, self.dec_rnns_list,
                                    pred_frames):
            states = [hidden_states[n - 1 - i] for i in range(n)]
            frames = []
            for _ in range(pred_frames):
                cur = None
                for i in range(n):
                    cur, states[i] = self.dec_rnns_list[i](cur, states[i], 1)
                    cur = apply_stage_batched(self.dec_stages[i], cur)
                frames.append(cur[0])
            return torch.stack(frames, 0)
        cur, _ = self.dec_rnns_list[0](None, hidden_states[-1], pred_frames)
        cur = apply_stage_batched(self.dec_stages[0], cur)
        for i in range(1, n):
            cur, _ = self.dec_rnns_list[i](cur, hidden_states[n - 1 - i], pred_frames)
            cur = apply_stage_batched(self.dec_stages[i], cur)
        return cur

    def forward(self, x, pred_frames: int = 1, actions=None, train: bool = False, **kwargs):
        states = self.encode(x.transpose(0, 1))
        preds = self.forecast(states, pred_frames)
        return preds.transpose(0, 1), None
