r"""Convolutional LSTM (Shi et al.): peephole ConvLSTM over a sequence.

One 4-gate convolution over ``concat([x, h])`` (gate order i, f, c, o),
zero-input decode mode and the ``(outputs, (h, c))`` sequence API, in three
forms, as in the JAX package's block:

- hoisted: the input half of the convolution runs once, batched over all
  ``t*b`` frames, and each step adds it to the hidden half (``hoist_i2h``);
- per-step concat: each step convolves ``concat([x_t, h])`` with the whole
  kernel;
- decode (no inputs): each step convolves ``h`` alone, with the bias.

Each step's gate chain is :func:`vp_suite_tpu_torch.ops.cells.convlstm_gate_fuse`
(the Triton kernels K1 forward and K2 backward on CUDA tensors), so the JAX
block's ``use_pallas`` has no counterpart here. ``use_fused_scan`` runs the
whole recurrence as one launch of
:func:`vp_suite_tpu_torch.ops.convlstm.convlstm_scan_fused` (for 3x3,
stride-1, padding-1 cells whose input half is hoisted or absent; K3 forward,
K3s and K4 under training). Both paths train through the kernels' autograd
Functions; the per-step path's backward (autograd over the cuDNN convs and
the K2 Function) is the counterpart of the JAX package's hand-written
recurrence VJP (``ops/scan_vjp.py``, ``remat_policy="scan_vjp"``). The JAX
block's ``remat``, ``remat_policy`` and ``scan_unroll`` steer XLA's
rematerialisation and loop unrolling; eager PyTorch has nothing they would
steer, so they have no counterpart. The block is time-major
(``[t, b, ...]``), the JAX block's ``time_major=True``: the Encoder-Forecaster
stack, its only user, runs time-major end to end.

Parameters keep the reference vp-suite's names and layouts: ``_conv``
(weight ``[4enc, in+enc, k, k]``, bias ``[4enc]``) and the peepholes
``Wci``/``Wcf``/``Wco`` ``[1, enc, state_h, state_w]``. The carry is ``h`` and
``c`` in the activation dtype on the per-step path; the fused scan carries
``c`` in f32 and returns it in the activation dtype.

Under tensor parallelism (``parallel.mesh.shard_params_tp``, the gate conv's
out-channels split over ``tp``) the per-step path computes this process's
``4enc / tp`` gate channels (the hoisted input half and each step's hidden
half, or each step's conv over ``concat([x_t, h])``) and gathers the gates
once a step, before K1; the fused path computes its hoisted input half
column-parallel and gathers it once, and runs K3 / K3s / K4 whole on every
process with the hidden weight and the peepholes gathered at use.
"""
import torch
from torch import nn

from vp_suite_tpu_torch.base.base_model_block import VPModelBlock
from vp_suite_tpu_torch.nn.functional import conv2d
from vp_suite_tpu_torch.nn.layers import Conv2d
from vp_suite_tpu_torch.ops.cells import convlstm_gate_fuse
from vp_suite_tpu_torch.ops.convlstm import convlstm_scan_fused
from vp_suite_tpu_torch.parallel.tensor import gather, local_param, tagged, tp_spec


class ConvLSTMShi(VPModelBlock):
    NAME = "ConvLSTM (Shi et al.)"
    PAPER_REFERENCE = "https://arxiv.org/abs/1506.04214"
    CODE_REFERENCE = "https://github.com/Hzzone/Precipitation-Nowcasting"
    MATCHES_REFERENCE = "Yes"

    def __init__(self, in_channels: int, enc_channels: int, state_h: int, state_w: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 use_fused_scan: bool = False, hoist_i2h: bool = True):
        super().__init__()
        self.in_channels = in_channels
        self.enc_channels = enc_channels
        self.state_h, self.state_w = state_h, state_w
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.use_fused_scan = use_fused_scan  #: whole recurrence in one kernel launch
        self.hoist_i2h = hoist_i2h            #: batch the input-half conv over time
        self._conv = Conv2d(in_channels + enc_channels, 4 * enc_channels, kernel_size,
                            stride, padding)
        shape = (1, enc_channels, state_h, state_w)
        self.Wci = nn.Parameter(torch.zeros(shape))
        self.Wcf = nn.Parameter(torch.zeros(shape))
        self.Wco = nn.Parameter(torch.zeros(shape))

    def reset_parameters(self, generator=None):
        r"""Zeroes the peepholes (``_conv`` initialises itself)."""
        with torch.no_grad():
            for p in (self.Wci, self.Wcf, self.Wco):
                p.zero_()

    def forward(self, inputs, states, seq_len: int):
        r"""Runs the cell over a sequence.

        Args:
            inputs: ``[t, b, h, w, in_c]`` or None (decode mode: zero inputs).
            states: ``(h, c)``, each ``[b, state_h, state_w, enc]``, or None
                (zero init).
            seq_len: number of steps (equal to t when inputs are given).

        Returns ``(outputs [t, b, state_h, state_w, enc], (h, c))``.
        """
        enc, sh, sw = self.enc_channels, self.state_h, self.state_w
        # this process's gate channels: all of them, or its tp shard
        weight, bias = local_param(self._conv, "weight"), local_param(self._conv, "bias")
        spec = tp_spec(weight)
        x_weight = tagged(weight[:, :self.in_channels], spec)
        h_weight = tagged(weight[:, self.in_channels:], spec)

        if states is None:
            if inputs is None:
                raise ValueError("ConvLSTMShi received None for both inputs and states")
            b = inputs.shape[1]
            h0 = inputs.new_zeros((b, sh, sw, enc))
            c0 = torch.zeros_like(h0)
        else:
            h0, c0 = states
            b = h0.shape[0]
        # the whole recurrence runs in the activation dtype (mixed precision); the
        # casts happen here, outside the kernels' autograd Functions, so that
        # autograd hands f32 gradients back to the f32 parameters
        dt = h0.dtype
        wci, wcf, wco = (p[0].permute(1, 2, 0).to(dt).contiguous()
                         for p in (self.Wci, self.Wcf, self.Wco))
        c0 = c0.to(dt)

        # the un-hoisted (concat) form needs x and h on the same spatial grid
        concat_ok = (inputs is not None and self.stride == 1
                     and inputs.shape[2] == sh and inputs.shape[3] == sw)
        hoist = inputs is not None and (self.hoist_i2h or self.use_fused_scan or not concat_ok)
        raw_xs = inputs is not None and not hoist
        fused = (self.use_fused_scan and not raw_xs and self.kernel_size == 3
                 and self.stride == 1 and self.padding == 1)
        if hoist:
            # one batched conv over all t*b frames; the bias rides this half. The
            # fused path takes it whole; the per-step path adds this process's
            # channels to each step's hidden half before the gather
            i2h_t = conv2d(inputs.reshape(-1, *inputs.shape[2:]), x_weight, bias,
                           self.stride, self.padding, gather_output=fused)
            i2h_t = i2h_t.reshape(seq_len, b, sh, sw, -1)
        elif raw_xs:
            i2h_t = inputs
        else:
            i2h_t = None  # decode mode: the bias rides the per-step hidden conv

        if fused:
            if i2h_t is None:
                i2h_in, k_bias = None, self._conv.bias
            else:
                i2h_in, k_bias = i2h_t, bias.new_zeros(4 * enc)
            outputs, (h_last, c_last) = convlstm_scan_fused(
                i2h_in, h0, c0, self._conv.weight[:, self.in_channels:].permute(2, 3, 1, 0).to(dt),
                k_bias, wci, wcf, wco, seq_len=seq_len)
        else:
            h, c = h0, c0
            outs = []
            for t in range(seq_len):
                if raw_xs:
                    gates = conv2d(torch.cat([i2h_t[t], h], dim=-1), weight, bias,
                                   self.stride, self.padding)
                else:
                    conv_h = conv2d(h, h_weight, bias if i2h_t is None else None,
                                    self.stride, self.padding, gather_output=False)
                    gates = conv_h if i2h_t is None else i2h_t[t] + conv_h
                    if spec is not None:
                        gates = gather(gates, spec, -1)
                h, c = convlstm_gate_fuse(gates, c, wci, wcf, wco)
                outs.append(h)
            outputs, h_last, c_last = torch.stack(outs), h, c
        return outputs, (h_last, c_last)
