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
Functions.

``remat`` and ``remat_policy`` are the JAX block's, with its branches
(``conv_lstm_shi.py:147-205``), as activation checkpointing
(:mod:`vp_suite_tpu_torch.nn.remat`) of the per-step path; the fused path
takes none (its kernels keep K3s's residuals, as in JAX):

- ``"scan_vjp"`` where the input half is hoisted or absent (decode): no
  checkpoint; the per-step autograd over the cuDNN convs and the K2 Function
  is the counterpart of JAX's hand-written recurrence VJP
  (``ops/scan_vjp.py``). With raw inputs (``hoist_i2h=False`` and inputs on
  the state's grid) JAX checkpoints the whole step, and so does the port;
- ``"gates"`` keeps each step's gate pre-activations (after the tensor-
  parallel gather) besides its inputs: the gate conv is not run again, K1 is
  (a checkpoint of the gate block alone, so that the backward relaunches K1
  for ``c'``), and with raw inputs the conv keeps ``x_t`` and ``h`` and builds
  its input ``[x_t, h]`` again in the backward
  (:func:`~vp_suite_tpu_torch.nn.remat.recompute_saved`);
- any other policy checkpoints the whole step: the backward runs the gate
  conv, the gather and K1 again.

The JAX block's ``use_pallas`` and ``scan_unroll`` have no counterpart: the
port has one gate path, and eager PyTorch has no loop to unroll. The block
is time-major (``[t, b, ...]``), the JAX block's ``time_major=True``: the
Encoder-Forecaster stack, its only user, runs time-major end to end.

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

Under spatial parallelism (inside ``parallel.spatial.spatial_halo_convs``,
each ``sp`` process holding a slab of the image's rows) the per-step path
runs on this process's rows: its convs exchange halos and K1 / K2 take the
slab's gates with the peepholes' same rows. The fused path gathers the rows
of its hoisted input half and of the initial state over ``sp``, runs K3 /
K3s / K4 on the whole image on every ``sp`` process and takes its rows of
the result back (as the JAX package's partitioner gathers around its Pallas
scan); the gather's backward sums the processes' cotangents.
"""
import contextlib

import torch
from torch import nn

from vp_suite_tpu_torch.base.base_model_block import VPModelBlock
from vp_suite_tpu_torch.nn import remat
from vp_suite_tpu_torch.nn.functional import conv2d
from vp_suite_tpu_torch.nn.layers import Conv2d
from vp_suite_tpu_torch.ops.cells import convlstm_gate_fuse
from vp_suite_tpu_torch.ops.convlstm import convlstm_scan_fused
from vp_suite_tpu_torch.parallel import spatial
from vp_suite_tpu_torch.parallel.tensor import gather, local_param, tagged, tp_spec


class ConvLSTMShi(VPModelBlock):
    NAME = "ConvLSTM (Shi et al.)"
    PAPER_REFERENCE = "https://arxiv.org/abs/1506.04214"
    CODE_REFERENCE = "https://github.com/Hzzone/Precipitation-Nowcasting"
    MATCHES_REFERENCE = "Yes"

    def __init__(self, in_channels: int, enc_channels: int, state_h: int, state_w: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 use_fused_scan: bool = False, hoist_i2h: bool = True, remat: bool = True,
                 remat_policy: str = "gates"):
        super().__init__()
        self.in_channels = in_channels
        self.enc_channels = enc_channels
        self.state_h, self.state_w = state_h, state_w
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.use_fused_scan = use_fused_scan  #: whole recurrence in one kernel launch
        self.hoist_i2h = hoist_i2h            #: batch the input-half conv over time
        self.remat = remat                    #: checkpoint the per-step path's steps
        self.remat_policy = remat_policy      #: "gates", "scan_vjp" or any other ("full")
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
        sp = spatial.active_spatial()
        rows = slice(None)   # this process's rows of the state: all, or its sp slab's
        if sp is not None:
            r, n, _ = spatial.coordinate(*sp)
            if sh % n:
                raise ValueError(f"state height {sh} not divisible by sp={n}")
            rows, sh = slice(r * (sh // n), (r + 1) * (sh // n)), sh // n
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
        wci, wcf, wco = (p[0].permute(1, 2, 0).to(dt) for p in (self.Wci, self.Wcf, self.Wco))
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
            if sp is not None:   # the whole image on every sp process
                i2h_in = None if i2h_in is None else spatial.gather_rows(i2h_in, 2, *sp)
                h0, c0 = spatial.gather_rows(h0, 1, *sp), spatial.gather_rows(c0, 1, *sp)
            outputs, (h_last, c_last) = convlstm_scan_fused(
                i2h_in, h0, c0, self._conv.weight[:, self.in_channels:].permute(2, 3, 1, 0).to(dt),
                k_bias, *(p.contiguous() for p in (wci, wcf, wco)), seq_len=seq_len)
            if sp is not None:
                outputs = spatial.own_rows(outputs, 2, *sp)
                h_last, c_last = spatial.own_rows(h_last, 1, *sp), spatial.own_rows(c_last, 1, *sp)
        else:
            peep = tuple(p[rows].contiguous() for p in (wci, wcf, wco))
            policy = self.remat_policy if self.remat else None
            if policy == "scan_vjp" and not raw_xs:
                policy = None

            def cat(x, h):
                return torch.cat([x, h], dim=-1)

            def step(h, c, x):
                if raw_xs:
                    xh = cat(x, h)
                    with remat.recompute_saved(xh, cat, x, h) if policy == "gates" \
                            else contextlib.nullcontext():
                        gates = conv2d(xh, weight, bias, self.stride, self.padding,
                                       gather_output=False)
                else:
                    gates = conv2d(h, h_weight, bias if x is None else None, self.stride,
                                   self.padding, gather_output=False)
                    gates = gates if x is None else x + gates
                if spec is not None:
                    gates = gather(gates, spec, -1)
                if policy == "gates":
                    return remat.checkpoint(convlstm_gate_fuse, gates, c, *peep)
                return convlstm_gate_fuse(gates, c, *peep)

            h, c = h0, c0
            outs = []
            for t in range(seq_len):
                x = None if i2h_t is None else i2h_t[t]
                if policy in (None, "gates"):
                    h, c = step(h, c, x)
                else:
                    h, c = remat.checkpoint(step, h, c, x)
                outs.append(h)
            outputs, h_last, c_last = torch.stack(outs), h, c
        return outputs, (h_last, c_last)
