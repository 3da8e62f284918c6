r"""TrajGRU (Shi et al.): a GRU whose hidden-to-hidden connection follows L
learned flow trajectories.

Per step, a small conv net generates L flow fields from the hidden state (and
the input), the hidden state is warped bilinearly along each negated flow,
and a 1x1 ``ret`` conv over the L warps gives the hidden half of the three
gate pre-activations (reset, update, memory). As in the JAX package's block:

- the input-to-hidden 3-gate conv and the input half of the flow net's first
  conv run once, batched over all ``t*b`` frames, outside the time loop;
- the L warps and the ``ret`` conv run as
  :func:`vp_suite_tpu_torch.ops.grid_sample.warp_flow_ret`: the warp kernels
  (CUDA C++ on CUDA tensors) and one GEMM;
- the flow convs are 5x5 with padding 2, whatever ``h2h_kernel`` and
  ``h2h_dilate`` say (the JAX block fixes them and ignores both);
- the gate math is plain PyTorch, as the JAX package leaves it to XLA;
- zero-input decode mode (``inputs=None``) and time-major ``[t, b, ...]``
  sequences (the Encoder-Forecaster stack, the block's only user, runs
  time-major end to end; the JAX block's ``time_major=True``).

Zoneout keeps the JAX package's intended semantics (the reference's branch
is inert): with probability ``zoneout`` per step, item and channel the block
keeps its previous hidden state. The keep masks ``[t, b, 1, 1, enc]`` are
passed in or drawn from ``generator`` (an explicit ``torch.Generator``;
zoneout > 0 without either raises, as the JAX block needs its ``zoneout`` rng).
The default is 0.0, as in every configuration. The JAX block's ``remat`` and
``scan_unroll`` steer XLA and have no counterpart in eager PyTorch; the warp
tensor is saved under autograd as its remat policy saves it.

Parameters keep the reference vp-suite's names: ``i2h``, ``i2f_conv1``,
``h2f_conv1``, ``flows_conv`` and ``ret``, torch-layout convs. f32
parameters are cast at use to the activation dtype.
"""
import torch
import torch.nn.functional as F

from vp_suite_tpu_torch.base.base_model_block import VPModelBlock
from vp_suite_tpu_torch.nn.layers import Conv2d
from vp_suite_tpu_torch.ops.grid_sample import warp_flow_ret

FLOW_HIDDEN = 32    #: channels of the flow net's first conv (the reference's)
FLOW_KERNEL = 5     #: the flow net's kernel (padding 2)


def conv_rnn_state_size(in_h, in_w, i2h_kernel, i2h_stride, i2h_pad, i2h_dilate=(1, 1)):
    r"""State size from the i2h conv arithmetic (reference ``traj_gru.py:58-65``)."""
    kh = 1 + (i2h_kernel[0] - 1) * i2h_dilate[0]
    kw = 1 + (i2h_kernel[1] - 1) * i2h_dilate[1]
    sh = (in_h + 2 * i2h_pad[0] - kh) // i2h_stride[0] + 1
    sw = (in_w + 2 * i2h_pad[1] - kw) // i2h_stride[1] + 1
    return sh, sw


class TrajGRU(VPModelBlock):
    NAME = "TrajGRU"
    PAPER_REFERENCE = "https://arxiv.org/abs/1706.03458"
    CODE_REFERENCE = "https://github.com/Hzzone/Precipitation-Nowcasting"
    MATCHES_REFERENCE = "Yes"

    def __init__(self, in_channels: int, enc_channels: int, state_h: int, state_w: int,
                 zoneout: float = 0.0, L: int = 5, i2h_kernel=(3, 3), i2h_stride=(1, 1),
                 i2h_pad=(1, 1), h2h_kernel=(5, 5), h2h_dilate=(1, 1), act_slope: float = 0.2,
                 generator: torch.Generator = None):
        super().__init__()
        f = enc_channels
        self.in_channels, self.enc_channels = in_channels, enc_channels
        self.state_h, self.state_w = state_h, state_w     #: the input feature map's size
        self.zoneout, self.L, self.act_slope = zoneout, L, act_slope
        self.i2h_kernel, self.i2h_stride, self.i2h_pad = i2h_kernel, i2h_stride, i2h_pad
        self.h2h_kernel, self.h2h_dilate = h2h_kernel, h2h_dilate
        self.generator = generator  #: draws the zoneout masks that the caller does not pass
        self.sh, self.sw = conv_rnn_state_size(state_h, state_w, i2h_kernel, i2h_stride, i2h_pad)
        pad = FLOW_KERNEL // 2
        self.i2h = Conv2d(in_channels, 3 * f, i2h_kernel, i2h_stride, i2h_pad)
        self.i2f_conv1 = Conv2d(in_channels, FLOW_HIDDEN, FLOW_KERNEL, 1, pad)
        self.h2f_conv1 = Conv2d(f, FLOW_HIDDEN, FLOW_KERNEL, 1, pad)
        self.flows_conv = Conv2d(FLOW_HIDDEN, 2 * L, FLOW_KERNEL, 1, pad)
        self.ret = Conv2d(f * L, 3 * f, 1, 1, 0)

    def _act(self, x):
        return F.leaky_relu(x, negative_slope=self.act_slope)

    def _zoneout_masks(self, seq_len, b, device):
        if self.generator is None:
            raise ValueError("TrajGRU with zoneout > 0 needs keep masks or a generator to draw "
                             "them from")
        draw = torch.rand((seq_len, b, 1, 1, self.enc_channels), generator=self.generator,
                          device=self.generator.device)
        return (draw < self.zoneout).to(device)

    def forward(self, inputs, states, seq_len: int, zoneout_masks=None):
        r"""Runs the cell over a sequence.

        Args:
            inputs: ``[t, b, h, w, in_c]`` or None (decode mode: zero inputs).
            states: ``[b, sh, sw, enc]`` or None (zero init).
            seq_len: number of steps (equal to t when inputs are given).
            zoneout_masks: ``[t, b, 1, 1, enc]`` bool keep masks (True keeps
                the previous hidden state), or None: drawn from ``generator``
                when ``zoneout > 0``, none otherwise.

        Returns ``(outputs [t, b, sh, sw, enc], next_h)``.
        """
        f, sh, sw = self.enc_channels, self.sh, self.sw
        if inputs is None and states is None:
            raise ValueError("TrajGRU received 'None' both in input and state")
        if states is None:
            states = inputs.new_zeros((inputs.shape[1], sh, sw, f))
        b = states.shape[0]
        if inputs is not None:
            x_flat = inputs.reshape(-1, *inputs.shape[2:])
            i2h = self.i2h(x_flat).reshape(seq_len, b, sh, sw, 3 * f)
            i2f = self.i2f_conv1(x_flat)
            i2f = i2f.reshape(seq_len, b, *i2f.shape[1:])
        if zoneout_masks is None and self.zoneout > 0.0:
            zoneout_masks = self._zoneout_masks(seq_len, b, states.device)

        # ret's kernel [3f, L*f, 1, 1] as the GEMM operand [L*f, 3f]; input
        # channel l*f + k is channel k of warp l, the warps' flattened order
        ret_w = self.ret.weight.view(3 * f, self.L * f).t()
        h, outs = states, []
        for t in range(seq_len):
            f_conv1 = self.h2f_conv1(h)
            if inputs is not None:
                f_conv1 = f_conv1 + i2f[t]
            flows = self.flows_conv(self._act(f_conv1))          # [b, sh, sw, 2L]
            h2h = warp_flow_ret(h, -flows, ret_w, self.ret.bias)  # [b, sh, sw, 3f]
            hr, hu, hm = h2h.chunk(3, dim=-1)
            if inputs is not None:
                ir, iu, im = i2h[t].chunk(3, dim=-1)
                reset = torch.sigmoid(ir + hr)
                update = torch.sigmoid(iu + hu)
                new_mem = self._act(im + reset * hm)
            else:
                reset = torch.sigmoid(hr)
                update = torch.sigmoid(hu)
                new_mem = self._act(reset * hm)
            next_h = update * h + (1.0 - update) * new_mem
            if zoneout_masks is not None:
                next_h = torch.where(zoneout_masks[t], h, next_h)
            outs.append(next_h)
            h = next_h
        return torch.stack(outs), h
