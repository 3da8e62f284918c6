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
The default is 0.0, as in every configuration.

``remat`` (the JAX block's, default True) checkpoints each step under
training (:mod:`vp_suite_tpu_torch.nn.remat`) with the JAX block's policy
(``traj_gru.py:124-131, 182-189``): autograd keeps the step's inputs, its
flows (``"trajgru_flows"``) and the warp tensor (``"warp_ret_warped"``), so
the backward launches neither the flow conv nor the warp forward again; it
runs the flow net's first conv, the flows' indices, the ``ret`` GEMM and the
gate math again. The keep masks are drawn before the loop, outside the
steps. The JAX block's ``scan_unroll`` has no counterpart: eager PyTorch has
no loop to unroll.

Inside ``parallel.spatial.spatial_halo_convs`` (a mesh with ``sp`` > 1) every
state and input is this process's slab of rows, as EF-ConvLSTM's cells take
them: the convs exchange halo rows, the gate math and ``ret`` are row-local,
and the warps, which read any row, sample the whole hidden state, gathered
over ``sp`` once a step (``parallel.spatial.gather_rows``; its backward sums
the image's gradient over ``sp``) and warped for this slab's pixels
(``warp_flow_ret``'s ``row0``), as XLA gathers around the JAX block's warp on
a spatial mesh. The gather runs before a step's checkpointed region, so that
``remat`` keeps the gathered state as the region's input: the recompute in the
backward gathers nothing again (it runs its halo exchanges again, in the same
order on every process).

Parameters keep the reference vp-suite's names: ``i2h``, ``i2f_conv1``,
``h2f_conv1``, ``flows_conv`` and ``ret``, torch-layout convs. f32
parameters are cast at use to the activation dtype.
"""
import torch
import torch.nn.functional as F

from vp_suite_tpu_torch.base.base_model_block import VPModelBlock
from vp_suite_tpu_torch.nn import remat
from vp_suite_tpu_torch.nn.layers import Conv2d
from vp_suite_tpu_torch.ops.grid_sample import warp_flow_ret
from vp_suite_tpu_torch.parallel import spatial

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
                 generator: torch.Generator = None, remat: bool = True):
        super().__init__()
        f = enc_channels
        self.in_channels, self.enc_channels = in_channels, enc_channels
        self.state_h, self.state_w = state_h, state_w     #: the input feature map's size
        self.zoneout, self.L, self.act_slope = zoneout, L, act_slope
        self.i2h_kernel, self.i2h_stride, self.i2h_pad = i2h_kernel, i2h_stride, i2h_pad
        self.h2h_kernel, self.h2h_dilate = h2h_kernel, h2h_dilate
        self.generator = generator  #: draws the zoneout masks that the caller does not pass
        self.remat = remat          #: checkpoint each step under training
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

        Returns ``(outputs [t, b, sh, sw, enc], next_h)``; on a spatial mesh
        every ``h``-sized tensor holds this process's ``sh / sp`` rows.
        """
        f, sh, sw = self.enc_channels, self.sh, self.sw
        sp = spatial.active_spatial()
        row0 = 0   # the image row of this process's first state row
        if sp is not None:
            r, n, _ = spatial.coordinate(*sp)
            if sh % n:
                raise ValueError(f"TrajGRU's state height {sh} is not divisible by sp={n}")
            sh //= n
            row0 = r * sh
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

        def step(h, whole, i2h_t, i2f_t, mask):
            f_conv1 = self.h2f_conv1(h)
            if i2f_t is not None:
                f_conv1 = f_conv1 + i2f_t
            flows = remat.named("trajgru_flows", self.flows_conv,
                                self._act(f_conv1))                  # [b, sh, sw, 2L]
            h2h = warp_flow_ret(whole, -flows, ret_w, self.ret.bias, row0)   # [b, sh, sw, 3f]
            hr, hu, hm = h2h.chunk(3, dim=-1)
            if i2h_t is not None:
                ir, iu, im = i2h_t.chunk(3, dim=-1)
                reset = torch.sigmoid(ir + hr)
                update = torch.sigmoid(iu + hu)
                new_mem = self._act(im + reset * hm)
            else:
                reset = torch.sigmoid(hr)
                update = torch.sigmoid(hu)
                new_mem = self._act(reset * hm)
            next_h = update * h + (1.0 - update) * new_mem
            return next_h if mask is None else torch.where(mask, h, next_h)

        h, outs = states, []
        for t in range(seq_len):
            xs = (None, None) if inputs is None else (i2h[t], i2f[t])
            mask = None if zoneout_masks is None else zoneout_masks[t]
            whole = h if sp is None else spatial.gather_rows(h, 1, *sp)   # what the warps sample
            if self.remat:
                h = remat.checkpoint(step, h, whole, *xs, mask,
                                     saved=("trajgru_flows", "warp_ret_warped"))
            else:
                h = step(h, whole, *xs, mask)
            outs.append(h)
        return torch.stack(outs), h
