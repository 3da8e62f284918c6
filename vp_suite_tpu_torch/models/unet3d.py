r"""UNet-3D (the JAX package's ``models/unet3d.py``): a 3-D conv UNet over the
last ``temporal_dim`` frames that predicts one frame, rolled out
autoregressively.

The down path runs DoubleConv3d blocks on ``[b, td, h, w, c]``, each
followed by a time-collapsing ``(td, 1, 1)`` Conv3d skip and a 2x2 max pool;
one more such conv collapses time before the 2-D bottleneck; the up path is
transposed convs and DoubleConv2d blocks over the skips (bilinear resize
where a size was floored on the way down). With ``action_conditional``, each
level's input and the bottleneck's gain the window's actions inflated to
that level's size by a linear layer. The parameters keep the reference's
``state_dict`` names (``downs``, ``time3ds`` with the bottleneck's conv
last, ``action_inflates``, ``bottleneck_action_inflate``, ``bottleneck``,
``ups`` alternating transposed conv and double conv, ``final_conv``).
"""
import torch
from torch import nn

from vp_suite_tpu_torch.base.base_model import VPModel
from vp_suite_tpu_torch.model_blocks.conv import DoubleConv2d, DoubleConv3d
from vp_suite_tpu_torch.nn.layers import Conv2d, Conv3d, ConvTranspose2d, Dense, max_pool_2d
from vp_suite_tpu_torch.ops.image import resize_bilinear


class UNet3D(VPModel):
    NAME = "UNet-3D"
    REQUIRED_ARGS = ["img_shape", "action_size", "tensor_value_range", "temporal_dim"]
    CAN_HANDLE_ACTIONS = True

    features = (8, 16, 32, 64)
    temporal_dim = None

    @property
    def MIN_CONTEXT_FRAMES(self):  # noqa: N802 (the JAX package's name)
        return self.temporal_dim

    def __init__(self, **hparams):
        super().__init__(**hparams)
        if self.temporal_dim is None:
            raise ValueError("UNet-3D needs 'temporal_dim'")
        feats, td = list(self.features), self.temporal_dim
        a = self.action_size if self.action_conditional else 0
        ins = [self.img_c] + feats[:-1]
        self.downs = nn.ModuleList([DoubleConv3d(i + a, f) for i, f in zip(ins, feats)])
        self.time3ds = nn.ModuleList([Conv3d(f, f, (td, 1, 1)) for f in feats + feats[-1:]])
        self.bottleneck = DoubleConv2d(feats[-1] + a, 2 * feats[-1])
        ups, up_in = [], 2 * feats[-1]
        for f in reversed(feats):
            ups += [ConvTranspose2d(up_in, f, 2, 2), DoubleConv2d(2 * f, f)]
            up_in = f
        self.ups = nn.ModuleList(ups)
        self.final_conv = Conv2d(feats[0], self.img_c, 1)
        if self.action_conditional:
            h, w = self.img_h, self.img_w
            inflates = []
            for _ in feats:
                inflates.append(Dense(a, a * h * w))
                h, w = h // 2, w // 2
            self.action_inflates = nn.ModuleList(inflates)
            self.bottleneck_action_inflate = Dense(a, a * h * w)

    def pred_1(self, x, actions=None, train: bool = False, **kwargs):
        r"""``x`` ``[b, t >= temporal_dim, h, w, c]`` -> ``[b, h, w, c]``, from
        the last ``temporal_dim`` frames (and the actions of those steps)."""
        t_in, td = x.shape[1], self.temporal_dim
        cur = x[:, -td:]
        b = cur.shape[0]
        if self.action_conditional:
            if actions is None or actions.dim() != 3 or actions.shape[-1] != self.action_size:
                raise ValueError("Given actions are None or of the wrong size!")
            acts = actions[:, t_in - td:t_in]
        skips = []
        for i, (down, time3d) in enumerate(zip(self.downs, self.time3ds)):
            if self.action_conditional:
                hh, ww = cur.shape[2:4]
                inflated = self.action_inflates[i](acts)
                inflated = inflated.reshape(b, td, self.action_size, hh, ww).permute(0, 1, 3, 4, 2)
                cur = torch.cat([cur, inflated], dim=-1)
            cur = down(cur, train)                   # [b, td, h, w, f]
            skips.append(time3d(cur)[:, 0])          # [b, h, w, f]
            cur = max_pool_2d(cur)
        cur = self.time3ds[-1](cur)[:, 0]
        if self.action_conditional:
            inflated = self.bottleneck_action_inflate(acts[:, -1])
            inflated = inflated.reshape(b, self.action_size, *cur.shape[1:3]).permute(0, 2, 3, 1)
            cur = torch.cat([cur, inflated], dim=-1)
        cur = self.bottleneck(cur, train)
        for up_t, up_c, skip in zip(self.ups[0::2], self.ups[1::2], reversed(skips)):
            cur = resize_bilinear(up_t(cur), skip.shape[1:3])
            cur = up_c(torch.cat([skip, cur], dim=-1), train)
        return self.final_conv(cur)

    def forward(self, x, pred_frames: int = 1, actions=None, train: bool = False, **kwargs):
        r"""Autoregressive rollout. As in the reference, every step reads the
        actions of the ORIGINAL context window: they do not advance with the
        frames."""
        if actions is None and self.action_conditional:
            raise ValueError("action-conditional UNet3D needs actions")
        act_window = actions[:, :x.shape[1]] if self.action_conditional else None
        preds, cur = [], x
        for _ in range(pred_frames):
            pred = self.pred_1(cur, actions=act_window, train=train)[:, None]
            preds.append(pred)
            cur = torch.cat([cur[:, 1:], pred], dim=1)
        return torch.cat(preds, dim=1), None
