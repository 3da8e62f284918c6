r"""SimVP-lite (the JAX package's ``models/simvp.py``): a fully convolutional
encoder-translator-decoder that emits ``out_frames`` frames in one forward
pass.

- Encoder, per frame (time folded into the batch): two 3x3 stride-2 convs
  ``c -> hid_s/2 -> hid_s``, each followed by GroupNorm and SiLU.
- Translator: the last ``in_frames`` context latents concatenated on
  channels (frame-major: channel ``t * hid_s + k`` is frame ``t``'s channel
  ``k``), a 1x1 ``trans_in`` to ``hid_t``, ``n_trans`` residual bottleneck
  blocks (1x1 ``red`` -> 3x3 ``mid`` -> 1x1 ``exp``, GroupNorm and SiLU after
  ``red`` and ``mid``), a 1x1 ``trans_out`` to ``out_frames * hid_s``.
- Decoder, per output frame: two k4 s2 p1 transposed convs with GroupNorm
  and SiLU, the first's output plus the last context frame's first encoder
  feature (the same for every output frame), then a 3x3 ``readout`` to ``c``.

GroupNorms take ``min(gn_groups, channels)`` groups. Horizons past
``out_frames`` roll out in chunks: each chunk reads the last ``in_frames``
frames of the context and the chunks before it. The model computes in
``compute_dtype`` and returns f32. Parameters: ``enc1``, ``enc1_gn``,
``enc2``, ``enc2_gn``, ``trans_in``, ``translator.{i}.red`` / ``.gn1`` /
``.mid`` / ``.gn2`` / ``.exp``, ``trans_out``, ``dec1``, ``dec1_gn``,
``dec2``, ``dec2_gn``, ``readout`` (torch layouts).

``remat`` checkpoints each chunk's forward under training where the horizon
takes more than one chunk, as the JAX model checkpoints its body only then
(``simvp.py:146``).
"""
import math

import torch
import torch.nn.functional as F
from torch import nn

from vp_suite_tpu_torch.base.base_model import VPModel
from vp_suite_tpu_torch.nn import remat
from vp_suite_tpu_torch.nn.layers import Conv2d, ConvTranspose2d, GroupNorm


class _Bottleneck(nn.Module):
    r"""A translator block: 1x1 reduce -> 3x3 -> 1x1 expand, with a residual."""

    def __init__(self, ht, groups):
        super().__init__()
        self.red = Conv2d(ht, ht // 2, 1)
        self.gn1 = groups(ht // 2)
        self.mid = Conv2d(ht // 2, ht // 2, 3, 1, 1)
        self.gn2 = groups(ht // 2)
        self.exp = Conv2d(ht // 2, ht, 1)

    def forward(self, z):
        y = F.silu(self.gn1(self.red(z)))
        y = F.silu(self.gn2(self.mid(y)))
        return z + self.exp(y)


class SimVP(VPModel):
    NAME = "SimVP-lite (one-shot conv translator)"
    PAPER_REFERENCE = "https://arxiv.org/abs/2206.05099"
    MATCHES_REFERENCE = "N/A (no reference analog; TPU-native extra)"

    hid_s = 64                      #: per-frame channels of the encoder and decoder
    hid_t = 256                     #: translator channels
    n_trans = 4                     #: translator blocks
    in_frames = 2                   #: context frames the translator reads (the last ones)
    out_frames = 10                 #: frames of one forward pass
    gn_groups = 8

    @property
    def MIN_CONTEXT_FRAMES(self):  # noqa: N802 (the JAX package's name)
        return self.in_frames

    def __init__(self, **hparams):
        super().__init__(**hparams)
        c, hs, ht = self.img_c, self.hid_s, self.hid_t

        def groups(ch):
            return GroupNorm(min(self.gn_groups, ch), ch)
        self.enc1 = Conv2d(c, hs // 2, 3, 2, 1)
        self.enc1_gn = groups(hs // 2)
        self.enc2 = Conv2d(hs // 2, hs, 3, 2, 1)
        self.enc2_gn = groups(hs)
        self.trans_in = Conv2d(self.in_frames * hs, ht, 1)
        self.translator = nn.ModuleList([_Bottleneck(ht, groups) for _ in range(self.n_trans)])
        self.trans_out = Conv2d(ht, self.out_frames * hs, 1)
        self.dec1 = ConvTranspose2d(hs, hs // 2, 4, 2, 1)
        self.dec1_gn = groups(hs // 2)
        self.dec2 = ConvTranspose2d(hs // 2, hs // 2, 4, 2, 1)
        self.dec2_gn = groups(hs // 2)
        self.readout = Conv2d(hs // 2, c, 3, 1, 1)

    def _one_shot(self, window):    # [b, in_frames, h, w, c] -> [b, out_frames, h, w, c] f32
        b, t_in, t_out, hs = window.shape[0], self.in_frames, self.out_frames, self.hid_s
        c, ih, iw = self.img_shape
        eh, ew = ih // 4, iw // 4
        f = window.to(self.compute_dtype).reshape(b * t_in, ih, iw, c)
        s1 = F.silu(self.enc1_gn(self.enc1(f)))                     # [b*t, h/2, w/2, hs/2]
        z = F.silu(self.enc2_gn(self.enc2(s1)))                     # [b*t, eh, ew, hs]
        z = z.reshape(b, t_in, eh, ew, hs).permute(0, 2, 3, 1, 4).reshape(b, eh, ew, t_in * hs)
        z = self.trans_in(z)
        for block in self.translator:
            z = block(z)
        z = self.trans_out(z)                                       # [b, eh, ew, t_out*hs]
        z = z.reshape(b, eh, ew, t_out, hs).permute(0, 3, 1, 2, 4).reshape(b * t_out, eh, ew, hs)
        y = F.silu(self.dec1_gn(self.dec1(z)))
        skip = s1.reshape(b, t_in, ih // 2, iw // 2, hs // 2)[:, -1]
        y = y + skip.repeat_interleave(t_out, dim=0)
        y = F.silu(self.dec2_gn(self.dec2(y)))
        return self.readout(y).float().reshape(b, t_out, ih, iw, c)

    def forward(self, x, pred_frames: int = 1, actions=None, train: bool = False, **kwargs):
        c, ih, iw = self.img_shape
        if tuple(x.shape[2:]) != (ih, iw, c):
            raise ValueError(f"input image does not match specified size "
                             f"(input: {tuple(x.shape[2:])}, required: {(ih, iw, c)})")
        if ih % 4 or iw % 4:
            raise ValueError(f"img size {(ih, iw)} must be divisible by 4")
        t_in = self.in_frames
        if x.shape[1] < t_in:
            raise ValueError(f"SimVP(in_frames={t_in}) needs at least {t_in} "
                             f"context frames, got {x.shape[1]}")
        window, preds = x[:, -t_in:], []
        # JAX checkpoints the body only when it runs more than once (simvp.py:146)
        checkpointed = self.remat and pred_frames > self.out_frames
        for _ in range(math.ceil(pred_frames / self.out_frames)):
            chunk = remat.checkpoint(self._one_shot, window) if checkpointed \
                else self._one_shot(window)
            preds.append(chunk)
            window = torch.cat([window, chunk], dim=1)[:, -t_in:]
        return torch.cat(preds, dim=1)[:, :pred_frames], None
