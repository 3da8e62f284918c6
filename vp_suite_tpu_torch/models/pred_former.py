r"""PredFormer-lite (the JAX package's ``models/pred_former.py``): a factorized
space-time transformer over patch tokens that predicts one frame at a time.

Each frame is cut into ``patch_size`` patches (rows of patches, each patch
row-major with channels last) and embedded by one linear layer (``embed``)
into ``[b, t, n, dim]`` tokens; learned spatial and temporal position
embeddings (``pos_spatial``, ``pos_temporal``, the latter ``max_frames``
long and sliced to the context) are added, then ``depth`` pre-LN blocks
(``blocks.{i}``) run spatial attention over the tokens of each frame,
temporal attention over the frames at each site, and a GELU MLP, each with
a residual. The last frame's tokens go through ``ln_out`` and ``head`` back
to pixels. The rollout shifts its window in token space: each prediction is
embedded once (its ``compute_dtype`` value, before the f32 cast of the
output) and appended, the oldest frame's tokens dropped; nothing is
re-encoded.

The layers are flax's (:mod:`~vp_suite_tpu_torch.model_blocks.transformer`:
LayerNorm with epsilon 1e-6 and f32 statistics, lecun-normal Dense,
attention with the query scaled before the product and the softmax in the
compute dtype); GELU is the tanh approximation (``jax.nn.gelu``'s default).
Every layer computes in ``compute_dtype``; the output is f32. ``remat``
checkpoints each block under training, as the JAX model wraps each in
``nn.remat`` (``pred_former.py:102``).
"""
import torch
import torch.nn.functional as F
from torch import nn

from vp_suite_tpu_torch.base.base_model import VPModel
from vp_suite_tpu_torch.nn import remat
from vp_suite_tpu_torch.model_blocks.transformer import (LayerNorm, LecunDense,
                                                         MultiHeadDotProductAttention)


class _Block(nn.Module):
    r"""Pre-LN factorized space-time block on ``[b, t, n, d]``."""

    def __init__(self, dim, heads, mlp_ratio):
        super().__init__()
        self.ln_s = LayerNorm(dim)
        self.attn_s = MultiHeadDotProductAttention(dim, heads)
        self.ln_t = LayerNorm(dim)
        self.attn_t = MultiHeadDotProductAttention(dim, heads)
        self.ln_m = LayerNorm(dim)
        self.mlp1 = LecunDense(dim, dim * mlp_ratio)
        self.mlp2 = LecunDense(dim * mlp_ratio, dim)

    def forward(self, x):
        b, t, n, d = x.shape
        y = self.attn_s(self.ln_s(x).reshape(b * t, n, d))           # over n within each frame
        x = x + y.reshape(b, t, n, d)
        y = self.ln_t(x).transpose(1, 2).reshape(b * n, t, d)        # over t at each site
        x = x + self.attn_t(y).reshape(b, n, t, d).transpose(1, 2)
        y = self.mlp1(self.ln_m(x))
        return x + self.mlp2(F.gelu(y, approximate="tanh"))


class PredFormer(VPModel):
    NAME = "PredFormer-lite (space-time transformer)"
    PAPER_REFERENCE = "https://arxiv.org/abs/2103.15691"
    MATCHES_REFERENCE = "N/A (no reference analog; TPU-native extra)"

    patch_size = 8
    dim = 256
    depth = 4
    heads = 4
    mlp_ratio = 4
    max_frames = 32                 #: temporal position embeddings (the longest context)

    def __init__(self, **hparams):
        super().__init__(**hparams)
        c, ih, iw = self.img_shape
        p, d = self.patch_size, self.dim
        n = (ih // p) * (iw // p)
        self.embed = LecunDense(p * p * c, d)
        self.blocks = nn.ModuleList([_Block(d, self.heads, self.mlp_ratio)
                                     for _ in range(self.depth)])
        self.ln_out = LayerNorm(d)
        self.head = LecunDense(d, p * p * c)
        self.pos_spatial = nn.Parameter(torch.empty(1, 1, n, d))
        self.pos_temporal = nn.Parameter(torch.empty(1, self.max_frames, 1, d))

    def reset_parameters(self, generator=None):
        super().reset_parameters(generator)
        with torch.no_grad():
            self.pos_spatial.normal_(0.0, 0.02, generator=generator)
            self.pos_temporal.normal_(0.0, 0.02, generator=generator)

    def _patch_embed(self, frames):  # [b, t, h, w, c] -> [b, t, n, dim]
        b, t, ih, iw, c = frames.shape
        p = self.patch_size
        z = frames.to(self.compute_dtype).reshape(b, t, ih // p, p, iw // p, p, c)
        return self.embed(z.transpose(3, 4).reshape(b, t, -1, p * p * c))

    def _predict_next(self, window):  # tokens [b, t, n, dim] -> [b, h, w, c]
        dt, p = self.compute_dtype, self.patch_size
        c, ih, iw = self.img_shape
        z = window + self.pos_spatial.to(dt) + self.pos_temporal[:, :window.shape[1]].to(dt)
        for block in self.blocks:
            z = remat.checkpoint(block, z) if self.remat else block(z)
        y = self.head(self.ln_out(z[:, -1]))                          # [b, n, p*p*c]
        y = y.reshape(-1, ih // p, iw // p, p, p, c).transpose(2, 3)
        return y.reshape(-1, ih, iw, c)

    def forward(self, x, pred_frames: int = 1, actions=None, train: bool = False, **kwargs):
        t_in = x.shape[1]
        c, ih, iw = self.img_shape
        if tuple(x.shape[2:]) != (ih, iw, c):
            raise ValueError(f"input image does not match specified size "
                             f"(input: {tuple(x.shape[2:])}, required: {(ih, iw, c)})")
        p = self.patch_size
        if ih % p or iw % p:
            raise ValueError(f"img size {(ih, iw)} must divide patch_size {p}")
        if t_in > self.max_frames:
            raise ValueError(f"context {t_in} exceeds max_frames {self.max_frames}")
        window, preds = self._patch_embed(x), []
        for _ in range(pred_frames):
            nxt = self._predict_next(window)
            preds.append(nxt.float())
            window = torch.cat([window[:, 1:], self._patch_embed(nxt[:, None])], dim=1)
        return torch.stack(preds, dim=1), None
