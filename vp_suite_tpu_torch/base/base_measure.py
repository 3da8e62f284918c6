r"""Base class for all measures (losses and metrics).

The JAX package's ``VPMeasure``: a measure is a function of ``(pred, target)``
5-D tensors ``[b, t, h, w, c]``, differentiable where it serves as a loss;
lower values mean better predictions, and ``to_display`` turns the internal
value into the measure's natural form.
"""
import contextlib

import torch


@contextlib.contextmanager
def full_precision():
    r"""Turns TF32 off for cuDNN convolutions and cuBLAS matmuls while the
    block runs, whatever the global flags say, and restores them after. The
    measures' f32 convolutions need full f32 products: SSIM's
    ``mu_xx - mu_x^2`` cancels, and the JAX package pins
    ``Precision.HIGHEST`` for the same reason."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def placed(params, cache, x):
    r"""``params`` (a dict of CPU tensors) on ``x``'s device and in its dtype,
    copied once per device and dtype and kept in ``cache``."""
    key = (x.device, x.dtype)
    if key not in cache:
        cache[key] = {k: v.to(x.device, x.dtype) for k, v in params.items()}
    return cache[key]


class VPMeasure:
    r"""Base measure. Subclasses implement :meth:`criterion` (elementwise) or
    override :meth:`forward` entirely."""

    NAME: str = NotImplemented
    REFERENCE: str = None
    BIGGER_IS_BETTER: bool = False
    OPT_VALUE: float = 0.0

    def __init__(self, device=None):
        self.device = device  #: kept for the reference API; tensors carry their device

    def criterion(self, pred, target):
        r"""Elementwise criterion; overridden by deriving classes."""
        raise NotImplementedError

    def forward(self, pred, target):
        r"""Default reduction: the elementwise criterion summed over each
        image's pixels and channels, then averaged over frames and batch.
        Expects ``[b, t, h, w, c]``."""
        if pred.dim() != 5 or target.dim() != 5:
            raise ValueError(f"{self.NAME} expects 5-D inputs!")
        return self.criterion(pred, target).sum(dim=(2, 3, 4)).mean(dim=1).mean(dim=0)

    def __call__(self, pred, target):
        return self.forward(pred, target)

    def per_frame(self, pred, target):
        r"""Optional fast path: per-(batch, frame) values ``[b, t]`` whose
        prefix means give :meth:`forward` on every horizon 1..t. Measures
        that do not decompose (FVD) return None and are evaluated per
        horizon."""
        return None

    @staticmethod
    def reshape_clamp(pred, target):
        r"""Reshapes to ``[b*t, h, w, c]`` and maps the (-1, 1) value range to
        clamped [0, 1]."""
        pred = ((pred.reshape(-1, *pred.shape[2:]) + 1.0) / 2.0).clamp(0.0, 1.0)
        target = ((target.reshape(-1, *target.shape[2:]) + 1.0) / 2.0).clamp(0.0, 1.0)
        return pred, target

    @classmethod
    def to_display(cls, x):
        r"""Converts the lower-is-better internal value to the measure's
        natural representation."""
        return x
