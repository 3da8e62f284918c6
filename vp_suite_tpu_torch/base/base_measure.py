r"""Base class for all measures (losses and metrics).

The JAX package's ``VPMeasure``: a measure is a function of ``(pred, target)``
5-D tensors ``[b, t, h, w, c]``, differentiable where it serves as a loss;
lower values mean better predictions, and ``to_display`` turns the internal
value into the measure's natural form.
"""


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

    @classmethod
    def to_display(cls, x):
        r"""Converts the lower-is-better internal value to the measure's
        natural representation."""
        return x
