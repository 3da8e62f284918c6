r"""Measure registries: every ported measure doubles as a differentiable loss
and a test metric."""
from vp_suite_tpu_torch.measure.image_wise import L1, MSE, SmoothL1

_MEASURES = (
    ("mse", MSE),
    ("l1", L1),
    ("smooth_l1", SmoothL1),
)

LOSS_CLASSES = dict(_MEASURES)
AVAILABLE_LOSSES = LOSS_CLASSES.keys()
