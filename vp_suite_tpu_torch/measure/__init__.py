r"""Measure registries: every measure doubles as a differentiable loss and a
test metric, so both registries are built from one table."""
from vp_suite_tpu_torch.measure.fvd.fvd import FrechetVideoDistance
from vp_suite_tpu_torch.measure.image_wise import L1, LPIPS, MSE, PSNR, SSIM, SmoothL1

_MEASURES = (
    ("mse", MSE),
    ("l1", L1),
    ("smooth_l1", SmoothL1),
    ("lpips", LPIPS),
    ("ssim", SSIM),
    ("psnr", PSNR),
    ("fvd", FrechetVideoDistance),
)

LOSS_CLASSES = dict(_MEASURES)
AVAILABLE_LOSSES = LOSS_CLASSES.keys()

METRIC_CLASSES = dict(_MEASURES)
AVAILABLE_METRICS = METRIC_CLASSES.keys()
