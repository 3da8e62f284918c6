r"""Image-wise measures: MSE, L1 and SmoothL1 (PSNR, SSIM and LPIPS are not
ported yet), on ``[b, t, h, w, c]`` tensors, as in the JAX package."""
import torch

from vp_suite_tpu_torch.base.base_measure import VPMeasure


class MSE(VPMeasure):
    r"""Pixel-wise squared error."""
    NAME = "Mean Squared Error (MSE) / L2 Loss"

    def criterion(self, pred, target):
        d = pred - target
        return d * d


class L1(VPMeasure):
    r"""Pixel-wise absolute error."""
    NAME = "Mean Absolute Error (MAE) / L1 Loss"

    def criterion(self, pred, target):
        return (pred - target).abs()


class SmoothL1(VPMeasure):
    r"""Huber-style smooth L1 with beta=1 (``nn.SmoothL1Loss``'s criterion)."""
    NAME = "Smooth L1 Loss"

    def criterion(self, pred, target):
        d = (pred - target).abs()
        return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
