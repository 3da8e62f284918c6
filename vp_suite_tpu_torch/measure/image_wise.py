r"""Image-wise measures: MSE, L1, SmoothL1, PSNR, SSIM and LPIPS, on
``[b, t, h, w, c]`` tensors, as in the JAX package. Each has ``per_frame``,
the ``[b, t]`` values whose prefix means give every prediction horizon.

SSIM is the JAX package's windowed SSIM (separable 11x11 Gaussian, sigma 1.5,
VALID); LPIPS is the port's AlexNet-feature net
(:mod:`vp_suite_tpu_torch.measure.lpips_net`). Both run their convolutions
without TF32 (:func:`~vp_suite_tpu_torch.base.base_measure.full_precision`).
"""
import torch
import torch.nn.functional as F

from vp_suite_tpu_torch.base.base_measure import VPMeasure, full_precision
from vp_suite_tpu_torch.ops.image import resize_bilinear


class MSE(VPMeasure):
    r"""Pixel-wise squared error."""
    NAME = "Mean Squared Error (MSE) / L2 Loss"

    def criterion(self, pred, target):
        d = pred - target
        return d * d

    def per_frame(self, pred, target):
        return self.criterion(pred, target).sum(dim=(2, 3, 4))


class L1(VPMeasure):
    r"""Pixel-wise absolute error."""
    NAME = "Mean Absolute Error (MAE) / L1 Loss"

    def criterion(self, pred, target):
        return (pred - target).abs()

    def per_frame(self, pred, target):
        return self.criterion(pred, target).sum(dim=(2, 3, 4))


class SmoothL1(VPMeasure):
    r"""Huber-style smooth L1 with beta=1 (``nn.SmoothL1Loss``'s criterion)."""
    NAME = "Smooth L1 Loss"

    def criterion(self, pred, target):
        d = (pred - target).abs()
        return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)

    def per_frame(self, pred, target):
        return self.criterion(pred, target).sum(dim=(2, 3, 4))


class PSNR(VPMeasure):
    r"""Peak signal-to-noise ratio; the internal loss is ``10 * log10(mse)``
    per frame, averaged over frames and batch, and the display negates it."""
    NAME = "Peak Signal to Noise Ratio (PSNR)"
    BIGGER_IS_BETTER = True
    OPT_VALUE = float("inf")

    def forward(self, pred, target):
        if pred.dim() != 5 or target.dim() != 5:
            raise ValueError(f"{self.NAME} expects 5-D inputs!")
        return self.per_frame(pred, target).mean(dim=1).mean(dim=0)

    def per_frame(self, pred, target):
        d = pred - target
        return torch.log10((d * d).mean(dim=(-1, -2, -3))) * 10.0

    @classmethod
    def to_display(cls, x):
        return -x


def _gaussian_kernel(size=11, sigma=1.5, dtype=torch.float32):
    coords = torch.arange(size, dtype=dtype) - (size - 1) / 2.0
    g = torch.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def ssim_per_image(pred, target, kernel_size=11, sigma=1.5, value_range=1.0, k1=0.01, k2=0.03):
    r"""Windowed SSIM of ``[n, h, w, c]`` images (a separable depthwise
    Gaussian window, VALID); returns the per-image SSIM ``[n]``."""
    c1 = (k1 * value_range) ** 2
    c2 = (k2 * value_range) ** 2
    c = pred.shape[-1]
    # the window is made on the host, so every device blurs with the same weights
    win = _gaussian_kernel(kernel_size, sigma, pred.dtype).to(pred.device)
    kh = win.reshape(1, 1, kernel_size, 1).expand(c, 1, kernel_size, 1)
    kw = win.reshape(1, 1, 1, kernel_size).expand(c, 1, 1, kernel_size)

    def blur(x):   # [n, c, h, w]: rows, then columns
        return F.conv2d(F.conv2d(x, kh, groups=c), kw, groups=c)

    x, y = pred.permute(0, 3, 1, 2), target.permute(0, 3, 1, 2)
    with full_precision():
        mu_x, mu_y = blur(x), blur(y)
        mu_xx, mu_yy, mu_xy = blur(x * x), blur(y * y), blur(x * y)
    sigma_x = mu_xx - mu_x * mu_x
    sigma_y = mu_yy - mu_y * mu_y
    sigma_xy = mu_xy - mu_x * mu_y
    num = (2.0 * mu_x * mu_y + c1) * (2.0 * sigma_xy + c2)
    den = (mu_x * mu_x + mu_y * mu_y + c1) * (sigma_x + sigma_y + c2)
    return (num / den).mean(dim=(1, 2, 3))


class SSIM(VPMeasure):
    r"""Structural similarity, computed in f32; the internal loss is
    ``1 - SSIM``. ``forward`` needs 3-channel images; ``per_frame`` takes any
    channel count, as the JAX package's does."""
    NAME = "Structural Similarity (SSIM)"
    REFERENCE = "https://ieeexplore.ieee.org/document/1284395"
    BIGGER_IS_BETTER = True
    OPT_VALUE = 1

    def forward(self, pred, target):
        if pred.shape[-1] != 3 or target.shape[-1] != 3:
            raise ValueError(f"{self.NAME} needs 3-channel images (channels last)")
        pred, target = self.reshape_clamp(pred.float(), target.float())
        return 1.0 - ssim_per_image(pred, target).mean()

    def per_frame(self, pred, target):
        b, t = pred.shape[:2]
        p, tg = self.reshape_clamp(pred.float(), target.float())
        return 1.0 - ssim_per_image(p, tg).reshape(b, t)

    @classmethod
    def to_display(cls, x):
        return 1.0 - x


class LPIPS(VPMeasure):
    r"""Learned Perceptual Image Patch Similarity over AlexNet features, in
    the prediction's dtype. Images under 64 px a side are first upscaled to
    64 (AlexNet's features need that much). Needs 3-channel images."""
    NAME = "Learned Perceptual Image Patch Similarity (LPIPS)"
    REFERENCE = "https://arxiv.org/abs/1801.03924"

    def __init__(self, device=None):
        super().__init__(device)
        from vp_suite_tpu_torch.measure.lpips_net import LPIPSNet
        self.net = LPIPSNet()

    def _images(self, pred, target):
        if pred.shape[-1] != 3 or target.shape[-1] != 3:
            raise ValueError(f"{self.NAME} needs 3-channel images (channels last)")
        p, tg = self.reshape_clamp(pred, target)
        if p.shape[1] < 64 or p.shape[2] < 64:
            p = resize_bilinear(p, (max(64, p.shape[1]), max(64, p.shape[2])))
            tg = resize_bilinear(tg, (max(64, tg.shape[1]), max(64, tg.shape[2])))
        return p, tg

    def forward(self, pred, target):
        return self.net(*self._images(pred, target))

    def per_frame(self, pred, target):
        b, t = pred.shape[:2]
        return self.net.per_image(*self._images(pred, target)).reshape(b, t)
