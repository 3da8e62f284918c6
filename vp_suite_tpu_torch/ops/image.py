r"""Image resizing on channels-last tensors.

``jax.image.resize(..., method="linear")``, which the JAX package uses, is a
bilinear resize with half-pixel centers that widens its kernel when it
shrinks an image (antialiasing); ``F.interpolate(mode="bilinear",
align_corners=False, antialias=True)`` computes the same function (without
``antialias`` a downscale samples only the two nearest rows and columns).
"""
import torch.nn.functional as F


def resize_bilinear(x, size):
    r"""Resizes ``[..., h, w, c]`` to ``[..., size[0], size[1], c]``."""
    th, tw = (size, size) if isinstance(size, int) else size
    *lead, h, w, c = x.shape
    y = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.interpolate(y, size=(th, tw), mode="bilinear", align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).reshape(*lead, th, tw, c)


def resize_video(x, size):
    r"""Resizes ``[b, t, h, w, c]`` videos frame by frame."""
    return resize_bilinear(x, size)
