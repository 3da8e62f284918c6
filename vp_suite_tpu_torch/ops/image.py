r"""Image resizing on channels-last tensors.

``jax.image.resize(..., method="linear")``, which the JAX package uses, is a
bilinear resize with half-pixel centers that widens its kernel when it
shrinks an image (antialiasing); ``F.interpolate(mode="bilinear",
align_corners=False, antialias=True)`` computes the same function (without
``antialias`` a downscale samples only the two nearest rows and columns).
PyTorch's CPU build has no half-precision antialiased resize; there a bf16
or f16 image is resized in f32 and rounded once, which is what the CUDA
kernel does (it accumulates in f32). A resize to the image's own size is
the identity and returns the image.
"""
import torch
import torch.nn.functional as F


def resize_bilinear(x, size):
    r"""Resizes ``[..., h, w, c]`` to ``[..., size[0], size[1], c]``."""
    th, tw = (size, size) if isinstance(size, int) else size
    *lead, h, w, c = x.shape
    if (h, w) == (th, tw):
        return x
    y = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    half_on_cpu = y.device.type == "cpu" and y.dtype in (torch.bfloat16, torch.float16)
    y = F.interpolate(y.float() if half_on_cpu else y, size=(th, tw), mode="bilinear",
                      align_corners=False, antialias=True).to(y.dtype)
    return y.permute(0, 2, 3, 1).reshape(*lead, th, tw, c)


def resize_video(x, size):
    r"""Resizes ``[b, t, h, w, c]`` videos frame by frame."""
    return resize_bilinear(x, size)
