r"""NHWC convolution helpers with torch ``Conv2d`` / ``ConvTranspose2d``
semantics.

Activations stay NHWC (``[n, h, w, c]``, contiguous) across the port, which is
the layout the kernels take. ``x.permute(0, 3, 1, 2)`` of such a tensor is an
NCHW view in ``channels_last`` memory format, so cuDNN runs its NHWC kernels
and the result permutes back without a copy. Weights keep torch's layouts
(conv ``[out, in, kh, kw]``, convT ``[in, out, kh, kw]``) and are cast to the
activation dtype at use, so f32 params serve bf16 activations.
"""
import torch.nn.functional as F


def conv2d(x, weight, bias=None, stride=1, padding=0):
    r"""NHWC conv: ``x`` ``[n, h, w, in]``, ``weight`` ``[out, in, kh, kw]``."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype),
                 None if bias is None else bias.to(x.dtype), stride, padding)
    return y.permute(0, 2, 3, 1).contiguous()


def conv_transpose2d(x, weight, bias=None, stride=1, padding=0, output_padding=0):
    r"""NHWC transposed conv: ``x`` ``[n, h, w, in]``, ``weight`` ``[in, out, kh, kw]``."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), weight.to(x.dtype),
                           None if bias is None else bias.to(x.dtype), stride, padding,
                           output_padding)
    return y.permute(0, 2, 3, 1).contiguous()
