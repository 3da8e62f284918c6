r"""UNet double convs and DCGAN convs over channels-last activations (the
JAX package's ``model_blocks/conv.py``, under the reference's ``state_dict``
names: a double conv's ``conv.0`` conv, ``conv.1`` BatchNorm, ``conv.3``
conv, ``conv.4`` BatchNorm; a DCGAN block's ``main.0`` conv and ``main.1``
GroupNorm)."""
import torch
from torch import nn

from vp_suite_tpu_torch.base.base_model_block import VPModelBlock
from vp_suite_tpu_torch.nn.functional import dcgan_step
from vp_suite_tpu_torch.nn.layers import BatchNorm, Conv2d, Conv3d, ConvTranspose2d, GroupNorm


class _DoubleConv(VPModelBlock):
    r"""(replicate-padded 3x3 conv without bias -> BatchNorm -> ReLU) x 2."""
    CONV = None

    def __init__(self, in_channels, out_channels):
        super().__init__()
        conv = self.CONV
        self.conv = nn.ModuleList([
            conv(in_channels, out_channels, 3, 1, 1, bias=False, padding_mode="replicate"),
            BatchNorm(out_channels), nn.ReLU(),
            conv(out_channels, out_channels, 3, 1, 1, bias=False, padding_mode="replicate"),
            BatchNorm(out_channels), nn.ReLU()])

    def forward(self, x, train: bool = False):
        c1, bn1, _, c2, bn2, _ = self.conv
        x = torch.relu(bn1(c1(x), train))
        return torch.relu(bn2(c2(x), train))


class DoubleConv2d(_DoubleConv):
    r"""UNet 2-D double conv on ``[b, h, w, c]``."""
    NAME = "DoubleConv2d"
    PAPER_REFERENCE = "arxiv.org/abs/1505.04597"
    CONV = Conv2d


class DoubleConv3d(_DoubleConv):
    r"""UNet 3-D double conv on ``[b, t, h, w, c]``; the BatchNorms take
    their statistics per channel over ``(b, t, h, w)``."""
    NAME = "DoubleConv3d"
    CONV = Conv3d


class DCGANConv(VPModelBlock):
    r"""DCGAN conv on ``[b, h, w, c]``: 3x3 conv -> ``GroupNorm(16)`` ->
    ``LeakyReLU(0.2)``."""
    NAME = "DCGAN - Conv"
    PAPER_REFERENCE = "arxiv.org/abs/1511.06434"
    TRANSPOSED = False

    def __init__(self, in_channels, out_channels, stride):
        super().__init__()
        self.stride = stride
        if self.TRANSPOSED:
            conv = ConvTranspose2d(in_channels, out_channels, 3, stride, 1,
                                   output_padding=int(stride == 2))
        else:
            conv = Conv2d(in_channels, out_channels, 3, stride, 1)
        self.main = nn.ModuleList([conv, GroupNorm(16, out_channels), nn.LeakyReLU(0.2)])

    def forward(self, x):
        conv, gn, _ = self.main
        return dcgan_step(x, conv.weight, conv.bias, gn.weight, gn.bias, self.stride,
                          self.TRANSPOSED)


class DCGANConvTranspose(DCGANConv):
    r"""DCGAN transposed conv on ``[b, h, w, c]``: 3x3 transposed conv (output
    padding 1 at stride 2) -> ``GroupNorm(16)`` -> ``LeakyReLU(0.2)``."""
    NAME = "DCGAN - ConvTranspose"
    TRANSPOSED = True
