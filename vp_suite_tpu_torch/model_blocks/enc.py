r"""Encoder, decoder and autoencoder blocks over channels-last activations
(the JAX package's ``model_blocks/enc.py``), under the reference vp-suite's
``state_dict`` names: ``Encoder``'s ``conv1``, ``conv2``, ``mean_layer``,
``Decoder``'s ``fc1``, ``conv1``, ``conv2``, ``conv3``, an ``Autoencoder``'s
``encoder`` and ``decoder``, the DCGAN blocks' ``c{i}`` and ``upc{i}``.

The reference sizes an autoencoder's code by running zeros through its
encoder; here it is conv arithmetic (``Autoencoder.encoded_shape``). The
decoders end in ``resize_bilinear`` (antialiased, as ``jax.image.resize``).
"""
from vp_suite_tpu_torch.base.base_model_block import VPModelBlock
from vp_suite_tpu_torch.model_blocks.conv import DCGANConv, DCGANConvTranspose
from vp_suite_tpu_torch.nn.layers import Conv2d, ConvTranspose2d
from vp_suite_tpu_torch.ops.image import resize_bilinear
from vp_suite_tpu_torch.utils.models import conv_output_shape


class Encoder(VPModelBlock):
    r"""5x5/s2 -> 3x3/s2 -> 3x3/s1 convs without padding, each with a ReLU,
    then an L2 normalization over the width axis (the reference normalizes
    the last axis of NCHW), with a floor of 1e-8."""
    NAME = "Encoder"

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.conv1 = Conv2d(in_channels, 32, 5, 2, 0)
        self.conv2 = Conv2d(32, 64, 3, 2, 0)
        self.mean_layer = Conv2d(64, out_channels, 3, 1, 0)

    def forward(self, x):
        x = self.conv1(x).relu()
        x = self.conv2(x).relu()
        x = self.mean_layer(x).relu()
        return x / x.square().sum(dim=-2, keepdim=True).sqrt().clamp_min(1e-8)


class Decoder(VPModelBlock):
    r"""A 1x1 conv, transposed convs 6x6/s2 -> 6x6/s2 -> 5x5/s1 (ReLUs
    between), then a resize to ``out_shape`` ``(c, h, w)``."""
    NAME = "Decoder"

    def __init__(self, in_channels, out_shape):
        super().__init__()
        self.out_shape = tuple(out_shape)
        self.fc1 = Conv2d(in_channels, in_channels, 1, 1, 0)
        self.conv1 = ConvTranspose2d(in_channels, 64, 6, 2, 0)
        self.conv2 = ConvTranspose2d(64, 32, 6, 2, 0)
        self.conv3 = ConvTranspose2d(32, self.out_shape[0], 5, 1, 0)

    def forward(self, x):
        x = self.fc1(x).relu()
        x = self.conv1(x).relu()
        x = self.conv2(x).relu()
        return resize_bilinear(self.conv3(x), self.out_shape[1:])


class Autoencoder(VPModelBlock):
    r""":class:`Encoder` and :class:`Decoder` for images of ``img_shape``
    ``(c, h, w)`` and codes of ``encoded_channels``."""
    NAME = "Autoencoder"

    def __init__(self, img_shape, encoded_channels):
        super().__init__()
        self.img_shape = tuple(img_shape)
        self.encoded_channels = encoded_channels
        self.encoder = Encoder(img_shape[0], encoded_channels)
        self.decoder = Decoder(encoded_channels, img_shape)

    @property
    def encoded_shape(self):
        r"""``(1, encoded_channels, h, w)`` of a code, the reference's ordering."""
        hw = self.img_shape[1:]
        for k, s in ((5, 2), (3, 2), (3, 1)):
            hw = conv_output_shape(hw, k, s, 0)
        return (1, self.encoded_channels, *hw)

    def encode(self, x):
        return self.encoder(x)

    def decode(self, x):
        return self.decoder(x)

    def forward(self, x):
        return self.decode(self.encode(x))


class DCGANEncoder(VPModelBlock):
    r"""DCGAN convs at strides 2, 1, 2 (``c1``-``c3``): a quarter of the size,
    ``2 * enc_channels`` channels."""
    NAME = "DCGAN Encoder"
    PAPER_REFERENCE = "arxiv.org/abs/1511.06434"

    def __init__(self, img_channels=1, enc_channels=32):
        super().__init__()
        self.c1 = DCGANConv(img_channels, enc_channels, 2)
        self.c2 = DCGANConv(enc_channels, enc_channels, 1)
        self.c3 = DCGANConv(enc_channels, 2 * enc_channels, 2)

    def forward(self, x):
        return self.c3(self.c2(self.c1(x)))


class DCGANDecoder(VPModelBlock):
    r"""DCGAN transposed convs at strides 2 and 1 (``upc1``, ``upc2``), a 3x3/s2
    transposed conv to ``img_channels`` (``upc3``), then a resize to
    ``out_size`` ``(h, w)``."""
    NAME = "DCGAN Decoder"
    PAPER_REFERENCE = "arxiv.org/abs/1511.06434"

    def __init__(self, out_size, img_channels=1, enc_channels=32):
        super().__init__()
        self.out_size = tuple(out_size)
        self.upc1 = DCGANConvTranspose(2 * enc_channels, enc_channels, 2)
        self.upc2 = DCGANConvTranspose(enc_channels, enc_channels, 1)
        self.upc3 = ConvTranspose2d(enc_channels, img_channels, 3, 2, 1, output_padding=1)

    def forward(self, x):
        return resize_bilinear(self.upc3(self.upc2(self.upc1(x))), self.out_size)


class EncoderSplit(VPModelBlock):
    r"""PhyDNet's branch encoder: two DCGAN convs at stride 1 (``c1``, ``c2``)."""
    NAME = "EncoderSplit"

    def __init__(self, in_channels=64, enc_channels=64):
        super().__init__()
        self.c1 = DCGANConv(in_channels, enc_channels, 1)
        self.c2 = DCGANConv(enc_channels, enc_channels, 1)

    def forward(self, x):
        return self.c2(self.c1(x))


class DecoderSplit(VPModelBlock):
    r"""PhyDNet's branch decoder: two DCGAN transposed convs at stride 1
    (``upc1``, ``upc2``)."""
    NAME = "DecoderSplit"

    def __init__(self, out_channels=64, enc_channels=64):
        super().__init__()
        self.upc1 = DCGANConvTranspose(enc_channels, enc_channels, 1)
        self.upc2 = DCGANConvTranspose(enc_channels, out_channels, 1)

    def forward(self, x):
        return self.upc2(self.upc1(x))

