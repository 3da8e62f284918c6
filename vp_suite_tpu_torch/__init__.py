r"""vp-suite-tpu-torch: the PyTorch port of vp-suite-tpu, for NVIDIA Hopper.

The public boundary is the JAX package's: frames are ``[b, t, h, w, c]``,
models take ``img_shape=(c, h, w)`` and :meth:`VPSuite.predict` returns
``[b, pred, h, w, c]`` float32. Inside, parameters live in ``nn.Module`` s
with the reference vp-suite's ``state_dict`` names and layouts, activations
stay NHWC, and the ConvLSTM hot path runs hand-written Hopper kernels
(:mod:`vp_suite_tpu_torch.ops`). Ported so far: EF-ConvLSTM inference.
"""
from vp_suite_tpu_torch.__about__ import __version__
from vp_suite_tpu_torch.vpsuite import VPSuite

__all__ = ["__version__", "VPSuite"]
