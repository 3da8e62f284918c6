r"""Package metadata for vp-suite-tpu-torch, the PyTorch and CUDA port of
vp-suite-tpu for NVIDIA Hopper cards."""

__title__ = "vp-suite-tpu-torch"
__summary__ = "The PyTorch/CUDA port of vp-suite-tpu: video prediction on NVIDIA Hopper"
__version__ = "0.1.0"
__author__ = "vp-suite-tpu developers"
__license__ = "MIT"
