r"""vp-suite-tpu-torch: the PyTorch port of vp-suite-tpu, for NVIDIA Hopper.

The public boundary is the JAX package's: frames are ``[b, t, h, w, c]``,
models take ``img_shape=(c, h, w)`` and :meth:`VPSuite.predict` returns
``[b, pred, h, w, c]`` float32. Inside, parameters live in ``nn.Module`` s
with the reference vp-suite's ``state_dict`` names and layouts where it has
the model, activations stay NHWC, and the ConvLSTM and TrajGRU hot paths run
hand-written Hopper kernels (:mod:`vp_suite_tpu_torch.ops`). Ported so far:
all eleven registry models of the JAX package (EF-ConvLSTM, EF-TrajGRU,
UNet-3D, PredRNN++, PhyDNet, ST-Phy, MinConvRNN, SimVP, PredFormer, the
encoder-LSTM-decoder and the CopyLastFrame baseline) with their training
regimes (:mod:`vp_suite_tpu_torch.training`), the block registry
(:mod:`vp_suite_tpu_torch.model_blocks`), the datasets but for the three
that decode videos (on-the-fly and stored Moving MNIST, BAIR, KTH, KITTI raw,
SynPick; :mod:`vp_suite_tpu_torch.datasets`), and the facade:
:meth:`VPSuite.load_dataset`, :meth:`VPSuite.create_model`,
:meth:`VPSuite.train` (file-backed sets staged in the card's memory),
:meth:`VPSuite.load_model`, :meth:`VPSuite.test` with the whole measure set,
and :meth:`VPSuite.predict`, and its tooling: visualisation, ``hyperopt``,
``profile_dir``, ``export_model`` (:mod:`vp_suite_tpu_torch.serving`),
``load_torch_model`` (:mod:`vp_suite_tpu_torch.utils.torch_import`) and
:func:`~vp_suite_tpu_torch.utils.flops.count_flops`. The kernels are
``torch.library`` operators in the ``vp_suite_tpu_torch`` namespace.
"""
from vp_suite_tpu_torch.__about__ import __version__
from vp_suite_tpu_torch.vpsuite import VPSuite

__all__ = ["__version__", "VPSuite"]
