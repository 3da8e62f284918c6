r"""Model registry of the port (the JAX package's ids; EF-ConvLSTM,
EF-TrajGRU, UNet-3D, PredRNN++ and the CopyLastFrame baseline are ported so
far; LSTM, PhyDNet, ST-Phy, MinConvRNN, PredFormer and SimVP are not)."""
import torch

from vp_suite_tpu_torch.models.copy_last_frame import CopyLastFrame
from vp_suite_tpu_torch.models.precipitation_nowcasting.ef_conv_lstm import EF_ConvLSTM
from vp_suite_tpu_torch.models.precipitation_nowcasting.ef_traj_gru import EF_TrajGRU
from vp_suite_tpu_torch.models.predrnn_v2 import PredRNN_V2
from vp_suite_tpu_torch.models.unet3d import UNet3D

MODEL_CLASSES = {
    "copy": CopyLastFrame,
    "unet-3d": UNet3D,
    "convlstm-shi": EF_ConvLSTM,
    "trajgru": EF_TrajGRU,
    "predrnn-pp": PredRNN_V2,
}
AVAILABLE_MODELS = MODEL_CLASSES.keys()


def build_model(model_id: str, seed: int, device, **model_kwargs):
    r"""The registry model ``model_id`` with parameters drawn from a
    ``torch.Generator`` seeded with ``seed`` on the CPU (torch's global RNG
    is not touched), moved to ``device``, in eval mode. ``reset_parameters``
    sets every parameter and buffer: ``to_empty`` leaves them uninitialised."""
    with torch.device("meta"):
        model = MODEL_CLASSES[model_id](**model_kwargs)
    model = model.to_empty(device="cpu")
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device).eval()
