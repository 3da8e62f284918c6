r"""Model registry of the port: the JAX package's 11 ids (EF-ConvLSTM,
EF-TrajGRU, UNet-3D, PredRNN++, PhyDNet, ST-Phy, MinConvRNN, SimVP,
PredFormer, the encoder-LSTM-decoder and the CopyLastFrame baseline)."""
import torch

from vp_suite_tpu_torch.models.copy_last_frame import CopyLastFrame
from vp_suite_tpu_torch.models.lstm import LSTM
from vp_suite_tpu_torch.models.min_conv_rnn import MinConvRNN
from vp_suite_tpu_torch.models.precipitation_nowcasting.ef_conv_lstm import EF_ConvLSTM
from vp_suite_tpu_torch.models.precipitation_nowcasting.ef_traj_gru import EF_TrajGRU
from vp_suite_tpu_torch.models.phydnet import PhyDNet
from vp_suite_tpu_torch.models.pred_former import PredFormer
from vp_suite_tpu_torch.models.predrnn_v2 import PredRNN_V2
from vp_suite_tpu_torch.models.simvp import SimVP
from vp_suite_tpu_torch.models.st_phy import STPhy
from vp_suite_tpu_torch.models.unet3d import UNet3D

MODEL_CLASSES = {
    "copy": CopyLastFrame,
    "lstm": LSTM,
    "unet-3d": UNet3D,
    "phy": PhyDNet,
    "st-phy": STPhy,
    "convlstm-shi": EF_ConvLSTM,
    "trajgru": EF_TrajGRU,
    "predrnn-pp": PredRNN_V2,
    "min-conv-rnn": MinConvRNN,
    "pred-former": PredFormer,
    "simvp": SimVP,
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
