r"""Model registry of the port (the JAX package's ids; EF-ConvLSTM and
EF-TrajGRU are ported so far)."""
from vp_suite_tpu_torch.models.precipitation_nowcasting.ef_conv_lstm import EF_ConvLSTM
from vp_suite_tpu_torch.models.precipitation_nowcasting.ef_traj_gru import EF_TrajGRU

MODEL_CLASSES = {
    "convlstm-shi": EF_ConvLSTM,
    "trajgru": EF_TrajGRU,
}
AVAILABLE_MODELS = MODEL_CLASSES.keys()
