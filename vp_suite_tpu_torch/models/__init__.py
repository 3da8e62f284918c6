r"""Model registry of the port (the JAX package's ids; only EF-ConvLSTM is
ported so far)."""
from vp_suite_tpu_torch.models.precipitation_nowcasting.ef_conv_lstm import EF_ConvLSTM

MODEL_CLASSES = {
    "convlstm-shi": EF_ConvLSTM,
}
AVAILABLE_MODELS = MODEL_CLASSES.keys()
