r"""CopyLastFrame: the baseline that repeats the last context frame, with no
parameters and nothing to train (the JAX package's ``CopyLastFrame``)."""
from vp_suite_tpu_torch.base.base_model import VPModel


class CopyLastFrame(VPModel):
    NAME = "CopyLastFrame"
    TRAINABLE = False

    def pred_1(self, x, **kwargs):
        return x[:, -1]

    def forward(self, x, pred_frames: int = 1, actions=None, train: bool = False, **kwargs):
        return x[:, -1:].repeat(1, pred_frames, 1, 1, 1), None
