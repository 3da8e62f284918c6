r"""Bundled loss calculation, as the JAX package's ``PredictionLossProvider``."""
import torch

from vp_suite_tpu_torch.measure import LOSS_CLASSES


class PredictionLossProvider:
    r"""Instantiates the configured losses (``config["losses_and_scales"]``,
    name -> scale) and computes them all on one (pred, target) pair,
    returning display values and the scaled total."""

    def __init__(self, config: dict):
        self.device = config.get("device")
        unknown = sorted(set(config["losses_and_scales"]) - set(LOSS_CLASSES))
        if unknown:
            raise ValueError(f"losses {unknown} are not ported (available: {list(LOSS_CLASSES)})")
        self.losses = {k: (LOSS_CLASSES[k](device=self.device), scale)
                       for k, scale in config["losses_and_scales"].items()}

    def get_losses(self, pred, target):
        r"""pred/target: ``[b, t, h, w, c]``. Returns ``(display dict, total)``."""
        if pred.shape != target.shape:
            raise ValueError("Output images and target images are of different shape!")
        loss_display_values = {}
        total_loss = torch.zeros((), dtype=torch.float32, device=pred.device)
        for key, (loss, scale) in self.losses.items():
            val = loss(pred, target)
            total_loss = total_loss + scale * val
            loss_display_values[key] = loss.to_display(val)
        return loss_display_values, total_loss
