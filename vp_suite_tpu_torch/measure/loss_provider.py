r"""Bundled loss calculation, as the JAX package's ``PredictionLossProvider``."""
import warnings

import torch

from vp_suite_tpu_torch.measure import LOSS_CLASSES


class PredictionLossProvider:
    r"""Instantiates the configured losses (``config["losses_and_scales"]``,
    name -> scale) and computes them all on one (pred, target) pair,
    returning display values and the scaled total. FVD is left out unless
    ``config["img_c"]`` is 2 or 3."""

    def __init__(self, config: dict):
        self.device = config.get("device")
        loss_scales = dict(config["losses_and_scales"])
        unknown = sorted(set(loss_scales) - set(LOSS_CLASSES))
        if unknown:
            raise ValueError(f"unknown losses {unknown} (available: {list(LOSS_CLASSES)})")
        if "fvd" in loss_scales and config.get("img_c") not in [2, 3]:
            warnings.warn("'FVD' measure won't be used since image channels needs to be in [2, 3]")
            loss_scales.pop("fvd")
        self.losses = {k: (LOSS_CLASSES[k](device=self.device), scale)
                       for k, scale in loss_scales.items()}

    def get_losses(self, pred, target):
        r"""pred/target: ``[b, t, h, w, c]``. Returns ``(display dict, total)``."""
        if pred.shape != target.shape:
            raise ValueError("Output images and target images are of different shape!")
        loss_display_values = {}
        total_loss = torch.zeros((), dtype=torch.float32, device=pred.device)
        for key, (loss, scale) in self.losses.items():
            val = loss(pred, target)
            if val is None:   # FVD on sequences shorter than 9 frames
                continue
            total_loss = total_loss + scale * val
            loss_display_values[key] = loss.to_display(val)
        return loss_display_values, total_loss
