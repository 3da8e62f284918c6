r"""Bundled metric calculation, as the JAX package's
``PredictionMetricProvider``, with the sweep over prediction horizons
(the metrics of every prefix 1..T)."""
import warnings

import torch

from vp_suite_tpu_torch.measure import METRIC_CLASSES


class PredictionMetricProvider:
    r"""Instantiates the configured metrics (``config["metrics"]``: a list
    of names, or ``"all"``); FVD is left out unless ``config["img_c"]`` is 2
    or 3."""

    def __init__(self, config: dict):
        self.device = config.get("device")
        self.available_metrics = dict(METRIC_CLASSES) if config["metrics"] == "all" \
            else {k: METRIC_CLASSES[k] for k in config["metrics"]}
        if config["img_c"] not in [2, 3] and "fvd" in self.available_metrics:
            warnings.warn("'FVD' measure won't be used since image channels needs to be in [2, 3]")
            self.available_metrics.pop("fvd")
        self.metrics = {k: metric(device=self.device) for k, metric in self.available_metrics.items()}

    def get_metrics(self, pred, target, frames: int = None, all_frame_cnts: bool = False):
        r"""pred/target: ``[b, t, h, w, c]``. Returns a list of dicts of
        display values, one per evaluated frame count (each horizon 1..frames
        with ``all_frame_cnts``, else ``frames`` alone). A metric that raises
        ``ValueError`` or returns None for a horizon leaves its key out.

        With several horizons, a metric with ``per_frame`` is evaluated once
        and its prefix means are taken on the host in f64; the others (FVD)
        are evaluated once per horizon."""
        if pred.dim() != 5 or target.dim() != 5:
            raise ValueError("Input tensors expected to be 5-dimensional!")
        if pred.shape != target.shape:
            raise ValueError("Output images and target images are of different shape!")
        frames = frames or pred.shape[1]

        frame_cnts = [frames] if not all_frame_cnts else list(range(1, frames + 1))
        results = [dict() for _ in frame_cnts]
        with torch.no_grad():
            for key, metric in self.metrics.items():
                arrow = "↑" if metric.BIGGER_IS_BETTER else "↓"
                name = f"{key} ({arrow})"
                per_frame = None
                if len(frame_cnts) > 1:
                    try:
                        per_frame = metric.per_frame(pred[:, :frames], target[:, :frames])
                    except ValueError:
                        per_frame = None
                if per_frame is not None:
                    vals = per_frame.double().cpu().numpy()   # [b, t]
                    for idx, fc in enumerate(frame_cnts):
                        internal = float(vals[:, :fc].mean(axis=1).mean(axis=0))
                        results[idx][name] = float(metric.to_display(internal))
                    continue
                for idx, fc in enumerate(frame_cnts):
                    try:
                        metric_val = metric(pred[:, :fc], target[:, :fc])
                    except ValueError:
                        metric_val = None
                    if metric_val is None:
                        continue
                    results[idx][name] = float(metric.to_display(float(metric_val)))
        return results
