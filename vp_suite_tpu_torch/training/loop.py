r"""Inference step with the JAX package's mixed-precision policy.

The input is cast once to the model's ``compute_dtype`` (bf16 halves the
activation traffic and runs the convolutions on the tensor cores), the
parameters stay f32 (each op casts its weights at use) and the predictions
come back as f32.
"""
import torch

from vp_suite_tpu_torch.base.base_model import VPModel


def _apply_model(model, x, *args, **kwargs):
    r"""Runs ``model(x, ...)`` under the mixed-precision policy; returns
    ``(preds, aux)``."""
    cd = model.compute_dtype
    cast = cd is not None and cd != torch.float32
    if cast:
        x = x.to(cd)
    preds, aux = model(x, *args, **kwargs)
    if cast:
        preds = preds.float()
        if aux is not None:
            aux = {k: v.float() if torch.is_tensor(v) else v for k, v in aux.items()}
    return preds, aux


def make_predict_fn(model: VPModel, run_config: dict):
    r"""Builds the inference function ``batch -> (preds, targets)`` for
    ``run_config``'s context and horizon. It runs under
    ``torch.inference_mode()``."""
    cfg = {"context_frames": run_config["context_frames"],
           "pred_frames": run_config["pred_frames"]}

    def predict(batch):
        inputs, targets, actions = VPModel.unpack_data(
            batch, cfg, needs_complete_input=model.NEEDS_COMPLETE_INPUT)
        kw = {"actions": actions} if model.CAN_HANDLE_ACTIONS else {}
        with torch.inference_mode():
            preds, _ = _apply_model(model, inputs, pred_frames=cfg["pred_frames"],
                                    train=False, **kw)
        return preds, targets

    return predict
