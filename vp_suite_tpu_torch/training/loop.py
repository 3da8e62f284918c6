r"""Training, evaluation and inference steps with the JAX package's
mixed-precision policy.

The input is cast once to the model's ``compute_dtype`` (bf16 halves the
activation traffic and runs the convolutions on the tensor cores), the
parameters stay f32 (each op casts its weights at use, so autograd returns
f32 gradients to them) and the predictions come back as f32, so that the
loss and its gradient start in full precision.
"""
import torch

from vp_suite_tpu_torch.base.base_model import VPModel
from vp_suite_tpu_torch.defaults import DEFAULT_RUN_CONFIG
from vp_suite_tpu_torch.measure.loss_provider import PredictionLossProvider


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


def _step_config(run_config, loss_provider):
    r"""``(run config, frames config, loss provider)`` of a step:
    ``run_config`` over the run defaults, which give the context and
    predicted frames, the losses (when ``loss_provider`` is None) and the
    accumulation steps that ``run_config`` leaves out."""
    run_config = {**DEFAULT_RUN_CONFIG, **run_config}
    cfg = {"context_frames": run_config["context_frames"],
           "pred_frames": run_config["pred_frames"]}
    if loss_provider is None:
        loss_provider = PredictionLossProvider(
            {"losses_and_scales": run_config["losses_and_scales"]})
    return run_config, cfg, loss_provider


def _unpack(model, batch, cfg):
    r"""``(inputs, targets, model kwargs)``; uint8 frames are scaled to [0, 1]
    by ``VPModel.unpack_data``, which does the JAX loop's ``_dequantize``."""
    inputs, targets, actions = VPModel.unpack_data(
        batch, cfg, needs_complete_input=model.NEEDS_COMPLETE_INPUT)
    return inputs, targets, ({"actions": actions} if model.CAN_HANDLE_ACTIONS else {})


def make_train_step(model: VPModel, run_config: dict, loss_provider=None, accum_steps: int = None):
    r"""Builds the train step for the model's ``TRAIN_REGIME``:
    ``(state, batch, epoch=0) -> (state, metrics)``, one forward, loss,
    backward and update of ``state.optimizer``; ``state`` is updated in place
    and returned. ``batch`` is ``{"frames": [b, T, h, w, c], "actions": ...}``;
    ``metrics`` is ``{"total": ..., <loss name>: ...}`` as 0-d f32 tensors on
    the model's device (reading them waits for the card). The JAX step's
    ``optimizer`` argument has no counterpart: the state holds the optimizer.

    ``loss_provider`` defaults to one built from
    ``run_config["losses_and_scales"]``, and ``accum_steps`` to
    ``run_config["accum_steps"]``; keys that ``run_config`` leaves out come
    from the run defaults (MSE alone, one step). ``accum_steps`` > 1
    accumulates gradients: the batch is split into k
    interleaved microbatches (sample j goes to microbatch j % k), each
    contributes the gradient of its mean loss / k, and ONE optimizer update
    follows; metrics are the microbatch means.

    Only the ``default`` regime is ported; ``teacher_forcing`` (PhyDNet) and
    ``scheduled_sampling`` (PredRNN++) raise ``NotImplementedError``.
    """
    regime = getattr(model, "TRAIN_REGIME", "default")
    if regime != "default":
        raise NotImplementedError(f"the '{regime}' training regime is not ported yet")
    run_config, cfg, loss_provider = _step_config(run_config, loss_provider)
    k = run_config["accum_steps"] if accum_steps is None else accum_steps

    def loss_fn(batch):
        inputs, targets, kw = _unpack(model, batch, cfg)
        preds, aux = _apply_model(model, inputs, pred_frames=cfg["pred_frames"], train=True, **kw)
        loss_values, total = loss_provider.get_losses(preds, targets)
        for v in (aux or {}).values():
            total = total + v
        return total, loss_values

    def train_step(state, batch, epoch=0):
        b = batch["frames"].shape[0]
        if b % k:
            raise ValueError(f"batch {b} not divisible by accum_steps {k}")
        state.optimizer.zero_grad(set_to_none=True)
        total, loss_values = 0.0, {}
        for i in range(k):
            mb = batch if k == 1 else {key: v[i::k] for key, v in batch.items()}
            t, lv = loss_fn(mb)
            (t / k).backward()
            total = total + t.detach() / k
            for name, v in lv.items():
                loss_values[name] = loss_values.get(name, 0.0) + v.detach() / k
        state.optimizer.step()
        state.step += 1
        return state, {"total": total, **loss_values}

    return train_step


def make_eval_step(model: VPModel, run_config: dict, loss_provider=None):
    r"""Builds the evaluation step: ``(state, batch) -> {"total": ..., <loss
    name>: ...}``, the model run with ``train=False`` under
    ``torch.inference_mode()``."""
    _, cfg, loss_provider = _step_config(run_config, loss_provider)

    def eval_step(state, batch):
        with torch.inference_mode():
            inputs, targets, kw = _unpack(model, batch, cfg)
            preds, _ = _apply_model(model, inputs, pred_frames=cfg["pred_frames"], train=False,
                                    **kw)
            loss_values, total = loss_provider.get_losses(preds, targets)
        return {"total": total, **loss_values}

    return eval_step


def make_predict_fn(model: VPModel, run_config: dict, pre=None, post=None):
    r"""Builds the inference function ``batch -> (preds, targets)`` for
    ``run_config``'s context and horizon. It runs under
    ``torch.inference_mode()``. ``pre`` maps the inputs into the model's
    value range and size and ``post`` maps the predictions back (the
    adapters of ``check_model_and_data_compat``; identity when None)."""
    cfg = {"context_frames": run_config["context_frames"],
           "pred_frames": run_config["pred_frames"]}

    def predict(batch):
        inputs, targets, actions = VPModel.unpack_data(
            batch, cfg, needs_complete_input=model.NEEDS_COMPLETE_INPUT)
        kw = {"actions": actions} if model.CAN_HANDLE_ACTIONS else {}
        with torch.inference_mode():
            if pre is not None:
                inputs = pre(inputs)
            preds, _ = _apply_model(model, inputs, pred_frames=cfg["pred_frames"],
                                    train=False, **kw)
            if post is not None:
                preds = post(preds)
        return preds, targets

    return predict
