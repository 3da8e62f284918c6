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
    follows; metrics are the microbatch means. As in the JAX package, every
    microbatch starts from the step's ``state.model_state``, and the
    schedules and the buffers (BatchNorm's running statistics) after the step
    are those that microbatch 0 left.

    Regimes: ``default`` (the model's loss on its predictions plus its
    auxiliary losses) and ``scheduled_sampling`` (PredRNN++): the complete
    sequence goes in with a sampling mask drawn from ``state.generator`` by
    ``model.scheduled_sampling_mask``; with ``model.reverse_input`` the
    time-reversed sequence, with a second mask, runs in the same forward as
    a batch of 2b (the mean loss of the two halves); ``training_iteration``
    advances once per step. ``teacher_forcing`` (PhyDNet) raises
    ``NotImplementedError``.
    """
    regime = getattr(model, "TRAIN_REGIME", "default")
    if regime not in ("default", "scheduled_sampling"):
        raise NotImplementedError(f"the '{regime}' training regime is not ported yet")
    run_config, cfg, loss_provider = _step_config(run_config, loss_provider)
    k = run_config["accum_steps"] if accum_steps is None else accum_steps
    ctx, pred = cfg["context_frames"], cfg["pred_frames"]

    def losses(preds, targets, aux):
        loss_values, total = loss_provider.get_losses(preds, targets)
        for v in (aux or {}).values():
            total = total + v
        return total, loss_values

    def default_loss(batch, model_state, generator):
        inputs, targets, kw = _unpack(model, batch, cfg)
        preds, aux = _apply_model(model, inputs, pred_frames=pred, train=True, **kw)
        return losses(preds, targets, aux), model_state

    def scheduled_sampling_loss(batch, model_state, generator):
        inputs, targets, _ = VPModel.unpack_data(batch, cfg, needs_complete_input=True)
        b = inputs.shape[0]
        mask, model_state = model.scheduled_sampling_mask(model_state, generator, b, ctx, pred,
                                                          train=True)
        if model.reverse_input:
            inputs_rev, targets_rev, _ = VPModel.unpack_data(batch, cfg, reverse=True,
                                                             needs_complete_input=True)
            mask_rev, model_state = model.scheduled_sampling_mask(model_state, generator, b, ctx,
                                                                  pred, train=True)
            inputs, targets = torch.cat([inputs, inputs_rev]), torch.cat([targets, targets_rev])
            mask = torch.cat([mask, mask_rev])
        preds, aux = _apply_model(model, inputs, pred_frames=pred, train=True, mask_true=mask)
        model_state = {**model_state,
                       "training_iteration": model_state["training_iteration"] + 1}
        return losses(preds, targets, aux), model_state

    loss_fn = scheduled_sampling_loss if regime == "scheduled_sampling" else default_loss

    def train_step(state, batch, epoch=0):
        b = batch["frames"].shape[0]
        if b % k:
            raise ValueError(f"batch {b} not divisible by accum_steps {k}")
        state.optimizer.zero_grad(set_to_none=True)
        total, loss_values, buffers = 0.0, {}, None
        for i in range(k):
            mb = batch if k == 1 else {key: v[i::k] for key, v in batch.items()}
            (t, lv), model_state = loss_fn(mb, state.model_state, state.generator)
            (t / k).backward()
            if i == 0:
                new_model_state = model_state
                if k > 1:
                    buffers = [buf.detach().clone() for buf in model.buffers()]
            total = total + t.detach() / k
            for name, v in lv.items():
                loss_values[name] = loss_values.get(name, 0.0) + v.detach() / k
        if buffers:
            with torch.no_grad():
                for buf, kept in zip(model.buffers(), buffers):
                    buf.copy_(kept)
        state.optimizer.step()
        state.step += 1
        state.model_state = new_model_state
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
