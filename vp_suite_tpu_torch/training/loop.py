r"""Training, evaluation and inference steps with the JAX package's
mixed-precision policy.

The input is cast once to the model's ``compute_dtype`` (bf16 halves the
activation traffic and runs the convolutions on the tensor cores), the
parameters stay f32 (each op casts its weights at use, so autograd returns
f32 gradients to them) and the predictions come back as f32, so that the
loss and its gradient start in full precision.
"""
import numpy as np
import torch

from vp_suite_tpu_torch.base.base_model import VPModel
from vp_suite_tpu_torch.defaults import DEFAULT_RUN_CONFIG
from vp_suite_tpu_torch.measure.loss_provider import PredictionLossProvider
from vp_suite_tpu_torch.parallel.distributed import batch_statistics_over
from vp_suite_tpu_torch.parallel.mesh import (all_reduce_gradients, average_over_tp,
                                              check_same_gradients, check_train_mesh,
                                              data_coordinate, data_group, is_fsdp)
from vp_suite_tpu_torch.parallel.tensor import sharded_params


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


def make_train_step(model: VPModel, run_config: dict, loss_provider=None, accum_steps: int = None,
                    mesh=None):
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
    auxiliary losses); ``teacher_forcing`` (PhyDNet): the complete sequence
    goes in and the targets are its frames from the second on; each
    microbatch draws one coin from ``state.generator``, 1 with probability
    ``max(0, 1 - epoch * model.teacher_forcing_decay)`` (in f32, as the JAX
    step computes it: always 1 at epoch 0, always 0 from epoch 334 at the
    default decay), and the model gets it as a 0-d tensor on the generator's
    device, so that the step reads nothing back from the card; and
    ``scheduled_sampling`` (PredRNN++): the complete sequence goes in with a
    sampling mask drawn from ``state.generator`` by
    ``model.scheduled_sampling_mask``; with ``model.reverse_input`` the
    time-reversed sequence, with a second mask, runs in the same forward as
    a batch of 2b (the mean loss of the two halves); ``training_iteration``
    advances once per step. Any other regime raises ``NotImplementedError``.

    With a data ``mesh`` (``parallel.mesh.make_mesh``), ``batch`` is this
    process's slice of the global batch and the step is the global batch's,
    as the JAX step on a batch sharded over its mesh: the gradients of the
    replicated parameters are averaged over the mesh in one all-reduce after
    the last microbatch's backward, together with the metrics (FSDP2
    reduce-scatters the sharded parameters' gradients, once a step); batch
    statistics are taken over the global batch; the scheduled-sampling masks
    are drawn for the global batch (every process draws the same, from its
    identically seeded generator) and each process takes its rows; the
    teacher-forcing coin is the same on every process. Parameters without a
    gradient (ST-Phy's dead layers) keep ``.grad`` None on every process:
    the first step checks that the processes agree on them.

    On an N-D mesh (``parallel.mesh.make_mesh_nd``) all of this runs over its
    ``data`` axis: ``batch`` holds the rows of this process's data coordinate
    (every ``tp`` process of it the same), the masks' rows are that
    coordinate's, and the gradients of the replicated parameters and of this
    process's tp shards (``shard_params_tp``) are averaged over the processes
    of its ``data`` axis, which hold the same shards; the layers' own
    collectives run over ``tp``, and the gradients of the parameters that
    ``tp`` leaves whole are then averaged over ``tp`` (``average_over_tp``),
    so that their replicas stay equal. A mesh with ``sp`` > 1 raises
    (``check_train_mesh``).
    """
    regime = getattr(model, "TRAIN_REGIME", "default")
    if regime not in ("default", "teacher_forcing", "scheduled_sampling"):
        raise NotImplementedError(f"the '{regime}' training regime is not ported")
    run_config, cfg, loss_provider = _step_config(run_config, loss_provider)
    k = run_config["accum_steps"] if accum_steps is None else accum_steps
    ctx, pred = cfg["context_frames"], cfg["pred_frames"]
    if mesh is not None:
        check_train_mesh(mesh)
    rank, world = data_coordinate(mesh)
    group = data_group(mesh)

    def losses(preds, targets, aux):
        loss_values, total = loss_provider.get_losses(preds, targets)
        for v in (aux or {}).values():
            total = total + v
        return total, loss_values

    def default_loss(batch, model_state, generator, epoch):
        inputs, targets, kw = _unpack(model, batch, cfg)
        preds, aux = _apply_model(model, inputs, pred_frames=pred, train=True, **kw)
        return losses(preds, targets, aux), model_state

    def teacher_forcing_loss(batch, model_state, generator, epoch):
        inputs, _, actions = VPModel.unpack_data(batch, cfg, complete=True)
        decay = np.float32(epoch) * np.float32(model.teacher_forcing_decay)
        ratio = float(max(np.float32(0.0), np.float32(1.0) - decay))
        coin = torch.rand((), generator=generator, device=generator.device) < ratio
        kw = {"actions": actions} if model.CAN_HANDLE_ACTIONS else {}
        preds, aux = _apply_model(model, inputs, pred_frames=pred, train=True,
                                  teacher_forcing=coin, **kw)
        return losses(preds, inputs[:, 1:], aux), model_state

    def scheduled_sampling_loss(batch, model_state, generator, epoch):
        inputs, targets, _ = VPModel.unpack_data(batch, cfg, needs_complete_input=True)
        b = inputs.shape[0]
        rows = slice(rank * b, (rank + 1) * b)   # this process's rows of the global masks
        mask, model_state = model.scheduled_sampling_mask(model_state, generator, b * world, ctx,
                                                          pred, train=True)
        if model.reverse_input:
            inputs_rev, targets_rev, _ = VPModel.unpack_data(batch, cfg, reverse=True,
                                                             needs_complete_input=True)
            mask_rev, model_state = model.scheduled_sampling_mask(model_state, generator,
                                                                  b * world, ctx, pred, train=True)
            inputs, targets = torch.cat([inputs, inputs_rev]), torch.cat([targets, targets_rev])
            mask = torch.cat([mask[rows], mask_rev[rows]])
        else:
            mask = mask[rows]
        preds, aux = _apply_model(model, inputs, pred_frames=pred, train=True, mask_true=mask)
        model_state = {**model_state,
                       "training_iteration": model_state["training_iteration"] + 1}
        return losses(preds, targets, aux), model_state

    loss_fn = {"default": default_loss, "teacher_forcing": teacher_forcing_loss,
               "scheduled_sampling": scheduled_sampling_loss}[regime]

    replicated = whole = None   # the parameters whose gradients the step all-reduces

    def train_step(state, batch, epoch=0):
        nonlocal replicated, whole
        b = batch["frames"].shape[0]
        if b % k:
            raise ValueError(f"batch {b} not divisible by accum_steps {k}")
        state.optimizer.zero_grad(set_to_none=True)
        sharded = mesh is not None and is_fsdp(model)
        total, loss_values, buffers = 0.0, {}, None
        for i in range(k):
            mb = batch if k == 1 else {key: v[i::k] for key, v in batch.items()}
            if sharded:
                model.set_requires_gradient_sync(i == k - 1)
            with batch_statistics_over(group):
                (t, lv), model_state = loss_fn(mb, state.model_state, state.generator, epoch)
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
        if mesh is not None:
            if replicated is None:
                from torch.distributed.tensor import DTensor
                replicated = [p for p in model.parameters()
                              if p.requires_grad and not isinstance(p, DTensor)]
                check_same_gradients(replicated, mesh)
                split = sharded_params(model)
                whole = [p for n, p in model.named_parameters()
                         if p.requires_grad and n not in split]
            names = list(loss_values)
            means = all_reduce_gradients(replicated, mesh,
                                         torch.stack([total, *(loss_values[n] for n in names)]))
            total, loss_values = means[0], dict(zip(names, means[1:]))
            average_over_tp(whole, mesh)
        state.optimizer.step()
        state.step += 1
        state.model_state = new_model_state
        return state, {"total": total, **loss_values}

    return train_step


def make_eval_step(model: VPModel, run_config: dict, loss_provider=None, mesh=None):
    r"""Builds the evaluation step: ``(state, batch) -> {"total": ..., <loss
    name>: ...}``, the model run with ``train=False`` under
    ``torch.inference_mode()``. With a ``mesh``, ``batch`` is this process's
    share of the global batch (``shard_batch``) and the metrics are the global
    batch's, averaged over the mesh's ``data`` axis in one all-reduce."""
    _, cfg, loss_provider = _step_config(run_config, loss_provider)
    group = data_group(mesh)

    def eval_step(state, batch):
        with torch.inference_mode():
            inputs, targets, kw = _unpack(model, batch, cfg)
            preds, _ = _apply_model(model, inputs, pred_frames=cfg["pred_frames"], train=False,
                                    **kw)
            loss_values, total = loss_provider.get_losses(preds, targets)
            if group is not None:
                names = list(loss_values)
                means = torch.stack([total, *(loss_values[n] for n in names)]).float()
                torch.distributed.all_reduce(means, group=group)
                means /= torch.distributed.get_world_size(group)
                total, loss_values = means[0], dict(zip(names, means[1:]))
        return {"total": total, **loss_values}

    return eval_step


def make_predict_fn(model: VPModel, run_config: dict, pre=None, post=None):
    r"""Builds the inference function ``batch -> (preds, targets)`` for
    ``run_config``'s context and horizon. It runs under
    ``torch.inference_mode()``. ``pre`` maps the inputs into the model's
    value range and size and ``post`` maps the predictions back (the
    adapters of ``check_model_and_data_compat``; identity when None). On a
    mesh it predicts the rows it is given (``shard_batch``): every ``tp``
    process of a data coordinate predicts the same, the model's collectives
    running over ``tp``."""
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
