r"""Training, evaluation and inference steps with the JAX package's
mixed-precision policy.

The input is cast once to the model's ``compute_dtype`` (bf16 halves the
activation traffic and runs the convolutions on the tensor cores), the
parameters stay f32 (each op casts its weights at use, so autograd returns
f32 gradients to them) and the predictions come back as f32, so that the
loss and its gradient start in full precision.

Each builder takes the JAX package's ``use_jit`` (default True): on the card
the step is then captured into CUDA graphs and replayed
(``training/graphs.py``), the counterpart of ``jax.jit``; on CPU tensors it
runs eagerly either way. ``make_train_step`` also takes ``donate`` (default
True): the port's step always updates the state in place, which is what
donation gives the JAX package, so ``donate=False`` raises. What a step
computes on the host for each call (the teacher-forcing ratio, the sampling
rates, the schedules, the step count) stays outside the graph and enters it
as 0-d tensors.
"""
import contextlib

import numpy as np
import torch

from vp_suite_tpu_torch.base.base_model import VPModel
from vp_suite_tpu_torch.defaults import DEFAULT_RUN_CONFIG
from vp_suite_tpu_torch.measure.fvd.fvd import step_distance
from vp_suite_tpu_torch.measure.loss_provider import PredictionLossProvider
from vp_suite_tpu_torch.parallel.distributed import batch_statistics_over
from vp_suite_tpu_torch.parallel.mesh import (all_reduce_gradients, average_over_tp, axis_size,
                                              check_same_gradients, check_train_mesh,
                                              data_coordinate, data_group, gather_batch, is_fsdp,
                                              replica_group, step_groups)
from vp_suite_tpu_torch.parallel.spatial import active_spatial, gather_rows, spatial_halo_convs
from vp_suite_tpu_torch.parallel.tensor import sharded_params
from vp_suite_tpu_torch.training.graphs import CompiledStep, capture_refusal

#: the registry models whose every op is row-local, so that they run on a mesh
#: with ``sp`` > 1 (each process on its slab of image rows)
SPATIAL_MODELS = ("copy", "convlstm-shi", "trajgru")
#: the losses that sum over pixels, so that the image slabs' parts add up to the
#: whole image's (summed over ``sp``)
SPATIAL_LOSSES = ("mse", "l1", "smooth_l1")


def _spatial(model, mesh, loss_provider=None):
    r"""``(mesh, "sp")`` where ``mesh`` has ``sp`` > 1, else None; raises for a
    model that cannot run on image slabs, or a loss that does not add up over
    them."""
    sp = axis_size(mesh, "sp")
    if sp < 2:
        return None
    others = sorted(set(getattr(loss_provider, "losses", {})) - set(SPATIAL_LOSSES))
    if others:
        raise ValueError(f"the losses {others} do not add up over image slabs: on a mesh with "
                         f"sp={sp} only {', '.join(SPATIAL_LOSSES)} run")
    from vp_suite_tpu_torch.models import MODEL_CLASSES
    model_id = next((k for k, c in MODEL_CLASSES.items() if isinstance(model, c)),
                    type(model).__name__)
    if model_id not in SPATIAL_MODELS:
        raise ValueError(
            f"model '{model_id}' cannot run on a mesh with sp={sp}: its ops (warps, norms, "
            f"attention, pools or resizes over the image) are not row-local in the port; only "
            f"{', '.join(SPATIAL_MODELS)} run on image slabs")
    return mesh, "sp"


def _opened(spatial):
    r"""The spatial context of ``spatial`` (a ``(mesh, axis)`` or None)."""
    return contextlib.nullcontext() if spatial is None else spatial_halo_convs(*spatial)


def fvd_in_step(mesh=None):
    r"""The context in which a step computes its FVD loss as the JAX package's
    traced steps do: the device distance, which needs no read-back (so the
    step captures), over the global batch. On a data mesh each process's I3D
    features are first gathered over ``data`` (:func:`gather_batch`), so every
    process computes the whole batch's distance: FVD's covariances are taken
    over the batch, so it does not add up over rows, where MSE, L1 and smooth
    L1 (means of per-row values) do and are averaged over ``data`` with the
    gradients. The gather's backward sums the cotangent over ``data``, so the
    step's mean over ``data`` gives the global distance's gradient."""
    gather = None if data_coordinate(mesh)[1] < 2 else (lambda x: gather_batch(x, mesh))
    return step_distance(gather)


def compile_refusal(model, mesh=None):
    r"""Why the steps of ``model`` on ``mesh`` do not capture on the card
    (:func:`~vp_suite_tpu_torch.training.graphs.capture_refusal` over the
    groups its collectives reach, ``parallel.mesh.step_groups``), or None
    where they do: off the card, without a mesh or FSDP, and where every
    group runs NCCL."""
    on_card = any(t.is_cuda for t in (*model.parameters(), *model.buffers()))
    return capture_refusal(step_groups(mesh, model), on_card)


def _check_compiled(model, mesh, use_jit):
    r"""Raises ``NotImplementedError`` for ``use_jit`` where
    :func:`compile_refusal` refuses the step."""
    refusal = compile_refusal(model, mesh) if use_jit else None
    if refusal is not None:
        raise NotImplementedError(refusal)


def _check_graphable(optimizer):
    r"""Raises ``NotImplementedError`` for an optimizer on the card with a
    float learning rate, which a CUDA graph would freeze at its capture:
    ``create_train_state`` holds it as a 0-d tensor there, except for SGD
    over FSDP2's sharded parameters (``training.train_state``)."""
    groups = [g for g in optimizer.param_groups if any(p.is_cuda for p in g["params"])]
    if any(not torch.is_tensor(g["lr"]) for g in groups):
        raise NotImplementedError(
            "use_jit=True with an optimizer whose learning rate on the card is a float, which "
            "a CUDA graph would keep at its value at the capture (SGD over FSDP2's sharded "
            "parameters has no form that reads a tensor rate); train with Adam, or build the "
            "step with use_jit=False")


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
                    mesh=None, use_jit: bool = True, donate: bool = True):
    r"""Builds the train step for the model's ``TRAIN_REGIME``:
    ``(state, batch, epoch=0) -> (state, metrics)``, one forward, loss,
    backward and update of ``state.optimizer``; ``state`` is updated in place
    and returned. ``batch`` is ``{"frames": [b, T, h, w, c], "actions": ...}``;
    ``metrics`` is ``{"total": ..., <loss name>: ...}`` as 0-d f32 tensors on
    the model's device (reading them waits for the card). The JAX step's
    ``optimizer`` argument has no counterpart: the state holds the optimizer.

    ``use_jit`` (the JAX package's, default True): on the card the step's
    device work (everything but the host's ratio, rates, schedules and step
    count) runs eagerly at the first call, is captured into a CUDA graph at
    the second and replayed from then on, one graph per batch shape and
    dtype (``training/graphs.py``); the metrics are new tensors at every
    call. The optimizer must be the capturable form ``create_train_state``
    builds on the card. On CPU tensors, and with ``use_jit=False``, every
    call runs eagerly. An FVD loss takes the device distance (E1 on the
    card) over the global batch (:func:`fvd_in_step`), as JAX's step, which
    always traces, takes ``wasserstein2_jax``. ``donate`` (default True)
    must stay True: the step updates ``state`` in place, as the JAX step
    donates it.

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
    so that their replicas stay equal.

    On a mesh with ``sp`` > 1 (``copy`` and ``convlstm-shi`` only; any other
    model raises) the step must be built inside
    ``parallel.spatial.spatial_halo_convs`` (else ``check_train_mesh``
    raises the JAX package's "inference-only" error), which each call of the
    step reopens: ``batch`` is this process's share from
    ``shard_video_batch`` (its data rows and its block of image rows), the
    convolutions exchange halo rows, this process computes its image rows'
    part of the losses (MSE, L1 and smooth L1 only: they sum over pixels), and
    the gradients of the replicated parameters and the losses are summed over
    ``sp`` and averaged over ``data`` (``all_reduce_gradients``).

    On a mesh the step is captured as without one, its collectives inside
    the graph, where every group it reaches runs NCCL (the all-reduce of the
    gradients and losses, FSDP2's all-gathers and reduce-scatters, BatchNorm's
    statistics, the tp, halo and row gathers); the first, eager call also
    checks that the processes agree on the parameters without a gradient,
    which reads back. On the card a group over gloo raises
    ``NotImplementedError`` unless ``use_jit=False`` (:func:`compile_refusal`).
    """
    if not donate:
        raise ValueError("donate=False is not ported: the port's train step always updates the "
                         "state in place (parameters, moments, buffers), which is what the JAX "
                         "step does with a donated state; copy the state before the step where "
                         "the old one is needed")
    _check_compiled(model, mesh, use_jit)
    regime = getattr(model, "TRAIN_REGIME", "default")
    if regime not in ("default", "teacher_forcing", "scheduled_sampling"):
        raise NotImplementedError(f"the '{regime}' training regime is not ported")
    run_config, cfg, loss_provider = _step_config(run_config, loss_provider)
    k = run_config["accum_steps"] if accum_steps is None else accum_steps
    ctx, pred = cfg["context_frames"], cfg["pred_frames"]
    if mesh is not None:
        check_train_mesh(mesh)
    spatial = _spatial(model, mesh, loss_provider) and active_spatial()
    if spatial and is_fsdp(model):
        raise ValueError("FSDP's reduce-scatter averages over every process of its mesh: on a "
                         "mesh with sp > 1 the gradients are summed over sp, so train the "
                         "replicated model (shard_params)")
    rank, world = data_coordinate(mesh)
    group = data_group(mesh)

    def losses(preds, targets, aux):
        loss_values, total = loss_provider.get_losses(preds, targets)
        for v in (aux or {}).values():
            total = total + v
        return total, loss_values

    def default_loss(batch, generator, scalars):
        inputs, targets, kw = _unpack(model, batch, cfg)
        preds, aux = _apply_model(model, inputs, pred_frames=pred, train=True, **kw)
        return losses(preds, targets, aux)

    def teacher_forcing_loss(batch, generator, scalars):
        inputs, _, actions = VPModel.unpack_data(batch, cfg, complete=True)
        coin = torch.rand((), generator=generator, device=generator.device) < scalars["ratio"]
        kw = {"actions": actions} if model.CAN_HANDLE_ACTIONS else {}
        preds, aux = _apply_model(model, inputs, pred_frames=pred, train=True,
                                  teacher_forcing=coin, **kw)
        return losses(preds, inputs[:, 1:], aux)

    def scheduled_sampling_loss(batch, generator, scalars):
        inputs, targets, _ = VPModel.unpack_data(batch, cfg, needs_complete_input=True)
        b = inputs.shape[0]
        rows = slice(rank * b, (rank + 1) * b)   # this process's rows of the global masks
        mask, _ = model.scheduled_sampling_mask(None, generator, b * world, ctx, pred, train=True,
                                                rates=scalars["rates"])
        if model.reverse_input:
            inputs_rev, targets_rev, _ = VPModel.unpack_data(batch, cfg, reverse=True,
                                                             needs_complete_input=True)
            mask_rev, _ = model.scheduled_sampling_mask(None, generator, b * world, ctx, pred,
                                                        train=True, rates=scalars["rates_rev"])
            inputs, targets = torch.cat([inputs, inputs_rev]), torch.cat([targets, targets_rev])
            mask = torch.cat([mask[rows], mask_rev[rows]])
        else:
            mask = mask[rows]
        preds, aux = _apply_model(model, inputs, pred_frames=pred, train=True, mask_true=mask)
        return losses(preds, targets, aux)

    loss_fn = {"default": default_loss, "teacher_forcing": teacher_forcing_loss,
               "scheduled_sampling": scheduled_sampling_loss}[regime]

    def host_scalars(state, epoch):
        r"""``(scalars, model_state)``: the values the host computes for a
        step (floats, which enter the step as 0-d f32 tensors) and the
        schedules after it."""
        if regime == "teacher_forcing":
            decay = np.float32(epoch) * np.float32(model.teacher_forcing_decay)
            return {"ratio": float(max(np.float32(0.0), np.float32(1.0) - decay))}, \
                state.model_state
        if regime == "scheduled_sampling":
            rates, model_state = model.sampling_rates(state.model_state)
            scalars = {"rates": rates}
            if model.reverse_input:
                scalars["rates_rev"], model_state = model.sampling_rates(model_state)
            return scalars, {**model_state,
                             "training_iteration": model_state["training_iteration"] + 1}
        return {}, state.model_state

    replicated = whole = None   # the parameters whose gradients the step all-reduces

    def device_step(state, generator, batch, scalars):
        r"""The step's work on the device: forward, loss, backward and the
        optimizer's update, for ``k`` microbatches; returns the metrics."""
        nonlocal replicated, whole
        state.optimizer.zero_grad(set_to_none=True)
        sharded = mesh is not None and is_fsdp(model)
        total, loss_values, buffers = 0.0, {}, None
        for i in range(k):
            mb = batch if k == 1 else {key: v[i::k] for key, v in batch.items()}
            if sharded:
                model.set_requires_gradient_sync(i == k - 1)
            with batch_statistics_over(group), _opened(spatial), fvd_in_step(mesh):
                t, lv = loss_fn(mb, generator, scalars)
            (t / k).backward()
            if i == 0 and k > 1:
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
        return {"total": total, **loss_values}

    run = CompiledStep(device_step, "the train step", use_jit)

    def train_step(state, batch, epoch=0):
        b = batch["frames"].shape[0]
        if b % k:
            raise ValueError(f"batch {b} not divisible by accum_steps {k}")
        if use_jit and state.optimizer is not None:
            _check_graphable(state.optimizer)
        scalars, model_state = host_scalars(state, epoch)
        metrics = run(state, state.generator, batch, scalars)
        state.step += 1
        state.model_state = model_state
        return state, metrics

    train_step.compiled = run   # its graphs, one per batch signature
    return train_step


def make_eval_step(model: VPModel, run_config: dict, loss_provider=None, mesh=None,
                   use_jit: bool = True):
    r"""Builds the evaluation step: ``(state, batch) -> {"total": ..., <loss
    name>: ...}``, the model run with ``train=False`` under
    ``torch.inference_mode()``. With a ``mesh``, ``batch`` is this process's
    share of the global batch (``shard_batch``, or ``shard_video_batch`` on a
    mesh with ``sp`` > 1, where the convolutions exchange halo rows) and the
    metrics are the global batch's, in one all-reduce over the mesh's ``data``
    x ``sp`` processes: averaged over ``data``, summed over ``sp`` (each
    process's image rows' part of the row-additive losses). ``use_jit`` as
    for :func:`make_train_step`: captured per batch shape on the card, on an
    NCCL mesh with the all-reduce inside the graph, new metric tensors at
    every call.

    An FVD loss takes the distance JAX's eval step takes: with ``use_jit``,
    or on a mesh (whose step JAX jits), the device distance over the global
    batch (:func:`fvd_in_step`); with ``use_jit=False`` and no mesh, the
    host's f64 distance, as JAX's unjitted step computes it."""
    _check_compiled(model, mesh, use_jit)
    _, cfg, loss_provider = _step_config(run_config, loss_provider)
    group = replica_group(mesh)
    shares = data_coordinate(mesh)[1]
    spatial = _spatial(model, mesh, loss_provider)
    traced = use_jit or mesh is not None
    fsdp = is_fsdp(model)

    def eval_step(state, batch):
        with torch.inference_mode(), _opened(spatial), \
                fvd_in_step(mesh) if traced else contextlib.nullcontext():
            inputs, targets, kw = _unpack(model, batch, cfg)
            preds, _ = _apply_model(model, inputs, pred_frames=cfg["pred_frames"], train=False,
                                    **kw)
            loss_values, total = loss_provider.get_losses(preds, targets)
            if group is not None:
                names = list(loss_values)
                means = torch.stack([total, *(loss_values[n] for n in names)]).float()
                torch.distributed.all_reduce(means, group=group)
                means /= shares
                total, loss_values = means[0], dict(zip(names, means[1:]))
            if fsdp:
                model.reshard()   # as after a train step: see make_predict_fn
        return {"total": total, **loss_values}

    return CompiledStep(eval_step, "the eval step", use_jit)


def make_predict_fn(model: VPModel, run_config: dict, pre=None, post=None, mesh=None,
                    use_jit: bool = True):
    r"""Builds the inference function ``batch -> (preds, targets)`` for
    ``run_config``'s context and horizon. It runs under
    ``torch.inference_mode()``. ``pre`` maps the inputs into the model's
    value range and size and ``post`` maps the predictions back (the
    adapters of ``check_model_and_data_compat``; identity when None). On a
    mesh it predicts the rows it is given (``shard_batch``): every ``tp``
    process of a data coordinate predicts the same, the model's collectives
    running over ``tp``. With a ``mesh`` whose ``sp`` is above 1, ``batch`` is
    this process's share (``shard_video_batch``), the convolutions exchange
    halo rows, and the predictions and targets come back as whole frames,
    gathered over ``sp``, as the JAX package returns a global array (the
    adapters, which resize whole frames, are refused there). ``use_jit`` as
    for :func:`make_train_step`: captured per input shape on the card, on an
    NCCL mesh with the row gathers inside the graph, new prediction tensors
    at every call."""
    _check_compiled(model, mesh, use_jit)
    cfg = {"context_frames": run_config["context_frames"],
           "pred_frames": run_config["pred_frames"]}
    spatial = _spatial(model, mesh)
    fsdp = is_fsdp(model)
    if spatial is not None and (pre is not None or post is not None):
        raise ValueError("the value-range and size adapters take whole frames: they do not run "
                         f"on a mesh with sp={axis_size(mesh, 'sp')}")

    def predict(batch):
        inputs, targets, actions = VPModel.unpack_data(
            batch, cfg, needs_complete_input=model.NEEDS_COMPLETE_INPUT)
        kw = {"actions": actions} if model.CAN_HANDLE_ACTIONS else {}
        with torch.inference_mode(), _opened(spatial):
            if pre is not None:
                inputs = pre(inputs)
            preds, _ = _apply_model(model, inputs, pred_frames=cfg["pred_frames"],
                                    train=False, **kw)
            if post is not None:
                preds = post(preds)
            if spatial is not None:
                preds, targets = gather_rows(preds, 2, *spatial), gather_rows(targets, 2, *spatial)
            if fsdp:
                # FSDP2 keeps its root's gathered parameters after a forward and
                # frees them only after a backward: free them here too, so that
                # every call (eager, captured or replayed) gathers the present
                # parameters and no graph reads a copy that a later step left stale
                model.reshard()
        return preds, targets

    return CompiledStep(predict, "the predict function", use_jit)
