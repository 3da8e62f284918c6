r"""The sharded checkpoint: the counterpart of the JAX package's orbax
backend, written with ``torch.distributed.checkpoint`` (DCP).

``checkpoint.py``'s file gathers the whole state to rank 0 and writes one
``torch.save`` file. Here instead

- **every process writes its own shards** into ``orbax_state/`` (the JAX
  package's directory name; DCP's ``.distcp`` files and ``.metadata``): an
  FSDP-sharded parameter or moment is written by each process from its
  shard, with no gather, and a replicated one once;
- **the restore reads each leaf straight into the template's layout**: a
  DTensor of an FSDP model gets its shard, a plain tensor (one process
  without a group, or a replicated leaf) the whole of it.

A tp-sharded parameter (``parallel.mesh.shard_params_tp``; with FSDP2 over
``data`` on top, ``shard_params_tp_fsdp``) and its moments are written by each
process from its shard too, as a DTensor over the whole N-D mesh (split over
``tp``, and over ``data`` where FSDP2 splits it). Such a checkpoint restores
into a model of any layout that is not tp-sharded, a plain one without a group
included; restoring into a tp-sharded model raises.

``VPSuite.train(ckpt_backend="orbax")`` selects it (the option keeps the JAX
package's name, so the run configurations stay alike); every process calls
:func:`save_checkpoint_orbax`. The ``model_config.json`` sidecar, which
``load_checkpoint`` reads to route by ``"backend"``, is the other backend's,
written by rank 0.
"""
from pathlib import Path

import torch
import torch.distributed.checkpoint as dcp

from vp_suite_tpu_torch.checkpoint.checkpoint import model_from_config, write_sidecars
from vp_suite_tpu_torch.parallel.distributed import is_grouped, process_index
from vp_suite_tpu_torch.parallel.tensor import sharded_params
from vp_suite_tpu_torch.training.train_state import (create_train_state, optimizer_form,
                                                      restore_optimizer_form)
from vp_suite_tpu_torch.utils.utils import resolve_device

STATE_DIR = "orbax_state"


def _global(name, t, specs):
    r"""``t`` (parameter ``name``'s tensor or moment) as a DTensor over the whole
    N-D mesh where ``name`` is tp-sharded: its ``tp`` shard, and within that
    FSDP2's ``data`` shard where ``t`` is one."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    spec = specs.get(name)
    if spec is None or not torch.is_tensor(t) or t.dim() <= spec.dim:
        return t
    on = {}
    if isinstance(t, DTensor):
        (axis,), (placement,) = t.device_mesh.mesh_dim_names, t.placements
        on[axis], t = placement, t.to_local()
    if t.shape[spec.dim] != spec.local:
        return t
    on["tp"] = Shard(spec.dim)
    return DTensor.from_local(t, spec.mesh, [on.get(n, Replicate())
                                             for n in spec.mesh.mesh_dim_names], run_check=False)


def _state_dict(state):
    r"""What DCP writes and reads: the model's and the optimizer's state
    dicts in their present layout (DTensors under FSDP, and over the whole
    mesh under tensor parallelism; the learning rate a float, as a capturable
    optimizer's tensor would not load into a plain one), the step, the
    schedules and the optimizer's name."""
    from torch.distributed.checkpoint.state_dict import get_model_state_dict, get_state_dict
    opt = state.optimizer
    if opt is None:
        model_sd, opt_sd = get_model_state_dict(state.model), {}
    else:
        model_sd, opt_sd = get_state_dict(state.model, opt)
        opt_sd["param_groups"] = [{**g, "lr": float(g["lr"])} for g in opt_sd["param_groups"]]
    specs = sharded_params(state.model)
    if specs:
        model_sd = {k: _global(k, v, specs) for k, v in model_sd.items()}
        if opt_sd:
            opt_sd["state"] = {k: {m: _global(k, v, specs) for m, v in st.items()}
                               for k, st in opt_sd["state"].items()}
    return {"model": model_sd, "optimizer": opt_sd, "step": state.step,
            "model_state": dict(state.model_state),
            "optimizer_name": type(opt).__name__.lower() if opt is not None else ""}


def save_checkpoint_orbax(ckpt_dir, state, model_id: str, model_config: dict,
                          run_config: dict = None):
    r"""Writes ``state`` sharded (every process of a group writes its own
    shards; call it from every process) into ``ckpt_dir/orbax_state``, and
    rank 0 the sidecars, with ``"backend": "orbax"``."""
    ckpt_dir = Path(ckpt_dir).absolute()
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    dcp.save(_state_dict(state), storage_writer=dcp.FileSystemWriter(ckpt_dir / STATE_DIR,
                                                                      overwrite=True),
             no_dist=not is_grouped())
    if process_index() == 0:
        write_sidecars(ckpt_dir, model_id, model_config, run_config, backend="orbax")


def restore_checkpoint_orbax(ckpt_dir, template_state):
    r"""Restores a state saved by :func:`save_checkpoint_orbax` into
    ``template_state`` (a ``TrainState`` of the same model and optimizer, in
    the layout wanted: FSDP-sharded, replicated, or plain in one process
    without a group) and returns it. Parameters without optimizer moments in
    the checkpoint (never given a gradient) get none."""
    from torch.distributed.checkpoint.state_dict import (StateDictOptions, set_model_state_dict,
                                                         set_optimizer_state_dict)
    if sharded_params(template_state.model):
        raise NotImplementedError("restoring a checkpoint into a tp-sharded model is not ported: "
                                  "restore it into a model that is not, then shard that")
    path = Path(ckpt_dir).absolute() / STATE_DIR
    sd = _state_dict(template_state)
    opt_sd, groups = sd["optimizer"], None
    if opt_sd:
        # the template's optimizer state is made by a step at lr 0: keep the
        # parameters that have moments in the checkpoint
        saved = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
        opt_sd["state"] = {fqn: st for fqn, st in opt_sd["state"].items()
                           if any(key.startswith(f"optimizer.state.{fqn}.") for key in saved)}
        # the parameter groups stay the template's (FSDP splits its optimizer's
        # parameters in two groups, one process keeps one), with the saved
        # hyperparameters of the first
        groups = [g["params"] for g in opt_sd["param_groups"]]
        opt_sd["param_groups"] = [{k: v for k, v in opt_sd["param_groups"][0].items()
                                   if k != "params"}]
    dcp.load(sd, checkpoint_id=path, no_dist=not is_grouped())
    if groups is not None:
        opt_sd["param_groups"] = [{**opt_sd["param_groups"][0], "params": g} for g in groups]
    set_model_state_dict(template_state.model, sd["model"])
    if template_state.optimizer is not None:
        form = optimizer_form(template_state.optimizer)
        set_optimizer_state_dict(template_state.model, template_state.optimizer, sd["optimizer"],
                                 options=StateDictOptions(strict=False))
        restore_optimizer_form(template_state.optimizer, form)
    template_state.step = sd["step"]
    template_state.model_state = sd["model_state"]
    return template_state


def load_checkpoint_orbax(ckpt_dir, device="cuda"):
    r"""``(model, state, model_id)`` from a sharded checkpoint directory, as
    ``checkpoint.load_checkpoint`` gives them: the model rebuilt from
    ``model_config.json`` on ``device`` (the card unless the caller asks for
    the CPU) and its whole state restored into plain tensors."""
    import json
    device = resolve_device(device, "load_checkpoint_orbax")
    ckpt_dir = Path(ckpt_dir)
    with open(ckpt_dir / "model_config.json", "r") as f:
        cfg = json.load(f)
    model = model_from_config(cfg["model_id"], cfg["model_config"], device)
    name = {"optimizer_name": ""}
    dcp.load(name, checkpoint_id=ckpt_dir.absolute() / STATE_DIR, no_dist=not is_grouped())
    state = create_train_state(model, optimizer=name["optimizer_name"] or "adam")
    return model, restore_checkpoint_orbax(ckpt_dir, state), cfg["model_id"]
