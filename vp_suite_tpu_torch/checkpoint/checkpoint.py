r"""Checkpoints: model parameters, optimizer state, step and training
schedules, with the configuration that rebuilds the model.

A checkpoint directory holds
- ``checkpoint.pt``: ``torch.save`` of ``{"model": state_dict, "optimizer":
  the optimizer's state_dict (its moments and learning rate, a float:
  it loads into a capturable optimizer on the card or a plain one on the
  CPU), "optimizer_name", "step", "model_state"}`` (``optimizer`` and
  ``optimizer_name`` are None for a model with nothing to train);
- ``model_config.json``: ``{"model_id", "model_config"}``, from which the
  registry rebuilds the model;
- ``run_cfg.json``: the run configuration, where one is given.

This is the counterpart of the JAX package's msgpack checkpoint; the
counterpart of its orbax backend, a sharded checkpoint that every process
writes its part of, is :mod:`.orbax_backend`. In a process group every
process calls :func:`save_checkpoint`: under FSDP each first joins the
gather of the full state, and under tensor parallelism the gather of each
tp-sharded parameter and its moments over ``tp``; then rank 0 alone writes
the files, in the same form as a single process does, so that they load
without a group.
"""
import json
from pathlib import Path

import numpy as np
import torch

from vp_suite_tpu_torch.models import MODEL_CLASSES, build_model
from vp_suite_tpu_torch.parallel.distributed import process_index
from vp_suite_tpu_torch.parallel.mesh import is_fsdp
from vp_suite_tpu_torch.parallel.tensor import sharded_params, whole
from vp_suite_tpu_torch.training.train_state import (create_train_state, load_optimizer_state,
                                                      optimizer_state_dict)
from vp_suite_tpu_torch.utils.utils import resolve_device, torch_dtype

CHECKPOINT_FILE = "checkpoint.pt"


def _jsonable(obj):
    if isinstance(obj, (list, tuple)):
        return [_jsonable(o) for o in obj]
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, torch.dtype):
        return str(obj).removeprefix("torch.")
    return obj


def save_checkpoint(ckpt_dir, state, model_id: str, model_config: dict, run_config: dict = None):
    r"""Writes ``state`` (a :class:`~vp_suite_tpu_torch.training.train_state.TrainState`)
    and the model's registry id and configuration into ``ckpt_dir``; in a
    process group, every process calls it and rank 0 writes."""
    opt = state.optimizer
    model_sd, opt_sd = _full_state(state)
    if process_index() != 0:
        return
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    torch.save({"model": model_sd,
                "optimizer": opt_sd,
                "optimizer_name": type(opt).__name__.lower() if opt is not None else None,
                "step": state.step,
                "model_state": state.model_state}, ckpt_dir / CHECKPOINT_FILE)
    write_sidecars(ckpt_dir, model_id, model_config, run_config)


def write_sidecars(ckpt_dir, model_id, model_config, run_config=None, **extra):
    r"""Writes ``model_config.json`` (``{"model_id", "model_config", **extra}``)
    and, where ``run_config`` is given, ``run_cfg.json`` into ``ckpt_dir``."""
    with open(ckpt_dir / "model_config.json", "w") as f:
        json.dump({"model_id": model_id, "model_config": _jsonable(model_config), **extra}, f,
                  indent=2, default=str)
    if run_config is not None:
        with open(ckpt_dir / "run_cfg.json", "w") as f:
            json.dump(_jsonable(run_config), f, indent=2, default=str)


def _full_state(state):
    r"""``(model state_dict, optimizer state_dict or None)`` of the whole
    state. Under FSDP every process joins the gather, the optimizer's state
    in the plain index-keyed form; without tensor parallelism rank 0 alone
    gets the full tensors, on the CPU (the others get empty dicts). Every
    tp-sharded parameter and moment is then gathered whole over ``tp`` on
    every process, which therefore needs FSDP's full tensors on every process
    (on the device: NCCL gathers no CPU tensors)."""
    specs = sharded_params(state.model)
    model_sd, opt_sd = _unsharded_state(state, cpu_offload=not specs)
    if not specs:
        return model_sd, opt_sd
    model_sd = {k: whole(k, v, specs) for k, v in model_sd.items()}
    if opt_sd:
        names = [n for n, p in state.model.named_parameters() if p.requires_grad]
        opt_sd = {**opt_sd, "state": {i: {k: whole(names[i], v, specs) for k, v in st.items()}
                                      for i, st in opt_sd["state"].items()}}
    return model_sd, opt_sd


def _unsharded_state(state, cpu_offload):
    r""":func:`_full_state` before the tp gather: FSDP's shards gathered, to
    rank 0's CPU with ``cpu_offload``, else to every process's device."""
    model, opt = state.model, state.optimizer
    if not is_fsdp(model):
        return model.state_dict(), optimizer_state_dict(opt) if opt is not None else None
    from torch.distributed.checkpoint.state_dict import (StateDictOptions, get_model_state_dict,
                                                         get_state_dict)
    options = StateDictOptions(full_state_dict=True, cpu_offload=cpu_offload)
    if opt is None:
        return get_model_state_dict(model, options=options), None
    model_sd, fqn_sd = get_state_dict(model, opt, options=options)
    if not fqn_sd:
        return model_sd, {}
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    index = {n: i for i, n in enumerate(names)}
    group = {k: v for k, v in fqn_sd["param_groups"][0].items() if k != "params"}
    group["lr"] = float(group["lr"])
    return model_sd, {"state": {index[n]: st for n, st in fqn_sd["state"].items()},
                      "param_groups": [{**group, "params": list(range(len(names)))}]}


def model_from_config(model_id: str, model_config: dict, device="cuda"):
    r"""A registry model built from a configuration dict (``VPModel.config``
    or its JSON form) on ``device`` (the card unless the caller asks for the
    CPU; raises without one); its parameters are freshly initialised."""
    device = resolve_device(device, "model_from_config")
    cls = MODEL_CLASSES[model_id]
    names = set(cls.hparam_names())
    kwargs = {}
    for k, v in model_config.items():
        if k not in names:
            continue
        if isinstance(v, list):
            v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        if k == "compute_dtype":
            v = torch_dtype(v)
        kwargs[k] = v
    return build_model(model_id, 0, device, **kwargs)


def load_checkpoint(ckpt_dir, device="cuda"):
    r"""``(model, state, model_id)`` from a checkpoint directory of either
    backend, on ``device`` (the card unless the caller asks for the CPU;
    raises without one)."""
    device = resolve_device(device, "load_checkpoint")
    ckpt_dir = Path(ckpt_dir)
    with open(ckpt_dir / "model_config.json", "r") as f:
        cfg = json.load(f)
    if cfg.get("backend", "msgpack") == "orbax":
        from vp_suite_tpu_torch.checkpoint.orbax_backend import load_checkpoint_orbax
        return load_checkpoint_orbax(ckpt_dir, device)
    model = model_from_config(cfg["model_id"], cfg["model_config"], device)
    ckpt = torch.load(ckpt_dir / CHECKPOINT_FILE, map_location=device, weights_only=True)
    model.load_state_dict(ckpt["model"])
    state = create_train_state(model, optimizer=ckpt["optimizer_name"] or "adam")
    if ckpt["optimizer"] is not None:
        load_optimizer_state(state.optimizer, ckpt["optimizer"])
    state.step = ckpt["step"]
    state.model_state = ckpt["model_state"]
    return model, state, cfg["model_id"]
