r"""Checkpoints: model parameters, optimizer state, step and training
schedules, with the configuration that rebuilds the model.

A checkpoint directory holds
- ``checkpoint.pt``: ``torch.save`` of ``{"model": state_dict, "optimizer":
  the optimizer's state_dict (its moments and learning rate), "optimizer_name",
  "step", "model_state"}`` (``optimizer`` and ``optimizer_name`` are None
  for a model with nothing to train);
- ``model_config.json``: ``{"model_id", "model_config"}``, from which the
  registry rebuilds the model;
- ``run_cfg.json``: the run configuration, where one is given.

This is the counterpart of the JAX package's msgpack checkpoint; its orbax
(sharded) backend is not ported.
"""
import json
from pathlib import Path

import numpy as np
import torch

from vp_suite_tpu_torch.models import MODEL_CLASSES, build_model
from vp_suite_tpu_torch.training.train_state import create_train_state
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
    and the model's registry id and configuration into ``ckpt_dir``."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    opt = state.optimizer
    torch.save({"model": state.model.state_dict(),
                "optimizer": opt.state_dict() if opt is not None else None,
                "optimizer_name": type(opt).__name__.lower() if opt is not None else None,
                "step": state.step,
                "model_state": state.model_state}, ckpt_dir / CHECKPOINT_FILE)
    with open(ckpt_dir / "model_config.json", "w") as f:
        json.dump({"model_id": model_id, "model_config": _jsonable(model_config)}, f,
                  indent=2, default=str)
    if run_config is not None:
        with open(ckpt_dir / "run_cfg.json", "w") as f:
            json.dump(_jsonable(run_config), f, indent=2, default=str)


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
    r"""``(model, state, model_id)`` from a checkpoint directory, on ``device``
    (the card unless the caller asks for the CPU; raises without one)."""
    device = resolve_device(device, "load_checkpoint")
    ckpt_dir = Path(ckpt_dir)
    with open(ckpt_dir / "model_config.json", "r") as f:
        cfg = json.load(f)
    if cfg.get("backend", "msgpack") != "msgpack":
        raise NotImplementedError(f"checkpoints of the '{cfg['backend']}' backend are not "
                                  f"ported yet")
    model = model_from_config(cfg["model_id"], cfg["model_config"], device)
    ckpt = torch.load(ckpt_dir / CHECKPOINT_FILE, map_location=device, weights_only=True)
    model.load_state_dict(ckpt["model"])
    state = create_train_state(model, optimizer=ckpt["optimizer_name"] or "adam")
    if ckpt["optimizer"] is not None:
        state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = ckpt["step"]
    state.model_state = ckpt["model_state"]
    return model, state, cfg["model_id"]
