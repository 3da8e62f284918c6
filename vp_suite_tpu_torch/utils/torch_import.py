r"""Checkpoints of the reference vp-suite (PyTorch) into the port's models;
the port's counterpart of the JAX package's ``utils/torch_import.py``.

The reference saves trained models as pickled modules (``torch.save(model)``).
The port keeps the reference's parameter names and torch layouts (for
example ``encoder.rnn1._conv.weight`` ``(256, 80, 3, 3)`` and
``encoder.rnn1.Wci`` ``(1, 64, 64, 64)``), so its importer works by name:

- :func:`import_state_dict` takes a flat reference ``state_dict`` (name ->
  tensor or numpy array) for one of the eight ids the reference has, as
  tensors (cast to ``dtype`` if given); the port-only ids are refused, with
  the JAX package's message.
- :func:`import_torch_model` takes an unpickled reference module: the model
  id from its class name, the constructor arguments from its attributes
  (each hyperparameter the port's model class takes, by name), and its
  ``state_dict``; :func:`load_torch_checkpoint` ``torch.load`` s a ``*.pth``
  file into it (the reference package must be importable to unpickle).
- :func:`model_from_import` builds the port's model and loads the weights.

The reference LSTM keeps its ``nn.LSTMCell`` s in a plain Python list, so
they are absent from its ``state_dict`` (and were never trained): the
importer recovers what the pickle holds by attribute access, and a
``state_dict`` without them leaves the port's freshly initialised cells in
place, as the JAX facade keeps its fresh cells. BatchNorm's
``num_batches_tracked`` counters, which the port's BatchNorm does not keep,
are dropped.
"""
import numpy as np
import torch

__all__ = ["import_state_dict", "import_torch_model", "load_torch_checkpoint",
           "model_from_import", "TORCH_CLASS_TO_MODEL_ID"]

#: reference torch class name -> registry id
TORCH_CLASS_TO_MODEL_ID = {
    "CopyLastFrame": "copy",
    "LSTM": "lstm",
    "UNet3D": "unet-3d",
    "PhyDNet": "phy",
    "STPhy": "st-phy",
    "PredRNN_V2": "predrnn-pp",
    "EF_ConvLSTM": "convlstm-shi",
    "EF_TrajGRU": "trajgru",
}
_LSTM_CELL_ATTRS = ("weight_ih", "bias_ih", "weight_hh", "bias_hh")


def _tensor(value, dtype=None):
    t = value.detach().cpu() if isinstance(value, torch.Tensor) \
        else torch.from_numpy(np.array(value))
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def import_state_dict(model_id, state_dict, dtype=None) -> dict:
    r"""The reference ``state_dict`` of a model ``model_id`` (``copy``,
    ``lstm``, ``unet-3d``, ``phy``, ``st-phy``, ``predrnn-pp``,
    ``convlstm-shi``, ``trajgru``) as the port's: CPU tensors under the same
    names, floating ones cast to ``dtype`` (a torch dtype) if given."""
    if model_id not in TORCH_CLASS_TO_MODEL_ID.values():
        raise ValueError(
            f"no torch importer for model id '{model_id}' "
            f"(available: {sorted(TORCH_CLASS_TO_MODEL_ID.values())}); TPU-native extras have "
            f"no torch analog to import from")
    return {k: _tensor(v, dtype) for k, v in state_dict.items()}


def _infer_model_kwargs(model_id, ref_model):
    r"""Constructor arguments of the port's model, read off the reference
    module's attributes: every hyperparameter of the port's model class
    whose name is an attribute of the module holding a bool, int, float or
    str or (nested) tuples of them, plus the basics. (The JAX package's
    importer reads flat tuples only, so it drops EF-TrajGRU's per-layer
    ``(k, k)`` kernel sizes and falls back to its defaults.)"""
    from vp_suite_tpu_torch.models import MODEL_CLASSES
    basics = {"img_shape", "action_size", "action_conditional", "tensor_value_range",
              "compute_dtype"}
    kwargs = {
        "img_shape": tuple(ref_model.img_shape),
        "action_size": int(getattr(ref_model, "action_size", 0) or 0),
        "action_conditional": bool(getattr(ref_model, "action_conditional", False)),
        "tensor_value_range": tuple(getattr(ref_model, "tensor_value_range", (0.0, 1.0))),
    }
    for name in MODEL_CLASSES[model_id].hparam_names():
        value = _plain(getattr(ref_model, name, None))
        if name not in basics and value is not None:
            kwargs[name] = value
    return kwargs


def _plain(value):
    r"""``value`` if it is a bool, int, float or str, a (nested) tuple of such
    for a tuple or list of them, else None."""
    if isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, (tuple, list)):
        items = [_plain(v) for v in value]
        return None if any(v is None for v in items) else tuple(items)
    return None


def import_torch_model(ref_model):
    r"""``(model_id, model_kwargs, state_dict)`` of an unpickled reference
    module, ready for :func:`model_from_import`. The LSTM's cells, absent
    from its ``state_dict``, are read from its ``rnn_layers`` list."""
    cls_name = type(ref_model).__name__
    if cls_name not in TORCH_CLASS_TO_MODEL_ID:
        raise ValueError(f"unrecognized reference model class '{cls_name}' "
                         f"(known: {sorted(TORCH_CLASS_TO_MODEL_ID)})")
    model_id = TORCH_CLASS_TO_MODEL_ID[cls_name]
    sd = dict(ref_model.state_dict())
    if model_id == "lstm":
        for i, cell in enumerate(getattr(ref_model, "rnn_layers", [])):
            for attr in _LSTM_CELL_ATTRS:
                sd.setdefault(f"rnn_layers.{i}.{attr}", getattr(cell, attr))
    return model_id, _infer_model_kwargs(model_id, ref_model), import_state_dict(model_id, sd)


def load_torch_checkpoint(ckpt_path):
    r"""``torch.load`` s a reference ``*.pth`` checkpoint (a pickled module;
    the classes it names must be importable) and imports it:
    ``(model_id, model_kwargs, state_dict)``."""
    ref_model = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    return import_torch_model(ref_model)


def model_from_import(model_id, model_kwargs, state_dict, device="cuda", seed=0):
    r"""The port's model ``model_id`` built with ``model_kwargs`` (parameters
    drawn from ``seed``), the imported weights loaded, on ``device``. Raises
    ``ValueError`` when the weights do not fit the model: a missing or
    unexpected name or another shape; only the LSTM may lack its cells
    (``rnn_layers.*``), which keep their fresh values."""
    from vp_suite_tpu_torch.models import build_model
    model = build_model(model_id, seed, "cpu", **model_kwargs)
    own = model.state_dict()
    sd = {k: v for k, v in state_dict.items()
          if not (k.endswith("num_batches_tracked") and k not in own)}
    missing = sorted(set(own) - set(sd))
    if model_id == "lstm":
        missing = [k for k in missing if not k.startswith("rnn_layers.")]
    unexpected = sorted(set(sd) - set(own))
    wrong = sorted(k for k in set(sd) & set(own) if tuple(sd[k].shape) != tuple(own[k].shape))
    if missing or unexpected or wrong:
        raise ValueError(
            f"imported torch checkpoint does not match model '{model_id}' built with "
            f"{model_kwargs}: missing {missing}, unexpected {unexpected}, other shapes "
            f"{[(k, tuple(sd[k].shape), tuple(own[k].shape)) for k in wrong]}")
    model.load_state_dict(sd, strict=False)
    return model.to(device).eval()
