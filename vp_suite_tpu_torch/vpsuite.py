r"""The VPSuite facade of the port: model creation and direct inference.

Same semantics as the JAX package's ``VPSuite.create_model`` and
``VPSuite.predict``: REQUIRED_ARGS come from the keyword arguments (datasets
are not ported yet, so none can supply them), models come from the registry,
a single ``[t, h, w, c]`` context sequence is accepted, actions are zero-filled
when absent, and the predictor is cached per ``(context, horizon,
action_conditional)``. Models run on CUDA unless the caller asks for the CPU.
"""
import warnings

import torch

from vp_suite_tpu_torch.defaults import DEFAULT_RUN_CONFIG
from vp_suite_tpu_torch.models import AVAILABLE_MODELS, MODEL_CLASSES
from vp_suite_tpu_torch.training.loop import make_predict_fn


class ModelEntry:
    r"""A created model (an ``nn.Module`` on the suite's device) with its
    registry id and cached predictors."""

    def __init__(self, model, model_id):
        self.model = model
        self.model_id = model_id
        self.predict_fns = {}

    @property
    def NAME(self):
        return self.model.NAME

    @property
    def config(self):
        return self.model.config


class VPSuite:
    def __init__(self, device: str = "cuda"):
        r"""device: ``"cuda"`` (default; the current card), ``"cuda:N"`` or
        ``"cpu"``. Raises when a CUDA device is asked for and none is
        available: the CPU runs only when the caller asks for it."""
        device = torch.device(device)
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("VPSuite: no CUDA device is available "
                                   "(pass device='cpu' to run on the CPU)")
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
        elif device.type != "cpu":
            raise ValueError(f"VPSuite runs on 'cuda' or 'cpu', not '{device}'")
        self.device = device
        self.clear_models()

    def clear_models(self):
        self.models = []

    def list_available_models(self):
        for model_id, model_class in MODEL_CLASSES.items():
            print(f"'{model_id}': {model_class.NAME}")

    def create_model(self, model_id: str, action_conditional: bool = False,
                     seed: int = None, **model_kwargs):
        r"""Creates a registry model with parameters drawn from a
        ``torch.Generator`` seeded with ``seed`` (default 42) on the CPU, then
        moved to the suite's device; returns its :class:`ModelEntry`."""
        if model_id not in AVAILABLE_MODELS:
            raise ValueError(f"invalid model type specified! "
                             f"Available model types: {list(AVAILABLE_MODELS)}")
        model_class = MODEL_CLASSES[model_id]
        for param in model_class.REQUIRED_ARGS:
            if param not in model_kwargs:
                print(f"model parameter '{param}' not specified "
                      f"-> trying to take from last loaded dataset...")
                raise ValueError(f"no dataset loaded to take parameter '{param}' from")
        if action_conditional and not model_class.CAN_HANDLE_ACTIONS:
            warnings.warn("specified model can't handle actions "
                          "-> argument 'action_conditional' set to False")
            action_conditional = False
        model_kwargs["action_conditional"] = action_conditional
        for k, v in list(model_kwargs.items()):
            if isinstance(v, list):
                model_kwargs[k] = tuple(v)

        # build without drawing from torch's global RNG, then draw from the seed
        with torch.device("meta"):
            model = model_class(**model_kwargs)
        model = model.to_empty(device="cpu")
        seed = DEFAULT_RUN_CONFIG["seed"] if seed is None else seed
        model.reset_parameters(torch.Generator().manual_seed(seed))
        model = model.to(self.device).eval()
        entry = ModelEntry(model, model_id)
        print(f"created new model '{entry.NAME}' "
              f"{'(action-conditional)' if action_conditional else ''}")
        print(f" - Model parameters (total): {sum(p.numel() for p in model.parameters())}")
        self.models.append(entry)
        return entry

    def predict(self, frames, actions=None, pred_frames: int = None, model_idx: int = -1):
        r"""Direct inference: context ``frames`` ``[b, t, h, w, c]`` (or one
        ``[t, h, w, c]`` sequence) in the model's value range ->
        ``[b, pred_frames, h, w, c]`` float32 predictions of the frames after
        them, on the suite's device. ``actions``, when given, must cover
        ``t + pred_frames`` steps."""
        if not self.models:
            raise ValueError("No model available for prediction")
        entry = self.models[model_idx]
        model = entry.model
        pred_frames = pred_frames or 1
        frames = torch.as_tensor(frames, dtype=torch.float32, device=self.device)
        squeeze = frames.dim() == 4
        if squeeze:
            frames = frames[None]
        b, ctx = frames.shape[:2]
        if ctx < (model.MIN_CONTEXT_FRAMES or 1):
            raise ValueError(f"need at least {model.MIN_CONTEXT_FRAMES} "
                             f"context frames, got {ctx}")
        total = ctx + pred_frames
        if model.NEEDS_COMPLETE_INPUT:
            frames = torch.cat([frames, frames.new_zeros((b, pred_frames, *frames.shape[2:]))],
                               dim=1)
        if actions is not None:
            actions = torch.as_tensor(actions, dtype=torch.float32, device=self.device)
            if squeeze and actions.dim() == 2:
                actions = actions[None]
            if actions.shape[1] < total:
                raise ValueError(f"actions must cover context + horizon "
                                 f"({total} steps), got {actions.shape[1]}")
            actions = actions[:, :total]
        else:
            actions = torch.zeros((b, total, max(model.action_size, 1)), dtype=torch.float32,
                                  device=self.device)

        key = (ctx, pred_frames, bool(model.action_conditional))
        if key not in entry.predict_fns:
            entry.predict_fns[key] = make_predict_fn(
                model, {"context_frames": ctx, "pred_frames": pred_frames,
                        "use_actions": model.action_conditional})
        preds, _ = entry.predict_fns[key]({"frames": frames, "actions": actions})
        return preds[0] if squeeze else preds
