r"""Base class for all video prediction models.

Hyperparameters are the lowercase class attributes of a model class and its
``VPModel`` bases; the constructor overrides them by keyword and rejects
unknown names, as the JAX package's dataclass fields do. Parameters are
created by the subclass constructor and initialised by
:meth:`VPModel.reset_parameters` from a ``torch.Generator``, so a model's
initial weights depend on its seed alone. Tensors are ``[b, t, h, w, c]``.
"""
import torch
from torch import nn


class VPModel(nn.Module):
    r"""The base class for all video prediction models."""

    # --- model constants (the reference vp-suite's names and meaning) ---
    NAME = None
    PAPER_REFERENCE = None
    CODE_REFERENCE = None
    MATCHES_REFERENCE = None
    REQUIRED_ARGS = ["img_shape", "action_size", "tensor_value_range"]
    CAN_HANDLE_ACTIONS = False
    TRAINABLE = True
    NEEDS_COMPLETE_INPUT = False
    MIN_CONTEXT_FRAMES = 1
    TRAIN_REGIME = "default"        #: "default", "teacher_forcing" or "scheduled_sampling"

    # --- common hyperparameters ---
    img_shape = None                #: (c, h, w), the reference's ordering.
    action_size = 0
    tensor_value_range = (0.0, 1.0)
    action_conditional = False
    compute_dtype = torch.float32   #: torch.bfloat16 for bf16 activations over f32 params.

    def __init__(self, **hparams):
        super().__init__()
        names = self.hparam_names()
        unknown = sorted(set(hparams) - set(names))
        if unknown:
            raise TypeError(f"{type(self).__name__} got unknown hyperparameters {unknown} "
                            f"(known: {names})")
        for name, value in hparams.items():
            setattr(self, name, value)

    @classmethod
    def hparam_names(cls):
        r"""Names of the hyperparameters, base classes' first."""
        names = []
        for klass in reversed(cls.__mro__):
            if not (isinstance(klass, type) and issubclass(klass, VPModel)):
                continue
            for name, value in vars(klass).items():
                if name.startswith("_") or name.isupper() or name in names \
                        or callable(value) or isinstance(value, (property, classmethod,
                                                                 staticmethod)):
                    continue
                names.append(name)
        return names

    @property
    def img_c(self):
        return self.img_shape[0]

    @property
    def img_h(self):
        return self.img_shape[1]

    @property
    def img_w(self):
        return self.img_shape[2]

    @property
    def config(self) -> dict:
        r"""The model's configuration as a flat dict."""
        cfg = {name: getattr(self, name) for name in self.hparam_names()}
        cfg["compute_dtype"] = str(self.compute_dtype).removeprefix("torch.")
        img_c, img_h, img_w = self.img_shape
        cfg.update({"img_h": img_h, "img_w": img_w, "img_c": img_c, "NAME": self.NAME})
        return cfg

    def reset_parameters(self, generator=None):
        r"""(Re)initialises every submodule's parameters in registration order,
        drawing from ``generator``."""
        for module in self.modules():
            if module is not self and hasattr(module, "reset_parameters"):
                module.reset_parameters(generator)

    def init_model_state(self) -> dict:
        r"""The model's training schedules (the reference's mutable
        attributes, such as PredRNN++'s sampling eta), which the train step
        carries in its state; none by default."""
        return {}

    @staticmethod
    def unpack_data(batch: dict, config: dict, reverse: bool = False, complete: bool = False,
                    needs_complete_input: bool = False):
        r"""Extracts ``(input_frames, target_frames, actions)`` from a batch dict
        (parity: the reference's ``base_model.py:87-114``). Frames are
        ``[b, T, h, w, c]`` (a single ``[T, h, w, c]`` sequence gains a batch
        axis); uint8 frames are scaled to [0, 1]."""
        frames = batch["frames"]
        actions = batch.get("actions")
        if frames.dtype == torch.uint8:
            frames = frames.float() / 255.0
        if frames.dim() == 4:
            frames = frames[None]
            if actions is not None:
                actions = actions[None]
        if reverse:
            frames = frames.flip(1)
            if actions is not None:
                actions = actions.flip(1)
        t_in, t_pred = config["context_frames"], config["pred_frames"]
        total = t_in + t_pred
        if needs_complete_input or complete:
            input_frames = frames[:, :total]
        else:
            input_frames = frames[:, :t_in]
        return input_frames, frames[:, t_in:total], actions

    def pred_1(self, x, **kwargs):
        r"""Predicts one future frame ``[b, h, w, c]`` from the context
        ``[b, t, h, w, c]``."""
        preds, _ = self(x, pred_frames=1, **kwargs)
        return preds[:, 0]

    def forward(self, x, pred_frames: int = 1, actions=None, train: bool = False, **kwargs):
        r"""Full rollout: ``[b, t, h, w, c] -> ([b, p, h, w, c], aux_losses)``."""
        raise NotImplementedError
