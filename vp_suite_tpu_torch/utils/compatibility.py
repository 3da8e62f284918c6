r"""Model/dataset/run compatibility checks and adapters (the JAX package's
``utils/compatibility.py``).

A value-range or image-size difference between a model and a dataset is
bridged by pre/post adapters over ``[b, t, h, w, c]`` tensors (``VPSuite.test``
uses them); strict mode, which ``VPSuite.train`` uses, raises instead.
"""
import warnings

from vp_suite_tpu_torch.ops.image import resize_bilinear
from vp_suite_tpu_torch.utils.models import ScaleToModel, ScaleToTest


class AdapterChain:
    r"""Composition of adapters; the identity when empty."""

    def __init__(self, fns=None):
        self.fns = list(fns or [])

    def __call__(self, x):
        for fn in self.fns:
            x = fn(x)
        return x

    def __len__(self):
        return len(self.fns)


class ResizeAdapter:
    r"""Resizes frames to ``size`` (h, w), bilinearly."""

    def __init__(self, size):
        self.size = size

    def __call__(self, x):
        return resize_bilinear(x, self.size)


def check_model_and_data_compat(model, dataset, strict_mode=False):
    r"""Returns the (preprocessing, postprocessing) adapter chains."""
    model_config = model.config
    dataset_config = dataset.config
    pre, post = [], []

    model_value_range = list(model_config["tensor_value_range"])
    test_value_range = list(dataset_config["tensor_value_range"])
    if model_value_range != test_value_range:
        if strict_mode:
            raise ValueError("Model and run value ranges differ")
        pre.append(ScaleToModel(model_value_range, test_value_range))
        post.append(ScaleToTest(model_value_range, test_value_range))

    model_c, model_h, model_w = model_config["img_shape"]
    test_c, test_h, test_w = dataset_config["img_shape"]
    if model_c != test_c:
        raise ValueError(f"Test dataset provides {test_c}-channel images but "
                         f"Model '{model.NAME}' expects {model_c} channels")
    elif model_h != test_h or model_w != test_w:
        if strict_mode:
            raise ValueError("Model and run img sizes differ")
        pre.append(ResizeAdapter((model_h, model_w)))
        post.append(ResizeAdapter((test_h, test_w)))

    if model.CAN_HANDLE_ACTIONS and model_config["action_conditional"]:
        if dataset_config["action_size"] <= 0:
            raise ValueError("Can't use action-conditional model on a dataset "
                             "that doesn't provide actions.")
        if model_config["action_size"] != dataset_config["action_size"]:
            raise ValueError("Action size of action-conditional model and dataset "
                             "must be equal")

    return AdapterChain(pre), AdapterChain(post)


def check_run_and_model_compat(model, run_config: dict):
    r"""Raises on critical run/model inconsistencies."""
    model_config = model.config
    mdl_ac, run_ac = model_config["action_conditional"], run_config["use_actions"]
    if model.CAN_HANDLE_ACTIONS:
        if mdl_ac and not run_ac:
            raise ValueError(f"Action-conditioned model '{model.NAME}' can't be invoked "
                             f"without using actions -> set 'use_actions' to True!")
        elif not mdl_ac and run_ac:
            raise ValueError(f"Action-conditionable model '{model.NAME}' was created "
                             f"without using actions -> set 'use_actions' to False!")
    elif run_ac:
        warnings.warn(f"Model '{model.NAME}' can't handle actions -> running it without "
                      f"using the actions provided by the dataset")

    min_ctx = model.MIN_CONTEXT_FRAMES
    if run_config["context_frames"] < min_ctx:
        raise ValueError(f"Model '{model.NAME}' needs at least {min_ctx} context frames")
