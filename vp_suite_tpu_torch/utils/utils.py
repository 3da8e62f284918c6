r"""Core utilities of the kwargs-based configuration system (the JAX
package's ``utils/utils.py``, the parts that the datasets and the facade use)."""
import random
import signal
import sys
from datetime import datetime

import torch


class PytestExpectedException(Exception):
    r"""Raised instead of downloading datasets when running under pytest."""


def most(lst, factor=0.67):
    r"""True iff at least ``factor`` of the entries of ``lst`` are truthy."""
    lst = list(lst)
    if len(lst) == 0:
        return False
    return sum(1 for x in lst if x) >= factor * len(lst)


def seeded_shuffle_split(items, ratio, seed, at_least_one=False):
    r"""``(first, second)``: a copy of ``items`` shuffled by
    ``random.Random(seed)``, cut at ``int(len * ratio)`` (at least 1 with
    ``at_least_one``); the split membership of the path-globbing datasets."""
    pool = list(items)
    random.Random(seed).shuffle(pool)
    cut = int(len(pool) * ratio)
    if at_least_one:
        cut = max(1, cut)
    return pool[:cut], pool[cut:]


def timed_input(prompt: str, default=None, secs: int = 60):
    r"""Asks for a value on the terminal, taking ``default`` after ``secs``
    seconds, or at once when the input is not a terminal."""
    if not sys.stdin.isatty():
        return default

    def _timeout(signum, frame):
        raise TimeoutError

    old = signal.signal(signal.SIGALRM, _timeout)
    signal.alarm(secs)
    try:
        result = input(f"{prompt} (default: {default}, {secs}s timeout): ").strip()
        return result if result else default
    except TimeoutError:
        print(f"\n... timed out, using default: {default}")
        return default
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def resolve_device(device, who: str) -> torch.device:
    r"""``device`` (``"cuda"``, ``"cuda:N"`` or ``"cpu"``) as a
    ``torch.device``, a bare ``"cuda"`` pinned to the current card. Raises when
    a CUDA device is asked for and none is available: the CPU runs only when
    the caller asks for it."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{who}: no CUDA device is available "
                               f"(pass device='cpu' to run on the CPU)")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"{who} runs on 'cuda' or 'cpu', not '{device}'")
    return device


def timestamp(program: str = "") -> str:
    r"""Returns a timestamp string usable as a directory name."""
    stamp = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    return f"{program}_{stamp}" if program else stamp


def set_from_kwarg(obj, kwarg_dict: dict, attr_name: str, default=None, required: bool = False,
                   choices=None, skip_unusable: bool = False):
    r"""Sets ``obj.<attr_name>`` from ``kwarg_dict`` if present, type-checked
    against the attribute's current value and validated against ``choices``."""
    attr_val = kwarg_dict.get(attr_name, default)
    if attr_name not in kwarg_dict:
        if required:
            raise ValueError(f"missing required argument: '{attr_name}'")
        if default is None:
            return
    if hasattr(obj, attr_name):
        cur = getattr(obj, attr_name)
        if cur is not None and attr_val is not None and not isinstance(cur, type(NotImplemented)):
            cur_t, new_t = type(cur), type(attr_val)
            compatible = (cur_t == new_t
                          or (cur_t in (list, tuple) and new_t in (list, tuple))
                          or (cur_t in (int, float) and new_t in (int, float)))
            if not compatible:
                if skip_unusable:
                    return
                raise TypeError(f"mismatching types for argument '{attr_name}' "
                                f"(expected: {cur_t}, got: {new_t})")
    elif skip_unusable:
        return
    if choices is not None:
        vals = attr_val if isinstance(attr_val, (list, tuple)) else [attr_val]
        for v in vals:
            if v not in choices:
                raise ValueError(f"invalid value for argument '{attr_name}': {v} "
                                 f"(valid choices: {choices})")
    setattr(obj, attr_name, attr_val)


def get_public_attrs(obj, calling_method: str = None, non_config_vars=None,
                     model_mode: bool = False) -> dict:
    r"""An object's public, non-constant, non-callable attributes as a flat
    dict: skips private names, ALL-CAPS constants, properties, callables,
    ``calling_method`` and ``non_config_vars`` (and, in ``model_mode``,
    anything with a ``shape``)."""
    non_config_vars = set(non_config_vars or [])
    attrs = {}
    cls = type(obj)
    names = set()
    for klass in cls.__mro__:
        names.update(vars(klass).keys())
    names.update(vars(obj).keys() if hasattr(obj, "__dict__") else [])
    for name in sorted(names):
        if name.startswith("_") or name == calling_method or name in non_config_vars:
            continue
        if name.isupper():
            continue
        if isinstance(getattr(cls, name, None), property):
            continue
        try:
            val = getattr(obj, name)
        except AttributeError:
            continue
        if callable(val):
            continue
        if model_mode and hasattr(val, "shape"):
            continue
        attrs[name] = val
    return attrs


def torch_dtype(value):
    r"""A torch dtype from a dtype or its name (``"bfloat16"``, ``"torch.float32"``)."""
    if isinstance(value, torch.dtype):
        return value
    dtype = getattr(torch, str(value).removeprefix("torch."), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown compute_dtype '{value}'")
    return dtype


def check_optuna_config(optuna_cfg: dict):
    r"""Validates a hyperopt search space, as the JAX package does: each entry
    maps a run-config parameter to ``{"choices": [...]}`` or ``{"min": x,
    "max": y, ["scale": "log"], ["type": "int"]}``; raises ``ValueError``
    otherwise."""
    if not isinstance(optuna_cfg, dict):
        raise ValueError("hyperopt config must be a dict")
    for param, spec in optuna_cfg.items():
        if not isinstance(spec, dict):
            raise ValueError(f"hyperopt config entry '{param}' must be a dict")
        if "choices" in spec:
            if not isinstance(spec["choices"], list) or len(spec["choices"]) == 0:
                raise ValueError(f"hyperopt config entry '{param}': 'choices' must be a "
                                 f"non-empty list")
        else:
            if "min" not in spec or "max" not in spec:
                raise ValueError(f"hyperopt config entry '{param}' needs 'min' and 'max' "
                                 f"(or 'choices')")
            if spec["min"] > spec["max"]:
                raise ValueError(f"hyperopt config entry '{param}': min > max")
