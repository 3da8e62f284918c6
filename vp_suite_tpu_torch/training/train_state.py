r"""Training state.

The JAX package keeps params, optimizer state, step, schedules and a PRNG key
in one immutable pytree that each jitted step consumes and returns. In
PyTorch the parameters live in the model and the optimizer holds its own
moments, so the state is a mutable record of those objects: the model, its
optimizer (``torch.optim.Adam`` by default, with ``optax.adam``'s defaults,
betas 0.9/0.999 and eps 1e-8, and the same update formula), the optimizer
step count, the functional training schedules (``model_state``) and an
explicit ``torch.Generator`` in place of the PRNG key, for regimes that draw.
A model with nothing to train (``TRAINABLE = False``, or no parameter that
requires grad) gets no optimizer, as the JAX package gives it no optimizer
state. Under FSDP the optimizer is built over the sharded parameters, so its
moments are sharded like them (:func:`rebuild_optimizer`).

On the card the optimizer can be captured into a CUDA graph
(``training/graphs.py``): Adam is built ``capturable`` (its step count a
device tensor) and both optimizers hold the learning rate as a 0-d f32 tensor
on the card, which :func:`~vp_suite_tpu_torch.training.schedule.set_learning_rate`
fills in place, so that a replayed step reads the rate the host set last (SGD
runs its fused update, the one that reads a tensor rate on the card). CPU
states, and FSDP's sharded parameters (whose DTensors the capturable update
does not take), keep a float rate.
"""
import dataclasses

import torch

from vp_suite_tpu_torch.defaults import DEFAULT_RUN_CONFIG


def _adam(params, lr, graphable):
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, capturable=graphable)


def _sgd(params, lr, graphable):
    return torch.optim.SGD(params, lr=lr, fused=True) if graphable else \
        torch.optim.SGD(params, lr=lr)


#: name -> ``(params, lr, graphable) -> optimizer``; ``graphable``: the form a
#: CUDA graph can capture, with ``lr`` a 0-d tensor on the card
OPTIMIZERS = {"adam": _adam, "sgd": _sgd}


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer                           #: None: nothing to train
    step: int = 0                                              #: optimizer steps taken
    model_state: dict = dataclasses.field(default_factory=dict)  #: training schedules
    generator: torch.Generator = None                         #: randomness of the regimes that draw


def _param_groups(params):
    r"""``params`` as they go to the optimizer: one list, or under FSDP two
    groups, the sharded (DTensor) parameters and the whole ones, since the
    optimizers' multi-tensor updates take no mix of the two."""
    from torch.distributed.tensor import DTensor
    sharded = [p for p in params if isinstance(p, DTensor)]
    if not sharded or len(sharded) == len(params):
        return params
    return [{"params": sharded}, {"params": [p for p in params if not isinstance(p, DTensor)]}]


def _graphable(params):
    r"""Whether an optimizer over ``params`` is built to be captured: every
    parameter a plain tensor on the card."""
    from torch.distributed.tensor import DTensor
    return bool(params) and all(p.is_cuda and not isinstance(p, DTensor) for p in params)


def _make_optimizer(name, params, lr):
    graphable = _graphable(params)
    if graphable:
        lr = torch.tensor(float(lr), dtype=torch.float32, device=params[0].device)
    return OPTIMIZERS[name](_param_groups(params), lr, graphable)


def optimizer_state_dict(optimizer):
    r"""``optimizer.state_dict()`` with each group's learning rate a float,
    the form checkpoints keep: it loads into a state on the card or the CPU
    (:func:`load_optimizer_state`)."""
    sd = optimizer.state_dict()
    return {**sd, "param_groups": [{**g, "lr": float(g["lr"])} for g in sd["param_groups"]]}


#: the keys of a parameter group that say how this optimizer runs, not what it
#: has learnt: a loaded state keeps its own
_RUN_KEYS = ("capturable", "fused", "foreach", "differentiable")


def optimizer_form(optimizer):
    r"""What loading a checkpoint leaves as ``optimizer`` has it: each
    group's learning-rate object (a tensor on the card, or a float) and how
    the group runs (capturable, fused, foreach)."""
    return [{k: g[k] for k in _RUN_KEYS + ("lr",) if k in g} for g in optimizer.param_groups]


def restore_optimizer_form(optimizer, form):
    r"""Puts :func:`optimizer_form`'s ``form`` back after a load: the loaded
    learning rate goes into the group's own tensor (or stays a float)."""
    for group, mine in zip(optimizer.param_groups, form):
        lr = float(group["lr"])
        group.update(mine)
        if torch.is_tensor(mine["lr"]):
            mine["lr"].fill_(lr)
        else:
            group["lr"] = lr


def load_optimizer_state(optimizer, state_dict):
    r"""Loads ``state_dict`` (a checkpoint's, of either form: a float learning
    rate and a host step count, or a capturable optimizer's) into
    ``optimizer``, which keeps its own form (:func:`optimizer_form`); Adam's
    step counts move to the card with a capturable optimizer."""
    form = optimizer_form(optimizer)
    groups = [{**saved, **{k: v for k, v in mine.items() if k != "lr"}}
              for saved, mine in zip(state_dict["param_groups"], form)]
    optimizer.load_state_dict({**state_dict, "param_groups": groups})
    restore_optimizer_form(optimizer, form)


def create_train_state(model, lr: float = None, seed: int = None, optimizer: str = "adam"):
    r"""The training state of ``model`` (whose parameters are already
    initialised): ``optimizer`` is ``"adam"`` or ``"sgd"`` (plain SGD, with
    which one step shows the gradients); ``lr`` and ``seed`` default to the
    run defaults. The generator lies on the model's device, and
    ``model_state`` starts as ``model.init_model_state()``. A model with
    nothing to train gets ``optimizer=None``. On the card the optimizer is
    built to be captured (module docstring)."""
    lr = DEFAULT_RUN_CONFIG["lr"] if lr is None else lr
    seed = DEFAULT_RUN_CONFIG["seed"] if seed is None else seed
    params = [p for p in model.parameters() if p.requires_grad]
    device = params[0].device if params else torch.device("cpu")
    trainable = getattr(model, "TRAINABLE", True) and params
    return TrainState(model=model,
                      optimizer=_make_optimizer(optimizer, params, lr) if trainable else None,
                      model_state=model.init_model_state(),
                      generator=torch.Generator(device=device).manual_seed(seed))


def rebuild_optimizer(state):
    r"""Replaces the state's optimizer by a new one of the same kind and
    learning rate over the model's present parameters (``fully_shard``
    replaces them by DTensors), carrying the old one's moments over, each
    sharded like its parameter; returns the state. The JAX package shards
    ``opt_state`` beside ``params`` in the same way."""
    old = state.optimizer
    if old is None:
        return state
    from torch.distributed.tensor import DTensor, distribute_tensor
    if len(old.param_groups) != 1:
        raise ValueError("the optimizer to rebuild must hold the model's parameters in one "
                         "group, as create_train_state builds it")
    moments = old.state_dict()["state"]
    params = [p for p in state.model.parameters() if p.requires_grad]
    state.optimizer = _make_optimizer(type(old).__name__.lower(), params,
                                      float(old.param_groups[0]["lr"]))
    for i, st in moments.items():
        p = params[i]
        state.optimizer.state[p] = {
            k: distribute_tensor(v.to(p.device), p.device_mesh, p.placements)
            if isinstance(p, DTensor) and torch.is_tensor(v) and v.shape == p.shape else v
            for k, v in st.items()}
    return state
