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
"""
import dataclasses

import torch

from vp_suite_tpu_torch.defaults import DEFAULT_RUN_CONFIG

OPTIMIZERS = {
    "adam": lambda params, lr: torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8),
    "sgd": lambda params, lr: torch.optim.SGD(params, lr=lr),
}


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


def create_train_state(model, lr: float = None, seed: int = None, optimizer: str = "adam"):
    r"""The training state of ``model`` (whose parameters are already
    initialised): ``optimizer`` is ``"adam"`` or ``"sgd"`` (plain SGD, with
    which one step shows the gradients); ``lr`` and ``seed`` default to the
    run defaults. The generator lies on the model's device, and
    ``model_state`` starts as ``model.init_model_state()``. A model with
    nothing to train gets ``optimizer=None``."""
    lr = DEFAULT_RUN_CONFIG["lr"] if lr is None else lr
    seed = DEFAULT_RUN_CONFIG["seed"] if seed is None else seed
    make = OPTIMIZERS[optimizer]
    params = [p for p in model.parameters() if p.requires_grad]
    device = params[0].device if params else torch.device("cpu")
    trainable = getattr(model, "TRAINABLE", True) and params
    return TrainState(model=model, optimizer=make(_param_groups(params), lr) if trainable else None,
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
    state.optimizer = OPTIMIZERS[type(old).__name__.lower()](_param_groups(params),
                                                             old.param_groups[0]["lr"])
    for i, st in moments.items():
        p = params[i]
        state.optimizer.state[p] = {
            k: distribute_tensor(v.to(p.device), p.device_mesh, p.placements)
            if isinstance(p, DTensor) and torch.is_tensor(v) and v.shape == p.shape else v
            for k, v in st.items()}
    return state
