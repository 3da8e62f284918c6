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
state.
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


def create_train_state(model, lr: float = None, seed: int = None, optimizer: str = "adam"):
    r"""The training state of ``model`` (whose parameters are already
    initialised): ``optimizer`` is ``"adam"`` or ``"sgd"`` (plain SGD, with
    which one step shows the gradients); ``lr`` and ``seed`` default to the
    run defaults. The generator lies on the model's device. A model with
    nothing to train gets ``optimizer=None``."""
    lr = DEFAULT_RUN_CONFIG["lr"] if lr is None else lr
    seed = DEFAULT_RUN_CONFIG["seed"] if seed is None else seed
    make = OPTIMIZERS[optimizer]
    params = [p for p in model.parameters() if p.requires_grad]
    device = params[0].device if params else torch.device("cpu")
    trainable = getattr(model, "TRAINABLE", True) and params
    return TrainState(model=model, optimizer=make(params, lr) if trainable else None,
                      generator=torch.Generator(device=device).manual_seed(seed))
