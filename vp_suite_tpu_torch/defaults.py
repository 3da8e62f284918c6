r"""Run defaults that the ported slice uses (a subset of the JAX package's
default run configuration, with its values)."""

DEFAULT_RUN_CONFIG = {
    "seed": 42,                             #: parameter-init seed when ``create_model`` is given none
    "lr": 0.0001,                           #: Adam's learning rate
    "losses_and_scales": {"mse": 1.0},      #: training losses and their weights in the total
    "context_frames": 10,
    "pred_frames": 10,
    "accum_steps": 1,                       #: microbatches per optimizer step
}
