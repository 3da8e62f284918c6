r"""Run defaults that the ported slice uses (a subset of the JAX package's
default run configuration)."""

DEFAULT_RUN_CONFIG = {
    "seed": 42,  #: parameter-init seed when ``create_model`` is given none
}
