r"""Dataset registry of the port (the JAX package's ids; on-the-fly Moving
MNIST is ported so far)."""
from vp_suite_tpu_torch.datasets.mmnist_on_the_fly import MovingMNISTOnTheFly

DATASET_CLASSES = {
    "MMF": MovingMNISTOnTheFly,
}
AVAILABLE_DATASETS = DATASET_CLASSES.keys()
