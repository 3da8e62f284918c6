r"""Dataset wrapper bundling the main/train/val or main/test datasets of one
dataset class (the JAX package's ``VPDatasetWrapper``)."""
from vp_suite_tpu_torch.datasets import DATASET_CLASSES


class VPDatasetWrapper:
    r"""One dataset class as a {main, train, val} or {main, test} dict, with
    its properties and methods fanned out to the contained datasets."""

    ALLOWED_SPLITS = ["train", "test"]

    def __init__(self, dataset_class, split, **dataset_kwargs):
        if isinstance(dataset_class, str):
            dataset_class = DATASET_CLASSES[dataset_class]
        self.dataset_class = dataset_class
        if split not in self.ALLOWED_SPLITS:
            raise ValueError(f"split must be one of {self.ALLOWED_SPLITS}")
        self.split = split
        if split == "train":
            d_train, d_val = dataset_class.get_train_val(**dataset_kwargs)
            self.datasets = {"main": getattr(d_train, "dataset", d_train),
                             "train": d_train, "val": d_val}
        else:
            d_test = dataset_class.get_test(**dataset_kwargs)
            self.datasets = {"main": d_test, "test": d_test}

    @property
    def NAME(self):
        return self.dataset_class.NAME

    @property
    def is_training_set(self):
        return self.split == "train"

    @property
    def is_test_set(self):
        return self.split == "test"

    @property
    def train_data(self):
        if not self.is_training_set:
            raise ValueError("this wrapper holds a test dataset")
        return self.datasets["train"]

    @property
    def val_data(self):
        if not self.is_training_set:
            raise ValueError("this wrapper holds a test dataset")
        return self.datasets["val"]

    @property
    def test_data(self):
        if not self.is_test_set:
            raise ValueError("this wrapper holds a training dataset")
        return self.datasets["test"]

    @property
    def config(self):
        return self.datasets["main"].config

    @property
    def img_shape(self):
        return self.datasets["main"].img_shape

    @property
    def action_size(self):
        return self.datasets["main"].ACTION_SIZE

    def _bases(self):
        r"""The distinct datasets underneath (a subset counts as its dataset)."""
        seen = {}
        for d in self.datasets.values():
            base = getattr(d, "dataset", d)
            seen.setdefault(id(base), base)
        return list(seen.values())

    def set_seq_len(self, context_frames, pred_frames, seq_step):
        for d in self._bases():
            d.set_seq_len(context_frames, pred_frames, seq_step)

    def reset_rng(self):
        for d in self._bases():
            d.reset_rng()

    def is_ready(self):
        return all(getattr(d, "ready_for_usage", False) for d in self.datasets.values())

    def __repr__(self):
        return f"VPDatasetWrapper({self.NAME}, split={self.split})"
