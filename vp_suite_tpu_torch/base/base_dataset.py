r"""Base class for all video prediction datasets.

The JAX package's ``VPDataset``: the same constants, sequence-length
negotiation, split semantics and preprocessing, producing numpy arrays in the
THWC layout (``frames`` ``[t, h, w, c]`` float32 in the value range). The
batch loader stacks them and copies them to the card.
"""
import random as _pyrandom
import sys
from copy import deepcopy
from pathlib import Path
from typing import TypedDict

import numpy as np

from vp_suite_tpu_torch.utils import transforms as T
from vp_suite_tpu_torch.utils.utils import (PytestExpectedException, get_public_attrs,
                                            set_from_kwarg)


class VPData(TypedDict):
    r"""What every dataset item is."""
    frames: np.ndarray   #: video frames [t, h, w, c], float32, in the value range
    actions: np.ndarray  #: actions per frame [t, a], float32
    origin: str          #: where the data comes from


class VPSubset:
    r"""A subset of a dataset at the given indices; other attributes are the
    dataset's."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]

    def __getattr__(self, item):
        return getattr(self.dataset, item)


class VPDataset:
    r"""Base video prediction dataset; usable once :meth:`set_seq_len` has
    been called."""

    NON_CONFIG_VARS = ["functions", "ready_for_usage", "total_frames", "seq_len",
                       "frame_offsets", "data_dir", "transform"]

    NAME: str = NotImplemented
    REFERENCE: str = None
    IS_DOWNLOADABLE: str = None
    ON_THE_FLY: bool = False
    DEFAULT_DATA_DIR: Path = NotImplemented
    VALID_SPLITS = ["train", "test"]
    MIN_SEQ_LEN: int = NotImplemented
    ACTION_SIZE: int = NotImplemented
    DATASET_FRAME_SHAPE: tuple = NotImplemented  #: (h, w, c) of the stored frames

    img_shape: tuple = NotImplemented  #: (c, h, w), as the configs give it
    train_to_val_ratio: float = 0.8
    train_val_seed = 1234
    transform = None
    split: str = None
    seq_step: int = 1
    data_dir: str = None
    value_range_min: float = 0.0
    value_range_max: float = 1.0

    def __init__(self, split: str, **dataset_kwargs):
        if split not in self.VALID_SPLITS:
            raise ValueError(f"parameter '{split}' has to be one of the following: {self.VALID_SPLITS}")
        self.split = split

        set_from_kwarg(self, dataset_kwargs, "seq_step")
        self.data_dir = dataset_kwargs.get("data_dir", self.data_dir)
        if self.data_dir is None:
            if not self.default_available(self.split, **dataset_kwargs):
                if "pytest" in sys.modules:
                    raise PytestExpectedException(f"Default for Dataset '{self.NAME}' is unavailable "
                                                  f"and pytest won't download it")
                print(f"downloading/preparing dataset '{self.NAME}' "
                      f"and saving it to '{self.default_data_dir()}'...")
                self.download_and_prepare_dataset()
            self.data_dir = str(Path(self.default_data_dir()).resolve())

        # preprocessing: scale -> crop -> resize -> augment
        transforms = []
        set_from_kwarg(self, dataset_kwargs, "value_range_min")
        set_from_kwarg(self, dataset_kwargs, "value_range_max")

        crop = dataset_kwargs.get("crop", None)
        crop_out_hw = None
        if crop is not None:
            if type(crop) not in T.CROPS:
                raise ValueError(f"for the parameter 'crop', only the following transforms "
                                 f"are allowed: {T.CROPS}")
            transforms.append(crop)
            crop_out_hw = crop.size

        img_size = dataset_kwargs.get("img_size", None)
        h, w, c = self.DATASET_FRAME_SHAPE
        if crop_out_hw is not None:
            h, w = crop_out_hw
        if img_size is None:
            h_, w_ = h, w
        elif isinstance(img_size, int):
            h_, w_ = img_size, img_size
        elif isinstance(img_size, (list, tuple)) and len(img_size) == 2:
            h_, w_ = img_size
        else:
            raise ValueError("invalid img size provided, expected either None, int or a "
                             "two-element list/tuple")
        self.img_shape = (c, h_, w_)
        if (h, w) != (h_, w_):
            transforms.append(T.Resize((h_, w_)))

        augmentations = dataset_kwargs.get("augmentations", [])
        for aug in augmentations:
            if type(aug) not in T.SHAPE_PRESERVING_AUGMENTATIONS:
                raise ValueError(f"within the parameter 'augmentations', only the following "
                                 f"transformations are allowed: {T.SHAPE_PRESERVING_AUGMENTATIONS}")
            transforms.append(aug)

        self.transform = T.Identity() if len(transforms) == 0 else T.Compose(transforms)
        self.ready_for_usage = False

    @classmethod
    def default_data_dir(cls) -> Path:
        r"""Where the dataset's files are kept when no ``data_dir`` is given."""
        return cls.DEFAULT_DATA_DIR

    @property
    def config(self) -> dict:
        r"""The dataset's configuration as a flat dict."""
        attr_dict = get_public_attrs(self, "config", non_config_vars=self.NON_CONFIG_VARS)
        img_c, img_h, img_w = self.img_shape
        extra_config = {
            "img_h": img_h,
            "img_w": img_w,
            "img_c": img_c,
            "action_size": self.ACTION_SIZE,
            "tensor_value_range": [self.value_range_min, self.value_range_max],
            "NAME": self.NAME,
        }
        return {**attr_dict, **extra_config}

    def set_seq_len(self, context_frames: int, pred_frames: int, seq_step: int):
        r"""Sequence-length negotiation: ``seq_len = (ctx + pred - 1) * step + 1``,
        checked against ``MIN_SEQ_LEN``."""
        total_frames = context_frames + pred_frames
        seq_len = (total_frames - 1) * seq_step + 1
        if self.MIN_SEQ_LEN < seq_len:
            raise ValueError(f"Dataset '{self.NAME}' supports videos with up to {self.MIN_SEQ_LEN} "
                             f"frames, which is exceeded by your configuration: "
                             f"{{context frames: {context_frames}, pred frames: {pred_frames}, "
                             f"seq step: {seq_step}}}")
        self.total_frames = total_frames
        self.seq_len = seq_len
        self.seq_step = seq_step
        self.frame_offsets = range(0, total_frames * seq_step, seq_step)
        self._set_seq_len()
        self.ready_for_usage = True

    def _set_seq_len(self):
        r"""Optional dataset-specific logic for :meth:`set_seq_len`."""

    def reset_rng(self):
        r"""Optional logic for resetting the RNG of a dataset."""

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, i) -> VPData:
        raise NotImplementedError

    def preprocess(self, x: np.ndarray, transform: bool = True) -> np.ndarray:
        r"""Raw frames ``[..., h, w]`` or ``[..., h, w, c]`` (uint8, uint16, or
        float64 in [0, 255]) -> float32 THWC in the value range. float32 input
        is refused: it may already be normalised."""
        x = np.asarray(x)
        if x.dtype == np.uint16:
            x = x.astype(np.float32) / ((1 << 16) - 1)
        elif x.dtype in (np.uint8, np.float64):
            x = x.astype(np.float32) / ((1 << 8) - 1)
        else:
            raise ValueError(
                f"only dtypes np.uint8, np.uint16 and np.float64 are supported "
                f"(given: {x.dtype}). Already-normalized float32 frames should "
                f"be fed as float64 scaled by 255 (x.astype(np.float64) * 255) "
                f"or quantized to uint8")

        if x.ndim < 2:
            raise ValueError("expected at least two dimensions for input image")
        elif x.ndim == 2:
            x = x[..., None]

        if self.value_range_min != 0.0 or self.value_range_max != 1.0:
            x = x * (self.value_range_max - self.value_range_min) + self.value_range_min

        if transform:
            x = self.transform(x)
        return np.ascontiguousarray(x, dtype=np.float32)

    def postprocess(self, x) -> np.ndarray:
        r"""Value-range floats ``[..., h, w, c]`` -> uint8."""
        x = np.asarray(x, dtype=np.float32)
        if x.ndim < 3:
            raise ValueError("expected at least three dimensions for input image")
        x = x - self.value_range_min
        x = x / (self.value_range_max - self.value_range_min)
        x = np.clip(x * 255.0, 0.0, 255.0)
        return x.astype(np.uint8)

    def default_available(self, split: str, **dataset_kwargs):
        r"""Whether the dataset in the default data dir is usable."""
        try:
            kwargs_ = deepcopy(dataset_kwargs)
            kwargs_.update({"data_dir": str(self.default_data_dir())})
            default_ = self.__class__(split, **kwargs_)
            default_.set_seq_len(1, 1, 1)
            _ = default_[0]
        except (FileNotFoundError, ValueError, IndexError, RuntimeError):
            return False
        return True

    @classmethod
    def download_and_prepare_dataset(cls):
        raise NotImplementedError

    @classmethod
    def get_train_val(cls, **dataset_kwargs):
        r"""``(train, val)`` datasets: a seeded random split of the train split
        when the dataset has no val split of its own."""
        if cls.VALID_SPLITS not in (["train", "test"], ["train", "val", "test"]):
            raise ValueError(f"parameter 'VALID_SPLITS' of dataset class '{cls.__name__}' "
                             f"is ill-configured")
        if cls.VALID_SPLITS == ["train", "test"]:
            d_main = cls("train", **dataset_kwargs)
            len_main = len(d_main)
            len_train = int(len_main * cls.train_to_val_ratio)
            len_val = len_main - len_train
            d_train, d_val = _random_split(d_main, [len_train, len_val], cls.train_val_seed)
        else:
            d_train = cls("train", **dataset_kwargs)
            d_val = cls("val", **dataset_kwargs)
        return d_train, d_val

    @classmethod
    def get_test(cls, **dataset_kwargs):
        return cls("test", **dataset_kwargs)


def _random_split(dataset, lengths, random_seed: int):
    r"""Seeded random split into :class:`VPSubset` s, shuffled by Python's
    ``random.Random(seed)`` as the reference's split is."""
    if sum(lengths) != len(dataset):
        raise ValueError("Sum of input lengths does not equal the length of the input dataset!")
    indices = list(range(sum(lengths)))
    _pyrandom.Random(random_seed).shuffle(indices)
    subsets, offset = [], 0
    for length in lengths:
        subsets.append(VPSubset(dataset, indices[offset:offset + length]))
        offset += length
    return subsets
