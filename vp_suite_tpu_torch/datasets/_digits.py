r"""Digit template sources for the on-the-fly Moving MNIST generator.

- ``MNISTSource``: MNIST's raw idx(.gz) files, where the data dir has them.
- ``SyntheticDigitSource``: 100 deterministic 28x28 uint8 digit glyphs (10
  digits x 5 Hershey fonts x 2 thicknesses), the JAX package's synthetic
  source. They are read from ``synthetic_digits.npz`` beside this module,
  which holds the glyphs that source renders (with OpenCV, which the port does
  not need), so nothing is rendered or downloaded here.
"""
import gzip
import struct
from pathlib import Path

import numpy as np

SYNTHETIC_DIGITS_FP = Path(__file__).parent / "synthetic_digits.npz"


class MNISTSource:
    r"""MNIST digit images from raw idx(.gz) files."""

    FILES = {
        "train": ["train-images-idx3-ubyte", "train-images.idx3-ubyte"],
        "test": ["t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte"],
    }

    def __init__(self, data_dir, train=True):
        split = "train" if train else "test"
        fp = self._find(data_dir, self.FILES[split])
        if fp is None:
            raise FileNotFoundError(f"no MNIST idx file for split '{split}' under {data_dir}")
        self.images = self._load_idx(fp)

    @staticmethod
    def _find(data_dir, names):
        data_dir = Path(data_dir)
        for name in names:
            for cand in [data_dir / name, data_dir / f"{name}.gz",
                         data_dir / "MNIST" / "raw" / name,
                         data_dir / "MNIST" / "raw" / f"{name}.gz"]:
                if cand.exists():
                    return cand
        return None

    @staticmethod
    def _load_idx(fp):
        fp = Path(fp)
        opener = gzip.open if fp.suffix == ".gz" else open
        with opener(fp, "rb") as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            if magic != 2051:
                raise ValueError(f"bad idx magic in {fp}: {magic}")
            data = np.frombuffer(f.read(n * rows * cols), dtype=np.uint8)
        return data.reshape(n, rows, cols)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return self.images[i]  # uint8 [28, 28]


class SyntheticDigitSource:
    r"""The 100 synthetic glyphs, indexed like MNIST's 60000 training images
    (``images[i % 100]``), so that the generator's sampling is unchanged."""

    def __init__(self):
        with np.load(SYNTHETIC_DIGITS_FP) as bank:
            self.images = bank["images"]

    def __len__(self):
        return 60000

    def __getitem__(self, i):
        return self.images[i % len(self.images)]


def open_digit_source(data_dir, train=True, source="auto"):
    r"""Returns ``(source_obj, kind)``; ``source`` is 'auto', 'mnist' or 'synthetic'."""
    if source in ("auto", "mnist"):
        try:
            return MNISTSource(data_dir, train=train), "mnist"
        except (FileNotFoundError, ValueError):
            if source == "mnist":
                raise
    return SyntheticDigitSource(), "synthetic"
