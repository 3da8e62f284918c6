r"""Moving MNIST, stored: one ``seq_XXXXX.npy`` file of uint8 ``[t, h, w]``
grey frames per sequence under ``<data_dir>/<split>/``, repeated to three
channels (the JAX package's ``MovingMNISTDataset``).

:func:`generate_moving_mnist` writes such files: digits bouncing off the
walls with a 2-pixel tolerance, their templates shrunk by
:func:`~vp_suite_tpu_torch.utils.transforms.area_resize` where the JAX
package calls ``cv2.resize(..., INTER_AREA)``.
"""
import math
import os
import re
from pathlib import Path

import numpy as np

from vp_suite_tpu_torch.base.base_dataset import VPData, VPDataset
from vp_suite_tpu_torch.datasets._digits import open_digit_source
from vp_suite_tpu_torch.defaults import SETTINGS
from vp_suite_tpu_torch.utils.transforms import area_resize
from vp_suite_tpu_torch.utils.utils import timed_input


class MovingMNISTDataset(VPDataset):
    NAME = "Moving MNIST"
    REFERENCE = "https://arxiv.org/abs/1502.04681v3"
    IS_DOWNLOADABLE = "Yes (synthetic glyph fallback needs no download)"
    ACTION_SIZE = 0
    DATASET_FRAME_SHAPE = (64, 64, 3)

    train_to_val_ratio = 0.96

    def __init__(self, split, **dataset_kwargs):
        super().__init__(split, **dataset_kwargs)
        self.NON_CONFIG_VARS = self.NON_CONFIG_VARS + ["data_ids", "data_fps"]

        self.data_dir = str((Path(self.data_dir) / split).resolve())
        if not os.path.isdir(self.data_dir):
            raise FileNotFoundError(f"no dataset split dir at {self.data_dir}")
        self.data_ids = sorted(fn for fn in os.listdir(self.data_dir)
                               if re.match(r"seq_[0-9]+\.npy", fn))
        self.data_fps = [os.path.join(self.data_dir, data_id) for data_id in self.data_ids]
        if not self.data_fps:
            raise FileNotFoundError(f"no seq_*.npy files in {self.data_dir}")
        self.MIN_SEQ_LEN = np.load(self.data_fps[0]).shape[0]

    @classmethod
    def default_data_dir(cls):
        return SETTINGS.DATA_PATH / "moving_mnist"

    def __len__(self):
        return len(self.data_fps)

    def __getitem__(self, i) -> VPData:
        if not self.ready_for_usage:
            raise RuntimeError("Dataset is not yet ready for usage "
                               "(maybe you forgot to call set_seq_len()).")
        data_fp = self.data_fps[i]
        raw = np.load(data_fp)   # [t', h, w]
        raw = np.repeat(raw[..., None], 3, axis=-1)
        raw = raw[:self.seq_len:self.seq_step]
        frames = self.preprocess(raw.astype(np.uint8))
        actions = np.zeros((self.total_frames, 1), dtype=np.float32)
        return {"frames": frames, "actions": actions, "origin": data_fp}

    @classmethod
    def download_and_prepare_dataset(cls):
        r"""Generates the dataset into the default data dir (asking for the
        sizes on a terminal), from whichever digit source is available."""
        frame_size = (64, 64)
        num_frames = int(timed_input("Number of frames per sequence", default=20))
        digit_size = int(timed_input("Pixel size of digit in frame", default=28))
        digits_per_image = int(timed_input("Digits per image", default=2))
        train_seqs = int(timed_input("Number of training sequences", default=60000))
        test_seqs = int(timed_input("Number of test sequences", default=10000))

        d_path = cls.default_data_dir()
        d_path.mkdir(parents=True, exist_ok=True)
        for split, n_seqs, train in [("train", train_seqs, True), ("test", test_seqs, False)]:
            print(f"generating {split} set...")
            out_path = d_path / split
            out_path.mkdir(exist_ok=True)
            generate_moving_mnist(d_path, out_path, training=train, shape=frame_size,
                                  num_frames=num_frames, num_images=n_seqs,
                                  digit_size=digit_size, digits_per_image=digits_per_image)


def generate_moving_mnist(d_path, out_path, training, shape, num_frames, num_images,
                          digit_size, digits_per_image, seed=None):
    r"""Writes ``num_images`` sequences of ``num_frames`` bouncing digits,
    one ``seq_XXXXX.npy`` (uint8 ``[t, h, w]``) each, drawn from
    ``np.random.default_rng(seed)``: a random direction and a speed of 2-6
    pixels per frame, bounced past the walls with a 2-pixel tolerance."""
    src, _ = open_digit_source(d_path, train=training, source="auto")
    width, height = shape
    lims = (width - digit_size, height - digit_size)
    rng = np.random.default_rng(seed)

    for img_idx in range(num_images):
        direcs = np.pi * (rng.random(digits_per_image) * 2 - 1)
        speeds = rng.integers(5, size=digits_per_image) + 2
        veloc = np.array([(s * math.cos(d), s * math.sin(d)) for d, s in zip(direcs, speeds)])
        digit_imgs = []
        for r in rng.integers(0, len(src), digits_per_image):
            img = np.asarray(src[int(r)], dtype=np.float32)
            if img.shape != (digit_size, digit_size):
                img = area_resize(img.astype(np.float64), (digit_size, digit_size))
            digit_imgs.append(img / 255.0)
        positions = np.array([(rng.random() * lims[0], rng.random() * lims[1])
                              for _ in range(digits_per_image)])

        seq = np.empty((num_frames, height, width), dtype=np.uint8)
        for frame_idx in range(num_frames):
            canvas = np.zeros((height, width), dtype=np.float32)
            for i, dig in enumerate(digit_imgs):
                x, y = positions[i].astype(int)
                x = np.clip(x, 0, lims[0])
                y = np.clip(y, 0, lims[1])
                canvas[y:y + digit_size, x:x + digit_size] += dig
            next_pos = positions + veloc
            for i, pos in enumerate(next_pos):
                for j, coord in enumerate(pos):
                    if coord < -2 or coord > lims[j] + 2:
                        veloc[i, j] = -veloc[i, j]
            positions = positions + veloc
            seq[frame_idx] = (canvas * 255).clip(0, 255).astype(np.uint8)
        np.save(str(Path(out_path) / f"seq_{img_idx:05d}.npy"), seq)
