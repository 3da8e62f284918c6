r"""Moving MNIST, generated on the fly: two digits bouncing in a square frame.

The JAX package's ``MovingMNISTOnTheFly``, with the same per-split seeds
(``3x + 2`` / ``3x + 1`` / ``3x``), the same four numpy RNGs that every item
draws from in turn (so an item depends on the order of the draws, as in the
reference), the same speed-sampling loops and bounce physics. Digit templates
larger than the frame are shrunk by :func:`~vp_suite_tpu_torch.utils.transforms.area_resize`,
which computes what the JAX package's ``cv2.resize(..., INTER_AREA)`` does.

Backends: ``"numpy"`` draws every item on the host; ``"native"`` renders
each item with the C generator (``native/mmnist_gen.c``, built at first use;
without a C compiler the dataset raises), seeded by the split and the item's
index, so an item does not depend on the order of reads; ``"device"`` makes
``VPSuite.train`` synthesise the training batches on the card
(:mod:`~vp_suite_tpu_torch.datasets.mmnist_device`), while items (validation)
still come from the numpy path.
"""
import numpy as np

from vp_suite_tpu_torch.base.base_dataset import VPData, VPDataset
from vp_suite_tpu_torch.datasets._digits import open_digit_source
from vp_suite_tpu_torch.defaults import SETTINGS
from vp_suite_tpu_torch.native import generate_sequence_native, load_native
from vp_suite_tpu_torch.utils.transforms import area_resize


class MovingMNISTOnTheFly(VPDataset):
    NAME = "Moving MNIST - On the fly"
    IS_DOWNLOADABLE = "Yes (MNIST digits; synthetic glyph fallback needs no download)"
    ON_THE_FLY = True
    VALID_SPLITS = ["train", "val", "test"]
    MIN_SEQ_LEN = int(1e8)
    ACTION_SIZE = 0
    DATASET_FRAME_SHAPE = (64, 64, 3)
    DEFAULT_N_SEQS = {"train": 9600, "val": 400, "test": 1000}
    SPLIT_SEED_OFFSETS = {"train": lambda x: 3 * x + 2, "val": lambda x: 3 * x + 1,
                          "test": lambda x: 3 * x}
    BACKENDS = ("numpy", "native", "device")

    min_speed = 2
    max_speed = 5
    min_acc = 0
    max_acc = 0
    num_channels = 3
    num_digits = 2
    rng_seed = 4115
    n_seqs = None
    digit_source = "auto"  #: 'auto' | 'mnist' | 'synthetic'
    backend = "numpy"      #: 'numpy' | 'native' (the C generator) | 'device' (training
    #: batches made on the card)

    def __init__(self, split, **dataset_kwargs):
        super().__init__(split, **dataset_kwargs)
        self.NON_CONFIG_VARS = self.NON_CONFIG_VARS + ["data", "digit_id_rng", "speed_rng",
                                                       "acc_rng", "pos_rng"]

        for attr in ["num_channels", "num_digits", "rng_seed", "n_seqs", "digit_source",
                     "min_speed", "max_speed", "min_acc", "max_acc", "backend"]:
            if attr in dataset_kwargs:
                setattr(self, attr, dataset_kwargs[attr])
        if self.backend not in self.BACKENDS:
            raise ValueError(f"backend must be one of {self.BACKENDS}, not '{self.backend}'")
        if self.backend == "native":
            load_native()   # builds the C generator now; raises without a compiler

        if self.num_channels not in [1, 3]:
            raise ValueError("num_channels for dataset needs to be in [1, 3].")
        img_c, img_h, img_w = self.img_shape
        if img_h != img_w:
            raise ValueError("MMNIST only permits square images")
        self.img_shape = (self.num_channels, img_h, img_w)
        self.DATASET_FRAME_SHAPE = (img_h, img_w, self.num_channels)

        self.data, self._source_kind = open_digit_source(
            self.data_dir, train=(self.split == "train"), source=self.digit_source)
        if isinstance(self.n_seqs, dict):  # per-split sizes
            self.n_seqs = self.n_seqs.get(self.split)
        self.n_seqs = self.n_seqs or self.DEFAULT_N_SEQS[self.split]
        self.digit_id_rng = self.speed_rng = self.acc_rng = self.pos_rng = None
        self._native_templates = None
        self.reset_rng()

    @classmethod
    def default_data_dir(cls):
        return SETTINGS.DATA_PATH / "moving_mnist_on_the_fly"

    def default_available(self, split, **dataset_kwargs):
        # on-the-fly generation with the synthetic source needs no files
        src = dataset_kwargs.get("digit_source", self.digit_source)
        if src in ("auto", "synthetic"):
            return True
        return super().default_available(split, **dataset_kwargs)

    def __len__(self):
        return self.n_seqs

    def reset_rng(self):
        r"""Re-creates the split-seeded generation RNGs."""
        split_rng_seed = self.SPLIT_SEED_OFFSETS[self.split](self.rng_seed)
        self.digit_id_rng = np.random.default_rng(split_rng_seed)
        self.speed_rng = np.random.default_rng(split_rng_seed)
        self.acc_rng = np.random.default_rng(split_rng_seed)
        self.pos_rng = np.random.default_rng(split_rng_seed)

    def _get_speed(self):
        return int(self.speed_rng.integers(-self.max_speed, self.max_speed + 1))

    def _get_acc(self):
        return int(self.acc_rng.integers(-self.max_acc, self.max_acc + 1))

    def _digit_size(self, size):
        r"""The templates' side in the frame: shrunk to half the frame (at
        least 4) where they do not fit."""
        return max(4, self.img_shape[1] // 2) if size >= self.img_shape[1] else size

    def __getitem__(self, i) -> VPData:
        if not self.ready_for_usage:
            raise RuntimeError("Dataset is not yet ready for usage "
                               "(maybe you forgot to call set_seq_len()).")
        if self.backend == "native":
            return self._getitem_native(i)
        digits, next_poses, speeds, digit_size = [], [], [], None
        for _ in range(self.num_digits):
            digit, pos, speed, digit_size = self._sample_digit()
            digits.append(digit)
            next_poses.append(pos)
            speeds.append(speed)

        frames = np.zeros((self.seq_len, *self.DATASET_FRAME_SHAPE), dtype=np.float64)
        for fi in range(self.seq_len):
            frame = frames[fi]
            for j, (digit, cur_pos, speed) in enumerate(zip(digits, next_poses, speeds)):
                speed, cur_pos = self._move_digit(speed=speed, cur_pos=cur_pos,
                                                  img_size=self.img_shape[1],
                                                  digit_size=digit_size)
                speeds[j] = speed
                next_poses[j] = cur_pos
                cur_h, cur_w = cur_pos
                frame[cur_h:cur_h + digit_size, cur_w:cur_w + digit_size] += digit
            frames[fi] = np.clip(frame, 0, 1)
        frames = self.preprocess(frames * 255)

        actions = np.zeros((self.total_frames, 1), dtype=np.float32)
        return {"frames": frames, "actions": actions, "origin": "generated on-the-fly"}

    def _getitem_native(self, i) -> VPData:
        r"""Item ``i`` from the C generator, seeded with ``(split seed << 20)
        ^ (i + 1)``: the same for the same index whatever the order of reads."""
        split_seed = self.SPLIT_SEED_OFFSETS[self.split](self.rng_seed)
        if self._native_templates is None:   # shrunk once, as the frame size is fixed
            self._native_templates = self._digit_templates()
        seq = generate_sequence_native(
            self._native_templates, self.seq_len, self.img_shape[1], self.num_channels,
            self.num_digits, self.min_speed, self.max_speed,
            seed=(split_seed << 20) ^ (i + 1))
        frames = self.preprocess(seq.astype(np.float64) * 255.0)
        actions = np.zeros((self.total_frames, 1), dtype=np.float32)
        return {"frames": frames, "actions": actions,
                "origin": "generated on-the-fly (native)"}

    def _digit_templates(self):
        r"""The digit bank as uint8 ``[n, ds, ds]``, shrunk as the numpy path
        shrinks each digit."""
        templates = np.asarray(self.data.images, dtype=np.uint8)
        size = self._digit_size(templates.shape[-1])
        if size != templates.shape[-1]:
            templates = np.stack([area_resize(t, (size, size)) for t in templates])
        return templates

    def device_batch_iterator(self, batch_size, n_steps, seed, device):
        r"""``n_steps`` batches ``{"frames", "actions"}`` synthesised on
        ``device`` (see :mod:`~vp_suite_tpu_torch.datasets.mmnist_device`):
        the digit bank goes up once, and each batch is drawn from a
        ``torch.Generator`` on ``device`` seeded with
        ``(split seed << 16) ^ seed``."""
        from vp_suite_tpu_torch.datasets.mmnist_device import DeviceBatchIterator
        split_seed = self.SPLIT_SEED_OFFSETS[self.split](self.rng_seed)
        return DeviceBatchIterator(
            self._digit_templates(), batch_size=batch_size,
            seq_len=self.seq_len, img_size=self.img_shape[1],
            num_channels=self.num_channels, num_digits=self.num_digits,
            min_speed=self.min_speed, max_speed=self.max_speed,
            value_range=(self.value_range_min, self.value_range_max),
            n_steps=n_steps, seed=(split_seed << 16) ^ seed, device=device)

    def _sample_digit(self):
        digit_id = int(self.digit_id_rng.integers(len(self.data)))
        cur_digit = np.array(self.data[digit_id], dtype=np.float64) / 255
        digit_size = self._digit_size(cur_digit.shape[-1])
        if digit_size != cur_digit.shape[-1]:
            cur_digit = area_resize(cur_digit, (digit_size, digit_size))
        cur_digit = cur_digit[..., np.newaxis]
        if self.num_channels == 3:
            cur_digit = np.repeat(cur_digit, 3, axis=-1)

        x_coord = int(self.pos_rng.integers(0, self.img_shape[1] - digit_size))
        y_coord = int(self.pos_rng.integers(0, self.img_shape[2] - digit_size))
        cur_pos = np.array([y_coord, x_coord])

        speed_x, speed_y, acc = None, None, None
        while speed_x is None or np.abs(speed_x) < self.min_speed:
            speed_x = self._get_speed()
        while speed_y is None or np.abs(speed_y) < self.min_speed:
            speed_y = self._get_speed()
        while acc is None or np.abs(acc) < self.min_acc:
            acc = self._get_acc()
        speed = np.array([speed_y, speed_x])
        return cur_digit, cur_pos, speed, digit_size

    @staticmethod
    def _move_digit(speed, cur_pos, img_size, digit_size):
        r"""Bounce physics: past the far wall the digit is put against it, past
        the near wall it is mirrored, and the speed turns; then it is clamped
        into the frame, since where the free range (frame - digit) is smaller
        than the speed one reflection can land past the other wall."""
        next_pos = cur_pos + speed
        for i, p in enumerate(next_pos):
            if p + digit_size > img_size:
                offset = p + digit_size - img_size
                next_pos[i] = p - offset
                speed[i] = -1 * speed[i]
            elif p < 0:
                next_pos[i] = -1 * p
                speed[i] = -1 * speed[i]
        np.clip(next_pos, 0, img_size - digit_size, out=next_pos)
        return speed, next_pos

    @classmethod
    def download_and_prepare_dataset(cls):
        r"""MNIST is not downloaded; the synthetic source needs no preparation."""
        cls.default_data_dir().mkdir(parents=True, exist_ok=True)
