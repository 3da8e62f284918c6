r"""KITTI raw: the drives' PNG frames under
``<data_dir>/<recording day>/<drive>/<camera>/data/*.png`` (the JAX package's
``KITTIRawDataset``). The drives are split twice by seeded shuffles
(train + val against test, then train against val), and each drive is cut
into windows of ``seq_len`` frames that do not overlap. The frames are read
by the port's PNG reader as RGB, as ``cv2.imread`` and ``COLOR_BGR2RGB``
give them.
"""
from pathlib import Path

import numpy as np

from vp_suite_tpu_torch.base.base_dataset import VPData, VPDataset
from vp_suite_tpu_torch.defaults import SETTINGS
from vp_suite_tpu_torch.utils.image_io import read_png
from vp_suite_tpu_torch.utils.utils import seeded_shuffle_split, set_from_kwarg


class KITTIRawDataset(VPDataset):
    NAME = "KITTI raw"
    REFERENCE = "http://www.cvlibs.net/datasets/kitti/raw_data.php"
    IS_DOWNLOADABLE = "With Registered Account"
    VALID_SPLITS = ["train", "val", "test"]
    MIN_SEQ_LEN = 994
    ACTION_SIZE = 0
    DATASET_FRAME_SHAPE = (375, 1242, 3)
    FPS = 10
    AVAILABLE_CAMERAS = [f"image_{i:02d}" for i in range(4)]

    camera = "image_02"
    trainval_to_test_ratio = 0.8
    train_to_val_ratio = 0.9
    trainval_test_seed = 1234

    def __init__(self, split, **dataset_kwargs):
        super().__init__(split, **dataset_kwargs)
        self.NON_CONFIG_VARS = self.NON_CONFIG_VARS + ["sequences", "sequences_with_frame_index",
                                                       "AVAILABLE_CAMERAS"]
        for attr in ("camera", "trainval_to_test_ratio", "train_to_val_ratio",
                     "trainval_test_seed", "train_val_seed"):
            set_from_kwarg(self, dataset_kwargs, attr)

        drive_dirs = [drive
                      for day in Path(self.data_dir).iterdir() if day.is_dir()
                      for drive in day.iterdir() if drive.is_dir()]
        if len(drive_dirs) < 3:
            raise ValueError(f"Dataset {self.NAME}: need at least 3 drive "
                             f"sequences to form train/val/test splits, "
                             f"found {len(drive_dirs)}")

        trainval, test = seeded_shuffle_split(
            drive_dirs, self.trainval_to_test_ratio, self.trainval_test_seed,
            at_least_one=True)
        if self.split == "test":
            chosen = test
        else:
            train, val = seeded_shuffle_split(
                trainval, self.train_to_val_ratio, self.train_val_seed,
                at_least_one=True)
            chosen = train if self.split == "train" else val

        self.sequences = [
            (drive, len(list(drive.rglob(f"{self.camera}/data/*.png"))))
            for drive in sorted(chosen)]
        self.sequences_with_frame_index = []

    @classmethod
    def default_data_dir(cls):
        return SETTINGS.DATA_PATH / "kitti_raw"

    def _set_seq_len(self):
        # windows that do not overlap: consecutive starts one window apart
        stride = self.seq_len + self.seq_step - 1
        self.sequences_with_frame_index = [
            (drive, start)
            for drive, n_frames in self.sequences
            for start in range(0, n_frames - self.seq_len + 1, stride)]

    def __getitem__(self, i) -> VPData:
        drive, start = self.sequences_with_frame_index[i]
        frame_paths = sorted(drive.rglob(f"{self.camera}/data/*.png"))
        window = frame_paths[start:start + self.seq_len:self.seq_step]
        frames = np.stack([read_png(fp.resolve(), color=True) for fp in window], axis=0)
        vid = self.preprocess(frames)
        actions = np.zeros((self.total_frames, 1), dtype=np.float32)
        return {"frames": vid, "actions": actions,
                "origin": f"{drive}, start frame: {start}"}

    def __len__(self):
        return len(self.sequences_with_frame_index)

    @classmethod
    def download_and_prepare_dataset(cls):
        raise NotImplementedError(
            "the port does not download KITTI raw (it needs a registered account): the JAX "
            "package's KITTIRawDataset.download_and_prepare_dataset runs its "
            f"resources/get_dataset_kitti_raw.sh into {cls.default_data_dir()}")
