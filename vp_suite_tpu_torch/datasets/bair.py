r"""BAIR robot pushing: paired ``seq_XXXXX_obs.npy`` (uint8 ``[30, 64, 64, 3]``)
and ``seq_XXXXX_actions.npy`` (float32 ``[30, 4]``) files under
``<data_dir>/softmotion30_44k/<split>/`` (the JAX package's
``BAIRPushingDataset``). The files are extracted from the dataset's
tfrecords, which the port does not read: prepare them with the JAX package.
"""
import os
from pathlib import Path

import numpy as np

from vp_suite_tpu_torch.base.base_dataset import VPData, VPDataset
from vp_suite_tpu_torch.defaults import SETTINGS


class BAIRPushingDataset(VPDataset):
    NAME = "BAIR robot pushing"
    REFERENCE = "https://arxiv.org/abs/1710.05268"
    IS_DOWNLOADABLE = "Yes"
    MIN_SEQ_LEN = 30
    ACTION_SIZE = 4
    DATASET_FRAME_SHAPE = (64, 64, 3)

    train_to_val_ratio = 0.96

    def __init__(self, split, **dataset_kwargs):
        super().__init__(split, **dataset_kwargs)
        self.NON_CONFIG_VARS = self.NON_CONFIG_VARS + ["obs_ids", "actions_ids", "obs_fps",
                                                       "actions_fps"]

        self.data_dir = str((Path(self.data_dir) / "softmotion30_44k" / split).resolve())
        if not os.path.isdir(self.data_dir):
            raise FileNotFoundError(f"no dataset split dir at {self.data_dir}")
        files = sorted(os.listdir(self.data_dir))
        self.obs_ids = [fn for fn in files if fn.endswith("obs.npy")]
        self.actions_ids = [fn for fn in files if fn.endswith("actions.npy")]
        if len(self.obs_ids) != len(self.actions_ids):
            raise ValueError("Different number of obs and action files found "
                             "-> Delete dataset and prepare again!")
        elif len(self.obs_ids) == 0:
            raise ValueError("No trajectory files (.npy) found! "
                             "Maybe you forgot to prepare the dataset?")
        self.obs_fps = [os.path.join(self.data_dir, i) for i in self.obs_ids]
        self.actions_fps = [os.path.join(self.data_dir, i) for i in self.actions_ids]

    @classmethod
    def default_data_dir(cls):
        return SETTINGS.DATA_PATH / "bair_robot_pushing"

    def __len__(self):
        return len(self.obs_fps)

    def __getitem__(self, i) -> VPData:
        if not self.ready_for_usage:
            raise RuntimeError("Dataset is not yet ready for usage "
                               "(maybe you forgot to call set_seq_len()).")
        obs_fp = self.obs_fps[i]
        rgb_raw = np.load(obs_fp)[:self.seq_len:self.seq_step]   # [t, h, w, c] uint8
        frames = self.preprocess(rgb_raw)
        actions = np.load(self.actions_fps[i]).astype(np.float32)[:self.seq_len:self.seq_step]
        return {"frames": frames, "actions": actions, "origin": obs_fp}

    @classmethod
    def download_and_prepare_dataset(cls):
        raise NotImplementedError(
            "the port does not download BAIR: the JAX package's "
            "BAIRPushingDataset.download_and_prepare_dataset fetches "
            "http://rail.eecs.berkeley.edu/datasets/bair_robot_pushing_dataset_v0.tar and "
            "splits its tfrecords with TensorFlow (split_bair_traj_files) into "
            f"{cls.default_data_dir()}/softmotion30_44k/<split>/seq_XXXXX_{{obs,actions}}.npy")
