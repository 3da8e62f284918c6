r"""SynPick - Moving: RGB frames ``<ep>_<frame>.png`` under
``<data_dir>/processed/<split>/rgb/`` and, per episode, the gripper's poses in
``scene_gt/<ep>_scene_gt.json`` (the JAX package's ``SynpickMovingDataset``).
A window is valid past the first 72 frames of an episode, within one episode,
apart from the last valid window, and where the gripper moves by more than 1
in most of its steps and by less than 30 in each; its actions are the
gripper's per-step position deltas. The frames are read by the port's PNG
reader as RGB, as ``cv2.imread`` and ``COLOR_BGR2RGB`` give them.
"""
import json
import math
import os
from pathlib import Path

import numpy as np

from vp_suite_tpu_torch.base.base_dataset import VPData, VPDataset
from vp_suite_tpu_torch.defaults import SETTINGS
from vp_suite_tpu_torch.utils.image_io import read_png
from vp_suite_tpu_torch.utils.utils import most


class SynpickMovingDataset(VPDataset):
    NAME = "SynPick - Moving"
    REFERENCE = "https://arxiv.org/abs/2107.04852"
    IS_DOWNLOADABLE = "Not Yet"
    VALID_SPLITS = ["train", "val", "test"]
    SKIP_FIRST_N = 72
    MIN_SEQ_LEN = 90
    ACTION_SIZE = 3
    DATASET_FRAME_SHAPE = (135, 240, 3)

    train_to_val_ratio = 0.9

    def __init__(self, split, **dataset_kwargs):
        super().__init__(split, **dataset_kwargs)
        self.NON_CONFIG_VARS = self.NON_CONFIG_VARS + ["all_idx", "valid_idx", "image_ids",
                                                       "image_fps", "gripper_pos", "total_len"]

        self.data_dir = str((Path(self.data_dir) / "processed" / split).resolve())
        images_dir = os.path.join(self.data_dir, "rgb")
        scene_gt_dir = os.path.join(self.data_dir, "scene_gt")
        if not os.path.isdir(images_dir) or not os.path.isdir(scene_gt_dir):
            raise FileNotFoundError(f"missing rgb/scene_gt dirs under {self.data_dir}")
        self.all_idx = []
        self.valid_idx = []   # filled by set_seq_len

        self.image_ids = sorted(os.listdir(images_dir))
        self.image_fps = [os.path.join(images_dir, image_id) for image_id in self.image_ids]

        scene_gt_fps = [os.path.join(scene_gt_dir, fp) for fp in sorted(os.listdir(scene_gt_dir))]
        self.gripper_pos = {}
        for scene_gt_fp, ep in zip(scene_gt_fps, [int(a[-20:-14]) for a in scene_gt_fps]):
            with open(scene_gt_fp, "r") as scene_json_file:
                ep_dict = json.load(scene_json_file)
            self.gripper_pos[ep] = [ep_dict[frame_num][-1]["cam_t_m2c"]
                                    for frame_num in ep_dict.keys()]

    @classmethod
    def default_data_dir(cls):
        return SETTINGS.DATA_PATH / "synpick"

    def _set_seq_len(self):
        r"""The valid windows (see the module's docstring)."""
        last_valid_idx = -1 * self.seq_len
        self.all_idx, self.valid_idx = [], []
        for idx in range(len(self.image_ids) - self.seq_len + 1):
            self.all_idx.append(idx)
            ep_nums = [self._ep_num_from_id(self.image_ids[idx + off])
                       for off in self.frame_offsets]
            frame_nums = [self._frame_num_from_id(self.image_ids[idx + off])
                          for off in self.frame_offsets]
            if frame_nums[0] < self.SKIP_FIRST_N:
                continue
            if ep_nums[0] != ep_nums[-1]:
                continue
            if idx < last_valid_idx + self.seq_len:
                continue
            gripper_pos = [self.gripper_pos[ep_nums[0]][fn] for fn in frame_nums]
            deltas = self._get_gripper_pos_xydist(gripper_pos)
            above_min = [(d > 1.0) for d in deltas]
            below_max = [(d < 30.0) for d in deltas]
            if not (most(above_min) and all(below_max)):
                continue
            self.valid_idx.append(idx)
            last_valid_idx = idx
        if len(self.valid_idx) < 1:
            raise ValueError("No valid indices in generated dataset! Perhaps the calculated "
                             "sequence length is longer than the trajectories of the data?")

    def __getitem__(self, i) -> VPData:
        if not self.ready_for_usage:
            raise RuntimeError("Dataset is not yet ready for usage "
                               "(maybe you forgot to call set_seq_len()).")
        i = self.valid_idx[i]
        idx = range(i, i + self.seq_len, self.seq_step)
        ep_num = self._ep_num_from_id(self.image_ids[idx[0]])
        frame_nums = [self._frame_num_from_id(self.image_ids[id_]) for id_ in idx]
        gripper_pos = [self.gripper_pos[ep_num][fn] for fn in frame_nums]
        actions = self._get_gripper_pos_diff(gripper_pos).astype(np.float32)

        imgs = [read_png(self.image_fps[id_], color=True) for id_ in idx]
        rgb = self.preprocess(np.stack(imgs, axis=0))
        origin_str = (f"1st frame: {self.image_fps[i]}, frames: {self.total_frames}, "
                      f"step: {self.seq_step}")
        return {"frames": rgb, "actions": actions, "origin": origin_str}

    def __len__(self):
        return len(self.valid_idx)

    @staticmethod
    def _comp_gripper_pos(old, new):
        x_diff, y_diff = new[0] - old[0], new[1] - old[1]
        return math.sqrt(x_diff * x_diff + y_diff * y_diff)

    def _get_gripper_pos_xydist(self, gripper_pos):
        return [self._comp_gripper_pos(o, n) for o, n in zip(gripper_pos, gripper_pos[1:])]

    @staticmethod
    def _get_gripper_pos_diff(gripper_pos):
        arr = np.array(gripper_pos)
        return np.stack([n - o for o, n in zip(arr, arr[1:])], axis=0)

    @staticmethod
    def _ep_num_from_id(file_id: str):
        return int(file_id[-17:-11])

    @staticmethod
    def _frame_num_from_id(file_id: str):
        return int(file_id[-10:-4])

    def download_and_prepare_dataset(self):
        raise NotImplementedError("SynPick dataset is not yet downloadable! "
                                  "Please contact the paper authors to resolve this issue.")
