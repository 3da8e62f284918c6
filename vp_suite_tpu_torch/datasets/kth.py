r"""KTH Actions: per class and split, JSON metadata (one record per video
directory, listing its frame files) and the frames as 64x64 PNGs under
``<data_dir>/processed/<class>/<video>/`` (the JAX package's
``KTHActionsDataset``). Each item is ``seq_len`` consecutive frames of one
video from a start drawn by ``random.Random(1234)``, the last frame repeated
where the video is shorter. The frames are read by the port's PNG reader,
as ``imageio.v2.imread`` returns them: greyscale is repeated to three
channels, and any other channel count than three is refused.

Metadata written by the reference as ``.t7`` files is read too where the
``torchfile`` package is importable.
"""
import json
import os
import random
from pathlib import Path

import numpy as np

from vp_suite_tpu_torch.base.base_dataset import VPData, VPDataset
from vp_suite_tpu_torch.defaults import SETTINGS
from vp_suite_tpu_torch.utils.image_io import read_png


class KTHActionsDataset(VPDataset):
    NAME = "KTH Actions"
    REFERENCE = "https://doi.org/10.1109/ICPR.2004.1334462"
    IS_DOWNLOADABLE = "Yes"
    CLASSES = ['boxing', 'handclapping', 'handwaving', 'walking', 'running', 'jogging']
    SHORT_CLASSES = ['walking', 'running', 'jogging']
    MIN_SEQ_LEN = 30
    ACTION_SIZE = 0
    DATASET_FRAME_SHAPE = (64, 64, 3)

    first_frame_rng_seed = 1234

    def __init__(self, split, **dataset_kwargs):
        super().__init__(split, **dataset_kwargs)
        self.NON_CONFIG_VARS = self.NON_CONFIG_VARS + ["data"]

        self.data_dir = str((Path(self.data_dir) / "processed").resolve())
        self.data = {c: self._load_meta(c) for c in self.CLASSES}

    @classmethod
    def default_data_dir(cls):
        return SETTINGS.DATA_PATH / "kth_actions"

    def _load_meta(self, c):
        r"""A class's metadata: ``[{"vid": dir name, "files": [[frame file,
        ...], ...]}, ...]``, each video's subsequences as lists of frames."""
        h, w = self.DATASET_FRAME_SHAPE[0], self.DATASET_FRAME_SHAPE[1]
        json_fp = os.path.join(self.data_dir, c, f"{self.split}_meta{h}x{w}.json")
        if os.path.exists(json_fp):
            with open(json_fp, "r") as f:
                return json.load(f)
        t7_fp = os.path.join(self.data_dir, c, f"{self.split}_meta{h}x{w}.t7")
        if os.path.exists(t7_fp):
            import torchfile
            raw = torchfile.load(t7_fp)
            return [{"vid": vid[b"vid"].decode("utf-8"),
                     "files": [[fn.decode("utf-8") for fn in seq]
                               for seq in vid[b"files"]]} for vid in raw]
        raise FileNotFoundError(f"no KTH metadata for class '{c}' at {json_fp}")

    def get_from_idx(self, i):
        for c, c_data in self.data.items():
            len_c_data = sum(len(vid["files"]) for vid in c_data)
            if i >= len_c_data:
                i -= len_c_data
                continue
            for vid in c_data:
                len_vid = len(vid["files"])
                if i < len_vid:
                    return c, vid, vid["files"][i]
                i -= len_vid
        raise ValueError("invalid i")

    def __getitem__(self, i) -> VPData:
        if not self.ready_for_usage:
            raise RuntimeError("Dataset is not yet ready for usage "
                               "(maybe you forgot to call set_seq_len()).")
        c, vid, seq = self.get_from_idx(i)
        dname = os.path.join(self.data_dir, c, vid["vid"])
        frames = np.zeros((self.seq_len, *self.DATASET_FRAME_SHAPE))
        if len(seq) <= self.seq_len:
            first_frame = 0
        else:
            first_frame = random.Random(self.first_frame_rng_seed).randint(
                0, len(seq) - self.seq_len)
        last_frame = len(seq) - 1 if len(seq) <= self.seq_len else first_frame + self.seq_len - 1
        for fi in range(first_frame, last_frame + 1):
            fp = os.path.join(dname, seq[fi])
            img = read_png(fp)
            if img.ndim == 2:
                img = np.repeat(img[..., None], 3, axis=-1)
            if img.shape != frames.shape[1:]:
                raise ValueError(f"{fp}: a frame of shape {img.shape}, not "
                                 f"{frames.shape[1:]}")
            frames[fi - first_frame] = img
        for fi in range(last_frame + 1, self.seq_len):
            frames[fi] = frames[last_frame]

        rgb = self.preprocess(frames)
        actions = np.zeros((self.total_frames, 1), dtype=np.float32)
        return {"frames": rgb, "actions": actions,
                "origin": f"{dname}, start frame: {first_frame}"}

    def __len__(self):
        return sum(sum(len(vid["files"]) for vid in c_data) for c_data in self.data.values())

    @classmethod
    def download_and_prepare_dataset(cls):
        raise NotImplementedError(
            "the port does not download KTH: the JAX package's "
            "KTHActionsDataset.download_and_prepare_dataset runs its "
            f"resources/get_dataset_kth.sh into {cls.default_data_dir()}; then "
            "build_kth_metadata(<data_dir>/processed, KTHActionsDataset.CLASSES) writes the "
            "metadata")


def build_kth_metadata(processed_dir: Path, classes, frame_hw=(64, 64),
                       test_persons=range(21, 26)):
    r"""Writes each class's ``{split}_meta{h}x{w}.json`` from the frame
    directories ``processed/<class>/<person>_<...>/*.png``: one subsequence
    per video directory, covering all its frames; persons 21-25 are the test
    split (the standard KTH protocol)."""
    processed_dir = Path(processed_dir)
    h, w = frame_hw
    test_set = {f"person{p:02d}" for p in test_persons}
    for c in classes:
        c_dir = processed_dir / c
        if not c_dir.is_dir():
            continue
        split_meta = {"train": [], "test": []}
        for vid_dir in sorted(d for d in c_dir.iterdir() if d.is_dir()):
            files = sorted(fp.name for fp in vid_dir.glob("*.png"))
            if not files:
                continue
            person = vid_dir.name.split("_")[0]
            split = "test" if person in test_set else "train"
            split_meta[split].append({"vid": vid_dir.name, "files": [files]})
        for split, meta in split_meta.items():
            with open(c_dir / f"{split}_meta{h}x{w}.json", "w") as f:
                json.dump(meta, f)
