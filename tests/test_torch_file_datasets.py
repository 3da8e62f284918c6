r"""The port's file-backed datasets against the JAX package's, on small
datasets written here in each loader's own storage format (the writers of
``tests/test_dataset_fixtures.py``, copied):

- stored Moving MNIST (``MM``; also the port's ``generate_moving_mnist``
  against the JAX package's, file for file), BAIR, KTH (``build_kth_metadata``),
  KITTI raw and SynPick (``SPM``): ``len``, the split membership, and every
  item's frames (within 1e-6) and actions (exactly), plain, with a crop, with
  another ``img_size`` and with augmentations (flips, random greyscale, blur);
- the refusals of crops and augmentations that are not allowed, the same
  ``ValueError`` s as the JAX package's;
- ``VPSuite(device="cpu").load_dataset`` for each id, and for MMF with
  ``backend="native"``;
- the package imports, and reads KTH and KITTI frames, with cv2, imageio and
  PIL (and JAX) blocked.
"""
import json
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from vp_suite_tpu.datasets import DATASET_CLASSES as JAX_CLASSES
from vp_suite_tpu.datasets.kth import build_kth_metadata as jax_build_kth_metadata
from vp_suite_tpu.datasets.mmnist import generate_moving_mnist as jax_generate_mm
from vp_suite_tpu.utils import transforms as JT
from vp_suite_tpu_torch import VPSuite
from vp_suite_tpu_torch.datasets import DATASET_CLASSES
from vp_suite_tpu_torch.datasets.kth import build_kth_metadata
from vp_suite_tpu_torch.datasets.mmnist import generate_moving_mnist
from vp_suite_tpu_torch.utils import transforms as PT

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


def _write_png(fp, h=32, w=32, seed=0, grey=False):
    img = (np.random.default_rng(seed).random((h, w, 3)) * 255).astype(np.uint8)
    cv2.imwrite(str(fp), img[..., 0] if grey else img)


def write_mm(root, seed=42):
    for split, n in [("train", 6), ("test", 3)]:
        out = root / split
        out.mkdir(parents=True)
        jax_generate_mm(root, out, training=(split == "train"), shape=(64, 64), num_frames=8,
                        num_images=n, digit_size=28, digits_per_image=2, seed=seed)


def write_bair(root):
    rng = np.random.default_rng(0)
    for split, n in [("train", 6), ("test", 2)]:
        d = root / "softmotion30_44k" / split
        d.mkdir(parents=True)
        for i in range(n):
            np.save(d / f"seq_{i:05d}_obs.npy",
                    (rng.random((30, 64, 64, 3)) * 255).astype(np.uint8))
            np.save(d / f"seq_{i:05d}_actions.npy", rng.random((30, 4)).astype(np.float32))


def write_kth(root, frames=(35, 9)):
    processed = root / "processed"
    seed = 0
    for c in JAX_CLASSES["KTH"].CLASSES:
        for person, n_frames in zip(("person01", "person22"), frames):
            vid_dir = processed / c / f"{person}_{c}_d1"
            vid_dir.mkdir(parents=True)
            for f in range(n_frames):   # some frames grey, as KTH's are
                _write_png(vid_dir / f"image-{f:03d}_64x64.png", 64, 64, seed, grey=f % 3 == 0)
                seed += 1
    jax_build_kth_metadata(processed, JAX_CLASSES["KTH"].CLASSES)
    return processed


def write_kitti(root):
    for date_i in range(2):
        for drive_i in range(3):
            data_dir = (root / f"2011_09_{26 + date_i}"
                        / f"2011_09_{26 + date_i}_drive_{drive_i:04d}_sync" / "image_02" / "data")
            data_dir.mkdir(parents=True)
            for f in range(12):
                _write_png(data_dir / f"{f:010d}.png", 24, 48, 100 * drive_i + 10 * date_i + f)


def write_synpick(root):
    for split, eps in (("train", (0, 3)), ("val", (5,)), ("test", (7,))):
        rgb = root / "processed" / split / "rgb"
        gt = root / "processed" / split / "scene_gt"
        rgb.mkdir(parents=True)
        gt.mkdir(parents=True)
        rng = np.random.default_rng(len(split))
        for ep in eps:
            gt_dict, pos = {}, np.array([0.0, 0.0, 0.0])
            for f in range(90):
                _write_png(rgb / f"{ep:06d}_{f:06d}.png", 34, 60, 1000 * ep + f)
                pos = pos + rng.uniform(2, 8, 3)   # the gripper keeps moving
                gt_dict[str(f)] = [{"cam_t_m2c": pos.tolist()}]
            with open(gt / f"{ep:06d}_scene_gt.json", "w") as fp:
                json.dump(gt_dict, fp)


WRITERS = {"MM": write_mm, "BAIR": write_bair, "KTH": write_kth, "KITTI": write_kitti,
           "SPM": write_synpick}
#: (context, predicted, step) of each dataset's items
SEQ = {"MM": (2, 3, 1), "BAIR": (3, 4, 2), "KTH": (4, 8, 1), "KITTI": (2, 2, 1),
       "SPM": (2, 3, 2)}
#: each dataset's stored frame size as the fixtures write it (KITTI's and
#: SynPick's frames are smaller than the real ones: img_size is their size)
NATIVE_SIZE = {"KITTI": (24, 48), "SPM": (34, 60)}


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("file_datasets")
    for name, write in WRITERS.items():
        write(root / name)
    return root


def _variants(name):
    r"""``(label, JAX keywords, port keywords)``: plain, a crop, another
    size, augmentations; each transform a fresh instance per package."""
    base = {"img_size": NATIVE_SIZE[name]} if name in NATIVE_SIZE else {}
    h, w = NATIVE_SIZE.get(name, (64, 64))
    out = [("plain", base, base)]
    for T_kw in ({"crop": "center"}, {"crop": "random"}, {"size": True}, {"augment": True}):
        kws = []
        for T in (JT, PT):
            kw = dict(base)
            if T_kw.get("crop") == "center":
                kw = {"crop": T.CenterCrop((h - 4, w - 6))}
            elif T_kw.get("crop") == "random":
                kw = {"crop": T.RandomCrop((h // 2, w // 2 + 1), seed=5), "img_size": (20, 18)}
            elif T_kw.get("size"):
                kw = {"img_size": (h // 2 + 3, w + 5)}
            else:
                kw["augmentations"] = [T.RandomHorizontalFlip(seed=1), T.RandomVerticalFlip(seed=2),
                                       T.RandomGrayscale(0.5, seed=3), T.GaussianBlur(3, 0.9)]
            kws.append(kw)
        out.append((next(iter(T_kw)), *kws))
    return out


def _pairs(name, root, split, jax_kw, port_kw):
    r"""``[(JAX dataset, port dataset)]`` of ``split`` (train and val for
    ``"train"`` where the class splits its train set), sequence lengths set."""
    jcls, pcls = JAX_CLASSES[name], DATASET_CLASSES[name]
    if split == "train":
        jd, pd = jcls.get_train_val(data_dir=str(root), **jax_kw), \
            pcls.get_train_val(data_dir=str(root), **port_kw)
    else:
        jd, pd = (jcls.get_test(data_dir=str(root), **jax_kw),), \
            (pcls.get_test(data_dir=str(root), **port_kw),)
    for d in (*jd, *pd):
        getattr(d, "dataset", d).set_seq_len(*SEQ[name])
    return list(zip(jd, pd))


def _membership(d):
    if hasattr(d, "indices"):
        return list(d.indices)
    if hasattr(d, "sequences"):
        return [(str(p), n) for p, n in d.sequences]
    if hasattr(d, "valid_idx"):
        return list(d.valid_idx)
    return None


@pytest.mark.parametrize("name", list(WRITERS))
def test_items_match_jax(data_root, name):
    root = data_root / name
    for label, jax_kw, port_kw in _variants(name):
        for split in ("train", "test"):
            for want_d, got_d in _pairs(name, root, split, jax_kw, port_kw):
                assert len(got_d) == len(want_d) > 0, (name, label, split)
                assert _membership(got_d) == _membership(want_d)
                assert got_d.img_shape == want_d.img_shape
                for i in range(len(want_d)):
                    want, got = want_d[i], got_d[i]
                    assert got["frames"].shape == want["frames"].shape, (name, label, split, i)
                    assert got["frames"].dtype == np.float32
                    np.testing.assert_allclose(got["frames"], want["frames"], rtol=0, atol=1e-6,
                                               err_msg=f"{name} {label} {split} {i}")
                    np.testing.assert_array_equal(got["actions"], want["actions"])
                    assert got["actions"].dtype == want["actions"].dtype
                    if label == "plain":
                        assert got["origin"] == want["origin"]


@pytest.mark.parametrize("name", list(WRITERS))
def test_config_and_refusals_match_jax(data_root, name):
    root = str(data_root / name)
    kw = {"img_size": NATIVE_SIZE[name]} if name in NATIVE_SIZE else {}
    want = JAX_CLASSES[name]("train", data_dir=root, **kw)
    got = DATASET_CLASSES[name]("train", data_dir=root, **kw)
    skip = {"data_dir"}
    want_cfg = {k: v for k, v in want.config.items() if k not in skip}
    got_cfg = {k: v for k, v in got.config.items() if k not in skip}
    assert set(got_cfg) <= set(want_cfg) | {"value_range_min", "value_range_max"}
    for k in got_cfg:
        assert got_cfg[k] == want_cfg.get(k, got_cfg[k]), k
    for bad, match in (({"crop": PT.Resize(8)}, "'crop'"), ({"crop": JT.CenterCrop(8)}, "'crop'"),
                       ({"augmentations": [PT.CenterCrop(8)]}, "'augmentations'")):
        with pytest.raises(ValueError, match=match):
            DATASET_CLASSES[name]("train", data_dir=root, **kw, **bad)
    for d in (want, got):
        with pytest.raises(ValueError, match="has to be one of"):
            type(d)("eval", data_dir=root)


def test_generate_moving_mnist_matches_jax(tmp_path):
    for gen, out in ((jax_generate_mm, tmp_path / "jax"),
                     (generate_moving_mnist, tmp_path / "port")):
        out.mkdir()
        gen(tmp_path, out, training=True, shape=(64, 48), num_frames=7, num_images=3,
            digit_size=28, digits_per_image=3, seed=5)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir()) and len(names) == 3
    for n in names:
        np.testing.assert_array_equal(np.load(tmp_path / "port" / n), np.load(tmp_path / "jax" / n))


def test_build_kth_metadata_matches_jax(tmp_path):
    processed = write_kth(tmp_path / "a", frames=(5, 4))
    want = {p.relative_to(processed): p.read_text() for p in processed.rglob("*.json")}
    for p in processed.rglob("*.json"):
        p.unlink()
    build_kth_metadata(processed, DATASET_CLASSES["KTH"].CLASSES)
    got = {p.relative_to(processed): p.read_text() for p in processed.rglob("*.json")}
    assert got == want and len(got) == 12


def test_kth_refuses_frames_that_jax_cannot_assign(tmp_path):
    processed = write_kth(tmp_path, frames=(5, 4))
    bad = processed / "boxing" / "person01_boxing_d1" / "image-002_64x64.png"   # item 0's
    cv2.imwrite(str(bad), np.zeros((64, 64, 4), np.uint8))
    for cls in (JAX_CLASSES["KTH"], DATASET_CLASSES["KTH"]):
        ds = cls("train", data_dir=str(tmp_path))
        ds.set_seq_len(2, 2, 1)
        with pytest.raises(ValueError):
            ds[0]


def test_registry_is_jaxs_order():
    assert list(DATASET_CLASSES) == [k for k in JAX_CLASSES if k in DATASET_CLASSES]
    assert list(DATASET_CLASSES) == ["MM", "MMF", "BAIR", "KTH", "SPM", "KITTI"]
    for k, cls in DATASET_CLASSES.items():
        assert cls.NAME == JAX_CLASSES[k].NAME and cls.__name__ == JAX_CLASSES[k].__name__


@pytest.mark.parametrize("name", list(WRITERS) + ["MMF native"])
def test_suite_loads_each_dataset(data_root, name):
    suite = VPSuite(device="cpu")
    if name == "MMF native":
        kw = dict(digit_source="synthetic", backend="native", img_size=16,
                  n_seqs={"train": 8, "val": 4, "test": 4})
        name = "MMF"
    else:
        kw = {"data_dir": str(data_root / name)}
        kw.update({"img_size": NATIVE_SIZE[name]} if name in NATIVE_SIZE else {})
    train = suite.load_dataset(name, **kw)
    test = suite.load_dataset(name, split="test", **kw)
    ctx, pred, step = SEQ.get(name, (2, 2, 1))
    for wrapper, data in ((train, train.train_data), (train, train.val_data),
                          (test, test.test_data)):
        wrapper.set_seq_len(ctx, pred, step)
        item = data[0]
        c, h, w = wrapper.img_shape
        assert item["frames"].shape == (ctx + pred, h, w, c)
        assert item["actions"].shape[-1] == max(wrapper.action_size, 1) or name == "SPM"
    assert [d.is_training_set for d in suite.datasets] == [True, False]


def test_stored_moving_mnist_prepares_as_jax(tmp_path, monkeypatch):
    from vp_suite_tpu_torch.datasets import mmnist
    answers = {"Number of frames per sequence": 6, "Pixel size of digit in frame": 28,
               "Digits per image": 2, "Number of training sequences": 3,
               "Number of test sequences": 2}
    monkeypatch.setattr(mmnist, "timed_input", lambda prompt, default=None: answers[prompt])
    monkeypatch.setattr(mmnist.MovingMNISTDataset, "default_data_dir",
                        classmethod(lambda cls: tmp_path))
    mmnist.MovingMNISTDataset.download_and_prepare_dataset()
    for split, n in (("train", 3), ("test", 2)):
        ds = mmnist.MovingMNISTDataset(split, data_dir=str(tmp_path))
        ds.set_seq_len(2, 4, 1)
        assert len(ds) == n and ds.MIN_SEQ_LEN == 6
        assert ds[n - 1]["frames"].shape == (6, 64, 64, 3) and ds[0]["frames"].max() > 0.1


def test_download_is_not_ported():
    for name in ("BAIR", "KTH", "KITTI"):
        with pytest.raises(NotImplementedError, match="JAX package"):
            DATASET_CLASSES[name].download_and_prepare_dataset()


def test_package_reads_frames_with_cv2_imageio_and_pil_blocked(data_root, tmp_path):
    kth = data_root / "KTH"
    code = (
        "import sys, importlib, pkgutil\n"
        "for name in ('cv2', 'imageio', 'PIL', 'jax', 'jaxlib', 'flax', 'optax', 'vp_suite_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import vp_suite_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(vp_suite_tpu_torch.__path__,\n"
        "                                              'vp_suite_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "from vp_suite_tpu_torch.datasets import KTHActionsDataset, KITTIRawDataset\n"
        f"kth = KTHActionsDataset('train', data_dir={str(kth)!r})\n"
        "kth.set_seq_len(2, 2, 1)\n"
        f"kitti = KITTIRawDataset('train', data_dir={str(data_root / 'KITTI')!r}, "
        "img_size=(12, 20))\n"
        "kitti.set_seq_len(2, 2, 1)\n"
        "print(len(mods), kth[0]['frames'].shape, kitti[0]['frames'].shape)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, rest = out.stdout.split(maxsplit=1)
    assert int(n) >= 60 and "(4, 64, 64, 3) (4, 12, 20, 3)" in rest
