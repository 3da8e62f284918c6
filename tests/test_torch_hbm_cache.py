r"""The device-memory cache of file-backed datasets
(``vp_suite_tpu_torch/training/data.py``'s ``HBMCachedLoader`` and
``estimate_cache_bytes``, and ``VPSuite.train``'s ``hbm_cache``) against the
JAX package's.

- The cache's batches and epoch order equal JAX's ``HBMCachedLoader``'s for
  the same seeds, shuffled and in order, with and without ``drop_last``; its
  uint8 frames are ``BatchLoader(uint8_frames=True)``'s bytes.
- ``estimate_cache_bytes`` equals JAX's, in uint8 and in float32.
- ``hbm_cache="on"`` over the budget raises JAX's ``ValueError``; on-the-fly
  datasets are never staged; an unknown mode is refused.
- A 2-epoch CPU ``train`` on a KTH fixture: every epoch the train step sees
  the same sequences with ``hbm_cache="auto"`` (staged) as with ``"off"``
  (the host loader), bit for bit, and the validation losses agree. Each
  epoch is one batch of the whole training set, whose order differs between
  the two (each path shuffles with its own seeds, as in the JAX package), so
  the sums over the batch run in another order: rtol 1e-5.
"""
import json
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import vp_suite_tpu_torch.vpsuite as port_vpsuite
from vp_suite_tpu.datasets.kth import KTHActionsDataset as JaxKTH, build_kth_metadata
from vp_suite_tpu.training.data import HBMCachedLoader as JaxCache
from vp_suite_tpu.training.data import estimate_cache_bytes as jax_estimate
from vp_suite_tpu_torch import VPSuite
from vp_suite_tpu_torch.training.data import BatchLoader, HBMCachedLoader, estimate_cache_bytes

torch.set_num_threads(1)


class _Items:
    r"""n items of random [0, 1] frames and actions that name the item."""

    def __init__(self, n=10, t=3, hw=6, c=3, action_size=2):
        self.n, self.t, self.hw, self.c, self.action_size = n, t, hw, c, action_size

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        r = np.random.default_rng(i)
        return {"frames": r.random((self.t, self.hw, self.hw, self.c)).astype(np.float32),
                "actions": np.full((self.t, self.action_size), float(i), np.float32),
                "origin": f"item{i}"}


@pytest.mark.parametrize("drop_last", [True, False])
def test_cache_batches_and_order_equal_jax(drop_last):
    ds = _Items(n=10)
    want = JaxCache(ds, 4, uint8_frames=True, drop_last=drop_last)
    got = HBMCachedLoader(ds, 4, "cpu", uint8_frames=True, drop_last=drop_last)
    assert len(got) == len(want) == (2 if drop_last else 3)
    assert got.nbytes == want.nbytes
    for seed, shuffle in ((0, True), (7, True), (7, False), (42 * 9973 + 1, True)):
        w = list(want.epoch_iterator(seed, shuffle=shuffle))
        g = list(got.epoch_iterator(seed, shuffle=shuffle))
        assert len(g) == len(w) == len(got)
        for a, b in zip(g, w):
            assert a["frames"].dtype == torch.uint8 and a["frames"].device.type == "cpu"
            np.testing.assert_array_equal(a["frames"].numpy(), np.asarray(b["frames"]))
            np.testing.assert_array_equal(a["actions"].numpy(), np.asarray(b["actions"]))
        ids = np.concatenate([b["actions"][:, 0, 0].numpy() for b in g]).astype(int)
        np.testing.assert_array_equal(ids, got.epoch_order(seed, shuffle)[:len(ids)])


def test_cache_frames_are_the_host_loaders_bytes():
    ds = _Items(n=6)
    host = next(iter(BatchLoader(ds, 6, shuffle=False, uint8_frames=True, num_workers=1)))
    (batch,) = HBMCachedLoader(ds, 6, "cpu").epoch_iterator(0, shuffle=False)
    np.testing.assert_array_equal(batch["frames"].numpy(), host["frames"])
    np.testing.assert_array_equal(batch["actions"].numpy(), host["actions"])
    f32 = HBMCachedLoader(ds, 6, "cpu", uint8_frames=False)
    (batch,) = f32.epoch_iterator(0, shuffle=False)
    np.testing.assert_array_equal(batch["frames"].numpy(),
                                  np.stack([ds[i]["frames"] for i in range(6)]))


@pytest.mark.parametrize("uint8_frames", [True, False])
def test_estimate_cache_bytes_equals_jax(uint8_frames):
    for ds in (_Items(n=8), _Items(n=5, t=4, hw=7, c=1, action_size=3)):
        assert estimate_cache_bytes(ds, uint8_frames) == jax_estimate(ds, uint8_frames)
    ds = _Items(n=8)
    assert estimate_cache_bytes(ds, uint8_frames) == \
        HBMCachedLoader(ds, 2, "cpu", uint8_frames=uint8_frames).nbytes


def write_kth(root):
    r"""KTH at its 64x64: one training and one test person per class, 12
    frames each (6 training sequences: 4 to train, 2 to validate)."""
    processed = root / "processed"
    seed = 0
    for c in JaxKTH.CLASSES:
        for person in ("person01", "person22"):
            vid_dir = processed / c / f"{person}_{c}_d1"
            vid_dir.mkdir(parents=True)
            for f in range(12):
                img = (np.random.default_rng(seed).random((64, 64, 3)) * 255).astype(np.uint8)
                cv2.imwrite(str(vid_dir / f"image-{f:03d}_64x64.png"), img)
                seed += 1
    build_kth_metadata(processed, JaxKTH.CLASSES)


MAKE_TRAIN_STEP = port_vpsuite.make_train_step
RUN = dict(epochs=2, batch_size=4, context_frames=2, pred_frames=2, no_vis=True, no_wandb=True)


def _train(root, out, monkeypatch, **kw):
    r"""A 2-epoch run on KTH at 16x16; returns the validation losses and
    the frames of each step's batch, dequantised, rows sorted."""
    seen = []
    make = MAKE_TRAIN_STEP

    def recording_make(*a, **k):
        step = make(*a, **k)

        def recording(state, batch, epoch):
            frames = batch["frames"].float() / 255.0
            seen.append(np.sort(frames.reshape(frames.shape[0], -1).numpy(), axis=0))
            return step(state, batch, epoch)
        return recording

    monkeypatch.setattr(port_vpsuite, "make_train_step", recording_make)
    suite = VPSuite(device="cpu")
    suite.load_dataset("KTH", data_dir=str(root), img_size=16)
    suite.create_model("convlstm-shi", seed=3)
    best = suite.train(out_dir=str(out), **RUN, **kw)
    with open(Path(out) / "metrics.jsonl") as f:
        losses = [json.loads(line)["mse"] for line in f]
    return best, losses, seen


def test_train_through_the_cache_equals_the_host_path(tmp_path, monkeypatch, capsys):
    write_kth(tmp_path / "kth")
    best_off, off, seen_off = _train(tmp_path / "kth", tmp_path / "off", monkeypatch,
                                     hbm_cache="off")
    assert "staged" not in capsys.readouterr().out
    best_on, on, seen_on = _train(tmp_path / "kth", tmp_path / "auto", monkeypatch,
                                  hbm_cache="auto")
    assert "staged training set into device memory" in capsys.readouterr().out
    assert len(seen_on) == len(seen_off) == 2
    for a, b in zip(seen_on, seen_off):
        np.testing.assert_array_equal(a, b)
    assert len(on) == len(off) == 2 and all(map(np.isfinite, on))
    np.testing.assert_allclose(on, off, rtol=1e-5, atol=0)
    np.testing.assert_allclose(best_on, best_off, rtol=1e-5, atol=0)


def test_cache_refusals(tmp_path):
    write_kth(tmp_path / "kth")
    suite = VPSuite(device="cpu")
    suite.load_dataset("KTH", data_dir=str(tmp_path / "kth"), img_size=16)
    suite.create_model("convlstm-shi")
    with pytest.raises(ValueError, match="hbm_cache='on'"):
        suite.train(out_dir=str(tmp_path / "on"), hbm_cache="on", hbm_cache_mb=0, **RUN)
    with pytest.raises(ValueError, match="hbm_cache must be"):
        suite.train(out_dir=str(tmp_path / "bad"), hbm_cache="yes", **RUN)


def test_on_the_fly_data_is_never_staged(tmp_path, capsys):
    suite = VPSuite(device="cpu")
    suite.load_dataset("MMF", img_size=16, digit_source="synthetic",
                       n_seqs={"train": 4, "val": 2, "test": 2})
    suite.create_model("convlstm-shi")
    suite.train(out_dir=str(tmp_path / "mmf"), hbm_cache="on", **{**RUN, "epochs": 1})
    assert "staged" not in capsys.readouterr().out
