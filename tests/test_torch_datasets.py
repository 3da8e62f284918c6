r"""The port's datasets and host input pipeline against the JAX package's.

- The synthetic digit bank shipped with the port equals the glyphs that the
  JAX package's ``SyntheticDigitSource`` renders, bit for bit.
- ``area_resize`` equals ``cv2.resize(..., interpolation=cv2.INTER_AREA)``
  bit for bit at 28 -> 14 (2x2 blocks), 28 -> 8 (weight tables) and 28 -> 4
  (7x7 blocks), in uint8 and float64, on the digit bank and on random images.
- On-the-fly Moving MNIST items (frames and actions) of each split equal the
  JAX package's bit for bit at 16x16 (digits shrunk to 8x8), 32x32 (28x28
  digits in a 32x32 frame, where the bounce's clamp fires) and 64x64, for the
  same keywords; so do ``config``, the sequence-length errors, the random
  split's membership, ``BatchLoader``'s batches and ``device_prefetch``'s
  read-ahead.
"""
import cv2
import numpy as np
import pytest
import torch

from vp_suite_tpu.base.base_dataset import _random_split as jax_random_split
from vp_suite_tpu.datasets._digits import SyntheticDigitSource as JaxDigits
from vp_suite_tpu.datasets.mmnist_on_the_fly import MovingMNISTOnTheFly as JaxMMF
from vp_suite_tpu.training import data as jax_data
from vp_suite_tpu.utils.dataset_wrapper import VPDatasetWrapper as JaxWrapper
from vp_suite_tpu_torch.base.base_dataset import _random_split
from vp_suite_tpu_torch.datasets._digits import SyntheticDigitSource
from vp_suite_tpu_torch.datasets.mmnist_on_the_fly import MovingMNISTOnTheFly
from vp_suite_tpu_torch.training.data import BatchLoader, device_prefetch
from vp_suite_tpu_torch.utils.dataset_wrapper import VPDatasetWrapper
from vp_suite_tpu_torch.utils.transforms import area_resize

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def bank():
    return JaxDigits().images


def test_digit_bank_is_the_jax_glyphs(bank):
    src = SyntheticDigitSource()
    assert src.images.dtype == np.uint8 and src.images.shape == (100, 28, 28)
    np.testing.assert_array_equal(src.images, bank)
    assert len(src) == len(JaxDigits()) == 60000
    for i in (0, 99, 100, 12345, 59999):
        np.testing.assert_array_equal(src[i], bank[i % 100])


@pytest.mark.parametrize("size", [14, 8, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.float64], ids=["uint8", "float64"])
def test_area_resize_is_cv2_inter_area(bank, size, dtype):
    rand = np.random.default_rng(size).integers(0, 256, (100, 28, 28), dtype=np.uint8)
    images = np.concatenate([bank, rand])
    if dtype == np.float64:
        images = images.astype(np.float64) / 255
    for img in images:
        want = cv2.resize(img, (size, size), interpolation=cv2.INTER_AREA)
        got = area_resize(img, (size, size))
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_area_resize_refuses_what_it_does_not_compute():
    with pytest.raises(ValueError, match="only shrinks"):
        area_resize(np.zeros((8, 8)), (16, 16))
    with pytest.raises(ValueError, match="uint8 or float64"):
        area_resize(np.zeros((8, 8), np.float32), (4, 4))


def _pair(split, **kw):
    kw = {"digit_source": "synthetic", "n_seqs": 8, **kw}
    return JaxMMF(split, **kw), MovingMNISTOnTheFly(split, **kw)


ITEM_CASES = [(16, {}, 6), (32, {}, 6), (64, {}, 2),
              (16, dict(num_channels=1, value_range_min=-1.0, value_range_max=1.0), 3)]


@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("img_size,kw,n_items", ITEM_CASES,
                         ids=["16", "32", "64", "16_gray_pm1"])
def test_mmf_items_equal_jax(split, img_size, kw, n_items):
    want_ds, got_ds = _pair(split, img_size=img_size, **kw)
    for ds in (want_ds, got_ds):
        ds.set_seq_len(3, 4, 1)
    for i in range(n_items):
        want, got = want_ds[i], got_ds[i]
        assert got["frames"].dtype == np.float32 and got["frames"].shape == want["frames"].shape
        np.testing.assert_array_equal(got["frames"], want["frames"])
        np.testing.assert_array_equal(got["actions"], want["actions"])
        assert got["origin"] == want["origin"]
    np.testing.assert_array_equal(got_ds._digit_templates(), want_ds._digit_templates())


@pytest.mark.parametrize("img_size", [16, 64])
def test_mmf_config_equals_jax(img_size):
    want, got = _pair("train", img_size=img_size, n_seqs={"train": 8, "val": 4})
    assert got.config == want.config
    assert got.config["img_shape"] == (3, img_size, img_size)
    assert len(got) == len(want) == 8


def test_mmf_errors_equal_jax():
    want, got = _pair("test", img_size=16)
    for ds in (want, got):
        with pytest.raises(RuntimeError, match="set_seq_len"):
            ds[0]
        ds.MIN_SEQ_LEN = 5
    with pytest.raises(ValueError) as jax_err:
        want.set_seq_len(3, 3, 1)
    with pytest.raises(ValueError) as port_err:
        got.set_seq_len(3, 3, 1)
    assert str(port_err.value) == str(jax_err.value)
    for cls in (JaxMMF, MovingMNISTOnTheFly):
        with pytest.raises(ValueError, match="has to be one of"):
            cls("eval", digit_source="synthetic")
        with pytest.raises(ValueError, match="square"):
            cls("train", digit_source="synthetic", img_size=(16, 32))
        with pytest.raises(ValueError, match="num_channels"):
            cls("train", digit_source="synthetic", num_channels=2)
    for cls in (JaxMMF, MovingMNISTOnTheFly):
        with pytest.raises(ValueError, match="'crop'"):
            cls("train", digit_source="synthetic", crop=object())
    with pytest.raises(ValueError, match="backend"):
        MovingMNISTOnTheFly("train", digit_source="synthetic", backend="cuda")


def test_preprocess_and_postprocess_equal_jax():
    want, got = _pair("test", img_size=16, value_range_min=-1.0, value_range_max=1.0)
    rng = np.random.default_rng(3)
    for x in (rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8),
              rng.integers(0, 65536, (16, 16), dtype=np.uint16),
              rng.random((2, 16, 16, 3)) * 255):
        np.testing.assert_array_equal(got.preprocess(x), want.preprocess(x))
    y = rng.random((2, 16, 16, 3)).astype(np.float32) * 2 - 1
    np.testing.assert_array_equal(got.postprocess(y), want.postprocess(y))
    with pytest.raises(ValueError, match="float32"):
        got.preprocess(y)


def test_random_split_membership_equals_jax():
    data = list(range(50))
    for lengths, seed in (([40, 10], 1234), ([25, 20, 5], 7)):
        want, got = jax_random_split(data, lengths, seed), _random_split(data, lengths, seed)
        assert [s.indices for s in got] == [s.indices for s in want]
        assert [got[0][i] for i in range(3)] == [want[0][i] for i in range(3)]


def test_wrapper_equals_jax():
    kw = dict(img_size=16, digit_source="synthetic", n_seqs={"train": 6, "val": 4, "test": 2})
    want, got = JaxWrapper(JaxMMF, "train", **kw), VPDatasetWrapper(MovingMNISTOnTheFly,
                                                                   "train", **kw)
    assert got.config == want.config
    assert (len(got.train_data), len(got.val_data)) == (6, 4)
    assert got.is_training_set and not got.is_test_set and got.action_size == 0
    got.set_seq_len(2, 2, 1)
    want.set_seq_len(2, 2, 1)
    assert got.is_ready()
    np.testing.assert_array_equal(got.val_data[0]["frames"], want.val_data[0]["frames"])
    got.reset_rng()
    want.reset_rng()
    np.testing.assert_array_equal(got.val_data[0]["frames"], want.val_data[0]["frames"])
    test = VPDatasetWrapper("MMF", "test", **kw)
    assert len(test.test_data) == 2
    with pytest.raises(ValueError, match="test dataset"):
        test.train_data


@pytest.mark.parametrize("shuffle,drop_last,uint8", [(True, True, True), (False, False, False)],
                         ids=["shuffled_uint8", "in_order_f32"])
def test_batch_loader_equals_jax(shuffle, drop_last, uint8):
    r"""One worker: MMF items draw from RNGs that all items share, so which
    sequence lands in which slot depends on the order of the draws, which
    threads would leave to timing."""
    want_ds, got_ds = _pair("train", img_size=16, n_seqs=7)
    for ds in (want_ds, got_ds):
        ds.set_seq_len(2, 3, 1)
    kw = dict(batch_size=2, shuffle=shuffle, seed=11, num_workers=1, drop_last=drop_last,
              uint8_frames=uint8)
    want_loader, got_loader = jax_data.BatchLoader(want_ds, **kw), BatchLoader(got_ds, **kw)
    assert len(got_loader) == len(want_loader) == (3 if drop_last else 4)
    for _ in range(2):   # two epochs: the shuffle's generator advances
        np.testing.assert_array_equal(got_loader._indices(), want_loader._indices())
        for want, got in zip(want_loader, got_loader, strict=True):
            assert got["frames"].dtype == want["frames"].dtype
            np.testing.assert_array_equal(got["frames"], want["frames"])
            np.testing.assert_array_equal(got["actions"], want["actions"])


class _Indexed:
    r"""Items that depend on their index alone, so threads cannot reorder them."""

    def __len__(self):
        return 9

    def __getitem__(self, i):
        return {"frames": np.full((2, 4, 4, 1), i / 9.0, np.float32),
                "actions": np.full((2, 1), i, np.float32), "origin": str(i)}


def test_batch_loader_threads_keep_the_order():
    want = list(jax_data.BatchLoader(_Indexed(), 2, shuffle=True, seed=3, num_workers=4))
    got = list(BatchLoader(_Indexed(), 2, shuffle=True, seed=3, num_workers=4))
    assert len(got) == len(want) == 5
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g["frames"], w["frames"])
        assert g["origin"] == w["origin"]


@pytest.mark.parametrize("depth", [1, 2])
def test_device_prefetch_reads_ahead_as_jax(depth):
    r"""The read-ahead decides how many items an epoch cut by
    ``steps_per_epoch`` draws from MMF's shared RNGs, so it must be JAX's."""
    def counted(pulls):
        for i, batch in enumerate(BatchLoader(_Indexed(), 2)):
            pulls.append(i)
            yield batch

    want_pulls, got_pulls = [], []
    want_seen, got_seen = [], []
    for batch in jax_data.device_prefetch(counted(want_pulls), depth=depth):
        want_seen.append(len(want_pulls))
        if len(want_seen) == 2:
            break
    for batch in device_prefetch(counted(got_pulls), torch.device("cpu"), depth=depth):
        got_seen.append(len(got_pulls))
        assert set(batch) == {"frames", "actions"} and batch["frames"].device.type == "cpu"
        if len(got_seen) == 2:
            break
    assert got_seen == want_seen
    first = next(iter(device_prefetch(BatchLoader(_Indexed(), 2), "cpu")))
    np.testing.assert_array_equal(first["frames"].numpy(),
                                  next(iter(BatchLoader(_Indexed(), 2)))["frames"])
