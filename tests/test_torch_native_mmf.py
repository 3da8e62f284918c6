r"""On-the-fly Moving MNIST's ``backend="native"`` (the port's copy of the C
generator, ``vp_suite_tpu_torch/native/``) against the JAX package's native
items, bit for bit: each split, several indices, frame sizes where the digits
are shrunk (16), clamped (32) and as they are (64), one channel, three
digits, another value range. Items do not depend on the order of reads or on
threads. Without a C compiler the dataset raises; there is no numpy fallback.
"""
import concurrent.futures as cf
import shutil

import numpy as np
import pytest
import torch

from vp_suite_tpu.datasets.mmnist_on_the_fly import MovingMNISTOnTheFly as JaxMMF
from vp_suite_tpu_torch.datasets.mmnist_on_the_fly import MovingMNISTOnTheFly
from vp_suite_tpu_torch.native import build

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(shutil.which("cc") is None, reason="no C compiler available")

CASES = [(16, {}), (32, {}), (64, {}),
         (32, dict(num_channels=1, num_digits=3, value_range_min=-1.0, value_range_max=1.0)),
         (24, dict(min_speed=1, max_speed=7, rng_seed=7))]


@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("img_size,kw", CASES, ids=[str(i) for i in range(len(CASES))])
def test_native_items_equal_jax(split, img_size, kw):
    kw = dict(img_size=img_size, digit_source="synthetic", backend="native", n_seqs=16, **kw)
    want, got = JaxMMF(split, **kw), MovingMNISTOnTheFly(split, **kw)
    for d in (want, got):
        d.set_seq_len(3, 4, 1)
    for i in (0, 5, 15, 2):
        w, g = want[i], got[i]
        assert g["frames"].dtype == np.float32 and g["frames"].shape == w["frames"].shape
        np.testing.assert_array_equal(g["frames"], w["frames"])
        np.testing.assert_array_equal(g["actions"], w["actions"])
        assert g["origin"] == w["origin"]
    assert got.config == {**want.config, "backend": "native"}


def test_native_items_do_not_depend_on_order_or_threads():
    ds = MovingMNISTOnTheFly("train", img_size=32, digit_source="synthetic", backend="native",
                             n_seqs=32)
    ds.set_seq_len(2, 3, 1)
    first = [ds[i]["frames"] for i in range(32)]
    with cf.ThreadPoolExecutor(max_workers=4) as pool:
        again = list(pool.map(lambda i: ds[i]["frames"], reversed(range(32))))[::-1]
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(first[0], first[1])


def test_native_without_a_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("CC", "no-such-compiler")
    with pytest.raises(RuntimeError, match="no C compiler"):
        MovingMNISTOnTheFly("train", img_size=16, digit_source="synthetic", backend="native")
    assert not (tmp_path / "_build").exists()
