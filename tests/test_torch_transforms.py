r"""The port's numpy transforms (``vp_suite_tpu_torch/utils/transforms.py``)
against the JAX package's (``vp_suite_tpu/utils/transforms.py``, which calls
OpenCV for ``Resize``, ``RandomRotation`` and ``GaussianBlur``), on the same
seeds and inputs: frames of [0, 1] floats, square and not, with 1 and 3
channels, alone and under leading time and batch axes.

- ``Resize`` (up and down, each axis alone and both), ``RandomRotation`` and
  ``GaussianBlur`` within 1e-5 absolute;
- ``CenterCrop``, ``RandomCrop``, both flips, ``Grayscale`` and
  ``RandomGrayscale`` bit for bit, over several draws;
- a ``Compose`` of random transforms after ``reset_rng``, draw by draw;
- the ``CROPS`` and ``SHAPE_PRESERVING_AUGMENTATIONS`` lists, class by name.
"""
import numpy as np
import pytest
import torch

from vp_suite_tpu.utils import transforms as J
from vp_suite_tpu_torch.utils import transforms as P

torch.set_num_threads(1)

SHAPES = {"square c3": (12, 12, 3), "wide c1": (9, 14, 1), "time c3": (3, 10, 13, 3),
          "batch time c1": (2, 3, 11, 8, 1)}
CLOSE = 1e-5


def _frames(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("size", [(5, 7), (24, 31), (12, 20), (20, 6), 16, (3, 3)],
                         ids=str)
@pytest.mark.parametrize("shape", list(SHAPES), ids=str)
def test_resize_matches_cv2(shape, size):
    x = _frames(SHAPES[shape])
    want, got = J.Resize(size)(x), P.Resize(size)(x)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=CLOSE)


@pytest.mark.parametrize("degrees", [5, 30, 180])
@pytest.mark.parametrize("shape", list(SHAPES), ids=str)
def test_random_rotation_matches_cv2(shape, degrees):
    x = _frames(SHAPES[shape], seed=degrees)
    want_t, got_t = J.RandomRotation(degrees, seed=3), P.RandomRotation(degrees, seed=3)
    for _ in range(3):   # three draws of the angle
        want, got = want_t(x), got_t(x)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=CLOSE)


@pytest.mark.parametrize("kernel,sigma", [(3, 1.0), (5, 2.0), (7, 0.6), (5, 0.0), (9, 0.0)])
@pytest.mark.parametrize("shape", list(SHAPES), ids=str)
def test_gaussian_blur_matches_cv2(shape, kernel, sigma):
    x = _frames(SHAPES[shape], seed=kernel)
    want, got = J.GaussianBlur(kernel, sigma)(x), P.GaussianBlur(kernel, sigma)(x)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=CLOSE)


def test_gaussian_kernel_is_cv2s():
    import cv2
    for k, s in ((3, 1.0), (5, 2.0), (7, 0.6), (5, 0.0), (9, 0.0), (1, 0.0)):
        np.testing.assert_allclose(P.gaussian_kernel(k, s),
                                   cv2.getGaussianKernel(k, s, cv2.CV_32F)[:, 0],
                                   rtol=0, atol=1e-7)
    np.testing.assert_array_equal(P.rotation_matrix((6.5, 4.0), 33.0),
                                  cv2.getRotationMatrix2D((6.5, 4.0), 33.0, 1.0))


@pytest.mark.parametrize("shape", list(SHAPES), ids=str)
def test_exact_transforms_match_bit_for_bit(shape):
    x = _frames(SHAPES[shape], seed=7)
    pairs = [(J.CenterCrop(5), P.CenterCrop(5)), (J.CenterCrop((6, 4)), P.CenterCrop((6, 4))),
             (J.CenterCrop(40), P.CenterCrop(40)),
             (J.RandomCrop(5, seed=1), P.RandomCrop(5, seed=1)),
             (J.RandomCrop((7, 3), seed=2), P.RandomCrop((7, 3), seed=2)),
             (J.RandomHorizontalFlip(seed=3), P.RandomHorizontalFlip(seed=3)),
             (J.RandomVerticalFlip(0.7, seed=4), P.RandomVerticalFlip(0.7, seed=4))]
    if SHAPES[shape][-1] == 3:
        pairs += [(J.Grayscale(), P.Grayscale()),
                  (J.RandomGrayscale(0.5, seed=5), P.RandomGrayscale(0.5, seed=5))]
    for want_t, got_t in pairs:
        for _ in range(4):
            want, got = want_t(x), got_t(x)
            assert got.shape == want.shape and got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_grayscale_of_one_channel_fails_as_in_jax():
    x = _frames((4, 5, 1))
    for t in (J.Grayscale(), P.Grayscale()):
        with pytest.raises(ValueError):
            t(x)


def test_compose_reset_rng_draws_as_jax():
    x = _frames((2, 3, 14, 18, 3), seed=9)

    def chain(T):
        return T.Compose([T.RandomCrop((10, 12)), T.Resize((16, 20)),
                          T.RandomHorizontalFlip(), T.RandomVerticalFlip(),
                          T.RandomRotation(20), T.GaussianBlur(3, 0.8), T.RandomGrayscale(0.5)])

    want_t, got_t = chain(J), chain(P)
    for seed in (0, 11):
        want_t.reset_rng(seed)
        got_t.reset_rng(seed)
        for _ in range(4):
            want, got = want_t(x), got_t(x)
            assert got.shape == want.shape == (2, 3, 16, 20, 3)
            np.testing.assert_allclose(got, want, rtol=0, atol=CLOSE)


def test_transform_lists_are_jaxs():
    for name in ("CROPS", "SHAPE_PRESERVING_AUGMENTATIONS"):
        assert [c.__name__ for c in getattr(P, name)] == [c.__name__ for c in getattr(J, name)]
    for cls in P.CROPS + [P.Resize]:
        assert not cls.SHAPE_PRESERVING
    for cls in P.SHAPE_PRESERVING_AUGMENTATIONS:
        assert cls.SHAPE_PRESERVING
