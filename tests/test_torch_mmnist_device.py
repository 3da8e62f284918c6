r"""Moving MNIST batches made on the device, against the JAX package's.

- Given the draws that the JAX package's ``generate_batch`` makes from a key
  (template ids, start positions and speeds, reproduced here with
  ``jax.random.split``, ``jax.random.randint`` and ``_sample_speed``), the
  port's ``render`` gives its frames exactly, at 16x16 (8x8 digits) and 32x32
  (28x28 digits, where the bounce's clamp fires), and ``simulate`` gives
  ``_simulate``'s trajectories.
- The port's own draws come from a ``torch.Generator``: they hold the same
  distributions (speeds over {±2..±5}, start positions in [0, S - ds),
  values in [0, 1]) and the same seed gives the same batches.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vp_suite_tpu.datasets.mmnist_device import _sample_speed, _simulate, generate_batch
from vp_suite_tpu.datasets.mmnist_on_the_fly import MovingMNISTOnTheFly as JaxMMF
from vp_suite_tpu_torch.datasets.mmnist_device import (DeviceBatchIterator, render, sample,
                                                       sample_speed, simulate)
from vp_suite_tpu_torch.datasets.mmnist_on_the_fly import MovingMNISTOnTheFly

torch.set_num_threads(1)

B, D, T = 4, 2, 9


def _templates(img_size):
    ds = JaxMMF("train", img_size=img_size, digit_source="synthetic", n_seqs=4)
    return ds._digit_templates()


def _jax_draws(key, n, img_size, ds, min_speed=2, max_speed=5):
    r"""The draws of ``generate_batch(key, ...)``, made as it makes them."""
    k_id, k_pos, k_speed = jax.random.split(key, 3)
    ids = jax.random.randint(k_id, (B, D), 0, n)
    pos0 = jax.random.randint(k_pos, (B, D, 2), 0, img_size - ds)
    speed0 = _sample_speed(k_speed, (B, D, 2), min_speed, max_speed)
    return k_pos, k_speed, [torch.from_numpy(np.asarray(a).astype(np.int64))
                            for a in (ids, pos0, speed0)]


@pytest.mark.parametrize("img_size,channels,value_range",
                         [(16, 3, (0.0, 1.0)), (32, 3, (0.0, 1.0)), (16, 1, (-1.0, 1.0))],
                         ids=["16", "32", "16_gray_pm1"])
@pytest.mark.parametrize("seed", [0, 5])
def test_render_is_jax_generate_batch(img_size, channels, value_range, seed):
    templates_u8 = _templates(img_size)
    templates = np.asarray(templates_u8, np.float32) / 255.0
    n, ds = templates.shape[0], templates.shape[-1]
    key = jax.random.PRNGKey(seed)
    want = np.asarray(generate_batch(key, jnp.asarray(templates), batch=B, seq_len=T,
                                     img_size=img_size, num_channels=channels, num_digits=D,
                                     min_speed=2, max_speed=5, value_range=value_range))
    _, _, (ids, pos0, speed0) = _jax_draws(key, n, img_size, ds)
    got = render(torch.from_numpy(templates), ids, pos0, speed0, seq_len=T, img_size=img_size,
                 num_channels=channels, value_range=value_range)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert tuple(got.shape) == want.shape == (B, T, img_size, img_size, channels)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("img_size,ds", [(64, 28), (32, 28), (16, 8)])
def test_simulate_is_jax_simulate(img_size, ds):
    k_pos, k_speed, (_, pos0, speed0) = _jax_draws(jax.random.PRNGKey(3), 100, img_size, ds)
    want = np.asarray(_simulate(k_pos, k_speed, B, D, 25, img_size, ds, 2, 5))
    got = simulate(pos0, speed0, 25, img_size, ds)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got >= 0).all() and (got <= img_size - ds).all()


def test_own_draws_hold_the_distributions():
    gen = torch.Generator().manual_seed(0)
    v = sample_speed(gen, (4000,), 2, 5)
    assert set(v.abs().unique().tolist()) == {2, 3, 4, 5}
    assert (v < 0).any() and (v > 0).any()
    v0 = sample_speed(gen, (4000,), 0, 2)
    assert set(v0.unique().tolist()) == {-2, -1, 0, 1, 2}
    ids, pos0, speed0 = sample(gen, 100, batch=64, num_digits=2, img_size=32, digit_size=28,
                               min_speed=2, max_speed=5)
    assert ids.min() >= 0 and ids.max() < 100
    assert set(pos0.unique().tolist()) == {0, 1, 2, 3}
    assert set(speed0.abs().unique().tolist()) <= {2, 3, 4, 5}


def test_iterator_is_seeded_and_yields_batches_on_its_device():
    kw = dict(batch_size=3, seq_len=5, img_size=16, num_channels=3, num_digits=2, min_speed=2,
              max_speed=5, value_range=(0.0, 1.0), n_steps=3, device="cpu")
    templates = _templates(16)
    batches = list(DeviceBatchIterator(templates, seed=7, **kw))
    again = list(DeviceBatchIterator(templates, seed=7, **kw))
    other = list(DeviceBatchIterator(templates, seed=8, **kw))
    assert len(batches) == 3
    for b, a, o in zip(batches, again, other):
        f = b["frames"]
        assert tuple(f.shape) == (3, 5, 16, 16, 3) and f.dtype == torch.float32
        assert f.min() >= 0 and f.max() <= 1 and (f.sum(dim=(2, 3, 4)) > 0).all()
        assert torch.equal(f[..., 0], f[..., 2])
        assert torch.equal(b["actions"], torch.zeros(3, 5, 1))
        assert torch.equal(f, a["frames"]) and not torch.equal(f, o["frames"])
    assert not torch.equal(batches[0]["frames"], batches[1]["frames"])


def test_dataset_iterator_seed_is_jax_formula():
    ds = MovingMNISTOnTheFly("train", img_size=16, digit_source="synthetic", backend="device",
                             n_seqs=8)
    ds.set_seq_len(2, 2, 1)
    it = ds.device_batch_iterator(4, 2, seed=42 * 9973 + 1, device="cpu")
    assert it.seed == ((3 * 4115 + 2) << 16) ^ (42 * 9973 + 1)
    batches = list(it)
    assert len(batches) == 2 and tuple(batches[0]["frames"].shape) == (4, 4, 16, 16, 3)
    assert tuple(ds[0]["frames"].shape) == (4, 16, 16, 3)   # items come from the numpy path
