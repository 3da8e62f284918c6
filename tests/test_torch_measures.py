r"""The port's measures against the JAX package's, on the CPU.

Inputs come from a numpy seed, in f32; the JAX package runs under
``jax.default_matmul_precision("highest")``. Tolerances:

- MSE, L1, SmoothL1, PSNR and SSIM: 1e-5 relative (the same f32 formulas,
  sums in another order);
- LPIPS, the I3D features and FVD: 1e-4 relative (convolutions of up to
  7*7*7*3 taps in f32 summed in another order, through 5 and 22 layers);
  the I3D features relative to the largest of them;
- gradients: 2e-4 relative to the largest of each;
- the bilinear resize: 2e-5 absolute on values in [0, 1] (the antialiased
  kernel's f32 weights are computed in another order);
- the LPIPS and I3D random parameters: bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vp_suite_tpu.measure import METRIC_CLASSES as JAX_METRICS
from vp_suite_tpu.measure import lpips_net as jax_lpips
from vp_suite_tpu.measure.fvd import fvd as jax_fvd
from vp_suite_tpu.measure.fvd import i3d as jax_i3d
from vp_suite_tpu.measure.loss_provider import PredictionLossProvider as JaxLossProvider
from vp_suite_tpu.measure.metric_provider import PredictionMetricProvider as JaxMetricProvider
from vp_suite_tpu.ops.image import resize_bilinear as jax_resize
from vp_suite_tpu_torch.measure import METRIC_CLASSES, image_wise, lpips_net
from vp_suite_tpu_torch.measure.fvd import fvd, i3d
from vp_suite_tpu_torch.measure.loss_provider import PredictionLossProvider
from vp_suite_tpu_torch.measure.metric_provider import PredictionMetricProvider
from vp_suite_tpu_torch.ops.image import resize_bilinear
from vp_suite_tpu_torch.utils.jax_params import i3d_params_from_jax, lpips_params_from_jax

torch.set_num_threads(1)

RTOL = {"mse": 1e-5, "l1": 1e-5, "smooth_l1": 1e-5, "psnr": 1e-5, "ssim": 1e-5, "lpips": 1e-4,
        "fvd": 1e-4}
GRAD_RTOL = 2e-4


def _videos(seed, b=2, t=3, side=16, c=3):
    r"""(pred, target) as numpy f32 in [-1.1, 1.1]: reshape_clamp's range and
    a little beyond it."""
    rng = np.random.default_rng(seed)
    return tuple((rng.random((b, t, side, side, c)) * 2.2 - 1.1).astype(np.float32)
                 for _ in range(2))


def _jax(fn, *arrays, jit=False):
    with jax.default_matmul_precision("highest"):
        return (jax.jit(fn) if jit else fn)(*(jnp.asarray(a) for a in arrays))


@pytest.fixture(scope="module")
def jax_fvd_measure():
    r"""One JAX FVD measure for the module: it jit-compiles its I3D features
    once per input shape, and each instance compiles anew."""
    return JAX_METRICS["fvd"]()


def _torch(fn, *arrays):
    return fn(*(torch.from_numpy(a) for a in arrays))


def _close_to_largest(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), f"max error {err:.3g}, largest {np.abs(want).max():.3g}"


@pytest.mark.parametrize("side", [16, 64])
@pytest.mark.parametrize("name", ["mse", "l1", "smooth_l1", "psnr", "ssim", "lpips"])
def test_measure_matches_jax(name, side):
    pred, target = _videos(1, side=side)
    got_m, want_m = METRIC_CLASSES[name](), JAX_METRICS[name]()
    got, want = _torch(got_m, pred, target), _jax(want_m, pred, target, jit=True)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL[name])
    got_pf = _torch(got_m.per_frame, pred, target)
    want_pf = _jax(want_m.per_frame, pred, target, jit=True)
    assert tuple(got_pf.shape) == (2, 3)
    np.testing.assert_allclose(got_pf.numpy(), np.asarray(want_pf), rtol=RTOL[name])
    # per_frame's prefix means give forward
    np.testing.assert_allclose(float(got_pf.double().mean()), float(got), rtol=RTOL[name])


def test_measure_dtypes_follow_jax():
    r"""SSIM computes in f32 whatever comes in; LPIPS in the prediction's
    dtype."""
    pred, target = (torch.from_numpy(a).bfloat16() for a in _videos(2, side=64))
    assert METRIC_CLASSES["ssim"]()(pred, target).dtype == torch.float32
    assert METRIC_CLASSES["lpips"]()(pred, target).dtype == torch.bfloat16
    with pytest.raises(ValueError):
        METRIC_CLASSES["ssim"]()(pred[..., :1], target[..., :1])


def test_reshape_clamp_matches_jax():
    pred, target = _videos(3, side=8)
    got = _torch(image_wise.VPMeasure.reshape_clamp, pred, target)
    want = _jax(JAX_METRICS["mse"].reshape_clamp, pred, target)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert tuple(got[0].shape) == (6, 8, 8, 3)


@pytest.mark.parametrize("src,dst", [(16, 64), (64, 224), (300, 224), (100, 64)])
def test_resize_matches_jax(src, dst):
    x = np.random.default_rng(src).random((2, 2, src, src, 3)).astype(np.float32)
    got = resize_bilinear(torch.from_numpy(x), (dst, dst))
    want = np.asarray(jax_resize(jnp.asarray(x), (dst, dst)))
    assert tuple(got.shape) == want.shape == (2, 2, dst, dst, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


def test_lpips_random_params_are_jax_bit_for_bit():
    got, got_pre = lpips_net._random_params()
    want, want_pre = jax_lpips._random_params()
    assert list(got) == list(want) and got_pre is want_pre is False
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    net = lpips_net.LPIPSNet()
    assert net.pretrained is False and list(net.params) == list(want)
    for k, v in lpips_params_from_jax(want).items():
        w = want[k].transpose(3, 2, 0, 1) if k.endswith("_kernel") else want[k]
        assert np.array_equal(net.params[k].numpy(), w) and np.array_equal(v.numpy(), w), k


def test_i3d_random_params_are_jax_bit_for_bit():
    assert i3d.param_shapes() == jax_i3d.param_shapes()
    assert i3d.param_shapes(2, 10) == jax_i3d.param_shapes(2, 10)
    got, want = i3d.random_params(), jax_i3d.random_params()
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    params, pretrained = i3d.load_params()
    assert pretrained is False and list(params) == list(want)
    for k, v in i3d_params_from_jax(want).items():
        w = want[k].transpose(4, 3, 0, 1, 2) if k.endswith("_kernel") else want[k]
        assert np.array_equal(params[k].numpy(), w) and np.array_equal(v.numpy(), w), k


@pytest.mark.parametrize("n,k,s,want", [(224, 7, 2, (2, 3)), (112, 3, 2, (0, 1)),
                                        (9, 7, 2, (3, 3)), (5, 3, 2, (1, 1)), (8, 1, 1, (0, 0))])
def test_same_pads_are_tf_same(n, k, s, want):
    r"""TF-'SAME' is asymmetric: ``Conv3d_1a_7x7`` on 224 pads 2 before and 3
    after, ``MaxPool3d_2a_3x3`` on 112 pads 0 before and 1 after."""
    assert i3d.same_pads(n, k, s) == want


def test_i3d_features_match_jax():
    x = np.random.default_rng(5).random((2, 9, 224, 224, 3)).astype(np.float32) * 2 - 1
    params, _ = i3d.load_params()
    got = i3d.i3d_features(torch.from_numpy(x), params)
    jax_params, _ = jax_i3d.load_params()
    want = _jax(lambda v: jax_i3d.i3d_features(v, jax_params), x, jit=True)
    assert tuple(got.shape) == (2, 400)
    _close_to_largest(got.numpy(), want, RTOL["fvd"])


def test_calculate_n_chunks_matches_jax():
    for n in range(1, 65):
        assert fvd.calculate_n_chunks(n) == jax_fvd.calculate_n_chunks(n), n


def test_wasserstein_paths_match_jax():
    rng = np.random.default_rng(6)
    p, t = (rng.standard_normal((4, 16)).astype(np.float32) for _ in range(2))
    t += 0.5
    host = fvd.wasserstein2_numpy(p, t)
    assert host == jax_fvd.wasserstein2_numpy(p, t)
    got = _torch(fvd.wasserstein2_torch, p, t)
    want = _jax(jax_fvd.wasserstein2_jax, p, t)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL["fvd"])
    np.testing.assert_allclose(float(got), host, rtol=RTOL["fvd"])
    # the eigh path's gradient
    pt = torch.from_numpy(p).requires_grad_()
    fvd.wasserstein2_torch(pt, torch.from_numpy(t)).backward()
    with jax.default_matmul_precision("highest"):
        want_grad = jax.grad(jax_fvd.wasserstein2_jax)(jnp.asarray(p), jnp.asarray(t))
    _close_to_largest(pt.grad.numpy(), want_grad, GRAD_RTOL)


@pytest.mark.parametrize("name", ["psnr", "ssim", "lpips"])
def test_gradients_match_jax(name):
    pred, target = _videos(7, side=16)
    pt = torch.from_numpy(pred).requires_grad_()
    METRIC_CLASSES[name]()(pt, torch.from_numpy(target)).backward()
    measure = JAX_METRICS[name]()
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jax.grad(lambda p: measure(p, jnp.asarray(target))))(jnp.asarray(pred))
    _close_to_largest(pt.grad.numpy(), want, GRAD_RTOL)


@pytest.mark.parametrize("t", [9, 20])
def test_fvd_matches_jax(t, jax_fvd_measure):
    r"""T=9: one I3D window; T=20: two chunks of 10 frames."""
    pred, target = _videos(8, b=2, t=t, side=16)
    got = _torch(METRIC_CLASSES["fvd"](), pred, target)
    want = _jax(jax_fvd_measure, pred, target)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL["fvd"])
    assert _torch(METRIC_CLASSES["fvd"](), pred[:, :8], target[:, :8]) is None


def test_fvd_loss_path_matches_jax(monkeypatch, jax_fvd_measure):
    r"""With autograd recording and a prediction that requires grad, FVD
    stays on the tensors' device and takes the ``eigh`` form: its value
    against JAX's traced path (the measure under ``jax.jit``), a finite
    gradient, and no host eigendecomposition. JAX's traced path is
    ``wasserstein2_jax`` of its I3D features. (The eigh form's gradient is
    held against ``jax.grad`` in ``test_wasserstein_paths_match_jax``; through
    I3D at b=2 it carries the noise of the covariance's zero eigenvalue.)"""
    pred, target = _videos(9, b=2, t=9, side=16)

    def refuse(*args):
        raise AssertionError("the loss path went to the host")
    monkeypatch.setattr(fvd, "wasserstein2_numpy", refuse)
    pt = torch.from_numpy(pred).requires_grad_()
    got = METRIC_CLASSES["fvd"]()(pt, torch.from_numpy(target))
    got.backward()
    features = jax_fvd_measure._features_fn
    want = _jax(lambda p, t: jax_fvd.wasserstein2_jax(features(jax_resize(p, (224, 224))),
                                                      features(jax_resize(t, (224, 224)))),
                pred, target)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL["fvd"])
    assert bool(torch.isfinite(pt.grad).all()) and bool((pt.grad != 0).any())


def _assert_dicts_close(got, want):
    r"""Display values compared as the measures' own values: SSIM's is
    ``1 - SSIM`` (SSIM itself may be near 0, where a relative bound is
    meaningless)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            name = k.split(" ")[0]
            own = (lambda v: 1.0 - v) if name == "ssim" else (lambda v: v)
            np.testing.assert_allclose(own(g[k]), own(w[k]), rtol=RTOL[name], err_msg=k)


def test_metric_provider_matches_jax(jax_fvd_measure):
    r"""All seven measures for each horizon 1..10, FVD from 9 frames on."""
    pred, target = _videos(10, b=2, t=10, side=16)
    config = {"metrics": "all", "img_c": 3}
    got = _torch(lambda p, t: PredictionMetricProvider(config).get_metrics(
        p, t, all_frame_cnts=True), pred, target)
    jax_provider = JaxMetricProvider(config)
    jax_provider.metrics["fvd"] = jax_fvd_measure
    want = _jax(lambda p, t: jax_provider.get_metrics(p, t, all_frame_cnts=True), pred, target)
    assert len(got) == 10 and "fvd (↓)" not in got[7] and "fvd (↓)" in got[8]
    _assert_dicts_close(got, want)
    one = _torch(lambda p, t: PredictionMetricProvider({**config, "metrics": ["mse", "ssim"]})
                 .get_metrics(p, t, frames=4), pred, target)
    _assert_dicts_close(one, [{k: got[3][k] for k in ("mse (↓)", "ssim (↑)")}])


def test_metric_provider_leaves_out_fvd_below_two_channels():
    with pytest.warns(UserWarning, match="FVD"):
        provider = PredictionMetricProvider({"metrics": "all", "img_c": 1})
    assert "fvd" not in provider.metrics and len(provider.metrics) == 6


def test_loss_provider_takes_the_new_losses():
    pred, target = _videos(11, side=16)
    config = {"losses_and_scales": {"mse": 1.0, "ssim": 0.5, "psnr": 0.1, "lpips": 2.0},
              "img_c": 3}
    got_vals, got_total = _torch(PredictionLossProvider(config).get_losses, pred, target)
    want_vals, want_total = _jax(JaxLossProvider(config).get_losses, pred, target, jit=True)
    assert list(got_vals) == list(config["losses_and_scales"]) and set(want_vals) == set(got_vals)
    for k in want_vals:
        np.testing.assert_allclose(float(got_vals[k]), float(want_vals[k]), rtol=RTOL[k])
    np.testing.assert_allclose(float(got_total), float(want_total), rtol=1e-4)
    with pytest.raises(ValueError, match="unknown losses"):
        PredictionLossProvider({"losses_and_scales": {"vgg": 1.0}, "img_c": 3})
