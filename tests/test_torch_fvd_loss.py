r"""FVD as a loss inside the port's steps, and E1 (the symmetric eigensolver
its device distance takes its eigenvalues from), on the CPU, against the JAX
package.

EF-ConvLSTM at 16x16 (weights from JAX's init, carried into the port), the
losses ``{"mse": 1, "fvd": 1}``, 2 -> 9 frames (FVD's minimum) and a global
batch of 4 (``helpers/torch_parallel_worker.py``'s ``fvd`` task, which makes
the frames from a numpy seed); one JAX compile per step shared across the
tests; JAX at ``default_matmul_precision("highest")``.

- (a) The eval step takes the distance JAX's does: with ``use_jit=True``
  (eager on the CPU, where JAX's ``jit`` still traces) the device distance,
  against JAX's jitted eval step, with the host distance made to raise; with
  ``use_jit=False`` the host's f64 distance, against JAX's unjitted step,
  with the device distance made to raise. Values to 1e-4 relative (I3D's
  convolutions summed in another order; MSE 1e-5).
- (b) One f32 SGD train step against JAX's: losses to 1e-4 relative, the
  update as ``(p0 - p1) / lr`` within 5e-4 of the largest of each tensor (at
  least 1). Both train steps take the worker's ``standin_features`` for I3D
  (a fixed projection of block means, the same function in both packages):
  JAX's I3D backward at 224x224 takes minutes a call on the CPU, far beyond
  the suite's budget, where its forward takes seconds.
  I3D's forward is held against JAX's in ``test_torch_measures.py`` and runs
  here in every eval step; its backward is PyTorch's autograd.
- (c) Two gloo processes at ``data=2``, 2 rows each, against JAX's one-process
  steps on the 4-row batch: the eval step on the mesh, the facade's validation
  (an eval step without the mesh inside ``fvd_in_step``) and the train step's
  losses (1e-4 relative) and parameters (as in (b); both processes equal).
  FVD's covariances are over the batch, so each process computes the global
  batch's distance on features gathered over ``data``; a mean of per-process
  distances is another number.
- (d) E1's plain version (``torch.linalg.eigh``) and its Function's backward
  (``v diag(g) v^T``) against ``jnp.linalg.eigh`` and ``jax.grad`` of
  ``sum(sqrt(clip(eigh(m), 0) + 1e-15))`` on symmetric positive definite
  matrices at b = 1, 2, 4, 32: eigenvalues within 1e-5 of the largest, the
  eigenvectors by reconstruction and orthogonality (within 1e-5; degenerate
  eigenvalues leave columns undetermined), the gradient within 1e-4 of its
  largest element.
- (e) A step-by-step transcription of E1's arithmetic (the round-robin pairs,
  the rotations in Numerical Recipes' form, the two-by-two block updates with
  their mirrors, the off-diagonal test and the sweep cap) against
  ``torch.linalg.eigh``: within the same 1e-5 gates, on FVD-made matrices
  (rank-deficient: centred features), one with repeated eigenvalues, and a
  zero matrix (the FVD of one video), converging within half the cap (the
  repeated eigenvalues take 14 sweeps, FVD's matrices at most 6).

Why the near-zero eigenvalue is kept out of the numeric comparisons with JAX:
centring leaves ``m = a a^T`` one exact zero eigenvalue, which any f32
eigensolver returns as rounding noise of either sign (up to about 1e-7 of the
largest); its square root then shifts the distance, differently for
``torch.linalg.eigh`` and JAX's ``eigh`` (by percents where the prediction is
close to the target). So (a) tells the two distances apart by
which function ran, and the data keeps FVD's covariance part well determined.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vp_suite_tpu.measure.fvd import fvd as jax_fvd
from vp_suite_tpu.measure.loss_provider import PredictionLossProvider as JaxLossProvider
from vp_suite_tpu.models import MODEL_CLASSES as JAX_MODELS
from vp_suite_tpu.training import loop as jax_loop
from vp_suite_tpu.training.train_state import TrainState as JaxTrainState
from vp_suite_tpu_torch.measure.fvd import fvd
from vp_suite_tpu_torch.measure.loss_provider import PredictionLossProvider
from vp_suite_tpu_torch.models import build_model
from vp_suite_tpu_torch.ops import sym_eig as e1
from vp_suite_tpu_torch.training.loop import make_eval_step, make_train_step
from vp_suite_tpu_torch.training.train_state import create_train_state
from vp_suite_tpu_torch.utils.jax_params import ef_state_dict_from_jax

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "helpers" / "torch_parallel_worker.py"
_spec = importlib.util.spec_from_file_location("torch_parallel_worker", WORKER)
W = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(W)
WORLD_TIMEOUT = 150

RTOL = {"total": 1e-4, "mse": 1e-5, "fvd": 1e-4}
STEP_TOL = 5e-4
EIG_TOL = 1e-5
GRAD_TOL = 1e-4
#: E1's cap on sweeps (``csrc/sym_eig.cu``'s MAX_SWEEPS)
MAX_SWEEPS = 30


@pytest.fixture(scope="module")
def weights():
    r"""JAX's EF-ConvLSTM parameters (a jitted init) and the port's
    ``state_dict`` of them."""
    params = jax.jit(JAX_MODELS["convlstm-shi"](**W.EF).init_params)(jax.random.PRNGKey(0))
    return params, ef_state_dict_from_jax(params)


@pytest.fixture(scope="module")
def world(weights, tmp_path_factory):
    r"""The ``fvd`` world of two processes, started before JAX's steps
    compile, so that it runs meanwhile."""
    out_dir = tmp_path_factory.mktemp("fvd")
    torch.save(weights[1], out_dir / "fvd_weights.pt")
    started = W.World("fvd", out_dir, timeout=WORLD_TIMEOUT)
    yield started
    started.stop()


def _model(weights):
    model = build_model("convlstm-shi", 0, "cpu", **W.EF)
    model.load_state_dict(weights[1])
    return model


def _losses():
    return PredictionLossProvider({"losses_and_scales": W.FVD_LOSSES, "img_c": 3})


def _batch():
    return {"frames": torch.from_numpy(W.fvd_frames())}


@pytest.fixture(scope="module")
def jax_side(weights, world):
    r"""JAX's jitted and unjitted eval steps and its jitted SGD step on the
    4-row batch: ``(p0, results)``, ``p0`` the port's ``state_dict``."""
    params, p0 = weights
    jmodel = JAX_MODELS["convlstm-shi"](**W.EF)
    optimizer = optax.sgd(W.LR)
    state = jax.tree.map(jnp.asarray, JaxTrainState(
        params=params, extra_vars={}, opt_state=optimizer.init(params),
        step=jnp.asarray(0, jnp.int32), model_state=jmodel.init_model_state(),
        rng=jax.random.PRNGKey(0)))
    run = {**W.FVD_RUN, "use_actions": False}
    batch = {"frames": jnp.asarray(W.fvd_frames())}
    out = {}
    with jax.default_matmul_precision("highest"):
        lp = JaxLossProvider({"losses_and_scales": W.FVD_LOSSES, "img_c": 3, "device": None})
        for use_jit in (True, False):
            metrics = jax_loop.make_eval_step(jmodel, run, lp, use_jit=use_jit)(state, batch)
            out[f"eval_{use_jit}"] = {k: float(v) for k, v in metrics.items()}
        real, jax_fvd.i3d_features = jax_fvd.i3d_features, _jax_standin_features
        try:   # a provider of its own: its FVD traces the stand-in
            lp = JaxLossProvider({"losses_and_scales": W.FVD_LOSSES, "img_c": 3,
                                  "device": None})
            step = jax_loop.make_train_step(jmodel, run, optimizer, lp, donate=False)
            after, metrics = step(state, batch, jnp.asarray(0.0))
            out["train"] = {k: float(v) for k, v in metrics.items()}
        finally:
            jax_fvd.i3d_features = real
        out["after"] = ef_state_dict_from_jax(jax.device_get(after.params))
    return p0, out


def _jax_standin_features(x, params=None):
    r"""The worker's ``standin_features`` in JAX."""
    b, t, _, _, c = x.shape
    pooled = x.reshape(b, t, 7, 32, 7, 32, c).mean(axis=(3, 5))
    return jnp.tanh(pooled.reshape(b, -1) @ jnp.asarray(W.standin_weight()))


def _assert_metrics(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), v, rtol=RTOL[k], err_msg=k)


def _assert_update(p0, got, want):
    r"""``(p0 - p1) / lr`` within STEP_TOL times the largest of each tensor
    (at least 1), as ``test_torch_graphs.py`` holds SGD steps."""
    assert set(got) == set(want)
    for k, v in want.items():
        g, w = ((p0[k] - got[k]) / W.LR).numpy(), ((p0[k] - v) / W.LR).numpy()
        err, scale = np.abs(g - w).max(), np.abs(w).max()
        assert err <= STEP_TOL * max(scale, 1.0), f"{k}: {err:.3g} > {STEP_TOL} * {scale:.3g}"


def _refuse(name):
    def refuse(*args):
        raise AssertionError(f"the step took {name}")
    return refuse


# ---------------------------------------------------------------------------
# (a) the eval step's distance

@pytest.mark.parametrize("use_jit", [True, False], ids=["jit", "no_jit"])
def test_eval_step_takes_jax_distance(use_jit, weights, jax_side, monkeypatch):
    r"""``use_jit=True``: the device distance (JAX's jitted step traces);
    ``False``: the host's f64 distance (JAX's unjitted step)."""
    _, want = jax_side
    other = "wasserstein2_numpy" if use_jit else "wasserstein2_torch"
    monkeypatch.setattr(fvd, other, _refuse(other))
    model = _model(weights)
    state = create_train_state(model, lr=W.LR, optimizer="sgd")
    got = make_eval_step(model, W.FVD_RUN, _losses(), use_jit=use_jit)(state, _batch())
    _assert_metrics(got, want[f"eval_{use_jit}"])


def test_metrics_outside_a_step_keep_the_host_distance(monkeypatch):
    r"""``test``'s metrics run outside any step, as JAX's run outside ``jit``:
    with no grad the host distance; ``step_distance`` picks the device one,
    and outside it the host one holds again."""
    rng = np.random.default_rng(3)
    pred, target = (torch.from_numpy(rng.random((3, 9, 8, 8, 3), dtype=np.float32))
                    for _ in range(2))
    seen = []
    for name in ("wasserstein2_numpy", "wasserstein2_torch"):
        def recording(p, t, _f=getattr(fvd, name), _name=name):
            seen.append(_name)
            return _f(p, t)
        monkeypatch.setattr(fvd, name, recording)
    monkeypatch.setattr(fvd, "i3d_features", W.standin_features)
    measure = fvd.FrechetVideoDistance()
    with torch.no_grad():
        host = measure(pred, target)
        with fvd.step_distance():
            device = measure(pred, target)
        after = measure(pred, target)
    assert seen == ["wasserstein2_numpy", "wasserstein2_torch", "wasserstein2_numpy"]
    np.testing.assert_allclose(float(device), float(host), rtol=RTOL["fvd"])
    assert float(after) == float(host)


# ---------------------------------------------------------------------------
# (b) the train step

def test_train_step_matches_jax(weights, jax_side, monkeypatch):
    p0, want = jax_side
    monkeypatch.setattr(fvd, "wasserstein2_numpy", _refuse("wasserstein2_numpy"))
    monkeypatch.setattr(fvd, "i3d_features", W.standin_features)
    model = _model(weights)
    state = create_train_state(model, lr=W.LR, optimizer="sgd")
    _, metrics = make_train_step(model, W.FVD_RUN, _losses())(state, _batch())
    _assert_metrics(metrics, want["train"])
    _assert_update(p0, model.state_dict(), want["after"])
    assert e1.sym_eig.launches == 0   # CPU tensors: the plain version


# ---------------------------------------------------------------------------
# (c) a data mesh of two processes

@pytest.fixture(scope="module")
def world_results(world):
    world.wait()
    return [torch.load(world.out_dir / f"fvd_{r}.pt", weights_only=False) for r in range(2)]


@pytest.mark.parametrize("what", ["val", "facade", "train"])
def test_data_mesh_losses_are_the_global_batch(what, world_results, jax_side):
    _, want = jax_side
    for rank in range(2):
        _assert_metrics(world_results[rank][what], want["train" if what == "train"
                                                         else "eval_True"])


def test_data_mesh_step_matches_jax(world_results, jax_side):
    p0, want = jax_side
    for rank in range(2):
        _assert_update(p0, world_results[rank]["state_dict"], want["after"])
    for k, v in world_results[0]["state_dict"].items():
        assert torch.equal(v, world_results[1]["state_dict"][k]), k


# ---------------------------------------------------------------------------
# (d) E1's plain version and its Function against JAX

def _spd(b, seed):
    r"""A symmetric positive definite f32 ``[b, b]``: ``a a^T`` of a random
    square ``a`` (its eigenvalues well away from 0 and from each other)."""
    a = np.random.default_rng(seed).standard_normal((b, b)).astype(np.float32)
    return (a @ a.T + 0.5 * np.eye(b, dtype=np.float32)).astype(np.float32)


def _assert_decomposition(w, v, m, want_w):
    r"""Eigenvalues within EIG_TOL of the largest; ``v diag(w) v^T`` against
    ``m`` and ``v^T v`` against the identity within EIG_TOL (of the largest
    eigenvalue, and absolutely)."""
    w, v, m, want_w = (torch.as_tensor(np.array(x), dtype=torch.float64)
                       for x in (w, v, m, want_w))
    scale = float(want_w.abs().max()) or 1.0
    assert float((w - want_w).abs().max()) <= EIG_TOL * scale
    assert bool((w[1:] >= w[:-1]).all())
    assert float((v @ torch.diag(w) @ v.T - m).abs().max()) <= EIG_TOL * scale
    assert float((v.T @ v - torch.eye(len(w), dtype=torch.float64)).abs().max()) <= EIG_TOL


def _sqrt_sum(s, clip, sqrt):
    return sqrt(clip(s) + 1e-15).sum()


@pytest.mark.parametrize("b", [1, 2, 4, 32])
def test_e1_plain_version_and_gradient_match_jax(b):
    m = _spd(b, b)
    w, v = e1.sym_eig(torch.from_numpy(m))
    jw, _ = jnp.linalg.eigh(jnp.asarray(m))
    _assert_decomposition(w, v, m, jw)
    mt = torch.from_numpy(m).requires_grad_()
    _sqrt_sum(e1.sym_eigvals(mt), lambda s: s.clamp_min(0.0), torch.sqrt).backward()
    with jax.default_matmul_precision("highest"):
        want = jax.grad(lambda x: _sqrt_sum(jnp.linalg.eigh(x)[0], lambda s: jnp.clip(s, 0.0),
                                            jnp.sqrt))(jnp.asarray(m))
    want = np.asarray(want)
    assert np.abs(mt.grad.numpy() - want).max() <= GRAD_TOL * np.abs(want).max()


def test_e1_function_runs_under_inference_mode():
    m = torch.from_numpy(_spd(4, 9))
    with torch.inference_mode():
        got = e1.sym_eigvals(m)
    assert torch.equal(got, torch.linalg.eigh(m)[0])


def test_e1_operator_checks_and_shapes():
    with pytest.raises(ValueError, match=r"\[\.\.\., n, n\]"):
        e1.sym_eigvals(torch.zeros(3, 4))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        e1.sym_eig(torch.zeros(2, 3, 3, device="meta"))
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    with FakeTensorMode():
        w, v = torch.ops.vp_suite_tpu_torch.sym_eig(torch.empty(5, 7, 7))
    assert tuple(w.shape) == (5, 7) and tuple(v.shape) == (5, 7, 7)
    with FlopCounterMode(display=False) as counter:
        e1.sym_eig(torch.eye(6).expand(2, 6, 6).contiguous())
    assert counter.get_total_flops() == 2 * 9 * 6 ** 3


# ---------------------------------------------------------------------------
# (e) E1's algorithm, transcribed

def _tour(j, r, n2):
    return 0 if j == 0 else 1 + (j - 1 + r) % (n2 - 1)


def jacobi_transcription(m, max_sweeps=MAX_SWEEPS):
    r"""``(w, v, sweeps)`` as E1 computes them for one ``[n, n]`` matrix, in
    f32: the lower triangle, padded to an even n2; before each sweep the
    off-diagonal test against FLT_EPSILON times the Frobenius norm; n2 - 1
    rounds of the round-robin pairs, each pair's rotation (s, u = s / (1 +
    c), t), the blocks (a, b) with a < b as ``R_a^T X R_b`` stored with their
    mirrors, each pair's diagonal block as ``diag(a_pp - t a_pq, a_qq + t
    a_pq)``, V's pair columns; the diagonal sorted."""
    n = m.shape[0]
    n2, f32 = n + n % 2, torch.float32
    half = n2 // 2
    A = torch.zeros(n2, n2, dtype=f32)
    A[:n, :n] = torch.tril(m) + torch.tril(m, -1).T
    V = torch.eye(n2, dtype=f32)
    eps = torch.finfo(f32).eps
    off_diagonal = 1.0 - torch.eye(n2, dtype=f32)
    tol = eps * eps * (A * A).sum()
    sweeps = 0
    while sweeps < max_sweeps and (A * A * off_diagonal).sum() > tol:
        sweeps += 1
        for r in range(n2 - 1):
            P = torch.tensor([_tour(i, r, n2) for i in range(half)])
            Q = torch.tensor([_tour(n2 - 1 - i, r, n2) for i in range(half)])
            apq, app, aqq = A[P, Q], A[P, P], A[Q, Q]
            nz = apq != 0
            tau = (aqq - app) / torch.where(nz, 2 * apq, torch.ones((), dtype=f32))
            one = torch.ones((), dtype=f32)
            t = torch.where(nz, torch.where(tau >= 0, one, -one)
                            / (tau.abs() + torch.hypot(one, tau)), torch.zeros((), dtype=f32))
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            u = s / (1.0 + c)
            # rows, then columns, of every block: R_a^T X R_b
            Y = A.clone()
            Y[P], Y[Q] = A[P] - s[:, None] * (A[Q] + u[:, None] * A[P]), \
                A[Q] + s[:, None] * (A[P] - u[:, None] * A[Q])
            Z = Y.clone()
            Z[:, P], Z[:, Q] = Y[:, P] - s * (Y[:, Q] + u * Y[:, P]), \
                Y[:, Q] + s * (Y[:, P] - u * Y[:, Q])
            # the blocks a < b with their mirrors
            pair = torch.empty(n2, dtype=torch.long)
            pair[P], pair[Q] = torch.arange(half), torch.arange(half)
            upper = pair[:, None] < pair[None, :]
            A = torch.where(upper, Z, torch.where(upper.T, Z.T, A))
            A[P, P], A[Q, Q] = app - t * apq, aqq + t * apq
            A[P, Q] = A[Q, P] = 0.0
            V[:, P], V[:, Q] = V[:, P] - s * (V[:, Q] + u * V[:, P]), \
                V[:, Q] + s * (V[:, P] - u * V[:, Q])
    d = A.diagonal()[:n]
    order = torch.argsort(d, stable=True)
    return d[order], V[:n, :n][:, order], sweeps


def _fvd_matrix(b, seed, noise=0.05, width=400):
    r"""FVD's ``m = a a^T`` (``a = c_p^T c_t``, f32) of ``b`` 400-wide feature
    sets, the target the prediction plus ``noise``: centring leaves it one
    exact zero eigenvalue."""
    rng = np.random.default_rng(seed)
    p = torch.from_numpy(rng.standard_normal((b, width)).astype(np.float32))
    t = p + noise * torch.from_numpy(rng.standard_normal((b, width)).astype(np.float32))
    fact = 1.0 if b < 2 else 1.0 / (b - 1)
    a = ((p - p.mean(0)) @ (t - t.mean(0)).T) * fact
    return a @ a.T


def _repeated(n=16, seed=0):
    q, _ = torch.linalg.qr(torch.from_numpy(
        np.random.default_rng(seed).standard_normal((n, n)).astype(np.float32)))
    d = torch.tensor([1.0] * 6 + [2.0] * 6 + [0.0] * (n - 12))
    return (q * d) @ q.T


@pytest.mark.parametrize("name,m", [
    *[(f"fvd_b{b}", _fvd_matrix(b, b)) for b in (1, 2, 3, 4, 10, 32)],
    ("independent_b4", _fvd_matrix(4, 5, noise=3.0)),
    ("repeated_16", _repeated()),
    ("zero_5", torch.zeros(5, 5)),
], ids=lambda x: x if isinstance(x, str) else "")
def test_e1_transcription_matches_eigh(name, m):
    w, v, sweeps = jacobi_transcription(m)
    want = torch.linalg.eigh(m)[0]
    _assert_decomposition(w, v, m, want)
    assert sweeps <= MAX_SWEEPS // 2, sweeps
    if not bool(m.any()):
        assert sweeps == 0 and torch.equal(w, torch.zeros(len(w)))
