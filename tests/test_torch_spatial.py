r"""Spatial (image-row) parallelism of the port (``parallel/spatial.py``, the
``sp`` axis of ``parallel/mesh.py``, EF-ConvLSTM's cells on slabs) against the
JAX package's, on the CPU.

Two spawned gloo worlds of ``helpers/torch_model_parallel_worker.py`` (torch
and the port only; 120 s each, started at the fixture so that they run while
JAX compiles):

- ``sp``, two processes on ``{"sp": 2}``: ``halo_conv2d`` and
  ``halo_conv_transpose2d`` on each process's slab, at every geometry of the
  JAX package's ``tests/test_spatial.py``, against JAX's ``halo_conv2d`` /
  ``halo_conv_transpose2d`` on ``make_mesh_nd({"sp": 2})`` of the conftest's
  virtual CPU devices: the slabs' outputs joined, the input's gradient joined
  and the weight's and bias's summed over the processes, to 1e-5 of the
  largest of each; the geometry and slab refusals; EF-ConvLSTM's
  ``make_predict_fn`` (whole frames on both processes) and ``make_eval_step``
  on the mesh, per step and fused, against JAX's forward (1e-5).
- ``data_sp``, four processes on ``{"data": 2, "sp": 2}``: each process's
  rows and image rows of a batch; one SGD step of EF-ConvLSTM per path, built
  inside ``spatial_halo_convs``, against JAX's step inside its
  ``spatial_halo_convs`` on the same mesh shape and against JAX's one-device
  step, at ``default_matmul_precision("highest")``, on the port's weights
  carried into JAX: the loss to 1e-5 relative, the parameters to 1e-5
  absolute (the slabs' MSE parts summed over ``sp``, averaged over
  ``data``); ``check_train_mesh``'s "inference-only" refusal outside the
  context, and the refusals of a model whose ops are not row-local and of a
  loss that does not sum over pixels.

The pure parts: the context is a no-op without a mesh or at ``sp`` = 1, and
the functional convs refuse what is not row-local inside it.
"""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vp_suite_tpu.measure.loss_provider import PredictionLossProvider as JaxLossProvider
from vp_suite_tpu.models import MODEL_CLASSES as JAX_MODELS
from vp_suite_tpu.parallel import mesh as jax_mesh
from vp_suite_tpu.parallel import spatial as jax_spatial
from vp_suite_tpu.training import loop as jax_loop
from vp_suite_tpu.training.train_state import TrainState as JaxTrainState
from vp_suite_tpu.utils import torch_import
from vp_suite_tpu_torch.nn import functional as PF
from vp_suite_tpu_torch.parallel import active_spatial, spatial_halo_convs
from vp_suite_tpu_torch.utils import jax_params as J

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "helpers" / "torch_model_parallel_worker.py"
_spec = importlib.util.spec_from_file_location("torch_model_parallel_worker", WORKER)
W = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(W)
WORLD_TIMEOUT = 120
WORLDS = {"sp": 2, "data_sp": 4}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    started = {task: W.P.World(task, tmp_path_factory.mktemp(task), size=size,
                               timeout=WORLD_TIMEOUT, script=WORKER)
               for task, size in WORLDS.items()}
    yield started
    for world in started.values():
        world.stop()


def _results(worlds, task):
    world = worlds[task]
    world.wait()
    return [torch.load(world.out_dir / f"{task}_{r}.pt", weights_only=False)
            for r in range(WORLDS[task])]


@pytest.fixture(scope="module")
def sp(worlds):
    return _results(worlds, "sp")


@pytest.fixture(scope="module")
def data_sp(worlds):
    return _results(worlds, "data_sp")


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()),
                               err_msg=what)


# ---------------------------------------------------------------------------
# the halo convolutions


@functools.lru_cache(maxsize=None)
def _jax_halo(transposed, geom):
    r"""JAX's halo conv on ``{"sp": 2}``: ``(y, dx, dk, db)`` of ``sum(y * c)``,
    the kernel's gradient in the port's layout."""
    x, w, b = W.halo_case(transposed, geom)
    k = w.transpose(2, 3, 0, 1) if transposed else w.transpose(2, 3, 1, 0)
    mesh = jax_mesh.make_mesh_nd({"sp": 2})

    def fn(x, k, b):
        if transposed:
            return jax_spatial.halo_conv_transpose2d(x, k, b, geom[1], geom[2], geom[3], mesh,
                                                     "sp")
        return jax_spatial.halo_conv2d(x, k, b, geom[1], geom[2], mesh, "sp")

    with jax.default_matmul_precision("highest"):
        y = fn(x, k, b)
        c = W.rand(13, y.shape)
        dx, dk, db = jax.grad(lambda *a: jnp.sum(fn(*a) * c), argnums=(0, 1, 2))(x, k, b)
    dk = np.asarray(dk).transpose(2, 3, 0, 1) if transposed else \
        np.asarray(dk).transpose(3, 2, 0, 1)
    return np.asarray(y), np.asarray(dx), dk, np.asarray(db)


@pytest.mark.parametrize("transposed,geom", [(False, g) for g in W.CONV_GEOMS]
                         + [(True, g) for g in W.CONVT_GEOMS])
def test_halo_conv_matches_jax(sp, transposed, geom):
    r"""The slabs' outputs and input gradients joined, the weight's and bias's
    gradients summed over the two processes, equal JAX's halo conv on the
    whole image."""
    y, dx, dk, db = _jax_halo(transposed, geom)
    got = [r["halo"][(transposed, geom)] for r in sp]
    _close(torch.cat([g["y"] for g in got], 1).numpy(), y, "y")
    _close(torch.cat([g["dx"] for g in got], 1).numpy(), dx, "dx")
    _close(sum(g["dw"] for g in got).numpy(), dk, "dw")
    _close(sum(g["db"] for g in got).numpy(), db, "db")


@pytest.mark.parametrize("what,kind,text", [
    ("conv_geometry", "NotImplementedError", "kh - 2*ph in [1, stride]"),
    ("convT_geometry", "NotImplementedError", "output_padding = stride + 2*pad - kh"),
    ("too_fine", "ValueError", "too fine"),
    ("stride", "ValueError", "divisible by stride")])
def test_halo_refusals(sp, what, kind, text):
    r"""JAX's refusals: unsupported geometry, a slab under 2 rows, rows that do
    not divide by the stride."""
    message = sp[0]["refused"][what]
    assert message is not None and message.startswith(kind) and text in message, message


# ---------------------------------------------------------------------------
# EF-ConvLSTM on slabs


@functools.lru_cache(maxsize=None)
def _jax_params():
    sd = {k: v.numpy().copy() for k, v in W.ef_model("per_step").state_dict().items()}
    return torch_import._IMPORTERS["convlstm-shi"](sd)["params"]


def _jax_model():
    return JAX_MODELS["convlstm-shi"](**W.EF)


def _loss_provider():
    return JaxLossProvider({"losses_and_scales": {"mse": 1.0}, "img_c": 3, "device": None})


def _jax_state(optimizer):
    params = jax.tree.map(jnp.asarray, _jax_params())
    return JaxTrainState(params=params, extra_vars={}, opt_state=optimizer.init(params),
                         step=jnp.asarray(0, jnp.int32),
                         model_state=_jax_model().init_model_state(), rng=jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _jax_forward():
    r"""JAX's ``predict`` and eval loss on the ``sp`` world's batch, one device."""
    model, state = _jax_model(), _jax_state(optax.sgd(W.LR))
    batch = {"frames": jnp.asarray(W.frames(1))}
    with jax.default_matmul_precision("highest"):
        preds, targets = jax_loop.make_predict_fn(model, W.RUN)(state, batch)
        losses = jax_loop.make_eval_step(model, W.RUN, _loss_provider())(state, batch)
    return np.asarray(preds), np.asarray(targets), float(losses["total"])


@pytest.mark.parametrize("path", list(W.PATHS))
def test_predict_and_eval_on_slabs_match_jax(sp, path):
    r"""Each process predicts from its image rows, and gets whole frames back."""
    preds, targets, loss = _jax_forward()
    for r in range(2):
        got = sp[r][path]
        _close(got["preds"].numpy(), preds, "preds")
        assert torch.equal(got["targets"], torch.from_numpy(targets.copy()))
        np.testing.assert_allclose(got["eval"], loss, rtol=1e-5)
    assert torch.equal(sp[0][path]["preds"], sp[1][path]["preds"])


@functools.lru_cache(maxsize=None)
def _jax_step(kind):
    r"""``(JAX parameters after one SGD step, loss)``: ``kind`` ``"one"`` on one
    device, ``"sp"`` inside ``spatial_halo_convs`` on ``{"data": 2, "sp": 2}``."""
    optimizer = optax.sgd(W.LR)
    step = jax_loop.make_train_step(_jax_model(), {**W.RUN, "use_actions": False}, optimizer,
                                    _loss_provider(), donate=False)
    state, frames = _jax_state(optimizer), W.frames(0)
    with jax.default_matmul_precision("highest"):
        if kind == "one":
            after, metrics = step(state, {"frames": jnp.asarray(frames)}, jnp.asarray(0.0))
        else:
            mesh = jax_mesh.make_mesh_nd({"data": 2, "sp": 2})
            state = state.replace(params=jax_mesh.shard_params(state.params, mesh),
                                  opt_state=jax_mesh.shard_params(state.opt_state, mesh))
            batch = {"frames": jax.device_put(frames, jax_mesh.video_batch_sharding(mesh))}
            with jax_spatial.spatial_halo_convs(mesh):
                jax_mesh.check_train_mesh(mesh)
                after, metrics = step(state, batch, jnp.asarray(0.0))
    return J.ef_state_dict_from_jax(jax.device_get(after.params)), float(metrics["total"])


@pytest.mark.parametrize("reference", ["jax_data_sp", "jax_one_device"])
@pytest.mark.parametrize("path", list(W.PATHS))
def test_data_sp_step_matches_jax(data_sp, path, reference):
    r"""Four processes, each on its half of the batch's rows and half of the
    image's rows, take JAX's step: the same loss and parameters on every
    process."""
    got = data_sp[0][path]
    for other in data_sp[1:]:
        assert other[path]["loss"] == got["loss"]
        for k, v in got["state_dict"].items():
            assert torch.equal(v, other[path]["state_dict"][k]), k
    want, loss = _jax_step("sp" if reference == "jax_data_sp" else "one")
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
    assert set(got["state_dict"]) == set(want)
    for k, v in got["state_dict"].items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=1e-5,
                                   err_msg=f"{path}: {k}")
    assert got["exchanges"] > 0


def test_data_sp_rows(data_sp):
    r"""Process ``r`` holds the batch rows of its data coordinate ``r // 2`` and
    the image rows of its sp coordinate ``r % 2``; the other keys only the
    batch rows (JAX's ``video_batch_sharding`` and ``P("data")``)."""
    frames = torch.from_numpy(W.frames(0))
    for r, got in enumerate(data_sp):
        d, s = divmod(r, 2)
        assert torch.equal(got["frames"], frames[2 * d:2 * d + 2, :, 8 * s:8 * s + 8])
        assert got["actions"][:, 0].tolist() == [2 * d, 2 * d + 1]


@pytest.mark.parametrize("what,text", [
    ("check_train_mesh", "inference-only"), ("make_train_step", "inference-only"),
    ("other_model_train", "'min-conv-rnn'"), ("other_model_predict", "'min-conv-rnn'"),
    ("loss", "['ssim'] do not add up"), ("height", "not divisible by sp=2"),
    ("fsdp", "FSDP's reduce-scatter")])
def test_data_sp_refusals(data_sp, what, text):
    r"""Training on ``sp`` > 1 outside ``spatial_halo_convs`` is JAX's
    inference-only refusal; a model whose ops are not row-local is named, and
    so is a loss that does not sum over pixels (the slabs' losses are summed
    over sp); a height that does not divide is refused, and FSDP, whose
    reduce-scatter would average the slabs' gradients."""
    message = data_sp[0]["refused"][what]
    assert message is not None and text in message, message
    if what == "check_train_mesh":
        assert "sp=2" in message
    assert not jax_spatial.active_spatial()


# ---------------------------------------------------------------------------
# the pure parts


def test_context_is_a_no_op_without_a_spatial_axis():
    with spatial_halo_convs(None):
        assert active_spatial() is None
    assert active_spatial() is None


@pytest.mark.parametrize("op", ["conv3d", "group_norm", "layer_norm_chw", "replicate"])
def test_not_row_local_ops_refuse_inside_the_context(monkeypatch, op):
    r"""A slab never takes an op that is not row-local: inside a spatial
    context those raise (a stand-in for a mesh: the refusal needs no group)."""
    from vp_suite_tpu_torch.parallel import spatial
    monkeypatch.setattr(spatial, "_ACTIVE", ("mesh", "sp"))
    x4, x5 = torch.zeros(1, 4, 4, 4), torch.zeros(1, 2, 4, 4, 4)
    call = {"conv3d": lambda: PF.conv3d(x5, torch.zeros(4, 4, 1, 1, 1)),
            "group_norm": lambda: PF.group_norm(x4, torch.ones(4), torch.zeros(4), 2),
            "layer_norm_chw": lambda: PF.layer_norm_chw(x4, torch.ones(4, 4, 4),
                                                       torch.zeros(4, 4, 4)),
            "replicate": lambda: PF.conv2d(x4, torch.zeros(4, 4, 3, 3), None, 1, 1,
                                           "replicate")}[op]
    with pytest.raises(NotImplementedError, match="not row-local"):
        call()
