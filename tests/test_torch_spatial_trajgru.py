r"""EF-TrajGRU on image slabs (``sp`` > 1) against the JAX package's one-device
results, on the CPU.

Two spawned gloo worlds of ``helpers/torch_model_parallel_worker.py`` (torch
and the port only; started at the fixture so that they run while JAX
compiles): ``sp_trajgru``, two processes on ``{"sp": 2}``, for all of the
below, and ``data_sp_trajgru``, four on ``{"data": 2, "sp": 2}``, for the
model's calls with ``remat`` on:

- ``warp_flow_ret`` of each process's slab (the hidden state gathered whole,
  the slab's flows, ``row0``) against the same call on the whole image in
  this process, on flows that send every tap of each slab into the other
  slab's rows: the outputs, the image's and the flows' gradients joined, and
  ``ret``'s weight and bias gradients summed over the processes, to 1e-5 of
  the largest of each in f32 (2^-7 in bf16);
- the small EF-TrajGRU of ``tests/test_torch_traj_gru.py`` (16x16, two layers,
  L = 3), with ``remat`` on and off, its weights carried into JAX by the JAX
  package's importer: ``make_predict_fn`` (whole frames on each process, of
  its data coordinate's batch rows) and ``make_eval_step`` to 1e-4, one f32 SGD step built inside
  ``spatial_halo_convs`` with the loss to 1e-5 relative and ``(p0 - p1) / lr``
  to 5e-4, against JAX at ``default_matmul_precision("highest")``;
- the spatial collectives each ran (``parallel.spatial.record``): one row
  gather of the hidden state per cell step, and in the step's backward one
  all-reduce per cell step whose state carries a gradient (all but each
  encoder layer's first, which starts from zeros);
- the refusals: a TrajGRU state height that ``sp`` does not divide, and a
  model whose ops are not row-local (SimVP).

The pure part: a slab's fractional indices are the whole image's rows, bit for
bit, in the JAX package's f32 operation order on the global view.
"""
import functools
import importlib
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
from vp_suite_tpu.training import loop as jax_loop
from vp_suite_tpu.training.train_state import TrainState as JaxTrainState
from vp_suite_tpu.utils.torch_import import import_state_dict
from vp_suite_tpu_torch.ops.grid_sample import _flow_to_indices, warp_flow_ret
from vp_suite_tpu_torch.utils.jax_params import ef_state_dict_from_jax

torch.set_num_threads(1)

jax_grid_sample = importlib.import_module("vp_suite_tpu.ops.grid_sample")
ROOT = Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "helpers" / "torch_model_parallel_worker.py"
_spec = importlib.util.spec_from_file_location("torch_model_parallel_worker", WORKER)
W = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(W)
WORLD_TIMEOUT = 120
WORLDS = {"sp_trajgru": 2, "data_sp_trajgru": 4}
#: (world, remat) of the model's calls: both settings on {"sp": 2}, remat on
#: {"data": 2, "sp": 2}
CASES = [("sp_trajgru", True), ("sp_trajgru", False), ("data_sp_trajgru", True)]
CASE_IDS = ["sp-remat", "sp-no_remat", "data_sp-remat"]
#: the warp case against the whole image, relative to the largest of each result:
#: f32 to 1e-5; bf16 to 2^-7, as a sum over the slabs (``ret``'s gradients; the image's
#: where both slabs' taps meet, summed in f32) rounds each process's part and then the
#: sum, where the whole image rounds once
WARP_TOL = {"float32": 1e-5, "bfloat16": 2 ** -7}
#: the JAX model's own knob: no rematerialisation (the same function; it compiles faster)
JAX_ONLY = dict(remat=False)
#: cell steps of a step: two layers over the context and predicted frames
CELL_STEPS = W.TRAJGRU["num_layers"] * (W.RUN["context_frames"] + W.RUN["pred_frames"])


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
def calls(worlds):
    r"""``{task: each process's results}`` of both worlds."""
    return {task: _results(worlds, task) for task in WORLDS}


@pytest.fixture(scope="module")
def ranks(calls):
    return calls["sp_trajgru"]


def _close(got, want, what, tol=1e-5):
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=what)


# ---------------------------------------------------------------------------
# the warp on slabs


@functools.lru_cache(maxsize=None)
def _whole_warp(dtype):
    r"""``warp_flow_ret`` in ``dtype`` on the whole image in this process: the
    output and the gradients of ``sum(y * c)``."""
    img, flows, w, bias, cot = (torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_(True)
                                for a in W.warp_case())
    y = warp_flow_ret(img, flows, w, bias)
    (y * cot.detach()).sum().backward()
    return {"y": y.detach(), "d_img": img.grad, "d_flows": flows.grad, "d_w": w.grad,
            "d_bias": bias.grad}


@pytest.mark.parametrize("dtype", W.WARP_DTYPES)
@pytest.mark.parametrize("what", ["y", "d_img", "d_flows", "d_w", "d_bias"])
def test_warp_flow_ret_on_slabs_matches_the_whole_image(ranks, what, dtype):
    r"""Rows (the output, the image's and the flows' gradients) join over the
    slabs; ``ret``'s gradients sum over them."""
    got = [r["warp"][dtype][what] for r in ranks]
    joined = sum(got) if what in ("d_w", "d_bias") else torch.cat(got, 1)
    _close(joined.float().numpy(), _whole_warp(dtype)[what].float().numpy(), what,
           WARP_TOL[dtype])


def test_warp_case_reads_the_other_slab():
    r"""The case's taps that fall in the image all lie in the other slab's
    rows, so a warp that sampled its own slab, or placed a slab's rows at the
    image's top, would be caught."""
    img, flows = (torch.from_numpy(a) for a in W.warp_case()[:2])
    h, hl = img.shape[1], img.shape[1] // 2
    iy = _flow_to_indices(img, flows)[0].view(img.shape[0], h, -1)
    for r in range(2):
        y0 = torch.floor(iy[:, r * hl:(r + 1) * hl])
        taps = torch.cat([y0, y0 + 1])
        inside = taps[(taps >= 0) & (taps <= h - 1)]
        assert inside.numel() > 0
        assert bool(((inside < r * hl) | (inside >= (r + 1) * hl)).all())


def test_warp_on_slabs_runs_one_gather_and_one_all_reduce(ranks):
    for r in ranks:
        for dtype in W.WARP_DTYPES:
            assert r["warp"][dtype]["kinds"] == {"gather": 1, "all_reduce": 1}


@pytest.mark.parametrize("dtype", W.WARP_DTYPES)
def test_the_image_gradients_sum_runs_in_f32(ranks, dtype):
    r"""The all-reduce of the image's gradient sums in f32 under bf16 too, and
    hands back the image's dtype."""
    for r in ranks:
        assert r["warp"][dtype]["reduce_dtypes"] == [torch.float32]
        assert r["warp"][dtype]["d_img"].dtype == getattr(torch, dtype)


@pytest.mark.parametrize("row0", [0, 5, 8])
def test_slab_indices_are_the_whole_images_bit_for_bit(row0):
    r"""``_flow_to_indices`` of rows ``row0 ..`` of the flows into the whole
    image equals those rows of JAX's indices on the global view, bit for bit
    (the ``r0`` and ``H`` of ``(r0 + yy + f) * (H / (H-1)) - 0.5``)."""
    img, flows = W.warp_case()[:2]
    w, hl = img.shape[2], 8
    want_y, want_x = (np.asarray(a) for a in jax_grid_sample._flow_to_indices(
        jnp.asarray(img), jnp.asarray(flows)))
    got_y, got_x = _flow_to_indices(torch.from_numpy(img),
                                    torch.from_numpy(flows[:, row0:row0 + hl]), row0)
    L = flows.shape[-1] // 2
    rows = slice(row0 * w, (row0 + hl) * w)
    for got, want in ((got_y, want_y), (got_x, want_x)):
        np.testing.assert_array_equal(got.numpy(), want[:, :, rows].transpose(0, 2, 1))
        assert got.shape == (img.shape[0], hl * w, L)


# ---------------------------------------------------------------------------
# EF-TrajGRU on slabs


@functools.lru_cache(maxsize=None)
def _jax_params():
    sd = {k: v.numpy().copy() for k, v in W.trajgru_model(True).state_dict().items()}
    return import_state_dict("trajgru", sd)["params"]


def _loss_provider():
    return JaxLossProvider({"losses_and_scales": {"mse": 1.0}, "img_c": 3, "device": None})


@functools.lru_cache(maxsize=None)
def _jax_results():
    r"""JAX's one-device ``predict``, eval loss, and parameters (the port's
    layout) and loss after one SGD step, on the world's batch."""
    model = JAX_MODELS["trajgru"](**W.TRAJGRU, **JAX_ONLY)
    params = jax.tree.map(jnp.asarray, _jax_params())
    sgd = optax.sgd(W.LR)
    state = JaxTrainState(params=params, extra_vars={}, opt_state=sgd.init(params),
                          step=jnp.asarray(0, jnp.int32), model_state=model.init_model_state(),
                          rng=jax.random.PRNGKey(0))
    batch = {"frames": jnp.asarray(W.frames(1))}
    step = jax_loop.make_train_step(model, {**W.RUN, "use_actions": False}, sgd,
                                    _loss_provider(), donate=False)
    with jax.default_matmul_precision("highest"):
        preds, targets = jax_loop.make_predict_fn(model, W.RUN)(state, batch)
        losses = jax_loop.make_eval_step(model, W.RUN, _loss_provider())(state, batch)
        after, metrics = step(state, batch, jnp.asarray(0.0))
    return {"preds": np.asarray(preds), "targets": np.asarray(targets),
            "eval": float(losses["total"]), "loss": float(metrics["total"]),
            "before": ef_state_dict_from_jax(jax.device_get(params)),
            "after": ef_state_dict_from_jax(jax.device_get(after.params))}


def _batch_rows(task, rank):
    r"""The batch rows that process ``rank`` of ``task``'s world predicts: all
    on ``{"sp": 2}``, its data coordinate's (``rank // 2``) half on
    ``{"data": 2, "sp": 2}``."""
    if task == "sp_trajgru":
        return slice(None)
    half = W.B // 2
    return slice(rank // 2 * half, (rank // 2 + 1) * half)


@pytest.mark.parametrize("task,remat", CASES, ids=CASE_IDS)
def test_predict_and_eval_on_slabs_match_jax(calls, task, remat):
    r"""Each process predicts from its image rows and gets whole frames back
    (its data coordinate's batch rows), the same as the other process of its
    ``sp`` pair; the eval loss is the whole batch's."""
    want = _jax_results()
    ranks = calls[task]
    for r, result in enumerate(ranks):
        got, rows = result[remat], _batch_rows(task, r)
        _close(got["preds"].numpy(), want["preds"][rows], "preds", 1e-4)
        assert torch.equal(got["targets"], torch.from_numpy(want["targets"][rows].copy()))
        np.testing.assert_allclose(got["eval"], want["eval"], rtol=1e-4)
        assert torch.equal(got["preds"], ranks[r ^ 1][remat]["preds"])


@pytest.mark.parametrize("task,remat", CASES, ids=CASE_IDS)
def test_sgd_step_on_slabs_matches_jax(calls, task, remat):
    r"""One f32 SGD step of the slab processes, built inside
    ``spatial_halo_convs``: the same loss and parameters on every process,
    JAX's loss and ``(p0 - p1) / lr``."""
    want = _jax_results()
    ranks = calls[task]
    got = ranks[0][remat]
    for other in ranks[1:]:
        assert other[remat]["loss"] == got["loss"]
        for k, v in got["state_dict"].items():
            assert torch.equal(v, other[remat]["state_dict"][k]), k
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    before, after = want["before"], want["after"]
    assert set(got["state_dict"]) == set(after)
    for k, v in got["state_dict"].items():
        np.testing.assert_allclose(((before[k] - v) / W.LR).numpy(),
                                   ((before[k] - after[k]) / W.LR).numpy(),
                                   rtol=5e-4, atol=5e-4, err_msg=k)


@pytest.mark.parametrize("task,remat", CASES, ids=CASE_IDS)
def test_spatial_collectives_per_cell_step(calls, task, remat):
    r"""One row gather per cell step (``predict`` also gathers its predictions
    and targets); the step's backward one all-reduce per cell step whose
    state carries a gradient. ``remat`` keeps the gathered state, so its
    recompute gathers nothing again (it runs its halo exchanges again)."""
    layers = W.TRAJGRU["num_layers"]
    for r in calls[task]:
        got = r[remat]
        assert got["predict_kinds"]["gather"] == CELL_STEPS + 2
        assert got["eval_kinds"]["gather"] == CELL_STEPS
        assert "all_reduce" not in got["predict_kinds"] and "all_reduce" not in got["eval_kinds"]
        assert got["step_kinds"]["gather"] == CELL_STEPS
        assert got["step_kinds"]["all_reduce"] == CELL_STEPS - layers
        assert got["step_kinds"]["halo"] > 0


@pytest.mark.parametrize("what,text", [
    ("height", "state height 5 is not divisible by sp=2"),
    ("simvp", "model 'simvp' cannot run on a mesh with sp=2")])
def test_refusals_on_slabs(ranks, what, text):
    message = ranks[0]["refused"][what]
    assert message is not None and message.startswith("ValueError") and text in message, message
