r"""The port's N-D mesh and tensor parallelism against the JAX package's, on
the CPU.

- The pure parts: ``factorize_mesh`` gives JAX's sizes for every count and
  strategy; ``make_mesh_nd`` without a group; ``utils.jax_params.leaf_axes``,
  the port dimension of each JAX leaf dimension on which ``shard_params_tp``
  and ``shard_params_tp_fsdp`` place their shards, against the converters
  (the JAX package's ``utils/torch_import`` one way, the port's
  ``*_state_dict_from_jax`` back) for every registry model with parameters.
- Two spawned gloo worlds of ``helpers/torch_tp_worker.py`` (torch and the
  port only; 120 s each, started at the fixture so that they run while JAX
  compiles):

  - ``tp``, two processes on ``{"tp": 2}``: EF-ConvLSTM's tp-sharded leaves
    and each local shape equal JAX's ``shard_params_tp`` on
    ``make_mesh_nd(factorize_mesh(4, "tp"))`` of the conftest's virtual CPU
    devices (42 of 44 leaves at 16x16), each process holds exactly its slice;
    ``make_predict_fn`` and ``make_eval_step`` on the per-step and the fused
    path equal JAX's forward (1e-5); every conv computes ``out / tp``
    channels before its gather; the ``msgpack`` and ``orbax`` checkpoints of a
    tp-sharded model load in this process without a group and predict what
    the processes' gathered parameters predict (1e-6); and every other
    registry model's tp=2 SGD step equals its one-process step (1e-5).
  - ``data_tp``, four processes on ``{"data": 2, "sp": 1, "tp": 2}``: one
    step of EF-ConvLSTM, per-step and fused, with SGD and Adam, and under
    ``shard_params_tp_fsdp`` (``min_size=1024``), on each process's rows of a
    global batch of 4, held against JAX's step on the same mesh shape and
    against JAX's one-device step, at ``default_matmul_precision("highest")``,
    on the port's weights carried into JAX: losses to 1e-5 relative,
    parameters to 1e-5 absolute; Adam with ``test_torch_parallel``'s
    first-moment and sign-aware checks; the 2-D leaves and every leaf's
    per-process element count against JAX's; and the refusals (``sp`` x
    ``tp`` "miscompiles", ``check_train_mesh`` and ``shard_video_batch`` at
    ``sp`` > 1 outside a spatial context, a height that does not divide by
    ``sp``, a mesh that is not the group's size); and the ``msgpack`` and
    ``orbax`` checkpoints of a ``shard_params_tp_fsdp`` model, loaded as the
    tp world's are.
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
from vp_suite_tpu.training import loop as jax_loop
from vp_suite_tpu.training.train_state import TrainState as JaxTrainState
from vp_suite_tpu.utils import torch_import
from vp_suite_tpu_torch.checkpoint import load_checkpoint
from vp_suite_tpu_torch.models import build_model
from vp_suite_tpu_torch.parallel import factorize_mesh, make_mesh_nd
from vp_suite_tpu_torch.training.loop import make_predict_fn
from vp_suite_tpu_torch.utils import jax_params as J

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "helpers" / "torch_tp_worker.py"
_spec = importlib.util.spec_from_file_location("torch_tp_worker", WORKER)
W = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(W)
WORLD_TIMEOUT = 120
WORLDS = {"tp": 2, "data_tp": 4}
EF_LEAVES, EF_WHOLE = 44, {"forecaster.stage1.conv3_3.weight", "forecaster.stage1.conv3_3.bias"}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    r"""Both worlds, started together; they run while the JAX steps compile."""
    started = {task: W.P.World(task, tmp_path_factory.mktemp(task), size=size,
                               timeout=WORLD_TIMEOUT, script=WORKER)
               for task, size in WORLDS.items()}
    yield started
    for world in started.values():
        world.stop()


def _results(worlds, task):
    world = worlds[task]
    world.wait()
    return world.out_dir, [torch.load(world.out_dir / f"{task}_{r}.pt", weights_only=False)
                           for r in range(WORLDS[task])]


@pytest.fixture(scope="module")
def tp_world(worlds):
    return _results(worlds, "tp")


@pytest.fixture(scope="module")
def data_tp(worlds):
    return _results(worlds, "data_tp")[1]


# ---------------------------------------------------------------------------
# the pure parts


def test_factorize_mesh_matches_jax():
    assert factorize_mesh(8) == {"data": 4, "sp": 1, "tp": 2}
    assert factorize_mesh(8, "sp") == {"data": 4, "sp": 2, "tp": 1}
    assert factorize_mesh(2, "sp") == {"data": 1, "sp": 2, "tp": 1}
    assert factorize_mesh(1) == {"data": 1, "sp": 1, "tp": 1}
    assert factorize_mesh(7) == {"data": 7, "sp": 1, "tp": 1}
    for n in range(1, 17):
        for strategy in ("sp", "tp"):
            assert factorize_mesh(n, strategy) == jax_mesh.factorize_mesh(n, strategy)
    with pytest.raises(ValueError, match="neither"):
        factorize_mesh(4, "pp")


def test_make_mesh_nd_without_a_group():
    r"""One process runs one device: a mesh of ones is None, a larger one
    needs its processes."""
    assert make_mesh_nd({"data": 1, "sp": 1, "tp": 1}, "cpu") is None
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        make_mesh_nd(factorize_mesh(4, "tp"), "cpu")
    assert not torch.distributed.is_initialized()


def _to_jax(model_id, sd, model):
    r"""The JAX package's tree for a port ``state_dict`` and the port's
    converter back."""
    arrays = {k: v.numpy().copy() for k, v in sd.items()}
    if model_id in ("convlstm-shi", "trajgru"):
        return torch_import._IMPORTERS[model_id](arrays)["params"], J.ef_state_dict_from_jax
    if model_id == "unet-3d":
        return torch_import._import_unet3d(arrays), J.unet3d_state_dict_from_jax
    if model_id == "predrnn-pp":
        return torch_import._import_predrnn(arrays)["params"], J.predrnn_state_dict_from_jax
    if model_id == "phy":
        return torch_import._import_phydnet(arrays)["params"], J.phydnet_state_dict_from_jax
    if model_id == "pred-former":
        return J.pred_former_params_to_jax(sd, model.heads), J.pred_former_state_dict_from_jax
    name = model_id.replace("-", "_")
    return (getattr(J, f"{name}_params_to_jax")(sd), getattr(J, f"{name}_state_dict_from_jax"))


def _index_tree(tree, j):
    r"""Each leaf's index along its dimension ``j`` (0 where it has none)."""
    if isinstance(tree, dict):
        return {k: _index_tree(v, j) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.ndim <= j:
        return np.zeros(a.shape, np.float32)
    shape = [-1 if i == j else 1 for i in range(a.ndim)]
    return np.broadcast_to(np.arange(a.shape[j], dtype=np.float32).reshape(shape), a.shape)


def _along(shape, d):
    v = torch.arange(shape[d], dtype=torch.float32).reshape([-1 if i == d else 1
                                                            for i in range(len(shape))])
    return v.expand(shape)


@pytest.mark.parametrize("model_id", [m for m in W.OTHERS] + ["convlstm-shi"])
def test_leaf_axes_follow_the_converters(model_id):
    r"""Each JAX leaf dimension's index, carried into the port by the
    converters, runs along the port dimension that ``leaf_axes`` names for it;
    where ``leaf_axes`` names none (PredFormer's attention kernels and its
    query, key and value biases), the JAX leaf has more dimensions than the
    port's tensor."""
    cfg = {} if model_id == "convlstm-shi" else W.OTHERS[model_id][0]
    model = build_model(model_id, 0, "cpu", **{**W.EF, **cfg})
    axes = J.leaf_axes(model)
    params = dict(model.named_parameters())
    assert set(axes) == set(params)
    tree, back = _to_jax(model_id, model.state_dict(), model)
    for j in range(5):
        got = back(_index_tree(tree, j))
        for name, ax in axes.items():
            p = params[name]
            if ax is None:   # the JAX leaf has a dimension more than the port's tensor
                if j == p.dim():
                    assert got[name].abs().sum() > 0, name
            elif j < len(ax):
                assert torch.equal(got[name], _along(p.shape, ax[j])), (name, j, ax)
    assert any(ax is None for ax in axes.values()) == (model_id == "pred-former")


# ---------------------------------------------------------------------------
# JAX's side on the conftest's virtual devices


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


def _tp_mesh():
    return jax_mesh.make_mesh_nd(jax_mesh.factorize_mesh(4, "tp"))


@functools.lru_cache(maxsize=None)
def _jax_step(opt, kind):
    r"""``(JAX state after, loss)`` of one step on the global batch: ``kind``
    ``"one"`` on one device, ``"tp"`` under ``shard_params_tp`` and
    ``"tp_fsdp"`` under ``shard_params_tp_fsdp`` on the data x tp mesh."""
    optimizer = optax.sgd(W.LR) if opt == "sgd" else optax.adam(W.LR)
    step = jax_loop.make_train_step(_jax_model(), {**W.RUN, "use_actions": False}, optimizer,
                                    _loss_provider(), donate=False)
    state, frames = _jax_state(optimizer), W.frames(0)
    if kind == "one":
        batch = {"frames": jnp.asarray(frames)}
    else:
        mesh = _tp_mesh()
        place = functools.partial(jax_mesh.shard_params_tp, mesh=mesh) if kind == "tp" else \
            functools.partial(jax_mesh.shard_params_tp_fsdp, mesh=mesh,
                              min_size=W.TP_FSDP_MIN_SIZE)
        state = state.replace(params=place(state.params), opt_state=place(state.opt_state))
        batch = {"frames": jax.device_put(frames, jax_mesh.video_batch_sharding(mesh))}
    with jax.default_matmul_precision("highest"):
        after, metrics = step(state, batch, jnp.asarray(0.0))
    return after, float(metrics["total"])


# ---------------------------------------------------------------------------
# placement


def _first_shapes(tree):
    r"""Port names -> shapes of device 0's shard of each leaf."""
    first = jax.tree.map(lambda a: np.asarray(a.addressable_shards[0].data), tree)
    return {k: tuple(v.shape) for k, v in J.ef_state_dict_from_jax(first).items()}


def test_tp_placement_matches_jax(tp_world):
    _, ranks = tp_world
    want = _first_shapes(jax_mesh.shard_params_tp(_jax_params(), _tp_mesh()))
    full = {k: tuple(v.shape) for k, v in J.ef_state_dict_from_jax(_jax_params()).items()}
    assert len(want) == EF_LEAVES
    assert {k for k in want if want[k] == full[k]} == EF_WHOLE
    for r in range(2):
        assert ranks[r]["local_shapes"] == want
        assert ranks[r]["shards_exact"], f"process {r} holds another slice than its own"


def test_tp_fsdp_placement_matches_jax(data_tp):
    r"""The 2-D leaves (split over both axes) and every leaf's per-process
    element count, process 0 against device 0."""
    sharded = jax_mesh.shard_params_tp_fsdp(_jax_params(), _tp_mesh(), min_size=W.TP_FSDP_MIN_SIZE)
    want = _first_shapes(sharded)
    full = {k: tuple(v.shape) for k, v in J.ef_state_dict_from_jax(_jax_params()).items()}
    for name in ("per_step_2d", "fused_2d"):
        counts = data_tp[0][name]["counts"]
        assert set(counts) == set(want)
        two_d = {k for k in want if sum(a != b for a, b in zip(want[k], full[k])) == 2}
        assert two_d and two_d == {k for k, (_, both) in counts.items() if both}
        for k, (numel, _) in counts.items():
            assert numel == int(np.prod(want[k])), k


# ---------------------------------------------------------------------------
# the data x tp steps against JAX's


def _ranks_agree(data_tp, name):
    a = data_tp[0][name]
    for other in data_tp[1:]:
        assert other[name]["loss"] == a["loss"]
        for k, v in a["state_dict"].items():
            assert torch.equal(v, other[name]["state_dict"][k]), f"{name}: {k}"
    return a


def _same_step(name, got, want_sd, want_loss):
    np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-5)
    assert set(got["state_dict"]) == set(want_sd)
    for k, v in got["state_dict"].items():
        np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), rtol=0, atol=1e-5,
                                   err_msg=f"{name}: {k}")


def _adam_step(name, got, after, loss):
    r"""Adam's first moment is 0.1 g; its first update lr g / (|g| + eps) may
    part where the two g differ, within the bound their difference puts on
    it, where both share a sign (``test_torch_parallel``)."""
    want = J.ef_state_dict_from_jax(after.params)
    g = {k: v.numpy() / 0.1 for k, v in J.ef_state_dict_from_jax(after.opt_state[0].mu).items()}
    same_sign = 0
    for k, m in got["moments"].items():
        mine, eps = m.numpy() / 0.1, 1e-8
        np.testing.assert_allclose(mine, g[k], rtol=0, atol=1e-5 * np.abs(g[k]).max(), err_msg=k)
        agree = np.sign(mine) == np.sign(g[k])
        same_sign += agree.sum()
        bound = W.LR * eps * np.abs(mine - g[k]) / ((np.abs(mine) + eps) * (np.abs(g[k]) + eps))
        diff = np.abs(got["state_dict"][k].numpy() - want[k].numpy())
        assert np.all(diff[agree] <= bound[agree] + 1e-6), f"{name}: {k}"
    assert same_sign > 0.999 * sum(m.numel() for m in got["moments"].values())
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)


@pytest.mark.parametrize("reference", ["jax_mesh", "jax_one_device"])
@pytest.mark.parametrize("name", list(W.STEPS))
def test_data_tp_step_matches_jax(data_tp, name, reference):
    got = _ranks_agree(data_tp, name)
    _, opt, two_d = W.STEPS[name]
    kind = "one" if reference == "jax_one_device" else "tp_fsdp" if two_d else "tp"
    after, loss = _jax_step(opt, kind)
    if opt == "adam":
        _adam_step(name, got, after, loss)
    else:
        _same_step(name, got, J.ef_state_dict_from_jax(after.params), loss)


def test_data_rows(data_tp):
    r"""Each process holds the rows of its data coordinate ``r // 2``: the
    two tp processes of one coordinate the same."""
    frames = torch.from_numpy(W.frames(0))[:, 0, 0, 0, 0]
    for r, got in enumerate(data_tp):
        d = r // 2
        assert torch.equal(got["rows"], frames[2 * d:2 * d + 2])


def _conv_out(model):
    r"""``{weight name: out-channels}`` of every conv whose weight is tp-sharded."""
    from vp_suite_tpu_torch.nn.layers import ConvTranspose2d
    out = {}
    for name, module in model.named_modules():
        if isinstance(module, torch.nn.modules.conv._ConvNd):
            key = f"{name}.weight"
            if key not in EF_WHOLE:
                out[key] = module.weight.shape[1 if isinstance(module, ConvTranspose2d) else 0]
    return out


def _split_kinds(kinds, path):
    r"""Every tp-sharded conv computed ``out / 2`` channels before its gather
    (the fused path's deepest forecaster block has no input half: its hidden
    half runs in the scan kernel); what was gathered at use is only the
    peepholes, and on the fused path the scans' hidden weights and the
    decode block's bias."""
    model = W.ef_model(path)
    out = _conv_out(model)
    rnns = [n for n, m in model.named_modules() if n.rsplit(".", 1)[-1].startswith("rnn")]
    want_use = {f"{r}.{p}" for r in rnns for p in ("Wci", "Wcf", "Wco")}
    if path == "fused":
        out.pop("forecaster.rnn3._conv.weight")
        want_use |= {f"{r}._conv.weight" for r in rnns} | {"forecaster.rnn3._conv.bias"}
    assert kinds["column"] == {k: [v // 2] for k, v in out.items()}
    assert set(kinds["use"]) == want_use


@pytest.mark.parametrize("path", list(W.PATHS))
def test_compute_is_split(tp_world, data_tp, path):
    _split_kinds(tp_world[1][0][path]["predict"], path)
    for name, (p, _, _) in W.STEPS.items():
        if p == path:
            for r in range(4):
                _split_kinds(data_tp[r][name]["step"], path)


# ---------------------------------------------------------------------------
# the tp world: predict, eval, checkpoints, the other models


@functools.lru_cache(maxsize=None)
def _jax_forward():
    r"""JAX's ``predict`` and eval loss on the tp world's batch, on one device."""
    model, state = _jax_model(), _jax_state(optax.sgd(W.LR))
    batch = {"frames": jnp.asarray(W.frames(1))}
    with jax.default_matmul_precision("highest"):
        preds, _ = jax_loop.make_predict_fn(model, W.RUN)(state, batch)
        losses = jax_loop.make_eval_step(model, W.RUN, _loss_provider())(state, batch)
    return np.asarray(preds), float(losses["total"])


@pytest.mark.parametrize("path", list(W.PATHS))
def test_predict_and_eval_match_jax(tp_world, path):
    _, ranks = tp_world
    preds, loss = _jax_forward()
    for r in range(2):
        got = ranks[r][path]
        np.testing.assert_allclose(got["preds"].numpy(), preds, rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["eval"], loss, rtol=1e-5)
    assert torch.equal(ranks[0][path]["preds"], ranks[1][path]["preds"])


@pytest.mark.parametrize("path", list(W.PATHS))
def test_eval_over_data_matches_jax(data_tp, path):
    r"""``make_eval_step(..., mesh=)`` on each process's rows gives the global
    batch's losses, on every process."""
    _, loss = _jax_forward()
    for r in range(4):
        np.testing.assert_allclose(data_tp[r]["eval"][path], loss, rtol=1e-5)


@pytest.mark.parametrize("backend", ["msgpack", "orbax"])
def test_checkpoint_loads_without_a_group(tp_world, backend):
    r"""A tp-sharded model's checkpoint loads here without a group and
    predicts what the processes' gathered parameters predict; its moments
    and step are theirs. The sharded one refuses to restore into the
    tp-sharded model itself."""
    out_dir, ranks = tp_world
    _check_loads(out_dir / f"ckpt_{backend}", ranks)
    if backend == "orbax":
        assert "tp-sharded" in ranks[0]["restore_refused"]


@pytest.mark.parametrize("backend", ["msgpack", "orbax"])
def test_2d_checkpoint_loads_without_a_group(worlds, backend):
    r"""The same for a ``shard_params_tp_fsdp`` model of the data x tp world,
    which every one of its four processes saves."""
    out_dir, ranks = _results(worlds, "data_tp")
    _check_loads(out_dir / f"ckpt_{backend}_2d", ranks)


def _check_loads(ckpt_dir, ranks):
    r"""The checkpoint in ``ckpt_dir`` loads here without a group, with the
    processes' gathered parameters, first moments and step, and predicts
    what those parameters predict."""
    saved = ranks[0]["ckpt"]
    for rank in ranks[1:]:
        for k, v in saved["params"].items():
            assert torch.equal(v, rank["ckpt"]["params"][k]), k
    model, state, model_id = load_checkpoint(ckpt_dir, device="cpu")
    assert model_id == "convlstm-shi" and state.step == saved["step"] == 1
    assert not torch.distributed.is_initialized()
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved["params"][k]), k
    for n, p in model.named_parameters():
        assert torch.equal(state.optimizer.state[p]["exp_avg"], saved["moments"][n]), n
    ref = W.ef_model("fused")
    ref.load_state_dict(saved["params"])
    batch = {"frames": torch.from_numpy(W.frames(3))}
    got, _ = make_predict_fn(model, W.RUN)(batch)
    want, _ = make_predict_fn(ref, W.RUN)(batch)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("model_id", list(W.OTHERS))
def test_other_model_tp_step_equals_one_process(tp_world, model_id):
    r"""Gather at use (and column-parallel layers) keep every registry model
    exact under tp: its tp=2 SGD step equals its one-process step."""
    _, ranks = tp_world
    one, tp = ranks[0]["others"][model_id][False], ranks[0]["others"][model_id][True]
    assert tp["sharded"] and not one["sharded"]
    np.testing.assert_allclose(tp["loss"], one["loss"], rtol=1e-5)
    for k, v in tp["state_dict"].items():
        assert torch.equal(v, ranks[1]["others"][model_id][True]["state_dict"][k]), k
        if v.is_floating_point():
            np.testing.assert_allclose(v.numpy(), one["state_dict"][k].numpy(), rtol=0,
                                       atol=1e-5, err_msg=f"{model_id}: {k}")


@pytest.mark.parametrize("what", ["check_train_mesh", "shard_video_batch", "shard_params_tp",
                                  "shard_params_tp_fsdp", "make_mesh_nd"])
def test_refusals(data_tp, what):
    message = data_tp[0]["refused"][what]
    assert message is not None, f"{what} did not refuse"
    want = {"check_train_mesh": "is inference-only", "shard_video_batch": "not divisible by sp=2",
            "shard_params_tp": "miscompiles", "shard_params_tp_fsdp": "miscompiles",
            "make_mesh_nd": "not the group's 4"}[what]
    assert want in message, message
