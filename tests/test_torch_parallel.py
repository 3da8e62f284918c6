r"""The port's data-parallel, multi-process and FSDP training and its sharded
checkpoint against the JAX package's, on the CPU.

- The pure parts, as ``tests/test_parallel.py`` holds JAX's:
  ``ProcessShard``'s strides and floor length, a batch that ``num_devices``
  does not divide, ``local_batch_size``'s error; and ``num_devices`` > 1 in
  one process without a group (one process runs one device).
- Two spawned two-process gloo worlds (``helpers/torch_parallel_worker.py``,
  which imports torch and the port only; each world has 120 s):

  - ``steps``: one train step of each case on each process's half of a
    global batch, held against the JAX step on the whole batch sharded over
    ``make_mesh(2)`` of the conftest's virtual CPU devices, at
    ``default_matmul_precision("highest")``, on the port's weights carried
    into JAX: EF-ConvLSTM with SGD and Adam, under ``shard_params_fsdp``
    (against JAX's, with the large leaves' per-process share) and with
    ``accum_steps=2``; UNet-3D with its BatchNorm statistics over the global
    batch; PredRNN++ with ``scheduled_sampling`` masks that every process
    draws for the global batch (the global masks are injected into the JAX
    step); and ST-Phy, whose dead layers keep ``.grad`` None on both
    processes, against the port's one-process step. Losses to 1e-5
    relative, parameters to 1e-5 absolute, running statistics to 1e-6;
    UNet-3D's parameters, whose f32 gradients of order 100 part the port's
    one-process step from JAX's by up to 2.5e-5, to the one-process step to
    1e-5 and to JAX's as (p0 - p1) / lr within 2e-4 of the largest.
    Adam's first step is lr g / (|g| + eps), about lr * sign(g): its first
    moment, 0.1 g, is compared to 1e-5 of each tensor's largest, and its
    parameters, where both g share a sign (over 99.9% of the elements),
    within the bound that the two g's difference puts on that update, plus
    1e-6.
  - ``facade``: the counterpart of ``test_multihost_two_process_train``:
    ``VPSuite.train(multihost=True)`` with the ``msgpack`` backend, and with
    ``orbax`` and ``fsdp=True``: both processes end with the same
    parameters, steps and learning rate, only rank 0 writes
    ``checkpoint.pt``, and the checkpoint loads in this process, without a
    group, to the same checksum (1e-4).
"""
import functools
import importlib.util
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vp_suite_tpu.measure.loss_provider import PredictionLossProvider as JaxLossProvider
from vp_suite_tpu.models import MODEL_CLASSES as JAX_MODELS
from vp_suite_tpu.parallel.mesh import batch_sharding, make_mesh, shard_params, shard_params_fsdp
from vp_suite_tpu.training import loop as jax_loop
from vp_suite_tpu.training.train_state import TrainState as JaxTrainState
from vp_suite_tpu.utils.torch_import import _import_predrnn, _import_unet3d, import_state_dict
from vp_suite_tpu_torch import VPSuite
from vp_suite_tpu_torch.parallel import distributed
from vp_suite_tpu_torch.parallel.distributed import shard_dataset_for_process
from vp_suite_tpu_torch.training.loop import make_train_step
from vp_suite_tpu_torch.training.train_state import create_train_state
from vp_suite_tpu_torch.utils.jax_params import (ef_state_dict_from_jax,
                                                 predrnn_state_dict_from_jax,
                                                 unet3d_state_dict_from_jax)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "helpers" / "torch_parallel_worker.py"
_spec = importlib.util.spec_from_file_location("torch_parallel_worker", WORKER)
W = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(W)
WORLD_TIMEOUT = 120


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    r"""Both worlds, started together; they run while the JAX steps compile."""
    started = {task: W.World(task, tmp_path_factory.mktemp(task), timeout=WORLD_TIMEOUT)
               for task in ("steps", "facade")}
    yield started
    for world in started.values():
        world.stop()


@pytest.fixture(scope="module")
def steps(worlds):
    world = worlds["steps"]
    world.wait()
    return [torch.load(world.out_dir / f"steps_{r}.pt", weights_only=False) for r in range(2)]


@pytest.fixture(scope="module")
def facade(worlds):
    world = worlds["facade"]
    world.wait()
    return world.out_dir, [json.loads((world.out_dir / f"facade_{r}.json").read_text())
                           for r in range(2)]


# ---------------------------------------------------------------------------
# the pure parts


def test_process_shard():
    class FakeDS:
        def __len__(self):
            return 10

        def __getitem__(self, i):
            return i

    shards = [shard_dataset_for_process(FakeDS(), shard_id=s, num_shards=3) for s in range(3)]
    seen = sorted(x for sh in shards for x in (sh[i] for i in range(len(sh))))
    assert len(set(len(sh) for sh in shards)) == 1
    assert len(seen) == len(set(seen)) == 9
    assert set(seen) <= set(range(10))
    assert [shards[1][i] for i in range(3)] == [1, 4, 7]
    assert shard_dataset_for_process(FakeDS()).num_shards == 1   # no group: one shard


def test_local_batch_size(monkeypatch):
    assert distributed.local_batch_size(6) == 6
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    assert distributed.local_batch_size(6) == 3
    with pytest.raises(ValueError, match="global batch 3 not divisible by 2 processes"):
        distributed.local_batch_size(3)


def _copy_suite():
    suite = VPSuite(device="cpu")
    suite.load_dataset("MMF", img_size=16, digit_source="synthetic", n_seqs=16)
    suite.create_model("copy")
    return suite


def test_batch_not_divisible_raises(tmp_path):
    with pytest.raises(ValueError, match="batch_size 3 not divisible by 8 devices"):
        _copy_suite().train(batch_size=3, num_devices=8, context_frames=2, pred_frames=2,
                            epochs=1, no_wandb=True, no_vis=True, out_dir=str(tmp_path / "run"))
    assert not (tmp_path / "run").exists()


def test_num_devices_without_a_group_raises(tmp_path):
    r"""One process runs one device: more need processes of their own, and
    ``multihost`` needs torchrun's variables."""
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        _copy_suite().train(batch_size=4, num_devices=2, context_frames=2, pred_frames=2,
                            epochs=1, no_wandb=True, no_vis=True, out_dir=str(tmp_path / "run"))
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        assert k not in os.environ
    with pytest.raises(ValueError, match="RANK"):
        _copy_suite().train(batch_size=4, multihost=True, context_frames=2, pred_frames=2,
                            epochs=1, no_wandb=True, no_vis=True, out_dir=str(tmp_path / "run"))
    assert not (tmp_path / "run").exists()
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# the steps world against JAX's steps on a two-device mesh

def _jax_params(name, model):
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    if name == "unet3d":
        return _import_unet3d(sd)
    if name == "predrnn":
        return _import_predrnn(sd)
    return import_state_dict("convlstm-shi", sd)


def _port_state_dict(name, jstate):
    if name == "unet3d":
        return unet3d_state_dict_from_jax({"params": jstate.params,
                                           "batch_stats": jstate.extra_vars["batch_stats"]})
    if name == "predrnn":
        return predrnn_state_dict_from_jax(jstate.params)
    return ef_state_dict_from_jax(jstate.params)


@functools.lru_cache(maxsize=None)
def _jax_step(name):
    r"""``(JAX state before, state after, loss)`` of the case's step on the
    global batch sharded over a two-device mesh; PredRNN++'s with the
    port's global masks injected."""
    model_id, cfg, opt, k, fsdp, (ctx, pred), _ = W.CASES[name]
    extra = dict(scan_unroll=1) if model_id == "predrnn-pp" else {}
    jmodel = JAX_MODELS[model_id](**{**W.EF, **cfg}, **extra)
    optimizer = optax.sgd(W.LR) if opt == "sgd" else optax.adam(W.LR)
    lp = JaxLossProvider({"losses_and_scales": {"mse": 1.0}, "img_c": 3, "device": None})
    step = jax_loop.make_train_step(jmodel, {"context_frames": ctx, "pred_frames": pred,
                                             "use_actions": False}, optimizer, lp,
                                    donate=False, accum_steps=k)
    variables = _jax_params(name, W.case_model(name))
    params = variables["params"]
    mesh = make_mesh(2)
    model_state = {**jmodel.init_model_state(), **(W.PREDRNN_STATE if name == "predrnn" else {})}
    state = jax.tree.map(jnp.asarray, JaxTrainState(
        params=params, extra_vars={k2: v for k2, v in variables.items() if k2 != "params"},
        opt_state=optimizer.init(params), step=jnp.asarray(0, jnp.int32),
        model_state=model_state, rng=jax.random.PRNGKey(0)))
    place = (lambda t: shard_params_fsdp(t, mesh, min_size=W.FSDP_MIN_SIZE)) if fsdp \
        else (lambda t: shard_params(t, mesh))
    state = state.replace(params=place(state.params), opt_state=place(state.opt_state),
                          extra_vars=shard_params(state.extra_vars, mesh))
    batch = {"frames": jax.device_put(W.case_frames(name), batch_sharding(mesh))}
    with jax.default_matmul_precision("highest"):
        after, metrics = step(state, batch, jnp.asarray(0.0))
    return state, after, float(metrics["total"])


def _inject_masks(monkeypatch, masks):
    r"""Makes the JAX PredRNN++ draw ``masks`` (the port's global masks, in
    the order drawn), with its own schedule arithmetic."""
    cls = JAX_MODELS["predrnn-pp"]
    draw = cls.scheduled_sampling_mask
    pending = [m.reshape(m.shape[:2]).numpy() for m in masks]

    def injected(self, model_state, rng, batch_size, context_frames, pred_frames, train):
        mask, model_state = draw(self, model_state, rng, batch_size, context_frames, pred_frames,
                                 train)
        m = pending.pop(0)
        return jnp.asarray(np.broadcast_to(m[:, :, None, None, None], mask.shape)), model_state
    monkeypatch.setattr(cls, "scheduled_sampling_mask", injected)


def _ranks_agree(steps, name):
    a, b = steps[0][name], steps[1][name]
    assert a["loss"] == b["loss"] and a["no_grad"] == b["no_grad"]
    for k, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][k]), f"{name}: {k} differs between the processes"
    return a


def _same_step(name, got, want_sd, want_loss, atol=1e-5, where=None):
    np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-5)
    assert set(got["state_dict"]) == set(want_sd)
    for k, v in got["state_dict"].items():
        w = want_sd[k].numpy()
        tol = 1e-6 if k.endswith(("running_mean", "running_var")) else atol
        keep = where[k] if where is not None else np.ones(w.shape, bool)
        np.testing.assert_allclose(v.numpy()[keep], w[keep], rtol=0, atol=tol,
                                   err_msg=f"{name}: {k}")


@pytest.mark.parametrize("name", ["sgd", "adam", "fsdp", "accum_steps_2", "unet3d", "predrnn"])
def test_two_process_step_matches_jax(steps, name, monkeypatch):
    got = _ranks_agree(steps, name)
    if name == "predrnn":
        assert len(got["masks"]) == 2 and got["masks"][0].shape[0] == 4   # the global batch
        _inject_masks(monkeypatch, got["masks"])
    before, after, loss = _jax_step(name)
    want = _port_state_dict(name, after)
    if name == "unet3d":
        _unet3d_step(got, want, loss)
        return
    if name != "adam":
        _same_step(name, got, want, loss)
        return
    # Adam: the first moment is 0.1 g everywhere. Its first update is
    # lr g / (|g| + eps): where the two g share a sign, the parameters may part
    # by lr eps |g - g'| / ((|g| + eps)(|g'| + eps)) and rounding
    g = {k: v.numpy() / 0.1 for k, v in ef_state_dict_from_jax(after.opt_state[0].mu).items()}
    same_sign = 0
    for k, m in got["moments"].items():
        mine, eps = m.numpy() / 0.1, 1e-8
        np.testing.assert_allclose(mine, g[k], rtol=0, atol=1e-5 * np.abs(g[k]).max(), err_msg=k)
        agree = np.sign(mine) == np.sign(g[k])
        same_sign += agree.sum()
        bound = W.LR * eps * np.abs(mine - g[k]) / ((np.abs(mine) + eps) * (np.abs(g[k]) + eps))
        diff = np.abs(got["state_dict"][k].numpy() - want[k].numpy())
        assert np.all(diff[agree] <= bound[agree] + 1e-6), k
    assert same_sign > 0.999 * sum(m.numel() for m in got["moments"].values())
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)


def _one_process_step(name):
    r"""The port's model after its one-process step on the whole batch, and
    the loss."""
    model = W.case_model(name)
    state = create_train_state(model, lr=W.LR, optimizer=W.CASES[name][2])
    ctx, pred = W.CASES[name][5]
    _, metrics = make_train_step(model, {"context_frames": ctx, "pred_frames": pred})(
        state, {"frames": torch.from_numpy(W.case_frames(name))})
    return model, float(metrics["total"])


def _unet3d_step(got, want, loss):
    r"""UNet-3D: the summed MSE gives gradients of order 100, whose f32
    rounding moves a parameter by up to 2.5e-5 at lr 1e-2 between the port's
    one-process step and JAX's. So the two-process step is held to the
    one-process step to 1e-5, to JAX's as (p0 - p1) / lr within 2e-4 of each
    tensor's largest, or absolutely where all are below 1
    (``test_torch_unet3d``'s gate of the one-process step), and the running
    statistics to 1e-6."""
    model, one_loss = _one_process_step("unet3d")
    _same_step("unet3d", got, model.state_dict(), one_loss)
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
    p0 = W.case_model("unet3d").state_dict()
    for k, v in got["state_dict"].items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=1e-6, err_msg=k)
        elif v.is_floating_point():
            step_got, step_want = (p0[k] - v) / W.LR, (p0[k] - want[k]) / W.LR
            scale = max(float(step_want.abs().max()), 1.0)
            assert (step_got - step_want).abs().max() <= 2e-4 * scale, k


def test_fsdp_shards_large_leaves_only(steps):
    r"""The leaves of at least ``min_size`` elements hold half their rows on
    each process (FSDP2 pads the last shard), the others stay whole."""
    shares = [steps[r]["fsdp"]["shares"] for r in range(2)]
    large = [n for n, (_, _, numel, _) in shares[0].items() if numel >= W.FSDP_MIN_SIZE]
    assert large and len(large) < len(shares[0])
    for n, (sharded, local, numel, rows) in shares[0].items():
        if numel < W.FSDP_MIN_SIZE:
            assert not sharded and local == numel, n
            continue
        assert sharded and shares[1][n][0], n
        per_row = numel // rows
        assert local == -(-rows // 2) * per_row, n
        assert local + shares[1][n][1] == numel, n


def test_scheduled_sampling_masks_are_global(steps):
    r"""Every process draws the same masks for the global batch of 4 from
    its identically seeded generator (the run seed, as
    ``create_train_state`` seeds it) and takes its own rows; a fresh draw in
    this process at the global batch gives the same masks."""
    a, b = steps[0]["predrnn"]["masks"], steps[1]["predrnn"]["masks"]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    model = W.case_model("predrnn")
    state = create_train_state(model)
    (ctx, pred), ms = W.CASES["predrnn"][5], dict(W.PREDRNN_STATE)
    for got in a:
        want, ms = model.scheduled_sampling_mask(ms, state.generator, 4, ctx, pred, train=True)
        assert torch.equal(got, want)
    assert 0.0 < float(torch.cat(a).mean()) < 1.0, "the masks are not random"
    assert steps[0]["predrnn"]["model_state"]["sampling_eta"] == float(
        np.float32(np.float32(0.5) - np.float32(2e-5)) - np.float32(2e-5))


def test_st_phy_dead_layers_keep_no_gradient(steps):
    r"""ST-Phy's layers that feed nothing keep ``.grad`` None on both
    processes (the all-reduce skips them alike); the step equals the port's
    one-process step on the whole batch."""
    got = _ranks_agree(steps, "st_phy")
    assert got["no_grad"]
    model, loss = _one_process_step("st_phy")
    assert got["no_grad"] == [n for n, p in model.named_parameters() if p.grad is None]
    _same_step("st_phy", got, model.state_dict(), loss)


# ---------------------------------------------------------------------------
# the facade world

@pytest.mark.parametrize("run", [name for name, _, _ in W.FACADE_RUNS])
def test_multihost_two_process_train(facade, run):
    out_dir, results = facade
    r0, r1 = results[0][run], results[1][run]
    assert r0["process_count"] == r1["process_count"] == 2
    assert r0["steps"] == r1["steps"] == 2 and r0["lr"] == r1["lr"]
    assert abs(r0["checksum"] - r1["checksum"]) < 1e-5
    ckpt = out_dir / f"run_{run}" / "best_model"
    backend = dict((n, b) for n, b, _ in W.FACADE_RUNS)[run]
    if backend == "msgpack":
        assert sorted(Path(p).parent.name for p in r0["checkpoint_writes"]) \
            == ["best_model", "final_model"]
    else:
        assert (ckpt / "orbax_state" / ".metadata").exists()
        assert not (ckpt / "checkpoint.pt").exists()
        assert json.loads((ckpt / "model_config.json").read_text())["backend"] == "orbax"
    assert r1["checkpoint_writes"] == []
    entry = VPSuite(device="cpu").load_model(str(out_dir / f"run_{run}"), "best_model")
    assert entry.model_id == "convlstm-shi" and entry.state.step == 2
    assert entry.state.optimizer.param_groups[0]["lr"] == r0["lr"]
    checksum = float(sum(v.abs().sum() for v in entry.model.state_dict().values()))
    assert abs(checksum - r0["checksum"]) < 1e-4
    assert not torch.distributed.is_initialized()
