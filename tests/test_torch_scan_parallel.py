r"""The port's sequence-parallel linear recurrence (``ops/scan_parallel.py``)
and MinConvRNN's ``context_mesh`` against the JAX package's, on the CPU.

Two spawned gloo worlds of ``helpers/torch_model_parallel_worker.py`` (torch
and the port only; 120 s each, started at the fixture so that they run while
JAX compiles):

- ``seq``, two processes on ``{"seq": 2}``: ``linear_recurrence_scan_sharded``
  on each process's time block, without and with ``h0``, against JAX's on
  ``make_mesh_nd({"seq": 2})`` of the conftest's virtual CPU devices: the
  blocks' outputs and the gradients of ``f`` and ``u`` of ``sum(h * c)``
  joined, ``h0``'s on every process, to 1e-5; the refusals (a time that does
  not divide, a ``spec`` whose first axis is not the sequence's); MinConvRNN
  with ``context_mesh``: ``predict`` and one SGD step equal the same model's
  without one (1e-5) at a context of 4 steps, which shards, and of 3, which
  does not (then bit for bit, and no all-gather ran); ``context_mesh`` stays
  out of the model's ``config``.
- ``seq_data``, four processes on ``{"seq": 2, "data": 2}``: the scan with
  ``spec=("seq", "data")`` against JAX's with ``P("seq", "data")``.
"""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from vp_suite_tpu.ops import scan_parallel as jax_scan_parallel
from vp_suite_tpu.parallel import mesh as jax_mesh

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "helpers" / "torch_model_parallel_worker.py"
_spec = importlib.util.spec_from_file_location("torch_model_parallel_worker", WORKER)
W = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(W)
WORLD_TIMEOUT = 120
WORLDS = {"seq": 2, "seq_data": 4}


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
def seq(worlds):
    return _results(worlds, "seq")


@pytest.fixture(scope="module")
def seq_data(worlds):
    return _results(worlds, "seq_data")


@functools.lru_cache(maxsize=None)
def _jax_scan(shape, seed, with_h0, axes):
    r"""JAX's sharded scan on ``make_mesh_nd(axes)``: ``(h, df, du, dh0)`` of
    ``sum(h * c)``."""
    f, u, h0 = W.scan_inputs(shape, seed)
    c = W.rand(7, shape)
    mesh = jax_mesh.make_mesh_nd(dict(axes))
    spec = PartitionSpec(*dict(axes)) if len(axes) > 1 else None

    def loss(f, u, h0):
        h = jax_scan_parallel.linear_recurrence_scan_sharded(f, u, mesh, "seq",
                                                             h0=h0 if with_h0 else None,
                                                             spec=spec)
        return jnp.sum(h * c), h

    if spec is not None:
        f, u = (jax.device_put(a, NamedSharding(mesh, spec)) for a in (f, u))
    (_, h), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(f, u, h0)
    return tuple(np.asarray(a) for a in (h, *grads))


def _joined(ranks, key, case="scan"):
    return torch.cat([r[case][key] for r in ranks]).numpy()


@pytest.mark.parametrize("case", ["scan", "scan_h0"])
def test_scan_matches_jax(seq, case):
    h, df, du, dh0 = _jax_scan(W.SCAN, 0, case == "scan_h0", (("seq", 2),))
    for key, want in (("h", h), ("df", df), ("du", du)):
        np.testing.assert_allclose(_joined(seq, key, case), want, rtol=1e-5, atol=1e-5,
                                   err_msg=key)
    for r in seq:
        if case == "scan_h0":
            np.testing.assert_allclose(r[case]["dh0"].numpy(), dh0, rtol=1e-5, atol=1e-5)
        else:
            assert r[case]["dh0"] is None


def test_scan_with_data_spec_matches_jax(seq_data):
    r"""Process ``r`` of ``{"seq": 2, "data": 2}`` holds time block ``r // 2`` and
    batch rows ``r % 2``; ``h0``'s gradient is its batch rows', summed over seq."""
    h, df, du, dh0 = _jax_scan(W.SCAN_DATA, 4, True, (("seq", 2), ("data", 2)))
    for r, got in enumerate(seq_data):
        s, d = divmod(r, 2)
        block = (slice(4 * s, 4 * s + 4), slice(2 * d, 2 * d + 2))
        for key, want in (("h", h), ("df", df), ("du", du)):
            np.testing.assert_allclose(got["scan"][key].numpy(), want[block], rtol=1e-5,
                                       atol=1e-5, err_msg=f"{key} of process {r}")
        np.testing.assert_allclose(got["scan"]["dh0"].numpy(), dh0[block[1]], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("what,text", [("indivisible", "must divide mesh axis 'seq' of size 2"),
                                       ("spec", "must put 'seq' on the time dim")])
def test_scan_refusals(seq, what, text):
    message = seq[0]["refused"][what]
    assert message is not None and message.startswith("ValueError") and text in message, message


@pytest.mark.parametrize("ctx", W.MCR_CONTEXTS)
def test_min_conv_rnn_context_mesh_matches_unsharded(seq, ctx):
    r"""At a context that divides by ``seq`` the scan shards (all-gathers ran)
    and ``predict`` and one SGD step equal the unsharded model's; at one that
    does not it runs unsharded, as the JAX model does: the same tensors and no
    collective."""
    for r in seq:
        sharded, plain = r["mcr"][ctx][True], r["mcr"][ctx][False]
        assert plain["gathers"] == 0
        assert "context_mesh" not in sharded["config"] and sharded["config"] == plain["config"]
        if ctx % 2:
            assert sharded["gathers"] == 0
            assert torch.equal(sharded["preds"], plain["preds"])
        else:
            assert sharded["gathers"] > 0
        np.testing.assert_allclose(sharded["preds"].numpy(), plain["preds"].numpy(), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(sharded["loss"], plain["loss"], rtol=1e-5)
        for k, v in sharded["state_dict"].items():
            np.testing.assert_allclose(v.numpy(), plain["state_dict"][k].numpy(), rtol=0,
                                       atol=1e-5, err_msg=k)
    for k, v in seq[0]["mcr"][ctx][True]["state_dict"].items():
        assert torch.equal(v, seq[1]["mcr"][ctx][True]["state_dict"][k]), k
