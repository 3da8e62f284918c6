r"""The port's GPipe pipeline (``parallel/pipeline.py``) against the JAX
package's ``gpipe_apply`` and the serial composition of its stages, on the CPU.

A spawned gloo world of ``helpers/torch_model_parallel_worker.py`` (torch and
the port only; 120 s, started at the fixture so that it runs while JAX
compiles), ``pp``: two processes on ``{"pp": 2}`` run a 3x3 conv + tanh stage
(the JAX package's dry-run stage) over 4 microbatches of 2. Both processes'
output and the gradients of a mean squared error of it with respect to the
stacked parameters and the input equal JAX's ``gpipe_apply`` on
``make_mesh_nd({"pp": 2})`` of the conftest's virtual CPU devices, under
``default_matmul_precision("highest")``, and the serial composition in this
process, to 1e-5; ``make_mesh_nd`` takes any axis names in their order.

Without a group: one stage is a map over the microbatches, and ``microbatch``
refuses a batch that does not divide.
"""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vp_suite_tpu.parallel import mesh as jax_mesh
from vp_suite_tpu.parallel import pipeline as jax_pipeline
from vp_suite_tpu_torch.parallel import gpipe_apply, microbatch, stack_stage_params

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "helpers" / "torch_model_parallel_worker.py"
_spec = importlib.util.spec_from_file_location("torch_model_parallel_worker", WORKER)
W = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(W)
WORLD_TIMEOUT = 120


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    started = W.P.World("pp", tmp_path_factory.mktemp("pp"), size=2, timeout=WORLD_TIMEOUT,
                        script=WORKER)
    yield started
    started.stop()


def _results(world):
    world.wait()
    return [torch.load(world.out_dir / f"pp_{r}.pt", weights_only=False) for r in range(2)]


def _jax_stage(params, x):
    y = jax.lax.conv_general_dilated(x, params["w"], (1, 1), "SAME",
                                     dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return jnp.tanh(y + params["b"])


@functools.lru_cache(maxsize=None)
def _jax_gpipe():
    r"""JAX's ``gpipe_apply`` on ``{"pp": 2}``: ``(y, loss, dx, {leaf: stacked
    gradient in the port's layout})``."""
    params, x, tgt = W.pp_inputs()
    stacked = jax_pipeline.stack_stage_params(
        [{"w": jnp.asarray(p["w"].transpose(2, 3, 1, 0)), "b": jnp.asarray(p["b"])}
         for p in params])
    mesh = jax_mesh.make_mesh_nd({"pp": W.PP["S"]})

    def loss(stacked, x):
        y = jax_pipeline.gpipe_apply(_jax_stage, stacked, jax_pipeline.microbatch(x, W.PP["M"]),
                                     mesh)
        return jnp.mean((y.reshape(tgt.shape) - tgt) ** 2), y

    with jax.default_matmul_precision("highest"):
        (value, y), (grads, dx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
            stacked, jnp.asarray(x))
    grads = {"w": np.asarray(grads["w"]).transpose(0, 4, 3, 1, 2), "b": np.asarray(grads["b"])}
    return np.asarray(y), float(value), np.asarray(dx), grads


def _serial():
    r"""The port's stages in turn on the whole batch: ``(y, loss, dx, grads)``."""
    params, x, tgt = W.pp_inputs()
    stages = [{k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()} for p in params]
    xt = torch.from_numpy(x).requires_grad_(True)
    y = xt
    for p in stages:
        y = W.pp_stage(p, y)
    loss = ((y - torch.from_numpy(tgt)) ** 2).mean()
    loss.backward()
    grads = {k: torch.stack([p[k].grad for p in stages]).numpy() for k in ("w", "b")}
    return y.detach().numpy(), loss.item(), xt.grad.numpy(), grads


@pytest.mark.parametrize("reference", ["jax_gpipe", "serial"])
def test_gpipe_matches(world, reference):
    r"""Both processes hold the whole output and the whole gradients of the
    stacked parameters and of the input, equal to JAX's pipeline's and the
    serial composition's."""
    y, loss, dx, grads = _jax_gpipe() if reference == "jax_gpipe" else _serial()
    pp = _results(world)
    for r in pp:
        np.testing.assert_allclose(r["y"].reshape(y.shape).numpy(), y, rtol=0, atol=1e-5)
        np.testing.assert_allclose(r["loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(r["dx"].numpy(), dx, rtol=0, atol=1e-5)
        for k, want in grads.items():
            np.testing.assert_allclose(r["grads"][k].numpy(), want, rtol=0,
                                       atol=1e-5 * max(1.0, np.abs(want).max()), err_msg=k)
    assert torch.equal(pp[0]["y"], pp[1]["y"])


def test_make_mesh_nd_takes_any_axis_names(world):
    for r in _results(world):
        assert r["names"] == {("pp",): (("pp",), (2,)),
                              ("seq", "data"): (("seq", "data"), (2, 1)),
                              ("data", "pp"): (("data", "pp"), (1, 2))}


def test_one_stage_maps_the_microbatches():
    r"""``S`` = 1 (no mesh) is a map of the stage over the microbatches; its
    gradients reach the stacked parameters' one row."""
    params, x, _ = W.pp_inputs()
    stacked = stack_stage_params([{k: torch.from_numpy(v) for k, v in params[0].items()}])
    for v in stacked.values():
        v.requires_grad_(True)
    y = gpipe_apply(W.pp_stage, stacked, microbatch(torch.from_numpy(x), W.PP["M"]), None)
    want = W.pp_stage({k: torch.from_numpy(v) for k, v in params[0].items()}, torch.from_numpy(x))
    assert y.shape == (W.PP["M"], W.PP["MB"], *x.shape[1:])
    np.testing.assert_allclose(y.reshape(want.shape).detach().numpy(), want.numpy(), rtol=0,
                               atol=1e-6)
    y.sum().backward()
    assert stacked["w"].grad.shape == (1, *params[0]["w"].shape)


def test_microbatch_validates_divisibility():
    with pytest.raises(ValueError, match="not divisible"):
        microbatch(torch.zeros(5, 2), 2)
    assert microbatch(torch.arange(6.0), 3).tolist() == [[0.0, 1.0], [2.0, 3.0], [4.0, 5.0]]
