r"""The port's ``VPSuite`` facade and package boundary.

- ``VPSuite(device="cpu").create_model(...).predict(...)`` of the port equals
  the JAX package's ``VPSuite(device="cpu").predict`` on the same carried
  weights (f32, atol 1e-4), and CPU calls leave the kernels' launch counts at 0;
- ``VPSuite()`` defaults to CUDA and raises where there is none;
- the port imports neither JAX nor the JAX package, checked by importing each
  of its modules with both blocked and by reading its sources.
"""
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import vp_suite_tpu_torch
from vp_suite_tpu import VPSuite as JaxVPSuite
from vp_suite_tpu_torch import VPSuite
from vp_suite_tpu_torch.ops.cells import convlstm_gate_fuse
from vp_suite_tpu_torch.ops.convlstm import convlstm_scan_fused
from vp_suite_tpu_torch.utils.jax_params import load_jax_params

torch.set_num_threads(1)

ROOT = Path(vp_suite_tpu_torch.__file__).resolve().parent.parent
KWARGS = dict(img_shape=(3, 16, 16), action_size=0, tensor_value_range=(0.0, 1.0))


@pytest.mark.parametrize("cfg", [{}, dict(use_fused_scan=True, interleaved_encode=False,
                                          interleaved_forecast=False)],
                         ids=["per_step", "fused_scan"])
def test_predict_matches_jax_facade(cfg):
    jax_suite = JaxVPSuite(device="cpu", compilation_cache=False)
    jax_entry = jax_suite.create_model("convlstm-shi", **KWARGS, **cfg)
    suite = VPSuite(device="cpu")
    entry = suite.create_model("convlstm-shi", **KWARGS, **cfg)
    load_jax_params(entry.model, jax_entry.state.params)
    frames = np.random.default_rng(1).random((2, 3, 16, 16, 3)).astype(np.float32)
    convlstm_gate_fuse.launches = convlstm_scan_fused.launches = 0
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_suite.predict(frames, pred_frames=4))
        want_one = np.asarray(jax_suite.predict(frames[0], pred_frames=4))
    got = suite.predict(frames, pred_frames=4)
    got_one = suite.predict(frames[0], pred_frames=4)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert got.shape == (2, 4, 16, 16, 3) and got_one.shape == (4, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_one.numpy(), want_one, rtol=0, atol=1e-4)
    assert list(entry.predict_fns) == [(3, 4, False)]
    assert convlstm_gate_fuse.launches == 0 and convlstm_scan_fused.launches == 0


def test_create_model_is_seeded_and_needs_required_args():
    suite = VPSuite(device="cpu")
    a = suite.create_model("convlstm-shi", seed=3, **KWARGS).model.state_dict()
    b = suite.create_model("convlstm-shi", seed=3, **KWARGS).model.state_dict()
    c = suite.create_model("convlstm-shi", seed=4, **KWARGS).model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    assert len(suite.models) == 3
    with pytest.raises(ValueError, match="no dataset loaded"):
        suite.create_model("convlstm-shi", img_shape=(3, 16, 16))
    with pytest.raises(ValueError, match="invalid model type"):
        suite.create_model("phy", **KWARGS)
    with pytest.raises(TypeError, match="unknown hyperparameters"):
        suite.create_model("convlstm-shi", use_pallas=True, **KWARGS)


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VPSuite()
    with pytest.raises(ValueError):
        VPSuite(device="meta")
    assert VPSuite(device="cpu").device == torch.device("cpu")


def test_package_imports_without_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'vp_suite_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import vp_suite_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(vp_suite_tpu_torch.__path__,\n"
        "                                              'vp_suite_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 16


def test_package_sources_name_no_jax():
    pattern = re.compile(r"import jax|from jax|vp_suite_tpu(?!_torch)")
    pkg = ROOT / "vp_suite_tpu_torch"
    sources = sorted(pkg.rglob("*.py")) + sorted(pkg.rglob("*.cu"))
    assert len(sources) > 16
    for src in sources:
        for n, line in enumerate(src.read_text().splitlines(), 1):
            assert not pattern.search(line), f"{src.relative_to(ROOT)}:{n}: {line}"
