r"""``VPSuite.load_dataset`` -> ``create_model`` -> ``train`` -> ``load_model``
of the port against the JAX package's.

- Facade parity: both packages load on-the-fly Moving MNIST (16x16, synthetic
  digits, 8/4/4 sequences), create EF-ConvLSTM (the port carries the JAX
  parameters over with ``load_jax_params``) and train 2 epochs of 2 Adam
  steps, b=2, 2 -> 2 frames, in f32 (JAX under
  ``jax.default_matmul_precision("highest")``). The per-epoch validation
  losses in ``metrics.jsonl`` and the returned best loss agree to rtol 1e-4.
  Both loaders run with one worker: MMF's items draw from RNGs that all items
  share, so with threads which sequence lands in which batch slot would
  depend on timing.
- Checkpoints: ``load_model`` restores the trained parameters exactly, with
  the step count, and its ``predict`` equals the trained entry's; a second
  ``train`` continues from the kept optimizer state.
- The device backend trains on the CPU; REQUIRED_ARGS come from the dataset;
  unknown and not-yet-ported run options raise before any work; no kernel
  launches on CPU tensors; the package imports with ``cv2`` blocked.
"""
import functools
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import vp_suite_tpu.vpsuite as jax_vpsuite
import vp_suite_tpu_torch
import vp_suite_tpu_torch.vpsuite as port_vpsuite
from vp_suite_tpu_torch import VPSuite
from vp_suite_tpu_torch.ops import cells, convlstm
from vp_suite_tpu_torch.utils.jax_params import load_jax_params

torch.set_num_threads(1)

ROOT = Path(vp_suite_tpu_torch.__file__).resolve().parent.parent
MMF = dict(img_size=16, digit_source="synthetic", n_seqs={"train": 8, "val": 4, "test": 4})
RUN = dict(epochs=2, batch_size=2, context_frames=2, pred_frames=2, steps_per_epoch=2,
           no_vis=True, no_wandb=True, num_devices=1)


def _one_worker(monkeypatch, module):
    monkeypatch.setattr(module, "BatchLoader",
                        functools.partial(module.BatchLoader, num_workers=1))


def _val_losses(out_dir):
    with open(Path(out_dir) / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def _launches():
    return (cells.convlstm_gate_fuse.launches, cells.convlstm_gate_backward.launches,
            convlstm.convlstm_scan_fused.launches,
            convlstm.convlstm_scan_fused.save_gates_launches,
            convlstm.convlstm_scan_backward.launches)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    r"""The JAX package's run, once: its initial parameters (as numpy), its
    metrics and its best loss."""
    out = tmp_path_factory.mktemp("jax_run")
    with pytest.MonkeyPatch.context() as mp:
        _one_worker(mp, jax_vpsuite)
        suite = jax_vpsuite.VPSuite(device="cpu", compilation_cache=False)
        suite.load_dataset("MMF", **MMF)
        entry = suite.create_model("convlstm-shi")
        params = jax.tree_util.tree_map(np.asarray, entry.state.params)
        with jax.default_matmul_precision("highest"):
            best = suite.train(out_dir=str(out), **RUN)
    return dict(params=params, metrics=_val_losses(out), best=best)


@pytest.fixture(scope="module")
def port_run(jax_run, tmp_path_factory):
    out = tmp_path_factory.mktemp("port_run")
    with pytest.MonkeyPatch.context() as mp:
        _one_worker(mp, port_vpsuite)
        suite = VPSuite(device="cpu")
        suite.load_dataset("MMF", **MMF)
        entry = suite.create_model("convlstm-shi")
        load_jax_params(entry.model, jax_run["params"])
        before = _launches()
        best = suite.train(out_dir=str(out), **RUN)
        after = _launches()
    return dict(suite=suite, entry=entry, out=out, best=best, launches=(before, after))


def test_train_matches_jax(jax_run, port_run):
    want, got = jax_run["metrics"], _val_losses(port_run["out"])
    assert [m["epoch"] for m in got] == [m["epoch"] for m in want] == [0, 1]
    for w, g in zip(want, got):
        assert set(g) == set(w) == {"epoch", "total", "mse"}
        np.testing.assert_allclose(g["mse"], w["mse"], rtol=1e-4)
        np.testing.assert_allclose(g["total"], w["total"], rtol=1e-4)
    np.testing.assert_allclose(port_run["best"], jax_run["best"], rtol=1e-4)
    assert port_run["best"] == min(m["mse"] for m in got)
    entry = port_run["entry"]
    assert entry.state.step == 4 and len(entry.train_epoch_fps) == 2
    assert port_run["launches"][0] == port_run["launches"][1]


def _predict(entry):
    suite = VPSuite(device="cpu")
    suite.models.append(entry)
    frames = np.random.default_rng(4).random((2, 2, 16, 16, 3)).astype(np.float32)
    return suite.predict(frames, pred_frames=3)


def test_checkpoints_load_the_trained_model(port_run):
    out, entry = port_run["out"], port_run["entry"]
    for name in ("best_model", "final_model"):
        for f in ("checkpoint.pt", "model_config.json", "run_cfg.json"):
            assert (out / name / f).is_file()
    assert (out / "run_cfg.json").is_file()
    loaded = VPSuite(device="cpu").load_model(str(out), "final_model")
    want, got = entry.model.state_dict(), loaded.model.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert loaded.state.step == 4 and loaded.model_id == "convlstm-shi"
    assert loaded.model.img_shape == (3, 16, 16) and loaded.model_dir == str(out)
    torch.testing.assert_close(_predict(loaded), _predict(entry), rtol=0, atol=0)
    best = VPSuite(device="cpu").load_model(str(out))
    assert best.state.step > 0


def test_second_train_continues_the_optimizer(port_run, tmp_path):
    entry, suite = port_run["entry"], port_run["suite"]
    optimizer = entry.state.optimizer
    moments = {id(p): s["exp_avg"].clone() for p, s in optimizer.state.items()}
    suite.train(out_dir=str(tmp_path), **{**RUN, "epochs": 1, "steps_per_epoch": 1})
    assert entry.state.optimizer is optimizer and entry.state.step == 5
    assert all(int(s["step"]) == 5 for s in optimizer.state.values())
    assert any(not torch.equal(s["exp_avg"], moments[id(p)]) for p, s in optimizer.state.items())
    loaded = VPSuite(device="cpu").load_model(str(tmp_path), "final_model")
    assert all(int(s["step"]) == 5 for s in loaded.state.optimizer.state.values())


@pytest.mark.parametrize("cfg", [{}, dict(use_fused_scan=True, interleaved_encode=False,
                                          interleaved_forecast=False)],
                         ids=["per_step", "fused_scan"])
def test_device_backend_trains_on_the_cpu(tmp_path, cfg):
    suite = VPSuite(device="cpu")
    suite.load_dataset("MMF", backend="device", **MMF)
    entry = suite.create_model("convlstm-shi", **cfg)
    before = _launches()
    best = suite.train(out_dir=str(tmp_path), **{**RUN, "epochs": 1, "steps_per_epoch": 1})
    assert _launches() == before
    assert np.isfinite(best) and entry.state.step == 1
    assert [m["epoch"] for m in _val_losses(tmp_path)] == [0]
    assert (tmp_path / "best_model" / "checkpoint.pt").is_file()


def test_required_args_come_from_the_dataset():
    suite = VPSuite(device="cpu")
    ds = suite.load_dataset("MMF", img_size=16, digit_source="synthetic", num_channels=1,
                            value_range_min=-1.0, value_range_max=1.0, n_seqs=4)
    entry = suite.create_model("convlstm-shi")
    required = entry.model.REQUIRED_ARGS
    assert set(required) <= set(ds.config) and set(required) <= set(entry.model.hparam_names())
    assert entry.model.img_shape == (1, 16, 16)
    assert entry.model.tensor_value_range == (-1.0, 1.0) and entry.model.action_size == 0
    jax_suite = jax_vpsuite.VPSuite(device="cpu", compilation_cache=False)
    jax_suite.load_dataset("MMF", img_size=16, digit_source="synthetic", num_channels=1,
                           value_range_min=-1.0, value_range_max=1.0, n_seqs=4)
    assert {k: jax_suite.datasets[-1].config[k] for k in required} \
        == {k: ds.config[k] for k in required}


#: options that were refused until they were ported, and the file each now
#: writes; multihost joins a gloo group of one process from torchrun's variables
PORTED = {"multihost": (dict(multihost=True), "run/final_model/checkpoint.pt"),
          "fsdp": (dict(fsdp=True), "run/final_model/checkpoint.pt"),
          "orbax": (dict(ckpt_backend="orbax"), "run/final_model/orbax_state/.metadata"),
          "profile_dir": (dict(profile_dir="trace"), "trace/trace_epoch_002.json"),
          "trial": (dict(trial=object()), "run/final_model"),
          "vis": (dict(no_vis=False, vis_every=1), "run/vis_ep_002/vis_0.gif")}


@pytest.mark.parametrize("name", ["multihost", "fsdp", "num_devices", "orbax", "profile_dir",
                                  "trial", "vis"])
def test_unported_run_options_raise_before_any_work(tmp_path, monkeypatch, name):
    r"""``num_devices`` > 1 in one process without a group raises before any
    work (one process runs one device: start them with torchrun). The
    parallel options, ``profile_dir``, a trial without a search space
    (ignored, as in the JAX package) and visualisation, which were refused
    here until they were ported, now run and write their files."""
    import socket
    import torch.distributed as dist
    monkeypatch.chdir(tmp_path)
    suite = VPSuite(device="cpu")
    suite.load_dataset("MMF", **MMF)
    entry = suite.create_model("convlstm-shi")
    out = tmp_path / "run"
    if name == "num_devices":
        with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
            suite.train(out_dir=str(out), **{**RUN, "num_devices": 2})
        assert not out.exists() and entry.state is None
        return
    kw, written = PORTED[name]
    if name == "multihost":
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        for k, v in dict(RANK=0, WORLD_SIZE=1, LOCAL_RANK=0, MASTER_ADDR="127.0.0.1",
                         MASTER_PORT=port).items():
            monkeypatch.setenv(k, str(v))
        kw = {**kw, "num_devices": 0}
    try:
        suite.train(out_dir=str(out), **{**RUN, **kw})
        assert dist.is_initialized() == (name == "multihost")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert entry.state.step == RUN["epochs"] * RUN["steps_per_epoch"]
    assert (tmp_path / written).exists()


def test_run_kwargs_are_checked():
    suite = VPSuite(device="cpu")
    with pytest.raises(RuntimeError, match="No model"):
        suite.train()
    suite.create_model("convlstm-shi", img_shape=(3, 16, 16), action_size=0,
                       tensor_value_range=(0.0, 1.0))
    with pytest.raises(ValueError, match="No training sets"):
        suite.train()
    suite.load_dataset("MMF", **MMF)
    with pytest.raises(ValueError, match="unknown"):
        suite.train(learning_rate=1e-3)
    with pytest.raises(ValueError, match="img sizes differ"):
        suite.load_dataset("MMF", **{**MMF, "img_size": 32})
        suite.train(**RUN)
    with pytest.raises(ValueError, match="batch_size"):
        suite.load_dataset("MMF", **MMF)
        suite.train(**{**RUN, "batch_size": 16})


def test_package_imports_with_cv2_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "for name in ('cv2', 'jax', 'jaxlib', 'flax', 'optax', 'vp_suite_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import vp_suite_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(vp_suite_tpu_torch.__path__,\n"
        "                                              'vp_suite_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "from vp_suite_tpu_torch.datasets import MovingMNISTOnTheFly\n"
        "ds = MovingMNISTOnTheFly('train', img_size=16, digit_source='synthetic', n_seqs=2)\n"
        "ds.set_seq_len(2, 2, 1)\n"
        "print(len(mods), ds[0]['frames'].shape)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[0] and "(4, 16, 16, 3)" in out.stdout
