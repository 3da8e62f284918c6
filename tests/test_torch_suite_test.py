r"""``VPSuite.test`` of the port against the JAX package's, on the CPU.

- Facade parity: both packages load on-the-fly Moving MNIST's test split
  (16x16, synthetic digits, 4 sequences), create EF-ConvLSTM (the port
  carries the JAX parameters over with ``load_jax_params``) and run
  ``test(brief_test=True, context_frames=2, pred_frames=2, metrics=["mse",
  "psnr", "ssim", "lpips"])`` in f32 (JAX under
  ``jax.default_matmul_precision("highest")``), each with ``OUT_PATH`` in a
  temporary directory. The per-horizon dicts of EF-ConvLSTM and of the
  CopyLastFrame baseline agree to 1e-4 relative (SSIM as ``1 - SSIM``, the
  measure's own value), and the result files have the JAX package's keys.
  Both loaders run with one worker: MMF's items draw from RNGs that all
  items share, so with threads which sequence lands in which batch would
  depend on timing.
- ``num_devices > 1`` and unknown options raise before any work;
  ``no_vis=False`` writes the videos; no kernel launches on CPU tensors;
  ``create_model("copy")`` followed by ``train`` runs validation only, and
  its checkpoint loads again.
"""
import functools
import json

import jax
import numpy as np
import pytest
import torch

import vp_suite_tpu.defaults as jax_defaults
import vp_suite_tpu.vpsuite as jax_vpsuite
import vp_suite_tpu_torch.vpsuite as port_vpsuite
from vp_suite_tpu_torch import VPSuite
from vp_suite_tpu_torch.defaults import SETTINGS
from vp_suite_tpu_torch.ops import cells, convlstm
from vp_suite_tpu_torch.utils.jax_params import load_jax_params

torch.set_num_threads(1)

MMF = dict(split="test", img_size=16, digit_source="synthetic", n_seqs=4)
TEST = dict(brief_test=True, context_frames=2, pred_frames=2,
            metrics=["mse", "psnr", "ssim", "lpips"], no_vis=True, no_wandb=True)
RTOL = 1e-4


def _one_worker(mp, module):
    mp.setattr(module, "BatchLoader", functools.partial(module.BatchLoader, num_workers=1))


def _launches():
    return (cells.convlstm_gate_fuse.launches, cells.convlstm_gate_backward.launches,
            convlstm.convlstm_scan_fused.launches,
            convlstm.convlstm_scan_fused.save_gates_launches,
            convlstm.convlstm_scan_backward.launches)


def _files(out_path):
    r"""The one test run's ``test_metrics.jsonl`` records and
    ``test_metrics.json`` under ``out_path``."""
    (run_dir,) = [d for d in out_path.iterdir() if d.name.startswith("test_")]
    with open(run_dir / "test_metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    with open(run_dir / "test_metrics.json") as f:
        return records, json.load(f)


@pytest.fixture(scope="module")
def jax_test(tmp_path_factory):
    r"""The JAX package's test run, once: its initial EF-ConvLSTM parameters
    (as numpy), its results and its files."""
    out = tmp_path_factory.mktemp("jax_test")
    with pytest.MonkeyPatch.context() as mp:
        _one_worker(mp, jax_vpsuite)
        mp.setattr(jax_defaults.SETTINGS, "OUT_PATH", out)
        suite = jax_vpsuite.VPSuite(device="cpu", compilation_cache=False)
        suite.load_dataset("MMF", **MMF)
        entry = suite.create_model("convlstm-shi")
        params = jax.tree_util.tree_map(np.asarray, entry.state.params)
        with jax.default_matmul_precision("highest"):
            results = suite.test(**TEST)
    return dict(params=params, results=results, files=_files(out))


@pytest.fixture(scope="module")
def port_test(jax_test, tmp_path_factory):
    out = tmp_path_factory.mktemp("port_test")
    with pytest.MonkeyPatch.context() as mp:
        _one_worker(mp, port_vpsuite)
        mp.setattr(SETTINGS, "_run_path", out)
        suite = VPSuite(device="cpu")
        suite.load_dataset("MMF", **MMF)
        entry = suite.create_model("convlstm-shi")
        load_jax_params(entry.model, jax_test["params"])
        before = _launches()
        results = suite.test(**TEST)
        after = _launches()
    return dict(suite=suite, results=results, files=_files(out / "output"),
                launches=(before, after))


def _assert_horizons_close(got, want):
    assert len(got) == len(want) == TEST["pred_frames"]
    for g, w in zip(got, want):
        assert list(g) == list(w) == ["mse (↓)", "psnr (↑)", "ssim (↑)", "lpips (↓)"]
        for k in w:
            own = (lambda v: 1.0 - v) if k.startswith("ssim") else (lambda v: v)
            np.testing.assert_allclose(own(g[k]), own(w[k]), rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("name", ["EF-ConvLSTM (Shi et al.)", "CopyLastFrame"])
def test_results_match_jax(jax_test, port_test, name):
    (want,), (got,) = jax_test["results"], port_test["results"]
    assert list(got) == list(want) == ["EF-ConvLSTM (Shi et al.)", "CopyLastFrame"]
    _assert_horizons_close(got[name], want[name])
    assert all(np.isfinite(v) for d in got[name] for v in d.values())


def test_result_files_have_jax_keys(jax_test, port_test):
    (got_records, got_json), (want_records, want_json) = port_test["files"], jax_test["files"]
    assert [list(r) for r in got_records] == [list(r) for r in want_records]
    assert [(r["model"], r["pred_frames"], r["test_mode"]) for r in got_records] \
        == [(r["model"], r["pred_frames"], r["test_mode"]) for r in want_records]
    assert got_json.keys() == want_json.keys()
    for name in want_json:
        _assert_horizons_close(got_json[name], want_json[name])
        assert got_json[name] == port_test["results"][0][name]


def test_no_kernel_launches_on_the_cpu(port_test):
    before, after = port_test["launches"]
    assert before == after


def test_copy_last_frame_repeats_the_last_context_frame():
    suite = VPSuite(device="cpu")
    entry = suite.create_model("copy", img_shape=(3, 8, 8), action_size=0,
                               tensor_value_range=(0.0, 1.0))
    assert entry.model.TRAINABLE is False and not list(entry.model.parameters())
    x = torch.rand((2, 3, 8, 8, 3), generator=torch.Generator().manual_seed(0))
    preds, aux = entry.model(x, pred_frames=4)
    assert aux is None and tuple(preds.shape) == (2, 4, 8, 8, 3)
    assert all(torch.equal(preds[:, i], x[:, -1]) for i in range(4))
    assert torch.equal(entry.model.pred_1(x), x[:, -1])
    assert torch.equal(suite.predict(x, pred_frames=2), x[:, -1:].repeat(1, 2, 1, 1, 1))


def test_copy_model_trains_validation_only(tmp_path):
    r"""``create_model("copy")`` followed by ``train`` validates and saves,
    with no optimizer, as in the JAX package; the checkpoint loads again."""
    suite = VPSuite(device="cpu")
    suite.load_dataset("MMF", img_size=16, digit_source="synthetic",
                       n_seqs={"train": 4, "val": 2, "test": 2})
    entry = suite.create_model("copy")
    best = suite.train(epochs=2, batch_size=2, context_frames=2, pred_frames=2, no_vis=True,
                       no_wandb=True, out_dir=str(tmp_path))
    assert entry.state.optimizer is None and entry.state.step == 0
    with open(tmp_path / "metrics.jsonl") as f:
        val = [json.loads(line) for line in f]
    assert [v["epoch"] for v in val] == [0, 1] and best == min(v["mse"] for v in val)
    loaded = VPSuite(device="cpu").load_model(str(tmp_path), "best_model")
    assert loaded.model_id == "copy" and loaded.state.optimizer is None
    assert loaded.model.img_shape == (3, 16, 16) and loaded.state.step == 0


@pytest.mark.parametrize("kw,error", [(dict(no_vis=False), None),
                                      (dict(vis_every=1, no_vis=False), None),
                                      (dict(num_devices=2), ValueError),
                                      (dict(learning_rate=1e-3), ValueError)],
                         ids=["vis", "vis_every", "num_devices", "unknown"])
def test_test_refuses_before_any_work(monkeypatch, tmp_path, kw, error):
    r"""Unknown options, and ``num_devices`` > 1 in one process without a
    group (one process runs one device), raise before any work. Visualisation,
    refused here until it was ported, now writes each model's videos
    (``vis_every`` is a training option, which ``test`` ignores)."""
    monkeypatch.setattr(SETTINGS, "_run_path", tmp_path)
    suite = VPSuite(device="cpu")
    suite.load_dataset("MMF", **MMF)
    suite.create_model("convlstm-shi")
    before = _launches()
    if error is None:
        suite.test(**{**TEST, "metrics": ["mse"], "n_vis": 1, **kw})
        (run_dir,) = (tmp_path / "output").iterdir()
        assert {"vis_0_EF-ConvLSTM_(Shi_et_al.).gif", "vis_0_CopyLastFrame.gif",
                "vis_info.txt"} <= {p.name for p in run_dir.iterdir()}
        assert _launches() == before
        return
    with pytest.raises(error):
        suite.test(**{**TEST, **kw})
    assert not (tmp_path / "output").exists() and _launches() == before


def test_each_horizon_keeps_its_own_metrics(monkeypatch, tmp_path):
    r"""The per-horizon means take each horizon's own keys, so FVD, which
    has values from 9 frames on, reaches the results at those horizons (the
    JAX package takes every horizon's keys from the first, which drops it);
    a provider that returns fixed dicts shows the aggregation."""
    class Provider:
        def __init__(self, config):
            self.n = 0

        def get_metrics(self, pred, target, all_frame_cnts=False):
            self.n += 1
            return [{"mse (↓)": float(self.n)}, {"mse (↓)": 2.0 * self.n, "fvd (↓)": 10.0 * self.n}]

    monkeypatch.setattr(SETTINGS, "_run_path", tmp_path)
    monkeypatch.setattr(port_vpsuite, "PredictionMetricProvider", Provider)
    suite = VPSuite(device="cpu")
    suite.load_dataset("MMF", **{**MMF, "n_seqs": 2})
    suite.create_model("convlstm-shi")
    (results,) = suite.test(**TEST)
    # one provider for the test set, called per batch and model: EF-ConvLSTM
    # on calls 1 and 3, CopyLastFrame on calls 2 and 4
    assert results["EF-ConvLSTM (Shi et al.)"] == [{"mse (↓)": 2.0},
                                                   {"mse (↓)": 4.0, "fvd (↓)": 20.0}]
    assert results["CopyLastFrame"] == [{"mse (↓)": 3.0}, {"mse (↓)": 6.0, "fvd (↓)": 30.0}]


def test_test_needs_a_model_and_a_test_set():
    suite = VPSuite(device="cpu")
    with pytest.raises(RuntimeError, match="No model"):
        suite.test(**TEST)
    suite.load_dataset("MMF", img_size=16, digit_source="synthetic", n_seqs=4)
    suite.create_model("convlstm-shi")
    with pytest.raises(ValueError, match="No test sets"):
        suite.test(**TEST)


def test_resize_adapter_bridges_image_sizes(monkeypatch, tmp_path):
    r"""A 16x16 model on a 32x32 test set: the inputs are resized to the
    model's size and the predictions back (``ResizeAdapter``); without a
    strict check, as the JAX package's ``test`` does."""
    monkeypatch.setattr(SETTINGS, "_run_path", tmp_path)
    suite = VPSuite(device="cpu")
    suite.load_dataset("MMF", **{**MMF, "img_size": 32, "n_seqs": 1})
    suite.create_model("convlstm-shi", img_shape=(3, 16, 16), action_size=0,
                       tensor_value_range=(0.0, 1.0))
    (results,) = suite.test(**{**TEST, "metrics": ["mse"]})
    assert len(results["EF-ConvLSTM (Shi et al.)"]) == 2
    assert all(np.isfinite(d["mse (↓)"]) for d in results["EF-ConvLSTM (Shi et al.)"])
