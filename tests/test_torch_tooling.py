r"""The rest of the facade's tooling against the JAX package's:

- ``measure/convert_weights.py``: on synthetic torch state dicts of I3D's and
  LPIPS's names, the port's ``.npz`` files are byte for byte the JAX
  converter's (the zip entries' clock held fixed), through the functions and
  the command line's flags; the port's measures load them.
- ``resources/set_run_path.py``: the run directory moves and the new path is
  recorded, as the JAX script does it.
- ``VPSuite.download_dataset``: runs the dataset's preparation (stored Moving
  MNIST, generated), and raises where the JAX package's needs the network.
- ``profile_dir``: a Chrome trace of the second epoch's training loop alone.
"""
import json
import time
import types
import zipfile

import numpy as np
import pytest
import torch

import vp_suite_tpu.measure.convert_weights as jax_convert
import vp_suite_tpu.resources.set_run_path as jax_set_run_path
import vp_suite_tpu_torch.measure.convert_weights as convert
import vp_suite_tpu_torch.resources.set_run_path as set_run_path
from vp_suite_tpu.defaults import SETTINGS as JAX_SETTINGS
from vp_suite_tpu_torch import VPSuite
from vp_suite_tpu_torch.defaults import SETTINGS

torch.set_num_threads(1)

I3D_CONVS = ["Conv3d_1a_7x7", "Conv3d_2b_1x1", "Conv3d_2c_3x3"] + [
    f"{m}.{b}" for m in ["Mixed_3b", "Mixed_3c", "Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e",
                         "Mixed_4f", "Mixed_5b", "Mixed_5c"]
    for b in ["b0", "b1a", "b1b", "b2a", "b2b", "b3b"]]


def _i3d_state_dict():
    g = torch.Generator().manual_seed(0)
    sd = {}
    for name in I3D_CONVS:
        sd[f"{name}.conv3d.weight"] = torch.randn(4, 3, 1, 2, 2, generator=g)
        for stat in ("running_mean", "running_var", "weight", "bias"):
            sd[f"{name}.bn.{stat}"] = torch.randn(4, generator=g)
    sd["logits.conv3d.weight"] = torch.randn(5, 4, 1, 1, 1, generator=g)
    sd["logits.conv3d.bias"] = torch.randn(5, generator=g)
    return sd


def _lpips_state_dict():
    g = torch.Generator().manual_seed(1)
    sd = {}
    for i, idx in enumerate([0, 3, 6, 8, 10]):
        sd[f"features.{idx}.weight"] = torch.randn(6, 3, 3, 3, generator=g)
        sd[f"features.{idx}.bias"] = torch.randn(6, generator=g)
        sd[f"lin{i}.model.1.weight"] = torch.randn(1, 6, 1, 1, generator=g)
    return sd


@pytest.fixture
def fixed_zip_clock(monkeypatch):
    r"""``np.savez`` stamps each zip entry with the time of writing: hold it
    fixed, so that two files written a second apart can be equal."""
    monkeypatch.setattr(zipfile, "time", types.SimpleNamespace(
        time=lambda: 1.7e9, localtime=time.localtime))


@pytest.mark.parametrize("net", ["i3d", "lpips"])
def test_converted_weights_are_jax_bytes(tmp_path, monkeypatch, fixed_zip_clock, net):
    sd = _i3d_state_dict() if net == "i3d" else _lpips_state_dict()
    torch.save(sd, tmp_path / "ckpt.pt")
    getattr(jax_convert, f"convert_{net}")(tmp_path / "ckpt.pt", tmp_path / "jax.npz")
    getattr(convert, f"convert_{net}")(tmp_path / "ckpt.pt", tmp_path / "port.npz")
    assert (tmp_path / "port.npz").read_bytes() == (tmp_path / "jax.npz").read_bytes()
    monkeypatch.setattr(convert, "RESOURCES", tmp_path / "resources")
    convert.main([f"--{net}", str(tmp_path / "ckpt.pt")])
    (written,) = (tmp_path / "resources").iterdir()
    assert written.read_bytes() == (tmp_path / "jax.npz").read_bytes()


def test_converted_lpips_weights_load_in_the_port(tmp_path, monkeypatch):
    r"""The port's LPIPS net reads the converted file as pretrained."""
    from vp_suite_tpu_torch.measure import lpips_net
    torch.save(_lpips_state_dict(), tmp_path / "ckpt.pt")
    convert.convert_lpips(tmp_path / "ckpt.pt", tmp_path / "lpips.npz")
    monkeypatch.setattr(lpips_net, "_WEIGHTS_FP", tmp_path / "lpips.npz")
    params, pretrained = lpips_net._load_params()
    assert pretrained
    sd = _lpips_state_dict()
    np.testing.assert_array_equal(np.asarray(params["conv0_kernel"]),
                                  sd["features.0.weight"].numpy().transpose(2, 3, 1, 0))
    np.testing.assert_array_equal(np.asarray(params["lin4"]),
                                  sd["lin4.model.1.weight"].numpy().reshape(-1))


def test_convert_without_flags_does_nothing(capsys):
    convert.main([])
    assert "nothing to do" in capsys.readouterr().out


def test_set_run_path_moves_the_run_directory_as_jax(tmp_path, monkeypatch):
    for name, module, settings in (("port", set_run_path, SETTINGS),
                                   ("jax", jax_set_run_path, JAX_SETTINGS)):
        old, new = tmp_path / name / "old", tmp_path / name / "sub" / "new"
        (old / "output").mkdir(parents=True)
        (old / "output" / "a.txt").write_text(name)
        config = tmp_path / name / "local_config.json"
        monkeypatch.setattr(type(settings), "LOCAL_CONFIG_FP", str(config))
        for attr in (("_run_path",) if name == "port" else
                     ("RUN_PATH", "OUT_PATH", "DATA_PATH", "LOG_PATH")):
            monkeypatch.setattr(settings, attr, old)
        monkeypatch.setattr(module, "timed_input", lambda prompt, default=None, secs=60,
                            _new=str(new): _new)
        module.main()
        assert not old.exists() and (new / "output" / "a.txt").read_text() == name
        assert settings.RUN_PATH == new
        assert json.loads(config.read_text()) == {"run_path": str(new)}
        monkeypatch.setattr(module, "timed_input", lambda prompt, default=None, secs=60: None)
        module.main()
        assert settings.RUN_PATH == new


def test_download_dataset(tmp_path, monkeypatch):
    from vp_suite_tpu_torch.datasets import mmnist
    answers = {"Number of frames per sequence": 6, "Pixel size of digit in frame": 28,
               "Digits per image": 2, "Number of training sequences": 2,
               "Number of test sequences": 1}
    monkeypatch.setattr(mmnist, "timed_input", lambda prompt, default=None: answers[prompt])
    monkeypatch.setattr(mmnist.MovingMNISTDataset, "default_data_dir",
                        classmethod(lambda cls: tmp_path))
    suite = VPSuite(device="cpu")
    suite.download_dataset("MM")
    assert sorted(p.name for p in tmp_path.iterdir())
    ds = mmnist.MovingMNISTDataset("train", data_dir=str(tmp_path))
    ds.set_seq_len(2, 4, 1)
    assert len(ds) == 2
    with pytest.raises(NotImplementedError, match="JAX package"):
        suite.download_dataset("BAIR")


def test_profile_dir_traces_the_second_epoch(tmp_path, monkeypatch):
    monkeypatch.setattr(SETTINGS, "_run_path", tmp_path)
    suite = VPSuite(device="cpu")
    suite.load_dataset("MMF", img_size=16, digit_source="synthetic",
                       n_seqs={"train": 4, "val": 2, "test": 2})
    suite.create_model("convlstm-shi")
    suite.train(epochs=3, batch_size=2, context_frames=2, pred_frames=2, steps_per_epoch=1,
                no_vis=True, no_wandb=True, out_dir=str(tmp_path / "run"),
                profile_dir=str(tmp_path / "prof"))
    (trace,) = (tmp_path / "prof").iterdir()
    assert trace.name == "trace_epoch_002.json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::convolution") for e in events)
    assert any("convlstm_gate_forward" in e.get("name", "") for e in events)
