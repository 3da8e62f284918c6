r"""The port's public checkpoint entry points run on the card unless the
caller asks for the CPU, as ``VPSuite()`` does: ``load_checkpoint`` and
``model_from_config`` raise without a CUDA device by default, and with
``device="cpu"`` rebuild the saved model exactly.
"""
import pytest
import torch

from vp_suite_tpu_torch.checkpoint import load_checkpoint, model_from_config, save_checkpoint
from vp_suite_tpu_torch.models import build_model
from vp_suite_tpu_torch.training.train_state import create_train_state

torch.set_num_threads(1)

KWARGS = dict(img_shape=(3, 16, 16), action_size=0, tensor_value_range=(0.0, 1.0))


@pytest.fixture
def ckpt(tmp_path):
    model = build_model("convlstm-shi", 5, "cpu", **KWARGS)
    state = create_train_state(model, lr=1e-3)
    state.step = 3
    save_checkpoint(tmp_path / "ckpt", state, "convlstm-shi", model.config)
    return tmp_path / "ckpt", model


def test_checkpoint_entry_points_default_to_the_card(ckpt, monkeypatch):
    path, model = ckpt
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="load_checkpoint: no CUDA device"):
        load_checkpoint(path)
    with pytest.raises(RuntimeError, match="model_from_config: no CUDA device"):
        model_from_config("convlstm-shi", model.config)
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        load_checkpoint(path, device="meta")


def test_checkpoint_loads_on_the_cpu_when_asked(ckpt):
    path, model = ckpt
    loaded, state, model_id = load_checkpoint(path, device="cpu")
    assert model_id == "convlstm-shi" and state.step == 3
    want = model.state_dict()
    got = loaded.state_dict()
    assert list(got) == list(want)
    for k in want:
        assert got[k].device.type == "cpu"
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    fresh = model_from_config("convlstm-shi", model.config, device="cpu")
    assert next(fresh.parameters()).device.type == "cpu"
    assert fresh.config == model.config
