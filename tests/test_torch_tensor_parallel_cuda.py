r"""Tensor parallelism's N-D mesh on a CUDA card: a world of one process over
NCCL on the mesh ``{"data": 1, "sp": 1, "tp": 1}``.

These tests need an NVIDIA card and skip without one. They import neither
JAX nor the JAX package, so they run on a machine that has neither:

    python -m pytest tests/test_torch_tensor_parallel_cuda.py -q --noconftest -p no:cacheprovider

EF-ConvLSTM at 16x16, 2 -> 2, b=4, f32, per step (K1, K2) and fused (K3s,
K4; K3 in ``predict``): the SGD step and ``predict`` in the group launch
exactly the kernels they launch without it, and the parameters after the
step are bit-identical to the step's without a group (cuDNN's deterministic
algorithms). The two-process and four-process tp worlds on the card are
``chip_smoke.py``'s ``drive_tensor_parallel``.
"""
import importlib.util
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.cuda

WORKER = Path(__file__).resolve().parent / "helpers" / "torch_tp_worker.py"
_spec = importlib.util.spec_from_file_location("torch_tp_worker", WORKER)
W = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(W)


@pytest.fixture(scope="module")
def card_one(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = tmp_path_factory.mktemp("card_one")
    world = W.P.World("card_one", out, size=1, timeout=300, script=WORKER)
    world.wait()
    return torch.load(out / "card_one.pt", weights_only=False)


@pytest.mark.parametrize("path", list(W.PATHS))
def test_world_of_one_launches_exactly(card_one, path):
    assert card_one["backend"] == "nccl"
    grouped, alone = card_one[(path, True)], card_one[(path, False)]
    assert grouped["train"] == alone["train"] and grouped["predict"] == alone["predict"]
    want = {"per_step": ("K1", "K2"), "fused": ("K3s", "K4")}[path]
    assert all(grouped["train"][k] > 0 for k in want), grouped["train"]
    assert grouped["predict"]["K1" if path == "per_step" else "K3"] > 0


@pytest.mark.parametrize("path", list(W.PATHS))
def test_world_of_one_step_is_bit_identical(card_one, path):
    grouped, alone = card_one[(path, True)]["params"], card_one[(path, False)]["params"]
    for k, v in alone.items():
        assert torch.equal(grouped[k], v), k
