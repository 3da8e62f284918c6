r"""Data-parallel training of the port on a CUDA card: the two-process step
of ``tests/test_torch_parallel.py`` with both processes on card 0 over gloo,
and the facade in a world of one over NCCL.

These tests need an NVIDIA card and skip without one. They import neither
JAX nor the JAX package, so they run on a machine that has neither:

    python -m pytest tests/test_torch_parallel_cuda.py -q --noconftest -p no:cacheprovider

- Two processes, each with half of the b=4 batch (16x16, 2 -> 2, f32), one
  SGD step of EF-ConvLSTM per step (K1, K2) and fused under FSDP (K3s, K4):
  the processes' replicated parameters are equal, and with the sharded ones
  joined from both processes' rows (``DTensor.full_tensor`` crashes gloo on
  CUDA tensors) they match the one-process step on the whole batch on the
  card as ``(p0 - p1) / lr`` within 5e-4 relative plus 5e-4
  (``chip_smoke.py``'s SGD gate), the loss within 1e-5 relative; each process
  launches the kernels the one-process step launches.
- ``VPSuite.train(multihost=True, fsdp=True, ckpt_backend="orbax")`` at b=8
  on the fused path in f32 in a world of one, and the same run without a
  group, under cuDNN's deterministic algorithms: parameters within 1e-6 of
  each other, relative to each tensor's largest.
"""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

WORKER = Path(__file__).resolve().parent / "helpers" / "torch_parallel_worker.py"
_spec = importlib.util.spec_from_file_location("torch_parallel_worker", WORKER)
W = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(W)
STEP_TOL = 5e-4


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_two_processes_on_one_card_match_one_process(card, tmp_path):
    world = W.World("card_pair", tmp_path, size=2, timeout=300)
    world.wait()
    ranks = [torch.load(tmp_path / f"card_pair_{r}.pt", weights_only=False) for r in range(2)]
    for path in ("per_step", "fused"):
        got = [ranks[r][path] for r in range(2)]
        assert bool(got[0]["sharded"]) == (path == "fused")
        for k, v in got[0]["state_dict"].items():
            if k in got[0]["sharded"]:   # FSDP2's dim-0 chunks, one a process
                got[0]["state_dict"][k] = torch.cat([v, got[1]["state_dict"][k]])
            else:
                assert torch.equal(v, got[1]["state_dict"][k]), f"{path}: {k} differs"
        model, p0, loss, launches = W.card_step(path, "cuda")
        assert got[0]["launches"] == got[1]["launches"] == launches, (path, launches)
        assert sum(launches.values()) > 0, path
        np.testing.assert_allclose(got[0]["loss"], loss, rtol=1e-5)
        for k, v in model.named_parameters():
            want = (p0[k] - v.detach().cpu()) / W.LR
            mine = (p0[k] - got[0]["state_dict"][k]) / W.LR
            excess = ((mine - want).abs() - STEP_TOL * want.abs()).max().item()
            assert excess <= STEP_TOL, f"{path}: {k}"


def test_facade_in_a_world_of_one_equals_the_run_without_a_group(card, tmp_path):
    world = W.World("card_facade", tmp_path, size=1, timeout=300)
    world.wait()
    rel = json.loads((tmp_path / "card_facade.json").read_text())["rel"]
    assert rel <= 1e-6, rel
