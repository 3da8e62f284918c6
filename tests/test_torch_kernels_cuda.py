r"""The port's kernels on a CUDA card, against their plain versions.

These tests need an NVIDIA card with ``nvcc`` and Triton, and skip without
one. They import neither JAX nor the JAX package, so they run on a machine
that has neither:

    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest -p no:cacheprovider

Tolerances: f32 with TF32 off, 1e-5 for the gate block (same formula) and
1e-4 for the scan (sums in another order); bf16 scan 3e-2, since ``h`` is
rounded every step and a one-ulp flip feeds the next steps.
"""
import numpy as np
import pytest
import torch

from vp_suite_tpu_torch import VPSuite
from vp_suite_tpu_torch.ops.cells import convlstm_gate_fuse, convlstm_gate_reference
from vp_suite_tpu_torch.ops.convlstm import convlstm_scan_fused, convlstm_scan_reference

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gate_kernel_matches_reference(cuda, dtype):
    rng = np.random.default_rng(0)
    b, h, w, c = 2, 16, 16, 32
    args = [_randn(rng, b, h, w, 4 * c), _randn(rng, b, h, w, c)] \
        + [_randn(rng, h, w, c, scale=0.5) for _ in range(3)]
    args = [a.to(cuda, dtype) for a in args]
    before = convlstm_gate_fuse.launches
    got = convlstm_gate_fuse(*args)
    torch.cuda.synchronize()
    assert convlstm_gate_fuse.launches == before + 1
    atol = 1e-5 if dtype == torch.float32 else 2 ** -6   # 2 bf16 ulps at |x| < 2
    for g, want in zip(got, convlstm_gate_reference(*args)):
        assert g.dtype == dtype
        torch.testing.assert_close(g.float(), want.float(), rtol=2 ** -7, atol=atol)


@pytest.mark.parametrize("with_x", [False, True], ids=["decode", "with_i2h"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_scan_kernel_matches_reference(cuda, dtype, with_x):
    rng = np.random.default_rng(1)
    t, b, sh, sw, enc = 3, 2, 12, 20, 32    # ragged tiles on both spatial axes
    args = [_randn(rng, t, b, sh, sw, 4 * enc, scale=0.3) if with_x else None,
            _randn(rng, b, sh, sw, enc, scale=0.3), _randn(rng, b, sh, sw, enc, scale=0.3),
            _randn(rng, 3, 3, enc, 4 * enc, scale=(9 * enc) ** -0.5), _randn(rng, 4 * enc, scale=0.1)] \
        + [_randn(rng, sh, sw, enc, scale=0.1) for _ in range(3)]
    args = [None if a is None else a.to(cuda, torch.float32 if i == 4 else dtype)
            for i, a in enumerate(args)]
    before = convlstm_scan_fused.launches
    seq, (h, c) = convlstm_scan_fused(*args, seq_len=t)
    torch.cuda.synchronize()
    assert convlstm_scan_fused.launches == before + 1
    rseq, (rh, rc) = convlstm_scan_reference(*args, seq_len=t)
    atol = 1e-4 if dtype == torch.float32 else 3e-2
    for got, want in ((seq, rseq), (h, rh), (c, rc)):
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


def test_scan_kernel_rejects_what_it_does_not_take(cuda):
    args = [None, torch.zeros(1, 8, 8, 8, device=cuda), torch.zeros(1, 8, 8, 8, device=cuda),
            torch.zeros(3, 3, 8, 32, device=cuda), torch.zeros(32, device=cuda)] \
        + [torch.zeros(8, 8, 8, device=cuda) for _ in range(3)]
    with pytest.raises(ValueError, match="multiple of 16"):
        convlstm_scan_fused(*args, seq_len=2)


@pytest.mark.parametrize("cfg", [{}, dict(use_fused_scan=True, interleaved_encode=False,
                                          interleaved_forecast=False)],
                         ids=["per_step", "fused_scan"])
def test_predict_on_the_card_matches_the_cpu(cuda, cfg):
    kw = dict(img_shape=(3, 16, 16), action_size=0, tensor_value_range=(0.0, 1.0), seed=5,
              enc_c=(16, 16, 16, 32, 32, 32), dec_c=(32, 32, 32, 32, 16, 16), **cfg)
    frames = np.random.default_rng(2).random((2, 3, 16, 16, 3)).astype(np.float32)
    card, host = VPSuite(), VPSuite(device="cpu")
    card.create_model("convlstm-shi", **kw)
    host.create_model("convlstm-shi", **kw)
    got = card.predict(frames, pred_frames=4)
    assert got.device.type == "cuda" and got.shape == (2, 4, 16, 16, 3)
    torch.testing.assert_close(got.cpu(), host.predict(frames, pred_frames=4),
                               rtol=0, atol=1e-4)
