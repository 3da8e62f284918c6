r"""The port's kernels on a CUDA card, against their plain versions.

These tests need an NVIDIA card with ``nvcc`` and Triton, and skip without
one. They import neither JAX nor the JAX package, so they run on a machine
that has neither:

    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest -p no:cacheprovider

Tolerances: f32 with TF32 off, 1e-5 for the gate block and its backward (same
formula) and 1e-4 for the scan and its backward (sums in another order); bf16
scan 3e-2, since ``h`` is rounded every step and a one-ulp flip feeds the next
steps; bf16 scan backward 1% of the largest gradient of each kind, since
``dz`` is rounded to bf16 every step (a flipped rounding is 0.4% of the value)
and flips feed the earlier steps through the transposed conv.
"""
import numpy as np
import pytest
import torch

from vp_suite_tpu_torch import VPSuite
from vp_suite_tpu_torch.ops.cells import (convlstm_gate_backward, convlstm_gate_backward_reference,
                                          convlstm_gate_fuse, convlstm_gate_reference)
from vp_suite_tpu_torch.ops.convlstm import (convlstm_scan_backward,
                                             convlstm_scan_backward_reference, convlstm_scan_forward,
                                             convlstm_scan_forward_reference, convlstm_scan_fused,
                                             convlstm_scan_reference)
from vp_suite_tpu_torch.training.loop import make_train_step
from vp_suite_tpu_torch.training.train_state import create_train_state

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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


def _gate_args(rng, cuda, dtype, grads=False):
    b, h, w, c = 2, 16, 16, 32
    args = [_randn(rng, b, h, w, 4 * c), _randn(rng, b, h, w, c)] \
        + [_randn(rng, h, w, c, scale=0.5) for _ in range(3)]
    if grads:
        args += [_randn(rng, b, h, w, c), _randn(rng, b, h, w, c)]
    return [a.to(cuda, dtype) for a in args]


def _scan_args(rng, cuda, dtype, with_x, t=3, b=2, sh=12, sw=20, enc=32):
    r"""Ragged tiles on both spatial axes (sh != sw) and a weight with no symmetry."""
    args = [_randn(rng, t, b, sh, sw, 4 * enc, scale=0.3) if with_x else None,
            _randn(rng, b, sh, sw, enc, scale=0.3), _randn(rng, b, sh, sw, enc, scale=0.3),
            _randn(rng, 3, 3, enc, 4 * enc, scale=(9 * enc) ** -0.5),
            _randn(rng, 4 * enc, scale=0.1)] + [_randn(rng, sh, sw, enc, scale=0.1) for _ in range(3)]
    return [None if a is None else a.to(cuda, torch.float32 if i == 4 else dtype)
            for i, a in enumerate(args)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gate_backward_kernel_matches_reference(cuda, dtype):
    args = _gate_args(np.random.default_rng(3), cuda, dtype, grads=True)
    before = convlstm_gate_backward.launches
    got = convlstm_gate_backward(*args)
    torch.cuda.synchronize()
    assert convlstm_gate_backward.launches == before + 1
    atol = 1e-5 if dtype == torch.float32 else 2 ** -6
    for g, want in zip(got, convlstm_gate_backward_reference(*args)):
        assert g.dtype == dtype and g.shape == want.shape
        torch.testing.assert_close(g.float(), want.float(), rtol=2 ** -7, atol=atol)


@pytest.mark.parametrize("with_x", [False, True], ids=["decode", "with_i2h"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_scan_residuals_match_reference(cuda, dtype, with_x):
    args = _scan_args(np.random.default_rng(4), cuda, dtype, with_x)
    plain_seq, _ = convlstm_scan_forward(*args, seq_len=3)
    before = convlstm_scan_fused.save_gates_launches
    seq, c_last, z, c_prev = convlstm_scan_forward(*args, seq_len=3, save_gates=True)
    torch.cuda.synchronize()
    assert convlstm_scan_fused.save_gates_launches == before + 1
    assert torch.equal(seq, plain_seq)   # saving the residuals leaves h_seq bit for bit
    rseq, rc, rz, rc_prev = convlstm_scan_forward_reference(*args, seq_len=3, save_gates=True)
    atol = 1e-4 if dtype == torch.float32 else 3e-2
    for got, want in ((seq, rseq), (c_last, rc), (z, rz), (c_prev, rc_prev)):
        assert got.dtype == dtype and got.shape == want.shape
        torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


def _close_to_largest(got, want, rel):
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_scan_backward_kernel_matches_reference(cuda, dtype):
    rng = np.random.default_rng(5)
    args = _scan_args(rng, cuda, dtype, with_x=True)
    _, _, z, c_prev = convlstm_scan_forward(*args, seq_len=3, save_gates=True)
    dh_seq = _randn(rng, *c_prev.shape).to(cuda, dtype)
    dc_last = _randn(rng, *c_prev.shape[1:]).to(cuda, dtype)
    bwd_args = (z, c_prev, dh_seq, dc_last, args[3], *args[5:])
    before = convlstm_scan_backward.launches
    got = convlstm_scan_backward(*bwd_args)
    torch.cuda.synchronize()
    assert convlstm_scan_backward.launches == before + 1
    want = convlstm_scan_backward_reference(*bwd_args)
    for g, w, dt in zip(got, want, (dtype, torch.float32, torch.float32)):
        assert g.dtype == dt and g.shape == w.shape
        _close_to_largest(g, w, 1e-4 if dtype == torch.float32 else 1e-2)


def test_autograd_through_the_kernels_matches_the_plain_versions(cuda):
    r"""On CUDA tensors the kernels' wrappers are differentiable: every input
    gets the gradient that autograd gives through the plain versions, and
    c0's gradient is the walk's, not a copy of c_last's."""
    rng = np.random.default_rng(6)
    gate = [a.requires_grad_() for a in _gate_args(rng, cuda, torch.float32)]
    weights = [_randn(rng, *a.shape).to(cuda) for a in gate[:2]]
    grads = []
    for fn in (convlstm_gate_fuse, convlstm_gate_reference):
        h, c = fn(*gate)
        grads.append(torch.autograd.grad((h * weights[0][..., :h.shape[-1]]).sum()
                                         + (c * weights[1]).sum(), gate))
    for g, want in zip(*grads):
        assert g is not None
        torch.testing.assert_close(g, want, rtol=1e-5, atol=1e-5)

    for with_x in (False, True):
        args = [None if a is None else a.requires_grad_()
                for a in _scan_args(rng, cuda, torch.float32, with_x)]
        r_seq = _randn(rng, *args[1].shape).to(cuda)
        r_c = _randn(rng, *args[1].shape).to(cuda)
        inputs = [a for a in args if a is not None]
        grads = []
        for fn in (convlstm_scan_fused, convlstm_scan_reference):
            seq, (h, c) = fn(*args, seq_len=3)
            loss = (seq * r_seq).sum() + (h * h).sum() + (c * r_c).sum()
            grads.append(torch.autograd.grad(loss, inputs))
        for g, want in zip(*grads):
            assert g is not None
            _close_to_largest(g, want, 1e-4)
        dc0 = grads[0][2 if with_x else 1]
        assert dc0.shape == r_c.shape and not torch.allclose(dc0, r_c)


@pytest.mark.parametrize("cfg", [{}, dict(use_fused_scan=True, interleaved_encode=False,
                                          interleaved_forecast=False)],
                         ids=["per_step", "fused_scan"])
def test_sgd_step_on_the_card_matches_the_cpu(cuda, cfg):
    kw = dict(img_shape=(3, 16, 16), action_size=0, tensor_value_range=(0.0, 1.0), seed=7,
              enc_c=(16, 16, 16, 32, 32, 32), dec_c=(32, 32, 32, 32, 16, 16), **cfg)
    frames = torch.from_numpy(np.random.default_rng(8).random((2, 5, 16, 16, 3), dtype=np.float32))
    run_config = {"context_frames": 3, "pred_frames": 2}
    lr = 1e-2
    steps = {}
    for device in ("cuda", "cpu"):
        model = VPSuite(device=device).create_model("convlstm-shi", **kw).model
        p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
        state = create_train_state(model, lr=lr, optimizer="sgd")
        _, metrics = make_train_step(model, run_config)(state, {"frames": frames.to(device)})
        steps[device] = (float(metrics["total"]),
                         {k: ((p0[k] - v.detach()) / lr).cpu() for k, v in model.named_parameters()})
    assert abs(steps["cuda"][0] - steps["cpu"][0]) <= 1e-4 * abs(steps["cpu"][0])
    for k, want in steps["cpu"][1].items():
        torch.testing.assert_close(steps["cuda"][1][k], want, rtol=5e-4, atol=5e-4, msg=k)
