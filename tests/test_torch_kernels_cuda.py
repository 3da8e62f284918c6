r"""The port's kernels on a CUDA card, against their plain versions.

These tests need an NVIDIA card with ``nvcc`` and Triton, and skip without
one. They import neither JAX nor the JAX package, so they run on a machine
that has neither:

    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest -p no:cacheprovider

Tolerances: f32 with TF32 off, 1e-5 for the gate block and its backward (same
formula) and 1e-4 for the scan and its backward (sums in another order); bf16
scan 3e-2 (at every hidden-channel block and stage count the bf16 kernel
picks), since ``h`` is rounded every step and a one-ulp flip feeds the next
steps; bf16 scan backward (with a nonzero gradient of ``h_last``, at every
output-channel block the bf16 kernel picks) 1% of the largest gradient of
each kind, since ``dz`` is rounded to bf16 every step (a flipped rounding is
0.4% of the value) and flips feed the earlier steps through the transposed
conv. The warp:
f32 1e-5 (the same f32 formula, sums in another order); bf16 outputs within
one bf16 ulp plus 1e-5 (both round one f32 result); its gradients 1e-5 of the
largest of each kind, and in bf16 ``d_img`` within 2^-7 + 1e-5 of its largest
(one bf16 ulp of the largest: both round an f32 sum, which the kernel's
atomics take in an order that varies by run). The fused warp + ``ret`` (K8)
and the factor contraction (K9), relative to the largest of each kind: f32
1e-5 (K8) and 5e-5 (K9), sums in another order; bf16 2^-6, since both sides
round each result once and a sum taken in another order flips some roundings
(and K9's kernel rounds the factor product, as the TPU kernel does).

The measures run with PyTorch's default TF32 flags (cuDNN's on), which they
turn off around their own convolutions and matmuls: MSE, L1, SmoothL1, PSNR
and SSIM within 1e-5 relative of the CPU (the same f32 formulas, sums in
another order), LPIPS and FVD within MEASURE_RTOL.
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
from vp_suite_tpu_torch.defaults import SETTINGS
from vp_suite_tpu_torch.kernels import build, k8_variants, k9_variants, warp_fwd_variants
from vp_suite_tpu_torch.measure import METRIC_CLASSES
from vp_suite_tpu_torch.kernels.warp_bwd_variants import geometry, out_of_band_share
from vp_suite_tpu_torch.ops.grid_sample import _flow_to_indices, _onehot_factor, grid_sample
from vp_suite_tpu_torch.ops.warp import (warp_contract, warp_contract_backward,
                                         warp_contract_backward_reference, warp_contract_forward,
                                         warp_contract_reference, warp_ret, warp_ret_backward,
                                         warp_ret_backward_reference, warp_ret_forward,
                                         warp_ret_reference, warp_sample, warp_sample_backward,
                                         warp_sample_backward_reference, warp_sample_forward,
                                         warp_sample_reference)
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


@pytest.fixture()
def cuda_default_tf32():
    r"""The card, with PyTorch's default TF32 flags (cuDNN's on, cuBLAS's
    off) while the test runs; the flags are restored after it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32, matmul.allow_tf32 = True, False
    yield torch.device("cuda")
    cudnn.allow_tf32, matmul.allow_tf32 = saved


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
    # bf16 keeps a block's weights resident: above enc=288 they do not fit
    enc = 304
    wide = [None] + [torch.zeros(*s, device=cuda, dtype=torch.bfloat16)
                     for s in ((1, 4, 4, enc), (1, 4, 4, enc), (3, 3, enc, 4 * enc))] \
        + [torch.zeros(4 * enc, device=cuda)] \
        + [torch.zeros(4, 4, enc, device=cuda, dtype=torch.bfloat16) for _ in range(3)]
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        convlstm_scan_forward(*wide, seq_len=1)


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


#: (T, sh, sw, enc) of the forward scan: sh and sw not multiples of the 16x4
#: (f32) or 16x8 (bf16) pixel tile, every hidden-channel block the bf16 kernel
#: picks (enc 32 and 64 take 32, 48 and 96 take 24, 16 takes 16, 208 takes 8),
#: a half last stage of h channels (enc 16, 48 and 208), three stages (96) and
#: a single step.
SCAN_FWD_SHAPES = [(3, 12, 20, 32), (1, 9, 17, 16), (2, 10, 18, 48), (2, 10, 18, 64),
                   (2, 7, 13, 96), (1, 5, 6, 208)]


@pytest.mark.parametrize("shape", SCAN_FWD_SHAPES, ids=lambda s: "T{}_{}x{}x{}".format(*s))
@pytest.mark.parametrize("with_x", [False, True], ids=["decode", "with_i2h"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_scan_residuals_match_reference(cuda, dtype, with_x, shape):
    t, sh, sw, enc = shape
    args = _scan_args(np.random.default_rng(4), cuda, dtype, with_x, t=t, sh=sh, sw=sw, enc=enc)
    plain_seq, plain_c = convlstm_scan_forward(*args, seq_len=t)
    before = convlstm_scan_fused.save_gates_launches
    seq, c_last, z, c_prev = convlstm_scan_forward(*args, seq_len=t, save_gates=True)
    torch.cuda.synchronize()
    assert convlstm_scan_fused.save_gates_launches == before + 1
    # saving the residuals leaves h_seq and c_last bit for bit
    assert torch.equal(seq, plain_seq) and torch.equal(c_last, plain_c)
    rseq, rc, rz, rc_prev = convlstm_scan_forward_reference(*args, seq_len=t, save_gates=True)
    atol = 1e-4 if dtype == torch.float32 else 3e-2
    for got, want in ((seq, rseq), (c_last, rc), (z, rz), (c_prev, rc_prev)):
        assert got.dtype == dtype and got.shape == want.shape
        torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


def _close_to_largest(got, want, rel):
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    assert err <= rel * scale, (err, scale)


#: (T, sh, sw, enc): sh and sw not multiples of the 16x4 (f32) or 16x8 (bf16)
#: pixel tile, every output-channel block the bf16 kernel picks (enc 16 and 32
#: take 16 and 32 channels, 64 takes 32, 96 takes 24), and a single step.
SCAN_BWD_SHAPES = [(3, 12, 20, 32), (1, 9, 17, 16), (2, 10, 18, 64), (2, 7, 13, 96)]


@pytest.mark.parametrize("shape", SCAN_BWD_SHAPES, ids=lambda s: "T{}_{}x{}x{}".format(*s))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_scan_backward_kernel_matches_reference(cuda, dtype, shape):
    t, sh, sw, enc = shape
    rng = np.random.default_rng(5)
    args = _scan_args(rng, cuda, dtype, with_x=True, t=t, sh=sh, sw=sw, enc=enc)
    _, _, z, c_prev = convlstm_scan_forward(*args, seq_len=t, save_gates=True)
    dh_seq = _randn(rng, *c_prev.shape).to(cuda, dtype)
    dc_last = _randn(rng, *c_prev.shape[1:]).to(cuda, dtype)
    dh_last = _randn(rng, *c_prev.shape[1:]).to(cuda, dtype)
    bwd_args = (z, c_prev, dh_seq, dc_last, args[3], *args[5:], dh_last)
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

    # bf16: the plain forward rounds at other places (dh at every step, and
    # h_last's gradient folded into h_seq's in bf16), 2% of the largest.
    for dtype, rel in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        for with_x in (False, True):
            args = [None if a is None else a.requires_grad_()
                    for a in _scan_args(rng, cuda, dtype, with_x)]
            r_seq, r_h, r_c = (_randn(rng, *args[1].shape).to(cuda) for _ in range(3))
            inputs = [a for a in args if a is not None]
            grads = []
            for fn in (convlstm_scan_fused, convlstm_scan_reference):
                seq, (h, c) = fn(*args, seq_len=3)
                loss = (seq.float() * r_seq).sum() + (h.float() * r_h).sum() \
                    + (h.float() * h.float()).sum() + (c.float() * r_c).sum()
                grads.append(torch.autograd.grad(loss, inputs))
            for g, want in zip(*grads):
                assert g is not None
                _close_to_largest(g, want, rel)
            dc0 = grads[0][2 if with_x else 1]
            assert dc0.shape == r_c.shape and not torch.allclose(dc0.float(), r_c)


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



@pytest.mark.parametrize("cfg,want", [
    ({}, dict(K1=4 * 15, K2=15)),
    (dict(use_fused_scan=True, interleaved_encode=False, interleaved_forecast=False),
     dict(K3=2 * 6, K3s=6, K4=6))], ids=["per_step", "fused_scan"])
def test_facade_train_on_the_card_launches_the_kernels(cuda, tmp_path, cfg, want):
    r"""One device-backend ``VPSuite.train`` step (b=2, 3 -> 2 frames, so 15
    cell steps per forward) and its validation over two batches: exactly the
    train step's K1 + K2 (or K3s + K4) and each validation forward's K1 (or
    K3), and no other kernel. The per-step cells' default ``remat_policy``
    (``"gates"``) launches K1 again in the train step's backward: 15 + 15."""
    suite = VPSuite()
    suite.load_dataset("MMF", img_size=16, digit_source="synthetic", backend="device",
                       n_seqs={"train": 8, "val": 4, "test": 4})
    entry = suite.create_model("convlstm-shi", enc_c=(16, 16, 16, 32, 32, 32),
                               dec_c=(32, 32, 32, 32, 16, 16), **cfg)
    counters = {"K1": (convlstm_gate_fuse, "launches"), "K2": (convlstm_gate_backward, "launches"),
                "K3": (convlstm_scan_fused, "launches"),
                "K3s": (convlstm_scan_fused, "save_gates_launches"),
                "K4": (convlstm_scan_backward, "launches"), "warp_fwd": (warp_sample, "launches"),
                "warp_bwd": (warp_sample_backward, "launches")}
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    best = suite.train(epochs=1, batch_size=2, context_frames=3, pred_frames=2,
                       steps_per_epoch=1, no_vis=True, no_wandb=True, out_dir=str(tmp_path))
    torch.cuda.synchronize()
    assert {k: getattr(fn, attr) for k, (fn, attr) in counters.items()} \
        == {k: want.get(k, 0) for k in counters}
    assert np.isfinite(best) and entry.state.step == 1
    loaded = VPSuite().load_model(str(tmp_path), "final_model")
    assert all(torch.equal(a, b) for a, b in zip(loaded.model.state_dict().values(),
                                                 entry.model.state_dict().values()))

def _warp_args(rng, cuda, dtype, b=2, h=12, w=20, c=24, L=3):
    r"""Indices a few pixels off each output pixel, some out of the image;
    c=24 takes the kernel's vector path in both dtypes, c=20 (below) its
    scalar path in bf16."""
    oy = np.repeat(np.arange(h, dtype=np.float32), w)[None, :, None]
    ox = np.tile(np.arange(w, dtype=np.float32), h)[None, :, None]
    iy = oy + rng.normal(0.0, 2.0, (b, h * w, L)) + (rng.random((b, h * w, L)) < 0.1) * h
    ix = ox + rng.normal(0.0, 2.0, (b, h * w, L)) - (rng.random((b, h * w, L)) < 0.1) * w
    return [torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (iy, ix)] \
        + [_randn(rng, b, h, w, c).to(cuda, dtype), _randn(rng, b, h * w, L, c).to(cuda, dtype)]


@pytest.mark.parametrize("c", [24, 20], ids=["vector", "scalar"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_warp_kernels_match_the_plain_versions(cuda, dtype, c):
    iy, ix, img, g = _warp_args(np.random.default_rng(9), cuda, dtype, c=c)
    before = (warp_sample.launches, warp_sample_backward.launches)
    leaves = [a.clone().requires_grad_() for a in (iy, ix, img)]
    out = warp_sample(*leaves)
    out.backward(g)
    torch.cuda.synchronize()
    assert (warp_sample.launches, warp_sample_backward.launches) == (before[0] + 1, before[1] + 1)
    want = warp_sample_reference(iy, ix, img)
    assert out.dtype == dtype and out.shape == want.shape
    ulp = 0 if dtype == torch.float32 else 1
    bound = ulp * torch.exp2(torch.floor(torch.log2(want.float().abs().clamp_min(1e-30))) - 7) + 1e-5
    assert bool(((out.float() - want.float()).abs() <= bound).all())
    want_grads = warp_sample_backward_reference(iy, ix, img, g)
    for a, w in zip(leaves, want_grads):
        assert a.grad.dtype == w.dtype and a.grad.shape == w.shape
        _close_to_largest(a.grad, w, 1e-5 if w.dtype == torch.float32 else 2 ** -7 + 1e-5)


def _check_warp_backward(iy, ix, img, g):
    r"""The backward kernel (one launch) against its plain version, within the
    warp's gradient tolerances; returns the block tiling it ran with."""
    b, P, L = iy.shape
    _, h, w, c = img.shape
    geom = geometry(build.warp_library(), b, P, L, h, w, c, img.dtype == torch.bfloat16)
    before = warp_sample_backward.launches
    got = warp_sample_backward(iy, ix, img, g)
    torch.cuda.synchronize()
    assert warp_sample_backward.launches == before + 1
    for q, want in zip(got, warp_sample_backward_reference(iy, ix, img, g)):
        assert q.dtype == want.dtype and q.shape == want.shape
        _close_to_largest(q, want, 1e-5 if want.dtype == torch.float32 else 2 ** -7 + 1e-5)
    return geom


@pytest.mark.parametrize("c", [24, 20, 72, 6, 5], ids=["c24", "c20", "c72-3-chunks", "c6", "c5"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_warp_backward_band_and_out_of_band_taps(cuda, dtype, c):
    r"""A 40x64 image, whose blocks' bands (the tile's rows and R = 6 above
    and below) are smaller than it, and a fifth of the row offsets 7-12 rows
    away: both the shared window and the global atomics for taps outside it
    take part. c = 24/20/72/6/5 cover whole and ragged channel chunks and every
    vector width (16, 8, 4 and 2 bytes, one channel)."""
    rng = np.random.default_rng(13)
    b, h, w, L = 2, 40, 64, 3
    P = h * w
    oy = np.repeat(np.arange(h, dtype=np.float32), w)[None, :, None]
    ox = np.tile(np.arange(w, dtype=np.float32), h)[None, :, None]
    far = (rng.random((b, P, L)) < 0.2) * rng.choice([-1.0, 1.0], (b, P, L)) \
        * rng.uniform(7.0, 12.0, (b, P, L))
    iy = oy + rng.normal(0.0, 2.0, (b, P, L)) + far
    ix = ox + rng.normal(0.0, 2.0, (b, P, L)) - (rng.random((b, P, L)) < 0.05) * w
    iy, ix = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (iy, ix))
    img = _randn(rng, b, h, w, c).to(cuda, dtype)
    g = _randn(rng, b, P, L, c).to(cuda, dtype)
    geom = _check_warp_backward(iy, ix, img, g)
    assert 0 < geom["rows"] < h
    outside, taps = out_of_band_share(iy, ix, h, w, geom)
    assert 0.05 * taps < outside < 0.5 * taps


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_warp_backward_without_a_window(cuda, dtype):
    r"""So wide an image (w = 1900, 32 channels) that not one row of f32
    accumulators fits in shared memory: every tap goes to global atomics."""
    rng = np.random.default_rng(15)
    b, h, w, c, L = 1, 3, 1900, 32, 1
    P = h * w
    iy = np.repeat(np.arange(h, dtype=np.float32), w)[None, :, None] + rng.normal(0.0, 1.0, (b, P, L))
    ix = np.tile(np.arange(w, dtype=np.float32), h)[None, :, None] + rng.normal(0.0, 3.0, (b, P, L))
    iy, ix = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (iy, ix))
    geom = _check_warp_backward(iy, ix, _randn(rng, b, h, w, c).to(cuda, dtype),
                                _randn(rng, b, P, L, c).to(cuda, dtype))
    assert geom["rows"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_grid_sample_backward_with_p_not_hw(cuda, dtype):
    r"""``grid_sample`` sends the warp P = 10*13 != h*w = 24*40 samples of one
    flow; its gradients on the card against the same call on the CPU (the
    plain backward), with the tiles' bands placed as if the output pixels
    were rows of the image."""
    rng = np.random.default_rng(14)
    b, h, w, c, h_out, w_out = 2, 24, 40, 16, 10, 13
    grid = torch.from_numpy(rng.uniform(-1.1, 1.1, (b, h_out, w_out, 2)).astype(np.float32))
    img = _randn(rng, b, h, w, c).to(dtype)
    g = _randn(rng, b, h_out, w_out, c).to(dtype)
    geom = geometry(build.warp_library(), b, h_out * w_out, 1, h, w, c, dtype == torch.bfloat16)
    assert 0 < geom["rows"] < h
    grads = []
    for device in (cuda, torch.device("cpu")):
        leaves = [a.to(device).requires_grad_() for a in (img, grid)]
        before = warp_sample_backward.launches
        grid_sample(*leaves).backward(g.to(device))
        assert warp_sample_backward.launches == before + (device.type == "cuda")
        grads.append([a.grad.cpu() for a in leaves])
    for q, want in zip(*grads):
        assert q.dtype == want.dtype
        _close_to_largest(q, want, 1e-5 if want.dtype == torch.float32 else 2 ** -7 + 1e-5)


def _assert_warp_close(got, want):
    r"""The warp forward's tolerance: 1e-5 in f32; one bf16 ulp of the value
    plus 1e-5 in bf16."""
    assert got.dtype == want.dtype and got.shape == want.shape
    ulp = 0 if want.dtype == torch.float32 else 1
    bound = ulp * torch.exp2(torch.floor(torch.log2(want.float().abs().clamp_min(1e-30))) - 7) + 1e-5
    assert bool(((got.float() - want.float()).abs() <= bound).all())


def _check_warp_forward(iy, ix, img):
    r"""The forward kernel (one launch) against its plain version; returns the
    block tiling it ran with."""
    b, P, L = iy.shape
    _, h, w, c = img.shape
    geom = warp_fwd_variants.geometry(build.warp_library(), b, P, L, h, w, c,
                                      img.dtype == torch.bfloat16)
    before = warp_sample.launches
    got = warp_sample_forward(iy, ix, img)
    torch.cuda.synchronize()
    assert warp_sample.launches == before + 1
    _assert_warp_close(got, warp_sample_reference(iy, ix, img))
    return geom


@pytest.mark.parametrize("c", [64, 96, 20], ids=["c64", "c96", "c20"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_warp_forward_band_and_out_of_band_taps(cuda, dtype, c):
    r"""A 40x64 image, whose blocks' bands (the tile's rows and R = 6 above
    and below) are smaller than it, a fifth of the row offsets 7-12 rows away
    and some samples out of the image: taps from the band in shared memory
    and from global memory take part. c = 96 in f32 takes two channel passes;
    c = 20 vectors of 8 bytes in bf16."""
    rng = np.random.default_rng(16)
    b, h, w, L = 2, 40, 64, 3
    P = h * w
    oy = np.repeat(np.arange(h, dtype=np.float32), w)[None, :, None]
    ox = np.tile(np.arange(w, dtype=np.float32), h)[None, :, None]
    far = (rng.random((b, P, L)) < 0.2) * rng.choice([-1.0, 1.0], (b, P, L)) \
        * rng.uniform(7.0, 12.0, (b, P, L))
    iy = oy + rng.normal(0.0, 2.0, (b, P, L)) + far
    ix = ox + rng.normal(0.0, 2.0, (b, P, L)) - (rng.random((b, P, L)) < 0.05) * w
    iy, ix = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (iy, ix))
    geom = _check_warp_forward(iy, ix, _randn(rng, b, h, w, c).to(cuda, dtype))
    assert 0 < geom["rows"] < h
    assert geom["passes"] == (2 if (c, dtype) == (96, torch.float32) else 1)
    outside, taps = out_of_band_share(iy, ix, h, w, geom)
    assert 0.05 * taps < outside < 0.5 * taps


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_warp_forward_zero_flows(cuda, dtype):
    r"""EF-TrajGRU's indices at zero flows (its flow convs' start): every tap
    lies in its block's band."""
    rng = np.random.default_rng(17)
    b, side, c, L = 2, 32, 96, 13
    img = _randn(rng, b, side, side, c).to(cuda, dtype)
    iy, ix = _flow_to_indices(img, torch.zeros(b, side, side, 2 * L, device=cuda))
    geom = _check_warp_forward(iy, ix, img)
    assert out_of_band_share(iy, ix, side, side, geom)[0] == 0


def test_warp_forward_f32_in_channel_passes(cuda):
    r"""EF-TrajGRU's first layer in f32 at b=32 (two flows): the full band,
    20 rows of 64x64 channels, is 320 KB; the forward takes two passes of 32
    channels."""
    rng = np.random.default_rng(18)
    b, side, c, L = 32, 64, 64, 2
    P = side * side
    oy = np.repeat(np.arange(side, dtype=np.float32), side)[None, :, None]
    ox = np.tile(np.arange(side, dtype=np.float32), side)[None, :, None]
    iy, ix = (torch.from_numpy((o + rng.normal(0.0, 3.0, (b, P, L))).astype(np.float32)).to(cuda)
              for o in (oy, ox))
    geom = _check_warp_forward(iy, ix, _randn(rng, b, side, side, c).to(cuda))
    assert (geom["passes"], geom["cw"], geom["rows"]) == (2, 32, 20)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_warp_forward_without_a_band(cuda, dtype):
    r"""So wide an image (w = 15000, 16 bytes of channels a pixel) that not
    one row fits in shared memory: every tap reads global memory."""
    rng = np.random.default_rng(19)
    b, h, w, L = 1, 2, 15000, 2
    c = 4 if dtype == torch.float32 else 8
    P = h * w
    iy = np.repeat(np.arange(h, dtype=np.float32), w)[None, :, None] + rng.normal(0.0, 1.0, (b, P, L))
    ix = np.tile(np.arange(w, dtype=np.float32), h)[None, :, None] + rng.normal(0.0, 3.0, (b, P, L))
    iy, ix = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (iy, ix))
    geom = _check_warp_forward(iy, ix, _randn(rng, b, h, w, c).to(cuda, dtype))
    assert geom["rows"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_grid_sample_forward_with_p_not_hw(cuda, dtype):
    r"""``grid_sample`` sends the warp P = 10*13 != h*w = 24*40 samples of one
    flow; the card's result against the same call on the CPU (the plain
    forward), with the tiles' bands placed as if the output pixels were rows
    of the image."""
    rng = np.random.default_rng(20)
    b, h, w, c, h_out, w_out = 2, 24, 40, 16, 10, 13
    grid = torch.from_numpy(rng.uniform(-1.1, 1.1, (b, h_out, w_out, 2)).astype(np.float32))
    img = _randn(rng, b, h, w, c).to(dtype)
    geom = warp_fwd_variants.geometry(build.warp_library(), b, h_out * w_out, 1, h, w, c,
                                      dtype == torch.bfloat16)
    assert 0 < geom["rows"] < h
    before = warp_sample.launches
    got = grid_sample(img.to(cuda), grid.to(cuda))
    torch.cuda.synchronize()
    assert warp_sample.launches == before + 1
    _assert_warp_close(got.cpu(), grid_sample(img, grid))


def test_warp_forward_geometry_matches_its_mirror(cuda):
    r"""``vp_warp_fwd_geometry`` on an H100 against
    :func:`warp_fwd_variants.plan` with the H100's limits, at EF-TrajGRU's
    three layer shapes and the shapes of the tests above."""
    props = torch.cuda.get_device_properties(0)
    if (props.multi_processor_count, props.shared_memory_per_multiprocessor) != (132, 233472):
        pytest.skip("the mirror's limits are an H100 SXM's")
    lib = build.warp_library()
    for b, P, h, w, c in [(32, 4096, 64, 64, 64), (32, 1024, 32, 32, 96), (32, 256, 16, 16, 96),
                          (2, 2560, 40, 64, 96), (2, 130, 24, 40, 16), (1, 30000, 2, 15000, 8),
                          (2, 2560, 40, 64, 20)]:
        for bf16 in (True, False):
            assert warp_fwd_variants.geometry(lib, b, P, 13, h, w, c, bf16) \
                == warp_fwd_variants.plan(b, P, h, w, c, bf16), (b, P, h, w, c, bf16)


#: (h, w, P, c): a square image with P = h*w, and a ragged one with P != h*w (K8 takes
#: h, w and P with f = 24); for K9's bf16 kernels also every branch: w = 64, 32 and 16 with
#: c = 64 and 96 (Bm in registers, staged d_img slabs), rows L*P not a multiple of the tile,
#: c = 24 and c = 20 (padded to 32 and 24 channels), h % 8 != 0 with a part-filled last slab
#: (gathered d_img), two channel passes and chunks (c = 136), the ragged image (every
#: fragment gathered), w = 200 (d_A / d_Bm in two column chunks, with scratch), h = 512 (the
#: forward's A tile in two parts) and h = 1024 (in three; d_A / d_Bm by the general kernel).
FACTOR_SHAPES = {"16x16": (16, 16, 256, 24), "ragged": (9, 11, 50, 24),
                 "64x64x64": (64, 64, 4096, 64), "64x64x96": (64, 64, 4096, 96),
                 "32x32x64": (32, 32, 1024, 64), "32x32x96": (32, 32, 1024, 96),
                 "16x16x64": (16, 16, 256, 64), "16x16x96": (16, 16, 256, 96),
                 "P1000": (32, 32, 1000, 64), "c20": (16, 16, 256, 20),
                 "h6": (6, 16, 96, 64), "c136": (8, 32, 200, 136),
                 "w200": (2, 200, 400, 8), "tall": (512, 16, 128, 8), "h1024": (1024, 16, 64, 8)}


@pytest.mark.parametrize("shape", list(FACTOR_SHAPES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_warp_ret_kernels_match_the_plain_versions(cuda, dtype, shape):
    r"""f=24 and O=72 leave partial channel blocks in every tile of the kernels."""
    _check_warp_ret(cuda, dtype, shape, 24)


@pytest.mark.parametrize("f", [64, 96])
@pytest.mark.parametrize("shape", ["16x16", "ragged", "P1000", "w200", "tall"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_warp_ret_kernels_match_at_the_layer_widths(cuda, dtype, shape, f):
    r"""EF-TrajGRU's widths, f=64 with O=192 and f=96 with O=288, which take the
    bf16 kernels' two- and three-product forward and pass 2's m64 tiles of O,
    at small P."""
    _check_warp_ret(cuda, dtype, shape, f)


#: (shape, b, L, f, O) past EF-TrajGRU's widths, which take the bf16 pass 1's chunks of O and
#: pass 2's channel and O passes: f=192, O=576 at more pixel tiles than SMs (two warpgroups, the g
#: tile staged whole, two chunks); f=384, O=1152 (one warpgroup, four chunks); f=32, O=1536 (g
#: streamed in chunks beside W^T); L=480 (the indices read from global memory). The f32 kernels
#: take them in blocks of 64 channels.
WIDE_RET = {"O576": ("64x64x64", 5, 3, 192, 576), "O1152": ("16x16", 2, 3, 384, 1152),
            "O1536": ("16x16", 2, 3, 32, 1536), "L480": ("ragged", 2, 480, 8, 16)}


@pytest.mark.parametrize("case", list(WIDE_RET))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_warp_ret_kernels_match_past_the_layer_widths(cuda, dtype, case):
    shape, b, L, f, O = WIDE_RET[case]
    _check_warp_ret(cuda, dtype, shape, f, O=O, b=b, L=L)


def _check_warp_ret(cuda, dtype, shape, f, O=None, b=2, L=3):
    rng = np.random.default_rng(10)
    h, w, P, _ = FACTOR_SHAPES[shape]
    O = O or 3 * f
    idx = [torch.from_numpy((rng.random((b, P, L)) * (n + 4) - 2).astype(np.float32)).to(cuda)
           for n in (h, w)]
    args = idx + [_randn(rng, b, h, w, f).to(cuda, dtype),
                  _randn(rng, L, f, O, scale=0.2).to(cuda), _randn(rng, O).to(cuda)]
    g = _randn(rng, b, P, O).to(cuda, dtype)
    before = (warp_ret_forward.launches, warp_ret_backward.launches)
    leaves = [a.clone().requires_grad_() for a in args]
    out = warp_ret(*leaves)
    out.backward(g)
    torch.cuda.synchronize()
    assert (warp_ret_forward.launches, warp_ret_backward.launches) == (before[0] + 1, before[1] + 3)
    rel = 1e-5 if dtype == torch.float32 else 2 ** -6
    want = warp_ret_reference(*args)
    assert out.dtype == dtype and out.shape == want.shape == (b, P, O)
    _close_to_largest(out, want, rel)
    for a, w_ in zip(leaves, warp_ret_backward_reference(*args, g)):
        assert a.grad.dtype == w_.dtype and a.grad.shape == w_.shape
        _close_to_largest(a.grad, w_, rel)


@pytest.mark.parametrize("shape", list(FACTOR_SHAPES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_warp_contract_kernels_match_the_plain_versions(cuda, dtype, shape):
    r"""Dense random factors; c=24 leaves a partial channel block of the f32
    kernels, and the shapes take every branch of the bf16 kernels."""
    rng = np.random.default_rng(11)
    h, w, P, c = FACTOR_SHAPES[shape]
    b, L = 2, 3
    args = [_randn(rng, b, L, P, h).to(cuda, dtype), _randn(rng, b, L, P, w).to(cuda, dtype),
            _randn(rng, b, h, w, c).to(cuda, dtype)]
    g = _randn(rng, b, L, P, c).to(cuda, dtype)
    before = (warp_contract_forward.launches, warp_contract_backward.launches)
    leaves = [a.clone().requires_grad_() for a in args]
    out = warp_contract(*leaves)
    out.backward(g)
    torch.cuda.synchronize()
    assert (warp_contract_forward.launches, warp_contract_backward.launches) \
        == (before[0] + 1, before[1] + 2)
    rel = 5e-5 if dtype == torch.float32 else 2 ** -6
    want = warp_contract_reference(*args)
    assert out.dtype == dtype and out.shape == want.shape == (b, L, P, c)
    _close_to_largest(out, want, rel)
    for a, w_ in zip(leaves, warp_contract_backward_reference(*args, g)):
        assert a.grad.dtype == dtype and a.grad.shape == w_.shape
        _close_to_largest(a.grad, w_, rel)


@pytest.mark.parametrize("shape", ["64x64x64", "ragged", "c136", "w200"])
def test_warp_contract_kernels_are_deterministic(cuda, shape):
    r"""No atomics: two runs of the bf16 forward and backward give the same bits."""
    rng = np.random.default_rng(13)
    h, w, P, c = FACTOR_SHAPES[shape]
    b, L = 2, 3
    A, Bm = (_randn(rng, b, L, P, n, scale=n ** -0.5).to(cuda, torch.bfloat16) for n in (h, w))
    img = _randn(rng, b, h, w, c).to(cuda, torch.bfloat16)
    g = _randn(rng, b, L, P, c, scale=1e-2).to(cuda, torch.bfloat16)
    first = (warp_contract_forward(A, Bm, img), *warp_contract_backward(A, Bm, img, g))
    second = (warp_contract_forward(A, Bm, img), *warp_contract_backward(A, Bm, img, g))
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


def test_warp_ret_geometry_is_its_mirror(cuda):
    r"""K8's bf16 plan (``vp_warp_ret_geometry``) is :func:`k8_variants.plan` on
    this card at EF-TrajGRU's three layer shapes and the shapes of the tests
    above."""
    lib = build.warp_ret_library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = [(32, s * s, 13, s, s, c, 3 * c) for s, c in ((64, 64), (32, 96), (16, 96))] \
        + [(2, P, 3, h, w, f, 3 * f) for h, w, P, _ in FACTOR_SHAPES.values() for f in (24, 64, 96)] \
        + [(b, FACTOR_SHAPES[s][2], L, *FACTOR_SHAPES[s][:2], f, O) for s, b, L, f, O in WIDE_RET.values()] \
        + [(32, 4096, 13, 64, 64, 192, 576), (32, 4096, 13, 64, 64, 384, 1152)]
    for shape in shapes:
        assert k8_variants.geometry(lib, *shape) \
            == k8_variants.plan(*shape, limits=(sms, k8_variants.H100_LIMITS[1])), shape


def test_warp_contract_geometry_is_its_mirror(cuda):
    r"""The bf16 kernels' plan (``vp_warp_contract_geometry``) is
    :func:`k9_variants.plan` at EF-TrajGRU's three layer shapes and the shapes
    of the tests above."""
    lib = build.warp_contract_library()
    shapes = [(32, 13, 4096, 64, 64, 64), (32, 13, 1024, 32, 32, 96), (32, 13, 256, 16, 16, 96)] \
        + [(2, 3, P, h, w, -(-c // 8) * 8) for h, w, P, c in FACTOR_SHAPES.values()]
    for shape in shapes:
        assert k9_variants.geometry(lib, *shape) == k9_variants.plan(*shape), shape


def test_onehot_warp_contract_is_the_warp(cuda):
    iy, ix, img, _ = _warp_args(np.random.default_rng(12), cuda, torch.float32)
    h, w = img.shape[1:3]
    got = warp_contract(_onehot_factor(iy.transpose(1, 2), h, torch.float32),
                        _onehot_factor(ix.transpose(1, 2), w, torch.float32), img)
    torch.testing.assert_close(got.transpose(1, 2), warp_sample(iy, ix, img), rtol=0, atol=1e-5)


def test_factor_kernels_reject_what_they_do_not_take(cuda):
    A = torch.zeros(1, 1, 4, 4, device=cuda)
    with pytest.raises(TypeError, match="all float32 or all bfloat16"):
        warp_contract_forward(A, A, torch.zeros(1, 4, 4, 8, device=cuda, dtype=torch.bfloat16))
    iy = torch.zeros(1, 4, 2, device=cuda)
    with pytest.raises(TypeError, match="float32 indices"):
        warp_ret_forward(iy.double(), iy.double(), torch.zeros(1, 2, 2, 8, device=cuda),
                         torch.zeros(2, 8, 24, device=cuda), torch.zeros(24, device=cuda))


#: the measures' display values on the card against the CPU, relative: the
#: same f32 formulas; LPIPS and FVD sum convolutions of up to 7*7*7*3 taps in
#: another order, through 5 and 22 layers. With TF32 let into those
#: convolutions they must exceed these limits
#: (``test_measure_limits_see_tf32_in_the_convolutions``).
MEASURE_RTOL = {"mse": 1e-5, "l1": 1e-5, "smooth_l1": 1e-5, "psnr": 1e-5, "ssim": 1e-5,
                "lpips": 1e-5, "fvd": 1e-4}


@pytest.mark.parametrize("name", list(MEASURE_RTOL))
def test_measures_on_the_card_match_the_cpu(cuda_default_tf32, name):
    r"""Each measure's ``forward`` (and ``per_frame``), as displayed, on the
    card against the CPU at 64x64 (FVD at 10 frames, resized to 224x224), on
    a target and a prediction near it, with PyTorch's default TF32 flags,
    which the measures leave as they found them."""
    pred, target = _measure_pair(10 if name == "fvd" else 3)
    measure = METRIC_CLASSES[name]()
    want = measure.to_display(measure(pred, target))
    got = measure(pred.to(cuda_default_tf32), target.to(cuda_default_tf32))
    assert got.device.type == "cuda" and got.dtype == torch.float32
    np.testing.assert_allclose(float(measure.to_display(got)), float(want), rtol=MEASURE_RTOL[name])
    if name != "fvd":
        got_pf = measure.per_frame(pred.to(cuda_default_tf32), target.to(cuda_default_tf32))
        want_pf = measure.per_frame(pred, target)
        torch.testing.assert_close(measure.to_display(got_pf).cpu(), measure.to_display(want_pf),
                                   rtol=MEASURE_RTOL[name], atol=0)
    assert torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32


def _measure_pair(t):
    rng = np.random.default_rng(0)
    target = rng.random((2, t, 64, 64, 3)).astype(np.float32)
    pred = np.clip(target + 0.1 * rng.standard_normal(target.shape), 0, 1).astype(np.float32)
    return torch.from_numpy(pred), torch.from_numpy(target)


@pytest.mark.parametrize("name", ["lpips", "fvd"])
def test_measure_limits_see_tf32_in_the_convolutions(cuda_default_tf32, monkeypatch, name):
    r"""With the measures' TF32 guard made a no-op, cuDNN's default TF32
    reaches LPIPS's and I3D's convolutions, and the card's value leaves
    MEASURE_RTOL of the CPU's: the limits can see that fault."""
    import contextlib
    from vp_suite_tpu_torch.measure import image_wise, lpips_net
    from vp_suite_tpu_torch.measure.fvd import fvd, i3d
    pred, target = _measure_pair(10 if name == "fvd" else 3)
    measure = METRIC_CLASSES[name]()
    want = float(measure(pred, target))
    for module in (image_wise, lpips_net, fvd, i3d):
        monkeypatch.setattr(module, "full_precision", contextlib.nullcontext)
    got = float(measure(pred.to(cuda_default_tf32), target.to(cuda_default_tf32)))
    assert abs(got - want) > MEASURE_RTOL[name] * abs(want)


@pytest.mark.parametrize("cfg,want", [
    ({}, dict(K1=2 * 15)),
    (dict(use_fused_scan=True, interleaved_encode=False, interleaved_forecast=False),
     dict(K3=2 * 6))], ids=["per_step", "fused_scan"])
def test_facade_test_on_the_card_launches_the_kernels(cuda_default_tf32, monkeypatch, tmp_path,
                                                       cfg, want):
    r"""One ``VPSuite.test`` over 4 test sequences (3 -> 2 frames, so 15 cell
    steps per forward): exactly the K1 (or K3) of the compiled predictor's
    first two batches (its eager call and its capture; the other batches
    replay the graph, launching from the card), and no other kernel; every
    horizon's metrics finite, for the model and CopyLastFrame."""
    monkeypatch.setattr(SETTINGS, "_run_path", tmp_path)
    suite = VPSuite()
    suite.load_dataset("MMF", split="test", img_size=16, digit_source="synthetic", n_seqs=4)
    suite.create_model("convlstm-shi", enc_c=(16, 16, 16, 32, 32, 32),
                       dec_c=(32, 32, 32, 32, 16, 16), **cfg)
    counters = {"K1": (convlstm_gate_fuse, "launches"), "K2": (convlstm_gate_backward, "launches"),
                "K3": (convlstm_scan_fused, "launches"),
                "K3s": (convlstm_scan_fused, "save_gates_launches"),
                "K4": (convlstm_scan_backward, "launches"), "warp_fwd": (warp_sample, "launches"),
                "warp_bwd": (warp_sample_backward, "launches")}
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    (results,) = suite.test(brief_test=True, context_frames=3, pred_frames=2,
                            metrics=["mse", "psnr", "ssim", "lpips"], no_vis=True, no_wandb=True)
    torch.cuda.synchronize()
    assert {k: getattr(fn, attr) for k, (fn, attr) in counters.items()} \
        == {k: want.get(k, 0) for k in counters}
    assert list(results) == ["EF-ConvLSTM (Shi et al.)", "CopyLastFrame"]
    for horizons in results.values():
        assert len(horizons) == 2
        assert all(len(d) == 4 and all(np.isfinite(v) for v in d.values()) for d in horizons)


# ---- E1: the symmetric eigensolver (csrc/sym_eig.cu) ---------------------------------------------

#: E1's sizes: FVD batches (b=1 the zero matrix, odd sizes padded), A and V in shared memory up to
#: about 168, in the scratch above
E1_SIZES = (1, 2, 3, 4, 10, 32, 160, 256)
#: eigenvalues within this of the largest, against torch.linalg.eigh in f64 on the CPU;
#: reconstruction (relative to the largest) and orthogonality (absolute) likewise: an f32
#: solver's rounding (cuSOLVER's own f32 eigenvalues part from f64 by more at b = 128, so
#: they are not the reference)
E1_TOL = 1e-5


def _fvd_matrix(b, seed, noise=0.05, width=400):
    r"""FVD's ``m = a a^T`` of ``b`` feature sets (the target the prediction
    plus ``noise``), f32 on the CPU: one exact zero eigenvalue (centring)."""
    g = torch.Generator().manual_seed(seed)
    p = torch.randn((b, width), generator=g)
    t = p + noise * torch.randn((b, width), generator=g)
    a = ((p - p.mean(0)) @ (t - t.mean(0)).T) * (1.0 if b < 2 else 1.0 / (b - 1))
    return a @ a.T


def _assert_eig(w, v, m, want_w):
    w, v, m, want_w = (x.double().cpu() for x in (w, v, m, want_w))
    scale = float(want_w.abs().max()) or 1.0
    eye = torch.eye(m.shape[-1], dtype=torch.float64)
    assert float((w - want_w).abs().max()) <= E1_TOL * scale
    assert float((v @ torch.diag_embed(w) @ v.transpose(-1, -2) - m).abs().max()) <= E1_TOL * scale
    assert float((v.transpose(-1, -2) @ v - eye).abs().max()) <= E1_TOL


@pytest.mark.parametrize("b", E1_SIZES)
def test_sym_eig_kernel_matches_eigh(cuda, b):
    from vp_suite_tpu_torch.ops.sym_eig import sym_eig, sym_eig_reference
    m = _fvd_matrix(b, b).to(cuda)
    sym_eig.launches = 0
    w, v = sym_eig(m)
    again = sym_eig(m)
    torch.cuda.synchronize()
    assert sym_eig.launches == 2
    assert torch.equal(w, again[0]) and torch.equal(v, again[1]), "E1 is not deterministic"
    _assert_eig(w, v, m, sym_eig_reference(m.double().cpu())[0])


def test_sym_eig_kernel_takes_batches_and_repeated_eigenvalues(cuda):
    from vp_suite_tpu_torch.ops.sym_eig import sym_eig, sym_eig_reference
    q, _ = torch.linalg.qr(torch.randn(16, 16, generator=torch.Generator().manual_seed(0)))
    repeated = (q * torch.tensor([1.0] * 6 + [2.0] * 6 + [0.0] * 4)) @ q.T
    m = torch.stack([repeated, _fvd_matrix(16, 1), torch.zeros(16, 16)]).to(cuda)
    sym_eig.launches = 0
    w, v = sym_eig(m)
    torch.cuda.synchronize()
    assert sym_eig.launches == 1
    for i in range(3):
        _assert_eig(w[i], v[i], m[i], sym_eig_reference(m[i].double().cpu())[0])


def test_sym_eig_gradient_on_the_card_matches_the_cpu(cuda):
    from vp_suite_tpu_torch.ops.sym_eig import sym_eigvals
    a = torch.randn(32, 32, generator=torch.Generator().manual_seed(2))
    m = a @ a.T + 0.5 * torch.eye(32)
    grads = []
    for device in ("cpu", cuda):
        mt = m.to(device).detach().requires_grad_()
        torch.sqrt(sym_eigvals(mt).clamp_min(0.0) + 1e-15).sum().backward()
        grads.append(mt.grad.cpu())
    assert float((grads[1] - grads[0]).abs().max()) <= 1e-4 * float(grads[0].abs().max())


def test_sym_eig_rejects_what_it_does_not_take(cuda):
    from vp_suite_tpu_torch.ops.sym_eig import sym_eig
    m = _fvd_matrix(4, 0).to(cuda)
    with pytest.raises(TypeError, match="float32"):
        sym_eig(m.double())
    with pytest.raises(ValueError, match="contiguous"):
        sym_eig(torch.stack([m, m], -1)[..., 0])
