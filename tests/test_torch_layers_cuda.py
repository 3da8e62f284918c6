r"""The layers of UNet-3D, PredRNN++ and PhyDNet, and ST-Phy and the
encoder-LSTM-decoder whole, on a CUDA card against the CPU.

These tests need an NVIDIA card and skip without one. They import neither
JAX nor the JAX package, so they run on a machine that has neither:

    python -m pytest tests/test_torch_layers_cuda.py -q --noconftest -p no:cacheprovider

They run with PyTorch's default TF32 flags (cuDNN's on, cuBLAS's off), as a
user's model runs: ``BatchNorm`` (no convolution) within 1e-5 of the CPU, its
running statistics too; ``Conv3d`` and one ST-LSTM step,
whose f32 convolutions cuDNN then runs in TF32 (operands rounded to 10
mantissa bits, 2^-11 relative), within 5e-3 of the largest output of each
kind: TF32 roundings of K products summed (K = 27 * 8 for the Conv3d, 25 *
48 for the cell's input conv) stay some sqrt(K) * 2^-11 of the terms. The
bf16 Conv3d within 2^-6 of the largest (operands and result rounded to 8
mantissa bits). PhyDNet's (TF32 convolutions): the DCGAN conv and transposed
conv, the ndrplz ConvLSTM cell and the PhyCell step (its 7x7 F conv, K = 49
* 64) within 5e-3 of the largest; ``GroupNorm`` (no convolution) in f32
within 1e-5, in bf16 within 2^-7 of the largest of the CPU's f32 output on
the same bf16-rounded input: the affine parameters are cast to bf16 and the
output is rounded to bf16 (statistics in f32), each rounding at most 2^-8
of its value. ST-Phy and LSTM at their defaults (64x64, 5 -> 10, b=2), plain
and with 3 action channels, their eval-mode f32 forward with TF32 off within
1e-4 of the CPU's.
"""
import copy

import pytest
import torch

from vp_suite_tpu_torch.model_blocks.conv import DCGANConv, DCGANConvTranspose
from vp_suite_tpu_torch.model_blocks.conv_lstm_ndrplz import ConvLSTMCellNdrplz
from vp_suite_tpu_torch.model_blocks.phydnet import PhyCellCell
from vp_suite_tpu_torch.model_blocks.predrnn import SpatioTemporalLSTMCell
from vp_suite_tpu_torch.models import build_model
from vp_suite_tpu_torch.nn.layers import BatchNorm, Conv3d, GroupNorm

pytestmark = pytest.mark.cuda

TF32_REL = 5e-3


@pytest.fixture()
def cuda_default_tf32():
    r"""The card, with PyTorch's default TF32 flags while the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32, matmul.allow_tf32 = True, False
    yield torch.device("cuda")
    cudnn.allow_tf32, matmul.allow_tf32 = saved


def _rel(got, want):
    return (got.float().cpu() - want.float()).abs().max().item() / want.float().abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batchnorm_matches_cpu(cuda_default_tf32, train, dtype):
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(4, 3, 16, 16, 8, generator=g) * 2 + 0.5).to(dtype)
    host = BatchNorm(8)
    host.reset_parameters()
    with torch.no_grad():
        host.weight.uniform_(0.5, 1.5, generator=g)
        host.bias.normal_(generator=g)
        host.running_var.uniform_(0.5, 1.5, generator=g)
    card = copy.deepcopy(host).to(cuda_default_tf32)
    want, got = host(x, train), card(x.to(cuda_default_tf32), train)
    assert got.dtype == want.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    for name, buf in host.named_buffers():
        torch.testing.assert_close(dict(card.named_buffers())[name].cpu(), buf, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("kind", ["3x3x3_replicate", "time_collapse"])
def test_conv3d_matches_cpu(cuda_default_tf32, kind):
    td = 3
    if kind == "time_collapse":
        host = Conv3d(8, 16, (td, 1, 1))
    else:
        host = Conv3d(8, 16, 3, 1, 1, bias=False, padding_mode="replicate")
    host.reset_parameters(torch.Generator().manual_seed(1))
    card = copy.deepcopy(host).to(cuda_default_tf32)
    x = torch.randn(2, td, 32, 32, 8, generator=torch.Generator().manual_seed(2))
    want, got = host(x), card(x.to(cuda_default_tf32))
    assert got.shape == want.shape and got.is_contiguous()
    assert _rel(got, want) <= TF32_REL
    got16 = card(x.to(cuda_default_tf32, torch.bfloat16))
    assert got16.dtype == torch.bfloat16 and _rel(got16, want) <= 2 ** -6


def test_st_lstm_step_matches_cpu(cuda_default_tf32):
    host = SpatioTemporalLSTMCell(48, 32, 16, 16, 5, 1, layer_norm=False)
    for m in host.modules():
        if hasattr(m, "reset_parameters") and m is not host:
            m.reset_parameters(torch.Generator().manual_seed(3))
    card = copy.deepcopy(host).to(cuda_default_tf32)
    g = torch.Generator().manual_seed(4)
    args = [torch.randn(2, 16, 16, 48, generator=g)] \
        + [torch.randn(2, 16, 16, 32, generator=g) * 0.5 for _ in range(3)]
    want = host(*args)
    got = card(*[a.to(cuda_default_tf32) for a in args])
    for name, w, c in zip(("h", "c", "m", "delta_c", "delta_m"), want, got):
        assert _rel(c, w.detach()) <= TF32_REL, name


def _seeded(module, seed):
    for m in module.modules():
        if hasattr(m, "reset_parameters") and m is not module:
            m.reset_parameters(torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for p in module.parameters():
            if p.dim() == 1:
                p.add_(torch.randn(p.shape, generator=g) * 0.1)
    return module


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_group_norm_matches_cpu(cuda_default_tf32, dtype):
    host = _seeded(GroupNorm(7, 49), 5)
    card = copy.deepcopy(host).to(cuda_default_tf32)
    x = (torch.randn(4, 16, 16, 49, generator=torch.Generator().manual_seed(6)) * 2 + 0.5) \
        .to(dtype)
    want = host(x.float()).detach()
    got = card(x.to(cuda_default_tf32))
    assert got.dtype == dtype and got.is_contiguous()
    if dtype == torch.float32:
        torch.testing.assert_close(got.detach().cpu(), want, rtol=1e-5, atol=1e-5)
    else:
        assert _rel(got.detach(), want) <= 2 ** -7


@pytest.mark.parametrize("block", ["conv_s1", "conv_s2", "conv_transpose_s1",
                                   "conv_transpose_s2"])
def test_dcgan_blocks_match_cpu(cuda_default_tf32, block):
    kind, stride = block.rsplit("_s", 1)
    host = _seeded((DCGANConvTranspose if kind == "conv_transpose" else DCGANConv)(
        32, 64, int(stride)), 7)
    card = copy.deepcopy(host).to(cuda_default_tf32)
    x = torch.randn(2, 16, 16, 32, generator=torch.Generator().manual_seed(8))
    assert _rel(card(x.to(cuda_default_tf32)).detach(), host(x).detach()) <= TF32_REL


def test_phydnet_cells_match_cpu(cuda_default_tf32):
    g = torch.Generator().manual_seed(9)
    phy = _seeded(PhyCellCell(64, False, 0, 49, (7, 7)), 10)
    lstm = _seeded(ConvLSTMCellNdrplz(64, 128, (3, 3)), 11)
    frame, hidden = (torch.randn(2, 16, 16, 64, generator=g) for _ in range(2))
    h, c = (torch.randn(2, 16, 16, 128, generator=g) * 0.5 for _ in range(2))
    dev = cuda_default_tf32
    want = phy(frame, None, hidden).detach()
    got = copy.deepcopy(phy).to(dev)(frame.to(dev), None, hidden.to(dev))
    assert _rel(got.detach(), want) <= TF32_REL
    want = lstm(frame, (h, c))
    got = copy.deepcopy(lstm).to(dev)(frame.to(dev), (h.to(dev), c.to(dev)))
    for name, w, x in zip(("h", "c"), want, got):
        assert _rel(x.detach(), w.detach()) <= TF32_REL, name


@pytest.fixture()
def cuda_no_tf32():
    r"""The card, with TF32 off in cuDNN and cuBLAS while the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    yield torch.device("cuda")
    cudnn.allow_tf32, matmul.allow_tf32 = saved


@pytest.mark.parametrize("ac", [False, True], ids=["plain", "action_conditional"])
@pytest.mark.parametrize("model_id", ["st-phy", "lstm"])
def test_new_models_match_cpu(cuda_no_tf32, model_id, ac):
    kw = dict(img_shape=(3, 64, 64), action_size=3 if ac else 0, tensor_value_range=(0.0, 1.0),
              action_conditional=ac)
    host = build_model(model_id, 0, "cpu", **kw)
    card = build_model(model_id, 0, cuda_no_tf32, **kw)
    g = torch.Generator().manual_seed(12)
    x, actions = torch.rand((2, 5, 64, 64, 3), generator=g), torch.rand((2, 15, 3), generator=g)
    with torch.no_grad():
        want, _ = host(x, pred_frames=10, actions=actions)
        got, _ = card(x.to(cuda_no_tf32), pred_frames=10, actions=actions.to(cuda_no_tf32))
    assert got.shape == want.shape == (2, 10, 64, 64, 3)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
