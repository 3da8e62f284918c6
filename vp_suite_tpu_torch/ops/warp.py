r"""Multi-flow bilinear warp: CUDA kernels for its forward and backward, their
plain versions, and the autograd Function that joins them.

TrajGRU warps its hidden state along L flows per step. From fractional source
indices ``iy``, ``ix`` (f32) the warp samples an NHWC image bilinearly, with
zero outside the image (torch ``grid_sample(align_corners=False,
padding_mode='zeros')`` in index space)::

    y0 = floor(iy), wy1 = iy - y0, wy0 = 1 - wy1   (and x0, wx0, wx1 from ix)
    out[b, p, l, :] = sum over the taps (y, x) in {y0, y0+1} x {x0, x0+1}
                      of wy * wx * img[b, y, x, :]

with weights and sums in f32 and ``out`` rounded to ``img``'s dtype. The
backward, from ``g = d out``, follows the JAX package's VJP: ``floor`` carries
no gradient and the validity masks are constants, so ``d_img`` scatters
``g * wy * wx`` into each tap inside the image (accumulated in f32, rounded to
``img``'s dtype) and ``d_iy = sum_c g * (wx0 * (I[y1,x0] - I[y0,x0]) + wx1 *
(I[y1,x1] - I[y0,x1]))``, ``d_ix`` likewise, in f32, with ``I`` the taps'
values (zero outside the image).

Layout, pixel-major (the JAX package's kernels emit channel-major ``[b, L, c,
P]``, which suits the TPU's lanes): ``iy``, ``ix`` ``[b, P, L]`` with ``P =
h*w`` output pixels, ``img`` ``[b, h, w, c]`` and ``out`` ``[b, P, L, c]``. Each
tap then reads ``c`` contiguous channels of the NHWC image, and ``out`` viewed
as ``[b*P, L*c]`` feeds TrajGRU's 1x1 ``ret`` conv as one GEMM with no
transpose.

The kernels (``csrc/warp_sample.cu``, whose header gives their bound and
design) replace the JAX package's TPU kernels ``ops/pallas_warp.py``:
``_make_band_fwd_kernel`` (K5) and ``_make_fused_fwd_kernel`` (K7a) for the
forward, ``_make_band_dimg_kernel``/``_make_band_didx_kernel`` (K6a/K6b) and
``_make_fused_dimg_kernel``/``_make_fused_didx_kernel`` (K7b/K7c) for the
backward. Those are TPU tilings of one function, which a direct 4-tap gather
computes exactly for any flow; the band kernels' clamp mode saturates the row
indices before the kernel (``_clamp_rows``), so it is an input transform, not
another function. The backward's f32 atomics make ``d_img``'s summation order
vary from run to run. The kernels are built with ``nvcc`` at first use
(:mod:`vp_suite_tpu_torch.kernels.build`) and called through ``ctypes``.

Two more entry points reach the JAX package's other warp kernels:

- :func:`warp_ret` is the L warps fused with TrajGRU's 1x1 ``ret`` conv,
  ``out[b, p, o] = bias[o] + sum_l sum_k w[l, k, o] * warp_l[b, p, k]``, with
  the warp tensor kept out of device memory (``csrc/warp_ret.cu``, for K8a-c,
  ``pallas_warp.warp_ret``; bf16 on wgmma kernels that stage the image's
  band of rows, f32 on the first port's FMA bodies). No model calls it, as
  in the JAX package, whose ``TrajGRU`` runs the unfused ``warp_flow_ret``.
- :func:`warp_contract` contracts prebuilt factor matrices, ``out[b, l, p, c]
  = sum_{y, x} A[b, l, p, y] * Bm[b, l, p, x] * img[b, y, x, c]``, for any real
  ``A`` and ``Bm`` (``csrc/warp_contract.cu``, for K9a-c,
  ``pallas_warp.warp_contract``); with the one-hot factors of
  :func:`~vp_suite_tpu_torch.ops.grid_sample._onehot_factor` it is the warp.
"""
import ctypes
import itertools

import torch
from torch import Tensor

from vp_suite_tpu_torch.kernels import build
from vp_suite_tpu_torch.ops.library import check_device, define_op


def _check(iy, ix, img, g=None):
    if img.dim() != 4:
        raise ValueError(f"img must be [b, h, w, c], got shape {tuple(img.shape)}")
    if iy.dim() != 3 or iy.shape[0] != img.shape[0]:
        raise ValueError(f"iy must be [b, P, L] with b = {img.shape[0]}, got shape "
                         f"{tuple(iy.shape)}")
    if tuple(ix.shape) != tuple(iy.shape):
        raise ValueError(f"ix must match iy {tuple(iy.shape)}, got {tuple(ix.shape)}")
    if g is not None and tuple(g.shape) != (*iy.shape, img.shape[-1]):
        raise ValueError(f"g must be [b, P, L, c] = {(*iy.shape, img.shape[-1])}, "
                         f"got {tuple(g.shape)}")
    tensors = (iy, ix, img) if g is None else (iy, ix, img, g)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("iy, ix, img and g must lie on one device")


def _check_kernel_operands(name, iy, ix, img, g=None):
    r"""What the CUDA kernels take: f32 indices, an image (and ``g``) all
    float32 or all bfloat16, contiguous."""
    if iy.dtype != torch.float32 or ix.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 indices, not {iy.dtype} and {ix.dtype}")
    if img.dtype not in (torch.float32, torch.bfloat16) or (g is not None and g.dtype != img.dtype):
        raise TypeError(f"{name} takes a float32 or bfloat16 image (and g of the same dtype), "
                        f"not {img.dtype}" + ("" if g is None else f" and {g.dtype}"))
    tensors = (iy, ix, img) if g is None else (iy, ix, img, g)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")
    if img[0].numel() >= 2 ** 31:
        raise ValueError(f"{name} indexes a batch item's image with int32: "
                         f"{img[0].numel()} elements is too many")


def _taps(iy, ix, h, w):
    r"""The four taps of each sample, in the order (y0, x0), (y0, x1), (y1,
    x0), (y1, x1): ``(flat pixel index clamped into the image, weight wy*wx,
    valid)``, plus the axis weights ``(wy0, wy1, wx0, wx1)``; all ``[b, P, L]``."""
    iy, ix = iy.float(), ix.float()
    y0, x0 = torch.floor(iy), torch.floor(ix)
    wy1, wx1 = iy - y0, ix - x0
    wy0, wx0 = 1.0 - wy1, 1.0 - wx1
    taps = []
    for (yy, wy), (xx, wx) in itertools.product(((y0, wy0), (y0 + 1.0, wy1)),
                                                ((x0, wx0), (x0 + 1.0, wx1))):
        valid = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        flat = yy.clamp(0, h - 1).long() * w + xx.clamp(0, w - 1).long()
        taps.append((flat, wy * wx * valid, valid))
    return taps, (wy0, wy1, wx0, wx1)


def _gather(img_flat, flat):
    r"""``img_flat [b, h*w, c]`` at ``flat [b, P, L]`` -> ``[b, P, L, c]``."""
    b = flat.shape[0]
    return img_flat[torch.arange(b, device=flat.device)[:, None], flat.reshape(b, -1)] \
        .reshape(*flat.shape, img_flat.shape[-1])


def warp_sample_reference(iy, ix, img):
    r"""Plain PyTorch version of the warp: the explicit 4-tap formula,
    computed in f32 and rounded to ``img.dtype``. Differentiable by autograd
    (``floor`` and the validity masks are constants to it). Returns ``[b, P,
    L, c]``."""
    _check(iy, ix, img)
    b, h, w, c = img.shape
    taps, _ = _taps(iy, ix, h, w)
    img_flat = img.reshape(b, h * w, c).float()
    out = 0.0
    for flat, wt, _ in taps:
        out = out + _gather(img_flat, flat) * wt[..., None]
    return out.to(img.dtype)


def warp_sample_backward_reference(iy, ix, img, g):
    r"""Plain PyTorch version of the warp's backward, with the JAX package's
    semantics: ``(d_iy, d_ix)`` ``[b, P, L]`` in f32, ``d_img`` ``[b, h, w, c]``
    accumulated in f32 and rounded to ``img.dtype``."""
    _check(iy, ix, img, g)
    b, h, w, c = img.shape
    taps, (wy0, wy1, wx0, wx1) = _taps(iy, ix, h, w)
    img_flat = img.reshape(b, h * w, c).float()
    gf = g.float()
    v00, v01, v10, v11 = (_gather(img_flat, flat) * valid[..., None] for flat, _, valid in taps)
    d_iy = (gf * (wx0[..., None] * (v10 - v00) + wx1[..., None] * (v11 - v01))).sum(-1)
    d_ix = (gf * (wy0[..., None] * (v01 - v00) + wy1[..., None] * (v11 - v10))).sum(-1)
    d_img = torch.zeros((b * h * w, c), dtype=torch.float32, device=img.device)
    item = (torch.arange(b, device=img.device) * (h * w)).view(b, 1, 1)
    for flat, wt, _ in taps:
        d_img.index_add_(0, (flat + item).reshape(-1), (gf * wt[..., None]).reshape(-1, c))
    return d_iy, d_ix, d_img.view(b, h, w, c).to(img.dtype)


def _launch(name, lib, entry, *args):
    r"""Calls ``lib``'s C entry point ``entry`` with ``args`` (tensors as
    their data pointers) on the current stream of the first tensor's card;
    raises if it returns an error."""
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    with torch.cuda.device(device):
        err = getattr(lib, entry)(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                                    for a in args), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name}: kernel launch failed: "
                           f"{lib.vp_cuda_error_string(err).decode()} ({err})")


def _warp_sample_forward_cpu(iy: Tensor, ix: Tensor, img: Tensor) -> Tensor:
    return warp_sample_reference(iy, ix, img)


def _warp_sample_forward_cuda(iy, ix, img):
    _check(iy, ix, img)
    _check_kernel_operands("warp_sample", iy, ix, img)
    b, P, L = iy.shape
    _, h, w, c = img.shape
    out = torch.empty((b, P, L, c), dtype=img.dtype, device=img.device)
    if not out.numel():
        return out
    _launch("warp_sample", build.warp_library(), "vp_warp_sample_fwd",
            int(img.dtype == torch.bfloat16), iy, ix, img, out, b, P, L, h, w, c)
    warp_sample.launches += 1
    return out


def _warp_sample_forward_fake(iy, ix, img):
    _check(iy, ix, img)
    return img.new_empty((*iy.shape, img.shape[-1]))


_WARP_SAMPLE_FORWARD = define_op("warp_sample_forward", _warp_sample_forward_cpu,
                                 _warp_sample_forward_cuda, _warp_sample_forward_fake)


def warp_sample_forward(iy, ix, img):
    r"""The warp's forward with no autograd: ``[b, P, L, c]`` in
    ``img.dtype``. The operator ``vp_suite_tpu_torch::warp_sample_forward``:
    on CPU tensors it computes :func:`warp_sample_reference`;
    on CUDA tensors it launches the forward kernel, which takes contiguous
    f32 indices and a contiguous bf16 or f32 image, and raises on anything
    else."""
    check_device("warp_sample", img)
    return _WARP_SAMPLE_FORWARD(iy, ix, img)


def _warp_sample_backward_cpu(iy: Tensor, ix: Tensor, img: Tensor,
                              g: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    return warp_sample_backward_reference(iy, ix, img, g)


def _warp_sample_backward_cuda(iy, ix, img, g):
    _check(iy, ix, img, g)
    _check_kernel_operands("warp_sample_backward", iy, ix, img, g)
    b, P, L = iy.shape
    _, h, w, c = img.shape
    d_iy = torch.empty(iy.shape, dtype=torch.float32, device=img.device)
    d_ix = torch.empty_like(d_iy)
    d_img = torch.zeros(img.shape, dtype=torch.float32, device=img.device)
    if not g.numel():
        return d_iy, d_ix, d_img.to(img.dtype)
    _launch("warp_sample_backward", build.warp_library(), "vp_warp_sample_bwd",
            int(img.dtype == torch.bfloat16), iy, ix, img, g, d_img, d_iy, d_ix, b, P, L, h, w, c)
    warp_sample_backward.launches += 1
    return d_iy, d_ix, d_img.to(img.dtype)


def _warp_sample_backward_fake(iy, ix, img, g):
    _check(iy, ix, img, g)
    f32 = dict(dtype=torch.float32)
    return iy.new_empty(iy.shape, **f32), iy.new_empty(iy.shape, **f32), torch.empty_like(img)


_WARP_SAMPLE_BACKWARD = define_op("warp_sample_backward", _warp_sample_backward_cpu,
                                  _warp_sample_backward_cuda, _warp_sample_backward_fake)


def warp_sample_backward(iy, ix, img, g):
    r"""The warp's backward: ``(d_iy, d_ix)`` ``[b, P, L]`` f32 and ``d_img``
    ``[b, h, w, c]`` in ``img.dtype``. The operator
    ``vp_suite_tpu_torch::warp_sample_backward``: on CPU tensors it computes
    :func:`warp_sample_backward_reference`; on CUDA tensors it launches the
    backward kernel (``d_img`` accumulated in f32 with atomics, then rounded),
    which takes contiguous f32 indices and a contiguous bf16 or f32 image and
    ``g`` of one dtype, and raises on anything else."""
    check_device("warp_sample_backward", img)
    return _WARP_SAMPLE_BACKWARD(iy, ix, img, g)


class WarpFunction(torch.autograd.Function):
    r"""The warp under autograd: the forward kernel (its plain version on the
    CPU), and the backward kernel (or its plain version), which gives all
    three gradients in one pass. Saves the indices and the image."""

    @staticmethod
    def forward(ctx, iy, ix, img):
        out = warp_sample_forward(iy, ix, img)
        ctx.save_for_backward(iy, ix, img)
        return out

    @staticmethod
    def backward(ctx, g):
        iy, ix, img = ctx.saved_tensors
        d_iy, d_ix, d_img = warp_sample_backward(iy, ix, img, g.to(img.dtype).contiguous())
        need = ctx.needs_input_grad
        return (d_iy if need[0] else None, d_ix if need[1] else None,
                d_img if need[2] else None)


def warp_sample(iy, ix, img):
    r"""Multi-flow bilinear warp, differentiable.

    Args:
        iy, ix: ``[b, P, L]`` f32 fractional source indices (row, column) of
            each output pixel and flow, ``P = h_out * w_out``.
        img: ``[b, h, w, c]``, bf16 or f32.

    Returns ``[b, P, L, c]`` in ``img.dtype``. Runs :class:`WarpFunction`:
    the CUDA kernels on CUDA tensors (it raises on what they do not take),
    their plain versions on CPU tensors.
    """
    _check(iy, ix, img)
    return WarpFunction.apply(iy.contiguous(), ix.contiguous(), img.contiguous())


#: Launches of the forward kernel since the count was last set to 0.
warp_sample.launches = 0
#: Launches of the backward kernel since the count was last set to 0.
warp_sample_backward.launches = 0


# ---- K8: the warp fused with TrajGRU's 1x1 ``ret`` conv ----------------------------------------

def _check_ret(iy, ix, img, w, bias, g=None):
    _check(iy, ix, img)
    L, f = iy.shape[2], img.shape[-1]
    if w.dim() != 3 or tuple(w.shape[:2]) != (L, f):
        raise ValueError(f"w must be [L, f, O] with L = {L}, f = {f}, got shape {tuple(w.shape)}")
    O = w.shape[2]
    if tuple(bias.shape) != (O,):
        raise ValueError(f"bias must be [O] = [{O}], got shape {tuple(bias.shape)}")
    if g is not None and tuple(g.shape) != (*iy.shape[:2], O):
        raise ValueError(f"g must be [b, P, O] = {(*iy.shape[:2], O)}, got {tuple(g.shape)}")
    tensors = (iy, img, w, bias) if g is None else (iy, img, w, bias, g)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("iy, ix, img, w, bias and g must lie on one device")


def warp_ret_reference(iy, ix, img, w, bias):
    r"""Plain PyTorch version of :func:`warp_ret`'s forward: the warp
    (:func:`warp_sample_reference`, rounded to ``img.dtype``) times ``w``
    rounded to ``img.dtype``, summed in f32, plus the bias in f32, rounded
    once. Returns ``[b, P, O]`` in ``img.dtype``."""
    _check_ret(iy, ix, img, w, bias)
    b, P, _ = iy.shape
    warped = warp_sample_reference(iy, ix, img).float().reshape(b, P, -1)
    out = warped @ w.to(img.dtype).float().reshape(-1, w.shape[-1]) + bias.float()
    return out.to(img.dtype)


def warp_ret_backward_reference(iy, ix, img, w, bias, g):
    r"""Plain PyTorch version of :func:`warp_ret`'s backward, with the JAX
    package's semantics (``pallas_warp._warpret_bwd``): ``g_l = g w_l^T``
    summed in f32 and rounded to ``img.dtype``, then the warp's backward of
    ``g_l`` (:func:`warp_sample_backward_reference`); ``d_w`` the f32 sum of
    the rounded warp times ``g``, in ``w.dtype``; ``d_bias`` the f32 sum of
    ``g``, in ``bias.dtype``. Returns ``(d_iy, d_ix, d_img, d_w, d_bias)``,
    the index gradients in f32 and ``d_img`` in ``img.dtype``."""
    _check_ret(iy, ix, img, w, bias, g)
    gf = g.float()
    g_l = torch.einsum("bpo,lfo->bplf", gf, w.to(img.dtype).float()).to(img.dtype)
    d_iy, d_ix, d_img = warp_sample_backward_reference(iy, ix, img, g_l)
    d_w = torch.einsum("bplf,bpo->lfo", warp_sample_reference(iy, ix, img).float(), gf)
    return d_iy, d_ix, d_img, d_w.to(w.dtype), gf.sum((0, 1)).to(bias.dtype)


def _ret_operands(img, w, bias, g=None):
    r"""``(img, w, bias, g)`` as the kernels read them: ``w`` in the image's
    dtype, ``bias`` in f32, all contiguous; in bf16, which the kernels read in
    16-byte vectors, ``f`` and ``O`` padded with zeros to multiples of 8 (the
    image's and ``g``'s channels, ``w``'s rows and columns, ``bias``) and each
    tensor 16-byte aligned (copied where a view starts elsewhere)."""
    w, bias = w.to(img.dtype).contiguous(), bias.float().contiguous()
    if img.dtype != torch.bfloat16:
        return img, w, bias, g
    pf, po = -img.shape[-1] % 8, -w.shape[-1] % 8
    pad = torch.nn.functional.pad
    if pf:
        img = pad(img, (0, pf))
    if pf or po:
        w = pad(w, (0, po, 0, pf))
    if po:
        bias = pad(bias, (0, po))
        g = None if g is None else pad(g, (0, po))
    return [t if t is None or t.data_ptr() % 16 == 0 else t.clone() for t in (img, w, bias, g)]


def _warp_ret_forward_cpu(iy: Tensor, ix: Tensor, img: Tensor, w: Tensor, bias: Tensor) -> Tensor:
    return warp_ret_reference(iy, ix, img, w, bias)


def _warp_ret_forward_cuda(iy, ix, img, w, bias):
    _check_ret(iy, ix, img, w, bias)
    _check_kernel_operands("warp_ret", iy, ix, img)
    b, P, L = iy.shape
    _, h, wd, _ = img.shape
    O = w.shape[-1]
    img, w, bias, _ = _ret_operands(img, w, bias)
    f, Op = img.shape[-1], w.shape[-1]
    out = torch.empty((b, P, Op), dtype=img.dtype, device=img.device)
    if not out.numel():
        return out[..., :O]
    _launch("warp_ret", build.warp_ret_library(), "vp_warp_ret_fwd",
            int(img.dtype == torch.bfloat16), iy, ix, img, w, bias, out, b, P, L, h, wd, f, Op)
    warp_ret_forward.launches += 1
    return out if Op == O else out[..., :O].contiguous()


def _warp_ret_forward_fake(iy, ix, img, w, bias):
    _check_ret(iy, ix, img, w, bias)
    return img.new_empty((*iy.shape[:2], w.shape[-1]))


def _warp_ret_flops(iy, ix, img, w, bias, *, out_shape=None, **kwargs):
    r"""The contraction with ``ret``'s weights: ``2 b P L f O``."""
    b, P, L = iy
    return 2 * b * P * L * w[1] * w[2]


_WARP_RET_FORWARD = define_op("warp_ret_forward", _warp_ret_forward_cpu,
                              _warp_ret_forward_cuda, _warp_ret_forward_fake, _warp_ret_flops)


def warp_ret_forward(iy, ix, img, w, bias):
    r""":func:`warp_ret`'s forward with no autograd: ``[b, P, O]`` in
    ``img.dtype``. The operator ``vp_suite_tpu_torch::warp_ret_forward``: on
    CPU tensors it computes :func:`warp_ret_reference`; on
    CUDA tensors it launches the forward kernel, which takes contiguous f32
    indices and a contiguous bf16 or f32 image (``w`` is rounded to the
    image's dtype and ``bias`` taken in f32), and raises on anything else."""
    check_device("warp_ret", img)
    return _WARP_RET_FORWARD(iy, ix, img, w, bias)


def _dw_slices(device, b, P, L, f, O, bf16):
    r"""How many slices of the pixels the d_W pass splits into. f32: slices of
    the 64-pixel tiles, enough blocks for four per SM, at most one slice per
    tile. bf16: ``b`` times the parts of an item's 64-pixel chunks (a block
    and a partial each), enough blocks over all flows for four per SM, at
    most one part per chunk."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    if bf16:
        return b * max(1, min(-(-P // 64), -(-4 * sms // (b * L))))
    tiles = b * -(-P // 64)
    blocks = L * -(-f // 64) * -(-O // 64)
    return max(1, min(tiles, -(-4 * sms // blocks)))


def _warp_ret_backward_cpu(iy: Tensor, ix: Tensor, img: Tensor, w: Tensor, bias: Tensor,
                           g: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    return warp_ret_backward_reference(iy, ix, img, w, bias, g)


def _warp_ret_backward_cuda(iy, ix, img, w, bias, g):
    _check_ret(iy, ix, img, w, bias, g)
    _check_kernel_operands("warp_ret_backward", iy, ix, img, g)
    b, P, L = iy.shape
    _, h, wd, f = img.shape
    O = w.shape[-1]
    dev, dtype, w_dtype, bias_dtype = img.device, img.dtype, w.dtype, bias.dtype
    d_bias = g.float().sum((0, 1))
    bf16 = dtype == torch.bfloat16
    img, w, _, g = _ret_operands(img, w, bias, g)
    fp, Op = img.shape[-1], w.shape[-1]
    d_iy = torch.empty(iy.shape, dtype=torch.float32, device=dev)
    d_ix = torch.empty_like(d_iy)
    d_img = torch.zeros(img.shape, dtype=torch.float32, device=dev)
    d_w = torch.zeros(w.shape, dtype=torch.float32, device=dev)
    if g.numel():
        slices = _dw_slices(dev, b, P, L, fp, Op, bf16)
        partial = torch.empty((slices, L, fp, Op), dtype=torch.float32, device=dev)
        _launch("warp_ret_backward", build.warp_ret_library(), "vp_warp_ret_bwd",
                int(bf16), iy, ix, img, w, g, d_img, d_iy, d_ix, partial, d_w, slices, b, P, L,
                h, wd, fp, Op)
        warp_ret_backward.launches += 3
    return (d_iy, d_ix, d_img[..., :f].to(dtype).contiguous(),
            d_w[:, :f, :O].to(w_dtype).contiguous(), d_bias.to(bias_dtype))


def _warp_ret_backward_fake(iy, ix, img, w, bias, g):
    _check_ret(iy, ix, img, w, bias, g)
    f32 = dict(dtype=torch.float32)
    return iy.new_empty(iy.shape, **f32), iy.new_empty(iy.shape, **f32), torch.empty_like(img), \
        torch.empty_like(w), torch.empty_like(bias)


_WARP_RET_BACKWARD = define_op(
    "warp_ret_backward", _warp_ret_backward_cpu, _warp_ret_backward_cuda, _warp_ret_backward_fake,
    lambda *args, out_shape=None, **kwargs: 2 * _warp_ret_flops(*args[:5]))


def warp_ret_backward(iy, ix, img, w, bias, g):
    r""":func:`warp_ret`'s backward: ``(d_iy, d_ix, d_img, d_w, d_bias)`` as
    :func:`warp_ret_backward_reference` gives them. The operator
    ``vp_suite_tpu_torch::warp_ret_backward``: on CPU tensors it computes
    that; on CUDA tensors it launches the backward kernels (d_img by f32
    atomics; d_W as per-slice partials summed in order by a third launch)
    and takes ``d_bias`` as a sum outside them, as the JAX package does; it
    raises on operands the kernels do not take."""
    check_device("warp_ret_backward", img)
    return _WARP_RET_BACKWARD(iy, ix, img, w, bias, g)


class WarpRetFunction(torch.autograd.Function):
    r""":func:`warp_ret` under autograd: the forward kernel (its plain version
    on the CPU), and the backward kernels (or their plain version), which give
    all five gradients. Saves the indices, the image, ``w`` and ``bias``; the
    warp tensor is not saved, as the fused form exists to keep it out of
    memory."""

    @staticmethod
    def forward(ctx, iy, ix, img, w, bias):
        out = warp_ret_forward(iy, ix, img, w, bias)
        ctx.save_for_backward(iy, ix, img, w, bias)
        return out

    @staticmethod
    def backward(ctx, g):
        iy, ix, img, w, bias = ctx.saved_tensors
        grads = warp_ret_backward(iy, ix, img, w, bias, g.to(img.dtype).contiguous())
        return tuple(d if need else None for d, need in zip(grads, ctx.needs_input_grad))


def warp_ret(iy, ix, img, w, bias):
    r"""The L bilinear warps fused with TrajGRU's 1x1 ``ret`` conv,
    differentiable: ``out[b, p, o] = bias[o] + sum_l sum_k w[l, k, o] *
    warp_sample(iy, ix, img)[b, p, l, k]``.

    Args:
        iy, ix: ``[b, P, L]`` f32 fractional source indices.
        img: ``[b, h, w, f]``, bf16 or f32; its dtype is the compute dtype.
        w: ``[L, f, O]`` ret weights (``warp_flow_ret``'s ``[L*f, O]``
            viewed per flow), rounded to ``img``'s dtype.
        bias: ``[O]``, added in f32.

    Returns ``[b, P, O]`` in ``img.dtype``, ``warp_flow_ret``'s output viewed
    ``[b, P, O]``. Rounding rule, in the kernels and the plain versions alike:
    the warp samples and ``w`` are rounded to ``img``'s dtype, products are
    summed in f32, the bias is added in f32 and the result rounded once; in
    the backward, ``g_l = g w_l^T`` is rounded to ``img``'s dtype before the
    warp's backward. Runs :class:`WarpRetFunction`: the CUDA kernels on CUDA
    tensors (it raises on what they do not take), their plain versions on CPU
    tensors.
    """
    _check_ret(iy, ix, img, w, bias)
    return WarpRetFunction.apply(iy.contiguous(), ix.contiguous(), img.contiguous(),
                                 w.contiguous(), bias.contiguous())


#: Launches of the fused forward kernel since the count was last set to 0.
warp_ret_forward.launches = 0
#: Launches of the fused backward kernels (three per call) since the count was last set to 0.
warp_ret_backward.launches = 0


# ---- K9: the warp by prebuilt factor matrices ---------------------------------------------------

def _check_contract(A, Bm, img, g=None):
    if img.dim() != 4:
        raise ValueError(f"img must be [b, h, w, c], got shape {tuple(img.shape)}")
    b, h, w, c = img.shape
    if A.dim() != 4 or A.shape[0] != b or A.shape[3] != h:
        raise ValueError(f"A must be [b, L, P, h] with b = {b}, h = {h}, got shape "
                         f"{tuple(A.shape)}")
    if tuple(Bm.shape) != (*A.shape[:3], w):
        raise ValueError(f"Bm must be [b, L, P, w] = {(*A.shape[:3], w)}, got {tuple(Bm.shape)}")
    if g is not None and tuple(g.shape) != (*A.shape[:3], c):
        raise ValueError(f"g must be [b, L, P, c] = {(*A.shape[:3], c)}, got {tuple(g.shape)}")
    tensors = (A, Bm, img) if g is None else (A, Bm, img, g)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("A, Bm, img and g must lie on one device")


def warp_contract_reference(A, Bm, img):
    r"""Plain PyTorch version of :func:`warp_contract`: per flow, ``u =
    A_l img`` over y, then ``Bm_l u`` over x (the JAX package's
    ``_warp_contract_einsum``), in f32, rounded once to ``img.dtype``.
    Returns ``[b, L, P, c]``."""
    _check_contract(A, Bm, img)
    imgf = img.float()
    outs = [torch.einsum("bpx,bpxc->bpc", Bm[:, l].float(),
                         torch.einsum("bpy,byxc->bpxc", A[:, l].float(), imgf))
            for l in range(A.shape[1])]
    return torch.stack(outs, 1).to(img.dtype)


def warp_contract_backward_reference(A, Bm, img, g):
    r"""Plain PyTorch version of :func:`warp_contract`'s backward, the JAX
    package's einsum VJP (``pallas_warp._warp_bwd``), per flow in f32:
    returns ``(d_A, d_Bm, d_img)`` in ``A``'s, ``Bm``'s and ``img``'s
    dtypes."""
    _check_contract(A, Bm, img, g)
    imgf = img.float()
    d_img = torch.zeros_like(imgf)
    d_A, d_Bm = [], []
    for l in range(A.shape[1]):
        a, bm, gl = A[:, l].float(), Bm[:, l].float(), g[:, l].float()
        u = torch.einsum("bpy,byxc->bpxc", a, imgf)
        d_Bm.append(torch.einsum("bpxc,bpc->bpx", u, gl))
        v = bm[..., None] * gl[:, :, None, :]
        d_A.append(torch.einsum("byxc,bpxc->bpy", imgf, v))
        d_img += torch.einsum("bpy,bpxc->byxc", a, v)
    return (torch.stack(d_A, 1).to(A.dtype), torch.stack(d_Bm, 1).to(Bm.dtype),
            d_img.to(img.dtype))


def _check_contract_kernel_operands(name, *tensors):
    r"""What the CUDA kernels take: contiguous tensors, all float32 or all
    bfloat16."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or dtypes.pop() not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes A, Bm, img (and g) all float32 or all bfloat16, not "
                        f"{', '.join(str(t.dtype) for t in tensors)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous tensors")


def _bf16_contract_operands(*tensors):
    r"""What the bf16 kernels read in 16-byte vectors: each tensor 16-byte
    aligned (copied where a view starts elsewhere) and the last tensor, the
    image or g, padded with zero channels to a multiple of 8."""
    out = [t if t.data_ptr() % 16 == 0 else t.clone() for t in tensors]
    if out[-1].shape[-1] % 8:
        out[-1] = torch.nn.functional.pad(out[-1], (0, -out[-1].shape[-1] % 8))
    return out


def _warp_contract_forward_cpu(A: Tensor, Bm: Tensor, img: Tensor) -> Tensor:
    return warp_contract_reference(A, Bm, img)


def _warp_contract_forward_cuda(A, Bm, img):
    _check_contract(A, Bm, img)
    _check_contract_kernel_operands("warp_contract", A, Bm, img)
    b, L, P, h = A.shape
    _, _, w, c = img.shape
    bf16 = img.dtype == torch.bfloat16
    if bf16:
        A, Bm, img = _bf16_contract_operands(A, Bm, img)
    cp = img.shape[-1]
    out = torch.empty((b, L, P, cp), dtype=img.dtype, device=img.device)
    if out.numel():
        _launch("warp_contract", build.warp_contract_library(), "vp_warp_contract_fwd",
                int(bf16), A, Bm, img, out, b, L, P, h, w, cp)
        warp_contract_forward.launches += 1
    return out if cp == c else out[..., :c].contiguous()


def _warp_contract_forward_fake(A, Bm, img):
    _check_contract(A, Bm, img)
    return img.new_empty((*A.shape[:3], img.shape[-1]))


def _warp_contract_flops(A, Bm, img, *, out_shape=None, **kwargs):
    r"""The factor contraction: ``2 b L P h w c``."""
    b, L, P, h = A
    return 2 * b * L * P * h * img[2] * img[3]


_WARP_CONTRACT_FORWARD = define_op("warp_contract_forward", _warp_contract_forward_cpu,
                                   _warp_contract_forward_cuda, _warp_contract_forward_fake,
                                   _warp_contract_flops)


def warp_contract_forward(A, Bm, img):
    r""":func:`warp_contract`'s forward with no autograd: ``[b, L, P, c]`` in
    ``img.dtype``. The operator ``vp_suite_tpu_torch::warp_contract_forward``:
    on CPU tensors it computes
    :func:`warp_contract_reference`; on CUDA tensors it launches the forward
    kernel, which takes contiguous operands all f32 or all bf16 (it forms the
    factor product ``A[p, y] * Bm[p, x]`` in that dtype and sums in f32), and
    raises on anything else. In bf16 the operands are padded to a multiple
    of 8 channels and copied to 16-byte alignment where needed."""
    check_device("warp_contract", img)
    return _WARP_CONTRACT_FORWARD(A, Bm, img)


def _contract_scratch(b, L, P, h, w, c, device):
    r"""The f32 scratch that the bf16 backward kernels need at these sizes
    (the plan's ``scratch``: the general d_A / d_Bm kernel's partial sums
    where w > 128 or c > 128 split them), or None where they need none."""
    out = (ctypes.c_int64 * 23)()
    lib = build.warp_contract_library()
    err = lib.vp_warp_contract_geometry(b, L, P, h, w, c, out)
    if err:
        raise RuntimeError(f"warp_contract_backward: no plan for these sizes: "
                           f"{lib.vp_cuda_error_string(err).decode()} ({err})")
    return torch.empty(out[22], dtype=torch.float32, device=device) if out[22] else None


def _warp_contract_backward_cpu(A: Tensor, Bm: Tensor, img: Tensor,
                                g: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    return warp_contract_backward_reference(A, Bm, img, g)


def _warp_contract_backward_cuda(A, Bm, img, g):
    _check_contract(A, Bm, img, g)
    _check_contract_kernel_operands("warp_contract_backward", A, Bm, img, g)
    b, L, P, h = A.shape
    _, _, w, c = img.shape
    d_A, d_Bm = torch.empty_like(A), torch.empty_like(Bm)
    if not g.numel():
        return d_A.zero_(), d_Bm.zero_(), torch.zeros_like(img)
    bf16 = img.dtype == torch.bfloat16
    if bf16:
        A, Bm, img = _bf16_contract_operands(A, Bm, img)
        g, = _bf16_contract_operands(g)
    cp = img.shape[-1]
    d_img = torch.empty_like(img)
    scratch = _contract_scratch(b, L, P, h, w, cp, img.device) if bf16 else None
    _launch("warp_contract_backward", build.warp_contract_library(), "vp_warp_contract_bwd",
            int(bf16), A, Bm, img, g, d_A, d_Bm, d_img, scratch, b, L, P, h, w, cp)
    warp_contract_backward.launches += 2
    return d_A, d_Bm, d_img if cp == c else d_img[..., :c].contiguous()


def _warp_contract_backward_fake(A, Bm, img, g):
    _check_contract(A, Bm, img, g)
    return torch.empty_like(A), torch.empty_like(Bm), torch.empty_like(img)


_WARP_CONTRACT_BACKWARD = define_op(
    "warp_contract_backward", _warp_contract_backward_cpu, _warp_contract_backward_cuda,
    _warp_contract_backward_fake,
    lambda *args, out_shape=None, **kwargs: 2 * _warp_contract_flops(*args[:3]))


def warp_contract_backward(A, Bm, img, g):
    r""":func:`warp_contract`'s backward: ``(d_A, d_Bm, d_img)`` in the
    inputs' dtype. The operator ``vp_suite_tpu_torch::warp_contract_backward``:
    on CPU tensors it computes
    :func:`warp_contract_backward_reference`; on CUDA tensors it launches
    the two backward kernels (no atomics), which take contiguous operands all
    f32 or all bf16, and raises on anything else."""
    check_device("warp_contract_backward", img)
    return _WARP_CONTRACT_BACKWARD(A, Bm, img, g)


class WarpContractFunction(torch.autograd.Function):
    r""":func:`warp_contract` under autograd: the forward kernel and the
    backward kernels (their plain versions on the CPU). Saves ``A``, ``Bm``
    and the image."""

    @staticmethod
    def forward(ctx, A, Bm, img):
        out = warp_contract_forward(A, Bm, img)
        ctx.save_for_backward(A, Bm, img)
        return out

    @staticmethod
    def backward(ctx, g):
        A, Bm, img = ctx.saved_tensors
        grads = warp_contract_backward(A, Bm, img, g.to(img.dtype).contiguous())
        return tuple(d if need else None for d, need in zip(grads, ctx.needs_input_grad))


def warp_contract(A, Bm, img):
    r"""The warp by prebuilt factor matrices, differentiable:
    ``out[b, l, p, c] = sum_{y, x} A[b, l, p, y] * Bm[b, l, p, x] *
    img[b, y, x, c]``.

    Args:
        A: ``[b, L, P, h]`` row factors, any real values.
        Bm: ``[b, L, P, w]`` column factors.
        img: ``[b, h, w, c]``; on CUDA tensors all three are f32 or all bf16.

    Returns ``[b, L, P, c]`` in ``img.dtype`` (the JAX package's layout).
    With ``A = _onehot_factor(iy, h)`` and ``Bm = _onehot_factor(ix, w)`` it
    is the bilinear warp. Runs :class:`WarpContractFunction`: the CUDA
    kernels on CUDA tensors, their plain versions on CPU tensors.
    """
    _check_contract(A, Bm, img)
    return WarpContractFunction.apply(A.contiguous(), Bm.contiguous(), img.contiguous())


#: Launches of the factor-contraction forward kernel since the count was last set to 0.
warp_contract_forward.launches = 0
#: Launches of its backward kernels (two per call) since the count was last set to 0.
warp_contract_backward.launches = 0
