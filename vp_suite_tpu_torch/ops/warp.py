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
"""
import itertools

import torch

from vp_suite_tpu_torch.kernels import build


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
    r"""What the CUDA kernels take: CUDA tensors, f32 indices, an image (and
    ``g``) all float32 or all bfloat16, contiguous."""
    if img.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, not {img.device}")
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


def warp_sample_forward(iy, ix, img):
    r"""The warp's forward with no autograd: ``[b, P, L, c]`` in
    ``img.dtype``. On CPU tensors it computes :func:`warp_sample_reference`;
    on CUDA tensors it launches the forward kernel, which takes contiguous
    f32 indices and a contiguous bf16 or f32 image, and raises on anything
    else."""
    _check(iy, ix, img)
    if img.device.type == "cpu":
        return warp_sample_reference(iy, ix, img)
    _check_kernel_operands("warp_sample", iy, ix, img)
    b, P, L = iy.shape
    _, h, w, c = img.shape
    out = torch.empty((b, P, L, c), dtype=img.dtype, device=img.device)
    if not out.numel():
        return out
    lib = build.warp_library()
    with torch.cuda.device(img.device):
        err = lib.vp_warp_sample_fwd(int(img.dtype == torch.bfloat16), iy.data_ptr(),
                                     ix.data_ptr(), img.data_ptr(), out.data_ptr(), b, P, L, h, w,
                                     c, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"warp_sample: kernel launch failed: "
                           f"{lib.vp_cuda_error_string(err).decode()} ({err})")
    warp_sample.launches += 1
    return out


def warp_sample_backward(iy, ix, img, g):
    r"""The warp's backward: ``(d_iy, d_ix)`` ``[b, P, L]`` f32 and ``d_img``
    ``[b, h, w, c]`` in ``img.dtype``. On CPU tensors it computes
    :func:`warp_sample_backward_reference`; on CUDA tensors it launches the
    backward kernel (``d_img`` accumulated in f32 with atomics, then rounded),
    which takes contiguous f32 indices and a contiguous bf16 or f32 image and
    ``g`` of one dtype, and raises on anything else."""
    _check(iy, ix, img, g)
    if img.device.type == "cpu":
        return warp_sample_backward_reference(iy, ix, img, g)
    _check_kernel_operands("warp_sample_backward", iy, ix, img, g)
    b, P, L = iy.shape
    _, h, w, c = img.shape
    d_iy = torch.empty(iy.shape, dtype=torch.float32, device=img.device)
    d_ix = torch.empty_like(d_iy)
    d_img = torch.zeros(img.shape, dtype=torch.float32, device=img.device)
    if not g.numel():
        return d_iy, d_ix, d_img.to(img.dtype)
    lib = build.warp_library()
    with torch.cuda.device(img.device):
        err = lib.vp_warp_sample_bwd(int(img.dtype == torch.bfloat16), iy.data_ptr(),
                                     ix.data_ptr(), img.data_ptr(), g.data_ptr(), d_img.data_ptr(),
                                     d_iy.data_ptr(), d_ix.data_ptr(), b, P, L, h, w, c,
                                     torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"warp_sample_backward: kernel launch failed: "
                           f"{lib.vp_cuda_error_string(err).decode()} ({err})")
    warp_sample_backward.launches += 1
    return d_iy, d_ix, d_img.to(img.dtype)


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
