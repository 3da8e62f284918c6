r"""Bilinear grid sampling and flow warping of NHWC tensors, around the warp
kernels of :mod:`vp_suite_tpu_torch.ops.warp`.

The semantics are torch ``grid_sample``'s with ``align_corners=False`` and
``padding_mode='zeros'``, as TrajGRU's trajectory warps use them (reference
``vp_suite/model_blocks/traj_gru.py:149-164``). Every function here turns its
grid or flows into fractional source indices and runs
:func:`~vp_suite_tpu_torch.ops.warp.warp_sample` (the CUDA kernels on CUDA
tensors, their plain versions on CPU tensors), so none of them calls
``torch.nn.functional.grid_sample``. Layouts are pixel-major: multi-flow
results are ``[b, h, w, L*c]`` (channel blocks in flow order) and ``ret``'s
gate pre-activations ``[b, h, w, O]``, where the JAX package's kernels are
channel-major.
"""
import torch

from vp_suite_tpu_torch.nn.remat import named
from vp_suite_tpu_torch.ops.warp import warp_sample


def grid_sample(img, grid):
    r"""Samples ``img`` ``[b, h, w, c]`` at normalized grid locations ``grid``
    ``[b, h_out, w_out, 2]`` (last axis (x, y) in [-1, 1], torch's
    convention); returns ``[b, h_out, w_out, c]``, zero outside the image."""
    b, h, w, c = img.shape
    _, h_out, w_out, _ = grid.shape
    grid = grid.float()
    # align_corners=False unnormalization: ix = ((x + 1) * W - 1) / 2
    ix = ((grid[..., 0] + 1.0) * w - 1.0) / 2.0
    iy = ((grid[..., 1] + 1.0) * h - 1.0) / 2.0
    out = warp_sample(iy.reshape(b, h_out * w_out, 1), ix.reshape(b, h_out * w_out, 1), img)
    return out.view(b, h_out, w_out, c)


def _onehot_factor(i_frac, n, dtype):
    r"""Weighted one-hot factor of one axis of a bilinear sample: ``[...]``
    fractional indices -> ``[..., n]`` in ``dtype``, with weight ``1 - frac``
    at ``floor(i)`` and ``frac`` at ``floor(i) + 1``, zero outside ``[0,
    n-1]``. The index math runs in f32 (bf16 stops holding integers at 256);
    the JAX package's ``grid_sample._onehot_factor``, bit for bit. With one
    factor per axis, :func:`~vp_suite_tpu_torch.ops.warp.warp_contract` is
    the warp."""
    i_frac = i_frac.float()
    i0 = torch.floor(i_frac)
    w1 = i_frac - i0
    w0 = 1.0 - w1
    i1 = i0 + 1.0
    v0 = (i0 >= 0) & (i0 <= n - 1)
    v1 = (i1 >= 0) & (i1 <= n - 1)
    iota = torch.arange(n, dtype=torch.float32, device=i_frac.device)
    fac = (w0 * v0)[..., None] * (iota == i0[..., None]) \
        + (w1 * v1)[..., None] * (iota == i1[..., None])
    return fac.to(dtype)


def _flow_to_indices(img, flows):
    r"""``[b, h, w, 2L]`` pixel-space flows ((dx, dy) pairs) -> fractional
    source indices ``iy``, ``ix`` ``[b, h*w, L]`` f32: torch's round trip
    through a normalized grid and ``align_corners=False``, ``v * dim/(dim-1) -
    1/2``. The operations run in f32 in the JAX package's order, ``(xx + f) *
    (w / (w-1)) - 0.5``: an index one ulp from an integer floors the other way
    under another order, which leaves the warp continuous but moves its index
    gradient by O(1)."""
    b, h, w, _ = img.shape
    L = flows.shape[-1] // 2
    f = flows.reshape(b, h, w, L, 2).float()
    xx = torch.arange(w, dtype=torch.float32, device=flows.device).view(1, 1, w, 1)
    yy = torch.arange(h, dtype=torch.float32, device=flows.device).view(1, h, 1, 1)
    ix = (xx + f[..., 0]) * (w / max(w - 1, 1)) - 0.5
    iy = (yy + f[..., 1]) * (h / max(h - 1, 1)) - 0.5
    return iy.reshape(b, h * w, L), ix.reshape(b, h * w, L)


def warp_flow(img, flow):
    r"""Warps ``img`` ``[b, h, w, c]`` along one dense flow field ``flow``
    ``[b, h, w, 2]`` (pixel-space offsets, (dx, dy)); returns ``[b, h, w, c]``.
    TrajGRU's ``_warp`` semantics: the grid is normalized in ``img``'s dtype
    as torch does (``2 * v / max(dim-1, 1) - 1``), then sampled."""
    b, h, w, _ = flow.shape
    xx = torch.arange(w, dtype=img.dtype, device=img.device).view(1, 1, w)
    yy = torch.arange(h, dtype=img.dtype, device=img.device).view(1, h, 1)
    gx = 2.0 * (xx + flow[..., 0]) / max(w - 1, 1) - 1.0
    gy = 2.0 * (yy + flow[..., 1]) / max(h - 1, 1) - 1.0
    return grid_sample(img, torch.stack([gx, gy], dim=-1))


def warp_flow_multi(img, flows):
    r"""Warps ``img`` ``[b, h, w, c]`` along L flow fields ``flows`` ``[b, h,
    w, 2L]`` at once; returns ``[b, h, w, L*c]``, the concatenation of
    ``warp_flow(img, flows[..., 2l:2l+2])`` over l."""
    b, h, w, _ = img.shape
    iy, ix = _flow_to_indices(img, flows)
    return warp_sample(iy, ix, img).view(b, h, w, -1)


def warp_flow_ret(img, flows, w, bias):
    r"""TrajGRU's L trajectory warps followed by its 1x1 ``ret`` conv:
    ``conv1x1(warp_flow_multi(img, flows), w, bias)``.

    Args:
        img: ``[b, h, w, c]``; its dtype is the compute dtype.
        flows: ``[b, h, w, 2L]`` pixel-space offsets, (dx, dy) pairs.
        w: ``[L*c, O]`` ret weights (input channel ``l*c + k`` is channel k
            of warp l), cast to ``img``'s dtype.
        bias: ``[O]``.

    Returns ``[b, h, w, O]`` gate pre-activations in ``img``'s dtype: the
    warps' ``[b*P, L*c]`` output times ``w`` as one GEMM, bias added in its
    epilogue. Under autograd the warp tensor is saved for ``w``'s gradient,
    as the JAX package saves it; it is named ``"warp_ret_warped"``
    (``nn.remat.named``), so that a checkpointed step keeps it and does not
    launch the warp again.
    """
    b, h, wd, c = img.shape
    iy, ix = _flow_to_indices(img, flows)
    warped = named("warp_ret_warped", warp_sample, iy, ix, img)   # [b, P, L, c]
    out = torch.addmm(bias.to(img.dtype), warped.view(b * h * wd, -1), w.to(img.dtype))
    return out.view(b, h, wd, -1)
