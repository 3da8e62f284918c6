r"""Spatial (image-row) parallelism over the ``sp`` axis of a mesh: convolutions
by explicit halo exchange (the JAX package's ``parallel/spatial.py``).

Each process of the ``sp`` axis holds a contiguous block of image rows, a
*slab* (``parallel.mesh.shard_video_batch`` gives it its rows of a batch).
A convolution of a slab fetches the ``O(kernel)`` boundary rows it needs from
its ``sp`` neighbours, zeros at the image's top and bottom (the constant zero
padding of the whole image), and runs a plain local convolution. The JAX
package runs each such conv as a ``shard_map`` region whose ``ppermute``
transposes route the halo cotangents back to their owners; here the exchange
is an ``autograd.Function`` that does the same: its backward returns each
halo row's gradient to the process that owns the row.

The exchange is one ``all_gather_into_tensor`` over the ``sp`` group of each
process's top and bottom boundary rows (each process picks its neighbours'):
the collective that gloo runs with CUDA tensors (several processes on one
card) as NCCL does. Gloo's point-to-point ops do not: ``send`` / ``recv``,
``isend`` / ``irecv`` and ``batch_isend_irecv`` of CUDA tensors fail in
torch 2.11 ("writev ... Bad address"; a probe on an H100, ``PERF.md``).

``nn.functional.conv2d`` / ``conv_transpose2d`` (and so the layer modules)
route here while :func:`spatial_halo_convs` is open. The supported geometry
is JAX's: the "shape-preserving modulo stride" family every model of the zoo
uses (conv: ``kh - 2 ph`` in ``[1, stride]``, so ``H_out = H / stride``;
transposed conv: ``output_padding = stride + 2 ph - kh``, so ``H_out = H *
stride``), zero padding, dilation 1, one group. Anything else raises, as
does a slab of fewer than 2 rows or one that does not cover its halo.

    mesh = make_mesh_nd({"data": 2, "sp": 2})
    with spatial_halo_convs(mesh):
        step = make_train_step(model, run_config, mesh=mesh, use_jit=False)   # reopens it
    state, metrics = step(state, shard_video_batch(batch, mesh))

Ops that are not row-local gather the rows (:func:`gather_rows`, whose
backward sums the cotangents over ``sp`` and returns each process its rows).
"""
from contextlib import contextmanager

import torch
import torch.distributed as dist
import torch.nn.functional as F

_ACTIVE = None  # (mesh, axis) while a spatial_halo_convs context is open


def active_spatial():
    r"""The ``(mesh, axis)`` of the open spatial context, or None."""
    return _ACTIVE


@contextmanager
def spatial_halo_convs(mesh, axis: str = "sp"):
    r"""Routes the port's NHWC convolutions (``nn.functional.conv2d`` and
    ``conv_transpose2d``) through the halo exchange over ``mesh``'s ``axis``
    while open: every 4-D activation is then this process's slab of rows. A
    no-op where the mesh has no such axis or it has size 1."""
    global _ACTIVE
    if mesh is None or axis not in (mesh.mesh_dim_names or ()) \
            or mesh.size(mesh.mesh_dim_names.index(axis)) <= 1:
        yield
        return
    prev, _ACTIVE = _ACTIVE, (mesh, axis)
    try:
        yield
    finally:
        _ACTIVE = prev


@contextmanager
def reopened(active):
    r"""Sets the open spatial context to ``active`` (a ``(mesh, axis)`` that
    :func:`active_spatial` returned, or None) while open: a region run again
    in the backward (``nn.remat``) takes the path its forward took."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, active
    try:
        yield
    finally:
        _ACTIVE = prev


def coordinate(mesh, axis: str = "sp"):
    r"""``(this process's coordinate on mesh's axis, the axis's size, its
    process group)``."""
    return mesh.get_local_rank(axis), mesh.size(mesh.mesh_dim_names.index(axis)), \
        mesh.get_group(axis)


def refuse(what):
    r"""Raises where a spatial context is open: ``what`` is not row-local, and
    a slab must never take the unsharded op."""
    if _ACTIVE is not None:
        raise NotImplementedError(
            f"{what} is not row-local: it has no spatial (sp) form; run it outside "
            f"spatial_halo_convs or on a mesh with sp=1")


def gather_stacked(x, n, group, kind="gather"):
    r"""``[n, *x.shape]``: the ``n`` processes' ``x`` of ``group`` in rank order,
    in one ``all_gather_into_tensor`` (no autograd), noted for :func:`record`
    as ``kind``."""
    x = x.contiguous()
    buf = x.new_empty((n * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(buf, x, group=group)
    _note(kind, buf)
    return buf.view(n, *x.shape)


class _Halo(torch.autograd.Function):
    r"""``[the previous slab's last top rows, x, the next slab's first bottom
    rows]`` along dim 1 (zeros past the image's edges) forward; each halo
    row's gradient sent back to its owner backward."""

    @staticmethod
    def forward(ctx, x, top, bottom, rank, n, group):
        ctx.top, ctx.bottom, ctx.rank, ctx.n, ctx.group = top, bottom, rank, n, group
        parts = ([x[:, x.shape[1] - top:]] if top else []) + ([x[:, :bottom]] if bottom else [])
        rows = gather_stacked(torch.cat(parts, 1), n, group, "halo")   # [n, b, top + bottom, w, c]
        out = [x]
        if top:
            out.insert(0, rows[rank - 1, :, :top] if rank > 0 else x.new_zeros(
                (x.shape[0], top, *x.shape[2:])))
        if bottom:
            out.append(rows[rank + 1, :, top:] if rank < n - 1 else x.new_zeros(
                (x.shape[0], bottom, *x.shape[2:])))
        return torch.cat(out, 1)

    @staticmethod
    def backward(ctx, g):
        top, bottom, rank, n = ctx.top, ctx.bottom, ctx.rank, ctx.n
        hl = g.shape[1] - top - bottom
        dx = g[:, top:top + hl].clone(memory_format=torch.contiguous_format)
        # this process's halo cotangents, [for the previous slab, for the next]
        sent = gather_stacked(torch.cat([g[:, :top], g[:, top + hl:]], 1), n, ctx.group, "halo")
        if top and rank < n - 1:      # the next slab read my last top rows
            dx[:, hl - top:] += sent[rank + 1, :, :top]
        if bottom and rank > 0:       # the previous slab read my first bottom rows
            dx[:, :bottom] += sent[rank - 1, :, top:]
        return dx, None, None, None, None, None


def halo_rows(x, top, bottom, mesh, axis="sp"):
    r"""This process's slab ``x`` ``[n, hl, w, c]`` with ``top`` rows of the
    previous slab above and ``bottom`` rows of the next below (zeros at the
    image's edges); differentiable."""
    if not (top or bottom):
        return x
    rank, n, group = coordinate(mesh, axis)
    return _Halo.apply(x, top, bottom, rank, n, group)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _check_slab(hl, top, bottom, h, n):
    r"""Halos come from the immediate neighbours only, so each slab must cover
    its exports; the JAX package's floor is 2 rows a slab."""
    if hl < 2 or top > hl or bottom > hl:
        raise ValueError(
            f"spatial axis too fine for this layer: H={h} over {n} shards leaves {hl} row(s) per "
            f"device (halo needs top={top}, bottom={bottom}, floor is 2 rows). Use a smaller sp "
            f"axis or a larger image.")


def _check_conv_geometry(kh, s, p):
    if not 1 <= kh - 2 * p <= s:
        raise NotImplementedError(
            f"spatial halo conv supports kh - 2*ph in [1, stride] (H_out = H/stride); got "
            f"kh={kh}, stride={s}, ph={p}")


def halo_conv2d(x, weight, bias, stride, padding, mesh, axis="sp"):
    r"""NHWC convolution (``weight`` ``[out, in, kh, kw]``, zero padding) of
    this process's slab ``x`` ``[n, hl, w, c]`` of an image whose rows are split
    over ``mesh``'s ``axis``: the halo exchange, then a local convolution;
    returns this process's ``hl / stride`` output rows. JAX's geometry and
    refusals (module docstring)."""
    s, p = _pair(stride), _pair(padding)
    kh = weight.shape[2]
    _check_conv_geometry(kh, s[0], p[0])
    n = coordinate(mesh, axis)[1]
    hl = x.shape[1]
    if hl % s[0]:
        raise ValueError(f"local row block {hl} must be divisible by stride {s[0]}")
    top, bottom = p[0], max(0, kh - s[0] - p[0])
    _check_slab(hl, top, bottom, hl * n, n)
    crop = kh - s[0] - p[0] - bottom          # <= 0: rows past the last window
    xh = halo_rows(x, top, bottom, mesh, axis)
    if crop < 0:
        xh = xh[:, :xh.shape[1] + crop]
    y = F.conv2d(xh.permute(0, 3, 1, 2), weight.to(x.dtype), None if bias is None
                 else bias.to(x.dtype), s, (0, p[1]))
    return y.permute(0, 2, 3, 1).contiguous()


def halo_conv_transpose2d(x, weight, bias, stride, padding, output_padding, mesh, axis="sp"):
    r"""NHWC transposed convolution (torch semantics, ``weight`` ``[in, out,
    kh, kw]``) of this process's slab ``x`` ``[n, hl, w, c]``; returns this
    process's ``hl * stride`` output rows. Requires ``output_padding = stride +
    2 padding - kh`` (``H_out = H * stride``)."""
    s, p, op = _pair(stride), _pair(padding), _pair(output_padding)
    kh = weight.shape[2]
    if op[0] != s[0] + 2 * p[0] - kh:
        raise NotImplementedError(
            f"spatial halo convT supports output_padding = stride + 2*pad - kh (H_out = "
            f"H*stride); got kh={kh}, s={s[0]}, p={p[0]}, op={op[0]}")
    n = coordinate(mesh, axis)[1]
    hl = x.shape[1]
    # input halo rows so that every local output row's window is in range: top
    # covers the kh-1-p look-back, bottom the p look-ahead
    rt = -(-(kh - 1 - p[0]) // s[0])
    rb = (p[0] - 1) // s[0] + 1 if p[0] >= 1 else 0
    _check_slab(hl, rt, rb, hl * n, n)
    xh = halo_rows(x, rt, rb, mesh, axis)
    # the whole transposed conv of the haloed rows (row padding 0), whose row
    # kh-1-pt is this slab's first output row (pt: JAX's top padding of the
    # dilated input, negative where JAX crops)
    y = F.conv_transpose2d(xh.permute(0, 3, 1, 2), weight.to(x.dtype), None, s, (0, p[1]),
                           (0, op[1]))
    start = kh - 1 - ((kh - 1 - p[0]) - rt * s[0])
    end = start + hl * s[0]
    if end > y.shape[2]:          # JAX's bottom padding past the dilated rows: zeros
        y = F.pad(y, (0, 0, 0, end - y.shape[2]))
    y = y[:, :, start:end].permute(0, 2, 3, 1).contiguous()
    return y if bias is None else y + bias.to(x.dtype)


class _GatherRows(torch.autograd.Function):
    r"""Every process's block joined along ``dim`` forward; the cotangent
    summed over the group and this process's block of it backward (each
    process's cotangent of the whole comes from its own part of the loss).
    The sum runs in f32 whatever the cotangent's dtype, and a bf16 result is
    rounded once: each process's part keeps the rounding it came with (the
    warp backward rounds its f32 sum once), so at ``sp`` = 2 a bf16 ``d_img``
    is rounded three times where one process's whole-image sum rounds once."""

    @staticmethod
    def forward(ctx, x, dim, rank, n, group):
        ctx.dim, ctx.start, ctx.rows, ctx.group = dim, rank * x.shape[dim], x.shape[dim], group
        parts = gather_stacked(x.movedim(dim, 0), n, group)       # [n, rows, ...]
        return parts.flatten(0, 1).movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        total = g.to(torch.float32, copy=True).contiguous()
        dist.all_reduce(total, group=ctx.group)
        _note("all_reduce", total)
        return (total.narrow(ctx.dim, ctx.start, ctx.rows).to(g.dtype).contiguous(),
                None, None, None, None)


def gather_rows(x, dim, mesh, axis="sp"):
    r"""The whole image from this process's slab ``x`` (rows on ``dim``),
    gathered over ``mesh``'s ``axis`` (or any blocks of ``dim``); differentiable,
    the gradient summed over ``axis`` (see :class:`_GatherRows`)."""
    rank, n, group = coordinate(mesh, axis)
    return _GatherRows.apply(x, dim, rank, n, group)


def own_rows(x, dim, mesh, axis="sp"):
    r"""This process's slab of the whole ``x`` (rows on ``dim``), contiguous."""
    rank, n, _ = coordinate(mesh, axis)
    rows = x.shape[dim] // n
    return x.narrow(dim, rank * rows, rows).contiguous()


# ---------------------------------------------------------------------------
# the exchanges a step ran, for tests and the smoke

_RECORDS = []


@contextmanager
def record():
    r"""Within the context, every collective that the halo exchanges and row
    gathers ran is appended to the yielded list as ``(kind, shape, dtype)`` of
    its buffer: kind ``"halo"`` (a halo exchange's ``all_gather_into_tensor``,
    forward or backward, the gathered buffer), ``"gather"`` (a row gather's
    or another ``gather_stacked``'s) or ``"all_reduce"`` (a row gather's
    backward)."""
    log = []
    _RECORDS.append(log)
    try:
        yield log
    finally:
        _RECORDS.remove(log)


def _note(kind, t):
    for log in _RECORDS:
        log.append((kind, tuple(t.shape), t.dtype))
