r"""The linear recurrence ``h_t = f_t * h_{t-1} + u_t`` with its time axis split
over a mesh axis (the JAX package's ``ops/scan_parallel.py``): MinConvRNN's
context scan, sharded over ``seq``.

One process runs one device, so each process holds one contiguous block of
the time steps (:func:`sequence_sharding` cuts it from a whole tensor) and:

1. scans its block;
2. all-gathers the blocks' aggregates ``(F, U) = (prod f, last h of the
   block)`` over the ``seq`` axis, in one ``all_gather_into_tensor`` (they carry
   no time dimension: ``1 / t_block`` of the activations);
3. combines the aggregates of the blocks before its own, in order (JAX's
   exclusive prefix-combine, an ``n_seq``-step element-wise loop), into the
   hidden state entering its block, and corrects its block's scan by it:
   ``h = h_local + carry_in * cumprod(f)``.

The gradients are exact: every later block reads the earlier blocks'
aggregates, so the aggregates' gather sums the processes' cotangents over
``seq`` in its backward and returns each block its own (the opposite of the
tp gather of ``parallel/tensor.py``, whose downstream is replicated); ``h0``,
which every block's carry starts from, has its gradient summed over ``seq``
too.

:func:`sequence_block` and :func:`whole_sequence` carry a tensor that every
``seq`` process holds whole (as MinConvRNN's gates are) into its block and
the scanned blocks back into a whole, with the gradients of a replicated
computation: the block's backward gathers the blocks' cotangents, the whole's
takes this process's.
"""
import torch

from vp_suite_tpu_torch.models.min_conv_rnn import linear_recurrence_scan
from vp_suite_tpu_torch.parallel.mesh import axis_size
from vp_suite_tpu_torch.parallel.spatial import coordinate, gather_rows, gather_stacked
from vp_suite_tpu_torch.parallel.tensor import summed_gradient


def _combine(a, b):
    r"""Composition of (decay, update) pairs: ``a`` then ``b``."""
    fa, ua = a
    fb, ub = b
    return fa * fb, ub + fb * ua


def linear_recurrence_scan_sharded(f, u, mesh, axis="seq", h0=None, spec=None):
    r"""``h_t = f_t * h_{t-1} + u_t`` with the time axis split over ``mesh``'s
    ``axis``.

    Args:
        f, u: this process's block of the stacked decay / update tensors,
            time-major ``[t / n, ...]`` (:func:`sequence_sharding`).
        mesh: the ``DeviceMesh`` holding ``axis``.
        axis: the mesh axis the time dimension is split over.
        h0: optional initial hidden state ``[...]`` (broadcast against
            ``f[0]``), held alike by every ``axis`` process; it enters block
            0, and its gradient is summed over ``axis``.
        spec: optional axis names of ``f`` / ``u``'s dimensions where others
            are split too (e.g. ``("seq", "data")`` on a seq x data mesh: each
            process then holds its data rows of ``f``, ``u`` and ``h0``; the
            aggregates' collective still runs over ``axis`` only). Its first
            entry must be ``axis``.

    Returns:
        this process's block of the inclusive scan ``h``, like ``f``.
    """
    if spec is None:
        spec = (axis,)
    if spec[0] != axis:
        raise ValueError(f"spec {spec} must put '{axis}' on the time dim")
    rank, n, group = coordinate(mesh, axis)
    h_local = linear_recurrence_scan(f, u)
    cumf = torch.cumprod(f, 0)
    # the blocks' aggregates: applying a whole block to an incoming carry c
    # gives its last h = cumf[-1] * c + h_local[-1]
    F_all, U_all = gather_rows(torch.stack([cumf[-1], h_local[-1]])[None], 0, mesh,
                               axis).unbind(1)
    # the carry entering this block: h0 advanced through blocks 0 .. rank-1 (every
    # block's aggregates stay in every process's graph, so that all processes
    # run the same collectives in their backward)
    carry_f = torch.ones_like(F_all[0])
    carry_u = torch.zeros_like(U_all[0]) if h0 is None else \
        summed_gradient(h0, group).expand_as(U_all[0]).to(U_all.dtype)
    for j in range(n):
        nf, nu = _combine((carry_f, carry_u), (F_all[j], U_all[j]))
        take = torch.tensor(j < rank, device=nf.device)
        carry_f, carry_u = torch.where(take, nf, carry_f), torch.where(take, nu, carry_u)
    return h_local + carry_u * cumf


def sequence_sharding(mesh, axis="seq", spec=None):
    r"""The function that cuts this process's share from a whole time-major
    ``[t, ...]`` tensor: its block of ``t`` over ``mesh``'s ``axis`` (the JAX
    package's ``NamedSharding(mesh, P(axis))``), and with ``spec`` (axis names
    per dimension, as :func:`linear_recurrence_scan_sharded` takes it) its
    rows of every dimension named there. A dimension must divide by its
    axis's size."""
    spec = (axis,) if spec is None else tuple(spec)

    def shard(x):
        if x.shape[0] % axis_size(mesh, axis):
            raise ValueError(f"time dim {x.shape[0]} must divide mesh axis '{axis}' of size "
                             f"{axis_size(mesh, axis)}")
        for d, name in enumerate(spec):
            if name is None:
                continue
            n = axis_size(mesh, name)
            if x.shape[d] % n:
                raise ValueError(f"dim {d} of {x.shape[d]} must divide mesh axis '{name}' of "
                                 f"size {n}")
            m = x.shape[d] // n
            x = x.narrow(d, mesh.get_local_rank(name) * m, m)
        return x

    return shard


class _Block(torch.autograd.Function):
    r"""This process's block of dim 0 forward; the blocks' cotangents gathered
    into the whole backward."""

    @staticmethod
    def forward(ctx, x, rank, n, group):
        ctx.n, ctx.group = n, group
        m = x.shape[0] // n
        return x[rank * m:(rank + 1) * m].clone()

    @staticmethod
    def backward(ctx, g):
        return gather_stacked(g, ctx.n, ctx.group).flatten(0, 1), None, None, None


class _Whole(torch.autograd.Function):
    r"""The blocks joined along dim 0 forward; this process's block of the
    cotangent backward."""

    @staticmethod
    def forward(ctx, x, rank, n, group):
        ctx.rank, ctx.m = rank, x.shape[0]
        return gather_stacked(x, n, group).flatten(0, 1)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank * ctx.m:(ctx.rank + 1) * ctx.m].contiguous(), None, None, None


def sequence_block(x, mesh, axis="seq"):
    r"""This process's time block of ``x`` ``[t, ...]``, which every ``axis``
    process holds whole; differentiable (the whole gradient on every
    process)."""
    return _Block.apply(x, *coordinate(mesh, axis))


def whole_sequence(x, mesh, axis="seq"):
    r"""The whole ``[t, ...]`` from every ``axis`` process's block ``x``;
    differentiable (each process's downstream computes alike)."""
    return _Whole.apply(x, *coordinate(mesh, axis))
