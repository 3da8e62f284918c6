r"""GPipe pipeline parallelism over a ``pp`` mesh axis (the JAX package's
``parallel/pipeline.py``).

Stages are laid out one per process along the ``pp`` axis; microbatches
stream through them, one hop a step. :func:`gpipe_apply` is one
differentiable function with a replicated output, as JAX's is (its schedule
is one ``lax.scan`` under ``shard_map``), so it is written by hand here rather
than on ``torch.distributed.pipelining``, whose schedules run their own
backward over modules.

Scope: uniform stages (the same activation shape in and out), as in JAX. The
bubble fraction is ``(S - 1) / (M + S - 1)``; choose ``n_micro >> n_stages``.

The collectives, all over the ``pp`` group (gloo runs these with CUDA tensors,
its point-to-point ops not; ``parallel/spatial.py``):

- the activation hop: every process's output all-gathered, each stage taking
  its predecessor's (stage 0 zeros); its backward is the reverse hop, each
  stage taking its successor's cotangent;
- the output: the last stage's stream summed over ``pp``, so that every
  process holds it. Every process then computes the same loss from it, so
  the sum's backward passes the cotangent through unchanged
  (``torch.distributed.nn.functional.all_reduce`` would sum it, and multiply
  every stage's gradient by ``S``);
- the stacked parameters: stage ``k`` reads row ``k``, whose gradient only its
  process computes, so the rows' gradients are all-gathered into the whole
  stacked gradient on every process (and the input's, which only stage 0
  reads, is broadcast from it), as JAX's gradient is one global array.

Every process runs every step of the schedule, bubbles too (on zeros, masked
out with ``torch.where``, as JAX's ``jnp.where``), and keeps every hop in its
graph, so that all processes run the same collectives in the same order,
forward and backward.
"""
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from vp_suite_tpu_torch.parallel.mesh import axis_size
from vp_suite_tpu_torch.parallel.spatial import gather_stacked


def stack_stage_params(params_list):
    r"""Stacks a list of per-stage parameter pytrees (identical structure)
    into one pytree whose leaves have a leading stage dimension: the layout
    :func:`gpipe_apply` takes."""
    leaves, spec = zip(*(tree_flatten(p) for p in params_list))
    return tree_unflatten([torch.stack(xs) for xs in zip(*leaves)], spec[0])


def microbatch(x, n_micro: int):
    r"""Splits a ``[batch, ...]`` tensor into ``[n_micro, batch / n_micro, ...]``."""
    b = x.shape[0]
    if b % n_micro != 0:
        raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
    return x.reshape(n_micro, b // n_micro, *x.shape[1:])


class _Hop(torch.autograd.Function):
    r"""The predecessor stage's ``x`` (stage 0: zeros) forward; the successor
    stage's cotangent (the last stage: zeros) backward."""

    @staticmethod
    def forward(ctx, x, k, n, group):
        ctx.k, ctx.n, ctx.group = k, n, group
        rows = gather_stacked(x[None], n, group)
        return rows[k - 1, 0] if k > 0 else torch.zeros_like(x)

    @staticmethod
    def backward(ctx, g):
        sent = gather_stacked(g[None], ctx.n, ctx.group)
        return (sent[ctx.k + 1, 0] if ctx.k < ctx.n - 1 else torch.zeros_like(g)), None, None, None


class _SumOut(torch.autograd.Function):
    r"""Summed over the group forward; the cotangent unchanged backward (every
    process computes the same loss from the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Rows(torch.autograd.Function):
    r"""Row ``k`` of every stacked leaf forward; the rows' gradients
    all-gathered into every leaf's whole gradient backward (one collective)."""

    @staticmethod
    def forward(ctx, k, n, group, *leaves):
        ctx.n, ctx.group = n, group
        rows = tuple(leaf[k].clone() for leaf in leaves)
        ctx.shapes = [row.shape for row in rows]
        ctx.zeros = [row.new_zeros(()) for row in rows]
        return rows

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([(z.expand(s) if g is None else g).reshape(-1)
                          for g, s, z in zip(grads, ctx.shapes, ctx.zeros)])
        whole = gather_stacked(flat, ctx.n, ctx.group)               # [n, sum of row sizes]
        out, offset = [], 0
        for s in ctx.shapes:
            size = s.numel()
            out.append(whole[:, offset:offset + size].reshape(ctx.n, *s))
            offset += size
        return (None, None, None, *out)


class _FromFirst(torch.autograd.Function):
    r"""The identity forward; the gradient broadcast from the group's first
    process backward (only stage 0 reads the input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.broadcast(g, dist.get_global_rank(ctx.group, 0), group=ctx.group)
        return g, None


def gpipe_apply(stage_fn, stacked_params, x_mb, mesh, axis_name: str = "pp"):
    r"""Runs ``S = mesh``'s ``axis_name`` size stages as a GPipe pipeline over
    the microbatched input.

    Args:
        stage_fn: ``(params_k, x) -> y`` with ``y.shape == x.shape`` (uniform
            stages), applied once per (stage, microbatch) pair.
        stacked_params: a pytree whose leaves have a leading stage dimension
            of size ``S`` (:func:`stack_stage_params`), the same on every
            process; stage ``k`` (this process's coordinate) uses row ``k``.
        x_mb: ``[n_micro, mb, ...]`` microbatched input, the same on every
            process (only stage 0 reads it).
        mesh / axis_name: the mesh (None: one stage) and its pipeline axis.

    Returns:
        ``[n_micro, mb, ...]``, ``stage_{S-1}(... stage_0(x))`` per
        microbatch, on every process. Its gradients reach every leaf of
        ``stacked_params`` whole, and ``x_mb``, on every process.

    Schedule: at step ``t`` stage ``k`` computes microbatch ``t - k`` (valid
    where ``0 <= t - k < M``), so the loop runs ``M + S - 1`` steps;
    activations hop one stage a step. Bubble lanes compute on zeros.
    """
    S, M = axis_size(mesh, axis_name), x_mb.shape[0]
    if S == 1:
        p0 = tree_map(lambda p: p[0], stacked_params)
        return torch.stack([stage_fn(p0, x) for x in x_mb])
    k, group = mesh.get_local_rank(axis_name), mesh.get_group(axis_name)
    leaves, spec = tree_flatten(stacked_params)
    params = tree_unflatten(list(_Rows.apply(k, S, group, *leaves)), spec)
    if x_mb.requires_grad:
        x_mb = _FromFirst.apply(x_mb, group)
    first, last = x_mb.new_tensor(k == 0, dtype=torch.bool), x_mb.new_tensor(k == S - 1,
                                                                             dtype=torch.bool)
    prev, emitted = torch.zeros_like(x_mb[0]), []
    for t in range(M + S - 1):
        recv = _Hop.apply(prev, k, S, group)
        my_in = torch.where(first, x_mb[min(t, M - 1)], recv)
        valid = x_mb.new_tensor(0 <= t - k < M, dtype=torch.bool)
        my_in = torch.where(valid, my_in, torch.zeros_like(my_in))
        out = torch.where(valid, stage_fn(params, my_in), torch.zeros_like(my_in))
        emitted.append(torch.where(last, out, torch.zeros_like(out)))
        prev = out
    # only the last stage emitted non-zeros; the sum replicates its stream
    return _SumOut.apply(torch.stack(emitted), group)[S - 1:]
