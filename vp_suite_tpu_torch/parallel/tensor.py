r"""Tensor parallelism over the ``tp`` axis of an N-D mesh (Megatron-style).

:func:`~vp_suite_tpu_torch.parallel.mesh.shard_params_tp` keeps, of every
parameter it shards, only this process's slice of the dimension that holds
the JAX leaf's last one (a layer's out-channels): a plain tensor, so the
optimizer and its moments are local too. The JAX package leaves the
resharding to XLA; here it is explicit, in two forms:

- **column-parallel compute**: a conv or dense layer whose weight is sharded
  computes its own out-channels from its local shard (:func:`column_parallel`)
  and all-gathers the output along channels in tp-rank order. Its input enters
  through an identity whose backward sums the input gradient over ``tp`` (each
  rank's covers its own channels only); the gather's backward takes this
  rank's slice, with no sum: everything downstream runs replicated, so every
  rank already holds the whole gradient. ``nn.functional``'s convs and the
  layers of ``nn.layers`` take this path when given a sharded weight
  (:func:`local_param` hands one out);
- **gather at use**: any other read of a sharded parameter (``module.weight``,
  a peephole, a norm scale, the hidden weight that the fused scan kernels hold
  resident) returns the whole tensor, gathered, whose backward again takes this
  rank's slice. So no model computes on a local shard by accident. A module
  that owns a sharded parameter has its class swapped for a subclass whose
  ``__getattr__`` gathers (:func:`install`); within the sharded root model's
  forward each parameter is gathered at most once.

Both gathers run ``all_gather_into_tensor`` over the ``tp`` group: on NCCL, and
on gloo with CUDA tensors (several processes on one card), where it runs in
torch 2.11 as the all-reduce and the list all-gather do (a probe on an H100,
``PERF.md``), while ``torch.distributed.nn.functional.all_gather`` would be
wrong here anyway: its backward reduce-scatters, which multiplies every
upstream gradient by ``tp``.
"""
import contextlib
import contextvars
import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor


@dataclasses.dataclass(frozen=True)
class TPSpec:
    r"""A tp-sharded parameter: its name in the root model, the dimension
    split over ``tp``, that dimension's whole length, this process's
    coordinate in the ``tp`` group of ``size`` processes, and the N-D mesh."""
    name: str
    dim: int
    full: int
    rank: int
    size: int
    group: object = dataclasses.field(compare=False, repr=False)
    mesh: object = dataclasses.field(compare=False, repr=False)

    @property
    def local(self) -> int:
        return self.full // self.size


def all_gather(x, dim, size, group):
    r"""The ``size`` processes' ``x`` of ``group``, joined along ``dim`` in
    rank order (no autograd)."""
    x = x.contiguous()
    buf = x.new_empty((size * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(buf, x, group=group)
    _note("gather", buf)
    return buf if dim == 0 else torch.cat(buf.view(size, *x.shape).unbind(0), dim)


class _Gather(torch.autograd.Function):
    r"""All-gather along ``dim`` forward; this rank's slice backward, no sum."""

    @staticmethod
    def forward(ctx, x, dim, rank, size, group):
        ctx.dim, ctx.start, ctx.n = dim, rank * x.shape[dim], x.shape[dim]
        return all_gather(x, dim, size, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.start, ctx.n).contiguous(), None, None, None, None


class _Enter(torch.autograd.Function):
    r"""Identity forward; the gradient summed over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        _note("all_reduce", g)
        return g, None


def summed_gradient(x, group):
    r"""``x`` (held alike by every process of ``group``, each using it for its
    own part), whose gradient the backward sums over ``group``."""
    return _Enter.apply(x, group)


def gather(x, spec: TPSpec, dim=None):
    r"""``x``, this rank's slice along ``dim`` (default ``spec.dim``) of a
    tensor split like ``spec``'s parameter, made whole; differentiable."""
    dim = spec.dim if dim is None else dim % x.dim()
    return _Gather.apply(x, dim, spec.rank, spec.size, spec.group)


def tp_spec(t):
    r"""The :class:`TPSpec` of a local shard handed out by :func:`local_param`
    (or of a slice of it tagged by :func:`tagged`); None for any other tensor."""
    return getattr(t, "_tp_spec", None)


def tagged(t, spec):
    r"""``t`` (a slice of a local shard along another dimension, or the shard)
    marked as split like ``spec``; returns ``t``."""
    if spec is not None:
        t._tp_spec = spec
    return t


def local_param(module, name):
    r"""``module``'s parameter ``name`` as it is stored: this process's shard,
    marked with its :class:`TPSpec`, where it is tp-sharded, else the whole
    parameter (None for an absent bias)."""
    p = module._parameters[name]
    spec = module.__dict__.get("_tp_specs", {}).get(name)
    return p if spec is None or p is None else tagged(p, spec)


def layer_params(module):
    r"""``(weight, bias)`` of a conv or dense layer as its forward takes them:
    both this process's shards where the weight is tp-sharded (its bias, of
    the same length, is too), else both whole (a bias gathered at use where
    it alone is sharded)."""
    if not module.__dict__.get("_tp_specs"):
        return module.weight, module.bias
    weight = local_param(module, "weight")
    return weight, local_param(module, "bias") if tp_spec(weight) is not None else module.bias


def column_parallel(fn, x, weight, bias, gather_output=True):
    r"""``fn(x, weight, bias)`` of a layer whose output channels lie on the
    last dimension of its result. With a sharded ``weight`` (and ``bias``,
    sharded alike or None), it computes this rank's out-channels only, on an
    input whose gradient is summed over ``tp``, and gathers them (or, with
    ``gather_output=False``, returns them local); otherwise it is ``fn``."""
    spec = tp_spec(weight)
    if spec is None:
        return fn(x, weight, bias)
    y = fn(summed_gradient(x, spec.group), weight, bias)
    _note("column", y, spec)
    return gather(y, spec, -1) if gather_output else y


# ---------------------------------------------------------------------------
# gather at use

_SCOPE = contextvars.ContextVar("tp_gather_scope", default=None)
_CLASSES = {}


def _tp_class(cls):
    r"""``cls`` with a ``__getattr__`` that gathers its sharded parameters
    (not FSDP2's DTensor form of one, which FSDP2 reads back itself and no
    layer computes on)."""
    if cls not in _CLASSES:
        def __getattr__(self, name):
            if name in self.__dict__.get("_tp_specs", ()) \
                    and not isinstance(self._parameters[name], DTensor):
                return gathered(self, name)
            return cls.__getattr__(self, name)
        _CLASSES[cls] = type(f"TP{cls.__name__}", (cls,), {"__getattr__": __getattr__})
    return _CLASSES[cls]


def gathered(module, name):
    r"""The whole of ``module``'s sharded parameter ``name``, gathered over
    ``tp`` (once per forward of the sharded root model); differentiable."""
    spec, p = module._tp_specs[name], module._parameters[name]
    scope = _SCOPE.get()
    key = (id(module), name)
    if scope is not None and key in scope and scope[key][0] is p:
        return scope[key][1]
    full = gather(p, spec)
    _note("use", full, spec)
    if scope is not None:
        scope[key] = (p, full)
    return full


def _open_scope(module, args):
    module._tp_scope_token = _SCOPE.set({})


def _close_scope(module, args, output):
    _SCOPE.reset(module._tp_scope_token)


def install(root, dims, mesh):
    r"""Shards ``root``'s parameters ``{name: dim}`` over the ``tp`` axis of
    ``mesh``: each becomes a new parameter holding this process's contiguous
    slice of ``dim``, its module's class gains the gather at use, and
    ``root``'s forward a scope in which each is gathered once. The parameters
    must already be equal on every process; a model sharded before is left as
    it is."""
    if sharded_params(root):
        return root
    rank, size, group = mesh.get_local_rank("tp"), mesh["tp"].size(), mesh.get_group("tp")
    modules = dict(root.named_modules())
    for name, dim in dims.items():
        mname, _, pname = name.rpartition(".")
        module = modules[mname]
        p = module._parameters[pname]
        n = p.shape[dim] // size
        with torch.no_grad():
            shard = p.detach().narrow(dim, rank * n, n).clone()
        module._parameters[pname] = torch.nn.Parameter(shard, requires_grad=p.requires_grad)
        specs = module.__dict__.setdefault("_tp_specs", {})
        specs[pname] = TPSpec(name, dim, p.shape[dim], rank, size, group, mesh)
        if type(module) not in _CLASSES.values():
            module.__class__ = _tp_class(type(module))
    if dims:
        root.register_forward_pre_hook(_open_scope)
        root.register_forward_hook(_close_scope, always_call=True)
    return root


def sharded_params(model):
    r"""``{name: TPSpec}`` of ``model``'s tp-sharded parameters."""
    return {spec.name: spec for m in model.modules()
            for spec in m.__dict__.get("_tp_specs", {}).values()}


def whole(name, t, specs):
    r"""``t`` (the state of parameter ``name``: the parameter or a moment of
    the same shape) made whole where ``name`` is tp-sharded (no autograd;
    every process of the ``tp`` group must call it alike)."""
    spec = specs.get(name)
    if spec is None or not torch.is_tensor(t) or t.dim() <= spec.dim \
            or t.shape[spec.dim] != spec.local:
        return t
    return all_gather(t.detach(), spec.dim, spec.size, spec.group)


# ---------------------------------------------------------------------------
# what a step ran, for tests and the smoke

_RECORDS = []


@contextlib.contextmanager
def record():
    r"""Within the context, every column-parallel output, gather at use and
    collective is appended to the yielded list as ``(kind, name, shape,
    dtype)``: kind ``"column"`` (the layer's local output before its gather;
    ``name`` its weight's), ``"use"`` (a whole parameter), ``"gather"`` or
    ``"all_reduce"`` (a collective's buffer; name None)."""
    log = []
    _RECORDS.append(log)
    try:
        yield log
    finally:
        _RECORDS.remove(log)


def _note(kind, t, spec=None):
    for log in _RECORDS:
        log.append((kind, None if spec is None else spec.name, tuple(t.shape), t.dtype))
