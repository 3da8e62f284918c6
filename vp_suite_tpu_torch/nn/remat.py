r"""Rematerialisation: what autograd keeps of a region for the backward, and
what it computes again there.

The counterpart of the JAX package's ``jax.checkpoint``,
``jax.ad_checkpoint.checkpoint_name`` and
``jax.checkpoint_policies.save_only_these_names``:

- :func:`checkpoint` runs ``fn(*args)`` as a region of
  ``torch.utils.checkpoint`` (non-reentrant): autograd keeps the region's
  input tensors and none of its intermediates, and the backward runs the
  region again to rebuild them. With ``saved`` names, the outputs of the
  :func:`named` calls under those names are kept as well, and the run in the
  backward takes each from the op that made it in the forward instead of
  running that op again (a selective checkpoint whose policy saves the named
  tensors and recomputes the rest);
- :func:`named` is ``fn(*args)``, its output named (``checkpoint_name`` of
  it);
- :func:`recompute_saved` keeps a tensor that autograd would save as the
  inputs it was made from, and makes it again when the backward reads it
  (outside any region: what JAX's policy recomputes of a step whose other
  parts the port keeps).

As JAX's ``remat`` does nothing in a forward without a gradient, a region
runs as a plain call where ``torch.is_grad_enabled()`` is false: ``predict``,
the evaluation step and the exported programs launch what they launch
without it.

A named output is kept by keeping the output of the op inside ``fn`` that
allocated its storage (a view's base op): the backward's run of ``fn`` then
returns that output where the forward ran the op, so a convolution or a
kernel launch whose output is named does not run again, while ``fn``'s other
ops (casts, views) do. Only the ops of ``fn`` pass through the dispatch
modes that do this, so the rest of a region pays no Python per op. The
``named`` calls of a region are matched by their order, the ops of one by
their order per operator, as PyTorch's own selective checkpoint matches
them; a matched op whose inputs differ in shape from the forward's raises,
and so does a kept output written in place. A named output whose op had
several outputs keeps all of them.

The backward's run reopens what the forward's saw: the spatial context
(``parallel.spatial``), the group of the batch statistics
(``parallel.distributed``) and the tensor-parallel gather scope as it stood
at the region's start (``parallel.tensor``), so that it takes the same path
and runs the same collectives in the same order on every process. A region
must not draw random numbers: no RNG state is saved or restored (that would
read the generator's state inside a CUDA-graph capture); the models draw
their masks and coins outside their regions.
"""
import contextlib

import torch
from torch.utils import checkpoint as _checkpoint
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map_only, tree_unflatten

from vp_suite_tpu_torch.parallel import distributed, spatial
from vp_suite_tpu_torch.parallel import tensor as tp

#: ops whose count differs between the forward and the backward's run
_IGNORED = getattr(_checkpoint, "SAC_IGNORED_OPS", {torch.ops.aten.detach.default})

_REGIONS = []     # the regions with named outputs whose forward or backward run is open
_OBSERVERS = []   # lists open in ``observe``
_ALIASES = {}


def named(name: str, fn, *args):
    r"""``fn(*args)``, its output named ``name``: a region whose ``saved``
    holds ``name`` keeps it for the backward and does not run the op that made
    it again (``jax.ad_checkpoint.checkpoint_name`` of the output)."""
    if not _REGIONS or name not in _REGIONS[-1].saved:
        return fn(*args)
    return _REGIONS[-1].run(fn, args)


@contextlib.contextmanager
def observe():
    r"""Within the context, every tensor that a region keeps for the backward
    (its input tensors and its named outputs) and every tensor that
    :func:`recompute_saved` keeps is appended to the yielded list; what
    autograd saves elsewhere reaches ``torch.autograd.graph.saved_tensors_hooks``
    as usual."""
    seen = []
    _OBSERVERS.append(seen)
    try:
        yield seen
    finally:
        _OBSERVERS.remove(seen)


@contextlib.contextmanager
def recompute_saved(t, fn, *inputs):
    r"""Within the context, autograd saves any view of ``t`` (the output of
    ``fn(*inputs)``) as ``inputs`` and builds it again with ``fn`` when the
    backward reads it: a concatenation that a convolution saves as its input
    is kept as its parts, as JAX's ``remat`` keeps the step's inputs and
    recomputes the concatenation. Nothing else changes, and nothing at all
    where ``torch.is_grad_enabled()`` is false."""
    if not torch.is_grad_enabled():
        yield
        return
    key = _storage_key(t)

    def pack(saved):
        if saved.numel() and _storage_key(saved) == key:
            _observed(_tensors(inputs))
            return fn, inputs, saved.shape, saved.stride(), saved.storage_offset()
        _observed([saved])
        return saved

    def unpack(packed):
        if isinstance(packed, torch.Tensor):
            return packed
        fn_, inputs_, size, stride, offset = packed
        return fn_(*inputs_).as_strided(size, stride, offset)

    with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
        yield


def _observed(tensors):
    for seen in _OBSERVERS:
        seen.extend(tensors)


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _storage_key(t):
    return t.device, t.untyped_storage().data_ptr()


def _aliases(func):
    r"""Whether ``func`` returns a view of (or writes into) an input."""
    if func not in _ALIASES:
        _ALIASES[func] = any(r.alias_info is not None for r in func._schema.returns)
    return _ALIASES[func]


def _inputs(args, kwargs):
    r"""An op's tensor arguments, and those in its list arguments (``cat``)."""
    out = []
    for a in (*args, *(kwargs or {}).values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


class _Named:
    r"""One region's named outputs: for each :func:`named` call of its
    forward, in order, the op that made the output and that op's output;
    handed back, in the same order, in the backward's run."""

    def __init__(self, saved):
        self.saved = frozenset(saved)
        self.kept = []        # per named call: ((op, index), input shapes, output, versions)
        self.replaying = False
        self.calls = 0        # named calls of the backward's run so far

    def run(self, fn, args):
        if self.replaying:
            entry = self.kept[self.calls] if self.calls < len(self.kept) else None
            self.calls += 1
            if entry is None:    # its output was a view of an input, kept as such
                return fn(*args)
            with _Replay(entry):
                return fn(*args)
        with _Record() as record:
            out = fn(*args)
        self.kept.append(record.keep(out))
        return out


class _Record(TorchDispatchMode):
    r"""A named call's ops in a region's forward: notes the op that allocated
    each storage, and keeps the output of the one that made the call's
    output (an op's one output by its geometry on that storage; the outputs
    of an op with several, which are few and small, by reference)."""

    def __init__(self):
        super().__init__()
        self.counts = {}
        self.made = {}       # storage -> ((op, index), input shapes, output geometry or outputs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _IGNORED:
            return out
        index = self.counts[func] = self.counts.get(func, -1) + 1
        if _aliases(func):
            return out
        leaves = [out] if isinstance(out, torch.Tensor) else _tensors(out)
        inputs = _inputs(args, kwargs)
        keys = {_storage_key(t) for t in inputs}
        if isinstance(out, torch.Tensor):
            made = (out.shape, out.stride(), out.storage_offset())
        else:
            made = tree_map_only(torch.Tensor, torch.Tensor.detach, out)
        for t in leaves:
            key = _storage_key(t)
            if t.numel() and key not in keys:   # not a view of an input
                self.made[key] = ((func, index), tuple(x.shape for x in inputs), made)
        return out

    def keep(self, x):
        r"""The entry that hands ``x``'s op's output back, or None where no op
        of the call made ``x``'s storage (a view of an input: kept as such)."""
        entry = self.made.get(_storage_key(x)) if isinstance(x, torch.Tensor) and x.numel() \
            else None
        if entry is None:
            return None
        op, shapes, out = entry
        if isinstance(out, tuple) and isinstance(out[0], torch.Size):
            size, stride, offset = out
            with torch.no_grad():
                out = x.detach().new_empty(0).set_(x.untyped_storage(), offset, size, stride)
        leaves = _tensors(out)
        _observed(leaves)
        return op, shapes, out, [t._version for t in leaves]


class _Replay(TorchDispatchMode):
    r"""A named call's ops in the backward's run: the op that made its
    output returns the forward's output instead of running."""

    def __init__(self, entry):
        super().__init__()
        self.op, self.shapes, self.out, self.versions = entry
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _IGNORED:
            return func(*args, **(kwargs or {}))
        index = self.counts[func] = self.counts.get(func, -1) + 1
        if (func, index) != self.op:
            return func(*args, **(kwargs or {}))
        got = tuple(x.shape for x in _inputs(args, kwargs))
        if got != self.shapes:
            raise RuntimeError(f"remat: the backward's run of a named call reached {func} "
                               f"#{index} with inputs {got}, the forward with {self.shapes}")
        if [t._version for t in _tensors(self.out)] != self.versions:
            raise RuntimeError(f"remat: the kept output of {func} was written in place")
        return self.out


class _Open:
    r"""A region's forward (or backward's run) with named outputs: its
    :func:`named` calls record (or hand back)."""

    def __init__(self, named_):
        self.named = named_

    def __enter__(self):
        _REGIONS.append(self.named)

    def __exit__(self, *exc):
        _REGIONS.remove(self.named)


class _Reopened:
    r"""Reopens, around the backward's run of a region, what the region's
    forward saw (and its named outputs, to hand back)."""

    def __init__(self, named_=None):
        self.active = spatial.active_spatial()
        self.group = distributed._BATCH_GROUP.get()
        scope = tp._SCOPE.get()
        self.scope = None if scope is None else dict(scope)
        self.named = named_

    def __enter__(self):
        self.stack = stack = contextlib.ExitStack()
        stack.enter_context(spatial.reopened(self.active))
        stack.enter_context(distributed.batch_statistics_over(self.group))
        stack.callback(tp._SCOPE.reset,
                       tp._SCOPE.set(None if self.scope is None else dict(self.scope)))
        if self.named is not None:
            self.named.replaying, self.named.calls = True, 0
            stack.enter_context(_Open(self.named))
        return self

    def __exit__(self, *exc):
        return self.stack.__exit__(*exc)


def checkpoint(fn, *args, saved=()):
    r"""``fn(*args)`` (``args`` may nest tensors in lists, tuples and dicts)
    as a region: autograd keeps its input tensors, and the outputs of its
    :func:`named` calls under a name in ``saved``; the backward runs it again
    for the rest. Where ``torch.is_grad_enabled()`` is false it is
    ``fn(*args)``."""
    if not torch.is_grad_enabled():
        return fn(*args)
    leaves, spec = tree_flatten(args)
    _observed(_tensors(leaves))
    if saved:
        named_ = _Named(saved)
        contexts = lambda: (_Open(named_), _Reopened(named_))
    else:
        contexts = lambda: (contextlib.nullcontext(), _Reopened())
    return _checkpoint.checkpoint(lambda *flat: fn(*tree_unflatten(list(flat), spec)),
                                  *leaves, use_reentrant=False, preserve_rng_state=False,
                                  context_fn=contexts)
