r"""Device meshes over the process group: the data axis (replicated or
FSDP-sharded parameters, the batch split along its first dimension) and the
N-D ``data`` x ``sp`` x ``tp`` meshes with tensor parallelism.

The JAX package's ``Mesh`` spans the devices that one process drives,
and XLA inserts the collectives. The port runs one process per device
(:mod:`~vp_suite_tpu_torch.parallel.distributed`), so its mesh is the process
group, as a ``DeviceMesh``, and the collectives are explicit:

- parameters and buffers are broadcast from rank 0 and stay replicated
  (:func:`shard_params`), or large ones are sharded by FSDP2
  (:func:`shard_params_fsdp`);
- each process computes its slice of the global batch (:func:`shard_batch`,
  :func:`shard_video_batch`): the rows of its ``data`` coordinate;
- the train step averages the gradients of the replicated parameters over the
  ``data`` axis in one all-reduce after the backward (:func:`all_reduce_gradients`;
  FSDP2 reduce-scatters those of the sharded ones), so no collective
  overlaps a kernel of the backward;
- batch statistics are taken over the global batch
  (``distributed.batch_statistics_over`` the ``data`` sub-group);
- on an N-D mesh (:func:`make_mesh_nd`, :func:`factorize_mesh`), the layers'
  out-channels are split over ``tp`` (:func:`shard_params_tp`, and with FSDP2
  over ``data`` on top, :func:`shard_params_tp_fsdp`); the layers compute
  column-parallel or gather at use (:mod:`~vp_suite_tpu_torch.parallel.tensor`).

Spatial sharding (``sp`` > 1; the JAX package's ``parallel/spatial.py`` halo
convolutions) is not ported: a mesh may name the axis, but every function
that would shard over it raises.
"""
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from vp_suite_tpu_torch.parallel.distributed import is_grouped, process_count


def local_device_count(device_type: str = "cuda") -> int:
    r"""The devices of ``device_type`` this host can reach (one process runs
    on each); 1 for the CPU."""
    return torch.cuda.device_count() if device_type == "cuda" else 1


def make_mesh(num_devices: int = 0, axis_name: str = "data", device_type: str = "cuda"):
    r"""The data mesh: a ``DeviceMesh`` with the one axis ``axis_name`` over
    the whole process group (``num_devices`` 0, or the group's size); None
    without a group, where one process runs one device (``num_devices`` 0 or
    1). Raises for another ``num_devices``: each device needs a process of its
    own."""
    world = process_count()
    if not is_grouped():
        if num_devices > 1:
            raise ValueError(
                f"num_devices={num_devices} needs {num_devices} processes, one per device: start "
                f"them with `torchrun --nproc-per-node {num_devices}` and train with "
                f"multihost=True")
        return None
    if num_devices and num_devices != world:
        raise ValueError(f"a data mesh spans the whole group of {world} processes, "
                         f"not {num_devices}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (world,), mesh_dim_names=(axis_name,))


def make_mesh_nd(axis_sizes: dict, device_type: str = "cuda"):
    r"""An N-D ``DeviceMesh`` over the whole process group from an ordered
    ``{axis name: size}`` dict such as ``{"data": 2, "sp": 1, "tp": 2}`` (the
    JAX package's ``make_mesh_nd``; axes of size 1 are kept). The ranks fill
    it row-major, as JAX reshapes its device list: with the axes in that
    order, rank ``r`` has ``tp`` coordinate ``r % tp`` and ``data`` coordinate
    ``r // (sp * tp)``. One process runs one device, so the sizes' product
    must equal the group's size; without a group, a mesh whose sizes are all 1
    is None."""
    n = 1
    for v in axis_sizes.values():
        n *= int(v)
    if not is_grouped():
        if n > 1:
            raise ValueError(f"a mesh of {dict(axis_sizes)} needs {n} processes, one per device: "
                             f"start them with `torchrun --nproc-per-node {n}`")
        return None
    if n != process_count():
        raise ValueError(f"a mesh of {dict(axis_sizes)} spans {n} processes, not the group's "
                         f"{process_count()}: one process runs one device")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(int(v) for v in axis_sizes.values()),
                            mesh_dim_names=tuple(axis_sizes))


def factorize_mesh(n_devices: int, strategy: str = "tp") -> dict:
    r"""Splits ``n_devices`` into ``data`` x ``sp`` x ``tp`` sizes as the JAX
    package does: a factor of 2 for the model-parallel axis named by
    ``strategy`` (``"tp"``, out-channels; ``"sp"``, spatial), the rest to
    ``data``; odd counts give pure data parallelism. ``sp`` and ``tp`` are
    never both above 1."""
    if strategy not in ("sp", "tp"):
        raise ValueError(f"strategy {strategy!r} is neither 'sp' nor 'tp'")
    mp = 2 if n_devices % 2 == 0 else 1
    axes = {"data": n_devices // mp, "sp": 1, "tp": 1}
    axes[strategy] = mp
    return axes


def axis_size(mesh, name: str) -> int:
    r"""The size of ``mesh``'s axis ``name``; 1 for no mesh or no such axis."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def _data_axis(mesh):
    r"""The name of ``mesh``'s data axis: ``data``, or the one axis of a 1-D
    mesh (:func:`make_mesh`'s ``axis_name``); None where it has none."""
    names = mesh.mesh_dim_names or ()
    if "data" in names:
        return "data"
    return names[0] if len(names) == 1 and names[0] not in ("sp", "tp") else None


def data_coordinate(mesh):
    r"""``(this process's data coordinate, the data axis's size)``: which rows
    of a global batch it holds, of how many shares; ``(0, 1)`` for no mesh."""
    axis = None if mesh is None else _data_axis(mesh)
    if axis is None:
        return 0, 1
    return mesh.get_local_rank(axis), axis_size(mesh, axis)


def data_group(mesh):
    r"""The process group of this process's ``data`` axis: the processes that
    hold other rows of the batch and the same ``sp`` and ``tp`` coordinates;
    None for no mesh or a mesh without a data axis."""
    axis = None if mesh is None else _data_axis(mesh)
    return None if axis is None else mesh.get_group(axis)


def check_train_mesh(mesh):
    r"""Refuses a mesh with an active spatial axis (``sp`` > 1) for training,
    as the JAX package does (there because XLA doubles conv kernel gradients
    under spatial sharding). The port has no spatial sharding yet: it comes
    with the spatial slice (``parallel/spatial.py``'s halo convolutions),
    which decides whether this refusal stays."""
    sp = axis_size(mesh, "sp")
    if sp > 1:
        raise ValueError(
            f"mesh with active spatial axis (sp={sp}) cannot train: spatial sharding is not "
            f"ported (it comes with the spatial slice, parallel/spatial.py's halo convolutions); "
            f"train on a data x tp mesh (factorize_mesh(n, strategy='tp'))")


def shard_params(model, mesh):
    r"""Broadcasts ``model``'s parameters and buffers from rank 0, so that
    every process of the mesh holds the same replica (the JAX package's
    ``replicated_sharding``); returns ``model``."""
    group = mesh.get_group() if mesh.ndim == 1 else None   # an N-D mesh spans the group
    src = dist.get_global_rank(group, 0) if group is not None else 0
    with torch.no_grad():
        for t in [*model.parameters(), *model.buffers()]:
            dist.broadcast(t.data, src, group=group)
    return model


def shard_batch(batch, mesh):
    r"""This process's contiguous slice of a global batch dict (rows ``r *
    b / n`` to ``(r + 1) * b / n`` of every tensor and array, ``r`` its data
    coordinate of ``n``; the JAX package's ``batch_sharding``): every ``tp``
    process of one data coordinate gets the same rows. The first dimension
    must divide by ``n``."""
    r, n = data_coordinate(mesh)
    out = {}
    for k, v in batch.items():
        if hasattr(v, "shape"):
            if v.shape[0] % n:
                raise ValueError(f"batch '{k}' of {v.shape[0]} not divisible by {n} processes")
            m = v.shape[0] // n
            v = v[r * m:(r + 1) * m]
        out[k] = v
    return out


def shard_video_batch(batch, mesh):
    r"""This process's share of a ``[b, t, h, w, c]`` video batch dict (the
    JAX package's ``video_batch_sharding``): the batch over ``data`` as
    :func:`shard_batch` splits it. The JAX package splits the height over
    ``sp``; that comes with the spatial slice, so ``sp`` > 1 raises."""
    sp = axis_size(mesh, "sp")
    if sp > 1:
        raise ValueError(f"sharding a video batch's height over sp={sp} is not ported: it comes "
                         f"with the spatial slice (parallel/spatial.py)")
    return shard_batch(batch, mesh)


def _refuse_sp_tp(mesh):
    tp, sp = axis_size(mesh, "tp"), axis_size(mesh, "sp")
    if tp > 1 and sp > 1:
        raise ValueError(
            f"refusing to tensor-shard params on a mesh with an active spatial axis (sp={sp}, "
            f"tp={tp}): the JAX package's XLA miscompiles >1x1 convs with spatially-sharded "
            f"inputs and channel-sharded kernels, and the port has no spatial sharding; train on "
            f"factorize_mesh(n, strategy='tp')")
    return tp


def _tp_plan(model, tp, min_channels):
    r"""``{name: (port dim of each JAX dim, or None)}`` for every parameter
    and ``{name: port dim}`` of those that JAX's ``shard_params_tp`` rule
    shards over ``tp``: the JAX leaf's last dimension, where it divides by
    ``tp`` and is at least ``max(tp, min_channels)``."""
    from vp_suite_tpu_torch.utils.jax_params import leaf_axes
    axes = leaf_axes(model)
    params = dict(model.named_parameters())
    dims = {}
    for name, ax in axes.items():
        if ax is None or tp < 2:
            continue
        n = params[name].shape[ax[-1]]
        if n % tp == 0 and n >= max(tp, min_channels):
            dims[name] = ax[-1]
    return axes, dims


def _install_tp(model, mesh, dims):
    from vp_suite_tpu_torch.parallel.tensor import install
    shard_params(model, mesh)
    return install(model, dims, mesh)


def shard_params_tp(model, mesh, min_channels: int = 0):
    r"""Megatron-style out-channel sharding over the mesh's ``tp`` axis (the
    JAX package's ``shard_params_tp``), by JAX's rule on JAX's layout: every
    parameter whose JAX leaf's last dimension (a layer's out-channels) divides
    by ``tp`` and is at least ``max(tp, min_channels)`` keeps only this
    process's contiguous slice of the port dimension that holds it (dim 0 of
    a conv, dense or norm weight and of a 1-D vector, dim 1 of a transposed
    conv's ``[in, out, kh, kw]`` weight and of a ConvLSTM's peepholes
    ``[1, enc, h, w]``; ``utils.jax_params.leaf_axes``); every other parameter,
    and every buffer, stays whole. Parameters and buffers are first broadcast
    from rank 0. The layers then compute column-parallel or gather at use
    (:mod:`~vp_suite_tpu_torch.parallel.tensor`). Build the optimizer after
    this (``training.train_state``): its moments are local too. Does nothing
    on a mesh of one ``tp`` process. Refuses ``sp`` x ``tp`` with the JAX
    package's ``ValueError`` ("miscompiles", an XLA fault); whether the port
    keeps that refusal is decided by the spatial slice, which brings ``sp``.
    Returns ``model``."""
    tp = _refuse_sp_tp(mesh)
    if tp < 2:
        return model
    return _install_tp(model, mesh, _tp_plan(model, tp, min_channels)[1])


def shard_params_tp_fsdp(model, mesh, min_size: int = 4096):
    r"""2-D parameter sharding on a ``data`` x ``tp`` mesh (the JAX package's
    ``shard_params_tp_fsdp``): the out-channels over ``tp`` as
    :func:`shard_params_tp` splits them, and every parameter of at least
    ``min_size`` elements (its whole size, not its tp shard's, so that the same
    leaves are 2-D as in JAX) also over ``data``, by FSDP2's ``fully_shard``
    over the ``data`` sub-mesh: on the port dimension that holds the last of
    the JAX leaf's dimensions that divides by ``data`` and is not split over
    ``tp``; parameters without one stay whole over ``data``. A parameter that
    JAX holds with more dimensions (PredFormer's attention kernels) is split
    over ``data`` on its dim 0 where that divides. Build the optimizer after
    this. Does nothing on a mesh of one process. Returns ``model``."""
    tp = _refuse_sp_tp(mesh)
    data = axis_size(mesh, "data")
    if mesh is None or tp * data < 2:
        return model
    axes, dims = _tp_plan(model, tp, 0)
    placement = {}
    for name, p in model.named_parameters():
        ax = axes[name]
        if data < 2 or p.numel() < min_size:
            continue
        if ax is None:
            if p.shape[0] % data == 0:
                placement[name] = 0
            continue
        for d in reversed(ax):
            if d != dims.get(name) and p.shape[d] % data == 0:
                placement[name] = d
                break
    if tp > 1:
        _install_tp(model, mesh, dims)
    else:
        shard_params(model, mesh)
    if not placement:
        return model
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard
    params = dict(model.named_parameters())
    dim_of = {id(params[name]): d for name, d in placement.items()}
    whole = {p for p in params.values() if id(p) not in dim_of}
    fully_shard(model, mesh=mesh["data"], ignored_params=whole or None,
                shard_placement_fn=lambda p: Shard(dim_of[id(p)]))
    return model


def shard_params_fsdp(model, mesh, min_size: int = 4096):
    r"""ZeRO-style sharding over the data axis with FSDP2's ``fully_shard``:
    every parameter of at least ``min_size`` elements becomes a DTensor of
    which each process holds 1/n of the rows (dimension 0; FSDP2 pads the
    last shards where n does not divide it), with its gradient and its
    optimizer state; the smaller ones stay whole and replicated (FSDP2's
    ``ignored_params``: the train step all-reduces their gradients). The
    whole model is one FSDP unit: its forward gathers every sharded
    parameter, which stays gathered through the backward (FSDP2 does not
    reshard its root after the forward), so every ``autograd.Function`` of a
    kernel reads plain, gathered tensors in its backward too. Does nothing
    on a mesh of one process, as the JAX package does; returns ``model``.
    Build the optimizer after this (``training.train_state``)."""
    if mesh is None or mesh.size() < 2:
        return model
    from torch.distributed.fsdp import FSDPModule, fully_shard
    if isinstance(model, FSDPModule):
        return model
    small = {p for p in model.parameters() if p.numel() < min_size}
    fully_shard(model, mesh=mesh, ignored_params=small or None)
    return model


def is_fsdp(model) -> bool:
    r"""Whether ``model`` was sharded by :func:`shard_params_fsdp`."""
    from torch.distributed.fsdp import FSDPModule
    return isinstance(model, FSDPModule)


def _average(tensors, group, extra=None):
    r"""Averages ``tensors`` in place over ``group`` in one all-reduce of their
    concatenation (in the first one's dtype), with ``extra`` appended;
    returns ``extra``'s mean."""
    parts = [t.reshape(-1).to(tensors[0].dtype if tensors else torch.float32) for t in tensors]
    if extra is not None:
        parts.append(extra.reshape(-1).to(parts[0].dtype if parts else torch.float32))
    if not parts:
        return extra
    flat = torch.cat(parts)
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    offset = 0
    with torch.no_grad():
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
    return flat[offset:] if extra is not None else None


def all_reduce_gradients(params, mesh, extra=None):
    r"""Averages the gradients of ``params`` (plain tensors: replicated
    parameters and each process's own tp shards; those whose ``.grad`` is
    None are skipped, alike on every process) over the mesh's ``data`` axis
    in one all-reduce of their concatenation, with ``extra`` (a 1-D f32
    tensor, such as the step's losses) appended; returns ``extra``'s mean.
    The ``tp`` processes of one data coordinate hold different slices of the
    sharded parameters, so the sum runs over ``data`` only."""
    group = data_group(mesh)
    if group is None:
        return extra
    return _average([p.grad for p in params if p.grad is not None], group, extra)


def average_over_tp(params, mesh):
    r"""Averages the gradients of ``params`` (those that ``tp`` leaves whole;
    FSDP2's by their local shards; a ``.grad`` of None is skipped, alike on
    every process) over the mesh's ``tp`` axis in one all-reduce. Every tp
    process computes them from the same replicated activations, but a card's
    non-deterministic kernels (cuDNN's weight gradients) round them apart:
    averaged, every tp process takes the same update and the replicas stay
    equal, as JAX's one replicated value does. Nothing on a mesh of one tp
    process."""
    grads = [p.grad.to_local() if isinstance(p.grad, DTensor) else p.grad
             for p in params if p.grad is not None]
    if axis_size(mesh, "tp") > 1 and grads:
        _average(grads, mesh.get_group("tp"))


def check_same_gradients(params, mesh):
    r"""Raises unless every process of the mesh's ``data`` axis has gradients
    for the same parameters (by position; one collective)."""
    group = data_group(mesh)
    if not params or group is None:
        return
    present = torch.tensor([p.grad is not None for p in params], dtype=torch.float32)
    device = next((p.device for p in params), torch.device("cpu"))
    both = torch.cat([present, -present]).to(device)
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=group)
    n = len(params)
    if not torch.equal(both[:n], -both[n:]):
        raise RuntimeError("the processes of the data mesh computed gradients for different "
                           "parameters; their all-reduce would mix unrelated tensors")


def mean_over(values: dict, mesh) -> dict:
    r"""``{name: float}`` averaged over the processes of the mesh's ``data``
    axis (the mean of equal-sized shards' means), in one all-reduce;
    ``values`` as is without one."""
    group = data_group(mesh)
    if group is None:
        return values
    names = list(values)
    device = "cuda" if mesh.device_type == "cuda" else "cpu"
    t = torch.tensor([float(values[k]) for k in names], dtype=torch.float64, device=device)
    dist.all_reduce(t, group=group)
    t /= dist.get_world_size(group)
    return dict(zip(names, t.tolist()))
