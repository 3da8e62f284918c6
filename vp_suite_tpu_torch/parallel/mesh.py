r"""The data axis: a 1-D device mesh over the process group, replicated or
FSDP-sharded parameters, and the batch split along its first dimension.

The JAX package's 1-D ``Mesh`` spans the devices that one process drives,
and XLA inserts the collectives. The port runs one process per device
(:mod:`~vp_suite_tpu_torch.parallel.distributed`), so its mesh is the process
group, as a ``DeviceMesh`` with one axis named ``data``, and the collectives
are explicit:

- parameters and buffers are broadcast from rank 0 and stay replicated
  (:func:`shard_params`), or large ones are sharded by FSDP2
  (:func:`shard_params_fsdp`);
- each process computes its slice of the global batch (:func:`shard_batch`);
- the train step averages the gradients of the replicated parameters over the
  group in one all-reduce after the backward (:func:`all_reduce_gradients`;
  FSDP2 reduce-scatters those of the sharded ones), so no collective
  overlaps a kernel of the backward;
- batch statistics are taken over the global batch
  (``distributed.batch_statistics_over``).

The N-D meshes of the JAX package (``make_mesh_nd``, ``factorize_mesh``,
tensor and spatial sharding) are not ported.
"""
import torch
import torch.distributed as dist

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


def shard_params(model, mesh):
    r"""Broadcasts ``model``'s parameters and buffers from rank 0, so that
    every process of the mesh holds the same replica (the JAX package's
    ``replicated_sharding``); returns ``model``."""
    group = mesh.get_group()
    src = dist.get_global_rank(group, 0)
    with torch.no_grad():
        for t in [*model.parameters(), *model.buffers()]:
            dist.broadcast(t.data, src, group=group)
    return model


def shard_batch(batch, mesh):
    r"""This process's contiguous slice of a global batch dict (rows ``r *
    b / n`` to ``(r + 1) * b / n`` of every tensor and array; the JAX
    package's ``batch_sharding``); the first dimension must divide by the
    mesh's size."""
    n, r = mesh.size(), mesh.get_local_rank()
    out = {}
    for k, v in batch.items():
        if hasattr(v, "shape"):
            if v.shape[0] % n:
                raise ValueError(f"batch '{k}' of {v.shape[0]} not divisible by {n} processes")
            m = v.shape[0] // n
            v = v[r * m:(r + 1) * m]
        out[k] = v
    return out


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


def all_reduce_gradients(params, mesh, extra=None):
    r"""Averages the gradients of ``params`` (plain tensors; those whose
    ``.grad`` is None are skipped, alike on every process) over the mesh in
    one all-reduce of their concatenation, with ``extra`` (a 1-D f32 tensor,
    such as the step's losses) appended; returns ``extra``'s mean."""
    grads = [p.grad for p in params if p.grad is not None]
    dtype = grads[0].dtype if grads else torch.float32
    parts = [g.reshape(-1).to(dtype) for g in grads]
    if extra is not None:
        parts.append(extra.reshape(-1).to(dtype))
    if not parts:
        return extra
    flat = torch.cat(parts)
    dist.all_reduce(flat, group=mesh.get_group())
    flat /= mesh.size()
    offset = 0
    with torch.no_grad():
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
    return flat[offset:] if extra is not None else None


def check_same_gradients(params, mesh):
    r"""Raises unless every process of the mesh has gradients for the same
    parameters (by position; one collective)."""
    if not params:
        return
    present = torch.tensor([p.grad is not None for p in params], dtype=torch.float32)
    device = next((p.device for p in params), torch.device("cpu"))
    both = torch.cat([present, -present]).to(device)
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=mesh.get_group())
    n = len(params)
    if not torch.equal(both[:n], -both[n:]):
        raise RuntimeError("the processes of the data mesh computed gradients for different "
                           "parameters; their all-reduce would mix unrelated tensors")


def mean_over(values: dict, mesh) -> dict:
    r"""``{name: float}`` averaged over the mesh's processes (the mean of
    equal-sized shards' means), in one all-reduce; ``values`` as is
    without a mesh."""
    if mesh is None:
        return values
    names = list(values)
    device = "cuda" if mesh.device_type == "cuda" else "cpu"
    t = torch.tensor([float(values[k]) for k in names], dtype=torch.float64, device=device)
    dist.all_reduce(t, group=mesh.get_group())
    t /= mesh.size()
    return dict(zip(names, t.tolist()))
