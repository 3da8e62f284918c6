r"""Multi-process training: the process group and each process's share of the data.

The JAX package drives every device of a host from one process and joins
hosts with ``jax.distributed.initialize``. The port follows PyTorch's idiom
instead: one process per device, joined in a ``torch.distributed`` process
group. Start one process per card with ``torchrun``:

    torchrun --nproc-per-node 4 train.py      # train.py:
        from vp_suite_tpu_torch import VPSuite
        from vp_suite_tpu_torch.parallel import initialize_multihost
        initialize_multihost()                # reads torchrun's RANK, WORLD_SIZE, LOCAL_RANK, ...
        suite = VPSuite()                     # after it: the model goes to cuda:LOCAL_RANK
        ...
        suite.train(multihost=True, ...)

Each process reads its shard of the dataset (:func:`shard_dataset_for_process`)
at its share of the global batch (:func:`local_batch_size`).
"""
import contextlib
import contextvars
import os

import torch
import torch.distributed as dist


def is_grouped() -> bool:
    r"""Whether this process belongs to an initialised process group."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    r"""This process's rank in the group; 0 without a group."""
    return dist.get_rank() if is_grouped() else 0


def process_count() -> int:
    r"""The number of processes in the group; 1 without a group."""
    return dist.get_world_size() if is_grouped() else 1


def initialize_multihost(coordinator_address=None, num_processes=None, process_id=None,
                         device="cuda", backend=None):
    r"""Joins this process to the default process group; returns ``(rank,
    world size)``. A no-op that returns them when a group already exists.

    The arguments default to torchrun's environment: ``coordinator_address``
    ``"host:port"`` to ``MASTER_ADDR`` and ``MASTER_PORT``, ``num_processes``
    to ``WORLD_SIZE`` and ``process_id`` to ``RANK``. ``device`` is the
    suite's device type: for ``"cuda"`` the process binds ``cuda:LOCAL_RANK``
    and the group runs NCCL, for ``"cpu"`` gloo; ``backend`` overrides the
    backend (gloo also takes CUDA tensors, and admits several processes on one
    card, which NCCL refuses)."""
    if is_grouped():
        return process_index(), process_count()
    env = os.environ
    given = {"MASTER_ADDR": coordinator_address, "MASTER_PORT": coordinator_address,
             "RANK": process_id, "WORLD_SIZE": num_processes}
    missing = [k for k, v in given.items() if v is None and k not in env]
    if missing:
        raise ValueError(f"multi-process training needs torchrun's {', '.join(missing)} in the "
                         f"environment, or initialize_multihost's arguments")
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    rank = int(env["RANK"] if process_id is None else process_id)
    world = int(env["WORLD_SIZE"] if num_processes is None else num_processes)
    device_type = torch.device(device).type
    kwargs = {}
    if device_type == "cuda":
        local = torch.device("cuda", int(env.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(local)
        if (backend or "nccl") == "nccl":
            kwargs["device_id"] = local
    dist.init_process_group(backend or ("nccl" if device_type == "cuda" else "gloo"),
                            init_method=f"tcp://{coordinator_address}", rank=rank,
                            world_size=world, **kwargs)
    return process_index(), process_count()


class ProcessShard:
    r"""A strided view of a dataset for one process: item ``i`` is the
    dataset's item ``i * num_shards + shard_id`` (stride sharding keeps the
    shards balanced for ordered datasets). Every shard has the floor length,
    so that every process takes the same number of steps per epoch (the
    collectives of a step would wait forever otherwise); fewer than
    ``num_shards`` items are dropped."""

    def __init__(self, dataset, shard_id: int = None, num_shards: int = None):
        self.dataset = dataset
        self.shard_id = process_index() if shard_id is None else shard_id
        self.num_shards = process_count() if num_shards is None else num_shards

    def __len__(self):
        return len(self.dataset) // self.num_shards

    def __getitem__(self, i):
        return self.dataset[i * self.num_shards + self.shard_id]

    def __getattr__(self, item):
        return getattr(self.dataset, item)


def shard_dataset_for_process(dataset, shard_id=None, num_shards=None):
    r"""Wraps a dataset so that each process sees only its shard of it."""
    return ProcessShard(dataset, shard_id, num_shards)


def local_batch_size(global_batch_size: int) -> int:
    r"""This process's share of a global batch."""
    count = process_count()
    if global_batch_size % count != 0:
        raise ValueError(f"global batch {global_batch_size} not divisible by {count} processes")
    return global_batch_size // count


_BATCH_GROUP = contextvars.ContextVar("batch_statistics_group", default=None)


@contextlib.contextmanager
def batch_statistics_over(group):
    r"""Within the context, batch statistics (``nn.layers.BatchNorm`` in
    training) are taken over the batch of every process of ``group``, as the
    JAX package's are over a batch sharded across its mesh; ``None`` keeps
    them per process."""
    token = _BATCH_GROUP.set(group)
    try:
        yield
    finally:
        _BATCH_GROUP.reset(token)


def batch_statistics_group():
    r"""The group set by :func:`batch_statistics_over`, when it spans more
    than one process; else None."""
    group = _BATCH_GROUP.get()
    return group if group is not None and dist.get_world_size(group) > 1 else None
