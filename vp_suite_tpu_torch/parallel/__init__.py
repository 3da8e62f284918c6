r"""Data-parallel and multi-process training (one process per device) and
FSDP; see :mod:`.distributed` and :mod:`.mesh`."""
from vp_suite_tpu_torch.parallel.distributed import (ProcessShard, initialize_multihost,
                                                     local_batch_size, process_count,
                                                     process_index, shard_dataset_for_process)
from vp_suite_tpu_torch.parallel.mesh import (local_device_count, make_mesh, shard_batch,
                                              shard_params, shard_params_fsdp)

__all__ = ["ProcessShard", "initialize_multihost", "local_batch_size", "local_device_count",
           "make_mesh", "process_count", "process_index", "shard_batch",
           "shard_dataset_for_process", "shard_params", "shard_params_fsdp"]
