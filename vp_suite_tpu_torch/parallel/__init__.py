r"""Data-parallel and multi-process training (one process per device), FSDP
and the N-D mesh with tensor parallelism; see :mod:`.distributed`,
:mod:`.mesh` and :mod:`.tensor`."""
from vp_suite_tpu_torch.parallel.distributed import (ProcessShard, initialize_multihost,
                                                     local_batch_size, process_count,
                                                     process_index, shard_dataset_for_process)
from vp_suite_tpu_torch.parallel.mesh import (check_train_mesh, factorize_mesh,
                                              local_device_count, make_mesh, make_mesh_nd,
                                              shard_batch, shard_params, shard_params_fsdp,
                                              shard_params_tp, shard_params_tp_fsdp,
                                              shard_video_batch)

__all__ = ["ProcessShard", "check_train_mesh", "factorize_mesh", "initialize_multihost",
           "local_batch_size", "local_device_count", "make_mesh", "make_mesh_nd",
           "process_count", "process_index", "shard_batch", "shard_dataset_for_process",
           "shard_params", "shard_params_fsdp", "shard_params_tp", "shard_params_tp_fsdp",
           "shard_video_batch"]
