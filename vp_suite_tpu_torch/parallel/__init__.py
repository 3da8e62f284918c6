r"""Data-parallel and multi-process training (one process per device), FSDP
and the N-D mesh with tensor, spatial and pipeline parallelism; see
:mod:`.distributed`, :mod:`.mesh`, :mod:`.tensor`, :mod:`.spatial` and
:mod:`.pipeline` (the context scan sharded over time is
:mod:`vp_suite_tpu_torch.ops.scan_parallel`)."""
from vp_suite_tpu_torch.parallel.distributed import (ProcessShard, initialize_multihost,
                                                     local_batch_size, process_count,
                                                     process_index, shard_dataset_for_process)
from vp_suite_tpu_torch.parallel.mesh import (check_train_mesh, factorize_mesh,
                                              local_device_count, make_mesh, make_mesh_nd,
                                              shard_batch, shard_params, shard_params_fsdp,
                                              shard_params_tp, shard_params_tp_fsdp,
                                              shard_video_batch)
from vp_suite_tpu_torch.parallel.pipeline import gpipe_apply, microbatch, stack_stage_params
from vp_suite_tpu_torch.parallel.spatial import (active_spatial, gather_rows, halo_conv2d,
                                                 halo_conv_transpose2d, spatial_halo_convs)

__all__ = ["ProcessShard", "active_spatial", "check_train_mesh", "factorize_mesh", "gather_rows",
           "gpipe_apply", "halo_conv2d", "halo_conv_transpose2d", "initialize_multihost",
           "local_batch_size", "local_device_count", "make_mesh", "make_mesh_nd", "microbatch",
           "process_count", "process_index", "shard_batch", "shard_dataset_for_process",
           "shard_params", "shard_params_fsdp", "shard_params_tp", "shard_params_tp_fsdp",
           "shard_video_batch", "spatial_halo_convs", "stack_stage_params"]
