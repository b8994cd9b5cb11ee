"""Training (counterpart of mxnet_tpu/parallel/): `ShardedTrainer` on one
device with its meshes (`mesh`) and input prefetcher (`prefetch`), the
`FusedUpdater` and the fused exchange + update step (`fused_step`) behind
`gluon.Trainer`, the fusion buckets (`bucketing`) and the cross-process
KVStore (`kvstore_dist`)."""
from .mesh import (Mesh, NamedSharding, PartitionSpec, current_mesh,
                   data_parallel_mesh, make_mesh, put_sharded,
                   replica_devices, replicated, shard_on, use_mesh)
from .data_parallel import ShardedTrainer
from .fused_update import FusedUpdater
from .prefetch import DevicePrefetcher, stage_databatch

__all__ = ["DevicePrefetcher", "FusedUpdater", "Mesh", "NamedSharding",
           "PartitionSpec", "ShardedTrainer", "current_mesh",
           "data_parallel_mesh", "make_mesh", "put_sharded",
           "replica_devices", "replicated", "shard_on", "stage_databatch",
           "use_mesh"]
