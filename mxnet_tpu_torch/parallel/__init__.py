"""Training (counterpart of mxnet_tpu/parallel/): `ShardedTrainer` on one
device, the `FusedUpdater` and the fused exchange + update step
(`fused_step`) behind `gluon.Trainer`, the fusion buckets (`bucketing`)
and the cross-process KVStore (`kvstore_dist`)."""
from .data_parallel import ShardedTrainer
from .fused_update import FusedUpdater

__all__ = ["FusedUpdater", "ShardedTrainer"]
