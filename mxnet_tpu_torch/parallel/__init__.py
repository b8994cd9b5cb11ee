"""Training (counterpart of mxnet_tpu/parallel/): `ShardedTrainer` on one
device, and the `FusedUpdater` behind `gluon.Trainer`."""
from .data_parallel import ShardedTrainer
from .fused_update import FusedUpdater

__all__ = ["FusedUpdater", "ShardedTrainer"]
