"""Training (counterpart of mxnet_tpu/parallel/): `ShardedTrainer` on one
device."""
from .data_parallel import ShardedTrainer

__all__ = ["ShardedTrainer"]
