"""Gluon data pipeline (counterpart of mxnet_tpu/gluon/data/): datasets,
samplers, the DataLoader and the vision datasets and transforms.
`RecordFileDataset` and `vision.ImageRecordDataset` wait for the
recordio port."""
from .dataset import *  # noqa: F401,F403
from .sampler import *  # noqa: F401,F403
from .dataloader import *  # noqa: F401,F403
from . import dataloader, dataset, sampler, vision  # noqa: F401
