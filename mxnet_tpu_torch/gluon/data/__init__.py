"""Gluon data pipeline (counterpart of mxnet_tpu/gluon/data/): datasets,
samplers, the DataLoader and the vision datasets and transforms, with
the record datasets `RecordFileDataset` and `vision.ImageRecordDataset`."""
from .dataset import *  # noqa: F401,F403
from .sampler import *  # noqa: F401,F403
from .dataloader import *  # noqa: F401,F403
from . import dataloader, dataset, sampler, vision  # noqa: F401
