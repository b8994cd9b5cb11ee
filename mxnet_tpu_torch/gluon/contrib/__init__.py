"""Gluon contrib (counterpart of mxnet_tpu/gluon/contrib/): the
concurrent containers that the model zoo builds on, and `data`'s
IntervalSampler."""
from . import data, nn  # noqa: F401
