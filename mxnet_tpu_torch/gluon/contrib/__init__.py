"""Gluon contrib (counterpart of mxnet_tpu/gluon/contrib/): the
concurrent containers that the model zoo builds on."""
from . import nn  # noqa: F401
