"""Gluon layers (counterpart of mxnet_tpu/gluon/nn/)."""
from .activations import *  # noqa: F401,F403
from .basic_layers import *  # noqa: F401,F403
from .conv_layers import *  # noqa: F401,F403
from . import activations, basic_layers, conv_layers  # noqa: F401
