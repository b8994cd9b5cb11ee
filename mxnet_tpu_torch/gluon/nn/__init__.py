"""Gluon layers (counterpart of mxnet_tpu/gluon/nn/): the ones ResNet V1
is built from."""
from .activations import Activation
from .basic_layers import BatchNorm, Dense, Flatten, HybridSequential
from .conv_layers import Conv2D, GlobalAvgPool2D, MaxPool2D

__all__ = ["Activation", "BatchNorm", "Conv2D", "Dense", "Flatten",
           "GlobalAvgPool2D", "HybridSequential", "MaxPool2D"]
