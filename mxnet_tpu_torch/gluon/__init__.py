"""Gluon (counterpart of mxnet_tpu/gluon/): only the model zoo's GPT so far."""
from . import model_zoo

__all__ = ["model_zoo"]
