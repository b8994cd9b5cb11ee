"""Gluon (counterpart of mxnet_tpu/gluon/): the layers, loss and model zoo
that the ported paths run."""
from . import loss, model_zoo, nn
from .block import HybridBlock, collect_params

__all__ = ["HybridBlock", "collect_params", "loss", "model_zoo", "nn"]
