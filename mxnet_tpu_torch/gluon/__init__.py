"""Gluon (counterpart of mxnet_tpu/gluon/): the layers, loss and model zoo
that the ported paths run, `Parameter`/`ParameterDict` and `Trainer`."""
from . import loss, model_zoo, nn
from .block import HybridBlock, collect_params
from .parameter import Parameter, ParameterDict
from .trainer import Trainer

__all__ = ["HybridBlock", "Parameter", "ParameterDict", "Trainer",
           "collect_params", "loss", "model_zoo", "nn"]
