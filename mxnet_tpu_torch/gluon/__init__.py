"""Gluon (counterpart of mxnet_tpu/gluon/): `Block`/`HybridBlock`/
`SymbolBlock`,
`Parameter`/`Constant`/`ParameterDict`, `Trainer`, the layers and
losses, `gluon.data`, `gluon.utils` and the model zoo."""
from . import parameter
from .parameter import Constant, Parameter, ParameterDict
from . import block
from .block import Block, HybridBlock, SymbolBlock, collect_params
from . import trainer
from .trainer import Trainer
from . import utils
from . import nn
from . import loss
from . import data
from . import model_zoo
from . import contrib

__all__ = ["Block", "Constant", "HybridBlock", "Parameter", "ParameterDict",
           "SymbolBlock", "Trainer", "collect_params", "contrib", "data",
           "loss", "model_zoo", "nn", "utils"]
