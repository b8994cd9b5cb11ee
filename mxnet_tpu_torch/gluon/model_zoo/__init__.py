"""Model zoo (counterpart of mxnet_tpu/gluon/model_zoo/): the vision
models with `get_model`, the pretrained-weight store, and the GPT
decoder."""
from . import model_store, vision
from .gpt import GPTDecoder
from .vision import get_model

__all__ = ["GPTDecoder", "get_model", "model_store", "vision"]
