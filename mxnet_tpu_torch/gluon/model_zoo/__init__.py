"""Model zoo (counterpart of mxnet_tpu/gluon/model_zoo/): the GPT decoder
and the vision models."""
from . import vision
from .gpt import GPTDecoder

__all__ = ["GPTDecoder", "vision"]
