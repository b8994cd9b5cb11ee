"""Model zoo (counterpart of mxnet_tpu/gluon/model_zoo/): the GPT decoder."""
from .gpt import GPTDecoder

__all__ = ["GPTDecoder"]
