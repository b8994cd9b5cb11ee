"""The minimal `NDArray`: a `torch.Tensor` subclass for a loss's output
(counterpart of mxnet_tpu/ndarray/ndarray.py's `backward`, `asnumpy`,
`asscalar`).

MXNet's ``loss.backward()`` on a per-sample loss seeds a head gradient of
ones; torch's ``Tensor.backward()`` refuses a non-scalar. A loss under
`autograd.record()` therefore returns its output as this type (made with
``as_subclass`` at the loss's output only; layers pass plain tensors),
whose `backward` is `autograd.backward`. Operations on it keep the type,
so ``loss.mean().asscalar()`` works. The rest of NDArray (the operator
registry, contexts, sparse storage) is not ported yet.
"""
from __future__ import annotations

import torch

from ..base import MXNetError

__all__ = ["NDArray"]


class NDArray(torch.Tensor):
    """A tensor with MXNet's `backward`, `asnumpy` and `asscalar`."""

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        """Gradients of this array into every parameter it reaches
        (`autograd.backward`); `out_grad` None seeds ones."""
        from .. import autograd
        autograd.backward(self, out_grad, retain_graph=retain_graph,
                          train_mode=train_mode)

    def asnumpy(self):
        """A numpy copy on the host (bf16 as float32: numpy has no
        bfloat16)."""
        t = self.detach().cpu().as_subclass(torch.Tensor)
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    def asscalar(self):
        """The value of a one-element array as a Python number."""
        if self.numel() != 1:
            raise MXNetError("asscalar needs an array of one element, got "
                             "shape %s" % (tuple(self.shape),))
        return self.asnumpy().reshape(()).item()
