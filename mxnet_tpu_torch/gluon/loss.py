"""Losses (counterpart of mxnet_tpu/gluon/loss.py): SoftmaxCrossEntropyLoss.

A loss returns its per-sample values as an `ndarray.NDArray` when it
records (under `autograd.record()`), so that ``loss.backward()`` seeds
ones as MXNet does, and when its inputs are NDArrays; a plain tensor
otherwise."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import autograd
from ..ndarray import NDArray
from .block import HybridBlock

__all__ = ["SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


def _log_softmax(x, axis):
    """fp32 inner log-softmax for low-precision x, cast back
    (ops/nn.py:81 `_f32_inner`)."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return F.log_softmax(x.float(), dim=axis).to(x.dtype)
    return F.log_softmax(x, dim=axis)


class SoftmaxCrossEntropyLoss(HybridBlock):
    """loss.py:108: log_softmax, then the label's entry (sparse labels,
    taken as integers, as `pick` casts them) or the sum against a dense
    label, times `weight`, averaged over every axis but the batch axis.
    Returns one loss per sample."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, prefix=None):
        super().__init__(prefix=prefix)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits
        self._weight = weight
        self._batch_axis = batch_axis

    def forward(self, pred, label):
        if not self._from_logits:
            pred = _log_softmax(pred, self._axis)
        if self._sparse_label:
            idx = label.long().unsqueeze(self._axis % pred.dim())
            loss = -torch.gather(pred, self._axis, idx)
        else:
            loss = -(pred * label.reshape(pred.shape)).sum(
                dim=self._axis, keepdim=True)
        if self._weight is not None:
            loss = loss * self._weight
        axes = [i for i in range(loss.dim())
                if i != self._batch_axis % loss.dim()]
        loss = loss.mean(dim=axes) if axes else loss
        return NDArray(loss) if autograd.is_recording() else loss


SoftmaxCELoss = SoftmaxCrossEntropyLoss
