"""Losses (counterpart of mxnet_tpu/gluon/loss.py): `Loss` (:49) with
`_apply_weighting` (:30), L2, L1, SigmoidBinaryCrossEntropy,
SoftmaxCrossEntropy, KLDiv, CTC, Huber, Hinge, SquaredHinge, Logistic and
Triplet.

Each loss runs on tensors and returns one value per sample (the mean
over every axis but `batch_axis`, after weighting): `weight` scales it,
`sample_weight` multiplies it elementwise, broadcast as MXNet
broadcasts. It returns an `ndarray.NDArray` when it records (under
`autograd.record()`), so that ``loss.backward()`` seeds ones as MXNet
does, and when its inputs are NDArrays; a plain tensor otherwise.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import autograd
from ..ndarray import NDArray
from .block import HybridBlock

__all__ = ["CTCLoss", "HingeLoss", "HuberLoss", "KLDivLoss", "L1Loss",
           "L2Loss", "LogisticLoss", "Loss", "SigmoidBCELoss",
           "SigmoidBinaryCrossEntropyLoss", "SoftmaxCELoss",
           "SoftmaxCrossEntropyLoss", "SquaredHingeLoss", "TripletLoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    """loss.py:30: loss * sample_weight (broadcast), then * weight."""
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        assert isinstance(weight, (int, float)), "weight must be a number"
        loss = loss * weight
    return loss


def _log_softmax(x, axis):
    """fp32 inner log-softmax for low-precision x, cast back
    (ops/nn.py:81 `_f32_inner`)."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return F.log_softmax(x.float(), dim=axis).to(x.dtype)
    return F.log_softmax(x, dim=axis)


def _softrelu(x):
    return F.softplus(x)


class Loss(HybridBlock):
    """loss.py:49: the base of the losses. A subclass defines
    `_loss(pred, label, *rest)`, the per-element values before
    weighting and the batch mean, or overrides `forward`."""

    def __init__(self, weight, batch_axis, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return "%s(batch_axis=%s, w=%s)" % (type(self).__name__,
                                            self._batch_axis, self._weight)

    def _weight_of(self):
        return self._weight

    def _mean(self, loss):
        axes = [i for i in range(loss.dim())
                if i != self._batch_axis % loss.dim()]
        return loss.mean(dim=axes) if axes else loss

    def _out(self, loss):
        return NDArray(loss) if autograd.is_recording() else loss

    def forward(self, pred, label, sample_weight=None):
        loss = self._loss(pred, label.reshape(pred.shape)
                          if label.numel() == pred.numel() else label)
        loss = _apply_weighting(loss, self._weight_of(), sample_weight)
        return self._out(self._mean(loss))

    def _loss(self, pred, label):
        raise NotImplementedError


class L2Loss(Loss):
    """loss.py:80: 0.5 * (pred - label)^2."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def _weight_of(self):
        return self._weight / 2

    def _loss(self, pred, label):
        return torch.square(pred - label)


class L1Loss(Loss):
    """loss.py:120: |pred - label|."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def _loss(self, pred, label):
        return torch.abs(pred - label)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """loss.py:159: binary cross entropy of sigmoid(pred), in the stable
    form relu(x) - x * z + softrelu(-|x|), or of pred itself when
    `from_sigmoid`."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def _loss(self, pred, label):
        if not self._from_sigmoid:
            return torch.relu(pred) - pred * label + \
                _softrelu(-torch.abs(pred))
        eps = 1e-12
        return -(torch.log(pred + eps) * label
                 + torch.log(1. - pred + eps) * (1. - label))


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """loss.py:108: log_softmax, then the label's entry (sparse labels,
    taken as integers, as `pick` casts them) or the sum against a dense
    label, weighted, averaged over every axis but the batch axis."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = _log_softmax(pred, self._axis)
        if self._sparse_label:
            idx = label.long().unsqueeze(self._axis % pred.dim())
            loss = -torch.gather(pred, self._axis, idx)
        else:
            loss = -(pred * label.reshape(pred.shape)).sum(
                dim=self._axis, keepdim=True)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._out(self._mean(loss))


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    """loss.py:300: label * (log(label + 1e-12) - pred), pred taken as
    log-probabilities (`from_logits`) or logits."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = _log_softmax(pred, self._axis)
        loss = label * (torch.log(label + 1e-12) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._out(self._mean(loss))


class CTCLoss(Loss):
    """loss.py:354: connectionist temporal classification, blank label
    0, labels padded with 0 (or their lengths given). `pred` (N, T, C)
    or (T, N, C) are unnormalised activations. One value per sample,
    not averaged."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        assert layout in ("NTC", "TNC"), \
            "Only 'NTC' and 'TNC' layouts for pred are supported."
        assert label_layout in ("NT", "TN"), \
            "Only 'NT' and 'TN' layouts for label are supported."
        self._layout = layout
        self._label_layout = label_layout
        super().__init__(weight, label_layout.find("N"), **kwargs)

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        if self._layout == "NTC":
            pred = pred.transpose(0, 1)
        if self._batch_axis == 1:
            label = label.transpose(0, 1)
        T, N, _ = pred.shape
        logp = F.log_softmax(pred.float(), dim=-1)
        label = label.long()
        if label_lengths is None:
            label_lengths = (label > 0).sum(dim=1)
        if pred_lengths is None:
            pred_lengths = torch.full((N,), T, dtype=torch.long,
                                      device=pred.device)
        loss = F.ctc_loss(logp, torch.clamp(label, min=0),
                          pred_lengths.long(), label_lengths.long(),
                          blank=0, reduction="none").to(pred.dtype)
        return self._out(_apply_weighting(loss, self._weight,
                                          sample_weight))


class HuberLoss(Loss):
    """loss.py:432: |d| - rho / 2 where |d| > rho, else d^2 / (2 rho)."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def _loss(self, pred, label):
        d = torch.abs(pred - label)
        return torch.where(d > self._rho, d - 0.5 * self._rho,
                           (0.5 / self._rho) * torch.square(d))


class HingeLoss(Loss):
    """loss.py:477: relu(margin - pred * label)."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def _loss(self, pred, label):
        return torch.relu(self._margin - pred * label)


class SquaredHingeLoss(Loss):
    """loss.py:519: relu(margin - pred * label)^2."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def _loss(self, pred, label):
        return torch.square(torch.relu(self._margin - pred * label))


class LogisticLoss(Loss):
    """loss.py:561: log(1 + exp(-pred * label)) for signed labels (-1,
    1), in the stable form; binary labels (0, 1) with
    ``label_format="binary"``."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format
        if label_format not in ("signed", "binary"):
            raise ValueError("label_format can only be signed or binary, "
                             "received %s." % label_format)

    def _loss(self, pred, label):
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        return torch.relu(pred) - pred * label + _softrelu(-torch.abs(pred))


class TripletLoss(Loss):
    """loss.py:613: relu(sum(|pred - positive|^2 - |pred - negative|^2)
    + margin), the sum over every axis but the batch axis."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, positive, negative):
        positive = positive.reshape(pred.shape)
        negative = negative.reshape(pred.shape)
        d = torch.square(pred - positive) - torch.square(pred - negative)
        axes = [i for i in range(d.dim())
                if i != self._batch_axis % d.dim()]
        loss = torch.relu(d.sum(dim=axes) + self._margin)
        return self._out(_apply_weighting(loss, self._weight, None))
