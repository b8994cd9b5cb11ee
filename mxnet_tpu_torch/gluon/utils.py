"""Gluon utilities (counterpart of mxnet_tpu/gluon/utils.py): split_data
(:25), split_and_load (:47), clip_global_norm (:83), check_sha1, download
(:122).

`clip_global_norm` is one plain reduction over the arrays (the JAX
package jits it, :61): the squared norms summed in fp32 in the arrays'
order, one host read of the total, then an in-place rescale.
`download` copies a local ``file://`` URL or returns a file that is
already there, and raises otherwise: nothing is fetched over a network.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import warnings

import numpy as np
import torch

from .. import ndarray
from ..ndarray import NDArray

__all__ = ["check_sha1", "clip_global_norm", "download", "split_and_load",
           "split_data"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """Split an NDArray into `num_slice` slices along `batch_axis`
    (utils.py:25)."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices "
            "along axis %d. Use a batch size that's multiple of %d or set "
            "even_split=False to allow uneven partitioning of data." % (
                str(data.shape), num_slice, batch_axis, num_slice))
    step = size // num_slice
    if not even_split and size < num_slice:
        step = 1
        num_slice = size
    slices = []
    for i in range(num_slice):
        begin = i * step
        end = (i + 1) * step if i < num_slice - 1 else size
        slices.append(data.slice_axis(axis=batch_axis, begin=begin, end=end))
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split an array into len(ctx_list) slices and put each on its
    context (utils.py:47)."""
    if not isinstance(data, NDArray):
        data = ndarray.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Rescale the arrays (NDArrays or tensors) in place so that the 2-norm
    of all of them together is at most `max_norm`; returns that norm
    before the rescale (utils.py:83)."""
    assert len(arrays) > 0
    ts = [a._data if isinstance(a, NDArray) else a for a in arrays]
    with torch.no_grad():
        total = torch.zeros((), dtype=torch.float32, device=ts[0].device)
        for t in ts:
            total = total + torch.square(t.float()).sum().to(total.device)
        sumsq = float(total)
    total_norm = float(np.sqrt(sumsq))
    if check_isfinite and not np.isfinite(total_norm):
        warnings.warn(UserWarning("nan or inf is detected. Clipping "
                                  "results will be undefined."),
                      stacklevel=2)
    scale = max_norm / (total_norm + 1e-8)
    if scale < 1.0:
        with torch.no_grad():
            for t in ts:
                t.mul_(scale)
    return total_norm


def check_sha1(filename, sha1_hash):
    """Whether the sha1 of the file's content is `sha1_hash`."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            sha1.update(chunk)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    """The path of `url`'s file (utils.py:122): the file already at
    `path` (when its sha1 matches, if one is given), or a copy of a
    local ``file://`` URL. Any other URL raises RuntimeError: place the
    file there by hand."""
    if path is None:
        fname = url.split("/")[-1]
    elif os.path.isdir(path):
        fname = os.path.join(path, url.split("/")[-1])
    else:
        fname = path
    if os.path.exists(fname) and not overwrite and (
            not sha1_hash or check_sha1(fname, sha1_hash)):
        return fname
    if url.startswith("file://"):
        shutil.copyfile(url[len("file://"):], fname)
        return fname
    raise RuntimeError(
        "download(%r) requires network egress, which is unavailable; "
        "place the file at %r manually." % (url, fname))
