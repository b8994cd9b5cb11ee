"""2-bit gradient compression with an error-feedback residual (counterpart
of mxnet_tpu/gradient_compression.py: `packed_size` :38, `quantize_2bit`
:43, `dequantize_2bit` :68, `GradientCompression` :78; reference:
src/kvstore/gradient_compression.h GC_TWO_BIT)::

    residual += grad
    code      = 1 where residual >  threshold
                2 where residual < -threshold
                0 elsewhere
    wire      = 16 codes to a 32-bit word, code i at bits 2i..2i+1,
                the tail zero-padded
    decoded   = +threshold, -threshold or 0
    residual -= decoded

The words are bit-identical to the JAX package's uint32 words. torch's
uint32 lacks shifts and ors on CUDA, so the codes are packed in int64
arithmetic and the words kept as int32 tensors: the same 32 bits
(`.view(torch.uint32)`, or numpy's ``.view(np.uint32)``, reads them as
JAX's). A compressed exchange all-gathers the words and every rank
dequantizes and sums them in rank order.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["GradientCompression", "dequantize_2bit", "packed_size",
           "quantize_2bit"]

_VALS_PER_WORD = 16  # 2 bits per value in a 32-bit word


def packed_size(n):
    """Number of 32-bit words carrying n 2-bit codes."""
    return (n + _VALS_PER_WORD - 1) // _VALS_PER_WORD


def _shifts(device):
    return 2 * torch.arange(_VALS_PER_WORD, dtype=torch.int64, device=device)


def _decode(code, threshold, dtype):
    return torch.where(code == 1, threshold,
                       torch.where(code == 2, -threshold, 0.0)).to(dtype)


def quantize_2bit(grad, residual, threshold):
    """(int32 words [packed_size(n)], new residual like grad) for `grad`
    of any shape, with error feedback from `residual`."""
    acc = residual + grad
    code = torch.where(acc > threshold, 1,
                       torch.where(acc < -threshold, 2, 0)).to(torch.int64)
    new_residual = acc - _decode(code, threshold, grad.dtype)
    flat = code.reshape(-1)
    pad = packed_size(flat.numel()) * _VALS_PER_WORD - flat.numel()
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    # codes occupy disjoint bit ranges, so the sum is their bitwise or
    words = (flat.view(-1, _VALS_PER_WORD) << _shifts(flat.device)).sum(1)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32), new_residual


def dequantize_2bit(packed, shape, threshold, dtype=torch.float32):
    """The +-threshold/0 values of `shape` that int32 words `packed`
    carry."""
    words = packed.to(torch.int64) & 0xFFFFFFFF
    codes = (words[:, None] >> _shifts(words.device)) & 3
    n = 1
    for d in shape:
        n *= int(d)
    return _decode(codes.reshape(-1)[:n], threshold, dtype).view(tuple(shape))


class GradientCompression:
    """Stateful 2-bit compressor: one residual per key, beside the store.
    Arrays smaller than `min_elements` bypass compression (the
    reference's bigarray bound)."""

    def __init__(self, type="2bit", threshold=0.5, min_elements=0):
        if type != "2bit":
            raise MXNetError("unsupported gradient compression type %r"
                             % (type,))
        self.type = type
        self.threshold = float(threshold)
        self.min_elements = int(min_elements)
        self._residuals = {}

    @classmethod
    def from_params(cls, params):
        p = dict(params)
        return cls(type=p.pop("type", "2bit"),
                   threshold=float(p.pop("threshold", 0.5)))

    def active_for(self, x):
        return x.numel() >= self.min_elements

    def compress(self, key, grad):
        """grad -> packed words, updating the key's residual."""
        packed, self._residuals[key] = quantize_2bit(
            grad, self.residual(key, grad.shape, grad.dtype, grad.device),
            self.threshold)
        return packed

    def residual(self, key, shape, dtype, device=None):
        """The key's error-feedback residual: zeros when absent or when
        the key changed shape. The bucketed exchange reads residuals per
        key as slices of a bucket and writes them back with
        `set_residual`, so they survive a change of bucket layout."""
        res = self._residuals.get(key)
        if res is None or tuple(res.shape) != tuple(shape):
            return torch.zeros(shape, dtype=dtype, device=device)
        return res

    def set_residual(self, key, res):
        self._residuals[key] = res

    def decompress(self, packed, shape, dtype=torch.float32):
        return dequantize_2bit(packed, tuple(shape), self.threshold, dtype)

    def roundtrip(self, key, grad):
        """compress then decompress: what the other end of the wire sees."""
        return self.decompress(self.compress(key, grad), grad.shape,
                               grad.dtype)
