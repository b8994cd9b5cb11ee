"""Fused softmax attention forward: a hand-written CUDA kernel and its
plain PyTorch version.

Replaces mxnet_tpu/ops/pallas_kernels.py `flash_attention` (:138, forward
`_flash_fwd` :95, body `_flash_fwd_kernel` :46). The kernel is
``csrc/flash_attention.cu``; its source note says what bounds it on the
H100 (arithmetic, done here as fp32 FMAs) and how its design answers
that.

Layout is the JAX package's: q, k, v of shape (B, H, T, D). The kernel
takes float32 and bfloat16, D a multiple of 8 up to 128, and any T (the
TPU kernel required T to divide its block). Its tiles are fixed, so the
JAX function's `block_q`/`block_k` arguments have no counterpart. Only
the forward is ported: the JAX backward is not a kernel (it takes the
vjp of `_attn_reference`), and this slice serves without gradients.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from . import _build

__all__ = ["flash_attention", "attention_plain"]

_NEG_INF = -1e30
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("flash_attention").mxtpu_flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def attention_plain(q, k, v, causal=False):
    """The kernel's function in plain PyTorch — the port of the JAX
    package's `_attn_reference` (pallas_kernels.py:124): fp32 scores,
    masked with -1e30 above the diagonal when causal, softmax, output in
    q's dtype."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        Tq, Tk = s.shape[-2:]
        mask = torch.ones(Tq, Tk, dtype=torch.bool, device=s.device).tril()
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def flash_attention(q, k, v, causal=False):
    """softmax(q k^T / sqrt(D)) v over (B, H, T, D). On CUDA tensors this
    launches the kernel (and counts it in ``flash_attention.launches``) or
    raises; on CPU tensors it runs `attention_plain`."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal)
    if q.dim() != 4:
        raise MXNetError("flash_attention: q must be (B, H, T, D), got %s"
                         % (tuple(q.shape),))
    B, H, T, D = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or \
                t.device != q.device:
            raise MXNetError(
                "flash_attention: %s must match q (%s %s on %s), got %s %s "
                "on %s" % (name, tuple(q.shape), q.dtype, q.device,
                           tuple(t.shape), t.dtype, t.device))
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise MXNetError("flash_attention: q, k, v must be contiguous")
    if D % 8 or not 8 <= D <= 128:
        raise MXNetError("flash_attention: head dim must be a multiple of "
                         "8 in [8, 128], got %d" % D)
    if T < 1 or not 1 <= B * H <= 65535:
        raise MXNetError("flash_attention: cannot take shape %s"
                         % (tuple(q.shape),))
    fn = _kernel()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B * H, T, D, _build.dtype_code(q), 1.0 / (D ** 0.5),
                int(bool(causal)), _build.stream_of(q))
    _build.check_launch(rc, "flash_attention")
    flash_attention.launches += 1
    return out


#: kernel launches so far (the plain CPU path does not count)
flash_attention.launches = 0
