"""Fused softmax attention forward: a hand-written CUDA kernel and its
plain PyTorch version.

Replaces mxnet_tpu/ops/pallas_kernels.py `flash_attention` (:138, forward
`_flash_fwd` :95, body `_flash_fwd_kernel` :46). The kernel is
``csrc/flash_attention.cu``; its source note says what bounds it on the
H100 (arithmetic, on the tensor cores: bf16, or fp32 as 3xTF32) and how
its design answers that.

Layout is the JAX package's: q, k, v of shape (B, H, T, D). The kernel
takes float32 and bfloat16, D a multiple of 8 up to 128, any T (the TPU
kernel required T to divide its block), and any batch, head and row
strides with a unit stride along D, so the (B, T, H, D) projections of a
transformer go in as `transpose(1, 2)` views, and `out=` may be such a
view too. Its tiles are fixed, so the JAX function's `block_q`/`block_k`
arguments have no counterpart. Only the forward is ported: the JAX
backward is not a kernel (it takes the vjp of `_attn_reference`), and
serving needs no gradient.

The registry op `_contrib_flash_attention` (the JAX package registers it
at pallas_kernels.py:204) runs the kernel forward through
`FlashAttentionFunction`, whose backward is autograd through
`attention_plain`, as the JAX op's backward (`_fa_bwd` :150) is the vjp
of its plain reference.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from . import _build
from .registry import register

__all__ = ["FlashAttentionFunction", "attention_plain", "flash_attention"]

_NEG_INF = -1e30
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("flash_attention").mxtpu_flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 12 + [
            ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 2 + [
                ctypes.c_void_p]
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


def _aligned(t, stride):
    """16-byte aligned rows: the base and the batch, head and row strides
    (a size-1 dimension with an odd stride counts as misaligned too)."""
    size = t.element_size()
    return not (t.data_ptr() | stride[0] * size | stride[1] * size
                | stride[2] * size) & 15


def flash_attention(q, k, v, causal=False, *, out=None):
    """softmax(q k^T / sqrt(D)) v over (B, H, T, D). Written into `out`
    (a (B, H, T, D) tensor or view) when given, else into a new tensor,
    which is returned. On CUDA tensors this launches the kernel (and
    counts it in ``flash_attention.launches``) or raises; on CPU tensors
    it runs `attention_plain`."""
    if q.is_cpu:
        res = attention_plain(q, k, v, causal)
        return res if out is None else out.copy_(res)
    shape, dt, dev = q.shape, q.dtype, q.device
    if len(shape) != 4:
        raise MXNetError("flash_attention: q must be (B, H, T, D), got %s"
                         % (tuple(shape),))
    B, H, T, D = shape
    ts = (q, k, v) if out is None else (q, k, v, out)
    for name, t in zip(("k", "v", "out"), ts[1:]):
        if t.shape != shape or t.dtype != dt or t.device != dev:
            raise MXNetError(
                "flash_attention: %s must match q (%s %s on %s), got %s %s "
                "on %s" % (name, tuple(shape), dt, dev, tuple(t.shape),
                           t.dtype, t.device))
    if D % 8 or not 8 <= D <= 128:
        raise MXNetError("flash_attention: head dim must be a multiple of "
                         "8 in [8, 128], got %d" % D)
    strides = [t.stride() for t in ts]
    if any(st[3] != 1 for st in strides):
        raise MXNetError("flash_attention: q, k, v and out need a unit "
                         "stride along D")
    if T < 1 or -(-T // 64) > 65535 or not 1 <= B * H < 2 ** 31:
        raise MXNetError("flash_attention: cannot take shape %s"
                         % (tuple(shape),))
    fn = _kernel()
    # rows that are not 16-byte aligned (an odd offset or stride) go
    # through an aligned copy
    qkv = [t if _aligned(t, st) else
           t.clone(memory_format=torch.contiguous_format)
           for t, st in zip(ts[:3], strides)]
    if out is not None and _aligned(out, strides[3]):
        dst, ost = out, strides[3]
    else:
        dst = torch.empty(shape, dtype=dt, device=dev)
        ost = dst.stride()
    q, k, v = qkv
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dst.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *ost[:3],
            B, H, T, D, _build.dtype_code(q), 1.0 / (D ** 0.5),
            int(bool(causal)), dev.index, _build.stream_of(q))
    _build.check_launch(rc, "flash_attention")
    flash_attention.launches += 1
    if out is None or dst is out:
        return dst
    return out.copy_(dst)


#: kernel launches so far (the plain CPU path does not count)
flash_attention.launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """`flash_attention` forward (the kernel on CUDA tensors); backward
    the vjp of `attention_plain`, recomputed from q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return flash_attention(q, k, v, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = attention_plain(*qkv, causal=ctx.causal)
            dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None


@register("_contrib_flash_attention")
def _flash_attention_op(q, k, v, *, causal=False, block_q=128, block_k=128):
    """Attention over (B, H, T, D) through the kernel. `block_q` and
    `block_k` are accepted for the JAX op's signature and ignored: the
    kernel's tiles are fixed. The head dim must be a multiple of 8 in
    [8, 128] on the card, where the JAX op takes any."""
    return FlashAttentionFunction.apply(q, k, v, bool(causal))
