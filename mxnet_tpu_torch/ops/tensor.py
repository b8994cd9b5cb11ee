"""Shape, indexing, ordering, linalg, sequence and dot operators
(counterpart of mxnet_tpu/ops/tensor.py), on torch tensors.

`dot` and `batch_dot` are `torch.matmul`/`tensordot` (no TPU kernel
computes them), the `_linalg_*` ops `torch.linalg`. Index inputs may be
of any numeric dtype; they are taken as integers, as the JAX package
casts them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError, dtype_from_name
from .registry import register

# ---------------------------------------------------------------------------
# shape manipulation
# ---------------------------------------------------------------------------


def _mx_reshape_shape(src_shape, target):
    """The reference's Reshape codes (matrix_op.cc): 0 copy a dim, -1
    infer, -2 copy the rest, -3 merge two dims, -4 split a dim."""
    src = list(src_shape)
    out = []
    i = 0
    t = list(target)
    j = 0
    while j < len(t):
        d = t[j]
        if d == 0:
            out.append(src[i])
            i += 1
        elif d == -1:
            out.append(-1)
            i += 1
        elif d == -2:
            out.extend(src[i:])
            i = len(src)
        elif d == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif d == -4:
            a, b = t[j + 1], t[j + 2]
            if a == -1:
                a = src[i] // b
            if b == -1:
                b = src[i] // a
            out.extend([a, b])
            i += 1
            j += 2
        else:
            out.append(int(d))
            if i < len(src):
                i += 1
        j += 1
    if out.count(-1) > 1:
        raise MXNetError("Reshape: more than one -1 in %r" % (target,))
    return tuple(out)


@register("Reshape", aliases=("reshape",))
def _reshape(x, *, shape, reverse=False):
    tgt = _mx_reshape_shape(x.shape if not reverse else tuple(x.shape)[::-1],
                            shape if not reverse else tuple(shape)[::-1])
    if reverse:
        tgt = tgt[::-1]
    return torch.reshape(x, tgt)


@register("Flatten", aliases=("flatten",))
def _flatten(x):
    return torch.reshape(x, (x.shape[0], -1))


@register("transpose")
def _transpose(x, *, axes=None):
    if axes is None or axes == ():
        axes = tuple(range(x.dim()))[::-1]
    return x.permute(*axes)


@register("expand_dims")
def _expand_dims(x, *, axis):
    return torch.unsqueeze(x, axis if axis >= 0 else axis + x.dim() + 1)


@register("squeeze")
def _squeeze(x, *, axis=None):
    if axis is None:
        return torch.squeeze(x)
    return torch.squeeze(x, dim=axis if isinstance(axis, int)
                         else tuple(axis))


@register("swapaxes", aliases=("SwapAxis",))
def _swapaxes(x, *, dim1=0, dim2=0):
    return torch.swapaxes(x, dim1, dim2)


@register("reshape_like")
def _reshape_like(lhs, rhs):
    return torch.reshape(lhs, rhs.shape)


def _index(x, dim, b, e, s):
    """x sliced along `dim` by Python's slice(b, e, s), negative steps too
    (which torch's slicing lacks)."""
    if s is None or s > 0:
        idx = [slice(None)] * x.dim()
        idx[dim] = slice(b, e, s)
        return x[tuple(idx)]
    rows = list(range(*slice(b, e, s).indices(x.shape[dim])))
    return torch.index_select(
        x, dim, torch.tensor(rows, dtype=torch.long, device=x.device))


@register("slice")
def _slice(x, *, begin, end, step=None):
    step = step or (None,) * len(begin)
    for d, (b, e, s) in enumerate(zip(begin, end, step)):
        x = _index(x, d, b, e, s)
    return x


@register("slice_axis")
def _slice_axis(x, *, axis, begin, end):
    return _index(x, axis % x.dim(), begin, end, None)


@register("slice_like")
def _slice_like(x, y, *, axes=()):
    axes = tuple(axes) if axes else tuple(range(y.dim()))
    idx = [slice(None)] * x.dim()
    for a in axes:
        idx[a] = slice(0, y.shape[a])
    return x[tuple(idx)]


@register("Concat", aliases=("concat",))
def _concat(*xs, dim=1):
    return torch.cat(xs, dim=dim)


@register("stack")
def _stack(*xs, axis=0):
    return torch.stack(xs, dim=axis)


def _split_arity(params):
    return int(params.get("num_outputs", 1))


@register("SliceChannel", aliases=("split",), num_outputs=_split_arity)
def _split(x, *, num_outputs, axis=1, squeeze_axis=False):
    if x.shape[axis] % num_outputs:
        raise MXNetError("split: axis %d of size %d does not divide into %d"
                         % (axis, x.shape[axis], num_outputs))
    outs = torch.chunk(x, num_outputs, dim=axis)
    if squeeze_axis:
        outs = [torch.squeeze(o, dim=axis) for o in outs]
    return tuple(outs)


@register("tile")
def _tile(x, *, reps):
    return torch.tile(x, tuple(reps) if not isinstance(reps, int)
                      else (reps,))


@register("repeat")
def _repeat(x, *, repeats, axis=None):
    if axis is None:
        return torch.repeat_interleave(x.reshape(-1), repeats)
    return torch.repeat_interleave(x, repeats, dim=axis)


@register("Pad", aliases=("pad",))
def _pad(x, *, mode="constant", pad_width=(), constant_value=0):
    pairs = [(pad_width[2 * i], pad_width[2 * i + 1])
             for i in range(len(pad_width) // 2)]
    pairs += [(0, 0)] * (x.dim() - len(pairs))
    if mode == "constant":
        flat = [p for pair in reversed(pairs) for p in pair]
        return F.pad(x, flat, mode="constant", value=constant_value)
    if mode not in ("edge", "reflect"):
        raise MXNetError("Pad: unknown mode %r" % mode)
    # torch pads the trailing dims of a batched tensor: pad only those
    lead = 0
    while lead < len(pairs) and pairs[lead] == (0, 0):
        lead += 1
    lead = min(lead, x.dim() - 1)
    trail = pairs[lead:]
    flat = [p for pair in reversed(trail) for p in pair]
    xs = x.reshape((-1,) + tuple(x.shape[lead:]))
    y = F.pad(xs, flat, mode="replicate" if mode == "edge" else "reflect")
    return y.reshape(tuple(x.shape[:lead]) + tuple(y.shape[1:]))


@register("flip", aliases=("reverse",))
def _flip(x, *, axis):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    return torch.flip(x, dims=axes)


@register("space_to_depth")
def _space_to_depth(x, *, block_size):
    n, c, h, w = x.shape
    b = block_size
    x = x.reshape(n, c, h // b, b, w // b, b)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


@register("depth_to_space")
def _depth_to_space(x, *, block_size):
    n, c, h, w = x.shape
    b = block_size
    x = x.reshape(n, b, b, c // (b * b), h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


# ---------------------------------------------------------------------------
# indexing / embedding
# ---------------------------------------------------------------------------


def _long(t):
    return t.long() if t.dtype != torch.long else t


@register("take")
def _take(a, indices, *, axis=0, mode="clip"):
    n = a.shape[axis]
    idx = _long(indices)
    idx = torch.remainder(idx, n) if mode == "wrap" else \
        torch.clamp(idx, 0, n - 1)
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(tuple(a.shape[:axis]) + tuple(indices.shape) +
                       tuple(a.shape[axis + 1:]))


@register("batch_take", aliases=("pick",))
def _batch_take(a, indices, *, axis=1, keepdims=False):
    axis = axis % a.dim()
    idx = torch.clamp(_long(indices), 0, a.shape[axis] - 1)
    out = torch.gather(a, axis, idx.unsqueeze(axis))
    if not keepdims:
        out = torch.squeeze(out, dim=axis)
    return out


@register("Embedding")
def _embedding(data, weight, *, input_dim, output_dim, dtype="float32",
               sparse_grad=False):
    """Embedding lookup (reference: indexing_op.h EmbeddingOpForward): the
    weight's rows at the (clipped) indices."""
    idx = torch.clamp(_long(data), 0, weight.shape[0] - 1)
    return F.embedding(idx, weight)


@register("one_hot")
def _one_hot(indices, *, depth, on_value=1.0, off_value=0.0,
             dtype="float32"):
    idx = _long(indices)
    valid = (idx >= 0) & (idx < depth)
    oh = F.one_hot(torch.where(valid, idx, torch.zeros_like(idx)), depth)
    oh = (oh * valid.unsqueeze(-1)).float()
    out = oh * on_value + (1 - oh) * off_value
    return out.to(dtype_from_name(dtype))


@register("gather_nd")
def _gather_nd(data, indices):
    return data[tuple(_long(indices))]


@register("scatter_nd")
def _scatter_nd(data, indices, *, shape):
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(tuple(_long(indices)), data)


@register("_scatter_set_nd")
def _scatter_set_nd(lhs, indices, rhs, *, shape=None):
    return lhs.index_put(tuple(_long(indices)), rhs.to(lhs.dtype))


@register("where")
def _where(cond, x, y):
    return torch.where(cond != 0, x, y)


@register("ravel_multi_index")
def _ravel(data, *, shape):
    idx = _long(data)
    strides = [1]
    for s in list(shape)[::-1][:-1]:
        strides.append(strides[-1] * int(s))
    strides = strides[::-1]
    out = sum(idx[i] * strides[i] for i in range(len(strides)))
    return out.to(torch.float32)


@register("unravel_index")
def _unravel(data, *, shape):
    rem = _long(data)
    out = []
    for d in reversed(tuple(shape)):
        out.append(torch.remainder(rem, d))
        rem = torch.div(rem, d, rounding_mode="floor")
    return torch.stack(out[::-1]).to(torch.float32)


# ---------------------------------------------------------------------------
# ordering (reference: ordering_op.cc)
# ---------------------------------------------------------------------------


@register("topk", num_outputs=lambda p: 2 if p.get("ret_typ", "indices")
          == "both" else 1)
def _topk(x, *, axis=-1, k=1, ret_typ="indices", is_ascend=False,
          dtype="float32"):
    vals, idxs = torch.topk(x, k, dim=axis, largest=not is_ascend,
                            sorted=True)
    idxs_t = idxs.to(dtype_from_name(dtype))
    if ret_typ == "value":
        return vals
    if ret_typ == "indices":
        return idxs_t
    if ret_typ == "both":
        return vals, idxs_t
    if ret_typ == "mask":
        return torch.zeros_like(x).scatter(axis, idxs, 1.0)
    raise MXNetError("topk: bad ret_typ %r" % ret_typ)


@register("sort")
def _sort(x, *, axis=-1, is_ascend=True):
    out = torch.sort(x, dim=axis, stable=True).values
    return out if is_ascend else torch.flip(out, dims=(axis,))


@register("argsort")
def _argsort(x, *, axis=-1, is_ascend=True, dtype="float32"):
    out = torch.argsort(x if is_ascend else -x, dim=axis, stable=True)
    return out.to(dtype_from_name(dtype))


# ---------------------------------------------------------------------------
# dot / linalg (reference: dot.cc, la_op.cc)
# ---------------------------------------------------------------------------


@register("dot")
def _dot(a, b, *, transpose_a=False, transpose_b=False):
    """Contracts a's last axis with b's first (MXNet's dot), with the
    transpose flags moving a's first axis last and b's last axis first."""
    if transpose_a:
        a = a.permute(*range(1, a.dim()), 0) if a.dim() > 2 else a.T
    if transpose_b:
        b = b.permute(b.dim() - 1, *range(b.dim() - 1)) if b.dim() > 2 \
            else b.T
    return torch.tensordot(a, b, dims=1)


@register("batch_dot")
def _batch_dot(a, b, *, transpose_a=False, transpose_b=False):
    if transpose_a:
        a = a.transpose(-1, -2)
    if transpose_b:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


def _t(a):
    return a.transpose(-1, -2)


@register("_linalg_gemm", aliases=("linalg_gemm",))
def _linalg_gemm(a, b, c, *, transpose_a=False, transpose_b=False,
                 alpha=1.0, beta=1.0, axis=-2):
    a = _t(a) if transpose_a else a
    b = _t(b) if transpose_b else b
    return alpha * torch.matmul(a, b) + beta * c


@register("_linalg_gemm2", aliases=("linalg_gemm2",))
def _linalg_gemm2(a, b, *, transpose_a=False, transpose_b=False, alpha=1.0,
                  axis=-2):
    a = _t(a) if transpose_a else a
    b = _t(b) if transpose_b else b
    return alpha * torch.matmul(a, b)


@register("_linalg_potrf", aliases=("linalg_potrf",))
def _linalg_potrf(a):
    return torch.linalg.cholesky(a)


@register("_linalg_potri", aliases=("linalg_potri",))
def _linalg_potri(l):
    eye = torch.eye(l.shape[-1], dtype=l.dtype, device=l.device)
    inv_l = torch.linalg.solve_triangular(l, eye.expand(l.shape), upper=False)
    return torch.matmul(_t(inv_l), inv_l)


@register("_linalg_trsm", aliases=("linalg_trsm",))
def _linalg_trsm(a, b, *, transpose=False, rightside=False, lower=True,
                 alpha=1.0):
    if transpose:
        a = _t(a)
        lower = not lower
    if rightside:
        x = torch.linalg.solve_triangular(_t(a), _t(b), upper=lower)
        return alpha * _t(x)
    return alpha * torch.linalg.solve_triangular(a, b, upper=not lower)


@register("_linalg_trmm", aliases=("linalg_trmm",))
def _linalg_trmm(a, b, *, transpose=False, rightside=False, lower=True,
                 alpha=1.0):
    tri = torch.tril(a) if lower else torch.triu(a)
    if transpose:
        tri = _t(tri)
    if rightside:
        return alpha * torch.matmul(b, tri)
    return alpha * torch.matmul(tri, b)


@register("_linalg_syrk", aliases=("linalg_syrk",))
def _linalg_syrk(a, *, transpose=False, alpha=1.0):
    return alpha * (torch.matmul(_t(a), a) if transpose
                    else torch.matmul(a, _t(a)))


@register("_linalg_sumlogdiag", aliases=("linalg_sumlogdiag",))
def _linalg_sumlogdiag(a):
    return torch.sum(torch.log(torch.diagonal(a, dim1=-2, dim2=-1)), dim=-1)


@register("_linalg_syevd", aliases=("linalg_syevd",), num_outputs=2)
def _linalg_syevd(a):
    w, v = torch.linalg.eigh(a)
    return _t(v), w


@register("_linalg_gelqf", aliases=("linalg_gelqf",), num_outputs=2)
def _linalg_gelqf(a):
    q, r = torch.linalg.qr(_t(a))
    return _t(q), _t(r)


# ---------------------------------------------------------------------------
# sequence ops, layout (seq_len, batch, ...) as in the reference
# ---------------------------------------------------------------------------


def _seq_mask(length, maxlen):
    return torch.arange(maxlen, device=length.device)[:, None] < \
        length[None, :]


@register("SequenceMask")
def _sequence_mask(data, *args, use_sequence_length=False, value=0.0,
                   axis=0):
    if not use_sequence_length or not args:
        return data
    mask = _seq_mask(_long(args[0]), data.shape[axis])     # (T, B)
    if axis == 1:
        mask = mask.T
    mask = mask.reshape(tuple(mask.shape) + (1,) * (data.dim() - 2))
    return torch.where(mask, data, torch.full_like(data, value))


@register("SequenceLast")
def _sequence_last(data, *args, use_sequence_length=False, axis=0):
    if not use_sequence_length or not args:
        return torch.select(data, axis, data.shape[axis] - 1)
    idx = torch.clamp(_long(args[0]) - 1, 0, data.shape[axis] - 1)  # (B,)
    d = torch.movedim(data, axis, 0)                              # (T, B..)
    idx = idx.reshape((1, -1) + (1,) * (d.dim() - 2)).expand(
        (1,) + tuple(d.shape[1:]))
    return torch.gather(d, 0, idx)[0]


@register("SequenceReverse")
def _sequence_reverse(data, *args, use_sequence_length=False, axis=0):
    if not use_sequence_length or not args:
        return torch.flip(data, dims=(0,))
    T = data.shape[0]
    t = torch.arange(T, device=data.device)[:, None]
    L = _long(args[0])[None, :]
    src = torch.where(t < L, L - 1 - t, t)
    src = src.reshape(tuple(src.shape) + (1,) * (data.dim() - 2))
    return torch.gather(data, 0, src.expand(data.shape))


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------


@register("diag")
def _diag(x, *, k=0):
    if x.dim() == 1:
        return torch.diag(x, k)
    return torch.diagonal(x, offset=k, dim1=-2, dim2=-1)


def histogram_counts(x, edges):
    """Counts of x's values in the bins [edges[i], edges[i+1]) (the last
    bin closed on the right), values outside left out, as
    `jnp.histogram` counts them."""
    x = x.reshape(-1)
    n = edges.numel() - 1
    idx = torch.bucketize(x, edges, right=True) - 1
    idx = torch.where(x == edges[-1], torch.full_like(idx, n - 1), idx)
    ok = (idx >= 0) & (idx < n)
    return torch.bincount(idx[ok], minlength=n)[:n]


@register("histogram", num_outputs=2)
def _histogram(x, *, bin_cnt=10, range=None):
    lo, hi = range if range is not None else (0.0, 1.0)
    edges = torch.linspace(lo, hi, bin_cnt + 1, dtype=torch.float32,
                           device=x.device)
    cnt = histogram_counts(x.float(), edges)
    return cnt.to(torch.float32), edges
