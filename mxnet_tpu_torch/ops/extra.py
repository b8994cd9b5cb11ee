"""Breadth operators: the optimizer update ops, extra samplers and misc
tensor ops (counterpart of mxnet_tpu/ops/extra.py; reference:
src/operator/optimizer_op.cc, random/sample_op.cc, tensor/*,
image/image_random.cc, contrib/bounding_box.cc).

The four SGD updates, `sgd_update`, `sgd_mom_update`, `mp_sgd_update` and
`mp_sgd_mom_update`, are the hand-written kernel `fused_sgd_momentum` in
MXNet's form (`ops.sgd_momentum`): on CUDA tensors each call is one
launch over its one weight, through a plan kept as long as the weight
lives and built anew when a tensor's pointer changes; on CPU tensors a
plan runs the kernel's plain version. `optimizer.SGD` updates through the
same function, `sgd_mxnet_update`.
`_prep_grad`'s rescale and clip (extra.py:30-34 of the JAX package) are
the kernel's `rescale` and `clip`. With ``out=weight`` the weight and
the state are updated in place; without it the new weight is a new
array and only the state is written (the aux write-back). The other
updates (adam, rmsprop, ftrl, ftml, signum, ...) are plain torch, as the
JAX package runs them through XLA.

Not ported yet (sparse storage): `_sparse_adagrad_update`,
`_contrib_SparseEmbedding`, `cast_storage`, `_sparse_retain`.
"""
from __future__ import annotations

import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..base import dtype_from_name, tuple_param
from . import sgd_momentum as _sgd
from .random_ops import gamma_draws, poisson_draws
from .registry import alias, exists, register
from .tensor import histogram_counts

# ---------------------------------------------------------------------------
# the SGD updates: the fused_sgd_momentum kernel in MXNet's form
# ---------------------------------------------------------------------------

# one-tensor plans by the weight they update, held weakly: an entry goes
# with its weight (the plan holds aliases of the tensors' storage, never
# the weight object itself)
_PLANS = WeakIdKeyDictionary()


def _plan(ws, vs, lows, cached):
    if not cached or ws[0].device.type == "cpu":
        return _sgd.SGDMomentumPlan(ws, vs, form="mxnet", weights=lows)
    return _sgd.cached_mxnet_plan(_PLANS, ws[0], ws, vs, lows)


def _bump(*ts):
    """Tell autograd that the kernel wrote these tensors (it writes
    through pointers, which torch's version counter does not see)."""
    for t in ts:
        if t is not None:
            torch.autograd.graph.increment_version(t)


def sgd_mxnet_update(weight, grad, mom, weight32, out, lr, momentum, wd,
                     rescale_grad, clip_gradient):
    """One MXNet-form SGD update, the four ops' and `optimizer.SGD`'s.
    Returns the new weight: `out`'s tensor (the weight itself with
    ``out=weight``) or a new one; `mom` and `weight32` are updated in
    place."""
    inplace = out is weight
    target = weight if inplace else weight.clone(
        memory_format=torch.contiguous_format)
    ws, lows = ([target], None) if weight32 is None else \
        ([weight32], [target])
    vs = None if mom is None else [mom]
    dtype = (lows or ws)[0].dtype
    g = grad if grad.dtype == dtype and grad.is_contiguous() else \
        grad.to(dtype).contiguous()
    clip = clip_gradient if clip_gradient is not None and \
        clip_gradient > 0 else None
    plan = _plan(ws, vs, lows, cached=inplace)
    with torch.no_grad():
        if momentum == 0.0 and mom is not None:
            # MXNet's velocity at momentum 0 is -lr * (rescaled, clipped
            # gradient + wd * w): written here, since the kernel keeps no
            # state then
            wf = (weight32 if weight32 is not None else weight).float()
            r = g.float() * rescale_grad
            if clip is not None:
                r = torch.clamp(r, -clip, clip)
            mom.copy_(-lr * (r + wd * wf))
        plan([g], lr, momentum, wd, rescale_grad, clip)
    _bump(target, mom, weight32)
    return target


@register("sgd_update")
def _sgd_update(weight, grad, *, lr, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0, lazy_update=True, out=None):
    return sgd_mxnet_update(weight, grad, None, None, out, lr, 0.0, wd,
                            rescale_grad, clip_gradient)


@register("sgd_mom_update", num_outputs=2, visible_outputs=1,
          aux_write={1: 2})
def _sgd_mom_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True,
                    out=None):
    return (sgd_mxnet_update(weight, grad, mom, None, out, lr, momentum,
                             wd, rescale_grad, clip_gradient), mom)


@register("mp_sgd_update", num_outputs=2, visible_outputs=1,
          aux_write={1: 2})
def _mp_sgd_update(weight, grad, weight32, *, lr, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True,
                   out=None):
    """Mixed-precision SGD: the fp32 master is updated and the weight is
    its cast (reference: optimizer_op.cc MP_SGD)."""
    return (sgd_mxnet_update(weight, grad, None, weight32, out, lr, 0.0,
                             wd, rescale_grad, clip_gradient), weight32)


@register("mp_sgd_mom_update", num_outputs=3, visible_outputs=1,
          aux_write={1: 2, 2: 3})
def _mp_sgd_mom_update(weight, grad, mom, weight32, *, lr, momentum=0.0,
                       wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                       lazy_update=True, out=None):
    return (sgd_mxnet_update(weight, grad, mom, weight32, out, lr,
                             momentum, wd, rescale_grad, clip_gradient),
            mom, weight32)


# ---------------------------------------------------------------------------
# the other update ops, plain torch (the JAX package's formulas)
# ---------------------------------------------------------------------------


def _prep_grad(grad, rescale_grad, clip_gradient, wd, weight):
    g = grad.float() * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g + wd * weight.float()


@register("adam_update", num_outputs=3, visible_outputs=1,
          aux_write={1: 2, 2: 3})
def _adam_update(weight, grad, mean, var, *, lr, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                 clip_gradient=-1.0, lazy_update=True):
    g = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    m = beta1 * mean + (1 - beta1) * g
    v = beta2 * var + (1 - beta2) * g * g
    w = weight.float() - lr * m / (torch.sqrt(v) + epsilon)
    return w.to(weight.dtype), m.to(mean.dtype), v.to(var.dtype)


@register("rmsprop_update", num_outputs=2, visible_outputs=1,
          aux_write={1: 2})
def _rmsprop_update(weight, grad, n, *, lr, gamma1=0.95, epsilon=1e-8,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                    clip_weights=-1.0):
    g = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    new_n = gamma1 * n + (1 - gamma1) * g * g
    w = weight.float() - lr * g / torch.sqrt(new_n + epsilon)
    if clip_weights is not None and clip_weights > 0:
        w = torch.clamp(w, -clip_weights, clip_weights)
    return w.to(weight.dtype), new_n.to(n.dtype)


@register("rmspropalex_update", num_outputs=4, visible_outputs=1,
          aux_write={1: 2, 2: 3, 3: 4})
def _rmspropalex_update(weight, grad, n, g_acc, delta, *, lr, gamma1=0.95,
                        gamma2=0.9, epsilon=1e-8, wd=0.0,
                        rescale_grad=1.0, clip_gradient=-1.0,
                        clip_weights=-1.0):
    g = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    new_n = gamma1 * n + (1 - gamma1) * g * g
    new_g = gamma1 * g_acc + (1 - gamma1) * g
    new_d = gamma2 * delta - lr * g / torch.sqrt(new_n - new_g * new_g
                                                 + epsilon)
    w = weight.float() + new_d
    if clip_weights is not None and clip_weights > 0:
        w = torch.clamp(w, -clip_weights, clip_weights)
    return (w.to(weight.dtype), new_n.to(n.dtype), new_g.to(g_acc.dtype),
            new_d.to(delta.dtype))


@register("ftrl_update", num_outputs=3, visible_outputs=1,
          aux_write={1: 2, 2: 3})
def _ftrl_update(weight, grad, z, n, *, lr, lamda1=0.01, beta=1.0,
                 wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g = grad.float() * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    new_n = n + g * g
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
    new_z = z + g - sigma * weight.float()
    w = torch.where(
        torch.abs(new_z) <= lamda1, torch.zeros_like(new_z),
        -(new_z - torch.sign(new_z) * lamda1)
        / ((beta + torch.sqrt(new_n)) / lr + wd))
    return w.to(weight.dtype), new_z.to(z.dtype), new_n.to(n.dtype)


@register("ftml_update", num_outputs=4, visible_outputs=1,
          aux_write={1: 2, 2: 3, 3: 4})
def _ftml_update(weight, grad, d, v, z, *, lr, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0,
                 clip_grad=-1.0):
    g = grad.float() * rescale_grad + wd * weight.float()
    if clip_grad is not None and clip_grad > 0:
        g = torch.clamp(g, -clip_grad, clip_grad)
    new_v = beta2 * v + (1 - beta2) * g * g
    d_t = (1 - beta1 ** t) / lr * (
        torch.sqrt(new_v / (1 - beta2 ** t)) + epsilon)
    sigma = d_t - beta1 * d
    new_z = beta1 * z + (1 - beta1) * g - sigma * weight.float()
    w = -new_z / d_t
    return (w.to(weight.dtype), d_t.to(d.dtype), new_v.to(v.dtype),
            new_z.to(z.dtype))


@register("signsgd_update")
def _signsgd_update(weight, grad, *, lr, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0):
    g = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    return (weight.float() - lr * torch.sign(g)).to(weight.dtype)


@register("signum_update", num_outputs=2, visible_outputs=1,
          aux_write={1: 2})
def _signum_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _prep_grad(grad, rescale_grad, clip_gradient, wd, weight)
    new_mom = momentum * mom - (1 - momentum) * g
    w = (1 - lr * wd_lh) * weight.float() + lr * torch.sign(new_mom)
    return w.to(weight.dtype), new_mom.to(mom.dtype)


# ---------------------------------------------------------------------------
# distribution samplers (reference: random/sample_op.cc _sample_*): one
# parameter array -> `shape` draws per element
# ---------------------------------------------------------------------------


def _sample_shape(param, shape):
    shape = tuple_param(shape, None) if isinstance(shape, (list, tuple)) \
        else ((shape,) if isinstance(shape, int) else tuple(shape or ()))
    return tuple(param.shape) + tuple(s for s in shape if s != 0)


def _bcast(p, out):
    return p.reshape(tuple(p.shape) + (1,) * (len(out) - p.dim())).float()


@register("_sample_exponential", needs_rng=True)
def _sample_exponential(gen, lam, *, shape=(), dtype="float32"):
    out = _sample_shape(lam, shape)
    e = torch.empty(out, dtype=torch.float32, device=lam.device)
    return (e.exponential_(1.0, generator=gen) / _bcast(lam, out)).to(
        dtype_from_name(dtype))


@register("_sample_gamma", needs_rng=True)
def _sample_gamma(gen, alpha, beta, *, shape=(), dtype="float32"):
    out = _sample_shape(alpha, shape)
    a = _bcast(alpha, out).expand(out)
    return (gamma_draws(gen, a, out, alpha.device) * _bcast(beta, out)).to(
        dtype_from_name(dtype))


@register("_sample_poisson", needs_rng=True)
def _sample_poisson(gen, lam, *, shape=(), dtype="float32"):
    out = _sample_shape(lam, shape)
    return poisson_draws(gen, _bcast(lam, out).expand(out)).to(
        dtype_from_name(dtype))


@register("_sample_negative_binomial", needs_rng=True)
def _sample_negative_binomial(gen, k, p, *, shape=(), dtype="float32"):
    """NB(k, p) as a gamma-poisson mixture: failures before k
    successes."""
    out = _sample_shape(k, shape)
    pp = _bcast(p, out)
    rate = gamma_draws(gen, _bcast(k, out).expand(out), out, k.device) * \
        (1 - pp) / pp
    return poisson_draws(gen, rate).to(dtype_from_name(dtype))


@register("_sample_generalized_negative_binomial", needs_rng=True)
def _sample_gnb(gen, mu, alpha, *, shape=(), dtype="float32"):
    out = _sample_shape(mu, shape)
    a = _bcast(alpha, out)
    r = 1.0 / torch.clamp(a, min=1e-12)
    rate = gamma_draws(gen, r.expand(out), out, mu.device) * \
        _bcast(mu, out) * a
    return poisson_draws(gen, rate).to(dtype_from_name(dtype))


# ---------------------------------------------------------------------------
# misc tensor ops
# ---------------------------------------------------------------------------


@register("add_n", aliases=("ElementWiseSum",) if not
          exists("ElementWiseSum") else ())
def _add_n(*args, num_args=0):
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


@register("_grad_add")
def _grad_add(lhs, rhs):
    return lhs + rhs


@register("hard_sigmoid")
def _hard_sigmoid(data, *, alpha=0.2, beta=0.5):
    return torch.clamp(alpha * data + beta, 0.0, 1.0)


@register("softmax_cross_entropy")
def _softmax_cross_entropy(data, label):
    """(reference: loss_binary_op.cc): the cross entropy summed over the
    batch, shape (1,)."""
    lp = torch.log_softmax(data.float(), dim=-1)
    picked = torch.gather(lp, -1, label.long()[:, None])
    return (-torch.sum(picked)).reshape(1).to(data.dtype)


@register("_histogram", num_outputs=2)
def _histogram(data, *bins_in, bin_cnt=None, range=None):
    if bin_cnt is not None:
        lo, hi = range
        edges = torch.linspace(lo, hi, int(bin_cnt) + 1,
                               dtype=data.dtype, device=data.device)
    else:
        edges = bins_in[0]
    return histogram_counts(data, edges).to(torch.float32), edges


@register("_ravel_multi_index")
def _ravel_multi_index(data, *, shape):
    """data (ndim, N) -> flat indices (reference: ravel.cc)."""
    dims = tuple(int(s) for s in shape)
    strides, acc = [], 1
    for d in reversed(dims):
        strides.append(acc)
        acc *= d
    strides = torch.tensor(list(reversed(strides)), dtype=data.dtype,
                           device=data.device)
    return torch.sum(data * strides[:, None], dim=0)


@register("_unravel_index")
def _unravel_index(data, *, shape):
    dims = tuple(int(s) for s in shape)
    out = []
    rem = data.to(torch.int32)
    acc = 1
    for d in dims:
        acc *= d
    for d in dims:
        acc //= d
        out.append(torch.div(rem, acc, rounding_mode="floor"))
        rem = torch.remainder(rem, acc)
    return torch.stack(out).to(data.dtype)


def _logical(name, fn):
    @register(name)
    def _op(lhs, rhs, _fn=fn):
        return _fn(lhs != 0, rhs != 0).to(lhs.dtype)

    @register(name + "_scalar")
    def _op_scalar(data, *, scalar=0.0, _fn=fn):
        return _fn(data != 0, torch.tensor(scalar != 0,
                                           device=data.device)).to(
                                               data.dtype)


_logical("_logical_and", torch.logical_and)
_logical("_logical_or", torch.logical_or)
_logical("_logical_xor", torch.logical_xor)


def _slices(begin, end, step):
    return tuple(slice(b, e, s or None) for b, e, s in
                 zip(begin, end, step or (None,) * len(begin)))


@register("_slice_assign", aliases=("_crop_assign",))
def _slice_assign(lhs, rhs, *, begin, end, step=()):
    out = lhs.clone()
    out[_slices(begin, end, step)] = rhs.to(lhs.dtype)
    return out


@register("_slice_assign_scalar", aliases=("_crop_assign_scalar",))
def _slice_assign_scalar(data, *, scalar=0.0, begin=(), end=(), step=()):
    out = data.clone()
    out[_slices(begin, end, step)] = scalar
    return out


@register("_scatter_plus_scalar")
def _scatter_plus_scalar(data, *, scalar=0.0):
    return data + scalar


@register("_scatter_minus_scalar")
def _scatter_minus_scalar(data, *, scalar=0.0):
    return data - scalar


@register("_scatter_elemwise_div")
def _scatter_elemwise_div(lhs, rhs):
    return lhs / rhs


@register("_square_sum")
def _square_sum(data, *, axis=None, keepdims=False, exclude=False):
    if axis is None:
        dims = tuple(range(data.dim()))
    else:
        dims = tuple_param(axis, None) if isinstance(axis, (list, tuple)) \
            else (axis,)
    return torch.sum(torch.square(data), dim=dims, keepdim=keepdims)


@register("_identity_with_attr_like_rhs")
def _identity_with_attr_like_rhs(lhs, rhs):
    return lhs


@register("_image_to_tensor", aliases=("_npi_to_tensor",))
def _image_to_tensor(data):
    """HWC uint8 [0, 255] -> CHW float32 [0, 1] (reference:
    image/image_random.cc ToTensor); a batch NHWC -> NCHW."""
    x = data.float() / 255.0
    if x.dim() == 3:
        return x.permute(2, 0, 1)
    return x.permute(0, 3, 1, 2)


@register("_image_normalize")
def _image_normalize(data, *, mean=(0, 0, 0), std=(1, 1, 1)):
    """CHW (or NCHW) normalize (reference: image_random.cc Normalize)."""
    mean = torch.tensor(mean, dtype=data.dtype, device=data.device)
    std = torch.tensor(std, dtype=data.dtype, device=data.device)
    if data.dim() == 4:
        return (data - mean.reshape(1, -1, 1, 1)) / std.reshape(1, -1, 1, 1)
    return (data - mean.reshape(-1, 1, 1)) / std.reshape(-1, 1, 1)


@register("_contrib_bipartite_matching", num_outputs=2)
def _bipartite_matching(data, *, is_ascend=False, threshold=0.0, topk=-1):
    """Greedy bipartite matching over a score matrix (reference:
    contrib/bounding_box.cc BipartiteMatching): (row -> col match or -1,
    col -> row match or -1), k = min(rows, cols, topk) rounds."""
    rows, cols = data.shape[-2], data.shape[-1]
    k = min(rows, cols) if topk <= 0 else min(topk, min(rows, cols))
    sign = 1.0 if not is_ascend else -1.0
    limit = threshold * sign if not is_ascend else float("-inf")

    def one(mat):
        m = (mat * sign).clone()
        rmatch = torch.full((rows,), -1.0, device=mat.device)
        cmatch = torch.full((cols,), -1.0, device=mat.device)
        for _ in range(k):
            flat = int(torch.argmax(m))
            i, j = flat // cols, flat % cols
            if float(m[i, j]) > limit:
                rmatch[i] = j
                cmatch[j] = i
            m[i, :] = float("-inf")
            m[:, j] = float("-inf")
        return rmatch, cmatch

    if data.dim() == 2:
        return one(data)
    pairs = [one(d) for d in data.reshape(-1, rows, cols)]
    lead = tuple(data.shape[:-2])
    return (torch.stack([p[0] for p in pairs]).reshape(lead + (rows,)),
            torch.stack([p[1] for p in pairs]).reshape(lead + (cols,)))


@register("_CrossDeviceCopy")
def _cross_device_copy(data):
    """Device copy (reference: cross_device_copy.cc): the identity here;
    `NDArray.as_in_context` moves arrays."""
    return data


# legacy front-end names kept for reference compatibility
for _old, _new in [("Convolution", "Convolution_v1"),
                   ("Pooling", "Pooling_v1"), ("slice", "crop")]:
    if exists(_old) and not exists(_new):
        alias(_old, _new)
