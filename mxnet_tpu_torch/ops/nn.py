"""Neural-network operators (counterpart of mxnet_tpu/ops/nn.py).

Two layers. The functions on tensors (`activation`, `fully_connected`,
`convolution`, `pooling`, `batch_norm`), which the Gluon layers call,
keep the JAX package's numerics; their convolution weights are in
PyTorch's (O, I/groups, kh, kw) in both layouts (the JAX package keeps
an NHWC weight as (O, kh, kw, I), and `convert.resnet_params_from_jax`
permutes it), and an NHWC input runs as a channels_last view of NCHW.

Then the registry entries of ops/nn.py, which take the JAX op's inputs
and params as they are, its NHWC weight layout included: Activation,
LeakyReLU, the softmax family, the loss heads (SoftmaxOutput, the
regression outputs, MakeLoss, each a `torch.autograd.Function` with the
reference's own gradient), FullyConnected, N-D Convolution,
Deconvolution and Pooling, UpSampling, BatchNorm, LayerNorm (on the
`layer_norm` kernel, with a plain PyTorch backward), InstanceNorm,
L2Normalization, LRN, Dropout, Correlation and
IdentityAttachKLSparseReg. The fused `RNN` op is not ported yet.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.nn.functional as F

from ..base import MXNetError, tuple_param
from .layer_norm import layer_norm
from .registry import register

__all__ = ["LayerNormFunction", "activation", "batch_norm", "bn_axis",
           "convolution", "fully_connected", "global_batch_stats",
           "is_channels_last", "pooling"]


def is_channels_last(layout):
    """True for NWC/NHWC/NDHWC-family layout strings (ops/nn.py:266)."""
    return layout is not None and layout[1] != "C"


def bn_axis(layout):
    """The channel axis of a layout string: 1 for NCHW, 3 for NHWC."""
    return len(layout) - 1 if is_channels_last(layout) else 1


def activation(x, act_type="relu"):
    """ops/nn.py:34 `Activation`."""
    if act_type == "relu":
        return torch.relu(x)
    if act_type == "sigmoid":
        return torch.sigmoid(x)
    if act_type == "tanh":
        return torch.tanh(x)
    if act_type == "softrelu":
        return F.softplus(x)
    if act_type == "softsign":
        return F.softsign(x)
    if act_type == "gelu":
        return F.gelu(x, approximate="tanh")    # jax.nn.gelu's default
    if act_type in ("silu", "swish"):
        return F.silu(x)
    raise MXNetError("Activation: unknown act_type %r" % act_type)


def fully_connected(x, weight, bias=None, flatten=True):
    """ops/nn.py:250: y = x @ weight.T (+ bias), weight (num_hidden,
    in_units). The bias joins in y's dtype, so fp32 biases do not promote
    a bf16 activation."""
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    y = F.linear(x, weight)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def _pair(v, default):
    if v is None:
        return default
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _to_nchw(x, layout):
    return x.permute(0, 3, 1, 2) if is_channels_last(layout) else x


def _from_nchw(y, layout):
    return y.permute(0, 2, 3, 1) if is_channels_last(layout) else y


def convolution(x, weight, bias=None, stride=1, pad=0, dilate=1, groups=1,
                layout="NCHW"):
    """ops/nn.py:300: 2-D convolution; the bias joins after, in y's
    dtype."""
    if x.dim() != 4:
        raise MXNetError("Convolution: the port takes 2-D convolutions, "
                         "got input of shape %s" % (tuple(x.shape),))
    y = F.conv2d(_to_nchw(x, layout), weight, None, _pair(stride, (1, 1)),
                 _pair(pad, (0, 0)), _pair(dilate, (1, 1)), groups)
    y = _from_nchw(y, layout)
    if bias is not None:
        shape = [1] * 4
        shape[bn_axis(layout)] = bias.numel()
        y = y + bias.reshape(shape).to(y.dtype)
    return y


def pooling(x, kernel=(), pool_type="max", stride=None, pad=None,
            global_pool=False, pooling_convention="valid",
            count_include_pad=True, layout="NCHW"):
    """ops/nn.py:371: 2-D max/avg pooling and global pooling. Max pooling
    pads with -inf, as `lax.reduce_window` with a -inf init does."""
    axes = (1, 2) if is_channels_last(layout) else (2, 3)
    if global_pool:
        if pool_type == "max":
            return x.amax(dim=axes, keepdim=True)
        if pool_type in ("avg", "sum"):
            r = x.sum(dim=axes, keepdim=True)
            if pool_type == "avg":
                r = r / (x.shape[axes[0]] * x.shape[axes[1]])
            return r
        raise MXNetError("Pooling: unknown pool_type %r" % pool_type)
    if pooling_convention != "valid":
        raise MXNetError("Pooling: the port takes pooling_convention "
                         "'valid' only, got %r" % pooling_convention)
    kernel = _pair(kernel, None)
    stride = _pair(stride, (1, 1))
    pad = _pair(pad, (0, 0))
    xc = _to_nchw(x, layout)
    if pool_type == "max":
        y = F.max_pool2d(xc, kernel, stride, pad)
    elif pool_type == "avg":
        y = F.avg_pool2d(xc, kernel, stride, pad,
                         count_include_pad=count_include_pad)
    else:
        raise MXNetError("Pooling: unknown pool_type %r" % pool_type)
    return _from_nchw(y, layout)


def batch_norm(x, gamma, beta, moving_mean, moving_var, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False, axis=1,
               training=False, stats=None):
    """ops/nn.py:466 `BatchNorm`. Returns (y, new_moving_mean,
    new_moving_var); the new moving statistics carry no gradient.

    Training (and not `use_global_stats`): single-pass statistics in
    fp32 (fp64 for fp64 x), var = max(E[x^2] - E[x]^2, 0), unless
    `stats` = (mean, var) hands in ones already computed (by
    `ops.conv1x1_bn_stats` in the producer's epilogue). The moving
    statistics become momentum * old + (1 - momentum) * batch (MXNet's
    momentum: not PyTorch's complement, and the biased variance); inside
    `global_batch_stats` the batch is every rank's. The
    scale and shift fold into one per-channel pair, computed in the
    statistics' dtype and applied in x's dtype."""
    y, _, _, new_mm, new_mv = _batch_norm(
        x, gamma, beta, moving_mean, moving_var, eps, momentum, fix_gamma,
        use_global_stats, axis, training, stats)
    return y, new_mm, new_mv


# the cross-rank mean of training BatchNorm's statistics, while a trainer
# step over a data-parallel axis runs (`global_batch_stats`)
_STATS_MEAN = []


@contextmanager
def global_batch_stats(mean_over_ranks):
    """Within the scope, a training BatchNorm normalises with statistics
    of the global batch: its per-channel mean and E[x^2] (each rank's,
    over equal shards) go through `mean_over_ranks` (a differentiable
    mean over the ranks of a data-parallel axis, `parallel.mesh.pmean`)
    before var = max(E[x^2] - mean^2, 0); the moving statistics follow
    the global ones. Where a 1x1 convolution's kernel handed in its
    (mean, var), E[x^2] is var + mean^2, rebuilt, reduced and subtracted
    again in fp64 (in fp32 the subtraction would cancel var's digits where
    mean^2 >> var). The scope is the process's, not
    a thread's: a rematerialized forward, which runs in the backward,
    sees it too. Outside any scope each process keeps its own
    statistics."""
    _STATS_MEAN.append(mean_over_ranks)
    try:
        yield
    finally:
        _STATS_MEAN.pop()


def _batch_norm(x, gamma, beta, moving_mean, moving_var, eps, momentum,
                fix_gamma, use_global_stats, axis, training, stats=None):
    """`batch_norm`, also returning the mean and inv_std it normalised
    with: (y, mean, inv_std, new_moving_mean, new_moving_var)."""
    ax = axis % x.dim()
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if training and not use_global_stats:
        across = _STATS_MEAN[-1] if _STATS_MEAN else None
        if stats is None:
            red = tuple(i for i in range(x.dim()) if i != ax)
            xf = x if x.dtype == torch.float64 else x.float()
            mean = xf.mean(dim=red)
            sq = (xf * xf).mean(dim=red)
            if across is not None:
                mean, sq = across(torch.stack([mean, sq])).unbind(0)
            var = torch.clamp(sq - mean * mean, min=0.0)
        else:
            mean, var = stats
            if across is not None:
                # E[x^2] rebuilt and reduced in fp64: var + mean^2 - mean^2
                # in fp32 would cancel away var's digits where mean^2 >> var
                m64 = mean.double()
                m64, sq = across(torch.stack(
                    [m64, var.double() + m64 * m64])).unbind(0)
                var = torch.clamp(sq - m64 * m64, min=0.0).to(var.dtype)
                mean = m64.to(mean.dtype)
        with torch.no_grad():
            new_mm = momentum * moving_mean + (1 - momentum) * mean
            new_mv = momentum * moving_var + (1 - momentum) * var
    else:
        mean, var = moving_mean, moving_var
        new_mm, new_mv = moving_mean, moving_var
    shape = [1] * x.dim()
    shape[ax] = x.shape[ax]
    inv_std = torch.rsqrt(var + eps)
    a = g * inv_std
    b = beta - mean * a
    y = x * a.reshape(shape).to(x.dtype) + b.reshape(shape).to(x.dtype)
    return y, mean, inv_std, new_mm, new_mv


# ---------------------------------------------------------------------------
# registry entries (ops/nn.py of the JAX package, by its line numbers). The
# functions above stay callable on tensors: the Gluon layers call them.
# ---------------------------------------------------------------------------


@register("Activation")
def _activation_op(data, *, act_type="relu"):
    """:34."""
    return activation(data, act_type)


@register("LeakyReLU", needs_rng=True, takes_mode=True)
def _leaky_relu(gen, data, *rest, act_type="leaky", slope=0.25,
                lower_bound=0.125, upper_bound=0.334, _mode="predict"):
    """:54."""
    x = data
    if act_type == "leaky":
        return torch.where(x >= 0, x, slope * x)
    if act_type == "elu":
        return torch.where(x >= 0, x, slope * (torch.exp(x) - 1))
    if act_type == "selu":
        a, sc = 1.6732632423543772, 1.0507009873554805
        return sc * torch.where(x >= 0, x, a * (torch.exp(x) - 1))
    if act_type == "prelu":
        gamma = rest[0]
        shape = [1] * x.dim()
        if gamma.numel() > 1 and x.dim() > 1:
            shape[1] = gamma.numel()
        return torch.where(x >= 0, x, gamma.reshape(shape) * x)
    if act_type == "rrelu":
        if _mode == "train":
            s = torch.rand(x.shape, dtype=x.dtype, device=x.device,
                           generator=gen)
            s = lower_bound + (upper_bound - lower_bound) * s
        else:
            s = (lower_bound + upper_bound) / 2.0
        return torch.where(x >= 0, x, s * x)
    raise MXNetError("LeakyReLU: unknown act_type %r" % act_type)


def _f32_inner(fn, x, **kw):
    """fn in fp32 for a low-precision x, cast back (:81)."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return fn(x.float(), **kw).to(x.dtype)
    return fn(x, **kw)


@register("softmax")
def _softmax(data, *, axis=-1, temperature=None):
    """:92."""
    x = data
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    return _f32_inner(torch.softmax, x, dim=axis)


@register("log_softmax")
def _log_softmax(data, *, axis=-1, temperature=None):
    """:100."""
    x = data
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    return _f32_inner(torch.log_softmax, x, dim=axis)


@register("softmin")
def _softmin(data, *, axis=-1, temperature=None):
    return torch.softmax(-data, dim=axis)


@register("SoftmaxActivation")
def _softmax_activation(data, *, mode="instance"):
    x = data
    if mode == "channel":
        return torch.softmax(x, dim=1)
    return torch.softmax(x.reshape(x.shape[0], -1), dim=-1).reshape(x.shape)


# -- loss heads (:129-242): the gradient is their own, the incoming one is
# ignored, as in the reference's training semantics ------------------------


def _one_hot_valid(lbl, n, dtype):
    ok = (lbl >= 0) & (lbl < n)
    oh = F.one_hot(torch.where(ok, lbl, torch.zeros_like(lbl)), n)
    return (oh * ok.unsqueeze(-1)).to(dtype)


class SoftmaxOutputFunction(torch.autograd.Function):
    """softmax over the last axis; backward (softmax - one_hot(label)) *
    grad_scale, masked and normalized as the params say (:129)."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, use_ignore,
                normalization):
        y = torch.softmax(data, dim=-1)
        ctx.save_for_backward(y, label)
        ctx.cfg = (grad_scale, ignore_label, use_ignore, normalization)
        return y

    @staticmethod
    def backward(ctx, g):
        y, label = ctx.saved_tensors
        grad_scale, ignore_label, use_ignore, normalization = ctx.cfg
        lbl = label.long()
        grad = y - _one_hot_valid(lbl, y.shape[-1], y.dtype)
        valid = torch.ones(lbl.shape, dtype=y.dtype, device=y.device)
        if use_ignore:
            valid = (lbl != int(ignore_label)).to(y.dtype)
            grad = grad * valid[..., None]
        if normalization == "batch":
            grad = grad / y.shape[0]
        elif normalization == "valid":
            grad = grad / torch.clamp(valid.sum(), min=1.0)
        return grad * grad_scale, None, None, None, None, None


@register("SoftmaxOutput", aliases=("Softmax",))
def _softmax_output(data, label, *, grad_scale=1.0, ignore_label=-1.0,
                    use_ignore=False, multi_output=False,
                    preserve_shape=False, normalization="null",
                    out_grad=False, smooth_alpha=0.0):
    """:170. multi_output: data (N, C, d...) softmaxed over C at each
    position."""
    args = (grad_scale, ignore_label, use_ignore, normalization)
    if multi_output and data.dim() > 2:
        d = torch.movedim(data, 1, -1)
        return torch.movedim(SoftmaxOutputFunction.apply(d, label, *args),
                             -1, 1)
    if data.dim() > 2 and not preserve_shape:
        flat = data.reshape(data.shape[0], -1)
        return SoftmaxOutputFunction.apply(flat, label, *args).reshape(
            data.shape)
    return SoftmaxOutputFunction.apply(data, label, *args)


class RegressionOutputFunction(torch.autograd.Function):
    """y = fwd(data); backward grad_fn(y, label) * grad_scale / (the
    size of a sample) (:191)."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, kind):
        y = torch.sigmoid(data) if kind == "logistic" else data.clone()
        ctx.save_for_backward(y, label)
        ctx.cfg = (grad_scale, kind)
        return y

    @staticmethod
    def backward(ctx, g):
        y, label = ctx.saved_tensors
        grad_scale, kind = ctx.cfg
        d = torch.sign(y - label) if kind == "mae" else y - label
        per = 1
        for s in y.shape[1:]:
            per *= s
        return d * grad_scale / max(1, per), None, None, None


def _make_regression(name, kind):
    @register(name)
    def op(data, label, *, grad_scale=1.0):
        return RegressionOutputFunction.apply(
            data, label.reshape(data.shape), grad_scale, kind)
    return op


_make_regression("LinearRegressionOutput", "linear")
_make_regression("MAERegressionOutput", "mae")
_make_regression("LogisticRegressionOutput", "logistic")


class MakeLossFunction(torch.autograd.Function):
    """Identity forward; backward `grad_scale` everywhere (:219)."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return torch.full_like(g, ctx.scale), None


@register("MakeLoss", aliases=("make_loss",))
def _make_loss(x, *, grad_scale=1.0, valid_thresh=0.0,
               normalization="null"):
    scale = grad_scale
    if normalization == "batch":
        scale = grad_scale / x.shape[0]
    return MakeLossFunction.apply(x, scale)


# -- FullyConnected / Convolution / Deconvolution / Pooling ----------------


@register("FullyConnected")
def _fully_connected_op(data, weight, *rest, num_hidden, no_bias=False,
                        flatten=True):
    """:250: y = x @ W^T + b, W (num_hidden, in_units)."""
    return fully_connected(data, weight, None if no_bias else rest[0],
                           flatten)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _nc_first(x, channels_last):
    return torch.movedim(x, -1, 1) if channels_last else x


def _nc_last(y, channels_last):
    return torch.movedim(y, 1, -1) if channels_last else y


@register("Convolution")
def _convolution_op(data, weight, *rest, kernel, num_filter, stride=None,
                    dilate=None, pad=None, num_group=1, no_bias=False,
                    layout=None, cudnn_tune=None, cudnn_off=False,
                    workspace=1024):
    """:300: N-D convolution. Channels-last layouts take the JAX
    package's weight layout (O, *kernel, I)."""
    nd = len(kernel)
    stride = tuple_param(stride, nd) or (1,) * nd
    dilate = tuple_param(dilate, nd) or (1,) * nd
    pad = tuple_param(pad, nd) or (0,) * nd
    last = is_channels_last(layout)
    w = torch.movedim(weight, -1, 1) if last else weight
    y = _CONV[nd](_nc_first(data, last), w, None, stride, pad, dilate,
                  num_group)
    if not no_bias:
        shape = [1] * y.dim()
        shape[1] = rest[0].numel()
        y = y + rest[0].reshape(shape).to(y.dtype)
    return _nc_last(y, last)


@register("Deconvolution")
def _deconvolution(data, weight, *rest, kernel, num_filter, stride=None,
                   dilate=None, pad=None, adj=None, target_shape=None,
                   num_group=1, no_bias=True, layout=None, cudnn_tune=None,
                   cudnn_off=False, workspace=1024):
    """:327: transposed convolution, weight (in_channels,
    num_filter // num_group, *kernel)."""
    nd = len(kernel)
    stride = tuple_param(stride, nd) or (1,) * nd
    dilate = tuple_param(dilate, nd) or (1,) * nd
    pad = tuple_param(pad, nd) or (0,) * nd
    adj = tuple_param(adj, nd) or (0,) * nd
    if is_channels_last(layout):
        raise MXNetError(
            "Deconvolution: channels-last layouts not supported; use "
            "NC+spatial (the NHWC weight convention for transposed "
            "convolution is unspecified in the reference)")
    if num_group != 1:
        raise MXNetError("Deconvolution: num_group>1 not yet supported")
    y = _DECONV[nd](data, weight, None, stride, pad, adj, 1, dilate)
    if not no_bias and rest:
        shape = [1] * y.dim()
        shape[1] = rest[0].numel()
        y = y + rest[0].reshape(shape)
    return y


_MAXPOOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVGPOOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


@register("Pooling")
def _pooling_op(data, *, kernel=(), pool_type="max", stride=None, pad=None,
                global_pool=False, pooling_convention="valid",
                cudnn_off=False, count_include_pad=True, p_value=2,
                layout=None):
    """:371: N-D max/avg/sum/lp pooling, global or windowed, 'valid' or
    'full' (ceil) convention, NC+spatial or channels-last."""
    last = is_channels_last(layout)
    x = _nc_first(data, last)
    nd = x.dim() - 2
    axes = tuple(range(2, x.dim()))
    if global_pool:
        if pool_type == "max":
            y = torch.amax(x, dim=axes, keepdim=True)
        elif pool_type in ("avg", "sum"):
            y = torch.sum(x, dim=axes, keepdim=True)
            if pool_type == "avg":
                n = 1
                for a in axes:
                    n *= x.shape[a]
                y = y / n
        elif pool_type == "lp":
            y = torch.pow(torch.sum(torch.pow(torch.abs(x), p_value),
                                    dim=axes, keepdim=True), 1.0 / p_value)
        else:
            raise MXNetError("Pooling: unknown pool_type %r" % pool_type)
        return _nc_last(y, last)
    kernel = tuple_param(kernel, nd)
    stride = tuple_param(stride, nd) or (1,) * nd
    pad = tuple_param(pad, nd) or (0,) * nd
    pads = []
    for i, ax in enumerate(axes):
        size, k, s, p = x.shape[ax], kernel[i], stride[i], pad[i]
        if pooling_convention == "full":
            out = -(-(size + 2 * p - k) // s) + 1
            pads.append((p, max((out - 1) * s + k - size - p, p)))
        else:
            pads.append((p, p))
    flat = [v for pr in reversed(pads) for v in pr]
    ksize = 1
    for k in kernel:
        ksize *= k
    if pool_type == "max":
        fill = float("-inf") if x.is_floating_point() else \
            torch.iinfo(x.dtype).min
        y = _MAXPOOL[nd](F.pad(x, flat, value=fill), kernel, stride)
    elif pool_type in ("avg", "sum"):
        y = _AVGPOOL[nd](F.pad(x, flat), kernel, stride) * ksize
        if pool_type == "avg":
            if count_include_pad:
                y = y / ksize
            else:
                ones = F.pad(torch.ones_like(x[:1, :1]), flat)
                y = y / (_AVGPOOL[nd](ones, kernel, stride) * ksize)
    elif pool_type == "lp":
        s = _AVGPOOL[nd](F.pad(torch.pow(torch.abs(x), p_value), flat),
                         kernel, stride) * ksize
        y = torch.pow(s, 1.0 / p_value)
    else:
        raise MXNetError("Pooling: unknown pool_type %r" % pool_type)
    return _nc_last(y, last)


@register("UpSampling")
def _upsampling(*data, scale, sample_type="nearest", num_args=1,
                num_filter=0, multi_input_mode="concat", workspace=512):
    """:437."""
    x = data[0]
    if sample_type == "nearest":
        outs = [torch.repeat_interleave(torch.repeat_interleave(
            xi, scale, dim=2), scale, dim=3) for xi in data]
        if len(outs) == 1:
            return outs[0]
        if multi_input_mode == "sum":
            return sum(outs)
        return torch.cat(outs, dim=1)
    if sample_type == "bilinear":
        return F.interpolate(x, scale_factor=scale, mode="bilinear",
                             align_corners=False)
    raise MXNetError("UpSampling: unknown sample_type %r" % sample_type)


# -- normalization ---------------------------------------------------------


@register("BatchNorm", num_outputs=5,
          visible_outputs=lambda p: 3 if p.get("output_mean_var") else 1,
          aux_write={3: 3, 4: 4}, takes_mode=True,
          aliases=("BatchNorm_v1",))
def _batch_norm_op(data, gamma, beta, moving_mean, moving_var, *, eps=1e-3,
                   momentum=0.9, fix_gamma=True, use_global_stats=False,
                   output_mean_var=False, axis=1, cudnn_off=False,
                   _mode="predict"):
    """:466. Outputs (y, mean, inv_std, new_moving_mean, new_moving_var);
    `ndarray.invoke` writes the last two into the moving statistics in
    training mode."""
    y, mean, inv_std, new_mm, new_mv = _batch_norm(
        data, gamma, beta, moving_mean, moving_var, eps, momentum,
        fix_gamma, use_global_stats, axis, _mode == "train")
    return y, mean, inv_std, new_mm.detach(), new_mv.detach()


class LayerNormFunction(torch.autograd.Function):
    """LayerNorm over the last axis: the forward is `ops.layer_norm` (the
    kernel on a CUDA tensor, its plain version on a CPU one); the kernel
    is forward-only, so the backward is plain PyTorch, recomputing the
    fp32 statistics from x."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        ctx.beta_dtype = beta.dtype
        return layer_norm(x, gamma, beta, eps)

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        xc = xf - mean
        rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + ctx.eps)
        xhat = xc * rstd
        dyf = dy.float()
        rows = tuple(range(x.dim() - 1))
        dgamma = (dyf * xhat).sum(dim=rows)
        dbeta = dyf.sum(dim=rows)
        dxhat = dyf * gamma.float()
        dx = rstd * (dxhat - dxhat.mean(dim=-1, keepdim=True)
                     - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
        return (dx.to(x.dtype), dgamma.to(gamma.dtype),
                dbeta.to(ctx.beta_dtype), None)


@register("LayerNorm")
def _layer_norm_op(data, gamma, beta, *, axis=-1, eps=1e-5,
                   output_mean_var=False):
    """:512, on the `layer_norm` kernel (its statistics are fp32 where
    the JAX op's are in x's dtype). A non-last `axis` moves to the end,
    contiguous, and back."""
    ax = axis % data.dim()
    last = ax == data.dim() - 1
    x = data if last else torch.movedim(data, ax, -1)
    y = LayerNormFunction.apply(x.contiguous(), gamma.contiguous(),
                                beta.contiguous(), eps)
    return y if last else torch.movedim(y, -1, ax)


@register("InstanceNorm")
def _instance_norm(data, gamma, beta, *, eps=1e-3):
    x = data
    ax = tuple(range(2, x.dim()))
    mean = x.mean(dim=ax, keepdim=True)
    var = x.var(dim=ax, keepdim=True, unbiased=False)
    y = (x - mean) * torch.rsqrt(var + eps)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return y * gamma.reshape(shape) + beta.reshape(shape)


@register("L2Normalization")
def _l2_normalization(data, *, eps=1e-10, mode="instance"):
    x = data
    if mode == "instance":
        ax = tuple(range(1, x.dim()))
    elif mode == "channel":
        ax = (1,)
    elif mode == "spatial":
        ax = tuple(range(2, x.dim()))
    else:
        raise MXNetError("L2Normalization: unknown mode %r" % mode)
    return x / torch.sqrt(torch.sum(torch.square(x), dim=ax, keepdim=True)
                          + eps)


@register("LRN")
def _lrn(data, *, nsize, alpha=1e-4, beta=0.75, knorm=2.0):
    x = data
    half = nsize // 2
    sq = F.pad(torch.square(x), [0, 0] * (x.dim() - 2) + [half, half])
    window = torch.stack([sq[:, i:i + x.shape[1]]
                          for i in range(nsize)]).sum(0)
    return x / torch.pow(knorm + alpha / nsize * window, beta)


@register("Dropout", needs_rng=True, takes_mode=True)
def _dropout(gen, data, *, p=0.5, mode="training", axes=(), cudnn_off=False,
             _mode="predict"):
    """:565: in training mode (or mode 'always'), x * mask / (1 - p) with
    a Bernoulli(1 - p) mask drawn from the generator, shared along
    `axes`."""
    x = data
    if (_mode != "train" and mode != "always") or p <= 0:
        return x
    shape = list(x.shape)
    for a in axes:
        shape[a] = 1
    keep = 1.0 - p
    mask = torch.empty(shape, dtype=torch.float32, device=x.device)
    mask = mask.bernoulli_(keep, generator=gen).to(x.dtype)
    return x * mask / keep


@register("Correlation")
def _correlation(a, b, *, kernel_size=1, max_displacement=1, stride1=1,
                 stride2=1, pad_size=0, is_multiply=True):
    """:740: FlowNet's patch cross-correlation of two NCHW maps; output
    channel q is the displacement (dy, dx), the value the mean over
    channels and the KxK window of a * shift(b) (|a - b| when not
    is_multiply)."""
    n, c, h, w = a.shape
    k, rad = int(kernel_size), (int(kernel_size) - 1) // 2
    md, s2 = int(max_displacement), int(stride2)
    reach = (md // s2) * s2
    border = md + rad
    hp, wp = h + 2 * pad_size, w + 2 * pad_size
    out_h = -(-(hp - 2 * border) // stride1)
    out_w = -(-(wp - 2 * border) // stride1)
    if out_h <= 0 or out_w <= 0:
        raise MXNetError("Correlation: displacement+kernel exceed input")
    pa = F.pad(a, [pad_size] * 4)
    pb = F.pad(b, [pad_size + md] * 4)
    planes = []
    for dy in range(-reach, reach + 1, s2):
        for dx in range(-reach, reach + 1, s2):
            shifted = pb[:, :, md + dy:md + dy + hp, md + dx:md + dx + wp]
            prod = pa * shifted if is_multiply else torch.abs(pa - shifted)
            plane = F.avg_pool2d(prod.sum(dim=1, keepdim=True), k, 1)[:, 0]
            plane = plane * (k * k)
            planes.append(plane[:, md:md + out_h * stride1:stride1,
                                md:md + out_w * stride1:stride1])
    return torch.stack(planes, dim=1) / (k * k * c)


@register("IdentityAttachKLSparseReg")
def _identity_kl(x, *, sparseness_target=0.1, penalty=0.001, momentum=0.9):
    return x
