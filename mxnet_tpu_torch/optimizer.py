"""The optimizer zoo (counterpart of mxnet_tpu/optimizer.py): `Optimizer`
(:71), `SGD` (:255), `NAG` (:287), `Signum` (:305), `SGLD` (:337), `Adam`
(:370), `AdaGrad` (:446), `RMSProp` (:470), `AdaDelta` (:504), `Ftrl`
(:531), `Adamax` (:563), `Nadam` (:591), `FTML` (:631), `DCASGD` (:664),
`LBSGD` (:697), `Test` (:731), `Updater` (:746), `get_updater` (:806).

Every rule is plain PyTorch on tensors, in the JAX package's order of
operations, and writes the weight and its states in place (the JAX
package rebinds immutable arrays; here a parameter's storage stays where
it is, so update plans keep valid pointers). The lr/wd plumbing is the
JAX package's: `_update_count` (:185) drives ``num_update`` and so the
scheduler, and `_resolved_mult` (:192-205) reads
``param_dict[index].lr_mult`` / ``wd_mult`` first, so under
`gluon.Trainer` biases and BatchNorm betas take weight decay unless their
``wd_mult`` is 0. Multi-precision (:118-150) keeps an fp32 master of a
bf16/fp16 weight and updates through it.

SGD's rule is the hand-written kernel's MXNet form, through the
`sgd_mom_update` op's own function (`ops.extra.sgd_mxnet_update`): on the
card one parameter is one launch, through a plan kept while its weight
lives; on the CPU its plain version, `ops.sgd_mxnet_plain`.
`parallel.FusedUpdater` runs a whole group of SGD parameters through
that kernel in one launch. Adam, AdaGrad
and RMSProp are written over lists with `torch._foreach_*`, one function
for a key and for a fused group, so the two paths compute alike.
"""
from __future__ import annotations

import math
import pickle

import numpy as np
import torch

from . import random as _random
from .base import MXNetError
from .observability import registry as _obs
from .ops.extra import sgd_mxnet_update

__all__ = ["AdaDelta", "AdaGrad", "Adam", "Adamax", "DCASGD", "FTML",
           "Ftrl", "LBSGD", "NAG", "Nadam", "Optimizer", "RMSProp", "SGD",
           "SGLD", "Signum", "Test", "Updater", "create", "get_updater",
           "register"]

# every optimizer-update computation: one per per-key call, one per fused
# group (parallel/fused_update.py)
_UPDATE_DISPATCHES = _obs.counter(
    "optimizer.update.dispatches",
    "Optimizer update computations dispatched (per-param + fused-group)")

_LOW = (torch.float16, torch.bfloat16)


def _zeros(weight):
    return torch.zeros_like(weight, memory_format=torch.contiguous_format)


def _assign(dst, src):
    """Write `src` into `dst`, cast to its dtype (under no_grad)."""
    with torch.no_grad():
        dst.copy_(src)


class Optimizer:
    """Base optimizer (optimizer.py:71)."""

    opt_registry = {}

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.idx2name = dict(param_idx2name or {})
        # a Symbol's __lr_mult__/__wd_mult__ attributes (optimizer.py:96)
        self.sym_info = (sym.attr_dict(), sym.list_arguments()) \
            if sym is not None else ()
        self.param_dict = param_dict if param_dict else {}
        self.set_lr_mult({})
        self.set_wd_mult({})

    # -- registry -------------------------------------------------------
    @staticmethod
    def register(klass):
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() not in Optimizer.opt_registry:
            raise MXNetError("cannot find optimizer %s" % name)
        return Optimizer.opt_registry[name.lower()](**kwargs)

    # -- state ----------------------------------------------------------
    def create_state(self, index, weight):
        return None

    def create_state_multi_precision(self, index, weight):
        if self.multi_precision and weight.dtype in _LOW:
            master = weight.detach().to(torch.float32, copy=True,
                                        memory_format=torch.contiguous_format)
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def _is_multi_precision_state(self, weight, state):
        """True when `state` is the (fp32 master, base state) pair of a
        low-precision weight (optimizer.py:130): the dtype checks keep a
        tuple state of an fp32 weight (Adam's) from being read as one."""
        return (self.multi_precision and isinstance(state, tuple)
                and len(state) == 2 and isinstance(state[0], torch.Tensor)
                and state[0].dtype == torch.float32
                and state[0].dtype != weight.dtype)

    def update_multi_precision(self, index, weight, grad, state):
        if self._is_multi_precision_state(weight, state):
            master, base_state = state
            self.update(index, master, grad.float(), base_state)
            _assign(weight, master)
        else:
            self.update(index, weight, grad, state)

    # -- lr/wd plumbing -------------------------------------------------
    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError("lr_scheduler is set; cannot set lr directly")
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = {}
        if self.sym_info:
            attr, arg_names = self.sym_info
            for name in arg_names:
                if name in attr and "__lr_mult__" in attr[name]:
                    self.lr_mult[name] = float(attr[name]["__lr_mult__"])
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """Module's rule (optimizer.py:173): names that end in neither
        _weight nor _gamma get no weight decay. Under gluon.Trainer the
        param_dict's own wd_mult comes first (`_resolved_mult`)."""
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        if self.sym_info:
            attr, arg_names = self.sym_info
            for name in arg_names:
                if name in attr and "__wd_mult__" in attr[name]:
                    self.wd_mult[name] = float(attr[name]["__wd_mult__"])
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _resolved_mult(self, index, attr):
        """The multiplier ('lr_mult' or 'wd_mult') of `index`: the
        param_dict's parameter, then the mult table by index, then by
        name (optimizer.py:192-205)."""
        if index in self.param_dict:
            return float(getattr(self.param_dict[index], attr))
        table = getattr(self, attr)
        if index in table:
            return float(table[index])
        if index in self.idx2name:
            return float(table.get(self.idx2name[index], 1.0))
        return 1.0

    def _get_lr(self, index):
        if self.lr_scheduler is not None:
            lr = self.lr_scheduler(self.num_update)
        else:
            lr = self.lr
        return lr * self._resolved_mult(index, "lr_mult")

    def _get_wd(self, index):
        return self.wd * self._resolved_mult(index, "wd_mult")

    def __getstate__(self):
        # the parameters stay out of a pickle: the Trainer sets them again
        d = self.__dict__.copy()
        d["param_dict"] = {}
        return d


register = Optimizer.register
create = Optimizer.create_optimizer


def _prep(grad, rescale, clip, wd, weight):
    """optimizer.py:226: rescale, clip, weight decay."""
    g = grad * rescale
    if clip is not None:
        g = torch.clamp(g, -clip, clip)
    if wd:
        g = g + wd * weight
    return g


def _prep_all(gs, rescale, clip, wd, ws):
    """`_prep` over lists, with the same operations."""
    g = torch._foreach_mul(gs, rescale)
    if clip is not None:
        g = torch._foreach_clamp_max(torch._foreach_clamp_min(g, -clip),
                                     clip)
    if wd:
        g = torch._foreach_add(g, torch._foreach_mul(ws, wd))
    return g


def _copy_all(dsts, srcs):
    for d, s in zip(dsts, srcs):
        d.copy_(s)


@register
class SGD(Optimizer):
    """SGD with momentum, MXNet's form (optimizer.py:255):
    v' = momentum v - lr g~, w' = w + v'. A weight off the CPU is updated
    by the hand-written kernel, or the update raises."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        """The `sgd_update`/`sgd_mom_update` op's function, in place."""
        self._update_count(index)
        sgd_mxnet_update(weight, grad, state, None, weight,
                         self._get_lr(index), self.momentum,
                         self._get_wd(index), self.rescale_grad,
                         self.clip_gradient)


@register
class NAG(SGD):
    """Nesterov accelerated SGD (optimizer.py:287)."""

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        g = _prep(grad, self.rescale_grad, self.clip_gradient, wd, weight)
        if state is not None:
            m = self.momentum * state + g
            g = g + self.momentum * m
            _assign(state, m)
        _assign(weight, weight - lr * g)


@register
class Signum(Optimizer):
    """signSGD / Signum (optimizer.py:305)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        g = grad * self.rescale_grad
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        if state is not None:
            m = self.momentum * state - (1 - self.momentum) * (
                g + wd * weight)
            _assign(state, m)
            _assign(weight, (1 - lr * self.wd_lh) * weight
                    + lr * torch.sign(m))
        else:
            _assign(weight, (1 - lr * (wd + self.wd_lh)) * weight
                    - lr * torch.sign(g))


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (optimizer.py:337); the
    noise comes from `random.generator` on the weight's device."""

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        g = _prep(grad, self.rescale_grad, self.clip_gradient, wd, weight)
        noise = torch.randn(weight.shape, generator=_random.generator(
            weight.device), device=weight.device,
            dtype=weight.dtype) * math.sqrt(lr)
        _assign(weight, weight - lr / 2 * g + noise)


def _bias_coefs(beta1, beta2, t):
    """1 - beta^t in float32, as the JAX kernels compute them from a
    traced t."""
    one = np.float32(1.0)
    return (float(one - np.float32(beta1) ** np.float32(t)),
            float(one - np.float32(beta2) ** np.float32(t)))


def _adam_math(ws, gs, means, vars_, lr, t, wd, hyper):
    """optimizer.py:352 over lists; writes ws, means, vars_ in place."""
    beta1, beta2, epsilon, rescale, clip = hyper
    g = _prep_all(gs, rescale, clip, wd, ws)
    mean = torch._foreach_add(torch._foreach_mul(means, beta1),
                              torch._foreach_mul(g, 1 - beta1))
    var = torch._foreach_add(torch._foreach_mul(vars_, beta2),
                             torch._foreach_mul(torch._foreach_mul(g, g),
                                                1 - beta2))
    coef1, coef2 = _bias_coefs(beta1, beta2, t)
    lr_t = float(np.float32(lr) * np.float32(coef2) ** np.float32(0.5)
                 / np.float32(coef1))
    den = torch._foreach_add(torch._foreach_sqrt(var), epsilon)
    step = torch._foreach_div(torch._foreach_mul(mean, lr_t), den)
    _copy_all(ws, torch._foreach_sub(ws, step))
    _copy_all(means, mean)
    _copy_all(vars_, var)


@register
class Adam(Optimizer):
    """Adam (optimizer.py:370)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def hyper(self):
        return (self.beta1, self.beta2, self.epsilon, self.rescale_grad,
                self.clip_gradient)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        t = self._index_update_count[index]
        mean, var = state
        with torch.no_grad():
            _adam_math([weight], [grad], [mean], [var], lr, t, wd,
                       self.hyper())


def _adagrad_math(ws, gs, states, lr, t, wd, hyper):
    """optimizer.py:407 over lists; states = [history list]."""
    epsilon, rescale, clip = hyper
    (hist,) = states
    g = _prep_all(gs, rescale, clip, wd, ws)
    h = torch._foreach_add(hist, torch._foreach_mul(g, g))
    den = torch._foreach_add(torch._foreach_sqrt(h), epsilon)
    step = torch._foreach_div(torch._foreach_mul(g, lr), den)
    _copy_all(ws, torch._foreach_sub(ws, step))
    _copy_all(hist, h)


def _rmsprop_math(ws, gs, states, lr, t, wd, hyper):
    """optimizer.py:414 over lists; states = [n] or [n, g, delta]."""
    gamma1, gamma2, epsilon, centered, clip_weights, rescale, clip = hyper
    g = _prep_all(gs, rescale, clip, wd, ws)
    sq = torch._foreach_mul(g, g)
    if centered:
        n, gm, delta = states
        n_ = torch._foreach_add(torch._foreach_mul(n, gamma1),
                                torch._foreach_mul(sq, 1 - gamma1))
        gm_ = torch._foreach_add(torch._foreach_mul(gm, gamma1),
                                 torch._foreach_mul(g, 1 - gamma1))
        den = torch._foreach_sqrt(torch._foreach_add(
            torch._foreach_sub(n_, torch._foreach_mul(gm_, gm_)), epsilon))
        d_ = torch._foreach_sub(torch._foreach_mul(delta, gamma2),
                                torch._foreach_div(
                                    torch._foreach_mul(g, lr), den))
        w = torch._foreach_add(ws, d_)
        new = (n_, gm_, d_)
    else:
        (n,) = states
        n_ = torch._foreach_add(torch._foreach_mul(sq, 1 - gamma1),
                                torch._foreach_mul(n, gamma1))
        den = torch._foreach_sqrt(torch._foreach_add(n_, epsilon))
        w = torch._foreach_sub(ws, torch._foreach_div(
            torch._foreach_mul(g, lr), den))
        new = (n_,)
    if clip_weights:
        w = torch._foreach_clamp_max(
            torch._foreach_clamp_min(w, -clip_weights), clip_weights)
    _copy_all(ws, w)
    for dst, src in zip(states, new):
        _copy_all(dst, src)


@register
class AdaGrad(Optimizer):
    """AdaGrad (optimizer.py:446)."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros(weight)

    def hyper(self):
        return (self.float_stable_eps, self.rescale_grad, self.clip_gradient)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        with torch.no_grad():
            _adagrad_math([weight], [grad], [[state]], lr,
                          self._index_update_count[index], wd, self.hyper())


@register
class RMSProp(Optimizer):
    """RMSProp, centered and not (optimizer.py:470)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        n = 3 if self.centered else 1
        return tuple(_zeros(weight) for _ in range(n))

    def hyper(self):
        return (self.gamma1, self.gamma2, self.epsilon, self.centered,
                self.clip_weights, self.rescale_grad, self.clip_gradient)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        with torch.no_grad():
            _rmsprop_math([weight], [grad], [[s] for s in state], lr,
                          self._index_update_count[index], wd, self.hyper())


@register
class AdaDelta(Optimizer):
    """AdaDelta (optimizer.py:504)."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        wd = self._get_wd(index)
        g = _prep(grad, self.rescale_grad, self.clip_gradient, wd, weight)
        acc_g, acc_delta = state
        ag = self.rho * acc_g + (1 - self.rho) * torch.square(g)
        delta = torch.sqrt(acc_delta + self.epsilon) / torch.sqrt(
            ag + self.epsilon) * g
        ad = self.rho * acc_delta + (1 - self.rho) * torch.square(delta)
        _assign(acc_g, ag)
        _assign(acc_delta, ad)
        _assign(weight, weight - delta)


@register
class Ftrl(Optimizer):
    """FTRL (optimizer.py:531)."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))     # z, n

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        g = grad * self.rescale_grad
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        z, n = state
        sigma = (torch.sqrt(n + torch.square(g)) - torch.sqrt(n)) / lr
        z_ = z + g - sigma * weight
        n_ = n + torch.square(g)
        _assign(z, z_)
        _assign(n, n_)
        _assign(weight, torch.where(
            torch.abs(z_) <= self.lamda1, torch.zeros_like(z_),
            (torch.sign(z_) * self.lamda1 - z_)
            / ((self.beta + torch.sqrt(n_)) / lr + wd)))


@register
class Adamax(Optimizer):
    """AdaMax (optimizer.py:563)."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        t = self._index_update_count[index]
        lr /= (1.0 - self.beta1 ** t)
        g = _prep(grad, self.rescale_grad, self.clip_gradient, wd, weight)
        m, u = state
        m_ = self.beta1 * m + (1 - self.beta1) * g
        u_ = torch.maximum(self.beta2 * u, torch.abs(g))
        _assign(m, m_)
        _assign(u, u_)
        _assign(weight, weight - lr * m_ / (u_ + 1e-8))


@register
class Nadam(Optimizer):
    """Nesterov Adam (optimizer.py:591)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        t = self._index_update_count[index]
        g = _prep(grad, self.rescale_grad, self.clip_gradient, wd, weight)
        momentum_t = self.beta1 * (
            1.0 - 0.5 * 0.96 ** (t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (
            1.0 - 0.5 * 0.96 ** ((t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        m, v = state
        g_prime = g / (1.0 - self.m_schedule)
        m_ = self.beta1 * m + (1.0 - self.beta1) * g
        v_ = self.beta2 * v + (1.0 - self.beta2) * torch.square(g)
        m_prime = m_ / (1.0 - m_schedule_next)
        v_prime = v_ / (1.0 - self.beta2 ** t)
        m_bar = (1.0 - momentum_t) * g_prime + momentum_t_1 * m_prime
        _assign(m, m_)
        _assign(v, v_)
        _assign(weight, weight - lr * m_bar / (
            torch.sqrt(v_prime) + self.epsilon))


@register
class FTML(Optimizer):
    """FTML (optimizer.py:631)."""

    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight), _zeros(weight))  # d, v, z

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        t = self._index_update_count[index]
        g = _prep(grad, self.rescale_grad, self.clip_gradient, wd, weight)
        d, v, z = state
        v_ = self.beta2 * v + (1 - self.beta2) * torch.square(g)
        d_ = (1 - self.beta1 ** t) / lr * (
            torch.sqrt(v_ / (1 - self.beta2 ** t)) + self.epsilon)
        sigma = d_ - self.beta1 * d
        z_ = self.beta1 * z + (1 - self.beta1) * g - sigma * weight
        _assign(d, d_)
        _assign(v, v_)
        _assign(z, z_)
        _assign(weight, -z_ / d_)


@register
class DCASGD(Optimizer):
    """Delay-compensated async SGD (optimizer.py:664)."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        prev = weight.detach().clone(memory_format=torch.contiguous_format)
        if self.momentum == 0.0:
            return (None, prev)
        return (_zeros(weight), prev)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        g = _prep(grad, self.rescale_grad, self.clip_gradient, wd, weight)
        mom, prev = state
        comp = g + self.lamda * g * g * (weight - prev)
        if mom is not None:
            m = self.momentum * mom - lr * (comp + wd * weight)
            _assign(mom, m)
            step = m
        else:
            step = -lr * (comp + wd * weight)
        _assign(prev, weight)
        _assign(weight, weight + step)


@register
class LBSGD(SGD):
    """Large-batch SGD with a LARS trust ratio (optimizer.py:697)."""

    def __init__(self, warmup_strategy="linear", warmup_epochs=5,
                 batch_scale=1, updates_per_epoch=32, begin_epoch=0,
                 num_epochs=60, **kwargs):
        super().__init__(**kwargs)
        self.warmup_strategy = warmup_strategy
        self.warmup_epochs = warmup_epochs
        self.batch_scale = batch_scale
        self.updates_per_epoch = updates_per_epoch

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr = self._get_lr(index)
        wd = self._get_wd(index)
        g = _prep(grad, self.rescale_grad, self.clip_gradient, wd, weight)
        wnorm = torch.linalg.vector_norm(weight)
        gnorm = torch.linalg.vector_norm(g)
        trust = torch.where(gnorm > 0, wnorm / (gnorm + 1e-9),
                            torch.ones_like(gnorm))
        lr_eff = lr * torch.clamp(trust, 0.0, 50.0)
        if state is not None:
            m = self.momentum * state - lr_eff * g
            _assign(state, m)
            _assign(weight, weight + m)
        else:
            _assign(weight, weight - lr_eff * g)


@register
class Test(Optimizer):
    """The trivial optimizer of the unit tests (optimizer.py:731)."""

    def create_state(self, index, weight):
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        _assign(weight, weight - self.rescale_grad * grad)


Optimizer.opt_registry["ccsgd"] = SGD


class Updater:
    """Applies an optimizer keyed by parameter index (optimizer.py:746):
    what the Trainer and the kvstore run."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def _state_of(self, index, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
            self.states_synced[index] = True
        elif not self.states_synced.get(index, True):
            self.states[index] = self.sync_state_context(
                self.states[index], weight.device)
            self.states_synced[index] = True
        return self.states[index]

    def __call__(self, index, grad, weight):
        """Update `weight` in place from `grad` (tensors, or NDArrays,
        whose tensors are updated)."""
        from .ndarray import NDArray
        if isinstance(grad, NDArray):
            grad = grad._data
        if isinstance(weight, NDArray):
            weight = weight._data
        state = self._state_of(index, weight)
        _UPDATE_DISPATCHES.inc()
        with torch.no_grad():
            self.optimizer.update_multi_precision(index, weight, grad, state)

    def update_all(self, indices, grads, weights):
        """The whole (index, grad, weight) set in one call: here a loop
        over keys; `parallel.FusedUpdater` groups it."""
        for i, g, w in zip(indices, grads, weights):
            self(i, g, w)

    def sync_state_context(self, state, device):
        """Move a state (tensors, possibly nested in tuples) to `device`,
        keeping dtypes (optimizer.py:780)."""
        if isinstance(state, torch.Tensor):
            return state.to(device)
        if isinstance(state, (list, tuple)):
            return type(state)(self.sync_state_context(s, device)
                               for s in state)
        return state

    def set_states(self, states):
        """Adopt pickled states (and optimizer), as `get_states` wrote
        them; they move to each weight's device on first use. Only bytes
        this package wrote may be given: unpickling runs code."""
        states = pickle.loads(states)
        if isinstance(states, tuple) and len(states) == 2:
            self.states, self.optimizer = states
        else:
            self.states = states
        self.states_synced = dict.fromkeys(self.states.keys(), False)

    def get_states(self, dump_optimizer=False):
        return pickle.dumps((self.states, self.optimizer)
                            if dump_optimizer else self.states)


def get_updater(optimizer):
    """The fusing updater (`parallel.FusedUpdater`): one launch of the
    hand-written kernel per SGD group, per key for what it does not
    fuse."""
    from .parallel.fused_update import FusedUpdater
    return FusedUpdater(optimizer)
