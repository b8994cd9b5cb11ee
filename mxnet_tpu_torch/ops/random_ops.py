"""Random sampling operators (counterpart of mxnet_tpu/ops/random_ops.py;
reference: src/operator/random/sample_op.cc, multisample_op.cc,
shuffle_op.cc).

Every op takes a `torch.Generator` as its first input, which
`ndarray.invoke` passes: the package's generator for the output's device
(`random.generator`, seeded by `mx.random.seed`). The draws are
PyTorch's: they match the JAX package's in distribution, not in bits.
"""
from __future__ import annotations

import torch

from ..base import dtype_from_name
from .registry import register


def _dt(dtype, default="float32"):
    if dtype is None or dtype == "None":
        dtype = default
    return dtype_from_name(dtype)


def _dev(gen):
    return gen.device


def gamma_draws(gen, alpha, shape, device):
    """Gamma(alpha, 1) draws of `shape` (alpha a number or a tensor that
    broadcasts to it), in float32."""
    a = torch.as_tensor(alpha, dtype=torch.float32, device=device)
    return torch._standard_gamma(a.expand(shape).contiguous(),
                                 generator=gen)


def poisson_draws(gen, rate):
    return torch.poisson(rate.float(), generator=gen)


@register("_random_uniform", aliases=("random_uniform", "uniform"),
          needs_rng=True)
def _uniform(gen, *, low=0.0, high=1.0, shape=(1,), dtype=None, ctx=None):
    u = torch.rand(tuple(shape), dtype=_dt(dtype), device=_dev(gen),
                   generator=gen)
    return low + (high - low) * u


@register("_random_normal", aliases=("random_normal", "normal"),
          needs_rng=True)
def _normal(gen, *, loc=0.0, scale=1.0, shape=(1,), dtype=None, ctx=None):
    return loc + scale * torch.randn(tuple(shape), dtype=_dt(dtype),
                                     device=_dev(gen), generator=gen)


@register("_random_gamma", aliases=("random_gamma",), needs_rng=True)
def _gamma(gen, *, alpha=1.0, beta=1.0, shape=(1,), dtype=None, ctx=None):
    return (beta * gamma_draws(gen, alpha, tuple(shape), _dev(gen))).to(
        _dt(dtype))


@register("_random_exponential", aliases=("random_exponential",),
          needs_rng=True)
def _exponential(gen, *, lam=1.0, shape=(1,), dtype=None, ctx=None):
    e = torch.empty(tuple(shape), dtype=_dt(dtype), device=_dev(gen))
    return e.exponential_(1.0, generator=gen) / lam


@register("_random_poisson", aliases=("random_poisson",), needs_rng=True)
def _poisson(gen, *, lam=1.0, shape=(1,), dtype=None, ctx=None):
    rate = torch.full(tuple(shape), float(lam), device=_dev(gen))
    return poisson_draws(gen, rate).to(_dt(dtype))


@register("_random_negative_binomial",
          aliases=("random_negative_binomial",), needs_rng=True)
def _neg_binomial(gen, *, k=1, p=1.0, shape=(1,), dtype=None, ctx=None):
    lam = gamma_draws(gen, k, tuple(shape), _dev(gen)) * (1 - p) / p
    return poisson_draws(gen, lam).to(_dt(dtype))


@register("_random_generalized_negative_binomial",
          aliases=("random_generalized_negative_binomial",), needs_rng=True)
def _gen_neg_binomial(gen, *, mu=1.0, alpha=1.0, shape=(1,), dtype=None,
                      ctx=None):
    r = 1.0 / alpha
    p = r / (r + mu)
    lam = gamma_draws(gen, r, tuple(shape), _dev(gen)) * (1 - p) / p
    return poisson_draws(gen, lam).to(_dt(dtype))


@register("_random_randint", aliases=("random_randint", "randint"),
          needs_rng=True)
def _randint(gen, *, low=0, high=1, shape=(1,), dtype="int32", ctx=None):
    return torch.randint(int(low), int(high), tuple(shape),
                         dtype=_dt(dtype, "int32"), device=_dev(gen),
                         generator=gen)


@register("_sample_uniform", aliases=("sample_uniform",), needs_rng=True)
def _sample_uniform(gen, low, high, *, shape=(), dtype=None):
    s = tuple(low.shape) + tuple(shape)
    u = torch.rand(s, dtype=_dt(dtype), device=low.device, generator=gen)
    tail = (1,) * len(tuple(shape))
    return low.reshape(tuple(low.shape) + tail) + \
        (high - low).reshape(tuple(low.shape) + tail) * u


@register("_sample_normal", aliases=("sample_normal",), needs_rng=True)
def _sample_normal(gen, mu, sigma, *, shape=(), dtype=None):
    s = tuple(mu.shape) + tuple(shape)
    z = torch.randn(s, dtype=_dt(dtype), device=mu.device, generator=gen)
    tail = (1,) * len(tuple(shape))
    return mu.reshape(tuple(mu.shape) + tail) + \
        sigma.reshape(tuple(sigma.shape) + tail) * z


@register("_sample_multinomial", aliases=("sample_multinomial",),
          needs_rng=True,
          num_outputs=lambda p: 2 if p.get("get_prob", False) else 1)
def _sample_multinomial(gen, data, *, shape=(), get_prob=False,
                        dtype="int32"):
    """data: (..., k) probabilities; draws category indices, `shape` per
    row (one per row when `shape` is empty)."""
    shp = tuple(shape) if shape else ()
    n = 1
    for s in shp:
        n *= s
    k = data.shape[-1]
    probs = data.reshape(-1, k).float()
    idx = torch.multinomial(probs, n, replacement=True, generator=gen)
    idx = idx.reshape(tuple(data.shape[:-1]) + shp)
    out = idx.to(_dt(dtype, "int32"))
    if get_prob:
        logp = torch.log(torch.clamp(data.float(), min=1e-37))
        flat = logp.reshape(-1, k)
        lp = torch.gather(flat, 1, idx.reshape(flat.shape[0], -1))
        return out, lp.reshape(idx.shape)
    return out


@register("_shuffle", aliases=("shuffle",), needs_rng=True)
def _shuffle(gen, x):
    perm = torch.randperm(x.shape[0], device=x.device, generator=gen)
    return x[perm]


@register("bernoulli", needs_rng=True)
def _bernoulli(gen, *, prob=0.5, shape=(1,), dtype=None, ctx=None):
    e = torch.empty(tuple(shape), dtype=torch.float32, device=_dev(gen))
    return e.bernoulli_(prob, generator=gen).to(_dt(dtype))
