"""Parity of the port's Gluon losses (mxnet_tpu_torch/gluon/loss.py) with
the JAX package's, on the CPU: all 12, each plain, with a `weight` and
with a broadcast `sample_weight`. The same seeded numpy predictions and
labels go through both under `record()`; the per-sample losses and the
gradient of their sum with respect to the prediction agree within 1e-5
(fp32 on both sides; CTC 1e-4, a log-space recursion summed in another
order)."""
import numpy as np
import jax
from jax._src import compilation_cache
import pytest

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd, gluon, nd

TOL = 1e-5
CTC_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _no_persistent_compile_cache():
    """The session's persistent compile cache (tests/conftest.py) installs
    a read guard that takes one argument fewer than jax 0.9 passes it, so
    every JAX compile under it raises. This module's JAX compiles run with
    the cache off; the setting is restored, and the cache reset, after."""
    was = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", was)
    compilation_cache.reset_cache()


def _rng(seed):
    return np.random.RandomState(seed)


def _f32(a):
    return np.asarray(a, np.float32)


def _regression(seed):
    r = _rng(seed)
    return _f32(r.randn(4, 3)), _f32(r.randn(4, 3))


def _signed(seed):
    r = _rng(seed)
    return _f32(r.randn(4, 3)), _f32(np.sign(r.randn(4, 3)))


def _binary(seed):
    r = _rng(seed)
    return _f32(r.randn(4, 3)), _f32(r.randint(0, 2, (4, 3)))


def _probs(seed):
    r = _rng(seed)
    return _f32(r.rand(4, 3) * 0.8 + 0.1), _f32(r.randint(0, 2, (4, 3)))


def _classes(seed):
    r = _rng(seed)
    return _f32(r.randn(4, 5)), _f32(r.randint(0, 5, 4))


def _dense_label(seed):
    r = _rng(seed)
    p = r.rand(4, 5)
    return _f32(r.randn(4, 5)), _f32(p / p.sum(1, keepdims=True))


def _kl(seed):
    r = _rng(seed)
    p = r.rand(4, 5)
    logp = np.log(r.rand(4, 5) + 0.1)
    return _f32(logp), _f32(p / p.sum(1, keepdims=True))


# name -> (constructor on a gluon package, data, kwargs)
CASES = {
    "l2": (lambda g, **k: g.loss.L2Loss(**k), _regression),
    "l1": (lambda g, **k: g.loss.L1Loss(**k), _regression),
    "sigmoid_bce": (lambda g, **k: g.loss.SigmoidBinaryCrossEntropyLoss(
        **k), _binary),
    "sigmoid_bce_from_sigmoid": (
        lambda g, **k: g.loss.SigmoidBCELoss(from_sigmoid=True, **k),
        _probs),
    "softmax_ce": (lambda g, **k: g.loss.SoftmaxCrossEntropyLoss(**k),
                   _classes),
    "softmax_ce_dense": (lambda g, **k: g.loss.SoftmaxCELoss(
        sparse_label=False, **k), _dense_label),
    "kldiv": (lambda g, **k: g.loss.KLDivLoss(**k), _kl),
    "kldiv_logits": (lambda g, **k: g.loss.KLDivLoss(from_logits=False,
                                                     **k), _dense_label),
    "huber": (lambda g, **k: g.loss.HuberLoss(rho=0.7, **k), _regression),
    "hinge": (lambda g, **k: g.loss.HingeLoss(**k), _signed),
    "squared_hinge": (lambda g, **k: g.loss.SquaredHingeLoss(margin=1.5,
                                                             **k), _signed),
    "logistic": (lambda g, **k: g.loss.LogisticLoss(**k), _signed),
    "logistic_binary": (lambda g, **k: g.loss.LogisticLoss(
        label_format="binary", **k), _binary),
}


def _run(pkg, loss, pred, label, sample_weight=None):
    """(per-sample loss, d sum / d pred) on one side."""
    if pkg == "jax":
        arr, record = mx.nd.array, mx.autograd.record
    else:
        arr, record = nd.array, autograd.record
    p = arr(pred)
    p.attach_grad()
    extra = [] if sample_weight is None else [arr(sample_weight)]
    with record():
        out = loss(p, arr(label), *extra)
    out.backward()
    return out.asnumpy(), p.grad.asnumpy()


@pytest.mark.parametrize("weighting", ["plain", "weight", "sample_weight"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_matches_jax(name, weighting):
    make, data = CASES[name]
    pred, label = data(3)
    kwargs = {"weight": 0.7} if weighting == "weight" else {}
    sw = _f32(_rng(4).rand(4, 1)) if weighting == "sample_weight" else None
    want = _run("jax", make(jgluon, **kwargs), pred, label, sw)
    with tmx.cpu():
        got = _run("port", make(gluon, **kwargs), pred, label, sw)
    for w, g in zip(want, got):
        assert g.shape == w.shape
        assert np.abs(g - w).max() < TOL, (name, weighting)


@pytest.mark.parametrize("weighting", ["plain", "weight"])
def test_triplet_loss_matches_jax(weighting):
    r = _rng(5)
    pred, pos, neg = (_f32(r.randn(4, 6) * 0.5) for _ in range(3))
    kwargs = {"weight": 0.5} if weighting == "weight" else {}
    outs = []
    for pkg, g, arr, rec in (("jax", jgluon, mx.nd.array, mx.autograd.record),
                             ("port", gluon, nd.array, autograd.record)):
        with tmx.cpu():
            p = arr(pred)
            p.attach_grad()
            with rec():
                out = g.loss.TripletLoss(margin=0.5, **kwargs)(
                    p, arr(pos), arr(neg))
            out.backward()
            outs.append((out.asnumpy(), p.grad.asnumpy()))
    for w, g in zip(*outs):
        assert np.abs(g - w).max() < TOL


@pytest.mark.parametrize("layout,lengths", [("NTC", False), ("TNC", True)])
def test_ctc_loss_matches_jax(layout, lengths):
    """Blank 0, labels padded with 0; given lengths, in both layouts."""
    r = _rng(6)
    T, N, C = 7, 3, 5
    pred = _f32(r.randn(N, T, C) if layout == "NTC" else r.randn(T, N, C))
    label = _f32([[1, 2, 2, 0], [3, 0, 0, 0], [4, 1, 3, 2]])
    outs = []
    for g, arr, rec in ((jgluon, mx.nd.array, mx.autograd.record),
                        (gluon, nd.array, autograd.record)):
        with tmx.cpu():
            p = arr(pred)
            p.attach_grad()
            args = [arr(label)]
            if lengths:
                args += [arr(_f32([7, 5, 6])), arr(_f32([3, 1, 4]))]
            with rec():
                out = g.loss.CTCLoss(layout=layout)(p, *args)
            out.backward()
            outs.append((out.asnumpy(), p.grad.asnumpy()))
    for w, g in zip(*outs):
        assert g.shape == w.shape
        assert np.abs(g - w).max() < CTC_TOL * max(1.0, np.abs(w).max())


def test_losses_are_blocks_on_the_loss_base():
    for name, (make, _) in CASES.items():
        assert isinstance(make(gluon), gluon.loss.Loss), name
    loss = gluon.loss.L2Loss()
    assert repr(loss) == "L2Loss(batch_axis=0, w=1.0)"
