"""Parity of the PyTorch port's operators (mxnet_tpu_torch/ops/nn.py) with
the JAX package's registered ops (mxnet_tpu/ops/nn.py), on the CPU, in
both layouts: Activation, FullyConnected, Convolution, Pooling and
BatchNorm, and the SoftmaxCrossEntropyLoss block. Inputs are made with
numpy from a seed and fed to both; every comparison is fp32 on both sides
(atol 1e-5; 1e-4 where convolutions and BatchNorm sum more terms, in
other orders)."""
import numpy as np
import jax
from jax._src import compilation_cache
import jax.numpy as jnp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.ops import nn as jnn
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.ops import nn as tnn

TOL = 1e-5


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


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got.detach().numpy() - want).max() < tol


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu",
                                 "softsign", "gelu", "silu"])
def test_activation(act):
    x = _rand(3, 17) * 3
    _close(tnn.activation(torch.from_numpy(x), act),
           jnn._activation(jnp.asarray(x), act_type=act))


def test_activation_refuses_an_unknown_type():
    with pytest.raises(MXNetError, match="act_type"):
        tnn.activation(torch.zeros(2), "swoosh")


@pytest.mark.parametrize("flatten", [True, False])
def test_fully_connected(flatten):
    x, w, b = _rand(4, 3, 5), _rand(7, 15 if flatten else 5, seed=1), \
        _rand(7, seed=2)
    _close(tnn.fully_connected(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(b), flatten),
           jnn._fully_connected(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b), num_hidden=7,
                                flatten=flatten))


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("kernel,stride,pad,dilate,groups",
                         [(3, 1, 1, 1, 1), (3, 2, 0, 2, 1), (1, 2, 0, 1, 1),
                          (3, 1, 1, 1, 2)])
def test_convolution(layout, kernel, stride, pad, dilate, groups):
    cin, cout = 4, 6
    x = _rand(2, cin, 9, 9)
    w = _rand(cout, cin // groups, kernel, kernel, seed=1) * 0.3
    b = _rand(cout, seed=2)
    xj, wj = x, w
    if layout == "NHWC":       # JAX's NHWC weight is (O, kh, kw, I)
        xj, wj = x.transpose(0, 2, 3, 1), w.transpose(0, 2, 3, 1)
    want = jnn._convolution(jnp.asarray(xj), jnp.asarray(wj), jnp.asarray(b),
                            kernel=(kernel, kernel), num_filter=cout,
                            stride=(stride, stride), pad=(pad, pad),
                            dilate=(dilate, dilate), num_group=groups,
                            layout=layout)
    got = tnn.convolution(torch.from_numpy(np.ascontiguousarray(xj)),
                          torch.from_numpy(w), torch.from_numpy(b), stride,
                          pad, dilate, groups, layout)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("pool_type,count_include_pad",
                         [("max", True), ("avg", True), ("avg", False)])
def test_pooling(layout, pool_type, count_include_pad):
    x = _rand(2, 3, 8, 8)
    if layout == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    kw = dict(kernel=(3, 3), pool_type=pool_type, stride=(2, 2),
              pad=(1, 1), count_include_pad=count_include_pad,
              layout=layout)
    _close(tnn.pooling(torch.from_numpy(x), **kw),
           jnn._pooling(jnp.asarray(x), **kw))
    for pool in ("max", "avg"):
        _close(tnn.pooling(torch.from_numpy(x), pool_type=pool,
                           global_pool=True, layout=layout),
               jnn._pooling(jnp.asarray(x), pool_type=pool,
                            global_pool=True, layout=layout))


def test_pooling_refuses_the_full_convention():
    with pytest.raises(MXNetError, match="valid"):
        tnn.pooling(torch.zeros(1, 1, 4, 4), kernel=(2, 2),
                    pooling_convention="full")


@pytest.mark.parametrize("mode", ["train", "predict", "global_stats",
                                  "fix_gamma"])
@pytest.mark.parametrize("axis", [1, 3])
def test_batch_norm(mode, axis):
    """y and the new moving statistics, against `_batch_norm`'s outputs
    0, 3 and 4; a large mean tests the clamped single-pass variance."""
    x = _rand(4, 5, 6, 7) * 2 + 3
    c = x.shape[axis]
    gamma, beta = _rand(c, seed=1) + 1, _rand(c, seed=2)
    mm, mv = _rand(c, seed=3) * 0.1, np.abs(_rand(c, seed=4)) + 0.5
    kw = dict(eps=1e-5, momentum=0.9, fix_gamma=mode == "fix_gamma",
              use_global_stats=mode == "global_stats", axis=axis)
    want = jnn._batch_norm(*(jnp.asarray(a) for a in (x, gamma, beta, mm,
                                                      mv)),
                           _mode="predict" if mode == "predict" else "train",
                           **kw)
    got = tnn.batch_norm(*(torch.from_numpy(a) for a in (x, gamma, beta, mm,
                                                         mv)),
                         training=mode != "predict", **kw)
    for g, w in zip(got, (want[0], want[3], want[4])):
        _close(g, w, 1e-4)


@pytest.mark.parametrize("sparse", [True, False])
def test_softmax_cross_entropy_loss(sparse):
    """gluon/loss.py:108, per-sample losses; float sparse labels are taken
    as integers, as `pick` casts them."""
    pred = _rand(6, 10) * 2
    label = (np.arange(6) * 3 % 10).astype(np.float32) if sparse else \
        np.abs(_rand(6, 10, seed=1))
    want = jgluon.loss.SoftmaxCrossEntropyLoss(sparse_label=sparse)(
        mx.nd.array(pred), mx.nd.array(label)).asnumpy()
    got = SoftmaxCrossEntropyLoss(sparse_label=sparse)(
        torch.from_numpy(pred), torch.from_numpy(label))
    _close(got, want)
