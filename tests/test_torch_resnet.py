"""Parity of the PyTorch port's ResNet V1 with the JAX package's, on the CPU.

A small JAX `ResNetV1(BottleneckV1, [1, 1], [16, 32, 64], classes=10)` is
initialised from a seed, its weights (and random running statistics)
carried over with `convert.resnet_params_from_jax`, and the same numpy
batch goes through both: logits in predict mode, and in training mode the
logits and the BatchNorm moving statistics after one forward. On both
sides the mode follows autograd: training under `autograd.record()`,
predict outside it. In training mode the port's NHWC net runs every 1x1
convolution + BatchNorm through `ops.conv1x1_bn_stats` (its plain
version on the CPU). A `resnet18_v1` covers BasicBlockV1 and its
downsample.
"""
import numpy as np
import jax
from jax._src import compilation_cache
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet
from mxnet_tpu_torch import MXNetError, autograd
from mxnet_tpu_torch.convert import init_resnet_params, resnet_params_from_jax
from mxnet_tpu_torch.gluon import collect_params
from mxnet_tpu_torch.gluon.model_zoo import vision

# fp32 on both sides; sums and convolutions run in other orders
LOGIT_TOL = 1e-4
STAT_TOL = 1e-5


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


def _jax_net(ctor, layout, seed, img=32):
    """A JAX net with seeded Xavier weights and random running
    statistics; returns (net, {name: numpy array})."""
    np.random.seed(seed)
    mx.random.seed(seed)
    net = ctor(layout)
    net.initialize(mx.init.Xavier(magnitude=2))
    shape = (1, img, img, 3) if layout == "NHWC" else (1, 3, img, img)
    net.infer_shape(mx.nd.zeros(shape))
    rng = np.random.RandomState(seed)
    for name, p in net.collect_params().items():
        p._finish_deferred_init()
        n = p.shape[0]
        if name.endswith("_running_mean"):
            p.set_data(mx.nd.array(rng.randn(n).astype(np.float32) * 0.1))
        elif name.endswith("_running_var"):
            p.set_data(mx.nd.array(rng.rand(n).astype(np.float32) + 0.5))
    return net, {k: np.asarray(v.data()._data)
                 for k, v in net.collect_params().items()}


def _small_jax(layout):
    return jresnet.ResNetV1(jresnet.BottleneckV1, [1, 1], [16, 32, 64],
                            classes=10, layout=layout)


def _small_port(layout):
    return vision.ResNetV1(vision.BottleneckV1, [1, 1], [16, 32, 64],
                           classes=10, layout=layout, device="cpu")


def _batch(layout, n=4, img=32, seed=1):
    x = np.random.RandomState(seed).randn(n, img, img, 3).astype(np.float32)
    return x if layout == "NHWC" else np.ascontiguousarray(
        x.transpose(0, 3, 1, 2))


@pytest.fixture(scope="module", params=["NHWC", "NCHW"])
def small(request):
    layout = request.param
    jnet, np_params = _jax_net(_small_jax, layout, seed=5)
    tnet = _small_port(layout)
    # structural names: the JAX net's dotted block paths
    tnet.load_parameters(resnet_params_from_jax(jnet, "cpu", layout))
    return layout, jnet, tnet, np_params


def test_weights_carry_over_name_for_name(small):
    layout, jnet, tnet, np_params = small
    names = collect_params(tnet)
    assert len(np_params) == len(names) == 51
    assert {k[len(jnet.prefix):] for k in np_params} == \
        {k[len(tnet.prefix):] for k in names}
    # the JAX block paths are the port's module paths
    paths = {p.name: k for k, p in
             jnet._collect_params_with_prefix().items()}
    assert set(paths.values()) == set(names.values())
    tensors = dict(tnet.named_parameters())
    tensors.update(tnet.named_buffers())
    for jname, arr in np_params.items():
        got = tensors[paths[jname]].detach().numpy()
        if layout == "NHWC" and arr.ndim == 4:
            got = got.transpose(0, 2, 3, 1)    # back to (O, kh, kw, I)
        assert np.array_equal(got, arr), jname


def test_load_parameters_raises_on_missing_extra_or_misshaped(small):
    layout, _, tnet, np_params = small
    params = resnet_params_from_jax(np_params, "cpu", layout)
    with pytest.raises(MXNetError, match="missing"):
        tnet.load_parameters({k: v for k, v in params.items()
                              if k != "dense0_bias"})
    with pytest.raises(MXNetError, match="unexpected"):
        tnet.load_parameters({**params, "dense1_bias": params["dense0_bias"]})
    with pytest.raises(MXNetError, match="shape"):
        tnet.load_parameters({**params,
                              "dense0_bias": torch.zeros(11)})
    with pytest.raises(MXNetError, match="prefix"):
        resnet_params_from_jax({"a_w": np.zeros(1), "b_w": np.zeros(1)},
                               "cpu")


def test_predict_logits_match_jax(small):
    layout, jnet, tnet, _ = small
    x = _batch(layout)
    want = jnet(mx.nd.array(x)).asnumpy()
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    assert got.shape == (4, 10) and np.isfinite(got).all()
    assert np.abs(got - want).max() < LOGIT_TOL


def test_train_logits_and_moving_stats_match_jax(small):
    """One training-mode forward on each side (autograd.record in both
    packages); the port's BatchNorm moves its running statistics in
    place, as the JAX net's aux write does. Runs after the tests that
    read the module's nets unchanged."""
    layout, jnet, _, np_params = small
    tnet = _small_port(layout)
    tnet.load_parameters(resnet_params_from_jax(np_params, "cpu", layout))
    x = _batch(layout, seed=2)
    with mx.autograd.record():
        want = jnet(mx.nd.array(x)).asnumpy()
    with autograd.record():
        got = tnet(torch.from_numpy(x)).detach().numpy()
    assert np.abs(got - want).max() < LOGIT_TOL
    names = collect_params(tnet)
    bufs = dict(tnet.named_buffers())
    moved = 0
    for jname, p in jnet.collect_params().items():
        if "_running_" in jname:
            new = np.asarray(p.data()._data)
            assert not np.array_equal(new, np_params[jname])
            port = bufs[names[tnet.prefix + jname[len(jnet.prefix):]]] \
                .numpy()
            assert np.abs(port - new).max() < STAT_TOL, jname
            moved += 1
    assert moved == 18


@pytest.fixture(scope="module")
def resnet18():
    jnet, np_params = _jax_net(
        lambda layout: jresnet.resnet18_v1(classes=10, layout=layout),
        "NHWC", seed=6)
    tnet = vision.resnet18_v1(classes=10, layout="NHWC", device="cpu")
    tnet.load_parameters(resnet_params_from_jax(jnet, "cpu", "NHWC"))
    return jnet, tnet


@pytest.mark.parametrize("mode", ["predict", "train"])
def test_resnet18_v1_nhwc_logits_match_jax(resnet18, mode):
    """BasicBlockV1, and the downsample of stages 2-4, whose 1x1
    convolution + BatchNorm take the kernel path in training mode
    (predict first: training moves the nets' running statistics)."""
    jnet, tnet = resnet18
    x = _batch("NHWC", n=2, seed=3)
    if mode == "train":
        with mx.autograd.record():
            want = jnet(mx.nd.array(x)).asnumpy()
        with autograd.record():
            got = tnet(torch.from_numpy(x)).detach().numpy()
    else:
        want = jnet(mx.nd.array(x)).asnumpy()
        got = tnet(torch.from_numpy(x)).detach().numpy()
    assert np.abs(got - want).max() < LOGIT_TOL


def test_init_resnet_params_is_seeded_and_gluon_shaped():
    a, b = _small_port("NHWC"), _small_port("NHWC")
    pa = init_resnet_params(a, seed=11)
    pb = init_resnet_params(b, seed=11)
    assert list(pa) == list(collect_params(a))
    for (name, va), (nb, vb) in zip(pa.items(), pb.items()):
        assert name[len(a.prefix):] == nb[len(b.prefix):]
        assert np.array_equal(va, vb), name
    conv0 = pa[a.prefix + "conv0_weight"]
    assert conv0.shape == (16, 3, 7, 7)
    assert np.abs(conv0).max() <= 0.07
    assert (pa[a.prefix + "batchnorm0_running_var"] == 1).all()
    assert (pa[a.prefix + "stage1_conv0_bias"] == 0).all()
    assert conv0.std() > 0.03
    assert torch.equal(a.features[0].weight, torch.from_numpy(conv0))
