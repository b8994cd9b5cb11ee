"""Parity of the port's hybridize (trace to a Symbol, replay as a
CachedOp), `export` and `SymbolBlock` with the JAX package's, on the CPU.

Each net is built in both packages under fresh name managers (so names
agree), given the JAX net's parameters through a `.params` file, and
hybridized. Then, on the same seeded input:

- one forward under `autograd.record()` in training mode and a backward:
  outputs, parameter gradients and BatchNorm's moving statistics agree
  within 1e-5 (fp32; only summation order differs);
- the port's hybridized net agrees with the port's eager net within
  1e-5 (the conv1x1+BatchNorm rewrite included);
- `export` writes the JAX package's symbol JSON byte for byte, and the
  files of one package load into the other's `SymbolBlock.imports`
  (an export then imports in the port is bit-identical).
"""
import ast
import json
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu.gluon.contrib import nn as jcnn
from mxnet_tpu_torch.gluon.contrib import nn as tcnn

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_symbolic_parity import (  # noqa: E402,F401
    no_persistent_compile_cache, restore_shared_state)

pytestmark = pytest.mark.usefixtures("restore_shared_state")

TOL = 1e-5


def _stack(nn, cnn, layers):
    net = nn.HybridSequential()
    with net.name_scope():
        for make in layers:
            net.add(make(nn, cnn))
    return net


# (id, layers (each a function of (nn, contrib.nn)), input shape, int input)
LAYERS = [
    ("dense", [lambda nn, c: nn.Dense(5, activation="tanh"),
               lambda nn, c: nn.Dense(3, use_bias=False,
                                      flatten=False)], (2, 4), False),
    ("dropout_flatten", [lambda nn, c: nn.Dropout(0.0),
                         lambda nn, c: nn.Flatten()], (2, 3, 2), False),
    ("batchnorm", [lambda nn, c: nn.BatchNorm(momentum=0.8),
                   lambda nn, c: nn.BatchNorm(axis=-1, scale=False,
                                              center=False)],
     (4, 3, 5), False),
    ("instance_layer_norm", [lambda nn, c: nn.InstanceNorm(scale=True),
                             lambda nn, c: nn.LayerNorm(axis=1),
                             lambda nn, c: nn.LayerNorm()], (2, 3, 4), False),
    ("embedding", [lambda nn, c: nn.Embedding(10, 4)], (2, 5), True),
    ("activations", [lambda nn, c: nn.Activation("softrelu"),
                     lambda nn, c: nn.LeakyReLU(0.1),
                     lambda nn, c: nn.PReLU(),
                     lambda nn, c: nn.ELU(0.5), lambda nn, c: nn.SELU(),
                     lambda nn, c: nn.Swish(1.5), lambda nn, c: nn.GELU(),
                     lambda nn, c: nn.Activation("sigmoid")],
     (2, 6), False),
    ("conv1d_pool1d", [lambda nn, c: nn.Conv1D(4, 3, padding=1),
                       lambda nn, c: nn.MaxPool1D(2),
                       lambda nn, c: nn.AvgPool1D(2, count_include_pad=False,
                                                  padding=1),
                       lambda nn, c: nn.GlobalMaxPool1D(),
                       lambda nn, c: nn.Conv1DTranspose(2, 3)],
     (2, 3, 8), False),
    ("conv2d_nchw", [lambda nn, c: nn.Conv2D(4, 3, strides=2, padding=1,
                                             groups=1, activation="relu"),
                     lambda nn, c: nn.MaxPool2D(2, ceil_mode=True),
                     lambda nn, c: nn.Conv2DTranspose(3, 2, strides=2),
                     lambda nn, c: nn.AvgPool2D(2),
                     lambda nn, c: nn.GlobalAvgPool2D(),
                     lambda nn, c: nn.Flatten(),
                     lambda nn, c: nn.Dense(2)], (2, 3, 9, 9), False),
    # a bias that feeds a training BatchNorm has an exact gradient of 0,
    # which both packages give as rounding noise: the convolutions here
    # have none, as ResNet's before a BatchNorm
    ("conv2d_nhwc_bn", [lambda nn, c: nn.Conv2D(4, 3, padding=1,
                                                layout="NHWC",
                                                use_bias=False),
                        lambda nn, c: nn.BatchNorm(axis=3),
                        lambda nn, c: nn.Activation("relu"),
                        lambda nn, c: nn.Conv2D(6, 1, layout="NHWC",
                                                use_bias=False),
                        lambda nn, c: nn.BatchNorm(axis=3),
                        lambda nn, c: nn.MaxPool2D(2, layout="NHWC"),
                        lambda nn, c: nn.GlobalMaxPool2D(layout="NHWC")],
     (4, 6, 6, 3), False),
    ("conv3d_pool3d", [lambda nn, c: nn.Conv3D(3, 2),
                       lambda nn, c: nn.MaxPool3D(2, strides=1),
                       lambda nn, c: nn.AvgPool3D(1),
                       lambda nn, c: nn.GlobalAvgPool3D(),
                       lambda nn, c: nn.Conv3DTranspose(2, 1)],
     (2, 2, 4, 4, 4), False),
    ("pad_lambda_concurrent", [lambda nn, c: nn.ReflectionPad2D(1),
                               lambda nn, c: nn.HybridLambda("tanh"),
                               lambda nn, c: nn.HybridLambda(
                                   lambda F, x: F.relu(x) * 2),
                               lambda nn, c: _concurrent(nn, c)],
     (2, 2, 4, 4), False),
]


def _concurrent(nn, cnn):
    blk = cnn.HybridConcurrent(axis=1)
    with blk.name_scope():
        blk.add(nn.Conv2D(2, 1))
        blk.add(cnn.Identity())
        blk.add(nn.Activation("tanh"))
    return blk


def _input(shape, integer, seed=0):
    rng = np.random.RandomState(seed)
    if integer:
        return rng.randint(0, 10, size=shape).astype(np.float32)
    return rng.randn(*shape).astype(np.float32)


def _pair(build, x, path):
    """(jax net, port net), both initialized by one eager predict-mode
    forward, the port's parameters loaded from the JAX net's file."""
    with jmx.name.NameManager():
        j = build(jnn, jcnn)
    with tmx.name.NameManager():
        t = build(tnn, tcnn)
    jmx.random.seed(0)      # not wherever earlier tests left JAX's key
    j.initialize(jmx.init.Xavier())
    t.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    j(jmx.nd.array(x))
    with tmx.cpu():
        t(tmx.nd.array(x))
    if len(j.collect_params()):
        j.save_parameters(path)
        t.load_parameters(path, ctx=tmx.cpu())
    return j, t


def _train_step(net, mx, x, integer=False):
    """One recorded training forward, and a backward from a seeded head
    gradient; the output and, for a float input, the input's gradient."""
    with mx.cpu():
        xv = mx.nd.array(x)
        if not integer:
            xv.attach_grad()
        with mx.autograd.record():
            y = net(xv)
        head = np.random.RandomState(99).randn(*y.shape).astype(np.float32)
        y.backward(mx.nd.array(head))
    return y.asnumpy(), (None if integer else xv.grad.asnumpy())


def _same_step(a, b, tol=TOL):
    np.testing.assert_allclose(b[0], a[0], rtol=tol, atol=tol)
    if a[1] is not None:
        np.testing.assert_allclose(b[1], a[1], rtol=tol, atol=tol)


def _grads(net, port):
    out = {}
    for name, p in net.collect_params().items():
        if p.grad_req == "null":
            continue
        g = p.grad()
        g = g.detach().numpy() if port else g.asnumpy()
        if port and p._file_perm is not None:
            g = g.transpose(p._file_perm)
        out[name] = g
    return out


def _stats(net, port):
    return {name: (p._file_value().numpy() if port else p.data().asnumpy())
            for name, p in net.collect_params().items()
            if p.grad_req == "null"}


def _close_dicts(a, b, tol=TOL):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=tol, atol=tol,
                                   err_msg=k)


@pytest.mark.parametrize("layers,shape,integer",
                         [case[1:] for case in LAYERS],
                         ids=[case[0] for case in LAYERS])
def test_hybridized_layers_agree_with_jax_and_eager(layers, shape, integer,
                                                    tmp_path):
    build = lambda nn, cnn: _stack(nn, cnn, layers)  # noqa: E731
    x = _input(shape, integer)
    j, t = _pair(build, x, str(tmp_path / "p.params"))
    with tmx.name.NameManager():
        eager = build(tnn, tcnn)
    eager.initialize(ctx=tmx.cpu())
    with tmx.cpu():
        eager(tmx.nd.array(x))
    if len(j.collect_params()):
        eager.load_parameters(str(tmp_path / "p.params"), ctx=tmx.cpu())
    j.hybridize()
    t.hybridize()
    yj = _train_step(j, jmx, x, integer)
    yt = _train_step(t, tmx, x, integer)
    ye = _train_step(eager, tmx, x, integer)
    _same_step(yj, yt)
    _same_step(ye, yt)
    _close_dicts(_grads(j, False), _grads(t, True))
    _close_dicts(_grads(eager, True), _grads(t, True))
    _close_dicts(_stats(j, False), _stats(t, True))
    # predict mode through the cached graph
    with tmx.cpu():
        pt = t(tmx.nd.array(x)).asnumpy()
    pj = j(jmx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(pt, pj, rtol=TOL, atol=TOL)
    j.export(str(tmp_path / "j"))
    t.export(str(tmp_path / "t"))
    assert (tmp_path / "t-symbol.json").read_bytes() == \
        (tmp_path / "j-symbol.json").read_bytes()


class _UserBlock:
    """A user's HybridBlock of either package: its own parameter of
    unknown dims (its shape from the graph's inference), children, F ops
    in between."""

    @staticmethod
    def make(gluon, nn):
        class Scale(gluon.HybridBlock):
            def __init__(self, **kw):
                super().__init__(**kw)
                with self.name_scope():
                    self.scale = self.params.get(
                        "scale", shape=(3, 0), init="ones",
                        allow_deferred_init=True)
                    self.dense = nn.Dense(3, flatten=False)
                    self.bn = nn.BatchNorm(axis=-1)

            def hybrid_forward(self, F, x, scale):
                h = F.FullyConnected(x, scale, no_bias=True, num_hidden=3,
                                     flatten=False)
                h = self.bn(self.dense(h) + h)
                return F.relu(h) + F.broadcast_mul(h, F.sigmoid(h))
        return Scale()


def test_user_block_deferred_parameter_takes_its_shape_from_the_graph(
        tmp_path):
    x = _input((2, 4, 5), False, 3)
    with jmx.name.NameManager():
        j = _UserBlock.make(jmx.gluon, jnn)
    with tmx.name.NameManager():
        t = _UserBlock.make(tmx.gluon, tnn)
    assert t.scale.shape == (3, 0)
    jmx.random.seed(0)
    j.initialize()
    t.initialize(ctx=tmx.cpu())
    j(jmx.nd.array(x))
    with tmx.cpu():
        t(tmx.nd.array(x))            # eager: the shape comes from the graph
    assert t.scale.shape == j.scale.shape == (3, 5)
    j.save_parameters(str(tmp_path / "u.params"))
    t.load_parameters(str(tmp_path / "u.params"), ctx=tmx.cpu())
    ye = _train_step(t, tmx, x)
    j.hybridize()
    t.hybridize()
    yj = _train_step(j, jmx, x)
    yt = _train_step(t, tmx, x)
    _same_step(yj, yt)
    _same_step(ye, yt)
    _close_dicts(_grads(j, False), _grads(t, True))
    j.export(str(tmp_path / "j"))
    t.export(str(tmp_path / "t"))
    assert (tmp_path / "t-symbol.json").read_bytes() == \
        (tmp_path / "j-symbol.json").read_bytes()


def test_hybridized_deferred_net_initializes_at_its_first_call():
    def build(nn, cnn):
        net = nn.HybridSequential()
        with net.name_scope():
            net.add(nn.Conv2D(3, 1, layout="NHWC"), nn.BatchNorm(axis=3),
                    nn.Dense(2))
        return net
    with tmx.name.NameManager():
        t = build(tnn, tcnn)
    t.initialize(ctx=tmx.cpu())
    t.hybridize()
    x = _input((2, 3, 3, 5), False)
    with tmx.cpu():
        y = t(tmx.nd.array(x))
    assert y.shape == (2, 2)
    w = t.collect_params()["hybridsequential0_conv0_weight"]
    assert w.shape == (3, 5, 1, 1)         # the port's layout
    assert w._file_value().shape == (3, 1, 1, 5)
    with jmx.name.NameManager():
        j = build(jnn, jcnn)
    j.initialize()
    j.hybridize()
    j(jmx.nd.array(x))
    assert t._cached_graph[1].tojson() == j._cached_graph[1].tojson()


def _resnet(mx_gluon, layout):
    from_zoo = mx_gluon.model_zoo.vision
    return from_zoo.ResNetV1(from_zoo.BottleneckV1, [1, 1], [8, 16, 32],
                             classes=5, thumbnail=True, layout=layout)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_resnet_exports_cross_both_packages(layout, tmp_path):
    x = _input((2, 8, 8, 3) if layout == "NHWC" else (2, 3, 8, 8), False, 5)
    with jmx.name.NameManager():
        j = _resnet(jmx.gluon, layout)
    with tmx.name.NameManager():
        t = _resnet(tmx.gluon, layout)
    jmx.random.seed(0)
    j.initialize(jmx.init.Xavier())
    j(jmx.nd.array(x))
    j.save_parameters(str(tmp_path / "r.params"))
    t.load_parameters(str(tmp_path / "r.params"), ctx=tmx.cpu())
    j.hybridize()
    t.hybridize()
    yj = _train_step(j, jmx, x)
    yt = _train_step(t, tmx, x)
    _same_step(yj, yt, 1e-4)
    _close_dicts(_grads(j, False), _grads(t, True), 1e-4)
    j.export(str(tmp_path / "j"), epoch=3)
    t.export(str(tmp_path / "t"), epoch=3)
    jj = json.loads((tmp_path / "j-symbol.json").read_text())
    tj = json.loads((tmp_path / "t-symbol.json").read_text())
    # the port's ResNet V1 declares every parameter's full shape (its
    # layers make their tensors on the card at construction) where the
    # JAX package's declares the stem's input channels and BatchNorm's
    # channels unknown (0): the variables' __shape__ attributes differ
    # there and agree on every known dim; the rest is byte-identical
    for jn, tn in zip(jj["nodes"], tj["nodes"]):
        js, ts = (n.get("attrs", {}).pop("__shape__", None)
                  for n in (jn, tn))
        if js != ts:
            js, ts = ast.literal_eval(js), ast.literal_eval(ts)
            assert len(js) == len(ts) and all(
                a in (0, b) for a, b in zip(js, ts)), (jn["name"], js, ts)
    assert json.dumps(tj) == json.dumps(jj)
    # JAX's files into the port, the port's into JAX: predictions agree
    ti = tmx.gluon.SymbolBlock.imports(str(tmp_path / "j-symbol.json"),
                                       "data", str(tmp_path / "j-0003.params"),
                                       ctx=tmx.cpu())
    ji = jmx.gluon.SymbolBlock.imports(str(tmp_path / "t-symbol.json"),
                                       "data", str(tmp_path / "t-0003.params"))
    with tmx.cpu():
        pti = ti(tmx.nd.array(x)).asnumpy()
        pt = t(tmx.nd.array(x)).asnumpy()
    pji = ji(jmx.nd.array(x)).asnumpy()
    pj = j(jmx.nd.array(x)).asnumpy()
    np.testing.assert_allclose(pti, pj, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(pji, pt, rtol=TOL, atol=TOL)
    # the port's export, imported by the port: bit-identical
    tt = tmx.gluon.SymbolBlock.imports(str(tmp_path / "t-symbol.json"),
                                       ["data"],
                                       str(tmp_path / "t-0003.params"),
                                       ctx=tmx.cpu())
    with tmx.cpu():
        assert np.array_equal(tt(tmx.nd.array(x)).asnumpy(), pt)


def test_symbol_block_trains_and_writes_back_aux(tmp_path):
    with jmx.name.NameManager():
        data = jmx.sym.var("data")
        net = jmx.sym.BatchNorm(jmx.sym.FullyConnected(data, num_hidden=4,
                                                       name="fc"),
                                name="bn", momentum=0.5)
    net.save(str(tmp_path / "g-symbol.json"))
    rng = np.random.RandomState(2)
    vals = {"fc_weight": rng.randn(4, 3), "fc_bias": rng.randn(4),
            "bn_gamma": rng.rand(4) + 0.5, "bn_beta": rng.randn(4),
            "bn_moving_mean": np.zeros(4), "bn_moving_var": np.ones(4)}
    jmx.nd.save(str(tmp_path / "g-0000.params"),
                {("aux:" if "moving" in k else "arg:") + k:
                 jmx.nd.array(v.astype(np.float32)) for k, v in vals.items()})
    x = rng.randn(6, 3).astype(np.float32)
    outs = []
    for mx in (jmx, tmx):
        with mx.cpu():
            blk = mx.gluon.SymbolBlock.imports(
                str(tmp_path / "g-symbol.json"), "data",
                str(tmp_path / "g-0000.params"), ctx=mx.cpu())
            y = _train_step(blk, mx, x)[0]
            p = blk.collect_params()
            mm = p["bn_moving_mean"].data()
            grad = p["fc_weight"].grad()
            outs.append((y, mm.asnumpy() if hasattr(mm, "asnumpy")
                         else mm.numpy(),
                         grad.asnumpy() if hasattr(grad, "asnumpy")
                         else grad.numpy()))
    for a, b in zip(*outs):
        np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL)
    assert np.abs(outs[1][1]).max() > 0      # the moving mean moved


def test_hybridize_off_and_cast_rebuild_the_graph():
    with tmx.name.NameManager():
        t = _stack(tnn, tcnn, [lambda nn, c: nn.Dense(3, in_units=4)])
    t.initialize(ctx=tmx.cpu())
    x = torch.tensor(_input((2, 4), False))
    t.hybridize()
    y1 = t(x)
    assert t._cached_op is not None
    t.hybridize(False)
    assert t._cached_op is None
    torch.testing.assert_close(t(x), y1)
    t.hybridize()
    t.cast("float64")
    y3 = t(x.double())
    assert y3.dtype == torch.float64
    torch.testing.assert_close(y3.float(), y1, rtol=1e-5, atol=1e-5)
