"""Parity of the port's Gluon layers (mxnet_tpu_torch/gluon/nn/) with the
JAX package's, on the CPU, and of the Block machinery around them.

Each layer is built on both sides from the same arguments, the JAX one
initialised from a seed and run once (its deferred shapes resolve), its
weights carried into the port layer by their block paths
(`convert.gluon_params_from_jax` of the JAX block). The same numpy input
and head gradient then go through both under `record()`: outputs, input
gradients and weight gradients agree within 1e-5 in fp32 (1e-4 where a
convolution or a normalisation sums more terms in another order). Both
layouts are run where the JAX class takes both.

Then the Block machinery: deferred shape inference (a Trainer made
before the first forward picks the new tensors up), `Constant`,
`ParameterDict.get`/`get_constant`, forward hooks and pre-hooks,
`apply`, `summary`, a user `hybrid_forward` block nested in a
HybridSequential against the same block in JAX, `Lambda`/`HybridLambda`,
Dropout's modes, and `save_parameters` files read across the two
packages in both directions."""
import numpy as np
import jax
from jax._src import compilation_cache
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError, autograd, gluon, nd
from mxnet_tpu_torch.convert import gluon_params_from_jax

TOL = 1e-5
SUM_TOL = 1e-4          # convolutions and normalisations


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


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale) \
        .astype(np.float32)


# (name, constructor on a gluon package, input shape, tolerance)
CASES = [
    ("dense_deferred", lambda g: g.nn.Dense(5, activation="tanh"),
     (4, 3, 2), TOL),
    ("dense_no_flatten", lambda g: g.nn.Dense(5, flatten=False,
                                              use_bias=False), (2, 3, 4), TOL),
    ("batchnorm_nhwc", lambda g: g.nn.BatchNorm(axis=3), (2, 3, 3, 4),
     SUM_TOL),
    ("embedding", lambda g: g.nn.Embedding(10, 4), "indices", TOL),
    ("instancenorm", lambda g: g.nn.InstanceNorm(scale=True),
     (2, 3, 5, 4), SUM_TOL),
    ("instancenorm_axis2", lambda g: g.nn.InstanceNorm(axis=2),
     (2, 5, 3, 4), SUM_TOL),
    ("layernorm", lambda g: g.nn.LayerNorm(), (4, 6), SUM_TOL),
    ("layernorm_axis1", lambda g: g.nn.LayerNorm(axis=1), (2, 6, 3),
     SUM_TOL),
    ("leakyrelu", lambda g: g.nn.LeakyReLU(0.1), (3, 5), TOL),
    ("prelu", lambda g: g.nn.PReLU(), (3, 5), TOL),
    ("elu", lambda g: g.nn.ELU(0.7), (3, 5), TOL),
    ("selu", lambda g: g.nn.SELU(), (3, 5), TOL),
    ("swish", lambda g: g.nn.Swish(1.5), (3, 5), TOL),
    ("gelu", lambda g: g.nn.GELU(), (3, 5), TOL),
    ("conv1d", lambda g: g.nn.Conv1D(4, 3, strides=2, padding=1,
                                     activation="relu"), (2, 3, 9), SUM_TOL),
    ("conv2d_nhwc_groups", lambda g: g.nn.Conv2D(
        4, 3, padding=1, groups=2, layout="NHWC"), (2, 5, 5, 4), SUM_TOL),
    ("conv3d", lambda g: g.nn.Conv3D(3, 2, dilation=1), (1, 2, 4, 4, 4),
     SUM_TOL),
    ("conv3d_ndhwc", lambda g: g.nn.Conv3D(3, 2, strides=2,
                                           layout="NDHWC"), (1, 4, 4, 4, 2),
     SUM_TOL),
    ("conv1d_transpose", lambda g: g.nn.Conv1DTranspose(
        3, 3, strides=2, padding=1, output_padding=1), (2, 2, 5), SUM_TOL),
    ("conv2d_transpose", lambda g: g.nn.Conv2DTranspose(
        3, 3, strides=2), (1, 2, 4, 4), SUM_TOL),
    ("conv3d_transpose", lambda g: g.nn.Conv3DTranspose(2, 2),
     (1, 2, 3, 3, 3), SUM_TOL),
    ("maxpool1d", lambda g: g.nn.MaxPool1D(3, 2, ceil_mode=True),
     (2, 3, 8), TOL),
    ("maxpool2d_ceil", lambda g: g.nn.MaxPool2D(3, 2, ceil_mode=True),
     (1, 2, 6, 6), TOL),
    ("maxpool3d_ndhwc", lambda g: g.nn.MaxPool3D(2, layout="NDHWC"),
     (1, 4, 4, 4, 2), TOL),
    ("avgpool1d", lambda g: g.nn.AvgPool1D(3, 1, 1,
                                           count_include_pad=False),
     (2, 3, 7), TOL),
    ("avgpool2d_nhwc", lambda g: g.nn.AvgPool2D(2, layout="NHWC"),
     (1, 4, 4, 3), TOL),
    ("avgpool3d", lambda g: g.nn.AvgPool3D(2, ceil_mode=True),
     (1, 2, 5, 5, 5), TOL),
    ("globalmaxpool1d", lambda g: g.nn.GlobalMaxPool1D(), (2, 3, 7), TOL),
    ("globalmaxpool2d_nhwc", lambda g: g.nn.GlobalMaxPool2D(layout="NHWC"),
     (2, 4, 4, 3), TOL),
    ("globalmaxpool3d", lambda g: g.nn.GlobalMaxPool3D(), (1, 2, 3, 3, 3),
     TOL),
    ("globalavgpool1d", lambda g: g.nn.GlobalAvgPool1D(), (2, 3, 7), TOL),
    ("globalavgpool3d_ndhwc", lambda g: g.nn.GlobalAvgPool3D(
        layout="NDHWC"), (1, 3, 3, 3, 2), TOL),
    ("reflectionpad2d", lambda g: g.nn.ReflectionPad2D(2), (1, 2, 5, 5),
     TOL),
    ("sequential", lambda g: _stack(g, g.nn.Sequential), (3, 4), TOL),
    ("hybridsequential_fusion", lambda g: _conv_bn(g), (2, 4, 4, 3),
     SUM_TOL),
]


def _stack(g, cls):
    net = cls()
    with net.name_scope():
        net.add(g.nn.Dense(6, activation="relu"), g.nn.Dropout(0.5),
                g.nn.Dense(3))
    return net


def _conv_bn(g):
    """A 1x1 NHWC convolution and its BatchNorm: the conv1x1 + BN
    statistics path in training mode."""
    net = g.nn.HybridSequential()
    with net.name_scope():
        net.add(g.nn.Conv2D(5, 1, layout="NHWC"), g.nn.BatchNorm(axis=3),
                g.nn.Activation("relu"))
    return net


def _input(shape, seed):
    if shape == "indices":
        return np.random.RandomState(seed).randint(0, 10, (3, 4)) \
            .astype(np.float32)
    return _rand(*shape, seed=seed)


def _pair(make, shape, seed=0):
    """A JAX layer initialised from a seed and run once, and the port
    layer given its weights by block path."""
    mx.random.seed(seed)
    jl = make(jgluon)
    jl.initialize(mx.init.Uniform(0.5))
    x = _input(shape, seed)
    jl(mx.nd.array(x))
    tl = make(gluon)
    nhwc = any(isinstance(m, gluon.nn.Conv2D) and m._layout == "NHWC"
               for m in tl.modules())
    if jl.collect_params():
        tl.load_parameters(gluon_params_from_jax(
            jl, "cpu", "NHWC" if nhwc else "NCHW"))
    return jl, tl, x


def _grads(net, port):
    out = {}
    if port:
        for k, p in net._collect_params_with_prefix().items():
            if p.grad_req != "null":
                g = p.grad()
                if p._file_perm:
                    g = g.permute(*p._file_perm)
                out[k] = g.numpy()
        return out
    return {k: p.grad().asnumpy()
            for k, p in net._collect_params_with_prefix().items()
            if p.grad_req != "null"}


@pytest.mark.parametrize("name,make,shape,tol", CASES,
                         ids=[c[0] for c in CASES])
def test_layer_forward_and_gradients_match_jax(name, make, shape, tol):
    jl, tl, x = _pair(make, shape)
    differentiable = shape != "indices"
    jx, tx = mx.nd.array(x), nd.array(x)
    if differentiable:
        jx.attach_grad()
        tx.attach_grad()
    with mx.autograd.record():
        jy = jl(jx)
    with autograd.record():
        ty = tl(tx)
    assert isinstance(ty, nd.NDArray)
    want = jy.asnumpy()
    got = ty.asnumpy()
    assert got.shape == want.shape, name
    if name != "sequential":          # dropout draws differ
        assert np.abs(got - want).max() < tol, name
    seed = _rand(*want.shape, seed=1)
    jy.backward(mx.nd.array(seed))
    ty.backward(nd.array(seed))
    if name == "sequential":
        return
    if differentiable:
        assert np.abs(tx.grad.asnumpy() - jx.grad.asnumpy()).max() < tol
    jg, tg = _grads(jl, False), _grads(tl, True)
    assert jg.keys() == tg.keys()
    for k in jg:
        assert np.abs(tg[k] - jg[k]).max() < tol * max(
            1.0, np.abs(jg[k]).max()), (name, k)


def test_predict_mode_outputs_match_jax():
    """Outside record(): BatchNorm on its running statistics and Dropout
    as the identity, on both sides."""
    for make, shape in ((lambda g: g.nn.BatchNorm(), (2, 3, 4)),
                        (lambda g: _stack(g, g.nn.HybridSequential),
                         (3, 4))):
        jl, tl, x = _pair(make, shape, seed=2)
        want = jl(mx.nd.array(x)).asnumpy()
        got = tl(torch.from_numpy(x)).numpy()
        assert np.abs(got - want).max() < SUM_TOL


def test_dropout_drops_in_training_only():
    tmx.random.seed(0)
    drop = gluon.nn.Dropout(0.25)
    x = torch.ones(200, 100)
    assert torch.equal(drop(x), x)
    with autograd.record():
        y = drop(x)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.02
    assert torch.allclose(y[y != 0], torch.full_like(y[y != 0], 1 / 0.75))
    with autograd.record():
        shared = gluon.nn.Dropout(0.5, axes=(1,))(x)
    assert all(len(set(row.tolist())) == 1 for row in shared)


class _UserBlock:
    """The same user block source for both packages: a parameter made by
    params.get, a child layer, and a hybrid_forward on F."""

    @staticmethod
    def make(g):
        class Scaled(g.HybridBlock):
            def __init__(self, **kwargs):
                super().__init__(**kwargs)
                with self.name_scope():
                    self.scale = self.params.get("weight", shape=(1, 4))
                    self.dense = g.nn.Dense(4, in_units=4)

            def hybrid_forward(self, F, x, scale):
                return F.relu(self.dense(x)) * F.broadcast_like(scale, x)

        net = g.nn.HybridSequential()
        with net.name_scope():
            net.add(g.nn.Dense(4, in_units=3), Scaled(),
                    g.nn.Dense(2, in_units=4))
        return net


def test_user_hybrid_forward_block_nested_in_hybrid_sequential():
    jl, tl, x = _pair(_UserBlock.make, (5, 3), seed=3)
    assert [k[len(tl.prefix):] for k in tl.collect_params()] == \
        [k[len(jl.prefix):] for k in jl.collect_params()]
    jx, tx = mx.nd.array(x), nd.array(x)
    jx.attach_grad()
    tx.attach_grad()
    with mx.autograd.record():
        jy = jl(jx)
    with autograd.record():
        ty = tl(tx)
    jy.backward()
    ty.backward()
    assert np.abs(ty.asnumpy() - jy.asnumpy()).max() < TOL
    assert np.abs(tx.grad.asnumpy() - jx.grad.asnumpy()).max() < TOL
    jg, tg = _grads(jl, False), _grads(tl, True)
    assert sorted(jg) == sorted(tg) and "1.scale" in tg
    for k in jg:
        assert np.abs(tg[k] - jg[k]).max() < TOL, k
    # tensors in, tensors out; the user block saw NDArrays
    out = tl(torch.from_numpy(x))
    assert type(out) is torch.Tensor


def test_deferred_init_and_a_trainer_made_before_the_first_forward():
    net = gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(gluon.nn.Conv2D(4, 3, layout="NHWC"),
                gluon.nn.BatchNorm(axis=3), gluon.nn.Dense(2))
    net.initialize(tmx.init.Xavier())
    params = net.collect_params()
    conv_w = params[net.prefix + "conv0_weight"]
    assert conv_w.shape == (4, 0, 3, 3)
    with pytest.raises(gluon.parameter.DeferredInitializationError):
        conv_w.data()
    trainer = gluon.Trainer(params, "sgd", {"learning_rate": 0.1,
                                            "momentum": 0.9})
    x = torch.from_numpy(_rand(2, 5, 5, 2))
    for _ in range(2):
        with autograd.record():
            loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(x),
                                                        torch.zeros(2))
        loss.backward()
        before = conv_w.data().detach().clone()
        trainer.step(2)
        assert not torch.equal(conv_w.data(), before)
    assert conv_w.shape == (4, 2, 3, 3)
    assert conv_w._fan_shape == (4, 3, 3, 2)     # the JAX layout's
    assert params[net.prefix + "dense0_weight"].shape == (2, 36)
    # a parameter never initialized says so at the first forward
    fresh = gluon.nn.Dense(3)
    with pytest.raises(RuntimeError, match="initialize"):
        fresh(torch.ones(2, 4))


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_float64_conv_and_batch_norm_stay_float64(layout):
    """A float64 net's 1x1 convolution + BatchNorm (a fused pair in NHWC
    for float32 and bfloat16) computes its batch statistics in float64:
    output and input gradient equal a float64 reference within 1e-12."""
    axis = 3 if layout == "NHWC" else 1
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Conv2D(6, 1, layout=layout, in_channels=5),
            gluon.nn.BatchNorm(axis=axis, in_channels=6))
    net.initialize(tmx.init.Xavier())
    net.cast("float64")
    shape = (4, 3, 3, 5) if layout == "NHWC" else (4, 5, 3, 3)
    x = torch.from_numpy(_rand(*shape).astype(np.float64) * 3 + 2)
    head = torch.from_numpy(_rand(4, 3, 3, 6, seed=1).astype(np.float64))
    if layout == "NCHW":
        head = head.permute(0, 3, 1, 2)
    x.requires_grad_(True)
    with autograd.record():
        y = net(x)
    y.backward(head)
    w = net[0].weight.detach()          # (O, I, kh, kw) in both layouts
    xr = x.detach().clone().requires_grad_(True)
    xc = xr.permute(0, 3, 1, 2) if layout == "NHWC" else xr
    c = torch.nn.functional.conv2d(xc, w)
    var, mean = torch.var_mean(c, dim=(0, 2, 3), correction=0,
                               keepdim=True)
    ref = (c - mean) / torch.sqrt(var + 1e-5)
    ref = ref.permute(0, 2, 3, 1) if layout == "NHWC" else ref
    ref.backward(head)
    assert y.dtype == torch.float64
    assert (y - ref).abs().max().item() < 1e-12
    assert (x.grad - xr.grad).abs().max().item() < 1e-12


def test_constant_and_parameter_dict_get():
    class WithConst(gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.const = self.params.get_constant(
                    "const", [[1.0, 2.0], [3.0, 4.0]])
                self.weight = self.params.get("weight", shape=(2, 2),
                                              init=tmx.init.One())

        def hybrid_forward(self, F, x, const, weight):
            return F.dot(x, const) + F.dot(x, weight)

    blk = WithConst()
    blk.initialize()
    c = blk.collect_params()[blk.prefix + "const"]
    assert isinstance(c, gluon.Constant) and c.grad_req == "null"
    x = nd.array([[1.0, 0.0]])
    x.attach_grad()
    with autograd.record():
        y = blk(x)
    y.backward()
    assert y.asnumpy().tolist() == [[2.0, 3.0]]
    assert x.grad.asnumpy().tolist() == [[5.0, 9.0]]
    with pytest.raises(MXNetError, match="null"):
        c.grad()
    assert blk.params.get("weight") is blk.weight
    with pytest.raises(MXNetError, match="conflicts"):
        blk.params.get("weight", shape=(3, 2))
    assert blk.params.get_constant("const") is c
    with pytest.raises(KeyError):
        blk.params.get_constant("absent")


def test_forward_hooks_apply_and_summary(capsys):
    net = _stack(gluon, gluon.nn.HybridSequential)
    net.initialize()
    seen = []
    pre = net[0].register_forward_pre_hook(
        lambda b, args: seen.append(("pre", b.name, type(args[0]))))
    post = net[0].register_forward_hook(
        lambda b, args, out: seen.append(("post", b.name, tuple(out.shape))))
    net(nd.ones((2, 4)))
    assert seen == [("pre", net[0].name, nd.NDArray),
                    ("post", net[0].name, (2, 6))]
    pre.detach()
    post.detach()
    net(nd.ones((2, 4)))
    assert len(seen) == 2
    names = []
    assert net.apply(lambda b: names.append(b.name)) is net
    # children before their parent, as Gluon's apply goes
    assert names == [net[0].act.name, net[0].name, net[1].name, net[2].name,
                     net.name]
    net.summary(nd.ones((2, 4)))
    text = capsys.readouterr().out
    assert "(2, 6)" in text and "Parameters in total: %d" % (
        4 * 6 + 6 + 6 * 3 + 3) in text


def test_lambdas_run_on_ndarrays():
    lam = gluon.nn.Lambda("tanh")
    hl = gluon.nn.HybridLambda(lambda F, x: F.relu(x) * 2)
    x = torch.tensor([[-1.0, 0.5]])
    assert torch.allclose(lam(x), torch.tanh(x))
    assert torch.equal(hl(x), torch.tensor([[0.0, 1.0]]))
    seq = gluon.nn.Sequential()
    seq.add(lam, gluon.nn.Dense(2, in_units=2))
    seq.initialize()
    assert isinstance(seq(nd.array(x.numpy())), nd.NDArray)
    with pytest.raises(ValueError, match="hybridizable"):
        gluon.nn.HybridSequential().add(gluon.nn.Lambda("tanh"))


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_save_parameters_files_cross_load_both_ways(tmp_path, layout):
    def net_of(g):
        net = g.nn.HybridSequential()
        with net.name_scope():
            net.add(g.nn.Conv2D(3, 3, layout=layout),
                    g.nn.BatchNorm(axis=1 if layout == "NCHW" else 3),
                    g.nn.Dense(2))
        return net

    shape = (2, 3, 5, 5) if layout == "NCHW" else (2, 5, 5, 3)
    x = _rand(*shape, seed=4)
    mx.random.seed(4)
    jnet = net_of(jgluon)
    jnet.initialize(mx.init.Uniform(0.5))
    want = jnet(mx.nd.array(x)).asnumpy()
    jfile, tfile = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jnet.save_parameters(jfile)
    tnet = net_of(gluon)
    tnet.load_parameters(jfile)
    assert np.abs(tnet(torch.from_numpy(x)).numpy() - want).max() < SUM_TOL
    tnet.save_parameters(tfile)
    back = net_of(jgluon)
    back.load_parameters(tfile)
    assert np.abs(back(mx.nd.array(x)).asnumpy() - want).max() < SUM_TOL
    # the deprecated flat form, under the block's own prefix
    flat = str(tmp_path / "flat.params")
    with pytest.warns(UserWarning, match="deprecated"):
        tnet.save_params(flat)
    other = net_of(gluon)
    with pytest.warns(UserWarning, match="deprecated"):
        other.load_params(flat)
    assert np.abs(other(torch.from_numpy(x)).numpy() - want).max() < SUM_TOL
    with pytest.raises(MXNetError, match="missing"):
        gluon.nn.Dense(2, in_units=3).load_parameters(jfile)
