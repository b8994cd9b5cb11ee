"""Parity of the PyTorch port's `autograd` with the JAX package's, on the
CPU: the record/pause/mode scopes and their flags, `backward` on a
per-sample loss, MXNet's grad_req semantics ("write" overwrites, "add"
accumulates, "null" has no gradient), and the mode that a port net's
layers follow: BatchNorm uses batch statistics, and moves its running
statistics, only under `autograd.record()`, as in the JAX package.

Tolerances: fp32 on both sides, sums in other orders: gradients 1e-5,
logits 1e-4, running statistics 1e-5.
"""
import gc

import numpy as np
import jax
from jax._src import compilation_cache
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet
from mxnet_tpu_torch import MXNetError, autograd, gluon, nd
from mxnet_tpu_torch import cpu as mx_torch_cpu
from mxnet_tpu_torch.convert import gluon_params_from_jax
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.gluon.nn import conv_layers
from mxnet_tpu_torch.ndarray import NDArray

GRAD_TOL = 1e-5
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


# each case: the scopes entered, outermost first, as (function, kwargs)
SCOPES = {
    "record": [("record", {})],
    "record_predict": [("record", {"train_mode": False})],
    "pause_in_record": [("record", {}), ("pause", {})],
    "pause_train_in_record": [("record", {}), ("pause", {"train_mode": True})],
    "predict_in_record": [("record", {}), ("predict_mode", {})],
    "train_mode_alone": [("train_mode", {})],
}


def _flags(pkg, scopes):
    """(recording, training) inside every scope level, then after all."""
    seen = []

    def enter(level):
        if level == len(scopes):
            return
        name, kw = scopes[level]
        with getattr(pkg, name)(**kw):
            seen.append((pkg.is_recording(), pkg.is_training()))
            enter(level + 1)
        seen.append((pkg.is_recording(), pkg.is_training()))

    enter(0)
    return seen


@pytest.mark.parametrize("case", sorted(SCOPES))
def test_scope_flags_match_jax(case):
    scopes = SCOPES[case]
    assert _flags(autograd, scopes) == _flags(mx.autograd, scopes)


def test_record_turns_torch_grad_on_and_pause_off():
    with torch.no_grad():
        with autograd.record():
            assert torch.is_grad_enabled()
            with autograd.pause():
                assert not torch.is_grad_enabled()
            assert torch.is_grad_enabled()
        assert not torch.is_grad_enabled()
    with autograd.train_mode():     # the mode alone leaves grad mode be
        assert torch.is_grad_enabled()


def test_set_recording_and_set_training_return_the_previous_flag():
    try:
        for pkg in (autograd, mx.autograd):
            assert pkg.set_training(True) is False
            assert pkg.set_training(False) is True
            assert pkg.set_recording(True) is False
            assert pkg.is_recording()
            assert pkg.set_recording(False) is True
        # torch's grad mode follows the port's recording flag
        assert torch.is_grad_enabled() is False
    finally:
        for pkg in (autograd, mx.autograd):
            pkg.set_training(False)
            pkg.set_recording(False)
        torch.set_grad_enabled(True)


def _dense_pair(seed=0, units=3, in_units=4):
    """A JAX Dense and a port Dense with the same weights."""
    rng = np.random.RandomState(seed)
    w = rng.randn(units, in_units).astype(np.float32)
    b = rng.randn(units).astype(np.float32)
    jd = mx.gluon.nn.Dense(units, in_units=in_units)
    jd.initialize()
    jd.weight.set_data(mx.nd.array(w))
    jd.bias.set_data(mx.nd.array(b))
    td = gluon.nn.Dense(units, in_units=in_units, device="cpu")
    td.load_parameters({"weight": torch.from_numpy(w),
                        "bias": torch.from_numpy(b)})
    return jd, td


def _loss_pair():
    return (mx.gluon.loss.SoftmaxCrossEntropyLoss(),
            gluon.loss.SoftmaxCrossEntropyLoss())


def _backward(jd, td, x, y):
    """One recorded per-sample loss and its backward on each side."""
    jl, tl = _loss_pair()
    with mx.autograd.record():
        jloss = jl(jd(mx.nd.array(x)), mx.nd.array(y))
    jloss.backward()
    with autograd.record():
        tloss = tl(td(torch.from_numpy(x)), torch.from_numpy(y))
    tloss.backward()
    return jloss, tloss


def test_vector_loss_backward_seeds_ones_as_jax_does():
    jd, td = _dense_pair()
    rng = np.random.RandomState(1)
    x = rng.randn(5, 4).astype(np.float32)
    y = np.array([0, 1, 2, 1, 0], np.float32)
    jloss, tloss = _backward(jd, td, x, y)
    assert isinstance(tloss, NDArray) and tuple(tloss.shape) == (5,)
    assert np.abs(tloss.asnumpy() - jloss.asnumpy()).max() < GRAD_TOL
    tp = td.collect_params()
    for name in ("weight", "bias"):
        want = jd.collect_params()[jd.prefix + name].grad().asnumpy()
        got = tp[td.prefix + name]
        assert np.abs(got.grad().numpy() - want).max() < GRAD_TOL
        assert got._fresh_grad
        assert type(got.grad()) is torch.Tensor
    # the same gradients as torch's backward of the summed loss
    w = td.weight.detach().clone().requires_grad_(True)
    torch.nn.functional.cross_entropy(
        torch.from_numpy(x) @ w.t() + td.bias.detach(),
        torch.from_numpy(y).long(), reduction="sum").backward()
    assert torch.allclose(w.grad, tp[td.prefix + "weight"].grad(),
                          atol=GRAD_TOL)


@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_grad_req_over_two_backwards_matches_jax(grad_req):
    """'write' keeps only the second backward's gradient, 'add' the sum."""
    jd, td = _dense_pair(seed=2)
    for p in jd.collect_params().values():
        p.grad_req = grad_req
    td.collect_params().setattr("grad_req", grad_req)
    rng = np.random.RandomState(3)
    grads = []
    for _ in range(2):
        x = rng.randn(4, 4).astype(np.float32)
        y = rng.randint(0, 3, 4).astype(np.float32)
        _backward(jd, td, x, y)
        grads.append(td.collect_params()[td.prefix + "weight"].grad()
                     .clone())
    for name in ("weight", "bias"):
        want = jd.collect_params()[jd.prefix + name].grad().asnumpy()
        got = td.collect_params()[td.prefix + name].grad().numpy()
        assert np.abs(got - want).max() < GRAD_TOL, name
    assert not torch.allclose(grads[0], grads[1])


def test_null_grad_req_has_no_gradient_and_backward_leaves_it():
    jd, td = _dense_pair()
    tp = td.collect_params()
    tp[td.prefix + "bias"].grad_req = "null"
    assert not td.bias.requires_grad
    with pytest.raises(MXNetError, match="null"):
        tp[td.prefix + "bias"].grad()
    x = np.ones((2, 4), np.float32)
    with autograd.record():
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(
            td(torch.from_numpy(x)), torch.zeros(2))
    loss.backward()
    assert tp[td.prefix + "weight"]._fresh_grad and \
        not tp[td.prefix + "bias"]._fresh_grad
    # buffers never take a gradient
    bn = gluon.nn.BatchNorm(in_channels=3, device="cpu")
    mean = bn.prefix + "running_mean"
    assert bn.collect_params()[mean].grad_req == "null"
    bn.collect_params()[mean].grad_req = "write"
    assert bn.collect_params()[mean].grad_req == "null"


def test_backward_of_an_unrecorded_output_raises():
    """A loss computed outside record() is not in the graph: its backward
    raises MXNetError with the JAX package's words, for the per-sample
    loss and for its mean (no torch.no_grad() anywhere)."""
    jd, td = _dense_pair()
    x = np.ones((2, 4), np.float32)
    y = np.zeros(2, np.float32)
    for head in ("vector", "mean"):
        jl, tl = _loss_pair()
        jloss = jl(jd(mx.nd.array(x)), mx.nd.array(y))
        tloss = tl(td(torch.from_numpy(x)), torch.from_numpy(y))
        if head == "mean":
            jloss, tloss = jloss.mean(), tloss.mean()
        with pytest.raises(mx.base.MXNetError) as jerr:
            jloss.backward()
        with pytest.raises(MXNetError) as terr:
            autograd.backward(tloss)
        assert str(terr.value) == str(jerr.value), head
        assert "not in the recorded graph" in str(terr.value)
        assert not td.collect_params()[td.prefix + "weight"]._fresh_grad


def test_predict_mode_forward_builds_no_graph():
    """net(x) outside record() gives an output that requires no grad, for
    tensor and NDArray inputs, whatever torch's own grad mode says."""
    _, td = _dense_pair()
    assert torch.is_grad_enabled()
    out = td(torch.ones(2, 4))
    assert type(out) is torch.Tensor and not out.requires_grad
    with mx_torch_cpu():
        nd_out = td(nd.ones((2, 4)))
    assert isinstance(nd_out, NDArray) and not nd_out._data.requires_grad
    with autograd.record():
        assert td(torch.ones(2, 4)).requires_grad


def test_head_gradient_seeds_the_backward_and_zero_grad_is_not_fresh():
    _, td = _dense_pair()
    x = torch.ones(2, 4)
    seed = torch.tensor([[1.0, 0.0, 0.0], [0.0, 0.0, 2.0]])
    with autograd.record():
        out = td(x)
    autograd.backward(out, seed)
    tp = td.collect_params()
    bias, weight = tp[td.prefix + "bias"], tp[td.prefix + "weight"]
    assert torch.equal(bias.grad(), torch.tensor([1.0, 0.0, 2.0]))
    assert torch.equal(weight.grad(), seed.t() @ x)
    tp.zero_grad()
    bias._fresh_grad = False
    assert not bias.grad().any() and not bias._fresh_grad


def test_ndarray_head_reads_back_as_numpy_and_scalar():
    with autograd.record():
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(
            torch.zeros(3, 2, dtype=torch.bfloat16), torch.zeros(3))
    assert isinstance(loss, NDArray) and loss.asnumpy().dtype == np.float32
    assert abs(loss.mean().asscalar() - np.log(2)) < 1e-2
    with pytest.raises(MXNetError, match="one element"):
        loss.asscalar()
    plain = gluon.loss.SoftmaxCrossEntropyLoss()(torch.zeros(3, 2),
                                                 torch.zeros(3))
    assert type(plain) is torch.Tensor


@pytest.mark.parametrize("holder", ["nothing", "parameter_dict", "trainer"])
def test_a_dropped_net_leaves_the_live_set_at_once(holder):
    """A parameter holds its block weakly, so a dropped net is freed
    without the cycle collector, and `backward` no longer differentiates
    against its parameters. A ParameterDict or a Trainer keeps the blocks
    of the parameters it holds; a parameter whose block is gone raises."""
    was = gc.isenabled()
    gc.disable()
    try:
        before = len(autograd._live)
        net = gluon.nn.Dense(3, in_units=4, device="cpu")
        kept = net.collect_params()
        lone = kept[net.prefix + "weight"]
        if holder == "trainer":
            kept = gluon.Trainer(kept, "sgd")
        elif holder == "nothing":
            kept = None
        assert len(autograd._live) == before + 2
        del net
        if holder == "nothing":
            assert len(autograd._live) == before + 1    # `lone` alone
            with pytest.raises(MXNetError, match="no longer exists"):
                lone.data()
            del lone
            assert len(autograd._live) == before
        else:
            assert lone.shape == (3, 4)
            assert len(autograd._live) == before + 2
            del kept, lone
            assert len(autograd._live) == before
    finally:
        if was:
            gc.enable()


@pytest.fixture(scope="module")
def nets():
    """A small NHWC JAX ResNet with Xavier weights and random running
    statistics, and a fresh port net given its weights."""
    np.random.seed(7)
    mx.random.seed(7)
    jnet = jresnet.ResNetV1(jresnet.BottleneckV1, [1, 1], [16, 32, 64],
                            classes=10, layout="NHWC")
    jnet.initialize(mx.init.Xavier(magnitude=2))
    jnet.infer_shape(mx.nd.zeros((1, 32, 32, 3)))
    rng = np.random.RandomState(7)
    for name, p in jnet.collect_params().items():
        p._finish_deferred_init()
        if name.endswith("_running_mean"):
            p.set_data(mx.nd.array(rng.randn(p.shape[0]).astype(
                np.float32) * 0.1))
        elif name.endswith("_running_var"):
            p.set_data(mx.nd.array(rng.rand(p.shape[0]).astype(
                np.float32) + 0.5))
    tnet = vision.ResNetV1(vision.BottleneckV1, [1, 1], [16, 32, 64],
                           classes=10, layout="NHWC", device="cpu")
    return jnet, tnet


def _running(net, port):
    if port:
        return {k[len(net.prefix):]: v.data().clone() for k, v in
                net.collect_params().items() if "_running_" in k}
    return {k[len(net.prefix):]: np.asarray(v.data()._data)
            for k, v in net.collect_params().items() if "_running_" in k}


def test_fresh_net_predicts_outside_record_as_jax_does(nets, monkeypatch):
    """The repair: a fresh port net's net(x) outside record() uses the
    running statistics, as the JAX net does, runs no 1x1 conv + BN
    fusion, and leaves the running statistics of both bit-identical."""
    jnet, _ = nets
    tnet = vision.ResNetV1(vision.BottleneckV1, [1, 1], [16, 32, 64],
                           classes=10, layout="NHWC", device="cpu")
    assert tnet.training        # torch's own flag plays no part
    tnet.load_parameters(gluon_params_from_jax(jnet, "cpu", "NHWC"))
    fused = []
    real = conv_layers.conv1x1_bn_nhwc
    monkeypatch.setattr(conv_layers, "conv1x1_bn_nhwc",
                        lambda *a: fused.append(1) or real(*a))
    x = np.random.RandomState(8).randn(4, 32, 32, 3).astype(np.float32)
    jbefore, tbefore = _running(jnet, False), _running(tnet, True)
    want = jnet(mx.nd.array(x)).asnumpy()
    got = tnet(torch.from_numpy(x)).detach().numpy()
    assert np.abs(got - want).max() < LOGIT_TOL
    assert not fused
    for k, v in _running(jnet, False).items():
        assert np.array_equal(v, jbefore[k]), k
        assert torch.equal(_running(tnet, True)[k], tbefore[k]), k
    # under record() both normalise with batch statistics and move them
    with mx.autograd.record():
        want = jnet(mx.nd.array(x)).asnumpy()
    with autograd.record():
        got = tnet(torch.from_numpy(x)).detach().numpy()
    assert np.abs(got - want).max() < LOGIT_TOL
    assert len(fused) == 6      # 2 bottlenecks: 2 body + 1 downsample
    jafter = _running(jnet, False)
    for k, v in _running(tnet, True).items():
        assert not torch.equal(v, tbefore[k]), k
        assert np.abs(v.numpy() - jafter[k]).max() < STAT_TOL, k


def test_predict_mode_inside_record_uses_running_statistics(nets):
    jnet, tnet = nets
    tnet.load_parameters(gluon_params_from_jax(jnet, "cpu", "NHWC"))
    x = torch.randn(2, 32, 32, 3)
    before = _running(tnet, True)
    with autograd.record(train_mode=False):
        a = tnet(x)
    b = tnet(x)
    assert torch.equal(a.detach(), b.detach())
    for k, v in _running(tnet, True).items():
        assert torch.equal(v, before[k]), k


def test_collect_params_names_and_order_match_jax(nets):
    jnet, tnet = nets
    want = [k[len(jnet.prefix):] for k in jnet.collect_params()]
    got = [k[len(tnet.prefix):] for k in tnet.collect_params()]
    assert got == want
    sel = tnet.collect_params(".*_running_")
    assert [k[len(tnet.prefix):] for k in sel] == \
        [k for k in want if "_running_" in k]
    for name, p in tnet.collect_params().items():
        jp = jnet.collect_params()[jnet.prefix + name[len(tnet.prefix):]]
        assert p.grad_req == jp.grad_req, name
