"""Parity of the port's Symbol layer with the JAX package's: the cases of
tests/test_symbol.py, each run on both packages (the port on the CPU)
with the same seeded numpy inputs.

Each case is a function of the package; it makes the reference test's
own assertions, in both packages, and returns what the two must agree
on: names and shapes exactly, arrays within 1e-6 (fp32, the same ops in
the same order), graph JSON byte for byte. Beyond the reference's
cases: JSON that the JAX package writes loads into the port and back,
auto names inside a `NameManager`, `AttrScope`, `infer_type`, and graphs
of every op family the Gluon layers trace.
"""
import json
import os
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_symbolic_parity import (  # noqa: E402,F401
    no_persistent_compile_cache, restore_shared_state)

pytestmark = pytest.mark.usefixtures("restore_shared_state")

TOL = 1e-6


def _np(v):
    return v.asnumpy() if hasattr(v, "asnumpy") else v


def _run(case, seed=0):
    """(JAX's result, the port's result) of `case(mx, rng)`, each under a
    fresh name manager: auto names count from 0 in both."""
    with jmx.name.NameManager():
        j = case(jmx, np.random.RandomState(seed))
    with tmx.cpu(), tmx.name.NameManager():
        t = case(tmx, np.random.RandomState(seed))
    return j, t


def _agree(j, t, tol=TOL):
    assert type(j) is type(t) or isinstance(j, (np.ndarray,)) or \
        hasattr(j, "asnumpy"), (type(j), type(t))
    if isinstance(j, dict):
        assert list(j) == list(t)
        for k in j:
            _agree(j[k], t[k], tol)
    elif isinstance(j, (list, tuple)):
        assert len(j) == len(t)
        for a, b in zip(j, t):
            _agree(a, b, tol)
    elif hasattr(j, "asnumpy") or isinstance(j, np.ndarray):
        a, b = _np(j), _np(t)
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=tol, atol=tol)
    else:
        assert j == t


# -- the cases of tests/test_symbol.py ---------------------------------------

def variable_and_compose(mx, rng):
    x = mx.sym.var("x")
    y = mx.sym.var("y")
    z = x + y
    assert set(z.list_arguments()) == {"x", "y"}
    assert z.num_outputs == 1
    return z.list_arguments(), z.tojson()


def auto_variable_creation(mx, rng):
    data = mx.sym.var("data")
    fc = mx.sym.FullyConnected(data=data, num_hidden=10, name="fc1")
    assert fc.list_arguments() == ["data", "fc1_weight", "fc1_bias"]
    fc_nb = mx.sym.FullyConnected(data=data, num_hidden=10, no_bias=True,
                                  name="fc2")
    assert fc_nb.list_arguments() == ["data", "fc2_weight"]
    return fc.tojson(), fc_nb.tojson()


def auto_naming(mx, rng):
    with mx.name.NameManager():
        data = mx.sym.var("data")
        c1 = mx.sym.Convolution(data=data, kernel=(3, 3), num_filter=8)
        c2 = mx.sym.Convolution(data=c1, kernel=(3, 3), num_filter=8)
        assert c1.name == "convolution0"
        assert c2.name == "convolution1"
        assert "convolution0_weight" in c2.list_arguments()
        return c2.list_arguments(), c2.tojson()


def batchnorm_aux_states(mx, rng):
    data = mx.sym.var("data")
    bn = mx.sym.BatchNorm(data=data, name="bn")
    assert bn.list_arguments() == ["data", "bn_gamma", "bn_beta"]
    assert bn.list_auxiliary_states() == ["bn_moving_mean", "bn_moving_var"]
    return bn.list_outputs(), bn.tojson()


def infer_shape_mlp(mx, rng):
    data = mx.sym.var("data")
    h = mx.sym.FullyConnected(data=data, num_hidden=128, name="fc1")
    h = mx.sym.Activation(data=h, act_type="relu")
    out = mx.sym.FullyConnected(data=h, num_hidden=10, name="fc2")
    arg_shapes, out_shapes, aux_shapes = out.infer_shape(data=(32, 784))
    d = dict(zip(out.list_arguments(), arg_shapes))
    assert d["fc1_weight"] == (128, 784)
    assert d["fc1_bias"] == (128,)
    assert d["fc2_weight"] == (10, 128)
    assert out_shapes == [(32, 10)]
    return arg_shapes, out_shapes, aux_shapes


def infer_shape_conv(mx, rng):
    data = mx.sym.var("data")
    c = mx.sym.Convolution(data=data, kernel=(3, 3), num_filter=16,
                           pad=(1, 1), name="c1")
    p = mx.sym.Pooling(data=c, kernel=(2, 2), stride=(2, 2), pool_type="max")
    arg_shapes, out_shapes, _ = p.infer_shape(data=(4, 3, 32, 32))
    d = dict(zip(p.list_arguments(), arg_shapes))
    assert d["c1_weight"] == (16, 3, 3, 3)
    assert out_shapes == [(4, 16, 16, 16)]
    return arg_shapes, out_shapes


def group_and_internals(mx, rng):
    with mx.name.NameManager():
        x = mx.sym.var("x")
        a = x * 2
        b = x + 1
        g = mx.sym.Group([a, b])
        assert g.num_outputs == 2
        assert len(g.list_outputs()) == 2
        internals = (a + b).get_internals()
        assert internals.num_outputs >= 3
        return g.list_outputs(), internals.list_outputs(), g.tojson()


def json_roundtrip(mx, rng):
    data = mx.sym.var("data")
    net = mx.sym.FullyConnected(data=data, num_hidden=4, name="fc")
    net = mx.sym.SoftmaxOutput(data=net, name="sm")
    js = net.tojson()
    net2 = mx.sym.load_json(js)
    assert net2.list_arguments() == net.list_arguments()
    a1, o1, _ = net.infer_shape(data=(2, 8))
    a2, o2, _ = net2.infer_shape(data=(2, 8))
    assert o1 == o2 and a1 == a2
    assert net2.tojson() == js
    return js, a2, o2


def simple_bind_forward_backward(mx, rng):
    data = mx.sym.var("data")
    fc = mx.sym.FullyConnected(data=data, num_hidden=3, name="fc")
    out = mx.sym.sum(fc)
    ex = out.simple_bind(mx.cpu(), data=(2, 5))
    ex.arg_dict["data"][:] = 1.0
    ex.arg_dict["fc_weight"][:] = 0.5
    ex.arg_dict["fc_bias"][:] = 0.0
    outs = ex.forward(is_train=True)
    np.testing.assert_allclose(outs[0].asnumpy(), 2 * 3 * 5 * 0.5, rtol=1e-5)
    ex.backward()
    np.testing.assert_allclose(ex.grad_dict["fc_bias"].asnumpy(),
                               np.full(3, 2.0), rtol=1e-5)
    np.testing.assert_allclose(ex.grad_dict["fc_weight"].asnumpy(),
                               np.full((3, 5), 2.0), rtol=1e-5)
    return outs, dict(ex.grad_dict)


def executor_softmax_output_grad(mx, rng):
    data = mx.sym.var("data")
    label = mx.sym.var("label")
    out = mx.sym.SoftmaxOutput(data=data, label=label, name="sm")
    ex = out.simple_bind(mx.cpu(), data=(2, 4), label=(2,),
                         grad_req={"data": "write"})
    x = rng.randn(2, 4).astype(np.float32)
    ex.arg_dict["data"][:] = x
    ex.arg_dict["label"][:] = np.array([1, 3], dtype=np.float32)
    outs = ex.forward(is_train=True)
    p = outs[0].asnumpy()
    np.testing.assert_allclose(p.sum(axis=1), np.ones(2), rtol=1e-5)
    ex.backward()
    onehot = np.zeros((2, 4), np.float32)
    onehot[0, 1] = 1
    onehot[1, 3] = 1
    np.testing.assert_allclose(ex.grad_dict["data"].asnumpy(), p - onehot,
                               rtol=1e-4, atol=1e-6)
    return outs, ex.grad_dict["data"]


def executor_batchnorm_aux_update(mx, rng):
    data = mx.sym.var("data")
    bn = mx.sym.BatchNorm(data=data, name="bn", momentum=0.5)
    loss = mx.sym.sum(bn)
    ex = loss.simple_bind(mx.cpu(), data=(8, 3))
    ex.aux_dict["bn_moving_var"][:] = 1.0
    x = rng.randn(8, 3).astype(np.float32) * 3 + 1
    ex.arg_dict["data"][:] = x
    mm_before = ex.aux_dict["bn_moving_mean"].asnumpy().copy()
    ex.forward(is_train=True)
    mm_after = ex.aux_dict["bn_moving_mean"].asnumpy()
    expected = 0.5 * mm_before + 0.5 * x.mean(axis=0)
    np.testing.assert_allclose(mm_after, expected, rtol=1e-4)
    ex.forward(is_train=False)
    np.testing.assert_allclose(ex.aux_dict["bn_moving_mean"].asnumpy(),
                               mm_after, rtol=1e-6)
    return mm_after, ex.aux_dict["bn_moving_var"].asnumpy()


def bind_with_arrays(mx, rng):
    x = mx.sym.var("x")
    y = x * 2 + 1
    xv = mx.nd.array(np.arange(6).reshape(2, 3))
    ex = y.bind(mx.cpu(), {"x": xv})
    out = ex.forward()[0].asnumpy()
    np.testing.assert_allclose(out, np.arange(6).reshape(2, 3) * 2 + 1)
    return out


def grad_req_add_and_null(mx, rng):
    x = mx.sym.var("x")
    y = mx.sym.sum(x * 3)
    ex = y.simple_bind(mx.cpu(), x=(4,), grad_req="add")
    ex.arg_dict["x"][:] = 1.0
    ex.forward(is_train=True)
    ex.backward()
    ex.forward(is_train=True)
    ex.backward()
    np.testing.assert_allclose(ex.grad_dict["x"].asnumpy(), np.full(4, 6.0))
    ex2 = y.simple_bind(mx.cpu(), x=(4,), grad_req="null")
    ex2.arg_dict["x"][:] = 1.0
    ex2.forward(is_train=True)
    ex2.backward()
    assert ex2.grad_dict == {}
    return ex.grad_dict["x"]


def slice_channel_multi_output(mx, rng):
    x = mx.sym.var("x")
    parts = mx.sym.SliceChannel(x, num_outputs=3, axis=1, name="split")
    assert parts.num_outputs == 3
    s = parts[0] + parts[1] + parts[2]
    ex = s.simple_bind(mx.cpu(), x=(2, 6))
    ex.arg_dict["x"][:] = 1.0
    out = ex.forward()[0]
    assert out.shape == (2, 2)
    np.testing.assert_allclose(out.asnumpy(), np.full((2, 2), 3.0))
    return parts.list_outputs(), out


def cached_op_forward(mx, rng):
    data = mx.sym.var("data")
    net = mx.sym.FullyConnected(data=data, num_hidden=3, name="fc")
    op = mx.CachedOp(net)
    assert op.input_names == ["data", "fc_weight", "fc_bias"]
    d = mx.nd.ones((2, 5))
    w = mx.nd.full((3, 5), 0.5)
    b = mx.nd.zeros((3,))
    (out,) = op(d, w, b)
    np.testing.assert_allclose(out.asnumpy(), np.full((2, 3), 2.5),
                               rtol=1e-5)
    return out


def cached_op_backward_through_tape(mx, rng):
    data = mx.sym.var("data")
    net = mx.sym.FullyConnected(data=data, num_hidden=3, name="fc")
    op = mx.CachedOp(net)
    d = mx.nd.ones((2, 5))
    w = mx.nd.full((3, 5), 0.5)
    b = mx.nd.zeros((3,))
    w.attach_grad()
    b.attach_grad()
    with mx.autograd.record():
        (out,) = op(d, w, b)
        loss = out.sum()
    loss.backward()
    np.testing.assert_allclose(b.grad.asnumpy(), np.full(3, 2.0), rtol=1e-5)
    np.testing.assert_allclose(w.grad.asnumpy(), np.full((3, 5), 2.0),
                               rtol=1e-5)
    return w.grad, b.grad


def eval_(mx, rng):
    x = mx.sym.var("x")
    y = x * 2
    out = y.eval(x=mx.nd.ones((2, 2)))
    np.testing.assert_allclose(out[0].asnumpy(), np.full((2, 2), 2.0))
    return out


def dropout_rng_in_graph(mx, rng):
    x = mx.sym.var("x")
    y = mx.sym.Dropout(x, p=0.5)
    ex = y.simple_bind(mx.cpu(), x=(100,))
    ex.arg_dict["x"][:] = 1.0
    out_train = ex.forward(is_train=True)[0].asnumpy()
    assert (out_train == 0).any()
    assert set(np.unique(out_train)) <= {0.0, 2.0}
    out_pred = ex.forward(is_train=False)[0].asnumpy()
    np.testing.assert_allclose(out_pred, np.ones(100))
    # the masks are each package's own draws: compare the prediction
    return out_pred


def backward_out_grads_same_dropout_mask(mx, rng):
    x = mx.sym.var("x")
    y = mx.sym.Dropout(x, p=0.5)
    ex = y.simple_bind(mx.cpu(), x=(200,))
    ex.arg_dict["x"][:] = 1.0
    out = ex.forward(is_train=True)[0].asnumpy()
    ex.backward(out_grads=mx.nd.ones((200,)))
    g = ex.grad_dict["x"].asnumpy()
    kept = out != 0
    np.testing.assert_allclose(g[kept], np.full(kept.sum(), 2.0))
    np.testing.assert_allclose(g[~kept], 0.0)
    return bool(kept.any() and (~kept).any())


def shared_var_not_reclassified_as_aux(mx, rng):
    mm = mx.sym.var("mm")
    other = mm * 2
    assert other.list_arguments() == ["mm"]
    d = mx.sym.var("d")
    bn = mx.sym.BatchNorm(data=d, moving_mean=mm, name="bn")
    assert "mm" in bn.list_auxiliary_states()
    assert other.list_arguments() == ["mm"]
    assert other.list_auxiliary_states() == []
    return bn.list_auxiliary_states(), bn.list_arguments()


def extra_positional_inputs_raise(mx, rng):
    x = mx.sym.var("x")
    w = mx.sym.var("w")
    b = mx.sym.var("b")
    with pytest.raises(mx.MXNetError):
        mx.sym.FullyConnected(x, w, b, num_hidden=3, no_bias=True)
    return True


REFERENCE_CASES = [
    variable_and_compose, auto_variable_creation, auto_naming,
    batchnorm_aux_states, infer_shape_mlp, infer_shape_conv,
    group_and_internals, json_roundtrip, simple_bind_forward_backward,
    executor_softmax_output_grad, executor_batchnorm_aux_update,
    bind_with_arrays, grad_req_add_and_null, slice_channel_multi_output,
    cached_op_forward, cached_op_backward_through_tape, eval_,
    dropout_rng_in_graph, backward_out_grads_same_dropout_mask,
    shared_var_not_reclassified_as_aux, extra_positional_inputs_raise,
]


@pytest.mark.parametrize("case", REFERENCE_CASES,
                         ids=[c.__name__.rstrip("_") for c in REFERENCE_CASES])
def test_reference_case_agrees(case):
    _agree(*_run(case))


def test_rnn_symbol_waits_for_its_op():
    """tests/test_symbol.py::test_rnn_symbol_infer: the `RNN` op is
    deferred with gluon.rnn (ROADMAP A10), so the port has no sym.RNN
    while the JAX package infers its shapes."""
    data = jmx.sym.var("data")
    rnn = jmx.sym.RNN(data=data, state_size=16, num_layers=2, mode="lstm",
                      name="lstm", state_outputs=True)
    assert rnn.infer_shape(data=(10, 4, 8))[1][0] == (10, 4, 16)
    assert not hasattr(tmx.sym, "RNN")


# -- beyond the reference's cases ---------------------------------------------

def _mixed_graph(mx):
    """A graph over the op families the Gluon layers trace, NHWC and NCHW,
    with attributes and scopes."""
    with mx.name.NameManager():
        with mx.AttrScope(ctx_group="stage1", lr_mult="0.5"):
            data = mx.sym.var("data")
            w = mx.sym.var("w", shape=(8, 3, 3, 3), lr_mult=2.0,
                           wd_mult=0.0, dtype="float32", init="zeros")
        c = mx.sym.Convolution(data, weight=w, kernel=(3, 3), pad=(1, 1),
                               num_filter=8, no_bias=True, layout="NHWC")
        b = mx.sym.BatchNorm(c, axis=3, fix_gamma=False, eps=1e-5)
        a = mx.sym.LeakyReLU(b, act_type="leaky", slope=0.1)
        p = mx.sym.Pooling(a, kernel=(2, 2), stride=(2, 2), pool_type="avg",
                           layout="NHWC")
        q = mx.sym.Pooling(a, kernel=(1, 1), global_pool=True,
                           pool_type="max", layout="NHWC")
        f = mx.sym.concat(mx.sym.flatten(p), mx.sym.flatten(q), dim=1)
        ln = mx.sym.LayerNorm(f, axis=-1, eps=1e-5)
        fc = mx.sym.FullyConnected(ln, num_hidden=5)
        d = mx.sym.Dropout(fc, p=0.25)
        out = mx.sym.SoftmaxOutput(d, name="softmax")
        return mx.sym.Group([out, mx.sym.BlockGrad(fc)])


def test_mixed_graph_json_is_byte_identical():
    j, t = _mixed_graph(jmx), _mixed_graph(tmx)
    assert t.tojson() == j.tojson()
    assert t.list_arguments() == j.list_arguments()
    assert t.list_auxiliary_states() == j.list_auxiliary_states()
    assert t.list_outputs() == j.list_outputs()
    assert t.attr_dict() == j.attr_dict()


def test_json_from_jax_loads_in_the_port_and_back():
    js = _mixed_graph(jmx).tojson()
    t = tmx.sym.load_json(js)
    assert t.tojson() == js
    assert jmx.sym.load_json(t.tojson()).tojson() == js
    shapes = dict(data=(2, 6, 6, 3))
    assert t.infer_shape(**shapes) == \
        jmx.sym.load_json(js).infer_shape(**shapes)


def test_symbol_files_cross_both_ways(tmp_path):
    _mixed_graph(jmx).save(str(tmp_path / "j-symbol.json"))
    _mixed_graph(tmx).save(str(tmp_path / "t-symbol.json"))
    assert (tmp_path / "j-symbol.json").read_bytes() == \
        (tmp_path / "t-symbol.json").read_bytes()
    t = tmx.sym.load(str(tmp_path / "j-symbol.json"))
    j = jmx.sym.load(str(tmp_path / "t-symbol.json"))
    assert t.tojson() == j.tojson()


def test_legacy_json_fills_aux_inputs_as_jax_does():
    """A pre-1.0 graph: split 'param'/'attr' dicts, [node, out] entries
    and a BatchNorm without its moving statistics."""
    legacy = json.dumps({
        "nodes": [
            {"op": "null", "name": "data", "inputs": []},
            {"op": "null", "name": "bn_gamma", "inputs": []},
            {"op": "null", "name": "bn_beta", "inputs": []},
            {"op": "BatchNorm", "name": "bn", "param": {"eps": "0.001"},
             "attr": {"ctx_group": "g1"},
             "inputs": [[0, 0], [1, 0], [2, 0]]}],
        "arg_nodes": [0, 1, 2], "heads": [[3, 0]]})
    j, t = jmx.sym.load_json(legacy), tmx.sym.load_json(legacy)
    assert t.list_auxiliary_states() == j.list_auxiliary_states() == \
        ["bn_moving_mean", "bn_moving_var"]
    assert t.tojson() == j.tojson()
    assert t.attr_dict() == j.attr_dict()


@pytest.mark.parametrize("types", [dict(data="float32"),
                                   dict(data="float64"),
                                   dict(data="float16")])
def test_infer_type_agrees(types):
    j, t = _mixed_graph(jmx), _mixed_graph(tmx)
    jt, tt = j.infer_type(**types), t.infer_type(**types)
    for a, b in zip(jt, tt):
        assert [np.dtype(x) for x in a] == [np.dtype(x) for x in b]


@pytest.mark.parametrize("shape", [(2, 6, 6, 3), (4, 8, 8, 3)])
def test_infer_shape_of_the_mixed_graph_agrees(shape):
    j, t = _mixed_graph(jmx), _mixed_graph(tmx)
    assert t.infer_shape(data=shape) == j.infer_shape(data=shape)
    assert t.infer_shape_partial() == j.infer_shape_partial()


def test_internals_and_children_agree():
    j, t = _mixed_graph(jmx), _mixed_graph(tmx)
    assert t.get_internals().list_outputs() == \
        j.get_internals().list_outputs()
    ji = j.get_internals()["fullyconnected0_output"]
    ti = t.get_internals()["fullyconnected0_output"]
    assert ti.tojson() == ji.tojson()
    assert t[0].get_children().list_outputs() == \
        j[0].get_children().list_outputs()
    assert t.debug_str() == j.debug_str()


def test_symbol_arithmetic_and_fluent_methods_agree():
    def build(mx):
        with mx.name.NameManager():
            x = mx.sym.var("x")
            y = mx.sym.var("y")
            z = (2 - x) * y / 3 + x ** 2 - (x % 2) + (-y)
            z = z.reshape((4, 3)).transpose().sum(axis=1, keepdims=True)
            z = z.astype("float64").expand_dims(0).squeeze(0).flatten()
            return mx.sym.Group([z, x > y, x <= 1.5, x.mean(), x.softmax(),
                                 x.slice_axis(axis=0, begin=0, end=1)])
    j, t = build(jmx), build(tmx)
    assert t.tojson() == j.tojson()
    rng = np.random.RandomState(1)
    xv = rng.randn(3, 4).astype(np.float32)
    yv = rng.randn(3, 4).astype(np.float32)
    jo = j.eval(x=jmx.nd.array(xv), y=jmx.nd.array(yv))
    with tmx.cpu():
        to = t.eval(ctx=tmx.cpu(), x=tmx.nd.array(xv), y=tmx.nd.array(yv))
    _agree(jo, to, 1e-5)


def test_sym_namespaces_and_generated_ops():
    jnames = {n for n in dir(jmx.sym) if not n.startswith("__")}
    tnames = {n for n in dir(tmx.sym) if not n.startswith("__")}
    # every operator the port registers has its sym function, named as
    # the JAX package's
    from mxnet_tpu_torch.ops import registry as TR
    for name in TR.list_ops():
        assert name in tnames and name in jnames
    for ns in ("random", "linalg", "contrib", "sparse"):
        assert set(dir(getattr(tmx.sym, ns))) <= \
            set(dir(getattr(jmx.sym, ns))) | set(dir(tmx.sym.random))
    assert tmx.sym.contrib.flash_attention is \
        tmx.sym._contrib_flash_attention
