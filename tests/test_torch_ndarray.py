"""The port's NDArray layer against the JAX package's, on the CPU: the
registry audit, creation and dtypes, MXNet's reshape codes, indexing and
in-place writes (which must land in the array's own storage), `out=`,
copies between contexts, the fluent methods, and the rest of autograd on
NDArrays (attach_grad, mark_variables, grad with create_graph, Function,
grad_req "add", and the rule for in-place writes under record()).

Tolerances: values that both sides compute in fp32 by the same formula
agree to 1e-6; gradients to 1e-5."""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.ops import registry as JR
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, autograd, nd
from mxnet_tpu_torch.ops import registry as TR
from torch_ops_parity import (DEFERRED, DEFERRED_MODULES, SWEPT_MODULES,
                              _no_persistent_compile_cache,  # noqa: F401
                              module_of)

TOL = 1e-6
GRAD_TOL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


def test_registry_audit():
    """The port registers every op the JAX package registers in
    ops/{math,tensor,extra,init_ops,random_ops,nn}.py and
    _contrib_flash_attention, under every name, but the deferred list;
    nothing of the deferred modules, and no name JAX lacks."""
    jax_names = set(JR.list_ops())
    port = set(TR.list_ops())
    swept = {n for n in jax_names if module_of(n) in SWEPT_MODULES}
    assert swept - port == set(DEFERRED)
    assert port <= jax_names, sorted(port - jax_names)
    later = {n for n in jax_names if module_of(n) in DEFERRED_MODULES}
    assert later and not later & port
    # aliases share one op, as in the JAX registry
    for name in port:
        for other in ("broadcast_add", "Reshape", "SoftmaxOutput"):
            assert (JR.get(name) is JR.get(other)) == \
                (TR.get(name) is TR.get(other)), (name, other)
    assert len(port) == len(swept) - len(DEFERRED)


def test_nd_namespaces_and_calling_convention():
    assert nd.linalg.gemm2 is nd._linalg_gemm2
    assert nd.contrib.flash_attention is nd._contrib_flash_attention
    assert nd.random.normal is nd._random_normal
    x = nd.array(np.arange(6.0).reshape(2, 3))
    w = nd.array(np.ones((4, 3)))
    by_kw = nd.FullyConnected(data=x, weight=w, no_bias=True, num_hidden=4)
    by_pos = nd.FullyConnected(x, w, no_bias=True, num_hidden=4)
    assert np.array_equal(by_kw.asnumpy(), by_pos.asnumpy())
    parts = nd.split(x, num_outputs=3, axis=1)
    assert isinstance(parts, list) and len(parts) == 3
    with pytest.raises(MXNetError, match="positional"):
        nd.relu(x, 2.0)
    with pytest.raises(MXNetError, match="unknown param"):
        nd.relu(x, bogus=1)


@pytest.mark.parametrize("src", [
    np.arange(6, dtype=np.float64).reshape(2, 3),
    np.arange(6, dtype=np.int64),
    np.arange(4, dtype=np.uint8),
    np.ones((2, 2), np.float16),
    [1, 2, 3],
    2.5])
def test_array_dtypes_match_jax(src):
    """float64 -> float32 and int64 -> int32 as in the JAX package; a
    list or a number gives float32."""
    t, j = nd.array(src), jmx.nd.array(src)
    assert t.dtype == j.dtype and t.shape == j.shape
    assert np.array_equal(t.asnumpy(), j.asnumpy())
    assert isinstance(t.size, int) and t.ndim == j.ndim
    assert nd.array(src, dtype="float16").dtype == np.float16


def test_creation_functions_match_jax():
    for name, args, kw in [("zeros", ((2, 3),), {}),
                           ("ones", (4,), {"dtype": "int32"}),
                           ("full", ((2, 2), 7.5), {}),
                           ("empty", ((3,),), {}),
                           ("arange", (2, 9, 1.5), {}),
                           ("arange", (0, 3), {"repeat": 2})]:
        t = getattr(nd, name)(*args, **kw)
        j = getattr(jmx.nd, name)(*args, **kw)
        assert t.dtype == j.dtype and t.shape == j.shape, name
        assert np.array_equal(t.asnumpy(), j.asnumpy()), name
    a = nd.array([[1.0, 2.0]])
    assert np.array_equal(nd.zeros_like(a).asnumpy(), [[0, 0]])
    assert nd.concatenate([a, a]).shape == (2, 2)
    assert nd.moveaxis(nd.zeros((2, 3, 4)), 0, -1).shape == (3, 4, 2)
    assert a.context == mx.cpu() and a.ctx.device_type == "cpu"
    nd.waitall()
    a.wait_to_read()


@pytest.mark.parametrize("shape", [(0, -1), (-1, 0), (-3, -2), (-4, 1, 2, -2),
                                   (-2, 1), (0, -3), (6, 2, 2)])
def test_reshape_codes_match_jax(shape):
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    t = nd.array(x).reshape(shape)
    j = jmx.nd.array(x).reshape(shape)
    assert t.shape == j.shape
    assert np.array_equal(t.asnumpy(), j.asnumpy())


def _both(x):
    return nd.array(x), jmx.nd.array(x)


def _same(t, j, tol=TOL):
    assert t.shape == j.shape and t.dtype == j.dtype
    assert np.allclose(t.asnumpy(), j.asnumpy(), atol=tol, rtol=0)


@pytest.mark.parametrize("key, value", [
    (slice(None), 3.0),
    (1, np.array([9.0, 8.0, 7.0, 6.0])),
    ((slice(1, 3), 0), -1.0),
    ((0, slice(None, None, 2)), np.array([5.0, 6.0])),
    ("nd_index", 4.0)])
def test_setitem_writes_in_place_as_jax_values(key, value):
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    t, j = _both(x)
    ptr = t._data.data_ptr()
    if key == "nd_index":
        t[nd.array([0, 2])] = value
        j[jmx.nd.array([0, 2])] = value
    else:
        t[key] = nd.array(value) if isinstance(value, np.ndarray) else value
        j[key] = jmx.nd.array(value) if isinstance(value, np.ndarray) \
            else value
    _same(t, j)
    assert t._data.data_ptr() == ptr


def test_setitem_keeps_the_dtype_and_slices_are_views():
    t, j = _both(np.zeros((2, 3), np.int32))
    t[0] = 9.7
    j[0] = 9.7
    _same(t, j)
    v = t[1]
    v[:] = 5          # a basic slice is a view of t's storage, as in MXNet
    assert t.asnumpy()[1].tolist() == [5, 5, 5]


@pytest.mark.parametrize("op", ["+=", "-=", "*=", "/="])
def test_augmented_assignment_is_in_place(op):
    x = np.arange(1, 7, dtype=np.float32).reshape(2, 3)
    y = np.full((1, 3), 2.0, np.float32)
    for other in (2.0, "array"):
        t, j = _both(x)
        ptr = t._data.data_ptr()
        to = nd.array(y) if other == "array" else other
        jo = jmx.nd.array(y) if other == "array" else other
        scope = {"t": t, "to": to}
        exec("t %s to" % op, {}, scope)
        want = {"+=": j + jo, "-=": j - jo, "*=": j * jo, "/=": j / jo}[op]
        # the augmented operators write t's own tensor
        assert scope["t"] is t and t._data.data_ptr() == ptr
        _same(t, want)


def test_out_writes_into_the_given_array():
    x = nd.array(np.array([[-1.0, 2.0]]))
    y = nd.zeros((1, 2))
    ptr = y._data.data_ptr()
    r = nd.relu(x, out=y)
    assert r is y and y._data.data_ptr() == ptr
    assert y.asnumpy().tolist() == [[0.0, 2.0]]


def test_copyto_and_as_in_context():
    a = nd.array(np.arange(4.0))
    b = nd.zeros((4,))
    ptr = b._data.data_ptr()
    assert a.copyto(b) is b and b._data.data_ptr() == ptr
    assert np.array_equal(b.asnumpy(), a.asnumpy())
    c = a.copyto(mx.cpu())
    assert c is not a and c._data.data_ptr() != a._data.data_ptr()
    assert a.as_in_context(mx.cpu()) is a
    with pytest.raises(MXNetError, match="shapes"):
        a.copyto(nd.zeros((3,)))
    d = a.copy()
    d[:] = 0
    assert a.asnumpy().sum() == 6


def test_asscalar_errors_as_jax():
    t, j = _both(np.ones(3, np.float32))
    with pytest.raises(MXNetError, match="not a scalar"):
        t.asscalar()
    with pytest.raises(jmx.base.MXNetError, match="not a scalar"):
        j.asscalar()
    assert nd.array([4.0]).asscalar() == 4.0
    assert nd.array([4.0]).item() == jmx.nd.array([4.0]).item()


@pytest.mark.parametrize("method, args", [
    ("sum", {"axis": 1}), ("mean", {}), ("max", {"axis": 0}),
    ("min", {"axis": 1, "keepdims": True}), ("argmax", {"axis": 1}),
    ("argmin", {}), ("norm", {}), ("abs", {}), ("flatten", {}),
    ("expand_dims", {"axis": 0}), ("transpose", {}),
    ("clip", {"a_min": -0.5, "a_max": 0.5}),
    ("slice_axis", {"axis": 1, "begin": 0, "end": 2}),
    ("one_hot", {"depth": 3}), ("astype", {"dtype": "int32"}),
    ("flip", {"axis": 1}), ("squeeze", {})])
def test_fluent_methods_match_jax(method, args):
    x = np.random.RandomState(0).uniform(-1, 1, (2, 3)).astype(np.float32)
    if method == "one_hot":
        x = np.array([0, 2, 1], np.float32)
    t, j = _both(x)
    _same(getattr(t, method)(**args), getattr(j, method)(**args), 1e-6)


def test_operators_match_jax():
    x = np.random.RandomState(1).uniform(0.5, 2, (2, 3)).astype(np.float32)
    t, j = _both(x)
    for fn in (lambda a: a + 1, lambda a: 2 - a, lambda a: a * a,
               lambda a: 1 / a, lambda a: a ** 2, lambda a: 2 ** a,
               lambda a: a % 0.7, lambda a: -a, lambda a: abs(a - 1),
               lambda a: a == a, lambda a: a > 1, lambda a: a <= 1.2,
               lambda a: a != 1, lambda a: a.T, lambda a: a[1],
               lambda a: a[:, 1:], lambda a: a.take(np.array([1, 0]))):
        _same(fn(t), fn(j))
    # comparisons are 0/1 in x's dtype
    assert (t > 1).dtype == np.float32
    assert len(t) == 2 and [r.shape for r in t] == [(3,), (3,)]


# ---------------------------------------------------------------------------
# autograd on NDArrays
# ---------------------------------------------------------------------------


def test_attach_grad_and_backward_match_jax():
    x = np.random.RandomState(2).randn(3, 4).astype(np.float32)
    grads = []
    for pkg in (mx, jmx):
        a = pkg.nd.array(x)
        a.attach_grad()
        with pkg.autograd.record():
            y = pkg.nd.sum(pkg.nd.exp(a) * a, axis=1)
        y.backward(pkg.nd.array(np.array([1.0, 2.0, 3.0], np.float32)))
        grads.append(a.grad.asnumpy())
    assert np.allclose(grads[0], grads[1], atol=GRAD_TOL)


def test_grad_req_add_and_mark_variables():
    x = np.arange(1, 5, dtype=np.float32)
    buf = nd.zeros((4,))
    a = nd.array(x)
    autograd.mark_variables([a], [buf], grad_reqs="add")
    for _ in range(2):
        with autograd.record():
            y = a * a
        y.backward()
    assert a.grad is buf
    assert np.allclose(buf.asnumpy(), 4 * x)
    ja = jmx.nd.array(x)
    jmx.autograd.mark_variables([ja], [jmx.nd.zeros((4,))], grad_reqs="add")
    for _ in range(2):
        with jmx.autograd.record():
            jy = ja * ja
        jy.backward()
    assert np.allclose(buf.asnumpy(), ja.grad.asnumpy(), atol=GRAD_TOL)


def test_grad_returns_and_create_graph_gives_the_second_derivative():
    x = np.array([0.5, -1.0, 2.0], np.float32)
    a = nd.array(x)
    a.attach_grad()
    with autograd.record():
        y = a ** 3
        (dy,) = autograd.grad(y, [a], create_graph=True)
    assert np.allclose(dy.asnumpy(), 3 * x * x, atol=GRAD_TOL)
    assert not a.grad.asnumpy().any()        # grad writes nothing
    dy.backward()
    assert np.allclose(a.grad.asnumpy(), 6 * x, atol=GRAD_TOL)
    ja = jmx.nd.array(x)
    ja.attach_grad()
    with jmx.autograd.record():
        jy = ja ** 3
        (jdy,) = jmx.autograd.grad(jy, [ja], create_graph=True)
    jdy.backward()
    assert np.allclose(a.grad.asnumpy(), ja.grad.asnumpy(), atol=GRAD_TOL)


def test_custom_function_matches_jax():
    x = np.array([[0.2, -0.4, 1.0]], np.float32)
    seed = np.array([[1.0, 2.0, -1.0]], np.float32)
    out = []
    for pkg in (mx, jmx):
        class Sigmoid(pkg.autograd.Function):
            def forward(self, z):
                y = 1 / (1 + pkg.nd.exp(-z))
                self.save_for_backward(y)
                return y

            def backward(self, dy):
                (y,) = self.saved_tensors
                return dy * y * (1 - y)

        a = pkg.nd.array(x)
        a.attach_grad()
        with pkg.autograd.record():
            y = Sigmoid()(a)
        y.backward(pkg.nd.array(seed))
        out.append((y.asnumpy(), a.grad.asnumpy()))
    assert np.allclose(out[0][0], out[1][0], atol=TOL)
    assert np.allclose(out[0][1], out[1][1], atol=GRAD_TOL)
    assert np.allclose(out[0][0], 1 / (1 + np.exp(-x)), atol=TOL)


def test_in_place_write_rule_under_record():
    """Under record() an in-place write into or from a recorded array
    raises; outside it the write lands in place, and a backward that
    needs the overwritten value raises instead of using the new one."""
    a = nd.array(np.array([1.0, 2.0], np.float32))
    a.attach_grad()
    with autograd.record():
        y = a * a
        with pytest.raises(MXNetError, match="in-place"):
            a[:] = 0
        with pytest.raises(MXNetError, match="in-place"):
            a += 1
        with pytest.raises(MXNetError, match="in-place"):
            nd.zeros((2,))[:] = y
    y.backward()
    assert a.grad.asnumpy().tolist() == [2.0, 4.0]
    with autograd.record():
        y = a * a
    ptr = a._data.data_ptr()
    a[:] = 5.0                      # outside record(): in place
    assert a._data.data_ptr() == ptr and a.asnumpy().tolist() == [5, 5]
    with pytest.raises(MXNetError, match="overwritten in place"):
        y.backward()
    # a fresh recording from the new value works
    with autograd.record():
        y = a * a
    y.backward()
    assert a.grad.asnumpy().tolist() == [10.0, 10.0]


def test_unrecorded_ndarray_head_raises_as_jax():
    for pkg, err in ((mx, MXNetError), (jmx, jmx.base.MXNetError)):
        a = pkg.nd.array(np.ones(2, np.float32))
        a.attach_grad()
        y = a * 2          # outside record()
        with pytest.raises(err, match="not in the recorded graph"):
            y.backward()
    a = nd.array(np.ones(2, np.float32))
    y = a * 2
    assert not y._data.requires_grad


def test_updater_and_kvstore_take_ndarrays():
    w = nd.array(np.ones(3, np.float32))
    g = nd.array(np.full(3, 0.5, np.float32))
    upd = mx.optimizer.get_updater(mx.optimizer.SGD(learning_rate=0.1))
    ptr = w._data.data_ptr()
    upd(0, g, w)
    assert np.allclose(w.asnumpy(), 0.95) and w._data.data_ptr() == ptr
    kv = mx.kv.create("local")
    kv.init(3, nd.zeros((3,)))
    kv.push(3, [nd.ones((3,)), nd.ones((3,))])
    out = nd.zeros((3,))
    kv.pull(3, out=out)
    assert out.asnumpy().tolist() == [2.0, 2.0, 2.0]
