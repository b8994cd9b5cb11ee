"""Parity of the port's executor (Symbol.simple_bind / bind, forward,
backward) with the JAX package's, on the CPU.

The same graph, seeded inputs and parameters go through both executors.
Tolerances: fp32 outputs, gradients and aux states within 1e-5 (the
same ops; only summation order differs). The graph function's
conv1x1+BatchNorm rewrite (`graph.build_graph_fn`) is held against the
unfused graph on the plain path within 1e-5, and a float64 graph never
takes it.
"""
import os
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import graph as tgraph
from mxnet_tpu_torch import ops as tops

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_symbolic_parity import (  # noqa: E402,F401
    no_persistent_compile_cache, restore_shared_state)

pytestmark = pytest.mark.usefixtures("restore_shared_state")

TOL = 1e-5


def mlp(mx):
    with mx.name.NameManager():
        data = mx.sym.var("data")
        h = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
        h = mx.sym.Activation(h, act_type="relu")
        h = mx.sym.FullyConnected(h, num_hidden=4, name="fc2")
        return mx.sym.SoftmaxOutput(h, name="softmax")


def conv_bn(mx, layout="NCHW"):
    """conv3x3 -> BN -> relu -> conv1x1 -> BN -> pool -> fc -> softmax:
    in NHWC the second pair is the conv1x1+BN the graph fuses."""
    ax = 3 if layout == "NHWC" else 1
    with mx.name.NameManager():
        data = mx.sym.var("data")
        c = mx.sym.Convolution(data, kernel=(3, 3), pad=(1, 1), num_filter=6,
                               layout=layout, name="c1")
        b = mx.sym.BatchNorm(c, axis=ax, fix_gamma=False, name="bn1")
        a = mx.sym.Activation(b, act_type="relu")
        c = mx.sym.Convolution(a, kernel=(1, 1), num_filter=8,
                               layout=layout, name="c2")
        b = mx.sym.BatchNorm(c, axis=ax, fix_gamma=False, name="bn2")
        p = mx.sym.Pooling(b, kernel=(1, 1), global_pool=True,
                           pool_type="avg", layout=layout)
        f = mx.sym.FullyConnected(mx.sym.flatten(p), num_hidden=3, name="fc")
        return mx.sym.SoftmaxOutput(f, name="softmax")


def _shapes(sym_name, layout="NCHW", n=4):
    if sym_name == "mlp":
        return {"data": (n, 7)}
    return {"data": (n, 5, 5, 3) if layout == "NHWC" else (n, 3, 5, 5)}


def _values(ex, rng, n_cls):
    """Seeded values for every argument and aux state of a bound JAX
    executor (labels as class indices)."""
    out = {}
    for name, arr in list(ex.arg_dict.items()) + list(ex.aux_dict.items()):
        if name.endswith("label"):
            v = rng.randint(0, n_cls, size=arr.shape)
        elif name.endswith("moving_var"):
            v = rng.uniform(0.5, 2.0, size=arr.shape)
        else:
            v = rng.randn(*arr.shape) * 0.5
        out[name] = v.astype(np.float32)
    return out


def _bind_pair(build, grad_req="write", layout="NCHW", seed=0, n=4,
               **kw):
    js = build(jmx, layout) if layout != "none" else build(jmx)
    ts = build(tmx, layout) if layout != "none" else build(tmx)
    shapes = _shapes("mlp" if build is mlp else "cnn", layout, n)
    jex = js.simple_bind(jmx.cpu(), grad_req=grad_req, **shapes)
    tex = ts.simple_bind(tmx.cpu(), grad_req=grad_req, **shapes)
    vals = _values(jex, np.random.RandomState(seed),
                   4 if build is mlp else 3)
    for d_j, d_t in ((jex.arg_dict, tex.arg_dict),
                     (jex.aux_dict, tex.aux_dict)):
        for k in d_j:
            d_j[k][:] = vals[k]
            d_t[k][:] = vals[k]
    return jex, tex


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(b.asnumpy(), a.asnumpy(), rtol=tol, atol=tol)


def _check_all(jex, tex, tol=TOL):
    for a, b in zip(jex.outputs, tex.outputs):
        _close(a, b, tol)
    assert sorted(jex.grad_dict) == sorted(tex.grad_dict)
    for k in jex.grad_dict:
        _close(jex.grad_dict[k], tex.grad_dict[k], tol)
    for k in jex.aux_dict:
        _close(jex.aux_dict[k], tex.aux_dict[k], tol)


@pytest.mark.parametrize("build,layout", [(mlp, "none"), (conv_bn, "NCHW"),
                                          (conv_bn, "NHWC")],
                         ids=["mlp", "conv_bn_nchw", "conv_bn_nhwc"])
def test_forward_backward_agree(build, layout):
    jex, tex = _bind_pair(build, layout=layout)
    assert tex._arg_names == jex._arg_names
    assert tex._aux_names == jex._aux_names
    for _ in range(2):
        jex.forward(is_train=True)
        tex.forward(is_train=True)
        jex.backward()
        tex.backward()
        _check_all(jex, tex)
    jo = jex.forward(is_train=False)
    to = tex.forward(is_train=False)
    _close(jo[0], to[0])


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_grad_req_agrees(req):
    jex, tex = _bind_pair(conv_bn, grad_req=req, layout="NHWC")
    for _ in range(2):
        jex.forward(is_train=True)
        jex.backward()
        tex.forward(is_train=True)
        tex.backward()
    _check_all(jex, tex)
    if req == "null":
        assert tex.grad_dict == {}


def test_grad_req_per_argument_and_head_gradients():
    req = {"data": "write", "fc1_weight": "add", "fc2_bias": "null"}
    jex, tex = _bind_pair(mlp, grad_req=req, layout="none")
    assert sorted(tex.grad_dict) == ["data", "fc1_weight"]
    og = np.random.RandomState(3).randn(4, 4).astype(np.float32)
    for ex, mx in ((jex, jmx), (tex, tmx)):
        ex.forward(is_train=True)
        with mx.cpu():
            ex.backward(out_grads=[mx.nd.array(og)])
    _check_all(jex, tex)


def test_backward_without_forward_replays_the_graph():
    jex, tex = _bind_pair(mlp, layout="none")
    jex.backward()
    tex.backward()
    for k in jex.grad_dict:
        _close(jex.grad_dict[k], tex.grad_dict[k])


def test_reshape_shares_the_parameters():
    jex, tex = _bind_pair(conv_bn, layout="NHWC")
    jr = jex.reshape(data=(2, 5, 5, 3), softmax_label=(2,))
    tr = tex.reshape(data=(2, 5, 5, 3), softmax_label=(2,))
    assert tr.arg_dict["c1_weight"] is tex.arg_dict["c1_weight"]
    assert tr.arg_dict["data"].shape == (2, 5, 5, 3)
    x = np.random.RandomState(5).randn(2, 5, 5, 3).astype(np.float32)
    jr.arg_dict["data"][:] = x
    tr.arg_dict["data"][:] = x
    _close(jr.forward()[0], tr.forward()[0])


def test_copy_params_from_and_bind_with_arrays():
    jex, tex = _bind_pair(mlp, layout="none")
    rng = np.random.RandomState(7)
    params = {k: rng.randn(*v.shape).astype(np.float32)
              for k, v in jex.arg_dict.items() if k.startswith("fc")}
    jex.copy_params_from({k: jmx.nd.array(v) for k, v in params.items()})
    with tmx.cpu():
        tex.copy_params_from({k: tmx.nd.array(v)
                              for k, v in params.items()})
        with pytest.raises(tmx.MXNetError):
            tex.copy_params_from({"nope": tmx.nd.zeros((1,))})
        tex.copy_params_from({"nope": tmx.nd.zeros((1,))},
                             allow_extra_params=True)
    _close(jex.forward()[0], tex.forward()[0])
    # bind() with the same arrays: outputs equal simple_bind's
    ts = mlp(tmx)
    with tmx.cpu():
        args = {k: tmx.nd.array(v.asnumpy())
                for k, v in tex.arg_dict.items()}
        ex2 = ts.bind(tmx.cpu(), args)
    _close(jex.outputs[0], ex2.forward()[0])
    with pytest.raises(tmx.MXNetError):
        ts.bind(tmx.cpu(), {"data": args["data"]})


def test_monitor_callback_and_output_dict():
    _, tex = _bind_pair(mlp, layout="none")
    seen = []
    tex.set_monitor_callback(lambda name, arr: seen.append(
        (name, arr.shape)))
    tex.forward()
    assert seen == [("softmax_output", (4, 4))]
    assert list(tex.output_dict) == ["softmax_output"]


def _graph_outputs(sym, vals, fused):
    """Outputs, aux updates and the count of fused pairs of the port's
    training graph on `vals`; `fused=False` groups each convolution's
    output in as a graph output, which keeps it unfused."""
    if not fused:
        internals = sym.get_internals()
        convs = [internals[n] for n in internals.list_outputs()
                 if n.startswith("c") and n.endswith("_output")
                 and "_" not in n[:-len("_output")]]
        sym = tmx.sym.Group([sym] + [tmx.sym.BlockGrad(c) for c in convs])
    fn, arg_names, aux_names, _ = tgraph.build_graph_fn(sym._entries,
                                                        "train")
    import torch
    args = {n: torch.tensor(vals[n]) for n in arg_names}
    aux = {n: torch.tensor(vals[n]) for n in aux_names}
    for n in ("data",):
        args[n] = args[n].requires_grad_(True)
    outs, auxup = fn(args, aux)
    g = torch.autograd.grad(outs[0].sum() + 0 * outs[0].sum(),
                            [args["data"]])[0]
    return outs[0], auxup, fn.fused_pairs, g


def test_conv1x1_bn_rewrite_matches_the_unfused_graph():
    ts = conv_bn(tmx, "NHWC")
    jex = conv_bn(jmx, "NHWC").simple_bind(jmx.cpu(), **_shapes("cnn",
                                                                 "NHWC"))
    vals = _values(jex, np.random.RandomState(11), 3)
    y1, aux1, n1, g1 = _graph_outputs(ts, vals, fused=True)
    y0, aux0, n0, g0 = _graph_outputs(ts, vals, fused=False)
    assert (n1, n0) == (1, 0)
    np.testing.assert_allclose(y1.detach().numpy(), y0.detach().numpy(),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(g1.numpy(), g0.numpy(), rtol=TOL, atol=TOL)
    for k in aux0:
        np.testing.assert_allclose(aux1[k].numpy(), aux0[k].numpy(),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_conv1x1_bn_rewrite_runs_only_for_kernel_dtypes(dtype, monkeypatch):
    import torch
    calls = []
    real = tops.conv1x1_bn_nhwc

    def counting(*a, **kw):
        calls.append(a[0].dtype)
        return real(*a, **kw)

    monkeypatch.setattr(tops, "conv1x1_bn_nhwc", counting)
    ts = conv_bn(tmx, "NHWC")
    ex = ts.simple_bind(tmx.cpu(), type_dict={"data": dtype},
                        **_shapes("cnn", "NHWC"))
    td = getattr(torch, dtype)
    for d in (ex.arg_dict, ex.aux_dict):
        for k, v in d.items():
            d[k] = tmx.nd.NDArray(v._data.to(td))
    ex = tmx.executor.Executor(ts, tmx.cpu(), ex.arg_dict, ex.grad_dict,
                               ex._grad_req, ex.aux_dict)
    ex.forward(is_train=True)
    assert calls == ([torch.float32] if dtype == "float32" else [])
    assert ex.outputs[0].dtype == np.dtype(dtype)


def test_predict_graph_takes_no_rewrite():
    ts = conv_bn(tmx, "NHWC")
    fn = tgraph.build_graph_fn(ts._entries, "predict")[0]
    assert fn.fused_pairs == 0


def test_every_op_infers_its_structs_off_the_cpu(monkeypatch):
    """Shape inference of every op of the port's sweep table gives the
    structs of its run on the case's inputs on the CPU; only the ops `graph._CPU_STRUCT_OPS`
    names are evaluated on the CPU (the rest on meta tensors, or by the
    kernel ops' rule)."""
    import torch
    from tools import torch_op_cases as C
    reg = tops.registry
    on_cpu = []
    real = tgraph._eval_shape

    def recording(op, params, structs, on):
        if on == "cpu":
            on_cpu.append(op.name)
        return real(op, params, structs, on)

    checked = 0
    for name in reg.list_ops():
        op = reg.get(name)
        case = C.case_of(name, reg.get)
        if case is None:
            rcase = C.random_case_of(name, reg.get)
            assert rcase is not None, name
            variants = [(rcase[0](C.rng_for(name)), rcase[1], False)]
        else:
            make, vs = case[0], case[1]
            variants = []
            for v in vs:
                params, train, alt = C.split_params(v)
                variants.append(((alt or make)(C.rng_for(name)), params,
                                 train))
        for arrays, params, train in variants:
            p = reg.apply_defaults(op, dict(params))
            if op.takes_mode:
                p["_mode"] = "train" if train else "predict"
            if "out" in p:
                p["out"] = None
            ins = [tgraph.Struct(tuple(a.shape),
                                 torch.from_numpy(np.asarray(a)).dtype)
                   for a in arrays]
            monkeypatch.setattr(tgraph, "_eval_shape", recording)
            got = tgraph._op_structs(op, p, ins)
            monkeypatch.setattr(tgraph, "_eval_shape", real)
            args = [torch.from_numpy(np.array(a)) for a in arrays]
            if op.needs_rng:
                args = [torch.Generator(device="cpu")] + args
            if "ctx" in p:
                p["ctx"] = torch.device("cpu")
            with torch.no_grad():
                raw = op.fn(*args, **p)
            raw = raw if isinstance(raw, tuple) else (raw,)
            want = [tgraph.Struct(tuple(r.shape), r.dtype) for r in raw]
            assert got == want, (name, got, want)
            checked += 1
    assert set(on_cpu) == tgraph._CPU_STRUCT_OPS, set(on_cpu)
    assert checked >= len(reg.list_ops()), checked
