"""Parity of the port's Module API (io.NDArrayIter, metric, callback,
model, module/) with the JAX package's, on the CPU.

Both packages' Modules bind the same symbol, start from the same
parameters (the JAX Module's initializer draws them; the port's takes
them as arg_params), and run `fit` on the same seeded batches.
Tolerances: fp32 parameters and outputs after 3 SGD steps within 1e-5
(the same ops and update; only summation order differs); metrics within
1e-6 on the same arrays; iterator batches exactly.
"""
import logging
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

TOL = 1e-5


def lenet(mx):
    with mx.name.NameManager():
        data = mx.sym.var("data")
        c1 = mx.sym.Convolution(data, kernel=(5, 5), num_filter=4)
        a1 = mx.sym.Activation(c1, act_type="tanh")
        p1 = mx.sym.Pooling(a1, pool_type="max", kernel=(2, 2),
                            stride=(2, 2))
        c2 = mx.sym.Convolution(p1, kernel=(3, 3), num_filter=6)
        a2 = mx.sym.Activation(c2, act_type="tanh")
        f = mx.sym.Flatten(a2)
        fc1 = mx.sym.FullyConnected(f, num_hidden=16)
        a3 = mx.sym.Activation(fc1, act_type="tanh")
        fc2 = mx.sym.FullyConnected(a3, num_hidden=10)
        return mx.sym.SoftmaxOutput(fc2, name="softmax")


def resnet_small(mx, layout="NHWC"):
    """A narrow ResNet V1 symbol (bottleneck units, 32 px): 1x1
    convolutions before training BatchNorms, which the port's graph runs
    on the conv1x1_bn_stats kernel (its plain version here)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    from torch_resnet_symbol import resnet_v1_symbol
    with mx.name.NameManager():
        return resnet_v1_symbol(mx, units=(1, 1), filters=(8, 16, 32),
                                num_classes=5, layout=layout)


def _data(shape, n, classes, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, *shape).astype(np.float32),
            rng.randint(0, classes, n).astype(np.float32))


def _modules(build, x, y, batch, **bind_kw):
    """(JAX Module, port Module, JAX iter, port iter), bound, the port's
    parameters the JAX Module's."""
    js, ts = build(jmx), build(tmx)
    assert ts.tojson() == js.tojson()
    ji = jmx.io.NDArrayIter(x, y, batch_size=batch)
    ti = tmx.io.NDArrayIter(x, y, batch_size=batch)
    jm = jmx.mod.Module(js, context=jmx.cpu(), logger=logging)
    tm = tmx.mod.Module(ts, context=tmx.cpu(), logger=logging)
    jm.bind(ji.provide_data, ji.provide_label, **bind_kw)
    tm.bind(ti.provide_data, ti.provide_label, **bind_kw)
    # the initial weights from a fixed key, not from wherever the tests
    # before this one left JAX's key
    jmx.random.seed(0)
    jm.init_params(jmx.init.Xavier(magnitude=2.0))
    args, auxs = jm.get_params()
    tm.init_params(arg_params={k: tmx.nd.array(v.asnumpy())
                               for k, v in args.items()},
                   aux_params={k: tmx.nd.array(v.asnumpy())
                               for k, v in auxs.items()})
    return jm, tm, ji, ti


def _params_agree(jm, tm, tol=TOL):
    ja, jx = jm.get_params()
    ta, tx = tm.get_params()
    assert sorted(ja) == sorted(ta) and sorted(jx) == sorted(tx)
    for d_j, d_t in ((ja, ta), (jx, tx)):
        for k in d_j:
            np.testing.assert_allclose(d_t[k].asnumpy(), d_j[k].asnumpy(),
                                       rtol=tol, atol=tol, err_msg=k)


SGD = dict(optimizer="sgd",
           optimizer_params=(("learning_rate", 0.1), ("momentum", 0.9),
                             ("wd", 1e-4)))


def test_three_fit_steps_agree_on_lenet():
    x, y = _data((1, 12, 12), 24, 10)
    jm, tm, ji, ti = _modules(lenet, x, y, 8)
    losses = []
    for mod, it in ((jm, ji), (tm, ti)):
        metric = (jmx if mod is jm else tmx).metric.create("ce")
        mod.fit(it, num_epoch=1, eval_metric=metric, **SGD)
        losses.append(metric.get()[1])
    np.testing.assert_allclose(losses[1], losses[0], rtol=TOL, atol=TOL)
    _params_agree(jm, tm)
    assert tm._exec_group.exec_.arg_dict["data"]._data.device.type == "cpu"


def test_resnet_symbol_steps_agree_from_a_shared_state():
    """The narrow NHWC ResNet symbol at 32 px: three steps, each from the
    JAX Module's state (parameters, BatchNorm statistics, momentum), so
    each step is held to 1e-5. Over compounding steps the two drift
    apart with the CPU's thread count: BatchNorm's backward spreads fp32
    rounding and lr 0.1 under momentum 0.9 grows it, as it parts the
    Gluon twins of chip_smoke.py)."""
    import torch
    x, y = _data((32, 32, 3), 24, 5)
    jm, tm, ji, ti = _modules(resnet_small, x, y, 8)
    for mod in (jm, tm):
        mod.init_optimizer(**SGD)
    for step, (jb, tb) in enumerate(zip(ji, ti)):
        if step:
            tm.set_params(*[{k: tmx.nd.array(v.asnumpy()) for k, v in
                             d.items()} for d in jm.get_params()])
            for i, state in jm._updater.states.items():
                with torch.no_grad():
                    tm._updater.states[i].copy_(
                        torch.from_numpy(state.asnumpy()))
        losses = []
        for mod, batch, mx in ((jm, jb, jmx), (tm, tb, tmx)):
            mod.forward_backward(batch)
            mod.update()
            metric = mx.metric.create("ce")
            mod.update_metric(metric, batch.label)
            losses.append(metric.get()[1])
        np.testing.assert_allclose(losses[1], losses[0], rtol=TOL,
                                   atol=TOL)
        _params_agree(jm, tm)
    assert step == 2


def test_score_and_predict_agree():
    x, y = _data((1, 12, 12), 20, 10, 1)
    jm, tm, ji, ti = _modules(lenet, x, y, 8)
    js, ts = jm.score(ji, ["acc", "ce"]), tm.score(ti, ["acc", "ce"])
    assert [n for n, _ in ts] == [n for n, _ in js]
    np.testing.assert_allclose([v for _, v in ts], [v for _, v in js],
                               rtol=1e-6)
    jp, tp = jm.predict(ji), tm.predict(ti)
    assert tp.shape == jp.shape == (20, 10)       # the pad dropped
    np.testing.assert_allclose(tp.asnumpy(), jp.asnumpy(), rtol=TOL,
                               atol=TOL)
    outs = [o[0].asnumpy() for o, _, _ in tm.iter_predict(ti)]
    np.testing.assert_allclose(np.concatenate(outs), tp.asnumpy())
    np.testing.assert_allclose(tm.predict(x).asnumpy(), tp.asnumpy(),
                               rtol=TOL, atol=TOL)


def test_forward_backward_update_and_input_grads():
    x, y = _data((1, 12, 12), 8, 10, 2)
    jm, tm, ji, ti = _modules(lenet, x, y, 8, inputs_need_grad=True)
    for mod in (jm, tm):
        mod.init_optimizer(**SGD)
    jb, tb = next(iter(ji)), next(iter(ti))
    for _ in range(2):
        jm.forward_backward(jb)
        jm.update()
        tm.forward_backward(tb)
        tm.update()
    np.testing.assert_allclose(tm.get_input_grads()[0].asnumpy(),
                               jm.get_input_grads()[0].asnumpy(),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tm.get_outputs()[0].asnumpy(),
                               jm.get_outputs()[0].asnumpy(), rtol=TOL,
                               atol=TOL)
    assert tm.output_shapes == jm.output_shapes
    _params_agree(jm, tm)


def test_checkpoints_cross_both_packages(tmp_path):
    x, y = _data((1, 12, 12), 16, 10, 3)
    jm, tm, ji, ti = _modules(lenet, x, y, 8)
    for mod, it in ((jm, ji), (tm, ti)):
        mod.fit(it, num_epoch=1, **SGD)
    jm.save_checkpoint(str(tmp_path / "j"), 2)
    tm.save_checkpoint(str(tmp_path / "t"), 2, save_optimizer_states=True)
    assert (tmp_path / "t-symbol.json").read_bytes() == \
        (tmp_path / "j-symbol.json").read_bytes()
    # JAX's checkpoint into the port and the port's into JAX
    tl = tmx.mod.Module.load(str(tmp_path / "j"), 2, context=tmx.cpu())
    jl = jmx.mod.Module.load(str(tmp_path / "t"), 2, context=jmx.cpu())
    for mod, it in ((tl, ti), (jl, ji)):
        mod.bind(it.provide_data, it.provide_label, for_training=False)
    np.testing.assert_allclose(tl.predict(ti).asnumpy(),
                               jm.predict(ji).asnumpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(jl.predict(ji).asnumpy(),
                               tm.predict(ti).asnumpy(), rtol=TOL, atol=TOL)
    sym, args, auxs = tmx.model.load_checkpoint(str(tmp_path / "j"), 2)
    ja, _ = jm.get_params()
    for k in ja:
        np.testing.assert_array_equal(args[k].asnumpy(), ja[k].asnumpy())
    # the port's optimizer states come back into a fresh module
    t2 = tmx.mod.Module.load(str(tmp_path / "t"), 2,
                             load_optimizer_states=True, context=tmx.cpu())
    t2.bind(ti.provide_data, ti.provide_label)
    t2.init_optimizer(**SGD)
    assert t2._updater.states.keys() == tm._updater.states.keys()


def test_do_checkpoint_callback_and_speedometer(tmp_path, caplog):
    x, y = _data((1, 12, 12), 16, 10, 4)
    _, tm, _, ti = _modules(lenet, x, y, 4)
    with caplog.at_level(logging.INFO):
        tm.fit(ti, num_epoch=2, epoch_end_callback=tmx.callback.do_checkpoint(
            str(tmp_path / "cb")), batch_end_callback=[
                tmx.callback.Speedometer(4, 2),
                tmx.callback.log_train_metric(2),
                tmx.callback.ProgressBar(4)], **SGD)
    assert (tmp_path / "cb-0001.params").exists()
    assert (tmp_path / "cb-0002.params").exists()
    assert "samples/sec" in caplog.text
    assert "Train-accuracy" in caplog.text


def _bucket_sym(mx, seq_len):
    with mx.name.NameManager():
        data = mx.sym.var("data")
        h = mx.sym.FullyConnected(data, num_hidden=6, name="fc")
        h = mx.sym.Activation(h, act_type="relu")
        h = mx.sym.FullyConnected(h, num_hidden=3, name="out")
        return (mx.sym.SoftmaxOutput(h, name="softmax"), ("data",),
                ("softmax_label",))


def test_bucketing_module_shares_parameters_across_buckets():
    rng = np.random.RandomState(5)
    params = {"fc_weight": rng.randn(6, 4), "fc_bias": rng.randn(6),
              "out_weight": rng.randn(3, 6), "out_bias": rng.randn(3)}
    res = []
    for mx in (jmx, tmx):
        mod = mx.mod.BucketingModule(lambda k: _bucket_sym(mx, k),
                                     default_bucket_key=4,
                                     context=mx.cpu())
        mod.bind([("data", (2, 4))], [("softmax_label", (2,))])
        mod.init_params(arg_params={k: mx.nd.array(v.astype(np.float32))
                                    for k, v in params.items()},
                        aux_params={})
        mod.init_optimizer(**SGD)
        for key, n in ((4, 2), (4, 3)):
            batch = mx.io.DataBatch(
                [mx.nd.array(rng.randn(n, 4).astype(np.float32))],
                [mx.nd.array(np.arange(n) % 3)], bucket_key=key,
                provide_data=[("data", (n, 4))],
                provide_label=[("softmax_label", (n,))])
            mod.forward(batch, is_train=True)
            mod.backward()
            mod.update()
        res.append({k: v.asnumpy() for k, v in mod.get_params()[0].items()})
        rng = np.random.RandomState(5)
        rng.randn(6, 4), rng.randn(6), rng.randn(3, 6), rng.randn(3)
    for k in res[0]:
        np.testing.assert_allclose(res[1][k], res[0][k], rtol=TOL, atol=TOL)


def test_sequential_module_chains_two_modules():
    res = []
    for mx in (jmx, tmx):
        with mx.name.NameManager():
            d = mx.sym.var("data")
            net1 = mx.sym.FullyConnected(d, num_hidden=5, name="fc1")
            net1 = mx.sym.Activation(net1, act_type="relu")
            d2 = mx.sym.var("data")
            net2 = mx.sym.FullyConnected(d2, num_hidden=3, name="fc2")
            net2 = mx.sym.SoftmaxOutput(net2, name="softmax")
        seq = mx.mod.SequentialModule()
        seq.add(mx.mod.Module(net1, label_names=None, context=mx.cpu()))
        seq.add(mx.mod.Module(net2, context=mx.cpu()), take_labels=True,
                auto_wiring=True)
        x, y = _data((4,), 8, 3, 6)
        it = mx.io.NDArrayIter(x, y, batch_size=4)
        rng = np.random.RandomState(8)
        seq.bind(it.provide_data, it.provide_label)
        seq.init_params(arg_params={
            "fc1_weight": mx.nd.array(rng.randn(5, 4).astype(np.float32)),
            "fc1_bias": mx.nd.zeros((5,)),
            "fc2_weight": mx.nd.array(rng.randn(3, 5).astype(np.float32)),
            "fc2_bias": mx.nd.zeros((3,))}, allow_missing=True)
        seq.init_optimizer(**SGD)
        for batch in it:
            seq.forward(batch, is_train=True)
            seq.backward()
            seq.update()
        res.append([m.get_params()[0] for m in seq._modules])
    for a, b in zip(*res):
        for k in a:
            np.testing.assert_allclose(b[k].asnumpy(), a[k].asnumpy(),
                                       rtol=TOL, atol=TOL)


def test_python_loss_module_gradient():
    for mx in (tmx,):
        mod = mx.mod.PythonLossModule(
            grad_func=lambda scores, labels: scores - labels)
        mod.bind([("data", (2, 3))], [("softmax_label", (2, 3))])
        mod.init_params()
        s = mx.nd.array(np.ones((2, 3), np.float32))
        lab = mx.nd.array(np.zeros((2, 3), np.float32))
        mod.forward(mx.io.DataBatch([s], [lab]), is_train=True)
        mod.backward()
        np.testing.assert_allclose(mod.get_input_grads()[0].asnumpy(), 1.0)


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter_batches_are_identical(handle, shuffle):
    x = np.arange(7 * 3, dtype=np.float32).reshape(7, 3)
    y = np.arange(7, dtype=np.float32)
    out = []
    for mx in (jmx, tmx):
        np.random.seed(11)
        it = mx.io.NDArrayIter({"a": x, "b": x * 2}, {"lab": y},
                               batch_size=3, shuffle=shuffle,
                               last_batch_handle=handle)
        batches = []
        for _ in range(2):
            for b in it:
                batches.append(([d.asnumpy() for d in b.data],
                                [lb.asnumpy() for lb in b.label], b.pad))
            it.reset()
        out.append((batches, [(d.name, d.shape) for d in it.provide_data],
                    [(d.name, d.shape) for d in it.provide_label]))
    (jb, jd, jl), (tb, td, tl) = out
    assert (td, tl) == (jd, jl)
    assert len(tb) == len(jb)
    for (a_d, a_l, a_p), (b_d, b_l, b_p) in zip(jb, tb):
        assert a_p == b_p
        for u, v in zip(a_d + a_l, b_d + b_l):
            np.testing.assert_array_equal(v, u)


def test_ndarray_iter_batches_are_host_arrays():
    it = tmx.io.NDArrayIter(np.zeros((4, 2), np.float32), batch_size=2)
    batch = next(it)
    assert batch.data[0].context == tmx.cpu()
    assert it.provide_data[0].shape == (2, 2)
    resized = tmx.io.ResizeIter(it, 5)
    assert sum(1 for _ in resized) == 5


def _metric_inputs(seed):
    rng = np.random.RandomState(seed)
    probs = rng.rand(6, 4).astype(np.float32)
    probs /= probs.sum(axis=1, keepdims=True)
    cls = rng.randint(0, 4, 6).astype(np.float32)
    binary = rng.rand(6, 2).astype(np.float32)
    binary /= binary.sum(axis=1, keepdims=True)
    bin_lab = rng.randint(0, 2, 6).astype(np.float32)
    reg = rng.randn(6, 1).astype(np.float32)
    reg_lab = rng.randn(6, 1).astype(np.float32)
    return probs, cls, binary, bin_lab, reg, reg_lab


METRICS = [
    ("acc", {}, "cls"), ("top_k_accuracy", {"top_k": 2}, "cls"),
    ("f1", {}, "bin"), ("perplexity", {"ignore_label": None}, "cls"),
    ("mae", {}, "reg"), ("mse", {}, "reg"), ("rmse", {}, "reg"),
    ("ce", {}, "cls"), ("nll_loss", {}, "cls"), ("pearsonr", {}, "reg"),
    ("loss", {}, "reg"), ("Torch", {}, "reg"), ("Caffe", {}, "reg"),
]


@pytest.mark.parametrize("name,kwargs,kind", METRICS,
                         ids=[m[0] for m in METRICS])
def test_metric_agrees(name, kwargs, kind):
    vals = []
    for mx in (jmx, tmx):
        m = getattr(mx.metric, name)(**kwargs) if name[0].isupper() \
            else mx.metric.create(name, **kwargs)
        for seed in (0, 1):
            probs, cls, binary, bin_lab, reg, reg_lab = _metric_inputs(seed)
            pred, lab = {"cls": (probs, cls), "bin": (binary, bin_lab),
                         "reg": (reg, reg_lab)}[kind]
            m.update([mx.nd.array(lab)], [mx.nd.array(pred)])
        vals.append(m.get())
    assert vals[1][0] == vals[0][0]
    np.testing.assert_allclose(vals[1][1], vals[0][1], rtol=1e-6)


def test_composite_and_custom_metrics_agree():
    vals = []
    for mx in (jmx, tmx):
        comp = mx.metric.create(["acc", "ce", mx.metric.np(
            lambda label, pred: float(np.abs(label - pred.argmax(1)).sum()),
            name="custom")])
        probs, cls = _metric_inputs(2)[:2]
        comp.update_dict({"softmax_label": mx.nd.array(cls)},
                         {"softmax_output": mx.nd.array(probs)})
        vals.append(comp.get_name_value())
        assert isinstance(comp, mx.metric.CompositeEvalMetric)
        assert comp.get_metric(0).get_config()["metric"] == "Accuracy"
    assert [n for n, _ in vals[1]] == [n for n, _ in vals[0]]
    np.testing.assert_allclose([v for _, v in vals[1]],
                               [v for _, v in vals[0]], rtol=1e-6)


def test_module_binds_a_graph_that_gluon_exported(tmp_path):
    """A graph HybridBlock.export wrote binds in a Module: its variables'
    __init__ declarations ("zeros" for Dense's bias) win over the
    initializer, and the exported parameters predict as the block does."""
    with tmx.name.NameManager():
        net = tmx.gluon.nn.Dense(3, in_units=4)
    net.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    net.collect_params()["dense0_bias"].set_data(tmx.nd.ones((3,)))
    net.hybridize()
    x = tmx.nd.array(np.random.RandomState(9).randn(2, 4).astype(
        np.float32))
    want = net(x).asnumpy()
    net.export(str(tmp_path / "d"))
    sym, args, auxs = tmx.model.load_checkpoint(str(tmp_path / "d"), 0)
    assert sym.attr_dict()["dense0_bias"]["__init__"] == "zeros"
    mod = tmx.mod.Module(sym, label_names=None, context=tmx.cpu())
    mod.bind([("data", (2, 4))], for_training=False)
    mod.init_params(tmx.init.Uniform(1.0))
    got = mod.get_params()[0]
    assert not got["dense0_bias"].asnumpy().any()
    assert got["dense0_weight"].asnumpy().any()
    mod.set_params(args, auxs)
    mod.forward(tmx.io.DataBatch([x]), is_train=False)
    np.testing.assert_array_equal(mod.get_outputs()[0].asnumpy(), want)
