"""ResNet-50 v1 at 224 px against the JAX package (ROADMAP C2): one
Module step, batch 2, from the same weights in both packages, on the CPU.

The net is the model zoo's resnet50_v1 (NHWC) traced to a Symbol with a
SoftmaxOutput head, bound by each package's Module (fp32) and executor
(float64).

The reference is the JAX package's own step in float64: jax's x64 mode
on, and the float32 that the JAX package's nn ops cast to (its training
BatchNorm takes single-pass statistics in float32) taken as float64,
both for this test only. Against it:

- the port's float64 step: the loss within 1e-12 relative, and every
  gradient tensor within 1e-10 of its largest magnitude (plus 1e-12
  absolute: the 32 conv biases before a BatchNorm have a gradient of 0,
  and both packages leave ~1e-14 there);
- the fp32 losses of both packages' Modules within 1e-4 relative;
- the port's fp32 Module gradients: fp32 rounding through ~50
  BatchNorms over as few as 98 values a channel (stage 4) and their
  ReLUs moves a gradient tensor by percents of its largest magnitude.
  The port's departure from the reference (the largest difference over
  the tensor's largest magnitude), median over the tensors, must be no
  more than the JAX package's fp32 Module's, and on each tensor no more
  than the largest the JAX package's fp32 Module shows on any tensor.
  The one part of the port's fp32 step that its float64 step does not
  run, the executor's conv1x1+BN rewrite, is held to the unfused graph
  within 1e-5 by tests/test_torch_executor.py.

The Gluon twins' yardstick (each fp32 gradient within twice the JAX
package's own departure between its Module step and its eager Gluon
step, plus 1e-4) is printed, not held: the JAX package's two fp32 paths
share XLA's kernels and their rounding, so they agree with each other
(median 0.025) far better than either agrees with float64 (0.043 and
0.047), and the port, closer to float64 than both (0.023), falls outside
it on 58 of the 193 tensors. The JAX package's float64 step with its
float32 statistics kept departs from the reference about as far as its
fp32 step (asserted: at least half as far, median over the tensors):
the float32 single-pass statistics are where the fp32 departure comes
from.
Marked slow: it runs full ResNet-50 steps on the CPU in both packages.
"""
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_symbolic_parity import (  # noqa: E402,F401
    no_persistent_compile_cache, restore_shared_state)

pytestmark = [pytest.mark.slow,
              pytest.mark.usefixtures("restore_shared_state")]

BATCH, IMG = 2, 224


def _module_step(mx, sym, x, y, args, auxs):
    mod = mx.mod.Module(sym, context=mx.cpu())
    mod.bind([("data", x.shape)], [("softmax_label", y.shape)])
    mod.init_params(arg_params={k: mx.nd.array(v) for k, v in args.items()},
                    aux_params={k: mx.nd.array(v) for k, v in auxs.items()})
    batch = mx.io.DataBatch([mx.nd.array(x)], [mx.nd.array(y)])
    mod.forward_backward(batch)
    p = mod.get_outputs()[0].asnumpy()
    loss = float(-np.log(p[np.arange(len(y)), y.astype(int)]).mean())
    grads = {k: v.asnumpy() for k, v in
             mod._exec_group.exec_.grad_dict.items() if k in args}
    return loss, grads


def _float64_step(sym, x, y, args, auxs):
    """The port's executor in float64 on the same values (its training
    BatchNorm keeps float64 statistics for float64 input)."""
    names = sym.list_arguments()
    ex = sym.simple_bind(tmx.cpu(), grad_req={
        n: "write" if n in args else "null" for n in names},
        data=x.shape, softmax_label=y.shape)
    for n in names:
        v = x if n == "data" else y if n == "softmax_label" else args[n]
        ex.arg_dict[n]._data = torch.from_numpy(np.asarray(v, np.float64))
        if n in ex.grad_dict:
            ex.grad_dict[n]._data = torch.zeros(v.shape, dtype=torch.float64)
    for n, v in auxs.items():
        ex.aux_dict[n]._data = torch.from_numpy(v.astype(np.float64))
    p = ex.forward(is_train=True)[0].asnumpy()
    ex.backward()
    loss = float(-np.log(p[np.arange(len(y)), y.astype(int)]).mean())
    return loss, {k: ex.grad_dict[k].asnumpy() for k in args}


@pytest.fixture
def jax_x64():
    """jax's x64 mode on for the test, restored after it."""
    import jax
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", was)


def _float64_statistics(monkeypatch):
    """Take `mxnet_tpu.ops.nn`'s float32 casts (its training BatchNorm's
    statistics) as float64 until the test ends."""
    import types

    import jax.numpy as jnp
    import mxnet_tpu.ops.nn as jnn

    class _Float64(types.ModuleType):
        float32 = jnp.float64

        def __getattr__(self, name):
            return getattr(jnp, name)

    monkeypatch.setattr(jnn, "jnp", _Float64("jax.numpy"))


def _jax_float64_step(sym, x, y, args, auxs):
    """The JAX package's executor in float64 on the same values."""
    names = sym.list_arguments()
    f64 = {n: np.asarray(x if n == "data" else y if n == "softmax_label"
                         else args[n], np.float64) for n in names}
    ex = sym.bind(jmx.cpu(), args={
        n: jmx.nd.array(v, dtype="float64") for n, v in f64.items()},
        grad_req={n: "write" if n in args else "null" for n in names},
        aux_states={n: jmx.nd.array(v.astype(np.float64), dtype="float64")
                    for n, v in auxs.items()})
    p = ex.forward(is_train=True)[0].asnumpy()
    ex.backward()
    assert p.dtype == np.float64
    loss = float(-np.log(p[np.arange(len(y)), y.astype(int)]).mean())
    return loss, {k: ex.grad_dict[k].asnumpy() for k in args}


def test_one_module_step_agrees_with_jax_at_224px(request, monkeypatch):
    rng = np.random.RandomState(0)
    x = rng.randn(BATCH, IMG, IMG, 3).astype(np.float32)
    y = rng.randint(0, 1000, BATCH).astype(np.float32)
    with jmx.name.NameManager():
        net = jmx.gluon.model_zoo.vision.resnet50_v1(classes=1000,
                                                     layout="NHWC")
        net.initialize(jmx.init.Xavier(rnd_type="gaussian",
                                       factor_type="in", magnitude=2))
        net(jmx.nd.array(x))                       # finish deferred init
    with tmx.name.NameManager():
        tnet = tmx.gluon.model_zoo.vision.resnet50_v1(
            classes=1000, layout="NHWC", device="cpu")
        tsym = tmx.sym.SoftmaxOutput(tnet(tmx.sym.var("data")),
                                     name="softmax")
    # the JAX Module binds the port's graph file: the JAX net's own trace
    # carries the unknown (0) dims of its deferred parameters in the
    # variables' __shape__ attributes, which its simple_bind takes as
    # given; the port's carry the full shapes (the graphs are otherwise
    # the same, node for node)
    jsym = jmx.sym.load_json(tsym.tojson())
    params = {k: p.data().asnumpy() for k, p in
              net.collect_params().items()}
    aux_names = set(jsym.list_auxiliary_states())
    args = {k: v for k, v in params.items() if k not in aux_names}
    auxs = {k: v for k, v in params.items() if k in aux_names}
    assert sorted(args) == sorted(
        k for k, p in net.collect_params().items() if p.grad_req != "null")
    assert {v.dtype for v in params.values()} == {np.dtype(np.float32)}

    jloss, jgrads = _module_step(jmx, jsym, x, y, args, auxs)
    tloss, tgrads = _module_step(tmx, tsym, x, y, args, auxs)
    tloss64, t64 = _float64_step(tsym, x, y, args, auxs)
    # the JAX package's eager Gluon step from the same weights
    loss_fn = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    with jmx.autograd.record():
        eloss = loss_fn(net(jmx.nd.array(x)), jmx.nd.array(y))
    eloss.backward()
    egrads = {k: p.grad().asnumpy() for k, p in net.collect_params().items()
              if p.grad_req != "null"}
    request.getfixturevalue("jax_x64")
    _, kept = _jax_float64_step(jsym, x, y, args, auxs)
    _float64_statistics(monkeypatch)
    loss64, g64 = _jax_float64_step(jsym, x, y, args, auxs)

    # float64: the port's step is the JAX package's
    assert abs(tloss64 - loss64) <= 1e-12 * abs(loss64), (tloss64, loss64)
    for k in args:
        assert np.abs(t64[k] - g64[k]).max() <= \
            1e-10 * np.abs(g64[k]).max() + 1e-12, k
    # the tensors whose gradient is not 0 (the conv biases before a
    # BatchNorm have none: rounding leaves noise there in both packages)
    live = [k for k in args if np.abs(g64[k]).max() > 1e-8]
    f64_err = max(np.abs(t64[k] - g64[k]).max() / np.abs(g64[k]).max()
                  for k in live)
    # fp32
    assert abs(tloss - jloss) <= 1e-4 * abs(jloss), (tloss, jloss)
    assert abs(tloss - loss64) <= 1e-4 * abs(loss64), (tloss, loss64)

    def departure(g, k):
        return np.abs(g[k] - g64[k]).max() / np.abs(g64[k]).max()

    port = {k: departure(tgrads, k) for k in live}
    jax_ = {k: departure(jgrads, k) for k in live}
    eager = {k: departure(egrads, k) for k in live}
    # the JAX package's float64 step with its float32 statistics kept
    stats32 = {k: departure(kept, k) for k in live}
    twins = sum(np.abs(tgrads[k] - jgrads[k]).max() >
                2 * np.abs(jgrads[k] - egrads[k]).max() + 1e-4
                for k in args)
    print("C2: loss port %r jax %r float64 %r (port float64 %r); float64 "
          "gradients: largest error %.3g; fp32 departures from float64 "
          "over %d tensors, median/max: port %.4f/%.4f, jax Module "
          "%.4f/%.4f, jax eager %.4f/%.4f, jax float64 with float32 "
          "statistics %.4f/%.4f; outside 2x JAX's Module-vs-eager "
          "departure + 1e-4: %d of %d"
          % (tloss, jloss, loss64, tloss64, f64_err,
             len(live), np.median(list(port.values())),
             max(port.values()), np.median(list(jax_.values())),
             max(jax_.values()), np.median(list(eager.values())),
             max(eager.values()), np.median(list(stats32.values())),
             max(stats32.values()), twins, len(args)))
    assert len(live) == len(args) - 32, len(live)
    # the float32 statistics alone move the JAX package's float64 step
    # as far as its fp32 step departs: that is the fp32 departure's source
    assert np.median(list(stats32.values())) >= \
        0.5 * np.median(list(jax_.values()))
    assert np.median(list(port.values())) <= np.median(list(jax_.values()))
    worst = max(jax_.values())
    assert all(v <= worst for v in port.values()), \
        {k: v for k, v in port.items() if v > worst}
