"""The port's fused exchange + update step (mxnet_tpu_torch/parallel/
fused_step.py) in one process, on the CPU, held to the contract of
tests/test_fused_step.py:

- fused equals the staged path (``MXTPU_FUSED_STEP=0``) bit for bit, in
  the weights and the optimizer states: SGD at momentum 0 and 0.9, with
  weight decay, with clipping and in multi-precision bf16; Adam, also in
  multi-precision bf16;
- the fused step matches the JAX package's `gluon.Trainer` over 3 steps
  from the same weights with an lr that changes, within 1e-6 of each
  tensor's largest magnitude for SGD (1e-5 for Adam);
- a non-finite gradient leaves weights and states bit-identical and
  counts one skipped step; switching the gate mid-run stays exact;
  `save_states` flushes the state flats into compact tensors; the
  launches a step are counted; ``MXTPU_ZERO1=1`` raises; `Module.update`
  takes the fused step; 2-bit compression trains through the Trainer, as
  JAX's does.
"""
import pickle

import numpy as np
import jax
from jax._src import compilation_cache
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.observability import registry
from mxnet_tpu_torch.resilience import numerics

BATCH = 4
LRS = (0.1, 0.05, 0.025, 0.0125)


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
def _fresh_verdicts():
    numerics.drain_flags()
    yield
    numerics.drain_flags()


def _weights():
    rng = np.random.RandomState(0)
    return [rng.uniform(-0.5, 0.5, (8, 5)).astype(np.float32),
            rng.uniform(-0.1, 0.1, (8,)).astype(np.float32),
            rng.uniform(-0.5, 0.5, (3, 8)).astype(np.float32),
            rng.uniform(-0.1, 0.1, (3,)).astype(np.float32)]


def _batch(step):
    rng = np.random.RandomState(10 + step)
    return (rng.randn(BATCH, 5).astype(np.float32),
            rng.randint(0, 3, BATCH).astype(np.float32))


def _port_net(dtype=None):
    net = gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(gluon.nn.Dense(8, activation="relu", in_units=5,
                               device="cpu"),
                gluon.nn.Dense(3, in_units=8, device="cpu"))
    net.initialize(ctx=mx.cpu())
    for p, w in zip(net.collect_params().values(), _weights()):
        p.set_data(torch.from_numpy(w))
    if dtype:
        net.cast(dtype)
    return net


def _port_step(net, tr, step, dtype=None, bad=False):
    x, y = _batch(step)
    if bad:
        x[0, 0] = np.nan
    x = torch.from_numpy(x)
    if dtype:
        x = x.to(getattr(torch, dtype))
    with autograd.record():
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(x),
                                                    torch.from_numpy(y))
    loss.backward()
    tr.step(BATCH)


def _params(net):
    return [p.data().detach().clone() for p in net.collect_params().values()]


def _state_tensors(tr):
    out, stack = [], [pickle.loads(tr._updaters[0].get_states())]
    while stack:
        s = stack.pop()
        if isinstance(s, dict):
            stack.extend(s[k] for k in sorted(s, reverse=True))
        elif isinstance(s, (list, tuple)):
            stack.extend(reversed(s))
        elif s is not None:
            out.append(s)
    return out


def _train(monkeypatch, opt_name, kw, fused, steps=4, dtype=None,
           kvstore="device"):
    monkeypatch.setenv("MXTPU_FUSED_STEP", "1" if fused else "0")
    net = _port_net(dtype)
    tr = gluon.Trainer(net.collect_params(), opt_name, dict(kw),
                       kvstore=kvstore)
    for s in range(steps):
        tr.set_learning_rate(LRS[s])
        _port_step(net, tr, s, dtype)
    return net, tr


CASES = {
    "sgd": ("sgd", dict(learning_rate=0.1), None),
    "sgd_momentum_wd": ("sgd", dict(learning_rate=0.1, momentum=0.9,
                                    wd=0.01), None),
    "sgd_clip": ("sgd", dict(learning_rate=0.1, momentum=0.9,
                             clip_gradient=0.05), None),
    "sgd_mp_bf16": ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-4,
                                multi_precision=True), "bfloat16"),
    "adam": ("adam", dict(learning_rate=0.01, wd=0.001), None),
    "adam_mp_bf16": ("adam", dict(learning_rate=0.01,
                                  multi_precision=True), "bfloat16"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_equals_staged_bit_for_bit(case, monkeypatch):
    name, kw, dtype = CASES[case]
    fnet, ftr = _train(monkeypatch, name, kw, True, dtype=dtype)
    assert ftr._updaters[0]._fused_step_owner is not None
    snet, str_ = _train(monkeypatch, name, kw, False, dtype=dtype)
    for a, b in zip(_params(fnet), _params(snet)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    fs, ss = _state_tensors(ftr), _state_tensors(str_)
    assert len(fs) == len(ss) > 0 or name == "sgd"
    for a, b in zip(fs, ss):
        assert a.dtype == b.dtype and torch.equal(a, b)


# Adam divides each gradient by its own running magnitude, so the ~1e-7
# absolute differences of the two packages' gradients become relative
# ones in its smallest elements (measured: 1.5e-6 of the largest weight)
@pytest.mark.parametrize("opt_name,kw,tol", [
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-4), 1e-6),
    ("adam", dict(learning_rate=0.01, wd=1e-4), 1e-5)])
def test_fused_step_matches_the_jax_trainer(opt_name, kw, tol, monkeypatch):
    monkeypatch.setenv("MXTPU_FUSED_STEP", "1")
    jnet = jgluon.nn.HybridSequential()
    with jnet.name_scope():
        jnet.add(jgluon.nn.Dense(8, activation="relu", in_units=5),
                 jgluon.nn.Dense(3, in_units=8))
    jnet.initialize()
    for p, w in zip(jnet.collect_params().values(), _weights()):
        p.set_data(jmx.nd.array(w))
    jtr = jgluon.Trainer(jnet.collect_params(), opt_name, dict(kw))
    tnet = _port_net()
    ttr = gluon.Trainer(tnet.collect_params(), opt_name, dict(kw))
    for s in range(3):
        jtr.set_learning_rate(LRS[s])
        x, y = _batch(s)
        with jmx.autograd.record():
            loss = jgluon.loss.SoftmaxCrossEntropyLoss()(
                jnet(jmx.nd.array(x)), jmx.nd.array(y))
        loss.backward()
        jtr.step(BATCH)
        ttr.set_learning_rate(LRS[s])
        _port_step(tnet, ttr, s)
    assert ttr._updaters[0]._fused_step_owner is not None
    for p, j in zip(_params(tnet), jnet.collect_params().values()):
        want = np.asarray(j.data()._data)
        err = np.abs(p.numpy() - want).max() / np.abs(want).max()
        assert err <= tol, (j.name, err)


def test_non_finite_gradient_skips_the_step_bit_identically(monkeypatch):
    monkeypatch.setenv("MXTPU_FUSED_STEP", "1")
    net = _port_net()
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       dict(learning_rate=0.1, momentum=0.9))
    _port_step(net, tr, 0)
    numerics.drain_flags()
    before = _params(net)
    states = {i: s.clone() for i, s in tr._updaters[0].states.items()}
    skipped = numerics.SKIPPED.total()
    _port_step(net, tr, 1, bad=True)
    for a, b in zip(_params(net), before):
        assert torch.equal(a, b)
    for i, s in tr._updaters[0].states.items():
        assert torch.equal(s, states[i]), i
    # one verdict (the fused step's), read at the step's boundary
    guard = tr.numerics.last_report
    assert guard["skipped_steps"] == 1 and guard["bad"] == 1
    assert numerics.SKIPPED.total() == skipped + 1
    _port_step(net, tr, 2)
    assert not any(torch.equal(a, b) for a, b in zip(_params(net), before))


@pytest.mark.parametrize("opt_name,kw", [
    ("sgd", dict(learning_rate=0.05, momentum=0.9)),
    ("adam", dict(learning_rate=0.01))])
def test_switching_the_gate_mid_run_stays_exact(opt_name, kw, monkeypatch):
    net = _port_net()
    tr = gluon.Trainer(net.collect_params(), opt_name, dict(kw))
    for s, fused in enumerate([1, 1, 0, 0, 1, 1]):
        monkeypatch.setenv("MXTPU_FUSED_STEP", str(fused))
        _port_step(net, tr, s % 4)
    ref = _port_net()
    rtr = gluon.Trainer(ref.collect_params(), opt_name, dict(kw))
    monkeypatch.setenv("MXTPU_FUSED_STEP", "0")
    for s in range(6):
        _port_step(ref, rtr, s % 4)
    for a, b in zip(_params(net), _params(ref)):
        assert torch.equal(a, b)


def test_save_states_flushes_the_state_flats(monkeypatch, tmp_path):
    net, tr = _train(monkeypatch, "sgd", dict(learning_rate=0.1,
                                              momentum=0.9), True, steps=2)
    owner = tr._updaters[0]._fused_step_owner
    moms = list(tr._updaters[0].states.values())
    assert owner._state_flats and all(
        m.untyped_storage().nbytes() > m.numel() * 4 for m in moms)
    path = str(tmp_path / "s")
    tr.save_states(path)
    assert not owner._state_flats
    moms = list(tr._updaters[0].states.values())
    assert all(m.untyped_storage().nbytes() == m.numel() * 4 for m in moms)
    # the pickle holds each key's own elements, not the flat per view
    assert len(open(path, "rb").read()) < 2 * 4 * sum(
        m.numel() for m in moms) + 20000
    twin = _port_net()
    for p, q in zip(twin.collect_params().values(),
                    net.collect_params().values()):
        p.set_data(q.data().detach())
    ttr = gluon.Trainer(twin.collect_params(), "sgd",
                        dict(learning_rate=0.1, momentum=0.9))
    ttr.load_states(path)
    for s in (2, 3):
        _port_step(net, tr, s)
        _port_step(twin, ttr, s)
    assert owner._state_flats         # carried again after the flush
    for a, b in zip(_params(net), _params(twin)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kvstore", ["device", "dist_sync"])
def test_launches_a_step_are_the_groups_at_one_process(kvstore, monkeypatch):
    """train.step.dispatches a step: no collective at one process, one
    launch per update group (here two: the biases take their own lr
    lane), fused as staged."""
    disp = registry.counter("train.step.dispatches")
    groups = registry.counter("optimizer.fused.groups")
    counts = {}
    for fused in (True, False):
        monkeypatch.setenv("MXTPU_FUSED_STEP", "1" if fused else "0")
        net = _port_net()
        for name, p in net.collect_params().items():
            if name.endswith("bias"):
                p.lr_mult = 2.0
        with mx.cpu():
            tr = gluon.Trainer(net.collect_params(), "sgd",
                               dict(learning_rate=0.1, momentum=0.9),
                               kvstore=kvstore)
            d0, g0 = disp.get(), groups.get()
            for s in range(3):
                _port_step(net, tr, s)
        counts[fused] = (disp.get() - d0, groups.get() - g0)
        if fused:
            assert tr._updaters[0]._fused_step_owner.last_dispatches == 2
    assert counts[True] == counts[False] == (6, 6)


def test_zero1_raises(monkeypatch):
    """MXTPU_ZERO1=1 no longer raises. At one process it changes nothing,
    as in JAX (ZeRO-1 needs nproc > 1): the fused step runs and equals
    the staged path bit for bit. (Across processes:
    tests/test_torch_sharded_dist.py.)"""
    monkeypatch.setenv("MXTPU_ZERO1", "1")
    finals = {}
    for fused in ("1", "0"):
        monkeypatch.setenv("MXTPU_FUSED_STEP", fused)
        net = _port_net()
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           dict(learning_rate=0.1, momentum=0.9))
        for s in range(2):
            _port_step(net, tr, s)
        finals[fused] = [p.data().clone()
                         for p in net.collect_params().values()]
        if fused == "1":
            assert tr._updaters[0]._fused_step_owner is not None
    assert all(torch.equal(a, b) for a, b in zip(finals["1"], finals["0"]))


def test_module_update_takes_the_fused_step(monkeypatch):
    def fit(fused):
        monkeypatch.setenv("MXTPU_FUSED_STEP", "1" if fused else "0")
        data = mx.sym.var("data")
        s = mx.sym.FullyConnected(data, num_hidden=8, name="fc1")
        s = mx.sym.Activation(s, act_type="relu")
        s = mx.sym.FullyConnected(s, num_hidden=4, name="fc2")
        s = mx.sym.SoftmaxOutput(s, name="softmax")
        X = np.random.RandomState(3).randn(16, 10).astype("f")
        Y = np.random.RandomState(4).randint(0, 4, (16,)).astype("f")
        it = mx.io.NDArrayIter(X, Y, batch_size=8,
                               label_name="softmax_label")
        mod = mx.mod.Module(s, data_names=("data",),
                            label_names=("softmax_label",),
                            context=mx.cpu())
        mx.random.seed(0)
        mod.fit(it, num_epoch=2, optimizer="sgd",
                initializer=mx.init.Uniform(0.1),
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
        args, _ = mod.get_params()
        return {k: v.asnumpy() for k, v in args.items()}, mod

    a, mod = fit(True)
    assert mod._updater._fused_step_owner is not None
    b, smod = fit(False)
    assert smod._updater._fused_step_owner is None
    for k in sorted(a):
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("kvstore", ["device", "dist_sync"])
def test_two_bit_compression_trains_as_jax_does(kvstore, monkeypatch):
    """One process: the 'device' store compresses each value before the
    sum, the distributed one round-trips the sum through the quantizer;
    both are staged, and match the JAX package's Trainer."""
    comp = {"type": "2bit", "threshold": 0.05}
    kw = dict(learning_rate=0.1, momentum=0.9)
    jnet = jgluon.nn.HybridSequential()
    with jnet.name_scope():
        jnet.add(jgluon.nn.Dense(8, activation="relu", in_units=5),
                 jgluon.nn.Dense(3, in_units=8))
    jnet.initialize()
    for p, w in zip(jnet.collect_params().values(), _weights()):
        p.set_data(jmx.nd.array(w))
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", dict(kw),
                         kvstore=kvstore, compression_params=comp)
    tnet = _port_net()
    with mx.cpu():
        ttr = gluon.Trainer(tnet.collect_params(), "sgd", dict(kw),
                            kvstore=kvstore, compression_params=comp)
        for s in range(3):
            x, y = _batch(s)
            with jmx.autograd.record():
                loss = jgluon.loss.SoftmaxCrossEntropyLoss()(
                    jnet(jmx.nd.array(x)), jmx.nd.array(y))
            loss.backward()
            jtr.step(BATCH)
            _port_step(tnet, ttr, s)
    assert ttr._kvstore._compression is not None
    assert ttr._updaters[0]._fused_step_owner is None     # staged
    moved = False
    for p, w0, j in zip(_params(tnet), _weights(),
                        jnet.collect_params().values()):
        want = np.asarray(j.data()._data)
        assert np.abs(p.numpy() - want).max() <= 1e-6, j.name
        moved |= not np.array_equal(p.numpy(), w0)
    assert moved
