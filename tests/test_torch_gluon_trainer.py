"""Parity of the PyTorch port's Gluon training loop with the JAX package's,
on the CPU: ``with autograd.record(): loss = L(net(x), y)``,
``loss.backward()``, ``trainer.step(batch)``, as
example/gluon/train_cifar10.py:62-80 writes it.

A small NHWC JAX ResNetV1 (BottleneckV1, [1, 1], [16, 32, 64], 10
classes; hybridized, which computes what the eager net does in one
program) gives its Xavier weights to a port net, and both train 3 steps
of SGD (momentum 0.9, wd 1e-4, lr 0.1 halved every step by a
FactorScheduler) on the same numpy batch, through each package's
`gluon.Trainer`. Per step the losses, and after it the parameters,
momenta and BatchNorm running statistics agree in fp32 within TOL. On
the CPU the port's update runs the plain version of the
`fused_sgd_momentum` kernel's MXNet form, through the same plans the
card runs.

Then the Trainer's options (kvstore None / 'device' / update on the
kvstore, ignore_stale_grad, allreduce_grads + update, set_learning_rate,
save_states / load_states), the numerics guard, every way a parameter's
tensor can change under a built update plan (each held to what the JAX
package does next), bf16 multi-precision against JAX's own bf16, and
`initialize`: the initializers, which draw from other generators than
JAX's, held by distribution.
"""
import numpy as np
import jax
from jax._src import compilation_cache
import jax.numpy as jnp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError, autograd, gluon
from mxnet_tpu_torch.convert import gluon_params_from_jax
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.observability import registry
from mxnet_tpu_torch.ops import sgd_momentum
from mxnet_tpu_torch.parallel import FusedUpdater
from mxnet_tpu_torch.resilience import numerics

BATCH = 8
# fp32 on both sides; convolutions and sums run in other orders, and the
# differences grow a little through 3 updates (measured: loss 2.4e-6,
# parameters 4.3e-7, momenta 1.1e-7 after 3 steps)
TOL = dict(loss=2e-5, param=1e-5, momentum=1e-5, aux=1e-5)
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


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


def _small_jax():
    return jresnet.ResNetV1(jresnet.BottleneckV1, [1, 1], [16, 32, 64],
                            classes=10, layout="NHWC")


@pytest.fixture(scope="module")
def setup():
    """(JAX net, its initial weights by port name, x, y). The JAX net is
    hybridized once and given its initial weights again by `_jax_net`."""
    np.random.seed(4)
    mx.random.seed(4)
    jnet = _small_jax()
    jnet.initialize(mx.init.Xavier(magnitude=2))
    jnet.infer_shape(mx.nd.zeros((1, 32, 32, 3)))
    for p in jnet.collect_params().values():
        p._finish_deferred_init()
    jnet.hybridize()
    init = {k.split("_", 1)[1]: np.asarray(v.data()._data)
            for k, v in jnet.collect_params().items()}
    rng = np.random.RandomState(5)
    x = rng.randn(BATCH, 32, 32, 3).astype(np.float32)
    y = (np.arange(BATCH) % 10).astype(np.float32)
    return jnet, init, x, y


def _jax_net(setup):
    jnet, init, _, _ = setup
    for k, p in jnet.collect_params().items():
        p.set_data(mx.nd.array(init[k.split("_", 1)[1]]))
        p.zero_grad()
    return jnet


def _port_net(setup, dtype=None):
    _, init, _, _ = setup
    net = vision.ResNetV1(vision.BottleneckV1, [1, 1], [16, 32, 64],
                          classes=10, layout="NHWC", device="cpu")
    net.load_parameters(gluon_params_from_jax(init, "cpu", "NHWC",
                                              prefix=""))
    if dtype:
        net.cast(dtype)
    return net


def _jax_step(net, trainer, x, y, n=BATCH):
    loss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
    with mx.autograd.record():
        loss = loss_fn(net(mx.nd.array(x)), mx.nd.array(y))
    loss.backward()
    trainer.step(n)
    return loss.asnumpy()


def _port_step(net, trainer, x, y, n=BATCH):
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    with autograd.record():
        loss = loss_fn(net(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    trainer.step(n)
    return loss.asnumpy()


def _updater(trainer):
    kv = trainer._kvstore
    if kv is not None and trainer._update_via_kv:
        return kv._updater
    return trainer._updaters[0]


def _port_layout(arr):
    arr = np.asarray(arr, np.float32)
    return arr.transpose(0, 3, 1, 2) if arr.ndim == 4 else arr


def _errs(jnet, jtr, tnet, ttr):
    """Max abs differences of parameters, momenta and running statistics
    (port against JAX)."""
    tp = tnet.collect_params()
    out = dict(param=0.0, momentum=0.0, aux=0.0)
    jstates, tstates = _updater(jtr).states, _updater(ttr).states
    for i, (k, p) in enumerate(jnet.collect_params().items()):
        name = k.split("_", 1)[1]
        got = tp[tnet.prefix + name].data().detach().float().numpy()
        want = _port_layout(p.data()._data.astype(jnp.float32))
        kind = "aux" if "_running_" in name else "param"
        out[kind] = max(out[kind], float(np.abs(got - want).max()))
        if i in jstates and jstates[i] is not None:
            js, ts = jstates[i], tstates[i]
            if isinstance(js, tuple):
                js, ts = js[1], ts[1]
            err = np.abs(ts.float().numpy()
                         - _port_layout(js._data.astype(jnp.float32))).max()
            out["momentum"] = max(out["momentum"], float(err))
    return out


def _trainers(setup, kvstore="device", update_on_kvstore=None, **extra):
    jnet, tnet = _jax_net(setup), _port_net(setup)
    jsch = mx.lr_scheduler.FactorScheduler(step=1, factor=0.5)
    tsch = tmx.lr_scheduler.FactorScheduler(step=1, factor=0.5)
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd",
                         dict(OPT, lr_scheduler=jsch, **extra), kvstore,
                         update_on_kvstore=update_on_kvstore)
    ttr = gluon.Trainer(tnet.collect_params(), "sgd",
                        dict(OPT, lr_scheduler=tsch, **extra), kvstore,
                        update_on_kvstore=update_on_kvstore)
    return jnet, jtr, tnet, ttr


def _check(jnet, jtr, tnet, ttr, step=None):
    for kind, err in _errs(jnet, jtr, tnet, ttr).items():
        assert err < TOL[kind], (step, kind, err)


@pytest.mark.parametrize("kv", ["none", "device", "device_update_on_kvstore"])
def test_three_steps_match_the_jax_trainer(setup, kv):
    kvstore = None if kv == "none" else "device"
    jnet, jtr, tnet, ttr = _trainers(setup, kvstore,
                                     kv == "device_update_on_kvstore")
    _, _, x, y = setup
    lrs = []
    skipped = numerics.SKIPPED.total()
    for step in range(3):
        want = _jax_step(jnet, jtr, x, y)
        got = _port_step(tnet, ttr, x, y)
        assert np.abs(got - want).max() < TOL["loss"], step
        _check(jnet, jtr, tnet, ttr, step)
        lrs.append(ttr.learning_rate)
        assert ttr.learning_rate == jtr.learning_rate
    assert lrs == [0.1, 0.05, 0.025]     # lr changes every step
    # the trainer's guard read each step's verdicts at its boundary
    assert ttr.numerics.last_report == {"step": 2, "bad": 0, "anomalies": 0,
                                        "skipped_steps": 0, "sdc": None}
    assert numerics.pending_flags() == 0
    assert numerics.SKIPPED.total() == skipped


def test_ignore_stale_grad_updates_only_fresh_parameters(setup):
    """After a full step, a backward through the output layer alone
    leaves every other gradient stale: step(ignore_stale_grad=True)
    updates the output layer only, on both sides."""
    jnet, jtr, tnet, ttr = _trainers(setup)
    _, _, x, y = setup
    _jax_step(jnet, jtr, x, y)
    _port_step(tnet, ttr, x, y)
    feat = np.random.RandomState(9).randn(BATCH, 64).astype(np.float32)
    with mx.autograd.record():
        jl = jgluon.loss.SoftmaxCrossEntropyLoss()(
            jnet.output(mx.nd.array(feat)), mx.nd.array(y))
    jl.backward()
    jtr.step(BATCH, ignore_stale_grad=True)
    before = {k: p.data().clone() for k, p in tnet.collect_params().items()}
    with autograd.record():
        tl = gluon.loss.SoftmaxCrossEntropyLoss()(
            tnet.output(torch.from_numpy(feat)), torch.from_numpy(y))
    tl.backward()
    ttr.step(BATCH, ignore_stale_grad=True)
    for k, p in tnet.collect_params().items():
        moved = not torch.equal(p.data(), before[k])
        assert moved == k[len(tnet.prefix):].startswith("dense0_"), k
    _check(jnet, jtr, tnet, ttr)


def test_allreduce_grads_then_update_matches_the_jax_trainer(setup):
    jnet, jtr, tnet, ttr = _trainers(setup)
    _, _, x, y = setup
    for trainer, net, pkg, loss_fn, conv in (
            (jtr, jnet, mx.autograd, jgluon.loss.SoftmaxCrossEntropyLoss(),
             mx.nd.array),
            (ttr, tnet, autograd, gluon.loss.SoftmaxCrossEntropyLoss(),
             torch.from_numpy)):
        for _ in range(2):
            with pkg.record():
                loss = loss_fn(net(conv(x)), conv(y))
            loss.backward()
            trainer.allreduce_grads()
            trainer.update(BATCH)
    _check(jnet, jtr, tnet, ttr)


def test_set_learning_rate_between_steps_matches_jax(setup):
    jnet, tnet = _jax_net(setup), _port_net(setup)
    jtr = jgluon.Trainer(jnet.collect_params(), "sgd", dict(OPT))
    ttr = gluon.Trainer(tnet.collect_params(), "sgd", dict(OPT))
    _, _, x, y = setup
    for lr in (0.1, 0.02, 0.3):
        jtr.set_learning_rate(lr)
        ttr.set_learning_rate(lr)
        assert ttr.learning_rate == lr
        _jax_step(jnet, jtr, x, y)
        _port_step(tnet, ttr, x, y)
    _check(jnet, jtr, tnet, ttr)
    sched = gluon.Trainer(tnet.collect_params(), "sgd", dict(
        OPT, lr_scheduler=tmx.lr_scheduler.FactorScheduler(step=1)))
    with pytest.raises(MXNetError, match="lr_scheduler"):
        sched.set_learning_rate(0.5)


@pytest.mark.parametrize("update_on_kvstore", [False, True])
def test_save_and_load_states_continue_identically(setup, tmp_path,
                                                   update_on_kvstore):
    """Two steps, save; then the same trainer and a new one (over another
    net with the same weights) each load the states and take a step:
    both match a third trainer that never stopped. With
    update_on_kvstore the states are the kvstore's updater's, saved and
    loaded through it; the weights live in the store there, which
    set_data does not reach (as in the JAX package), so only the new
    trainer comes back."""
    _, _, x, y = setup
    runs = []
    for _ in range(3):
        net = _port_net(setup)
        runs.append((net, gluon.Trainer(
            net.collect_params(), "sgd", dict(
                OPT, lr_scheduler=tmx.lr_scheduler.FactorScheduler(step=1)),
            update_on_kvstore=update_on_kvstore)))
    for net, tr in runs:
        for _ in range(2):
            _port_step(net, tr, x, y)
    path = str(tmp_path / "trainer.states")
    runs[0][1].save_states(path)
    if update_on_kvstore:
        restored = runs[1:2]
    else:
        # the first trainer goes on, then comes back to the saved states
        restored = runs[:2]
        saved = {k: p.data().clone()
                 for k, p in runs[0][0].collect_params().items()}
        _port_step(*runs[0], x, y)
        for k, p in runs[0][0].collect_params().items():
            p.set_data(saved[k])
        runs[0][1].load_states(path)
    runs[1][1].load_states(path)
    assert runs[1][1].optimizer.num_update == 2
    for net, tr in restored + runs[2:]:
        _port_step(net, tr, x, y)
    want = list(runs[2][0].collect_params().values())
    for net, tr in restored:
        # three nets, three top-level prefixes: compared in Gluon's order
        for (k, p), w in zip(net.collect_params().items(), want):
            assert k[len(net.prefix):] == w.name[len(runs[2][0].prefix):]
            assert torch.equal(p.data(), w.data()), k
        assert tr.learning_rate == runs[2][1].learning_rate


def test_non_finite_gradient_skips_the_update_bit_identically(setup):
    _, _, x, y = setup
    net = _port_net(setup)
    tr = gluon.Trainer(net.collect_params(), "sgd", dict(OPT))
    _port_step(net, tr, x, y)
    numerics.drain_flags()
    params = {k: p.data().clone() for k, p in net.collect_params().items()
              if "_running_" not in k}
    states = {i: s.clone() for i, s in _updater(tr).states.items()}
    bad = x.copy()
    bad[0, 0, 0, 0] = np.nan
    skipped = numerics.SKIPPED.total()
    assert not np.isfinite(_port_step(net, tr, bad, y)).all()
    for k, v in params.items():
        assert torch.equal(net.collect_params()[k].data(), v), k
    for i, s in states.items():
        assert torch.equal(_updater(tr).states[i], s), i
    # the trainer's guard resolved the verdict at the step's boundary
    guard = tr.numerics.last_report
    assert guard["skipped_steps"] == 1 and guard["anomalies"] == 1
    assert numerics.SKIPPED.total() == skipped + 1
    assert np.isfinite(_port_step(net, tr, x, y)).all()


def _change_set_data(pkg, net, step_fn):
    """Each parameter's tensor written in place with new values."""
    for k, p in net.collect_params().items():
        if "_running_" in k:
            continue
        if pkg == "jax":
            p.set_data(p.data() * 0.5)
        else:
            p.set_data(p.data().detach() * 0.5)


def _change_cast(pkg, net, step_fn):
    """A cast to bf16 and back: new tensors, rounded to bf16."""
    net.cast("bfloat16")
    net.cast("float32")


def _change_force_reinit(pkg, net, step_fn):
    init = mx.init.Constant(0.01) if pkg == "jax" \
        else tmx.init.Constant(0.01)
    net.collect_params().initialize(init, force_reinit=True)


def _change_load_parameters(pkg, net, step_fn):
    """Other weights (half the current ones), loaded by name."""
    if pkg == "jax":
        for p in net.collect_params().values():
            p.set_data(p.data() * 0.5)
    else:
        net.load_parameters({k[len(net.prefix):]: p.data().detach() * 0.5
                             for k, p in net.collect_params().items()})


CHANGES = {"set_data": _change_set_data, "cast": _change_cast,
           "force_reinit": _change_force_reinit,
           "load_parameters": _change_load_parameters}


@pytest.mark.parametrize("change", sorted(CHANGES) + ["load_states",
                                                       "set_states"])
def test_update_plan_follows_every_change_of_its_tensors(setup, change,
                                                         tmp_path):
    """A step builds the SGD group's plan; then the parameters' tensors
    or the optimizer states change under it, and the next step must see
    the change as the JAX trainer does (on the CPU a stale plan would
    update the old tensors). load_states / set_states bring back states
    saved after the first step."""
    jnet, jtr, tnet, ttr = _trainers(setup)
    _, _, x, y = setup
    _jax_step(jnet, jtr, x, y)
    _port_step(tnet, ttr, x, y)
    path = str(tmp_path / "s")
    jtr.save_states(path)
    blob = ttr._updaters[0].get_states(dump_optimizer=True)
    ttr.save_states(path + ".port")
    _jax_step(jnet, jtr, x, y)
    _port_step(tnet, ttr, x, y)
    if change in CHANGES:
        CHANGES[change]("jax", jnet, _jax_step)
        CHANGES[change]("port", tnet, _port_step)
        if change == "cast":
            # bf16 rounding turns 1e-7 differences into a bf16 ulp (1e-3):
            # the port's new tensors take JAX's values, in place
            tnet.load_parameters(gluon_params_from_jax(
                {k: np.asarray(p.data()._data)
                 for k, p in jnet.collect_params().items()}, "cpu", "NHWC"))
    elif change == "load_states":
        jtr.load_states(path)
        ttr.load_states(path + ".port")
    else:
        jtr.load_states(path)
        ttr._updaters[0].set_states(blob)
        ttr._optimizer = ttr._updaters[0].optimizer
        ttr._optimizer.param_dict = dict(enumerate(ttr._params))
    _jax_step(jnet, jtr, x, y)
    _port_step(tnet, ttr, x, y)
    _check(jnet, jtr, tnet, ttr, change)


def test_one_plan_and_one_group_per_step_for_the_whole_net(setup,
                                                           monkeypatch):
    """Every parameter of the net takes the same lane: one SGD group, so
    one plan, built at the first step and called at every step."""
    built, calls = [], []

    class CountingPlan(sgd_momentum.SGDMomentumPlan):
        def __init__(self, *args, **kwargs):
            built.append(kwargs.get("form"))
            super().__init__(*args, **kwargs)

        def __call__(self, gs, *args, **kwargs):
            calls.append(len(gs))
            return super().__call__(gs, *args, **kwargs)

    monkeypatch.setattr(sgd_momentum, "SGDMomentumPlan", CountingPlan)
    _, _, x, y = setup
    net = _port_net(setup)
    tr = gluon.Trainer(net.collect_params(), "sgd", dict(OPT))
    groups = registry.counter("optimizer.fused.groups")
    before = groups.get()
    for _ in range(3):
        _port_step(net, tr, x, y)
    n = sum(p.grad_req != "null" for p in net.collect_params().values())
    assert built == ["mxnet"] and calls == [n] * 3 and n == 33
    assert groups.get() - before == 3


class _RecordingPlan:
    """Stands in for `SGDMomentumPlan`: records what it was built over and
    each call's gradients, and updates nothing (the tensors may be meta
    tensors, which stand for tensors on a card)."""

    built, calls = [], []

    def __init__(self, ws, vs, form="m", weights=None):
        assert form == "mxnet"
        self.built.append((len(ws), vs is not None, weights is not None,
                           ws[0].device.type))

    def __call__(self, gs, lr, momentum=0.9, wd=0.0, rescale=1.0, clip=None,
                 ok=None):
        self.calls.append((len(gs), lr, clip))


def _one_parameter_trainer(monkeypatch, setup):
    net = gluon.nn.Dense(3, in_units=4, device="cpu")
    net.initialize(tmx.init.Xavier())
    params = net.collect_params(".*weight")
    assert len(params) == 1
    tr = gluon.Trainer(params, "sgd", dict(OPT))
    x = torch.randn(2, 4, generator=torch.Generator().manual_seed(0))
    for _ in range(2):
        with autograd.record():
            loss = (net(x) ** 2).sum()
        autograd.backward(loss)
        tr.step(2)
    return [(1, True, False, "cpu")], [(1, 0.1, None)] * 2


def _whole_net_with_fused_update_off(monkeypatch, setup):
    monkeypatch.setenv("MXTPU_FUSED_UPDATE", "0")
    _, _, x, y = setup
    net = _port_net(setup)
    tr = gluon.Trainer(net.collect_params(), "sgd", dict(OPT))
    for _ in range(2):
        _port_step(net, tr, x, y)
    return [(33, True, False, "cpu")], [(33, 0.1, None)] * 2


def _per_key_off_the_cpu(mp):
    """The per-key Updater over meta tensors (a card's stand-in): SGD's
    own update takes the kernel's plan, one per index, kept across
    calls; multi-precision updates the fp32 master through it."""
    o = tmx.optimizer.SGD(learning_rate=0.1, momentum=0.9,
                          multi_precision=mp, clip_gradient=0.5)
    up = tmx.optimizer.Updater(o)
    dt = torch.bfloat16 if mp else torch.float32
    w = torch.empty(4, 3, device="meta", dtype=dt)
    for _ in range(2):
        up(0, torch.empty(4, 3, device="meta", dtype=dt), w)
    return [(1, True, False, "meta")], [(1, 0.1, 0.5)] * 2


def _leftover_off_the_cpu(monkeypatch, setup):
    """A gradient of another dtype than its weight is left over by the
    FusedUpdater's grouping; on the card it still reaches the kernel,
    through SGD's per-key update (whose plan then checks the dtypes)."""
    monkeypatch.setenv("MXTPU_NUMERICS", "0")
    up = FusedUpdater(tmx.optimizer.SGD(learning_rate=0.1))
    ws = [torch.empty(5, device="meta"), torch.empty(6, device="meta")]
    gs = [torch.empty(5, device="meta"),
          torch.empty(6, device="meta", dtype=torch.bfloat16)]
    up.update_all([0, 1], gs, ws)
    return [(1, False, False, "meta")] * 2, [(1, 0.1, None)] * 2


SGD_ROUTES = {
    "one_parameter_trainer": _one_parameter_trainer,
    "fused_update_off": _whole_net_with_fused_update_off,
    "per_key_off_the_cpu": lambda *_: _per_key_off_the_cpu(False),
    "per_key_multi_precision_off_the_cpu":
        lambda *_: _per_key_off_the_cpu(True),
    "leftover_off_the_cpu": _leftover_off_the_cpu,
}


@pytest.mark.parametrize("route", sorted(SGD_ROUTES))
def test_every_sgd_update_goes_through_the_kernel_plan(setup, monkeypatch,
                                                       route):
    """No SGD update reaches the weights around the kernel's plan: not one
    parameter alone, not under MXTPU_FUSED_UPDATE=0, not per key or as a
    group's leftover on a card's tensors. (On CPU tensors the plan runs
    the plain version; on a card it launches the kernel or raises.)"""
    monkeypatch.setattr(sgd_momentum, "SGDMomentumPlan", _RecordingPlan)
    monkeypatch.setattr(_RecordingPlan, "built", [])
    monkeypatch.setattr(_RecordingPlan, "calls", [])
    built, calls = SGD_ROUTES[route](monkeypatch, setup)
    assert _RecordingPlan.built == built
    assert _RecordingPlan.calls == calls


def test_fused_updater_keeps_the_plans_of_its_last_call_only():
    """The plan table holds the groups of the last update_all: a set that
    changes every call replaces it, and a set that comes back reuses its
    plan while it is still there."""
    up = FusedUpdater(tmx.optimizer.SGD(learning_rate=0.1, momentum=0.9))
    ws = [torch.zeros(3) for _ in range(4)]
    gs = [torch.ones(3) for _ in range(4)]
    up.update_all([0, 1], gs[:2], ws[:2])
    first = dict(up._plans)
    up.update_all([0, 1], gs[:2], ws[:2])
    assert list(up._plans) == list(first)
    assert all(up._plans[k][1] is first[k][1] for k in first)
    up.update_all([2, 3], gs[2:], ws[2:])
    assert len(up._plans) == 1 and not set(up._plans) & set(first)


@pytest.mark.parametrize("update_on_kvstore", [None, False, True])
def test_a_store_is_made_only_to_update_on_it(setup, update_on_kvstore):
    """One process, one device: a store that does not run the update
    would only copy each gradient onto itself, so the trainer makes
    none; with update_on_kvstore the store holds the weights and runs
    the updater."""
    _, _, x, y = setup
    net = _port_net(setup)
    tr = gluon.Trainer(net.collect_params(), "sgd", dict(OPT),
                       kvstore="device", update_on_kvstore=update_on_kvstore)
    _port_step(net, tr, x, y)
    if update_on_kvstore:
        assert tr._kvstore is not None and tr._kvstore._updater is not None
        assert len(tr._kvstore._data) == len(tr._params)
    else:
        assert tr._kvstore is None


def test_bf16_multi_precision_within_jax_bf16_distance(setup):
    """net.cast('bfloat16') with multi_precision: 3 steps on each side.
    The two packages round to bf16 at other places, and the rounding
    noise grows step by step, so per tensor the port's bf16 parameters
    lie no farther from JAX's bf16 run than NOISE times JAX's own
    bf16-to-fp32 distance plus MARGIN, and the mean losses of either
    package's bf16 run and JAX's fp32 run within BF16_LOSS_TOL (measured
    at step 3: port 0.038 from JAX bf16, JAX bf16 0.012 from fp32)."""
    NOISE, MARGIN, BF16_LOSS_TOL = 2.0, 2e-3, 0.06
    _, init, x, y = setup
    opt = dict(OPT, multi_precision=True)
    net = _small_jax()
    net.initialize()
    net.infer_shape(mx.nd.zeros((1, 32, 32, 3)))
    for k, p in net.collect_params().items():
        p._finish_deferred_init()
        p.set_data(mx.nd.array(init[k.split("_", 1)[1]]))
    net.cast("bfloat16")
    net.hybridize()
    jnets = [(net, jgluon.Trainer(net.collect_params(), "sgd", dict(opt)))]
    ref = _jax_net(setup)
    jnets.append((ref, jgluon.Trainer(ref.collect_params(), "sgd",
                                      dict(opt))))
    tnet = _port_net(setup, "bfloat16")
    ttr = gluon.Trainer(tnet.collect_params(), "sgd", dict(opt))
    assert {p.dtype for k, p in tnet.collect_params().items()} == \
        {torch.bfloat16}
    xb = x.astype(jnp.bfloat16)
    for step in range(3):
        want = _jax_step(jnets[0][0], jnets[0][1],
                         mx.nd.array(xb)._data, y)
        fp32 = _jax_step(jnets[1][0], jnets[1][1], x, y)
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        with autograd.record():
            got = loss_fn(tnet(torch.from_numpy(x).bfloat16()),
                          torch.from_numpy(y))
        got.backward()
        ttr.step(BATCH)
        assert abs(got.asnumpy().mean() - want.astype(np.float32).mean()) \
            < BF16_LOSS_TOL, step
        assert abs(fp32.mean() - want.astype(np.float32).mean()) \
            < BF16_LOSS_TOL, step
    (jb, _), (jf, _) = jnets
    tp = tnet.collect_params()
    for (k, pb), pf in zip(jb.collect_params().items(),
                           jf.collect_params().values()):
        name = k.split("_", 1)[1]
        if "_running_" in name:
            continue
        b = _port_layout(pb.data()._data.astype(jnp.float32))
        f = _port_layout(pf.data()._data.astype(jnp.float32))
        got = tp[tnet.prefix + name].data().detach().float().numpy()
        assert np.abs(got - b).max() <= NOISE * np.abs(b - f).max() \
            + MARGIN, name
    masters = [s[0] for s in _updater(ttr).states.values()]
    assert masters and all(m.dtype == torch.float32 for m in masters)


# (initializer on each side, the std the JAX package's formula gives it,
# the bound of a uniform draw or None) for a (64, 3, 3, 32) NHWC conv
# weight: fan_in = 3*3*32 = 288 and, as the JAX Xavier computes it from
# that layout, fan_out = 64*3*32 = 6144
_FAN_IN, _FAN_OUT = 288, 6144
INITS = {
    "uniform": ("Uniform", dict(scale=0.1), 0.1 / np.sqrt(3), 0.1),
    "normal": ("Normal", dict(sigma=0.05), 0.05, None),
    "xavier": ("Xavier", {}, np.sqrt(3 / ((_FAN_IN + _FAN_OUT) / 2))
               / np.sqrt(3), np.sqrt(3 / ((_FAN_IN + _FAN_OUT) / 2))),
    "xavier_gaussian_in": ("Xavier", dict(rnd_type="gaussian",
                                          factor_type="in", magnitude=2),
                           np.sqrt(2 / _FAN_IN), None),
    "xavier_out": ("Xavier", dict(factor_type="out"),
                   np.sqrt(3 / _FAN_OUT) / np.sqrt(3), np.sqrt(3 / _FAN_OUT)),
    "msra_prelu": ("MSRAPrelu", {}, np.sqrt(2 / 1.0625 / (
        (_FAN_IN + _FAN_OUT) / 2)), None),
}


@pytest.mark.parametrize("case", sorted(INITS))
def test_initializer_matches_jax_in_distribution(case):
    """Both packages draw an NHWC conv weight (18432 values) from their
    own generators: each sample's std within 3 % of the formula's (about
    6 standard errors), its mean within 5 standard errors of 0, a
    uniform draw inside its bound and reaching 99 % of it; the bias
    starts at zero on both."""
    cls, kw, std, bound = INITS[case]
    mx.random.seed(3)
    tmx.random.seed(3)
    jc = jgluon.nn.Conv2D(64, 3, in_channels=32, layout="NHWC")
    jc.initialize(getattr(mx.init, cls)(**kw))
    tc = gluon.nn.Conv2D(64, 3, in_channels=32, layout="NHWC",
                         device="cpu")
    tc.initialize(getattr(tmx.init, cls)(**kw))
    for w in (np.asarray(jc.weight.data()._data),
              tc.weight.detach().numpy()):
        assert abs(w.std() / std - 1) < 0.03, (case, w.std(), std)
        assert abs(w.mean()) < 5 * std / np.sqrt(w.size)
        if bound is not None:
            assert bound * 0.99 < np.abs(w).max() <= bound
    assert not tc.bias.detach().any()
    assert not np.asarray(jc.bias.data()._data).any()
    # a seed gives the same draws again
    again = gluon.nn.Conv2D(64, 3, in_channels=32, layout="NHWC",
                            device="cpu")
    tmx.random.seed(3)
    again.initialize(getattr(tmx.init, cls)(**kw))
    assert torch.equal(again.weight, tc.weight)


def test_initialize_follows_each_parameters_own_initializer(setup):
    """net.initialize(Xavier) gives weights the global initializer and
    biases, gammas, betas and running statistics their own (zeros and
    ones), as the JAX net's; a second call warns and changes nothing,
    force_reinit draws again."""
    jnet, _, _, _ = setup
    net = vision.ResNetV1(vision.BottleneckV1, [1, 1], [16, 32, 64],
                          classes=10, layout="NHWC", device="cpu")
    assert not any(p.data().any() for k, p in net.collect_params().items()
                   if k.endswith("_weight"))
    net.initialize(tmx.init.Xavier())
    jp = jnet.collect_params()
    for name, p in net.collect_params().items():
        t = p.data().detach()
        if name.endswith(("_gamma", "_running_var")):
            assert torch.equal(t, torch.ones_like(t)), name
        elif name.endswith(("_beta", "_bias", "_running_mean")):
            assert not t.any(), name
        else:
            assert t.std() > 0 and t.shape == _port_layout(
                jp[jnet.prefix + name[len(net.prefix):]].data()._data) \
                .shape, name
    before = net.output.weight.detach().clone()
    with pytest.warns(UserWarning, match="force_reinit"):
        net.initialize(tmx.init.Xavier())
    assert torch.equal(net.output.weight, before)
    net.initialize(tmx.init.Xavier(), force_reinit=True)
    assert not torch.equal(net.output.weight, before)


def test_trainer_refuses_what_the_port_does_not_have(setup, monkeypatch):
    """What the port refuses: the JAX package's own refusals. 'dist_async'
    is accepted, as in JAX: the synchronous distributed store under that
    name. A distributed store runs where the parameters are: with no
    card, on the CPU the caller put them on, at one process. At one
    process ``MXTPU_ZERO1=1`` changes nothing, as in JAX: the step is the
    replicated one, bit for bit."""
    _, _, x, y = setup
    net = _port_net(setup)
    params = net.collect_params()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tr = gluon.Trainer(params, "sgd", dict(OPT), kvstore="dist_async")
    _port_step(net, tr, x, y)
    assert tr._kvstore.type == "dist_async"
    assert tr._kvstore.device == torch.device("cpu")
    tr = gluon.Trainer(params, "sgd", dict(OPT), kvstore="dist_sync")
    _port_step(net, tr, x, y)
    assert tr._kvstore.device == torch.device("cpu")
    assert tr._kvstore.num_workers == 1
    before = {k: v.data().clone() for k, v in params.items()}
    after = {}
    for zero1 in ("1", "0"):
        monkeypatch.setenv("MXTPU_ZERO1", zero1)
        for k, v in params.items():
            v.set_data(before[k].clone())
        _port_step(net, gluon.Trainer(params, "sgd", dict(OPT)), x, y)
        after[zero1] = {k: v.data().clone() for k, v in params.items()}
    assert all(torch.equal(after["1"][k], after["0"][k]) for k in before)
    monkeypatch.delenv("MXTPU_ZERO1")
    with pytest.raises(ValueError, match="Parameters"):
        gluon.Trainer([net.output.weight], "sgd")
    with pytest.raises(MXNetError, match="optimizer_params"):
        gluon.Trainer(params, tmx.optimizer.SGD(), {"momentum": 0.9})
    tr = gluon.Trainer(params, "sgd", dict(OPT), update_on_kvstore=True)
    with pytest.raises(MXNetError, match="kvstore"):
        tr.allreduce_grads()
