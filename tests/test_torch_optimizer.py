"""Parity of the PyTorch port's optimizer zoo, schedulers and fused updater
with the JAX package's, on the CPU.

Each optimizer class updates two seeded tensors 3 times on each side (the
JAX package's per-key `Updater`, the port's), from the same numpy
weights and gradients; SGLD, whose noise comes from two different
generators, is held by its statistics. Then the lr/wd plumbing (clipping,
lr_mult/wd_mult through param_dict, a scheduler), multi-precision, the
Updater's pickled states, MXNet's SGD form against the JAX fused kernel
`_sgd_fused` with lr changing between calls, the port's `FusedUpdater`
against its own per-key path, and the numerics guard's group skip.

Tolerance: fp32 on both sides, 1e-6 relative to the tensors' scale
(TOL); a rule that divides by small running sums (AdaGrad, RMSProp,
AdaDelta, Ftrl, Nadam, FTML) gets 1e-5.
"""
import pickle

import numpy as np
import jax
from jax._src import compilation_cache
import jax.numpy as jnp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.parallel.fused_update import _sgd_fused
from mxnet_tpu_torch import lr_scheduler, optimizer as topt, ops
from mxnet_tpu_torch.parallel import FusedUpdater
from mxnet_tpu_torch.observability import registry
from mxnet_tpu_torch.resilience import numerics

TOL = 1e-6
LOOSE = 1e-5
SHAPES = [(6, 5), (7,)]


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


def _arrays(seed, steps=3):
    rng = np.random.RandomState(seed)
    ws = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    gs = [[rng.randn(*s).astype(np.float32) for s in SHAPES]
          for _ in range(steps)]
    return ws, gs


def _run_jax(name, kw, ws, gs, names=None):
    o = mx.optimizer.create(name, param_idx2name=names or {}, **kw)
    up = mx.optimizer.Updater(o)
    w = [mx.nd.array(a) for a in ws]
    for step in gs:
        for i, g in enumerate(step):
            up(i, mx.nd.array(g), w[i])
    return [np.asarray(a._data) for a in w], up


def _run_port(name, kw, ws, gs, updater=topt.Updater, names=None):
    o = topt.create(name, param_idx2name=names or {}, **kw)
    up = updater(o)
    w = [torch.from_numpy(a.copy()) for a in ws]
    for step in gs:
        if updater is topt.Updater:
            for i, g in enumerate(step):
                up(i, torch.from_numpy(g), w[i])
        else:
            up.update_all(list(range(len(w))),
                          [torch.from_numpy(g) for g in step], w)
    return [a.numpy() for a in w], up


CASES = {
    "sgd": ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-3), TOL),
    "sgd_no_momentum": ("sgd", dict(learning_rate=0.1, wd=1e-3), TOL),
    "nag": ("nag", dict(learning_rate=0.1, momentum=0.9, wd=1e-3), TOL),
    "signum": ("signum", dict(learning_rate=0.01, wd=1e-3, wd_lh=1e-2), TOL),
    "signum_no_momentum": ("signum", dict(learning_rate=0.01,
                                          momentum=0.0), TOL),
    "adam": ("adam", dict(learning_rate=0.01, wd=1e-3), TOL),
    "adagrad": ("adagrad", dict(learning_rate=0.1, wd=1e-3), LOOSE),
    "rmsprop": ("rmsprop", dict(learning_rate=0.01), LOOSE),
    "rmsprop_centered": ("rmsprop", dict(learning_rate=0.01, centered=True,
                                         clip_weights=0.5), LOOSE),
    "adadelta": ("adadelta", dict(wd=1e-3), LOOSE),
    "ftrl": ("ftrl", dict(learning_rate=0.1, wd=1e-3), LOOSE),
    "adamax": ("adamax", dict(wd=1e-3), TOL),
    "nadam": ("nadam", dict(wd=1e-3), LOOSE),
    "ftml": ("ftml", dict(wd=1e-3), LOOSE),
    "dcasgd": ("dcasgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-3),
               TOL),
    "lbsgd": ("lbsgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-3), TOL),
    "test": ("test", dict(rescale_grad=0.5), TOL),
}


def _close(got, want, tol):
    for a, b in zip(got, want):
        scale = max(1.0, float(np.abs(b).max()))
        assert np.abs(a - b).max() <= tol * scale, np.abs(a - b).max()


@pytest.mark.parametrize("case", sorted(CASES))
def test_three_updates_match_jax(case):
    name, kw, tol = CASES[case]
    ws, gs = _arrays(sorted(CASES).index(case))
    want, _ = _run_jax(name, kw, ws, gs)
    got, _ = _run_port(name, kw, ws, gs)
    _close(got, want, tol)


def test_sgld_noise_matches_jax_in_distribution():
    """Zero gradient and weight decay: each update adds N(0, lr). Over
    4096 elements and 3 updates the port's and JAX's weights both have
    mean ~0 and std ~sqrt(3 lr), within 4 standard errors."""
    lr = 0.01
    ws = [np.zeros((64, 64), np.float32)]
    gs = [[np.zeros((64, 64), np.float32)] for _ in range(3)]
    want, _ = _run_jax("sgld", dict(learning_rate=lr), ws, gs)
    got, _ = _run_port("sgld", dict(learning_rate=lr), ws, gs)
    std = np.sqrt(3 * lr)
    n = got[0].size
    for arr in (want[0], got[0]):
        assert abs(arr.mean()) < 4 * std / np.sqrt(n)
        assert abs(arr.std() - std) < 4 * std / np.sqrt(2 * n)
    assert not np.array_equal(got[0], want[0])


SCHEDULERS = {
    "factor": ("FactorScheduler", dict(step=2, factor=0.5,
                                       stop_factor_lr=1e-3)),
    "multifactor": ("MultiFactorScheduler", dict(step=[2, 5, 7],
                                                 factor=0.3)),
    "poly": ("PolyScheduler", dict(max_update=9, pwr=2, final_lr=1e-3)),
    "cosine": ("CosineScheduler", dict(max_update=9, final_lr=1e-3)),
    "factor_warmup": ("FactorScheduler", dict(step=3, factor=0.5,
                                              warmup_steps=3,
                                              warmup_begin_lr=0.01)),
    "cosine_warmup_constant": ("CosineScheduler", dict(
        max_update=9, warmup_steps=2, warmup_begin_lr=0.02,
        warmup_mode="constant")),
}


@pytest.mark.parametrize("case", sorted(SCHEDULERS))
def test_scheduler_matches_jax(case):
    cls, kw = SCHEDULERS[case]
    a = getattr(mx.lr_scheduler, cls)(base_lr=0.1, **kw)
    b = getattr(lr_scheduler, cls)(base_lr=0.1, **kw)
    for n in list(range(12)) + [12, 12, 20]:
        assert a(n) == b(n), (case, n)


class _P:
    """What param_dict holds: lr_mult and wd_mult."""

    def __init__(self, lr_mult, wd_mult):
        self.lr_mult, self.wd_mult = lr_mult, wd_mult


def test_clip_mults_and_scheduler_match_jax():
    """SGD with clip_gradient, per-parameter lr_mult/wd_mult through
    param_dict (which come before the name rule that would drop a bias's
    weight decay), rescale_grad and a FactorScheduler."""
    ws, gs = _arrays(11)
    names = {0: "fc_weight", 1: "fc_bias"}
    kw = dict(learning_rate=0.1, momentum=0.9, wd=0.01, clip_gradient=0.5,
              rescale_grad=0.7)
    out = []
    for pkg, run in ((mx, _run_jax), (None, _run_port)):
        sched = (mx.lr_scheduler if pkg else lr_scheduler).FactorScheduler(
            step=1, factor=0.5)
        params = {0: _P(2.0, 0.5), 1: _P(0.5, 1.0)}
        out.append(run("sgd", dict(kw, lr_scheduler=sched,
                                   param_dict=params), ws, gs,
                       names=names)[0])
    _close(out[1], out[0], TOL)
    # without param_dict the name rule applies: no weight decay on a bias
    port = topt.create("sgd", param_idx2name=names, wd=0.1)
    assert port._get_wd(0) == pytest.approx(0.1) and port._get_wd(1) == 0.0


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_multi_precision_matches_jax(name):
    """bf16 weights with fp32 masters: the masters and the bf16 weights
    after 3 updates, against JAX's (bf16 weights: one bf16 ulp)."""
    ws, gs = _arrays(13)
    kw = dict(learning_rate=0.05, wd=1e-3, multi_precision=True)
    if name == "sgd":
        kw["momentum"] = 0.9
    jo = mx.optimizer.create(name, **kw)
    jup = mx.optimizer.Updater(jo)
    jw = [mx.nd.array(a).astype("bfloat16") for a in ws]
    up = topt.Updater(topt.create(name, **kw))
    tw = [torch.from_numpy(a).bfloat16() for a in ws]
    for step in gs:
        for i, g in enumerate(step):
            jup(i, mx.nd.array(g).astype("bfloat16"), jw[i])
            up(i, torch.from_numpy(g).bfloat16(), tw[i])
    for i in range(len(ws)):
        jmaster = np.asarray(jup.states[i][0]._data)
        master = up.states[i][0]
        assert master.dtype == torch.float32 and tw[i].dtype == torch.bfloat16
        _close([master.numpy()], [jmaster], TOL)
        want = np.asarray(jw[i]._data.astype(jnp.float32))
        assert np.abs(tw[i].float().numpy() - want).max() <= \
            2 ** -7 * max(1.0, np.abs(want).max())


def test_updater_states_round_trip_through_pickle():
    """get_states / set_states (with the optimizer): a new updater that
    takes the states continues exactly as the first one does."""
    ws, gs = _arrays(17, steps=4)
    kw = dict(learning_rate=0.1, momentum=0.9, wd=1e-3,
              lr_scheduler=lr_scheduler.FactorScheduler(step=1, factor=0.5))
    _, up = _run_port("sgd", kw, ws, gs[:2])
    w = [torch.from_numpy(a) for a in _run_port("sgd", kw, ws, gs[:2])[0]]
    blob = up.get_states(dump_optimizer=True)
    other = topt.Updater(topt.create("sgd", learning_rate=1.0))
    other.set_states(blob)
    assert other.optimizer.num_update == up.optimizer.num_update == 2
    w2 = [a.clone() for a in w]
    for i, g in enumerate(gs[2]):
        up(i, torch.from_numpy(g), w[i])
        other(i, torch.from_numpy(g), w2[i])
    for a, b in zip(w, w2):
        assert torch.equal(a, b)
    assert isinstance(pickle.loads(up.get_states()), dict)


def test_sgd_mxnet_plain_matches_jax_sgd_fused_as_lr_changes():
    """MXNet's form, the kernel's plain version, against the JAX fused
    kernel over 3 calls with a new lr each call, with and without
    momentum and clipping; the m-form of the Pallas kernel gives another
    answer once lr changes."""
    rng = np.random.RandomState(19)
    w = rng.randn(300).astype(np.float32)
    for momentum, clip in ((0.9, None), (0.9, 0.3), (0.0, 0.3)):
        jw, jv = jnp.asarray(w), jnp.zeros_like(jnp.asarray(w))
        tw, tv = torch.from_numpy(w.copy()), torch.zeros(300)
        mw, mm = torch.from_numpy(w.copy()), torch.zeros(300)
        for lr in (0.1, 0.05, 0.2):
            g = rng.randn(300).astype(np.float32)
            states = (jv,) if momentum else ()
            jw, st = _sgd_fused(jw, jnp.asarray(g), states, lr, 1, 1e-3,
                                (0.5, clip, momentum))
            jv = st[0] if momentum else jv
            tw, tv_new = ops.sgd_mxnet_plain(tw, torch.from_numpy(g),
                                             tv if momentum else None, lr,
                                             momentum, 1e-3, 0.5, clip)
            tv = tv_new if momentum else tv
            mw, mm = ops.sgd_momentum_plain(mw, torch.from_numpy(g) * 0.5,
                                            mm, lr, momentum, 1e-3)
            assert np.abs(tw.numpy() - np.asarray(jw)).max() < TOL
            if momentum:
                assert np.abs(tv.numpy() - np.asarray(jv)).max() < TOL
        if momentum and clip is None:
            assert np.abs(mw.numpy() - np.asarray(jw)).max() > 1e-3


@pytest.mark.parametrize("name", ["sgd", "adam", "rmsprop", "adagrad"])
def test_fused_updater_equals_the_per_key_path(name):
    """The FusedUpdater's groups (the SGD plan's plain version, the
    _foreach functions) give the per-key path's bits, and count one group
    per lane: two here, since one parameter has its own lr_mult."""
    ws, gs = _arrays(23)
    ws.append(np.random.RandomState(1).randn(4, 4).astype(np.float32))
    for step in gs:
        step.append(np.random.RandomState(2).randn(4, 4).astype(np.float32))
    kw = dict(learning_rate=0.05, wd=1e-3,
              param_dict={0: _P(1.0, 1.0), 1: _P(1.0, 1.0),
                          2: _P(2.0, 1.0)})
    if name == "sgd":
        kw["momentum"] = 0.9
    groups = registry.counter("optimizer.fused.groups")
    before = groups.get()
    per_key, _ = _run_port(name, kw, ws, gs)
    fused, up = _run_port(name, kw, ws, gs, updater=FusedUpdater)
    for a, b in zip(fused, per_key):
        assert np.array_equal(a, b)
    assert groups.get() - before == 2 * len(gs)
    assert numerics.drain_flags()["total"] == len(gs)


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_non_finite_gradient_group_keeps_its_bits(name):
    ws, gs = _arrays(29, steps=1)
    kw = dict(learning_rate=0.05, wd=1e-3, momentum=0.9) if name == "sgd" \
        else dict(learning_rate=0.05)
    got, up = _run_port(name, kw, ws, gs, updater=FusedUpdater)
    numerics.drain_flags()
    w = [torch.from_numpy(a) for a in got]
    before = [a.clone() for a in w]
    states = pickle.loads(up.get_states())
    bad = [torch.from_numpy(g.copy()) for g in gs[0]]
    bad[1][3] = float("inf")
    up.update_all([0, 1], bad, w)
    for a, b in zip(w, before):
        assert torch.equal(a, b)
    after = pickle.loads(up.get_states())
    for i in states:
        for s, t in zip(states[i] if isinstance(states[i], tuple)
                        else (states[i],),
                        after[i] if isinstance(after[i], tuple)
                        else (after[i],)):
            assert torch.equal(s, t)
    guard = numerics.drain_flags()
    assert guard["skipped_steps"] == 1 and guard["total"] == 1


def test_mxnet_form_plan_refuses_what_it_does_not_take():
    w = [torch.zeros(3), torch.zeros(4)]
    with pytest.raises(Exception, match="form"):
        ops.SGDMomentumPlan(w, None, form="x")
    with pytest.raises(Exception, match="fp32 masters"):
        ops.SGDMomentumPlan([a.bfloat16() for a in w], None, form="mxnet",
                            weights=[a.bfloat16() for a in w])
    with pytest.raises(Exception, match="velocities"):
        ops.SGDMomentumPlan(w, None, form="mxnet")([a for a in w], 0.1, 0.9)
    plan = ops.SGDMomentumPlan(w, [torch.zeros(3), torch.zeros(4)],
                               form="mxnet")
    with pytest.raises(Exception, match="ok must be"):
        plan(w, 0.1, 0.9, ok=torch.tensor(1.0))
    with pytest.raises(Exception, match="MXNet's form"):
        ops.SGDMomentumPlan(w, [torch.zeros(3), torch.zeros(4)])(
            w, 0.1, clip=1.0)
