"""The port's training numerics guard (mxnet_tpu_torch/resilience/
numerics.py) and chaos corruption (resilience/chaos.py `corrupt_point`)
against the JAX package's, on the CPU, with the same scripted inputs:

- `GradScaler`'s schedule and `DivergenceWatchdog`'s spikes, streaks and
  `last_good_step`, exactly;
- `drain_flags` and `NumericsGuard.step_boundary` over scripted verdict
  sequences: a protected skip, exchange-only, a step_many window, an
  unguarded veto of the full skip, calibration under an armed scaler
  against divergence, the rollback chain and its exit codes (77, or 1
  without a checkpoint), and the SDC replay's two verdicts;
- `corrupt_point` corrupts the same element and the same bit for the
  same spec and seed; `parse_spec` takes the corrupt kinds;
- on a narrow NHWC ResNet through `gluon.Trainer`: a NaN injected at
  ``grad.post`` for step k only leaves weights and momenta of step k
  bit-identical to step k-1 while steps k-1 and k+1 update, halves an
  armed loss scale and emits a ``numerics_skip`` event; ``MXTPU_NUMERICS=0``
  gives the same bits as the guard on; and `Module.fit`'s guard replays
  a skipped batch.
"""
import json

import numpy as np
import jax
from jax._src import compilation_cache
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu.resilience import chaos as jchaos
from mxnet_tpu.resilience import numerics as jnum
from mxnet_tpu_torch import MXNetError, autograd, gluon
from mxnet_tpu_torch.convert import init_resnet_params
from mxnet_tpu_torch.gluon.model_zoo.vision import BottleneckV1, ResNetV1
from mxnet_tpu_torch.observability import telemetry
from mxnet_tpu_torch.resilience import chaos, numerics


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
def _clean(monkeypatch):
    for k in ("MXTPU_CHAOS", "MXTPU_CHAOS_SEED", "MXTPU_TELEMETRY",
              "MXTPU_NUMERICS"):
        monkeypatch.delenv(k, raising=False)
    numerics.reset_flags()
    jnum.reset_flags()
    chaos.reset()
    jchaos.reset()
    yield
    numerics.reset_flags()
    jnum.reset_flags()
    chaos.reset()
    jchaos.reset()
    telemetry.close_stream()


# -- the schedules ---------------------------------------------------------
OVERFLOWS = [True, False, False, True, False, False, False, False, True,
             True, True, False, False, False]


@pytest.mark.parametrize("armed", [True, False])
def test_grad_scaler_schedule_matches_jax(armed):
    port = numerics.GradScaler(init_scale=1024.0, growth_interval=3,
                               min_scale=64.0, max_scale=4096.0)
    ref = jnum.GradScaler(init_scale=1024.0, growth_interval=3,
                          min_scale=64.0, max_scale=4096.0)
    if armed:
        assert port.scale_loss(2.0) == ref.scale_loss(2.0) == 2048.0
    seq = []
    for ov in OVERFLOWS:
        a, b = port.update(ov), ref.update(ov)
        assert a == b
        seq.append(a)
        assert (port.scale, port.good_steps, port.overflows) == \
            (ref.scale, ref.good_steps, ref.overflows)
        assert port.unscale_factor() == ref.unscale_factor()
    if armed:
        assert seq[:4] == [512.0, 512.0, 512.0, 256.0] and min(seq) == 64.0
    else:
        assert set(seq) == {1.0}


VALUES = [1.0, 1.1, 0.9, 1.2, 1.0, 1.05, 50.0, 0.95, float("nan"),
          float("inf"), 1.0, 30.0, 40.0, 35.0, 1.0, None, 1.0]


def test_divergence_watchdog_matches_jax():
    port = numerics.DivergenceWatchdog(patience=3, factor=10.0, window=8)
    ref = jnum.DivergenceWatchdog(patience=3, factor=10.0, window=8)
    for step, v in enumerate(VALUES):
        anomalous = step == 14
        assert port.observe(step, v, anomalous) == \
            ref.observe(step, v, anomalous), step
        assert (port.bad_streak, port.first_bad_step,
                port.last_good_step(), port.median()) == \
            (ref.bad_streak, ref.first_bad_step, ref.last_good_step(),
             ref.median()), step


# -- the guard over scripted verdicts --------------------------------------
def _record(pkg, flags):
    import jax.numpy as jnp
    for ok, where, keys in flags:
        flag = torch.tensor(ok) if pkg is numerics else jnp.asarray(ok)
        pkg.record_flag(flag, keys=keys, where=where)


SCRIPTS = {
    "clean": [(True, "step", None)],
    "protected_skip": [(False, "update", ["a", "b"]),
                       (False, "update", ["c"]),
                       (True, "exchange", None)],
    "exchange_only": [(False, "exchange", [3, 4]), (True, "exchange", None)],
    "window": [(False, "window", None)],
    "vector": [([True, False, False], "step", None)],
    "partial": [(False, "update", [0]), (True, "update", [1])],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
@pytest.mark.parametrize("unguarded", [0, 2])
def test_drain_flags_matches_jax(name, unguarded):
    _record(numerics, SCRIPTS[name])
    _record(jnum, SCRIPTS[name])
    numerics.note_unguarded(unguarded)
    jnum.note_unguarded(unguarded)
    assert numerics.pending_flags() == jnum.pending_flags()
    port, ref = numerics.drain_flags(), jnum.drain_flags()
    assert port == ref
    if name == "protected_skip":
        assert port["full_skip"] == (unguarded == 0)
    assert numerics.pending_flags() == 0


def _boundaries(pkg, script, scaler=None, patience=3):
    guard = pkg.NumericsGuard(
        source="t", scaler=scaler,
        watchdog=pkg.DivergenceWatchdog(patience=patience))
    reports = []
    for step, (flags, loss) in enumerate(script):
        _record(pkg, flags)
        try:
            reports.append(guard.step_boundary(step=step, loss=loss))
        except pkg.TrainingDiverged as err:
            reports.append(("diverged", err.step, err.first_bad_step,
                            err.exit_code))
    return reports, guard


BAD = [(False, "step", None)]
GOOD = [(True, "step", None)]


def test_guard_reports_match_jax(capfd):
    script = [(GOOD, 1.0), (BAD, 1.0), ([(False, "exchange", [1])], 1.0),
              ([(False, "window", None)], 1.0), (GOOD, 1.0),
              (GOOD, float("nan")), (GOOD, 1.0)]
    skipped, anomalies = numerics.SKIPPED.total(), numerics.ANOMALIES.total()
    port, _ = _boundaries(numerics, script, patience=10)
    ref, _ = _boundaries(jnum, script, patience=10)
    assert port == ref
    assert [r["skipped_steps"] for r in port] == [0, 1, 0, 0, 0, 0, 0]
    assert numerics.SKIPPED.total() - skipped == 1
    # three nonfinite anomalies from flags, one spike (the NaN loss)
    assert numerics.ANOMALIES.total() - anomalies == 4
    assert capfd.readouterr().err.count("MXTPU_NUMERICS anomaly") == 6


def test_calibration_is_not_divergence_but_a_floored_scale_is():
    """An armed scaler with room to halve turns overflow skips into
    calibration; once floored, the same skips diverge (patience 3)."""
    script = [(BAD, None)] * 6
    for pkg in (numerics, jnum):
        scaler = pkg.GradScaler(init_scale=8.0, min_scale=1.0)
        scaler.scale_loss(1.0)
        reports, guard = _boundaries(pkg, script, scaler=scaler)
        if pkg is numerics:
            port = reports, scaler.scale
        else:
            ref = reports, scaler.scale
    assert port == ref
    reports, scale = port
    # 8 -> 4 -> 2 -> 1 calibrates; then three floored skips diverge
    assert scale == 1.0
    assert [r if isinstance(r, tuple) else "ok" for r in reports] == \
        ["ok"] * 5 + [("diverged", 5, 3, 1)]


class _FakeCheckpoint:
    def __init__(self, steps):
        self.steps = list(steps)
        self.restored = []

    def drop_steps_after(self, step):
        dropped = [s for s in self.steps if s > step]
        self.steps = [s for s in self.steps if s <= step]
        return dropped

    def restore_latest(self, state):
        self.restored.append(state)
        return max(self.steps) if self.steps else None


def test_rollback_chain_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("MXTPU_TELEMETRY", str(tmp_path / "t.jsonl"))
    out = {}
    for pkg in (numerics, jnum):
        ck = _FakeCheckpoint(range(1, 9))
        guard = pkg.NumericsGuard(
            source="t", watchdog=pkg.DivergenceWatchdog(patience=2))
        guard.attach_rollback(ck, "state")
        for step in range(1, 6):
            _record(pkg, GOOD)
            guard.step_boundary(step=step, loss=1.0)
        _record(pkg, BAD)
        guard.step_boundary(step=6)
        _record(pkg, BAD)
        with pytest.raises(pkg.TrainingDiverged) as err:
            guard.step_boundary(step=7)
        e = err.value
        out[pkg] = (e.exit_code, e.step, e.first_bad_step, e.restored_step,
                    ck.steps, ck.restored)
    assert out[numerics] == out[jnum] == (77, 7, 6, 4, [1, 2, 3, 4],
                                          ["state"])
    assert numerics.TrainingDiverged.exit_code == \
        numerics.EXIT_DIVERGED == 77
    telemetry.close_stream()
    events = [json.loads(line)["event"] for line in
              open(tmp_path / "t.jsonl") if "event" in line]
    assert events.count("numerics_rollback") == 2        # one a package
    assert events.count("numerics_skip") == 4


def test_replay_verdicts_match_jax():
    grads = [np.arange(6, dtype=np.float32).reshape(2, 3)]
    for same, want in ((True, "deterministic"), (False, "sdc")):
        got = []
        for pkg, wrap in ((numerics, torch.from_numpy), (jnum, np.asarray)):
            guard = pkg.NumericsGuard(source="t")
            other = grads[0] if same else grads[0] + 1
            guard.attach_replay(lambda o=other, w=wrap: [w(o.copy())])
            _record(pkg, BAD)
            got.append(guard.step_boundary(
                step=0, grads=[wrap(grads[0].copy())])["sdc"])
            # only the first anomaly replays
            _record(pkg, BAD)
            assert guard.step_boundary(
                step=1, grads=[wrap(grads[0].copy())])["sdc"] is None
        assert got == [want, want]
    assert numerics.digest([torch.ones(3)]) != \
        numerics.digest([torch.ones(3, dtype=torch.float64)])


def test_exit_codes_and_errors():
    from mxnet_tpu.resilience import preempt as jpreempt
    from mxnet_tpu.resilience import supervisor as jsup
    from mxnet_tpu_torch.resilience import preempt, supervisor
    assert (preempt.TrainingPreempted.exit_code,
            supervisor.PeerLost.exit_code,
            numerics.TrainingDiverged.exit_code) == \
        (jpreempt.TrainingPreempted.exit_code, jsup.PeerLost.exit_code,
         jnum.TrainingDiverged.exit_code) == (75, 76, 77)
    for err in (preempt.TrainingPreempted("x"), supervisor.PeerLost("x"),
                numerics.TrainingDiverged("x"), ValueError("x")):
        assert supervisor.exit_status(err) == \
            getattr(err, "exit_code", 1)
        assert isinstance(err, (MXNetError, ValueError))


# -- chaos ------------------------------------------------------------------
def test_parse_spec_takes_the_corrupt_kinds():
    spec = "grad.post:kind=nan,after=3,n=1;weight.post:kind=bitflip,p=0.5"
    assert chaos.parse_spec(spec) == jchaos.parse_spec(spec) == {
        "grad.post": {"kind": "nan", "after": 3, "n": 1},
        "weight.post": {"kind": "bitflip", "p": 0.5}}
    for bad in ("grad.post:kind=zero", "grad.post:bits=3"):
        with pytest.raises(MXNetError):
            chaos.parse_spec(bad)


@pytest.mark.parametrize("kind", ["nan", "bitflip"])
@pytest.mark.parametrize("dtype", ["float32", "float16", "int32"])
@pytest.mark.parametrize("seed", [0, 22])
def test_corrupt_point_hits_jaxs_element_and_bit(kind, dtype, seed):
    spec = "grad.post:kind=%s,after=1,n=3" % kind
    chaos.configure(spec, seed=seed)
    jchaos.configure(spec, seed=seed)
    rng = np.random.RandomState(seed)
    for draw in range(5):
        host = (rng.randn(7, 13) * 100).astype(dtype)
        port = chaos.corrupt_point("grad.post", host.copy())
        ref = np.asarray(jchaos.corrupt_point("grad.post", host.copy()))
        assert port.dtype == ref.dtype
        assert np.array_equal(port.view(np.uint8), ref.view(np.uint8)), draw
        # the tensor form corrupts the same element and bit, as a copy
        t = torch.from_numpy(host.copy())
        chaos.configure(spec, seed=seed)
        for _ in range(draw + 1):
            got = chaos.corrupt_point("grad.post", t)
        assert np.array_equal(got.numpy().view(np.uint8),
                              port.view(np.uint8)), draw
        assert np.array_equal(t.numpy(), host)
        changed = not np.array_equal(port.view(np.uint8),
                                     host.view(np.uint8))
        assert changed == (1 <= draw <= 3), draw
        # advance the tensor form's site back to where the numpy one is
        chaos.configure(spec, seed=seed)
        for _ in range(draw + 1):
            chaos.corrupt_point("grad.post", host.copy())
    assert chaos.trip_count("grad.post") == jchaos.trip_count("grad.post")


def test_corrupt_tensors_reads_a_list_as_one_flat():
    parts = [np.arange(5, dtype=np.float32), np.arange(7, dtype=np.float32),
             np.arange(3, dtype=np.float32)]
    for seed in range(6):
        chaos.configure("w:kind=bitflip", seed=seed)
        flat = chaos.corrupt_point("w", np.concatenate(parts))
        chaos.configure("w:kind=bitflip", seed=seed)
        ts = [torch.from_numpy(p.copy()) for p in parts]
        i, t = chaos.corrupt_tensors("w", ts)
        assert t is ts[i]
        assert np.array_equal(torch.cat(ts).numpy().view(np.uint8),
                              flat.view(np.uint8)), seed


# -- the guard on a real loop ---------------------------------------------
def _net_and_trainer():
    net = ResNetV1(BottleneckV1, [1, 1], [16, 32, 64], classes=10,
                   layout="NHWC", device="cpu")
    init_resnet_params(net, seed=3)
    tr = gluon.Trainer(net.collect_params(), "sgd",
                       {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})
    return net, tr


def _train(n, scale=False):
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(8, 32, 32, 3).astype(np.float32))
    y = torch.from_numpy((np.arange(8) % 10).astype(np.float32))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    snaps = []
    with mx.cpu():
        net, tr = _net_and_trainer()
        for _ in range(n):
            with autograd.record():
                loss = loss_fn(net(x), y)
                if scale:
                    loss = tr.scale_loss(loss)
            loss.backward()
            tr.step(8)
            up = tr._updaters[0]
            snaps.append((
                {k[len(net.prefix):]: p.data().clone() for k, p in
                 net.collect_params().items() if p.grad_req != "null"},
                {i: s.clone() for i, s in up.states.items()},
                tr.loss_scale,
                None if tr.numerics is None else tr.numerics.last_report))
    return snaps


def test_nan_at_step_k_only_is_skipped_bit_identically(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("MXTPU_TELEMETRY", str(tmp_path / "t.jsonl"))
    monkeypatch.setenv("MXTPU_CHAOS", "grad.post:kind=nan,after=2,n=1")
    snaps = _train(5, scale=True)

    def same(a, b):
        return all(torch.equal(a[0][k], b[0][k]) for k in a[0]) and \
            all(torch.equal(a[1][i], b[1][i]) for i in a[1])
    assert not same(snaps[0], snaps[1])      # step k-1 updates
    assert same(snaps[1], snaps[2])          # step k is skipped
    assert not same(snaps[2], snaps[3])      # step k+1 updates
    assert [s[2] for s in snaps] == [65536.0, 65536.0, 32768.0, 32768.0,
                                     32768.0]
    assert snaps[2][3]["skipped_steps"] == 1 and \
        snaps[3][3]["skipped_steps"] == 0
    telemetry.close_stream()
    recs = [json.loads(line) for line in open(tmp_path / "t.jsonl")]
    steps = [r for r in recs if r.get("source") == "gluon.trainer"]
    assert [r.get("skipped_steps", 0) for r in steps] == [0, 0, 1, 0, 0]
    assert [r["loss_scale"] for r in steps] == [s[2] for s in snaps]
    assert [r["step"] for r in recs if r.get("event") == "numerics_skip"] \
        == [2]


def test_guard_off_gives_the_guard_ons_bits(monkeypatch):
    on = _train(3)
    monkeypatch.setenv("MXTPU_NUMERICS", "0")
    off = _train(3)
    assert off[-1][3] is None
    for a, b in zip(on, off):
        assert all(torch.equal(a[0][k], b[0][k]) for k in a[0])
        assert all(torch.equal(a[1][i], b[1][i]) for i in a[1])


def test_module_fit_guard_replays_a_skipped_batch(monkeypatch):
    """A NaN gradient at grad.post in Module.fit is skipped, and the
    guard's replay from the preserved weights gives the same gradients
    (the corruption was in the update's copy): "deterministic"."""
    monkeypatch.setenv("MXTPU_CHAOS", "grad.post:kind=nan,after=1,n=1")
    rng = np.random.RandomState(7)
    x = rng.randn(32, 8).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.float32)
    with mx.cpu():
        train = mx.io.NDArrayIter(x, y, batch_size=8)
        h = mx.sym.FullyConnected(data=mx.sym.var("data"), num_hidden=2,
                                  name="fc1")
        sym = mx.sym.SoftmaxOutput(data=h, name="softmax")
        mod = mx.mod.Module(sym, context=mx.cpu())
        reports = []
        mod.fit(train, num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1},
                batch_end_callback=lambda p: reports.append(
                    mod.numerics.last_report))
    assert [r["skipped_steps"] for r in reports] == [0, 1, 0, 0]
    assert [r["sdc"] for r in reports] == [None, "deterministic", None,
                                           None]
