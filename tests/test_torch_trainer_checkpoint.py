"""The port's `TrainerCheckpoint` (mxnet_tpu_torch/parallel/checkpoint.py,
on `torch.distributed.checkpoint`) held to the 10 cases of JAX's
tests/test_trainer_checkpoint.py, each against the JAX package's result
on the same data and weights, and a torn save.

In one process (the port's trainer on the CPU, JAX's on the 8 virtual
devices, or on one where the result depends on the world size, as the
compressed step's per-device quantization does): resume after save,
async saves with max_to_keep, compression residuals, the refusal of
ZeRO-1 with compression, restores across compression configurations, a
checkpoint without optimizer state (JAX's plain-SGD layout) into the
port's momentum-0 trainer, and the fallback past a corrupt step.

Across processes (gloo gangs of tests/torch_sharded_worker.py): 4 ranks
save (an Adam MLP after 3 steps, a compressed SGD MLP after 4), 2 ranks
restore. The elastic case matches an uninterrupted 2-rank run restored
from the same step within 1e-5 and JAX's dp=8 -> dp=4 run; the residual
banks are resharded with their totals kept; the Adam state restores onto
ZeRO-1's blocks of rows (JAX's restore onto another sharding, :50). The
torn save: 2 ranks save step 1, then rank 1 is killed at the
``checkpoint.commit`` chaos site of step 2, between data and manifest;
`restore_latest` refuses step 2, falls back to step 1 and counts
``checkpoint.rejected{reason="uncommitted"}``.

Tolerances: losses and weights 1e-5 of max(1, |value|) against JAX
(fp32, other summation orders, as in the JAX tests); resumed-against-
uninterrupted runs of the port itself bit for bit where one process runs
both, 1e-5 across gangs (JAX's :264).
"""
import os
import shutil

import numpy as np
import jax
from jax._src import compilation_cache
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer
from mxnet_tpu.parallel import make_mesh as jax_make_mesh
from mxnet_tpu.parallel.checkpoint import TrainerCheckpoint as JaxCheckpoint
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, gluon
from mxnet_tpu_torch.convert import gluon_params_from_jax
from mxnet_tpu_torch.observability import registry
from mxnet_tpu_torch.parallel import ShardedTrainer
from mxnet_tpu_torch.parallel.checkpoint import (COMMIT_BASENAME,
                                                 TrainerCheckpoint)
import torch_sharded_worker as w
from test_torch_sharded_dist import (jax_net, paths_of, rel_errs, renamed,
                                     run_gang, write_inputs)

TOL = 1e-5
GC = {"type": "2bit", "threshold": 0.05}
ADAM = {"learning_rate": 0.01}
SGD = {"learning_rate": 0.05}


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


@pytest.fixture(scope="module")
def jnet():
    """JAX tests/test_trainer_checkpoint.py's `_net()`, seeded."""
    return jax_net("ckpt", 7)


def _port(jnet, opt="adam", hp=ADAM, **kw):
    with mx.cpu():
        net = w.build(gluon, "ckpt")
    net.initialize(ctx=mx.cpu())
    net.load_parameters(gluon_params_from_jax(jnet, "cpu"))
    return ShardedTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(), opt,
                          dict(hp), device="cpu", **kw)


def _jax(jnet, opt="adam", hp=ADAM, n_dp=8, **kw):
    loss = jgluon.loss.SoftmaxCrossEntropyLoss()
    return JaxTrainer(jnet, lambda o, l: loss(o, l), opt, dict(hp),
                      mesh=jax_make_mesh({"dp": n_dp},
                                         devices=jax.devices()[:n_dp]),
                      **kw)


def _loss(v):
    return float(v) if isinstance(v, torch.Tensor) else \
        float(np.asarray(v._data))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max()), \
        (got.tolist(), want.tolist())


def _by_path(st):
    """A trainer's parameters by block path (two nets built in one
    process have different Gluon names, the same paths)."""
    return {st._paths[k]: v for k, v in st.params.items()}


def _params_close(st, jst, jnet, tol=TOL):
    got = {"params": _by_path(st)}
    errs = rel_errs(got, renamed({"params": jst._params}, paths_of(jnet)))
    assert max(errs.values()) <= tol, errs


# -- one process ---------------------------------------------------------------
def test_save_restore_resumes_identically(tmp_path, jnet):
    x, y = w.ckpt_batch()
    a, ja = _port(jnet), _jax(jnet)
    for _ in range(3):
        a.step(x, y)
        ja.step(x, y)
    with TrainerCheckpoint(tmp_path / "ck") as ck:
        ck.save(a._step_count, a, wait=True)
        after = [_loss(a.step(x, y)) for _ in range(3)]
        b = _port(jnet)
        assert ck.restore_latest(b) == 3
        resumed = [_loss(b.step(x, y)) for _ in range(3)]
    assert resumed == after
    _close(after, [_loss(ja.step(x, y)) for _ in range(3)])
    assert ck.commit_manifest(3)["files"]


def test_async_save_and_max_to_keep(tmp_path, jnet):
    x, y = w.ckpt_batch()
    a, ja = _port(jnet), _jax(jnet)
    with TrainerCheckpoint(tmp_path / "ck3", max_to_keep=2,
                           async_save=True) as ck, \
            JaxCheckpoint(tmp_path / "jck3", max_to_keep=2,
                          async_save=True) as jck:
        for s in range(1, 5):
            a.step(x, y)
            ja.step(x, y)
            ck.save(s, a)
            jck.save(s, ja)
        ck.wait_until_finished()
        jck.wait_until_finished()
        assert ck.latest_step() == jck.latest_step() == 4
        assert ck.all_steps() == jck.all_steps() == [3, 4]
        assert ck.committed_steps() == [3, 4]
        b, jb = _port(jnet), _jax(jnet)
        assert ck.restore_latest(b) == a._step_count == 4
        assert jck.restore_latest(jb) == 4
    _params_close(b, jb, jnet)


def test_compressed_trainer_checkpoints_residuals(tmp_path, jnet):
    """Residuals are state: a resumed compressed run equals the
    uninterrupted one (bit for bit here), and both equal JAX's at dp=1
    (the port's one process quantizes what one JAX device does)."""
    x, y = w.ckpt_batch()
    mk = lambda: _port(jnet, "sgd", SGD, gradient_compression=GC)  # noqa
    a, ja = mk(), _jax(jnet, "sgd", SGD, n_dp=1, gradient_compression=GC)
    for _ in range(3):
        a.step(x, y)
        ja.step(x, y)
    assert any(float(r.abs().max()) > 0 for r in a._gc_residuals.values())
    with TrainerCheckpoint(tmp_path / "ckgc") as ck:
        ck.save(3, a, wait=True)
        after = [_loss(a.step(x, y)) for _ in range(2)]
        b = mk()
        assert ck.restore_latest(b) == 3
        resumed = [_loss(b.step(x, y)) for _ in range(2)]
    assert resumed == after
    _close(after, [_loss(ja.step(x, y)) for _ in range(2)])


def test_shard_opt_state_rejected_with_compression(jnet):
    with pytest.raises(MXNetError, match="gradient_compression"):
        _port(jnet, "sgd", {}, gradient_compression={"type": "2bit"},
              shard_optimizer_state=True)
    with pytest.raises(jmx.MXNetError):
        _jax(jnet, "sgd", {}, gradient_compression={"type": "2bit"},
             shard_optimizer_state=True)


def test_restore_across_compression_config_changes(tmp_path, jnet):
    """A plain checkpoint restores into a compressed trainer (residuals
    stay zero) and a compressed one into a plain trainer (the residuals
    on disk are ignored), as in JAX (dp=1 for the compressed steps)."""
    x, y = w.ckpt_batch()
    plain, jplain = _port(jnet, "sgd", SGD), _jax(jnet, "sgd", SGD, n_dp=1)
    plain.step(x, y)
    jplain.step(x, y)
    with TrainerCheckpoint(tmp_path / "p2c") as ck, \
            JaxCheckpoint(tmp_path / "jp2c") as jck:
        ck.save(1, plain, wait=True)
        jck.save(1, jplain, wait=True)
        comp = _port(jnet, "sgd", SGD, gradient_compression=GC)
        jcomp = _jax(jnet, "sgd", SGD, n_dp=1, gradient_compression=GC)
        assert ck.restore_latest(comp) == jck.restore_latest(jcomp) == 1
        assert all(float(r.abs().max()) == 0
                   for r in comp._gc_residuals.values())
        got, want = _loss(comp.step(x, y)), _loss(jcomp.step(x, y))
        assert got > 0
        _close([got], [want])
    comp2 = _port(jnet, "sgd", SGD, gradient_compression=GC)
    for _ in range(2):
        comp2.step(x, y)
    with TrainerCheckpoint(tmp_path / "c2p") as ck:
        ck.save(2, comp2, wait=True)
        plain2 = _port(jnet, "sgd", SGD)
        assert ck.restore_latest(plain2) == 2
        want = _by_path(comp2)
        for k, v in _by_path(plain2).items():
            assert torch.equal(v, want[k]), k
    _params_close(plain2, _jax_after(jnet, x, y, 2), jnet)


def _jax_after(jnet, x, y, steps):
    """JAX's compressed trainer at dp=1 after `steps` steps."""
    jst = _jax(jnet, "sgd", SGD, n_dp=1, gradient_compression=GC)
    for _ in range(steps):
        jst.step(x, y)
    return jst


def test_old_plain_sgd_checkpoint_restores_into_stateless_trainer(
        tmp_path, jnet, monkeypatch):
    """JAX's plain-SGD trainer keeps no optimizer state (its checkpoints
    hold none); the port's keeps momenta at momentum 0, which each step
    rewrites (m' = g). A checkpoint without optimizer state restores into
    the port's momentum-0 trainer: its weights, JAX's after the same
    step; an Adam trainer, which needs the state, refuses it."""
    x, y = w.ckpt_batch()
    a, ja = _port(jnet, "sgd", SGD), _jax(jnet, "sgd", SGD)
    a.step(x, y)
    ja.step(x, y)
    assert ja._opt_state == {}
    stateless = a._global_state
    monkeypatch.setattr(a, "_global_state", lambda: {
        k: v for k, v in stateless().items() if k != "opt_state"})
    with TrainerCheckpoint(tmp_path / "old") as ck:
        ck.save(1, a, wait=True)
        b = _port(jnet, "sgd", SGD)
        assert ck.restore_latest(b) == 1
        want = _by_path(a)
        for k, v in _by_path(b).items():
            assert torch.equal(v, want[k]), k
        _params_close(b, ja, jnet)
        _close([_loss(b.step(x, y))], [_loss(ja.step(x, y))])
        with pytest.raises(MXNetError, match="optimizer state"):
            ck.restore(1, _port(jnet))


def test_restore_latest_falls_back_past_corrupt_step(tmp_path, jnet):
    """A corrupt newest step (every data file clobbered, its metadata
    kept) is refused by its checksums, warned about, counted and dropped;
    restore_latest falls back to step 2, whose weights are JAX's after 2
    steps."""
    x, y = w.ckpt_batch()
    a, ja = _port(jnet), _jax(jnet)
    rejected = registry.counter("checkpoint.rejected")
    before = rejected.get(reason="checksum")
    with TrainerCheckpoint(tmp_path / "ck", max_to_keep=3) as ck:
        for s in (1, 2):
            a.step(x, y)
            ja.step(x, y)
            ck.save(s, a, wait=True)
        good = _by_path(a)
        a.step(x, y)
        ck.save(3, a, wait=True)
        step_dir = str(tmp_path / "ck" / "3")
        clobbered = 0
        for root, _dirs, files in os.walk(step_dir):
            for fn in files:
                if fn in (".metadata", COMMIT_BASENAME):
                    continue
                with open(os.path.join(root, fn), "wb") as f:
                    f.write(b"\x00garbage\x00" * 16)
                clobbered += 1
        assert clobbered > 0
        assert ck.latest_step() == 3
        b = _port(jnet)
        with pytest.warns(RuntimeWarning, match="step 3 .* unreadable"):
            restored = ck.restore_latest(b)
        assert restored == 2 and b._step_count == 2
        assert ck.all_steps() == [1, 2]
    assert rejected.get(reason="checksum") == before + 1
    for k, v in _by_path(b).items():
        assert torch.equal(v, good[k]), k
    _params_close(b, ja, jnet)


# -- across processes -------------------------------------------------------------
@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    """Gang A (4 ranks) saves, gang B (2 ranks) restores, gang C (2 ranks)
    tears a save. {mode: {rank: results}} and the checkpoint dir."""
    d = tmp_path_factory.mktemp("ckpt_gangs")
    ckdir = str(d / "ck")
    inputs = str(d / "inputs.pt")
    write_inputs(inputs, {"ckpt_dir": ckdir, "ckpt": gluon_params_from_jax(
        jax_net("ckpt", 7), "cpu")})
    out = {}
    for mode, n in (("ckpt_save", w.NPROC), ("ckpt_restore", 2)):
        res = str(d / mode)
        for r, (rc, log) in enumerate(run_gang(mode, n, inputs, res)):
            assert rc == 0 and "WORKER_%d_OK" % r in log, log[-6000:]
        out[mode] = {r: torch.load(os.path.join(res, "rank%d.pt" % r))
                     for r in range(n)}
    res = str(d / "ckpt_torn")
    out["torn"] = run_gang("ckpt_torn", 2, inputs, res, timeout=120, env={
        "MXTPU_CHAOS_RANK_1": "checkpoint.commit:kind=kill,after=1",
        "MXTPU_BARRIER_TIMEOUT_S": "5"})
    return out, ckdir


def test_elastic_restore_onto_smaller_world(gangs, jnet, tmp_path):
    """JAX :234: saved at 4 ranks, resumed at 2; the resumed run equals an
    uninterrupted 2-rank run restored from the same step (within 1e-5),
    and JAX's dp=8 -> dp=4 run; the loss keeps falling."""
    out, _ = gangs
    save, rest = out["ckpt_save"], out["ckpt_restore"]
    x, y = w.ckpt_batch()
    big = _jax(jnet)
    jlosses = [_loss(big.step(x, y)) for _ in range(w.CKPT["adam_steps"])]
    _close(save[0]["losses"], jlosses)
    with JaxCheckpoint(str(tmp_path / "jck")) as jck:
        jck.save(w.CKPT["adam_steps"], big, wait=True)
        small = _jax(jnet, n_dp=4)
        assert jck.restore_latest(small) == w.CKPT["adam_steps"]
    want = [_loss(small.step(x, y)) for _ in range(w.CKPT["resume_steps"])]
    for r in range(2):
        got = rest[r]
        assert got["restored"] == w.CKPT["adam_steps"]
        _close(got["resumed"], got["oracle"])
        _close(got["resumed"], want)
        assert got["resumed"][-1] < got["resumed"][0] * 1.05
        errs = rel_errs(got["resumed_state"], got["oracle_state"])
        assert max(errs.values()) <= TOL


def test_restore_onto_different_sharding(gangs):
    """JAX :50 restores a replicated dp checkpoint onto a dp x tp layout;
    the port (no tp) restores the 4-rank replicated Adam state onto a
    2-rank ZeRO-1 trainer: each rank takes its block of the rows, the
    whole state equals the saved one, and the next steps equal the
    replicated trainer's within 1e-5."""
    out, _ = gangs
    saved = out["ckpt_save"][0]
    for r in range(2):
        got = out["ckpt_restore"][r]
        assert got["zero_restored"] == w.CKPT["adam_steps"]
        for k, rows in got["zero_rows"].items():
            whole = tuple(saved["params"][k].shape)
            assert rows == ((whole[0] // 2,) + whole[1:]
                            if whole[0] % 2 == 0 else whole), (k, rows)
        errs = rel_errs(got["zero_at_restore"], {
            k: saved[k] for k in ("params", "aux", "opt_state")})
        assert max(errs.values()) == 0.0, errs
        _close(got["zero_resumed"], got["oracle"])


def test_elastic_restore_reshards_compression_residuals(gangs, jnet):
    """JAX :267: the residual banks saved at 4 ranks are resharded onto 2:
    each parameter's total over the streams is kept, and the resumed
    compressed run keeps training. The 4 ranks' residuals equal JAX's
    dp=4 banks after the same 4 steps."""
    out, _ = gangs
    save, rest = out["ckpt_save"], out["ckpt_restore"]
    x, y = w.ckpt_batch()
    jst = _jax(jnet, "sgd", SGD, n_dp=4, gradient_compression=GC)
    jl = [_loss(jst.step(x, y)) for _ in range(w.CKPT["comp_steps"])]
    _close(save[0]["comp_losses"], jl)
    banks = renamed(jst._gc_residuals, paths_of(jnet))
    totals = {}
    for k, bank in banks.items():
        got = np.stack([save[r]["residual"][k].double().numpy()
                        for r in range(w.NPROC)])
        assert np.abs(got - bank).max() <= TOL, k
        totals[k] = got.sum(0)
    assert any(np.abs(t).max() > 0 for t in totals.values())
    for r in range(2):
        assert rest[r]["comp_restored"] == w.CKPT["comp_steps"]
    for k, tot in totals.items():
        bank = np.stack([rest[r]["comp_residual"][k].double().numpy()
                         for r in range(2)])
        np.testing.assert_allclose(bank.sum(0), tot, rtol=1e-5, atol=1e-7)
    ls = rest[0]["comp_losses"]
    assert all(np.isfinite(ls)) and ls[-1] < ls[0] * 1.25


def test_torn_save_falls_back_to_the_last_committed_step(gangs, jnet):
    """Rank 1 killed between step 2's data and its manifest: rank 0's
    commit barrier fails, step 2 is left without a manifest, and
    restore_latest refuses it (uncommitted), warns, drops it and restores
    step 1, whose weights are JAX's after one step at dp=2."""
    out, ckdir = gangs
    (rc0, log0), (rc1, _) = out["torn"]
    assert rc1 == -9, rc1
    assert rc0 != 0 and "WORKER_0_OK" not in log0
    torn = os.path.join(ckdir, "torn")
    mngr = TrainerCheckpoint(torn)
    assert mngr.all_steps() == [1, 2]
    assert mngr.commit_manifest(1) is not None
    assert mngr.commit_manifest(2) is None
    rejected = registry.counter("checkpoint.rejected")
    before = rejected.get(reason="uncommitted")
    st = _port(jnet)
    with pytest.warns(RuntimeWarning, match="step 2 .* unreadable"):
        assert mngr.restore_latest(st) == 1
    mngr.close()
    assert rejected.get(reason="uncommitted") == before + 1
    assert mngr.all_steps() == [1]
    x, y = w.ckpt_batch()
    jst = _jax(jnet, n_dp=2)
    jst.step(x, y)
    _params_close(st, jst, jnet)
    shutil.rmtree(torn, ignore_errors=True)
