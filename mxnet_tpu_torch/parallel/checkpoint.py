"""Checkpoints of a `ShardedTrainer` on `torch.distributed.checkpoint`
(counterpart of mxnet_tpu/parallel/checkpoint.py: `_state_of` :60,
`TrainerCheckpoint` :73, `save` :118, `_commit` :194, `_reject_reason`
:233, `restore` :285, `_lenient_restore` :347, `_reshard_residuals` :391,
`restore_latest` :421, `drop_steps_after` :475)::

    from mxnet_tpu_torch.parallel import checkpoint as ckpt
    mngr = ckpt.TrainerCheckpoint(dir, max_to_keep=3, async_save=True)
    mngr.save(step, trainer)             # returns once the state is copied
    step = mngr.restore_latest(trainer)  # -> the restored step or None

What a step holds is the trainer's state in global form
(`ShardedTrainer._global_state`): parameters, BatchNorm statistics, the
whole optimizer state (ZeRO-1's blocks of rows all-gathered), the step
count and, with gradient compression, each parameter's bank of every
rank's error-feedback residual, (n_dp, ...) as JAX lays it out. So any
world size restores it: each rank takes its own blocks, and a residual
bank saved at another n_dp is resharded (its total over the streams,
which is all error feedback needs, spread evenly).

Across processes every rank calls `save` and `restore` alike (gathering
is a collective). The primary rank (rank 0 unless `primary` says)
writes: ``torch.distributed.checkpoint.save`` with ``no_dist=True`` of the
gathered state into ``<dir>/.<step>.tmp``, renamed to ``<dir>/<step>``
when whole, so a step directory always holds complete data. Every rank
reads the step back on restore (a shared filesystem).

Two-phase commit, as JAX's: after the data, ``<step>/mxtpu_commit.json``
(a sha256/size map of the step's files) is written atomically by the
primary through `resilience.atomic_write`, after `commit_barrier` (by
default, inside a process group, a barrier of the gang bounded by
``MXTPU_BARRIER_TIMEOUT_S``) confirms every rank reached the commit.
`restore_latest` refuses a step newer than the newest committed one that
has no manifest (a torn save) or whose checksums fail, warns, drops it
and falls back, counted in ``checkpoint.rejected{reason}``; a directory
with no manifest at all is a legacy one and is tried step by step. A
barrier forces synchronous commits (every rank mirrors one barrier a
save).

``async_save=True``: `save` returns once the state is on the host; a
background thread writes it, and its commit happens at the next `save`,
`wait_until_finished`, `restore*` or `close`. ``max_to_keep`` prunes the
oldest steps after each commit. Chaos sites: ``checkpoint.save`` (before
the data, retried up to ``MXTPU_CKPT_SAVE_RETRIES``) and
``checkpoint.commit`` (after it, before the barrier). ``MXTPU_CKPT_VERIFY=0``
trusts a manifest without reading the files back.

Lenient restore (JAX :347): a checkpoint without compression residuals
restores into a compressed trainer (the residuals stay zero), residuals
on disk are ignored by a plain one, and a checkpoint without optimizer
state (a stateless plain-SGD trainer's, as JAX saves momentum 0) restores
into the port's SGD trainer at momentum 0, whose momenta every step
rewrites; any other difference of keys or shapes raises, naming it,
before any data is read.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import torch

from ..base import MXNetError, getenv
from ..observability import registry as _obs
from ..observability import telemetry as _tele
from ..resilience.atomic import atomic_write
from ..resilience.chaos import chaos_point
from ..resilience.retry import RetryPolicy, TransientError, retry_call
from .mesh import _gang

__all__ = ["COMMIT_BASENAME", "TrainerCheckpoint"]

COMMIT_BASENAME = "mxtpu_commit.json"

COMMIT_SECONDS = _obs.histogram(
    "checkpoint.commit.seconds",
    "Wall time of one two-phase checkpoint commit (barrier + checksum "
    "manifest + atomic marker)")
REJECTED = _obs.counter(
    "checkpoint.rejected",
    "Checkpoint steps refused at restore time (label reason: "
    "uncommitted / checksum)")

# the keys a restore may find missing or extra and migrate
_MIGRATABLE = {"gc_residuals", "opt_state"}


def _gang_barrier():
    """Every rank of the process group reached this point, within
    ``MXTPU_BARRIER_TIMEOUT_S`` (then `DeadlineExceeded`; in a supervised
    gang, `PeerLost` as soon as a peer is dead)."""
    import torch.distributed as dist
    from ..resilience.supervisor import peer_checker
    from .kvstore_dist import bounded_barrier, rank_device
    bounded_barrier(getenv("MXTPU_BARRIER_TIMEOUT_S", 600.0),
                    "checkpoint commit barrier", rank_device(),
                    peer_checker(exclude_rank=dist.get_rank()))


def _dcp(fn, state, path):
    """`torch.distributed.checkpoint` `fn` (save or load) in this process
    alone (its warning that no group is up says nothing here)."""
    import torch.distributed.checkpoint as dcp
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*torch.distributed is "
                                "disabled")
        return getattr(dcp, fn)(state, checkpoint_id=path, no_dist=True)


def _flat(tree, prefix=""):
    """{name: leaf} of a nested dict, the levels joined by "/" (the
    checkpoint's names: ``params/features.0.weight``; a block path holds
    dots, never a slash)."""
    out = {}
    for k, v in tree.items():
        name = prefix + k
        if isinstance(v, dict):
            out.update(_flat(v, name + "/"))
        else:
            out[name] = v
    return out


def _top(name):
    return name.split("/", 1)[0]


def _nest(flat):
    out = {}
    for name, v in flat.items():
        node = out
        *path, leaf = name.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


class TrainerCheckpoint:
    """Checkpoint manager for a `ShardedTrainer` (parameters, BatchNorm
    statistics, optimizer state, step count, residuals), optionally
    asynchronous (module note). `commit_barrier`: a zero-argument
    callable run before the manifest (default: the gang's barrier inside
    a process group, none otherwise); `primary`: whether this process
    writes data and manifests (default: rank 0, or the one process);
    `single_host`: no commit barrier even inside a process group."""

    def __init__(self, directory, max_to_keep=None, async_save=False,
                 commit_barrier=None, primary=None, single_host=False):
        self._dir = os.path.abspath(str(directory))
        os.makedirs(self._dir, exist_ok=True)
        gang = _gang()
        self._world = 1 if gang is None else gang[0]
        self._primary = (gang is None or gang[1] == 0) if primary is None \
            else bool(primary)
        if commit_barrier is None and gang is not None and not single_host:
            commit_barrier = _gang_barrier
        self._commit_barrier = commit_barrier
        self._max_to_keep = max_to_keep
        self._async = bool(async_save)
        self._verify = getenv("MXTPU_CKPT_VERIFY", True)
        self._pending = []    # saved steps whose commit is due
        self._writes = []     # the background writes not yet waited on
        self._pool = ThreadPoolExecutor(1, thread_name_prefix="mxtpu-ckpt") \
            if self._async else None
        self._save_retry_pol = None

    # -- save ---------------------------------------------------------------
    def save(self, step, trainer, wait=False):
        """Write a checkpoint of `trainer` as `step`. Asynchronous, it
        returns once the state is copied to the host; the write overlaps
        the next steps (``wait=True`` blocks). A transient fault at the
        ``checkpoint.save`` site is retried (``MXTPU_CKPT_SAVE_RETRIES``)."""
        step = int(step)
        state = trainer._global_state()
        sync = wait or not self._async or self._commit_barrier is not None

        def attempt():
            chaos_point("checkpoint.save")
            if self._primary:
                if os.path.exists(self._step_dir(step)):
                    raise MXNetError("checkpoint step %d already exists in "
                                     "%s" % (step, self._dir))
                if sync:
                    self._write(step, state)
                else:
                    self._writes.append(self._pool.submit(self._write, step,
                                                          state))
        if self._save_retry_pol is None:
            self._save_retry_pol = RetryPolicy(
                max_attempts=getenv("MXTPU_CKPT_SAVE_RETRIES", 5),
                base_delay=getenv("MXTPU_RETRY_BASE_DELAY_S", 0.05),
                retry_on=(TransientError,), what="checkpoint.save")
        retry_call(attempt, policy=self._save_retry_pol)
        if sync:
            self._finalize_pending()
            self._commit(step)
        else:
            self._pending.append(step)

    def _write(self, step, state):
        tmp = os.path.join(self._dir, ".%d.tmp" % step)
        shutil.rmtree(tmp, ignore_errors=True)
        _dcp("save", _flat(state), tmp)
        os.rename(tmp, self._step_dir(step))

    def _wait_writes(self):
        writes, self._writes = self._writes, []
        for w in writes:
            w.result()

    # -- two-phase commit ---------------------------------------------------
    def _step_dir(self, step):
        return os.path.join(self._dir, str(int(step)))

    def _commit_path(self, step):
        return os.path.join(self._step_dir(step), COMMIT_BASENAME)

    @staticmethod
    def _hash_tree(step_dir):
        """Per-file sha256/size map of a step directory (the manifest
        body): relative paths, sorted, the manifest itself excluded."""
        files = {}
        for root, _dirs, names in os.walk(step_dir):
            for name in sorted(names):
                rel = os.path.relpath(os.path.join(root, name), step_dir)
                if rel == COMMIT_BASENAME:
                    continue
                h = hashlib.sha256()
                path = os.path.join(root, name)
                with open(path, "rb") as f:
                    for chunk in iter(lambda: f.read(1 << 20), b""):
                        h.update(chunk)
                files[rel] = {"sha256": h.hexdigest(),
                              "bytes": os.path.getsize(path)}
        return files

    def _commit(self, step):
        """Seal a saved step: the chaos site, the commit barrier (every
        rank runs it, whatever became of the step), then the primary's
        manifest and the pruning to `max_to_keep`."""
        t0 = time.perf_counter()
        chaos_point("checkpoint.commit")
        if self._commit_barrier is not None:
            self._commit_barrier()
        step_dir = self._step_dir(step)
        if not os.path.isdir(step_dir):
            return False
        if self._primary and not os.path.exists(self._commit_path(step)):
            manifest = {"step": int(step), "ts": time.time(),
                        "world": self._world,
                        "files": self._hash_tree(step_dir)}
            with atomic_write(self._commit_path(step), "w") as f:
                f.write(json.dumps(manifest, sort_keys=True))
        if self._primary and self._max_to_keep:
            for s in self.all_steps()[:-int(self._max_to_keep)]:
                self._drop_step(s)
        dt = time.perf_counter() - t0
        COMMIT_SECONDS.observe(dt)
        _tele.emit({"ts": time.time(), "source": "resilience",
                    "event": "ckpt_commit", "step": int(step),
                    "step_time": dt})
        return True

    def commit_manifest(self, step):
        """The step's commit manifest, or None (uncommitted or torn)."""
        try:
            with open(self._commit_path(step)) as f:
                rec = json.loads(f.read())
        except (OSError, ValueError):
            return None
        return rec if isinstance(rec, dict) else None

    def committed_steps(self):
        return [s for s in self.all_steps()
                if self.commit_manifest(s) is not None]

    def _reject_reason(self, step, newest_committed=None, manifest=None):
        """Why `step` must not be restored, or None (JAX :233): no
        manifest and newer than the newest committed step (torn), or a
        manifest whose checksums the files fail."""
        if manifest is None:
            manifest = self.commit_manifest(step)
        if manifest is None:
            if newest_committed is not None and step > newest_committed:
                REJECTED.inc(reason="uncommitted")
                return ("no commit marker — the save was torn before all "
                        "ranks finished")
            return None    # a legacy step (before two-phase commit)
        if not self._verify:
            return None
        want = manifest.get("files", {})
        try:
            have = self._hash_tree(self._step_dir(step))
        except OSError as err:
            REJECTED.inc(reason="checksum")
            return "unreadable during verification (%s)" % err
        if want != have:
            missing = sorted(set(want) - set(have))
            extra = sorted(set(have) - set(want))
            changed = sorted(k for k in set(want) & set(have)
                             if want[k] != have[k])
            REJECTED.inc(reason="checksum")
            return ("checksum manifest mismatch: %d missing, %d changed, %d "
                    "unexpected file(s)%s"
                    % (len(missing), len(changed), len(extra),
                       ((" — first: %r" % (missing + changed + extra)[0])
                        if (missing or changed or extra) else "")))
        return None

    # -- steps --------------------------------------------------------------
    def all_steps(self):
        """The steps whose data is whole, ascending."""
        return sorted(int(n) for n in os.listdir(self._dir)
                      if n.isdigit() and os.path.isdir(os.path.join(
                          self._dir, n)))

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- restore ------------------------------------------------------------
    def _saved(self, step):
        """{name: (shape or None for a non-tensor, dtype)} of a step's
        data, from its metadata alone."""
        import torch.distributed.checkpoint as dcp
        md = dcp.FileSystemReader(self._step_dir(step)).read_metadata()
        out = {}
        for name, m in md.state_dict_metadata.items():
            size = getattr(m, "size", None)
            out[name] = (None, None) if size is None else \
                (tuple(size), m.properties.dtype)
        return out

    def restore(self, step, trainer):
        """Restore `step` into `trainer` (onto its mesh, whatever the
        saving one was); returns the step. The trainer is written only
        after the whole state was read and checked."""
        self._wait_writes()
        target = _flat(trainer._global_shapes())
        try:
            saved = self._saved(step)
        except Exception:      # noqa: BLE001 - unreadable: let load decide
            saved = None
        tops = {_top(n) for n in target}
        if saved is not None:
            have = {_top(n) for n in saved}
            drift = {k for k in tops | have
                     if {n: saved[n][0] for n in saved if _top(n) == k} !=
                     {n: target[n] for n in target if _top(n) == k}}
            drift.discard("step")
            fatal = drift - _MIGRATABLE
            if fatal:
                raise MXNetError(
                    "checkpoint step %s cannot restore into this trainer: "
                    "saved shapes for %s do not match (metadata check)"
                    % (step, ", ".join(sorted(fatal))))
            if drift:
                state = self._lenient(step, saved, target, trainer)
            else:
                state = self._load(step, saved)
        else:
            state = self._load(step, None, target)
        trainer._load_global_state(state)
        return trainer._step_count

    def _load(self, step, saved, target=None):
        """The step's data as a nested state: every saved tensor (or, with
        no metadata, `target`'s shapes) and the step count."""
        if saved is None:
            shapes = {n: (s, torch.float32) for n, s in target.items()
                      if s is not None}
        else:
            shapes = {n: sd for n, sd in saved.items() if sd[0] is not None}
        flat = {n: torch.empty(s, dtype=dt) for n, (s, dt) in shapes.items()}
        flat["step"] = 0
        _dcp("load", flat, self._step_dir(step))
        return _nest(flat)

    def _lenient(self, step, saved, target, trainer):
        """The migrations of the module note, checked key by key."""
        state = self._load(step, saved)
        out = {}
        for top in ("params", "aux", "opt_state", "gc_residuals", "step"):
            want = {n: s for n, s in target.items() if _top(n) == top}
            if top not in state:
                if top == "opt_state" and want and not (
                        trainer._optimizer == "sgd" and
                        not trainer._hp["momentum"]):
                    raise MXNetError(
                        "checkpoint step %s holds no optimizer state; this "
                        "trainer needs it" % (step,))
                continue          # absent on disk: the trainer's stays
            if not want:
                continue          # extra on disk (residuals): ignored
            if top == "gc_residuals":
                out[top] = self._reshard_residuals(state[top], {
                    n.split("/", 1)[1]: s for n, s in want.items()})
                continue
            got = {n: tuple(v.shape) for n, v in _flat(
                {top: state[top]}).items()} if top != "step" else want
            if got != want:
                raise MXNetError(
                    "checkpoint step %s: %r on disk does not match the "
                    "trainer's (%s)" % (step, top, sorted(
                        set(got.items()) ^ set(want.items()))[:2]))
            out[top] = state[top]
        return out

    @staticmethod
    def _reshard_residuals(saved, target):
        """Residual banks across a change of world size (JAX :391): each
        parameter's total over the streams, spread evenly over the new
        ones. Only the leading axis may differ."""
        out = {}
        for name, shape in target.items():
            old = saved[name]
            if tuple(old.shape) == tuple(shape):
                out[name] = old
                continue
            if tuple(old.shape[1:]) != tuple(shape[1:]):
                raise MXNetError(
                    "checkpoint residual bank %r has per-stream shape %s on "
                    "disk but the trainer expects %s — only the leading "
                    "(world size) axis may differ"
                    % (name, tuple(old.shape[1:]), tuple(shape[1:])))
            total = old.sum(dim=0)
            out[name] = (total / shape[0]).expand(shape).clone()
        return out

    def restore_latest(self, trainer):
        """Restore the newest complete, readable step; its number, or None
        when there is none. Torn or corrupt steps are refused, warned
        about, dropped (primary) and counted; unreadable ones are skipped
        with a warning; when every step fails the last error is raised
        inside an MXNetError (JAX :421)."""
        self._finalize_pending()
        steps = sorted(self.all_steps(), reverse=True)
        if not steps:
            return None
        manifests = {s: self.commit_manifest(s) for s in steps}
        committed = [s for s in steps if manifests[s] is not None]
        newest_committed = max(committed) if committed else None
        last_err = None
        for i, step in enumerate(steps):
            if committed:
                reason = self._reject_reason(step, newest_committed,
                                             manifest=manifests[step])
                if reason is not None:
                    last_err = MXNetError("checkpoint step %d rejected: %s"
                                          % (step, reason))
                    self._warn_fallback(step, steps, i, reason)
                    if self._primary:
                        self._drop_step(step)
                    continue
            try:
                return self.restore(step, trainer)
            except Exception as err:  # noqa: BLE001 - the next one
                last_err = err
                self._warn_fallback(step, steps, i, "%s: %s"
                                    % (type(err).__name__, err))
        raise MXNetError("no complete readable checkpoint among steps %s "
                         "in %s" % (sorted(steps), self._dir)) from last_err

    def drop_steps_after(self, step):
        """Drop every step newer than `step`, committed or not; returns
        them, ascending (primary only)."""
        self._finalize_pending()
        dropped = []
        if not self._primary:
            return dropped
        for s in self.all_steps():
            if s > step:
                self._drop_step(s)
                dropped.append(int(s))
        return dropped

    def _drop_step(self, step):
        shutil.rmtree(self._step_dir(step), ignore_errors=True)

    def _warn_fallback(self, step, steps, i, why):
        if i + 1 < len(steps):
            warnings.warn("checkpoint step %d in %s is unreadable (%s); "
                          "falling back to step %d"
                          % (step, self._dir, why, steps[i + 1]),
                          RuntimeWarning)

    def _finalize_pending(self):
        """Finish the background writes and commit their steps."""
        self._wait_writes()
        pending, self._pending = self._pending, []
        for s in pending:
            self._commit(s)

    def wait_until_finished(self):
        self._finalize_pending()

    def close(self):
        try:
            self._finalize_pending()
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
