"""Training numerics guard: in-step anomaly detection and skip, dynamic
loss scaling, divergence rollback and SDC replay (counterpart of
mxnet_tpu/resilience/numerics.py).

Four layers, outermost first:

1. **Detection and skip in the step.** `ShardedTrainer.step` skips an
   update whose gradients are not all finite, leaving parameters,
   momentum and BatchNorm statistics as they were, and records its
   verdict here as where="step", as does the fused exchange + update step
   (`parallel.fused_step`, under `gluon.Trainer` and `Module`);
   `parallel.FusedUpdater` (the staged path) skips each such group the
   same way and records one verdict per update as where="update"; the
   distributed store's bucketed exchange records one verdict per bucket
   as where="exchange" (an anomaly, not a skip). `step_many` runs its
   steps unguarded and records one verdict for the window
   (where="window"): detection only, since a bad window's weights were
   written. A verdict is a bool or a 0-d (or 1-d) device tensor, appended
   by `record_flag` without a host read; the host reads each once, when
   `drain_flags` resolves them all at the next step boundary.
2. **Dynamic loss scaling** (`GradScaler`): halve on overflow, grow after
   ``MXTPU_SCALE_WINDOW`` clean steps. `gluon.Trainer.scale_loss` arms it,
   so the default-on guard never changes an unscaled run.
3. **Divergence watchdog and rollback** (`DivergenceWatchdog`): a step is
   bad when its loss (or gradient norm) is not finite, spikes past
   ``MXTPU_DIVERGE_FACTOR`` times the rolling median, or was skipped.
   After ``MXTPU_DIVERGE_PATIENCE`` bad steps in a row the guard drops the
   committed checkpoints newer than the last trusted step
   (`TrainerCheckpoint.drop_steps_after`), restores the newest surviving
   one and raises `TrainingDiverged` (exit code 77), which a
   `GangSupervisor` answers with a relaunch.
4. **SDC replay** (`NumericsGuard.attach_replay`): on the first anomaly of
   a wholly skipped step the guard re-runs the step's gradients from the
   preserved pre-step state and compares digests bit for bit: different
   bits mean suspected silent data corruption on the device
   (``numerics.sdc.suspected{device}``), the same bits a data or
   optimization problem.

`NumericsGuard.step_boundary` is where the flags are read: the trainers
call it once a step (`gluon.Trainer.step`, `Module.fit`), inside their
``numerics`` phase. Reading a verdict waits for the kernel that made it:
on the card the boundary's host read is where the host meets the device.

Env knobs (as the JAX package's):
  MXTPU_NUMERICS             guard on/off                      (1)
  MXTPU_SCALE_INIT           initial loss scale                (65536)
  MXTPU_SCALE_WINDOW         clean steps before the scale grows (200)
  MXTPU_DIVERGE_PATIENCE     consecutive bad steps before rollback (6)
  MXTPU_DIVERGE_FACTOR       spike threshold vs rolling median (10)
  MXTPU_DIVERGE_WINDOW       rolling-median window             (32)
  MXTPU_SDC_REPLAY           replay-classify the first anomaly (1)
"""
from __future__ import annotations

import hashlib
import sys
import threading
import time
from collections import deque

import numpy as np
import torch

from ..base import MXNetError, getenv
from ..observability import registry as _obs
from ..observability import telemetry as _tele

__all__ = ["EXIT_DIVERGED", "DivergenceWatchdog", "GradScaler",
           "NumericsGuard", "TrainingDiverged", "digest", "drain_flags",
           "enabled", "note_unguarded", "pending_flags", "record_flag",
           "reset_flags", "sdc_replay_enabled"]

EXIT_DIVERGED = 77

SKIPPED = _obs.counter(
    "numerics.skipped_steps",
    "Training steps where at least one update group was skipped "
    "because its gradients were not finite")
ANOMALIES = _obs.counter(
    "numerics.anomalies",
    "Numeric anomalies observed (label kind: nonfinite / spike / "
    "deterministic)")
LOSS_SCALE = _obs.gauge(
    "numerics.loss_scale",
    "Current dynamic loss scale (GradScaler; set only when armed)")
ROLLBACKS = _obs.counter(
    "numerics.rollbacks",
    "Divergence rollbacks performed (committed checkpoints dropped, "
    "restore, TrainingDiverged)")
SDC_SUSPECTED = _obs.counter(
    "numerics.sdc.suspected",
    "Anomalies whose deterministic replay produced bit-different "
    "gradients: suspected silent data corruption (label device)")

# the stderr markers are what tools/chaos_run.py greps for; a run that
# stays NaN must not flood stderr with them
_MAX_MARKERS = 8


def enabled():
    """MXTPU_NUMERICS gate, re-read per call (default on)."""
    return getenv("MXTPU_NUMERICS", True)


def sdc_replay_enabled():
    return getenv("MXTPU_SDC_REPLAY", True)


def _marker(guard, text):
    """A greppable ``MXTPU_NUMERICS ...`` line on stderr."""
    if guard._markers >= _MAX_MARKERS:
        if guard._markers == _MAX_MARKERS:
            guard._markers += 1
            print("MXTPU_NUMERICS further markers suppressed",
                  file=sys.stderr, flush=True)
        return
    guard._markers += 1
    print("MXTPU_NUMERICS %s" % text, file=sys.stderr, flush=True)


# -- the flag collector --------------------------------------------------
_flags_lock = threading.Lock()
_flags = []          # [(flag, keys, where)]
_FLAG_CAP = 4096     # loops that never drain stay bounded
_carry = {"bad": 0, "total": 0, "skipped": 0}
_unguarded = [0]     # updates applied outside the guard since the drain

# where a verdict comes from, and what a bad one means:
#   "update"   a FusedUpdater group skipped with its state preserved
#   "step"     a whole step skipped with its state preserved (the
#              ShardedTrainer step, the fused exchange + update step)
#   "exchange" an exchange bucket carried non-finite values (attribution
#              only: whether the update was skipped is the update's flag)
#   "window"   a step_many window went bad (detection only)
_PROTECTED = ("update", "step")


def record_flag(flag, keys=None, where="update"):
    """Record one ok verdict (a bool, or a 0-d or 1-d bool tensor; True
    is finite). Never reads the device; `drain_flags` resolves it."""
    with _flags_lock:
        _flags.append((flag, keys, where))
        if len(_flags) > _FLAG_CAP:
            old = _flags.pop(0)
            bad, total = _resolve(old[0])
            _carry["bad"] += bad
            _carry["total"] += total
            if old[2] in _PROTECTED:
                _carry["skipped"] += bad
    return flag


def note_unguarded(n=1):
    """Count updates that ran outside the guard this step (a
    FusedUpdater's per-key leftovers): they veto `full_skip`, so a step
    that was only partly skipped never claims a sound SDC replay."""
    with _flags_lock:
        _unguarded[0] += int(n)


def _host(flag):
    if isinstance(flag, torch.Tensor):
        return flag.detach().cpu().numpy()
    return np.asarray(flag)


def _resolve(flag):
    """(bad_count, total_count) of one recorded flag (the host read)."""
    arr = _host(flag)
    if arr.ndim == 0:
        return (0 if bool(arr) else 1), 1
    return int(np.size(arr) - np.count_nonzero(arr)), int(np.size(arr))


def drain_flags():
    """Resolve and clear every pending flag (JAX numerics.py:222).
    Returns a dict:

    - ``bad`` / ``total``: raw flag counts of every provenance;
    - ``skipped_steps``: steps whose state was provably preserved (bad
      "update"/"step" flags); scalar flags collapse to at most one
      skipped step a drain (several groups of one step may fail
      together), a vector flag counts one a False entry;
    - ``anomalies``: incidents, deduplicated: protected and window bads,
      plus exchange bads only when no protected flag rode the drain;
    - ``full_skip``: every protected flag bad, nothing unguarded, no
      window verdicts: the precondition of a sound SDC replay;
    - ``bad_keys`` / ``by_where`` / ``exchange_bad`` / ``unguarded``.

    Counts nothing in the registry: `NumericsGuard.step_boundary` does."""
    with _flags_lock:
        pending, _flags[:] = list(_flags), []
        carry = dict(_carry)
        _carry.update(bad=0, total=0, skipped=0)
        unguarded, _unguarded[0] = _unguarded[0], 0
    bad, total = carry["bad"], carry["total"]
    scalar_protected_bad = 0
    vector_skipped = carry["skipped"]
    bad_keys = []
    by_where = {}
    for flag, keys, where in pending:
        b, t = _resolve(flag)
        bad += b
        total += t
        wb, wt = by_where.get(where, (0, 0))
        by_where[where] = (wb + b, wt + t)
        if np.ndim(_host(flag)) == 0:
            if b:
                if where in _PROTECTED:
                    scalar_protected_bad += 1
                if keys:
                    bad_keys.extend(list(keys)[:8])
        elif where in _PROTECTED:
            vector_skipped += b
    skipped = (1 if scalar_protected_bad else 0) + vector_skipped
    prot_bad = sum(by_where.get(w, (0, 0))[0] for w in _PROTECTED)
    prot_total = sum(by_where.get(w, (0, 0))[1] for w in _PROTECTED)
    window_bad = by_where.get("window", (0, 0))[0]
    exchange_bad = by_where.get("exchange", (0, 0))[0]
    anomalies = prot_bad + window_bad + \
        (exchange_bad if prot_total == 0 else 0)
    full_skip = (prot_total > 0 and prot_bad == prot_total
                 and unguarded == 0 and window_bad == 0)
    return {"bad": bad, "total": total, "skipped_steps": skipped,
            "anomalies": anomalies, "bad_keys": bad_keys,
            "by_where": by_where, "exchange_bad": exchange_bad,
            "unguarded": unguarded, "full_skip": full_skip}


def pending_flags():
    with _flags_lock:
        return len(_flags)


def reset_flags():
    """Drop pending flags (tests)."""
    with _flags_lock:
        _flags[:] = []
        _carry.update(bad=0, total=0, skipped=0)
        _unguarded[0] = 0


def _raw_bytes(t):
    """A tensor's bytes as the host holds them (bf16 included)."""
    t = t.detach().contiguous().cpu()
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


def digest(arrays):
    """Order-sensitive sha256 over the shape, dtype and raw bytes of a
    list of arrays (NDArrays, tensors, numpy). A host read: the anomaly
    path (SDC replay) only, never each step."""
    h = hashlib.sha256()
    for a in arrays:
        if hasattr(a, "_data"):           # NDArray
            a = a._data
        if isinstance(a, torch.Tensor):
            h.update(str(tuple(a.shape)).encode())
            h.update(str(a.dtype).encode())
            h.update(_raw_bytes(a))
        else:
            arr = np.asarray(a)
            h.update(str(arr.shape).encode())
            h.update(str(arr.dtype).encode())
            h.update(arr.tobytes())
    return h.hexdigest()


def _device_of(arrays):
    """The device of the first tensor (the SDC suspect)."""
    for a in arrays or ():
        data = getattr(a, "_data", a)
        if isinstance(data, torch.Tensor):
            return str(data.device)
    return "unknown"


# -- dynamic loss scaling ------------------------------------------------
class GradScaler:
    """Dynamic loss scale: halve on overflow, double after
    `growth_interval` clean steps in a row, within [`min_scale`,
    `max_scale`]. Starts disarmed: `update` does nothing and the scale
    reads 1.0 until the first `scale_loss` arms it."""

    def __init__(self, init_scale=None, growth_factor=2.0,
                 backoff_factor=0.5, growth_interval=None,
                 min_scale=1.0, max_scale=2.0 ** 24):
        self._scale = float(init_scale if init_scale is not None
                            else getenv("MXTPU_SCALE_INIT", 65536.0))
        self.growth_factor = float(growth_factor)
        self.backoff_factor = float(backoff_factor)
        self.growth_interval = int(
            growth_interval if growth_interval is not None
            else getenv("MXTPU_SCALE_WINDOW", 200))
        self.min_scale = float(min_scale)
        self.max_scale = float(max_scale)
        self.armed = False
        self.good_steps = 0
        self.overflows = 0

    @property
    def scale(self):
        return self._scale if self.armed else 1.0

    def scale_loss(self, loss):
        """The loss times the scale, for the backward; arms the scaler."""
        self.armed = True
        LOSS_SCALE.set(self._scale)
        return loss * self._scale

    def unscale_factor(self):
        """What the optimizer folds into rescale_grad (1/scale)."""
        return 1.0 / self.scale

    def update(self, overflow):
        """Advance the schedule by one step's verdict."""
        if not self.armed:
            return self.scale
        if overflow:
            self.overflows += 1
            self.good_steps = 0
            self._scale = max(self.min_scale,
                              self._scale * self.backoff_factor)
        else:
            self.good_steps += 1
            if self.good_steps >= self.growth_interval:
                self.good_steps = 0
                self._scale = min(self.max_scale,
                                  self._scale * self.growth_factor)
        LOSS_SCALE.set(self._scale)
        return self._scale


# -- divergence watchdog -------------------------------------------------
class DivergenceWatchdog:
    """Rolling spike detector over a per-step value (loss or gradient
    norm). A step is bad when its value is not finite, exceeds `factor`
    times the rolling median of recent good values (after `min_history`
    of them), or the guard skipped it. `observe` returns True once
    `patience` bad steps came in a row."""

    def __init__(self, patience=None, factor=None, window=None,
                 min_history=5):
        self.patience = int(patience if patience is not None
                            else getenv("MXTPU_DIVERGE_PATIENCE", 6))
        self.factor = float(factor if factor is not None
                            else getenv("MXTPU_DIVERGE_FACTOR", 10.0))
        maxlen = int(window if window is not None
                     else getenv("MXTPU_DIVERGE_WINDOW", 32))
        self._window = deque(maxlen=max(1, maxlen))
        self.min_history = int(min_history)
        self.bad_streak = 0
        self.first_bad_step = None

    def median(self):
        if not self._window:
            return None
        vals = sorted(self._window)
        return vals[len(vals) // 2]

    def is_spike(self, value):
        if value is None:
            return False
        v = float(value)
        if not np.isfinite(v):
            return True
        med = self.median()
        if med is None or len(self._window) < self.min_history:
            return False
        return abs(v) > self.factor * max(abs(med), 1e-12)

    def observe(self, step, value=None, anomalous=False):
        bad = bool(anomalous) or self.is_spike(value)
        if bad:
            if self.bad_streak == 0:
                self.first_bad_step = step
            self.bad_streak += 1
            if not anomalous:
                # the guard counted its own nonfinite anomalies; only the
                # watchdog's spikes count here
                ANOMALIES.inc(kind="spike")
        else:
            self.bad_streak = 0
            self.first_bad_step = None
            if value is not None and np.isfinite(float(value)):
                self._window.append(abs(float(value)))
        return self.bad_streak >= self.patience

    def last_good_step(self):
        """The newest checkpoint step above suspicion: a bad value at
        step S came from weights written at S-1, so S-2 is trusted."""
        if self.first_bad_step is None:
            return None
        return int(self.first_bad_step) - 2


class TrainingDiverged(MXNetError):
    """Raised after ``MXTPU_DIVERGE_PATIENCE`` bad steps in a row, once
    the guard rolled back (suspect checkpoints dropped, the trusted one
    restored), so a supervised relaunch resumes from healthy state.
    `.exit_code` is 77, the gang's contract (`resilience.supervisor`)."""

    exit_code = EXIT_DIVERGED

    def __init__(self, msg, step=None, restored_step=None,
                 first_bad_step=None):
        super().__init__(msg)
        self.step = step
        self.restored_step = restored_step
        self.first_bad_step = first_bad_step


# -- the guard -----------------------------------------------------------
class NumericsGuard:
    """The step boundary's state machine over the flags: counters and
    telemetry, the loss-scale schedule, SDC replay on the first anomaly,
    and the divergence watchdog's rollback and `TrainingDiverged`. One
    guard a training loop (`gluon.Trainer` and `Module.fit` own theirs);
    not thread-safe."""

    def __init__(self, source="train", scaler=None, watchdog=None):
        self.source = source
        self.scaler = scaler
        self.watchdog = watchdog or DivergenceWatchdog()
        self._rollback = None        # (TrainerCheckpoint, state holder)
        self._replay_fn = None
        self._replay_done = False
        self._pending_note = {}
        self._markers = 0
        self._step = 0
        self.last_report = None

    def attach_rollback(self, checkpoint, state):
        """Arm divergence rollback: `checkpoint` is a
        `parallel.TrainerCheckpoint`, `state` what it saves and restores
        (a trainer)."""
        self._rollback = (checkpoint, state)
        return self

    def attach_replay(self, fn):
        """Arm SDC replay: `fn()` re-runs the step's gradients from the
        preserved pre-step state and returns the recomputed gradient
        arrays. Only the first anomaly ever replays."""
        self._replay_fn = fn
        return self

    def note(self, loss=None, grad_norm=None):
        """Stash this step's value for the next `step_boundary` (its own
        arguments win when both are given)."""
        if loss is not None:
            self._pending_note["loss"] = float(loss)
        if grad_norm is not None:
            self._pending_note["grad_norm"] = float(grad_norm)

    def step_boundary(self, step=None, loss=None, grad_norm=None,
                      grads=None):
        """Resolve the step's flags and run the state machine. Raises
        `TrainingDiverged` after a rollback; otherwise returns a report
        ``{"step", "bad", "anomalies", "skipped_steps", "sdc"}``."""
        if step is None:
            step = self._step
        self._step = int(step) + 1
        if loss is None:
            loss = self._pending_note.pop("loss", None)
        if grad_norm is None:
            grad_norm = self._pending_note.pop("grad_norm", None)
        self._pending_note.clear()
        resolved = drain_flags()
        any_bad = resolved["anomalies"] > 0
        verdict = None
        if any_bad:
            if resolved["skipped_steps"]:
                SKIPPED.inc(resolved["skipped_steps"])
            ANOMALIES.inc(resolved["anomalies"], kind="nonfinite")
            _tele.emit({"ts": time.time(), "source": "resilience",
                        "event": "numerics_skip", "step": int(step),
                        "step_time": 0.0,
                        "bad_groups": resolved["bad"],
                        "anomalies": resolved["anomalies"],
                        "skipped_steps": resolved["skipped_steps"],
                        "exchange_bad": resolved["exchange_bad"],
                        "unguarded": resolved["unguarded"],
                        "bad_keys": [str(k) for k in
                                     resolved["bad_keys"][:8]],
                        "guard": self.source})
            _marker(self, "anomaly step=%d anomalies=%d skipped=%d "
                    "keys=%s"
                    % (step, resolved["anomalies"],
                       resolved["skipped_steps"],
                       resolved["bad_keys"][:4]))
            if (self._replay_fn is not None and not self._replay_done
                    and sdc_replay_enabled()
                    and resolved["full_skip"]):
                verdict = self._classify(step, grads)
        calibrating = (any_bad and self.scaler is not None
                       and self.scaler.armed
                       and self.scaler.scale > self.scaler.min_scale)
        if self.scaler is not None:
            self.scaler.update(any_bad)
        value = loss if loss is not None else grad_norm
        # an armed scaler with room to back off is calibrating: its
        # overflow skips do not count toward divergence
        if self.watchdog.observe(step, value,
                                 anomalous=any_bad and not calibrating):
            self._fire_rollback(step)
        report = {"step": int(step), "bad": resolved["bad"],
                  "anomalies": resolved["anomalies"],
                  "skipped_steps": resolved["skipped_steps"],
                  "sdc": verdict}
        self.last_report = report
        return report

    def _classify(self, step, grads):
        """Replay the anomalous step's gradients: the same bits mean the
        anomaly replays (data or optimization), different bits suspected
        SDC on the device that computed them."""
        self._replay_done = True
        if not grads:
            return None
        try:
            original = digest(grads)
            replayed = self._replay_fn()
            if replayed is None:
                _marker(self, "sdc replay returned no arrays — "
                              "verdict abstained")
                return None
            replay_digest = digest(replayed)
        except Exception as err:  # noqa: BLE001 - never fail the step
            _marker(self, "sdc replay failed: %s" % err)
            return None
        if replay_digest == original:
            verdict, device = "deterministic", None
            ANOMALIES.inc(kind="deterministic")
        else:
            verdict = "sdc"
            device = _device_of(grads)
            SDC_SUSPECTED.inc(device=device)
        _tele.emit({"ts": time.time(), "source": "resilience",
                    "event": "sdc_suspected" if verdict == "sdc"
                    else "anomaly_deterministic",
                    "step": int(step), "step_time": 0.0,
                    "device": device, "guard": self.source})
        _marker(self, "sdc verdict=%s step=%d device=%s"
                % (verdict, step, device))
        return verdict

    def _fire_rollback(self, step):
        t0 = time.perf_counter()
        last_good = self.watchdog.last_good_step()
        restored, dropped = None, []
        if self._rollback is not None:
            ckpt, state = self._rollback
            if last_good is not None:
                dropped = ckpt.drop_steps_after(last_good)
            try:
                restored = ckpt.restore_latest(state)
            except MXNetError:
                restored = None      # nothing restorable: a fresh start
        ROLLBACKS.inc()
        _tele.emit({"ts": time.time(), "source": "resilience",
                    "event": "numerics_rollback", "step": int(step),
                    "step_time": time.perf_counter() - t0,
                    "restored_step": restored,
                    "dropped_steps": [int(s) for s in dropped],
                    "guard": self.source})
        _marker(self, "rollback step=%d restored_step=%s dropped=%s"
                % (step, restored, [int(s) for s in dropped]))
        self.watchdog.bad_streak = 0
        first_bad, self.watchdog.first_bad_step = \
            self.watchdog.first_bad_step, None
        rolled_back = self._rollback is not None
        err = TrainingDiverged(
            "training diverged: %d consecutive bad steps ending at "
            "step %d; %s"
            % (self.watchdog.patience, step,
               ("rolled back to committed checkpoint step %s (dropped "
                "%s) — exit code %d asks the supervisor for a "
                "restart-with-rollback"
                % (restored, [int(s) for s in dropped], EXIT_DIVERGED))
               if rolled_back else
               "no rollback target attached (attach_rollback) — "
               "surfacing as a plain crash"),
            step=step, restored_step=restored, first_bad_step=first_bad)
        if not rolled_back:
            # exit 77 promises a rollback; without a checkpoint this is an
            # ordinary crash
            err.exit_code = 1
        raise err
