"""Preemption-safe training: SIGTERM/SIGINT become a checkpoint at the
next step boundary (counterpart of mxnet_tpu/resilience/preempt.py).

A machine that is taken away gets a SIGTERM and a grace window. A
`PreemptionGuard` turns the signal into a request: its handler only sets
a flag, and the training loops (`gluon.Trainer.step`,
`parallel.ShardedTrainer.step`/`step_many`, `Module.fit`) call
`at_step_boundary()` between optimizer steps, the one moment parameters,
optimizer state and step counter agree. There the guard runs its
synchronous save and raises `TrainingPreempted` carrying the saved step,
so a relaunched job resumes where this one stopped::

    with TrainerCheckpoint(dir) as ck, \\
         PreemptionGuard.for_trainer(ck, trainer):
        for x, y in batches:
            ...
            trainer.step(batch)     # SIGTERM: save, TrainingPreempted

Handlers are installed only while a guard is active and restored on exit.
A second signal while the first is still pending raises
`KeyboardInterrupt` at once: the loop is not reaching a boundary.

`at_step_boundary` is also the ``worker.kill`` chaos site. The JAX
package's cold-start marker there belongs to the compile plane
(ROADMAP A9b) and is not ported.
"""
from __future__ import annotations

import signal

from ..base import MXNetError
from .chaos import chaos_point

__all__ = ["PreemptionGuard", "TrainingPreempted", "at_step_boundary",
           "preemption_requested"]


class TrainingPreempted(MXNetError):
    """Raised at a step boundary after a preemption signal; `.step` is
    the step the final checkpoint captured (None without a save).
    `.exit_code` is 75, the gang's contract (`resilience.supervisor`):
    eviction, so the supervisor stops instead of restarting."""

    exit_code = 75

    def __init__(self, msg, step=None):
        super().__init__(msg)
        self.step = step


_requested = {"sig": None}
_guards = []  # the active PreemptionGuards, innermost last


def _handler(signum, frame):
    if _requested["sig"] is not None:
        # a second signal before a boundary consumed the first: the loop
        # is stuck inside a step, so unwind now
        raise KeyboardInterrupt(
            "second %s while a preemption request was already pending"
            % signal.Signals(signum).name)
    # signal context: set the flag; the work happens at the boundary
    _requested["sig"] = signum


def preemption_requested():
    """True once a guarded SIGTERM/SIGINT arrived and no boundary has
    consumed it yet."""
    return _requested["sig"] is not None


def at_step_boundary():
    """Called by the training loops between optimizer steps: the
    ``worker.kill`` chaos site, then, if a guard is active and a signal
    arrived, the innermost guard saves and raises. One dict read
    otherwise."""
    chaos_point("worker.kill")
    sig = _requested["sig"]
    if sig is None or not _guards:
        return
    _requested["sig"] = None
    _guards[-1]._fire(sig)


class PreemptionGuard:
    """A scoped bridge from SIGTERM/SIGINT to a checkpoint.

    `save` is a zero-argument callable run at the boundary; it may return
    the step it captured. With `reraise=False` the guard is cooperative:
    it sets `preempted` and the loop breaks by itself."""

    def __init__(self, save=None, signals=(signal.SIGTERM, signal.SIGINT),
                 reraise=True):
        self._save = save
        self._signals = tuple(signals)
        self._old = {}
        self.reraise = reraise
        self.preempted = False
        self.saved_step = None

    @classmethod
    def for_trainer(cls, checkpoint, trainer, **kwargs):
        """A guard that saves `trainer` (one with a `_step_count`) through
        a `parallel.TrainerCheckpoint`, synchronously (wait=True): an
        asynchronous save racing the process's exit is the torn write
        this layer exists to prevent."""
        def _save():
            step = int(getattr(trainer, "_step_count", 0))
            checkpoint.save(step, trainer, wait=True)
            return step
        return cls(save=_save, **kwargs)

    def __enter__(self):
        _requested["sig"] = None
        for sig in self._signals:
            try:
                self._old[sig] = signal.signal(sig, _handler)
            except ValueError:
                # not the main thread: another guard's handler (or the
                # main thread's) still feeds at_step_boundary
                pass
        _guards.append(self)
        return self

    def __exit__(self, *exc):
        _guards.remove(self)
        for sig, old in self._old.items():
            signal.signal(sig, old)
        self._old = {}
        return False

    def _fire(self, signum):
        self.preempted = True
        if self._save is not None:
            self.saved_step = self._save()
        if self.reraise:
            name = signal.Signals(signum).name
            suffix = "" if self.saved_step is None else \
                "; final checkpoint saved at step %d" % self.saved_step
            raise TrainingPreempted(
                "training preempted by %s at a step boundary%s"
                % (name, suffix), step=self.saved_step)
