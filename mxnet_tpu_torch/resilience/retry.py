"""Deadlines (counterpart of mxnet_tpu/resilience/retry.py:49 and :127).

`Deadline` bounds a region of work by wall-clock; a diagnosable
`DeadlineExceeded` beats an unbounded wait. The retry policies of the
JAX package are not ported yet.
"""
from __future__ import annotations

import time

from ..base import MXNetError

__all__ = ["DeadlineExceeded", "Deadline"]


class DeadlineExceeded(MXNetError):
    """A bounded operation ran out of time. Diagnosable by design: the
    message names the operation and the budget, instead of the silent
    hang it replaces."""


class Deadline:
    """A wall-clock budget shared across a region of work.

        with Deadline(30.0, what="dist init") as dl:
            while ...:
                dl.check()      # raises DeadlineExceeded past budget
    """

    def __init__(self, seconds, what="operation"):
        self.seconds = float(seconds)
        self.what = what
        self._t0 = time.monotonic()

    def remaining(self):
        return self.seconds - (time.monotonic() - self._t0)

    def expired(self):
        return self.remaining() <= 0.0

    def check(self):
        if self.expired():
            raise DeadlineExceeded(
                "%s exceeded its %.6gs deadline" % (self.what,
                                                    self.seconds))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
