"""Retry with backoff, and deadlines (counterpart of
mxnet_tpu/resilience/retry.py: `TransientError` :43, `RetryPolicy` :55,
`retry_call` :81, `Deadline` :127).

A `RetryPolicy` names the exceptions worth another attempt (`retry_on`,
by default the explicit `TransientError` contract) and those that must
propagate at once (`give_up_on`, checked first). Backoff is exponential
with multiplicative jitter, so workers that fail together do not retry
in lockstep against one rendezvous. `Deadline` bounds a region of work
by wall-clock; a diagnosable `DeadlineExceeded` beats an unbounded wait.

Env knobs: ``MXTPU_RETRY_MAX_ATTEMPTS`` (default attempts, 5),
``MXTPU_RETRY_BASE_DELAY_S`` (first delay, 0.05).
"""
from __future__ import annotations

import logging
import random
import time

from ..base import MXNetError, getenv

__all__ = ["Deadline", "DeadlineExceeded", "RetryPolicy", "TransientError",
           "retry_call"]

_log = logging.getLogger("mxnet_tpu_torch.resilience")


class TransientError(MXNetError):
    """An error the caller may safely re-attempt: nothing was mutated, or
    the operation is idempotent."""


class DeadlineExceeded(MXNetError):
    """A bounded operation ran out of time. Diagnosable by design: the
    message names the operation and the budget, instead of the silent
    hang it replaces."""


class RetryPolicy:
    """Exponential backoff and jitter: `retry_on` errors are attempted up
    to `max_attempts` times in all; `give_up_on` errors propagate at once
    even when they match `retry_on`. An optional `Deadline` caps the
    loop: no attempt or sleep starts past it."""

    def __init__(self, max_attempts=None, base_delay=None, max_delay=2.0,
                 multiplier=2.0, jitter=0.25, retry_on=(TransientError,),
                 give_up_on=(), deadline=None, what="operation"):
        if max_attempts is None:
            max_attempts = getenv("MXTPU_RETRY_MAX_ATTEMPTS", 5)
        if base_delay is None:
            base_delay = getenv("MXTPU_RETRY_BASE_DELAY_S", 0.05)
        self.max_attempts = max(1, int(max_attempts))
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.retry_on = tuple(retry_on)
        self.give_up_on = tuple(give_up_on)
        self.deadline = deadline
        self.what = what


def retry_call(fn, *args, policy=None, **kwargs):
    """`fn(*args, **kwargs)` under `policy`. When the attempts run out the
    last retryable error propagates unchanged; any other error propagates
    from the attempt that raised it."""
    policy = policy or RetryPolicy()
    delay = policy.base_delay
    for attempt in range(1, policy.max_attempts + 1):
        if policy.deadline is not None:
            policy.deadline.check()
        try:
            return fn(*args, **kwargs)
        except policy.give_up_on:
            raise
        except policy.retry_on as err:
            if attempt >= policy.max_attempts:
                raise
            sleep_for = min(delay, policy.max_delay)
            if policy.jitter:
                sleep_for *= 1.0 + policy.jitter * (2 * random.random() - 1)
            if policy.deadline is not None and \
                    policy.deadline.remaining() <= sleep_for:
                raise
            _log.warning("%s: transient failure (attempt %d/%d): %s; "
                         "retrying in %.3gs", policy.what, attempt,
                         policy.max_attempts, err, sleep_for)
            time.sleep(max(0.0, sleep_for))
            delay *= policy.multiplier
    raise AssertionError("unreachable")


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
