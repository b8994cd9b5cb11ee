"""Automatic naming (counterpart of mxnet_tpu/name.py, copied: that module
imports no jax).

Every top-level Gluon block draws its prefix from the current name
manager: ``dense0_``, ``resnetv10_``, one counter per hint, as in the
reference (python/mxnet/name.py). `Prefix` prepends a prefix to every
name it gives.
"""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix", "current"]

_local = threading.local()


class NameManager:
    """Assigns default names (reference: name.py:24)."""

    def __init__(self):
        self._counter = {}
        self._old_manager = None

    def get(self, name, hint):
        if name:
            return name
        if hint not in self._counter:
            self._counter[hint] = 0
        name = "%s%d" % (hint, self._counter[hint])
        self._counter[hint] += 1
        return name

    def __enter__(self):
        self._old_manager = current()
        _local.manager = self
        return self

    def __exit__(self, *exc):
        _local.manager = self._old_manager
        return False


class Prefix(NameManager):
    """Prepends a prefix to every auto-generated name (reference:
    name.py:77)."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        name = super().get(name, hint)
        return self._prefix + name


def current() -> NameManager:
    if not hasattr(_local, "manager"):
        _local.manager = NameManager()
    return _local.manager
