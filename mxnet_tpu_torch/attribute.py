"""AttrScope: scoped default attributes for symbols (counterpart of
mxnet_tpu/attribute.py, copied: that module imports no jax; reference:
python/mxnet/attribute.py — `with mx.AttrScope(x=y):`
attaches attrs to every symbol created inside the scope; used e.g. to
set `ctx_group`/`lr_mult` over a model region).
"""
from __future__ import annotations

import threading

__all__ = ["AttrScope"]

_state = threading.local()


def _current():
    return getattr(_state, "stack", None) or []


class AttrScope:
    """Attach attributes to all symbols created within the scope.

    Nested scopes merge, inner wins::

        with mx.AttrScope(lr_mult="0.1", ctx_group="stage1"):
            w = mx.sym.var("w")      # w.attr("lr_mult") == "0.1"
    """

    def __init__(self, **kwargs):
        for k, v in kwargs.items():
            if not isinstance(v, str):
                raise ValueError(
                    "AttrScope values must be strings, got %s=%r"
                    % (k, v))
        self._attr = kwargs

    @staticmethod
    def current_attrs():
        """Merged attrs of the active scope stack (inner wins)."""
        merged = {}
        for scope in _current():
            merged.update(scope._attr)
        return merged

    def get(self, attr=None):
        """Merge this scope's attrs (reference API: an un-entered
        AttrScope(x='y').get() returns {'x': 'y'}) plus any active
        scope stack into `attr`; explicit attrs win."""
        merged = AttrScope.current_attrs()
        merged.update(self._attr)
        merged.update(attr or {})
        return merged

    def __enter__(self):
        if not hasattr(_state, "stack"):
            _state.stack = []
        _state.stack.append(self)
        return self

    def __exit__(self, *exc):
        _state.stack.pop()
        return False
