"""Shared parts of the symbolic-layer parity tests
(tests/test_torch_{symbol,executor,hybridize,module,mnist}.py): the
fixtures that leave both packages as each test found them.

A test here runs the JAX package and the port on the same seeded numpy
inputs in one process. The JAX package keeps process-wide state that
its own tests read (tests/test_symbol.py names its nodes from the
thread-local name manager, NDArrayIter shuffles with the global numpy
RNG), so every test runs between a snapshot and a restore of:

- both packages' thread-local name managers (their counters too: a
  symbol or block named outside a `NameManager` advances them) and
  `AttrScope` stacks;
- `mxnet_tpu.random`'s key and the global numpy RNG;
- the environment variables and the working directory, which is the
  test's own `tmp_path`: every file a test writes (checkpoints, exports,
  a dataset) lands there;
- JAX's compile-cache setting, per module, as tests/torch_ops_parity.py
  keeps it (the test run's cache read guard does not run under jax 0.9).

Inside a test the port's default context is the CPU (`with mx.cpu():`),
where the port's layers make their parameters.
"""
import os

import jax
from jax._src import compilation_cache
import numpy as np
import pytest

import mxnet_tpu.attribute as _jattr
import mxnet_tpu.name as _jname
import mxnet_tpu.random as _jrandom
import mxnet_tpu_torch as _tmx
import mxnet_tpu_torch.attribute as _tattr
import mxnet_tpu_torch.name as _tname

__all__ = ["no_persistent_compile_cache", "restore_shared_state"]

_MISSING = object()


@pytest.fixture(scope="module")
def no_persistent_compile_cache():
    was = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", was)
    compilation_cache.reset_cache()


def _snapshot(local, attr):
    """The value of `local.attr`, with what a test may change in place
    copied: a name manager's counters, a scope stack's entries."""
    value = getattr(local, attr, _MISSING)
    if isinstance(value, list):
        return list(value), None
    return value, dict(getattr(value, "_counter", None) or {})


def _restore(local, attr, saved):
    value, counters = saved
    if value is _MISSING:
        if hasattr(local, attr):
            delattr(local, attr)
        return
    if hasattr(value, "_counter"):
        value._counter.clear()
        value._counter.update(counters)
    setattr(local, attr, value)


@pytest.fixture
def restore_shared_state(no_persistent_compile_cache, tmp_path):
    held = [(_jname._local, "manager"), (_tname._local, "manager"),
            (_jattr._state, "stack"), (_tattr._state, "stack"),
            (_jrandom._state, "key")]
    saved = [_snapshot(local, attr) for local, attr in held]
    np_state = np.random.get_state()
    env = dict(os.environ)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        with _tmx.cpu():
            yield tmp_path
    finally:
        os.chdir(cwd)
        os.environ.clear()
        os.environ.update(env)
        np.random.set_state(np_state)
        for (local, attr), value in zip(held, saved):
            _restore(local, attr, value)
