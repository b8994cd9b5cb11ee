"""Shared parts of the operator sweep (tests/test_torch_ops_*.py): the
runs through both registries and the checks, over the case table of
tools/torch_op_cases.py.

Each case's inputs go through the JAX package's
`invoke(R.get(name), ...)`, as tests/test_op_coverage.py runs them, and
through the port's `invoke` on the CPU. The outputs, and every input
array after the call (an op's aux write-back), must agree within the
case's tolerance class (tools/torch_op_cases.py). `grad` cases also run
one record() -> backward with a seeded random head gradient in each
package and compare the gradients of the float inputs at the same
tolerance. Random ops are compared by distribution: mean and variance of
10^4 draws within 4 standard errors.
"""
import os
import sys

import numpy as np
import jax
from jax._src import compilation_cache
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.ndarray.ndarray import invoke as jinvoke
from mxnet_tpu.ops import registry as JR
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ndarray.ndarray import invoke as tinvoke
from mxnet_tpu_torch.ops import registry as TR

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from tools.torch_op_cases import (  # noqa: E402
    DEFERRED, DEFERRED_MODULES, N_DRAWS, SWEPT_MODULES, TOL, f32, rng_for,
    draws_agree, split_params)
from tools import torch_op_cases as _cases  # noqa: E402

__all__ = ["DEFERRED", "DEFERRED_MODULES", "N_DRAWS", "SWEPT_MODULES",
           "case_names", "check_forward", "check_grad", "check_random",
           "compare_draws", "grad_names", "jax_names", "module_of",
           "random_names"]


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


def module_of(name):
    """The JAX module (ops/<module>.py) that registered op `name`."""
    return JR.get(name).fn.__module__.split(".")[-1]


def jax_names(module):
    """Every name the JAX registry holds for ops of `module`, deferred
    ones left out."""
    return [n for n in JR.list_ops()
            if module_of(n) == module and n not in DEFERRED]


def case_of(name):
    return _cases.case_of(name, JR.get)


def has_case(name):
    return case_of(name) is not None


def random_case_of(name):
    return _cases.random_case_of(name, JR.get)


# ---------------------------------------------------------------------------
# running both sides
# ---------------------------------------------------------------------------


def _float_inputs(arrays, which):
    return [k for k in which if np.issubdtype(arrays[k].dtype, np.floating)]


def _jax_run(name, arrays, params, train, record=False, cots=None,
             which=()):
    from mxnet_tpu import autograd as jag
    ins = [jmx.nd.array(a, dtype=a.dtype) for a in arrays]
    if record:
        for k in _float_inputs(arrays, which):
            ins[k].attach_grad()
        with jag.record(train_mode=train):
            outs = jinvoke(JR.get(name), ins, dict(params))
        heads = [o for o in outs if np.issubdtype(o.dtype, np.floating)]
        jag.backward(heads, [jmx.nd.array(c) for c in cots[:len(heads)]])
        return outs, ins
    if train:
        with jag.train_mode():
            outs = jinvoke(JR.get(name), ins, dict(params))
    else:
        outs = jinvoke(JR.get(name), ins, dict(params))
    return outs, ins


def _torch_run(name, arrays, params, train, record=False, cots=None,
               which=()):
    from mxnet_tpu_torch import autograd as tag
    with tmx.cpu():
        ins = [tmx.nd.array(a, dtype=a.dtype) for a in arrays]
        if record:
            for k in _float_inputs(arrays, which):
                ins[k].attach_grad()
            with tag.record(train_mode=train):
                outs = tinvoke(TR.get(name), ins, dict(params))
            heads = [o for o in outs
                     if o._data.is_floating_point()]
            tag.backward(heads, [tmx.nd.array(c) for c in
                                 cots[:len(heads)]])
            return outs, ins
        if train:
            with tag.train_mode():
                outs = tinvoke(TR.get(name), ins, dict(params))
        else:
            outs = tinvoke(TR.get(name), ins, dict(params))
    return outs, ins


def compare(got, want, tol, what, up_to_sign=False):
    diff = _cases.compare(got, want, tol, up_to_sign)
    assert diff is None, "%s: %s" % (what, diff)


def check_forward(name):
    make, variants, tol_class, _, opts = case_of(name)
    tol = TOL[tol_class]
    for i, params in enumerate(variants):
        params, train, alt = split_params(params)
        arrays = (alt or make)(rng_for(name))
        jouts, jins = _jax_run(name, arrays, params, train)
        touts, tins = _torch_run(name, arrays, params, train)
        assert len(jouts) == len(touts), (name, len(jouts), len(touts))
        for k, (t, j) in enumerate(zip(touts, jouts)):
            compare(t.asnumpy(), j.asnumpy(),
                    opts.get("out_tol", tol) if k == 0 else tol,
                    "%s variant %d output %d" % (name, i, k),
                    opts.get("up_to_sign", False))
        for k, (t, j) in enumerate(zip(tins, jins)):
            compare(t.asnumpy(), j.asnumpy(), opts.get("out_tol", tol),
                    "%s variant %d input %d after the call" % (name, i, k))


def check_grad(name):
    make, variants, tol_class, _, opts = case_of(name)
    tol = TOL[tol_class]
    for i, params in enumerate(variants):
        params, train, alt = split_params(params)
        arrays = (alt or make)(rng_for(name))
        r = np.random.RandomState(i + 7)
        probe, _ = _jax_run(name, arrays, params, train)
        cots = [f32(r.uniform(-1, 1, o.shape)) for o in probe
                if np.issubdtype(o.dtype, np.floating)]
        which = opts.get("grad_inputs", range(len(arrays)))
        _, jins = _jax_run(name, arrays, params, train, True, cots, which)
        _, tins = _torch_run(name, arrays, params, train, True, cots, which)
        for k in _float_inputs(arrays, which):
            j, t = jins[k], tins[k]
            if j.grad is None:
                continue
            compare(t.grad.asnumpy(), j.grad.asnumpy(), tol,
                    "%s variant %d d/d input %d" % (name, i, k))


def grad_names(names):
    return [n for n in names if has_case(n) and case_of(n)[3]]


def case_names(names):
    """The names of `names` with a deterministic case; every other one
    must be a random op of RANDOM."""
    rest = [n for n in names if not has_case(n)]
    missing = [n for n in rest if random_case_of(n) is None]
    assert not missing, "no case for %s" % missing
    return [n for n in names if has_case(n)]


def random_names(names):
    return [n for n in names if not has_case(n)]


def compare_draws(got, want, what):
    """Mean and variance of `got` within 4 standard errors of `want`'s."""
    diff = draws_agree(got, want)
    assert diff is None, "%s: %s" % (what, diff)


def check_random(name):
    make, params = random_case_of(name)
    arrays = make(rng_for(name))
    jmx.random.seed(0)
    tmx.random.seed(0)
    jout = _jax_run(name, arrays, params, False)[0][0].asnumpy()
    tout = _torch_run(name, arrays, params, False)[0][0].asnumpy()
    assert tout.shape == jout.shape and tout.dtype == jout.dtype, \
        (name, tout.shape, jout.shape, tout.dtype, jout.dtype)
    rows = tout.reshape(-1, tout.shape[-1]) if arrays and \
        tout.ndim > 1 else tout.reshape(1, -1)
    jrows = jout.reshape(rows.shape)
    for i, (t, j) in enumerate(zip(rows, jrows)):
        compare_draws(t, j, "%s row %d" % (name, i))
    return tout
