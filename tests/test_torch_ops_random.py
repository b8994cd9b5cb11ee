"""The port's random ops (mxnet_tpu/ops/random_ops.py) against the JAX
package's, on the CPU: the draws of every registered name agree with
JAX's in distribution (mean and variance of 10^4 draws within 4 standard
errors), never in bits; a seed makes the port's draws repeat; Dropout in
training mode keeps 1 - p of its input, scaled by 1 / (1 - p)."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from torch_ops_parity import (_no_persistent_compile_cache,  # noqa: F401
                              N_DRAWS, check_random, compare_draws,
                              jax_names, random_names)


@pytest.mark.parametrize("name", random_names(jax_names("random_ops")))
def test_random_op_matches_jax_in_distribution(name):
    out = check_random(name)
    if name in ("_shuffle", "shuffle"):
        assert np.array_equal(np.sort(out), np.arange(N_DRAWS))


def test_seed_repeats_the_draws():
    with tmx.cpu():
        tmx.random.seed(5)
        a = tmx.nd.random.normal(shape=(100,)).asnumpy()
        tmx.random.seed(5)
        b = tmx.nd.random.normal(shape=(100,)).asnumpy()
        c = tmx.nd.random.normal(shape=(100,)).asnumpy()
    assert np.array_equal(a, b) and not np.array_equal(b, c)


def test_dropout_in_training_matches_jax_in_distribution():
    x = np.ones(N_DRAWS, np.float32)
    jmx.random.seed(0)
    tmx.random.seed(0)
    with jmx.autograd.train_mode():
        want = jmx.nd.Dropout(jmx.nd.array(x), p=0.3).asnumpy()
    with tmx.cpu(), tmx.autograd.train_mode():
        got = tmx.nd.Dropout(tmx.nd.array(x), p=0.3).asnumpy()
    assert set(np.unique(got)) <= {0.0, np.float32(1 / 0.7)}
    compare_draws(got, want, "Dropout")
