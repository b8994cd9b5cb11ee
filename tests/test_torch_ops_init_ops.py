"""The port's creation ops (mxnet_tpu/ops/init_ops.py) against the JAX
package's, on the CPU: every registered name on the same params, exact
or within 1e-6. The cases are in tests/torch_ops_parity.py."""
import pytest

from torch_ops_parity import (_no_persistent_compile_cache,  # noqa: F401
                              check_forward, jax_names)


@pytest.mark.parametrize("name", jax_names("init_ops"))
def test_op_matches_jax(name):
    check_forward(name)
