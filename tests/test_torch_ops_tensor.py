"""The port's registry ops of mxnet_tpu/ops/tensor.py against the JAX
package's, on the CPU: every registered name (aliases included) on the
same seeded inputs, outputs and aux write-backs within the tolerance of
its class, and the gradients of every differentiable op through one
record() -> backward. The cases and tolerances are in
tests/torch_ops_parity.py."""
import pytest

from torch_ops_parity import (_no_persistent_compile_cache,  # noqa: F401
                              case_names, check_forward, check_grad,
                              grad_names, jax_names)

NAMES = case_names(jax_names("tensor"))


@pytest.mark.parametrize("name", NAMES)
def test_op_matches_jax(name):
    check_forward(name)


@pytest.mark.parametrize("name", grad_names(NAMES))
def test_op_gradient_matches_jax(name):
    check_grad(name)
