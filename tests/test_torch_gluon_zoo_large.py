"""Parity of the port's DenseNet and Inception V3 with the JAX package's,
on the CPU, at their smallest valid inputs (224 and 299 px): one forward
each with the JAX net's seeded weights carried over by block path, the
logits within 1e-4 of their scale (fp32) and every parameter's shape
equal to JAX's after it. The rest of the zoo is in
test_torch_gluon_zoo.py; the checks are in torch_zoo_parity.py."""
import jax
from jax._src import compilation_cache
import pytest

from torch_zoo_parity import check_family


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


@pytest.mark.parametrize("name,side", [("densenet121", 224),
                                       ("inceptionv3", 299)])
def test_large_family_forward_matches_jax(name, side):
    check_family(name, side)
