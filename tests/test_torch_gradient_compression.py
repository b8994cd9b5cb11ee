"""Parity of the port's 2-bit gradient compression
(mxnet_tpu_torch/gradient_compression.py) with the JAX package's, on the
CPU: over 5 error-feedback steps, at sizes that are not multiples of 16
and at two thresholds, the packed words (the port's int32 read as
uint32) and the residuals are JAX's bit for bit, and so are the decoded
values; the stateful compressor's per-key roundtrip matches JAX's.
"""
import numpy as np
import jax
from jax._src import compilation_cache
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu import gradient_compression as jgc
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import gradient_compression as tgc


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


@pytest.mark.parametrize("threshold", [0.5, 0.05])
@pytest.mark.parametrize("shape", [(1,), (15,), (17,), (7, 9), (1027,)])
def test_words_and_residuals_equal_jax_over_five_steps(shape, threshold):
    rng = np.random.RandomState(sum(shape))
    jres = jnp.zeros(shape, jnp.float32)
    tres = torch.zeros(shape)
    n = int(np.prod(shape))
    for step in range(5):
        g = (rng.randn(*shape) * 0.4).astype(np.float32)
        jw, jres = jgc.quantize_2bit(jnp.asarray(g), jres, threshold)
        tw, tres = tgc.quantize_2bit(torch.from_numpy(g), tres, threshold)
        assert tw.dtype == torch.int32 and tw.shape == (tgc.packed_size(n),)
        assert np.array_equal(tw.numpy().view(np.uint32), np.asarray(jw)), \
            step
        assert tres.numpy().tobytes() == np.asarray(jres).tobytes(), step
        td = tgc.dequantize_2bit(tw, shape, threshold)
        jd = jgc.dequantize_2bit(jw, shape, threshold)
        assert td.numpy().tobytes() == np.asarray(jd).tobytes(), step


def test_compressor_roundtrip_per_key_equals_jax():
    jc = jgc.GradientCompression.from_params({"type": "2bit",
                                              "threshold": 0.25})
    tc = tgc.GradientCompression.from_params({"type": "2bit",
                                              "threshold": 0.25})
    rng = np.random.RandomState(3)
    for step in range(4):
        for key, shape in (("a", (33,)), (("b", 1), (4, 5))):
            g = (rng.randn(*shape) * 0.3).astype(np.float32)
            jout = jc.roundtrip(key, jnp.asarray(g))
            tout = tc.roundtrip(key, torch.from_numpy(g))
            assert tout.numpy().tobytes() == np.asarray(jout).tobytes()
            assert tc.residual(key, shape, torch.float32).numpy().tobytes() \
                == np.asarray(jc.residual(key, shape,
                                          jnp.float32)).tobytes()
    # a key that changes shape restarts from a zero residual
    assert not tc.residual("a", (8,), torch.float32).any()
    with pytest.raises(MXNetError, match="compression type"):
        tgc.GradientCompression(type="1bit")
