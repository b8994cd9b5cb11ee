"""Parity of the PyTorch port's kernel modules with the JAX package's
Pallas kernels.

On the CPU each wrapper in mxnet_tpu_torch.ops runs its plain PyTorch
version; the Pallas kernels run in interpret mode, as tests/test_pallas.py
runs them. Inputs are made with numpy from a seed and fed to both. The
CUDA kernels themselves are held against the plain versions on the card
by the tests marked `cuda` and by chip_smoke.py.
"""
import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.ops.pallas_kernels import (_attn_reference,
                                          flash_attention as jax_flash,
                                          pallas_layer_norm)
from mxnet_tpu_torch import MXNetError, ops
from mxnet_tpu_torch.ops import _build

# fp32 atol as tests/test_pallas.py:38-47; bf16 allows one output ulp
LN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# as tests/test_pallas.py:14-24
ATTN_TOL = 2e-4


def _ln_inputs(shape, seed):
    r = np.random.RandomState(seed)
    x = (r.randn(*shape) * 3 + 1).astype(np.float32)
    g = r.randn(shape[-1]).astype(np.float32)
    b = r.randn(shape[-1]).astype(np.float32)
    return x, g, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(300, 64), (8, 768)])
def test_layer_norm_matches_pallas(shape, dtype):
    """(300, 64) is not a multiple of the Pallas row block: its padding
    path runs."""
    x, g, b = _ln_inputs(shape, seed=2)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = pallas_layer_norm(jnp.asarray(x, jdt), jnp.asarray(g, jdt),
                             jnp.asarray(b, jdt))
    tdt = getattr(torch, dtype)
    got = ops.layer_norm(torch.from_numpy(x).to(tdt),
                         torch.from_numpy(g).to(tdt),
                         torch.from_numpy(b).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == shape
    err = np.abs(got.float().numpy()
                 - np.asarray(want.astype(jnp.float32))).max()
    assert err < LN_TOL[dtype], err


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 2, 64, 16), (1, 2, 256, 64)])
def test_flash_attention_matches_pallas(shape, causal):
    r = np.random.RandomState(0)
    q, k, v = (r.randn(*shape).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal))
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    assert np.abs(got.numpy() - want).max() < ATTN_TOL


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_ragged_tail_matches_reference(causal):
    """T = 40 divides no block: the Pallas kernel asserts
    (pallas_kernels.py:102), the port takes any T; its reference is the
    JAX `_attn_reference`."""
    r = np.random.RandomState(1)
    q, k, v = (r.randn(1, 3, 40, 16).astype(np.float32) for _ in range(3))
    want = np.asarray(_attn_reference(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal))
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    assert np.abs(got.numpy() - want).max() < ATTN_TOL


def test_cpu_tensors_take_plain_path_and_count_no_launch():
    ops.reset_launch_counts()
    x, g, b = (torch.from_numpy(a) for a in _ln_inputs((4, 32), seed=3))
    assert torch.equal(ops.layer_norm(x, g, b),
                       ops.layer_norm_plain(x, g, b))
    q = torch.randn(1, 2, 9, 8, generator=torch.Generator().manual_seed(0))
    assert torch.equal(ops.flash_attention(q, q, q, causal=True),
                       ops.attention_plain(q, q, q, causal=True))
    assert ops.launch_counts() == {"flash_attention": 0, "layer_norm": 0}


def test_non_cpu_tensor_never_falls_back(monkeypatch):
    """Off the CPU a wrapper launches its kernel or raises: here the
    kernel library cannot be had, and the wrappers must surface that
    instead of computing the plain version."""
    class NoKernel(Exception):
        pass

    def no_kernel(name):
        raise NoKernel(name)

    monkeypatch.setattr(_build, "load", no_kernel)
    for name in ("layer_norm", "flash_attention"):
        module = importlib.import_module("mxnet_tpu_torch.ops." + name)
        monkeypatch.setattr(module, "_fn", None)
    x = torch.empty(4, 32, device="meta")
    g = torch.empty(32, device="meta")
    with pytest.raises(NoKernel):
        ops.layer_norm(x, g, g)
    q = torch.empty(1, 2, 9, 16, device="meta")
    with pytest.raises(NoKernel):
        ops.flash_attention(q, q, q, causal=True)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    q = torch.empty(1, 2, 9, 12, device="meta")      # D not a multiple of 8
    with pytest.raises(MXNetError, match="head dim"):
        ops.flash_attention(q, q, q)
    q = torch.empty(1, 2, 9, 16, device="meta")
    with pytest.raises(MXNetError, match="contiguous"):
        ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                            q, q)
    x = torch.empty(4, 32, device="meta")
    with pytest.raises(MXNetError, match="gamma"):
        ops.layer_norm(x, torch.empty(16, device="meta"),
                       torch.empty(32, device="meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain_versions(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for shape in [(2, 2, 40, 16), (1, 12, 1000, 64), (2, 3, 77, 128)]:
        for causal in (False, True):
            q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                       .to(dtype) for _ in range(3))
            got = ops.flash_attention(q, k, v, causal)
            want = ops.attention_plain(q, k, v, causal)
            assert (got.float() - want.float()).abs().max() < tol
    x = torch.randn(300, 768, generator=gen, device="cuda").to(dtype)
    g = torch.randn(768, generator=gen, device="cuda").to(dtype)
    got = ops.layer_norm(x, g, g)
    assert (got.float() - ops.layer_norm_plain(x, g, g).float()).abs() \
        .max() < tol
