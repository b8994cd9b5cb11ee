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
import jax
from jax._src import compilation_cache
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.ops.nn import _batch_norm, _convolution
from mxnet_tpu.ops.pallas_kernels import (_attn_reference,
                                          conv1x1_bn_stats as jax_conv1x1,
                                          flash_attention as jax_flash,
                                          fused_sgd_momentum as jax_sgd,
                                          pallas_layer_norm)
from mxnet_tpu_torch import MXNetError, ops
from mxnet_tpu_torch.ops import _build

# fp32 atol as tests/test_pallas.py:38-47; bf16 allows one output ulp
LN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# as tests/test_pallas.py:14-24
ATTN_TOL = 2e-4
# as tests/test_pallas.py:61-98: fp32 atol; bf16 w (JAX updates it in bf16
# arithmetic, the port in fp32 with one rounding) allows a few bf16 ulps
SGD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# as tests/test_pallas.py:101-113 (y, mean; var)
CONV_TOL, VAR_TOL = 1e-4, 1e-3
# gradients of x, w, bias, gamma, beta through conv + training BatchNorm:
# fp32 on both sides, sums taken in other orders
GRAD_TOL = 1e-4


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


@pytest.mark.parametrize("shape", [(512, 128), (3, 3, 7, 11), (1000,)])
def test_fused_sgd_momentum_matches_pallas(shape):
    """The port's list form on CPU tensors (each updated in place) against
    the Pallas kernel, one tensor per shape and all three in one call."""
    rng = np.random.RandomState(0)
    w, g, m = (rng.randn(*shape).astype(np.float32) for _ in range(3))
    lr, mom, wd, rs = 0.05, 0.9, 1e-4, 0.5
    ow, om = jax_sgd(jnp.asarray(w), jnp.asarray(g), jnp.asarray(m), lr,
                     mom, wd, rs)
    tw, tg, tm = (torch.from_numpy(a.copy()) for a in (w, g, m))
    ops.fused_sgd_momentum([tw], [tg], [tm], lr, mom, wd, rs)
    assert np.abs(tw.numpy() - np.asarray(ow)).max() < SGD_TOL["float32"]
    assert np.abs(tm.numpy() - np.asarray(om)).max() < SGD_TOL["float32"]


def test_fused_sgd_momentum_many_tensors_and_bf16_weights():
    rng = np.random.RandomState(1)
    shapes = [(512, 128), (3, 3, 7, 11), (1000,)]
    ws = [rng.randn(*s).astype(np.float32) for s in shapes]
    gs = [rng.randn(*s).astype(np.float32) for s in shapes]
    ms = [rng.randn(*s).astype(np.float32) for s in shapes]
    tw, tg, tm = ([torch.from_numpy(a.copy()) for a in arrs]
                  for arrs in (ws, gs, ms))
    ops.fused_sgd_momentum(tw, tg, tm, 0.1, 0.9, 1e-4, 1.0)
    for w, g, m, a, b in zip(ws, gs, ms, tw, tm):
        ow, om = jax_sgd(jnp.asarray(w), jnp.asarray(g), jnp.asarray(m),
                         0.1, 0.9, 1e-4, 1.0)
        assert np.abs(a.numpy() - np.asarray(ow)).max() < SGD_TOL["float32"]
        assert np.abs(b.numpy() - np.asarray(om)).max() < SGD_TOL["float32"]
    # bf16 w and g with fp32 m, as tests/test_pallas.py:82-98
    w, g, m = ws[0][:64], gs[0][:64], ms[0][:64]
    ow, om = jax_sgd(jnp.asarray(w, jnp.bfloat16),
                     jnp.asarray(g, jnp.bfloat16), jnp.asarray(m), 0.1, 0.9)
    tw = torch.from_numpy(w).to(torch.bfloat16)
    tm = torch.from_numpy(m.copy())
    ops.fused_sgd_momentum([tw], [torch.from_numpy(g).to(torch.bfloat16)],
                           [tm], 0.1, 0.9)
    assert tw.dtype == torch.bfloat16 and tm.dtype == torch.float32
    assert np.abs(tm.numpy() - np.asarray(om)).max() < SGD_TOL["bfloat16"]
    assert np.abs(tw.float().numpy() - np.asarray(ow.astype(jnp.float32))
                  ).max() < SGD_TOL["bfloat16"]


@pytest.mark.parametrize("M,cin,cout", [(512, 16, 32), (300, 8, 8)])
def test_conv1x1_bn_stats_matches_pallas(M, cin, cout):
    """M = 300 is no multiple of the Pallas block: its padded-rows path,
    and the port's ragged M, run."""
    rng = np.random.RandomState(0)
    x = rng.randn(M, cin).astype(np.float32)
    w = (rng.randn(cin, cout) * 0.2).astype(np.float32)
    want = jax_conv1x1(jnp.asarray(x), jnp.asarray(w), block_rows=128)
    got = ops.conv1x1_bn_stats(torch.from_numpy(x), torch.from_numpy(w))
    for a, b, tol in zip(got, want, (CONV_TOL, CONV_TOL, VAR_TOL)):
        assert a.dtype == torch.float32
        assert np.abs(a.numpy() - np.asarray(b)).max() < tol


@pytest.mark.parametrize("stride,bias", [(1, True), (2, False)])
def test_conv1x1_bn_gradient_matches_jax_vjp(stride, bias):
    """The autograd.Function under a training BatchNorm (as the port's
    ResNet wires it) against JAX's vjp of the XLA convolution +
    `_batch_norm` in training mode: gradients of x, w, bias, gamma and
    beta, and the forward, for one random cotangent."""
    rng = np.random.RandomState(3)
    n, h, cin, cout = 2, 6, 8, 16
    x = rng.randn(n, h, h, cin).astype(np.float32)
    w = (rng.randn(cout, 1, 1, cin) * 0.3).astype(np.float32)   # JAX NHWC
    b = rng.randn(cout).astype(np.float32)
    gamma = (rng.rand(cout) + 0.5).astype(np.float32)
    beta = rng.randn(cout).astype(np.float32)
    mm, mv = np.zeros(cout, np.float32), np.ones(cout, np.float32)
    ho = -(-h // stride)
    cot = rng.randn(n, ho, ho, cout).astype(np.float32)

    def jax_fwd(x, w, b, gamma, beta):
        y = _convolution(x, w, *([b] if bias else []), kernel=(1, 1),
                         num_filter=cout, stride=(stride, stride),
                         no_bias=not bias, layout="NHWC")
        return _batch_norm(y, gamma, beta, jnp.asarray(mm), jnp.asarray(mv),
                           eps=1e-5, fix_gamma=False, axis=3,
                           _mode="train")[0]

    want, vjp = jax.vjp(jax_fwd, *(jnp.asarray(a)
                                   for a in (x, w, b, gamma, beta)))
    want_grads = vjp(jnp.asarray(cot))

    tx, tb, tg, tbeta = (torch.from_numpy(a).requires_grad_()
                         for a in (x, b, gamma, beta))
    tw = torch.from_numpy(w).permute(0, 3, 1, 2).contiguous() \
        .requires_grad_()
    y, mean, var = ops.conv1x1_bn_nhwc(tx, tw, tb if bias else None, stride)
    out = ops.nn.batch_norm(y, tg, tbeta, torch.from_numpy(mm),
                            torch.from_numpy(mv), eps=1e-5, fix_gamma=False,
                            axis=3, training=True, stats=(mean, var))[0]
    assert np.abs(out.detach().numpy() - np.asarray(want)).max() < GRAD_TOL
    (out * torch.from_numpy(cot)).sum().backward()
    got = [tx.grad, tw.grad.permute(0, 2, 3, 1), tb.grad, tg.grad,
           tbeta.grad]
    for name, a, e in zip(("x", "w", "bias", "gamma", "beta"), got,
                          want_grads):
        if name == "bias" and not bias:
            continue
        err = np.abs(a.numpy() - np.asarray(e)).max()
        assert err < GRAD_TOL * max(1.0, np.abs(np.asarray(e)).max()), \
            (name, err)


def test_cpu_tensors_take_plain_path_and_count_no_launch():
    ops.reset_launch_counts()
    x, g, b = (torch.from_numpy(a) for a in _ln_inputs((4, 32), seed=3))
    assert torch.equal(ops.layer_norm(x, g, b),
                       ops.layer_norm_plain(x, g, b))
    q = torch.randn(1, 2, 9, 8, generator=torch.Generator().manual_seed(0))
    assert torch.equal(ops.flash_attention(q, q, q, causal=True),
                       ops.attention_plain(q, q, q, causal=True))
    for got, want in zip(ops.conv1x1_bn_stats(x, g.reshape(32, 1)),
                         ops.conv1x1_bn_stats_plain(x, g.reshape(32, 1))):
        assert torch.equal(got, want)
    w, m = x.clone(), x.clone()
    want = ops.sgd_momentum_plain(w, g.expand(4, 32), m, 0.1)
    ops.fused_sgd_momentum([w], [g.expand(4, 32).contiguous()], [m], 0.1)
    assert torch.equal(w, want[0]) and torch.equal(m, want[1])
    assert ops.launch_counts() == {"flash_attention": 0, "layer_norm": 0,
                                   "fused_sgd_momentum": 0,
                                   "conv1x1_bn_stats": 0}


def test_non_cpu_tensor_never_falls_back(monkeypatch):
    """Off the CPU a wrapper launches its kernel or raises: here the
    kernel library cannot be had, and the wrappers must surface that
    instead of computing the plain version."""
    class NoKernel(Exception):
        pass

    def no_kernel(name):
        raise NoKernel(name)

    monkeypatch.setattr(_build, "load", no_kernel)
    for name in ("layer_norm", "flash_attention", "sgd_momentum",
                 "conv1x1_bn"):
        module = importlib.import_module("mxnet_tpu_torch.ops." + name)
        monkeypatch.setattr(module, "_fn", None)
    x = torch.empty(4, 32, device="meta")
    g = torch.empty(32, device="meta")
    with pytest.raises(NoKernel):
        ops.layer_norm(x, g, g)
    q = torch.empty(1, 2, 9, 16, device="meta")
    with pytest.raises(NoKernel):
        ops.flash_attention(q, q, q, causal=True)
    with pytest.raises(NoKernel):
        ops.fused_sgd_momentum([x], [x], [x], 0.1)
    with pytest.raises(NoKernel):
        ops.conv1x1_bn_stats(x, torch.empty(32, 8, device="meta"))


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
    with pytest.raises(MXNetError, match="float32"):
        ops.fused_sgd_momentum([x], [x], [x.to(torch.bfloat16)], 0.1)
    with pytest.raises(MXNetError, match="shapes"):
        ops.fused_sgd_momentum([x], [x[:2]], [x], 0.1)
    with pytest.raises(MXNetError, match="contiguous"):
        ops.fused_sgd_momentum([x.t()], [x.t()], [x.t()], 0.1)
    with pytest.raises(MXNetError, match="Cin"):
        ops.conv1x1_bn_stats(x, torch.empty(16, 8, device="meta"))
    with pytest.raises(MXNetError, match="contiguous"):
        ops.conv1x1_bn_stats(x.t().contiguous().t(),
                             torch.empty(32, 8, device="meta"))


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
    # 1x1 conv + statistics: y within a bf16 ulp of the plain version's
    # (both accumulate in fp32), the statistics in fp32
    for M, cin, cout in [(300, 64, 256), (6272, 256, 64), (77, 8, 24)]:
        x = torch.randn(M, cin, generator=gen, device="cuda").to(dtype)
        w = (torch.randn(cin, cout, generator=gen, device="cuda") * 0.1) \
            .to(dtype)
        for a, b in zip(ops.conv1x1_bn_stats(x, w),
                        ops.conv1x1_bn_stats_plain(x, w)):
            assert (a.float() - b.float()).abs().max() < 2e-2 \
                * max(1.0, b.float().abs().max().item())
    # SGD over several tensors, w in `dtype`, m in fp32
    ws = [torch.randn(s, generator=gen, device="cuda").to(dtype)
          for s in (5000, 7, 70000)]
    gs = [torch.randn_like(w) for w in ws]
    ms = [torch.randn(w.shape, generator=gen, device="cuda") for w in ws]
    want = [ops.sgd_momentum_plain(w, g, m, 0.1, 0.9, 1e-4)
            for w, g, m in zip(ws, gs, ms)]
    ops.fused_sgd_momentum(ws, gs, ms, 0.1, 0.9, 1e-4)
    for w, m, (ew, em) in zip(ws, ms, want):
        assert (w.float() - ew.float()).abs().max() < tol
        assert (m - em).abs().max() < 1e-5
