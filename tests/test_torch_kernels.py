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
@pytest.mark.parametrize("shape", [(300, 64), (8, 768), (5, 100)])
def test_layer_norm_matches_pallas(shape, dtype):
    """(300, 64) is not a multiple of the Pallas row block: its padding
    path runs. D = 100 is no multiple of 8: the CUDA kernel takes its
    scalar path there."""
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


def test_flash_attention_takes_strided_views():
    """q, k, v as `transpose(1, 2)` views of a fused (B, T, 3, H, D)
    projection, written into a (B, T, H, D) buffer through `out=`, as the
    GPT prefill calls it: the same result as the contiguous call."""
    r = np.random.RandomState(2)
    B, T, H, D = 2, 37, 3, 16
    qkv = torch.from_numpy(r.randn(B, T, 3, H, D).astype(np.float32))
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    assert q.stride(-1) == 1 and not q.is_contiguous()
    want = ops.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=True)
    buf = torch.full((B, T, H, D), float("nan"))
    got = ops.flash_attention(q, k, v, causal=True,
                              out=buf.transpose(1, 2))
    assert torch.equal(got, want)
    assert torch.equal(buf.transpose(1, 2), want)


_LOG2E = 1.4426950408889634


def _tf32(x):
    """Round fp32 to TF32 as cvt.rna.tf32.f32 does: 10 mantissa bits, to
    nearest, ties away from zero (the add carries into the magnitude)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as the fp32 kernel runs it: each operand split into TF32 hi
    and lo parts, lo*hi + hi*lo + hi*hi accumulated in fp32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _mm_1xtf32(a, b):
    return _tf32(a) @ _tf32(b)


def _attention_in_tf32(q, k, v, mm):
    """The fp32 kernel's arithmetic in plain torch: q scaled by
    log2(e) / sqrt(D) before the split, a causal base-2 softmax with
    masked probabilities exactly 0, both products through `mm`."""
    T, D = q.shape[-2:]
    s = mm(q * (_LOG2E / D ** 0.5), k.transpose(-1, -2))
    mask = torch.ones(T, T, dtype=torch.bool).tril()
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.where(mask, torch.exp2(s - s.amax(-1, keepdim=True)),
                    torch.zeros_like(s))
    return mm(p, v) / p.sum(-1, keepdim=True)


def test_fp32_kernel_needs_3xtf32_to_meet_its_tolerance():
    """The numerics case for the fp32 kernel's design, without a card: at
    the serve phase's largest prefill, (1, 12, 1024, 64) causal, the
    3xTF32 arithmetic stays within chip_smoke.py's fp32 tolerance (1e-4)
    of the JAX `_attn_reference`, and one TF32 product per matmul does
    not."""
    r = np.random.RandomState(4)
    q, k, v = (r.randn(1, 12, 1024, 64).astype(np.float32)
               for _ in range(3))
    want = np.asarray(_attn_reference(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), True))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    err3 = np.abs(_attention_in_tf32(tq, tk, tv, _mm_3xtf32).numpy()
                  - want).max()
    err1 = np.abs(_attention_in_tf32(tq, tk, tv, _mm_1xtf32).numpy()
                  - want).max()
    assert err3 < 1e-4, err3
    assert err1 > 1e-4, err1


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


def test_sgd_plan_over_three_steps_matches_pallas():
    """An `SGDMomentumPlan` built once over fixed w and m lists, run for 3
    steps with new gradient tensors each step (as ShardedTrainer runs it),
    against the Pallas kernel applied step by step."""
    rng = np.random.RandomState(5)
    shapes = [(512, 128), (3, 3, 7, 11), (1000,), (0, 4)]
    ws = [rng.randn(*s).astype(np.float32) for s in shapes]
    ms = [rng.randn(*s).astype(np.float32) for s in shapes]
    tw = [torch.from_numpy(a.copy()) for a in ws]
    tm = [torch.from_numpy(a.copy()) for a in ms]
    plan = ops.SGDMomentumPlan(tw, tm)
    lr, mom, wd, rs = 0.05, 0.9, 1e-4, 0.5
    for _ in range(3):
        gs = [rng.randn(*s).astype(np.float32) for s in shapes]
        plan([torch.from_numpy(g) for g in gs], lr, mom, wd, rs)
        for i, g in enumerate(gs[:3]):     # (0, 4) has nothing to update
            ow, om = jax_sgd(jnp.asarray(ws[i]), jnp.asarray(g),
                             jnp.asarray(ms[i]), lr, mom, wd, rs)
            ws[i], ms[i] = np.asarray(ow), np.asarray(om)
    for a, b, w, m in zip(tw[:3], tm[:3], ws, ms):
        assert np.abs(a.numpy() - w).max() < SGD_TOL["float32"]
        assert np.abs(b.numpy() - m).max() < SGD_TOL["float32"]


def test_sgd_plan_refuses_mismatched_lists():
    w, m = torch.zeros(4, 3), torch.zeros(4, 3)
    with pytest.raises(MXNetError, match="equal"):
        ops.SGDMomentumPlan([w, w], [m])
    with pytest.raises(MXNetError, match="float32"):
        ops.SGDMomentumPlan([w], [m.to(torch.bfloat16)])
    with pytest.raises(MXNetError, match="shapes"):
        ops.SGDMomentumPlan([w], [m[:2]])
    with pytest.raises(MXNetError, match="contiguous"):
        ops.SGDMomentumPlan([w.t()], [m.t()])
    plan = ops.SGDMomentumPlan([w], [m])
    with pytest.raises(MXNetError, match="1 tensors, got 2 gradients"):
        plan([w, w], 0.1)
    with pytest.raises(MXNetError, match="shapes"):
        plan([w[:2]], 0.1)
    with pytest.raises(MXNetError, match="contiguous torch.float32"):
        plan([w.to(torch.bfloat16)], 0.1)
    with pytest.raises(MXNetError, match="contiguous torch.float32"):
        plan([torch.zeros(3, 4).t()], 0.1)
    assert torch.equal(w, torch.zeros(4, 3))     # nothing was updated


def test_sgd_plan_off_the_cpu_never_falls_back(monkeypatch):
    """A plan over non-CPU tensors loads its kernel when it is built (and
    uploads its table): here the library cannot be had, and building the
    plan raises instead of setting up the plain version."""
    from mxnet_tpu_torch.ops import sgd_momentum

    class NoKernel(Exception):
        pass

    def no_kernel(name):
        raise NoKernel(name)

    monkeypatch.setattr(_build, "load", no_kernel)
    monkeypatch.setattr(sgd_momentum, "_fn", None)
    x = torch.empty(4, 32, device="meta")
    with pytest.raises(NoKernel):
        ops.SGDMomentumPlan([x], [x])


def test_sgd_mxnet_plan_off_the_cpu_never_falls_back(monkeypatch):
    """MXNet's form too: a plan over non-CPU tensors loads the kernel when
    it is built, and raises when the library cannot be had."""
    from mxnet_tpu_torch.ops import sgd_momentum

    class NoKernel(Exception):
        pass

    def no_kernel(name):
        raise NoKernel(name)

    monkeypatch.setattr(_build, "load", no_kernel)
    monkeypatch.setattr(sgd_momentum, "_fn", None)
    w = torch.empty(4, 32, device="meta")
    low = torch.empty(4, 32, device="meta", dtype=torch.bfloat16)
    with pytest.raises(NoKernel):
        ops.SGDMomentumPlan([w], [w], form="mxnet", weights=[low])


def test_conv1x1_bn_stats_takes_a_transposed_weight_view():
    """The weight as a conv weight lies, (Cout, Cin) row-major seen as a
    (Cin, Cout) view, gives what its contiguous copy gives, and both
    match the Pallas kernel; on a card the wrapper refuses any other
    layout before it reaches the kernel."""
    rng = np.random.RandomState(6)
    x = rng.randn(300, 16).astype(np.float32)
    w_oc = (rng.randn(24, 16) * 0.2).astype(np.float32)       # (Cout, Cin)
    view = torch.from_numpy(w_oc).t()
    assert not view.is_contiguous() and view.t().is_contiguous()
    got = ops.conv1x1_bn_stats(torch.from_numpy(x), view)
    same = ops.conv1x1_bn_stats(torch.from_numpy(x), view.contiguous())
    want = jax_conv1x1(jnp.asarray(x), jnp.asarray(w_oc.T), block_rows=128)
    for a, b, c, tol in zip(got, same, want, (CONV_TOL, CONV_TOL, VAR_TOL)):
        assert torch.allclose(a, b, rtol=0, atol=1e-6)
        assert np.abs(a.numpy() - np.asarray(c)).max() < tol
    xm = torch.empty(300, 16, device="meta")
    strided = torch.empty(16, 48, device="meta")[:, ::2]
    with pytest.raises(MXNetError, match="row-major"):
        ops.conv1x1_bn_stats(xm, strided)


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
    q = torch.empty(1, 2, 16, 16, device="meta")
    with pytest.raises(MXNetError, match="unit stride along D"):
        ops.flash_attention(q.transpose(2, 3), q, q)
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
    # the serve phase's bucket T's and a ragged tail at GPT-2-small heads,
    # and ragged T at other head dims
    shapes = [(1, 12, T, 64) for T in (32, 64, 256, 512, 1000, 1024)]
    for shape in shapes + [(2, 2, 40, 16), (2, 3, 77, 128), (1, 2, 33, 8),
                           (1, 2, 65, 24)]:
        for causal in (False, True):
            q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                       .to(dtype) for _ in range(3))
            got = ops.flash_attention(q, k, v, causal)
            want = ops.attention_plain(q, k, v, causal)
            assert (got.float() - want.float()).abs().max() < tol, \
                (shape, causal)
    # strided: transpose(1, 2) views of a fused projection, out= a view
    B, T, H, D = 2, 300, 12, 64
    qkv = torch.randn(B, T, 3, H, D, generator=gen, device="cuda").to(dtype)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    buf = torch.empty(B, T, H, D, device="cuda", dtype=dtype)
    ops.flash_attention(q, k, v, True, out=buf.transpose(1, 2))
    want = ops.attention_plain(q, k, v, True)
    assert (buf.transpose(1, 2).float() - want.float()).abs().max() < tol
    for rows, D in [(300, 768), (8, 768), (5, 100), (3, 4096)]:
        x = torch.randn(rows, D, generator=gen, device="cuda").to(dtype)
        g = torch.randn(D, generator=gen, device="cuda").to(dtype)
        got = ops.layer_norm(x, g, g)
        assert (got.float() - ops.layer_norm_plain(x, g, g).float()).abs() \
            .max() < tol, (rows, D)
    # 1x1 conv + statistics: y within a bf16 ulp of the plain version's
    # (both accumulate in fp32), the statistics in fp32; a ResNet-50 main
    # shape, ragged M, Cout past one 256-wide tile, the unaligned fallback
    # (20, 36: no TMA), each with w row-major and as a (Cout, Cin)
    # transposed view; two calls give the same bits
    for M, cin, cout in [(300, 64, 256), (25088, 1024, 256), (6272, 256, 64),
                         (1000, 128, 520), (77, 8, 24), (300, 20, 36)]:
        x = torch.randn(M, cin, generator=gen, device="cuda").to(dtype)
        w = (torch.randn(cin, cout, generator=gen, device="cuda") * 0.1) \
            .to(dtype)
        for w_ in (w, w.t().contiguous().t()):
            got = ops.conv1x1_bn_stats(x, w_)
            for a, b in zip(got, ops.conv1x1_bn_stats_plain(x, w_)):
                assert (a.float() - b.float()).abs().max() < 2e-2 \
                    * max(1.0, b.float().abs().max().item()), (M, cin, cout)
            assert all(torch.equal(a, b) for a, b in
                       zip(got, ops.conv1x1_bn_stats(x, w_)))
    # SGD over several tensors, w in `dtype`, m in fp32: the one-off
    # function, then a plan over 3 steps with new gradients each step
    ws = [torch.randn(s, generator=gen, device="cuda").to(dtype)
          for s in (5000, 7, 70000)]
    ms = [torch.randn(w.shape, generator=gen, device="cuda") for w in ws]
    plan = ops.SGDMomentumPlan(ws, ms)
    for step in range(4):
        gs = [torch.randn_like(w) for w in ws]
        want = [ops.sgd_momentum_plain(w, g, m, 0.1, 0.9, 1e-4)
                for w, g, m in zip(ws, gs, ms)]
        if step == 0:
            ops.fused_sgd_momentum(ws, gs, ms, 0.1, 0.9, 1e-4)
        else:
            plan(gs, 0.1, 0.9, 1e-4)
        for w, m, (ew, em) in zip(ws, ms, want):
            assert (w.float() - ew.float()).abs().max() < tol
            assert (m - em).abs().max() < 1e-5
    # a plan past one launch's 480 gradient pointers splits in two, each
    # with its own table and chunk numbering from 0
    ws = [torch.randn(1 + 37 * i % 9000, generator=gen, device="cuda")
          .to(dtype) for i in range(500)]
    ms = [torch.randn(w.shape, generator=gen, device="cuda") for w in ws]
    plan = ops.SGDMomentumPlan(ws, ms)
    for _ in range(2):
        gs = [torch.randn_like(w) for w in ws]
        want = [ops.sgd_momentum_plain(w, g, m, 0.1, 0.9, 1e-4)
                for w, g, m in zip(ws, gs, ms)]
        before = ops.fused_sgd_momentum.launches
        plan(gs, 0.1, 0.9, 1e-4)
        assert ops.fused_sgd_momentum.launches == before + 2
        for i, (w, m, (ew, em)) in enumerate(zip(ws, ms, want)):
            assert (w.float() - ew.float()).abs().max() < tol, i
            assert (m - em).abs().max() < 1e-5, i


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fp32", "bf16", "bf16_multi_precision"])
def test_cuda_sgd_mxnet_form_matches_plain_version(case):
    """MXNet's form through a plan, 3 calls with a new lr each, against
    `sgd_mxnet_plain` per tensor: with momentum and clipping, at momentum
    0 (no velocity), and vetoed by a false `ok` (nothing written).
    fp32: the kernel rounds each product and sum on its own, as the
    plain version's separate operations do (1e-6); bf16 weights: one
    bf16 ulp."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(1)
    mp = case == "bf16_multi_precision"
    low = torch.float32 if case == "fp32" else torch.bfloat16
    shapes = [(5000,), (7,), (64, 3, 3, 3), (70001,)]
    tol = 1e-6 if case == "fp32" else 2 ** -7
    for momentum, clip in ((0.9, 0.02), (0.0, None)):
        weights = [torch.randn(s, generator=gen, device="cuda").to(low)
                   for s in shapes]
        ws = [w.float() for w in weights] if mp else weights
        vs = [torch.randn(w.shape, generator=gen, device="cuda")
              .to(w.dtype) * 0.01 for w in ws] if momentum else None
        plan = ops.SGDMomentumPlan(ws, vs, form="mxnet",
                                   weights=weights if mp else None)
        for lr in (0.1, 0.05, 0.2):
            gs = [(torch.randn(w.shape, generator=gen, device="cuda")
                   * 0.05).to(low) for w in ws]
            want = [ops.sgd_mxnet_plain(w, g, v, lr, momentum, 1e-4, 0.5,
                                        clip)
                    for w, g, v in zip(ws, gs, vs or [None] * len(ws))]
            before = ops.fused_sgd_momentum.launches
            plan(gs, lr, momentum, 1e-4, 0.5, clip)
            assert ops.fused_sgd_momentum.launches == before + 1
            for i, (w_new, v_new) in enumerate(want):
                assert (ws[i].float() - w_new.float()).abs().max() <= \
                    tol * max(1.0, w_new.float().abs().max().item()), i
                if mp:
                    assert torch.equal(weights[i], w_new.to(low)), i
                if momentum:
                    assert (vs[i].float() - v_new.float()).abs().max() <= \
                        tol, i
        kept = [w.clone() for w in ws + weights]
        plan(gs, 0.1, momentum, 1e-4, 0.5, clip,
             ok=torch.zeros((), dtype=torch.bool, device="cuda"))
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(ws + weights, kept))
