"""Parity of the PyTorch port's GPT with the JAX package's.

One small GPT is initialised by the JAX package, its weights carried over
with `convert.gpt_params_from_jax`, and the same numpy inputs go through
the JAX pure functions (`forward_fn`, `prefill_fn`, `step_fn`,
`generate_reference`) and the port's counterparts. On the CPU the port's
kernel wrappers run their plain versions.

Eager JAX compiles every op anew for each sequence length, so the inputs
keep every JAX call at T <= 8 (the lengths test_torch_serving.py uses).
"""
import numpy as np
import jax
from jax._src import compilation_cache
import jax.numpy as jnp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo.gpt import GPTDecoder as JaxGPT
from mxnet_tpu_torch.convert import gpt_params_from_jax, init_gpt_params
from mxnet_tpu_torch.gluon.model_zoo import GPTDecoder

VOCAB, MAXLEN = 96, 32
CFG = dict(max_seq_len=MAXLEN, num_layers=2, num_heads=2, embed_dim=16)
FP32_TOL = 1e-4          # logits / K / V, fp32 on both sides
BF16_TOL = 0.05          # logits up to ~1.4; 0.024 measured (bf16 rounds
                         # at other places on the two sides)


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


@pytest.fixture(scope="module")
def pair():
    np.random.seed(7)
    jblk = JaxGPT(VOCAB, **CFG)
    jblk.initialize(mx.init.Xavier(magnitude=2.5))
    np_params = {k: np.asarray(v) for k, v in jblk.decode_params().items()}
    tblk = GPTDecoder(VOCAB, params=gpt_params_from_jax(np_params, "cpu"),
                      device="cpu", **CFG)
    return jblk, tblk, np_params


def test_weights_carry_over(pair):
    jblk, tblk, np_params = pair
    got = {k: v.numpy() for k, v in tblk.decode_params().items()}
    assert set(got) == set(np_params)
    for name, arr in np_params.items():
        assert np.array_equal(got[name], arr), name
    # seeded weights have the same names and shapes
    seeded = init_gpt_params(tblk.decode_spec(), seed=0)
    assert {k: v.shape for k, v in seeded.items()} == \
        {k: v.shape for k, v in np_params.items()}


def test_forward_matches_jax(pair):
    jblk, tblk, _ = pair
    toks = np.random.RandomState(1).randint(0, VOCAB, size=(2, 7))
    want = np.asarray(jblk.forward_fn()(jblk.decode_params(),
                                        toks.astype(np.int32)))
    got = tblk(torch.from_numpy(toks)).numpy()
    assert got.shape == (2, 7, VOCAB) and got.dtype == np.float32
    assert np.abs(got - want).max() < FP32_TOL


@pytest.mark.parametrize("length,bucket", [(5, 8), (8, 8)])
def test_prefill_matches_jax(pair, length, bucket):
    jblk, tblk, _ = pair
    padded = np.zeros((1, bucket), np.int64)
    padded[0, :length] = np.random.RandomState(length).randint(
        1, VOCAB, size=length)
    nt, k, v = jblk.prefill_fn()(jblk.decode_params(),
                                 padded.astype(np.int32), np.int32(length))
    tnt, tk, tv = tblk.prefill(torch.from_numpy(padded), length)
    assert int(tnt) == int(nt)
    assert tk.shape == (2, MAXLEN, 2, 8)
    assert np.abs(tk.numpy() - np.asarray(k)).max() < FP32_TOL
    assert np.abs(tv.numpy() - np.asarray(v)).max() < FP32_TOL
    assert not tk[:, length:].any() and not tv[:, length:].any()


def test_step_matches_jax_with_parked_slot(pair):
    """Slots 0 and 1 decode; slot 2 is inactive and parked at
    positions == max_seq_len, one past the cache (a retired sequence that
    filled its window). The active slots must match JAX; the parked one
    must neither raise nor touch its cache rows."""
    jblk, tblk, _ = pair
    r = np.random.RandomState(3)
    shape = (2, 3, MAXLEN, 2, 8)
    ck, cv = (r.randn(*shape).astype(np.float32) for _ in range(2))
    positions = np.array([4, 17, MAXLEN], np.int64)
    active = np.array([True, True, False])
    tokens = np.array([5, 60, 11], np.int64)
    jck, jcv, jpos, jnext = jblk.step_fn()(
        jblk.decode_params(), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(positions, jnp.int32), jnp.asarray(active),
        jnp.asarray(tokens, jnp.int32))
    tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    tpos = torch.from_numpy(positions.copy())
    tnext = tblk.step(tck, tcv, tpos, torch.from_numpy(active),
                      torch.from_numpy(tokens))
    assert np.array_equal(tnext.numpy()[:2], np.asarray(jnext)[:2])
    assert np.array_equal(tpos.numpy(), np.asarray(jpos))
    assert tpos.tolist() == [5, 18, MAXLEN]
    for got, want in ((tck, jck), (tcv, jcv)):
        assert np.abs(got.numpy()[:, :2] - np.asarray(want)[:, :2]).max() \
            < FP32_TOL
    assert np.array_equal(tck.numpy()[:, 2], ck[:, 2])
    assert np.array_equal(tcv.numpy()[:, 2], cv[:, 2])


def test_generate_reference_token_identical(pair):
    jblk, tblk, _ = pair
    r = np.random.RandomState(5)
    for n in (3, 4):
        prompt = r.randint(1, VOCAB, size=n)
        assert np.array_equal(tblk.generate_reference(prompt, 5),
                              jblk.generate_reference(prompt, 5))


def test_bf16_forward_within_tolerance(pair):
    """bf16 weights on both sides. The JAX forward rounds scores and
    LayerNorm intermediates to bf16 where the port's kernels keep fp32,
    so the two agree to bf16 precision, not bit for bit."""
    jblk, _, np_params = pair
    toks = np.random.RandomState(2).randint(0, VOCAB, size=(1, 6))
    want = np.asarray(jblk.forward_fn()(jblk.decode_params(dtype="bf16"),
                                        toks.astype(np.int32)))
    tblk16 = GPTDecoder(VOCAB, params=gpt_params_from_jax(
        np_params, "cpu", dtype="bf16"), device="cpu", **CFG)
    assert all(p.dtype == torch.bfloat16 for p in tblk16.parameters())
    got = tblk16(torch.from_numpy(toks)).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() < BF16_TOL
