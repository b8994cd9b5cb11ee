"""The PyTorch port's continuous-batching decode against the JAX
package's reference, on the CPU.

The acceptance oracle of tests/test_decode.py carried over: greedy
decode through the port's `DecodeEngine` + `ContinuousBatchScheduler`,
with sequences joining mid-batch, is token-identical to the JAX
`GPTDecoder.generate_reference` on the same weights. Plus the scheduler
edge cases: deadline eviction at a step boundary, drain with sequences
in flight, and shedding at a full queue.

Eager JAX compiles every op anew for each sequence length, so every
prompt here has 2-5 tokens and at most 4 are generated: all JAX work
stays at T <= 8, and the JAX references are memoised per prompt.
"""
import time

import numpy as np
import jax
from jax._src import compilation_cache
import pytest

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo.gpt import GPTDecoder as JaxGPT
from mxnet_tpu_torch.convert import gpt_params_from_jax
from mxnet_tpu_torch.observability import registry as obs
from mxnet_tpu_torch.gluon.model_zoo import GPTDecoder
from mxnet_tpu_torch.resilience import Deadline, DeadlineExceeded
from mxnet_tpu_torch.serving import (ContinuousBatchScheduler, DecodeEngine,
                                     RequestRejected, ServerClosed)

VOCAB, MAXLEN = 96, 32
CFG = dict(max_seq_len=MAXLEN, num_layers=2, num_heads=2, embed_dim=16)


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
def model():
    np.random.seed(19)
    jblk = JaxGPT(VOCAB, **CFG)
    jblk.initialize(mx.init.Xavier(magnitude=2.5))
    np_params = {k: np.asarray(v) for k, v in jblk.decode_params().items()}
    tblk = GPTDecoder(VOCAB, params=gpt_params_from_jax(np_params, "cpu"),
                      device="cpu", **CFG)
    memo = {}

    def reference(prompt, n):
        key = (tuple(int(t) for t in prompt), n)
        if key not in memo:
            memo[key] = jblk.generate_reference(prompt, n)
        return memo[key]

    return tblk, reference


def prompts_for(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, VOCAB, size=rng.randint(2, 6)) for _ in range(n)]


def slow_steps(engine, seconds):
    """Stretch every decode step so deadlines and queues act mid-run."""
    step = engine.step

    def slow():
        time.sleep(seconds)
        return step()
    engine.step = slow


def test_continuous_batching_token_identical_to_jax_with_joins(model):
    """6 prompts through 4 slots: the last two join mid-batch into freed
    slots, and every sequence still matches the JAX full re-forward."""
    tblk, reference = model
    eng = DecodeEngine(tblk, max_slots=4, device="cpu", name="joins")
    sched = ContinuousBatchScheduler(eng, max_new_tokens=4).start()
    prompts = prompts_for(6, seed=23)
    handles = [sched.submit(p) for p in prompts]
    outs = [h.result(timeout=60) for h in handles]
    assert sched.drain(timeout=30)
    stats = sched.stats()
    assert stats["served"] == 6 and stats["tokens"] == 24
    assert stats["steps"] > 3      # the joiners rode later steps
    for prompt, out in zip(prompts, outs):
        assert out.dtype == np.int32
        assert np.array_equal(out, reference(prompt, 4)), prompt
    # the scheduler's metrics, read back from the port's registry
    assert obs.REGISTRY.get("serving.decode.tokens").get(
        engine="joins") == 24
    assert obs.REGISTRY.get("serving.decode.ttft").percentile(
        0.5, engine="joins") > 0
    fill = obs.REGISTRY.get("serving.decode.slot.fill_ratio")
    assert fill.count(engine="joins") == stats["steps"]


def test_deadline_eviction_at_step_boundary(model):
    tblk, reference = model
    eng = DecodeEngine(tblk, max_slots=2, device="cpu", name="evict")
    slow_steps(eng, 0.02)
    sched = ContinuousBatchScheduler(eng, max_new_tokens=25).start()
    prompts = prompts_for(2, seed=29)
    doomed = sched.submit(prompts[0], deadline=Deadline(0.2))
    safe = sched.submit(prompts[1], max_new_tokens=3)
    assert np.array_equal(safe.result(timeout=60), reference(prompts[1], 3))
    with pytest.raises(DeadlineExceeded):
        doomed.result(timeout=60)
    assert doomed.generated, "evicted mid-flight, not at admission"
    assert sched.stats()["evicted"] == 1
    # the freed slot is reusable
    again = sched.generate(prompts[0], max_new_tokens=2, timeout=60)
    assert np.array_equal(again, reference(prompts[0], 2))
    assert sched.drain(timeout=30)


def test_deadline_rejected_at_admission(model):
    tblk, _ = model
    eng = DecodeEngine(tblk, max_slots=1, device="cpu", name="adm")
    sched = ContinuousBatchScheduler(eng, max_new_tokens=4)
    h = sched.submit([1, 2, 3], deadline=Deadline(0.0))
    sched.start()
    with pytest.raises(DeadlineExceeded):
        h.result(timeout=30)
    assert not h.generated and eng.steps == 0
    assert sched.drain(timeout=30)


def test_drain_finishes_sequences_in_flight(model):
    tblk, reference = model
    eng = DecodeEngine(tblk, max_slots=2, device="cpu", name="drain")
    sched = ContinuousBatchScheduler(eng, max_new_tokens=4).start()
    prompts = prompts_for(5, seed=47)
    handles = [sched.submit(p) for p in prompts]
    assert sched.drain(timeout=60)
    for prompt, h in zip(prompts, handles):
        assert np.array_equal(h.result(timeout=0.1), reference(prompt, 4))
    with pytest.raises(ServerClosed):
        sched.submit([1, 2])


@pytest.mark.parametrize("policy", ["reject", "drop_oldest"])
def test_shed_at_full_queue(model, policy):
    """With the only slot busy the queue backs up; past queue_depth the
    policy applies: reject refuses the newcomer, drop_oldest evicts the
    stalest queued request in its favour."""
    tblk, reference = model
    eng = DecodeEngine(tblk, max_slots=1, device="cpu", name="shed")
    slow_steps(eng, 0.02)
    sched = ContinuousBatchScheduler(eng, max_new_tokens=20, queue_depth=1,
                                     shed_policy=policy).start()
    running = sched.submit([1, 2, 3])
    deadline = time.monotonic() + 30
    while not eng.active.any():             # wait until it holds the slot
        assert time.monotonic() < deadline
        time.sleep(0.005)
    queued = sched.submit([4, 5], max_new_tokens=2)
    if policy == "reject":
        with pytest.raises(RequestRejected):
            sched.submit([5, 6], max_new_tokens=2)
        survivor = queued
    else:
        survivor = sched.submit([5, 6], max_new_tokens=2)
        with pytest.raises(RequestRejected):
            queued.result(timeout=30)
    assert sched.stats()["shed"] == 1
    assert len(running.result(timeout=60)) == 20
    assert np.array_equal(survivor.result(timeout=60),
                          reference(survivor.tokens, 2))
    assert sched.drain(timeout=30)
