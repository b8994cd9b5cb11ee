"""The port's `InferenceEngine` against the JAX package's, on the CPU.

Both packages freeze the same narrow ResNet V1 symbol (NHWC bottleneck
units, 32 px, tools/torch_resnet_symbol.py) with the same parameters
and BatchNorm statistics. Tolerances: fp32 outputs within 1e-5 of the
JAX engine's (the same ops; only summation order differs); bucket
choice, padding and the set of built buckets identical; the port's
engine bit-identical to the port's own block forward and executor
forward, which run the same graph on the same values; bf16 within 2e-2
of the port's fp32 outputs scaled by their largest magnitude (bf16 keeps
8 bits of mantissa).
"""
import os
import sys

import numpy as np
import jax
from jax._src import compilation_cache
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.serving import InferenceEngine as JaxEngine
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.observability import goodput, memory
from mxnet_tpu_torch.observability import registry as obs
from mxnet_tpu_torch.serving import InferenceEngine, bucket_sizes

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from torch_resnet_symbol import resnet_v1_symbol  # noqa: E402

TOL = 1e-5
BF16_TOL = 2e-2
SHAPE = (32, 32, 3)
MAX_BATCH = 8


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


def _symbol(mx):
    with mx.name.NameManager():
        return resnet_v1_symbol(mx, units=(1, 1), filters=(8, 16, 32),
                                num_classes=5, layout="NHWC")


def _params(sym, seed=3):
    """Seeded numpy parameters and BatchNorm statistics for `sym`."""
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(1,) + SHAPE)
    args, auxs = {}, {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        if name.endswith("_gamma"):
            args[name] = 1.0 + 0.1 * rng.randn(*shape)
        elif name.endswith(("_beta", "_bias")):
            args[name] = 0.1 * rng.randn(*shape)
        else:
            fan_in = np.prod(shape[1:]) if len(shape) > 1 else shape[0]
            args[name] = rng.randn(*shape) * np.sqrt(2.0 / fan_in)
    for name, shape in zip(sym.list_auxiliary_states(), aux_shapes):
        auxs[name] = (rng.uniform(0.5, 1.5, shape) if name.endswith("var")
                      else 0.1 * rng.randn(*shape))
    cast = {k: v.astype(np.float32) for k, v in {**args, **auxs}.items()}
    return ({k: cast[k] for k in args}, {k: cast[k] for k in auxs})


@pytest.fixture(scope="module")
def model():
    js, ts = _symbol(jmx), _symbol(tmx)
    assert ts.tojson() == js.tojson()
    args, auxs = _params(js)
    return js, ts, args, auxs


def _engines(model, dtype=None, name="resnet"):
    js, ts, args, auxs = model
    jeng = JaxEngine.from_symbol(
        js, {k: jmx.nd.array(v) for k, v in args.items()},
        {k: jmx.nd.array(v) for k, v in auxs.items()}, {"data": SHAPE},
        MAX_BATCH, name=name, dtype=dtype)
    teng = InferenceEngine.from_symbol(
        ts, {k: tmx.nd.array(v, ctx=tmx.cpu()) for k, v in args.items()},
        {k: tmx.nd.array(v, ctx=tmx.cpu()) for k, v in auxs.items()},
        {"data": SHAPE}, MAX_BATCH, name=name, dtype=dtype, device="cpu")
    return jeng, teng


def _x(n, seed=0):
    return np.random.RandomState(seed).randn(n, *SHAPE).astype(np.float32)


def _builds(name):
    """`serving.engine.compiles` of engine `name`, over its buckets."""
    builds = obs.REGISTRY.get("serving.engine.compiles")
    return sum(builds.get(engine=name, bucket=str(b))
               for b in bucket_sizes(MAX_BATCH))


@pytest.mark.parametrize("max_batch", [1, 2, 5, 8, 32, 33])
def test_bucket_ladder_and_choice_match_jax(model, max_batch):
    from mxnet_tpu.serving import bucket_sizes as jax_bucket_sizes
    assert bucket_sizes(max_batch) == jax_bucket_sizes(max_batch)
    jeng, teng = _engines(model)
    for n in range(1, MAX_BATCH + 1):
        assert teng.bucket_for(n) == jeng.bucket_for(n)


def test_outputs_match_jax_at_every_size(model):
    jeng, teng = _engines(model, name="resnet_sizes")
    for n in (1, 2, 3, 5, 8):
        x = _x(n, seed=n)
        got = teng.infer(x)[0].asnumpy()
        ref = jeng.infer(x)[0].asnumpy()
        assert got.shape == ref.shape == (n, 5)
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    assert teng.compiled_buckets == jeng.compiled_buckets == [1, 2, 4, 8]
    assert _builds("resnet_sizes") == 4


@pytest.mark.parametrize("on_device", [False, True])
def test_padding_matches_jax(model, on_device):
    jeng, teng = _engines(model)
    x = _x(3)
    jdesc = jeng._descs[0]
    tdesc = teng._descs[0]
    jx = jmx.nd.array(x) if on_device else x
    tx = torch.from_numpy(x) if on_device else x
    jpad = np.asarray(jeng._pad(jx, jdesc, 4))
    tpad = teng._pad(tx, tdesc, 4, torch.device("cpu"))
    assert tpad.shape == (4,) + SHAPE and tpad.dtype == torch.float32
    np.testing.assert_array_equal(tpad.numpy(), jpad)


def test_sweep_after_warmup_builds_nothing(model):
    _, teng = _engines(model, name="resnet_warm")
    assert teng.warmup() == [1, 2, 4, 8]
    assert teng.warmup() == []
    before = _builds("resnet_warm")
    for n in range(1, MAX_BATCH + 1):
        assert teng.infer(_x(n))[0].shape == (n, 5)
    teng.set_params({k: v * 1.0 for k, v in teng._params.items()})
    teng.infer(_x(2))
    assert _builds("resnet_warm") == before == 4


def test_bf16_engine_casts_and_returns_fp32(model):
    _, t32 = _engines(model, name="resnet_fp32")
    _, t16 = _engines(model, dtype="bf16", name="resnet_bf16")
    assert all(v.dtype == torch.bfloat16 for v in t16._params.values())
    x = _x(5)
    ref = t32.infer(x)[0].asnumpy()
    got = t16.infer(x)[0]
    assert got._data.dtype == torch.float32
    scale = np.abs(ref).max()
    assert np.abs(got.asnumpy() - ref).max() <= BF16_TOL * scale


def test_from_block_is_bit_identical_to_the_blocks_forward():
    with tmx.cpu():
        net = tmx.gluon.model_zoo.vision.resnet18_v1(classes=10)
        net.initialize(tmx.init.Xavier())
        net.hybridize()
        x = np.random.RandomState(1).randn(4, 3, 32, 32).astype(np.float32)
        ref = net(tmx.nd.array(x)).asnumpy()
        eng = InferenceEngine.from_block(net, tmx.nd.array(x[:1]),
                                         max_batch_size=4)
        ref2 = net(tmx.nd.array(x[:2])).asnumpy()
    assert eng.device == torch.device("cpu") and eng.buckets == (1, 2, 4)
    np.testing.assert_array_equal(eng.infer(x)[0].asnumpy(), ref)
    np.testing.assert_array_equal(eng.infer(x[:2])[0].asnumpy(), ref2)


def _modules(model, batch=MAX_BATCH):
    js, ts, args, auxs = model
    jm = jmx.mod.Module(js, context=jmx.cpu())
    tm = tmx.mod.Module(ts, context=tmx.cpu())
    jm.bind([("data", (batch,) + SHAPE)], for_training=False)
    tm.bind([("data", (batch,) + SHAPE)], for_training=False)
    jm.init_params(arg_params={k: jmx.nd.array(v) for k, v in args.items()},
                   aux_params={k: jmx.nd.array(v) for k, v in auxs.items()})
    tm.init_params(arg_params={k: tmx.nd.array(v, ctx=tmx.cpu())
                               for k, v in args.items()},
                   aux_params={k: tmx.nd.array(v, ctx=tmx.cpu())
                               for k, v in auxs.items()})
    return jm, tm


def test_module_predict_runs_the_engine_and_equals_the_executor(
        model, monkeypatch):
    jm, tm = _modules(model)
    x = _x(MAX_BATCH, seed=4)
    batch = tmx.io.DataBatch([tmx.nd.array(x, ctx=tmx.cpu())])
    tm.forward(batch, is_train=False)
    via_engine = tm.get_outputs()[0].asnumpy()
    assert tm._serving_engine_obj and \
        tm._serving_engine_obj.compiled_buckets == [MAX_BATCH]
    monkeypatch.setenv("MXTPU_SERVING_ENGINE", "0")
    tm.forward(batch, is_train=False)
    np.testing.assert_array_equal(tm.get_outputs()[0].asnumpy(), via_engine)
    jm.forward(jmx.io.DataBatch([jmx.nd.array(x)]), is_train=False)
    np.testing.assert_allclose(via_engine, jm.get_outputs()[0].asnumpy(),
                               rtol=TOL, atol=TOL)


def test_module_ragged_tail_batch_pads_through_the_engine(model):
    _, tm = _modules(model)
    x = _x(3, seed=5)
    tm.forward(tmx.io.DataBatch([tmx.nd.array(x, ctx=tmx.cpu())]),
               is_train=False)
    got = tm.get_outputs()[0].asnumpy()
    assert got.shape == (3, 5)
    assert tm._exec_group.exec_.arg_dict["data"].shape[0] == MAX_BATCH
    eng = tm._serving_engine_obj
    np.testing.assert_array_equal(got, eng.infer(x)[0].asnumpy())
    tm.set_params(*tm.get_params())
    assert tm._serving_engine_obj is None     # params changed: refreeze


def test_from_module_matches_jax(model):
    jm, tm = _modules(model)
    jeng = JaxEngine.from_module(jm)
    teng = InferenceEngine.from_module(tm)
    assert teng.device == torch.device("cpu")
    assert teng.max_batch_size == jeng.max_batch_size == MAX_BATCH
    x = _x(6, seed=6)
    np.testing.assert_allclose(teng.infer(x)[0].asnumpy(),
                               jeng.infer(x)[0].asnumpy(),
                               rtol=TOL, atol=TOL)


def test_ledger_and_goodput_follow_the_engine(model):
    memory._reset_for_tests()
    goodput._reset_for_tests()
    _, teng = _engines(model, name="resnet_ledger")
    assert memory.model_bytes("resnet_ledger") == teng.device_bytes() > 0
    flops_before = goodput.FLOPS.total()
    teng.infer(_x(2))
    cost = goodput.cost("engine/resnet_ledger/b2")
    assert cost["source"] == "measured" and cost["flops"] > 0
    teng.infer(_x(2))
    assert goodput.FLOPS.total() - flops_before == 2 * cost["flops"]
    # a bucket's counted FLOPs scale with its rows
    teng.infer(_x(4))
    assert goodput.cost("engine/resnet_ledger/b4")["flops"] == \
        2 * cost["flops"]


def test_input_errors_and_the_unported_compile_plane(model):
    _, teng = _engines(model)
    with pytest.raises(MXNetError, match="per-example shape"):
        teng.infer(np.zeros((2, 16, 16, 3), np.float32))
    with pytest.raises(MXNetError, match="exceeds max_batch_size"):
        teng.infer(_x(MAX_BATCH + 1))
    with pytest.raises(MXNetError, match="missing input"):
        teng.infer({"other": _x(1)})
    with pytest.raises(MXNetError, match=">= 1"):
        teng.bucket_for(0)
    with pytest.raises(MXNetError, match="A9"):
        teng.aot_export("/nonexistent")
    with pytest.raises(MXNetError, match="A9"):
        teng.aot_load("/nonexistent")
    zeros = teng.zero_inputs(3)
    assert zeros["data"].shape == (3,) + SHAPE


def test_default_device_is_the_card(model):
    js, ts, args, auxs = model
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from mxnet_tpu_torch.context import DeviceUnreachable
    with pytest.raises(DeviceUnreachable):
        InferenceEngine.from_symbol(ts, {}, {}, {"data": SHAPE}, 2)
