"""`nd.save`/`nd.load` across the two packages, on the CPU: the port
reads the .params files the JAX package writes and the JAX package reads
the port's, for a list and for a dict of arrays, in float32, float16,
int32 and uint8 (names, dtypes, shapes and values exactly); bfloat16 is
stored as float32 by both. The file is the reference's container, so
the bytes of the same arrays are the same."""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, nd
from torch_ops_parity import _no_persistent_compile_cache  # noqa: F401

DTYPES = ("float32", "float16", "int32", "uint8")


def _arrays():
    rng = np.random.RandomState(0)
    out = {}
    for i, dt in enumerate(DTYPES):
        shape = [(2, 3), (4,), (2, 2, 2), (5, 1)][i]
        out["arg:w_%s" % dt] = (rng.uniform(0, 200, shape)).astype(dt)
    return out


def _check(loaded, want, as_dict):
    if as_dict:
        assert list(loaded) == list(want)
        pairs = [(loaded[k], want[k]) for k in want]
    else:
        assert isinstance(loaded, list) and len(loaded) == len(want)
        pairs = list(zip(loaded, want.values()))
    for got, ref in pairs:
        got = got.asnumpy()
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert np.array_equal(got, ref)


@pytest.mark.parametrize("as_dict", [True, False])
def test_port_reads_what_jax_writes(tmp_path, as_dict):
    arrays = _arrays()
    data = {k: jmx.nd.array(v, dtype=v.dtype) for k, v in arrays.items()}
    fname = str(tmp_path / "jax.params")
    jmx.nd.save(fname, data if as_dict else list(data.values()))
    with mx.cpu():
        _check(nd.load(fname), arrays, as_dict)


@pytest.mark.parametrize("as_dict", [True, False])
def test_jax_reads_what_the_port_writes(tmp_path, as_dict):
    arrays = _arrays()
    with mx.cpu():
        data = {k: nd.array(v, dtype=v.dtype) for k, v in arrays.items()}
    fname = str(tmp_path / "port.params")
    nd.save(fname, data if as_dict else list(data.values()))
    _check(jmx.nd.load(fname), arrays, as_dict)
    # the same arrays make the same bytes
    jname = str(tmp_path / "jax.params")
    jmx.nd.save(jname, {k: jmx.nd.array(v, dtype=v.dtype)
                        for k, v in arrays.items()} if as_dict else
                [jmx.nd.array(v, dtype=v.dtype) for v in arrays.values()])
    with open(fname, "rb") as a, open(jname, "rb") as b:
        assert a.read() == b.read()


def test_bfloat16_is_stored_as_float32_both_ways(tmp_path):
    x = np.array([[1.5, -2.25], [3.0, 0.125]], np.float32)
    with mx.cpu():
        t = nd.array(x, dtype="bfloat16")
        assert t._data.dtype == torch.bfloat16
        nd.save(str(tmp_path / "p.params"), {"w": t})
    j = jmx.nd.load(str(tmp_path / "p.params"))["w"]
    assert j.dtype == np.float32 and np.array_equal(j.asnumpy(), x)
    jmx.nd.save(str(tmp_path / "j.params"),
                [jmx.nd.array(x, dtype="bfloat16")])
    with mx.cpu():
        (back,) = nd.load(str(tmp_path / "j.params"))
    assert back.dtype == np.float32 and np.array_equal(back.asnumpy(), x)


def test_round_trip_in_the_port_and_bad_files(tmp_path):
    with mx.cpu():
        a = nd.array(np.arange(6, dtype=np.float32).reshape(2, 3))
        fname = str(tmp_path / "a.params")
        nd.save(fname, a)
        (b,) = nd.load(fname)
        assert np.array_equal(a.asnumpy(), b.asnumpy())
        with open(fname, "rb") as f:
            buf = f.read()
        assert np.array_equal(nd.load_frombuffer(buf)[0].asnumpy(),
                              a.asnumpy())
        with pytest.raises(MXNetError, match="truncated"):
            nd.load_frombuffer(buf[:-4])
        with pytest.raises(MXNetError, match="bad magic"):
            nd.load_frombuffer(b"\0" * 16)
        with pytest.raises(MXNetError, match="keys must be strings"):
            nd.save(fname, {1: a})
