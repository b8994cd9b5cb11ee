"""Parity of the port's fusion buckets (mxnet_tpu_torch/parallel/bucketing.py)
with the JAX package's, on the CPU: over ResNet-50's parameter shapes,
mixed fp32/bf16, mixed priorities and lanes, `plan` gives the same
buckets in the same order (keys, shapes, offsets, sizes, signatures) and
`plan_signature` the same fingerprint, at bucket targets of 0, 1 and 25
MB; packing then unpacking is exact and packs what JAX packs; and
`finite_all` is a device verdict that one NaN or infinity turns false.
"""
import numpy as np
import jax
from jax._src import compilation_cache
import jax.numpy as jnp
import pytest
import torch

from mxnet_tpu.parallel import bucketing as jb
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
from mxnet_tpu_torch.parallel import bucketing as tb


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
def r50_shapes():
    return [tuple(p.shape) for p in
            resnet50_v1(layout="NHWC", device="cpu").parameters()]


def _items(shapes, scheme):
    """(key, shape, dtype, priority, lane) over the shapes: 4-d weights
    in bf16, the rest fp32; priorities by slot (the Trainer's -i) or
    mixed; every seventh key in the compressed lane."""
    out = []
    for i, shape in enumerate(shapes):
        dtype = "bfloat16" if len(shape) == 4 else "float32"
        prio = -i if scheme == "slot" else (i % 5) - i // 7
        out.append((i, shape, dtype, prio, i % 7 == 3))
    return tuple(out)


def _layout(buckets):
    return [(b.signature, list(b.keys), list(b.shapes), list(b.offsets),
             list(b.sizes), b.total, b.nbytes, b.first_pos,
             b.best_priority) for b in buckets]


@pytest.mark.parametrize("scheme", ["slot", "mixed"])
@pytest.mark.parametrize("mb", [0, 1, 25])
def test_plan_and_signature_equal_jax(r50_shapes, mb, scheme, monkeypatch):
    monkeypatch.setenv("MXTPU_BUCKET_MB", str(mb))
    assert tb.bucket_target_bytes() == jb.bucket_target_bytes() \
        == mb << 20
    items = _items(r50_shapes, scheme)
    tj, tt = jb.GradBucketer(), tb.GradBucketer()
    bj, bt = tj.plan(items), tt.plan(items)
    assert len(r50_shapes) == 193 and len(bt) > 1
    assert _layout(bt) == _layout(bj)
    assert tt.plan_signature(items) == tj.plan_signature(items)
    assert tt.plan_signature(bt) == tj.plan_signature(bj)
    assert tt.plan(items) is bt          # memoized


def test_layout_changes_change_the_signature(r50_shapes):
    items = _items(r50_shapes[:20], "slot")
    t = tb.GradBucketer(1 << 20)
    sig = t.plan_signature(items)
    assert tb.GradBucketer(2 << 20).plan_signature(items) != sig
    assert t.plan_signature(items[:-1]) != sig
    swapped = ((items[1][:3] + (items[0][3],) + items[1][4:]),
               (items[0][:3] + (items[1][3],) + items[0][4:])) + items[2:]
    assert t.plan_signature(swapped) != sig


def test_pack_then_unpack_is_exact_and_packs_what_jax_packs(r50_shapes):
    shapes = r50_shapes[:12]
    rng = np.random.RandomState(0)
    arrays = [rng.randn(*s).astype(np.float32) for s in shapes]
    items = tuple((i, s, "float32", -i, False) for i, s in enumerate(shapes))
    bt = tb.GradBucketer(64 << 10).plan(items)
    bj = jb.GradBucketer(64 << 10).plan(items)
    for b, j in zip(bt, bj):
        grads = [torch.from_numpy(arrays[k]) for k in b.keys]
        flat = b.pack(grads)
        assert flat.shape == (b.total,)
        assert np.array_equal(
            flat.numpy(), np.asarray(j.pack([jnp.asarray(arrays[k])
                                             for k in j.keys])))
        for k, g, back in zip(b.keys, grads, b.unpack(flat)):
            assert back.shape == g.shape and torch.equal(back, g), k
            assert back.data_ptr() >= flat.data_ptr()     # a view
    # pack copies: the flat does not alias a lone key's gradient
    lone = torch.ones(3)
    solo = tb.GradBucketer(0).plan([(0, (3,), "float32", 0, False)])[0]
    flat = solo.pack([lone])
    flat += 1
    assert torch.equal(lone, torch.ones(3))


@pytest.mark.parametrize("bad", [None, float("nan"), float("inf"),
                                 float("-inf")])
def test_finite_all_is_a_device_verdict(bad):
    flat = torch.linspace(-3, 3, 97)
    if bad is not None:
        flat[41] = bad
    ok = tb.finite_all(flat)
    assert isinstance(ok, torch.Tensor) and ok.dtype == torch.bool
    assert ok.dim() == 0 and bool(ok) == (bad is None)
    assert bool(ok) == bool(jb.finite_all(jnp.asarray(flat.numpy())))
