"""Parity of the PyTorch port's `ShardedTrainer` with the JAX package's, on
the CPU.

One small JAX ResNetV1 (BottleneckV1, [1, 1], [16, 32, 64], 10 classes,
NHWC) gives its weights to a port net, and both trainers take 3 `step`s of
momentum SGD on the same numpy batch, the JAX one on a one-device mesh.
Per step the losses, parameters, momenta and BatchNorm statistics must
agree: fp32 on both sides, and bf16 compute (looser). On the CPU the
port's step runs the plain versions of `conv1x1_bn_stats` and
`fused_sgd_momentum`.
"""
import numpy as np
import jax
from jax._src import compilation_cache
import jax.numpy as jnp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer, make_mesh
from mxnet_tpu_torch import DeviceUnreachable, MXNetError
from mxnet_tpu_torch.convert import resnet_params_from_jax
from mxnet_tpu_torch.gluon import collect_params
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.parallel import ShardedTrainer
from mxnet_tpu_torch.resilience import numerics

OPT = {"learning_rate": 0.1, "momentum": 0.9}
# fp32 on both sides: the sums run in other orders, and the errors grow a
# little over the steps through the updates
TOL = dict(loss=1e-5, param=1e-5, momentum=1e-4, aux=1e-5)
# bf16: the two packages round to bf16 at other places (the port's
# BatchNorm statistics come from the fp32 accumulator of the 1x1 kernel,
# JAX's from the bf16-rounded conv output), and at lr 0.1 the rounding
# noise grows step by step: by step 3 the losses of bf16 runs of either
# package scatter up to 0.05 around the fp32 loss (measured, 2 seeds).
# Per tensor, the port's bf16 state must lie no farther from JAX's bf16
# state than NOISE times JAX's own bf16-to-fp32 distance, plus MARGIN.
BF16_LOSS_TOL = 0.06
NOISE = 2.0
MARGIN = dict(param=2e-3, momentum=2e-2, aux=2e-3)


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


@pytest.fixture(autouse=True)
def _fresh_verdicts():
    numerics.drain_flags()


@pytest.fixture(scope="module")
def weights():
    np.random.seed(4)
    mx.random.seed(4)
    net = jresnet.ResNetV1(jresnet.BottleneckV1, [1, 1], [16, 32, 64],
                           classes=10, layout="NHWC")
    net.initialize(mx.init.Xavier(magnitude=2))
    net.infer_shape(mx.nd.zeros((1, 32, 32, 3)))
    for p in net.collect_params().values():
        p._finish_deferred_init()
    rng = np.random.RandomState(5)
    x = rng.randn(8, 32, 32, 3).astype(np.float32)
    y = (np.arange(8) % 10).astype(np.float32)
    return net, x, y


def _port_trainer(np_params, compute_dtype=None):
    net = vision.ResNetV1(vision.BottleneckV1, [1, 1], [16, 32, 64],
                          classes=10, layout="NHWC", device="cpu")
    net.load_parameters(resnet_params_from_jax(np_params, "cpu", "NHWC"))
    return ShardedTrainer(net, SoftmaxCrossEntropyLoss(), "sgd", dict(OPT),
                          compute_dtype=compute_dtype, device="cpu")


def _as_port(name, arr):
    """A JAX state array under its port name, in the port's layout."""
    arr = np.asarray(arr.astype(jnp.float32))
    if arr.ndim == 4:
        arr = arr.transpose(0, 3, 1, 2)
    return name.split("_", 1)[1], arr


def _errs(port, jax_state, prefix):
    """{name: max abs difference} of the port's state (names under the
    port net's `prefix`) from JAX's."""
    out = {}
    for jname, arr in jax_state.items():
        name, want = _as_port(jname, arr)
        out[name] = np.abs(port[prefix + name].numpy() - want).max()
    return out


def _jax_trainer(jnet, compute_dtype):
    loss = jgluon.loss.SoftmaxCrossEntropyLoss()
    return JaxTrainer(jnet, lambda o, l: loss(o, l), "sgd", dict(OPT),
                      mesh=make_mesh({"dp": 1}, devices=jax.devices()[:1]),
                      compute_dtype=compute_dtype)


def _state(trainer, port):
    if port:
        return dict(param=trainer.params, momentum=trainer.momentum,
                    aux=trainer.aux)
    return dict(param=trainer.params, momentum=trainer._opt_state,
                aux=trainer._aux)


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_three_steps_match_jax_trainer(weights, compute_dtype):
    """3 steps; per step the loss, parameters, momenta and BatchNorm
    statistics. In bf16 a JAX fp32 trainer beside them gives the scale of
    the rounding noise (see NOISE)."""
    jnet, x, y = weights
    np_params = {k: np.asarray(v.data()._data)
                 for k, v in jnet.collect_params().items()}
    jst = _jax_trainer(jnet, compute_dtype)
    ref = _jax_trainer(jnet, None) if compute_dtype else None
    st = _port_trainer(np_params, compute_dtype)
    for step in range(3):
        want = float(np.asarray(jst.step(x, y)._data))
        got = float(st.step(torch.from_numpy(x), torch.from_numpy(y)))
        port, jax_ = _state(st, True), _state(jst, False)
        if ref is None:
            assert abs(got - want) < TOL["loss"], (step, got, want)
            for kind in ("param", "momentum", "aux"):
                err = max(_errs(port[kind], jax_[kind],
                                st._net.prefix).values())
                assert err < TOL[kind], (step, kind, err)
            continue
        ref.step(x, y)
        assert abs(got - want) < BF16_LOSS_TOL, (step, got, want)
        fp32 = _state(ref, False)
        for kind in ("param", "momentum", "aux"):
            noise = {_as_port(k, a)[0]: np.abs(
                _as_port(k, a)[1] - _as_port(k, fp32[kind][k])[1]).max()
                for k, a in jax_[kind].items()}
            for name, err in _errs(port[kind], jax_[kind],
                                   st._net.prefix).items():
                assert err <= NOISE * noise[name] + MARGIN[kind], \
                    (step, kind, name, err, noise[name])
    assert all(v.dtype == torch.float32 for v in st.params.values())
    assert numerics.drain_flags()["skipped_steps"] == 0
    # the trained state goes back into the net
    st.copy_params_to_net()
    own = dict(st._net.named_parameters())
    own.update(st._net.named_buffers())
    for name, path in collect_params(st._net).items():
        assert torch.equal(own[path], {**st.params, **st.aux}[name]), name


def test_step_many_equals_three_steps(weights):
    jnet, x, y = weights
    np_params = {k: np.asarray(v.data()._data)
                 for k, v in jnet.collect_params().items()}
    a, b = _port_trainer(np_params), _port_trainer(np_params)
    xs, ys = torch.from_numpy(x), torch.from_numpy(y)
    stepped = [float(a.step(xs, ys)) for _ in range(3)]
    many = b.step_many(xs, ys, n_steps=3)
    assert many.shape == (3,)
    assert np.allclose(many.numpy(), stepped, rtol=0, atol=1e-6)
    for state in ("params", "momentum", "aux"):
        pa, pb = getattr(a, state), getattr(b, state)
        # two nets, two top-level prefixes: the same names below them
        for (k, va), (kb, vb) in zip(pa.items(), pb.items()):
            assert k[len(a._net.prefix):] == kb[len(b._net.prefix):]
            assert torch.allclose(va, vb, rtol=0, atol=1e-6), k
    guard = numerics.drain_flags()
    assert guard["skipped_steps"] == 0 and guard["anomalies"] == 0
    assert guard["total"] == 4     # 3 step verdicts + 1 window verdict


def test_nan_gradient_skips_the_step_bit_identically(weights):
    jnet, x, y = weights
    np_params = {k: np.asarray(v.data()._data)
                 for k, v in jnet.collect_params().items()}
    st = _port_trainer(np_params)
    xs, ys = torch.from_numpy(x), torch.from_numpy(y)
    st.step(xs, ys)
    numerics.drain_flags()
    before = (st.params, st.momentum, st.aux)
    bad = xs.clone()
    bad[0, 0, 0, 0] = float("nan")
    assert not np.isfinite(float(st.step(bad, ys)))
    for old, new in zip(before, (st.params, st.momentum, st.aux)):
        for k in old:
            assert torch.equal(old[k], new[k]), k
    guard = numerics.drain_flags()
    assert guard["skipped_steps"] == 1 and guard["anomalies"] == 1
    # the next good step trains on from the preserved state
    assert np.isfinite(float(st.step(xs, ys)))
    # a bad step_many window is detected, not skipped
    st.step_many(bad, ys, n_steps=2)
    guard = numerics.drain_flags()
    assert guard["anomalies"] == 1 and guard["skipped_steps"] == 0


def test_trainer_sets_up_its_update_once(weights, monkeypatch):
    """The trainer builds one `SGDMomentumPlan` over its parameters and
    momenta in `__init__`; every update after that, by `step` or
    `step_many`, is one call of that plan with the step's new gradients."""
    from mxnet_tpu_torch.parallel import data_parallel
    built, calls = [], []

    class CountingPlan(data_parallel.SGDMomentumPlan):
        def __init__(self, ws, ms):
            built.append(self)
            super().__init__(ws, ms)

        def __call__(self, gs, *args):
            calls.append([g.data_ptr() for g in gs])
            return super().__call__(gs, *args)

    monkeypatch.setattr(data_parallel, "SGDMomentumPlan", CountingPlan)
    jnet, x, y = weights
    np_params = {k: np.asarray(v.data()._data)
                 for k, v in jnet.collect_params().items()}
    st = _port_trainer(np_params)
    xs, ys = torch.from_numpy(x), torch.from_numpy(y)
    st.step(xs, ys)
    st.step_many(xs, ys, n_steps=2)
    assert len(built) == 1 and len(calls) == 3
    assert len(calls[0]) == len(st.params) == len(built[0]._ws)
    assert {p.data_ptr() for p in st._params.values()} == \
        {w.data_ptr() for w in built[0]._ws}


def test_trainer_refuses_what_the_port_does_not_have(weights, monkeypatch):
    """What the port's trainer refuses: ZeRO-1 together with gradient
    compression (JAX's refusal; an MXTPU_ZERO1 default gives way to
    compression), a compression type other than 2bit; parameters the
    optimizer does not have; a batch of the wrong arity; and, with no
    card, the default device. (Adam, aux_mode="predict", compression and
    ZeRO-1 are ported.)"""
    jnet, _, _ = weights
    np_params = {k: np.asarray(v.data()._data)
                 for k, v in jnet.collect_params().items()}
    st = _port_trainer(np_params)
    net = st._net
    gc = {"type": "2bit", "threshold": 0.5}
    with pytest.raises(MXNetError, match="shard_optimizer_state.*"
                       "gradient_compression"):
        ShardedTrainer(net, SoftmaxCrossEntropyLoss(), "sgd", dict(OPT),
                       device="cpu", gradient_compression=gc,
                       shard_optimizer_state=True)
    with pytest.raises(MXNetError, match="compression type"):
        ShardedTrainer(net, SoftmaxCrossEntropyLoss(), "sgd", dict(OPT),
                       device="cpu", gradient_compression={"type": "1bit"})
    monkeypatch.setenv("MXTPU_ZERO1", "1")
    assert ShardedTrainer(net, SoftmaxCrossEntropyLoss(), "sgd", dict(OPT),
                          device="cpu")._shard_opt
    assert not ShardedTrainer(net, SoftmaxCrossEntropyLoss(), "sgd",
                              dict(OPT), device="cpu",
                              gradient_compression=gc)._shard_opt
    monkeypatch.delenv("MXTPU_ZERO1")
    with pytest.raises(MXNetError, match="unknown"):
        ShardedTrainer(net, SoftmaxCrossEntropyLoss(), "sgd",
                       {"beta1": 0.9}, device="cpu")
    with pytest.raises(MXNetError, match="expects"):
        st.step(torch.zeros(1, 32, 32, 3))
    # the entry point runs on CUDA unless told otherwise: no card, it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnreachable):
        ShardedTrainer(net, SoftmaxCrossEntropyLoss(), "sgd", dict(OPT))
