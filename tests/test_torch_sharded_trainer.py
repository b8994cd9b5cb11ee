"""The port's `ShardedTrainer` API (mxnet_tpu_torch/parallel/data_parallel.py)
against the JAX package's, in one CPU process.

Two nets give the same weights to both packages: a narrow NHWC ResNet V1
(BottleneckV1, [1, 1], [16, 32, 64], 10 classes; BatchNorm, so running
statistics too) and a two-layer MLP. The JAX trainer runs on a one-device
mesh (``make_mesh({"dp": 1}, devices=jax.devices()[:1])``), the port's on
the CPU, where its step runs eagerly and the kernels' plain versions.
Over 3 steps each tensor of the port's state lies within TOL_REL of
JAX's, relative to max(1, the tensor's largest magnitude): SGD at
momentum 0 and 0.9 with wd, Adam with wd on the MLP (its step count
equal), and
aux_mode="predict" (running statistics untouched in both). bf16 compute
is held as tests/test_torch_trainer.py holds it. Then what the port
holds on its own, bit for bit: remat (every policy) against the plain
step, `input_specs` and accepted `param_rules` against the default,
`step_many(n)` against n steps, `fit` over an NDArrayIter against the
same batches through `step` (and against JAX's `fit`), a non-finite
gradient leaving every tensor as it was; and compression and ZeRO-1 on
one device against JAX's one-device trainer with the same arguments.
"""
import numpy as np
import jax
from jax._src import compilation_cache
import jax.numpy as jnp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer, make_mesh as \
    jax_make_mesh
from mxnet_tpu.parallel import data_parallel as jdp
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError, gluon
from mxnet_tpu_torch.convert import gluon_params_from_jax
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.observability import registry
from mxnet_tpu_torch.parallel import ShardedTrainer, data_parallel as dp
from mxnet_tpu_torch.parallel.mesh import make_mesh
from mxnet_tpu_torch.resilience import numerics

STEPS = 3
# fp32 on both sides, sums in other orders, grown through 3 updates
TOL_REL = 1e-5
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
SGD0 = {"learning_rate": 0.1, "wd": 1e-4}
ADAM = {"learning_rate": 0.01, "wd": 1e-4}
# bf16 compute, as tests/test_torch_trainer.py holds it: per tensor, the
# port's bf16 state no farther from JAX's bf16 state than NOISE times
# JAX's own bf16-to-fp32 distance, plus MARGIN; losses within LOSS
BF16 = dict(loss=0.06, noise=2.0, param=2e-3, state=2e-2, aux=2e-3)


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


# -- the two nets, in both packages ------------------------------------------
@pytest.fixture(scope="module")
def nets():
    """{kind: (JAX net, layout, x, y)}, weights seeded."""
    np.random.seed(4)
    jmx.random.seed(4)
    res = jresnet.ResNetV1(jresnet.BottleneckV1, [1, 1], [16, 32, 64],
                           classes=10, layout="NHWC")
    res.initialize(jmx.init.Xavier(magnitude=2))
    res.infer_shape(jmx.nd.zeros((1, 32, 32, 3)))
    for p in res.collect_params().values():
        p._finish_deferred_init()
    mlp = jgluon.nn.HybridSequential()
    mlp.add(jgluon.nn.Dense(16, activation="relu", in_units=10),
            jgluon.nn.Dense(4, in_units=16))
    mlp.initialize(jmx.init.Xavier(magnitude=2))
    rng = np.random.RandomState(5)
    return {"resnet": (res, "NHWC",
                       rng.randn(8, 32, 32, 3).astype(np.float32),
                       (np.arange(8) % 10).astype(np.float32)),
            "mlp": (mlp, "NCHW", rng.randn(8, 10).astype(np.float32),
                    (np.arange(8) % 4).astype(np.float32))}


def _port_net(nets, kind):
    jnet, layout = nets[kind][:2]
    if kind == "resnet":
        net = vision.ResNetV1(vision.BottleneckV1, [1, 1], [16, 32, 64],
                              classes=10, layout="NHWC", device="cpu")
    else:
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(16, activation="relu", in_units=10,
                               device="cpu"),
                gluon.nn.Dense(4, in_units=16, device="cpu"))
    net.load_parameters(gluon_params_from_jax(jnet, "cpu", layout))
    return net


def _port(nets, kind, optimizer="sgd", opt=SGD, **kw):
    return ShardedTrainer(_port_net(nets, kind),
                          gluon.loss.SoftmaxCrossEntropyLoss(), optimizer,
                          dict(opt), device="cpu", **kw)


def _jax(nets, kind, optimizer="sgd", opt=SGD, **kw):
    loss = jgluon.loss.SoftmaxCrossEntropyLoss()
    return JaxTrainer(nets[kind][0], lambda o, l: loss(o, l), optimizer,
                      dict(opt), mesh=jax_make_mesh(
                          {"dp": 1}, devices=jax.devices()[:1]), **kw)


def _xy(nets, kind):
    return nets[kind][2], nets[kind][3]


def _flat(state, tag=""):
    """{tag/name below the net's prefix: float64 array in the port's
    layout} of a state dict (nested for Adam), either package's."""
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update(_flat(v, tag + k + "/"))
            continue
        if isinstance(v, torch.Tensor):
            arr = v.detach().double().numpy()
        else:
            arr = np.asarray(v.astype(jnp.float32)).astype(np.float64)
            if arr.ndim == 4:           # NHWC conv weight (O,kh,kw,I)
                arr = arr.transpose(0, 3, 1, 2)
        out[tag + (k.split("_", 1)[1] if "_" in k else k)] = arr
    return out


def _port_state(st):
    return {"param": st.params, "state": st.opt_state, "aux": st.aux}


def _jax_state(st):
    return {"param": st._params, "state": st._opt_state, "aux": st._aux}


def _rel_errs(port, want):
    """{kind/name: max |port - want| / max(1, max |want|)}."""
    out = {}
    for kind in want:
        a, b = _flat(port[kind]), _flat(want[kind])
        assert sorted(a) == sorted(b), (kind, sorted(a), sorted(b))
        for name, w in b.items():
            scale = max(1.0, float(np.abs(w).max())) if w.size else 1.0
            out[kind + "/" + name] = float(np.abs(a[name] - w).max()) / scale \
                if w.size else 0.0
    return out


def _run_both(nets, kind, optimizer, opt, steps=STEPS, **kw):
    """(port trainer, JAX trainer, [(port loss, JAX loss)]) after `steps`
    steps on the net's batch."""
    x, y = _xy(nets, kind)
    st, jst = _port(nets, kind, optimizer, opt, **kw), \
        _jax(nets, kind, optimizer, opt, **kw)
    losses = []
    for _ in range(steps):
        losses.append((float(st.step(x, y)),
                       float(np.asarray(jst.step(x, y)._data))))
    return st, jst, losses


# -- parity with the JAX trainer ------------------------------------------------
@pytest.mark.parametrize("kind,opt", [("mlp", SGD0), ("mlp", SGD),
                                      ("resnet", SGD)])
def test_sgd_matches_jax(nets, kind, opt):
    st, jst, losses = _run_both(nets, kind, "sgd", opt)
    for got, want in losses:
        assert abs(got - want) <= TOL_REL * max(1.0, abs(want)), losses
    want = _jax_state(jst)
    if not opt.get("momentum"):
        # JAX keeps no state at momentum 0; the port's momenta hold m' = g
        assert want["state"] == {}
        want.pop("state")
    errs = _rel_errs(_port_state(st), want)
    assert max(errs.values()) <= TOL_REL, sorted(
        errs.items(), key=lambda kv: -kv[1])[:5]
    assert numerics.drain_flags()["skipped_steps"] == 0


def test_adam_matches_jax(nets):
    """Adam with wd on the MLP: losses, every tensor of the state, and the
    step count ``t``. (Not on the ResNet: a conv bias before a training
    BatchNorm has a gradient of 0 in exact arithmetic, the port's exactly
    0 and JAX's rounding noise, and Adam's m / sqrt(v) turns such noise,
    or any gradient element the two packages' sum orders round apart
    near 0, into steps of about lr. Measured: 38 of 118 tensors beyond
    1e-5 after 3 steps, the largest a conv bias at 0.011 of max(1, |w|),
    while the losses agreed to 7e-7.)"""
    st, jst, losses = _run_both(nets, "mlp", "adam", ADAM)
    for got, want in losses:
        assert abs(got - want) <= TOL_REL * max(1.0, abs(want)), losses
    errs = _rel_errs(_port_state(st), _jax_state(jst))
    assert max(errs.values()) <= TOL_REL, sorted(
        errs.items(), key=lambda kv: -kv[1])[:5]
    t = st.opt_state["t"]
    assert t.dtype == torch.int32 and int(t) == int(jst._opt_state["t"]) \
        == STEPS


@pytest.mark.parametrize("optimizer,opt", [("sgd", SGD), ("adam", ADAM)])
def test_bf16_compute_matches_jax(nets, optimizer, opt):
    """bf16 compute over fp32 masters on the MLP; a JAX fp32 trainer
    beside them gives the scale of the rounding noise."""
    x, y = _xy(nets, "mlp")
    st, jst = (_port(nets, "mlp", optimizer, opt, compute_dtype="bfloat16"),
               _jax(nets, "mlp", optimizer, opt, compute_dtype="bfloat16"))
    ref = _jax(nets, "mlp", optimizer, opt)
    for _ in range(STEPS):
        got = float(st.step(x, y))
        want = float(np.asarray(jst.step(x, y)._data))
        ref.step(x, y)
        assert abs(got - want) < BF16["loss"], (got, want)
    port, want, fp32 = (_flat_all(_port_state(st)), _flat_all(
        _jax_state(jst)), _flat_all(_jax_state(ref)))
    for name, w in want.items():
        kind = name.split("/", 1)[0]
        noise = float(np.abs(w - fp32[name]).max())
        err = float(np.abs(port[name] - w).max())
        assert err <= BF16["noise"] * noise + BF16[kind], \
            (name, err, noise)
    assert all(v.dtype == torch.float32 for v in st.params.values())


def _flat_all(state):
    return {kind + "/" + k: v for kind in state
            for k, v in _flat(state[kind]).items()}


def test_predict_mode_matches_jax_and_writes_no_statistics(nets):
    """aux_mode="predict": BatchNorm normalizes with its running
    statistics and writes none, in both packages (JAX's
    build_graph_fn(mode="predict"))."""
    st, jst, losses = _run_both(nets, "resnet", "sgd", SGD,
                                aux_mode="predict")
    for got, want in losses:
        assert abs(got - want) <= TOL_REL * max(1.0, abs(want)), losses
    errs = _rel_errs(_port_state(st), _jax_state(jst))
    assert max(errs.values()) <= TOL_REL, max(errs.items(),
                                              key=lambda kv: kv[1])
    before = _port_net(nets, "resnet")
    own = {n: b for n, b in before.named_buffers()}
    for name, path in gluon.collect_params(before).items():
        if path in own:
            assert torch.equal(own[path], st.aux[
                st._net.prefix + name[len(before.prefix):]]), name


def test_batch_axis_one_with_rank1_labels(nets):
    """TNC data (batch on axis 1) beside (B,) labels (JAX
    tests/test_parallel.py:280): the labels' batch axis clamps to their
    rank; 3 steps equal JAX's."""
    class JMean(jgluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.out = jgluon.nn.Dense(10, in_units=4)

        def hybrid_forward(self, F, x):
            return self.out(F.mean(x, axis=0))

    class Mean(gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.out = gluon.nn.Dense(10, in_units=4, device="cpu")

        def hybrid_forward(self, F, x):
            return self.out(F.mean(x, axis=0))

    jmx.random.seed(1)
    jnet = JMean()
    jnet.initialize(jmx.init.Xavier())
    net = Mean()
    net.load_parameters(gluon_params_from_jax(jnet, "cpu"))
    x = np.random.RandomState(0).randn(5, 16, 4).astype("f")
    y = (np.arange(16) % 10).astype("f")
    loss = jgluon.loss.SoftmaxCrossEntropyLoss()
    jst = JaxTrainer(jnet, lambda o, l: loss(o, l), "sgd", dict(SGD),
                     batch_axis=1, mesh=jax_make_mesh(
                         {"dp": 1}, devices=jax.devices()[:1]))
    st = ShardedTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                        dict(SGD), batch_axis=1, device="cpu")
    assert st._batch_axis_for(3) == 1 and st._batch_axis_for(1) == 0
    for _ in range(STEPS):
        got, want = float(st.step(x, y)), float(np.asarray(
            jst.step(x, y)._data))
        assert abs(got - want) <= TOL_REL * max(1.0, abs(want))
    errs = _rel_errs({"param": st.params}, {"param": jst._params})
    assert max(errs.values()) <= TOL_REL, errs


def test_fit_equals_its_batches_through_step_and_jaxs_fit(nets):
    """`fit` over an NDArrayIter (2 epochs, the last batch of each padded
    by wrap-around) takes the batches that `step` takes from the same
    iterator, bit for bit, and matches JAX's `fit` (JAX
    tests/test_prefetch.py:106)."""
    rng = np.random.RandomState(7)
    X = rng.randn(20, 10).astype(np.float32)
    Y = (np.arange(20) % 4).astype(np.float32)
    a, b = _port(nets, "mlp"), _port(nets, "mlp")
    seen = []
    last = a.fit(mx.io.NDArrayIter(X, Y, batch_size=8), num_epochs=2,
                 batch_end_callback=lambda e, n, l: seen.append((e, n)))
    assert seen == [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]
    it = mx.io.NDArrayIter(X, Y, batch_size=8)
    for _ in range(2):
        it.reset()
        for batch in it:
            want = b.step(batch.data[0], batch.label[0])
    assert torch.equal(last, want)
    _same_state(a, b)
    jst = _jax(nets, "mlp")
    jlast = jst.fit(jmx.io.NDArrayIter(X, Y, batch_size=8), num_epochs=2)
    assert abs(float(last) - float(np.asarray(jlast._data))) <= TOL_REL
    errs = _rel_errs({"param": a.params, "state": a.opt_state},
                     {"param": jst._params, "state": jst._opt_state})
    assert max(errs.values()) <= TOL_REL, errs


@pytest.mark.parametrize("optimizer,opt", [("sgd", SGD), ("adam", ADAM)])
def test_optimizer_functions_match_jax(optimizer, opt):
    """`sgd_update` / `adam_update` as functions on dicts of tensors, two
    updates against JAX's on the same numbers."""
    rng = np.random.RandomState(3)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    hp = {("lr" if k == "learning_rate" else k): v for k, v in opt.items()}
    init, update = ((dp.sgd_init, dp.sgd_update) if optimizer == "sgd"
                    else (dp.adam_init, dp.adam_update))
    jinit, jupdate = ((jdp.sgd_init, jdp.sgd_update) if optimizer == "sgd"
                      else (jdp.adam_init, jdp.adam_update))
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    s, js = init(p), jinit(jp)
    for _ in range(2):
        grads = {k: rng.randn(*s_).astype(np.float32)
                 for k, s_ in shapes.items()}
        p, s = update(p, {k: torch.from_numpy(v) for k, v in grads.items()},
                      s, **hp)
        jp, js = jupdate(jp, {k: jnp.asarray(v) for k, v in grads.items()},
                         js, **hp)
    errs = _rel_errs({"param": p, "state": s}, {"param": jp, "state": js})
    assert max(errs.values()) <= TOL_REL, errs


# -- what the port holds on its own, bit for bit --------------------------------
def _same_state(a, b):
    """The two trainers' parameters, optimizer states and aux are equal,
    bit for bit (names below each net's prefix)."""
    for kind in ("param", "state", "aux"):
        fa, fb = _flat(_port_state(a)[kind]), _flat(_port_state(b)[kind])
        assert sorted(fa) == sorted(fb), kind
        for k in fa:
            assert np.array_equal(fa[k], fb[k]), (kind, k)


@pytest.mark.parametrize("remat", [True, "dots_with_no_batch_dims_saveable",
                                   "dots_saveable", "checkpoint_dots",
                                   "nothing_saveable", "everything_saveable"])
def test_remat_is_bit_identical_to_the_plain_step(nets, remat):
    """Rematerialization changes what the backward keeps, not a bit of
    the step (JAX tests/test_parallel.py:379): losses, parameters,
    momenta and BatchNorm statistics, ResNet and MLP."""
    for kind in ("resnet", "mlp"):
        x, y = _xy(nets, kind)
        plain, re_ = _port(nets, kind), _port(nets, kind, remat=remat)
        for _ in range(2):
            assert torch.equal(plain.step(x, y), re_.step(x, y))
        _same_state(plain, re_)


def test_remat_replays_the_dropout_masks():
    """A net that draws random numbers (Dropout): the recomputation draws
    the masks of the first forward again, and leaves the package's
    generator where the plain step leaves it, so remat equals the plain
    step bit for bit over 3 steps from one seed."""
    def run(remat):
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(32, activation="relu", in_units=10,
                               device="cpu"), gluon.nn.Dropout(0.5),
                gluon.nn.Dense(4, in_units=32, device="cpu"))
        g = torch.Generator().manual_seed(0)
        net.load_parameters({k: torch.randn(v.shape, generator=g)
                             for k, v in net.state_dict().items()})
        st = ShardedTrainer(net, gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                            dict(SGD), device="cpu", remat=remat)
        x = np.random.RandomState(1).randn(16, 10).astype(np.float32)
        y = (np.arange(16) % 4).astype(np.float32)
        mx.random.seed(7)
        losses = [st.step(x, y) for _ in range(STEPS)]
        return torch.stack(losses), st
    (lp, plain), (lr, re_) = run(False), run(True)
    assert torch.equal(lp, lr) and len(set(lp.tolist())) == STEPS
    _same_state(plain, re_)


def test_remat_refuses_what_jax_refuses(nets):
    with pytest.raises(AttributeError, match="no_such_policy"):
        _port(nets, "mlp", remat="no_such_policy")
    with pytest.raises(MXNetError, match="remat"):
        _port(nets, "mlp", remat=3)


def test_input_specs_and_param_rules_change_nothing(nets):
    """On a one-device mesh of 'dp' and 'tp' axes, input specs and
    parameter rules over those axes are accepted and give the default's
    numbers bit for bit."""
    x, y = _xy(nets, "resnet")
    mesh = make_mesh({"dp": 1, "tp": 1}, devices=["cpu"])
    plain = _port(nets, "resnet")
    laid = _port(nets, "resnet", mesh=mesh,
                 input_specs={"data": ("dp", None, None, "tp"),
                              "label": ("dp",)},
                 param_rules=[(r"conv\d+_weight$", ("tp",)),
                              (r"dense\d+_weight$", (None, "tp"))])
    assert laid._spec_for(laid._net.prefix + "dense0_weight") == \
        dp.PartitionSpec(None, "tp")
    for _ in range(2):
        assert torch.equal(plain.step(x, y), laid.step(x, y))
    _same_state(plain, laid)


@pytest.mark.parametrize("kw,match", [
    ({"param_rules": [("weight", ("sp",))]}, "sp"),
    ({"input_specs": {"data": ("dp", "sp")}}, "sp"),
    ({"input_specs": {"image": ("dp",)}}, "image")])
def test_layouts_the_mesh_lacks_raise(nets, kw, match):
    with pytest.raises(MXNetError, match=match):
        _port(nets, "mlp", **kw)


@pytest.mark.parametrize("optimizer,opt", [("sgd", SGD), ("adam", ADAM)])
def test_step_many_equals_n_steps(nets, optimizer, opt):
    x, y = _xy(nets, "resnet")
    a, b = _port(nets, "resnet", optimizer, opt), \
        _port(nets, "resnet", optimizer, opt)
    stepped = torch.stack([a.step(x, y) for _ in range(STEPS)])
    many = b.step_many(x, y, n_steps=STEPS, unroll=2)
    assert torch.equal(stepped, many)
    _same_state(a, b)


@pytest.mark.parametrize("optimizer,opt", [("sgd", SGD), ("adam", ADAM)])
def test_nan_gradient_leaves_every_tensor_bit_identical(nets, optimizer, opt):
    x, y = _xy(nets, "resnet")
    st = _port(nets, "resnet", optimizer, opt)
    st.step(x, y)
    numerics.drain_flags()
    before = _flat_all(_port_state(st))
    bad = x.copy()
    bad[0, 0, 0, 0] = np.nan
    assert not np.isfinite(float(st.step(bad, y)))
    after = _flat_all(_port_state(st))
    assert all(np.array_equal(before[k], after[k], equal_nan=True)
               for k in before)
    guard = numerics.drain_flags()
    assert guard["skipped_steps"] == 1 and guard["anomalies"] == 1
    assert np.isfinite(float(st.step(x, y)))


def test_dispatches_count_one_a_step(nets):
    """``train.step.dispatches``: one a step and n a `step_many(n)` (eager
    here: the update's one launch; on the card one graph replay)."""
    x, y = _xy(nets, "mlp")
    st = _port(nets, "mlp")
    disp = registry.counter("train.step.dispatches")
    d0 = disp.get()
    st.step(x, y)
    st.step_many(x, y, n_steps=3)
    assert disp.get() - d0 == 4


@pytest.mark.parametrize("kw", [
    {"gradient_compression": {"type": "2bit", "threshold": 0.5}},
    {"shard_optimizer_state": True}, {"env": "MXTPU_ZERO1"}])
def test_a6c_refusals(nets, kw, monkeypatch):
    """Gradient compression and ZeRO-1, refused before they were ported,
    now train on one device as JAX's one-device trainer does with the same
    arguments (compression round-trips every gradient through the 2-bit
    quantizer; ZeRO-1 over one device holds every row)."""
    kw = dict(kw)
    if kw.pop("env", None):
        monkeypatch.setenv("MXTPU_ZERO1", "1")
    st, jst, losses = _run_both(nets, "mlp", "sgd", SGD, **kw)
    for got, want in losses:
        assert abs(got - want) <= TOL_REL * max(1.0, abs(want)), losses
    errs = _rel_errs(_port_state(st), _jax_state(jst))
    assert max(errs.values()) <= TOL_REL, max(errs.items(),
                                              key=lambda kv: kv[1])
    assert st._shard_opt == bool(jst._shard_opt)
