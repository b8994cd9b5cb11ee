"""Models written against `mx.nd` on the port, against the same code on
the JAX package, on the CPU:

- the eager loop of MXNet's first tutorial: a two-layer MLP of NDArrays
  (nd.FullyConnected, record(), nd.SoftmaxOutput, nd.sgd_mom_update on
  each weight, in place), 3 steps: losses and weights within 1e-5;
- FGSM's input gradient (example/adversary/fgsm.py:73-78) through a
  Gluon net of Dense layers given an NDArray: x.grad within 1e-5;
- `GPTDecoder.hybrid_forward(mx.nd, tokens, **P)` at 2 layers, width
  32, vocab 64, T 16 against the JAX GPTDecoder (hybridized: one
  compile) with its weights: logits within 1e-5, every weight's
  gradient within 1e-4, and one sgd_mom_update of every weight from the
  same gradients within 1e-6.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo.gpt import GPTDecoder as JaxGPT
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.convert import gpt_params_from_jax
from mxnet_tpu_torch.gluon.model_zoo import GPTDecoder
from torch_ops_parity import _no_persistent_compile_cache  # noqa: F401

TOL = 1e-5
GRAD_TOL = 1e-4
SGD_TOL = 1e-6


def _mlp_run(pkg, params, x, y, steps=3):
    """The eager loop on package `pkg`: returns (losses, final weights)."""
    F = pkg.nd
    P = {k: F.array(v) for k, v in params.items()}
    mom = {k: F.zeros(v.shape) for k, v in params.items()}
    for v in P.values():
        v.attach_grad()
    xb, yb = F.array(x), F.array(y)
    losses = []
    for _ in range(steps):
        with pkg.autograd.record():
            h = F.Activation(F.FullyConnected(xb, P["w1"], P["b1"],
                                              num_hidden=8), act_type="relu")
            out = F.FullyConnected(h, P["w2"], P["b2"], num_hidden=3)
            prob = F.SoftmaxOutput(out, yb)
        prob.backward()
        losses.append(float(-F.log(F.pick(prob, yb)).mean().asscalar()))
        for k in P:
            hp = dict(lr=0.5, momentum=0.9, wd=1e-4,
                      rescale_grad=1.0 / x.shape[0])
            if pkg is mx:       # in place, into the weight's own storage
                F.sgd_mom_update(P[k], P[k].grad, mom[k], out=P[k], **hp)
            else:               # the JAX frontend takes no NDArray out=
                new = F.sgd_mom_update(P[k], P[k].grad, mom[k], **hp)
                P[k]._data = new._data
    return np.array(losses), {k: v.asnumpy() for k, v in P.items()}


def test_eager_mlp_loop_matches_jax():
    rng = np.random.RandomState(0)
    params = {"w1": rng.randn(8, 5).astype(np.float32) * 0.5,
              "b1": np.zeros(8, np.float32),
              "w2": rng.randn(3, 8).astype(np.float32) * 0.5,
              "b2": np.zeros(3, np.float32)}
    x = rng.randn(16, 5).astype(np.float32)
    y = rng.randint(0, 3, 16).astype(np.float32)
    with mx.cpu():
        tl, tw = _mlp_run(mx, params, x, y)
    jl, jw = _mlp_run(jmx, params, x, y)
    assert np.abs(tl - jl).max() < TOL, (tl, jl)
    assert tl[-1] < tl[0]
    for k in params:
        assert np.abs(tw[k] - jw[k]).max() < TOL, k


def test_fgsm_input_gradient_matches_jax():
    rng = np.random.RandomState(1)
    w1, b1 = rng.randn(16, 12).astype(np.float32) * 0.3, \
        rng.randn(16).astype(np.float32) * 0.1
    w2, b2 = rng.randn(4, 16).astype(np.float32) * 0.3, \
        rng.randn(4).astype(np.float32) * 0.1
    X = rng.randn(6, 12).astype(np.float32)
    y = rng.randint(0, 4, 6).astype(np.float32)

    jnet = jmx.gluon.nn.HybridSequential()
    with jnet.name_scope():
        jnet.add(jmx.gluon.nn.Dense(16, activation="relu", in_units=12),
                 jmx.gluon.nn.Dense(4, in_units=16))
    jnet.initialize()
    for layer, (w, b) in zip(jnet, ((w1, b1), (w2, b2))):
        layer.weight.set_data(jmx.nd.array(w))
        layer.bias.set_data(jmx.nd.array(b))
    jx = jmx.nd.array(X)
    jx.attach_grad()
    with jmx.autograd.record():
        jloss = jmx.gluon.loss.SoftmaxCrossEntropyLoss()(jnet(jx),
                                                         jmx.nd.array(y))
    jloss.backward()

    tnet = gluon.nn.HybridSequential()
    with tnet.name_scope():
        tnet.add(gluon.nn.Dense(16, in_units=12, device="cpu"),
                 gluon.nn.Activation("relu"),
                 gluon.nn.Dense(4, in_units=16, device="cpu"))
    tnet.load_parameters({
        "dense0_weight": torch.from_numpy(w1),
        "dense0_bias": torch.from_numpy(b1),
        "dense1_weight": torch.from_numpy(w2),
        "dense1_bias": torch.from_numpy(b2)})
    with mx.cpu():
        x = nd.array(X)
        x.attach_grad()
        with autograd.record():
            loss = gluon.loss.SoftmaxCrossEntropyLoss()(tnet(x), nd.array(y))
        loss.backward()
    assert isinstance(loss, nd.NDArray)
    assert np.abs(loss.asnumpy() - jloss.asnumpy()).max() < TOL
    assert np.abs(x.grad.asnumpy() - jx.grad.asnumpy()).max() < TOL
    adv = X + 0.1 * np.sign(x.grad.asnumpy())
    assert np.array_equal(np.sign(x.grad.asnumpy()),
                          np.sign(jx.grad.asnumpy())) and adv.shape == X.shape


VOCAB = 64
CFG = dict(max_seq_len=16, num_layers=2, num_heads=2, embed_dim=32)


@pytest.fixture(scope="module")
def gpt_runs():
    np.random.seed(3)
    jblk = JaxGPT(VOCAB, **CFG)
    jblk.initialize(jmx.init.Xavier(magnitude=2.5))
    jblk.hybridize()
    np_params = {k: np.asarray(v) for k, v in jblk.decode_params().items()}
    rng = np.random.RandomState(4)
    tokens = rng.randint(0, VOCAB, (2, 16)).astype(np.int32)
    cot = rng.randn(2, 16, VOCAB).astype(np.float32)
    with jmx.autograd.record():
        jlogits = jblk(jmx.nd.array(tokens, dtype="int32"))
    jlogits.backward(jmx.nd.array(cot))
    jgrads = {k: getattr(jblk, k).grad().asnumpy() for k in np_params}

    tblk = GPTDecoder(VOCAB, params=gpt_params_from_jax(np_params, "cpu"),
                      device="cpu", **CFG)
    with mx.cpu():
        P = {k: nd.array(v) for k, v in np_params.items()}
        for v in P.values():
            v.attach_grad()
        tok = nd.array(tokens, dtype="int32")
        with autograd.record():
            logits = tblk.hybrid_forward(nd, tok, **P)
        logits.backward(nd.array(cot))
    tgrads = {k: v.grad.asnumpy() for k, v in P.items()}
    return dict(np_params=np_params, jlogits=jlogits.asnumpy(),
                logits=logits, tgrads=tgrads, jgrads=jgrads, tblk=tblk,
                tokens=tokens)


def test_gpt_hybrid_forward_logits_match_jax(gpt_runs):
    got = gpt_runs["logits"].asnumpy()
    want = gpt_runs["jlogits"]
    assert got.shape == want.shape == (2, 16, VOCAB)
    assert np.abs(got - want).max() < TOL
    # the Gluon path and the port's decode path give the same logits
    plain = gpt_runs["tblk"](torch.from_numpy(gpt_runs["tokens"]))
    assert np.abs(plain.numpy() - got).max() < TOL


def test_gpt_hybrid_forward_gradients_match_jax(gpt_runs):
    tg, jg = gpt_runs["tgrads"], gpt_runs["jgrads"]
    assert set(tg) == set(jg) and len(tg) == 4 + 12 * CFG["num_layers"]
    for k in jg:
        scale = max(1.0, float(np.abs(jg[k]).max()))
        assert np.abs(tg[k] - jg[k]).max() < GRAD_TOL * scale, k


def test_gpt_sgd_mom_update_step_matches_jax(gpt_runs):
    """One sgd_mom_update of every weight, from the same gradients and
    momenta, in place, on both packages."""
    rng = np.random.RandomState(5)
    hp = dict(lr=0.1, momentum=0.9, wd=1e-4, rescale_grad=0.5)
    for k, w in gpt_runs["np_params"].items():
        g = gpt_runs["jgrads"][k]
        m = (rng.randn(*w.shape) * 0.01).astype(np.float32)
        with mx.cpu():
            tw, tm = nd.array(w), nd.array(m)
            ptr = tw._data.data_ptr()
            nd.sgd_mom_update(tw, nd.array(g), tm, out=tw, **hp)
            assert tw._data.data_ptr() == ptr
        jw, jm = jmx.nd.array(w), jmx.nd.array(m)
        jw = jmx.nd.sgd_mom_update(jw, jmx.nd.array(g), jm, **hp)
        assert np.abs(tw.asnumpy() - jw.asnumpy()).max() < SGD_TOL, k
        assert np.abs(tm.asnumpy() - jm.asnumpy()).max() < SGD_TOL, k
