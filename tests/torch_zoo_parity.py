"""Helpers of the zoo parity tests (test_torch_gluon_zoo*.py): a JAX
zoo net with seeded weights and the port net given them by block path,
on the same input."""
import numpy as np

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo import vision as jvision
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.convert import gluon_params_from_jax
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

LOGIT_TOL = 1e-4


def _relative(net):
    return [(k[len(net.prefix):], p) for k, p in
            net.collect_params().items()]


def _agree(a, b):
    return len(a) == len(b) and all(x == y or 0 in (x, y)
                                    for x, y in zip(a, b))


def run_family(name, side, layout="NCHW"):
    """The JAX net (seeded Xavier weights, hybridized) and the port net
    given its weights, on the same input: (logits, logits, nets)."""
    np.random.seed(0)
    mx.random.seed(0)
    jnet = jvision.get_model(name, classes=7, layout=layout)
    jnet.initialize(mx.init.Xavier(magnitude=2))
    jnet.hybridize()
    shape = (2, 3, side, side) if layout == "NCHW" else (2, side, side, 3)
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    want = jnet(mx.nd.array(x)).asnumpy()
    with tmx.cpu():
        tnet = tvision.get_model(name, classes=7, layout=layout)
        tnet.load_parameters(gluon_params_from_jax(jnet, "cpu", layout))
        got = tnet(tmx.nd.array(x)).asnumpy()
    return want, got, jnet, tnet


def check_family(name, side, layout="NCHW"):
    want, got, jnet, tnet = run_family(name, side, layout)
    assert got.shape == want.shape == (2, 7)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < LOGIT_TOL * max(1.0,
                                                      np.abs(want).max())
    jshapes = [p.shape for _, p in _relative(jnet)]
    for (k, p), js in zip(_relative(tnet), jshapes):
        ps = p.shape
        if p._file_perm:
            ps = tuple(ps[i] for i in p._file_perm)
        assert ps == tuple(js), k
