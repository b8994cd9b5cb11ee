"""Parity of the port's model zoo (mxnet_tpu_torch/gluon/model_zoo/vision/)
with the JAX package's, on the CPU.

All 34 `get_model` names build, on both sides, the same parameters under
the same names (relative to each net's own prefix: the two packages'
global counters stand at different places in one process) in the same
order, with the same declared shapes where both know them. One member
of each family then runs one forward at its smallest valid input, with
the JAX net's seeded weights carried over by block path: the logits
agree within 1e-4 of their scale (fp32; convolutions sum in other
orders), and every parameter's shape equals the JAX one after the
forward. DenseNet (224 px) and Inception V3 (299 px) are in
test_torch_gluon_zoo_large.py. A `pretrained=True` model loads a local
checkpoint through `model_store`."""
import jax
from jax._src import compilation_cache
import pytest

from mxnet_tpu.gluon.model_zoo import vision as jvision
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from torch_zoo_parity import _agree, _relative, check_family

NAMES = sorted(tvision._MODELS)


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


def test_there_are_34_models_and_unknown_names_raise():
    assert len(NAMES) == 34
    for get_model in (tvision.get_model, jvision.get_model):
        with pytest.raises(ValueError, match="not supported"):
            get_model("resnet19_v1")


@pytest.mark.parametrize("name", NAMES)
def test_model_has_jax_parameter_names_and_shapes(name):
    jnet = jvision.get_model(name, classes=7)
    with tmx.cpu():
        tnet = tvision.get_model(name, classes=7)
    want, got = _relative(jnet), _relative(tnet)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, tp), (_, jp) in zip(got, want):
        assert _agree(tp.shape, jp.shape), (k, tp.shape, jp.shape)
        assert tp.grad_req == jp.grad_req, k
    assert tnet.prefix.startswith(jnet.prefix.rstrip("_0123456789"))


@pytest.mark.parametrize("name,side", [
    ("resnet18_v1", 32), ("resnet18_v2", 32), ("vgg11", 32),
    ("alexnet", 64), ("squeezenet1.1", 64), ("mobilenet0.25", 32),
    ("mobilenetv2_0.25", 32)])
def test_family_forward_matches_jax(name, side):
    check_family(name, side)


def test_mobilenet_nhwc_forward_matches_jax():
    check_family("mobilenet0.25", 32, layout="NHWC")


def test_pretrained_loads_a_local_checkpoint(tmp_path):
    with tmx.cpu():
        src = tvision.get_model("mobilenet0.25", classes=5)
        src.initialize(tmx.init.Xavier())
        src(tmx.nd.ones((1, 3, 32, 32)))
        src.save_parameters(str(tmp_path / "mobilenet0.25.params"))
        net = tvision.get_model("mobilenet0.25", classes=5,
                                pretrained=True, root=str(tmp_path))
        for (k, a), (_, b) in zip(_relative(src), _relative(net)):
            assert (a.data() == b.data()).all(), k
        with pytest.raises(RuntimeError, match="local files"):
            tvision.get_model("alexnet", pretrained=True,
                              root=str(tmp_path))
