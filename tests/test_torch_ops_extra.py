"""The port's registry ops of mxnet_tpu/ops/extra.py against the JAX
package's, on the CPU: every registered name (aliases included) on the
same seeded inputs, outputs and aux write-backs within the tolerance of
its class, and the gradients of every differentiable op through one
record() -> backward; the samplers by the mean and variance of their
draws. The cases and tolerances are in tests/torch_ops_parity.py."""
import pytest

from torch_ops_parity import (_no_persistent_compile_cache,  # noqa: F401
                              case_names, check_forward, check_grad,
                              check_random, grad_names, jax_names,
                              random_names)

NAMES = case_names(jax_names("extra"))


@pytest.mark.parametrize("name", NAMES)
def test_op_matches_jax(name):
    check_forward(name)


@pytest.mark.parametrize("name", grad_names(NAMES))
def test_op_gradient_matches_jax(name):
    check_grad(name)


@pytest.mark.parametrize("name", random_names(jax_names("extra")))
def test_sampler_matches_jax_in_distribution(name):
    check_random(name)


def test_an_update_plan_goes_with_its_weight(monkeypatch):
    """sgd_mom_update's plan (meta tensors stand for a card's) is built
    once for a weight, reused while the weight lives, shared with
    optimizer.SGD, and dropped with the weight: the cache holds no
    tensor past it."""
    import gc
    import weakref

    import torch

    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch.ops import extra, sgd_momentum

    built, calls = [], []

    class Plan:
        def __init__(self, ws, vs, form="m", weights=None):
            built.append(form)
            self.tensors = [*ws, *(vs or ())]

        def __call__(self, gs, *args, **kwargs):
            calls.append(len(gs))

    monkeypatch.setattr(sgd_momentum, "SGDMomentumPlan", Plan)
    gc.disable()   # the entry must go by reference counting alone
    try:
        w, m, g = (torch.empty(4, 3, device="meta") for _ in range(3))
        for _ in range(2):
            extra.sgd_mxnet_update(w, g, m, None, w, 0.1, 0.9, 0.0, 1.0,
                                   -1.0)
        opt = tmx.optimizer.SGD(learning_rate=0.1, momentum=0.9)
        opt.update(0, w, g, m)
        assert built == ["mxnet"] and calls == [1, 1, 1]
        assert w in extra._PLANS
        held = [weakref.ref(t) for t in (w, m)]
        entries = len(extra._PLANS)
        del w, m
        assert [r() for r in held] == [None, None]
        assert len(extra._PLANS) == entries - 1
    finally:
        gc.enable()
