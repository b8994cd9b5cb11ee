"""Seeding (counterpart of mxnet_tpu/random.py's `seed`): the explicit
`torch.Generator`s that the initializers and SGLD draw from.

Initializers draw on the CPU and copy to the parameter's device, so one
seed gives the same weights on every device. The draws are PyTorch's,
not JAX's: the two packages agree in distribution, not in bits.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["generator", "restore", "seed", "snapshot"]

_lock = threading.Lock()
_seed = [None]
_gens = {}


def seed(seed_state):
    """Seed every generator of the package (made anew, one per device,
    on first use after this)."""
    with _lock:
        _seed[0] = int(seed_state)
        _gens.clear()


def generator(device="cpu"):
    """The package's generator on `device`: seeded by `seed`, or from
    fresh entropy when `seed` was never called."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _lock:
        gen = _gens.get(dev)
        if gen is None:
            gen = torch.Generator(device=dev)
            if _seed[0] is None:
                gen.seed()
            else:
                gen.manual_seed(_seed[0])
            _gens[dev] = gen
        return gen


def snapshot():
    """The state of every generator made so far, {device: state}: what
    `restore` rewinds to (the numerics guard's replay of a step redraws
    the step's masks from it)."""
    with _lock:
        return {dev: gen.get_state() for dev, gen in _gens.items()}


def restore(states):
    """Put the generators back to a `snapshot`."""
    with _lock:
        for dev, state in states.items():
            gen = _gens.get(dev)
            if gen is not None:
                gen.set_state(state)
