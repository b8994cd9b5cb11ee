"""The port's Gluon names equal the JAX package's, on the CPU.

A top-level block draws its prefix ``<hint><n>_`` from the global name
manager, and a block made inside a `name_scope` gets its prefix from the
scope's counters under the owner's prefix, in both packages: for the
same construction sequence in a fresh process, `prefix`, `name` and the
`collect_params()` keys agree. Each side runs in a subprocess of its own
(the global counters start at zero there), for a Dense, a nested
`name_scope` and `resnet18_v1`."""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the same construction sequence; `pkg` is the package's name
SCRIPT = r"""
import json, sys
pkg = sys.argv[1]
if pkg == "mxnet_tpu":
    import jax
    jax.config.update("jax_platforms", "cpu")
mx = __import__(pkg)
from contextlib import nullcontext
scope = mx.cpu() if pkg == "mxnet_tpu_torch" else nullcontext()
nn = mx.gluon.nn
out = {}
with scope:
    if sys.argv[2] == "dense":
        d = nn.Dense(3, in_units=2)
        d2 = nn.Dense(4, in_units=3)
        out = [[b.prefix, b.name, list(b.collect_params())] for b in (d, d2)]
    elif sys.argv[2] == "scopes":
        net = nn.HybridSequential()
        with net.name_scope():
            inner = nn.HybridSequential()
            with inner.name_scope():
                inner.add(nn.Dense(4, in_units=3), nn.Dense(2, in_units=4))
            net.add(inner)
            net.add(nn.BatchNorm(in_channels=2))
            net.add(nn.Dense(5, activation="relu", in_units=2))
        plain = nn.HybridSequential(prefix="model_")
        with plain.name_scope():
            plain.add(nn.Conv2D(3, 1, in_channels=2))
        out = [[b.prefix, b.name, list(b.collect_params())]
               for b in (net, inner, net[2], plain)]
    else:
        net = mx.gluon.model_zoo.vision.resnet18_v1(classes=10)
        out = [[net.prefix, net.name, list(net.collect_params())]]
print(json.dumps(out))
"""


def _names(pkg, case):
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", SCRIPT, pkg, case],
                         capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", ["dense", "scopes", "resnet18"])
def test_names_and_prefixes_equal_jax_in_a_fresh_process(case):
    want = _names("mxnet_tpu", case)
    got = _names("mxnet_tpu_torch", case)
    assert got == want
    # the top-level prefix comes from the global counter, not ""
    assert got[0][0].endswith("0_") and got[0][2][0].startswith(got[0][0])
