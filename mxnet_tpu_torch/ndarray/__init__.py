"""The `nd` namespace: NDArray and one function per registered operator
(counterpart of mxnet_tpu/ndarray/__init__.py), with the `nd.random`,
`nd.linalg` and `nd.contrib` namespaces.

Not ported yet: sparse storage (`nd.sparse`) and the control-flow
frontends (`contrib.foreach`, `while_loop`, `cond`).
"""
import sys as _sys
import types as _types

from .. import ops as _ops  # noqa: F401  (registers every op)
from .ndarray import (NDArray, invoke, array, zeros, ones, full, empty,
                      arange, zeros_like, ones_like, concatenate, moveaxis,
                      waitall, load, save, load_frombuffer, _as_nd)
from .register import populate as _populate
from .. import random as _pkg_random

_populate(globals())
_g = globals()

# nd.random.* (reference: ndarray/random.py)
random = _types.ModuleType(__name__ + ".random")
for _name in ("uniform", "normal", "randint", "gamma", "exponential",
              "poisson", "negative_binomial",
              "generalized_negative_binomial"):
    random.__dict__[_name] = _g["_random_%s" % _name]
random.__dict__["multinomial"] = _g["_sample_multinomial"]
random.__dict__["shuffle"] = _g["_shuffle"]
random.__dict__["seed"] = _pkg_random.seed
_sys.modules[__name__ + ".random"] = random

# nd.linalg.* (reference: ndarray/linalg.py)
linalg = _types.ModuleType(__name__ + ".linalg")
for _name in ("gemm", "gemm2", "potrf", "potri", "trsm", "trmm", "syrk",
              "sumlogdiag", "syevd", "gelqf"):
    linalg.__dict__[_name] = _g["_linalg_%s" % _name]
_sys.modules[__name__ + ".linalg"] = linalg

# nd.contrib.*: the _contrib_ ops without their prefix
contrib = _types.ModuleType(__name__ + ".contrib")
for _name in list(_g):
    if _name.startswith("_contrib_"):
        contrib.__dict__[_name[len("_contrib_"):]] = _g[_name]
_sys.modules[__name__ + ".contrib"] = contrib
