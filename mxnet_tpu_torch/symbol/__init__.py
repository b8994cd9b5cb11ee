"""The `sym` namespace: Symbol and one function per registered operator
(counterpart of mxnet_tpu/symbol/__init__.py), with the `sym.random`,
`sym.linalg`, `sym.contrib` and `sym.sparse` namespaces.

Not ported yet: the control-flow frontends (`contrib.foreach`,
`while_loop`, `cond`), which wait with their ops (ROADMAP A10).
"""
import sys as _sys
import types as _types

from .. import ops as _ops  # noqa: F401  (registers every op)
from .symbol import (Symbol, var, Variable, Group, load, load_json,
                     zeros, ones, arange)
from .register import populate as _populate, make_symbol_func

_symbol_ns = _sys.modules[__name__]

_populate(globals())
_g = globals()

# sym.random.* / sym.linalg.* / sym.contrib.* namespaces
random = _types.ModuleType(__name__ + ".random")
for _name in ("uniform", "normal", "randint"):
    if ("_random_%s" % _name) in _g:
        random.__dict__[_name] = _g["_random_%s" % _name]
_sys.modules[__name__ + ".random"] = random

linalg = _types.ModuleType(__name__ + ".linalg")
for _name in ("gemm", "gemm2", "potrf", "potri", "trsm", "trmm", "syrk",
              "sumlogdiag", "syevd", "gelqf"):
    _key = "_linalg_%s" % _name
    if _key in _g:
        linalg.__dict__[_name] = _g[_key]
_sys.modules[__name__ + ".linalg"] = linalg

contrib = _types.ModuleType(__name__ + ".contrib")
for _name in list(_g):
    if _name.startswith("_contrib_"):
        contrib.__dict__[_name[len("_contrib_"):]] = _g[_name]
_sys.modules[__name__ + ".contrib"] = contrib

# sym.sparse.*: the same graph ops (storage type is an attribute matter)
sparse = _types.ModuleType(__name__ + ".sparse")
for _name in ("dot", "cast_storage", "elemwise_add", "elemwise_mul",
              "zeros_like"):
    if _name in _g:
        sparse.__dict__[_name] = _g[_name]
if "_sparse_retain" in _g:
    sparse.__dict__["retain"] = _g["_sparse_retain"]
_sys.modules[__name__ + ".sparse"] = sparse

__all__ = ["Group", "Symbol", "Variable", "arange", "load", "load_json",
           "make_symbol_func", "ones", "var", "zeros"]
