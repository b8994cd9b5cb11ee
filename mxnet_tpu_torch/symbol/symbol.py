"""Symbol: lazy symbolic graph construction (counterpart of
mxnet_tpu/symbol/symbol.py: `Symbol` :30, `get_internals` :86,
`list_arguments` :104, `infer_shape` :145, `infer_type` :173,
`simple_bind` :205, `bind` :215, `tojson` :358, `save` :396, `var` :464,
`Group` :490, `load`/`load_json` :499/:536; reference:
python/mxnet/symbol/symbol.py).

A Symbol is a list of (Node, out_index) heads over the graph IR in
`graph.py`. Binding turns the whole graph into one function over tensors
(see executor.py). `tojson` writes the JAX package's JSON byte for byte,
so graph files cross between the two packages both ways.
"""
from __future__ import annotations

import ast
import json

import numpy as np
import torch

from ..base import MXNetError, dtype_from_name, dtype_name, np_dtype
from ..context import current_context
from ..graph import Node, topo_order, collect_vars, infer_structs
from ..ops import registry as _reg
from .. import name as _name_mgr

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json",
           "zeros", "ones", "arange"]


class Symbol:
    """A node (or group of nodes) in the symbolic graph."""

    __slots__ = ("_entries",)

    def __init__(self, entries):
        # entries: list of (Node, out_index)
        self._entries = list(entries)

    # ------------------------------------------------------------------
    # identity / structure
    # ------------------------------------------------------------------
    @property
    def name(self):
        if len(self._entries) == 1:
            return self._entries[0][0].name
        return None

    def attr(self, key):
        node = self._entries[0][0]
        return node.attrs.get(key)

    def _set_attr(self, **kwargs):
        for k, v in kwargs.items():
            self._entries[0][0].attrs[k] = v

    def attr_dict(self):
        out = {}
        for node in topo_order(self._entries):
            if node.attrs:
                out[node.name] = dict(node.attrs)
        return out

    def __len__(self):
        return len(self._entries)

    def __iter__(self):
        for i in range(len(self._entries)):
            yield self[i]

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if index in names:
                index = names.index(index)
            else:
                # allow bare node name (reference: symbol.py __getitem__)
                matches = [i for i, n in enumerate(names)
                           if n.startswith(index)]
                if len(matches) != 1:
                    raise MXNetError("cannot resolve output %r" % index)
                index = matches[0]
        if isinstance(index, slice):
            return Symbol(self._entries[index])
        return Symbol([self._entries[index]])

    def get_internals(self):
        """A Symbol grouping every internal output (reference:
        symbol.py get_internals — used for feature extraction)."""
        entries = []
        for node in topo_order(self._entries):
            for i in range(node.n_visible()):
                entries.append((node, i))
        return Symbol(entries)

    def get_children(self):
        node = self._entries[0][0]
        if not node.inputs:
            return None
        return Symbol(list(node.inputs))

    # ------------------------------------------------------------------
    # listing
    # ------------------------------------------------------------------
    def list_arguments(self):
        args, _ = collect_vars(self._entries)
        return [n.name for n in args]

    def list_auxiliary_states(self):
        _, aux = collect_vars(self._entries)
        return [n.name for n in aux]

    def list_inputs(self):
        return self.list_arguments() + self.list_auxiliary_states()

    def list_outputs(self):
        out = []
        for node, idx in self._entries:
            if node.is_variable:
                out.append(node.name)
            elif node.n_visible() == 1:
                out.append(node.name + "_output")
            else:
                out.append("%s_output%d" % (node.name, idx))
        return out

    @property
    def num_outputs(self):
        return len(self._entries)

    # ------------------------------------------------------------------
    # inference
    # ------------------------------------------------------------------
    def _known_from_kwargs(self, args, kwargs, with_dtype=False):
        known = {}
        if args:
            names = self.list_arguments()
            for n, v in zip(names, args):
                if v is not None:
                    known[n] = v
        for k, v in kwargs.items():
            if v is not None:
                known[k] = v
        return known

    def infer_shape(self, *args, **kwargs):
        res = self.infer_shape_partial(*args, **kwargs)
        arg_shapes, out_shapes, aux_shapes = res
        if arg_shapes and any(s is None for s in arg_shapes):
            missing = [n for n, s in zip(self.list_arguments(), arg_shapes)
                       if s is None]
            raise MXNetError("infer_shape: cannot infer shapes for "
                             "arguments %s" % missing)
        return arg_shapes, out_shapes, aux_shapes

    def infer_shape_partial(self, *args, **kwargs):
        known = {}
        for k, v in self._known_from_kwargs(args, kwargs).items():
            if v is None or (isinstance(v, tuple) and len(v) == 0):
                continue
            known[k] = (tuple(v), torch.float32)
        var_structs, out_structs = infer_structs(self._entries, known)
        args_l, aux_l = collect_vars(self._entries)
        arg_shapes = [None if var_structs.get(n.name) is None
                      else tuple(var_structs[n.name].shape) for n in args_l]
        aux_shapes = [None if var_structs.get(n.name) is None
                      else tuple(var_structs[n.name].shape) for n in aux_l]
        out_shapes = []
        for node, i in self._entries:
            s = out_structs[id(node)][i]
            out_shapes.append(None if s is None else tuple(s.shape))
        return arg_shapes, out_shapes, aux_shapes

    def infer_type(self, *args, **kwargs):
        known = {}
        names = self.list_arguments()
        if args:
            for n, v in zip(names, args):
                if v is not None:
                    known[n] = ((), dtype_from_name(v))
        for k, v in kwargs.items():
            if v is not None:
                known[k] = ((), dtype_from_name(v))
        # dtype inference rides the struct inference with dummy shapes only
        # when full shapes are unknown; prefer float32 defaults.
        arg_types = [np.float32] * len(names)
        out_types = [np.float32] * len(self._entries)
        aux_types = [np.float32] * len(self.list_auxiliary_states())
        for i, n in enumerate(names):
            if n in known:
                arg_types[i] = np.dtype(np_dtype(known[n][1]))
        return arg_types, out_types, aux_types

    # ------------------------------------------------------------------
    # evaluation / binding
    # ------------------------------------------------------------------
    def eval(self, ctx=None, **kwargs):
        """Evaluate with concrete NDArray inputs (reference: symbol.py eval)."""
        ctx = ctx or current_context()
        args = {k: v for k, v in kwargs.items()}
        ex = self.bind(ctx, args)
        return ex.forward(is_train=False)

    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    stype_dict=None, group2ctx=None, shared_arg_names=None,
                    shared_exec=None, shared_buffer=None, **kwargs):
        from ..executor import Executor
        ctx = ctx or current_context()
        return Executor._simple_bind(self, ctx, grad_req=grad_req,
                                     type_dict=type_dict,
                                     shared_exec=shared_exec,
                                     shape_kwargs=kwargs)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        from ..executor import Executor
        ctx = ctx or current_context()
        return Executor._bind(self, ctx, args=args, args_grad=args_grad,
                              grad_req=grad_req, aux_states=aux_states,
                              shared_exec=shared_exec)

    # gradient of this symbol w.r.t. named args: kept for parity; the
    # executor computes grads with torch.autograd over the bound graph.
    def gradient(self, wrt):
        raise MXNetError("Symbol.gradient: use bind().backward() — gradients "
                         "are computed by autograd over the bound graph")

    # ------------------------------------------------------------------
    # arithmetic — defer to the generated symbolic ops
    # ------------------------------------------------------------------
    def _binop(self, other, op_name, scalar_op_name, reverse=False):
        from . import _symbol_ns
        if isinstance(other, Symbol):
            a, b = (other, self) if reverse else (self, other)
            return _apply_op(_reg.get(op_name), [a, b], {}, None)
        if isinstance(other, (int, float, bool, np.number)):
            name = scalar_op_name
            if reverse and _reg.exists("_r" + scalar_op_name.lstrip("_")):
                name = "_r" + scalar_op_name.lstrip("_")
            return _apply_op(_reg.get(name), [self],
                             {"scalar": float(other)}, None)
        return NotImplemented

    def __add__(self, o):
        return self._binop(o, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, o):
        return self._binop(o, "broadcast_sub", "_minus_scalar", reverse=True)

    def __mul__(self, o):
        return self._binop(o, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, o):
        return self._binop(o, "broadcast_div", "_div_scalar", reverse=True)

    __div__ = __truediv__
    __rdiv__ = __rtruediv__

    def __pow__(self, o):
        return self._binop(o, "broadcast_power", "_power_scalar")

    def __mod__(self, o):
        return self._binop(o, "broadcast_mod", "_mod_scalar")

    def __neg__(self):
        return _apply_op(_reg.get("negative"), [self], {}, None)

    def __eq__(self, o):
        if o is None:
            return False
        return self._binop(o, "broadcast_equal", "_equal_scalar")

    def __ne__(self, o):
        if o is None:
            return True
        return self._binop(o, "broadcast_not_equal", "_not_equal_scalar")

    def __gt__(self, o):
        return self._binop(o, "broadcast_greater", "_greater_scalar")

    def __ge__(self, o):
        return self._binop(o, "broadcast_greater_equal",
                           "_greater_equal_scalar")

    def __lt__(self, o):
        return self._binop(o, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, o):
        return self._binop(o, "broadcast_lesser_equal",
                           "_lesser_equal_scalar")

    def __hash__(self):
        return id(self)

    def __repr__(self):
        name = self.name
        if name is None:
            return "<Symbol group [%s]>" % ", ".join(
                n.name for n, _ in self._entries)
        return "<Symbol %s>" % name

    # common fluent methods (subset; same set NDArray exposes)
    def reshape(self, *shape, **kw):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = kw.get("shape", shape)
        return _apply_op(_reg.get("Reshape"), [self],
                         {"shape": tuple(shape)}, None)

    def astype(self, dtype):
        return _apply_op(_reg.get("Cast"), [self],
                         {"dtype": dtype_name(dtype_from_name(dtype))}, None)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return _apply_op(_reg.get("transpose"), [self],
                         {"axes": axes or None}, None)

    def sum(self, axis=None, keepdims=False):
        return _apply_op(_reg.get("sum"), [self],
                         {"axis": axis, "keepdims": keepdims}, None)

    def mean(self, axis=None, keepdims=False):
        return _apply_op(_reg.get("mean"), [self],
                         {"axis": axis, "keepdims": keepdims}, None)

    def flatten(self):
        return _apply_op(_reg.get("Flatten"), [self], {}, None)

    def slice_axis(self, axis, begin, end):
        return _apply_op(_reg.get("slice_axis"), [self],
                         {"axis": axis, "begin": begin, "end": end}, None)

    def expand_dims(self, axis):
        return _apply_op(_reg.get("expand_dims"), [self], {"axis": axis}, None)

    def squeeze(self, axis=None):
        return _apply_op(_reg.get("squeeze"), [self], {"axis": axis}, None)

    def softmax(self, axis=-1):
        return _apply_op(_reg.get("softmax"), [self], {"axis": axis}, None)

    # ------------------------------------------------------------------
    # serialization (reference: symbol.py tojson :1218, legacy_json_util)
    # ------------------------------------------------------------------
    def tojson(self):
        """Reference-compatible graph JSON: attr values are plain strings
        ("(3, 3)", "True", "relu"), the format the reference's
        nnvm::Graph SaveJSON emits and legacy_json_util.cc upgrades —
        so exported JSON loads in the reference and vice versa."""
        order = topo_order(self._entries)
        index = {id(n): i for i, n in enumerate(order)}
        nodes = []
        arg_nodes = []
        row_ptr = [0]
        for i, node in enumerate(order):
            if node.is_variable:
                arg_nodes.append(i)
                entry = {"op": "null", "name": node.name, "inputs": []}
                attrs = {k: _attr_str(v) for k, v in node.attrs.items()}
                if attrs:
                    entry["attrs"] = attrs
            else:
                entry = {
                    "op": node.op.name, "name": node.name,
                    "inputs": [[index[id(n)], oi, 0]
                               for n, oi in node.inputs]}
                # modern reference JSON merges op params and node
                # annotations (lr_mult/ctx_group/...) into one attrs
                # dict; load_json re-splits by op param names
                attrs = {k: _attr_str(v)
                         for k, v in {**node.attrs,
                                      **node.params}.items()}
                if attrs:
                    entry["attrs"] = attrs
            nodes.append(entry)
            row_ptr.append(row_ptr[-1] + node.n_raw())
        heads = [[index[id(n)], oi, 0] for n, oi in self._entries]
        return json.dumps({"nodes": nodes, "arg_nodes": arg_nodes,
                           "node_row_ptr": row_ptr, "heads": heads,
                           "attrs": {"mxnet_version": ["int", 10200]}},
                          indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    def debug_str(self):
        lines = []
        for node in topo_order(self._entries):
            if node.is_variable:
                lines.append("Variable:%s" % node.name)
            else:
                lines.append("--------------------")
                lines.append("Op:%s, Name=%s" % (node.op.name, node.name))
                for pos, (n, i) in enumerate(node.inputs):
                    lines.append("\targ[%d]=%s(%d)" % (pos, n.name, i))
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# composition helper used by the generated symbolic op functions
# ---------------------------------------------------------------------------


def _entry_of(sym):
    if len(sym._entries) != 1:
        raise MXNetError("cannot use a multi-output Symbol group as an "
                         "operator input; select one output first")
    return sym._entries[0]


def _apply_op(op, input_syms, params, name, aux_indices=(),
              input_spec=None):
    """Create an op node; auto-create variables for missing inputs
    (reference: symbol composition + ListArguments naming)."""
    params = dict(params)
    hint = op.name.lower().lstrip("_")
    name = _name_mgr.current().get(name, hint)
    inputs = []
    if input_spec is not None:
        for i, in_name in enumerate(input_spec):
            if i < len(input_syms) and input_syms[i] is not None:
                inputs.append(_entry_of(input_syms[i]))
            else:
                v = Node(None, [], {}, "%s_%s" % (name, in_name),
                         is_aux=(i in aux_indices))
                inputs.append((v, 0))
    else:
        inputs = [_entry_of(s) for s in input_syms]
    # NOTE: aux-ness (BatchNorm moving stats etc.) is NOT stamped on the
    # variable nodes — it is derived per-graph from usage at aux input
    # positions (graph.aux_var_ids), so sharing a var between graphs can't
    # reclassify it elsewhere.
    node = Node(op, inputs, params, name)
    scoped = _scope_attrs()
    if scoped:
        node.attrs = dict(scoped)
    return Symbol([(node, i) for i in range(node.n_visible())])


def _scope_attrs():
    from ..attribute import AttrScope
    return AttrScope.current_attrs()


# ---------------------------------------------------------------------------
# public constructors
# ---------------------------------------------------------------------------


def var(name, attr=None, shape=None, lr_mult=None, wd_mult=None, dtype=None,
        init=None, stype=None, **kwargs):
    """Create a variable symbol (reference: symbol.py var/Variable)."""
    if not isinstance(name, str):
        raise MXNetError("variable name must be a string")
    attrs = dict(_scope_attrs())  # AttrScope defaults; explicit attrs win
    attrs.update(attr or {})
    if shape is not None:
        attrs["__shape__"] = tuple(shape)
    if dtype is not None:
        attrs["__dtype__"] = dtype_name(dtype_from_name(dtype))
    if lr_mult is not None:
        attrs["__lr_mult__"] = lr_mult
    if wd_mult is not None:
        attrs["__wd_mult__"] = wd_mult
    if init is not None:
        attrs["__init__"] = str(init)
    if stype is not None:
        attrs["__storage_type__"] = stype
    attrs.update(kwargs)
    return Symbol([(Node(None, [], {}, name, attrs=attrs), 0)])


Variable = var


def Group(symbols):
    """Group symbols into one multi-output symbol (reference: symbol.py
    Group)."""
    entries = []
    for s in symbols:
        entries.extend(s._entries)
    return Symbol(entries)


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


def _node_attrs(nd):
    """Merged attr dict across JSON vintages (reference
    legacy_json_util.cc upgrade path: old graphs split op params into
    'param' and annotations into 'attr'; >=1.0 merges all into
    'attrs')."""
    out = {}
    if isinstance(nd.get("param"), dict):
        out.update(nd["param"])
    for key in ("attr", "attrs"):
        if isinstance(nd.get(key), dict):
            out.update(nd[key])
    return out


# node annotations that are never op params (reference: nnvm node attrs
# consumed by bind/PlaceDevice, plus our __shape__/__dtype__ markers)
_ANNOTATION_ATTRS = ("ctx_group", "lr_mult", "wd_mult", "force_mirroring",
                     "mirror_stage")


def _entry_list(raw):
    """Input/head entries: modern [node, out, version] or legacy
    [node, out]."""
    out = []
    for e in raw:
        if isinstance(e, (list, tuple)):
            out.append((e[0], e[1] if len(e) > 1 else 0))
        else:
            out.append((e, 0))
    return out


def load_json(json_str):
    """Load reference graph JSON (any vintage) or our own exports."""
    data = json.loads(json_str)
    raw_nodes = data["nodes"]
    built = []
    for nd in raw_nodes:
        merged = {k: _parse_attr(v) for k, v in _node_attrs(nd).items()}
        if nd["op"] == "null":
            node = Node(None, [], {}, nd["name"],
                        is_aux=nd.get("is_aux", False), attrs=merged)
        else:
            op = _reg.get(nd["op"])
            inputs = [(built[i], oi)
                      for i, oi in _entry_list(nd["inputs"])]
            if op.allow_extra_params:
                params = {k: v for k, v in merged.items()
                          if k not in _ANNOTATION_ATTRS
                          and not k.startswith("__")}
            else:
                params = {k: v for k, v in merged.items()
                          if k in op.params}
            attrs = {k: v for k, v in merged.items() if k not in params}
            # legacy graphs omit aux-state inputs (old BatchNorm nodes
            # have 3 inputs; moving stats were implicit) — create the
            # missing trailing variables like compose would
            from .register import _INPUT_SPECS
            spec_fn = _INPUT_SPECS.get(op.name)
            if spec_fn is not None:
                spec = spec_fn(_reg.apply_defaults(op, params))
                while len(inputs) < len(spec):
                    v = Node(None, [], {},
                             "%s_%s" % (nd["name"], spec[len(inputs)]))
                    inputs.append((v, 0))
            node = Node(op, inputs, params, nd["name"], attrs=attrs)
            for oi, ii in (op.aux_write or {}).items():
                if ii < len(inputs) and inputs[ii][0].is_variable:
                    inputs[ii][0].is_aux = True
        built.append(node)
    heads = data.get("heads") or [[len(built) - 1, 0, 0]]
    return Symbol([(built[i], oi) for i, oi in _entry_list(heads)])


def _attr_str(v):
    """Reference-style attr stringification: everything is a string;
    tuples print as "(3, 3)", bools as "True", strings bare."""
    if isinstance(v, str):
        return v
    if isinstance(v, (list, tuple)):
        return str(tuple(v))
    return str(v)


def _parse_attr(v):
    if not isinstance(v, str):
        return v
    if v in ("true", "false"):  # dmlc-style bools in C++-written JSON
        return v == "true"
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def zeros(shape, dtype="float32", **kw):
    return _apply_op(_reg.get("_zeros"), [],
                     {"shape": tuple(shape) if not isinstance(shape, int)
                      else (shape,), "dtype": dtype}, kw.get("name"))


def ones(shape, dtype="float32", **kw):
    return _apply_op(_reg.get("_ones"), [],
                     {"shape": tuple(shape) if not isinstance(shape, int)
                      else (shape,), "dtype": dtype}, kw.get("name"))


def arange(start, stop=None, step=1.0, repeat=1, dtype="float32", **kw):
    return _apply_op(_reg.get("_arange"), [],
                     {"start": start, "stop": stop, "step": step,
                      "repeat": repeat, "dtype": dtype}, kw.get("name"))
