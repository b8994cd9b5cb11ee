"""Graph IR: the node graph behind Symbol, the executor and CachedOp
(counterpart of mxnet_tpu/graph.py: `Node` :25, `topo_order` :65,
`aux_var_ids` :85, `collect_vars` :104, `build_graph_fn` :115, the shape
rules :192-394, `infer_structs` :395).

The graph is a small pure-Python DAG whose nodes hold registered ops.
`build_graph_fn` turns it into one Python function over tensors that
runs every node through the port's registry (`ops/registry.py`) in
"train" or "predict" mode, as the JAX package's does before handing it
to `jax.jit`. Here nothing compiles it: each op is a launch already, and
torch's autograd records the whole function when grad mode is on, so a
graph run under `autograd.record()` is differentiable end to end.

One rewrite happens on the way, in training mode: a 1x1 NHWC
convolution whose only consumer is a training-mode BatchNorm over its
channel axis runs through the `conv1x1_bn_stats` kernel
(`ops.conv1x1_bn_nhwc`), whose epilogue hands the BatchNorm its batch
statistics, for float32 and bfloat16 inputs: the rule of
`ops.fuses_bn_stats`, by which `gluon.nn.HybridSequential` fuses the same
pair of blocks.

Shape and dtype inference propagate `Struct`s (shape, torch dtype) with
the JAX package's rules for parameters of unknown shape, evaluating
each op on tensors of the "meta" device (no data, no compute) where
the JAX package uses `jax.eval_shape`; the ops that cannot run there
are listed by name (`_KERNEL_OPS`, `_CPU_STRUCT_OPS`).
"""
from __future__ import annotations

import time
from collections import namedtuple

import torch

from . import random as _random
from .observability import telemetry as _telemetry
from .base import MXNetError, tuple_param
from .ops import registry as _reg
from .ops.conv1x1_bn import STATS_DTYPES, fuses_bn_stats

__all__ = ["Node", "Struct", "aux_var_ids", "build_graph_fn",
           "collect_vars", "infer_structs", "register_shape_rule",
           "topo_order"]


class Node:
    """One graph node: a variable (op is None) or an op application.

    inputs: list of (Node, output_index) edges.
    """

    __slots__ = ("op", "inputs", "params", "name", "attrs", "is_aux",
                 "__weakref__")

    def __init__(self, op, inputs, params, name, is_aux=False, attrs=None):
        self.op = op
        self.inputs = inputs
        self.params = params
        self.name = name
        self.is_aux = is_aux
        self.attrs = attrs or {}

    @property
    def is_variable(self):
        return self.op is None

    def n_visible(self):
        if self.op is None:
            return 1
        vis = self.op.visible_outputs
        if callable(vis):
            return vis(self.params)
        return vis or self.op.out_arity(self.params)

    def n_raw(self):
        if self.op is None:
            return 1
        return self.op.out_arity(self.params)

    def __repr__(self):
        if self.op is None:
            return "Var(%s)" % self.name
        return "Node(%s:%s)" % (self.op.name, self.name)


def topo_order(output_entries):
    """Topological order of all nodes reachable from (node, idx) entries
    (an iterative post-order DFS, the reference's PostOrderDFSVisit)."""
    order = []
    seen = set()
    stack = [(n, False) for n, _ in reversed(output_entries)]
    while stack:
        node, expanded = stack.pop()
        if id(node) in seen:
            continue
        if expanded:
            seen.add(id(node))
            order.append(node)
        else:
            stack.append((node, True))
            for inp, _ in reversed(node.inputs):
                if id(inp) not in seen:
                    stack.append((inp, False))
    return order


def aux_var_ids(order):
    """Variables consumed at aux input positions of some op in this graph
    (aux-ness is a property of use within a graph, not of the variable)."""
    aux = set()
    for node in order:
        if node.is_variable or not node.op.aux_write:
            continue
        for _, ii in node.op.aux_write.items():
            in_node, _ = node.inputs[ii]
            if in_node.is_variable:
                aux.add(id(in_node))
    return aux


def collect_vars(output_entries):
    """(arg_nodes, aux_nodes) in first-seen topological order."""
    order = topo_order(output_entries)
    aux_ids = aux_var_ids(order)
    args, aux = [], []
    for node in order:
        if node.is_variable:
            (aux if id(node) in aux_ids else args).append(node)
    return args, aux


_BN_OPS = ("BatchNorm", "BatchNorm_v1")


def _fusion_plan(order, output_entries, node_params):
    """{id(conv node): id(bn node)} for every convolution whose only
    consumer is a training-mode BatchNorm and which, with it, meets
    `ops.fuses_bn_stats`'s rule but for the dtype, which the graph
    function tests when it runs."""
    consumers = {}
    for node in order:
        for n, i in node.inputs:
            consumers.setdefault((id(n), i), []).append(node)
    outputs = {(id(n), i) for n, i in output_entries}
    plan = {}
    for node in order:
        if node.is_variable or node.op.name not in _BN_OPS:
            continue
        src, idx = node.inputs[0]
        p = node_params[id(node)]
        if src.is_variable or idx != 0 or p["use_global_stats"] or \
                src.op.name != "Convolution":
            continue
        c = node_params[id(src)]
        if not fuses_bn_stats(
                tuple_param(c["kernel"], 2),
                tuple_param(c.get("stride"), 2) or (1, 1),
                tuple_param(c.get("pad"), 2) or (0, 0),
                tuple_param(c.get("dilate"), 2) or (1, 1),
                c.get("num_group", 1), c.get("layout"), p["axis"]):
            continue
        if consumers.get((id(src), 0)) == [node] and \
                (id(src), 0) not in outputs:
            plan[id(src)] = id(node)
    return plan


def _device_of(args, aux):
    for t in list(args.values()) + list(aux.values()):
        if isinstance(t, torch.Tensor):
            return t.device
    return torch.device("cpu")


def build_graph_fn(output_entries, mode="predict"):
    """The graph as one function over tensors.

    Returns (fn, arg_names, aux_names, needs_rng) where::

        fn(args: dict[str, Tensor], aux: dict[str, Tensor],
           generator=None) -> (list[Tensor] outputs,
                               dict[str, Tensor] aux_updates)

    aux_updates carries the new values of mutable aux states (BatchNorm's
    moving statistics) in training mode; the caller writes them back.
    A random op draws from `generator`, or from the package's generator
    for the inputs' device (`random.generator`) when none is given.
    """
    from .ops import conv1x1_bn_nhwc
    from .ops.nn import _batch_norm

    t_build = time.perf_counter()
    order = topo_order(output_entries)
    aux_ids = aux_var_ids(order)
    arg_nodes, aux_nodes = collect_vars(output_entries)
    arg_names = [n.name for n in arg_nodes]
    aux_names = [n.name for n in aux_nodes]
    needs_rng = any((not n.is_variable) and n.op.needs_rng for n in order)

    node_params = {}
    for node in order:
        if node.is_variable:
            continue
        p = _reg.apply_defaults(node.op, node.params)
        if node.op.takes_mode:
            p["_mode"] = mode
        if "out" in p:
            p["out"] = None
        node_params[id(node)] = p

    train = mode == "train"
    fused = _fusion_plan(order, output_entries, node_params) if train \
        else {}
    fused_bn = set(fused.values())
    takes_ctx = any("ctx" in p for p in node_params.values())

    def fn(args, aux, generator=None):
        values = {}
        aux_updates = {}
        stats = {}
        device = _device_of(args, aux) if (takes_ctx or (
            needs_rng and generator is None)) else None
        gen = generator
        for node in order:
            nid = id(node)
            if node.is_variable:
                values[nid] = (aux[node.name] if nid in aux_ids
                               else args[node.name],)
                continue
            arrs = [values[id(n)][i] for n, i in node.inputs]
            op = node.op
            params = node_params[nid]
            if nid in fused and arrs[0].dtype in STATS_DTYPES:
                bias = None if params["no_bias"] else arrs[2]
                stride = (tuple_param(params.get("stride"), 2) or (1,))[0]
                y, mean, var = conv1x1_bn_nhwc(arrs[0], arrs[1], bias, stride)
                values[nid] = (y,)
                stats[fused[nid]] = (mean, var)
                continue
            if nid in fused_bn and nid in stats:
                p = params
                y, mean, inv_std, new_mm, new_mv = _batch_norm(
                    arrs[0], arrs[1], arrs[2], arrs[3], arrs[4], p["eps"],
                    p["momentum"], p["fix_gamma"], p["use_global_stats"],
                    p["axis"], True, stats=stats.pop(nid))
                raw = (y, mean, inv_std, new_mm.detach(), new_mv.detach())
            else:
                if "ctx" in params:
                    params = dict(params, ctx=device)
                if op.needs_rng:
                    if gen is None:
                        gen = _random.generator(device)
                    arrs = [gen] + arrs
                raw = op.fn(*arrs, **params)
                if not isinstance(raw, tuple):
                    raw = (raw,)
            values[nid] = raw
            if op.aux_write and train:
                for oi, ii in op.aux_write.items():
                    in_node, _ = node.inputs[ii]
                    if in_node.is_variable and id(in_node) in aux_ids:
                        aux_updates[in_node.name] = raw[oi]
        outs = [values[id(n)][i] for n, i in output_entries]
        return outs, aux_updates

    fn.fused_pairs = len(fused)
    # a build is what the port compiles: ``compile.count`` in the step
    # records (observability.telemetry)
    _telemetry.note_compile(time.perf_counter() - t_build)
    return fn, arg_names, aux_names, needs_rng


# ---------------------------------------------------------------------------
# shape/dtype inference (reference: src/executor/infer_graph_attr_pass.cc).
# Structs flow forward through the graph; a parameter variable of unknown
# shape takes the one its op's rule gives (the reference's per-op
# FInferShape filling in weight shapes).
# ---------------------------------------------------------------------------

Struct = namedtuple("Struct", ["shape", "dtype"])

# op name -> rule(in_structs, params, in_nodes) -> list in_structs (completed)
_PARAM_SHAPE_RULES = {}


def register_shape_rule(name):
    def deco(fn):
        _PARAM_SHAPE_RULES[name] = fn
        return fn
    return deco


def _struct(shape, dtype):
    return Struct(tuple(int(s) for s in shape), dtype)


@register_shape_rule("FullyConnected")
def _fc_rule(ins, params, nodes):
    data = ins[0]
    if data is None:
        return ins
    dt = data.dtype
    if params.get("flatten", True) and len(data.shape) > 1:
        in_units = 1
        for s in data.shape[1:]:
            in_units *= int(s)
    else:
        in_units = data.shape[-1]
    nh = params["num_hidden"]
    out = list(ins)
    if out[1] is None:
        out[1] = _struct((nh, in_units), dt)
    if len(out) > 2 and out[2] is None:
        out[2] = _struct((nh,), dt)
    return out


@register_shape_rule("Convolution")
def _conv_rule(ins, params, nodes):
    data = ins[0]
    if data is None:
        return ins
    dt = data.dtype
    kernel = tuple(params["kernel"]) if not isinstance(params["kernel"], int) \
        else (params["kernel"],)
    nf = params["num_filter"]
    ng = params.get("num_group", 1) or 1
    layout = params.get("layout")
    channels_last = layout is not None and layout[1] != "C"
    cin = data.shape[len(data.shape) - 1 if channels_last else 1]
    out = list(ins)
    if out[1] is None:
        # a channels-last weight is (O, *kernel, I)
        wshape = (nf,) + kernel + (cin // ng,) if channels_last \
            else (nf, cin // ng) + kernel
        out[1] = _struct(wshape, dt)
    if len(out) > 2 and out[2] is None:
        out[2] = _struct((nf,), dt)
    return out


@register_shape_rule("Deconvolution")
def _deconv_rule(ins, params, nodes):
    data = ins[0]
    if data is None:
        return ins
    dt = data.dtype
    kernel = tuple(params["kernel"])
    nf = params["num_filter"]
    ng = params.get("num_group", 1) or 1
    cin = data.shape[1]
    out = list(ins)
    if out[1] is None:
        out[1] = _struct((cin, nf // ng) + kernel, dt)
    if len(out) > 2 and out[2] is None:
        out[2] = _struct((nf,), dt)
    return out


def _norm_rule_factory(n_stats):
    def rule(ins, params, nodes):
        data = ins[0]
        if data is None:
            return ins
        axis = params.get("axis", 1)
        c = data.shape[axis % len(data.shape)]
        out = list(ins)
        for i in range(1, min(len(out), 1 + n_stats)):
            if out[i] is None:
                out[i] = _struct((c,), torch.float32)
        return out
    return rule


_PARAM_SHAPE_RULES["BatchNorm"] = _norm_rule_factory(4)
_PARAM_SHAPE_RULES["BatchNorm_v1"] = _norm_rule_factory(4)
_PARAM_SHAPE_RULES["InstanceNorm"] = _norm_rule_factory(2)


@register_shape_rule("LayerNorm")
def _ln_rule(ins, params, nodes):
    data = ins[0]
    if data is None:
        return ins
    axis = params.get("axis", -1)
    c = data.shape[axis % len(data.shape)]
    out = list(ins)
    for i in (1, 2):
        if i < len(out) and out[i] is None:
            out[i] = _struct((c,), data.dtype)
    return out


@register_shape_rule("Embedding")
def _emb_rule(ins, params, nodes):
    out = list(ins)
    if out[1] is None:
        out[1] = _struct((params["input_dim"], params["output_dim"]),
                         torch.float32)
    return out


@register_shape_rule("LeakyReLU")
def _prelu_rule(ins, params, nodes):
    if params.get("act_type") != "prelu" or len(ins) < 2:
        return ins
    data = ins[0]
    if data is None or ins[1] is not None:
        return ins
    out = list(ins)
    c = data.shape[1] if len(data.shape) > 1 else 1
    out[1] = _struct((c,), data.dtype)
    return out


@register_shape_rule("SoftmaxOutput")
def _softmax_out_rule(ins, params, nodes):
    data = ins[0]
    if data is None or len(ins) < 2 or ins[1] is not None:
        return ins
    out = list(ins)
    if params.get("multi_output"):
        lbl = (data.shape[0],) + tuple(data.shape[2:])
    elif params.get("preserve_shape"):
        lbl = tuple(data.shape[:-1])
    else:
        lbl = (data.shape[0],)
    out[1] = _struct(lbl, torch.float32)
    return out


def _regression_rule(ins, params, nodes):
    data = ins[0]
    if data is None or len(ins) < 2 or ins[1] is not None:
        return ins
    out = list(ins)
    out[1] = _struct(data.shape, data.dtype)
    return out


@register_shape_rule("SVMOutput")
def _svm_out_rule(ins, params, nodes):
    """One class index per row (reference: svm_output.cc)."""
    data = ins[0]
    if data is None or len(ins) < 2 or ins[1] is not None:
        return ins
    out = list(ins)
    out[1] = _struct((data.shape[0],), torch.float32)
    return out


for _n in ("LinearRegressionOutput", "MAERegressionOutput",
           "LogisticRegressionOutput"):
    _PARAM_SHAPE_RULES[_n] = _regression_rule


def as_struct(v):
    """A `Struct` from a Struct, a (shape, dtype) pair or a bare shape
    (float32)."""
    from .base import dtype_from_name
    if isinstance(v, Struct):
        return v
    if isinstance(v, tuple) and v and isinstance(v[0], (tuple, list)):
        return _struct(v[0], dtype_from_name(v[1]))
    return _struct(v, torch.float32)


def _eval_shape(op, params, structs, on):
    args = [torch.zeros(s.shape, dtype=s.dtype, device=on) for s in structs]
    if op.needs_rng:
        args = [torch.Generator(device="cpu")] + args
    if "ctx" in params:
        params = dict(params, ctx=torch.device(on))
    with torch.no_grad():
        raw = op.fn(*args, **params)
    if not isinstance(raw, tuple):
        raw = (raw,)
    return [Struct(tuple(r.shape), r.dtype) for r in raw]


# The ops whose function launches a CUDA kernel on the card, which no
# meta tensor reaches: output 0 has input 0's struct, and each output an
# op writes back (`aux_write`) the struct of the input it writes.
_KERNEL_OPS = frozenset(("LayerNorm", "_contrib_flash_attention",
                         "sgd_update", "sgd_mom_update", "mp_sgd_update",
                         "mp_sgd_mom_update"))

# The ops evaluated once on CPU zeros of their input shapes: their code
# reads values (histogram's bins through `nonzero`, bipartite matching's
# `item()`), or torch's meta device refuses their draw (`exponential_`
# with a generator).
_CPU_STRUCT_OPS = frozenset(("histogram", "_histogram",
                             "_contrib_bipartite_matching",
                             "_sample_exponential"))


def _op_structs(op, params, ins):
    if op.name in _KERNEL_OPS:
        return [ins[0]] + [ins[ii] for _, ii in sorted(op.aux_write.items())]
    if op.name in _CPU_STRUCT_OPS:
        return _eval_shape(op, params, ins, "cpu")
    try:
        return _eval_shape(op, params, ins, "meta")
    except NotImplementedError:
        # torch has no meta kernel for an op this graph reaches (none of
        # the registry's, by the port's op sweep): its values decide
        return _eval_shape(op, params, ins, "cpu")


def infer_structs(output_entries, known, mode="predict"):
    """Propagate Structs through the graph.

    known: {var_name: Struct, (shape, dtype) or shape}. Returns
    ({var_name: Struct} for every variable it could resolve,
    {id(node): [output Structs]}). Each op is evaluated on meta tensors
    but for the kernel ops, whose output structs follow their inputs',
    and the ops that read values, which run once on CPU zeros of their
    input shapes (`_KERNEL_OPS`, `_CPU_STRUCT_OPS`).
    """
    var_structs = {k: as_struct(v) for k, v in known.items()}
    order = topo_order(output_entries)
    out_structs = {}

    for node in order:
        if node.is_variable:
            out_structs[id(node)] = [var_structs.get(node.name)]
            continue
        ins = [out_structs[id(n)][i] for n, i in node.inputs]
        params = _reg.apply_defaults(node.op, node.params)
        rule = _PARAM_SHAPE_RULES.get(node.op.name)
        if rule is not None and any(s is None for s in ins):
            ins = rule(ins, params, [n for n, _ in node.inputs])
            # write resolved structs back onto variable inputs
            for (in_node, _), s in zip(node.inputs, ins):
                if in_node.is_variable and s is not None and \
                        var_structs.get(in_node.name) is None:
                    var_structs[in_node.name] = s
                    out_structs[id(in_node)] = [s]
        if any(s is None for s in ins):
            out_structs[id(node)] = [None] * node.n_raw()
            continue
        if node.op.takes_mode:
            params["_mode"] = mode
        if "out" in params:
            params["out"] = None
        try:
            out_structs[id(node)] = _op_structs(node.op, params, ins)
        except Exception as e:  # noqa: BLE001 — surface as an infer error
            raise MXNetError(
                "shape inference failed at op %s(%s): %s"
                % (node.op.name, node.name, e)) from None

    return var_structs, out_structs
