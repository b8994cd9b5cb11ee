"""Symbolic frontend codegen: one `sym.<name>` function per registered op
(counterpart of mxnet_tpu/symbol/register.py). Reference: python/mxnet/symbol/register.py (ctypes codegen of symbol
functions) + the C-side composition in src/c_api/c_api_symbolic.cc.

Key behavior mirrored from the reference: inputs not supplied at compose
time become auto-named variables (``{name}_weight``, ``{name}_bias``,
``{name}_moving_mean`` ...), which is how Module discovers its parameter
list from a bare ``sym.Convolution(data=x, ...)`` chain.
"""
from __future__ import annotations

from ..base import MXNetError
from ..ops import registry as _reg
from .symbol import Symbol, _apply_op

# Ops whose full input list depends on params (the reference encodes this in
# each op's ListArguments()). name -> fn(params) -> list of input names.
_INPUT_SPECS = {
    "Convolution": lambda p: (["data", "weight"]
                              + ([] if p.get("no_bias") else ["bias"])),
    "Deconvolution": lambda p: (["data", "weight"]
                                + ([] if p.get("no_bias", True) else ["bias"])),
    "FullyConnected": lambda p: (["data", "weight"]
                                 + ([] if p.get("no_bias") else ["bias"])),
    "BatchNorm": lambda p: ["data", "gamma", "beta", "moving_mean",
                            "moving_var"],
    "BatchNorm_v1": lambda p: ["data", "gamma", "beta", "moving_mean",
                               "moving_var"],
    "LayerNorm": lambda p: ["data", "gamma", "beta"],
    "InstanceNorm": lambda p: ["data", "gamma", "beta"],
    "Embedding": lambda p: ["data", "weight"],
    "LeakyReLU": lambda p: (["data", "gamma"]
                            if p.get("act_type") == "prelu" else ["data"]),
    "RNN": lambda p: (["data", "parameters", "state"]
                      + (["state_cell"] if p.get("mode", "lstm") == "lstm"
                         else [])),
}

# variadic-input ops: all positional args are inputs
_VARIADIC = {"Concat", "concat", "stack", "add_n", "UpSampling", "khatri_rao",
             "ElementWiseSum", "_Group"}


def _aux_indices(op, params):
    return set((op.aux_write or {}).values())


def make_symbol_func(op, name):
    variadic = name in _VARIADIC or op.name in _VARIADIC

    def fn(*args, **kwargs):
        sym_name = kwargs.pop("name", None)
        attr = kwargs.pop("attr", None)
        inputs = []
        for a in args:
            if isinstance(a, Symbol):
                inputs.append(a)
            else:
                raise MXNetError(
                    "sym.%s: positional inputs must be Symbols, got %r "
                    "(pass params by keyword)" % (name, type(a)))
        params = {}
        named_inputs = {}
        for k, v in kwargs.items():
            if isinstance(v, Symbol):
                named_inputs[k] = v
            else:
                params[k] = v
        spec_fn = _INPUT_SPECS.get(op.name)
        full_params = dict(op.params)
        full_params.update(params)
        if spec_fn is not None:
            spec = spec_fn(full_params)
        elif variadic:
            spec = None
        else:
            spec = list(op.input_names)
        if spec is not None:
            if len(inputs) > len(spec):
                raise MXNetError(
                    "sym.%s: got %d positional inputs but the op takes at "
                    "most %d (%s)" % (name, len(inputs), len(spec), spec))
            # fill positional, then named, leave rest to auto-vars
            slots = list(inputs) + [None] * (len(spec) - len(inputs))
            for k, v in named_inputs.items():
                if k in spec:
                    slots[spec.index(k)] = v
                    continue
                # mxnet-style aliases: 'data' (or any unknown input kwarg)
                # fills the first free slot — op fns name inputs 'x'/'a'
                # while the reference API spells them 'data'/'lhs'
                free = [i for i, s in enumerate(slots) if s is None]
                if not free:
                    raise MXNetError(
                        "sym.%s: unknown input %r (inputs: %s)"
                        % (name, k, spec))
                slots[free[0]] = v
            inputs = slots[:len(spec)]
        else:
            inputs = inputs + list(named_inputs.values())
        aux_idx = _aux_indices(op, full_params)
        sym = _apply_op(op, inputs, params, sym_name,
                        aux_indices=aux_idx, input_spec=spec)
        if attr:
            sym._set_attr(**attr)
        return sym

    fn.__name__ = name
    fn.__doc__ = op.doc
    return fn


def populate(namespace_dict):
    for opname in _reg.list_ops():
        op = _reg.get(opname)
        namespace_dict.setdefault(opname, make_symbol_func(op, opname))
