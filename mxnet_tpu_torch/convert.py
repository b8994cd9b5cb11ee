"""Weights for the port's models (GPT, ResNet): made from a seed, or
carried over from the JAX package.

GPT weights are numpy arrays named as in `GPTDecoder.decode_params()`,
the same names in both packages. The JAX `_linear` (gpt.py:56) is
``x @ w.T`` with ``w`` of shape (out, in), which is already
`torch.nn.functional.linear`'s layout, so nothing is transposed. The LM
head is tied to ``tok_embed_weight`` and has no tensor of its own.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError
from .context import resolve_device

__all__ = ["gluon_params_from_jax", "gpt_param_shapes",
           "gpt_params_from_jax", "init_gpt_params", "init_resnet_params",
           "resnet_params_from_jax"]


def gpt_param_shapes(cfg):
    """{name: shape} of a GPT with config `cfg` (the keys of
    `GPTDecoder.decode_spec()`)."""
    V, L, E = cfg["vocab_size"], cfg["max_seq_len"], cfg["embed_dim"]
    M = cfg["mlp_hidden"]
    shapes = {"tok_embed_weight": (V, E), "pos_embed_weight": (L, E)}
    for i in range(cfg["num_layers"]):
        shapes.update({
            "h%d_ln1_gamma" % i: (E,), "h%d_ln1_beta" % i: (E,),
            "h%d_attn_qkv_weight" % i: (3 * E, E),
            "h%d_attn_qkv_bias" % i: (3 * E,),
            "h%d_attn_out_weight" % i: (E, E),
            "h%d_attn_out_bias" % i: (E,),
            "h%d_ln2_gamma" % i: (E,), "h%d_ln2_beta" % i: (E,),
            "h%d_mlp_up_weight" % i: (M, E), "h%d_mlp_up_bias" % i: (M,),
            "h%d_mlp_down_weight" % i: (E, M),
            "h%d_mlp_down_bias" % i: (E,)})
    shapes["lnf_gamma"] = (E,)
    shapes["lnf_beta"] = (E,)
    return shapes


def init_gpt_params(cfg, seed=0):
    """Random float32 weights from a numpy seed, drawn as GPT-2 draws
    them: matrices and embeddings N(0, 0.02), biases 0, LayerNorm gains 1
    and shifts 0."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in gpt_param_shapes(cfg).items():
        if name.endswith("_gamma"):
            out[name] = np.ones(shape, np.float32)
        elif name.endswith(("_beta", "_bias")):
            out[name] = np.zeros(shape, np.float32)
        else:
            out[name] = rng.standard_normal(shape, np.float32) * \
                np.float32(0.02)
    return out


def _to_torch(arr):
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":      # ml_dtypes' bfloat16 from JAX
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))   # a writable copy


def gpt_params_from_jax(np_params, device=None, dtype=None):
    """{name: tensor} on `device` (default CUDA) from the JAX package's
    ``{name: array}`` (`decode_params()` passed through `np.asarray`).
    `dtype` casts every tensor ('fp32', 'bf16' or a torch dtype); None
    keeps each array's own."""
    dev = resolve_device(device)
    if dtype in ("bf16", "bfloat16"):
        dtype = torch.bfloat16
    elif dtype in ("fp32", "float32"):
        dtype = torch.float32
    elif dtype is not None and not isinstance(dtype, torch.dtype):
        raise MXNetError("dtype must be 'fp32', 'bf16' or a torch dtype, "
                         "got %r" % (dtype,))
    return {name: _to_torch(arr).to(device=dev, dtype=dtype)
            for name, arr in np_params.items()}


# ---------------------------------------------------------------------------
# ResNet
# ---------------------------------------------------------------------------
_WEIGHT_SCALE = 0.07    # gluon's default initializer, Uniform(0.07)


def init_resnet_params(net, seed=0):
    """Set every parameter and buffer of `net` (any port block) from a
    numpy seed, as Gluon's default initializer draws them: weights
    Uniform(-0.07, 0.07), biases and BatchNorm shifts 0, gains 1, running
    means 0 and variances 1. Draws follow the Gluon name order, so one
    seed gives the same weights on every device. Returns {Gluon name:
    array} in the port's layout."""
    from .gluon.block import collect_params   # gluon imports this module
    rng = np.random.RandomState(seed)
    tensors = dict(net.named_parameters())
    tensors.update(net.named_buffers())
    out, by_path = {}, {}
    for name, path in collect_params(net).items():
        shape = tuple(tensors[path].shape)
        if name.endswith("_weight"):
            arr = rng.uniform(-_WEIGHT_SCALE, _WEIGHT_SCALE, shape)
        elif name.endswith(("_gamma", "_running_var")):
            arr = np.ones(shape)
        else:
            arr = np.zeros(shape)
        out[name] = arr.astype(np.float32)
        by_path[path] = torch.from_numpy(out[name])
    net.load_parameters(by_path)
    return out


def _jax_arrays(jax_params):
    """{name: numpy array} of a JAX block (its dotted block paths, which
    `save_parameters` writes) or of a dict of arrays or NDArrays."""
    if hasattr(jax_params, "_collect_params_with_prefix"):
        jax_params = jax_params._collect_params_with_prefix()
    return {k: (v.data() if hasattr(v, "data") and callable(v.data)
                else v) for k, v in jax_params.items()}


def _np(arr):
    return arr.asnumpy() if hasattr(arr, "asnumpy") else np.asarray(arr)


def gluon_params_from_jax(jax_block_params, device=None, layout="NCHW",
                          prefix=None):
    """{name: tensor} on `device` (default CUDA) for the port block's
    `load_parameters`, from a JAX Gluon block or its parameters.

    Names are structural: given the JAX block itself (or a dict keyed by
    its dotted block paths, ``features.0.weight``), they are those paths,
    which the port's blocks share whatever the two packages' name
    counters stand at. A dict of Gluon names (the JAX block's
    `collect_params()` values, the earlier form) loses the JAX block's
    own prefix: `prefix`, or else the first ``_``-separated word that
    every name shares (``resnetv10_``), and the port block restores its
    own. NHWC convolution weights, the 4-D arrays of an NHWC block, go
    from (O, kh, kw, I) to PyTorch's (O, I, kh, kw); everything else
    carries over as it is (bf16 arrays as bf16)."""
    dev = resolve_device(device)
    if layout not in ("NCHW", "NHWC"):
        raise MXNetError("layout must be NCHW or NHWC, got %r" % (layout,))
    structural = hasattr(jax_block_params, "_collect_params_with_prefix")
    arrays = _jax_arrays(jax_block_params)
    if not structural and not any("." in k for k in arrays):
        if prefix is None:
            heads = {name.split("_", 1)[0] for name in arrays}
            if len(heads) != 1:
                raise MXNetError("gluon_params_from_jax: the names do not "
                                 "share one net prefix: %s" % sorted(heads))
            prefix = heads.pop() + "_"
        for name in arrays:
            if not name.startswith(prefix):
                raise MXNetError("gluon_params_from_jax: %r lacks the "
                                 "prefix %r" % (name, prefix))
        arrays = {k[len(prefix):]: v for k, v in arrays.items()}
    out = {}
    for name, arr in arrays.items():
        t = _to_torch(_np(arr))
        if layout == "NHWC" and t.dim() == 4:
            t = t.permute(0, 3, 1, 2).contiguous()
        out[name] = t.to(dev)
    return out


def resnet_params_from_jax(np_params, device=None, layout="NCHW"):
    """`gluon_params_from_jax` of a JAX ResNet or its parameters."""
    return gluon_params_from_jax(np_params, device, layout)
