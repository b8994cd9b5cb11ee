"""GPT weights for the port: made from a seed, or carried over from the
JAX package.

Weights are numpy arrays named as in `GPTDecoder.decode_params()`, the
same names in both packages. The JAX `_linear` (gpt.py:56) is
``x @ w.T`` with ``w`` of shape (out, in), which is already
`torch.nn.functional.linear`'s layout, so nothing is transposed. The LM
head is tied to ``tok_embed_weight`` and has no tensor of its own.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError
from .context import resolve_device

__all__ = ["gpt_param_shapes", "gpt_params_from_jax", "init_gpt_params"]


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
