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

__all__ = ["gpt_param_shapes", "gpt_params_from_jax", "init_gpt_params",
           "init_resnet_params", "resnet_params_from_jax"]


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
    seed gives the same weights on every device. Returns {name: array}
    in the port's layout."""
    from .gluon.block import collect_params   # gluon imports this module
    rng = np.random.RandomState(seed)
    tensors = dict(net.named_parameters())
    tensors.update(net.named_buffers())
    out = {}
    for name, path in collect_params(net).items():
        shape = tuple(tensors[path].shape)
        if name.endswith("_weight"):
            arr = rng.uniform(-_WEIGHT_SCALE, _WEIGHT_SCALE, shape)
        elif name.endswith(("_gamma", "_running_var")):
            arr = np.ones(shape)
        else:
            arr = np.zeros(shape)
        out[name] = arr.astype(np.float32)
    net.load_parameters({k: torch.from_numpy(v) for k, v in out.items()})
    return out


def resnet_params_from_jax(np_params, device=None, layout="NCHW"):
    """{port name: tensor} on `device` (default CUDA) from the JAX
    package's ResNet ``{name: array}`` (`collect_params()` values as
    numpy), for `HybridBlock.load_parameters`. The names lose the JAX
    net's own prefix (``resnetv10_`` etc.), which the port's top block
    does not have. NHWC convolution weights (O, kh, kw, I) are permuted
    to PyTorch's (O, I, kh, kw); Dense weights (out, in) and the vectors
    carry over as they are."""
    dev = resolve_device(device)
    if layout not in ("NCHW", "NHWC"):
        raise MXNetError("layout must be NCHW or NHWC, got %r" % (layout,))
    heads = {name.split("_", 1)[0] for name in np_params}
    if len(heads) != 1:
        raise MXNetError("resnet_params_from_jax: the names do not share "
                         "one net prefix: %s" % sorted(heads))
    cut = len(heads.pop()) + 1
    out = {}
    for name, arr in np_params.items():
        t = _to_torch(arr)
        if layout == "NHWC" and t.dim() == 4:
            t = t.permute(0, 3, 1, 2).contiguous()
        out[name[cut:]] = t.to(dev)
    return out
