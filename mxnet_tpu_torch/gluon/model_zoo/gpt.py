"""GPT-style autoregressive decoder (counterpart of
mxnet_tpu/gluon/model_zoo/gpt.py).

A pre-norm causal transformer: learned token and position embeddings,
blocks of fused-QKV multi-head causal attention and a tanh-GELU MLP, a
final LayerNorm and a weight-tied LM head. The math mirrors the JAX
package's `_forward_jax`/`_prefill_jax`/`_step_jax` line for line,
with two kernels in place of plain ops:

- every LayerNorm goes through `ops.layer_norm` (2 * layers + 1 per
  forward, prefill or step);
- the causal attention of a full forward (and so of prefill) goes
  through `ops.flash_attention`, one launch per layer, on strided views
  of the projections and into a (B, T, H, D) buffer: no copies. The
  one-token step's attention over the cache stays plain PyTorch, as it
  stays plain XLA in the JAX package: the kernel has no one-query form.

`GPTDecoder.hybrid_forward(F, tokens, **P)` is the Gluon path: the JAX
package's (gpt.py:237-295) line for line, through the registry ops of
``F = mx.nd`` on NDArrays (LayerNorm on the `layer_norm` kernel, the
attention as batch_dot, softmax and batch_dot), so ``autograd.record()``
trains it. The decode path above does not use it.

Cache layout (shared with serving/decode.py and with the JAX package):

    k, v : (num_layers, slots, max_seq_len, num_heads, head_dim)
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...base import MXNetError
from ...context import resolve_device
from ...convert import gpt_param_shapes
from ...ops import flash_attention, layer_norm

__all__ = ["GPTDecoder"]

# additive attention mask value of the step, as in the JAX package: exp
# of a masked score underflows to exactly 0.0
_MASK = 1e30
_LN_EPS = 1e-5


def _linear(x, w, b=None):
    """y = x @ w.T (+ b): w is (out, in), the JAX package's layout too."""
    return F.linear(x, w, b)


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _softmax(x):
    """fp32 inner softmax for low-precision x, as the JAX `_softmax`."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return torch.softmax(x.float(), dim=-1).to(x.dtype)
    return torch.softmax(x, dim=-1)


def _mlp(P, i, x):
    h2 = layer_norm(x, P["h%d_ln2_gamma" % i], P["h%d_ln2_beta" % i],
                    _LN_EPS)
    up = _gelu(_linear(h2, P["h%d_mlp_up_weight" % i],
                       P["h%d_mlp_up_bias" % i]))
    return x + _linear(up, P["h%d_mlp_down_weight" % i],
                       P["h%d_mlp_down_bias" % i])


def _blocks(cfg, P, tokens, collect_kv=False):
    """Full-context causal forward up to the final LayerNorm. tokens:
    (B, T) int64. Returns the residual stream (B, T, E) and, when
    `collect_kv`, the per-layer K/V (B, T, H, D) the prefill keeps."""
    E, H, D = cfg["embed_dim"], cfg["num_heads"], cfg["head_dim"]
    B, T = tokens.shape
    x = P["tok_embed_weight"][tokens] + P["pos_embed_weight"][:T][None]
    ks, vs = [], []
    for i in range(cfg["num_layers"]):
        h = layer_norm(x, P["h%d_ln1_gamma" % i], P["h%d_ln1_beta" % i],
                       _LN_EPS)
        qkv = _linear(h, P["h%d_attn_qkv_weight" % i],
                      P["h%d_attn_qkv_bias" % i])
        q, k, v = (t.reshape(B, T, H, D) for t in qkv.split(E, dim=-1))
        if collect_kv:
            ks.append(k)
            vs.append(v)
        # the kernel's (B, H, T, D) as views of the (B, T, H, D) heads, as
        # the Gluon path transposes them (gpt.py:264-266); the kernel takes
        # the strides, so nothing is copied, and it writes into ctx
        ctx = torch.empty(B, T, H, D, dtype=q.dtype, device=q.device)
        flash_attention(*(t.transpose(1, 2) for t in (q, k, v)),
                        causal=True, out=ctx.transpose(1, 2))
        ctx = ctx.reshape(B, T, E)
        x = x + _linear(ctx, P["h%d_attn_out_weight" % i],
                        P["h%d_attn_out_bias" % i])
        x = _mlp(P, i, x)
    return x, ks, vs


def _head(P, x):
    """Final LayerNorm and the tied LM head; fp32 logits."""
    xf = layer_norm(x, P["lnf_gamma"], P["lnf_beta"], _LN_EPS)
    return _linear(xf, P["tok_embed_weight"]).float()


def _prefill(cfg, P, tokens, length):
    """Prefill one sequence: tokens (1, Lb) padded to a bucket length,
    `length` the true prompt length. Returns (next_token () int64, k, v
    (num_layers, max_seq_len, H, D)) with rows >= length zeroed and
    padded out to max_seq_len, as `_prefill_jax` does. Only the row at
    `length - 1` goes through the final LayerNorm and the head: the
    other rows' logits are never read."""
    L, Lb = cfg["max_seq_len"], tokens.shape[1]
    x, ks, vs = _blocks(cfg, P, tokens, collect_kv=True)
    logits = _head(P, x[0, length - 1:length])
    next_token = torch.argmax(logits[0])

    def pack(seqs):                     # layers x (1, Lb, H, D)
        out = torch.zeros((len(seqs), L) + tuple(seqs[0].shape[2:]),
                          dtype=seqs[0].dtype, device=seqs[0].device)
        for i, s in enumerate(seqs):
            out[i, :length] = s[0, :length]
        return out

    return next_token, pack(ks), pack(vs)


def _step(cfg, P, cache_k, cache_v, positions, active, tokens):
    """One decode step for every slot at once, updating `cache_k`,
    `cache_v` and `positions` in place where the JAX step donates them
    (serving/decode.py:132-136). positions (S,) int64: cached rows per
    slot, the row this step's token is written at; active (S,) bool;
    tokens (S,) int64. Returns next_tokens (S,) int64; inactive slots'
    entries are noise and keep their position.

    A retired slot that filled its window sits at ``positions ==
    max_seq_len``, one past the end. JAX's gather fills and its scatter
    drops such an index; torch would raise (on the card, a device-side
    assert). So the position embedding is read at the clamped index, and
    an inactive slot's cache rows are left as they were."""
    E, H, D = cfg["embed_dim"], cfg["num_heads"], cfg["head_dim"]
    L = cfg["max_seq_len"]
    S = positions.shape[0]
    slot = torch.arange(S, device=positions.device)
    row = positions.clamp(max=L - 1)
    keep = active[:, None, None]
    x = P["tok_embed_weight"][tokens] + P["pos_embed_weight"][row]
    # (S, 1, L) additive mask: key l visible while l <= position
    visible = torch.arange(L, device=positions.device)[None, :] \
        <= positions[:, None]
    add = ((visible.float() - 1.0) * _MASK)[:, None, :]
    scale = 1.0 / float(np.sqrt(D))
    for i in range(cfg["num_layers"]):
        h = layer_norm(x, P["h%d_ln1_gamma" % i], P["h%d_ln1_beta" % i],
                       _LN_EPS)
        qkv = _linear(h, P["h%d_attn_qkv_weight" % i],
                      P["h%d_attn_qkv_bias" % i])
        q, k, v = (t.reshape(S, H, D) for t in qkv.split(E, dim=-1))
        ck, cv = cache_k[i], cache_v[i]
        ck[slot, row] = torch.where(keep, k, ck[slot, row])
        cv[slot, row] = torch.where(keep, v, cv[slot, row])
        scores = torch.einsum("shd,slhd->shl", q, ck) * scale
        p = _softmax(scores + add.to(scores.dtype))
        ctx = torch.einsum("shl,slhd->shd", p, cv).reshape(S, E)
        x = x + _linear(ctx, P["h%d_attn_out_weight" % i],
                        P["h%d_attn_out_bias" % i])
        x = _mlp(P, i, x)
    next_tokens = torch.argmax(_head(P, x), dim=-1)
    positions += active.to(positions.dtype)
    return next_tokens


class GPTDecoder(nn.Module):
    """Minimal GPT. `forward(tokens)` -> fp32 logits (B, T, vocab).

    `params` are its weights, numpy arrays or tensors named as in
    `decode_params()` (`convert.init_gpt_params` makes them from a seed,
    `convert.gpt_params_from_jax` carries them over from the JAX
    package). The module lives on `device`: CUDA unless the caller
    passes ``device="cpu"``."""

    def __init__(self, vocab_size, max_seq_len=128, num_layers=2,
                 num_heads=2, embed_dim=32, mlp_ratio=4, eos_token=None,
                 *, params, device=None):
        super().__init__()
        if embed_dim % num_heads:
            raise MXNetError(
                "embed_dim=%d must divide by num_heads=%d"
                % (embed_dim, num_heads))
        self._cfg = {
            "vocab_size": int(vocab_size),
            "max_seq_len": int(max_seq_len),
            "num_layers": int(num_layers),
            "num_heads": int(num_heads),
            "embed_dim": int(embed_dim),
            "head_dim": int(embed_dim) // int(num_heads),
            "mlp_hidden": int(embed_dim) * int(mlp_ratio),
            "eos_token": None if eos_token is None else int(eos_token),
        }
        self.device = resolve_device(device)
        shapes = gpt_param_shapes(self._cfg)
        if set(params) != set(shapes):
            raise MXNetError("params must be exactly %d tensors named as "
                             "in decode_params(); missing %s, unexpected %s"
                             % (len(shapes), sorted(set(shapes) - set(params)),
                                sorted(set(params) - set(shapes))))
        for name, shape in shapes.items():
            value = torch.as_tensor(params[name], device=self.device)
            if tuple(value.shape) != shape:
                raise MXNetError("param %s: want shape %s, got %s"
                                 % (name, shape, tuple(value.shape)))
            self.register_parameter(name, nn.Parameter(
                value, requires_grad=False))

    # -- full forward ----------------------------------------------------
    def forward(self, tokens):
        """Full-context causal forward: tokens (B, T) -> fp32 logits."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        P = self.decode_params()
        with torch.no_grad():
            return _head(P, _blocks(self._cfg, P, tokens)[0])

    # -- Gluon path ----------------------------------------------------
    def hybrid_forward(self, F, tokens, **P):
        """Logits (B, T, vocab) of tokens (B, T) through the operators of
        `F` (``mx.nd``), with the weights `P` (NDArrays named as in
        `decode_params()`)."""
        cfg = self._cfg
        E, H, D = cfg["embed_dim"], cfg["num_heads"], cfg["head_dim"]
        V, M = cfg["vocab_size"], cfg["mlp_hidden"]
        x = F.Embedding(tokens, P["tok_embed_weight"], input_dim=V,
                        output_dim=E)
        # (T, E) slice of the position table, shape-agnostically: the
        # leading axis of tokens^T is T, which slice_like can see
        pos = F.slice_like(P["pos_embed_weight"], F.transpose(tokens),
                           axes=(0,))
        x = F.broadcast_add(x, F.expand_dims(pos, axis=0))
        # causal mask from token positions: r = 1..T per row
        r = F.cast(F.cumsum(F.ones_like(tokens), axis=1),
                   dtype="float32")
        allowed = F.broadcast_lesser_equal(F.expand_dims(r, axis=1),
                                           F.expand_dims(r, axis=2))
        add = F.expand_dims((allowed - 1.0) * _MASK, axis=1)
        scale = 1.0 / float(np.sqrt(D))
        for i in range(cfg["num_layers"]):
            h = F.LayerNorm(x, gamma=P["h%d_ln1_gamma" % i],
                            beta=P["h%d_ln1_beta" % i], axis=-1,
                            eps=_LN_EPS)
            qkv = F.FullyConnected(h, P["h%d_attn_qkv_weight" % i],
                                   P["h%d_attn_qkv_bias" % i],
                                   num_hidden=3 * E, flatten=False)

            def heads(t):               # (B,T,E) -> (B,H,T,D)
                t = F.reshape(t, shape=(0, 0, H, D))
                return F.transpose(t, axes=(0, 2, 1, 3))

            q = heads(F.slice_axis(qkv, axis=-1, begin=0, end=E))
            k = heads(F.slice_axis(qkv, axis=-1, begin=E, end=2 * E))
            v = heads(F.slice_axis(qkv, axis=-1, begin=2 * E,
                                   end=3 * E))
            scores = F.batch_dot(q, k, transpose_b=True) * scale
            p = F.softmax(F.broadcast_add(scores, add), axis=-1)
            ctx = F.batch_dot(p, v)      # (B,H,T,D)
            ctx = F.reshape(F.transpose(ctx, axes=(0, 2, 1, 3)),
                            shape=(0, 0, E))
            x = x + F.FullyConnected(ctx,
                                     P["h%d_attn_out_weight" % i],
                                     P["h%d_attn_out_bias" % i],
                                     num_hidden=E, flatten=False)
            h2 = F.LayerNorm(x, gamma=P["h%d_ln2_gamma" % i],
                             beta=P["h%d_ln2_beta" % i], axis=-1,
                             eps=_LN_EPS)
            up = F.Activation(
                F.FullyConnected(h2, P["h%d_mlp_up_weight" % i],
                                 P["h%d_mlp_up_bias" % i],
                                 num_hidden=M, flatten=False),
                act_type="gelu")
            x = x + F.FullyConnected(up, P["h%d_mlp_down_weight" % i],
                                     P["h%d_mlp_down_bias" % i],
                                     num_hidden=E, flatten=False)
        xf = F.LayerNorm(x, gamma=P["lnf_gamma"], beta=P["lnf_beta"],
                         axis=-1, eps=_LN_EPS)
        return F.FullyConnected(xf, P["tok_embed_weight"], no_bias=True,
                                num_hidden=V, flatten=False)

    # -- decode protocol (consumed by serving.DecodeEngine) --------------
    def decode_spec(self):
        """Static decode configuration (a copy; mutate freely)."""
        return dict(self._cfg)

    def decode_params(self, dtype=None):
        """{short_name: tensor} of the weights, optionally cast to a
        serving dtype ('bf16')."""
        cast = torch.bfloat16 if dtype in ("bf16", "bfloat16") else None
        return {name: p.detach() if cast is None else p.detach().to(cast)
                for name, p in self.named_parameters()}

    def init_cache(self, slots, dtype=None, device=None):
        """Statically-shaped per-slot KV cache:
        (num_layers, slots, max_seq_len, num_heads, head_dim) x2."""
        cfg = self._cfg
        dt = torch.bfloat16 if dtype in ("bf16", "bfloat16") \
            else torch.float32
        dev = self.device if device is None else resolve_device(device)
        shape = (cfg["num_layers"], int(slots), cfg["max_seq_len"],
                 cfg["num_heads"], cfg["head_dim"])
        return (torch.zeros(shape, dtype=dt, device=dev),
                torch.zeros(shape, dtype=dt, device=dev))

    def prefill(self, tokens, length, params=None):
        """tokens (1, Lb) padded to a bucket, `length` the prompt length
        -> (next_token, k, v) with k/v padded to max_seq_len."""
        P = self.decode_params() if params is None else params
        with torch.no_grad():
            return _prefill(self._cfg, P, tokens, int(length))

    def step(self, cache_k, cache_v, positions, active, tokens,
             params=None):
        """One token for every slot; updates cache_k, cache_v and
        positions in place and returns next_tokens (S,)."""
        P = self.decode_params() if params is None else params
        with torch.no_grad():
            return _step(self._cfg, P, cache_k, cache_v, positions, active,
                         tokens)

    def generate_reference(self, tokens, max_new_tokens):
        """Greedy decode by FULL re-forward each step — the cache-free
        reference the KV-cached path must match token for token. Stops
        early on eos_token (included in the output) or when the context
        window fills. Returns np int32 array of generated tokens."""
        cfg = self._cfg
        seq = [int(t) for t in np.asarray(tokens).reshape(-1)]
        out = []
        for _ in range(int(max_new_tokens)):
            if len(seq) > cfg["max_seq_len"]:
                break          # context window full: nothing to forward
            logits = self.forward(torch.tensor([seq]))
            nxt = int(torch.argmax(logits[0, -1]))
            out.append(nxt)
            seq.append(nxt)
            if cfg["eos_token"] is not None and nxt == cfg["eos_token"]:
                break
        return np.asarray(out, dtype=np.int32)
