"""DecodeEngine: KV-cached autoregressive generation over a fixed-shape
slot cache (counterpart of mxnet_tpu/serving/decode.py).

An autoregressive block (anything exposing the decode protocol below —
`gluon.model_zoo.GPTDecoder` is the in-repo model) is driven through:

- **prefill** (per padding bucket): full causal forward over a prompt
  padded up to a power-of-two length (`bucket_sizes`), returning the
  first greedy token and the prompt's K/V zero-masked and padded out to
  `max_seq_len`;
- **admit**: writes a prefilled K/V sequence into a free slot of the
  engine's cache, in place;
- **step**: ONE token for EVERY slot. The batch shape is pinned at
  `max_slots`, so each step runs the same kernels at the same shapes
  however sequences come and go — which is also what makes a sequence's
  tokens independent of its neighbours.

Where the JAX engine donates the cache and position vector to its jitted
programs (decode.py:132-136), this one updates them in place.

The cache is slot-based: (num_layers, max_slots, max_seq_len, heads,
head_dim) for K and V, plus a (max_slots,) int64 position vector (rows
of cache filled per slot) on the device, mirrored on the host so slot
bookkeeping never waits for the device. `ContinuousBatchScheduler` owns
slot assignment; the engine only moves tensors.

`dtype="bf16"` (or env ``MXTPU_SERVE_DTYPE=bf16``) casts params and the
cache to bfloat16, and the prefill's attention and every LayerNorm run
the bf16 paths of the `flash_attention` and `layer_norm` kernels on the
card; logits come back to fp32 before the greedy argmax either way.

Accounting as in the JAX engine: the params, KV cache and position
vector are cells of the memory ledger (`device_bytes` reconciles them);
each dispatch charges the decoder-FLOPs estimate 2 * n_params * n_tokens
to ``goodput.flops``; prefill and step run under the ledger's OOM guard,
prefill under the request's trace annotation. ``serving.decode.compiles``
counts each decode program (a prefill bucket, admit, step) at its first
dispatch. The JAX engine's AOT export/load is not ported: `aot_export`
and `aot_load` raise `MXNetError` naming ROADMAP A9b's compile plane.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..base import MXNetError, getenv
from ..context import resolve_device
from ..observability import goodput as _goodput
from ..observability import memory as _memory
from ..observability import registry as _obs
from ..observability import trace as _trace
from .engine import _AOT_MSG, bucket_sizes, resolve_serve_dtype

__all__ = ["DecodeEngine"]

_COMPILES = _obs.counter(
    "serving.decode.compiles",
    "decode-path programs run for the first time, by kind "
    "(prefill buckets, admit, step)")
_STEP_SECONDS = _obs.histogram(
    "serving.decode.step.seconds",
    "wall time of one whole-batch decode step, tokens back on the host")
_PREFILL_SECONDS = _obs.histogram(
    "serving.decode.prefill.seconds",
    "wall time of one prompt prefill + cache admit, first token on the "
    "host")


class DecodeEngine:
    """A frozen autoregressive model plus its at-rest decode state.

    `block` must expose the decode protocol:

    - ``decode_spec()`` -> dict with at least ``max_seq_len``,
      ``vocab_size`` and (optionally) ``eos_token``;
    - ``decode_params(dtype=None)`` -> {name: tensor};
    - ``init_cache(slots, dtype=None, device=None)`` -> (k, v) zero
      caches shaped (..., slots, max_seq_len, ...), slot axis second;
    - ``prefill(tokens (1, Lb), length, params)`` -> (next_token, k_seq,
      v_seq) with k/v padded to max_seq_len;
    - ``step(cache_k, cache_v, positions, active, tokens, params)`` ->
      next_tokens, updating the cache and positions in place.

    Runs on CUDA unless ``device="cpu"``. The engine is single-consumer:
    one scheduler (or caller thread) drives prefill/step.
    """

    def __init__(self, block, max_slots=None, dtype=None, device=None,
                 name=None):
        if getattr(block, "decode_spec", None) is None:
            raise MXNetError(
                "DecodeEngine wants a block with the decode protocol "
                "(decode_spec/decode_params/init_cache/prefill/step) — "
                "gluon.model_zoo.GPTDecoder is the in-repo reference; got "
                "%s" % type(block).__name__)
        self.device = resolve_device(device)
        self._block = block
        self._spec = dict(block.decode_spec())
        self.name = name or "decode"
        self.dtype = resolve_serve_dtype(dtype)
        self.max_seq_len = int(self._spec["max_seq_len"])
        self.vocab_size = int(self._spec["vocab_size"])
        self.max_slots = int(max_slots if max_slots is not None
                             else getenv("MXTPU_DECODE_SLOTS", 8))
        if self.max_slots < 1:
            raise MXNetError("max_slots must be >= 1, got %d"
                             % self.max_slots)
        self.eos_token = self._spec.get("eos_token")
        self._buckets = bucket_sizes(self.max_seq_len)
        cast = self.dtype if self.dtype == "bf16" else None
        self._params = {k: v.to(self.device)
                        for k, v in block.decode_params(dtype=cast).items()}
        self._lock = threading.Lock()
        self._compiled = {}
        self.steps = 0
        self.reset()

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def reset(self):
        """(Re)allocate the cache and clear every slot."""
        self._cache_k, self._cache_v = self._block.init_cache(
            self.max_slots, dtype=self.dtype if self.dtype == "bf16"
            else None, device=self.device)
        self._positions = torch.zeros(self.max_slots, dtype=torch.int64,
                                      device=self.device)
        # host mirrors — slot bookkeeping must not sync the device
        self.positions = np.zeros((self.max_slots,), np.int64)
        self.active = np.zeros((self.max_slots,), bool)
        self.tokens = np.zeros((self.max_slots,), np.int64)
        self._ledger_sync()

    def _ledger_sync(self):
        """Reconcile this engine's memory-ledger cells with the tensors
        it holds — params, the statically-shaped KV cache (the dominant
        cell at scale), and the position vector."""
        _memory.set_bytes(self.name, "decode", "params",
                          _memory.nbytes(self._params))
        _memory.set_bytes(self.name, "decode", "kv_cache",
                          int(self._cache_k.nbytes)
                          + int(self._cache_v.nbytes))
        _memory.set_bytes(self.name, "decode", "positions",
                          int(self._positions.nbytes))

    def device_bytes(self):
        """Measured device bytes this engine keeps resident: params plus
        the KV cache and position vector — what a model-multiplexing
        registry accounts against its budget. The cache is allocated for
        max_slots whether or not any sequence is active."""
        self._ledger_sync()      # ledger and budget agree by definition
        return (_memory.nbytes(self._params) + int(self._cache_k.nbytes)
                + int(self._cache_v.nbytes) + int(self._positions.nbytes))

    @property
    def compiled_programs(self):
        """{kind: count} of decode programs this engine has run: 'prefill'
        (one per padding bucket used), 'admit', 'step'."""
        with self._lock:
            out = {}
            for key in self._compiled:
                kind = key[0] if isinstance(key, tuple) else key
                out[kind] = out.get(kind, 0) + 1
            return out

    def _count_compile(self, key):
        with self._lock:
            if key in self._compiled:
                return
            self._compiled[key] = 1
        kind = key[0] if isinstance(key, tuple) else key
        _COMPILES.inc(engine=self.name, kind=kind)

    # -- ahead-of-time programs: the compile plane is not ported -------
    def aot_export(self, store, buckets=None, verify=True):
        raise MXNetError("DecodeEngine.aot_export: " + _AOT_MSG)

    def aot_load(self, store, buckets=None):
        raise MXNetError("DecodeEngine.aot_load: " + _AOT_MSG)

    @property
    def aot_programs(self):
        return []

    def _charge_goodput(self, kind, bucket=None, tokens=None):
        """Charge one dispatch's FLOPs to the goodput counter under the
        program's name: the decoder-FLOPs estimate 2 * n_params *
        n_tokens, as the JAX engine charges it."""
        if not _goodput.enabled():
            return
        name = "decode/%s/%s" % (self.name, kind if bucket is None
                                 else "%s_b%d" % (kind, bucket))
        if _goodput.cost(name) is None:
            n_elems = sum(int(v.numel()) for v in self._params.values())
            n_tok = int(tokens if tokens is not None else (bucket or 1))
            _goodput.record_cost(name, flops=2.0 * n_elems * n_tok)
        _goodput.note_dispatch(name)

    @property
    def free_slots(self):
        return [i for i in range(self.max_slots) if not self.active[i]]

    @property
    def active_slots(self):
        return [i for i in range(self.max_slots) if self.active[i]]

    def bucket_for(self, n):
        """Smallest prefill padding bucket holding an n-token prompt."""
        n = int(n)
        if n < 1:
            raise MXNetError("prompt must have >= 1 token")
        if n > self.max_seq_len:
            raise MXNetError(
                "prompt of %d tokens exceeds max_seq_len=%d"
                % (n, self.max_seq_len))
        for b in self._buckets:
            if b >= n:
                return b
        raise AssertionError("unreachable")

    # ------------------------------------------------------------------
    # prefill + admit, step
    # ------------------------------------------------------------------
    def prefill(self, tokens, slot):
        """Prefill `tokens` (1-D int array) into free cache slot `slot`:
        pads the prompt to its bucket, runs the bucketed prefill, admits
        the K/V into the cache, marks the slot active, and returns the
        first greedy token (int)."""
        tokens = np.asarray(tokens).reshape(-1)
        n = tokens.shape[0]
        bucket = self.bucket_for(n)
        if self.active[slot]:
            raise MXNetError("slot %d is already active" % slot)
        # JAX fills an out-of-range embedding gather with NaN; on the card
        # it would be a device-side assert that kills the context
        if tokens.min() < 0 or tokens.max() >= self.vocab_size:
            raise MXNetError("prompt tokens must lie in [0, %d)"
                             % self.vocab_size)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :n] = tokens
        t0 = time.perf_counter()
        # prefill + admit run under the requesting trace's annotation
        # (the scheduler restores the submit context)
        with _memory.oom_guard("decode.prefill", self.name), \
                _trace.device_annotation():
            next_token, k_seq, v_seq = self._block.prefill(
                torch.from_numpy(padded).to(self.device), n,
                params=self._params)
            self._count_compile(("prefill", bucket))
            self._admit(k_seq, v_seq, slot, n)
            self._count_compile("admit")
        self._charge_goodput("prefill", bucket=bucket)
        first = int(next_token)
        self.positions[slot] = n
        self.active[slot] = True
        self.tokens[slot] = first
        _PREFILL_SECONDS.observe(time.perf_counter() - t0,
                                 engine=self.name)
        return first

    def _admit(self, k_seq, v_seq, slot, length):
        """Write one prefilled sequence into `slot`, in place."""
        self._cache_k[:, slot] = k_seq
        self._cache_v[:, slot] = v_seq
        self._positions[slot] = length

    def step(self):
        """One decode step across ALL slots (the continuous-batching
        invariant: fixed shape, every step). Returns np int array of next
        tokens per slot — entries for inactive slots are noise and must
        be ignored. Cache/positions advance in place."""
        if not self.active.any():
            raise MXNetError("step() with no active slots")
        t0 = time.perf_counter()
        tokens = torch.from_numpy(self.tokens).to(self.device)
        active = torch.from_numpy(self.active).to(self.device)
        with _memory.oom_guard("decode.step", self.name):
            next_tokens = self._block.step(
                self._cache_k, self._cache_v, self._positions, active,
                tokens, params=self._params)
            self._count_compile("step")
        self._charge_goodput("step", tokens=self.max_slots)
        out = next_tokens.cpu().numpy()
        self.positions[self.active] += 1
        self.tokens[self.active] = out[self.active]
        self.steps += 1
        _STEP_SECONDS.observe(time.perf_counter() - t0, engine=self.name)
        return out

    def retire(self, slot):
        """Free a slot between steps (sequence finished or evicted).
        Nothing touches the device: the slot's cache rows are dead and
        the next admit overwrites them wholesale."""
        self.active[slot] = False

    def slot_full(self, slot):
        """True when the slot's cache cannot hold another token (the
        next step would have nowhere to write its K/V)."""
        return self.positions[slot] >= self.max_seq_len

    def fill_ratio(self):
        return float(self.active.sum()) / float(self.max_slots)

    def warmup(self, buckets=None):
        """Run one throwaway prefill per bucket (all of them by default)
        and a step after each, so library handles, allocator pools and
        the kernels' first-launch build are paid before real traffic;
        slot state is reset afterwards."""
        for b in (self._buckets if buckets is None else buckets):
            self.prefill(np.zeros(min(int(b), self.max_seq_len), np.int64),
                         slot=self.free_slots[0])
            self.step()
            self.reset()

    def replicate(self, device, name=None):
        """A sibling engine (same block, fresh cache) bound to `device` —
        ModelServer's per-device decode replicas, and the fresh engine a
        scheduler swaps in after a wedged dispatch."""
        return type(self)(self._block, max_slots=self.max_slots,
                          dtype=self.dtype, device=device,
                          name=name or "%s@%s" % (self.name, device))
