"""`ShardedTrainer`, on one device or over a mesh that spans a gang of
processes (counterpart of mxnet_tpu/parallel/data_parallel.py: the
optimizers :52-93, `ShardedTrainer` :115, the step body :343-399,
`step_many` :503, `_stage_inputs` :547, `prefetched` :560, `fit` :579,
`_build_step_compressed` :603, `step` :722, `params` :766,
`copy_params_to_net` :773).

A step is the JAX step body in PyTorch: forward through the
`nn.Module` (with `torch.func.functional_call`, so the trainer's own
copies of the parameters and BatchNorm statistics take the module's
place), the loss ``mean(outs.float())``, gradients with respect to the
fp32 master parameters, the numerics guard's verdict and the update. SGD
updates every tensor in ONE launch of the hand-written
`ops.fused_sgd_momentum` kernel through an `ops.SGDMomentumPlan` built
once in ``__init__`` (`sgd_update` is that kernel's function at
``rescale=1``); Adam is plain PyTorch (``torch._foreach_*``), as JAX's
`adam_update` is XLA. The trainer owns its parameters, aux and optimizer
state and updates them in place, where the JAX step donates its buffers.

**One program a step.** On the card a step runs as ONE CUDA graph
replay, the counterpart of JAX's one donated jit program (:435-449). The
first step of each input signature (shapes and dtypes, and whether the
guard is on) runs the step eagerly on a side stream to warm it up, puts
the trainer's state back exactly as it was, and captures the whole step
(forward, loss, backward, verdict, update) into a graph over static input
buffers; every step copies its inputs into those buffers and replays the
graph, which reads and writes the trainer's own tensors in place. The
hyper-parameters are constant, as in JAX's closure; Adam's step count
``t`` is a device tensor. The numerics verdict never goes to the host:
SGD's kernel reads it as its veto flag, and aux and Adam's state are
gated by `torch.where`. A capture or replay that fails raises; nothing
falls back to the eager step. ``MXTPU_CUDA_GRAPH=0`` (read at
construction) gives the eager step, the counterpart of
``jax.disable_jit``; the CPU always runs eager. A capture counts as a
compile (``compile.count``/``compile.seconds``, the step records').

The planes (JAX :278-300, :514, :727): `step` and `step_many` first pass
the preemption boundary (`resilience.preempt.at_step_boundary`: the
``worker.kill`` chaos site, and a pending SIGTERM's save and
`TrainingPreempted` under a `PreemptionGuard`), outside the captured
graph; the trainer's resident parameters, BatchNorm statistics and
optimizer state are cells of the memory ledger (`observability.memory`,
model "trainer", subsystem "sharded_trainer"). No chaos corruption site
sits in the step, as in the JAX package: a host-side draw at capture
would be baked into every replay (the sites are the fused update's and
the fused step's, which run eagerly).

Memory: every graph of a trainer is captured into ONE private memory
pool, made in ``__init__``; replays run in order on one stream, so the
graphs of several input signatures (and `step`'s guarded graph beside
`step_many`'s unguarded one) share one step's working set, and each
further graph adds only its static inputs and outputs. The pool lives as
long as the trainer; the eager step frees its working set between steps
instead.

The capture runs in ``thread_local`` error mode: another thread that
allocates, pins host memory or synchronises while a step is captured
(`prefetched`'s staging thread, which `fit` runs) does not invalidate it.

Counters: ``train.step.dispatches`` counts one a step: the step's graph
replay on the card (`step_many(n)` replays the one-step graph n times:
n dispatches), or, eager, the update's one launch. The kernels' launch
counters count their wrappers' calls: on the graph step those of the
warm-up steps and of the capture. A replay calls no wrapper, so it adds
nothing to them; its launches are seen by a profiler of the device.

``compute_dtype="bfloat16"``: weights of two or more dimensions and the
floating data inputs are cast to bf16 inside the step; labels, biases,
BatchNorm gains, shifts and statistics, the optimizer state and the
gradients stay fp32.

Meshes: without a process group the trainer runs on one device, a mesh
of one (``{"dp": 1}`` by default). Inside one (`kvstore_dist.
init_distributed`, one process a card as ``tools/launch.py -n N``
starts them) the default mesh is ``{"dp": N}`` over the gang's ranks
(`mesh.make_mesh`), and the step is one program on every rank:

- every rank is given the global batch and keeps its block along the
  batch axis (or as `input_specs` split it), as JAX's device_put does;
- in training each BatchNorm normalises with the global batch's
  statistics (`ops.nn.global_batch_stats`: per-channel mean and E[x^2]
  pmean'd over dp, the 1x1-conv kernel's epilogue statistics included;
  the backward through the differentiable `mesh.pmean`), as GSPMD
  computes them over the sharded batch in JAX; the moving statistics
  follow the global ones;
- the loss is the dp mean; the gradients are averaged over dp inside the
  step, bucket by bucket (`parallel.bucketing`, ``MXTPU_BUCKET_MB``):
  one all-reduce per bucket;
- ZeRO-1 (`shard_optimizer_state`, default ``MXTPU_ZERO1`` unless
  compressing; arXiv:2004.13336, JAX :132-138, :161-183, :401-433): the
  optimizer state of a replicated parameter whose rows divide over dp
  lives as this rank's block of rows; its gradients are reduce-scattered
  (each bucket laid out as n chunks, chunk r holding block r of every
  key), the blocks updated (SGD: still ONE kernel launch, the plan's
  entries being the blocks, contiguous views of the weights), and the
  weights all-gathered; `opt_state`/`momentum` all-gather it whole;
- on the card the step stays ONE CUDA graph replay with the NCCL
  collectives captured inside it. gloo's cannot be captured: a
  graph-mode trainer over a gloo group raises, naming
  ``MXTPU_CUDA_GRAPH=0`` (`refuse_capture_over`);
- dropout: each rank folds its index into its device's generator (JAX
  folds ``axis_index`` into the key, :624-627).

`param_rules` and `input_specs` are checked against the mesh's axes; one
that shards over an axis other than dp of size > 1 (tensor or sequence
parallelism, 'tp'/'sp') raises, naming ROADMAP A6d. One process driving
several cards is not ported (`Mesh.device` raises, naming
tools/launch.py).

The compressed step (``gradient_compression={"type": "2bit",
"threshold": t}``, over `mesh.shard_map_compat`): each rank quantizes
its gradients to 2-bit codes with its error-feedback residuals, only the
packed words are all-gathered (a bucket of words a collective), and
every rank dequantizes the ranks' words, sums them in rank order and
divides by n_dp; BatchNorm keeps each rank's own statistics and the
moving statistics are pmean'd (JAX's shard_map semantics); the update is
replicated; the guard over the reconstructed gradients keeps the
residuals too; `step_many` raises. At one process it round-trips every
gradient through the quantizer, as JAX's dp=1 shard_map does.
"""
from __future__ import annotations

import contextlib
import functools
import math
import re
import time

import numpy as np
import torch
from torch.func import functional_call
from torch.utils import checkpoint as _ckpt

from .. import autograd
from .. import random as _random
from ..base import MXNetError, getenv
from ..context import resolve_device
from ..gluon.block import collect_params
from ..gluon.nn.basic_layers import Dropout
from ..ndarray import NDArray
from ..gradient_compression import dequantize_2bit, quantize_2bit
from ..observability import telemetry as _telemetry
from ..ops import SGDMomentumPlan
from ..ops.nn import global_batch_stats
from ..resilience import numerics as _num
from ..resilience.preempt import at_step_boundary
from .bucketing import GradBucketer
from .fused_step import (ZERO1_ALLGATHER_SECONDS, ZERO1_SHARD_PARAMS,
                         zero1_enabled)
from .fused_update import STEP_DISPATCHES
from .mesh import (Mesh, PartitionSpec, _gang, all_gather_, all_reduce_,
                   current_mesh, local_block, make_mesh, pmean,
                   reduce_scatter_, shard_map_compat)
from .prefetch import DevicePrefetcher, to_device

__all__ = ["ShardedTrainer", "adam_init", "adam_update",
           "refuse_capture_over", "sgd_init", "sgd_update"]


# -- the optimizers, as functions on dicts of tensors (JAX :52-93) ----------
def sgd_init(params):
    return {k: torch.zeros_like(v) for k, v in params.items()}


def sgd_update(params, grads, state, lr=0.01, momentum=0.0, wd=0.0):
    """JAX's `sgd_update`, out of place: ``m = momentum * m + (g + wd *
    p)``, ``p - lr * m``; at momentum 0 no state is read and `state`
    passes through. (The trainer runs the same update in place as one
    launch of the `fused_sgd_momentum` kernel.)"""
    new_p, new_s = {}, {}
    for k, p in params.items():
        g = grads[k] + wd * p
        if momentum:
            m = momentum * state[k] + g
            new_s[k] = m
        else:
            m = g
        new_p[k] = p - lr * m
    return new_p, (new_s if momentum else state)


def adam_init(params):
    dev = next(iter(params.values())).device if params else None
    return {"m": {k: torch.zeros_like(v) for k, v in params.items()},
            "v": {k: torch.zeros_like(v) for k, v in params.items()},
            "t": torch.zeros((), dtype=torch.int32, device=dev)}


def adam_update(params, grads, state, lr=0.001, beta1=0.9, beta2=0.999,
                eps=1e-8, wd=0.0):
    """JAX's `adam_update`, out of place, in ``torch._foreach_*`` ops: the
    step count ``t`` an int32 tensor, the bias corrections
    ``1 - beta ** t`` in fp32 on the device (no host read)."""
    keys = list(params)
    p = [params[k] for k in keys]
    g = [grads[k] for k in keys]
    if wd:
        g = torch._foreach_add(g, torch._foreach_mul(p, wd))
    t = state["t"] + 1
    tf = t.to(torch.float32)
    m = torch._foreach_add(torch._foreach_mul([state["m"][k] for k in keys],
                                              beta1),
                           torch._foreach_mul(g, 1 - beta1))
    v = torch._foreach_add(torch._foreach_mul([state["v"][k] for k in keys],
                                              beta2),
                           torch._foreach_mul(torch._foreach_mul(
                               g, 1 - beta2), g))
    mhat = torch._foreach_div(m, 1 - torch.pow(beta1, tf))
    vhat = torch._foreach_div(v, 1 - torch.pow(beta2, tf))
    denom = torch._foreach_add(torch._foreach_sqrt(vhat), eps)
    new_p = torch._foreach_sub(p, torch._foreach_div(
        torch._foreach_mul(mhat, lr), denom))
    return (dict(zip(keys, new_p)),
            {"m": dict(zip(keys, m)), "v": dict(zip(keys, v)), "t": t})


# defaults match mx.optimizer's SGD/Adam (JAX :106-110): momentum 0
_OPTIMIZERS = {"sgd": {"lr": 0.01, "momentum": 0.0, "wd": 0.0},
               "adam": {"lr": 0.001, "beta1": 0.9, "beta2": 0.999,
                        "eps": 1e-8, "wd": 0.0}}
_OPT_PARAM_ALIASES = {"learning_rate": "lr"}


# -- rematerialization (JAX :210-219 over jax.checkpoint_policies) ----------
_DOTS = ("mm", "addmm", "bmm", "baddbmm")
_DOTS_NO_BATCH = ("mm", "addmm")


def _saving(names):
    """A selective-checkpoint policy that keeps the outputs of the aten
    ops named in `names` and recomputes the rest."""
    def policy(ctx, op, *args, **kwargs):
        name = getattr(op, "__name__", "").split(".")[0]
        return (_ckpt.CheckpointPolicy.MUST_SAVE if name in names
                else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


def _everything(ctx, op, *args, **kwargs):
    return _ckpt.CheckpointPolicy.MUST_SAVE


def _nothing(ctx, op, *args, **kwargs):
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


# the jax.checkpoint_policies members that have a PyTorch analog; a JAX
# "dot" is a matrix product (dot_general), never a convolution
REMAT_POLICIES = {
    "everything_saveable": _everything,
    "nothing_saveable": _nothing,
    "dots_saveable": _saving(_DOTS),
    "checkpoint_dots": _saving(_DOTS),
    "dots_with_no_batch_dims_saveable": _saving(_DOTS_NO_BATCH),
}


def _remat_context(remat):
    """`torch.utils.checkpoint`'s ``context_fn`` for `remat`: None for
    full rematerialization (True), else selective checkpointing under
    the named policy or a policy callable. An unknown name raises
    AttributeError, as ``getattr(jax.checkpoint_policies, name)`` does."""
    if remat is True:
        return None
    if isinstance(remat, str):
        if remat not in REMAT_POLICIES:
            raise AttributeError(
                "remat policy %r has no PyTorch analog here; have %s"
                % (remat, sorted(REMAT_POLICIES)))
        policy = REMAT_POLICIES[remat]
    elif callable(remat):
        policy = remat   # (ctx, op, *args, **kwargs) -> CheckpointPolicy
    else:
        raise MXNetError("remat must be True, a policy name, or a "
                         "checkpoint policy callable")

    def keep_writes_out(ctx, op, *args, **kwargs):
        # BatchNorm writes its statistics into copies the recomputation
        # makes anew: a copy, or a write, is never served from the cache
        if op._schema.is_mutable or op is torch.ops.aten.clone.default:
            return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE
        return policy(ctx, op, *args, **kwargs)
    return functools.partial(_ckpt.create_selective_checkpoint_contexts,
                             keep_writes_out)


def _draws_random(net):
    """Whether the net draws random numbers in training (JAX's
    `needs_rng` of the traced graph): it holds a Dropout of nonzero
    rate."""
    return any(isinstance(m, Dropout) and m._rate > 0
               for m in net.modules())


def _all_finite(tensors):
    """The numerics guard's verdict over fp32 `tensors`: a 0-d device
    bool, from one multi-tensor pass (torch's GradScaler check at a scale
    of 1, whose writes leave every value as it is) where a check per
    tensor would take five launches each."""
    dev = tensors[0].device
    found = torch.zeros(1, device=dev)
    torch._amp_foreach_non_finite_check_and_unscale_(
        list(tensors), found, torch.ones(1, device=dev))
    return found[0] == 0


def _assign(dsts, srcs, ok):
    """dst := src for each pair, in place; with a verdict `ok`, only where
    it is true (the skip keeps dst bit for bit)."""
    for d, s in zip(dsts, srcs):
        d.copy_(s if ok is None else torch.where(ok, s, d))


def _row_block(t, index, n):
    """Block `index` of `n` equal blocks of rows of contiguous `t` (a
    contiguous view)."""
    k = t.shape[0] // n
    return t[index * k:(index + 1) * k]


def _fold_rank(gen, index):
    """Fold a rank's index into `gen`: a draw from it (the same on every
    rank of an equally seeded gang) and the index seed it anew."""
    base = int(torch.randint(0, 1 << 62, (1,), generator=gen,
                             device=gen.device).item())
    gen.manual_seed((base * 1000003 + index) % (1 << 63))


def refuse_capture_over(mesh, axis):
    """Raise when the collectives over `mesh`'s `axis` are gloo's, which a
    CUDA graph cannot capture (they round-trip through the host): a
    graph-mode trainer there names ``MXTPU_CUDA_GRAPH=0`` instead of
    turning eager on its own."""
    import torch.distributed as dist
    group = mesh.group(axis)
    if group is not None and dist.get_backend(group) == "gloo":
        raise MXNetError(
            "ShardedTrainer: a CUDA-graph step cannot capture gloo's "
            "collectives (host round trips); over a gloo group set "
            "MXTPU_CUDA_GRAPH=0 for the eager step, or use nccl")


class _ZeroBucket:
    """A fusion bucket of ZeRO-1 gradients laid out for reduce-scatter:
    the flat is `n` chunks, chunk r holding block r of every key's rows
    in bucket order, so rank r receives its blocks as one contiguous
    chunk (`offsets`/`sizes` within it)."""

    __slots__ = ("keys", "sizes", "offsets", "chunk")

    def __init__(self, bucket, n):
        self.keys = list(bucket.keys)
        self.sizes = [s // n for s in bucket.sizes]
        self.offsets, off = [], 0
        for size in self.sizes:
            self.offsets.append(off)
            off += size
        self.chunk = off


# eager steps on a side stream before a capture (cuDNN's and cuBLAS's
# handles, the allocator's pools and the kernels' one-time set-up)
_WARMUP = 2


class _Captured:
    """One captured step: the graph and its static inputs and outputs."""

    __slots__ = ("graph", "inputs", "loss", "ok")

    def __init__(self, graph, inputs, loss, ok):
        self.graph, self.inputs, self.loss, self.ok = graph, inputs, loss, ok


class ShardedTrainer:
    """Trainer of a port `HybridBlock` under a loss, on one device or over
    a process-spanning data-parallel mesh (module note), with JAX's
    arguments in JAX's order (and the port's `device`).

    ``loss(outputs, *labels)`` returns per-sample losses (None: the net's
    outputs are the loss). `optimizer` is "sgd" or "adam"; `aux_mode`
    "train" (BatchNorm on batch statistics, running statistics written)
    or "predict" (running statistics used, none written); `remat` True,
    the name of a policy in `REMAT_POLICIES` or a selective-checkpoint
    policy callable. Entry point: runs on CUDA unless ``device="cpu"`` (or
    a CPU mesh) is given, and raises without a card."""

    def __init__(self, net, loss, optimizer="sgd", optimizer_params=None,
                 mesh=None, param_rules=None, batch_axis=0,
                 data_names=("data",), label_names=("label",),
                 aux_mode="train", compute_dtype=None,
                 gradient_compression=None, shard_optimizer_state=None,
                 remat=False, input_specs=None, device=None):
        if shard_optimizer_state is None:
            # MXTPU_ZERO1, except under compression, whose step keeps
            # replicated state (an env default never becomes an error)
            shard_optimizer_state = zero1_enabled() and \
                gradient_compression is None
        self._gc = None
        if gradient_compression is not None:
            gc = dict(gradient_compression)
            if gc.get("type", "2bit") != "2bit":
                raise MXNetError("unsupported gradient compression type %r"
                                 % gc.get("type"))
            if param_rules:
                raise MXNetError("gradient_compression requires a pure "
                                 "data-parallel mesh (no param_rules)")
            if shard_optimizer_state:
                raise MXNetError(
                    "shard_optimizer_state is not supported with "
                    "gradient_compression (the compressed step keeps "
                    "replicated optimizer state around its per-rank "
                    "residual exchange)")
            self._gc = {"threshold": float(gc.get("threshold", 0.5))}
        self._shard_opt = bool(shard_optimizer_state)
        if aux_mode not in ("train", "predict"):
            raise MXNetError("aux_mode must be 'train' or 'predict', got %r"
                             % (aux_mode,))
        if optimizer not in _OPTIMIZERS:
            raise MXNetError("ShardedTrainer: unknown optimizer %r (have %s)"
                             % (optimizer, sorted(_OPTIMIZERS)))
        hp = dict(optimizer_params or {})
        for old, new in _OPT_PARAM_ALIASES.items():
            if old in hp:
                hp[new] = hp.pop(old)
        unknown = sorted(set(hp) - set(_OPTIMIZERS[optimizer]))
        if unknown:
            raise MXNetError("ShardedTrainer: unknown %s parameters %s"
                             % (optimizer, unknown))
        self._optimizer = optimizer
        self._hp = {**_OPTIMIZERS[optimizer], **hp}
        if isinstance(compute_dtype, str):
            compute_dtype = getattr(torch, compute_dtype, None)
        if compute_dtype is not None and not (
                isinstance(compute_dtype, torch.dtype)
                and compute_dtype.is_floating_point):
            raise MXNetError("compute_dtype must name a floating dtype")
        self._cd = compute_dtype

        # the mesh: given, the use_mesh scope's, the gang's ranks on 'dp'
        # inside a process group, or one device
        if mesh is None:
            mesh = current_mesh()
        if mesh is None:
            mesh = make_mesh() if _gang() is not None else \
                make_mesh({"dp": 1}, devices=[resolve_device(device)])
        if not isinstance(mesh, Mesh):
            raise MXNetError("mesh must be a parallel.mesh.Mesh, got %r"
                             % (mesh,))
        self._mesh = mesh
        self._dev = resolve_device(mesh.device)     # this rank's device
        if device is not None and resolve_device(device) != self._dev:
            raise MXNetError("device %s is not the mesh's device %s"
                             % (device, self._dev))
        self._data_names = tuple(data_names)
        self._label_names = tuple(label_names)
        self._batch_axis = int(batch_axis)
        self._param_rules = []
        for pattern, spec in param_rules or []:
            self._param_rules.append((re.compile(pattern), mesh.check_spec(
                spec, "param_rules %r" % (pattern,))))
        self._input_specs = {}
        names = self._data_names + self._label_names
        for name, spec in (input_specs or {}).items():
            if name not in names:
                raise MXNetError("input_specs: %r is not one of the "
                                 "inputs %s" % (name, names))
            self._input_specs[name] = mesh.check_spec(
                spec, "input_specs[%r]" % (name,))
        self._dp = self._dp_axis_name()
        self._n_dp = mesh.shape[self._dp]
        self._dist = mesh.spans_processes
        self._refuse_other_axes()
        self._train = aux_mode == "train"
        self._remat = bool(remat)
        self._remat_ctx = _remat_context(remat) if remat else None
        self._net = net
        self._loss = loss
        self._needs_rng = _draws_random(net)

        # private copies, as the JAX trainer's `_shard_param` makes them
        paths = collect_params(net)
        params = dict(net.named_parameters())
        buffers = dict(net.named_buffers())
        self._paths = paths
        self._params = {n: params[p].detach().to(self._dev).clone()
                        .contiguous() for n, p in paths.items()
                        if p in params}
        self._aux = {n: buffers[p].detach().to(self._dev).clone()
                     for n, p in paths.items() if p in buffers}
        # ZeRO-1: the optimizer state of a replicated parameter whose rows
        # divide over dp lives as this rank's block of rows (JAX :401-433)
        n = self._n_dp
        self._zero = [k for k, v in self._params.items()
                      if self._shard_opt and
                      self._spec_for(k) == PartitionSpec() and
                      v.dim() >= 1 and v.shape[0] % n == 0 and
                      v.shape[0] >= n]
        if self._shard_opt:
            ZERO1_SHARD_PARAMS.set(len(self._zero))
        zero = self._zero_set = set(self._zero)
        # what the update writes: a parameter, or its block of rows
        self._upd = {k: (_row_block(v, self._mesh.axis_index(self._dp), n)
                         if k in zero else v)
                     for k, v in self._params.items()}
        if optimizer == "sgd":
            # momenta exist at momentum 0 too: m' = g there, the same update
            self._opt_state = {k: torch.zeros_like(v, dtype=torch.float32)
                               for k, v in self._upd.items()}
            # the update of these tensors, set up once: only gradients
            # change. Under ZeRO-1 the plan's entries are the blocks
            self._plan = SGDMomentumPlan(self._upd.values(),
                                         self._opt_state.values())
        else:
            self._opt_state = adam_init(self._upd)
        self._graph_on = self._dev.type == "cuda" and \
            getenv("MXTPU_CUDA_GRAPH", True)
        if self._graph_on and self._dist:
            refuse_capture_over(mesh, self._dp)
        self._graphs = {}
        # one memory pool for every graph of this trainer (module note)
        self._pool = torch.cuda.graph_pool_handle() if self._graph_on \
            else None
        self._plan_exchange()
        if self._gc is not None:
            # this rank's error-feedback residuals (its stream's slice of
            # JAX's (n_dp, ...) bank; JAX :286-294)
            self._gc_residuals = {k: torch.zeros_like(v) for k, v in
                                  self._params.items()}
        if self._dist and self._needs_rng:
            # each rank draws its own stream (JAX folds axis_index into
            # the key, :624-627)
            _fold_rank(_random.generator(self._dev),
                       self._mesh.axis_index(self._dp))
        self._step_count = 0
        self._register_ledger_bytes()

    def _register_ledger_bytes(self):
        """The memory ledger's cells for the trainer's resident state
        (JAX :280-300): params, aux and optimizer state, this rank's
        tensors (ZeRO-1 blocks where sharded)."""
        from ..observability import memory as _memory
        if not _memory.enabled():
            return
        _memory.set_bytes("trainer", "sharded_trainer", "params",
                          _memory.nbytes(self._params))
        if self._aux:
            _memory.set_bytes("trainer", "sharded_trainer", "aux",
                              _memory.nbytes(self._aux))
        opt_bytes = _memory.nbytes(self._opt_state)
        if opt_bytes:
            _memory.set_bytes("trainer", "sharded_trainer", "opt_state",
                              opt_bytes)

    # -- layouts on the mesh ------------------------------------------------
    def _dp_axis_name(self):
        names = self._mesh.axis_names
        return "dp" if "dp" in names else names[0]

    def _spec_for(self, name):
        for pattern, spec in self._param_rules:
            if pattern.search(name):
                return spec
        return PartitionSpec()

    def _batch_axis_for(self, ndim):
        """The batch axis of an input of rank `ndim`: inputs of lower rank
        than batch_axis + 1 (e.g. (B,) labels beside batch_axis=1 TNC
        data) batch on dim 0."""
        ax = self._batch_axis
        if ndim is not None and ax >= ndim:
            ax = 0
        return ax

    def _input_spec(self, name, ndim):
        over = self._input_specs.get(name)
        if over is not None:
            return over
        ax = self._batch_axis_for(ndim)
        return PartitionSpec(*([None] * ax + [self._dp_axis_name()]))

    def _refuse_other_axes(self):
        """A `param_rules` or `input_specs` entry that shards over an axis
        other than dp of size > 1 is tensor or sequence sharding, which is
        not ported (ROADMAP A6d)."""
        entries = [("param_rules %r" % (p.pattern,), spec)
                   for p, spec in self._param_rules] + \
            [("input_specs[%r]" % (n,), spec)
             for n, spec in self._input_specs.items()]
        for what, spec in entries:
            for axis in spec.axes():
                if axis != self._dp and self._mesh.shape[axis] > 1:
                    raise MXNetError(
                        "ShardedTrainer: %s shards over %r (size %d): "
                        "tensor and sequence sharding are not ported "
                        "(ROADMAP A6d); the port shards the batch over %r "
                        "only" % (what, axis, self._mesh.shape[axis],
                                  self._dp))

    def _check_layout(self, name, x):
        """Each dimension an input spec splits must divide by the mesh
        axes it is split over (JAX's sharding rule)."""
        for dim, part in enumerate(self._input_spec(name, x.dim())):
            if part is None:
                continue
            ways = math.prod(self._mesh.shape[a] for a in (
                part if isinstance(part, tuple) else (part,)))
            if dim >= x.dim() or x.shape[dim] % ways:
                raise MXNetError("input %r of shape %s cannot split dim %d "
                                 "%d ways" % (name, tuple(x.shape), dim,
                                              ways))

    def _plan_exchange(self):
        """The gradient exchange's fusion buckets (`parallel.bucketing`,
        ``MXTPU_BUCKET_MB``), planned once over the parameters in their
        order: the replicated parameters' (all-reduced) and, under
        ZeRO-1, the sharded ones' (reduce-scattered, `_ZeroBucket`). The
        compressed step's words are planned at its first step."""
        self._rep_buckets, self._zero_buckets = [], []
        self._word_buckets = None
        if not self._dist:
            return
        bucketer = GradBucketer()

        def plan(keys):
            items = tuple((k, tuple(self._params[k].shape), torch.float32,
                           -pos, False) for pos, k in enumerate(keys))
            return bucketer.plan(items) if items else []
        self._rep_buckets = plan([k for k in self._params
                                  if k not in self._zero_set])
        self._zero_buckets = [_ZeroBucket(b, self._n_dp)
                              for b in plan(self._zero)]

    # -- the step body --------------------------------------------------------
    def _stage(self, batch_and_labels):
        """The step's inputs on this rank's device: every rank is given
        the global batch and keeps its block along the batch axis (or as
        `input_specs` split it), as JAX's device_put places it."""
        names = self._data_names + self._label_names
        if len(batch_and_labels) != len(names):
            raise MXNetError("step expects %s" % (names,))
        inputs = []
        for name, x in zip(names, batch_and_labels):
            if isinstance(x, NDArray):
                x = x._data
            elif not isinstance(x, torch.Tensor):
                x = torch.as_tensor(np.asarray(x))
            self._check_layout(name, x)
            if self._dist:
                x = local_block(self._mesh, self._input_spec(name, x.dim()),
                                x)
            inputs.append(to_device(x, self._dev).contiguous())
        return inputs

    def _forward(self, leaves, aux, data, labels):
        """The loss of one forward: BatchNorm writes its new running
        statistics into `aux` (in training mode)."""
        cd = self._cd
        state = {self._paths[n]: (v.to(cd) if cd is not None and
                                  v.dim() >= 2 else v)
                 for n, v in zip(self._params, leaves)}
        state.update({self._paths[n]: v for n, v in aux.items()})
        outs = functional_call(self._net, state, tuple(data))
        loss = outs if self._loss is None else self._loss(outs, *labels)
        if isinstance(loss, (list, tuple)):
            loss = loss[0]
        if isinstance(loss, NDArray):   # a loss records as an NDArray
            loss = loss._data
        return loss.float().mean()

    def _remat_forward(self, leaves, aux, data, labels):
        """`_forward` under `torch.utils.checkpoint`: the backward
        recomputes the forward (or what the policy does not keep). Each
        run writes BatchNorm's statistics into copies of its own, and the
        first run's are kept, so the recomputation changes nothing; a net
        that draws random numbers recomputes with the draws of its first
        run (the package generator's state, stashed and put back)."""
        names = list(aux)
        gen = _random.generator(self._dev) if self._needs_rng else None
        if gen is not None and self._dev.type == "cuda" and \
                torch.cuda.is_current_stream_capturing():
            raise MXNetError(
                "remat of a net that draws random numbers cannot run in a "
                "captured step (its generator state is read on the host); "
                "set MXTPU_CUDA_GRAPH=0")
        first = []      # the generator's state before the first run

        def run(*leaves):
            again = bool(first)
            if not again:
                first.append(None if gen is None else gen.get_state())
            elif gen is not None:
                after = gen.get_state()
                gen.set_state(first[0])
            work = {n: aux[n].clone() for n in names}
            # the recomputation runs in the backward, on autograd's device
            # thread for CUDA tensors: the package's thread-local modes
            # (recording, training) are set here again
            with autograd.record(train_mode=self._train):
                loss = self._forward(leaves, work, data, labels)
            if again and gen is not None:
                gen.set_state(after)
            return (loss,) + tuple(work[n] for n in names)

        kwargs = {} if self._remat_ctx is None \
            else {"context_fn": self._remat_ctx}
        loss, *new = _ckpt.checkpoint(run, *leaves, use_reentrant=False,
                                      preserve_rng_state=False, **kwargs)
        with torch.no_grad():
            for n, v in zip(names, new):
                aux[n].copy_(v)
        return loss

    def _loss_and_grads(self, inputs, aux):
        """Forward and backward on this rank's block: (local loss,
        gradients in `_params` order). Over a process-spanning dp axis in
        training, BatchNorm normalises with the global batch's statistics
        (`ops.nn.global_batch_stats`), except in the compressed step,
        whose BatchNorm keeps each rank's own (JAX's shard_map)."""
        nd = len(self._data_names)
        data, labels = inputs[:nd], inputs[nd:]
        cd = self._cd
        if cd is not None:
            data = [x.to(cd) if x.is_floating_point() else x for x in data]
        forward = self._remat_forward if self._remat else self._forward
        scope = global_batch_stats(functools.partial(
            pmean, axis_name=self._dp, mesh=self._mesh)) \
            if self._dist and self._train and self._gc is None \
            else contextlib.nullcontext()
        with scope, autograd.record(train_mode=self._train):
            leaves = [p.detach().requires_grad_(True)
                      for p in self._params.values()]
            loss = forward(leaves, aux, data, labels)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g.contiguous()
                 for p, g in zip(leaves, grads)]
        return loss.detach(), grads

    def _exchange(self, grads):
        """The gradients' mean over dp, bucket by bucket: a replicated
        parameter's whole (all-reduce), a ZeRO-1 parameter's block of
        rows, this rank's (reduce-scatter of the bucket's chunked
        layout). Returns them in `_params` order."""
        group, n = self._mesh.group(self._dp), self._n_dp
        g = dict(zip(self._params, grads))
        out = {}
        for b in self._rep_buckets:
            flat = all_reduce_(b.pack([g[k] for k in b.keys]), group)
            flat.div_(n)
            out.update(zip(b.keys, b.unpack(flat)))
        for zb in self._zero_buckets:
            whole = torch.cat([g[k].reshape(n, s) for k, s in
                               zip(zb.keys, zb.sizes)], dim=1).reshape(-1)
            chunk = reduce_scatter_(whole.new_empty(zb.chunk), whole, group)
            chunk.div_(n)
            for k, off, size in zip(zb.keys, zb.offsets, zb.sizes):
                out[k] = chunk[off:off + size].view(self._upd[k].shape)
        return [out[k] for k in self._params]

    def _gather_weights(self):
        """ZeRO-1: every rank's updated blocks of rows, all-gathered into
        the whole parameters."""
        group, n = self._mesh.group(self._dp), self._n_dp
        for zb in self._zero_buckets:
            mine = torch.cat([self._upd[k].reshape(-1) for k in zb.keys])
            whole = all_gather_(mine.new_empty(n * zb.chunk), mine, group)
            rows = whole.view(n, zb.chunk)
            for k, off, size in zip(zb.keys, zb.offsets, zb.sizes):
                self._params[k].view(n, size).copy_(rows[:, off:off + size])

    def _verdict(self, grads):
        """The numerics guard's verdict over the exchanged gradients: a
        0-d device bool, the same on every rank (under ZeRO-1 each rank
        sees its blocks only, so the ranks' counts of non-finite verdicts
        are summed)."""
        ok = _all_finite(grads)
        if self._dist and self._zero:
            bad = all_reduce_((~ok).to(torch.float32).reshape(1),
                              self._mesh.group(self._dp))
            ok = bad[0] == 0
        return ok

    def _update(self, grads, ok):
        hp = self._hp
        if self._optimizer == "sgd":
            self._plan(grads, hp["lr"], hp["momentum"], hp["wd"], 1.0, None,
                       ok)
            return
        state = self._opt_state
        new_p, new_s = adam_update(self._upd, dict(zip(self._upd, grads)),
                                   state, **hp)
        keys = list(self._upd)
        _assign([self._upd[k] for k in keys] +
                [state["m"][k] for k in keys] +
                [state["v"][k] for k in keys] + [state["t"]],
                [new_p[k] for k in keys] + [new_s["m"][k] for k in keys] +
                [new_s["v"][k] for k in keys] + [new_s["t"]], ok)

    def _step_body(self, inputs, guard):
        """One step on `inputs`, in place: (loss, verdict). Guarded, a step
        whose gradients are not all finite writes nothing (JAX :387-394);
        unguarded, the verdict is None. Across processes the loss is the
        dp mean and the gradients are exchanged before the update."""
        aux = {n: v.clone() for n, v in self._aux.items()} if guard \
            else self._aux
        if self._gc is not None:
            loss, grads, residuals = self._compressed_grads(inputs, aux)
        else:
            loss, grads = self._loss_and_grads(inputs, aux)
            if self._dist:
                loss = pmean(loss, self._dp, self._mesh)
                grads = self._exchange(grads)
        ok = self._verdict(grads) if guard else None
        self._update(grads, ok)
        if self._dist and self._zero:
            self._gather_weights()
        if self._gc is not None:
            _assign(self._gc_residuals.values(), residuals, ok)
        if guard:
            _assign(self._aux.values(), aux.values(), ok)
        return loss, ok

    # -- the compressed step (JAX _build_step_compressed :603-720) -----------
    def _compressed_grads(self, inputs, aux):
        """The compressed exchange over `shard_map_compat` on dp: each rank
        2-bit quantizes its gradients with its error-feedback residuals,
        the packed words alone are all-gathered (one collective a fusion
        bucket of words), and each rank dequantizes every rank's words,
        sums them in rank order and divides by n_dp. BatchNorm keeps each
        rank's own statistics and the moving statistics are pmean'd.
        Returns (loss, gradients, the new residuals) without writing the
        residuals (the guard decides)."""
        mesh, dp, n = self._mesh, self._dp, self._n_dp
        thr = self._gc["threshold"]
        rep = PartitionSpec()

        def shard_grads(inputs, aux, residuals):
            loss, grads = self._loss_and_grads(inputs, aux)
            words, new_res = [], []
            for g, r in zip(grads, residuals):
                w, nr = quantize_2bit(g, r, thr)
                words.append(w)
                new_res.append(nr)
            gathered = self._gather_words(words)
            out = []
            for g, parts in zip(grads, gathered):
                tot = dequantize_2bit(parts[0], g.shape, thr, g.dtype)
                for p in parts[1:]:
                    tot = tot + dequantize_2bit(p, g.shape, thr, g.dtype)
                out.append(tot / n)
            loss = pmean(loss, dp)
            if self._train:
                with torch.no_grad():
                    for v in aux.values():
                        v.copy_(pmean(v, dp))
            return loss, out, new_res

        # the inputs are this rank's blocks already, the residuals its own
        return shard_map_compat(shard_grads, mesh, (rep, rep, rep),
                                (rep, rep, rep))(
            inputs, aux, list(self._gc_residuals.values()))

    def _gather_words(self, words):
        """Every rank's int32 words of each gradient, in rank order:
        [per key, [per rank, words]]."""
        if self._word_buckets is None:
            items = tuple((k, (int(w.numel()),), torch.int32, -pos, False)
                          for pos, (k, w) in enumerate(zip(self._params,
                                                           words)))
            self._word_buckets = GradBucketer().plan(items)
        group, n = self._mesh.group(self._dp), self._n_dp
        w = dict(zip(self._params, words))
        out = {}
        for b in self._word_buckets:
            mine = b.pack([w[k] for k in b.keys])
            whole = all_gather_(mine.new_empty(n * b.total), mine, group)
            ranks = [b.unpack(r) for r in whole.view(n, b.total).unbind(0)]
            for j, k in enumerate(b.keys):
                out[k] = [ranks[r][j] for r in range(n)]
        return [out[k] for k in self._params]

    # -- the captured step ----------------------------------------------------
    def _state_tensors(self):
        opt = self._opt_state
        if self._optimizer == "adam":
            opt = [*opt["m"].values(), *opt["v"].values(), opt["t"]]
        else:
            opt = list(opt.values())
        res = list(self._gc_residuals.values()) if self._gc is not None \
            else []
        return [*self._params.values(), *self._aux.values(), *opt, *res]

    def _capture(self, inputs, guard):
        """Warm the step up eagerly on a side stream, put the trainer's
        state back as it was, and capture the step into a CUDA graph over
        static copies of `inputs`."""
        dev = self._dev
        t_capture = time.perf_counter()
        static = [x.clone() for x in inputs]
        state = self._state_tensors()
        saved = [t.clone() for t in state]
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(_WARMUP):
                self._step_body(static, guard)
        torch.cuda.current_stream(dev).wait_stream(side)
        _assign(state, saved, None)
        del saved
        graph = torch.cuda.CUDAGraph()
        if self._needs_rng:
            graph.register_generator_state(_random.generator(dev))
        try:
            with torch.cuda.graph(graph, pool=self._pool,
                                  capture_error_mode="thread_local"):
                loss, ok = self._step_body(static, guard)
        except Exception as err:
            raise MXNetError("CUDA graph capture of the train step failed "
                             "(MXTPU_CUDA_GRAPH=0 runs it eagerly): %s"
                             % (err,)) from err
        # the warm-up and the capture are this path's compile
        _telemetry.note_compile(time.perf_counter() - t_capture)
        return _Captured(graph, static, loss, ok)

    def _graph_for(self, inputs, guard):
        """The captured step of this input signature, its static inputs
        holding `inputs`."""
        key = (guard,) + tuple((tuple(x.shape), x.dtype) for x in inputs)
        cap = self._graphs.get(key)
        if cap is None:
            cap = self._graphs[key] = self._capture(inputs, guard)
        else:
            for s, x in zip(cap.inputs, inputs):
                s.copy_(x)
        return cap

    @staticmethod
    def _replay(cap):
        cap.graph.replay()
        STEP_DISPATCHES.inc()

    def step(self, *batch_and_labels):
        """One train step; returns the scalar loss (a device tensor).

        With the numerics guard on (``MXTPU_NUMERICS``, default on) a step
        whose gradients are not all finite is skipped: parameters,
        optimizer state and BatchNorm statistics stay bit-identical, and
        the verdict is recorded as where="step" without a host read. On
        the card one graph replay (one ``train.step.dispatches``). A
        pending preemption checkpoints and stops first
        (`resilience.preempt.at_step_boundary`)."""
        at_step_boundary()
        inputs = self._stage(batch_and_labels)
        guard = _num.enabled()
        if self._graph_on:
            cap = self._graph_for(inputs, guard)
            self._replay(cap)
            loss = cap.loss.clone()
            ok = cap.ok.clone() if guard else None
        else:
            loss, ok = self._step_body(inputs, guard)
            STEP_DISPATCHES.inc()
        if guard:
            _num.record_flag(ok, where="step")
        self._step_count += 1
        return loss

    def step_many(self, *batch_and_labels, n_steps, unroll=1):
        """`n_steps` train steps on the one given batch, with no host
        synchronisation; returns the (n_steps,) losses on the device. On
        the card the one-step graph (unguarded) is replayed n_steps times,
        each loss copied into the losses' buffer: n_steps dispatches.
        `unroll` (JAX's scan unroll) is accepted and changes nothing. The
        steps run unguarded; with the guard on, one verdict for the window
        (every loss and every final parameter finite) is recorded as
        where="window", as the JAX `step_many` does (:483-494)."""
        if self._gc is not None:
            raise MXNetError("step_many: not supported with gradient "
                             "compression; call step() per batch")
        if int(unroll) < 1:
            raise MXNetError("step_many: unroll must be >= 1")
        at_step_boundary()
        inputs = self._stage(batch_and_labels)
        n = int(n_steps)
        losses = torch.empty(n, dtype=torch.float32, device=self._dev)
        cap = self._graph_for(inputs, False) if self._graph_on else None
        for i in range(n):
            if cap is not None:
                self._replay(cap)
                losses[i].copy_(cap.loss)
            else:
                losses[i] = self._step_body(inputs, False)[0]
                STEP_DISPATCHES.inc()
        if _num.enabled():
            _num.record_flag(_all_finite([losses, *self._params.values()]),
                             where="window")
        self._step_count += n
        return losses

    # -- input staging and the fit loop --------------------------------------
    def prefetched(self, data_iter, depth=2):
        """An iterable of batches (DataBatch objects or (data..., label...)
        tuples) wrapped into a host-to-device double buffer: a background
        thread pulls and stages batch k+1..k+depth, through pinned memory
        on a side stream, while step k runs. Yields lists of NDArrays on
        the trainer's device, in input order."""
        dev = self._dev

        def stage(batch):
            if hasattr(batch, "data") and hasattr(batch, "label"):
                parts = list(batch.data) + list(batch.label or [])
            elif isinstance(batch, (tuple, list)):
                parts = list(batch)
            else:
                parts = [batch]
            return [NDArray(to_device(x, dev)) for x in parts]

        return DevicePrefetcher(data_iter, stage, depth, device=dev)

    def fit(self, data_iter, num_epochs=1, prefetch_depth=2,
            batch_end_callback=None):
        """Epochs over a DataIter (reset before each) through `prefetched`
        and `step`; returns the last loss."""
        loss = None
        if num_epochs > 1 and not hasattr(data_iter, "reset"):
            raise MXNetError(
                "fit(num_epochs=%d) needs a resettable DataIter; a plain "
                "iterator or generator is exhausted after one epoch"
                % num_epochs)
        for epoch in range(num_epochs):
            if hasattr(data_iter, "reset"):
                data_iter.reset()
            pf = self.prefetched(data_iter, depth=prefetch_depth)
            try:
                for nbatch, staged in enumerate(pf):
                    loss = self.step(*staged)
                    if batch_end_callback is not None:
                        batch_end_callback(epoch, nbatch, loss)
            finally:
                pf.close()
        return loss

    # -- state --------------------------------------------------------------
    @property
    def params(self):
        """Copies of the fp32 master parameters, by Gluon name."""
        return {k: v.clone() for k, v in self._params.items()}

    @property
    def aux(self):
        """Copies of the BatchNorm running statistics, by Gluon name."""
        return {k: v.clone() for k, v in self._aux.items()}

    @property
    def momentum(self):
        """Copies of SGD's momenta, by parameter name, whole (under
        ZeRO-1 across processes, all-gathered: every rank calls it)."""
        if self._optimizer != "sgd":
            raise MXNetError("momentum is SGD's state; see opt_state")
        return self._whole_opt_state()

    @property
    def opt_state(self):
        """Copies of the optimizer state, whole: SGD's momenta by name, or
        Adam's {"m": ..., "v": ..., "t": int32 step count} (under ZeRO-1
        across processes, all-gathered: every rank calls it)."""
        return self._whole_opt_state()

    def _whole(self, k, t):
        """A copy of optimizer-state tensor `t` of parameter `k`, whole:
        a ZeRO-1 block of rows all-gathered over dp."""
        if not (self._dist and k in self._zero_set):
            return t.clone()
        out = t.new_empty(self._params[k].shape)
        return all_gather_(out, t, self._mesh.group(self._dp))

    def _whole_opt_state(self):
        t0 = time.perf_counter()
        st = self._opt_state
        if self._optimizer == "sgd":
            out = {k: self._whole(k, v) for k, v in st.items()}
        else:
            out = {"m": {k: self._whole(k, v) for k, v in st["m"].items()},
                   "v": {k: self._whole(k, v) for k, v in st["v"].items()},
                   "t": st["t"].clone()}
        if self._dist and self._zero:
            ZERO1_ALLGATHER_SECONDS.observe(time.perf_counter() - t0)
        return out

    def _global_state(self):
        """The whole state on the host, as a checkpoint saves it (a
        collective across processes): {"params", "aux", "opt_state"
        (whole, ZeRO-1's blocks gathered), "step", and with compression
        "gc_residuals" (each parameter's bank of every rank's residual,
        (n_dp, ...), JAX's layout)}, each tensor by its parameter's block
        path (``features.0.weight``), which a net rebuilt in another
        process, or beside others in this one, keeps."""
        def host(tree):
            return {self._paths.get(k, k): host(v)
                    for k, v in tree.items()} \
                if isinstance(tree, dict) else tree.detach().cpu()
        state = {"params": host(self._params), "aux": host(self._aux),
                 "opt_state": host(self._whole_opt_state()),
                 "step": int(self._step_count)}
        if self._gc is not None:
            group, n = self._mesh.group(self._dp), self._n_dp
            state["gc_residuals"] = host({
                k: all_gather_(r.new_empty((n,) + tuple(r.shape)), r, group)
                for k, r in self._gc_residuals.items()})
        return state

    def _global_shapes(self):
        """`_global_state`'s structure with shapes for tensors (no
        collective)."""
        p = self._paths
        whole = {p[k]: tuple(v.shape) for k, v in self._params.items()}
        opt = whole if self._optimizer == "sgd" else \
            {"m": whole, "v": whole, "t": ()}
        out = {"params": whole,
               "aux": {p[k]: tuple(v.shape) for k, v in self._aux.items()},
               "opt_state": opt, "step": None}
        if self._gc is not None:
            out["gc_residuals"] = {k: (self._n_dp,) + s
                                   for k, s in whole.items()}
        return out

    def _load_global_state(self, state):
        """Write a state of `_global_state`'s form into this trainer, in
        place (the CUDA graphs and the SGD plan hold these tensors): each
        rank takes its ZeRO-1 blocks and its slice of each residual bank
        (whose leading axis must be this mesh's n_dp)."""
        index, n = self._mesh.axis_index(self._dp), self._n_dp
        p = self._paths

        def put(k, dst, src):
            src = src.to(dst.device, dst.dtype)
            if self._dist and k in self._zero_set:
                src = _row_block(src, index, n)
            dst.copy_(src)
        with torch.no_grad():
            for k, v in self._params.items():
                v.copy_(state["params"][p[k]].to(v.device, v.dtype))
            for k, v in self._aux.items():
                v.copy_(state["aux"][p[k]].to(v.device, v.dtype))
            opt = state.get("opt_state")
            if opt:
                st = self._opt_state
                if self._optimizer == "sgd":
                    for k, v in st.items():
                        put(k, v, opt[p[k]])
                else:
                    for part in ("m", "v"):
                        for k, v in st[part].items():
                            put(k, v, opt[part][p[k]])
                    st["t"].copy_(opt["t"].to(st["t"].device))
            if self._gc is not None and "gc_residuals" in state:
                for k, r in self._gc_residuals.items():
                    r.copy_(state["gc_residuals"][p[k]][index].to(r.device))
        self._step_count = int(state["step"])

    def copy_params_to_net(self):
        """Write the trained values back into the net's parameters and
        buffers."""
        self._net.load_parameters({self._paths[n]: v for n, v in
                                   {**self._params, **self._aux}.items()})
