"""`ShardedTrainer` on one device (counterpart of
mxnet_tpu/parallel/data_parallel.py:115, at ``dp=1``).

A step is the JAX step body (data_parallel.py:365-397) in eager PyTorch:
forward through the `nn.Module` (with `torch.func.functional_call`, so
the trainer's own copies of the parameters and BatchNorm statistics take
the module's place), the loss ``mean(outs.float())``, gradients with
respect to the fp32 master parameters, and the momentum-SGD update, all
of the step's tensors in ONE launch of the hand-written
`ops.fused_sgd_momentum` kernel (`sgd_update`, data_parallel.py:56, is
that kernel's function at ``rescale=1``). The trainer owns its
parameters and momenta and updates them in place, where the JAX step
donates its buffers.

``compute_dtype="bfloat16"``: weights of two or more dimensions and the
floating data inputs are cast to bf16 inside the step; labels, biases,
BatchNorm gains, shifts and statistics, the momenta and the gradients
stay fp32.

Not ported yet: "adam", `remat`, meshes and `param_rules` beyond one
device, gradient compression, ZeRO-1, `fit` and its prefetcher.
"""
from __future__ import annotations

import torch
from torch.func import functional_call

from ..base import MXNetError
from ..context import resolve_device
from ..gluon.block import collect_params
from ..ops import fused_sgd_momentum
from ..resilience import numerics as _num

__all__ = ["ShardedTrainer"]

# mx.optimizer's SGD defaults (data_parallel.py:106)
_SGD_DEFAULTS = {"lr": 0.01, "momentum": 0.0, "wd": 0.0}
_OPT_PARAM_ALIASES = {"learning_rate": "lr"}


class ShardedTrainer:
    """One-device trainer of a port `HybridBlock` under a loss.

    ``loss(outputs, *labels)`` returns per-sample losses. Entry point:
    runs on CUDA unless ``device="cpu"`` is given, and raises without a
    card."""

    def __init__(self, net, loss, optimizer="sgd", optimizer_params=None,
                 data_names=("data",), label_names=("label",),
                 aux_mode="train", compute_dtype=None, device=None):
        self._dev = resolve_device(device)
        if optimizer != "sgd":
            raise MXNetError("ShardedTrainer: the port has optimizer 'sgd' "
                             "only, got %r" % (optimizer,))
        if aux_mode != "train":
            raise MXNetError("ShardedTrainer: the port trains with "
                             "aux_mode='train' only, got %r" % (aux_mode,))
        hp = dict(optimizer_params or {})
        for old, new in _OPT_PARAM_ALIASES.items():
            if old in hp:
                hp[new] = hp.pop(old)
        unknown = sorted(set(hp) - set(_SGD_DEFAULTS))
        if unknown:
            raise MXNetError("ShardedTrainer: unknown sgd parameters %s"
                             % unknown)
        self._hp = {**_SGD_DEFAULTS, **hp}
        if isinstance(compute_dtype, str):
            compute_dtype = getattr(torch, compute_dtype, None)
        if compute_dtype is not None and not (
                isinstance(compute_dtype, torch.dtype)
                and compute_dtype.is_floating_point):
            raise MXNetError("compute_dtype must name a floating dtype")
        self._cd = compute_dtype
        self._net = net
        self._loss = loss
        self._data_names = tuple(data_names)
        self._label_names = tuple(label_names)

        # private copies, as the JAX trainer's `_shard_param` makes them
        names = collect_params(net)
        params = dict(net.named_parameters())
        buffers = dict(net.named_buffers())
        self._paths = names
        self._params = {n: params[p].detach().to(self._dev).clone()
                        .contiguous() for n, p in names.items()
                        if p in params}
        self._aux = {n: buffers[p].detach().to(self._dev).clone()
                     for n, p in names.items() if p in buffers}
        # momenta exist at momentum 0 too: m' = g there, the same update
        self._mom = {n: torch.zeros_like(v, dtype=torch.float32)
                     for n, v in self._params.items()}

    # -- the step body ----------------------------------------------------
    def _stage(self, batch_and_labels):
        names = self._data_names + self._label_names
        if len(batch_and_labels) != len(names):
            raise MXNetError("step expects %s" % (names,))
        return [torch.as_tensor(x).to(self._dev) for x in batch_and_labels]

    def _loss_and_grads(self, inputs, aux):
        """Forward and backward: (loss, gradients in `_params` order).
        BatchNorm writes its new running statistics into `aux`."""
        nd = len(self._data_names)
        data, labels = inputs[:nd], inputs[nd:]
        cd = self._cd
        if cd is not None:
            data = [x.to(cd) if x.is_floating_point() else x for x in data]
        self._net.train()
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_(True)
                      for p in self._params.values()]
            state = {self._paths[n]: (v.to(cd) if cd is not None and
                                      v.dim() >= 2 else v)
                     for n, v in zip(self._params, leaves)}
            state.update({self._paths[n]: v for n, v in aux.items()})
            outs = functional_call(self._net, state, tuple(data))
            loss = self._loss(outs, *labels).float().mean()
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), [g.contiguous() for g in grads]

    def _update(self, grads):
        hp = self._hp
        fused_sgd_momentum(list(self._params.values()), grads,
                           list(self._mom.values()), hp["lr"],
                           hp["momentum"], hp["wd"], 1.0)

    def step(self, *batch_and_labels):
        """One train step; returns the scalar loss (a device tensor).

        With the numerics guard on (``MXTPU_NUMERICS``, default on) a step
        whose gradients are not all finite is skipped: parameters,
        momenta and BatchNorm statistics stay bit-identical. The verdict
        is read on the host once per step."""
        inputs = self._stage(batch_and_labels)
        guard = _num.enabled()
        aux = {n: v.clone() for n, v in self._aux.items()} if guard \
            else self._aux
        loss, grads = self._loss_and_grads(inputs, aux)
        if guard:
            ok = torch.stack([torch.isfinite(g).all() for g in grads]).all()
            _num.record_flag(ok, where="step")
            if not bool(ok):
                return loss
            self._aux = aux
        self._update(grads)
        return loss

    def step_many(self, *batch_and_labels, n_steps):
        """`n_steps` train steps on the one given batch, as a plain loop
        with no host synchronisation; returns the (n_steps,) losses on the
        device. The steps run unguarded; with the guard on, one verdict
        for the window (every loss and every final parameter finite) is
        recorded as where="window", as the JAX `step_many` does
        (data_parallel.py:483-494)."""
        inputs = self._stage(batch_and_labels)
        losses = torch.empty(int(n_steps), dtype=torch.float32,
                             device=self._dev)
        for i in range(int(n_steps)):
            loss, grads = self._loss_and_grads(inputs, self._aux)
            self._update(grads)
            losses[i] = loss
        if _num.enabled():
            ok = torch.stack([torch.isfinite(losses).all()] +
                             [torch.isfinite(p).all()
                              for p in self._params.values()]).all()
            _num.record_flag(ok, where="window")
        return losses

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
        """Copies of the momenta, by parameter name."""
        return {k: v.clone() for k, v in self._mom.items()}

    def copy_params_to_net(self):
        """Write the trained values back into the net's parameters and
        buffers."""
        self._net.load_parameters({**self._params, **self._aux})
