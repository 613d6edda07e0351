"""PyTorch framework adapter: the optimizer wrapper and broadcasts.

Counterpart of ``horovod_tpu/jax/__init__.py:50-174``. There,
``DistributedOptimizer`` wraps an optax transformation whose ``update``
first averages the gradients over a mesh axis. Here it wraps a
``torch.optim.Optimizer`` whose ``step()`` first averages every
parameter's ``.grad`` over the axis, in place, and then steps. The
broadcasts copy the root rank's tensors into every rank's own tensors,
in place, where the reference returns new pytrees.

The counterpart of ``horovod_tpu/torch/__init__.py`` (the hook-driven
optimizer on the negotiated runtime) is ``horovod_tpu_torch.torch.eager``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Union

import torch
import torch.distributed as dist

from horovod_tpu_torch import spmd as _spmd
from horovod_tpu_torch.common.compression import Compression


class _DistributedOptimizer:
    """A ``torch.optim.Optimizer`` whose ``step()`` first averages the
    gradients across the mesh axis. Everything but ``step`` and
    ``synchronize`` is the wrapped optimizer's own."""

    def __init__(self, optimizer: torch.optim.Optimizer, op: int,
                 axis: str, compression, gradient_predivide_factor: float):
        self.optimizer = optimizer
        self.op = op
        self.axis = axis
        self.compression = compression
        self.gradient_predivide_factor = gradient_predivide_factor

    def __getattr__(self, name):
        # Only reached for names this wrapper lacks.
        return getattr(self.__dict__["optimizer"], name)

    def _grads(self):
        return [p.grad for group in self.optimizer.param_groups
                for p in group["params"] if p.grad is not None]

    @torch.no_grad()
    def synchronize(self) -> None:
        """Average (or reduce by ``op``) every ``.grad`` across the axis,
        in place."""
        f = self.gradient_predivide_factor
        if f == 1.0 or self.op != _spmd.Average:
            _spmd.allreduce_gradients(self._grads(), self.op, self.axis,
                                      self.compression)
            return
        # Prescale by 1/f before the sum and postscale by f/n after: the
        # mean, with smaller intermediate magnitudes (reference :66-86).
        n = _spmd.mesh_size(self.axis)
        _spmd.allreduce_gradients(self._grads(), _spmd.Sum, self.axis,
                                  self.compression, prescale_factor=1.0 / f,
                                  postscale_factor=f / n)

    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self.synchronize()
        self.optimizer.step()
        return loss


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         op: int = _spmd.Average, axis: str = "data",
                         compression=Compression.none,
                         gradient_predivide_factor: float = 1.0):
    """Wrap ``optimizer`` so that each ``step()`` first reduces the
    parameters' gradients over the mesh ``axis`` (by default their mean)
    with ``compression`` on the wire, then steps. With
    ``gradient_predivide_factor`` f and ``op=Average`` the gradients are
    scaled by 1/f before the sum and by f/size after it."""
    return _DistributedOptimizer(optimizer, op, axis, compression,
                                 gradient_predivide_factor)


Tensors = Union[torch.nn.Module, Dict[str, torch.Tensor],
                Iterable[torch.Tensor]]


def _tensors(params: Tensors):
    if isinstance(params, torch.nn.Module):
        return list(params.state_dict().values())
    if isinstance(params, dict):
        return list(params.values())
    return [p[1] if isinstance(p, tuple) else p for p in params]


@torch.no_grad()
def broadcast_parameters(params: Tensors, root_rank: int = 0,
                         axis: str = "data") -> Tensors:
    """Copy ``root_rank``'s parameters into every rank's, in place.
    ``params`` is a module, a state dict, ``named_parameters()`` or an
    iterable of tensors. Returns ``params``."""
    _spmd.broadcast_variables(_tensors(params), root_rank, axis)
    return params


@torch.no_grad()
def broadcast_optimizer_state(optimizer, root_rank: int = 0,
                              axis: str = "data"):
    """Copy ``root_rank``'s optimizer state tensors (momentum buffers,
    step counts held as tensors) into every rank's, in place; other
    state values are left alone. Every rank must hold state of the same
    structure: a rank whose state differs raises on every rank, before
    any tensor moves."""
    opt = getattr(optimizer, "optimizer", optimizer)
    entries = [(i, key, t) for i, state in
               enumerate(opt.state[p] for g in opt.param_groups
                         for p in g["params"])
               for key, t in sorted(state.items())
               if isinstance(t, torch.Tensor)]
    mine = [(i, key, tuple(t.shape), str(t.dtype)) for i, key, t in entries]
    everyone = [None] * _spmd.mesh_size(axis)
    dist.all_gather_object(everyone, mine,
                           group=_spmd._mesh_for(axis).groups[axis])
    if any(other != mine for other in everyone):
        raise ValueError("optimizer state differs in structure across "
                         "ranks; take a step everywhere (or nowhere) "
                         "before broadcasting it")
    _spmd.broadcast_variables([t for _, _, t in entries], root_rank, axis)
    return optimizer


def broadcast_train_state(state: Dict[str, Any], root_rank: int = 0,
                          axis: str = "data"):
    """Broadcast a train state held as a dict of modules, optimizers,
    state dicts and tensors from ``root_rank``, in place."""
    for value in state.values():
        if isinstance(value, (torch.optim.Optimizer, _DistributedOptimizer)):
            broadcast_optimizer_state(value, root_rank, axis)
        elif isinstance(value, torch.Tensor):
            broadcast_parameters([value], root_rank, axis)
        else:
            broadcast_parameters(value, root_rank, axis)
    return state
