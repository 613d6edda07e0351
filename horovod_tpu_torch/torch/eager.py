"""PyTorch adapter on the negotiated runtime: hook-driven gradient
allreduce, in the reference's form.

Counterpart of ``horovod_tpu/torch/__init__.py`` as a whole: the
autograd-aware ``allreduce``/``allgather``/``broadcast`` (:48-238), the
in-place ``allreduce_``/``broadcast_``, the hook-driven
``DistributedOptimizer`` (:240-340) and ``broadcast_parameters`` /
``broadcast_optimizer_state`` (:343-). The difference: tensors stay
torch tensors on their device, where the reference stages them through
numpy on the caller's thread.

The optimizer names each gradient ``allreduce.<parameter name>``, so the
order in which the hooks fire may differ from rank to rank: the
coordinator puts the names in one order. (``horovod_tpu_torch.torch
.DistributedOptimizer`` is the in-step optimizer, which averages every
gradient over the process group inside ``step()``.)
"""

from __future__ import annotations

import weakref
from typing import Optional

import torch

from horovod_tpu_torch import ops as _ops
from horovod_tpu_torch.common.basics import (  # noqa: F401
    cross_rank, cross_size, init, initialized, is_homogeneous, local_rank,
    local_size, rank, shutdown, size,
)
from horovod_tpu_torch.common.compression import Compression
from horovod_tpu_torch.ops import Average, Sum, barrier, poll, synchronize

__all__ = [
    "init", "shutdown", "initialized", "rank", "size", "local_rank",
    "local_size", "cross_rank", "cross_size", "is_homogeneous",
    "Average", "Sum", "Compression", "poll", "synchronize", "barrier",
    "allreduce", "allreduce_", "allreduce_async",
    "allgather", "allgather_async",
    "broadcast", "broadcast_", "broadcast_async", "alltoall",
    "DistributedOptimizer", "broadcast_parameters",
    "broadcast_optimizer_state",
]


def _allreduce_impl(tensor, op, name, compression, prescale_factor,
                    postscale_factor):
    comp, ctx = compression.compress(tensor)
    out = _ops.allreduce(comp, op=op, name=name,
                         prescale_factor=prescale_factor,
                         postscale_factor=postscale_factor)
    return compression.decompress(out, ctx).to(tensor.dtype).reshape(
        tensor.shape)


class _AllreduceGrad(torch.autograd.Function):
    """The gradient of an allreduce is the allreduce of the gradient,
    with the same op and scales."""

    @staticmethod
    def forward(ctx, tensor, op, name, compression, pre, post):
        # Resolve the auto name here, so that the backward's name is
        # derived from it: backward order may differ across ranks.
        if name is None:
            name = _ops._auto_name("allreduce")
        ctx.op, ctx.pre, ctx.post = op, pre, post
        ctx.compression = compression
        ctx.name = name
        return _allreduce_impl(tensor, op, name, compression, pre, post)

    @staticmethod
    def backward(ctx, grad):
        g = allreduce(grad, op=ctx.op, name=f"{ctx.name}.grad",
                      compression=ctx.compression,
                      prescale_factor=ctx.pre, postscale_factor=ctx.post)
        return g, None, None, None, None, None


def _wants_grad(tensor) -> bool:
    return torch.is_grad_enabled() and tensor.requires_grad


def allreduce(tensor, op: int = Average, name: Optional[str] = None,
              compression=Compression.none,
              prescale_factor: float = 1.0, postscale_factor: float = 1.0):
    """Reduce ``tensor`` across ranks (the mean by default) into a new
    tensor on its device. Autograd flows through."""
    if _wants_grad(tensor):
        return _AllreduceGrad.apply(tensor, op, name, compression,
                                    prescale_factor, postscale_factor)
    return _allreduce_impl(tensor, op, name, compression, prescale_factor,
                           postscale_factor)


def allreduce_(tensor, op: int = Average, name: Optional[str] = None):
    """In place, not differentiable."""
    with torch.no_grad():
        tensor.copy_(allreduce(tensor, op=op, name=name))
    return tensor


def allreduce_async(tensor, op: int = Average,
                    name: Optional[str] = None) -> int:
    return _ops.allreduce_async(tensor, op=op, name=name)


def _allgather_grad(grad, local_d0: int, name: str):
    """Backward of a named allgather: sum-allreduce the gradient of the
    concatenated output and keep this rank's rows, found from an
    allgather of every rank's dim 0."""
    sizes = _ops.allgather(torch.tensor([local_d0], dtype=torch.int64),
                           name=f"{name}.grad.sizes")
    summed = _ops.allreduce(grad, op=Sum, name=f"{name}.grad")
    off = int(sizes[:rank()].sum())
    return summed[off:off + local_d0]


class _AllgatherGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, name):
        if name is None:
            name = _ops._auto_name("allgather")
        ctx.name = name
        ctx.d0 = tensor.shape[0] if tensor.dim() else 1
        return _ops.allgather(tensor, name=name)

    @staticmethod
    def backward(ctx, grad):
        return _allgather_grad(grad, ctx.d0, ctx.name), None


class _BroadcastGrad(torch.autograd.Function):
    """Backward: the sum of the gradients on the root, zeros
    elsewhere."""

    @staticmethod
    def forward(ctx, tensor, root_rank, name):
        if name is None:
            name = _ops._auto_name("broadcast")
        ctx.name = name
        ctx.root_rank = root_rank
        return _ops.broadcast(tensor, root_rank, name=name)

    @staticmethod
    def backward(ctx, grad):
        g = allreduce(grad, op=Sum, name=f"{ctx.name}.grad")
        if rank() != ctx.root_rank:
            g = torch.zeros_like(g)
        return g, None, None


def allgather(tensor, name: Optional[str] = None):
    """Concatenation of every rank's ``tensor`` along dim 0 (which may
    differ per rank). Autograd flows through."""
    if _wants_grad(tensor):
        return _AllgatherGrad.apply(tensor, name)
    return _ops.allgather(tensor, name=name)


def allgather_async(tensor, name: Optional[str] = None) -> int:
    return _ops.allgather_async(tensor, name=name)


def broadcast(tensor, root_rank: int = 0, name: Optional[str] = None):
    """``root_rank``'s ``tensor`` on every rank, in a new tensor.
    Autograd flows through."""
    if _wants_grad(tensor):
        return _BroadcastGrad.apply(tensor, root_rank, name)
    return _ops.broadcast(tensor, root_rank, name=name)


def broadcast_(tensor, root_rank: int = 0, name: Optional[str] = None):
    """In place, not differentiable."""
    with torch.no_grad():
        tensor.copy_(broadcast(tensor, root_rank=root_rank, name=name))
    return tensor


def broadcast_async(tensor, root_rank: int = 0,
                    name: Optional[str] = None) -> int:
    return _ops.broadcast_async(tensor, root_rank, name=name)


def alltoall(tensor, name: Optional[str] = None):
    return _ops.alltoall(tensor, name=name)


class _DistributedOptimizer:
    def __init__(self, optimizer, named_parameters=None,
                 compression=Compression.none,
                 backward_passes_per_step: int = 1, op: int = Average):
        self._opt = optimizer
        self._compression = compression
        self._op = op
        self.backward_passes_per_step = backward_passes_per_step
        if named_parameters is not None:
            named = list(named_parameters)
        else:
            named = [(f"param.{i}.{j}", p)
                     for i, group in enumerate(optimizer.param_groups)
                     for j, p in enumerate(group["params"])]
        names = [n for n, _ in named]
        if len(set(names)) != len(names):
            raise ValueError("parameter names must be unique for "
                             "DistributedOptimizer")
        self._param_names = {p: n for n, p in named}
        self._handles = {}       # param -> (handle, compression ctx)
        self._grad_counts = {}   # param -> backward passes seen
        self._hook_handles = [
            p.register_post_accumulate_grad_hook(self._make_hook())
            for group in optimizer.param_groups for p in group["params"]
            if p.requires_grad]

    def _make_hook(self):
        # Autograd runs this on the thread of the gradient's device, with
        # that gradient's stream current: the allreduce's ready event is
        # recorded there. The hook takes its parameter as its argument and
        # holds the optimizer weakly: a parameter keeps its hooks where the
        # garbage collector cannot see them, so a strong reference back
        # would keep the model and its optimizer state alive for the rest
        # of the process.
        ref = weakref.ref(self)

        def hook(p):
            opt = ref()
            if opt is None:
                return
            opt._grad_counts[p] = opt._grad_counts.get(p, 0) + 1
            if opt._grad_counts[p] == opt.backward_passes_per_step:
                opt._allreduce_grad(p)
        return hook

    def _allreduce_grad(self, p):
        name = self._param_names.get(p) or f"param.{id(p)}"
        grad = p.grad
        if self.backward_passes_per_step > 1:
            grad = grad / self.backward_passes_per_step
        comp, ctx = self._compression.compress(grad)
        handle = _ops.allreduce_async(comp, op=self._op,
                                      name=f"allreduce.{name}")
        self._handles[p] = (handle, ctx)

    def synchronize(self):
        """Wait for every gradient's allreduce and write the results into
        the ``.grad`` tensors; a parameter seen in fewer backward passes
        than ``backward_passes_per_step`` is reduced as it stands."""
        for p in [p for p, n in self._grad_counts.items()
                  if n > 0 and p not in self._handles]:
            self._allreduce_grad(p)
        for p, (handle, ctx) in list(self._handles.items()):
            out = self._compression.decompress(synchronize(handle), ctx)
            with torch.no_grad():
                p.grad.copy_(out.view_as(p.grad))
        self._handles.clear()
        self._grad_counts.clear()

    def step(self, closure=None):
        self.synchronize()
        return self._opt.step(closure)

    def zero_grad(self, *a, **kw):
        if self._handles:
            raise AssertionError(
                "zero_grad called with allreduces in flight; call "
                "optimizer.synchronize() first")
        return self._opt.zero_grad(*a, **kw)

    def __getattr__(self, item):
        return getattr(self.__dict__["_opt"], item)


def DistributedOptimizer(optimizer, named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step: int = 1,
                         op: int = Average):
    """Wrap a torch optimizer: each gradient's allreduce starts from a
    hook the moment autograd has accumulated it, and ``step()`` waits
    for them all before stepping."""
    return _DistributedOptimizer(optimizer, named_parameters, compression,
                                 backward_passes_per_step, op)


def broadcast_parameters(params, root_rank: int = 0):
    """Copy ``root_rank``'s tensors into every rank's, in place.
    ``params`` is a state dict or an iterable of (name, tensor)."""
    items = list(params.items()) if hasattr(params, "items") \
        else list(params)
    handles = [(t, _ops.broadcast_async(t, root_rank, name=f"bcast.{name}"))
               for name, t in items if isinstance(t, torch.Tensor)]
    for t, h in handles:
        out = synchronize(h)
        with torch.no_grad():
            t.copy_(out)


def broadcast_optimizer_state(optimizer, root_rank: int = 0):
    """Copy ``root_rank``'s optimizer state (tensors and scalars) into
    every rank's. A rank whose optimizer has no state yet materializes it
    first with a zero-gradient step, so that every rank submits the same
    broadcasts; a stateless optimizer returns without any."""
    inner = optimizer._opt if isinstance(optimizer, _DistributedOptimizer) \
        else optimizer
    if isinstance(inner, torch.optim.LBFGS):
        raise ValueError("cannot broadcast torch.optim.LBFGS state")
    state_dict = optimizer.state_dict()
    if not state_dict["state"]:
        for group in inner.param_groups:
            for p in group["params"]:
                if not p.requires_grad:
                    continue  # frozen: the root has no state for it
                if p.grad is None:
                    p.grad = torch.zeros_like(p.data)
                else:
                    with torch.no_grad():
                        p.grad.zero_()
        inner.step()
        state_dict = optimizer.state_dict()
    if not state_dict["state"]:
        return

    scalars = {}
    handles = []

    def visit(path, value):
        if isinstance(value, torch.Tensor):
            handles.append((value, _ops.broadcast_async(
                value, root_rank, name=f"bcast.os.{path}")))
        elif isinstance(value, (int, float)):
            scalars[path] = value
        elif isinstance(value, dict):
            for k in sorted(value, key=str):
                visit(f"{path}/{k}", value[k])
        elif isinstance(value, (list, tuple)):
            for i, v in enumerate(value):
                visit(f"{path}/{i}", v)

    visit("state", state_dict["state"])
    visit("param_groups", state_dict["param_groups"])
    for t, h in handles:
        out = synchronize(h)
        with torch.no_grad():
            t.copy_(out)
    if not scalars:
        return
    # Scalars (lr, momentum, step counts) ride one broadcast.
    keys = sorted(scalars)
    pos = {k: i for i, k in enumerate(keys)}
    vec = _ops.broadcast(torch.tensor([float(scalars[k]) for k in keys],
                                      dtype=torch.float64),
                         root_rank, name="bcast.os.scalars").tolist()

    def restored(path, value):
        if path in scalars:
            got = vec[pos[path]]
            if isinstance(value, bool):
                return bool(got)
            return int(got) if isinstance(value, int) else float(got)
        if isinstance(value, tuple):
            return tuple(restored(f"{path}/{i}", v)
                         for i, v in enumerate(value))
        if isinstance(value, dict):
            for k in sorted(value, key=str):
                value[k] = restored(f"{path}/{k}", value[k])
        elif isinstance(value, list):
            for i, v in enumerate(value):
                value[i] = restored(f"{path}/{i}", v)
        return value

    restored("state", state_dict["state"])
    restored("param_groups", state_dict["param_groups"])
    optimizer.load_state_dict(state_dict)
