"""Collectives over a named mesh axis, on torch tensors.

Counterpart of ``horovod_tpu/spmd/__init__.py:29-203``. In the reference
the axis names are in scope inside a shard_map'd step and the
collectives are ``jax.lax`` ops that XLA fuses into the step. Here each
axis name maps to a ``torch.distributed`` process group, and the
collectives run eagerly on the current CUDA stream's order: NCCL's
stream waits for the work already queued on the current stream (the
backward that produced a gradient) before it reduces, and the current
stream waits for the collective before anything queued after it.

This slice has one axis, ``data``, over the whole world (the reference's
default mesh). ``alltoall``, ``reducescatter``, the hybrid mesh and the
ZeRO optimizer are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import basics

Average = 0
Sum = 1
Min = 2
Max = 3

_REDUCE_OPS = {Sum: dist.ReduceOp.SUM, Average: dist.ReduceOp.SUM,
               Min: dist.ReduceOp.MIN, Max: dist.ReduceOp.MAX}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis name -> (process group, size)."""
    groups: Dict[str, object]
    sizes: Dict[str, int]


_mesh: Optional[Mesh] = None


def _forget_meshes() -> None:
    global _mesh
    _mesh = None


def create_mesh(axes: Optional[Dict[str, int]] = None) -> Mesh:
    """The mesh of this world: one ``data`` axis over every rank (the
    default), given as ``{"data": -1}`` or ``{"data": hvd.size()}``.
    It becomes the mesh the collectives' ``axis`` names refer to."""
    global _mesh
    n = basics.size()
    axes = {"data": -1} if axes is None else dict(axes)
    if len(axes) != 1:
        raise ValueError(f"one mesh axis is supported for now, got {axes}")
    (name, width), = axes.items()
    if width not in (-1, n):
        raise ValueError(f"axis {name!r} of size {width} in a world of {n}")
    _mesh = Mesh({name: dist.group.WORLD}, {name: n})
    return _mesh


def _mesh_for(axis: str) -> Mesh:
    mesh = _mesh if _mesh is not None else create_mesh()
    if axis not in mesh.groups:
        raise ValueError(f"no mesh axis {axis!r}; the mesh has "
                         f"{sorted(mesh.groups)}")
    return mesh


def mesh_rank(axis: str = "data") -> int:
    """This process's rank along ``axis``."""
    return dist.get_rank(_mesh_for(axis).groups[axis])


def mesh_size(axis: str = "data") -> int:
    return _mesh_for(axis).sizes[axis]


def _scale_(x: torch.Tensor, factor: float) -> None:
    """``x *= factor`` in place, the factor first rounded to ``x``'s
    dtype, as the reference's ``x * jnp.asarray(factor, x.dtype)``."""
    if factor != 1.0:
        x.mul_(torch.tensor(factor, dtype=x.dtype))


def _is_float(x: torch.Tensor) -> bool:
    return x.is_floating_point() or x.is_complex()


def allreduce_(x: torch.Tensor, op: int = Average, axis: str = "data",
               prescale_factor: float = 1.0,
               postscale_factor: float = 1.0) -> torch.Tensor:
    """In-place :func:`allreduce`: reduces ``x`` itself and returns it.
    The ``Average`` of an integer tensor is a float, which ``x`` cannot
    hold: that raises before any collective, leaving ``x`` as it was."""
    if op not in _REDUCE_OPS:
        raise ValueError(f"unknown reduction op {op}")
    if op == Average and not _is_float(x):
        raise ValueError(
            f"allreduce_: the average of a {x.dtype} tensor is a float "
            f"and cannot be written into it; use allreduce, which returns "
            f"the float mean")
    mesh = _mesh_for(axis)
    _scale_(x, prescale_factor)
    dist.all_reduce(x, op=_REDUCE_OPS[op], group=mesh.groups[axis])
    if op == Average and mesh.sizes[axis] > 1:
        x.div_(mesh.sizes[axis])
    _scale_(x, postscale_factor)
    return x


def allreduce(x: torch.Tensor, op: int = Average, axis: str = "data",
              prescale_factor: float = 1.0,
              postscale_factor: float = 1.0) -> torch.Tensor:
    """Cross-replica reduction into a new tensor. ``Average`` divides
    the sum by the axis size; for an integer tensor it returns the float
    mean, as ``jax.lax.pmean`` does."""
    if op == Average and not _is_float(x):
        y = allreduce_(x.clone(), Sum, axis, prescale_factor)
        y = y / mesh_size(axis)
        _scale_(y, postscale_factor)
        return y
    return allreduce_(x.clone(), op, axis, prescale_factor,
                      postscale_factor)


def allgather(x: torch.Tensor, axis: str = "data") -> torch.Tensor:
    """Concatenation of every replica's ``x`` along dim 0 (all shards
    have the same shape)."""
    mesh = _mesh_for(axis)
    parts = [torch.empty_like(x) for _ in range(mesh.sizes[axis])]
    dist.all_gather(parts, x.contiguous(), group=mesh.groups[axis])
    return torch.cat(parts, dim=0)


def broadcast_(x: torch.Tensor, root_rank: int = 0,
               axis: str = "data") -> torch.Tensor:
    """In-place :func:`broadcast`."""
    group = _mesh_for(axis).groups[axis]
    dist.broadcast(x, src=dist.get_global_rank(group, root_rank),
                   group=group)
    return x


def broadcast(x: torch.Tensor, root_rank: int = 0,
              axis: str = "data") -> torch.Tensor:
    """Every replica receives root's value, in a new tensor."""
    return broadcast_(x.clone(), root_rank, axis)


def allreduce_gradients(grads: Iterable[torch.Tensor], op: int = Average,
                        axis: str = "data", compression=None,
                        prescale_factor: float = 1.0,
                        postscale_factor: float = 1.0):
    """Reduce each gradient across the axis, in place, and return them.
    With ``compression`` (``Compression.fp16`` / ``.bf16``) a gradient
    is cast down, reduced, and cast back into its own storage. In place,
    unlike the reference's pytree map, so that no second copy of the
    gradients is held. The scale factors are :func:`allreduce`'s."""
    grads = list(grads)
    for g in grads:
        c, ctx = compression.compress(g) if compression else (g, None)
        allreduce_(c, op, axis, prescale_factor, postscale_factor)
        if c is not g:
            g.copy_(compression.decompress(c, ctx))
    return grads


def broadcast_variables(tensors: Iterable[torch.Tensor], root_rank: int = 0,
                        axis: str = "data"):
    """Broadcast each tensor from ``root_rank``, in place; returns them."""
    tensors = list(tensors)
    for t in tensors:
        broadcast_(t, root_rank, axis)
    return tensors
