"""Process identity: init / shutdown / rank / size / local_rank / ...

Counterpart of the identity half of ``horovod_tpu/common/basics.py``
(:1-20, :81-107, and ``rank``/``size``/``local_rank``/``local_size``).
Identity comes from the launcher's environment: ``HOROVOD_RANK``,
``HOROVOD_SIZE``, ``HOROVOD_LOCAL_RANK``, ``HOROVOD_LOCAL_SIZE`` and the
rendezvous address ``HOROVOD_CONTROLLER_ADDR``/``HOROVOD_CONTROLLER_PORT``.
With none set, ``init()`` brings up a size-1 world. Either way it creates
a ``torch.distributed`` process group (NCCL on CUDA, gloo on the CPU; a
size-1 world rendezvous through an in-process ``HashStore``), so the same
collective path runs at every size. The negotiated runtime and controller
of the reference are not ported yet.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Optional

import torch
import torch.distributed as dist


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless ``device`` says
    otherwise. Raises when CUDA is asked for (or defaulted to) and is
    absent, so that nothing carries on on the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass
class _World:
    rank: int
    size: int
    local_rank: int
    local_size: int


_lock = threading.Lock()
_world: Optional[_World] = None


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name, "")
    return int(value) if value else default


def init(device=None) -> None:
    """Join the world described by the environment (a size-1 world when
    it describes none). ``device`` defaults to CUDA: the local rank's
    card becomes the current device and the group uses NCCL. With
    ``device="cpu"`` the group uses gloo. A second call is a no-op."""
    global _world
    with _lock:
        if _world is not None:
            return
        dev = resolve_device(device)
        size = _env_int("HOROVOD_SIZE", 1)
        rank = _env_int("HOROVOD_RANK", 0)
        local_rank = _env_int("HOROVOD_LOCAL_RANK", rank)
        local_size = _env_int("HOROVOD_LOCAL_SIZE", size)
        if not 0 <= rank < size:
            raise ValueError(f"HOROVOD_RANK={rank} outside a world of "
                             f"HOROVOD_SIZE={size}")
        if dev.type == "cuda":
            dev = torch.device("cuda", local_rank)
            torch.cuda.set_device(dev)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if size == 1:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
        else:
            addr = os.environ.get("HOROVOD_CONTROLLER_ADDR", "")
            port = _env_int("HOROVOD_CONTROLLER_PORT", 0)
            if not addr or not port:
                raise ValueError(
                    "a world of size > 1 needs HOROVOD_CONTROLLER_ADDR "
                    "and HOROVOD_CONTROLLER_PORT")
            dist.init_process_group(backend,
                                    init_method=f"tcp://{addr}:{port}",
                                    rank=rank, world_size=size)
        _world = _World(rank, size, local_rank, local_size)


def shutdown() -> None:
    """Leave the world and destroy its process group."""
    global _world
    with _lock:
        if _world is None:
            return
        from horovod_tpu_torch import spmd
        spmd._forget_meshes()
        dist.destroy_process_group()
        _world = None


def _require() -> _World:
    if _world is None:
        raise ValueError(
            "horovod_tpu_torch has not been initialized; run hvd.init() "
            "first.")
    return _world


def initialized() -> bool:
    return _world is not None


def rank() -> int:
    return _require().rank


def size() -> int:
    return _require().size


def local_rank() -> int:
    return _require().local_rank


def local_size() -> int:
    return _require().local_size
