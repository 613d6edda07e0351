"""Process lifecycle and identity: init / shutdown / rank / size / ...

Counterpart of ``horovod_tpu/common/basics.py``. ``init`` builds the
negotiated runtime as the reference's ``_build_runtime`` does (:81-175):
a ``LocalController`` at size 1, otherwise a ``TcpCoordinator`` on rank
0 and a ``TcpWorker`` elsewhere, the coordinator listening on the
launcher's ``HOROVOD_CONTROLLER_ADDR``/``HOROVOD_CONTROLLER_PORT``, with
the backends ``[ProcessGroupBackend, SocketBackend, LocalBackend]`` on
CUDA (the process-group plane for CUDA tensors, agreed by the world at
first use, with the socket star as the fallback and for CPU tensors) and
``[SocketBackend, LocalBackend]`` on the CPU. Identity (rank, size,
local and cross ranks) comes from the controller's handshake, as in the
reference; ``HOROVOD_RANK`` and ``HOROVOD_SIZE`` say who this process
is, and ``HOROVOD_LOCAL_RANK`` picks its card. The controllers arm their
channels with ``HOROVOD_HEARTBEAT_INTERVAL`` and
``HOROVOD_HEARTBEAT_TIMEOUT`` (5 s and 30 s, on by default); the
coordinator folds each remote host's ranks behind its local root unless
``HOROVOD_TPU_HIER_CONTROLLER=0`` (reference :118); and
``HOROVOD_COMPRESSION`` sets this rank's wire-dtype proposal.
``HOROVOD_AUTOTUNE=1`` gives the runtime a ``ParameterManager``
(reference :167-172), which ``runtime().parameter_manager`` exposes.

``init`` also creates the ``torch.distributed`` process group that the
in-step path (``horovod_tpu_torch.spmd``) runs on: NCCL on CUDA, gloo on
the CPU. At size 1 it meets through an in-process store. Above size 1
the runtime already holds the launcher's port, so rank 0 opens the
group's ``TCPStore`` on a free port and hands that port to the others
with a first negotiated broadcast. The process-group plane's own groups
follow, made by every rank in the same order.
"""

from __future__ import annotations

import atexit
import threading
from typing import Optional

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import logging as hlog
from horovod_tpu_torch.common import wire_dtype as _wd
from horovod_tpu_torch.common.config import Config, env_int
from horovod_tpu_torch.common.controller import (
    Controller, LocalController, TcpCoordinator, TcpWorker,
)
from horovod_tpu_torch.common.parameter_manager import ParameterManager
from horovod_tpu_torch.common.runtime import Runtime
from horovod_tpu_torch.ops.local_ops import LocalBackend
from horovod_tpu_torch.ops.operation_manager import OperationManager
from horovod_tpu_torch.ops.process_group_ops import ProcessGroupBackend
from horovod_tpu_torch.ops.socket_ops import SocketBackend


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless ``device`` says
    otherwise. Raises when CUDA is asked for (or defaulted to) and is
    absent, so that nothing carries on on the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


_lock = threading.Lock()
_runtime: Optional[Runtime] = None


def _build_runtime(cfg: Config, device: Optional[torch.device]) -> Runtime:
    secret = cfg.secret_key.encode() if cfg.secret_key else b""
    size = cfg.size if cfg.size > 0 else 1
    rank = cfg.rank if cfg.rank >= 0 else 0
    if not 0 <= rank < size:
        raise ValueError(f"HOROVOD_RANK={rank} outside a world of "
                         f"HOROVOD_SIZE={size}")
    if size == 1:
        controller: Controller = LocalController()
    elif not cfg.controller_addr or not cfg.controller_port:
        raise ValueError("a world of size > 1 needs HOROVOD_CONTROLLER_ADDR "
                         "and HOROVOD_CONTROLLER_PORT")
    elif rank == 0:
        controller = TcpCoordinator(
            size, port=cfg.controller_port, secret=secret,
            start_timeout=cfg.start_timeout,
            hierarchical=cfg.hier_controller,
            heartbeat_interval=cfg.heartbeat_interval_s,
            heartbeat_timeout=cfg.heartbeat_timeout_s)
        controller.accept_workers()
    else:
        controller = TcpWorker(
            rank, size, cfg.controller_addr, cfg.controller_port,
            secret=secret, start_timeout=cfg.start_timeout,
            heartbeat_interval=cfg.heartbeat_interval_s,
            heartbeat_timeout=cfg.heartbeat_timeout_s)
    backends = [SocketBackend(controller),
                LocalBackend(lambda: controller.size)]
    if device is not None:
        backends.insert(0, ProcessGroupBackend(controller, cfg, "cuda"))
    parameter_manager = None
    if cfg.autotune:
        parameter_manager = ParameterManager(cfg, controller)
    rt = Runtime(cfg, controller, OperationManager(backends), device=device,
                 parameter_manager=parameter_manager)
    rt.start()
    return rt


def _init_process_group(rt: Runtime, cfg: Config, backend: str) -> None:
    from horovod_tpu_torch import ops
    size, rank = rt.controller.size, rt.controller.rank
    if size == 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
        return
    # The master's store listens on every interface; the address is
    # where each rank's own client reaches it.
    store = None
    if rank == 0:
        store = dist.TCPStore(cfg.controller_addr, 0, size, is_master=True,
                              wait_for_workers=False)
    port = torch.tensor([store.port if store is not None else 0])
    port = int(ops.broadcast(port, 0, name="hvd.init.store_port")[0])
    if store is None:
        store = dist.TCPStore(cfg.controller_addr, port, size,
                              is_master=False)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=size)


def init(device=None) -> None:
    """Join the world the environment describes (a size-1 world when it
    describes none): start the negotiated runtime and create the
    process group. ``device`` defaults to CUDA: the local rank's card
    (modulo the cards there are) becomes the current device and the
    group uses NCCL. With ``device="cpu"`` the group uses gloo. A second
    call is a no-op."""
    global _runtime
    with _lock:
        if _runtime is not None:
            return
        dev = resolve_device(device)
        cfg = Config.from_env()
        hlog.set_level(cfg.log_level)
        # The wire-compression latch the framework-level Compression
        # helpers read (common/wire_dtype.py).
        _wd.set_active(_wd.wire_code_of(cfg.compression))
        if dev.type == "cuda":
            local_rank = env_int("HOROVOD_LOCAL_RANK", max(cfg.rank, 0))
            dev = torch.device("cuda",
                               local_rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        rt = _build_runtime(cfg, dev if dev.type == "cuda" else None)
        _runtime = rt
        from horovod_tpu_torch import ops
        ops.reset_name_counters()
        try:
            _init_process_group(rt, cfg,
                                "nccl" if dev.type == "cuda" else "gloo")
            for plane in _planes(rt):
                plane.create_groups()
        except BaseException:
            _stop_runtime()
            raise
        ops.reset_name_counters()


def _planes(rt: Runtime):
    return [b for b in rt.op_manager.backends
            if isinstance(b, ProcessGroupBackend)]


def _stop_runtime() -> None:
    """Stop the loop, then drop the plane's groups: no collective of
    theirs is in flight once the loop has ended."""
    global _runtime
    rt, _runtime = _runtime, None
    _wd.set_active(_wd.WIRE_NONE)
    if rt is not None:
        rt.request_shutdown()
        rt.join(timeout=30.0)
        if dist.is_initialized():
            for plane in _planes(rt):
                plane.destroy_groups()


def shutdown() -> None:
    """Leave the world: stop the runtime (pending handles fail with the
    shutdown error) and destroy the process group."""
    with _lock:
        if _runtime is None:
            return
        from horovod_tpu_torch import spmd
        spmd._forget_meshes()
        _stop_runtime()
        if dist.is_initialized():
            dist.destroy_process_group()


atexit.register(shutdown)


def runtime() -> Runtime:
    """The live runtime (the ops and adapters use it)."""
    if _runtime is None:
        raise ValueError(
            "horovod_tpu_torch has not been initialized; run hvd.init() "
            "first.")
    return _runtime


def metrics() -> dict:
    """The live metrics view (``HOROVOD_TPU_METRICS=1``): ``{"enabled":
    bool, "local": {...}, "world": {...} | None, "http_port": int |
    None}``. ``local`` is this rank's fresh registry snapshot; ``world``
    is the world fold, on rank 0 only; ``http_port`` is the port of the
    Prometheus endpoint when ``HOROVOD_TPU_METRICS_PORT`` started it.
    With the plane off the snapshots are empty and ``enabled`` is
    False (reference ``horovod_tpu/common/basics.py:353-364``)."""
    return runtime().metrics_view()


def initialized() -> bool:
    return _runtime is not None


def rank() -> int:
    return runtime().controller.topology.rank


def size() -> int:
    return runtime().controller.topology.size


def local_rank() -> int:
    return runtime().controller.topology.local_rank


def local_size() -> int:
    return runtime().controller.topology.local_size


def cross_rank() -> int:
    """Rank among hosts."""
    return runtime().controller.topology.cross_rank


def cross_size() -> int:
    return runtime().controller.topology.cross_size


def is_homogeneous() -> bool:
    """True when every host runs the same number of ranks."""
    return runtime().controller.topology.is_homogeneous


def coordinator_threads_supported() -> bool:
    """Ops may be enqueued from any thread (the tensor table takes a
    lock), so multi-threaded use is always supported, as in the
    reference (``horovod_tpu/common/basics.py:367-373``)."""
    return True


def mpi_threads_supported() -> bool:
    """The reference's alias of :func:`coordinator_threads_supported`."""
    return coordinator_threads_supported()
