"""Negotiated collectives on torch tensors.

Counterpart of ``horovod_tpu/ops/__init__.py``: ``_inspect`` (:66) for
torch CPU and CUDA tensors, ``_enqueue`` (:88), the auto names
``<kind>.noname.<n>`` (:46), every sync and ``_async`` op,
``grouped_allreduce`` (an atomic group), ``poll``, ``synchronize`` and
``barrier``, with the reference's argument checks. Tensors stay torch
tensors on their device: an op returns a tensor on the input's device.

Auto names come from per-op counters; they agree across ranks as long as
the ranks create their unnamed ops in the same order. Named ops may be
submitted in any order: the coordinator puts them in one order.

A CUDA tensor is not ready when it is enqueued: its kernels may still be
queued on the caller's stream. ``_inspect`` records an event there,
which the data plane's stream waits on; ``synchronize`` makes the
caller's current stream wait on the plane's event before it hands the
output over.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

import torch

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.message import (
    RequestType, torch_dtype_to_datatype,
)
from horovod_tpu_torch.common.status import (
    HorovodInternalError, Status, WorldAbortedError,
)
from horovod_tpu_torch.common.tensor_table import TensorTableEntry

# Reduction ops.
Average = 0
Sum = 1

_counter_lock = threading.Lock()
_counters = {}


def _auto_name(kind: str) -> str:
    with _counter_lock:
        n = _counters.get(kind, 0)
        _counters[kind] = n + 1
    return f"{kind}.noname.{n}"


def reset_name_counters() -> None:
    """``init`` calls this, so that a re-initialized world agrees on
    auto names again."""
    with _counter_lock:
        _counters.clear()


def _inspect(tensor):
    """-> (payload, device index, DataType, shape, ready event). The
    payload is the tensor detached from autograd (a numpy array or a
    scalar becomes a CPU tensor); the device is -1 on the CPU; the ready
    event, for a CUDA tensor, is recorded on the current stream of the
    calling thread."""
    if not isinstance(tensor, torch.Tensor):
        tensor = torch.as_tensor(tensor)
    tensor = tensor.detach()
    dtype = torch_dtype_to_datatype(tensor.dtype)
    if tensor.device.type == "cuda":
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(tensor.device))
        return tensor, tensor.device.index, dtype, tuple(tensor.shape), ready
    if tensor.device.type != "cpu":
        raise ValueError(f"tensors on {tensor.device} are not supported; "
                         f"use a CUDA or a CPU tensor")
    return tensor, -1, dtype, tuple(tensor.shape), None


def _entry(name, inspected, handle, root_rank=-1) -> TensorTableEntry:
    payload, device, _, _, ready = inspected
    entry = TensorTableEntry(tensor_name=name, tensor=payload,
                             root_rank=root_rank, device=device,
                             ready_event=ready)
    manager = basics.runtime().handle_manager

    def callback(status: Status) -> None:
        manager.mark_done(handle, status, (entry.output, entry.done_event))

    entry.callback = callback
    return entry


def _enqueue(kind: RequestType, tensor, name: Optional[str],
             root_rank: int = -1, prescale: float = 1.0,
             postscale: float = 1.0) -> int:
    rt = basics.runtime()
    inspected = _inspect(tensor)
    name = name or _auto_name(kind.name.lower())
    handle = rt.handle_manager.allocate()
    entry = _entry(name, inspected, handle, root_rank)
    status = rt.enqueue(kind, entry, inspected[2], inspected[3], prescale,
                        postscale)
    if not status.ok():
        rt.handle_manager.mark_done(handle, status, (None, None))
    return handle


def poll(handle: int) -> bool:
    """True when the op behind ``handle`` has completed."""
    return basics.runtime().handle_manager.poll(handle)


def synchronize(handle: int) -> Any:
    """Block until the op completes; raise on its error; return its
    output. A CUDA output is handed over on the caller's current stream:
    that stream waits for the data plane's work on it first."""
    manager = basics.runtime().handle_manager
    status = manager.wait(handle)
    output, done = manager.release(handle)
    if not status.ok():
        if status.aborted_by is not None:
            raise WorldAbortedError(status.reason,
                                    origin_rank=status.aborted_by)
        raise HorovodInternalError(status.reason)
    if done is not None and isinstance(output, torch.Tensor):
        stream = torch.cuda.current_stream(output.device)
        stream.wait_event(done)
        # The output was made on the plane's stream: keep its memory
        # from going back to that stream while this one may still use it.
        output.record_stream(stream)
    return output


# -- allreduce -----------------------------------------------------------
def _check_scalable_dtype(tensor, op, prescale, postscale, opname):
    """Integer tensors cannot be averaged or scaled: the factor would be
    truncated in the tensor's dtype."""
    dtype = tensor.dtype if isinstance(tensor, torch.Tensor) \
        else torch.as_tensor(tensor).dtype
    if not (dtype.is_floating_point or dtype.is_complex) and (
            op == Average or prescale != 1.0 or postscale != 1.0):
        raise ValueError(
            f"Averaging or scaling during {opname} is not supported for "
            "integer tensors; use op=Sum with unit scale factors.")


def _resolve_op(average, op):
    if op is not None:
        return op
    return Average if average is None or average else Sum


def allreduce_async(tensor, average: Optional[bool] = None,
                    name: Optional[str] = None, op: Optional[int] = None,
                    prescale_factor: float = 1.0,
                    postscale_factor: float = 1.0) -> int:
    """Sum (or average) ``tensor`` across ranks; returns a handle."""
    op = _resolve_op(average, op)
    _check_scalable_dtype(tensor, op, prescale_factor, postscale_factor,
                          "allreduce")
    if op == Average:
        postscale_factor = postscale_factor / basics.size()
    return _enqueue(RequestType.ALLREDUCE, tensor, name,
                    prescale=prescale_factor, postscale=postscale_factor)


def allreduce(tensor, average: Optional[bool] = None,
              name: Optional[str] = None, op: Optional[int] = None,
              prescale_factor: float = 1.0,
              postscale_factor: float = 1.0) -> Any:
    return synchronize(allreduce_async(tensor, average, name, op,
                                       prescale_factor, postscale_factor))


def grouped_allreduce_async(tensors, average: Optional[bool] = None,
                            name: Optional[str] = None,
                            op: Optional[int] = None,
                            prescale_factor: float = 1.0,
                            postscale_factor: float = 1.0) -> list:
    """Submit ``tensors`` as one atomic allreduce group under the names
    ``{name}.<i>``: all members enter one RequestList, so compatible
    members fuse into one Response. Every member is checked before any
    is enqueued, so a bad member fails the call without leaving half a
    group in flight. Returns one handle per tensor."""
    if name is None:
        name = _auto_name("grouped_allreduce")
    op = _resolve_op(average, op)
    post = postscale_factor / basics.size() if op == Average \
        else postscale_factor
    inspected = []
    for t in tensors:
        inspected.append(_inspect(t))
        _check_scalable_dtype(t, op, prescale_factor, postscale_factor,
                              "grouped_allreduce")
    rt = basics.runtime()
    handles = rt.handle_manager.allocate_many(len(inspected))
    items = [(_entry(f"{name}.{i}", ins, h), ins[2], ins[3])
             for i, (ins, h) in enumerate(zip(inspected, handles))]
    status = rt.enqueue_group(RequestType.ALLREDUCE, items,
                              prescale_factor, post)
    if not status.ok():
        for h in handles:  # nothing was inserted
            rt.handle_manager.mark_done(h, status, (None, None))
    return handles


def grouped_allreduce(tensors, average: Optional[bool] = None,
                      name: Optional[str] = None, op: Optional[int] = None,
                      prescale_factor: float = 1.0,
                      postscale_factor: float = 1.0) -> list:
    """Blocking grouped allreduce: every member is drained even when one
    fails, then the first error raises."""
    handles = grouped_allreduce_async(tensors, average, name, op,
                                      prescale_factor, postscale_factor)
    outs, first_error = [], None
    for h in handles:
        try:
            outs.append(synchronize(h))
        except HorovodInternalError as e:
            outs.append(None)
            if first_error is None:
                first_error = e
    if first_error is not None:
        raise first_error
    return outs


# -- allgather -----------------------------------------------------------
def allgather_async(tensor, name: Optional[str] = None) -> int:
    """Concatenate each rank's tensor along dim 0, which may differ per
    rank."""
    return _enqueue(RequestType.ALLGATHER, tensor, name)


def allgather(tensor, name: Optional[str] = None) -> Any:
    return synchronize(allgather_async(tensor, name))


# -- broadcast -----------------------------------------------------------
def broadcast_async(tensor, root_rank: int,
                    name: Optional[str] = None) -> int:
    return _enqueue(RequestType.BROADCAST, tensor, name,
                    root_rank=root_rank)


def broadcast(tensor, root_rank: int, name: Optional[str] = None) -> Any:
    return synchronize(broadcast_async(tensor, root_rank, name))


# -- alltoall ------------------------------------------------------------
def alltoall_async(tensor, name: Optional[str] = None) -> int:
    """Send dim-0 block d to rank d and receive every rank's block for
    this rank, in rank order; dim 0 must divide by the world size."""
    return _enqueue(RequestType.ALLTOALL, tensor, name)


def alltoall(tensor, name: Optional[str] = None) -> Any:
    return synchronize(alltoall_async(tensor, name))


# -- reducescatter -------------------------------------------------------
def reducescatter_async(tensor, name: Optional[str] = None,
                        op: int = Sum) -> int:
    _check_scalable_dtype(tensor, op, 1.0, 1.0, "reducescatter")
    postscale = 1.0 / basics.size() if op == Average else 1.0
    return _enqueue(RequestType.REDUCESCATTER, tensor, name,
                    postscale=postscale)


def reducescatter(tensor, name: Optional[str] = None, op: int = Sum) -> Any:
    return synchronize(reducescatter_async(tensor, name, op))


# -- barrier -------------------------------------------------------------
def barrier(name: Optional[str] = None) -> None:
    """Block until every rank reaches the barrier."""
    synchronize(_enqueue(RequestType.BARRIER,
                         torch.zeros((), dtype=torch.uint8),
                         name or _auto_name("barrier")))
