"""Collective backend interface, and the data plane's CUDA stream.

Counterpart of ``horovod_tpu/ops/backend.py`` (:1-102): a backend says
whether it can run a batch of entries, and runs a whole (possibly fused)
Response at once, fusion-buffer pack and unpack included. It also says
whether the response cache's speculative cycle may carry a fused
allreduce in its place (``fused_cycle_reducible``, :77).

CUDA tensors: a backend runs a batch inside :func:`plane_stream`, which
puts the work on a stream of the data plane's own, after each entry's
ready event (the caller's stream when the entry was enqueued), and
records each entry's done event there at the end.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List

import torch

from horovod_tpu_torch.common.message import Response
from horovod_tpu_torch.common.status import Status
from horovod_tpu_torch.common.tensor_table import TensorTableEntry
from horovod_tpu_torch.common.timeline import NOOP_TIMELINE


def scale(t: torch.Tensor, factor: float) -> torch.Tensor:
    """``t`` times ``factor`` in ``t``'s dtype, the factor first rounded
    to that dtype, as the reference's ``arr * np.asarray(factor,
    arr.dtype)``; ``t`` itself when the factor is 1."""
    if factor == 1.0:
        return t
    return t * torch.tensor(factor, dtype=t.dtype)


def scale_(t: torch.Tensor, factor: float) -> None:
    """:func:`scale` in place, for a buffer the plane owns."""
    if factor != 1.0:
        t.mul_(torch.tensor(factor, dtype=t.dtype))


def pack(tensors: List[torch.Tensor], prescale: float,
         fresh: bool = False) -> torch.Tensor:
    """The fusion buffer: the tensors flattened and concatenated on
    their device, each copy scaled by ``prescale`` in the tensors' dtype.
    One tensor without a prescale stays a (flat) view, unless ``fresh``
    asks for a buffer that may be reduced in place."""
    flats = [t.reshape(-1) for t in tensors]
    if len(flats) == 1:
        out = scale(flats[0], prescale)
        return out.clone() if fresh and out is flats[0] else out
    buf = torch.empty(sum(f.numel() for f in flats), dtype=flats[0].dtype,
                      device=flats[0].device)
    factor = (None if prescale == 1.0
              else torch.tensor(prescale, dtype=buf.dtype))
    offset = 0
    for f in flats:
        dst = buf[offset:offset + f.numel()]
        if factor is None:
            dst.copy_(f)
        else:
            torch.mul(f, factor, out=dst)
        offset += f.numel()
    return buf


def unpack(entries: List[TensorTableEntry], flat: torch.Tensor) -> None:
    """Each entry's output: its window of the fused result, viewed in
    the entry's shape."""
    offset = 0
    for e in entries:
        n = e.tensor.numel()
        e.output = flat[offset:offset + n].view(e.tensor.shape)
        offset += n


class CollectiveBackend:
    name = "abstract"

    # Set by OperationManager.attach_timeline (rank 0 with
    # HOROVOD_TIMELINE): the fusion pack and unpack show as activities.
    timeline = NOOP_TIMELINE
    # Set by OperationManager.attach_finalizer: where a backend that
    # returns Status.InProgress() completes its batch.
    finalizer = None

    def __init__(self):
        # CUDA device index -> this plane's stream there.
        self._streams: Dict[int, torch.cuda.Stream] = {}

    @contextmanager
    def activity(self, names, act, enabled: bool = True):
        """A timeline sub-activity around the body, closed even when the
        body raises."""
        if not enabled:
            yield
            return
        self.timeline.activity_start_all(names, act)
        try:
            yield
        finally:
            self.timeline.activity_end_all(names)

    @contextmanager
    def plane_stream(self, entries: List[TensorTableEntry]):
        """Run the body on this plane's stream of the entries' CUDA
        device (all entries of a batch share it: the coordinator fuses
        only equal placements), after every entry's ready event; record
        the done event there afterwards. Yields the stream, or None for
        CPU tensors, where the body just runs."""
        stream = self.ready_stream(entries)
        if stream is None:
            yield None
            return
        with torch.cuda.stream(stream):
            yield stream
        done = torch.cuda.Event()
        done.record(stream)
        for e in entries:
            e.done_event = done

    def ready_stream(self, entries: List[TensorTableEntry]):
        """This plane's stream on the entries' CUDA device, made to wait
        for every entry's ready event; None for CPU tensors."""
        device = entries[0].tensor.device
        if device.type != "cuda":
            return None
        stream = self._streams.get(device.index)
        if stream is None:
            stream = self._streams[device.index] = torch.cuda.Stream(device)
        for e in entries:
            if e.ready_event is not None:
                stream.wait_event(e.ready_event)
            # The entry holds the tensor until the batch is done; this
            # keeps the allocator from handing its memory to the
            # caller's stream before this stream has read it.
            e.tensor.record_stream(stream)
        return stream

    def enabled(self, entries, response: Response) -> bool:
        raise NotImplementedError

    def fused_cycle_reducible(self, nbytes: int) -> bool:
        """True when a fused allreduce of ``nbytes`` would go through
        the coordinator's channels anyway: then the response cache's
        speculative cycle may carry it on the negotiation round
        (``common/runtime.py``). A plane with a transport of its own
        says False, so that speculation never takes a batch from it."""
        return False

    def execute_allreduce(self, entries, response) -> Status:
        raise NotImplementedError

    def execute_allgather(self, entries, response) -> Status:
        raise NotImplementedError

    def execute_broadcast(self, entries, response) -> Status:
        raise NotImplementedError

    def execute_alltoall(self, entries, response) -> Status:
        raise NotImplementedError

    def execute_reducescatter(self, entries, response) -> Status:
        raise NotImplementedError

    def execute_barrier(self, entries, response) -> Status:
        return Status.OK()
