"""Collective backend interface, and the data plane's CUDA stream.

Counterpart of ``horovod_tpu/ops/backend.py`` (:1-102): a backend says
whether it can run a batch of entries, and runs a whole (possibly fused)
Response at once, fusion-buffer pack and unpack included.

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


class CollectiveBackend:
    name = "abstract"

    # Set by OperationManager.attach_timeline (rank 0 with
    # HOROVOD_TIMELINE): the fusion pack and unpack show as activities.
    timeline = NOOP_TIMELINE

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
        device = entries[0].tensor.device
        if device.type != "cuda":
            yield None
            return
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
        with torch.cuda.stream(stream):
            yield stream
        done = torch.cuda.Event()
        done.record(stream)
        for e in entries:
            e.done_event = done

    def enabled(self, entries, response: Response) -> bool:
        raise NotImplementedError

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
