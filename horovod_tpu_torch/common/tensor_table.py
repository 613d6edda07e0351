"""Tensor table, message queue and handle manager.

Counterpart of ``horovod_tpu/common/tensor_table.py`` (:1-269). The
table holds the in-flight collectives of this process, keyed by name;
the message queue carries the matching Requests to the background loop;
handles serve every async API.

A torch CUDA tensor is not a future: the kernels that produce it may
still be queued on the caller's stream when it is enqueued. So an entry
carries ``ready_event``, recorded on the caller's stream at enqueue
time, which the data plane's stream waits on before it reads the
tensor, and ``done_event``, recorded on the data plane's stream after it
wrote the output, which ``synchronize`` makes the caller's stream wait
on (the reference's ReadyEvent, which ``horovod_tpu/common/runtime.py
:2951-2959`` explains the JAX package does without).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

from horovod_tpu_torch.common.message import Request
from horovod_tpu_torch.common.status import Status


class TensorTableEntry:
    """One in-flight collective on this process."""

    __slots__ = ("tensor_name", "tensor", "output", "root_rank", "device",
                 "callback", "ready_event", "done_event")

    def __init__(self, tensor_name: str, tensor: Any,
                 root_rank: int = -1, device: int = -1,
                 callback: Optional[Callable[[Status], None]] = None,
                 ready_event=None):
        self.tensor_name = tensor_name
        self.tensor = tensor          # input torch tensor (CPU or CUDA)
        self.output = None            # set by the executing backend
        self.root_rank = root_rank
        self.device = device          # CUDA index, -1 on the CPU
        self.callback = callback
        self.ready_event = ready_event  # torch.cuda.Event or None
        self.done_event = None          # set by the data plane (CUDA)


class TensorTable:
    """Name-keyed table of pending entries and the per-cycle message
    queue, under one lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._table: Dict[str, TensorTableEntry] = {}
        self._message_queue: List[Request] = []

    def __len__(self) -> int:
        """Entries tabled (in flight) on this rank."""
        with self._lock:
            return len(self._table)

    def add(self, entry: TensorTableEntry, request: Request) -> bool:
        """Insert entry and request together; False on a duplicate
        name."""
        with self._lock:
            if entry.tensor_name in self._table:
                return False
            self._table[entry.tensor_name] = entry
            self._message_queue.append(request)
            return True

    def add_all(self, pairs) -> Optional[str]:
        """Insert several (entry, request) pairs under one lock hold,
        all or nothing, so a concurrent cycle cannot split the group
        across two RequestLists. Returns the first duplicate name, or
        None."""
        with self._lock:
            for entry, _ in pairs:
                if entry.tensor_name in self._table:
                    return entry.tensor_name
            for entry, request in pairs:
                self._table[entry.tensor_name] = entry
                self._message_queue.append(request)
            return None

    def pop_messages(self) -> List[Request]:
        """Drain the message queue for this cycle."""
        with self._lock:
            msgs = self._message_queue
            self._message_queue = []
            return msgs

    def requeue(self, requests: List[Request]) -> None:
        """Return popped requests to the front of the message queue, in
        order: a cache hit the world did not grant this cycle rides the
        next cycle's bitmask. Requests whose entry is gone (the shutdown
        fan-out took it) are dropped, or a handle would complete
        twice."""
        with self._lock:
            live = [r for r in requests if r.tensor_name in self._table]
            if live:
                self._message_queue[:0] = live

    def queue_pending(self) -> bool:
        with self._lock:
            return bool(self._message_queue)

    def peek_entries(self, names) -> Optional[List[TensorTableEntry]]:
        """The entries for ``names`` without removing them, or None if
        any is absent: a speculative cycle packs its payload from live
        entries, which stay in the table until the world grants the bid
        (a denied bid leaves them to the classic path, which pops
        them)."""
        with self._lock:
            table = self._table
            try:
                return [table[n] for n in names]
            except KeyError:
                return None

    def pop_entries(self, names) -> List[TensorTableEntry]:
        """Remove and return the present entries among ``names``."""
        with self._lock:
            table = self._table
            return [table.pop(n) for n in names if n in table]

    def pop_entry_if_present(self, name: str):
        with self._lock:
            self._message_queue = [m for m in self._message_queue
                                   if m.tensor_name != name]
            return self._table.pop(name, None)

    def pop_all(self) -> List[TensorTableEntry]:
        """Remove and return every pending entry (shutdown fan-out)."""
        with self._lock:
            entries = list(self._table.values())
            self._table.clear()
            self._message_queue = []
            return entries


class HandleManager:
    """Integer handles for async ops; poll or wait on their status."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._last = 0
        self._results: Dict[int, Optional[Status]] = {}
        self._outputs: Dict[int, Any] = {}

    def allocate(self) -> int:
        return self.allocate_many(1)[0]

    def allocate_many(self, n: int) -> List[int]:
        with self._lock:
            first = self._last + 1
            self._last += n
            handles = list(range(first, self._last + 1))
            for h in handles:
                self._results[h] = None
            return handles

    def poll(self, handle: int) -> bool:
        with self._lock:
            if handle not in self._results:
                raise ValueError(f"Invalid handle {handle}")
            return self._results[handle] is not None

    def mark_done(self, handle: int, status: Status,
                  output: Any = None) -> None:
        with self._cv:
            # Output before status: wait() returns once the status is set.
            self._outputs[handle] = output
            self._results[handle] = status
            self._cv.notify_all()

    def wait(self, handle: int, timeout: Optional[float] = None) -> Status:
        with self._cv:
            if handle not in self._results:
                raise ValueError(f"Invalid handle {handle}")
            if not self._cv.wait_for(
                    lambda: self._results[handle] is not None, timeout):
                raise TimeoutError(f"Timed out waiting for handle {handle}")
            return self._results[handle]

    def release(self, handle: int) -> Any:
        """Return the output and forget the handle."""
        with self._lock:
            self._results.pop(handle, None)
            return self._outputs.pop(handle, None)
