"""Asynchronous collective completion.

Counterpart of ``horovod_tpu/common/finalizer.py``, itself the analog of
Horovod's CUDA finalizer threads (``FinalizeCUDAQueue``): a backend that
has issued its collective hands the rest of the batch (waiting for the
collective, the postscale and unpack, the entries' callbacks) to a
detached thread of its own and returns ``Status.InProgress()``, so that
the background loop goes on negotiating instead of waiting. One thread
per batch, as in the reference: a small batch issued after a large one
may complete first.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List

from horovod_tpu_torch.common import logging as hlog


class Finalizer:
    """Detached per-batch completion threads with a drainable registry."""

    def __init__(self):
        self._lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        self._closed = False

    def submit(self, fn: Callable[[], None]) -> bool:
        """Run ``fn`` on a detached thread. False once draining has begun:
        the caller must then complete synchronously."""
        t = threading.Thread(target=self._run, args=(fn,),
                             name="hvd-finalizer", daemon=True)
        with self._lock:
            if self._closed:
                return False
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)
            # Started under the lock, so that drain() never joins a
            # registered thread that has not started.
            t.start()
        return True

    @staticmethod
    def _run(fn: Callable[[], None]) -> None:
        try:
            fn()
        except Exception as e:  # a closure must never kill the process
            hlog.error(f"finalizer task failed: {e!r}")

    def drain(self, timeout: float = 30.0) -> None:
        """Refuse new work and wait for the batches in flight: the loop's
        shutdown calls this, so that every issued collective fires its
        callbacks before the shutdown fan-out."""
        with self._lock:
            self._closed = True
            threads = list(self._threads)
        deadline = time.monotonic() + timeout
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        stuck = [t.name for t in threads if t.is_alive()]
        if stuck:
            hlog.error(f"finalizer drain timed out after {timeout}s with "
                       f"{len(stuck)} completion thread(s) still running; "
                       f"their collectives' callbacks will not fire")
