"""Horovod Timeline: a Chrome-tracing profile of every collective.

Counterpart of ``horovod_tpu/common/timeline.py`` (:1-259), with the
reference's vocabulary: one trace "process" per tensor name,
``NEGOTIATE_<OP>`` spans with a tick per rank as it reports, a
top-level ``<OP>`` span with the activities ``QUEUE``,
``MEMCPY_IN_FUSION_BUFFER``, ``COLLECTIVE`` and
``MEMCPY_OUT_FUSION_BUFFER`` nested in it, and ``CYCLE_START`` instants.
Rank 0 writes it, on a thread of its own fed by a bounded queue, when
``HOROVOD_TIMELINE`` names a file (``HOROVOD_TIMELINE_MARK_CYCLES=1``
adds the cycle marks). The spans here are plain begin/end pairs: the
port's planes complete every batch on the background loop, so the
reference's deferred (async-nestable) spans have no use yet.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from typing import Dict, Optional

from horovod_tpu_torch.common.message import RequestType

ACT_QUEUE = "QUEUE"
ACT_MEMCPY_IN_FUSION_BUFFER = "MEMCPY_IN_FUSION_BUFFER"
ACT_COLLECTIVE = "COLLECTIVE"
ACT_MEMCPY_OUT_FUSION_BUFFER = "MEMCPY_OUT_FUSION_BUFFER"


class _NoOpTimeline:
    """Disabled timeline: every hook is a no-op."""

    enabled = False
    dropped_events = 0

    def negotiate_start(self, name, request_type): pass
    def negotiate_rank_ready(self, name, rank): pass
    def negotiate_end(self, name): pass
    def start(self, name, op_name): pass
    def activity_start_all(self, names, activity): pass
    def activity_end_all(self, names): pass
    def end(self, name): pass
    def mark_cycle_start(self): pass
    def shutdown(self): pass


class Timeline(_NoOpTimeline):
    """Enabled timeline writing Chrome-tracing JSON."""

    enabled = True

    # Past this depth (a wedged disk) new events are dropped and
    # counted rather than held in memory without bound.
    DEFAULT_QUEUE_CAPACITY = 1 << 16

    def __init__(self, path: str, mark_cycles: bool = False,
                 queue_capacity: int = DEFAULT_QUEUE_CAPACITY):
        self.mark_cycles = mark_cycles
        self._queue: "queue.Queue[Optional[dict]]" = queue.Queue(
            maxsize=queue_capacity)
        self.dropped_events = 0
        self._pids: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._start_ts = time.monotonic()
        self._file = open(path, "w")
        self._writer = threading.Thread(target=self._write_loop,
                                        name="hvd-timeline-writer",
                                        daemon=True)
        self._writer.start()

    def _put(self, rec: dict) -> None:
        try:
            self._queue.put_nowait(rec)
        except queue.Full:
            self.dropped_events += 1

    def _write_loop(self):
        with self._file as f:
            f.write("[\n")
            first = True
            while True:
                rec = self._queue.get()
                if rec is None:
                    break
                if not first:
                    f.write(",\n")
                f.write(json.dumps(rec))
                first = False
                f.flush()
            f.write("\n]\n")

    def _pid(self, name: str) -> int:
        with self._lock:
            pid = self._pids.get(name)
            if pid is None:
                pid = len(self._pids) + 1
                self._pids[name] = pid
                self._put({"name": "process_name", "ph": "M",
                           "pid": pid, "args": {"name": name}})
                self._put({"name": "process_sort_index", "ph": "M",
                           "pid": pid, "args": {"sort_index": pid}})
            return pid

    def _emit(self, ph: str, name: str, event_name: str, **kw):
        rec = {"ph": ph, "pid": self._pid(name),
               "ts": int((time.monotonic() - self._start_ts) * 1e6)}
        if event_name:
            rec["name"] = event_name
        rec.update(kw)
        self._put(rec)

    def negotiate_start(self, name: str, request_type) -> None:
        self._emit("B", name, f"NEGOTIATE_{RequestType(request_type).name}")

    def negotiate_rank_ready(self, name: str, rank: int) -> None:
        self._emit("X", name, f"{rank}", dur=0)

    def negotiate_end(self, name: str) -> None:
        self._emit("E", name, "")

    def start(self, name: str, op_name: str) -> None:
        self._emit("B", name, op_name)

    def activity_start_all(self, names, activity: str) -> None:
        for name in names:
            self._emit("B", name, activity)

    def activity_end_all(self, names) -> None:
        for name in names:
            self._emit("E", name, "")

    def end(self, name: str) -> None:
        self._emit("E", name, "")

    def mark_cycle_start(self) -> None:
        if self.mark_cycles:
            self._emit("i", "cycle", "CYCLE_START", s="g")

    def shutdown(self) -> None:
        # The queue may be full behind a wedged disk: give the sentinel
        # a short window rather than hang the teardown.
        try:
            self._queue.put(None, timeout=1.0)
        except queue.Full:
            pass
        self._writer.join(timeout=5.0)


def create_timeline(path: str, mark_cycles: bool = False):
    """An enabled timeline when ``path`` names a file (rank 0 only)."""
    return Timeline(path, mark_cycles) if path else NOOP_TIMELINE


NOOP_TIMELINE = _NoOpTimeline()
