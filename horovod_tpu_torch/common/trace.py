"""The world trace plane: clock-aligned spans of every rank, straggler
attribution at each gather, and the flight recorder.

Counterpart of ``horovod_tpu/common/trace.py`` (:1-767), with plain
``threading`` locks where the reference takes ``lockdep`` locks (A6.9).
The pieces:

* :class:`ClockSync`: NTP-style offsets of each worker's clock against
  the coordinator's, from the control traffic there is anyway: the
  coordinator's PING gives t1, the worker's next TRACE frame echoes
  (t2, t3), its arrival gives t4; the sample of least round trip wins.
* :class:`TraceCollector` and :class:`WorldTraceWriter`: each rank
  batches its spans (bounded, drops counted) into TAG_TRACE frames, and
  rank 0 writes one Chrome trace (``HOROVOD_TPU_TRACE``) with a track
  per rank, its times in the coordinator's clock and the world-identical
  cycle number on every span.
* :class:`StragglerTracker`: rank 0 stamps each rank's arrival at every
  negotiation gather and attributes the cycle's critical path
  (``hvd_cycle_skew_seconds``, per-rank lag gauges and last-arriver
  counters, and the stall report's line).
* :class:`FlightRecorder`: a fixed ring of recent cycle, abort, fault
  and stall events, on by default (``HOROVOD_TPU_FLIGHT=0`` gives the
  no-op), dumped as JSONL into ``HOROVOD_TPU_FLIGHT_DIR`` on every world
  abort and on SIGUSR2.

The recorder and the clock table are process-lifetime singletons, so
that modules without a runtime in hand (``common/faults.py``) record
too.
"""

from __future__ import annotations

import json
import os
import queue
import signal
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

from horovod_tpu_torch.common import config as hconfig
from horovod_tpu_torch.common.wire import (
    EV_ABORT, EV_CYCLE, EV_ELASTIC, EV_FAULT, EV_MARK, EV_NAMES,
    EV_SELFOP, EV_STALL, EV_TEARDOWN, SPAN_MARK, SPAN_SLICE,
    combine_trace_frames, parse_trace_frame, serialize_trace_frame,
)

__all__ = [
    "EV_CYCLE", "EV_ABORT", "EV_ELASTIC", "EV_STALL", "EV_FAULT",
    "EV_TEARDOWN", "EV_MARK", "EV_SELFOP", "ClockSync", "TraceCollector",
    "NOOP_TRACE", "FlightRecorder", "NOOP_RECORDER", "flight",
    "clock", "StragglerTracker", "WorldTraceWriter",
    "install_sigusr2", "serialize_trace_frame", "parse_trace_frame",
    "combine_trace_frames",
]


# ---------------------------------------------------------------------------
# Clock alignment
# ---------------------------------------------------------------------------

class _PeerClock:
    """Smoothed offset estimate for one peer: keep the recent samples
    and trust the one with the smallest round trip — queueing delay is
    the symmetric-delay violation that skews NTP math, and it only
    ever INFLATES the RTT, so min-RTT is the classic filter."""

    __slots__ = ("samples",)
    WINDOW = 32

    def __init__(self):
        self.samples: deque = deque(maxlen=self.WINDOW)

    def add(self, offset: float, rtt: float) -> None:
        self.samples.append((rtt, offset))

    def estimate(self) -> Optional[Tuple[float, float]]:
        """(offset_seconds, rtt_seconds) of the best recent sample, or
        None before any sample arrived. Offset is peer_clock minus
        coordinator_clock: coordinator time = peer time - offset."""
        if not self.samples:
            return None
        rtt, offset = min(self.samples)
        return offset, rtt


class ClockSync:
    """Both halves of the piggybacked clock exchange.

    Coordinator side: :meth:`ping_sent` records (seq -> t1) for every
    PING the beacon fans out; :meth:`echo` closes the loop when a
    worker's TRACE frame answers with (t2, t3) and the frame arrival
    supplies t4:

        rtt    = (t4 - t1) - (t3 - t2)
        offset = ((t2 - t1) + (t3 - t4)) / 2     # peer - coordinator

    Worker side: :meth:`ping_received` notes the latest coordinator
    PING (sender rank 0 only — local-root beacons carry their own
    clocks); :meth:`take_echo` hands the pending answer to the next
    TRACE frame build, consuming it so one ping is answered once.

    Thread-safety: pings arrive on the background loop, echoes are
    consumed there too, but rank 0's table is read from the stall
    report and the HTTP metrics thread — one small lock covers it.
    """

    PING_MEMORY = 128

    def __init__(self):
        self._lock = threading.Lock()
        self._pings: "OrderedDict[int, float]" = OrderedDict()
        self._peers: Dict[int, _PeerClock] = {}
        self._pending_echo: Optional[Tuple[int, float]] = None

    # -- coordinator side ------------------------------------------------
    def ping_sent(self, seq: int, t1: float) -> None:
        with self._lock:
            self._pings[seq] = t1
            while len(self._pings) > self.PING_MEMORY:
                self._pings.popitem(last=False)

    def echo(self, rank: int, seq: int, t2: float, t3: float,
             t4: float) -> None:
        with self._lock:
            t1 = self._pings.get(seq)
            if t1 is None:
                return  # answer to a ping we forgot: drop
            rtt = (t4 - t1) - (t3 - t2)
            if rtt < 0:
                return  # clocks moved mid-sample (suspend?): garbage
            offset = ((t2 - t1) + (t3 - t4)) / 2.0
            peer = self._peers.get(rank)
            if peer is None:
                peer = self._peers[rank] = _PeerClock()
            peer.add(offset, rtt)

    def offsets(self) -> Dict[int, Tuple[float, float]]:
        """{rank: (offset_s, rtt_s)} for every peer with samples."""
        with self._lock:
            out = {}
            for r, peer in self._peers.items():
                est = peer.estimate()
                if est is not None:
                    out[r] = est
            return out

    def offset_of(self, rank: int) -> float:
        """Best offset for ``rank`` (0.0 = coordinator itself, or no
        sample yet — spans then align uncorrected, which is exactly
        the pre-PR behavior)."""
        if rank == 0:
            return 0.0
        with self._lock:
            peer = self._peers.get(rank)
        if peer is None:
            return 0.0
        est = peer.estimate()
        return est[0] if est is not None else 0.0

    # -- worker side -----------------------------------------------------
    def ping_received(self, sender_rank: int, seq: int,
                      t2: float) -> None:
        if sender_rank != 0:
            return  # only the coordinator clock is the reference
        with self._lock:
            self._pending_echo = (seq, t2)

    def take_echo(self) -> Optional[Tuple[int, float, float]]:
        with self._lock:
            pending = self._pending_echo
            self._pending_echo = None
        if pending is None:
            return None
        seq, t2 = pending
        return (seq, t2, time.monotonic())


_CLOCK: Optional[ClockSync] = None
_CLOCK_LOCK = threading.Lock()


def clock() -> ClockSync:
    """The process-wide clock table (survives elastic re-inits — the
    offsets of a stable host stay useful across generations)."""
    global _CLOCK
    if _CLOCK is None:
        with _CLOCK_LOCK:
            if _CLOCK is None:
                _CLOCK = ClockSync()
    return _CLOCK


# ---------------------------------------------------------------------------
# Span collection (per rank)
# ---------------------------------------------------------------------------

class _NoOpTraceCollector:
    """Disabled collector: every hook is a cheap no-op, one shared
    instance so the disabled-path test can assert identity."""

    enabled = False
    dropped = 0

    def slice(self, name, ts, dur, cycle): pass
    def mark(self, name, ts, cycle): pass
    def drain(self): return [], 0


NOOP_TRACE = _NoOpTraceCollector()


class TraceCollector(_NoOpTraceCollector):
    """Bounded per-rank span buffer feeding TAG_TRACE frames. Appends
    are a lock + list append; past capacity new spans are DROPPED and
    counted (the drop count rides the next frame's section header) —
    a wedged control plane must never grow an unbounded span list."""

    enabled = True
    CAPACITY = 4096

    def __init__(self, capacity: int = CAPACITY):
        self._lock = threading.Lock()
        self._capacity = capacity
        self._spans: List[tuple] = []
        self.dropped = 0

    def _push(self, span: tuple) -> None:
        with self._lock:
            if len(self._spans) >= self._capacity:
                self.dropped += 1
                return
            self._spans.append(span)

    def slice(self, name: str, ts: float, dur: float,
              cycle: int) -> None:
        self._push((SPAN_SLICE, cycle, ts, dur, name))

    def mark(self, name: str, ts: float, cycle: int) -> None:
        self._push((SPAN_MARK, cycle, ts, 0.0, name))

    def drain(self):
        """-> (spans, dropped_since_last_drain)."""
        with self._lock:
            spans, self._spans = self._spans, []
            dropped, self.dropped = self.dropped, 0
        return spans, dropped


def create_collector(enabled: bool):
    return TraceCollector() if enabled else NOOP_TRACE


# ---------------------------------------------------------------------------
# Flight recorder (per rank, on by default)
# ---------------------------------------------------------------------------

class _NoOpRecorder:
    """Disabled recorder: record() is a no-op; dump() writes nothing.
    One shared instance (NOOP_RECORDER) so every instrumented write
    site is enumerable by identity in tests, like NOOP_METRIC."""

    enabled = False

    def record(self, ev, cycle=0, arg=None, note=""): pass
    def set_identity(self, rank): pass
    def events(self): return []
    def dump(self, cause="", origin=-1, path=None): return None


NOOP_RECORDER = _NoOpRecorder()


class FlightRecorder(_NoOpRecorder):
    """Fixed-size ring of recent world events. A write is one clock
    read + a lock + a slot store — cheap enough to stay on by default
    at one event per negotiation round. The ring never allocates
    after construction beyond the stored tuples themselves."""

    enabled = True

    def __init__(self, capacity: int = 512):
        self._lock = threading.Lock()
        self._ring: List[Optional[tuple]] = [None] * max(8, capacity)
        self._next = 0
        self._rank = hconfig.env_int("HOROVOD_RANK", -1)
        self._dumped = 0

    def set_identity(self, rank: int) -> None:
        """Current-world rank for dump headers (the LAUNCH identity
        from HOROVOD_RANK stays in the filename — stable across
        elastic renumbering)."""
        self._rank = rank

    def record(self, ev: int, cycle: int = 0,
               arg: Optional[int] = None, note: str = "") -> None:
        entry = (time.monotonic(), ev, cycle, arg, note)
        with self._lock:
            self._ring[self._next % len(self._ring)] = entry
            self._next += 1

    def events(self) -> List[tuple]:
        """Chronological snapshot of the ring. The lock is acquired
        best-effort: ``dump()`` runs inside the SIGUSR2 handler, which
        Python delivers ON the main thread — if that thread is mid-
        ``record()`` and already holds the lock, blocking here would
        wedge the very process the signal is trying to postmortem. A
        torn read of one in-flight slot is an acceptable last resort."""
        got = self._lock.acquire(timeout=0.2)
        try:
            n = len(self._ring)
            start = self._next
            out = [self._ring[(start + i) % n] for i in range(n)]
        finally:
            if got:
                self._lock.release()
        return [e for e in out if e is not None]

    def dump(self, cause: str = "", origin: int = -1,
             path: Optional[str] = None) -> Optional[str]:
        """Append one postmortem block (header line + event lines) to
        the rank's flight file; returns the path. Never raises — this
        runs on abort/signal paths where nothing may be assumed."""
        try:
            if path is None:
                base = hconfig.env_str("HOROVOD_TPU_FLIGHT_DIR", ".")
                launch_rank = hconfig.env_int("HOROVOD_RANK",
                                              self._rank)
                path = os.path.join(
                    base, f"hvd-flight-rank{max(launch_rank, 0)}"
                          f".pid{os.getpid()}.jsonl")
            events = self.events()
            now_wall, now_mono = time.time(), time.monotonic()
            header = {
                "flight": 1, "ts": now_wall, "mono": now_mono,
                "rank": self._rank,
                "launch_rank": hconfig.env_int("HOROVOD_RANK", -1),
                "pid": os.getpid(), "cause": cause, "origin": origin,
                "events": len(events), "dump": self._dumped,
            }
            try:
                header["build"] = build_info()
            except Exception:
                pass
            with open(path, "a") as f:
                f.write(json.dumps(header, separators=(",", ":"))
                        + "\n")
                for t, ev, cyc, arg, note in events:
                    rec = {"t": round(t, 6),
                           "ev": EV_NAMES.get(ev, ev), "cycle": cyc}
                    if arg is not None:
                        # `is not None`, not truthiness: rank 0 as an
                        # abort origin (and generation 0) are real args
                        rec["arg"] = arg
                    if note:
                        rec["note"] = note
                    f.write(json.dumps(rec, separators=(",", ":"))
                            + "\n")
            self._dumped += 1
            return path
        except Exception:
            return None


_FLIGHT = None
_FLIGHT_LOCK = threading.Lock()


def flight():
    """The process-wide flight recorder. Enabled by default; set
    ``HOROVOD_TPU_FLIGHT=0`` for the compiled-out no-op (every write
    site then holds/calls the shared NOOP_RECORDER). Capacity:
    ``HOROVOD_TPU_FLIGHT_EVENTS`` (default 512). Deliberately not a
    Config field — the recorder must exist before any Config snapshot
    does and survive re-inits."""
    global _FLIGHT
    if _FLIGHT is None:
        with _FLIGHT_LOCK:
            if _FLIGHT is None:
                if hconfig.env_bool("HOROVOD_TPU_FLIGHT", True):
                    _FLIGHT = FlightRecorder(hconfig.env_int(
                        "HOROVOD_TPU_FLIGHT_EVENTS", 512))
                else:
                    _FLIGHT = NOOP_RECORDER
    return _FLIGHT


def _reset_for_tests() -> None:
    """Drop the singletons so a test can re-read the env."""
    global _FLIGHT, _CLOCK
    with _FLIGHT_LOCK:
        _FLIGHT = None
    with _CLOCK_LOCK:
        _CLOCK = None


_SIGUSR2_INSTALLED = False


def install_sigusr2() -> bool:
    """Dump the flight ring on SIGUSR2 — the live-postmortem poke for
    a job that looks wedged but has not aborted. Main-thread only
    (signal module contract); installation failure is non-fatal."""
    global _SIGUSR2_INSTALLED
    if _SIGUSR2_INSTALLED:
        return True
    try:
        def _handler(signum, frame):
            flight().dump(cause="SIGUSR2")
        signal.signal(signal.SIGUSR2, _handler)
        _SIGUSR2_INSTALLED = True
        return True
    except (ValueError, OSError, AttributeError):
        return False  # non-main thread / unsupported platform


# ---------------------------------------------------------------------------
# Build identity (the hvd_build_info satellite)
# ---------------------------------------------------------------------------

def knobs_digest() -> str:
    """Short digest over every armed HOROVOD* knob (name=value,
    sorted) — two dumps with the same digest ran the same config."""
    import hashlib
    items = sorted(f"{k}={v}" for k, v in os.environ.items()
                   if k.startswith("HOROVOD"))
    return hashlib.sha256("\n".join(items).encode()).hexdigest()[:12]


def build_info() -> Dict[str, str]:
    """{version, native, knobs, flags}: which build and which knobs made
    a dump. ``version`` is the port's; the port has no native core yet
    (``ROADMAP.md`` A6.10), so ``native`` and ``flags`` are "none"."""
    from horovod_tpu_torch import __version__
    return {"version": __version__, "native": "none",
            "knobs": knobs_digest(), "flags": "none"}


# ---------------------------------------------------------------------------
# Straggler attribution (rank 0)
# ---------------------------------------------------------------------------

class StragglerTracker:
    """Per-cycle critical-path attribution from the coordinator's
    gather arrival stamps. ``note_gather`` runs on the background
    loop once per negotiation gather (only when the metrics or trace
    plane armed it); the report line and metric mirrors are read from
    other threads, so the window state sits under a small lock."""

    WINDOW = 1000

    def __init__(self, registry=None):
        from horovod_tpu_torch.common import metrics as hmetrics
        reg = registry if registry is not None \
            else hmetrics.NOOP_REGISTRY
        self._reg = reg
        self._lock = threading.Lock()
        self._window: deque = deque(maxlen=self.WINDOW)
        self._last_counts: Dict[int, int] = {}
        self._max_lag: Dict[int, float] = {}
        self._gathers = 0
        self._m_skew = reg.histogram(
            "hvd_cycle_skew_seconds",
            "per negotiation gather: last arrival minus first "
            "arrival (the cycle's straggler-induced critical path)",
            buckets=hmetrics.LATENCY_BUCKETS)
        self._m_lag: Dict[int, object] = {}
        self._m_last: Dict[int, object] = {}

    def _peer_metrics(self, r: int):
        lag = self._m_lag.get(r)
        if lag is None:
            from horovod_tpu_torch.common import metrics as hmetrics
            lag = self._reg.gauge(
                f'hvd_arrival_lag_seconds{{peer="{r}"}}',
                "worst observed gather arrival lag of this peer "
                "behind the cycle's first arrival",
                agg=hmetrics.AGG_MAX)
            self._m_lag[r] = lag
            self._m_last[r] = self._reg.counter(
                f'hvd_last_arriver_total{{peer="{r}"}}',
                "negotiation gathers this peer arrived LAST in")
        return lag, self._m_last[r]

    def note_gather(self, arrivals: Dict[int, float]) -> None:
        """``arrivals``: rank -> coordinator-monotonic stamp of that
        rank's request frame completing. Under the reference's hierarchical
        control plane (A6.3) the ranks are channel OWNERS (a local root
        answers for its host)."""
        if len(arrivals) < 1:
            return
        first = min(arrivals.values())
        last_rank, last_t = max(arrivals.items(),
                                key=lambda kv: (kv[1], kv[0]))
        skew = last_t - first
        self._m_skew.observe(skew)
        with self._lock:
            self._gathers += 1
            old = None
            if len(self._window) == self._window.maxlen:
                old = self._window[0]
            self._window.append(last_rank)
            self._last_counts[last_rank] = \
                self._last_counts.get(last_rank, 0) + 1
            if old is not None:
                self._last_counts[old] -= 1
            for r, t in arrivals.items():
                lag = t - first
                if lag > self._max_lag.get(r, -1.0):
                    self._max_lag[r] = lag
                    gauge, _ = self._peer_metrics(r)
                    gauge.set(lag)
        _, counter = self._peer_metrics(last_rank)
        counter.inc()

    def window_stats(self) -> Dict[str, object]:
        """Snapshot of the attribution window for the supervision
        policy (A9): gather count, window occupancy,
        per-rank last-arriver counts and worst lags."""
        with self._lock:
            return {
                "window": len(self._window),
                "gathers": self._gathers,
                "last_counts": dict(self._last_counts),
                "max_lag": dict(self._max_lag),
            }

    def report_line(self) -> str:
        """'rank 3 last-arriver in 84% of the last 1000 gathers
        (max lag 120.0ms)' — worst offenders first, empty before any
        gather was stamped."""
        with self._lock:
            n = len(self._window)
            if n == 0:
                return ""
            worst = sorted(
                ((c, r) for r, c in self._last_counts.items() if c > 0),
                reverse=True)[:3]
            parts = []
            for c, r in worst:
                lag = self._max_lag.get(r, 0.0)
                parts.append(f"rank {r} last-arriver in "
                             f"{100.0 * c / n:.0f}% of the last "
                             f"{n} gathers (max lag "
                             f"{lag * 1000.0:.1f}ms)")
        return "; ".join(parts)


# ---------------------------------------------------------------------------
# The merged world trace (rank 0)
# ---------------------------------------------------------------------------

class WorldTraceWriter:
    """Rank 0's fold point for TAG_TRACE frames: one Chrome-trace
    (catapult) JSON file with a track ("process") per rank, span
    timestamps corrected into the coordinator clock via the
    ClockSync offset table, and the world cycle number in every
    span's args. Writer thread + bounded queue, exactly the Timeline
    discipline — a sick disk drops spans, never blocks the control
    plane."""

    QUEUE_CAPACITY = 1 << 16

    def __init__(self, path: str, clock_sync: Optional[ClockSync] = None):
        self._path = path
        self._clock = clock_sync if clock_sync is not None else clock()
        self._queue: "queue.Queue[Optional[dict]]" = queue.Queue(
            maxsize=self.QUEUE_CAPACITY)
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._seen_ranks: set = set()
        self._last_ts: Dict[int, float] = {}
        self.dropped_events = 0
        self.spans_written = 0
        self._writer = threading.Thread(target=self._write_loop,
                                        name="hvd-worldtrace-writer",
                                        daemon=True)
        self._writer.start()

    def _put(self, rec: dict) -> None:
        try:
            self._queue.put_nowait(rec)
        except queue.Full:
            self.dropped_events += 1

    def _write_loop(self):
        with open(self._path, "w") as f:
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

    def _ensure_rank(self, rank: int) -> None:
        if rank in self._seen_ranks:
            return
        self._seen_ranks.add(rank)
        self._put({"name": "process_name", "ph": "M", "pid": rank,
                   "args": {"name": f"rank {rank}"}})
        self._put({"name": "process_sort_index", "ph": "M",
                   "pid": rank, "args": {"sort_index": rank}})

    def add_section(self, rank: int, spans, dropped: int = 0) -> None:
        """Write one rank's span batch, offset-corrected. The offset
        is sampled ONCE per batch and each track is clamped monotonic
        — a drifting estimate between batches must never make a
        rank's own track run backwards in the viewer."""
        if not spans and not dropped:
            return
        offset = self._clock.offset_of(rank)
        with self._lock:
            self._ensure_rank(rank)
            last = self._last_ts.get(rank, float("-inf"))
            for kind, cycle, ts, dur, name in spans:
                t = ts - offset - self._t0
                if t < last:
                    t = last
                last = max(last, t + max(dur, 0.0))
                rec = {"pid": rank, "tid": 0, "name": name,
                       "ts": int(t * 1e6),
                       "args": {"wc": cycle}}
                if kind == SPAN_MARK:
                    rec["ph"] = "i"
                    rec["s"] = "t"
                else:
                    rec["ph"] = "X"
                    rec["dur"] = int(max(dur, 0.0) * 1e6)
                self._put(rec)
                self.spans_written += 1
            if dropped:
                self._put({"pid": rank, "tid": 0, "ph": "i", "s": "t",
                           "name": f"TRACE_DROPPED {dropped}",
                           "ts": int(max(last, 0.0) * 1e6),
                           "args": {"dropped": dropped}})
            self._last_ts[rank] = last

    def ingest(self, owner_rank: int, payload: bytes) -> None:
        """A TAG_TRACE frame off the control tree (any thread that
        recvs control frames). Closes each section's clock-echo loop
        with THIS arrival stamp (t4), then writes its spans. A
        garbled frame is dropped — best-effort, like metrics."""
        t4 = time.monotonic()
        try:
            sections = parse_trace_frame(payload)
        except Exception:
            return
        for sec in sections:
            echo = sec.get("echo")
            if echo is not None:
                seq, t2, t3 = echo
                self._clock.echo(sec["rank"], seq, t2, t3, t4)
            self.add_section(sec["rank"], sec["spans"],
                             sec.get("dropped", 0))

    def close(self) -> None:
        try:
            self._queue.put(None, timeout=1.0)
        except queue.Full:
            pass
        self._writer.join(timeout=5.0)
