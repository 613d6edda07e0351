"""The metrics plane: per-rank counters, gauges and histograms, folded
into a world view on rank 0.

Counterpart of ``horovod_tpu/common/metrics.py`` (:1-597), with plain
``threading`` locks where the reference takes ``lockdep`` locks (the
lock-order and thread-affinity sanitizers are ``ROADMAP.md`` A6.9) and
without the scaling-efficiency feed of the reference's multichip
harness. The pieces:

* :class:`Counter`, :class:`Gauge` and :class:`Histogram`, handed out by
  a :class:`MetricsRegistry`, memoized by their full (labeled) name;
* the disabled path (``HOROVOD_TPU_METRICS`` unset, the default): the
  registry hands every call site the one shared :data:`NOOP_METRIC`,
  whose hooks are empty methods;
* the world fold: each rank sends its snapshot in a METRICS frame
  (``common/wire.py``) every ``HOROVOD_TPU_METRICS_INTERVAL`` seconds,
  out of band on the control channels, and rank 0's
  :class:`WorldAggregator` merges the latest frame of every rank;
* rank 0's read surfaces: ``GET /metrics`` in Prometheus text
  (:class:`MetricsHTTPServer`, ``HOROVOD_TPU_METRICS_PORT``), a JSONL
  log of world snapshots (``HOROVOD_TPU_METRICS_LOG``) and
  ``hvd.metrics()``.

Merge semantics: counters sum, gauges sum or take the max as declared
(peer heartbeat ages take the max), histograms add bucket by bucket
(their bounds are part of their identity). A name may carry Prometheus
labels inline (``hvd_ops_total{op="allreduce"}``): the whole string is
the key, and the renderer splits it back into name and labels.
"""

from __future__ import annotations

import json
import threading
import time

from bisect import bisect_left
from typing import Callable, Dict, List, Tuple

# Latency-shaped default buckets (seconds): negotiation rounds sit in
# the 100us-10ms band on a healthy host, collectives run up to seconds.
LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
# Ratio-shaped buckets (fusion-buffer fill, 0..1; the tail catches
# batches that overshoot the threshold by design — one tensor already
# over it ships alone).
RATIO_BUCKETS = (0.1, 0.25, 0.5, 0.75, 0.9, 1.0, 1.5)

KIND_COUNTER = "c"
KIND_GAUGE = "g"
KIND_HISTOGRAM = "h"

AGG_SUM = "sum"
AGG_MAX = "max"


class _NoOpMetric:
    """Disabled metric: every hook is a cheap no-op. One shared
    instance stands in for every metric of every kind, so the
    disabled-path test can assert identity (`is NOOP_METRIC`) on each
    instrumented call site."""

    enabled = False

    def inc(self, v=1): pass
    def set(self, v): pass
    def set_total(self, v): pass
    def observe(self, v): pass


NOOP_METRIC = _NoOpMetric()


class Counter:
    """Monotonic counter. ``inc`` takes the metric's lock — increments
    may arrive from the background loop, finalizer threads and the
    timeline writer; a GIL-raced ``+=`` would silently lose counts.
    ``set_total`` overwrites the total (mirror counters whose true
    source is elsewhere, e.g. the response cache's hit count)."""

    __slots__ = ("name", "help", "_v", "_lock")
    enabled = True

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, v=1) -> None:
        with self._lock:
            self._v += v

    def set_total(self, v) -> None:
        with self._lock:
            self._v = float(v)

    @property
    def value(self) -> float:
        return self._v

    def record(self) -> dict:
        rec = {"k": KIND_COUNTER, "v": self._v}
        if self.help:
            rec["help"] = self.help
        return rec


class Gauge:
    """Point-in-time value. ``set`` is a single attribute store
    (GIL-atomic); ``agg`` declares how the world fold combines ranks
    (queue depths sum, heartbeat ages max)."""

    __slots__ = ("name", "help", "agg", "_v")
    enabled = True

    def __init__(self, name: str, help: str = "", agg: str = AGG_SUM):
        if agg not in (AGG_SUM, AGG_MAX):
            raise ValueError(f"unknown gauge agg {agg!r}")
        self.name = name
        self.help = help
        self.agg = agg
        self._v = 0.0

    def set(self, v) -> None:
        self._v = float(v)

    @property
    def value(self) -> float:
        return self._v

    def record(self) -> dict:
        rec = {"k": KIND_GAUGE, "agg": self.agg, "v": self._v}
        if self.help:
            rec["help"] = self.help
        return rec


class Histogram:
    """Fixed-bucket histogram (+Inf bucket implicit at the end).
    ``observe`` is a bisect + two increments under the metric's lock;
    bounds are part of the metric's identity and must match across
    ranks for the world fold to add bucket-wise."""

    __slots__ = ("name", "help", "bounds", "_counts", "_sum", "_count",
                 "_lock")
    enabled = True

    def __init__(self, name: str, help: str = "",
                 buckets: Tuple[float, ...] = LATENCY_BUCKETS):
        bounds = tuple(float(b) for b in buckets)
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError("histogram buckets must be strictly "
                             f"increasing; got {buckets}")
        self.name = name
        self.help = help
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, v) -> None:
        i = bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def record(self) -> dict:
        with self._lock:
            rec = {"k": KIND_HISTOGRAM, "bounds": list(self.bounds),
                   "counts": list(self._counts), "sum": self._sum,
                   "count": self._count}
        if self.help:
            rec["help"] = self.help
        return rec


class _NoOpRegistry:
    """Disabled registry: every factory returns the shared no-op
    metric and snapshots are empty. Collectors are dropped — with
    metrics off nothing ever reads them."""

    enabled = False

    def counter(self, name, help=""):
        return NOOP_METRIC

    def gauge(self, name, help="", agg=AGG_SUM):
        return NOOP_METRIC

    def histogram(self, name, help="", buckets=LATENCY_BUCKETS):
        return NOOP_METRIC

    def add_collector(self, fn):
        pass

    def snapshot(self) -> dict:
        return {}


NOOP_REGISTRY = _NoOpRegistry()


class MetricsRegistry:
    """Per-rank metric store. Factories are memoized by full (labeled)
    name, so two call sites asking for the same metric share one
    object; a kind mismatch on a reused name is a programming error
    and raises. ``add_collector`` registers a callback run at the top
    of every :meth:`snapshot` — the hook mirror-metrics use to pull
    values whose true source lives elsewhere (cache counters, queue
    depth, per-peer heartbeat ages) without touching the hot paths
    that maintain them."""

    enabled = True

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: "Dict[str, object]" = {}
        self._collectors: List[Callable[[], None]] = []

    def _get(self, name: str, factory, kind):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory(name)
                self._metrics[name] = m
            elif not isinstance(m, kind):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, lambda n: Counter(n, help), Counter)

    def gauge(self, name: str, help: str = "",
              agg: str = AGG_SUM) -> Gauge:
        g = self._get(name, lambda n: Gauge(n, help, agg), Gauge)
        if g.agg != agg:
            # agg is part of the metric's identity (merge_into fails
            # loudly on it cross-rank) — the same must hold within a
            # rank, or a second call site silently folds wrong.
            raise ValueError(
                f"gauge {name!r} already registered with "
                f"agg={g.agg!r}, not {agg!r}")
        return g

    def histogram(self, name: str, help: str = "",
                  buckets: Tuple[float, ...] = LATENCY_BUCKETS
                  ) -> Histogram:
        h = self._get(name, lambda n: Histogram(n, help, buckets),
                      Histogram)
        if h.bounds != tuple(float(b) for b in buckets):
            raise ValueError(
                f"histogram {name!r} already registered with bounds "
                f"{h.bounds}, not {tuple(buckets)}")
        return h

    def add_collector(self, fn: Callable[[], None]) -> None:
        with self._lock:
            self._collectors.append(fn)

    def snapshot(self) -> dict:
        """{labeled name: record} — a self-contained copy safe to
        merge, encode or render after the registry moves on."""
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            fn()
        with self._lock:
            metrics = list(self._metrics.items())
        return {name: m.record() for name, m in metrics}


# -- merge semantics (the world fold) ---------------------------------------

def merge_into(dst: dict, src: dict) -> dict:
    """Fold snapshot ``src`` into ``dst`` in place (and return it):
    counters and histogram buckets add, gauges combine per their
    ``agg``. Mixed kinds or mismatched histogram bounds under one name
    mean the ranks disagree about the metric's identity — fail loudly
    rather than aggregate garbage."""
    for name, rec in src.items():
        cur = dst.get(name)
        if cur is None:
            dst[name] = {k: (list(v) if isinstance(v, list) else v)
                         for k, v in rec.items()}
            continue
        if cur["k"] != rec["k"]:
            raise ValueError(
                f"metric {name!r} kind mismatch across ranks: "
                f"{cur['k']!r} vs {rec['k']!r}")
        if rec["k"] == KIND_COUNTER:
            cur["v"] += rec["v"]
        elif rec["k"] == KIND_GAUGE:
            if cur.get("agg") != rec.get("agg"):
                raise ValueError(
                    f"gauge {name!r} agg mismatch across ranks")
            if rec.get("agg") == AGG_MAX:
                cur["v"] = max(cur["v"], rec["v"])
            else:
                cur["v"] += rec["v"]
        else:
            if list(cur["bounds"]) != list(rec["bounds"]):
                raise ValueError(
                    f"histogram {name!r} bucket bounds differ across "
                    f"ranks")
            cur["counts"] = [a + b for a, b in zip(cur["counts"],
                                                   rec["counts"])]
            cur["sum"] += rec["sum"]
            cur["count"] += rec["count"]
    return dst


# -- Prometheus text rendering ----------------------------------------------

def _split_labels(full_name: str) -> Tuple[str, str]:
    """'name{a="b"}' -> ('name', 'a="b"'); 'name' -> ('name', '')."""
    i = full_name.find("{")
    if i < 0:
        return full_name, ""
    return full_name[:i], full_name[i + 1:].rstrip("}")


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() else repr(f)


def render_prometheus(snap: dict) -> str:
    """Prometheus text exposition (version 0.0.4) of a snapshot.
    Histograms render the conventional ``_bucket{le=...}`` cumulative
    series plus ``_sum`` and ``_count``; inline labels on the metric
    name merge with the ``le`` label. ``# HELP`` renders when the
    record carries one (the wire codec drops help to keep frames
    compact, so world views document the metrics rank 0 also owns)."""
    lines: List[str] = []
    typed: set = set()
    for full_name in sorted(snap):
        rec = snap[full_name]
        base, labels = _split_labels(full_name)
        kind = rec["k"]
        if base not in typed:
            typed.add(base)
            help_text = rec.get("help")
            if help_text:
                lines.append(
                    f"# HELP {base} "
                    + help_text.replace("\\", r"\\").replace("\n",
                                                             r"\n"))
            ptype = {KIND_COUNTER: "counter", KIND_GAUGE: "gauge",
                     KIND_HISTOGRAM: "histogram"}[kind]
            lines.append(f"# TYPE {base} {ptype}")
        if kind in (KIND_COUNTER, KIND_GAUGE):
            suffix = f"{{{labels}}}" if labels else ""
            lines.append(f"{base}{suffix} {_fmt(rec['v'])}")
            continue
        cum = 0
        bounds = list(rec["bounds"]) + [float("inf")]
        for b, c in zip(bounds, rec["counts"]):
            cum += c
            le = f'le="{_fmt(b)}"'
            lab = f"{labels},{le}" if labels else le
            lines.append(f"{base}_bucket{{{lab}}} {cum}")
        suffix = f"{{{labels}}}" if labels else ""
        lines.append(f"{base}_sum{suffix} {_fmt(rec['sum'])}")
        lines.append(f"{base}_count{suffix} {rec['count']}")
    return "\n".join(lines) + "\n"


# -- world aggregation ------------------------------------------------------

class WorldAggregator:
    """Rank 0's fold point. The control plane delivers each owner
    channel's latest METRICS frame (a local root's frame already sums
    its whole host) through :meth:`ingest`; the local registry's
    snapshot arrives through :meth:`update_local`. :meth:`world`
    merges the latest view of every reporter — sums of totals, not
    deltas, so a dropped or reordered frame can never double-count.
    Thread-safe: ingest runs on the background loop, reads come from
    the HTTP server thread and the public API."""

    def __init__(self, size: int = 1):
        self._lock = threading.Lock()
        self._size = size
        self._local: dict = {}
        # owner rank -> (nranks represented, snapshot, recv time)
        self._owners: Dict[int, tuple] = {}
        # name -> identity (kind + agg/bounds): the O(metrics)
        # admission check for arriving frames. The local registry is
        # authoritative; accepted frames register the names it lacks.
        self._ident: Dict[str, tuple] = {}

    @staticmethod
    def _identity(rec: dict) -> tuple:
        k = rec["k"]
        if k == KIND_GAUGE:
            return (k, rec.get("agg", AGG_SUM))
        if k == KIND_HISTOGRAM:
            return (k, tuple(rec["bounds"]))
        return (k,)

    def _register_idents(self, snap: dict) -> None:
        for name, rec in snap.items():
            self._ident[name] = self._identity(rec)

    def update_local(self, snap: dict) -> None:
        with self._lock:
            self._local = snap
            self._register_idents(snap)

    def ingest(self, owner_rank: int, payload: bytes) -> None:
        from horovod_tpu_torch.common import wire
        try:
            nranks, snap = wire.parse_metrics_frame(payload)
        except Exception:
            return  # a garbled best-effort frame is dropped, not fatal
        with self._lock:
            # Admission check against the persistent identity map —
            # O(metrics) per frame, NOT a re-merge of every stored
            # snapshot (ingest runs on the coordinator's negotiation
            # thread, inside the gather loop). A parseable frame whose
            # identities disagree (skewed code across ranks — a
            # kind/agg/bucket change mid-rolling-restart) is DROPPED,
            # never stored to poison later world() folds.
            for name, rec in snap.items():
                known = self._ident.get(name)
                if known is not None and known != self._identity(rec):
                    return
            self._register_idents(snap)
            self._owners[owner_rank] = (nranks, snap,
                                        time.monotonic())

    def world(self) -> dict:
        with self._lock:
            merged: dict = {}
            merge_into(merged, self._local)
            reporting = 1 if self._local else 0
            for nranks, snap, _ts in self._owners.values():
                # Belt to ingest's trial-merge braces: a frame that
                # stops merging (the LOCAL registry grew a conflicting
                # metric after the frame was admitted) is skipped
                # whole — folded into a scratch copy first so a
                # half-merged frame can never leak partial sums — and
                # the read surfaces never raise from the fold.
                try:
                    trial = merge_into({}, merged)
                    merge_into(trial, snap)
                except ValueError:
                    continue
                merged = trial
                reporting += nranks
            merged["hvd_ranks_reporting"] = {
                "k": KIND_GAUGE, "agg": AGG_SUM, "v": float(reporting)}
            merged["hvd_world_size"] = {
                "k": KIND_GAUGE, "agg": AGG_MAX, "v": float(self._size)}
            return merged


# -- rank-0 read surfaces ---------------------------------------------------

class MetricsHTTPServer:
    """``GET /metrics`` (Prometheus text) + ``GET /metrics.json`` on a
    stdlib ThreadingHTTPServer daemon thread. ``port=0`` binds an
    ephemeral port, reported via :attr:`port` (tests and the
    ``hvd.metrics()`` API read it)."""

    def __init__(self, world_fn: Callable[[], dict], port: int = 0,
                 host: str = ""):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib handler contract)
                try:
                    snap = world_fn()
                    if self.path.startswith("/metrics.json"):
                        body = json.dumps(snap).encode()
                        ctype = "application/json"
                    elif self.path.startswith("/metrics"):
                        body = render_prometheus(snap).encode()
                        ctype = ("text/plain; version=0.0.4; "
                                 "charset=utf-8")
                    else:
                        self.send_error(404)
                        return
                except Exception as e:  # never kill the serving thread
                    self.send_error(500, str(e))
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # scrapes are not log events
                pass

        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="hvd-metrics-http", daemon=True)
        self._thread.start()

    def close(self) -> None:
        try:
            self._server.shutdown()
            self._server.server_close()
        except Exception:
            pass


class JsonlMetricsLog:
    """Appends one ``{"ts": ..., "world": {...}}`` line per publish
    interval — the offline twin of the HTTP endpoint for deployments
    without a scraper. Write failures disable the log (a full disk
    must not take the control plane down with it)."""

    def __init__(self, path: str):
        self._path = path
        self._dead = False

    def append(self, snap: dict) -> None:
        if self._dead:
            return
        try:
            with open(self._path, "a") as f:
                f.write(json.dumps({"ts": time.time(), "world": snap},
                                   separators=(",", ":")) + "\n")
        except OSError:
            self._dead = True


def create_registry(enabled: bool):
    """The registry for one runtime: a real one when the metrics plane
    is on, the shared no-op otherwise (the reference's tenant labels are
    ``ROADMAP.md`` A9)."""
    return MetricsRegistry() if enabled else NOOP_REGISTRY
