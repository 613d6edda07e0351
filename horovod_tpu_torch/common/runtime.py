"""The background coordination loop: the heart of the runtime.

Counterpart of ``horovod_tpu/common/runtime.py``: ``enqueue`` (:698),
``enqueue_group`` (:735), the background loop (:863, :1767),
``_coordinate`` (:2808), ``_check_stall`` (:2736),
``_perform_operations`` (:2909-3034), the response cache's share of
the loop (:1035-1360, :1758, :2095-2530, :2700), the world abort
(:801-880), the fault-injection ticks (:155, :1780, :2412, :2914) and
the metrics and trace planes (:418-656, :834-860, :1715-1760, :1944,
:2529-2643, :2744-2750, :2984-3016).
One daemon thread per process runs a negotiation cycle every
``HOROVOD_CYCLE_TIME`` ms: it drains this rank's request queue, gathers
every rank's requests at the coordinator, which fuses the ready tensors
under the fusion threshold and broadcasts the agreed ResponseList, and
runs that list through the backends. Enqueues return at once; completion comes back through each
entry's callback.

The response cache (on by default, ``HOROVOD_CACHE_*``). Negotiated
verdicts are kept in a world-coherent ``ResponseCache``; a request whose
signature is cached rides the cycle frame as one bit of a mask, the
coordinator ANDs the ranks' masks into a grant, and every rank replays
the granted slots from its own cache in ascending slot order, fused with
the threshold the coordinator broadcast. Misses, changed signatures and
uncacheable ops ride the same frame as Requests and repopulate the cache
in broadcast order. A cycle that caught only the front of a step's
gradient burst is held, woken by each enqueue, until the rest arrives
(``_absorb_burst``). Once a pure-hit mask was granted in full, the next
cycle with that mask speculates: each rank attaches its packed fused
allreduce buffers to the bitmask frame, and when every rank bid the same
mask the coordinator sums them in rank order and broadcasts the grant
and the result in one frame, one world round per step where the socket
star would carry the batch anyway. Anything else (a peer that did not
bid, a new tensor, a plane with a transport of its own) runs the classic
two-round path, and a denied bid leaves its entries in the table for it.
Ranks whose caches disagree fail with ``ConnectionError`` on every rank.

A backend may complete a batch on a finalizer thread
(``common/finalizer.py``) and return ``Status.InProgress()``; the loop
then fires no callbacks for it and goes on cycling, and its shutdown
drains the finalizer before it fails what is left.

The world abort. A rank that sees a peer fail (a closed socket, silence
past the heartbeat deadline, an ABORT notice, a data-plane error or the
stall-shutdown threshold) first sweeps its channels briefly for an ABORT
that names another origin (a blame inferred from a transport error can
race the notice of the rank that found the failure), records the abort,
fans it to every peer it can still reach, and completes every pending
handle, CUDA tensors' included, with ``Status.WorldAborted(origin,
cause)``. Every hold of the loop stays under a quarter of the heartbeat
timeout, and its idle backoff under a half: a rank that holds sends
nothing, and its next frame is its only proof of life.

Wire compression: every request carries this rank's wire-dtype proposal
(``HOROVOD_COMPRESSION`` for float32/float64 allreduces, allgathers and
reducescatters), the coordinator stamps the verdict and the algorithm on
each fused response, and the speculative cycle carries a cast wire's
payload in the wire dtype (an int8 batch takes the classic path, whose
coordinator dequantizes the ranks' payloads).

Left out until their slices (``ROADMAP.md`` A6 and A9): the ICI plane
and the native steady plan (which ride the cache), overlapped cycles,
elastic worlds, self-operation, tenancy and autotune.

The observability planes. The metrics plane (``HOROVOD_TPU_METRICS=1``)
registers the reference's series under its names (a series of a plane
the port lacks, native steady cycles, arena bytes, overlap, reads 0);
each rank sends its snapshot every interval in a METRICS frame and rank
0 folds the world view, served by ``hvd.metrics()``, ``GET /metrics``
and a JSONL log. The trace plane (``HOROVOD_TPU_TRACE=<path>``) records
a ROUND span per world round, an issue-side span per executed batch and
an ABORT mark, each with the world-identical round number; rank 0
writes them all into one Chrome trace in its clock, and stamps every
rank's arrival at each gather for the straggler attribution. The
flight recorder is on by default and dumps its ring on every world
abort and on SIGUSR2.

The loop keeps counts that say what it costs (``stats``): cycles,
responses and the tensors in them, the responses each backend ran
(``responses.<backend name>``), the seconds of negotiation
(building, gathering, coordinating and broadcasting the lists), of
execution (replaying and running the responses) and of burst holds, and
the cache's: cached cycles (negotiated through the bitmask alone), spec
cycles (completed by the fused round), spec bids and denials, the bytes
of bids left unused (``spec_unused_bytes``: a bid the world answered the
classic way, which packs its batch again), and the cache's hits, misses
and evictions.
"""

from __future__ import annotations

import threading
import time
import warnings
from collections import OrderedDict
from typing import Dict, List, Optional

import torch

from horovod_tpu_torch.common import faults
from horovod_tpu_torch.common import logging as hlog
from horovod_tpu_torch.common import metrics as hmetrics
from horovod_tpu_torch.common import trace as htrace
from horovod_tpu_torch.common import wire
from horovod_tpu_torch.common import wire_dtype as _wd
from horovod_tpu_torch.common.config import Config
from horovod_tpu_torch.common.controller import Controller
from horovod_tpu_torch.common.coordinator import (
    CACHEABLE_REQUESTS, CACHEABLE_RESPONSES, MessageTable, ResponseCache,
    StallInspector, construct_response, fuse_responses, iter_set_bits,
)
from horovod_tpu_torch.common.finalizer import Finalizer
from horovod_tpu_torch.common.invariants import world_coherent
from horovod_tpu_torch.common.message import (
    CacheCycleRequest, CacheCycleResponse, DataType, Request, RequestList,
    RequestType, Response, ResponseList, ResponseType, datatype_size,
    datatype_to_torch_dtype, torch_dtype_to_datatype,
)
from horovod_tpu_torch.common.status import (
    DUPLICATE_NAME_ERROR_FMT, SHUT_DOWN_ERROR, Status, WorldAbortedError,
    world_abort_message,
)
from horovod_tpu_torch.common.tensor_table import (
    HandleManager, TensorTable, TensorTableEntry,
)
from horovod_tpu_torch.common.timeline import (
    ACT_COLLECTIVE, ACT_QUEUE, NOOP_TIMELINE, create_timeline,
)
from horovod_tpu_torch.ops.operation_manager import OperationManager
from horovod_tpu_torch.ops.socket_ops import _accumulate


def _buffer_tensor(buf, dt: DataType, copy: bool) -> torch.Tensor:
    """A segment buffer (a memoryview over a frame, or any bytes-like
    object) as a flat CPU tensor of ``dt``; with ``copy`` a fresh one,
    else a view of the buffer (torch warns about a read-only one, which
    the callers only read)."""
    tdt = datatype_to_torch_dtype(dt)
    if not len(memoryview(buf).cast("B")):
        return torch.empty(0, dtype=tdt)
    if copy:
        return torch.frombuffer(bytearray(buf), dtype=tdt)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.frombuffer(buf, dtype=tdt)


class Runtime:
    """Process state and the background thread."""

    # Empty cycles before the idle backoff ramp starts.
    _IDLE_GRACE = 16

    # How long a cache hit may stay ungranted (some rank has not queued
    # that tensor yet) before it goes the full way, where the
    # coordinator's stall warnings and shutdown see it: bit-queued
    # requests never enter the MessageTable. Healthy hits are granted
    # within a cycle or two.
    _BIT_DEMOTE_S = 5.0

    # Speculative bids of one mask that the world answers with a classic
    # full grant (a peer that never speculates) before that mask stops
    # bidding.
    _SPEC_DENY_LIMIT = 3

    # In steady state, how long an idle rank waits for its producer
    # before it starts an empty round: no round can grant anything until
    # every rank submits again.
    _STEADY_IDLE_S = 0.25

    # Steady-state predictions kept (several sets stay steady in real
    # loops: alternating gradient buckets, an every-N-steps metric).
    _STEADY_CAP = 8

    # Floor of the burst hold's budget (_absorb_burst): a cycle that
    # caught the front of a step's burst waits at most
    # max(2 x cycle time, this) for the rest, woken by each enqueue.
    # While a rank holds, the world waits in the gather for its frame
    # anyway; a fragment negotiated instead costs a mispredicted cycle
    # and another round for the rest.
    _BURST_HOLD_S = 0.02

    def __init__(self, config: Config, controller: Controller,
                 op_manager: OperationManager, device=None):
        self.config = config
        self.controller = controller
        self.op_manager = op_manager
        # The CUDA device the loop's thread makes current (the current
        # device is per thread), None on the CPU.
        self.device = device
        self.tensor_table = TensorTable()
        self.handle_manager = HandleManager()
        self.timeline = NOOP_TIMELINE
        if controller.rank == 0 and config.timeline_path:
            self.timeline = create_timeline(config.timeline_path,
                                            config.timeline_mark_cycles)
        op_manager.attach_timeline(self.timeline)
        self.finalizer = Finalizer()
        op_manager.attach_finalizer(self.finalizer)
        self._dtypes: Dict[str, DataType] = {}
        # name -> elements per dim-0 row (allgather fusion accounting).
        self._slice_numels: Dict[str, int] = {}
        self._stall = StallInspector(
            controller.size,
            warning_time=config.stall_check_time_seconds,
            shutdown_time=config.stall_shutdown_time_seconds,
            disabled=config.stall_check_disable)
        self._message_table = MessageTable(
            on_remove=self._stall.tensor_completed) \
            if controller.rank == 0 else None
        self._shutdown_requested = threading.Event()
        self._done = threading.Event()
        self._teardown_started = False
        self._thread: Optional[threading.Thread] = None
        # (origin_rank, cause) once the world has aborted.
        self._abort_info: Optional[tuple] = None
        # Lifetime count of executed responses: fault injection's op
        # triggers key off it, to land a failure squarely mid-collective.
        self._op_count = 0
        faults.load_env()
        # This rank's wire-dtype proposal; the coordinator's verdict
        # rides each Response (and the cache with it).
        self._wire_propose = _wd.wire_code_of(config.compression)
        self._wire_policy = _wd.StaticWirePolicy()
        self._idle_cycles = 0
        # Set by enqueue and request_shutdown: wakes a sleeping loop.
        self._wake = threading.Event()
        self.stats = {"cycles": 0, "responses": 0, "tensors": 0,
                      "negotiate_s": 0.0, "execute_s": 0.0, "hold_s": 0.0,
                      "cached_cycles": 0, "spec_cycles": 0, "spec_bids": 0,
                      "spec_denials": 0, "spec_unused_bytes": 0,
                      "cache_hits": 0,
                      "cache_misses": 0, "cache_evictions": 0}
        # -- the response cache --------------------------------------
        self._cache: Optional[ResponseCache] = None
        if config.cache_enabled and config.cache_capacity > 0:
            self._cache = ResponseCache(config.cache_capacity)
        # name -> (signature, dtype, slice numel) of a cacheable request
        # sent the full way, taken when its response populates the cache.
        self._pending_sigs: Dict[str, tuple] = {}
        # (grant mask, threshold) -> fused replay plan, for one epoch.
        self._replay_plans: Dict[tuple, List[Response]] = {}
        self._replay_epoch = -1
        # (epoch, hit mask) -> serialized pure-hit frame.
        self._frame_memo: Dict[tuple, bytes] = {}
        # name -> when its cache hit first went ungranted.
        self._bit_pending_since: Dict[str, float] = {}
        self._spec_ok = (self._cache is not None
                         and config.cache_speculative)
        # Recently fully granted pure-hit masks -> their name sets
        # (insertion-ordered, at most _STEADY_CAP): the steady-state
        # predictions, which are also the burst hold's reference sets.
        # Only the broadcast verdict moves them (with this rank's bid).
        self._steady: "OrderedDict[int, frozenset]" = OrderedDict()
        self._steady_epoch = -1
        # The coordinator's fusion threshold, broadcast on cached
        # cycles: replay and speculation fuse with the world's value.
        self._world_fusion_threshold = config.fusion_threshold_bytes
        # mask -> consecutive speculative bids answered with a classic
        # full grant.
        self._spec_denied: Dict[int, int] = {}
        # [(fused Response, entries, backend)] of the speculative frame
        # in flight this cycle, None when the cycle is not speculative,
        # and the bytes of its packed payloads.
        self._spec_inflight = None
        self._spec_bytes = 0
        # Hits the last cycle bid but the world did not grant, requeued:
        # their peers were granted and will not come again, so they
        # never start a burst hold.
        self._requeued_names: frozenset = frozenset()
        self._init_metrics_plane()
        self._init_trace_plane()

    # -- the observability planes ----------------------------------------
    def _init_metrics_plane(self) -> None:
        """The registry (the shared no-op one while the plane is off,
        whose hooks hand every call site NOOP_METRIC) and the reference's
        series; on rank 0 the world aggregator and its read surfaces."""
        config, controller = self.config, self.controller
        self.metrics = hmetrics.create_registry(config.metrics_enabled)
        self._metrics_on = bool(config.metrics_enabled)
        reg = self.metrics
        self._m_cycle_s = reg.histogram(
            "hvd_cycle_seconds", "negotiation cycle wall time")
        self._m_negotiation_s = reg.histogram(
            "hvd_negotiation_seconds",
            "request gather -> response broadcast round trip")
        self._m_cycles = reg.counter("hvd_cycles_total")
        self._m_cached_cycles = reg.counter(
            "hvd_cached_cycles_total",
            "cycles negotiated purely via the cache bitmask")
        self._m_spec_cycles = reg.counter(
            "hvd_fused_spec_cycles_total",
            "single-round fused speculative cycles completed")
        self._m_spec_bids = reg.counter("hvd_spec_bids_total")
        self._m_spec_denials = reg.counter("hvd_spec_denials_total")
        self._m_native_steady = reg.counter(
            "hvd_native_steady_cycles_total",
            "steady steps completed by the one-call native data plane")
        self._m_arena_bytes = reg.gauge(
            "hvd_arena_bytes",
            "capacity of the persistent fusion arenas on this rank")
        self._m_data_copies = reg.counter(
            "hvd_data_copies_total",
            "payload byte-object copies on fallback data paths "
            "(0 while the zero-copy plane is engaged)")
        # The same counter objects as the socket plane's (the registry
        # memoizes by name).
        self._m_wire_saved = reg.counter(
            "hvd_wire_bytes_saved_total",
            "payload bytes kept OFF the wire by the negotiated "
            "wire dtype (uncompressed minus wire size, per send)")
        self._m_comp_ratio = reg.histogram(
            "hvd_compression_ratio",
            "wire bytes / uncompressed bytes per compressed payload",
            hmetrics.RATIO_BUCKETS)
        self._m_overlap_fraction = reg.histogram(
            "hvd_overlap_fraction",
            "per overlapped cycle: fraction of its wire time hidden "
            "under compute (1.0 = the loop never blocked on it)",
            hmetrics.RATIO_BUCKETS)
        self._m_inflight = reg.gauge(
            "hvd_inflight_cycles",
            "steady cycles outstanding on the overlap runner",
            agg=hmetrics.AGG_MAX)
        self._m_overlap_buckets = reg.counter(
            "hvd_overlap_buckets_total",
            "gradient buckets submitted by bucketed grouped dispatch")
        self._m_overlap_cycles = reg.counter(
            "hvd_overlap_cycles_total",
            "steady cycles completed through the overlap runner")
        self._m_cache_hits = reg.counter("hvd_cache_hits_total")
        self._m_cache_misses = reg.counter("hvd_cache_misses_total")
        self._m_cache_evictions = reg.counter(
            "hvd_cache_evictions_total")
        self._m_cache_entries = reg.gauge("hvd_cache_entries")
        self._m_queue_depth = reg.gauge(
            "hvd_tensor_queue_depth",
            "in-flight collectives tabled on this rank")
        self._m_burst_hold_s = reg.counter(
            "hvd_burst_hold_seconds_total",
            "time spent absorbing enqueue bursts")
        self._m_idle_hold_s = reg.counter(
            "hvd_idle_hold_seconds_total",
            "time spent in the steady-state idle hold")
        self._m_timeline_dropped = reg.counter(
            "hvd_timeline_dropped_events_total")
        self._m_world_size = reg.gauge(
            "hvd_world_size",
            "current world size (max-aggregated: the world view IS "
            "the size)", agg=hmetrics.AGG_MAX)
        # The fused speculative cycle bypasses the OperationManager: the
        # runtime keeps its share of the allreduce totals (the same
        # counters, memoized by name).
        self._m_bytes_allreduced = reg.counter("hvd_bytes_allreduced_total")
        self._m_ops_allreduce = reg.counter('hvd_ops_total{op="allreduce"}')
        self._idle_hold_total = 0.0
        controller.attach_metrics(reg)
        self.op_manager.attach_metrics(
            reg, lambda: self._world_fusion_threshold)
        self._aggregator = None
        self._metrics_http = None
        self._metrics_log = None
        self._metrics_last_pub = 0.0
        if not self._metrics_on:
            return
        reg.add_collector(self._collect_runtime_metrics)
        if controller.rank == 0:
            self._aggregator = hmetrics.WorldAggregator(controller.size)
            controller.metrics_sink = self._aggregator.ingest
            if config.metrics_port >= 0:
                self._metrics_http = hmetrics.MetricsHTTPServer(
                    self._aggregator.world, config.metrics_port,
                    host=config.metrics_addr)
            if config.metrics_log:
                self._metrics_log = hmetrics.JsonlMetricsLog(
                    config.metrics_log)
        # Build identity, info-style (the labels are the payload).
        bi = htrace.build_info()
        reg.gauge(
            f'hvd_build_info{{version="{bi["version"]}",'
            f'native="{bi["native"]}",knobs="{bi["knobs"]}",'
            f'flags="{bi["flags"]}"}}',
            "build identity: package version, native .so build "
            "hash, armed-knobs digest, kernel-feature flags "
            "(io_uring/zerocopy; value is always 1)",
            agg=hmetrics.AGG_MAX).set(1)

    def _init_trace_plane(self) -> None:
        """The flight recorder (on by default, process-lifetime) and its
        SIGUSR2 dump, the span collector and the world round number; on
        rank 0 the world trace writer and the straggler tracker."""
        controller = self.controller
        self._flight = htrace.flight()
        self._flight.set_identity(controller.rank)
        htrace.install_sigusr2()
        self._trace = htrace.create_collector(bool(self.config.trace_path))
        self._trace_on = self._trace.enabled
        self._world_cycle = 0
        self._trace_last_pub = 0.0
        self._trace_spans_sent = 0
        self._m_trace_spans = self.metrics.counter(
            "hvd_trace_spans_total",
            "trace spans this rank shipped (or wrote, on rank 0) "
            "into the world trace plane")
        self._trace_writer = None
        self._straggler = None
        if controller.rank == 0:
            if self._trace_on:
                self._trace_writer = htrace.WorldTraceWriter(
                    self.config.trace_path)
                controller.trace_sink = self._trace_writer.ingest
            if self._metrics_on or self._trace_on:
                self._straggler = htrace.StragglerTracker(self.metrics)
                controller.attach_trace(
                    on_arrivals=self._straggler.note_gather)
        elif self._trace_on:
            controller.attach_trace()

    def _note_round(self) -> int:
        """One world round (gather and broadcast) completed here. Every
        rank takes part in every round in the same order, so the number
        is the same on every rank: the key the world trace and the
        flight recorder stamp."""
        self._world_cycle += 1
        self._flight.record(htrace.EV_CYCLE, self._world_cycle)
        return self._world_cycle

    def _collect_runtime_metrics(self) -> None:
        """Registry collector: mirror the counts the loop keeps in
        ``stats`` and the cache, once per snapshot, never per event."""
        st, c = self.stats, self._cache
        if c is not None:
            self._m_cache_hits.set_total(c.hits)
            self._m_cache_misses.set_total(c.misses)
            self._m_cache_evictions.set_total(c.evictions)
            self._m_cache_entries.set(len(c))
        self._m_world_size.set(self.controller.size)
        self._m_cycles.set_total(st["cycles"])
        self._m_cached_cycles.set_total(st["cached_cycles"])
        self._m_spec_cycles.set_total(st["spec_cycles"])
        self._m_spec_bids.set_total(st["spec_bids"])
        self._m_spec_denials.set_total(st["spec_denials"])
        self._m_burst_hold_s.set_total(st["hold_s"])
        self._m_idle_hold_s.set_total(self._idle_hold_total)
        self._m_queue_depth.set(len(self.tensor_table))
        self._m_timeline_dropped.set_total(
            getattr(self.timeline, "dropped_events", 0))
        self._m_trace_spans.set_total(self._trace_spans_sent)
        for r, age in self.controller.peer_heartbeat_ages().items():
            self.metrics.gauge(
                f'hvd_peer_heartbeat_age_seconds{{peer="{r}"}}',
                "seconds since the last control frame from this peer",
                agg=hmetrics.AGG_MAX).set(age)

    def _maybe_publish_metrics(self) -> None:
        """Every interval (loop thread only): feed rank 0's aggregator
        and JSONL log, or send one METRICS frame up the control channel,
        out of band."""
        now = time.monotonic()
        if now - self._metrics_last_pub < self.config.metrics_interval_s:
            return
        self._metrics_last_pub = now
        snap = self.metrics.snapshot()
        if self._aggregator is not None:
            self._aggregator.update_local(snap)
            if self._metrics_log is not None:
                self._metrics_log.append(self._aggregator.world())
            return
        try:
            payload = wire.serialize_metrics_frame(1, snap)
        except Exception:
            return  # a malformed record must not kill the loop
        self.controller.send_metrics(payload)

    def _maybe_publish_trace(self) -> None:
        """Every interval (loop thread only): drain the span collector
        into rank 0's writer, or into one TRACE frame up the control
        channel with the clock echo that closes the exchange."""
        now = time.monotonic()
        if now - self._trace_last_pub < self.config.trace_interval_s:
            return
        self._trace_last_pub = now
        self._ship_spans()

    def _ship_spans(self) -> None:
        spans, dropped = self._trace.drain()
        if self._trace_writer is not None:
            self._trace_writer.add_section(0, spans, dropped)
            self._trace_spans_sent += len(spans)
            return
        echo = htrace.clock().take_echo()
        if not spans and not dropped and echo is None:
            return
        try:
            payload = wire.serialize_trace_frame(
                [{"rank": self.controller.rank, "dropped": dropped,
                  "echo": echo, "spans": spans}])
        except Exception:
            return  # a malformed span must not kill the loop
        self._trace_spans_sent += len(spans)
        self.controller.send_trace(payload)

    def metrics_view(self) -> Dict:
        """The ``hvd.metrics()`` payload: this rank's fresh snapshot, the
        world view (rank 0 only; None elsewhere) and the HTTP port of the
        Prometheus endpoint when it is live."""
        local = self.metrics.snapshot()
        view = {"enabled": self._metrics_on, "local": local,
                "world": None, "http_port": None}
        if self._aggregator is not None:
            self._aggregator.update_local(local)
            view["world"] = self._aggregator.world()
        if self._metrics_http is not None:
            view["http_port"] = self._metrics_http.port
        return view

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._background_loop,
                                        name="hvd-background", daemon=True)
        self._thread.start()

    def request_shutdown(self) -> None:
        self._shutdown_requested.set()
        self._wake.set()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    @property
    def alive(self) -> bool:
        return (self._thread is not None and self._thread.is_alive()
                and not self._done.is_set())

    def _terminal_status(self) -> Status:
        """A structured abort naming the failed rank when the world was
        torn down by a failure, the plain shutdown error otherwise."""
        if self._abort_info is not None:
            origin, cause = self._abort_info
            return Status.WorldAborted(origin, cause)
        return Status.Aborted(SHUT_DOWN_ERROR)

    # -- enqueue APIs ----------------------------------------------------
    def _request(self, request_type, entry, dtype, shape, prescale,
                 postscale) -> Request:
        return Request(request_rank=self.controller.rank,
                       request_type=request_type, tensor_type=dtype,
                       tensor_name=entry.tensor_name,
                       root_rank=entry.root_rank, device=entry.device,
                       tensor_shape=shape, prescale_factor=prescale,
                       postscale_factor=postscale,
                       wire_dtype=self._propose_wire(request_type, dtype))

    def _propose_wire(self, request_type: RequestType,
                      dtype: DataType) -> int:
        """This rank's wire-dtype bid for one request: the configured
        compression for float32/float64 allreduces, allgathers and
        reducescatters, none for everything else."""
        if self._wire_propose and dtype in _wd.COMPRESSIBLE \
                and request_type in (RequestType.ALLREDUCE,
                                     RequestType.ALLGATHER,
                                     RequestType.REDUCESCATTER):
            return self._wire_propose
        return _wd.WIRE_NONE

    def enqueue(self, request_type: RequestType, entry: TensorTableEntry,
                dtype: DataType, shape, prescale: float = 1.0,
                postscale: float = 1.0) -> Status:
        if self._done.is_set() or self._shutdown_requested.is_set():
            return self._terminal_status()
        req = self._request(request_type, entry, dtype, shape, prescale,
                            postscale)
        if not self.tensor_table.add(entry, req):
            return Status.InvalidArgument(
                DUPLICATE_NAME_ERROR_FMT
                % (request_type.name.lower(), entry.tensor_name))
        if self._done.is_set():
            # The loop exited between the check and the add, and its
            # shutdown fan-out may have missed this entry.
            if self.tensor_table.pop_entry_if_present(entry.tensor_name):
                return self._terminal_status()
        self._wake.set()
        return Status.OK()

    def enqueue_group(self, request_type: RequestType, items,
                      prescale: float = 1.0,
                      postscale: float = 1.0) -> Status:
        """Enqueue several entries as one negotiation batch: all enter
        the same RequestList, become ready in the same coordinator cycle
        and fuse under the threshold. ``items``: (entry, dtype, shape)."""
        if self._done.is_set() or self._shutdown_requested.is_set():
            return self._terminal_status()
        pairs = [(entry, self._request(request_type, entry, dtype, shape,
                                       prescale, postscale))
                 for entry, dtype, shape in items]
        dup = self.tensor_table.add_all(pairs)
        if dup is not None:
            return Status.InvalidArgument(
                DUPLICATE_NAME_ERROR_FMT % (request_type.name.lower(), dup))
        if self._done.is_set():
            for entry, _ in pairs:
                if self.tensor_table.pop_entry_if_present(
                        entry.tensor_name) and entry.callback:
                    entry.callback(self._terminal_status())
        self._wake.set()
        return Status.OK()

    # -- the loop --------------------------------------------------------
    def _background_loop(self) -> None:
        try:
            if self.device is not None:
                import torch
                torch.cuda.set_device(self.device)
            while self._run_loop_once():
                pass
        except WorldAbortedError as e:
            # Received over the wire or found here: fan the notice to
            # every peer still reachable (relays are idempotent), then
            # fail everything in flight. The bare cause travels, so that
            # each hop wraps the origin banner once.
            self._fail_world(e.origin_rank, e.cause,
                             resolved=getattr(e, "resolved", False))
        except (ConnectionError, OSError, TimeoutError) as e:
            rank = self.controller.rank
            self._fail_world(rank, f"transport failure on rank {rank}: {e}")
        except Exception as e:  # a backend bug: fail what is in flight
            hlog.error(f"horovod_tpu_torch background loop failed: {e!r}",
                       rank=self.controller.rank)
        finally:
            self._teardown()

    def _resolve_abort(self, origin: int, cause: str) -> tuple:
        """Defer a blame inferred from a transport error to an ABORT
        notice queued on (or arriving within 0.25 s at) the channels: the
        teardown of the rank that found the failure closes its channels,
        which its peers see as a second failure, and the notice makes the
        world agree on one origin. Failure paths only."""
        try:
            notice = self.controller.drain_abort_notice(0.25)
        except Exception:
            notice = None
        return notice if notice is not None else (origin, cause)

    def _data_plane_abort(self, entries, origin: int, cause: str,
                          resolved: bool = False) -> WorldAbortedError:
        """Fail a batch that was mid-collective as a world abort: resolve
        the origin first (the callbacks complete user-visible handles,
        which must carry the world's origin), fire the callbacks, and
        return the error for the loop to raise."""
        if not resolved:
            origin, cause = self._resolve_abort(origin, cause)
        status = Status.WorldAborted(origin, cause)
        for en in entries:
            if en.callback:
                en.callback(status)
        err = WorldAbortedError(world_abort_message(origin, cause),
                                origin_rank=origin, cause=cause)
        err.resolved = True
        return err

    def _fail_world(self, origin: int, cause: str,
                    resolved: bool = False) -> None:
        """Record the world abort and fan the notice to every reachable
        peer."""
        if not resolved:
            origin, cause = self._resolve_abort(origin, cause)
        self._abort_info = (origin, cause)
        hlog.error(f"horovod_tpu_torch world aborted: "
                   f"{world_abort_message(origin, cause)}",
                   rank=self.controller.rank)
        self._flight.record(htrace.EV_ABORT, self._world_cycle,
                            arg=origin, note=cause[:200])
        if self._trace_on:
            self._trace.mark("ABORT", time.monotonic(), self._world_cycle)
        try:
            self.controller.abort(origin, cause)
        except Exception:
            pass
        # The postmortem after the fan-out: file I/O must not delay the
        # notice the survivors' deadlines wait on.
        self._flight.dump(cause=cause, origin=origin)

    def _teardown(self) -> None:
        """Fail everything in flight, then close the timeline and the
        controller; each stage runs even if an earlier one raised."""
        if self._teardown_started:
            return
        self._teardown_started = True
        self._flight.record(htrace.EV_TEARDOWN, self._world_cycle)
        self._done.set()
        try:
            self.finalizer.drain()
        except Exception:
            pass  # the teardown goes on
        terminal = self._terminal_status()
        for entry in self.tensor_table.pop_all():
            if entry.callback:
                try:
                    entry.callback(terminal)
                except Exception:
                    pass  # a user callback; the teardown goes on
        try:
            self.timeline.shutdown()
        except Exception:
            pass
        # The trace's tail: rank 0 writes its own and closes the file
        # (the JSON array must end: an aborted run's trace is the one to
        # read); a worker sends its own while the channel may be up.
        if self._trace_on:
            try:
                self._ship_spans()
            except Exception:
                pass
        if self._trace_writer is not None:
            try:
                self._trace_writer.close()
            except Exception:
                pass
        if self._aggregator is not None and self._metrics_log is not None:
            # A last JSONL line with rank 0's own totals exact and every
            # rank's last frame folded in.
            try:
                self._aggregator.update_local(self.metrics.snapshot())
                self._metrics_log.append(self._aggregator.world())
            except Exception:
                pass
        if self._metrics_http is not None:
            try:
                self._metrics_http.close()
            except Exception:
                pass
        # Closing the channels is what tells the peers, whose recv on
        # them then fails, that this rank is gone.
        try:
            self.controller.close()
        except Exception:
            pass

    def _run_loop_once(self) -> bool:
        """One negotiation cycle; False to exit. With the response cache
        on, a steady-state cycle moves one bit per cache slot: the
        coordinator broadcasts the granted mask and every rank replays
        the cached responses in ascending slot order. Any miss, changed
        signature, eviction or uncacheable op rides the full path in the
        same frame and repopulates the cache alike everywhere."""
        self.stats["cycles"] += 1
        faults.tick_cycle(self, self.stats["cycles"])
        self.timeline.mark_cycle_start()
        requests = self.tensor_table.pop_messages()
        if requests and self._cache is not None:
            th = time.monotonic()
            requests = self._absorb_burst(requests)
            self.stats["hold_s"] += time.monotonic() - th
        t0 = time.monotonic()
        shutting_down = self._shutdown_requested.is_set()
        payload, bit_requests = self._build_request_frame(
            requests, shutting_down)
        tn = time.monotonic() if self._metrics_on or self._trace_on else 0.0
        gathered = self.controller.gather_requests(payload)
        if self.controller.is_coordinator:
            reply, meta = self._coordinate_cycle(gathered)
            self.controller.broadcast_responses(reply)
        else:
            meta = wire.parse_cycle_response(
                self.controller.broadcast_responses(None))
        t1 = time.monotonic()
        wc = self._note_round()
        if self._trace_on:
            self._trace.slice("ROUND", tn, t1 - tn, wc)
        if self._metrics_on:
            self._m_negotiation_s.observe(t1 - tn)
        self.stats["negotiate_s"] += t1 - t0
        if isinstance(meta, CacheCycleResponse):
            resp_list = self._apply_cached_cycle(meta, bit_requests)
        else:
            if self._cache is not None:
                raise ConnectionError(
                    "the coordinator negotiated without the response "
                    "cache while this rank has it on: HOROVOD_CACHE_"
                    "ENABLED and HOROVOD_CACHE_CAPACITY must be the same "
                    "on every rank")
            resp_list = meta
        self._perform_operations(resp_list)
        self.stats["execute_s"] += time.monotonic() - t1
        if self._cache is not None:
            c = self._cache
            self.stats.update(cache_hits=c.hits, cache_misses=c.misses,
                              cache_evictions=c.evictions)
        if resp_list.shutdown:
            return False
        if self._metrics_on:
            self._m_cycle_s.observe(time.monotonic() - t0)
            self._maybe_publish_metrics()
        if self._trace_on:
            self._maybe_publish_trace()

        # Pace the cycle.
        cycle_s = self.config.cycle_time_ms / 1000.0
        if resp_list.responses or requests:
            self._idle_cycles = 0
        else:
            self._idle_cycles += 1
        sleep_s = cycle_s - (time.monotonic() - t0)
        idle_hold = False
        if not self.tensor_table.queue_pending():
            if sleep_s <= 0:
                # The cycle overran its budget and drained everything
                # local: a round started now would race the callbacks'
                # re-enqueue and carry empty frames, so wait one period
                # (new work wakes the loop at once).
                sleep_s = cycle_s
            if self._steady:
                # In steady state no round can grant anything until this
                # rank's producer submits again: hold for that (an
                # enqueue or a shutdown wakes the loop at once).
                sleep_s = max(sleep_s, self._bounded_hold_s(
                    8, self._STEADY_IDLE_S))
                idle_hold = True
        backoff_s = self.config.idle_backoff_ms / 1000.0
        if self.config.heartbeat_timeout_s > 0:
            # A sleeping rank sends nothing: its next frame is its only
            # proof of life, so its backoff stays under the deadline.
            backoff_s = min(backoff_s, self.config.heartbeat_timeout_s / 2.0)
        if backoff_s > 0 and self._idle_cycles > self._IDLE_GRACE:
            ramp = cycle_s * (self._idle_cycles - self._IDLE_GRACE)
            sleep_s = max(sleep_s, min(backoff_s, ramp))
        if sleep_s > 0:
            th = time.monotonic() if idle_hold and self._metrics_on else 0.0
            self._wake.wait(sleep_s)
            if th:
                self._idle_hold_total += time.monotonic() - th
        self._wake.clear()
        return True

    def _bounded_hold_s(self, multiple: float, floor_s: float) -> float:
        """A hold budget from the cycle time: ``multiple`` cycles, at
        least ``floor_s``, and under a quarter of the heartbeat timeout
        as a whole: a holding rank sends no frames, and must never look
        dead to its peers, whatever HOROVOD_CYCLE_TIME says. The one
        budget rule of the burst hold and the steady idle hold."""
        hold = max(multiple * self.config.cycle_time_ms / 1000.0, floor_s)
        hb = self.config.heartbeat_timeout_s
        if hb > 0:
            hold = min(hold, hb / 4.0)
        return hold

    # -- the response cache's cycle ----------------------------------------
    def _record_signature(self, req: Request) -> None:
        if req.request_type not in CACHEABLE_REQUESTS:
            return
        numel = 1
        for d in req.tensor_shape[1:]:
            numel *= d
        self._pending_sigs[req.tensor_name] = (
            ResponseCache.signature(req), req.tensor_type, numel)

    def _build_request_frame(self, requests: List[Request],
                             shutting_down: bool):
        """This cycle's frame: (payload, bit_requests), ``bit_requests``
        being [(slot, request)] for the hits the grant mask decides."""
        cache = self._cache
        if self._spec_inflight is not None:
            self.stats["spec_unused_bytes"] += self._spec_bytes
        self._spec_inflight = None
        if cache is None:
            return wire.serialize_cycle_request(
                RequestList(requests, shutdown=shutting_down)), []
        now = time.monotonic()
        hit_mask = 0
        invalid_mask = 0
        uncached: List[Request] = []
        bit_requests: List[tuple] = []
        for req in requests:
            state, slot = cache.lookup(req)
            if state == ResponseCache.HIT:
                pending = self._bit_pending_since.get(req.tensor_name)
                if pending is None or now - pending < self._BIT_DEMOTE_S:
                    hit_mask |= 1 << slot
                    bit_requests.append((slot, req))
                    continue
                # Ungranted too long: the full path, where the stall
                # machinery sees it.
                self._bit_pending_since.pop(req.tensor_name, None)
                hlog.warning(
                    f"tensor {req.tensor_name} waited {now - pending:.1f}s "
                    f"as a cached hit without world agreement; falling "
                    f"back to full negotiation", rank=self.controller.rank)
            elif state == ResponseCache.INVALID:
                invalid_mask |= 1 << slot
            self._record_signature(req)
            uncached.append(req)
        if not uncached and not invalid_mask and not shutting_down:
            if hit_mask and self._spec_ok \
                    and self._steady_epoch == cache.epoch \
                    and hit_mask in self._steady \
                    and self._spec_denied.get(hit_mask, 0) \
                    < self._SPEC_DENY_LIMIT:
                payload = self._build_spec_frame(hit_mask)
                if payload is not None:
                    return payload, bit_requests
            # A pure-hit (or empty) frame is the same every steady-state
            # cycle: serialize it once per (epoch, mask).
            key = (cache.epoch, hit_mask)
            payload = self._frame_memo.get(key)
            if payload is None:
                payload = wire.serialize_cycle_request(CacheCycleRequest(
                    epoch=cache.epoch, nslots=cache.nslots,
                    hit_mask=hit_mask))
                if len(self._frame_memo) >= 64:
                    self._frame_memo.clear()
                self._frame_memo[key] = payload
            return payload, bit_requests
        return wire.serialize_cycle_request(CacheCycleRequest(
            epoch=cache.epoch, nslots=cache.nslots, hit_mask=hit_mask,
            invalid_mask=invalid_mask, requests=uncached,
            shutdown=shutting_down)), bit_requests

    def _absorb_burst(self, requests: List[Request]) -> List[Request]:
        """Hold a cycle that caught the front of an enqueue burst. A
        training step submits its steady set back to back; a loop that
        negotiates the first part gets a fragment grant, and each
        fragment pays a round trip. While the popped names are cache
        hits forming a strict subset of a steady set, wait (bounded) for
        the rest of the burst; any other name or the deadline ends the
        hold."""
        steady_sets = self._steady.values()
        if not steady_sets:
            return requests
        seen = {r.tensor_name for r in requests}

        def fragment() -> bool:
            # A strict subset of some steady set, and not exactly one of
            # them (a complete set negotiates now, even inside a larger
            # one).
            return (not any(seen == st for st in steady_sets)
                    and any(seen < st for st in steady_sets))

        if not fragment() or seen <= self._requeued_names:
            return requests
        deadline = time.monotonic() + self._bounded_hold_s(
            2, self._BURST_HOLD_S)
        while True:
            # Woken by the enqueues, never polled: clear before draining,
            # so that an enqueue between the drain and the wait still
            # wakes it.
            self._wake.clear()
            more = self.tensor_table.pop_messages()
            if more:
                requests.extend(more)
                seen.update(r.tensor_name for r in more)
                if not fragment():
                    return requests
                continue
            remaining = deadline - time.monotonic()
            if remaining <= 0 or self._shutdown_requested.is_set():
                return requests
            self._wake.wait(remaining)

    def _build_spec_frame(self, hit_mask: int) -> Optional[list]:
        """A fused speculative cycle frame: the pure-hit mask and this
        rank's fused allreduce buffers in replay-plan order, packed as
        the star packs them, or None when the batch cannot speculate
        (another op than allreduce in the set, a plane with its own
        transport would run it, or an entry is gone). The entries are
        only peeked: if the world denies the grant the classic path pops
        them. The frame is the list of its parts, which the channel
        sends without joining them (the buffers are the step's whole
        gradients)."""
        cache = self._cache
        plan = self._replay_plan(hit_mask, self._world_fusion_threshold)
        inflight = []
        for resp in plan:
            if resp.response_type != ResponseType.ALLREDUCE:
                return None
            if resp.wire_dtype == _wd.WIRE_INT8:
                # Per-rank int8 scales cannot be summed inline: the
                # classic star, which dequantizes, carries them.
                return None
            entries = self.tensor_table.peek_entries(resp.tensor_names)
            if entries is None:
                return None
            try:
                backend = self.op_manager.pick(entries, resp)
            except RuntimeError:
                return None
            nbytes = sum(e.tensor.numel() * e.tensor.element_size()
                         for e in entries)
            if not backend.fused_cycle_reducible(nbytes):
                return None
            inflight.append((resp, entries, backend))
        segments = []
        for resp, entries, backend in inflight:
            # A cast wire's segment travels, and is summed, in the wire
            # dtype, as the classic star's payload is.
            host = backend.pack_to_host(entries, resp.prescale_factor,
                                        resp.wire_dtype)
            segments.append((torch_dtype_to_datatype(host.dtype), host))
        self._spec_inflight = inflight
        self._spec_bytes = sum(h.numel() * h.element_size()
                               for _, h in segments)
        self.stats["spec_bids"] += 1
        return wire.spec_frame_chunks(cache.epoch, cache.nslots, hit_mask,
                                      segments)

    def _coordinate_cycle(self, gathered: List[bytes]):
        """Parse every rank's cycle frame and produce this cycle's
        broadcast: (payload, meta), ``meta`` being the ResponseList (no
        cache) or the CacheCycleResponse every rank, this one included,
        applies alike."""
        cache = self._cache
        if cache is None:
            req_lists = [wire.parse_cycle_request(f) for f in gathered]
            for rl in req_lists:
                if not isinstance(rl, RequestList):
                    raise ConnectionError(
                        "a rank negotiated with the response cache while "
                        "the coordinator has it off: HOROVOD_CACHE_"
                        "ENABLED and HOROVOD_CACHE_CAPACITY must be the "
                        "same on every rank")
            resp_list = self._coordinate(req_lists)
            return wire.serialize_cycle_response(resp_list), resp_list
        epoch = cache.epoch
        and_hits = -1  # all ones; every rank ANDs its mask in
        or_invalid = 0
        shutdown = False
        req_lists: List[RequestList] = []
        spec_frames: List[CacheCycleRequest] = []
        for f in gathered:
            cf = wire.parse_cycle_request(f)
            if not isinstance(cf, CacheCycleRequest):
                raise ConnectionError(
                    "a rank negotiated without the response cache while "
                    "the coordinator has it on: HOROVOD_CACHE_ENABLED and "
                    "HOROVOD_CACHE_CAPACITY must be the same on every rank")
            if cf.epoch != epoch or cf.nslots != cache.nslots:
                raise ConnectionError(
                    f"response-cache state diverged: a rank reported epoch "
                    f"{cf.epoch}/{cf.nslots} slots against the "
                    f"coordinator's {epoch}/{cache.nslots}; negotiation "
                    f"cannot continue safely")
            and_hits &= cf.hit_mask
            or_invalid |= cf.invalid_mask
            shutdown = shutdown or cf.shutdown
            if cf.spec_payload is not None:
                spec_frames.append(cf)
            if cf.requests:
                req_lists.append(RequestList(cf.requests, cf.shutdown))
        if (spec_frames and len(spec_frames) == len(gathered)
                and not shutdown and not or_invalid
                and all(cf.hit_mask == and_hits for cf in spec_frames)):
            # Every rank bid the same pure-hit mask with its buffers:
            # reduce here and broadcast grant and result in one frame.
            reduced = self._reduce_spec(spec_frames)
            self.timeline.negotiate_cached(fused=True)
            # A full-path tensor some rank submitted earlier may still
            # age in the table while the world runs fused cycles.
            self._check_stall(self._message_table, self.controller.size)
            meta = CacheCycleResponse(epoch=epoch, nslots=cache.nslots,
                                      grant_mask=and_hits,
                                      spec_payload=reduced)
            return wire.spec_frame_chunks(epoch, cache.nslots, and_hits,
                                          reduced), meta
        grant = and_hits & ~or_invalid
        resp_list = self._coordinate(req_lists, extra_shutdown=shutdown)
        if grant and not resp_list.responses:
            self.timeline.negotiate_cached()
        meta = CacheCycleResponse(epoch=epoch, nslots=cache.nslots,
                                  grant_mask=grant, invalid_mask=or_invalid,
                                  response_list=resp_list)
        return wire.serialize_cycle_response(meta), meta

    @world_coherent
    def _apply_cached_cycle(self, meta: CacheCycleResponse,
                            bit_requests: List[tuple]) -> ResponseList:
        """Apply the coordinator's verdict to the local cache, alike on
        every rank: evict the ORed invalid slots (ascending), replay the
        granted slots (ascending, fused with the world's threshold),
        repopulate from the freshly negotiated responses (stream order),
        and requeue the hits the world did not grant."""
        cache = self._cache
        if cache is None or meta.epoch != cache.epoch \
                or meta.nslots != cache.nslots:
            local = ("off" if cache is None
                     else f"epoch {cache.epoch}/{cache.nslots} slots")
            raise ConnectionError(
                f"response-cache state diverged from the coordinator "
                f"(local {local}, coordinator epoch "
                f"{meta.epoch}/{meta.nslots} slots); negotiation cannot "
                f"continue safely")
        if meta.spec_payload is not None:
            return self._complete_spec_cycle(meta, bit_requests)
        inner = meta.response_list
        if meta.invalid_mask:
            cache.evict_slots(meta.invalid_mask)
        if inner.tuned_fusion_threshold_bytes:
            self._world_fusion_threshold = \
                inner.tuned_fusion_threshold_bytes
        replayed: List[Response] = []
        if meta.grant_mask:
            replayed = self._replay_grants(meta.grant_mask,
                                           self._world_fusion_threshold)
            if not inner.responses:
                self.stats["cached_cycles"] += 1
        if inner.responses:
            self._populate_cache(inner)
        if bit_requests and not inner.shutdown:
            now = time.monotonic()
            missed = []
            for slot, req in bit_requests:
                if (meta.grant_mask >> slot) & 1:
                    self._bit_pending_since.pop(req.tensor_name, None)
                else:
                    self._bit_pending_since.setdefault(req.tensor_name, now)
                    missed.append(req)
            self._requeued_names = frozenset(r.tensor_name for r in missed)
            if missed:
                self.tensor_table.requeue(missed)
            if self._steady_epoch != cache.epoch:
                # Slots changed names: every prediction is stale.
                self._steady.clear()
                self._spec_denied.clear()
                self._steady_epoch = cache.epoch
            bid = 0
            for slot, _ in bit_requests:
                bid |= 1 << slot
            if self._spec_inflight is not None and not missed:
                # A speculative bid the world granted in full but
                # answered classically: some peer will not speculate.
                self._spec_denied[bid] = self._spec_denied.get(bid, 0) + 1
                self.stats["spec_denials"] += 1
                self.stats["spec_unused_bytes"] += self._spec_bytes
                self._spec_inflight = None
            if not missed and not inner.responses \
                    and not meta.invalid_mask:
                # A pure-hit cycle granted in full: its mask becomes a
                # steady-state prediction.
                self._steady[meta.grant_mask] = frozenset(
                    cache.entry(slot).name
                    for slot in iter_set_bits(meta.grant_mask))
                self._steady.move_to_end(meta.grant_mask)
                if len(self._steady) > self._STEADY_CAP:
                    self._steady.popitem(last=False)
            elif meta.grant_mask or inner.responses or meta.invalid_mask:
                # A partial verdict: the bid mask is not steady. A fully
                # denied bid (some rank had nothing queued yet) keeps its
                # prediction.
                self._steady.pop(bid, None)
        if not replayed:
            return inner
        return ResponseList(
            replayed + inner.responses, shutdown=inner.shutdown,
            tuned_cycle_time_ms=inner.tuned_cycle_time_ms,
            tuned_fusion_threshold_bytes=inner.tuned_fusion_threshold_bytes)

    def _replay_plan(self, grant_mask: int,
                     threshold: int) -> List[Response]:
        """The fused execution list of a granted mask: the granted
        entries cloned in ascending slot order and fused as the
        coordinator would. Memoized per (grant, threshold) for the
        current epoch; never touches the LRU (the speculative frame asks
        for it before any grant)."""
        cache = self._cache
        if self._replay_epoch != cache.epoch:
            self._replay_plans.clear()
            self._replay_epoch = cache.epoch
        key = (grant_mask, threshold)
        plan = self._replay_plans.get(key)
        if plan is None:
            responses: List[Response] = []
            dtypes: Dict[str, DataType] = {}
            slices: Dict[str, int] = {}
            for slot in iter_set_bits(grant_mask):
                e = cache.entry(slot)
                responses.append(e.clone_response())
                dtypes[e.name] = e.dtype
                slices[e.name] = e.slice_numel
            plan = fuse_responses(responses, dtypes, threshold, slices)
            if len(self._replay_plans) >= 64:
                self._replay_plans.clear()
            self._replay_plans[key] = plan
        return plan

    def _replay_grants(self, grant_mask: int,
                       threshold: int) -> List[Response]:
        plan = self._replay_plan(grant_mask, threshold)
        self._cache.touch_mask(grant_mask)
        return plan

    @staticmethod
    def _reduce_spec(spec_frames: List[CacheCycleRequest]):
        """The coordinator's half of the speculative cycle: every rank's
        fused buffers summed segment by segment in ascending rank order
        (``acc += peer`` in the dtype, as the star sums), as flat CPU
        tensors. The sum accumulates into the first frame's buffer when
        that is writable (a received or joined frame, which the cycle
        owns), else into a copy. The frames passed the epoch and mask
        check, so a layout mismatch here means the caches diverged."""
        first = spec_frames[0].spec_payload
        if any(len(sf.spec_payload) != len(first)
               for sf in spec_frames[1:]):
            raise ConnectionError(
                "speculative fused payloads disagree on layout across "
                "ranks: response-cache state diverged")
        out = []
        for i, (dt, buf0) in enumerate(first):
            acc = _buffer_tensor(buf0, dt,
                                 copy=memoryview(buf0).readonly)
            for sf in spec_frames[1:]:
                d2, b2 = sf.spec_payload[i]
                if d2 != dt or memoryview(b2).nbytes \
                        != memoryview(buf0).nbytes:
                    raise ConnectionError(
                        "speculative fused payloads disagree on layout "
                        "across ranks: response-cache state diverged")
                _accumulate(acc, _buffer_tensor(b2, dt, copy=False))
            out.append((dt, acc))
        return out

    @world_coherent
    def _complete_spec_cycle(self, meta: CacheCycleResponse,
                             bit_requests: List[tuple]) -> ResponseList:
        """A rank's half of the speculative cycle: the grant is what this
        rank bid, and the payload the world's sum of the buffers it
        packed. Write it into the (still tabled) entries' outputs, fire
        their callbacks, and keep every cache effect that of a classic
        hit cycle."""
        inflight = self._spec_inflight
        self._spec_inflight = None
        if inflight is None or meta.spec_payload is None \
                or len(meta.spec_payload) != len(inflight):
            raise ConnectionError(
                "fused speculative response does not match the frame this "
                "rank sent: control plane corrupted")
        timeline = self.timeline
        for (resp, entries, backend), (dt, buf) in zip(inflight,
                                                       meta.spec_payload):
            self._op_count += 1
            faults.tick_op(self, self._op_count)
            popped = self.tensor_table.pop_entries(resp.tensor_names)
            # The coordinator's own sum is fresh, and so is a received
            # frame (the channel's own buffer): the outputs may alias
            # either. A read-only buffer is copied once.
            result = buf if isinstance(buf, torch.Tensor) \
                else _buffer_tensor(buf, dt,
                                    copy=memoryview(buf).readonly)
            op_name = resp.response_type.name
            if self._metrics_on:
                # The fused round is this batch's data plane: keep the
                # allreduce totals exact though the OperationManager
                # never sees it.
                self._m_ops_allreduce.inc()
                self._m_bytes_allreduced.inc(
                    sum(e.tensor.nbytes for e in entries))
            for name in resp.tensor_names:
                timeline.start(name, op_name)
            try:
                backend.unpack_from_host(entries, result,
                                         resp.postscale_factor,
                                         resp.wire_dtype)
                status = Status.OK()
            except Exception as e:
                status = Status.UnknownError(
                    f"collective execution failed: {e!r}")
            for name in resp.tensor_names:
                timeline.end(name)
            self.stats["responses"] += 1
            self.stats["tensors"] += len(popped)
            key = f"responses.{backend.name}"
            self.stats[key] = self.stats.get(key, 0) + 1
            for e in popped:
                if e.callback:
                    e.callback(status)
        self.stats["cached_cycles"] += 1
        self.stats["spec_cycles"] += 1
        self._spec_denied.pop(meta.grant_mask, None)
        self._cache.touch_mask(meta.grant_mask)
        for _, req in bit_requests:
            self._bit_pending_since.pop(req.tensor_name, None)
        self._requeued_names = frozenset()
        return ResponseList([])

    @staticmethod
    def _unfuse(resp: Response, i: int, world_size: int) -> Response:
        """Entry ``i`` of a (possibly fused) response as a single-tensor
        Response, the unit the cache stores (a hit cycle re-fuses under
        the threshold then in effect). ALLGATHER sizes are entry-major
        (sizes[ec * world_size + rc]); ALLREDUCE sizes are per-entry
        numels; the other cacheable types never fuse."""
        if resp.response_type == ResponseType.ALLGATHER:
            sizes = list(resp.tensor_sizes[i * world_size:
                                           (i + 1) * world_size])
        elif resp.tensor_sizes:
            sizes = [resp.tensor_sizes[i]]
        else:
            sizes = []
        return Response(response_type=resp.response_type,
                        tensor_names=[resp.tensor_names[i]],
                        devices=list(resp.devices), tensor_sizes=sizes,
                        prescale_factor=resp.prescale_factor,
                        postscale_factor=resp.postscale_factor,
                        wire_dtype=resp.wire_dtype,
                        algorithm=resp.algorithm)

    @world_coherent
    def _populate_cache(self, resp_list: ResponseList) -> None:
        """Refresh the cache from freshly negotiated responses in
        broadcast order, the order every rank sees, which keeps slot
        assignment and LRU eviction the same everywhere. ERROR verdicts
        evict any entry under their names."""
        cache = self._cache
        world_size = self.controller.size
        for resp in resp_list.responses:
            rt = resp.response_type
            if rt == ResponseType.ERROR:
                for name in resp.tensor_names:
                    cache.evict_name(name)
                    self._pending_sigs.pop(name, None)
                continue
            if rt not in CACHEABLE_RESPONSES:
                for name in resp.tensor_names:
                    self._pending_sigs.pop(name, None)
                continue
            for i, name in enumerate(resp.tensor_names):
                info = self._pending_sigs.pop(name, None)
                if info is None:
                    # The negotiation streams diverged; going on would
                    # diverge the caches next.
                    raise ConnectionError(
                        f"negotiated response for tensor {name!r} without "
                        f"a matching local request: control plane "
                        f"corrupted")
                sig, dtype, slice_numel = info
                cache.put(name, sig, self._unfuse(resp, i, world_size),
                          dtype, slice_numel)

    def negotiation_cache_stats(self) -> Dict:
        """The cache's counts: hits and misses, cached and speculative
        cycles, entries and epoch. The ICI, native and overlap counts of
        the reference stay 0 until those planes are ported."""
        c = self._cache
        if c is None:
            return {"enabled": False}
        total = c.hits + c.misses
        st = self.stats
        return {"enabled": True, "capacity": c.capacity, "entries": len(c),
                "hits": c.hits, "misses": c.misses,
                "hit_rate": (c.hits / total) if total else 0.0,
                "cached_cycles": st["cached_cycles"],
                "spec_cycles": st["spec_cycles"],
                "spec_bids": st["spec_bids"],
                "native_steady_cycles": 0, "ici_cycles": 0,
                "ici_compiles": 0, "overlap_cycles": 0,
                "overlap_inflight": 0, "epoch": c.epoch}

    def _cache_stats_line(self) -> str:
        s = self.negotiation_cache_stats()
        if not s.get("enabled"):
            return ""
        return (f"cache: {s['hits']} hits / {s['misses']} misses "
                f"({s['hit_rate']:.1%} hit rate), "
                f"{s['cached_cycles']} fully cached cycles "
                f"({s['spec_cycles']} fused single-round, "
                f"{s['native_steady_cycles']} native zero-copy, "
                f"{s['overlap_cycles']} overlapped), "
                f"{s['entries']}/{s['capacity']} slots")

    def _check_stall(self, table: MessageTable, size: int) -> None:
        """Periodic coordinator-side stall scan; past the shutdown
        threshold it aborts the world, blaming the lowest rank missing
        from the oldest stalled tensor."""
        if not self._stall.should_check():
            return
        straggler = (self._straggler.report_line()
                     if self._straggler is not None else "")
        if not self._stall.check(table, cache_stats=self._cache_stats_line(),
                                 straggler_stats=straggler):
            return
        self._flight.record(htrace.EV_STALL, self._world_cycle,
                            note="stall shutdown threshold")
        origin, note = -1, ""
        pending = sorted(table.pending(), key=lambda p: -p[1])
        if pending:
            name, _, reported = pending[0]
            missing = [r for r in range(size) if r not in set(reported)]
            if missing:
                origin = min(missing)
                note = (f" (tensor '{name}' never submitted by ranks "
                        f"{missing})")
        cause = (f"stall shutdown threshold "
                 f"({self._stall.shutdown_time:g}s) exceeded: one or more "
                 f"tensors were never submitted by every rank (see "
                 f"coordinator stall warnings for names and missing "
                 f"ranks){note}")
        raise WorldAbortedError(world_abort_message(origin, cause),
                                origin_rank=origin, cause=cause)

    def _coordinate(self, req_lists: List[RequestList],
                    extra_shutdown: bool = False) -> ResponseList:
        """Coordinator half of the cycle."""
        table = self._message_table
        size = self.controller.size
        shutdown = extra_shutdown
        for rl in req_lists:
            shutdown = shutdown or rl.shutdown
            for req in rl.requests:
                self._dtypes[req.tensor_name] = req.tensor_type
                numel = 1
                for d in req.tensor_shape[1:]:
                    numel *= d
                self._slice_numels[req.tensor_name] = numel
                table.increment_tensor_count(req, size, self.timeline)
        responses = []
        for name in table.pop_ready():
            responses.append(construct_response(table, name, size))
            self.timeline.negotiate_end(name)
        fused = fuse_responses(responses, self._dtypes,
                               self.config.fusion_threshold_bytes,
                               self._slice_numels)
        self._stamp_wire_plan(fused)
        for resp in fused:
            for n in resp.tensor_names:
                self._dtypes.pop(n, None)
                self._slice_numels.pop(n, None)
        self._check_stall(table, size)
        resp_list = ResponseList(fused, shutdown=shutdown)
        if self._cache is not None:
            # Replay re-fuses granted slots on every rank with this
            # threshold: broadcast the coordinator's, so that a rank
            # started with another HOROVOD_FUSION_THRESHOLD builds the
            # same batches from the same grant.
            resp_list.tuned_fusion_threshold_bytes = \
                self.config.fusion_threshold_bytes
        return resp_list

    def _stamp_wire_plan(self, fused: List[Response]) -> None:
        """Stamp each fused allreduce with the policy's algorithm for its
        uncompressed size, and cap its wire verdict where the policy
        says, before the broadcast."""
        for resp in fused:
            if resp.response_type != ResponseType.ALLREDUCE \
                    or not resp.tensor_names:
                continue
            dtype = self._dtypes.get(resp.tensor_names[0])
            if dtype is None:
                continue
            alg, cap = self._wire_policy.plan(
                sum(resp.tensor_sizes) * datatype_size(dtype))
            resp.algorithm = alg
            if cap is not None and resp.wire_dtype > cap:
                resp.wire_dtype = cap

    def _perform_operations(self, resp_list: ResponseList) -> None:
        """Run each agreed response and fire the callbacks."""
        timeline = self.timeline
        for response in resp_list.responses:
            self._op_count += 1
            faults.tick_op(self, self._op_count)
            entries = self.tensor_table.pop_entries(response.tensor_names)
            if response.response_type == ResponseType.ERROR:
                for e in entries:
                    if e.callback:
                        e.callback(Status.PreconditionError(
                            response.error_message))
                continue
            if not entries and \
                    response.response_type != ResponseType.BARRIER:
                continue
            self.stats["responses"] += 1
            self.stats["tensors"] += len(entries)
            names = [e.tensor_name for e in entries]
            op_name = response.response_type.name
            for name in names:
                timeline.start(name, op_name)
            # The QUEUE activity marks the handoff between negotiation
            # and execution; the wait on each CUDA tensor's ready event
            # is queued on the plane's stream, not waited for here.
            timeline.activity_start_all(names, ACT_QUEUE)
            timeline.activity_end_all(names)
            timeline.activity_start_all(names, ACT_COLLECTIVE)
            tx = time.monotonic() if self._trace_on else 0.0
            try:
                backend, status = self.op_manager.execute(entries, response)
                key = f"responses.{backend}"
                self.stats[key] = self.stats.get(key, 0) + 1
            except WorldAbortedError as e:
                # The channel died mid-collective: fail this batch with
                # the structured status, then let the loop abort.
                raise self._data_plane_abort(
                    entries, e.origin_rank, e.cause,
                    getattr(e, "resolved", False)) from e
            except (ConnectionError, OSError, TimeoutError) as e:
                rank = self.controller.rank
                raise self._data_plane_abort(
                    entries, rank, f"data-plane failure during {op_name} "
                                   f"on rank {rank}: {e}") from e
            except Exception as e:
                status = Status.UnknownError(
                    f"collective execution failed: {e!r}")
            if tx:
                # The batch's issue-side wall time (a batch completed on
                # the finalizer ends later, as the timeline's span does).
                self._trace.slice(f"{op_name} x{len(entries)}", tx,
                                  time.monotonic() - tx, self._world_cycle)
            # An InProgress batch ends its spans at the issue; its
            # finalizer fires the callbacks when it completes.
            timeline.activity_end_all(names)
            for name in names:
                timeline.end(name)
            if status.in_progress():
                continue
            for e in entries:
                if e.callback:
                    e.callback(status)
