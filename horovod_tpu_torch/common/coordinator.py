"""Rank-0 coordinator: readiness counting, response construction, fusion
and stall detection.

Counterpart of ``horovod_tpu/common/coordinator.py``: ``MessageTable``
(:42), ``construct_response`` (:99) with all of its cross-rank checks
and the wire-dtype verdict (:222-271),
``_response_bytes`` and ``fuse_responses`` (:282-390), and
``StallInspector`` (:613), and the response cache: ``CACHEABLE_*``
(:383), ``iter_set_bits``, ``_CacheEntry`` and ``ResponseCache``
(:390-611). It turns requests that ranks submit in their own orders
into one validated, fused, globally agreed order, and keeps the
negotiated verdicts that a steady-state loop replays. It is host code
on Request and Response objects and runs unchanged on any tensor
type.

One departure: a REDUCESCATTER response carries the request's scale
factors, as an ALLREDUCE response does. The reference's leaves them at
1.0 (:257-271), so that an averaged reducescatter returns the sum on its
socket plane.
"""

from __future__ import annotations

import heapq
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

from horovod_tpu_torch.common import logging as hlog
from horovod_tpu_torch.common import wire_dtype as _wd
from horovod_tpu_torch.common.message import (
    DataType, Request, RequestType, Response, ResponseType, datatype_name,
    datatype_size,
)


class _TensorRecord:
    __slots__ = ("requests", "first_request_time")

    def __init__(self):
        self.requests: List[Request] = []
        self.first_request_time = time.monotonic()


class MessageTable:
    """Pending negotiations: tensor name → requests received so far
    (reference: global_state.h:120-125, operations.cc:110-117)."""

    def __init__(self, on_remove=None):
        self._table: Dict[str, _TensorRecord] = {}
        # FIFO of names that became ready this cycle, in readiness order
        # (reference: operations.cc ready_to_reduce, 1069-1079).
        self._ready: List[str] = []
        # Fired with the tensor name whenever a negotiation completes
        # (the StallInspector clears its warned-set entry so a
        # recurring name that stalls AGAIN warns again).
        self._on_remove = on_remove

    def increment_tensor_count(self, msg: Request, size: int,
                               timeline=None) -> bool:
        """Record one rank's request; True when all ``size`` ranks have
        reported (reference: operations.cc:163-189)."""
        name = msg.tensor_name
        rec = self._table.get(name)
        if rec is None:
            rec = _TensorRecord()
            self._table[name] = rec
            if timeline is not None:
                timeline.negotiate_start(name, msg.request_type)
        rec.requests.append(msg)
        if timeline is not None:
            timeline.negotiate_rank_ready(name, msg.request_rank)
        ready = len(rec.requests) == size
        if ready:
            self._ready.append(name)
        return ready

    def pop_ready(self) -> List[str]:
        ready = self._ready
        self._ready = []
        return ready

    def requests_for(self, name: str) -> List[Request]:
        return self._table[name].requests

    def remove(self, name: str) -> None:
        del self._table[name]
        if self._on_remove is not None:
            self._on_remove(name)

    def pending(self) -> List[Tuple[str, float, List[int]]]:
        """(name, age_seconds, ranks_reported) for stall reporting."""
        now = time.monotonic()
        return [(name, now - rec.first_request_time,
                 sorted(r.request_rank for r in rec.requests))
                for name, rec in self._table.items()]


def construct_response(table: MessageTable, name: str,
                       size: int) -> Response:
    """Build the (validated) Response for a fully-negotiated tensor
    (reference: operations.cc:197-399). Removes the entry from the table.

    Validation performed across ranks, any failure → ERROR response that
    every requesting rank surfaces as an exception:
    - mismatched collective op
    - mismatched dtype
    - mismatched shapes (allreduce/broadcast/reducescatter: all dims;
      allgather/alltoall: all dims but dim 0)
    - mismatched root ranks (broadcast)
    - mixed host/device placement
    """
    requests = table.requests_for(name)
    assert len(requests) == size

    error = None

    first = requests[0]
    # Op consistency (reference: operations.cc:223-237).
    for req in requests[1:]:
        if req.request_type != first.request_type:
            error = ("Mismatched collective operations requested: one rank "
                     f"requested {first.request_type.name}, another rank "
                     f"requested {req.request_type.name}.")
            break

    # Dtype consistency (reference: operations.cc:205-221).
    if error is None:
        for req in requests[1:]:
            if req.tensor_type != first.tensor_type:
                error = ("Mismatched data types: one rank sent "
                         f"{datatype_name(first.tensor_type)}, another rank "
                         f"sent {datatype_name(req.tensor_type)}.")
                break

    # Placement consistency (reference: operations.cc:352-365 CPU-vs-GPU).
    if error is None:
        on_device = [req.device >= 0 for req in requests]
        if any(on_device) and not all(on_device):
            error = ("Mismatched tensor placement: some ranks submitted "
                     "host tensors while others submitted device tensors.")

    op = first.request_type
    tensor_sizes: List[int] = []

    if error is None and op in (RequestType.ALLREDUCE,
                                RequestType.BROADCAST,
                                RequestType.REDUCESCATTER,
                                RequestType.ALLTOALL):
        # Exact shape match (reference: operations.cc:240-260).
        for req in requests[1:]:
            if req.tensor_shape != first.tensor_shape:
                error = (f"Mismatched {op.name.lower()} tensor shapes: one "
                         f"rank sent a tensor of shape "
                         f"{list(first.tensor_shape)}, another rank sent a "
                         f"tensor of shape {list(req.tensor_shape)}.")
                break

    if error is None and op == RequestType.ALLGATHER:
        # Same rank; same dims except dim 0 (reference: 262-319).
        for req in requests[1:]:
            if len(req.tensor_shape) != len(first.tensor_shape):
                error = (f"Mismatched {op.name.lower()} tensor ranks: one "
                         f"rank sent a {len(first.tensor_shape)}-d tensor, "
                         f"another rank sent a "
                         f"{len(req.tensor_shape)}-d tensor.")
                break
            if req.tensor_shape[1:] != first.tensor_shape[1:]:
                error = (f"Mismatched {op.name.lower()} tensor shapes: "
                         "dimensions beyond the first must match on every "
                         f"rank; got {list(first.tensor_shape)} and "
                         f"{list(req.tensor_shape)}.")
                break
        if error is None:
            if not first.tensor_shape:
                error = (f"Rank zero tensors cannot be "
                         f"{op.name.lower()}ed: at least one dimension is "
                         "required.")
            else:
                # dim-0 size per rank, in rank order (reference: 300-316).
                by_rank = sorted(requests, key=lambda r: r.request_rank)
                tensor_sizes = [r.tensor_shape[0] for r in by_rank]

    if error is None and op == RequestType.ALLTOALL:
        if not first.tensor_shape or first.tensor_shape[0] % size != 0:
            error = ("alltoall requires the first dimension to be "
                     f"divisible by the world size {size}; got shape "
                     f"{list(first.tensor_shape)}.")

    if error is None and op == RequestType.REDUCESCATTER:
        if not first.tensor_shape or first.tensor_shape[0] % size != 0:
            error = ("reducescatter requires the first dimension to be "
                     f"divisible by the world size {size}; got shape "
                     f"{list(first.tensor_shape)}.")

    if error is None and op == RequestType.BROADCAST:
        # Root rank consistency (reference: operations.cc:321-337).
        for req in requests[1:]:
            if req.root_rank != first.root_rank:
                error = ("Mismatched broadcast root ranks: one rank "
                         f"specified root rank {first.root_rank}, another "
                         f"rank specified root rank {req.root_rank}.")
                break
        if error is None and not (0 <= first.root_rank < size):
            error = (f"Invalid broadcast root rank {first.root_rank} for "
                     f"world size {size}.")

    devices = [0] * size
    for req in requests:
        devices[req.request_rank] = req.device

    table.remove(name)

    if error is not None:
        return Response(response_type=ResponseType.ERROR,
                        tensor_names=[name], error_message=error)

    # The wire-dtype verdict (common/wire_dtype.py): the least aggressive
    # proposal across the ranks, so that one rank started without
    # compression keeps the tensor uncompressed everywhere; only
    # float32/float64 tensors ever carry one.
    compressible = first.tensor_type in _wd.COMPRESSIBLE
    if op == RequestType.ALLREDUCE:
        numel = 1
        for d in first.tensor_shape:
            numel *= d
        return Response(response_type=ResponseType.ALLREDUCE,
                        tensor_names=[name], devices=devices,
                        tensor_sizes=[numel],
                        prescale_factor=first.prescale_factor,
                        postscale_factor=first.postscale_factor,
                        wire_dtype=_wd.resolve(r.wire_dtype for r in requests)
                        if compressible else _wd.WIRE_NONE)
    if op == RequestType.ALLGATHER:
        # int8 degrades to bf16: the gathered blocks join into one
        # payload, which cannot carry per-rank scales.
        return Response(response_type=ResponseType.ALLGATHER,
                        tensor_names=[name], devices=devices,
                        tensor_sizes=tensor_sizes,
                        wire_dtype=_wd.allgather_wire(
                            _wd.resolve(r.wire_dtype for r in requests))
                        if compressible else _wd.WIRE_NONE)
    if op == RequestType.BROADCAST:
        return Response(response_type=ResponseType.BROADCAST,
                        tensor_names=[name], devices=devices)
    if op == RequestType.ALLTOALL:
        return Response(response_type=ResponseType.ALLTOALL,
                        tensor_names=[name], devices=devices)
    if op == RequestType.REDUCESCATTER:
        numel = 1
        for d in first.tensor_shape:
            numel *= d
        # int8 in full: the star's coordinator dequantizes each rank's
        # payload with its own scale and quantizes each output slice.
        return Response(response_type=ResponseType.REDUCESCATTER,
                        tensor_names=[name], devices=devices,
                        tensor_sizes=[numel],
                        prescale_factor=first.prescale_factor,
                        postscale_factor=first.postscale_factor,
                        wire_dtype=_wd.resolve(r.wire_dtype for r in requests)
                        if compressible else _wd.WIRE_NONE)
    if op == RequestType.BARRIER:
        return Response(response_type=ResponseType.BARRIER,
                        tensor_names=[name])
    # JOIN (elastic membership) is wire-defined for forward compat but
    # not implemented; answer with ERROR rather than killing the loop.
    return Response(response_type=ResponseType.ERROR, tensor_names=[name],
                    error_message=f"Operation {op.name} is not supported "
                    "by this coordinator.")


def _response_bytes(resp: Response, dtype: DataType,
                    slice_numels: Dict[str, int]) -> int:
    """Payload bytes a response moves. ALLREDUCE tensor_sizes are
    per-tensor numels; ALLGATHER tensor_sizes are per-rank dim-0 rows,
    so the output size is rows × slice-numel (the reference's
    ``TotalByteSizeOfAllgatherOutput``, operations.cc:1178-1191)."""
    if resp.response_type == ResponseType.ALLGATHER:
        return (sum(resp.tensor_sizes)
                * slice_numels[resp.tensor_names[0]]
                * datatype_size(dtype))
    return sum(resp.tensor_sizes) * datatype_size(dtype)


def fuse_responses(responses: List[Response],
                   dtypes: Dict[str, DataType],
                   fusion_threshold_bytes: int,
                   slice_numels: Dict[str, int] = None) -> List[Response]:
    """Batch compatible consecutive ALLREDUCE **and ALLGATHER**
    responses under the fusion threshold, with the reference's
    look-ahead-skip behaviour: a tensor that cannot join the current
    batch does not end it — later compatible tensors may still join,
    and skipped ones are retried in order
    (reference: horovod/common/operations.cc:1118-1234; the allgather
    branch 1172-1234 accounts bytes as dim0-sum × slice-size).

    ``dtypes`` maps tensor name → dtype (fusion requires same dtype and
    same device placement; we fuse host-side entries and device entries
    separately via the devices signature). ``slice_numels`` maps
    name → elements per dim-0 row, needed for allgather byte
    accounting. A fused ALLGATHER response keeps ``tensor_sizes``
    entry-major: sizes[ec * world_size + rc] is entry ec's dim-0
    contribution from rank rc (reference:
    Response::add_allgather_response, message.cc:306-314).
    """
    # Without slice numels, allgather byte accounting is impossible —
    # pass allgathers through unfused (pre-fusion behavior) instead of
    # guessing sizes or crashing the coordinator loop.
    fusable = ((ResponseType.ALLREDUCE, ResponseType.ALLGATHER)
               if slice_numels is not None
               else (ResponseType.ALLREDUCE,))
    slice_numels = slice_numels or {}
    # Deques keep every enqueue/dequeue O(1): the previous list.pop(0)
    # version shifted the whole remainder on each pop, which made even
    # the no-fusion pass O(n^2) — invisible at 8 tensors/cycle, real
    # money in a 64-rank many-tensor storm (guarded by
    # tests/test_coordinator.py::test_coordinator_cycle_cost_64_ranks).
    queue = deque(responses)
    fused: List[Response] = []
    while queue:
        resp = queue.popleft()
        if resp.response_type not in fusable:
            fused.append(resp)
            continue
        dtype = dtypes[resp.tensor_names[0]]
        tensor_bytes = _response_bytes(resp, dtype, slice_numels)
        if tensor_bytes >= fusion_threshold_bytes:
            fused.append(resp)
            continue
        skipped: deque = deque()
        while queue:
            cand = queue.popleft()
            joinable = (
                cand.response_type == resp.response_type
                and dtypes[cand.tensor_names[0]] == dtype
                and cand.devices == resp.devices
                and cand.prescale_factor == resp.prescale_factor
                and cand.postscale_factor == resp.postscale_factor
                # one fused buffer = one wire representation and one
                # data-plane route; mixed verdicts must not share it
                and cand.wire_dtype == resp.wire_dtype
                and cand.algorithm == resp.algorithm)
            if joinable:
                # Byte accounting once per candidate, after the cheap
                # compatibility checks pass (and only then — computing
                # it first would price every incompatible candidate
                # too, and the allgather branch does real arithmetic).
                cand_bytes = _response_bytes(cand, dtype, slice_numels)
                joinable = (tensor_bytes + cand_bytes
                            <= fusion_threshold_bytes)
            if joinable:
                for n in cand.tensor_names:
                    resp.add_tensor_name(n)
                for s in cand.tensor_sizes:
                    resp.add_tensor_size(s)
                tensor_bytes += cand_bytes
            else:
                skipped.append(cand)
        queue = skipped
        fused.append(resp)
    return fused


# Response types whose negotiated verdicts are worth replaying: the
# signature (op, dtype, shape, root, device, scales) fully determines the
# Response. BARRIER is pure negotiation and JOIN/ERROR are one-shot.
CACHEABLE_REQUESTS = frozenset((
    RequestType.ALLREDUCE, RequestType.ALLGATHER, RequestType.BROADCAST,
    RequestType.ALLTOALL, RequestType.REDUCESCATTER,
))
CACHEABLE_RESPONSES = frozenset((
    ResponseType.ALLREDUCE, ResponseType.ALLGATHER,
    ResponseType.BROADCAST, ResponseType.ALLTOALL,
    ResponseType.REDUCESCATTER,
))


def iter_set_bits(mask: int):
    """Set bit positions of ``mask``, ascending: the one order every
    mask-driven cache change and replay uses, so that eviction, LRU
    touch and replay iterate alike on every rank."""
    while mask:
        low = mask & -mask
        mask ^= low
        yield low.bit_length() - 1


class _CacheEntry:
    __slots__ = ("name", "signature", "response", "dtype", "slice_numel",
                 "slot")

    def __init__(self, name: str, signature: tuple, response: Response,
                 dtype: DataType, slice_numel: int, slot: int):
        self.name = name
        self.signature = signature
        self.response = response
        self.dtype = dtype
        self.slice_numel = slice_numel
        self.slot = slot

    def clone_response(self) -> Response:
        """A fresh Response for fusion: ``fuse_responses`` extends the
        batch head's name and size lists, which must never reach the
        cached copy."""
        r = self.response
        return Response(response_type=r.response_type,
                        tensor_names=list(r.tensor_names),
                        error_message=r.error_message,
                        devices=list(r.devices),
                        tensor_sizes=list(r.tensor_sizes),
                        prescale_factor=r.prescale_factor,
                        postscale_factor=r.postscale_factor,
                        wire_dtype=r.wire_dtype,
                        algorithm=r.algorithm)


class ResponseCache:
    """World-coherent LRU cache of negotiated per-tensor Responses: the
    steady-state negotiation path (Horovod's ``HOROVOD_CACHE_CAPACITY``
    bit-vector cache).

    Coherence: every structural change (put, eviction, LRU touch) is
    driven only by world-identical inputs, the broadcast response stream
    for puts and the coordinator's broadcast grant and invalidate masks
    for touches and evictions, applied in one order (ascending slot
    order for masks, stream order for puts). Signatures are rank-local
    (an allgather's dim 0 and the device differ per rank); everything
    else (slot assignment, LRU order, eviction choice, epoch) is the
    same on every rank, which is what lets a rank's slot bit stand for
    its serialized Request. ``epoch`` counts structural events and rides
    every bitmask frame, so that a divergence fails fast instead of
    running mismatched collectives."""

    MISS, HIT, INVALID = range(3)

    def __init__(self, capacity: int, epoch0: int = 0):
        if capacity <= 0:
            raise ValueError("ResponseCache capacity must be positive")
        self.capacity = capacity
        self.epoch = epoch0
        # name -> entry, in LRU order (first = oldest)
        self._lru: "OrderedDict[str, _CacheEntry]" = OrderedDict()
        self._slots: List[Optional[_CacheEntry]] = []
        self._free: List[int] = []  # min-heap of freed slots
        # Local counts (not part of the coherent state).
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._lru)

    @property
    def nslots(self) -> int:
        return len(self._slots)

    @staticmethod
    def signature(req: Request) -> tuple:
        """Everything that determines a Request's negotiated verdict
        (rank-local: shape and device may differ per rank). The proposed
        wire dtype is part of it: a changed knob renegotiates the
        compression verdict instead of replaying a stale one."""
        return (int(req.request_type), int(req.tensor_type),
                req.tensor_shape, req.root_rank, req.device,
                req.prescale_factor, req.postscale_factor,
                req.wire_dtype)

    def lookup(self, req: Request) -> Tuple[int, int]:
        """(state, slot): HIT when the request matches the cached
        signature; INVALID when the name is cached under another
        signature (the slot must be evicted world-wide); MISS when the
        name is not cached. Never moves the LRU order (a local lookup is
        not a world-identical event)."""
        e = self._lru.get(req.tensor_name)
        if e is None:
            self.misses += 1
            return self.MISS, -1
        # Field by field against the stored signature (indices as in
        # signature()): this runs once per queued request per cycle.
        s = e.signature
        if (s[0] == req.request_type and s[1] == req.tensor_type
                and s[2] == req.tensor_shape and s[3] == req.root_rank
                and s[4] == req.device
                and s[5] == req.prescale_factor
                and s[6] == req.postscale_factor
                and s[7] == req.wire_dtype):
            self.hits += 1
            return self.HIT, e.slot
        self.misses += 1
        return self.INVALID, e.slot

    def put(self, name: str, signature: tuple, response: Response,
            dtype: DataType, slice_numel: int) -> None:
        """Insert or refresh from the negotiated response stream, in
        stream order on every rank: the LRU order and the capacity
        evictions follow the call order."""
        e = self._lru.get(name)
        if e is not None:
            e.signature = signature
            e.response = response
            e.dtype = dtype
            e.slice_numel = slice_numel
            self._lru.move_to_end(name)
            self.epoch += 1
            return
        if len(self._lru) >= self.capacity:
            _, victim = self._lru.popitem(last=False)
            self._slots[victim.slot] = None
            heapq.heappush(self._free, victim.slot)
            self.epoch += 1
            self.evictions += 1
        if self._free:
            slot = heapq.heappop(self._free)
        else:
            slot = len(self._slots)
            self._slots.append(None)
        entry = _CacheEntry(name, signature, response, dtype, slice_numel,
                            slot)
        self._slots[slot] = entry
        self._lru[name] = entry
        self.epoch += 1

    def evict_slots(self, mask: int) -> None:
        """Evict every slot set in ``mask``, ascending."""
        for slot in iter_set_bits(mask):
            self._evict(slot)

    def evict_name(self, name: str) -> None:
        e = self._lru.get(name)
        if e is not None:
            self._evict(e.slot)

    def _evict(self, slot: int) -> None:
        e = self._slots[slot]
        if e is None:
            return
        self._slots[slot] = None
        del self._lru[e.name]
        heapq.heappush(self._free, slot)
        self.epoch += 1
        self.evictions += 1

    def touch_mask(self, mask: int) -> None:
        """Mark granted slots most recently used, ascending. The epoch
        does not move: no slot's name changes, and the replay plans stay
        valid across hit cycles."""
        for slot in iter_set_bits(mask):
            e = self._slots[slot]
            if e is not None:
                self._lru.move_to_end(e.name)

    def slot_mask(self, response_type: ResponseType) -> int:
        """Mask of the occupied slots holding a verdict of
        ``response_type`` (read only)."""
        mask = 0
        for e in self._slots:
            if e is not None \
                    and e.response.response_type == response_type:
                mask |= 1 << e.slot
        return mask

    def entry(self, slot: int) -> _CacheEntry:
        e = self._slots[slot]
        if e is None:
            raise KeyError(f"response cache slot {slot} is empty")
        return e

    def state_fingerprint(self) -> tuple:
        """(epoch, ((slot, name) ascending), LRU name order): the part
        of the state every rank holds alike."""
        return (self.epoch,
                tuple((e.slot, e.name) for e in self._slots
                      if e is not None),
                tuple(self._lru))


class StallInspector:
    """Coordinator-side stall detection
    (reference: operations.cc:543-624 CheckForStalledTensors; env knobs
    HOROVOD_STALL_CHECK_TIME_SECONDS / HOROVOD_STALL_SHUTDOWN_TIME_SECONDS)."""

    def __init__(self, size: int, warning_time: float = 60.0,
                 shutdown_time: float = 0.0, disabled: bool = False):
        self.size = size
        self.warning_time = warning_time
        self.shutdown_time = shutdown_time
        self.disabled = disabled
        self._last_check = time.monotonic()
        # The cycle thread warns (check) while tensor_completed may run
        # on another thread: test-and-add must be atomic against the
        # discard or a name warns twice.
        self._warned_lock = threading.Lock()
        self._warned: set = set()

    def should_check(self) -> bool:
        if self.disabled or self.warning_time <= 0:
            return False
        return time.monotonic() - self._last_check >= self.warning_time

    def tensor_completed(self, name: str) -> None:
        """A stalled tensor finally negotiated: forget that we warned
        about it, so the SAME recurring name stalling again later in
        the process lifetime warns again (MessageTable.remove hook)."""
        with self._warned_lock:
            self._warned.discard(name)

    def check(self, table: MessageTable, cache_stats: str = "",
              world_stats: str = "",
              straggler_stats: str = "") -> bool:
        """Log a report of stalled tensors; returns True if the shutdown
        threshold was exceeded (the caller must then shut down).
        ``cache_stats``: a one-line summary of the response cache (hits,
        misses, cached cycles) logged with the report, which says
        whether negotiation went the full way or through the bitmask.
        ``world_stats``: the world's health (the world cycle, the tensor
        queue's depth, the wire plan, the peers' heartbeat ages on the
        coordinator's clock, their clock offsets, the timeline's dropped
        events), logged and appended to every stall warning, so that one
        warning carries enough to diagnose without a second tool.
        ``straggler_stats``: the trace plane's critical-path line ("rank
        3 last-arriver in 84% of the last 1000 gathers"), which names a
        slow rank even when nothing is stalled outright."""
        self._last_check = time.monotonic()
        if cache_stats:
            hlog.info(f"negotiation {cache_stats}")
        if world_stats:
            hlog.info(f"world health: {world_stats}")
        if straggler_stats:
            hlog.info(f"stragglers: {straggler_stats}")
        suffix = f" [world: {world_stats}]" if world_stats else ""
        must_shutdown = False
        for name, age, ranks_reported in table.pending():
            if age < self.warning_time:
                continue
            missing = [r for r in range(self.size)
                       if r not in ranks_reported]
            with self._warned_lock:
                if name in self._warned:
                    if self.shutdown_time > 0 and \
                            age >= self.shutdown_time:
                        must_shutdown = True
                    continue
                self._warned.add(name)
            hlog.warning(
                f"One or more tensors were submitted to be reduced, "
                f"gathered or broadcasted by subset of ranks and are "
                f"waiting for remainder of ranks for more than "
                f"{int(age)} seconds. Stalled op: {name} "
                f"[ready ranks: {ranks_reported}, "
                f"waiting on ranks: {missing}]{suffix}")
            if self.shutdown_time > 0 and age >= self.shutdown_time:
                hlog.error(
                    f"Stalled tensor {name} exceeded the shutdown "
                    f"threshold of {self.shutdown_time} s; shutting down.")
                must_shutdown = True
        return must_shutdown
