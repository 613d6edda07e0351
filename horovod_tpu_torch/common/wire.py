"""Binary wire format of the control plane.

Counterpart of ``horovod_tpu/common/wire.py``: the request-list and
response-list frames (:69-350), the cycle frames that carry them (FULL
and the response cache's CACHED, CACHED_AGG and CACHED_SPEC kinds,
:329-600), ``combine_cycle_requests`` (:705) and the world-id envelope
(``stamp_world``, ``unstamp_world``), and the METRICS and TRACE frames
of the observability planes with the span kinds and the flight
recorder's event codes (:585-880). For equal contents the frames are
byte-identical to the reference's, and each side parses the other's. A
truncated frame raises ``ConnectionError``, never ``struct.error``; a
frame of an unknown kind is refused by its number. The elastic and
tenant frames wait for their slices (``ROADMAP.md`` A6 and A9).

Layout (all little-endian; strings are u32 length + UTF-8 bytes,
vectors u32 count + elements):

  Request      := u8 request_type | i32 request_rank | u8 tensor_type
                | u8 wire_dtype | i32 root_rank | i32 device
                | str tensor_name
                | f64 prescale | f64 postscale | u8 ndim | i64 dims[ndim]
  RequestList  := u8 shutdown | u32 n | Request[n]
  Response     := u8 response_type | u8 wire_dtype | u8 algorithm
                | str error_message
                | f64 prescale | f64 postscale
                | u32 nnames | str names[nnames]
                | u32 ndev | i32 devices[ndev]
                | u32 nsz  | i64 tensor_sizes[nsz]
  ResponseList := u8 shutdown | f64 tuned_cycle_time_ms
                | i64 tuned_fusion_threshold_bytes
                | i64 tuned_overlap_buckets | u32 n | Response[n]

  CycleRequest  := u8 kind
    kind 0 FULL        : RequestList
    kind 1 CACHED      : u8 shutdown | i64 epoch | u32 nslots
                       | hit_mask[ceil(nslots/8)] | invalid_mask[...]
                       | u32 n | Request[n] (the uncached rest)
    kind 2 CACHED_AGG  : as CACHED, several ranks' frames folded into one
                         (hit masks ANDed, invalid masks and shutdown
                         ORed, requests concatenated)
    kind 3 CACHED_SPEC : i64 epoch | u32 nslots | hit_mask[...]
                       | segments (the fused speculative cycle: a pure-hit
                         mask with this rank's pre-packed fused allreduce
                         buffers attached)
  CycleResponse := u8 kind
    kind 0 FULL        : ResponseList
    kind 1 CACHED      : i64 epoch | u32 nslots | grant_mask[...]
                       | invalid_mask[...] | ResponseList
    kind 3 CACHED_SPEC : i64 epoch | u32 nslots | grant_mask[...]
                       | segments (the world-reduced fused buffers)
  segments      := u32 nseg | nseg x (u8 dtype | i64 nbytes | raw bytes)

Masks are little-endian fixed-width bit vectors, one bit per response
cache slot.
"""

from __future__ import annotations

import struct

from horovod_tpu_torch.common.message import (
    CacheCycleRequest, CacheCycleResponse, DataType, Request, RequestList,
    RequestType, Response, ResponseList, ResponseType,
)

_U8 = struct.Struct("<B")
_U32 = struct.Struct("<I")
_I32 = struct.Struct("<i")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")

# Combined-field structs for the hot request path: the coordinator
# parses world_size RequestLists per cycle, and per-field unpacks +
# enum __call__ dominate that cost (measured 86% of a synthetic
# 64-rank cycle). Same wire layout, one unpack per segment.
# type|rank|dtype|wire_dtype|root|device|namelen — wire_dtype is the
# rank's proposed on-the-wire compression (WIRE_* codes,
# common/wire_dtype.py), negotiated by the coordinator like the
# fusion threshold.
_REQ_HEAD = struct.Struct("<BiBBiiI")
_REQ_TAIL = struct.Struct("<ddB")     # prescale|postscale|ndim
_REQ_TYPE_OF = RequestType._value2member_map_
_DTYPE_OF = DataType._value2member_map_
_RESP_TYPE_OF = ResponseType._value2member_map_


class _Writer:
    def __init__(self):
        self.parts = []

    def u8(self, v): self.parts.append(_U8.pack(v))
    def u32(self, v): self.parts.append(_U32.pack(v))
    def i32(self, v): self.parts.append(_I32.pack(v))
    def i64(self, v): self.parts.append(_I64.pack(v))
    def f64(self, v): self.parts.append(_F64.pack(v))

    def string(self, s: str):
        b = s.encode("utf-8")
        self.u32(len(b))
        self.parts.append(b)

    def bytes(self) -> bytes:
        return b"".join(self.parts)


class _Reader:
    def __init__(self, data: bytes, offset: int = 0):
        self.data = data
        self.off = offset

    def _need(self, n: int) -> None:
        """Length guard ahead of every fixed-width read: a truncated
        frame must surface as a transport error (ConnectionError) the
        abort machinery understands, never as struct.error/IndexError
        deep inside a parse — and a short mask/segment slice must
        never silently decode a WRONG value."""
        if self.off + n > len(self.data):
            raise ConnectionError(
                f"truncated control frame: need {n} bytes at offset "
                f"{self.off}, have {len(self.data) - self.off}")

    def u8(self):
        self._need(1)
        v = _U8.unpack_from(self.data, self.off)[0]
        self.off += 1
        return v

    def u32(self):
        self._need(4)
        v = _U32.unpack_from(self.data, self.off)[0]
        self.off += 4
        return v

    def i32(self):
        self._need(4)
        v = _I32.unpack_from(self.data, self.off)[0]
        self.off += 4
        return v

    def i64(self):
        self._need(8)
        v = _I64.unpack_from(self.data, self.off)[0]
        self.off += 8
        return v

    def f64(self):
        self._need(8)
        v = _F64.unpack_from(self.data, self.off)[0]
        self.off += 8
        return v

    def string(self) -> str:
        n = self.u32()
        self._need(n)
        s = self.data[self.off:self.off + n].decode("utf-8")
        self.off += n
        return s


def _write_request(w: _Writer, req: Request) -> None:
    name = req.tensor_name.encode("utf-8")
    shape = req.tensor_shape
    w.parts.append(_REQ_HEAD.pack(
        int(req.request_type), req.request_rank, int(req.tensor_type),
        req.wire_dtype, req.root_rank, req.device, len(name)))
    w.parts.append(name)
    w.parts.append(_REQ_TAIL.pack(
        req.prescale_factor, req.postscale_factor, len(shape)))
    if shape:
        w.parts.append(struct.pack(f"<{len(shape)}q", *shape))


def _read_request(r: _Reader) -> Request:
    data, off = r.data, r.off
    r._need(_REQ_HEAD.size)
    (req_type, request_rank, tensor_type, wire_dtype, root_rank,
     device, namelen) = _REQ_HEAD.unpack_from(data, off)
    off += _REQ_HEAD.size
    if off + namelen + _REQ_TAIL.size > len(data):
        raise ConnectionError(
            f"truncated request frame at offset {off}")
    name = data[off:off + namelen].decode("utf-8")
    off += namelen
    prescale, postscale, ndim = _REQ_TAIL.unpack_from(data, off)
    off += _REQ_TAIL.size
    if ndim:
        if off + 8 * ndim > len(data):
            raise ConnectionError(
                f"truncated request frame at offset {off}")
        shape = struct.unpack_from(f"<{ndim}q", data, off)
        off += 8 * ndim
    else:
        shape = ()
    r.off = off
    # Direct slot assignment: the wire reader already holds real enum
    # members and an int tuple, so Request.__init__'s defensive
    # coercions (enum calls, per-dim int()) are pure overhead on the
    # coordinator's hottest loop.
    req = Request.__new__(Request)
    req.request_rank = request_rank
    req.request_type = _REQ_TYPE_OF[req_type]
    req.tensor_type = _DTYPE_OF[tensor_type]
    req.tensor_name = name
    req.root_rank = root_rank
    req.device = device
    req.tensor_shape = shape
    req.prescale_factor = prescale
    req.postscale_factor = postscale
    req.wire_dtype = wire_dtype
    return req


def serialize_request_list(rl: RequestList) -> bytes:
    w = _Writer()
    w.u8(1 if rl.shutdown else 0)
    w.u32(len(rl.requests))
    for req in rl.requests:
        _write_request(w, req)
    return w.bytes()


def parse_request_list(data: bytes, offset: int = 0) -> RequestList:
    r = _Reader(data, offset)
    shutdown = bool(r.u8())
    n = r.u32()
    return RequestList([_read_request(r) for _ in range(n)], shutdown)


def _write_response(w: _Writer, resp: Response) -> None:
    w.u8(int(resp.response_type))
    # The coordinator's world-coherent data-plane verdicts: resolved
    # wire dtype + stamped algorithm (WIRE_*/ALG_*, wire_dtype.py).
    w.u8(resp.wire_dtype)
    w.u8(resp.algorithm)
    w.string(resp.error_message)
    w.f64(resp.prescale_factor)
    w.f64(resp.postscale_factor)
    w.u32(len(resp.tensor_names))
    for name in resp.tensor_names:
        w.string(name)
    # vectors as one pack each: every rank parses the broadcast
    # ResponseList each cycle, and devices/tensor_sizes grow with
    # world size (devices) and fused batch width (sizes)
    devices = resp.devices
    w.u32(len(devices))
    if devices:
        w.parts.append(struct.pack(f"<{len(devices)}i", *devices))
    sizes = resp.tensor_sizes
    w.u32(len(sizes))
    if sizes:
        w.parts.append(struct.pack(f"<{len(sizes)}q", *sizes))


def _read_response(r: _Reader) -> Response:
    resp_type = _RESP_TYPE_OF[r.u8()]
    wire_dtype = r.u8()
    algorithm = r.u8()
    err = r.string()
    prescale = r.f64()
    postscale = r.f64()
    names = [r.string() for _ in range(r.u32())]
    ndev = r.u32()
    if ndev:
        r._need(4 * ndev)
        devices = list(struct.unpack_from(f"<{ndev}i", r.data, r.off))
        r.off += 4 * ndev
    else:
        devices = []
    nsz = r.u32()
    if nsz:
        r._need(8 * nsz)
        sizes = list(struct.unpack_from(f"<{nsz}q", r.data, r.off))
        r.off += 8 * nsz
    else:
        sizes = []
    return Response(response_type=resp_type, tensor_names=names,
                    error_message=err, devices=devices, tensor_sizes=sizes,
                    prescale_factor=prescale, postscale_factor=postscale,
                    wire_dtype=wire_dtype, algorithm=algorithm)


def serialize_response_list(rl: ResponseList) -> bytes:
    w = _Writer()
    w.u8(1 if rl.shutdown else 0)
    w.f64(rl.tuned_cycle_time_ms)
    w.i64(rl.tuned_fusion_threshold_bytes)
    w.i64(rl.tuned_overlap_buckets)
    w.u32(len(rl.responses))
    for resp in rl.responses:
        _write_response(w, resp)
    return w.bytes()


def parse_response_list(data: bytes,
                        offset: int = 0) -> ResponseList:
    r = _Reader(data, offset)
    shutdown = bool(r.u8())
    tuned_cycle = r.f64()
    tuned_fusion = r.i64()
    tuned_overlap = r.i64()
    n = r.u32()
    return ResponseList([_read_response(r) for _ in range(n)], shutdown,
                        tuned_cycle_time_ms=tuned_cycle,
                        tuned_fusion_threshold_bytes=tuned_fusion,
                        tuned_overlap_buckets=tuned_overlap)


FRAME_FULL = 0
FRAME_CACHED = 1
FRAME_CACHED_AGG = 2
FRAME_CACHED_SPEC = 3


def _mask_nbytes(nslots: int) -> int:
    return (nslots + 7) // 8


def _write_mask(w: _Writer, mask: int, nslots: int) -> None:
    w.parts.append(mask.to_bytes(_mask_nbytes(nslots), "little"))


def _read_mask(r: _Reader, nslots: int) -> int:
    n = _mask_nbytes(nslots)
    # Guard before the slice: int.from_bytes over a short slice would
    # decode a wrong mask.
    r._need(n)
    mask = int.from_bytes(r.data[r.off:r.off + n], "little")
    r.off += n
    return mask


def _seg_hdr(dt, nbytes: int) -> bytes:
    """The 9-byte header in front of one raw segment."""
    return _U8.pack(int(dt)) + _I64.pack(nbytes)


def spec_frame_parts(epoch: int, nslots: int, mask: int, seg_meta,
                     world_id: int = 0):
    """(prefix, [seg_hdr, ...]): the constant byte regions of a
    CACHED_SPEC cycle frame, everything but the raw segment data, for
    ``seg_meta`` = [(DataType, nbytes), ...]. The one source of the
    speculative layout: the request and the response share it (a granted
    speculative cycle's grant mask is the bid's hit mask), and a
    sub-world's prefix leads with the world-id envelope."""
    w = _Writer()
    if world_id:
        w.parts.append(TENANT_PREFIX)
        w.u32(world_id)
    w.u8(FRAME_CACHED_SPEC)
    w.i64(epoch)
    w.u32(nslots)
    _write_mask(w, mask, nslots)
    w.u32(len(seg_meta))
    return w.bytes(), [_seg_hdr(dt, nbytes) for dt, nbytes in seg_meta]


def spec_frame_chunks(epoch: int, nslots: int, mask: int,
                      segments) -> list:
    """A CACHED_SPEC frame (request or response) as the list of its
    parts in order, the segments' buffers uncopied (``segments`` =
    [(DataType, buffer), ...], each buffer a contiguous CPU tensor, an
    array or bytes): a channel sends the list without joining it."""
    from horovod_tpu_torch.common.network import as_byte_view
    views = [as_byte_view(buf) for _, buf in segments]
    prefix, hdrs = spec_frame_parts(
        epoch, nslots, mask,
        [(dt, len(v)) for (dt, _), v in zip(segments, views)])
    parts = [prefix]
    for hdr, view in zip(hdrs, views):
        parts.append(hdr)
        parts.append(view)
    return parts


def _read_segments(r: _Reader):
    """The segments as memoryviews over the frame (no copy)."""
    view = memoryview(r.data)
    segs = []
    for _ in range(r.u32()):
        code = r.u8()
        dt = _DTYPE_OF.get(code)
        if dt is None:
            raise ConnectionError(
                f"unknown dtype {code} in a control frame's segment")
        n = r.i64()
        if n < 0:
            raise ConnectionError(
                f"corrupt segment length {n} in control frame")
        r._need(n)
        segs.append((dt, view[r.off:r.off + n]))
        r.off += n
    return segs


def serialize_cycle_request(obj, aggregate: bool = False) -> bytes:
    """A RequestList as a FULL frame, a CacheCycleRequest as a CACHED
    (CACHED_AGG with ``aggregate``) or, with a payload, CACHED_SPEC
    frame."""
    if isinstance(obj, RequestList):
        return bytes((FRAME_FULL,)) + serialize_request_list(obj)
    if not isinstance(obj, CacheCycleRequest):
        raise TypeError(f"not a cycle request: {type(obj).__name__}")
    if obj.spec_payload is not None:
        return b"".join(spec_frame_chunks(obj.epoch, obj.nslots,
                                          obj.hit_mask, obj.spec_payload))
    w = _Writer()
    w.u8(FRAME_CACHED_AGG if aggregate else FRAME_CACHED)
    w.u8(1 if obj.shutdown else 0)
    w.i64(obj.epoch)
    w.u32(obj.nslots)
    _write_mask(w, obj.hit_mask, obj.nslots)
    _write_mask(w, obj.invalid_mask, obj.nslots)
    w.u32(len(obj.requests))
    for req in obj.requests:
        _write_request(w, req)
    return w.bytes()


def parse_cycle_request(data: bytes):
    """-> RequestList (FULL) or CacheCycleRequest (the cached kinds)."""
    r = _Reader(data)
    kind = r.u8()
    if kind == FRAME_FULL:
        return parse_request_list(data, offset=1)
    if kind == FRAME_CACHED_SPEC:
        epoch = r.i64()
        nslots = r.u32()
        hit = _read_mask(r, nslots)
        return CacheCycleRequest(epoch=epoch, nslots=nslots, hit_mask=hit,
                                 spec_payload=_read_segments(r))
    if kind not in (FRAME_CACHED, FRAME_CACHED_AGG):
        raise ConnectionError(f"unknown cycle-request kind {kind}")
    shutdown = bool(r.u8())
    epoch = r.i64()
    nslots = r.u32()
    hit = _read_mask(r, nslots)
    invalid = _read_mask(r, nslots)
    n = r.u32()
    reqs = [_read_request(r) for _ in range(n)]
    return CacheCycleRequest(epoch=epoch, nslots=nslots, hit_mask=hit,
                             invalid_mask=invalid, requests=reqs,
                             shutdown=shutdown)


def serialize_cycle_response(obj) -> bytes:
    """A ResponseList as a FULL frame, a CacheCycleResponse as a CACHED
    or, with a payload, CACHED_SPEC frame."""
    if isinstance(obj, ResponseList):
        return bytes((FRAME_FULL,)) + serialize_response_list(obj)
    if not isinstance(obj, CacheCycleResponse):
        raise TypeError(f"not a cycle response: {type(obj).__name__}")
    if obj.spec_payload is not None:
        return b"".join(spec_frame_chunks(obj.epoch, obj.nslots,
                                          obj.grant_mask, obj.spec_payload))
    w = _Writer()
    w.u8(FRAME_CACHED)
    w.i64(obj.epoch)
    w.u32(obj.nslots)
    _write_mask(w, obj.grant_mask, obj.nslots)
    _write_mask(w, obj.invalid_mask, obj.nslots)
    return w.bytes() + serialize_response_list(obj.response_list)


def parse_cycle_response(data: bytes):
    """-> ResponseList (FULL) or CacheCycleResponse (CACHED,
    CACHED_SPEC)."""
    r = _Reader(data)
    kind = r.u8()
    if kind == FRAME_FULL:
        return parse_response_list(data, offset=1)
    if kind not in (FRAME_CACHED, FRAME_CACHED_SPEC):
        raise ConnectionError(f"unknown cycle-response kind {kind}")
    epoch = r.i64()
    nslots = r.u32()
    grant = _read_mask(r, nslots)
    if kind == FRAME_CACHED_SPEC:
        return CacheCycleResponse(epoch=epoch, nslots=nslots,
                                  grant_mask=grant,
                                  spec_payload=_read_segments(r))
    invalid = _read_mask(r, nslots)
    return CacheCycleResponse(epoch=epoch, nslots=nslots,
                              grant_mask=grant, invalid_mask=invalid,
                              response_list=parse_response_list(data,
                                                                r.off))


def combine_cycle_requests(frames) -> "bytes | None":
    """Fold several ranks' cycle-request frames into one CACHED_AGG
    frame: hit masks AND, invalid masks and the shutdown flag OR,
    uncached Requests concatenated (each carries its rank). None when a
    frame is not a CACHED or CACHED_AGG frame (a FULL frame, or a
    speculative one whose payloads only the coordinator may sum), when
    the epochs or slot counts disagree, or when the frames carry
    different world ids: the coordinator then sees them unfolded and
    names the fault."""
    world_id = None
    parsed = []
    for f in frames:
        if not f:
            return None
        wid, off = read_world(f)
        if world_id is None:
            world_id = wid
        elif wid != world_id:
            return None
        if len(f) <= off or f[off] not in (FRAME_CACHED, FRAME_CACHED_AGG):
            return None
        parsed.append(parse_cycle_request(f[off:] if off else f))
    first = parsed[0]
    combined = CacheCycleRequest(
        epoch=first.epoch, nslots=first.nslots, hit_mask=first.hit_mask,
        invalid_mask=first.invalid_mask, requests=list(first.requests),
        shutdown=first.shutdown)
    for cf in parsed[1:]:
        if cf.epoch != first.epoch or cf.nslots != first.nslots:
            return None
        combined.hit_mask &= cf.hit_mask
        combined.invalid_mask |= cf.invalid_mask
        combined.shutdown = combined.shutdown or cf.shutdown
        combined.requests.extend(cf.requests)
    return stamp_world(serialize_cycle_request(combined, aggregate=True),
                       world_id)


# World-id envelope: a frame of a sub-world rides as
# ``0xFD | u32 world_id | frame``; world 0 (the default world) rides
# unstamped.
TENANT_PREFIX = b"\xfd"


def stamp_world(frame: bytes, world_id: int) -> bytes:
    """Wrap a cycle frame in the world-id envelope (identity for the
    default world)."""
    if not world_id:
        return frame
    return TENANT_PREFIX + _U32.pack(world_id) + frame


def read_world(data: bytes) -> tuple:
    """-> (world_id, payload_offset): (0, 0) for an unstamped frame."""
    if data[:1] != TENANT_PREFIX:
        return 0, 0
    if len(data) < 5:
        raise ConnectionError(
            f"truncated world-id envelope: {len(data)} bytes")
    return _U32.unpack_from(data, 1)[0], 5


def unstamp_world(data: bytes, expect_id: int) -> bytes:
    """Strip (and verify) the world-id envelope. A mismatch is a
    cross-world frame — the caller's world must fail fast, never
    decode a foreign table's masks."""
    world_id, off = read_world(data)
    if world_id != expect_id:
        raise ConnectionError(
            f"control frame for world {world_id:#010x} arrived in "
            f"world {expect_id:#010x} — two worlds are sharing a "
            f"connection (check sub-world coordinator ports)")
    return data[off:] if off else data


# ---------------------------------------------------------------------------
# METRICS frames: a rank's registry snapshot, sent upward every
# HOROVOD_TPU_METRICS_INTERVAL seconds out of band (TAG_METRICS, absorbed
# wherever a control frame is awaited, like a PING); rank 0 folds the
# owners into the world view (common/metrics.py WorldAggregator).
#
#   MetricsFrame := u8 version | u32 nranks | u32 nmetrics | Metric[n]
#   Metric       := u8 kind | str name | payload
#     kind 'c' COUNTER   : f64 value
#     kind 'g' GAUGE     : u8 agg (0 sum | 1 max) | f64 value
#     kind 'h' HISTOGRAM : u16 nbounds | f64 bounds[nbounds]
#                        | u64 counts[nbounds+1] | f64 sum | u64 count
#
# Bounds travel with every histogram, so that the aggregator verifies
# bucket identity instead of assuming it.

_METRICS_VERSION = 1
_KIND_BYTE = {"c": 0, "g": 1, "h": 2}
_BYTE_KIND = {v: k for k, v in _KIND_BYTE.items()}
_AGG_BYTE = {"sum": 0, "max": 1}
_BYTE_AGG = {v: k for k, v in _AGG_BYTE.items()}
_U16 = struct.Struct("<H")
_U64 = struct.Struct("<Q")


def serialize_metrics_frame(nranks: int, snap: dict) -> bytes:
    """Encode a (possibly pre-summed) snapshot; ``nranks`` is how many
    ranks the frame stands for (rank 0 reports hvd_ranks_reporting)."""
    w = _Writer()
    w.u8(_METRICS_VERSION)
    w.u32(nranks)
    w.u32(len(snap))
    for name, rec in snap.items():
        w.u8(_KIND_BYTE[rec["k"]])
        w.string(name)
        if rec["k"] == "c":
            w.f64(rec["v"])
        elif rec["k"] == "g":
            w.u8(_AGG_BYTE[rec.get("agg", "sum")])
            w.f64(rec["v"])
        else:
            bounds = rec["bounds"]
            w.parts.append(_U16.pack(len(bounds)))
            if bounds:
                w.parts.append(struct.pack(f"<{len(bounds)}d", *bounds))
            counts = rec["counts"]
            w.parts.append(struct.pack(f"<{len(counts)}Q", *counts))
            w.f64(rec["sum"])
            w.parts.append(_U64.pack(rec["count"]))
    return w.bytes()


def _read_u16(r: _Reader) -> int:
    r._need(_U16.size)
    (v,) = _U16.unpack_from(r.data, r.off)
    r.off += _U16.size
    return v


def _read_u64(r: _Reader) -> int:
    r._need(_U64.size)
    (v,) = _U64.unpack_from(r.data, r.off)
    r.off += _U64.size
    return v


def parse_metrics_frame(data: bytes):
    """-> (nranks, snapshot dict). Raises on a malformed frame or an
    unknown version; the control plane drops such a frame (it is best
    effort, never a world error)."""
    r = _Reader(data)
    version = r.u8()
    if version != _METRICS_VERSION:
        raise ValueError(f"unknown metrics frame version {version}")
    nranks = r.u32()
    snap = {}
    for _ in range(r.u32()):
        kind = _BYTE_KIND[r.u8()]
        name = r.string()
        if kind == "c":
            snap[name] = {"k": "c", "v": r.f64()}
        elif kind == "g":
            agg = _BYTE_AGG[r.u8()]
            snap[name] = {"k": "g", "agg": agg, "v": r.f64()}
        else:
            nb = _read_u16(r)
            r._need(8 * nb)
            bounds = list(struct.unpack_from(f"<{nb}d", r.data, r.off))
            r.off += 8 * nb
            r._need(8 * (nb + 1))
            counts = list(struct.unpack_from(f"<{nb + 1}Q", r.data, r.off))
            r.off += 8 * (nb + 1)
            total = r.f64()
            snap[name] = {"k": "h", "bounds": bounds, "counts": counts,
                          "sum": total, "count": _read_u64(r)}
    return nranks, snap


def combine_metrics_frames(frames, drop_incompatible: bool = False) -> bytes:
    """Sum several METRICS frames into one: nranks add, the records merge
    with the world fold's semantics. ``drop_incompatible`` skips a
    garbled or identity-mismatched frame instead of raising; each frame
    folds into a scratch copy first, so that a bad one leaks nothing."""
    from horovod_tpu_torch.common.metrics import merge_into
    total_ranks = 0
    merged: dict = {}
    for f in frames:
        try:
            nranks, snap = parse_metrics_frame(f)
            trial = merge_into(merge_into({}, merged), snap)
        except Exception:
            if drop_incompatible:
                continue
            raise
        merged = trial
        total_ranks += nranks
    return serialize_metrics_frame(total_ranks, merged)


# ---------------------------------------------------------------------------
# TRACE frames: a rank's batch of completed spans (TAG_TRACE, out of band
# like METRICS); rank 0 merges every rank's track into one clock-aligned
# Chrome trace (common/trace.py WorldTraceWriter). Spans are one-shot
# deltas, so frames are concatenated, never folded.
#
#   TraceFrame := u8 version | u32 nsections | Section[nsections]
#   Section    := i32 rank | u32 dropped
#               | u8 has_echo [| u64 ping_seq | f64 t_ping_recv
#                              | f64 t_send]
#               | u32 nspans | Span[nspans]
#   Span       := u8 kind | u64 cycle | f64 ts | f64 dur | str name
#
# The echo is the worker's half of the clock exchange (trace.ClockSync):
# the coordinator PING it answers and this rank's monotonic clock at the
# PING's receipt and at the frame's build. ``cycle`` is the world-
# identical round number, so spans correlate across ranks before the
# clocks are aligned.

_TRACE_VERSION = 1

# Span kinds (u8 on the wire).
SPAN_SLICE = 0   # a complete span: Chrome "X" (ts + dur)
SPAN_MARK = 1    # an instant: Chrome "i" (dur ignored)

SPAN_NAMES = {SPAN_SLICE: "slice", SPAN_MARK: "mark"}

# Flight-recorder event codes (trace.FlightRecorder).
EV_CYCLE = 0      # one world negotiation round completed
EV_ABORT = 1      # world abort observed or raised on this rank
EV_ELASTIC = 2    # elastic lifecycle event (A9)
EV_STALL = 3      # stall-inspector shutdown
EV_FAULT = 4      # injected fault fired (common/faults.py)
EV_TEARDOWN = 5   # runtime teardown entered
EV_MARK = 6       # free-form marker (tests, user code)
EV_SELFOP = 7     # supervision-policy verdict (A9)

EV_NAMES = {EV_CYCLE: "cycle", EV_ABORT: "abort",
            EV_ELASTIC: "elastic", EV_STALL: "stall",
            EV_FAULT: "fault", EV_TEARDOWN: "teardown",
            EV_MARK: "mark", EV_SELFOP: "selfop"}


def serialize_trace_frame(sections) -> bytes:
    """``sections``: [{"rank", "dropped", "echo": None|(seq, t_recv,
    t_send), "spans": [(kind, cycle, ts, dur, name), ...]}, ...]."""
    w = _Writer()
    w.u8(_TRACE_VERSION)
    w.u32(len(sections))
    for sec in sections:
        w.i32(sec["rank"])
        w.u32(sec.get("dropped", 0))
        echo = sec.get("echo")
        if echo is None:
            w.u8(0)
        else:
            seq, t_recv, t_send = echo
            w.u8(1)
            w.parts.append(_U64.pack(seq))
            w.f64(t_recv)
            w.f64(t_send)
        spans = sec.get("spans", ())
        w.u32(len(spans))
        for kind, cycle, ts, dur, name in spans:
            w.u8(kind)
            w.parts.append(_U64.pack(cycle))
            w.f64(ts)
            w.f64(dur)
            w.string(name)
    return w.bytes()


def parse_trace_frame(data: bytes):
    """-> [section dict, ...] (layout above). Raises on a malformed frame
    or an unknown version; the control plane drops such a frame."""
    r = _Reader(data)
    version = r.u8()
    if version != _TRACE_VERSION:
        raise ValueError(f"unknown trace frame version {version}")
    sections = []
    for _ in range(r.u32()):
        rank = r.i32()
        dropped = r.u32()
        echo = None
        if r.u8():
            seq = _read_u64(r)
            echo = (seq, r.f64(), r.f64())
        spans = []
        for _s in range(r.u32()):
            kind = r.u8()
            cycle = _read_u64(r)
            spans.append((kind, cycle, r.f64(), r.f64(), r.string()))
        sections.append({"rank": rank, "dropped": dropped,
                         "echo": echo, "spans": spans})
    return sections


def combine_trace_frames(frames) -> bytes:
    """Concatenate several TRACE frames' sections into one, each section
    verbatim with its rank; a garbled frame is dropped."""
    sections = []
    for f in frames:
        try:
            sections.extend(parse_trace_frame(f))
        except Exception:
            continue
    return serialize_trace_frame(sections)
