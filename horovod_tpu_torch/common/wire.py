"""Binary wire format of the control plane.

Counterpart of ``horovod_tpu/common/wire.py``: the request-list and
response-list frames (:69-350), the FULL cycle frames that carry them
(kind byte 0, :462-560) and the world-id envelope (``stamp_world``,
``unstamp_world``). For equal lists the frames are byte-identical to the
reference's, and each side parses the other's. The cache-cycle kinds
and the metrics, trace, elastic and tenant frames wait for their slices
(``ROADMAP.md`` A6); a frame of another kind is refused.

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
  CycleRequest := u8 0 | RequestList;  CycleResponse := u8 0 | ResponseList
"""

from __future__ import annotations

import struct

from horovod_tpu_torch.common.message import (
    DataType, Request, RequestList, RequestType, Response, ResponseList,
    ResponseType,
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


def serialize_cycle_request(rl: RequestList) -> bytes:
    return bytes((FRAME_FULL,)) + serialize_request_list(rl)


def parse_cycle_request(data: bytes) -> RequestList:
    _check_full(data, "request")
    return parse_request_list(data, offset=1)


def serialize_cycle_response(rl: ResponseList) -> bytes:
    return bytes((FRAME_FULL,)) + serialize_response_list(rl)


def parse_cycle_response(data: bytes) -> ResponseList:
    _check_full(data, "response")
    return parse_response_list(data, offset=1)


def _check_full(data: bytes, what: str) -> None:
    kind = data[0] if data else None
    if kind != FRAME_FULL:
        raise ConnectionError(
            f"cycle-{what} frame of kind {kind}: only FULL frames (kind "
            f"{FRAME_FULL}) are supported; the response cache's frames "
            f"are not ported (ROADMAP.md A6.1), so every rank must run "
            f"with HOROVOD_CACHE_CAPACITY=0")


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
