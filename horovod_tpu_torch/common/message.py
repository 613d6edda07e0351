"""Coordinator message protocol: Request / RequestList / Response /
ResponseList.

Counterpart of ``horovod_tpu/common/message.py`` (:1-367): the same
enums with the same codes and the same fields, so that ``wire.py``
writes frames byte for byte as the reference does, the response
cache's cycle messages (``CacheCycleRequest``/``CacheCycleResponse``,
:243-330) included. ``Request.wire_dtype`` and ``Response.wire_dtype`` /
``algorithm`` stay on the wire but are always 0 here: wire compression
and the algorithm stamp are not ported yet (``ROADMAP.md`` A6.5).

Tensors are torch tensors: ``torch_dtype_to_datatype`` maps their dtypes
(bfloat16 included) beside the reference's numpy mapping.
"""

from __future__ import annotations

import enum
from typing import List, Sequence

import numpy as np
import torch


class DataType(enum.IntEnum):
    """Tensor element types (codes of the reference's :24-36)."""
    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    INT32 = 4
    INT64 = 5
    FLOAT16 = 6
    FLOAT32 = 7
    FLOAT64 = 8
    BOOL = 9
    BFLOAT16 = 10


_NP_TO_DT = {
    np.dtype(np.uint8): DataType.UINT8,
    np.dtype(np.int8): DataType.INT8,
    np.dtype(np.uint16): DataType.UINT16,
    np.dtype(np.int16): DataType.INT16,
    np.dtype(np.int32): DataType.INT32,
    np.dtype(np.int64): DataType.INT64,
    np.dtype(np.float16): DataType.FLOAT16,
    np.dtype(np.float32): DataType.FLOAT32,
    np.dtype(np.float64): DataType.FLOAT64,
    np.dtype(np.bool_): DataType.BOOL,
}

_TORCH_TO_DT = {
    torch.uint8: DataType.UINT8,
    torch.int8: DataType.INT8,
    torch.uint16: DataType.UINT16,
    torch.int16: DataType.INT16,
    torch.int32: DataType.INT32,
    torch.int64: DataType.INT64,
    torch.float16: DataType.FLOAT16,
    torch.float32: DataType.FLOAT32,
    torch.float64: DataType.FLOAT64,
    torch.bool: DataType.BOOL,
    torch.bfloat16: DataType.BFLOAT16,
}

_DT_SIZE = {
    DataType.UINT8: 1, DataType.INT8: 1,
    DataType.UINT16: 2, DataType.INT16: 2,
    DataType.INT32: 4, DataType.INT64: 8,
    DataType.FLOAT16: 2, DataType.FLOAT32: 4, DataType.FLOAT64: 8,
    DataType.BOOL: 1, DataType.BFLOAT16: 2,
}


def numpy_dtype_to_datatype(dtype) -> DataType:
    """The reference's mapping for numpy dtypes (a bfloat16 numpy
    extension dtype maps by name)."""
    dtype = np.dtype(dtype)
    if dtype in _NP_TO_DT:
        return _NP_TO_DT[dtype]
    if dtype.name == "bfloat16":
        return DataType.BFLOAT16
    raise ValueError(f"Unsupported dtype for horovod_tpu_torch: {dtype}")


def torch_dtype_to_datatype(dtype: torch.dtype) -> DataType:
    try:
        return _TORCH_TO_DT[dtype]
    except KeyError:
        raise ValueError(
            f"Unsupported dtype for horovod_tpu_torch: {dtype}") from None


_DT_TO_TORCH = {dt: t for t, dt in _TORCH_TO_DT.items()}


def datatype_to_torch_dtype(dt: DataType) -> torch.dtype:
    return _DT_TO_TORCH[DataType(dt)]


def datatype_size(dt: DataType) -> int:
    return _DT_SIZE[dt]


def datatype_name(dt: DataType) -> str:
    return DataType(dt).name.lower()


class RequestType(enum.IntEnum):
    ALLREDUCE = 0
    ALLGATHER = 1
    BROADCAST = 2
    ALLTOALL = 3
    REDUCESCATTER = 4
    BARRIER = 5
    JOIN = 6


class ResponseType(enum.IntEnum):
    ALLREDUCE = 0
    ALLGATHER = 1
    BROADCAST = 2
    ALLTOALL = 3
    REDUCESCATTER = 4
    BARRIER = 5
    JOIN = 6
    ERROR = 7


class Request:
    """A rank's announcement that one named tensor is ready."""

    __slots__ = ("request_rank", "request_type", "tensor_type",
                 "tensor_name", "root_rank", "device", "tensor_shape",
                 "prescale_factor", "postscale_factor", "wire_dtype")

    def __init__(self, request_rank: int = 0,
                 request_type: RequestType = RequestType.ALLREDUCE,
                 tensor_type: DataType = DataType.FLOAT32,
                 tensor_name: str = "",
                 root_rank: int = -1,
                 device: int = -1,
                 tensor_shape: Sequence[int] = (),
                 prescale_factor: float = 1.0,
                 postscale_factor: float = 1.0,
                 wire_dtype: int = 0):
        self.request_rank = request_rank
        self.request_type = RequestType(request_type)
        self.tensor_type = DataType(tensor_type)
        self.tensor_name = tensor_name
        self.root_rank = root_rank
        # CUDA device index of the tensor, -1 for a CPU tensor.
        self.device = device
        self.tensor_shape = tuple(int(d) for d in tensor_shape)
        self.prescale_factor = prescale_factor
        self.postscale_factor = postscale_factor
        self.wire_dtype = wire_dtype

    def __eq__(self, other):
        return (isinstance(other, Request) and
                all(getattr(self, s) == getattr(other, s)
                    for s in Request.__slots__))

    def __repr__(self):
        return (f"Request({self.request_type.name}, rank={self.request_rank},"
                f" name={self.tensor_name!r}, dtype={self.tensor_type.name},"
                f" shape={self.tensor_shape}, root={self.root_rank},"
                f" device={self.device})")


class RequestList:
    """One cycle's requests from a rank, plus the shutdown bit."""

    __slots__ = ("requests", "shutdown")

    def __init__(self, requests: List[Request] | None = None,
                 shutdown: bool = False):
        self.requests = requests if requests is not None else []
        self.shutdown = shutdown

    def __eq__(self, other):
        return (isinstance(other, RequestList)
                and self.shutdown == other.shutdown
                and self.requests == other.requests)


class Response:
    """The coordinator's verdict for one (possibly fused) set of
    tensors."""

    __slots__ = ("response_type", "tensor_names", "error_message",
                 "devices", "tensor_sizes", "prescale_factor",
                 "postscale_factor", "wire_dtype", "algorithm")

    def __init__(self, response_type: ResponseType = ResponseType.ALLREDUCE,
                 tensor_names: List[str] | None = None,
                 error_message: str = "",
                 devices: List[int] | None = None,
                 tensor_sizes: List[int] | None = None,
                 prescale_factor: float = 1.0,
                 postscale_factor: float = 1.0,
                 wire_dtype: int = 0,
                 algorithm: int = 0):
        self.response_type = ResponseType(response_type)
        self.tensor_names = tensor_names if tensor_names is not None else []
        self.error_message = error_message
        self.devices = devices if devices is not None else []
        self.tensor_sizes = tensor_sizes if tensor_sizes is not None else []
        self.prescale_factor = prescale_factor
        self.postscale_factor = postscale_factor
        self.wire_dtype = wire_dtype
        self.algorithm = algorithm

    def add_tensor_name(self, name: str) -> None:
        self.tensor_names.append(name)

    def add_tensor_size(self, size: int) -> None:
        self.tensor_sizes.append(size)

    def __eq__(self, other):
        return (isinstance(other, Response) and
                all(getattr(self, s) == getattr(other, s)
                    for s in Response.__slots__))

    def __repr__(self):
        return (f"Response({self.response_type.name},"
                f" names={self.tensor_names},"
                f" err={self.error_message!r})")


class CacheCycleRequest:
    """One rank's cycle frame on the response cache's path. ``hit_mask``
    has one bit per cache slot this rank queued this cycle with an
    unchanged signature; ``invalid_mask`` marks slots whose name came
    back with another signature and must be evicted world-wide;
    ``requests`` carries the uncached rest as plain Requests. ``epoch``
    is the sender's cache event count: the coordinator fails fast on any
    mismatch rather than let diverged caches grant mismatched
    collectives. ``spec_payload`` (the fused speculative cycle) is
    ``[(DataType, buffer), ...]``, one pre-packed fused allreduce buffer
    per replay-plan batch in plan order, or None on a plain bitmask
    frame."""

    __slots__ = ("epoch", "nslots", "hit_mask", "invalid_mask",
                 "requests", "shutdown", "spec_payload")

    def __init__(self, epoch: int = 0, nslots: int = 0,
                 hit_mask: int = 0, invalid_mask: int = 0,
                 requests: List[Request] | None = None,
                 shutdown: bool = False,
                 spec_payload=None):
        self.epoch = epoch
        self.nslots = nslots
        self.hit_mask = hit_mask
        self.invalid_mask = invalid_mask
        self.requests = requests if requests is not None else []
        self.shutdown = shutdown
        self.spec_payload = spec_payload

    def __eq__(self, other):
        return (isinstance(other, CacheCycleRequest) and
                all(getattr(self, s) == getattr(other, s)
                    for s in ("epoch", "nslots", "hit_mask",
                              "invalid_mask", "requests", "shutdown"))
                and _payloads_equal(self.spec_payload,
                                    other.spec_payload))


class CacheCycleResponse:
    """The coordinator's cycle verdict on the response cache's path:
    ``grant_mask`` is the AND of every rank's hit bits (less the
    invalidated slots), the tensors the whole world queued this cycle,
    replayed from the cache in ascending slot order; ``invalid_mask`` is
    the OR of every rank's invalidate bits, evicted on every rank this
    cycle; ``response_list`` carries whatever negotiated the full way
    (empty on a pure hit cycle). ``spec_payload``: the world-reduced
    fused buffers of a speculative cycle, in replay-plan order, or
    None."""

    __slots__ = ("epoch", "nslots", "grant_mask", "invalid_mask",
                 "response_list", "spec_payload")

    def __init__(self, epoch: int = 0, nslots: int = 0,
                 grant_mask: int = 0, invalid_mask: int = 0,
                 response_list: "ResponseList | None" = None,
                 spec_payload=None):
        self.epoch = epoch
        self.nslots = nslots
        self.grant_mask = grant_mask
        self.invalid_mask = invalid_mask
        self.response_list = response_list if response_list is not None \
            else ResponseList()
        self.spec_payload = spec_payload

    def __eq__(self, other):
        return (isinstance(other, CacheCycleResponse) and
                all(getattr(self, s) == getattr(other, s)
                    for s in ("epoch", "nslots", "grant_mask",
                              "invalid_mask", "response_list"))
                and _payloads_equal(self.spec_payload,
                                    other.spec_payload))


def _raw(buf) -> bytes:
    """The bytes of a payload buffer (a CPU tensor, an array or any
    bytes-like object)."""
    if isinstance(buf, torch.Tensor):
        return buf.reshape(-1).view(torch.uint8).numpy().tobytes()
    return bytes(buf)


def _payloads_equal(a, b) -> bool:
    if (a is None) != (b is None):
        return False
    if a is None:
        return True
    return (len(a) == len(b)
            and all(da == db and _raw(ba) == _raw(bb)
                    for (da, ba), (db, bb) in zip(a, b)))


class ResponseList:
    """One cycle's broadcast from the coordinator: ordered, fused
    responses and the shutdown bit. The autotuner's trailer fields stay
    on the wire at their untuned values (0, 0, -1)."""

    __slots__ = ("responses", "shutdown", "tuned_cycle_time_ms",
                 "tuned_fusion_threshold_bytes",
                 "tuned_overlap_buckets")

    def __init__(self, responses: List[Response] | None = None,
                 shutdown: bool = False,
                 tuned_cycle_time_ms: float = 0.0,
                 tuned_fusion_threshold_bytes: int = 0,
                 tuned_overlap_buckets: int = -1):
        self.responses = responses if responses is not None else []
        self.shutdown = shutdown
        self.tuned_cycle_time_ms = tuned_cycle_time_ms
        self.tuned_fusion_threshold_bytes = tuned_fusion_threshold_bytes
        self.tuned_overlap_buckets = tuned_overlap_buckets

    def __eq__(self, other):
        return (isinstance(other, ResponseList)
                and all(getattr(self, s) == getattr(other, s)
                        for s in ResponseList.__slots__))
