"""Wire-dtype gradient compression: the codec, on torch tensors.

Counterpart of ``horovod_tpu/common/wire_dtype.py``. The wire dtype is a
negotiated attribute of each request: every rank proposes its
``HOROVOD_COMPRESSION`` for its float32/float64 allreduces, allgathers
and reducescatters, the coordinator resolves the world's least
aggressive proposal per tensor and broadcasts it in the Response, and
the socket star casts into the wire dtype after the fusion pack and back
after the reduction, so that only wire bytes cross PCIe and the socket:
user tensors and outputs keep their dtype. ``int8`` carries one float32
scale per payload and keeps per-tensor error-feedback residuals (Deep
Gradient Compression, Lin et al. 2018): the quantization error of a step
rides into the next one's payload.

Every function gives the reference's bits on the same inputs: the casts
round to nearest even, and int8 takes its scale, its reciprocal and its
rounding step for step as the reference's numpy leg does (:251-266), on
whatever device the tensor lives (no scale goes through the host).

Code families (one byte each on the wire): ``WIRE_*``, the negotiated
wire dtype, ordered by aggressiveness (the world's verdict is the
minimum of the proposals, so one rank proposing ``none`` keeps the whole
batch uncompressed); ``ALG_*``, the algorithm the coordinator stamps on a
fused Response (``DEFAULT`` keeps each backend's own routing; the ring,
two-level and ICI planes that the other codes name are not ported,
``ROADMAP.md`` A6.4, A6.5).
"""

from __future__ import annotations

import warnings
from collections import OrderedDict
from typing import List

import torch

from horovod_tpu_torch.common.message import DataType

# -- wire dtype codes (u8 on the wire; min-resolved across ranks) ------
WIRE_NONE = 0
WIRE_BF16 = 1
WIRE_FP16 = 2
WIRE_INT8 = 3

# -- algorithm codes (u8 on the wire; stamped by the coordinator) ------
ALG_DEFAULT = 0
ALG_STAR = 1
ALG_RING = 2
ALG_TWOLEVEL = 3
ALG_ICI = 4

WIRE_NAMES = {WIRE_NONE: "none", WIRE_BF16: "bf16",
              WIRE_FP16: "fp16", WIRE_INT8: "int8"}
_NAME_WIRES = {v: k for k, v in WIRE_NAMES.items()}
ALG_NAMES = {ALG_DEFAULT: "default", ALG_STAR: "star",
             ALG_RING: "ring", ALG_TWOLEVEL: "twolevel",
             ALG_ICI: "ici"}

# Request dtypes a wire cast can shrink: 16-bit floats are half width
# already, and integers have no reduced-precision sum.
COMPRESSIBLE = frozenset((DataType.FLOAT32, DataType.FLOAT64))

# The one float-dtype table that the framework-level compression
# (common/compression.py) and this codec both consult.
FLOATING_DTYPES = frozenset((
    torch.float16, torch.float32, torch.float64, torch.bfloat16,
    torch.float8_e4m3fn, torch.float8_e5m2,
))

# int8 wire layout: one float32 scale, then one int8 lane per element.
_INT8_HDR = 4

_WIRE_TORCH = {WIRE_BF16: torch.bfloat16, WIRE_FP16: torch.float16}
_WIRE_DATATYPE = {WIRE_BF16: DataType.BFLOAT16, WIRE_FP16: DataType.FLOAT16}


def is_floating(dtype: torch.dtype) -> bool:
    return dtype in FLOATING_DTYPES


def wire_code_of(name: str) -> int:
    """Knob string -> WIRE_* code; raises on a typo (a default picked
    silently would diverge the ranks' proposals unseen)."""
    code = _NAME_WIRES.get(name.strip().lower())
    if code is None:
        raise ValueError(
            f"HOROVOD_COMPRESSION={name!r}: must be one of "
            f"{sorted(_NAME_WIRES)}")
    return code


def ring_wire(wire: int) -> int:
    """The wire a ring leg carries: per-rank int8 scales cannot be summed
    link by link, so int8 degrades to bf16."""
    return WIRE_BF16 if wire == WIRE_INT8 else wire


def allgather_wire(wire: int) -> int:
    """The wire an allgather verdict carries: the gathered blocks join
    into one payload, which cannot hold per-rank int8 scales, so int8
    degrades to bf16 (the coordinator stamps it, world-identically)."""
    return WIRE_BF16 if wire == WIRE_INT8 else wire


def resolve(codes) -> int:
    """The world's common denominator of one tensor's proposals: the
    least aggressive wins."""
    out = None
    for c in codes:
        out = c if out is None else min(out, c)
    return WIRE_NONE if out is None else out


def wire_torch_dtype(wire: int) -> torch.dtype:
    """Lane dtype of a cast wire (int8 payloads are raw bytes)."""
    try:
        return _WIRE_TORCH[wire]
    except KeyError:
        raise ValueError(f"wire dtype {wire} has no lane dtype") from None


def wire_datatype(wire: int) -> DataType:
    """DataType a compressed speculative-frame segment declares (cast
    wires only: int8 never rides the speculative cycle)."""
    try:
        return _WIRE_DATATYPE[wire]
    except KeyError:
        raise ValueError(f"wire dtype {wire} has no DataType") from None


def compressed_nbytes(wire: int, count: int, src_itemsize: int) -> int:
    """Payload bytes of ``count`` elements at ``wire``."""
    if wire == WIRE_NONE:
        return count * src_itemsize
    if wire in (WIRE_BF16, WIRE_FP16):
        return count * 2
    if wire == WIRE_INT8:
        return _INT8_HDR + count
    raise ValueError(f"unknown wire dtype {wire}")


def _as_tensor(buf, dtype: torch.dtype, count: int) -> torch.Tensor:
    """``count`` elements of ``dtype`` at the start of ``buf``: a tensor
    (viewed as ``dtype`` when it holds bytes) or any bytes-like object
    (a read-only view, which the callers only read)."""
    if isinstance(buf, torch.Tensor):
        flat = buf.reshape(-1)
        if flat.dtype != dtype:
            flat = flat.view(torch.uint8).view(dtype)
        return flat[:count]
    if not count:
        return torch.empty(0, dtype=dtype)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.frombuffer(buf, dtype=dtype, count=count)


def _f64_to_f16(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float16 rounded once to nearest even, as numpy casts.
    torch goes through float32 and rounds twice; rounding to float32 by
    round-to-odd first (truncate, then set the last bit when inexact)
    keeps the one rounding's result, float32 having 13 bits to spare."""
    f = x.to(torch.float32)
    back = f.to(torch.float64)
    inexact = back != x
    bits = f.view(torch.int32)
    bits = torch.where(inexact & (back.abs() > x.abs()), bits - 1, bits)
    bits = torch.where(inexact, bits | 1, bits)
    return bits.view(torch.float32).to(torch.float16)


def compress(t: torch.Tensor, wire: int) -> torch.Tensor:
    """Flat tensor -> its wire representation, on its device: itself at
    ``none``, the [scale | lanes] bytes at int8, a fresh cast else."""
    if wire == WIRE_NONE:
        return t
    if wire == WIRE_INT8:
        return quantize(t)
    flat = t.reshape(-1)
    if wire == WIRE_FP16 and flat.dtype == torch.float64:
        return _f64_to_f16(flat)
    return flat.to(wire_torch_dtype(wire))


def decompress(buf, wire: int, dtype: torch.dtype,
               count: int) -> torch.Tensor:
    """Wire payload -> a fresh flat tensor of ``dtype`` on the payload's
    device (fresh: results back user-visible outputs, which must never
    alias wire memory)."""
    if wire == WIRE_NONE:
        return _as_tensor(buf, dtype, count).clone()
    if wire == WIRE_INT8:
        return dequantize(buf, dtype, count)
    return _as_tensor(buf, wire_torch_dtype(wire), count).to(dtype)


# -- int8 with error feedback ------------------------------------------

def quantize(t: torch.Tensor) -> torch.Tensor:
    """float32/float64 -> [float32 scale | int8 lanes] as one uint8
    tensor on ``t``'s device. The scale is max|x| / 127 in float64,
    stored as float32 (1.0 for an all-zero tensor, so that it comes back
    exact); the lanes are x times the float64 reciprocal of the scale
    cast to x's dtype, rounded half to even and clipped to +-127 before
    the narrowing: the reference's numpy leg step for step."""
    flat = t.reshape(-1)
    n = flat.numel()
    buf = torch.empty(_INT8_HDR + n, dtype=torch.uint8, device=flat.device)
    if n:
        scale = flat.abs().max().to(torch.float64) / 127.0
        scale = torch.where(scale == 0.0, 1.0, scale)
    else:
        scale = torch.ones((), dtype=torch.float64, device=flat.device)
    buf[:_INT8_HDR].view(torch.float32).copy_(
        scale.to(torch.float32).reshape(1))
    inv = (1.0 / scale).to(flat.dtype)
    lanes = torch.round(flat * inv).clamp_(-127, 127)
    buf[_INT8_HDR:].view(torch.int8).copy_(lanes)
    return buf


def dequantize(buf, dtype: torch.dtype, count: int) -> torch.Tensor:
    """[scale | int8] payload -> a fresh flat tensor of ``dtype`` on the
    payload's device: each lane times the scale, in ``dtype``."""
    raw = _as_tensor(buf, torch.uint8, _INT8_HDR + count)
    # A copy of the 4 scale bytes: aligned whatever the frame offset.
    scale = raw[:_INT8_HDR].clone().view(torch.float32).to(dtype)
    return raw[_INT8_HDR:].view(torch.int8).to(dtype) * scale


def quantize_ef(t: torch.Tensor, ef: "ErrorFeedback",
                key: tuple) -> torch.Tensor:
    """int8 quantize with error feedback: compensate (t + residual),
    quantize, keep what the wire lost as the next residual."""
    comp = ef.apply(key, t)
    buf = quantize(comp)
    ef.update(key, comp, buf)
    return buf


class ErrorFeedback:
    """Per-batch int8 residuals, on the device of the tensors they
    compensate. Rank-local by design: each rank compensates its own
    quantization error. Keyed by the fused batch's name tuple (training
    loops repeat their batches; a new membership starts a fresh
    residual) and capped LRU-wise: past ``_CAP`` keys the oldest residual
    goes, never the whole store."""

    _CAP = 64

    def __init__(self):
        self._residuals: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()

    def apply(self, key: tuple, t: torch.Tensor) -> torch.Tensor:
        """t + residual(key), fresh (t may alias a caller's tensor)."""
        flat = t.reshape(-1)
        r = self._residuals.get(key)
        if r is None or r.numel() != flat.numel() \
                or r.device != flat.device:
            return flat.clone()
        return flat + r.to(flat.dtype)

    def update(self, key: tuple, compensated: torch.Tensor,
               qbuf: torch.Tensor) -> None:
        """residual = compensated - dequantize(sent)."""
        if key not in self._residuals \
                and len(self._residuals) >= self._CAP:
            self._residuals.popitem(last=False)
        sent = dequantize(qbuf, compensated.dtype, compensated.numel())
        self._residuals[key] = compensated - sent
        self._residuals.move_to_end(key)

    def residual(self, key: tuple):
        """The stored residual of ``key`` (None when there is none)."""
        return self._residuals.get(key)

    def drop(self, key: tuple) -> None:
        self._residuals.pop(key, None)


def reduce_wire(own, peers: List, wire: int, dtype: torch.dtype,
                count: int):
    """The coordinator's sum of compressed contributions in rank order,
    its own first. Cast wires sum in the wire dtype (``own``, a fresh
    tensor, is the accumulator); int8 payloads carry per-rank scales, so
    each is dequantized into a ``dtype`` accumulator and the world sum is
    quantized with a fresh scale. Returns the wire payload to
    broadcast."""
    if wire in (WIRE_BF16, WIRE_FP16):
        wdt = wire_torch_dtype(wire)
        acc = own
        for p in peers:
            acc += _as_tensor(p, wdt, count)
        return acc
    if wire != WIRE_INT8:
        raise ValueError(f"reduce_wire of wire dtype {wire}")
    accf = dequantize(own, dtype, count)
    for p in peers:
        accf += dequantize(p, dtype, count)
    return quantize(accf)


class StaticWirePolicy:
    """The (algorithm, wire-dtype cap) the coordinator stamps on fused
    allreduce batches without the autotuner: each backend's own routing
    (``ALG_DEFAULT``), and no cap on the negotiated wire dtype (the
    proposals carry the operator's choice). The reference's two-level
    and ICI stamps wait for their planes (``ROADMAP.md`` A6.4, A6.5)."""

    def plan(self, nbytes: int):
        """-> (ALG_* code, wire cap or None)."""
        return ALG_DEFAULT, None


# -- the process-wide "wire compression is active" latch ----------------
# Set by basics.init from Config.compression and read by the
# framework-level Compression helpers, so that a job that compresses on
# the wire does not also cast in the framework (that would quantize twice
# and decompress once).

_ACTIVE = WIRE_NONE


def set_active(code: int) -> None:
    global _ACTIVE
    _ACTIVE = code


def active() -> int:
    return _ACTIVE
