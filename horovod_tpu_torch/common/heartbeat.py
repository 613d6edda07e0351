"""Heartbeat and abort frames of the fail-fast control plane.

A copy of ``horovod_tpu/common/heartbeat.py`` (:1-61), so that the bytes
on the wire are the reference's.

``PING`` is sent down the star (coordinator -> workers) while the
sender is alive but has nothing else to say: its gather waits on a
straggler. A receiver takes any frame, a PING or a real one, as proof of
life and restarts its recv deadline, so a healthy world that waits never
aborts while a silent peer is found within ``HOROVOD_HEARTBEAT_TIMEOUT``.

``ABORT`` is fanned down the star (and sent up by workers) when a rank
sees a transport failure, a data-plane exception or the stall-shutdown
threshold. It carries the global rank the failure came from and a cause,
which every survivor raises as a
:class:`~horovod_tpu_torch.common.status.WorldAbortedError`.

Both payloads are fixed little-endian structs (and a UTF-8 cause).
"""

from __future__ import annotations

import struct
from typing import Tuple

_PING = struct.Struct("<iQ")        # sender rank | monotone sequence
_ABORT_HEAD = struct.Struct("<iI")  # origin rank | cause byte length


def encode_ping(rank: int, seq: int) -> bytes:
    return _PING.pack(rank, seq)


def decode_ping(payload: bytes) -> Tuple[int, int]:
    """-> (sender_rank, sequence). Raises ValueError on a bad frame."""
    if len(payload) != _PING.size:
        raise ValueError(
            f"ping frame must be {_PING.size} bytes, got {len(payload)}")
    return _PING.unpack(payload)


def encode_abort(origin_rank: int, cause: str) -> bytes:
    body = cause.encode("utf-8")
    return _ABORT_HEAD.pack(origin_rank, len(body)) + body


def decode_abort(payload: bytes) -> Tuple[int, str]:
    """-> (origin_rank, cause). A truncated cause is kept (a dying sender
    may not flush the whole frame); a short header raises ValueError."""
    if len(payload) < _ABORT_HEAD.size:
        raise ValueError(
            f"abort frame too short: {len(payload)} bytes")
    origin, n = _ABORT_HEAD.unpack_from(payload, 0)
    body = payload[_ABORT_HEAD.size:_ABORT_HEAD.size + n]
    return origin, bytes(body).decode("utf-8", errors="replace")
