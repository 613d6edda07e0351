"""Operation status type and the errors the runtime raises.

A copy of ``horovod_tpu/common/status.py`` (:1-113): OK /
UNKNOWN_ERROR / PRECONDITION_ERROR / ABORTED / INVALID_ARGUMENT /
IN_PROGRESS, carried through enqueue callbacks and the handle manager.
"""

from __future__ import annotations

import enum
from typing import Optional


class StatusType(enum.IntEnum):
    OK = 0
    UNKNOWN_ERROR = 1
    PRECONDITION_ERROR = 2
    ABORTED = 3
    INVALID_ARGUMENT = 4
    IN_PROGRESS = 5


class Status:
    __slots__ = ("type", "reason", "aborted_by")

    def __init__(self, type_: StatusType = StatusType.OK, reason: str = "",
                 aborted_by: "Optional[int]" = None):
        self.type = type_
        self.reason = reason
        # Global rank the world abort originated from (None for plain
        # shutdowns) — lets handle APIs raise WorldAbortedError with
        # the failed rank attached instead of a generic internal error.
        self.aborted_by = aborted_by

    @staticmethod
    def OK() -> "Status":
        return Status(StatusType.OK)

    @staticmethod
    def UnknownError(msg: str) -> "Status":
        return Status(StatusType.UNKNOWN_ERROR, msg)

    @staticmethod
    def PreconditionError(msg: str) -> "Status":
        return Status(StatusType.PRECONDITION_ERROR, msg)

    @staticmethod
    def Aborted(msg: str) -> "Status":
        return Status(StatusType.ABORTED, msg)

    @staticmethod
    def WorldAborted(origin_rank: int, cause: str) -> "Status":
        return Status(StatusType.ABORTED,
                      world_abort_message(origin_rank, cause),
                      aborted_by=origin_rank)

    @staticmethod
    def InvalidArgument(msg: str) -> "Status":
        return Status(StatusType.INVALID_ARGUMENT, msg)

    @staticmethod
    def InProgress() -> "Status":
        return Status(StatusType.IN_PROGRESS)

    def ok(self) -> bool:
        return self.type == StatusType.OK

    def in_progress(self) -> bool:
        return self.type == StatusType.IN_PROGRESS

    def __repr__(self) -> str:
        return f"Status({self.type.name}, {self.reason!r})"


class HorovodInternalError(RuntimeError):
    """Raised to user code when a collective fails (coordinator ERROR
    response or shutdown; reference: message.h Response::ERROR and
    operations.cc:898-913 SHUT_DOWN_ERROR fan-out)."""


def world_abort_message(origin_rank: int, cause: str) -> str:
    origin = (f"rank {origin_rank}" if origin_rank is not None
              and origin_rank >= 0 else "unknown rank")
    return f"Horovod world aborted (origin: {origin}): {cause}"


class WorldAbortedError(HorovodInternalError):
    """The world was torn down by the fail-fast abort protocol: some
    rank died, a transport failed, or the stall-shutdown threshold
    fired, and the coordinator fanned an ABORT to every survivor.
    Subclasses HorovodInternalError so existing error handling keeps
    working; carries the originating rank and bare cause so survivors
    can log or react to *which* peer failed — and so relaying the
    abort re-wraps the cause exactly once, not per hop."""

    def __init__(self, message: str, origin_rank: int = -1,
                 cause: "Optional[str]" = None):
        super().__init__(message)
        self.origin_rank = origin_rank
        self.cause = cause if cause is not None else message


SHUT_DOWN_ERROR = (
    "Horovod has been shut down. This was caused by an exception on one of "
    "the ranks or an attempt to run a collective after shutdown was called."
)

DUPLICATE_NAME_ERROR_FMT = (
    "Requested to %s a tensor with the same name as another tensor that is "
    "currently being processed. If you want to request another tensor, use "
    "a different tensor name. Tensor name: %s"
)
