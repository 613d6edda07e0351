"""Priority dispatch across collective backends.

Counterpart of ``horovod_tpu/ops/operation_manager.py`` (:1-160): the
first backend whose ``enabled`` says yes runs the batch. Here the order
is the socket star (size > 1), then the local plane (size 1).
"""

from __future__ import annotations

from typing import List

from horovod_tpu_torch.common.message import Response, ResponseType
from horovod_tpu_torch.common.status import Status
from horovod_tpu_torch.common.tensor_table import TensorTableEntry
from horovod_tpu_torch.ops.backend import CollectiveBackend

_EXECUTE = {
    ResponseType.ALLREDUCE: "execute_allreduce",
    ResponseType.ALLGATHER: "execute_allgather",
    ResponseType.BROADCAST: "execute_broadcast",
    ResponseType.ALLTOALL: "execute_alltoall",
    ResponseType.REDUCESCATTER: "execute_reducescatter",
    ResponseType.BARRIER: "execute_barrier",
}


class OperationManager:
    def __init__(self, backends: List[CollectiveBackend]):
        self.backends = backends

    def attach_timeline(self, timeline) -> None:
        for b in self.backends:
            b.timeline = timeline

    def execute(self, entries: List[TensorTableEntry],
                response: Response) -> Status:
        for b in self.backends:
            if b.enabled(entries, response):
                return getattr(b, _EXECUTE[response.response_type])(
                    entries, response)
        raise RuntimeError(
            f"No collective backend enabled for response "
            f"{response.response_type.name} ({response.tensor_names})")
