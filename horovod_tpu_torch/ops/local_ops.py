"""Size-1 world backend: collectives reduce to local transforms.

Counterpart of ``horovod_tpu/ops/local_ops.py`` (:1-59). Every op keeps
the scaling contract: an allreduce or reducescatter output is the input
times prescale x postscale, so that a size-1 run is the size-N run
divided down. A factor of 1 returns the input tensor itself, as the
reference returns its array.
"""

from __future__ import annotations

from horovod_tpu_torch.common.status import Status
from horovod_tpu_torch.ops.backend import CollectiveBackend, scale


class LocalBackend(CollectiveBackend):
    name = "local"

    def __init__(self, size_fn):
        super().__init__()
        self._size_fn = size_fn

    def enabled(self, entries, response) -> bool:
        return self._size_fn() == 1

    def _scaled(self, entries, factor: float) -> Status:
        with self.plane_stream(entries):
            for e in entries:
                e.output = scale(e.tensor, factor)
        return Status.OK()

    def execute_allreduce(self, entries, response) -> Status:
        return self._scaled(entries, response.prescale_factor
                            * response.postscale_factor)

    execute_reducescatter = execute_allreduce

    def execute_allgather(self, entries, response) -> Status:
        return self._scaled(entries, 1.0)

    execute_broadcast = execute_allgather
    execute_alltoall = execute_allgather
