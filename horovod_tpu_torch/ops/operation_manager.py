"""Priority dispatch across collective backends.

Counterpart of ``horovod_tpu/ops/operation_manager.py`` (:1-160): the
first backend whose ``enabled`` says yes runs the batch. Here the order
is the process-group plane (CUDA tensors, size > 1, once the world
agreed to it), the socket star (size > 1), then the local plane
(size 1). With the metrics plane on, each batch counts its op, its
payload bytes per kind of collective and per plane, its issue-side wall
time and its fusion-buffer fill against the world's threshold, under
the reference's names (:28-66, :120-145).
"""

from __future__ import annotations

import time
from typing import List, Tuple

from horovod_tpu_torch.common.message import Response, ResponseType
from horovod_tpu_torch.common.metrics import NOOP_METRIC, RATIO_BUCKETS
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


_BYTES_NAMES = {
    ResponseType.ALLREDUCE: "hvd_bytes_allreduced_total",
    ResponseType.ALLGATHER: "hvd_bytes_allgathered_total",
    ResponseType.BROADCAST: "hvd_bytes_broadcast_total",
    ResponseType.ALLTOALL: "hvd_bytes_alltoall_total",
    ResponseType.REDUCESCATTER: "hvd_bytes_reducescattered_total",
}


class OperationManager:
    def __init__(self, backends: List[CollectiveBackend]):
        self.backends = backends
        self._metrics_on = False
        self._fusion_threshold_fn = None
        self._m_ops: dict = {}
        self._m_bytes: dict = {}
        self._m_wall: dict = {}
        self._m_fill = NOOP_METRIC

    def attach_metrics(self, registry, fusion_threshold_fn=None) -> None:
        """Op counts, payload bytes per kind of collective, issue-side
        wall-time histograms and the fusion-buffer fill ratio, from the
        runtime's registry (the disabled one hands back no-ops); each
        backend adds its per-plane counters."""
        self._metrics_on = bool(registry.enabled)
        self._fusion_threshold_fn = fusion_threshold_fn
        for rt, bname in _BYTES_NAMES.items():
            op = rt.name.lower()
            self._m_ops[rt] = registry.counter(f'hvd_ops_total{{op="{op}"}}')
            self._m_bytes[rt] = registry.counter(bname)
            self._m_wall[rt] = registry.histogram(
                f'hvd_collective_seconds{{op="{op}"}}',
                "collective execution wall time (issue time for "
                "async backends)")
        self._m_ops[ResponseType.BARRIER] = registry.counter(
            'hvd_ops_total{op="barrier"}')
        self._m_fill = registry.histogram(
            "hvd_fusion_fill_ratio",
            "fused batch bytes / fusion threshold", RATIO_BUCKETS)
        for b in self.backends:
            b.attach_metrics(registry)

    def attach_timeline(self, timeline) -> None:
        for b in self.backends:
            b.timeline = timeline

    def attach_finalizer(self, finalizer) -> None:
        for b in self.backends:
            b.finalizer = finalizer

    def pick(self, entries: List[TensorTableEntry],
             response: Response) -> CollectiveBackend:
        """The first enabled backend: the one that runs the batch. The
        runtime's speculative cycle asks it whether the batch may ride
        the negotiation round instead (``fused_cycle_reducible``)."""
        for b in self.backends:
            if b.enabled(entries, response):
                return b
        raise RuntimeError(
            f"No collective backend enabled for response "
            f"{response.response_type.name} ({response.tensor_names})")

    def execute(self, entries: List[TensorTableEntry],
                response: Response) -> Tuple[str, Status]:
        """Runs the batch on the first enabled backend; returns that
        backend's name and the status."""
        b = self.pick(entries, response)
        rt = response.response_type
        run = getattr(b, _EXECUTE[rt])
        if not self._metrics_on:
            return b.name, run(entries, response)
        nbytes = sum(getattr(e.tensor, "nbytes", 0) for e in entries)
        op_counter = self._m_ops.get(rt)
        if op_counter is not None:
            op_counter.inc()
        byte_counter = self._m_bytes.get(rt)
        if byte_counter is not None:
            byte_counter.inc(nbytes)
        b.m_ops.inc()
        b.m_bytes.inc(nbytes)
        if len(entries) > 1 and self._fusion_threshold_fn is not None:
            threshold = self._fusion_threshold_fn()
            if threshold > 0:
                self._m_fill.observe(nbytes / threshold)
        t0 = time.perf_counter()
        try:
            return b.name, run(entries, response)
        finally:
            wall = self._m_wall.get(rt)
            if wall is not None:
                wall.observe(time.perf_counter() - t0)
