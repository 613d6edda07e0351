"""TCP socket collective backend: the star through rank 0.

Counterpart of the star path of ``horovod_tpu/ops/socket_ops.py``:
``SocketBackend.execute_allreduce`` (:348-420) and its allgather (with a
variable dim 0), broadcast, alltoall and reducescatter legs. Every rank
sends its payload to the coordinator over the controller's channels; the
coordinator combines and broadcasts (or scatters) the result.

Where the tensors live on a CUDA device, the fusion buffer is packed on
the device (each entry flattened into it, the prescale fused into that
copy), on the data plane's stream after each entry's ready event, and
copied to pinned host memory once. The result comes back in one copy and
is postscaled on the device; the outputs are views of that buffer. CPU
tensors take the same path without the copies. The response cache's
speculative cycle (``common/runtime.py``) carries a fused allreduce on
the negotiation round instead: ``pack_to_host`` and ``unpack_from_host``
are the two halves of ``execute_allreduce`` it runs, so that both paths
give the same bits.

The coordinator accumulates in the tensor's dtype, in rank order
(``acc += peer`` for ranks 1..N-1), as the reference does at :396-418,
so that the result equals the reference's bit for bit, bfloat16
included (torch's CPU add and ml_dtypes' both round each sum to
nearest-even).

Wire compression (the compressed legs of :75-94, :375-610, :790-864).
When a response carries a wire-dtype verdict, the cast (or the int8
quantization, with this rank's error-feedback residuals on the tensors'
device) is the last step of the pack: on the card it runs on the data
plane's stream after the ready events, after the prescale, so that only
wire bytes cross PCIe and the socket. The coordinator reduces in the
wire dtype on the host (``wire_dtype.reduce_wire``: a cast wire sums in
its own dtype in rank order; int8 payloads are dequantized with each
rank's scale, summed and quantized again), and every rank decompresses
the result on the card before the postscale. Allreduce, allgather (never
int8: one joined payload cannot carry per-rank scales) and
reducescatter (int8 without error feedback: its output is a reduced
slice, not this rank's next gradient) compress; broadcast and alltoall
carry no verdict, as in the reference.

A wait on the card for the pack's copy is cut into slices, at whose
ends the controller beacons to the peers waiting on this rank
(``Controller.keepalive``), so that a long wait never reads as a dead
rank. The ring (``ops/ring.py``), shm and the fusion arena are not
ported yet (``ROADMAP.md`` A6.4, A6.6).
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import List

import torch

from horovod_tpu_torch.common import wire_dtype as _wd
from horovod_tpu_torch.common.controller import Controller
from horovod_tpu_torch.common.message import Response
from horovod_tpu_torch.common.metrics import NOOP_METRIC, RATIO_BUCKETS
from horovod_tpu_torch.common.status import Status
from horovod_tpu_torch.common.timeline import (
    ACT_MEMCPY_IN_FUSION_BUFFER, ACT_MEMCPY_OUT_FUSION_BUFFER,
)
from horovod_tpu_torch.ops.backend import (
    CollectiveBackend, pack, scale, scale_, unpack,
)


def _accumulate(acc: torch.Tensor, peer: torch.Tensor) -> None:
    """``acc += peer`` in ``acc``'s dtype. torch has no add for uint16:
    it adds in int32 and wraps back, as numpy's uint16 add wraps."""
    if acc.dtype == torch.uint16:
        acc.copy_((acc.to(torch.int32) + peer.to(torch.int32))
                  .to(torch.uint16))
    else:
        acc += peer


def _allgather_layout(tensors, response: Response, size: int):
    """Displacements of a (possibly fused) allgather. The response's
    ``tensor_sizes`` is entry-major: sizes[ec * size + rc] is entry
    ec's dim-0 rows from rank rc. Returns (comp, rank_counts):
    comp[ec][rc] = elements of entry ec from rank rc; rank_counts[rc] =
    elements in rank rc's packed block."""
    sizes = response.tensor_sizes
    comp = []
    for ec, t in enumerate(tensors):
        row = math.prod(t.shape[1:])
        comp.append([sizes[ec * size + rc] * row for rc in range(size)])
    rank_counts = [sum(c[rc] for c in comp) for rc in range(size)]
    return comp, rank_counts


class SocketBackend(CollectiveBackend):
    name = "socket"

    def __init__(self, controller: Controller):
        super().__init__()
        self._ctl = controller
        # Bytes copied between the card and the host (CUDA tensors).
        self.bytes_to_host = 0
        self.bytes_from_host = 0
        # This rank's int8 residuals, keyed by the fused batch's names.
        self._ef = _wd.ErrorFeedback()
        self._m_wire_saved = NOOP_METRIC
        self._m_comp_ratio = NOOP_METRIC

    def attach_metrics(self, registry) -> None:
        """The plane's counters, and the wire dtype's: bytes kept off the
        wire and the ratio of each compressed payload (the reference's
        names, counted where its compress leg counts them)."""
        super().attach_metrics(registry)
        self._m_wire_saved = registry.counter(
            "hvd_wire_bytes_saved_total",
            "payload bytes kept OFF the wire by the negotiated "
            "wire dtype (uncompressed minus wire size, per send)")
        self._m_comp_ratio = registry.histogram(
            "hvd_compression_ratio",
            "wire bytes / uncompressed bytes per compressed payload",
            RATIO_BUCKETS)

    def enabled(self, entries, response) -> bool:
        return self._ctl.size > 1

    def fused_cycle_reducible(self, nbytes: int) -> bool:
        """Every batch above size 1 goes through the coordinator's
        channels here (the ring, which takes the large ones in the
        reference, :300, is not ported), so the speculative cycle may
        carry any of them."""
        return self._ctl.size > 1

    def pack_to_host(self, entries, prescale: float,
                     wire: int = _wd.WIRE_NONE) -> torch.Tensor:
        """The fused allreduce buffer of ``entries`` in host memory
        (pinned for CUDA tensors), the prescale applied and then the
        ``wire`` verdict (int8 with this rank's error feedback): what
        ``execute_allreduce`` sends, and a speculative cycle frame's
        segment. On CUDA the pack and the cast wait for every entry's
        ready event. The entries' outputs and done events are left
        alone: the world may deny a speculative bid."""
        stream = self.ready_stream(entries)
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            flat = pack([e.tensor for e in entries], prescale)
            src_nbytes = flat.nbytes
            if wire == _wd.WIRE_INT8:
                flat = _wd.quantize_ef(
                    flat, self._ef, tuple(e.tensor_name for e in entries))
            else:
                flat = _wd.compress(flat, wire)
            if wire != _wd.WIRE_NONE:
                self._m_wire_saved.inc(max(0, src_nbytes - flat.nbytes))
                self._m_comp_ratio.observe(flat.nbytes / max(1, src_nbytes))
            return self._to_host(flat, stream)

    def unpack_from_host(self, entries, result: torch.Tensor,
                         postscale: float,
                         wire: int = _wd.WIRE_NONE) -> None:
        """The world's fused result (a fresh host buffer, at wire width
        under a verdict) into the entries' outputs: to the device,
        decompressed, postscaled, unpacked, and on CUDA the done event
        recorded after all of it."""
        with self.plane_stream(entries) as stream:
            result = self._to_device(result, entries[0].tensor.device,
                                     stream)
            if wire != _wd.WIRE_NONE:
                result = _wd.decompress(
                    result, wire, entries[0].tensor.dtype,
                    sum(e.tensor.numel() for e in entries))
            scale_(result, postscale)
            unpack(entries, result)

    # -- staging between the device and the host -------------------------
    def _to_host(self, flat: torch.Tensor, stream) -> torch.Tensor:
        """``flat`` in host memory: one copy into pinned memory when it
        is on the card (waited for, since the socket reads it next),
        ``flat`` itself on the CPU."""
        if stream is None:
            return flat.contiguous()
        host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
        host.copy_(flat, non_blocking=True)
        self._wait(stream)
        self.bytes_to_host += host.numel() * host.element_size()
        return host

    def _wait(self, stream) -> None:
        """Wait for ``stream``'s work so far in slices of at most 1 ms,
        beaconing to the waiting peers between them (rate-limited by
        the controller): the loop sends no frame while it waits on the
        card."""
        done = torch.cuda.Event()
        done.record(stream)
        delay = 5e-5
        while not done.query():
            self._ctl.keepalive()
            time.sleep(delay)
            delay = min(2 * delay, 1e-3)

    @staticmethod
    def _host_empty(n: int, dtype, stream) -> torch.Tensor:
        return torch.empty(n, dtype=dtype, pin_memory=stream is not None)

    def _to_device(self, host: torch.Tensor, device, stream) -> torch.Tensor:
        if stream is None:
            return host
        self.bytes_from_host += host.numel() * host.element_size()
        return host.to(device, non_blocking=True)

    def _star_reduce(self, host: torch.Tensor, fresh: bool,
                     wire: int = _wd.WIRE_NONE, dtype=None,
                     count: int = 0) -> torch.Tensor:
        """Coordinator: the sum over ranks of ``host``, in rank order, at
        ``wire`` (``dtype`` and ``count`` the uncompressed payload's).
        ``fresh`` says ``host`` may be accumulated into (a compressed
        payload always may)."""
        ctl = self._ctl
        outs = [None] + [torch.empty_like(host)
                         for _ in range(1, ctl.size)]
        ctl.gather_data_into(host, outs)
        if wire != _wd.WIRE_NONE:
            return _wd.reduce_wire(host, outs[1:], wire, dtype, count)
        acc = host if fresh else host.clone()
        for peer in outs[1:]:
            _accumulate(acc, peer)
        return acc

    # -- allreduce -------------------------------------------------------
    def execute_allreduce(self, entries, response: Response) -> Status:
        ctl = self._ctl
        names = [e.tensor_name for e in entries]
        multi = len(entries) > 1
        wire = response.wire_dtype
        with self.activity(names, ACT_MEMCPY_IN_FUSION_BUFFER, multi):
            host = self.pack_to_host(entries, response.prescale_factor, wire)
        # A pinned ``host`` is a copy of CUDA tensors.
        pinned = host.is_pinned()
        if ctl.is_coordinator:
            fresh = pinned or multi or response.prescale_factor != 1.0
            result = self._star_reduce(
                host, fresh, wire, entries[0].tensor.dtype,
                sum(e.tensor.numel() for e in entries))
            ctl.broadcast_data(result)
        else:
            ctl.gather_data_into(host, None)
            result = torch.empty(host.numel(), dtype=host.dtype,
                                 pin_memory=pinned)
            ctl.broadcast_data_into(None, result)
        with self.activity(names, ACT_MEMCPY_OUT_FUSION_BUFFER, multi):
            self.unpack_from_host(entries, result, response.postscale_factor,
                                  wire)
        return Status.OK()

    # -- allgather (fused responses; dim 0 may differ per rank) ----------
    def execute_allgather(self, entries, response: Response) -> Status:
        ctl = self._ctl
        size = ctl.size
        names = [e.tensor_name for e in entries]
        multi = len(entries) > 1
        tensors = [e.tensor for e in entries]
        device = tensors[0].device
        wire = response.wire_dtype  # a cast wire, never int8
        comp, rank_counts = _allgather_layout(tensors, response, size)
        offs = [0] * size
        for r in range(1, size):
            offs[r] = offs[r - 1] + rank_counts[r - 1]
        with self.plane_stream(entries) as stream:
            with self.activity(names, ACT_MEMCPY_IN_FUSION_BUFFER, multi):
                host = self._to_host(
                    _wd.compress(pack(tensors, 1.0), wire), stream)
            result = self._host_empty(sum(rank_counts), host.dtype, stream)
            if ctl.is_coordinator:
                # Peer r's block lands straight in its window of the
                # rank-major result.
                outs = [None] + [result[offs[r]:offs[r] + rank_counts[r]]
                                 for r in range(1, size)]
                ctl.gather_data_into(host, outs)
                result[:rank_counts[0]] = host
                ctl.broadcast_data(result)
            else:
                ctl.gather_data_into(host, None)
                ctl.broadcast_data_into(None, result)
            with self.activity(names, ACT_MEMCPY_OUT_FUSION_BUFFER, multi):
                result = self._to_device(result, device, stream)
                if wire != _wd.WIRE_NONE:
                    result = _wd.decompress(result, wire, tensors[0].dtype,
                                            result.numel())
                at = list(offs)  # where each rank's next component starts
                for ec, (e, t) in enumerate(zip(entries, tensors)):
                    parts = []
                    for rc in range(size):
                        parts.append(result[at[rc]:at[rc] + comp[ec][rc]])
                        at[rc] += comp[ec][rc]
                    rows = sum(response.tensor_sizes[ec * size:
                                                     (ec + 1) * size])
                    e.output = torch.cat(parts).view((rows,) + t.shape[1:])
        return Status.OK()

    # -- broadcast -------------------------------------------------------
    def execute_broadcast(self, entries, response: Response) -> Status:
        ctl = self._ctl
        (entry,) = entries
        t = entry.tensor
        root = entry.root_rank
        with self.plane_stream(entries) as stream:
            if ctl.rank == root:
                ctl.broadcast_data(self._to_host(t.reshape(-1), stream),
                                   root_rank=root)
                # A fresh copy, never an alias of the caller's tensor.
                entry.output = t.clone(memory_format=torch.contiguous_format)
            else:
                host = self._host_empty(t.numel(), t.dtype, stream)
                ctl.broadcast_data_into(None, host, root_rank=root)
                entry.output = self._to_device(host, t.device,
                                               stream).view(t.shape)
        return Status.OK()

    # -- alltoall --------------------------------------------------------
    def execute_alltoall(self, entries, response: Response) -> Status:
        ctl = self._ctl
        size = ctl.size
        (entry,) = entries
        t = entry.tensor
        with self.plane_stream(entries) as stream:
            host = self._to_host(t.reshape(-1), stream)
            block = host.numel() // size
            if ctl.is_coordinator:
                outs = [None] + [torch.empty_like(host)
                                 for _ in range(1, size)]
                ctl.gather_data_into(host, outs)
                mats = [host] + outs[1:]
                # Destination d receives block d of every source, in
                # rank order.
                payloads = [torch.cat([m[d * block:(d + 1) * block]
                                       for m in mats]) for d in range(size)]
                ctl.scatter_data_into(payloads, None)
                result = payloads[0]
            else:
                ctl.gather_data_into(host, None)
                result = self._host_empty(host.numel(), host.dtype, stream)
                ctl.scatter_data_into(None, result)
            entry.output = self._to_device(result, t.device,
                                           stream).view(t.shape)
        return Status.OK()

    # -- reducescatter ---------------------------------------------------
    def execute_reducescatter(self, entries, response: Response) -> Status:
        ctl = self._ctl
        size = ctl.size
        (entry,) = entries
        t = entry.tensor
        per_rank = t.shape[0] // size
        per_elems = t.numel() // size
        wire = response.wire_dtype
        with self.plane_stream(entries) as stream:
            flat = scale(t.reshape(-1), response.prescale_factor)
            if wire != _wd.WIRE_NONE:
                result = self._compressed_reducescatter(
                    self._to_host(_wd.compress(flat, wire), stream), wire,
                    t.dtype, t.numel(), per_elems, stream)
                result = _wd.decompress(self._to_device(result, t.device,
                                                        stream),
                                        wire, t.dtype, per_elems)
                scale_(result, response.postscale_factor)
                entry.output = result.view((per_rank,) + t.shape[1:])
                return Status.OK()
            host = self._to_host(flat, stream)
            if ctl.is_coordinator:
                fresh = stream is not None or response.prescale_factor != 1.0
                acc = self._star_reduce(host, fresh)
                slices = [acc[d * per_elems:(d + 1) * per_elems]
                          for d in range(size)]
                ctl.scatter_data_into(slices, None)
                result = slices[0]
            else:
                ctl.gather_data_into(host, None)
                result = self._host_empty(per_elems, host.dtype, stream)
                ctl.scatter_data_into(None, result)
            result = self._to_device(result, t.device, stream)
            scale_(result, response.postscale_factor)
            entry.output = result.view((per_rank,) + t.shape[1:])
        return Status.OK()

    def _compressed_reducescatter(self, host: torch.Tensor, wire: int,
                                  dtype, count: int, per_elems: int,
                                  stream) -> torch.Tensor:
        """The star's reducescatter at ``wire`` on the host payload
        ``host``: returns this rank's slice, still at wire width. A cast
        wire sums in its dtype; int8 sums the ranks' dequantized payloads
        in ``dtype`` and quantizes each output slice with a fresh scale,
        the coordinator's own included."""
        ctl = self._ctl
        size = ctl.size
        slice_nbytes = _wd.compressed_nbytes(wire, per_elems, 0)
        if ctl.is_coordinator:
            if wire == _wd.WIRE_INT8:
                outs = [None] + [torch.empty_like(host)
                                 for _ in range(1, size)]
                ctl.gather_data_into(host, outs)
                acc = _wd.dequantize(host, dtype, count)
                for peer in outs[1:]:
                    acc += _wd.dequantize(peer, dtype, count)
                slices = [_wd.quantize(acc[d * per_elems:(d + 1) * per_elems])
                          for d in range(size)]
            else:
                acc = self._star_reduce(host, True, wire, dtype, count)
                slices = [acc[d * per_elems:(d + 1) * per_elems]
                          for d in range(size)]
            ctl.scatter_data_into(slices, None)
            return slices[0]
        ctl.gather_data_into(host, None)
        if wire == _wd.WIRE_INT8:
            out = self._host_empty(slice_nbytes, torch.uint8, stream)
        else:
            out = self._host_empty(per_elems, host.dtype, stream)
        ctl.scatter_data_into(None, out)
        return out

    def execute_barrier(self, entries, response: Response) -> Status:
        if self._ctl.gather_data(b"") is not None:
            self._ctl.broadcast_data(b"")
        else:
            self._ctl.broadcast_data(None)
        return Status.OK()
