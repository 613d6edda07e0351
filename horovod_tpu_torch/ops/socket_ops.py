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
tensors take the same path without the copies.

The coordinator accumulates in the tensor's dtype, in rank order
(``acc += peer`` for ranks 1..N-1), as the reference does at :396-418,
so that the result equals the reference's bit for bit, bfloat16
included (torch's CPU add and ml_dtypes' both round each sum to
nearest-even). The ring (``ops/ring.py``), shm, wire compression and the
fusion arena are not ported yet (``ROADMAP.md`` A6.4-A6.6).
"""

from __future__ import annotations

import math
from typing import List

import torch

from horovod_tpu_torch.common.controller import Controller
from horovod_tpu_torch.common.message import Response
from horovod_tpu_torch.common.status import Status
from horovod_tpu_torch.common.timeline import (
    ACT_MEMCPY_IN_FUSION_BUFFER, ACT_MEMCPY_OUT_FUSION_BUFFER,
)
from horovod_tpu_torch.ops.backend import CollectiveBackend, scale


def _pack(tensors: List[torch.Tensor], prescale: float) -> torch.Tensor:
    """The fusion buffer: the tensors flattened and concatenated on
    their device, each copy scaled by ``prescale`` in the tensors' dtype.
    One tensor without a prescale stays a (flat) view."""
    flats = [t.reshape(-1) for t in tensors]
    if len(flats) == 1:
        return scale(flats[0], prescale)
    buf = torch.empty(sum(f.numel() for f in flats), dtype=flats[0].dtype,
                      device=flats[0].device)
    factor = (None if prescale == 1.0
              else torch.tensor(prescale, dtype=buf.dtype))
    offset = 0
    for f in flats:
        dst = buf[offset:offset + f.numel()]
        if factor is None:
            dst.copy_(f)
        else:
            torch.mul(f, factor, out=dst)
        offset += f.numel()
    return buf


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

    def enabled(self, entries, response) -> bool:
        return self._ctl.size > 1

    # -- staging between the device and the host -------------------------
    def _to_host(self, flat: torch.Tensor, stream) -> torch.Tensor:
        """``flat`` in host memory: one copy into pinned memory when it
        is on the card (waited for, since the socket reads it next),
        ``flat`` itself on the CPU."""
        if stream is None:
            return flat.contiguous()
        host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
        host.copy_(flat, non_blocking=True)
        stream.synchronize()
        self.bytes_to_host += host.numel() * host.element_size()
        return host

    @staticmethod
    def _host_empty(n: int, dtype, stream) -> torch.Tensor:
        return torch.empty(n, dtype=dtype, pin_memory=stream is not None)

    def _to_device(self, host: torch.Tensor, device, stream) -> torch.Tensor:
        if stream is None:
            return host
        self.bytes_from_host += host.numel() * host.element_size()
        return host.to(device, non_blocking=True)

    @staticmethod
    def _postscale_(result: torch.Tensor, factor: float) -> None:
        """In place: ``result`` is always a fresh buffer here."""
        if factor != 1.0:
            result.mul_(torch.tensor(factor, dtype=result.dtype))

    def _star_reduce(self, host: torch.Tensor, fresh: bool) -> torch.Tensor:
        """Coordinator: the sum over ranks of ``host``, in rank order.
        ``fresh`` says ``host`` may be accumulated into."""
        ctl = self._ctl
        outs = [None] + [torch.empty_like(host)
                         for _ in range(1, ctl.size)]
        ctl.gather_data_into(host, outs)
        acc = host if fresh else host.clone()
        for peer in outs[1:]:
            _accumulate(acc, peer)
        return acc

    # -- allreduce -------------------------------------------------------
    def execute_allreduce(self, entries, response: Response) -> Status:
        ctl = self._ctl
        names = [e.tensor_name for e in entries]
        multi = len(entries) > 1
        device = entries[0].tensor.device
        with self.plane_stream(entries) as stream:
            with self.activity(names, ACT_MEMCPY_IN_FUSION_BUFFER, multi):
                fused = _pack([e.tensor for e in entries],
                              response.prescale_factor)
                host = self._to_host(fused, stream)
            if ctl.is_coordinator:
                fresh = (stream is not None or multi
                         or response.prescale_factor != 1.0)
                result = self._star_reduce(host, fresh)
                ctl.broadcast_data(result)
            else:
                ctl.gather_data_into(host, None)
                result = self._host_empty(host.numel(), host.dtype, stream)
                ctl.broadcast_data_into(None, result)
            with self.activity(names, ACT_MEMCPY_OUT_FUSION_BUFFER, multi):
                result = self._to_device(result, device, stream)
                self._postscale_(result, response.postscale_factor)
                offset = 0
                for e in entries:
                    n = e.tensor.numel()
                    e.output = result[offset:offset + n].view(e.tensor.shape)
                    offset += n
        return Status.OK()

    # -- allgather (fused responses; dim 0 may differ per rank) ----------
    def execute_allgather(self, entries, response: Response) -> Status:
        ctl = self._ctl
        size = ctl.size
        names = [e.tensor_name for e in entries]
        multi = len(entries) > 1
        tensors = [e.tensor for e in entries]
        device = tensors[0].device
        comp, rank_counts = _allgather_layout(tensors, response, size)
        offs = [0] * size
        for r in range(1, size):
            offs[r] = offs[r - 1] + rank_counts[r - 1]
        with self.plane_stream(entries) as stream:
            with self.activity(names, ACT_MEMCPY_IN_FUSION_BUFFER, multi):
                host = self._to_host(_pack(tensors, 1.0), stream)
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
        with self.plane_stream(entries) as stream:
            host = self._to_host(
                scale(t.reshape(-1), response.prescale_factor), stream)
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
            self._postscale_(result, response.postscale_factor)
            entry.output = result.view((per_rank,) + t.shape[1:])
        return Status.OK()

    def execute_barrier(self, entries, response: Response) -> Status:
        if self._ctl.gather_data(b"") is not None:
            self._ctl.broadcast_data(b"")
        else:
            self._ctl.broadcast_data(None)
        return Status.OK()
