"""The process-group data plane: each negotiated Response as one
``torch.distributed`` collective.

Counterpart of ``horovod_tpu/ops/xla_ops.py`` ``XlaMeshBackend`` (:88),
which runs each fused Response as one compiled collective over a mesh
of one device per process. Here the collective is a ``torch.distributed``
call on process groups of the plane's own, issued by the runtime's
thread on the plane's CUDA stream (``ops/backend.py`` ``plane_stream``)
after each entry's ready event. torch compiles nothing per signature,
so the reference's executable cache (``_compiled`` :238, the epoch
eviction :249) has no counterpart. Like ``XlaMeshBackend``, the plane
has a transport of its own and is not ``fused_cycle_reducible``: the
response cache's cycles reach it through the two-round bitmask path,
never the speculative one.

Which tensors it takes. It serves one device type, given to the
constructor: ``common/basics.py`` builds it for ``"cuda"`` (a CPU
tensor stays on the socket star), as Horovod sends GPU tensors to NCCL
and CPU tensors to MPI, and as the reference sends device arrays to its
mesh and host arrays to its socket plane (:213-224); the CPU tests build
it for ``"cpu"``. Whether a Response is one it serves is read from the
Response itself (every rank's device index, which the coordinator has
already checked agree in kind), so every rank decides alike. Tensors of
a dtype neither gloo nor NCCL reduces (int16, uint16, bool) stay on the
star, also a choice every rank makes alike, since the coordinator made
the ranks' dtypes agree.

World-consistent enablement, as ``_ensure_mesh``/``_probe_local``
(:122-211). At the first Response it serves, which is the same point of
the response stream on every rank, each rank probes locally (its process
groups exist, the default group's size and rank are the controller's,
its tensors lie on the served device type) and ``controller.agree``
ANDs the answers: if any rank says no, every rank takes the star for
good and each rank that could have joined logs a warning. The same
first use picks the rendering. On ``"cuda"`` the ranks exchange their
cards' identities (``torch.cuda.get_device_properties(dev).uuid``)
through the controller: ``nccl`` when every rank holds its own card,
``gloo`` when two ranks share one (NCCL refuses that case, which is a
one-card machine's). ``"cpu"`` always renders with gloo. gloo takes
every op this plane issues on CUDA tensors as well (all_reduce in every
dtype of ``PLANE_DTYPES``, all_gather_into_tensor, reduce_scatter_tensor,
all_to_all_single, broadcast, barrier; ``tools/gloo_cuda_probe.py``
checked them with torch 2.11 on an NVIDIA H100 80GB HBM3 at 700.00 W),
so no op needs another rendering under gloo.

The plane's groups (a world group per rendering it may pick, and with
hierarchical collectives a local group per host and a cross group per
local rank) are made at ``hvd.init`` after the default group, every
rank calling ``dist.new_group`` in the same order, and destroyed at
``shutdown``. They are not the default group: the in-step collectives
(``spmd``) run on that from the caller's thread, and one NCCL
communicator used from two threads could see their collectives in
different orders on different ranks and hang.

Renderings per op, as the reference's methods:

- allreduce (:341-379): one ``all_reduce`` of the fused flat buffer, the
  prescale fused into the pack (``backend.pack``, shared with the star)
  and the postscale after, both factors rounded to the dtype.
- allgather (:381-466): each entry padded to its largest dim 0, one
  ``all_gather_into_tensor`` of the fused buffer, each rank's real rows
  sliced out. Under heavy dim-0 skew (:468-552; ``ragged_psum_wins``,
  a copy of the reference's) the fused buffer is instead scattered at
  each rank's true row offset into zeros and summed with one
  ``all_reduce``. Offsets are Python ints, never int32.
- broadcast (:554): one ``broadcast``. ``HOROVOD_XLA_BCAST`` picks one
  of two renderings in the reference only because JAX has no one-to-all
  collective; both values render as this one call here.
- alltoall (:614): ``all_to_all_single`` in equal blocks, the split the
  negotiated op has.
- reducescatter (:634): ``reduce_scatter_tensor`` of the prescaled
  tensor, then the postscale (the Response carries the requests' scale
  factors, the port's departure from the reference).
- barrier (:661): once the world has agreed on the plane, a barrier on
  its world group.

Hierarchical allreduce and allgather (``HOROVOD_HIERARCHICAL_*``), as
``_maybe_build_hierarchical_mesh`` (:162-193), under the same conditions
(a homogeneous topology, more than one rank per host, ranks numbered
contiguously per host; a warning otherwise). The allreduce is
reduce-scatter within the host, all-reduce across hosts, all-gather
within the host (reference Horovod's ``NCCLHierarchicalAllreduce``), on
a buffer padded to a multiple of the ranks per host; the allgather
gathers within the host and then exchanges whole host blocks across
hosts, which lands in rank order. Other ops stay flat, as in the
reference.

Completion. The reference returns ``InProgress`` from ``_complete``
(:311-338) and a finalizer thread observes the outputs, so that the loop
keeps negotiating while a collective is in flight. Under ``nccl`` the
done events cover this: the collective is queued on the card behind the
plane's stream, so are the postscale and the unpack after it,
``execute_*`` returns at once, and ``synchronize`` makes the caller's
stream wait on the done event. Under ``gloo`` they do not: gloo runs
its algorithm on the host. So there the plane does what the reference
does: it issues the collective (``async_op=True``) from the loop's
thread, in the response order every rank shares, and hands the wait,
the postscale, the unpack, the done event and the callbacks to a
finalizer thread (``common/finalizer.py``, the reference's), returning
``Status.InProgress()``. The stages of a hierarchical collective read
each other's outputs and are waited for in turn on the loop's thread;
only the last one completes on the finalizer.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import logging as hlog
from horovod_tpu_torch.common.message import Response, ResponseType
from horovod_tpu_torch.common.status import Status
from horovod_tpu_torch.common.timeline import (
    ACT_MEMCPY_IN_FUSION_BUFFER, ACT_MEMCPY_OUT_FUSION_BUFFER,
)
from horovod_tpu_torch.ops.backend import (
    CollectiveBackend, pack, scale, scale_, unpack,
)

# Dtypes that gloo and NCCL both reduce; others stay on the star.
PLANE_DTYPES = (torch.uint8, torch.int8, torch.int32, torch.int64,
                torch.float16, torch.bfloat16, torch.float32, torch.float64)


def _all_gather(out, inp, group):
    """``all_gather_into_tensor``, issued asynchronously, by the name
    the installed torch offers without a deprecation warning; returns
    the work."""
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    return fn(out, inp, group=group, async_op=True)


def _reduce_scatter(out, inp, group):
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    return fn(out, inp, group=group, async_op=True)


def ragged_psum_wins(sizes, slice_numels, world_size: int) -> bool:
    """Skew guard for the fused variable-dim0 allgather: True when the
    masked-psum rendering moves fewer bytes than the padded all_gather.

    The padded all_gather's wire traffic scales with
    ``world_size x max(dim0)`` per entry, the reference's
    ``MPI_Allgatherv`` with the TRUE bytes
    (reference: mpi_operations.cc:95-173). A psum over a zero-scattered
    output buffer moves ~2x the true bytes (reduce-scatter +
    all-gather phases), so it wins once the skew exceeds roughly
    ``max(dim0) > 2 x mean(dim0)``. Inputs come from the broadcast
    Response (entry-major ``sizes``), so every rank decides alike.
    """
    if world_size <= 1:
        return False
    padded_elems = 0
    psum_elems = 0
    for ec, sn in enumerate(slice_numels):
        rows = sizes[ec * world_size:(ec + 1) * world_size]
        m = max(rows)
        padded_elems += world_size * m * sn
        # psum buffer: true rows + one max-block of overlap slack
        psum_elems += (sum(rows) + m) * sn
    if psum_elems > 2 ** 31 - 1:
        # The reference's guard, kept so that both pick the same
        # rendering: its scatter offsets were 32-bit. The offsets here
        # are Python ints and would not wrap.
        return False
    return 2 * psum_elems < padded_elems


class _Groups:
    """One rendering's process groups: the world, and with hierarchical
    collectives this rank's host (local) and its peers of the same
    local rank on the other hosts (cross)."""

    def __init__(self, world, local=None, cross=None):
        self.world = world
        self.local = local
        self.cross = cross


class ProcessGroupBackend(CollectiveBackend):
    name = "process_group"

    def __init__(self, controller, config=None, device_type: str = "cuda"):
        super().__init__()
        if device_type not in ("cuda", "cpu"):
            raise ValueError(f"the plane serves 'cuda' or 'cpu' tensors, "
                             f"not {device_type!r}")
        self._ctl = controller
        self._config = config
        self.device_type = device_type
        self._groups: Dict[str, _Groups] = {}
        self._hierarchical = False
        self._available: Optional[bool] = None
        # "nccl" or "gloo", agreed at first use.
        self.rendering: Optional[str] = None

    # -- groups ------------------------------------------------------------
    def _renderings(self):
        return ("nccl", "gloo") if self.device_type == "cuda" else ("gloo",)

    def _hierarchical_layout(self) -> bool:
        """The reference's conditions for the two-level collectives."""
        cfg, topo = self._config, self._ctl.topology
        if cfg is None or not (cfg.hierarchical_allreduce
                               or cfg.hierarchical_allgather):
            return False
        if not topo.is_homogeneous or topo.local_size <= 1:
            return False
        if topo.rank != topo.cross_rank * topo.local_size + topo.local_rank:
            hlog.warning("hierarchical collectives disabled (allreduce/"
                         "allgather): ranks are not grouped contiguously "
                         "per host", rank=topo.rank)
            return False
        return True

    def create_groups(self) -> None:
        """Make the plane's groups. Every rank calls this once, after
        the default group exists, so that every ``dist.new_group`` call
        happens in the same order everywhere."""
        topo = self._ctl.topology
        if topo.size <= 1 or self._groups:
            return
        self._hierarchical = self._hierarchical_layout()
        ls, cs = topo.local_size, topo.cross_size
        for rendering in self._renderings():
            world = dist.new_group(list(range(topo.size)),
                                   backend=rendering)
            local = cross = None
            if self._hierarchical:
                for host in range(cs):
                    g = dist.new_group([host * ls + i for i in range(ls)],
                                       backend=rendering)
                    if host == topo.cross_rank:
                        local = g
                for i in range(ls):
                    g = dist.new_group([host * ls + i for host in range(cs)],
                                       backend=rendering)
                    if i == topo.local_rank:
                        cross = g
            self._groups[rendering] = _Groups(world, local, cross)

    def destroy_groups(self) -> None:
        for groups in self._groups.values():
            for g in (groups.world, groups.local, groups.cross):
                if g is not None:
                    dist.destroy_process_group(g)
        self._groups = {}

    @property
    def _g(self) -> _Groups:
        return self._groups[self.rendering]

    # -- enablement --------------------------------------------------------
    def _serves(self, response: Response) -> bool:
        """Read from the Response alone, so every rank answers alike."""
        if response.response_type == ResponseType.BARRIER:
            return self._available is True
        devs = response.devices
        on_device = bool(devs) and all(d >= 0 for d in devs)
        return on_device == (self.device_type == "cuda")

    def _probe_local(self, entries) -> bool:
        """This rank's view of the plane (another rank's may differ:
        never act on it alone)."""
        ctl = self._ctl
        if not self._groups or not dist.is_initialized():
            hlog.warning("process-group plane: this rank has no process "
                         "groups", rank=ctl.rank)
            return False
        if (dist.get_world_size(), dist.get_rank()) != (ctl.size, ctl.rank):
            # Group rank r must be horovod rank r: broadcast roots,
            # allgather slots and alltoall blocks are read by rank.
            hlog.warning(f"process-group plane: the default group's rank "
                         f"{dist.get_rank()} of {dist.get_world_size()} is "
                         f"not horovod rank {ctl.rank} of {ctl.size}",
                         rank=ctl.rank)
            return False
        if any(e.tensor.device.type != self.device_type for e in entries):
            return False
        return True

    def _agree_rendering(self) -> str:
        """Every rank's card identity through the controller; the
        coordinator picks and broadcasts."""
        if self.device_type == "cpu":
            return "gloo"
        dev = torch.cuda.current_device()
        ident = str(torch.cuda.get_device_properties(dev).uuid).encode()
        gathered = self._ctl.gather_data(ident)
        if gathered is not None:  # coordinator
            distinct = len(set(bytes(g) for g in gathered)) == len(gathered)
            return self._ctl.broadcast_data(
                b"nccl" if distinct else b"gloo").decode()
        return bytes(self._ctl.broadcast_data(None)).decode()

    def _ensure(self, entries) -> bool:
        if self._available is None:
            local_ok = self._probe_local(entries)
            self._available = self._ctl.agree(local_ok)
            if self._available:
                self.rendering = self._agree_rendering()
            elif local_ok:
                hlog.warning("process-group plane disabled: another rank "
                             "cannot join it; every collective takes the "
                             "socket star", rank=self._ctl.rank)
        return self._available

    def enabled(self, entries, response) -> bool:
        if self._ctl.size <= 1 or not self._serves(response):
            return False
        if response.response_type != ResponseType.BARRIER and \
                entries[0].tensor.dtype not in PLANE_DTYPES:
            return False
        return self._ensure(entries)

    # -- completion --------------------------------------------------------
    def _complete(self, entries, stream, work, finish) -> Status:
        """Wait for the issued collective, then ``finish`` (postscale,
        unpack), on the plane's stream for CUDA tensors, and record the
        entries' done event after it. Under ``nccl`` that is queued on
        the card at once; under ``gloo`` a finalizer thread waits for
        the host algorithm while the loop goes on, and fires the
        callbacks."""
        names = [e.tensor_name for e in entries]

        def run(inline):
            ctx = (torch.cuda.stream(stream) if stream is not None
                   else contextlib.nullcontext())
            with ctx:
                work.wait()
                # The timeline is the loop's: a finalizer leaves it be.
                with self.activity(names, ACT_MEMCPY_OUT_FUSION_BUFFER,
                                   inline and len(entries) > 1):
                    finish()
                if stream is not None:
                    done = torch.cuda.Event()
                    done.record(stream)
                    for e in entries:
                        e.done_event = done

        def finalize():
            if stream is not None:
                torch.cuda.set_device(stream.device)
            try:
                run(inline=False)
                status = Status.OK()
            except Exception as ex:
                status = Status.UnknownError(
                    f"collective completion failed: {ex!r}")
            for e in entries:
                if e.callback:
                    try:
                        e.callback(status)
                    except Exception as ex:
                        # One callback must not starve the batch's others.
                        hlog.error(f"completion callback for "
                                   f"{e.tensor_name} raised: {ex!r}")

        if self.rendering == "nccl" or self.finalizer is None or \
                not self.finalizer.submit(finalize):
            run(inline=True)
            return Status.OK()
        return Status.InProgress()

    # -- the two-level allreduce -------------------------------------------
    def _allreduce_flat(self, buf: torch.Tensor):
        """Issues the sum of ``buf`` over the world, in place; returns
        (the last stage's work, what to run after it)."""
        g = self._g
        if not (self._hierarchical and self._config.hierarchical_allreduce):
            return dist.all_reduce(buf, group=g.world, async_op=True), None
        ls = self._ctl.topology.local_size
        n = buf.numel()
        chunk = -(-n // ls)
        padded = buf if chunk * ls == n else torch.cat(
            [buf, buf.new_zeros(chunk * ls - n)])
        part = buf.new_empty(chunk)
        # Each stage reads the one before: wait between them.
        _reduce_scatter(part, padded, g.local).wait()
        dist.all_reduce(part, group=g.cross, async_op=True).wait()
        work = _all_gather(padded, part, g.local)
        if padded is buf:
            return work, None
        return work, lambda: buf.copy_(padded[:n])

    # -- allreduce ---------------------------------------------------------
    def execute_allreduce(self, entries, response: Response) -> Status:
        names = [e.tensor_name for e in entries]
        multi = len(entries) > 1
        with self.plane_stream(entries) as stream:
            with self.activity(names, ACT_MEMCPY_IN_FUSION_BUFFER, multi):
                buf = pack([e.tensor for e in entries],
                           response.prescale_factor, fresh=True)
            work, gathered = self._allreduce_flat(buf)

        def finish():
            if gathered is not None:
                gathered()
            scale_(buf, response.postscale_factor)
            unpack(entries, buf)
        return self._complete(entries, stream, work, finish)

    # -- allgather ---------------------------------------------------------
    def execute_allgather(self, entries, response: Response) -> Status:
        size = self._ctl.size
        sizes = response.tensor_sizes  # entry-major: [ec * size + rc]
        hier = self._hierarchical and self._config.hierarchical_allgather
        slice_numels = [math.prod(e.tensor.shape[1:]) for e in entries]
        names = [e.tensor_name for e in entries]
        multi = len(entries) > 1
        if not hier and ragged_psum_wins(sizes, slice_numels, size):
            return self._execute_allgather_psum(entries, response,
                                                slice_numels)
        with self.plane_stream(entries) as stream:
            with self.activity(names, ACT_MEMCPY_IN_FUSION_BUFFER, multi):
                blocks = []
                for ec, e in enumerate(entries):
                    m = max(sizes[ec * size:(ec + 1) * size])
                    x = e.tensor.reshape(-1)
                    blocks.append(torch.cat([x, x.new_zeros(
                        m * slice_numels[ec] - x.numel())]))
                flat = torch.cat(blocks) if multi else blocks[0]
            out = flat.new_empty(size * flat.numel())
            if hier:
                topo = self._ctl.topology
                local = flat.new_empty(topo.local_size * flat.numel())
                _all_gather(local, flat, self._g.local).wait()
                work = _all_gather(out, local, self._g.cross)
            else:
                work = _all_gather(out, flat, self._g.world)

        def finish():
            g = out.view(size, flat.numel())
            at = 0
            for ec, e in enumerate(entries):
                rows = sizes[ec * size:(ec + 1) * size]
                sn = slice_numels[ec]
                parts = [g[r, at:at + rows[r] * sn] for r in range(size)]
                e.output = torch.cat(parts).view(
                    (sum(rows),) + tuple(e.tensor.shape[1:]))
                at += max(rows) * sn
        return self._complete(entries, stream, work, finish)

    def _execute_allgather_psum(self, entries, response: Response,
                                slice_numels) -> Status:
        """The skewed fused allgather (reference :468-552): this rank's
        padded block written at its true row offset into a zero buffer
        laid out by the real row counts (one max-block of slack per
        entry), and one all_reduce assembles it. A position this rank
        does not own receives only its padding zeros, so every row is
        summed from exactly one rank's values."""
        size, rank = self._ctl.size, self._ctl.rank
        sizes = response.tensor_sizes
        layout = []   # per entry: (offset of each rank's rows, rows)
        total = 0
        for ec, sn in enumerate(slice_numels):
            rows = sizes[ec * size:(ec + 1) * size]
            offs, acc = [], 0
            for r in range(size):
                offs.append(total + acc * sn)
                acc += rows[r]
            layout.append((offs, rows))
            total += (acc + max(rows)) * sn
        with self.plane_stream(entries) as stream:
            buf = entries[0].tensor.new_zeros(total)
            for (offs, _), e in zip(layout, entries):
                x = e.tensor.reshape(-1)
                buf[offs[rank]:offs[rank] + x.numel()] = x
            work = dist.all_reduce(buf, group=self._g.world, async_op=True)

        def finish():
            for (offs, rows), sn, e in zip(layout, slice_numels, entries):
                parts = [buf[offs[r]:offs[r] + rows[r] * sn]
                         for r in range(size)]
                e.output = torch.cat(parts).view(
                    (sum(rows),) + tuple(e.tensor.shape[1:]))
        return self._complete(entries, stream, work, finish)

    # -- broadcast ---------------------------------------------------------
    def execute_broadcast(self, entries, response: Response) -> Status:
        (entry,) = entries
        t = entry.tensor
        with self.plane_stream(entries) as stream:
            # A fresh buffer on every rank, never an alias of the
            # caller's tensor.
            buf = (t.clone(memory_format=torch.contiguous_format)
                   if self._ctl.rank == entry.root_rank
                   else torch.empty_like(
                       t, memory_format=torch.contiguous_format))
            work = dist.broadcast(buf, src=entry.root_rank,
                                  group=self._g.world, async_op=True)

        def finish():
            entry.output = buf
        return self._complete(entries, stream, work, finish)

    # -- alltoall ----------------------------------------------------------
    def execute_alltoall(self, entries, response: Response) -> Status:
        (entry,) = entries
        with self.plane_stream(entries) as stream:
            x = entry.tensor.contiguous()
            out = torch.empty_like(x)
            work = dist.all_to_all_single(out, x, group=self._g.world,
                                          async_op=True)

        def finish():
            entry.output = out
        return self._complete(entries, stream, work, finish)

    # -- reducescatter -----------------------------------------------------
    def execute_reducescatter(self, entries, response: Response) -> Status:
        (entry,) = entries
        t = entry.tensor
        size = self._ctl.size
        with self.plane_stream(entries) as stream:
            x = scale(t.reshape(-1), response.prescale_factor).contiguous()
            out = x.new_empty(x.numel() // size)
            work = _reduce_scatter(out, x, self._g.world)

        def finish():
            scale_(out, response.postscale_factor)
            entry.output = out.view((t.shape[0] // size,) + t.shape[1:])
        return self._complete(entries, stream, work, finish)

    def execute_barrier(self, entries, response: Response) -> Status:
        if self.rendering == "nccl":
            # A one-element sum on the card, waited for.
            t = torch.zeros(1, device=torch.cuda.current_device())
            dist.all_reduce(t, group=self._g.world)
            t.item()
        else:
            dist.barrier(group=self._g.world)
        return Status.OK()
