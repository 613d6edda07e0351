"""The background coordination loop: the heart of the runtime.

Counterpart of ``horovod_tpu/common/runtime.py`` run with the response
cache off: ``enqueue`` (:698), ``enqueue_group`` (:735), the background
loop (:863, :1767) with full-path cycles only, ``_coordinate`` (:2808),
``_check_stall`` (:2736) and ``_perform_operations`` (:2909-3034). One
daemon thread per process runs a negotiation cycle every
``HOROVOD_CYCLE_TIME`` ms: it drains this rank's request queue, gathers
every rank's requests at the coordinator, which fuses the ready tensors
under the fusion threshold and broadcasts the agreed ResponseList, and
runs that list through the backends. Enqueues return at once;
completion comes back through each entry's callback.

Left out until their slices (``ROADMAP.md`` A6 and A9): the speculative,
cached, overlapped and native steady cycles, elastic worlds,
self-operation, fault injection, tenancy, the trace and metrics planes,
autotune and the async finalizer.

The loop keeps counts that say what it costs (``stats``): cycles,
responses and the tensors in them, the seconds of negotiation (building,
gathering, coordinating and broadcasting the lists) and of execution
(running the responses through the backends).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from horovod_tpu_torch.common import logging as hlog
from horovod_tpu_torch.common import wire
from horovod_tpu_torch.common.config import Config
from horovod_tpu_torch.common.controller import Controller
from horovod_tpu_torch.common.coordinator import (
    MessageTable, StallInspector, construct_response, fuse_responses,
)
from horovod_tpu_torch.common.message import (
    DataType, Request, RequestList, RequestType, ResponseList, ResponseType,
)
from horovod_tpu_torch.common.status import (
    DUPLICATE_NAME_ERROR_FMT, SHUT_DOWN_ERROR, Status, WorldAbortedError,
    world_abort_message,
)
from horovod_tpu_torch.common.tensor_table import (
    HandleManager, TensorTable, TensorTableEntry,
)
from horovod_tpu_torch.common.timeline import (
    ACT_COLLECTIVE, ACT_QUEUE, NOOP_TIMELINE, create_timeline,
)
from horovod_tpu_torch.ops.operation_manager import OperationManager


class Runtime:
    """Process state and the background thread."""

    # Empty cycles before the idle backoff ramp starts.
    _IDLE_GRACE = 16

    def __init__(self, config: Config, controller: Controller,
                 op_manager: OperationManager, device=None):
        self.config = config
        self.controller = controller
        self.op_manager = op_manager
        # The CUDA device the loop's thread makes current (the current
        # device is per thread), None on the CPU.
        self.device = device
        self.tensor_table = TensorTable()
        self.handle_manager = HandleManager()
        self.timeline = NOOP_TIMELINE
        if controller.rank == 0 and config.timeline_path:
            self.timeline = create_timeline(config.timeline_path,
                                            config.timeline_mark_cycles)
        op_manager.attach_timeline(self.timeline)
        self._dtypes: Dict[str, DataType] = {}
        # name -> elements per dim-0 row (allgather fusion accounting).
        self._slice_numels: Dict[str, int] = {}
        self._stall = StallInspector(
            controller.size,
            warning_time=config.stall_check_time_seconds,
            shutdown_time=config.stall_shutdown_time_seconds,
            disabled=config.stall_check_disable)
        self._message_table = MessageTable(
            on_remove=self._stall.tensor_completed) \
            if controller.rank == 0 else None
        self._shutdown_requested = threading.Event()
        self._done = threading.Event()
        self._teardown_started = False
        self._thread: Optional[threading.Thread] = None
        # (origin_rank, cause) once the world has aborted.
        self._abort_info: Optional[tuple] = None
        self._idle_cycles = 0
        # Set by enqueue and request_shutdown: wakes a sleeping loop.
        self._wake = threading.Event()
        self.stats = {"cycles": 0, "responses": 0, "tensors": 0,
                      "negotiate_s": 0.0, "execute_s": 0.0}

    # -- lifecycle -------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._background_loop,
                                        name="hvd-background", daemon=True)
        self._thread.start()

    def request_shutdown(self) -> None:
        self._shutdown_requested.set()
        self._wake.set()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    @property
    def alive(self) -> bool:
        return (self._thread is not None and self._thread.is_alive()
                and not self._done.is_set())

    def _terminal_status(self) -> Status:
        """A structured abort naming the failed rank when the world was
        torn down by a failure, the plain shutdown error otherwise."""
        if self._abort_info is not None:
            origin, cause = self._abort_info
            return Status.WorldAborted(origin, cause)
        return Status.Aborted(SHUT_DOWN_ERROR)

    # -- enqueue APIs ----------------------------------------------------
    def _request(self, request_type, entry, dtype, shape, prescale,
                 postscale) -> Request:
        return Request(request_rank=self.controller.rank,
                       request_type=request_type, tensor_type=dtype,
                       tensor_name=entry.tensor_name,
                       root_rank=entry.root_rank, device=entry.device,
                       tensor_shape=shape, prescale_factor=prescale,
                       postscale_factor=postscale)

    def enqueue(self, request_type: RequestType, entry: TensorTableEntry,
                dtype: DataType, shape, prescale: float = 1.0,
                postscale: float = 1.0) -> Status:
        if self._done.is_set() or self._shutdown_requested.is_set():
            return self._terminal_status()
        req = self._request(request_type, entry, dtype, shape, prescale,
                            postscale)
        if not self.tensor_table.add(entry, req):
            return Status.InvalidArgument(
                DUPLICATE_NAME_ERROR_FMT
                % (request_type.name.lower(), entry.tensor_name))
        if self._done.is_set():
            # The loop exited between the check and the add, and its
            # shutdown fan-out may have missed this entry.
            if self.tensor_table.pop_entry_if_present(entry.tensor_name):
                return self._terminal_status()
        self._wake.set()
        return Status.OK()

    def enqueue_group(self, request_type: RequestType, items,
                      prescale: float = 1.0,
                      postscale: float = 1.0) -> Status:
        """Enqueue several entries as one negotiation batch: all enter
        the same RequestList, become ready in the same coordinator cycle
        and fuse under the threshold. ``items``: (entry, dtype, shape)."""
        if self._done.is_set() or self._shutdown_requested.is_set():
            return self._terminal_status()
        pairs = [(entry, self._request(request_type, entry, dtype, shape,
                                       prescale, postscale))
                 for entry, dtype, shape in items]
        dup = self.tensor_table.add_all(pairs)
        if dup is not None:
            return Status.InvalidArgument(
                DUPLICATE_NAME_ERROR_FMT % (request_type.name.lower(), dup))
        if self._done.is_set():
            for entry, _ in pairs:
                if self.tensor_table.pop_entry_if_present(
                        entry.tensor_name) and entry.callback:
                    entry.callback(self._terminal_status())
        self._wake.set()
        return Status.OK()

    # -- the loop --------------------------------------------------------
    def _background_loop(self) -> None:
        try:
            if self.device is not None:
                import torch
                torch.cuda.set_device(self.device)
            while self._run_loop_once():
                pass
        except WorldAbortedError as e:
            self._fail_world(e.origin_rank, e.cause)
        except (ConnectionError, OSError, TimeoutError) as e:
            rank = self.controller.rank
            self._fail_world(rank, f"transport failure on rank {rank}: {e}")
        except Exception as e:  # a backend bug: fail what is in flight
            hlog.error(f"horovod_tpu_torch background loop failed: {e!r}",
                       rank=self.controller.rank)
        finally:
            self._teardown()

    def _fail_world(self, origin: int, cause: str) -> None:
        self._abort_info = (origin, cause)
        hlog.error(f"horovod_tpu_torch world aborted: "
                   f"{world_abort_message(origin, cause)}",
                   rank=self.controller.rank)

    def _teardown(self) -> None:
        """Fail everything in flight, then close the timeline and the
        controller; each stage runs even if an earlier one raised."""
        if self._teardown_started:
            return
        self._teardown_started = True
        self._done.set()
        terminal = self._terminal_status()
        for entry in self.tensor_table.pop_all():
            if entry.callback:
                try:
                    entry.callback(terminal)
                except Exception:
                    pass  # a user callback; the teardown goes on
        try:
            self.timeline.shutdown()
        except Exception:
            pass
        # Closing the channels is what tells the peers, whose recv on
        # them then fails, that this rank is gone.
        try:
            self.controller.close()
        except Exception:
            pass

    def _run_loop_once(self) -> bool:
        """One negotiation cycle; False to exit."""
        t0 = time.monotonic()
        self.stats["cycles"] += 1
        self.timeline.mark_cycle_start()
        requests = self.tensor_table.pop_messages()
        shutting_down = self._shutdown_requested.is_set()
        payload = wire.serialize_cycle_request(
            RequestList(requests, shutdown=shutting_down))
        gathered = self.controller.gather_requests(payload)
        if self.controller.is_coordinator:
            resp_list = self._coordinate(
                [wire.parse_cycle_request(f) for f in gathered])
            self.controller.broadcast_responses(
                wire.serialize_cycle_response(resp_list))
        else:
            resp_list = wire.parse_cycle_response(
                self.controller.broadcast_responses(None))
        t1 = time.monotonic()
        self.stats["negotiate_s"] += t1 - t0
        self._perform_operations(resp_list)
        self.stats["execute_s"] += time.monotonic() - t1
        if resp_list.shutdown:
            return False

        # Pace the cycle.
        cycle_s = self.config.cycle_time_ms / 1000.0
        if resp_list.responses or requests:
            self._idle_cycles = 0
        else:
            self._idle_cycles += 1
        sleep_s = cycle_s - (time.monotonic() - t0)
        if sleep_s <= 0 and not self.tensor_table.queue_pending():
            # The cycle overran its budget and drained everything local:
            # a round started now would race the callbacks' re-enqueue
            # and carry empty frames, so wait one period (new work
            # wakes the loop at once).
            sleep_s = cycle_s
        backoff_s = self.config.idle_backoff_ms / 1000.0
        if backoff_s > 0 and self._idle_cycles > self._IDLE_GRACE:
            ramp = cycle_s * (self._idle_cycles - self._IDLE_GRACE)
            sleep_s = max(sleep_s, min(backoff_s, ramp))
        if sleep_s > 0:
            self._wake.wait(sleep_s)
        self._wake.clear()
        return True

    def _check_stall(self, table: MessageTable, size: int) -> None:
        """Periodic coordinator-side stall scan; past the shutdown
        threshold it aborts the world, blaming the lowest rank missing
        from the oldest stalled tensor."""
        if not self._stall.should_check() or not self._stall.check(table):
            return
        origin, note = -1, ""
        pending = sorted(table.pending(), key=lambda p: -p[1])
        if pending:
            name, _, reported = pending[0]
            missing = [r for r in range(size) if r not in set(reported)]
            if missing:
                origin = min(missing)
                note = (f" (tensor '{name}' never submitted by ranks "
                        f"{missing})")
        cause = (f"stall shutdown threshold "
                 f"({self._stall.shutdown_time:g}s) exceeded: one or more "
                 f"tensors were never submitted by every rank (see "
                 f"coordinator stall warnings for names and missing "
                 f"ranks){note}")
        raise WorldAbortedError(world_abort_message(origin, cause),
                                origin_rank=origin, cause=cause)

    def _coordinate(self, req_lists: List[RequestList]) -> ResponseList:
        """Coordinator half of the cycle."""
        table = self._message_table
        size = self.controller.size
        shutdown = False
        for rl in req_lists:
            shutdown = shutdown or rl.shutdown
            for req in rl.requests:
                self._dtypes[req.tensor_name] = req.tensor_type
                numel = 1
                for d in req.tensor_shape[1:]:
                    numel *= d
                self._slice_numels[req.tensor_name] = numel
                table.increment_tensor_count(req, size, self.timeline)
        responses = []
        for name in table.pop_ready():
            responses.append(construct_response(table, name, size))
            self.timeline.negotiate_end(name)
        fused = fuse_responses(responses, self._dtypes,
                               self.config.fusion_threshold_bytes,
                               self._slice_numels)
        for resp in fused:
            for n in resp.tensor_names:
                self._dtypes.pop(n, None)
                self._slice_numels.pop(n, None)
        self._check_stall(table, size)
        return ResponseList(fused, shutdown=shutdown)

    def _perform_operations(self, resp_list: ResponseList) -> None:
        """Run each agreed response and fire the callbacks."""
        timeline = self.timeline
        for response in resp_list.responses:
            entries = self.tensor_table.pop_entries(response.tensor_names)
            if response.response_type == ResponseType.ERROR:
                for e in entries:
                    if e.callback:
                        e.callback(Status.PreconditionError(
                            response.error_message))
                continue
            if not entries and \
                    response.response_type != ResponseType.BARRIER:
                continue
            self.stats["responses"] += 1
            self.stats["tensors"] += len(entries)
            names = [e.tensor_name for e in entries]
            op_name = response.response_type.name
            for name in names:
                timeline.start(name, op_name)
            # The QUEUE activity marks the handoff between negotiation
            # and execution; the wait on each CUDA tensor's ready event
            # is queued on the plane's stream, not waited for here.
            timeline.activity_start_all(names, ACT_QUEUE)
            timeline.activity_end_all(names)
            timeline.activity_start_all(names, ACT_COLLECTIVE)
            try:
                status = self.op_manager.execute(entries, response)
            except WorldAbortedError as e:
                # The channel died mid-collective: fail this batch with
                # the structured status, then let the loop abort.
                for en in entries:
                    if en.callback:
                        en.callback(Status.WorldAborted(e.origin_rank,
                                                        e.cause))
                raise
            except (ConnectionError, OSError, TimeoutError) as e:
                rank = self.controller.rank
                cause = (f"data-plane failure during {op_name} on rank "
                         f"{rank}: {e}")
                for en in entries:
                    if en.callback:
                        en.callback(Status.WorldAborted(rank, cause))
                raise WorldAbortedError(world_abort_message(rank, cause),
                                        origin_rank=rank, cause=cause) from e
            except Exception as e:
                status = Status.UnknownError(
                    f"collective execution failed: {e!r}")
            timeline.activity_end_all(names)
            for name in names:
                timeline.end(name)
            for e in entries:
                if e.callback:
                    e.callback(status)
