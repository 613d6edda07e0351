"""Control-plane controllers: how ranks exchange request and response
lists, and the socket data plane's payloads.

Counterpart of ``horovod_tpu/common/controller.py``: ``Controller``
(:806), ``LocalController`` (:1026), and the flat-topology
``TcpCoordinator`` (:1070) and ``TcpWorker`` (:1855). Each cycle the
workers send their serialized RequestList to rank 0 and receive the
fused ResponseList from it, over persistent HMAC'd TCP connections
opened by a handshake that also shares every rank's hostname, from which
each rank derives the same local/cross topology. Frames carry the
reference's tags.

The fail-fast liveness layer (:78-79, :123-227): every channel is armed
with the heartbeat deadline (``Channel.arm``), so a recv gives up after
``HOROVOD_HEARTBEAT_TIMEOUT`` seconds of silence from its peer. Any frame
proves that its sender is alive. While the coordinator waits on a
straggler it PINGs the other workers, and a PING is absorbed wherever a
frame is received, data receives included. A rank that sees a failure
fans an ABORT naming the origin rank to every peer it can reach; a rank
that receives one raises ``WorldAbortedError`` naming that origin. A
worker also PINGs its coordinator while its loop waits on the card
(``keepalive``), which the reference's coordinator absorbs alike.

The observability planes (:80-85, :806-900, :1370-1500, :2040-2180):
METRICS and TRACE frames flow upward out of band and are absorbed
wherever a frame is received, like a PING: the coordinator hands them
to the runtime's sinks (``metrics_sink``, ``trace_sink``; dropped
without one). ``attach_trace`` arms the clock exchange (every
coordinator PING's send time is kept as t1, and a worker notes the
receipt of each as t2 for its next TRACE frame) and, on the coordinator,
the arrival stamps of every request gather. ``attach_metrics`` counts
the control bytes. The hierarchical control plane and its relays of
these frames, and the native fan-out, wait for their slices
(``ROADMAP.md`` A6.3, A6.10).
"""

from __future__ import annotations

import json
import select
import socket
import time
from typing import Dict, List, Optional

from horovod_tpu_torch.common import config as hconfig
from horovod_tpu_torch.common import heartbeat
from horovod_tpu_torch.common import logging as hlog
from horovod_tpu_torch.common import network
from horovod_tpu_torch.common import trace as htrace
from horovod_tpu_torch.common.metrics import NOOP_METRIC
from horovod_tpu_torch.common.status import (
    WorldAbortedError, world_abort_message,
)

# Frame tags on the controller channel (the reference's :74-77).
TAG_HANDSHAKE = 1
TAG_REQUESTS = 2    # worker -> coordinator: a cycle-request frame
TAG_RESPONSES = 3   # coordinator -> worker: a cycle-response frame
TAG_DATA = 4        # data-plane payload of the socket backend
TAG_PING = 5        # liveness beacon (heartbeat.encode_ping)
TAG_ABORT = 6       # world abort notice (heartbeat.encode_abort)
TAG_METRICS = 7     # upward metrics snapshot (wire.*_metrics_frame), out
                    # of band like a PING: absorbed wherever a control
                    # frame is awaited, never negotiated
TAG_TRACE = 8       # upward span batch (wire.*_trace_frame), out of band
                    # like METRICS; carries the worker's clock echo


def _my_hostname() -> str:
    """Hostname for topology grouping; ``HOROVOD_HOSTNAME`` overrides
    it (containers, or tests that fake several hosts on one)."""
    return hconfig.env_str("HOROVOD_HOSTNAME") or socket.gethostname()


def host_groups(hostnames: List[str]):
    """Group ranks by hostname in first-seen host order: (hosts,
    members) with ``members[i]`` the ascending ranks on ``hosts[i]``."""
    hosts: List[str] = []
    for h in hostnames:
        if h not in hosts:
            hosts.append(h)
    members = [[r for r in range(len(hostnames)) if hostnames[r] == h]
               for h in hosts]
    return hosts, members


class Topology:
    """World, local and cross identity of this process."""

    __slots__ = ("rank", "size", "local_rank", "local_size",
                 "cross_rank", "cross_size", "is_homogeneous")

    def __init__(self, rank: int, size: int, local_rank: int = 0,
                 local_size: int = 1, cross_rank: int = 0,
                 cross_size: int = 1, is_homogeneous: bool = True):
        self.rank = rank
        self.size = size
        self.local_rank = local_rank
        self.local_size = local_size
        self.cross_rank = cross_rank
        self.cross_size = cross_size
        self.is_homogeneous = is_homogeneous


def compute_topology(rank: int, hostnames: List[str]) -> Topology:
    """Ranks grouped by hostname -> the local/cross shape."""
    hosts, members = host_groups(hostnames)
    cross_rank = hosts.index(hostnames[rank])
    local_ranks = members[cross_rank]
    sizes = [len(ms) for ms in members]
    return Topology(rank=rank, size=len(hostnames),
                    local_rank=local_ranks.index(rank),
                    local_size=len(local_ranks), cross_rank=cross_rank,
                    cross_size=len(hosts),
                    is_homogeneous=all(s == sizes[0] for s in sizes))


def _dead_peers(channels: Dict[int, network.Channel]) -> List[int]:
    """Ranks whose socket has hung up, errored or was closed here,
    probed without blocking (failure paths only: it names the peer
    behind an anonymous transport error)."""
    dead: List[int] = []
    for r, ch in channels.items():
        try:
            fd = ch.sock.fileno()
        except OSError:
            fd = -1
        if fd < 0:
            # Closed here (an injected sever): dead by definition.
            dead.append(r)
            continue
        try:
            p = select.poll()
            p.register(fd, select.POLLIN)
            events = p.poll(0)
            if not events:
                continue
            mask = events[0][1]
            if mask & (select.POLLHUP | select.POLLERR | select.POLLNVAL) \
                    or ch.sock.recv(1, socket.MSG_PEEK) == b"":
                dead.append(r)
        except (OSError, ValueError):
            dead.append(r)
    return dead


def _abort_error(origin: int, cause: str,
                 resolved: bool = False) -> WorldAbortedError:
    """``resolved`` marks a notice decoded off the wire: the runtime then
    takes its origin as it is instead of sweeping the channels for a
    better one."""
    err = WorldAbortedError(world_abort_message(origin, cause),
                            origin_rank=origin, cause=cause)
    err.resolved = resolved
    return err


def _raise_if_abort(tag: int, data) -> None:
    """An ABORT frame raises its notice as the resolved origin."""
    if tag == TAG_ABORT:
        origin, cause = heartbeat.decode_abort(data)
        raise _abort_error(origin, cause, resolved=True)


def _drain_abort(channels: Dict[int, network.Channel],
                 grace_s: float) -> Optional[tuple]:
    """Sweep the channels for an ABORT notice that is queued or arrives
    within ``grace_s``: (origin, cause), else None. A blame inferred
    from a transport error can race the notice of the rank that found
    the failure, whose teardown closes channels that peers then see as
    a second failure; deferring to the notice makes the world agree on
    one origin. Failure paths only; other frames found are dropped (the
    world is already dead)."""
    deadline = time.monotonic() + grace_s
    while True:
        for ch in channels.values():
            # Past the channel's liveness slicing: 50 ms per read keeps
            # the sweep prompt over a frame a dying peer left partial.
            prev_hb, ch._hb = ch._hb, None
            try:
                prev_to = ch.sock.gettimeout()
                ch.sock.settimeout(0.05)
                try:
                    p = select.poll()
                    p.register(ch.sock.fileno(), select.POLLIN)
                    while p.poll(0):
                        tag, data = ch.recv()
                        if tag == TAG_ABORT:
                            return heartbeat.decode_abort(data)
                finally:
                    ch.sock.settimeout(prev_to)
            except (OSError, ValueError):
                pass  # a dead or garbled channel: nothing to learn
            finally:
                ch._hb = prev_hb
        if time.monotonic() >= deadline:
            return None
        time.sleep(0.02)


def _maybe_ping(ctl, channels: Dict[int, network.Channel],
                sender_rank: int) -> None:
    """PING ``channels``, at most once per ping interval; send failures
    are left to the recv and abort paths, which report them."""
    now = time.monotonic()
    if now - ctl._last_ping < _ping_interval(ctl._hb_timeout,
                                            ctl._hb_interval):
        return
    ctl._last_ping = now
    ctl._ping_seq += 1
    if sender_rank == 0:
        # The clock exchange's t1: the coordinator's clock is the world's
        # reference, so only its PINGs are kept (trace.ClockSync).
        htrace.clock().ping_sent(ctl._ping_seq, now)
    payload = heartbeat.encode_ping(sender_rank, ctl._ping_seq)
    for ch in channels.values():
        try:
            ch.send(payload, TAG_PING)
        except OSError:
            pass


def _hb_normalized(timeout_s: float, interval_s: float) -> tuple:
    """(timeout_s, interval_s) with the interval clamped into (0,
    timeout/2], the normalization ``Channel.arm`` applies."""
    half = timeout_s / 2.0
    interval_s = min(interval_s, half) if interval_s > 0 else half
    return timeout_s, interval_s


def _ping_interval(timeout_s: float, interval_s: float) -> float:
    """The PING gate beacons at least twice per deadline window whatever
    the configured interval: gating on an interval at or past the
    timeout would starve the waiting receivers and abort a healthy
    world."""
    return _hb_normalized(timeout_s, interval_s)[1]


def _accept_handshakes(server, secret: bytes, deadline: float,
                       timeout_msg, validate):
    """Accept, handshake and validate peers until the caller stops
    iterating. A stray probe, a garbage frame or a peer dying in the
    handshake is rejected without ending start-up. ``validate(hello) ->
    rank`` raises to reject. Yields (rank, hello, channel)."""
    server.settimeout(1.0)
    while True:
        if time.monotonic() > deadline:
            raise TimeoutError(timeout_msg())
        try:
            sock, _ = server.accept()
        except socket.timeout:
            continue
        try:
            sock.settimeout(5.0)
            ch = network.Channel(sock, secret)
            tag, payload = ch.recv()
            if tag != TAG_HANDSHAKE:
                raise ConnectionError(f"unexpected tag {tag}")
            hello = json.loads(payload.decode())
            r = validate(hello)
        except (ConnectionError, socket.timeout, ValueError,
                KeyError, TypeError, UnicodeDecodeError) as e:
            hlog.warning(f"rejected connection during startup: {e}")
            sock.close()
            continue
        sock.settimeout(None)
        yield r, hello, ch


class Controller:
    """Abstract control plane. The data-plane primitives must be called
    at the same negotiated response on every rank."""

    topology: Topology

    # -- the observability planes ----------------------------------------
    # Rank 0's sinks for METRICS and TRACE frames: callable(rank,
    # payload), set by the runtime once its aggregator or trace writer
    # exists; without one a frame is absorbed and dropped, so that a rank
    # with a plane on never hurts a coordinator with it off.
    metrics_sink = None
    trace_sink = None
    # Set by attach_trace: a worker notes coordinator PINGs for the clock
    # echo; the coordinator calls _on_arrivals({rank: monotonic stamp})
    # at every request gather (None keeps the gather free of clock reads).
    _trace_on = False
    _on_arrivals = None
    # Control-plane byte counters (attach_metrics); no-ops while off.
    _m_ctrl_rx = NOOP_METRIC
    _m_ctrl_tx = NOOP_METRIC
    _metrics_on = False

    def attach_trace(self, on_arrivals=None) -> None:
        """Arm the trace plane's hooks: PING noting for the clock echo
        and, on the coordinator, the gathers' arrival stamps."""
        self._trace_on = True
        if on_arrivals is not None:
            self._on_arrivals = on_arrivals

    def attach_metrics(self, registry) -> None:
        """The control-plane byte counters, from the runtime's registry
        (the disabled one hands back no-ops)."""
        self._m_ctrl_rx = registry.counter(
            'hvd_control_bytes_total{direction="rx"}',
            "control-plane bytes received by this rank")
        self._m_ctrl_tx = registry.counter(
            'hvd_control_bytes_total{direction="tx"}',
            "control-plane bytes sent by this rank")
        self._metrics_on = bool(registry.enabled)

    def send_metrics(self, payload: bytes) -> None:
        """Best-effort upward METRICS frame (workers). Never raises: a
        dead channel is the cycle path's to report."""

    def send_trace(self, payload: bytes) -> None:
        """Best-effort upward TRACE frame (workers). Never raises."""

    def _on_oob(self, r: int, tag: int, data) -> None:
        """A METRICS or TRACE frame from rank ``r``: to its sink."""
        sink = self.metrics_sink if tag == TAG_METRICS else self.trace_sink
        if sink is not None:
            sink(r, bytes(data))

    @property
    def rank(self) -> int:
        return self.topology.rank

    @property
    def size(self) -> int:
        return self.topology.size

    @property
    def is_coordinator(self) -> bool:
        return self.rank == 0

    def gather_requests(self, payload: bytes) -> Optional[List[bytes]]:
        """Coordinator: every rank's cycle-request frame (index = rank),
        its own included. Workers: send ``payload``; return None. A
        payload may be a list of buffers, the frame's bytes in order."""
        raise NotImplementedError

    def broadcast_responses(self, payload: Optional[bytes]) -> bytes:
        """The coordinator passes the cycle-response frame, workers
        None; everyone returns the broadcast bytes."""
        raise NotImplementedError

    def gather_data(self, payload) -> Optional[List[bytes]]:
        raise NotImplementedError

    def broadcast_data(self, payload, root_rank: int = 0) -> bytes:
        raise NotImplementedError

    def scatter_data(self, payloads) -> bytes:
        """The coordinator passes one payload per rank; every rank
        returns its own."""
        raise NotImplementedError

    def gather_data_into(self, payload, outs) -> Optional[List[int]]:
        """Workers send ``payload`` and return None; the coordinator
        receives rank r's payload into ``outs[r]`` (r >= 1) and returns
        the byte counts."""
        raise NotImplementedError

    def broadcast_data_into(self, payload, out, root_rank: int = 0) -> int:
        """The root sends ``payload``; every other rank receives into
        ``out``. Returns the byte count."""
        raise NotImplementedError

    def scatter_data_into(self, payloads, out) -> int:
        """The coordinator sends one payload per rank (its own stays
        local); workers receive theirs into ``out``."""
        raise NotImplementedError

    def agree(self, local_flag: bool) -> bool:
        """World-wide AND of a per-rank flag over the data channel
        (reference ``horovod_tpu/common/controller.py:987-1000``). A
        backend's enablement must be the same on every rank, or some
        ranks enter its collective while others wait in the star; the
        callers reach this at the same point of the response stream on
        every rank, which is when ``CollectiveBackend.enabled`` runs."""
        gathered = self.gather_data(b"\x01" if local_flag else b"\x00")
        if gathered is not None:  # coordinator
            ok = all(g == b"\x01" for g in gathered)
            return self.broadcast_data(
                b"\x01" if ok else b"\x00") == b"\x01"
        return self.broadcast_data(None) == b"\x01"

    # -- liveness and the world abort (no-ops without peers) -------------
    def keepalive(self) -> None:
        """Beacon to the peers that wait on this rank while its loop is
        busy elsewhere (a wait on the card): rate-limited PINGs."""

    def abort(self, origin_rank: int, cause: str) -> None:
        """Fan an ABORT naming ``origin_rank`` to every reachable peer."""

    def sever_connection(self, target_rank: Optional[int] = None) -> None:
        """Close this rank's channel(s) (fault injection's ``sever``)."""

    def drain_abort_notice(self, grace_s: float = 0.0) -> Optional[tuple]:
        """An ABORT notice queued on the channels: (origin, cause)."""
        return None

    def peer_heartbeat_ages(self) -> Dict[int, float]:
        """Seconds since the last frame from each peer."""
        return {}

    def close(self) -> None:
        pass


def _nbytes(payload) -> int:
    """The bytes of a frame given whole or as a list of buffers."""
    if isinstance(payload, list):
        return sum(len(network.as_byte_view(p)) for p in payload)
    return len(network.as_byte_view(payload))


def _frame(payload):
    """A frame given as a list of buffers (``network.Channel.send``),
    joined: the coordinator parses its own frame with the others."""
    if isinstance(payload, list):
        return bytearray().join(network.as_byte_view(p) for p in payload)
    return payload


class LocalController(Controller):
    """Size-1 world: negotiation is immediate."""

    def __init__(self):
        self.topology = Topology(rank=0, size=1)

    def gather_requests(self, payload: bytes) -> Optional[List[bytes]]:
        return [_frame(payload)]

    def broadcast_responses(self, payload: Optional[bytes]) -> bytes:
        return payload

    def gather_data(self, payload) -> Optional[List[bytes]]:
        return [payload]

    def broadcast_data(self, payload, root_rank: int = 0) -> bytes:
        return payload


class TcpCoordinator(Controller):
    """Rank 0: one persistent connection per worker (flat star)."""

    def __init__(self, size: int, port: int = 0, secret: bytes = b"",
                 start_timeout: float = 30.0,
                 heartbeat_interval: float = 5.0,
                 heartbeat_timeout: float = 30.0):
        self._secret = secret
        self._server = network.listen(port)
        self.port = self._server.getsockname()[1]
        self._channels: Dict[int, network.Channel] = {}
        self._size = size
        self._start_timeout = start_timeout
        self._hb_interval = heartbeat_interval
        self._hb_timeout = heartbeat_timeout
        self._ping_seq = 0
        self._last_ping = 0.0
        # rank -> monotonic time of its last frame (peer_heartbeat_ages)
        self._last_seen: Dict[int, float] = {}
        self.topology = None  # set by accept_workers

    def accept_workers(self) -> None:
        """Accept every worker, send each the hostname list, and arm the
        channels with the heartbeat deadline."""
        deadline = time.monotonic() + self._start_timeout
        hostnames = [None] * self._size
        hostnames[0] = _my_hostname()

        def _validate(hello):
            r = int(hello["rank"])
            if r <= 0 or r >= self._size or r in self._channels:
                raise ConnectionError(f"bad or duplicate rank {r}")
            hello["hostname"]  # reject (KeyError) if absent
            return r

        accepts = _accept_handshakes(
            self._server, self._secret, deadline,
            lambda: (f"Only {len(self._channels) + 1}/{self._size} ranks "
                     f"connected within start timeout; increase "
                     f"HOROVOD_START_TIMEOUT if startup is slow."),
            _validate)
        while len(self._channels) < self._size - 1:
            r, hello, ch = next(accepts)
            hostnames[r] = hello["hostname"]
            ch.peer = f"rank {r} ({ch.peer})"
            self._channels[r] = ch
        self._server.close()
        self.topology = compute_topology(0, hostnames)
        blob = json.dumps({"hostnames": hostnames, "hier": False}).encode()
        now = time.monotonic()
        for r, ch in self._channels.items():
            ch.send(blob, TAG_HANDSHAKE)
            self._last_seen[r] = now
        if self._hb_timeout and self._hb_timeout > 0:
            for ch in self._channels.values():
                ch.arm(self._hb_timeout, self._hb_interval,
                       on_idle=self._ping_peers)

    def _ping_peers(self) -> None:
        """Run at each idle slice of a recv: tell every worker the world
        is alive (the straggler this rank waits on is silent to them too,
        and their deadlines would fire on a merely slow peer)."""
        _maybe_ping(self, self._channels, 0)

    keepalive = _ping_peers

    def peer_heartbeat_ages(self) -> Dict[int, float]:
        now = time.monotonic()
        return {r: now - t for r, t in list(self._last_seen.items())}

    def _recv_ctrl(self, r: int, expect_tag: int) -> bytes:
        """One frame from rank ``r``: PINGs are skipped, an ABORT raises
        the structured error, transport failures name the peer."""
        ch = self._channels[r]
        while True:
            try:
                tag, data = ch.recv()
            except (ConnectionError, OSError) as e:
                raise _abort_error(
                    r, f"control channel to {ch.peer} failed: {e}") from e
            self._last_seen[r] = time.monotonic()
            if tag in (TAG_PING, TAG_ABORT):
                _raise_if_abort(tag, data)  # a PING: proof of life only
                continue
            if tag in (TAG_METRICS, TAG_TRACE):
                self._on_oob(r, tag, data)
                continue
            if tag != expect_tag:
                raise ConnectionError(f"expected tag {expect_tag} from rank "
                                      f"{r}, got {tag}")
            return data

    def _recv_data_into(self, r: int, out) -> int:
        """One data frame from rank ``r`` straight into ``out``; an
        out-of-band frame lands in ``out`` too (or spills when larger)
        and is absorbed."""
        ch = self._channels[r]
        view = memoryview(network.as_byte_view(out))
        while True:
            try:
                tag, n, spill = ch.recv_into_spill(view)
            except (ConnectionError, OSError) as e:
                raise _abort_error(
                    r, f"control channel to {ch.peer} failed: {e}") from e
            self._last_seen[r] = time.monotonic()
            if tag in (TAG_PING, TAG_ABORT, TAG_METRICS, TAG_TRACE):
                data = spill if spill is not None else bytes(view[:n])
                if tag in (TAG_METRICS, TAG_TRACE):
                    self._on_oob(r, tag, data)
                _raise_if_abort(tag, data)
                continue
            if tag != TAG_DATA:
                raise ConnectionError(f"expected tag {TAG_DATA} from rank "
                                      f"{r}, got {tag}")
            if spill is not None:
                raise ConnectionError(f"data frame of {n} bytes from rank "
                                      f"{r} overflows its buffer")
            return n

    def _raise_transport(self, e: Exception) -> None:
        """An anonymous transport error as a WorldAbortedError naming the
        dead peer when one can be found."""
        dead = _dead_peers(self._channels)
        if dead:
            raise _abort_error(
                dead[0], f"connection to rank {dead[0]} lost: {e}") from e
        raise _abort_error(0, f"coordinator transport failure: {e}") from e

    def _send_all(self, payload, tag: int, exclude: int = -1) -> None:
        try:
            for r, ch in self._channels.items():
                if r != exclude:
                    ch.send(payload, tag)
        except (ConnectionError, OSError) as e:
            self._raise_transport(e)

    def _gather_frames(self, payload, expect_tag: int) -> List[bytes]:
        """One frame per worker, rank-indexed, this rank's own at 0. On a
        request gather with the trace plane's hook armed, each rank's
        arrival is stamped as its recv returns (this rank's own at the
        start, the baseline of every lag) and handed to the hook."""
        out = [payload] + [b""] * (self._size - 1)
        on_arrivals = self._on_arrivals
        track = expect_tag == TAG_REQUESTS and on_arrivals is not None
        arrivals = {0: time.monotonic()} if track else None
        for r in self._channels:
            out[r] = self._recv_ctrl(r, expect_tag)
            if track:
                arrivals[r] = time.monotonic()
        if self._metrics_on:
            self._m_ctrl_rx.inc(sum(len(out[r]) for r in self._channels))
        if track:
            on_arrivals(arrivals)
        return out

    def gather_requests(self, payload: bytes) -> Optional[List[bytes]]:
        return self._gather_frames(_frame(payload), TAG_REQUESTS)

    def broadcast_responses(self, payload: Optional[bytes]) -> bytes:
        self._send_all(payload, TAG_RESPONSES)
        if self._metrics_on:
            self._m_ctrl_tx.inc(_nbytes(payload) * len(self._channels))
        return payload

    def gather_data(self, payload) -> Optional[List[bytes]]:
        return self._gather_frames(payload, TAG_DATA)

    def broadcast_data(self, payload, root_rank: int = 0) -> bytes:
        if root_rank != 0:
            payload = self._recv_ctrl(root_rank, TAG_DATA)
        self._send_all(payload, TAG_DATA, exclude=root_rank)
        return payload

    def scatter_data(self, payloads) -> bytes:
        try:
            for r, ch in self._channels.items():
                ch.send(payloads[r], TAG_DATA)
        except (ConnectionError, OSError) as e:
            self._raise_transport(e)
        return payloads[0]

    def gather_data_into(self, payload, outs) -> Optional[List[int]]:
        lens = [len(network.as_byte_view(payload))] + [0] * (self._size - 1)
        for r in self._channels:
            lens[r] = self._recv_data_into(r, outs[r])
        return lens

    def broadcast_data_into(self, payload, out, root_rank: int = 0) -> int:
        if root_rank == 0:
            self._send_all(payload, TAG_DATA)
            return len(network.as_byte_view(payload))
        n = self._recv_data_into(root_rank, out)
        self._send_all(network.as_byte_view(out)[:n], TAG_DATA,
                       exclude=root_rank)
        return n

    def scatter_data_into(self, payloads, out) -> int:
        self.scatter_data(payloads)
        return len(network.as_byte_view(payloads[0]))

    def abort(self, origin_rank: int, cause: str) -> None:
        payload = heartbeat.encode_abort(origin_rank, cause)
        for ch in self._channels.values():
            try:
                ch.send(payload, TAG_ABORT)
            except Exception:
                pass  # that peer is already gone

    def sever_connection(self, target_rank: Optional[int] = None) -> None:
        if target_rank is not None:
            ch = self._channels.get(target_rank)
            if ch is not None:
                ch.close()
            return
        for ch in self._channels.values():
            ch.close()

    def drain_abort_notice(self, grace_s: float = 0.0) -> Optional[tuple]:
        return _drain_abort(self._channels, grace_s)

    def close(self) -> None:
        for ch in self._channels.values():
            try:
                ch.close()
            except OSError:
                pass  # the others must still close


class TcpWorker(Controller):
    """Ranks 1..size-1: one persistent connection to the coordinator."""

    def __init__(self, rank: int, size: int, addr: str, port: int,
                 secret: bytes = b"", start_timeout: float = 30.0,
                 heartbeat_interval: float = 5.0,
                 heartbeat_timeout: float = 30.0):
        self._hb_interval = heartbeat_interval
        self._hb_timeout = heartbeat_timeout
        self._ping_seq = 0
        self._last_ping = 0.0
        self._ch = network.connect(addr, port, secret,
                                   timeout=start_timeout,
                                   retry_deadline=start_timeout)
        self._ch.peer = f"coordinator ({self._ch.peer})"
        hello = {"rank": rank, "hostname": _my_hostname()}
        self._ch.send(json.dumps(hello).encode(), TAG_HANDSHAKE)
        tag, payload = self._ch.recv()
        if tag != TAG_HANDSHAKE:
            raise ConnectionError("handshake failed")
        info = json.loads(payload.decode())
        self.topology = compute_topology(rank, info["hostnames"])
        self._up_seen = time.monotonic()
        # (sender, sequence) of the last PING from the coordinator
        self.last_ping: Optional[tuple] = None
        if self._hb_timeout and self._hb_timeout > 0:
            self._ch.arm(self._hb_timeout, self._hb_interval)

    def _fail(self, e: Exception) -> WorldAbortedError:
        return _abort_error(
            0, f"control channel to {self._ch.peer} failed: {e}")

    def keepalive(self) -> None:
        if self._hb_timeout and self._hb_timeout > 0:
            _maybe_ping(self, {0: self._ch}, self.rank)

    def peer_heartbeat_ages(self) -> Dict[int, float]:
        return {0: time.monotonic() - self._up_seen}

    def _note_ping(self, data) -> None:
        """A coordinator PING: liveness whatever its bytes say; a well
        formed one is kept as ``last_ping`` and, with the trace plane
        armed, its receipt is the clock exchange's t2."""
        t2 = time.monotonic()
        try:
            self.last_ping = heartbeat.decode_ping(bytes(data))
        except ValueError:
            return
        if self._trace_on:
            htrace.clock().ping_received(*self.last_ping, t2)

    def send_metrics(self, payload: bytes) -> None:
        try:
            self._ch.send(payload, TAG_METRICS)
            if self._metrics_on:
                self._m_ctrl_tx.inc(len(payload))
        except Exception:
            pass  # best effort: the cycle path reports a dead channel

    def send_trace(self, payload: bytes) -> None:
        try:
            self._ch.send(payload, TAG_TRACE)
            if self._metrics_on:
                self._m_ctrl_tx.inc(len(payload))
        except Exception:
            pass  # best effort, like send_metrics

    def _send(self, payload, tag: int) -> None:
        try:
            self._ch.send(payload, tag)
        except (ConnectionError, OSError) as e:
            raise self._fail(e) from e

    def _recv_up(self, expect_tag: int) -> bytes:
        """One frame from the coordinator. PINGs prove the world alive,
        an ABORT raises its notice, and silence past the deadline or a
        dead socket names the coordinator as the origin."""
        while True:
            try:
                tag, data = self._ch.recv()
            except (ConnectionError, OSError) as e:
                raise self._fail(e) from e
            self._up_seen = time.monotonic()
            if tag == TAG_PING:
                self._note_ping(data)
                continue
            if tag in (TAG_METRICS, TAG_TRACE):
                continue  # these only flow upward; a stray is dropped
            _raise_if_abort(tag, data)
            if tag != expect_tag:
                raise ConnectionError(f"expected tag {expect_tag} from "
                                      f"{self._ch.peer}, got {tag}")
            if self._metrics_on:
                self._m_ctrl_rx.inc(len(data))
            return data

    def _recv_up_into(self, out) -> int:
        """The recv-into mirror of :meth:`_recv_up`: the payload lands in
        ``out``; an out-of-band frame larger than ``out`` spills."""
        view = memoryview(network.as_byte_view(out))
        while True:
            try:
                tag, n, spill = self._ch.recv_into_spill(view)
            except (ConnectionError, OSError) as e:
                raise self._fail(e) from e
            self._up_seen = time.monotonic()
            if tag in (TAG_METRICS, TAG_TRACE):
                continue  # a stray downward frame is dropped
            if tag in (TAG_PING, TAG_ABORT):
                data = spill if spill is not None else bytes(view[:n])
                if tag == TAG_PING:
                    self._note_ping(data)
                    continue
                _raise_if_abort(tag, data)
            if tag != TAG_DATA or spill is not None:
                raise ConnectionError(f"expected a data frame that fits its "
                                      f"buffer from {self._ch.peer}, got tag "
                                      f"{tag} of {n} bytes")
            return n

    def gather_requests(self, payload: bytes) -> Optional[List[bytes]]:
        self._send(payload, TAG_REQUESTS)
        if self._metrics_on:
            self._m_ctrl_tx.inc(_nbytes(payload))
        return None

    def broadcast_responses(self, payload: Optional[bytes]) -> bytes:
        return self._recv_up(TAG_RESPONSES)

    def gather_data(self, payload) -> Optional[List[bytes]]:
        self._send(payload, TAG_DATA)
        return None

    def broadcast_data(self, payload, root_rank: int = 0) -> bytes:
        if self.rank == root_rank:
            self._send(payload, TAG_DATA)
            return payload
        return self._recv_up(TAG_DATA)

    def scatter_data(self, payloads) -> bytes:
        return self._recv_up(TAG_DATA)

    def gather_data_into(self, payload, outs) -> Optional[List[int]]:
        self._send(payload, TAG_DATA)
        return None

    def broadcast_data_into(self, payload, out, root_rank: int = 0) -> int:
        if self.rank == root_rank:
            self._send(payload, TAG_DATA)
            return len(network.as_byte_view(payload))
        return self._recv_up_into(out)

    def scatter_data_into(self, payloads, out) -> int:
        return self._recv_up_into(out)

    def abort(self, origin_rank: int, cause: str) -> None:
        try:
            self._ch.send(heartbeat.encode_abort(origin_rank, cause),
                          TAG_ABORT)  # up to the coordinator
        except Exception:
            pass

    def sever_connection(self, target_rank: Optional[int] = None) -> None:
        self._ch.close()

    def drain_abort_notice(self, grace_s: float = 0.0) -> Optional[tuple]:
        return _drain_abort({0: self._ch}, grace_s)

    def close(self) -> None:
        self._ch.close()
