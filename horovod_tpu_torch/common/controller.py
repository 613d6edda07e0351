"""Control-plane controllers: how ranks exchange request and response
lists, and the socket data plane's payloads.

Counterpart of ``horovod_tpu/common/controller.py``: ``Controller``
(:806), ``LocalController`` (:1026), ``TcpCoordinator`` (:1070) and
``TcpWorker`` (:1855). Each cycle the workers send their serialized
RequestList to rank 0 and receive the fused ResponseList from it, over
persistent HMAC'd TCP connections opened by a handshake that also shares
every rank's hostname, from which each rank derives the same local/cross
topology. Frames carry the reference's tags.

The hierarchical control plane (:46-52, :229-280, :1147-1362,
:1967-2352), on by default as in the reference
(``HOROVOD_TPU_HIER_CONTROLLER``): when the world spans several hosts and
a remote host runs more than one rank, that host's lowest rank becomes
its LOCAL ROOT. It keeps its channel to the coordinator and accepts its
host's other ranks (the leaves) on a listener of its own; the leaves
drop their coordinator channel after the handshake and talk only to it.
The coordinator then holds one channel per host-0 worker and one per
remote host, so its per-cycle fan-in scales with hosts, not ranks. A
local root relays every primitive store-and-forward: upward it sends its
host's frames as one (a host's cache bitmask frames folded into one
CACHED_AGG frame, any other mix packed under the PACKED envelope, data
frames packed with ``pack_frames``), downward it forwards what it
receives, and it relays PINGs and ABORTs to its leaves. The reference's
cut-through relay and native fan-out wait for the native core (A6.10).

The fail-fast liveness layer (:78-79, :123-227): every channel is armed
with the heartbeat deadline (``Channel.arm``), so a recv gives up after
``HOROVOD_HEARTBEAT_TIMEOUT`` seconds of silence from its peer. Any frame
proves that its sender is alive. While the coordinator waits on a
straggler it PINGs the other workers, and a PING is absorbed wherever a
frame is received, data receives included. A rank that sees a failure
fans an ABORT naming the origin rank to every peer it can reach; a rank
that receives one raises ``WorldAbortedError`` naming that origin. A
worker also PINGs its upward peer (and a local root its leaves) while its
loop waits on the card (``keepalive``), which the reference's coordinator
absorbs alike; a local root passes a leaf's PINGs on upward.

The observability planes (:80-85, :806-900, :1370-1500, :2040-2180):
METRICS and TRACE frames flow upward out of band and are absorbed
wherever a frame is received, like a PING: the coordinator hands them
to the runtime's sinks (``metrics_sink``, ``trace_sink``; dropped
without one), keyed by the channel's owner. A local root keeps its
leaves' latest METRICS frame and every TRACE frame, and folds them into
its own next frame (``wire.combine_metrics_frames``,
``wire.combine_trace_frames``). ``attach_trace`` arms the clock exchange
(every coordinator PING's send time is kept as t1, and a worker notes the
receipt of each as t2 for its next TRACE frame) and, on the coordinator,
the arrival stamps of every request gather. ``attach_metrics`` counts
the control bytes.
"""

from __future__ import annotations

import ipaddress
import json
import select
import socket
import struct
import time
from typing import Dict, List, Optional

from horovod_tpu_torch.common import config as hconfig
from horovod_tpu_torch.common import heartbeat
from horovod_tpu_torch.common import logging as hlog
from horovod_tpu_torch.common import network
from horovod_tpu_torch.common import trace as htrace
from horovod_tpu_torch.common import wire
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


def _local_root_addr() -> str:
    """The address a host's leaves dial to reach their local root's
    listener (the root binds it too). Loopback serves ranks that share a
    network namespace; ranks in containers of their own that share only
    ``HOROVOD_HOSTNAME`` set ``HOROVOD_TPU_LOCAL_ROOT_ADDR`` to an address
    they all reach."""
    return hconfig.env_str("HOROVOD_TPU_LOCAL_ROOT_ADDR", "127.0.0.1")


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


_PACK_COUNT = struct.Struct("<I")
_PACK_LEN = struct.Struct("<Q")


def pack_frames(frames) -> bytes:
    """Several ranks' frames as one aggregate payload: ``u32 count``,
    then ``u64 length | bytes`` per frame. A local root sends its host's
    frames up as one (the reference's LOCAL-then-CROSS split on the
    control plane). A frame may be any contiguous host buffer."""
    parts = [_PACK_COUNT.pack(len(frames))]
    for f in frames:
        view = network.as_byte_view(f)
        parts.append(_PACK_LEN.pack(len(view)))
        parts.append(view)
    return b"".join(parts)


def unpack_frames(blob) -> List[bytes]:
    """The inverse of :func:`pack_frames`. A truncated or overlong
    aggregate raises ConnectionError, as every malformed control frame
    does (the relays' error handling and the blame behind it catch that
    family; a bare ``struct.error`` would escape them)."""
    try:
        (n,) = _PACK_COUNT.unpack_from(blob, 0)
        off = _PACK_COUNT.size
        out: List[bytes] = []
        for _ in range(n):
            (ln,) = _PACK_LEN.unpack_from(blob, off)
            off += _PACK_LEN.size
            if off + ln > len(blob):
                raise ConnectionError(
                    f"aggregate frame truncated: slot of {ln} bytes at "
                    f"offset {off} overruns the {len(blob)}-byte blob")
            out.append(bytes(blob[off:off + ln]))
            off += ln
    except struct.error as e:
        raise ConnectionError(
            f"aggregate frame truncated mid-header: {e}") from e
    if off != len(blob):
        raise ConnectionError(
            f"aggregate frame has {len(blob) - off} trailing bytes")
    return out


def _dialable_leaf_ip(ip: str) -> bool:
    """Whether a leaf's observed connect address is worth keeping as the
    address others dial it at. A loopback address (``::1`` as well as
    ``127.*``) means the leaf shares its root's network namespace, where
    the root channel's address answers for it; a string that does not
    parse is not kept either."""
    try:
        return not ipaddress.ip_address(ip).is_loopback
    except ValueError:
        return False


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


def _copy_into(out, data) -> int:
    """Copy the bytes of ``data`` to the front of the buffer ``out``;
    returns their count."""
    n = len(data)
    if n:
        memoryview(network.as_byte_view(out))[:n] = data
    return n


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
    """Rank 0: one persistent connection per worker (flat star), or under
    the hierarchical control plane one per host-0 worker and one per
    remote host, whose local root answers for its host's ranks."""

    def __init__(self, size: int, port: int = 0, secret: bytes = b"",
                 start_timeout: float = 30.0, hierarchical: bool = True,
                 heartbeat_interval: float = 5.0,
                 heartbeat_timeout: float = 30.0):
        """``hierarchical`` allows the per-host fold: when the world spans
        several hosts and a remote host has ranks to fold behind its
        local root, the remote leaves migrate to that root after the
        handshake, and the per-cycle fan-in becomes the host-0 workers
        plus the remote hosts (reference :1087-1099)."""
        self._secret = secret
        self._server = network.listen(port)
        self.port = self._server.getsockname()[1]
        self._channels: Dict[int, network.Channel] = {}
        self._size = size
        self._start_timeout = start_timeout
        self._hierarchical = hierarchical
        self._hb_interval = heartbeat_interval
        self._hb_timeout = heartbeat_timeout
        self._ping_seq = 0
        self._last_ping = 0.0
        # channel owner -> every rank that channel carries (ascending,
        # the owner first): itself in a flat world, a remote host's ranks
        # for its local root.
        self._members: Dict[int, List[int]] = {}
        self._owner_of: Dict[int, int] = {}
        self._has_aggregates = False
        # leaf rank -> the address it connected to its root from, where
        # that is not loopback (worker_peer_ip)
        self._peer_ip_override: Dict[int, str] = {}
        # owner -> monotonic time of its last frame (peer_heartbeat_ages)
        self._last_seen: Dict[int, float] = {}
        self.topology = None  # set by accept_workers

    def accept_workers(self) -> None:
        """Accept every worker, send each the hostname list and whether
        the world folds its hosts, set the hierarchy up, and arm the
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
        _, host_members = host_groups(hostnames)
        # The fold pays only where a remote host has leaves to put
        # behind its root (reference :1191-1194).
        remote_leaves = (self._size - len(host_members[0])
                         - (len(host_members) - 1))
        hier = (self._hierarchical and len(host_members) > 1
                and remote_leaves > 0)
        blob = json.dumps({"hostnames": hostnames, "hier": hier}).encode()
        for ch in self._channels.values():
            ch.send(blob, TAG_HANDSHAKE)
        self._members = {r: [r] for r in self._channels}
        if hier:
            self._setup_hierarchy(host_members, deadline)
        self._owner_of = {m: owner for owner, ms in self._members.items()
                          for m in ms}
        self._has_aggregates = any(len(ms) > 1
                                   for ms in self._members.values())
        now = time.monotonic()
        for r in self._channels:
            self._last_seen[r] = now
        if self._hb_timeout and self._hb_timeout > 0:
            for ch in self._channels.values():
                ch.arm(self._hb_timeout, self._hb_interval,
                       on_idle=self._ping_peers)

    def _setup_hierarchy(self, host_members: List[List[int]],
                         deadline: float) -> None:
        """Fold each remote host of more than one rank behind its local
        root (reference :1247-1298): take each root's listener port, send
        the port map to that host's leaves and drop their channels, then
        take each root's report of the addresses its leaves connected
        from. Every wait is bounded by the start deadline: a root that
        dies in the set-up fails the start, it does not hang it."""
        root_ports: Dict[str, int] = {}
        for cross, members in enumerate(host_members[1:], start=1):
            if len(members) == 1:
                continue  # a host of one rank keeps its direct channel
            root = members[0]
            data = self._recv_by(self._channels[root], deadline,
                                 f"the port report of local root {root}")
            root_ports[str(cross)] = int(json.loads(data.decode())["port"])
        map_blob = json.dumps({"roots": root_ports}).encode()
        roots: List[int] = []
        for members in host_members[1:]:
            if len(members) == 1:
                continue
            for leaf in members[1:]:
                ch = self._channels.pop(leaf)
                self._members.pop(leaf)
                ch.send(map_blob, TAG_HANDSHAKE)
                ch.close()
            self._members[members[0]] = members
            roots.append(members[0])
        for root in roots:
            data = self._recv_by(self._channels[root], deadline,
                                 f"the leaf-address report of local root "
                                 f"{root}")
            for r, ip in json.loads(data.decode())["leaf_ips"].items():
                if _dialable_leaf_ip(ip):
                    self._peer_ip_override[int(r)] = ip

    @staticmethod
    def _recv_by(ch: network.Channel, deadline: float, what: str) -> bytes:
        """One handshake frame from ``ch`` within the start deadline
        (reference :1301-1317)."""
        msg = (f"start timeout expired waiting for {what}; increase "
               f"HOROVOD_START_TIMEOUT if startup is slow.")
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            raise TimeoutError(msg)
        ch.sock.settimeout(remaining)
        try:
            tag, data = ch.recv()
        except socket.timeout:
            raise TimeoutError(msg) from None
        finally:
            ch.sock.settimeout(None)
        if tag != TAG_HANDSHAKE:
            raise ConnectionError(f"expected {what}, got tag {tag}")
        return data

    def _expand(self, out: List, allow_combined: bool = False) -> List:
        """Spread each local root's aggregate over its members' slots
        (reference :1319-1362). On the request tag (``allow_combined``)
        a folded CACHED_AGG frame stays in the owner's slot and leaves
        the members' slots empty, since the fold answers for them; any
        other aggregate there comes under the PACKED envelope (a bare
        pack's leading count of 2 would read as the CACHED_AGG kind).
        Anything else raises ConnectionError."""
        if not self._has_aggregates:
            return out
        for owner, members in self._members.items():
            if len(members) == 1:
                continue
            blob = out[owner]
            if allow_combined:
                kind_off = 5 if blob[:1] == wire.TENANT_PREFIX else 0
                if blob[kind_off:kind_off + 1] == wire.CACHED_AGG_PREFIX:
                    for m in members[1:]:
                        out[m] = b""
                    continue
                if blob[:1] != wire.PACKED_PREFIX:
                    raise ConnectionError(
                        f"request aggregate from rank {owner} has kind "
                        f"{blob[0] if blob else None}; expected a folded "
                        f"CACHED_AGG frame or a PACKED envelope")
                blob = memoryview(blob)[1:]
            frames = unpack_frames(blob)
            if len(frames) != len(members):
                raise ConnectionError(
                    f"aggregate from rank {owner} carried {len(frames)} "
                    f"frames for {len(members)} ranks")
            for m, f in zip(members, frames):
                out[m] = f
        return out

    def _ping_peers(self) -> None:
        """Run at each idle slice of a recv: tell every worker the world
        is alive (the straggler this rank waits on is silent to them too,
        and their deadlines would fire on a merely slow peer)."""
        _maybe_ping(self, self._channels, 0)

    keepalive = _ping_peers

    def peer_heartbeat_ages(self) -> Dict[int, float]:
        """Seconds since the last frame on each channel, by its owner: a
        local root answers for its host (it reports its leaves' ages in
        its own metrics)."""
        now = time.monotonic()
        return {r: now - t for r, t in list(self._last_seen.items())}

    def worker_peer_ip(self, rank: int) -> str:
        """The address of worker ``rank`` as this coordinator sees it: a
        leaf's own non-loopback address reported by its root, else the
        address of the channel that carries it (reference :1812-1823)."""
        ip = self._peer_ip_override.get(rank)
        if ip is not None:
            return ip
        owner = self._owner_of.get(rank, rank)
        return self._channels[owner].sock.getpeername()[0]

    def _recv_ctrl(self, r: int, expect_tag: int) -> bytes:
        """One frame from owner ``r``: PINGs are skipped, an ABORT raises
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
        """One data frame from owner ``r`` straight into ``out``; an
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
        dead channel's owner when one can be found."""
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
        """One frame per rank, rank-indexed, this rank's own at 0, each
        local root's aggregate spread over its members (``_expand``). On
        a request gather with the trace plane's hook armed, each owner's
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
        return self._expand(out, allow_combined=expect_tag == TAG_REQUESTS)

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
        # The root's channel owner (the root, or its local root, which
        # has served the root's host already) gets nothing back.
        owner = self._owner_of.get(root_rank, root_rank)
        if root_rank != 0:
            payload = self._recv_ctrl(owner, TAG_DATA)
        self._send_all(payload, TAG_DATA, exclude=owner)
        return payload

    def scatter_data(self, payloads) -> bytes:
        # One payload per channel: a rank's own, or its host's packed.
        per_owner = payloads
        if self._has_aggregates:
            per_owner = {o: payloads[o] if len(ms) == 1
                         else pack_frames([payloads[m] for m in ms])
                         for o, ms in self._members.items()}
        try:
            for r, ch in self._channels.items():
                ch.send(per_owner[r], TAG_DATA)
        except (ConnectionError, OSError) as e:
            self._raise_transport(e)
        return payloads[0]

    def gather_data_into(self, payload, outs) -> Optional[List[int]]:
        lens = [len(network.as_byte_view(payload))] + [0] * (self._size - 1)
        if self._has_aggregates:
            # A local root's aggregate interleaves its host's payloads in
            # one frame: the classic gather, then one copy per rank.
            gathered = self.gather_data(payload)
            for r in range(1, self._size):
                lens[r] = _copy_into(outs[r], gathered[r])
            return lens
        for r in self._channels:
            lens[r] = self._recv_data_into(r, outs[r])
        return lens

    def broadcast_data_into(self, payload, out, root_rank: int = 0) -> int:
        if root_rank == 0:
            self._send_all(payload, TAG_DATA)
            return len(network.as_byte_view(payload))
        owner = self._owner_of.get(root_rank, root_rank)
        n = self._recv_data_into(owner, out)
        self._send_all(network.as_byte_view(out)[:n], TAG_DATA,
                       exclude=owner)
        return n

    def scatter_data_into(self, payloads, out) -> int:
        self.scatter_data(payloads)
        return len(network.as_byte_view(payloads[0]))

    def abort(self, origin_rank: int, cause: str) -> None:
        """The notice to every channel; a local root relays it to its
        leaves."""
        payload = heartbeat.encode_abort(origin_rank, cause)
        for ch in self._channels.values():
            try:
                ch.send(payload, TAG_ABORT)
            except Exception:
                pass  # that peer is already gone

    def sever_connection(self, target_rank: Optional[int] = None) -> None:
        if target_rank is not None:
            ch = self._channels.get(self._owner_of.get(target_rank,
                                                       target_rank))
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
    """Ranks 1..size-1: one persistent connection upward.

    Flat world: the upward channel goes to the coordinator. When the
    coordinator announces ``hier`` in the handshake and this rank's
    host is a remote host of more than one rank, its lowest rank becomes
    the host's local root (it keeps the coordinator channel, accepts its
    leaves and relays every primitive between them and the coordinator)
    and the others become leaves, whose upward channel then goes to the
    local root; every primitive below works unchanged for a leaf."""

    # A worker built without __init__ (the tests' socket pairs) is flat.
    _children: Dict[int, network.Channel] = {}
    _up_rank = 0

    def __init__(self, rank: int, size: int, addr: str, port: int,
                 secret: bytes = b"", start_timeout: float = 30.0,
                 heartbeat_interval: float = 5.0,
                 heartbeat_timeout: float = 30.0):
        self._hb_interval = heartbeat_interval
        self._hb_timeout = heartbeat_timeout
        self._ping_seq = 0
        self._last_ping = 0.0
        self._up_rank = 0  # the rank the upward channel talks to
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
        hostnames = info["hostnames"]
        self.topology = compute_topology(rank, hostnames)
        # leaf rank -> its channel (local roots only)
        self._children: Dict[int, network.Channel] = {}
        self._members: List[int] = [rank]  # this host's ranks, ascending
        # leaf rank -> its latest METRICS frame (snapshots are totals:
        # the latest of each leaf folds exactly into this root's own)
        self._child_metrics: Dict[int, bytes] = {}
        # leaf TRACE frames in arrival order (spans are deltas: each
        # frame goes up exactly once), bounded
        self._child_trace: List[bytes] = []
        self._up_seen = time.monotonic()
        self._child_seen: Dict[int, float] = {}
        # (sender, sequence) of the last PING from upward
        self.last_ping: Optional[tuple] = None
        topo = self.topology
        if info.get("hier") and topo.cross_rank != 0 \
                and topo.local_size > 1:
            members = host_groups(hostnames)[1][topo.cross_rank]
            if topo.local_rank == 0:
                self._become_local_root(members, secret, start_timeout)
            else:
                self._become_leaf(rank, members[0], secret, start_timeout)
        if self._hb_timeout and self._hb_timeout > 0:
            self._ch.arm(self._hb_timeout, self._hb_interval)
            for ch in self._children.values():
                ch.arm(self._hb_timeout, self._hb_interval,
                       on_idle=self._ping_children)

    def _become_local_root(self, members: List[int], secret: bytes,
                           start_timeout: float) -> None:
        """Open a listener on this host, report its port upward, accept
        this host's leaves, and report the addresses they came from
        (reference :1967-2003)."""
        srv = network.listen(0, host=_local_root_addr())
        try:
            port = srv.getsockname()[1]
            self._ch.send(json.dumps({"port": port}).encode(),
                          TAG_HANDSHAKE)
            expected = set(members[1:])

            def _validate(hello):
                r = int(hello["rank"])
                if r not in expected:
                    raise ConnectionError(f"unexpected rank {r}")
                return r

            accepts = _accept_handshakes(
                srv, secret, time.monotonic() + start_timeout,
                lambda: (f"local root {self.rank}: leaves "
                         f"{sorted(expected)} did not connect within "
                         f"start timeout"),
                _validate)
            while expected:
                r, _, ch = next(accepts)
                ch.send(b"{}", TAG_HANDSHAKE)  # the accept's ack
                ch.peer = f"rank {r} ({ch.peer})"
                self._children[r] = ch
                expected.discard(r)
        finally:
            srv.close()
        self._members = members
        now = time.monotonic()
        self._child_seen = {r: now for r in self._children}
        leaf_ips = {r: ch.sock.getpeername()[0]
                    for r, ch in self._children.items()}
        self._ch.send(json.dumps({"leaf_ips": leaf_ips}).encode(),
                      TAG_HANDSHAKE)

    def _become_leaf(self, rank: int, root: int, secret: bytes,
                     start_timeout: float) -> None:
        """Take the root-port map, then move the upward channel from the
        coordinator to this host's local root (reference :2005-2027)."""
        tag, data = self._ch.recv()
        if tag != TAG_HANDSHAKE:
            raise ConnectionError(f"expected the root-port map, got tag "
                                  f"{tag}")
        ports = json.loads(data.decode())["roots"]
        port = int(ports[str(self.topology.cross_rank)])
        self._ch.close()
        self._ch = network.connect(_local_root_addr(), port, secret,
                                   timeout=start_timeout,
                                   retry_deadline=start_timeout)
        self._up_rank = root
        self._ch.peer = f"local root rank {root} ({self._ch.peer})"
        self._ch.send(json.dumps({"rank": rank}).encode(), TAG_HANDSHAKE)
        tag, _ = self._ch.recv()
        if tag != TAG_HANDSHAKE:
            raise ConnectionError("local root handshake failed")

    def _fail(self, e: Exception) -> WorldAbortedError:
        return _abort_error(
            self._up_rank, f"control channel to {self._ch.peer} failed: {e}")

    def keepalive(self) -> None:
        """PINGs to the upward peer and, on a local root, to its leaves,
        which wait on this rank too."""
        if self._hb_timeout and self._hb_timeout > 0:
            _maybe_ping(self, {self._up_rank: self._ch, **self._children},
                        self.rank)

    def _ping_children(self) -> None:
        """Run at each idle slice of a recv from a leaf: a slow leaf must
        not look dead to its waiting siblings."""
        _maybe_ping(self, self._children, self.rank)

    def peer_heartbeat_ages(self) -> Dict[int, float]:
        now = time.monotonic()
        ages = {self._up_rank: now - self._up_seen}
        for r, t in list(self._child_seen.items()):
            ages[r] = now - t
        return ages

    def _note_ping(self, data) -> None:
        """A PING from upward: liveness whatever its bytes say; a well
        formed one is kept as ``last_ping`` and, with the trace plane
        armed, its receipt is the clock exchange's t2 (the clock keeps
        only the coordinator's, which a local root relays)."""
        t2 = time.monotonic()
        try:
            self.last_ping = heartbeat.decode_ping(bytes(data))
        except ValueError:
            return
        if self._trace_on:
            htrace.clock().ping_received(*self.last_ping, t2)

    # -- the observability planes' relays --------------------------------
    def _on_child_metrics(self, r: int, payload: bytes) -> None:
        """A leaf's METRICS frame: only its latest is kept."""
        self._child_metrics[r] = bytes(payload)

    def _on_child_trace(self, r: int, payload: bytes) -> None:
        """A leaf's TRACE frame: kept until this root's next frame goes
        up; past 64 frames the oldest is dropped (lossy, not unbounded)."""
        if len(self._child_trace) >= 64:
            del self._child_trace[0]
        self._child_trace.append(bytes(payload))

    def send_metrics(self, payload: bytes) -> None:
        try:
            if self._child_metrics:
                # A leaf whose frame does not merge (skewed code) is left
                # out; the rest of the host still reports.
                payload = wire.combine_metrics_frames(
                    [payload] + [self._child_metrics[r]
                                 for r in sorted(self._child_metrics)],
                    drop_incompatible=True)
            self._ch.send(payload, TAG_METRICS)
            if self._metrics_on:
                self._m_ctrl_tx.inc(len(payload))
        except Exception:
            pass  # best effort: the cycle path reports a dead channel

    def send_trace(self, payload: bytes) -> None:
        try:
            if self._child_trace:
                batch, self._child_trace = self._child_trace, []
                payload = wire.combine_trace_frames([payload] + batch)
            self._ch.send(payload, TAG_TRACE)
            if self._metrics_on:
                self._m_ctrl_tx.inc(len(payload))
        except Exception:
            pass  # best effort, like send_metrics

    # -- upward ----------------------------------------------------------
    def _relay_children_safe(self, data, tag: int) -> None:
        """PING or ABORT to every leaf, best effort (liveness and failure
        paths: never raises)."""
        for ch in self._children.values():
            try:
                ch.send(data, tag)
            except Exception:
                pass

    def _send_up(self, payload, tag: int) -> None:
        try:
            self._ch.send(payload, tag)
        except (ConnectionError, OSError) as e:
            raise self._fail(e) from e
        if self._metrics_on:
            self._m_ctrl_tx.inc(_nbytes(payload))

    def _recv_up(self, expect_tag: int) -> bytes:
        """One frame from upward. PINGs prove the world alive and go on
        down to the leaves, an ABORT goes down and then raises its
        notice, and silence past the deadline or a dead socket names the
        upward peer as the origin."""
        while True:
            try:
                tag, data = self._ch.recv()
            except (ConnectionError, OSError) as e:
                raise self._fail(e) from e
            self._up_seen = time.monotonic()
            if tag == TAG_PING:
                self._note_ping(data)
                self._relay_children_safe(data, TAG_PING)
                continue
            if tag in (TAG_METRICS, TAG_TRACE):
                continue  # these only flow upward; a stray is dropped
            if tag == TAG_ABORT:
                self._relay_children_safe(data, TAG_ABORT)
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
                self._relay_children_safe(data, tag)
                if tag == TAG_PING:
                    self._note_ping(data)
                    continue
                _raise_if_abort(tag, data)
            if tag != TAG_DATA or spill is not None:
                raise ConnectionError(f"expected a data frame that fits its "
                                      f"buffer from {self._ch.peer}, got tag "
                                      f"{tag} of {n} bytes")
            if self._metrics_on:
                self._m_ctrl_rx.inc(n)
            return n

    # -- the leaves (local roots only) -----------------------------------
    def _recv_child(self, r: int, tag: int) -> bytes:
        """One frame from leaf ``r``. Its PINGs go on upward (the
        coordinator waits on this root while it waits on the leaf), its
        METRICS and TRACE frames are kept for this root's next ones, an
        ABORT raises its notice, a transport failure names the leaf."""
        ch = self._children[r]
        while True:
            try:
                t, data = ch.recv()
            except (ConnectionError, OSError) as e:
                raise _abort_error(
                    r, f"control channel to local rank {r} failed: "
                       f"{e}") from e
            self._child_seen[r] = time.monotonic()
            if t == TAG_PING:
                try:
                    self._ch.send(data, TAG_PING)
                except OSError:
                    pass  # the upward recv reports a dead channel
                continue
            if t == TAG_METRICS:
                self._on_child_metrics(r, data)
                continue
            if t == TAG_TRACE:
                self._on_child_trace(r, data)
                continue
            _raise_if_abort(t, data)
            if t != tag:
                raise ConnectionError(
                    f"expected tag {tag} from local rank {r}, got {t}")
            return data

    def _raise_child_transport(self, e: Exception, what: str):
        """An anonymous transport error on the leaf tier as a blame: a
        leaf found dead, else this rank."""
        dead = _dead_peers(self._children)
        origin = dead[0] if dead else self.rank
        raise _abort_error(origin, f"{what} failed: {e}") from e

    def _send_children(self, data, tag: int,
                       exclude_rank: Optional[int] = None) -> None:
        try:
            for r, ch in self._children.items():
                if r != exclude_rank:
                    ch.send(data, tag)
        except (ConnectionError, OSError) as e:
            self._raise_child_transport(e, "relay to local leaves")

    def _gather_up(self, payload, tag: int) -> None:
        """Send this rank's frame up; a local root first takes its
        leaves' and sends the host's as one (reference :2215-2245): on
        the request tag a host of cache bitmask frames folds into one
        CACHED_AGG frame, and any other mix goes packed under the PACKED
        envelope; data frames go packed."""
        if self._children:
            frames = {r: self._recv_child(r, tag) for r in self._children}
            frames[self.rank] = _frame(payload)
            ordered = [frames[r] for r in self._members]
            payload = None
            if tag == TAG_REQUESTS:
                payload = wire.combine_cycle_requests(ordered)
                if payload is None:
                    payload = wire.PACKED_PREFIX + pack_frames(ordered)
            if payload is None:
                payload = pack_frames(ordered)
        self._send_up(payload, tag)

    # -- the primitives --------------------------------------------------
    def gather_requests(self, payload: bytes) -> Optional[List[bytes]]:
        self._gather_up(payload, TAG_REQUESTS)
        return None

    def broadcast_responses(self, payload: Optional[bytes]) -> bytes:
        data = self._recv_up(TAG_RESPONSES)
        if self._children:
            self._send_children(data, TAG_RESPONSES)
        return data

    def gather_data(self, payload) -> Optional[List[bytes]]:
        self._gather_up(payload, TAG_DATA)
        return None

    def _relay_root_payload(self, payload, root_rank: int):
        """A broadcast rooted on this host, past the coordinator's reach:
        the payload goes up (the coordinator serves the other hosts and
        skips this one) and to this host's other ranks. Returns it, or
        None when the root is elsewhere."""
        if self.rank == root_rank:
            self._send_up(payload, TAG_DATA)
            self._send_children(payload, TAG_DATA)
            return payload
        if root_rank in self._children:
            data = self._recv_child(root_rank, TAG_DATA)
            self._send_up(data, TAG_DATA)
            self._send_children(data, TAG_DATA, exclude_rank=root_rank)
            return data
        return None

    def broadcast_data(self, payload, root_rank: int = 0) -> bytes:
        data = self._relay_root_payload(payload, root_rank)
        if data is not None:
            return data
        data = self._recv_up(TAG_DATA)
        if self._children:
            self._send_children(data, TAG_DATA)
        return data

    def scatter_data(self, payloads) -> bytes:
        data = self._recv_up(TAG_DATA)
        if not self._children:
            return data
        mine = None
        try:
            for r, f in zip(self._members, unpack_frames(data)):
                if r == self.rank:
                    mine = f
                else:
                    self._children[r].send(f, TAG_DATA)
        except (ConnectionError, OSError) as e:
            self._raise_child_transport(e, "scatter to local leaves")
        return mine

    def gather_data_into(self, payload, outs) -> Optional[List[int]]:
        self._gather_up(payload, TAG_DATA)
        return None

    def broadcast_data_into(self, payload, out, root_rank: int = 0) -> int:
        if self.rank == root_rank or root_rank in self._children:
            data = self._relay_root_payload(payload, root_rank)
            if self.rank == root_rank:
                return len(network.as_byte_view(data))
            return _copy_into(out, data)
        n = self._recv_up_into(out)
        if self._children:
            self._send_children(
                memoryview(network.as_byte_view(out))[:n], TAG_DATA)
        return n

    def scatter_data_into(self, payloads, out) -> int:
        if not self._children:
            return self._recv_up_into(out)
        # A local root unpacks the aggregate to pass each leaf its slice:
        # the classic path, and one copy out.
        return _copy_into(out, self.scatter_data(payloads))

    def abort(self, origin_rank: int, cause: str) -> None:
        payload = heartbeat.encode_abort(origin_rank, cause)
        try:
            self._ch.send(payload, TAG_ABORT)  # up
        except Exception:
            pass
        self._relay_children_safe(payload, TAG_ABORT)

    def sever_connection(self, target_rank: Optional[int] = None) -> None:
        if target_rank is not None and target_rank in self._children:
            self._children[target_rank].close()
            return
        self._ch.close()

    def drain_abort_notice(self, grace_s: float = 0.0) -> Optional[tuple]:
        return _drain_abort({self._up_rank: self._ch, **self._children},
                            grace_s)

    def close(self) -> None:
        for ch in self._children.values():
            try:
                ch.close()
            except OSError:
                pass  # the upward channel must still close
        self._ch.close()
