"""Control-plane controllers: how ranks exchange request and response
lists, and the socket data plane's payloads.

Counterpart of ``horovod_tpu/common/controller.py``: ``Controller``
(:806), ``LocalController`` (:1026), and the flat-topology
``TcpCoordinator`` (:1070) and ``TcpWorker`` (:1855). Each cycle the
workers send their serialized RequestList to rank 0 and receive the
fused ResponseList from it, over persistent HMAC'd TCP connections
opened by a handshake that also shares every rank's hostname, from which
each rank derives the same local/cross topology. Frames carry the
reference's tags. The hierarchical control plane, the native fan-out
and the heartbeat and abort fan-out wait for their slices
(``ROADMAP.md`` A6.2, A6.3, A6.10). Without them a peer whose socket
closes is still seen at once: the recv on its channel fails, which the
runtime turns into a ``WorldAbortedError`` on every pending handle.
"""

from __future__ import annotations

import json
import select
import socket
import time
from typing import Dict, List, Optional

from horovod_tpu_torch.common import config as hconfig
from horovod_tpu_torch.common import logging as hlog
from horovod_tpu_torch.common import network
from horovod_tpu_torch.common.status import (
    WorldAbortedError, world_abort_message,
)

# Frame tags on the controller channel (the reference's :74-77).
TAG_HANDSHAKE = 1
TAG_REQUESTS = 2    # worker -> coordinator: a cycle-request frame
TAG_RESPONSES = 3   # coordinator -> worker: a cycle-response frame
TAG_DATA = 4        # data-plane payload of the socket backend


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


def _abort_error(origin: int, cause: str) -> WorldAbortedError:
    return WorldAbortedError(world_abort_message(origin, cause),
                             origin_rank=origin, cause=cause)


def _dead_peers(channels: Dict[int, network.Channel]) -> List[int]:
    """Ranks whose socket has hung up, probed without blocking (failure
    paths only: it names the peer behind an anonymous transport
    error)."""
    dead: List[int] = []
    for r, ch in channels.items():
        try:
            p = select.poll()
            p.register(ch.sock.fileno(), select.POLLIN)
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

    def close(self) -> None:
        pass


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
                 start_timeout: float = 30.0):
        self._secret = secret
        self._server = network.listen(port)
        self.port = self._server.getsockname()[1]
        self._channels: Dict[int, network.Channel] = {}
        self._size = size
        self._start_timeout = start_timeout
        self.topology = None  # set by accept_workers

    def accept_workers(self) -> None:
        """Accept every worker, then send each the hostname list."""
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
        for ch in self._channels.values():
            ch.send(blob, TAG_HANDSHAKE)

    def _recv(self, r: int, expect_tag: int) -> bytes:
        ch = self._channels[r]
        try:
            tag, data = ch.recv()
        except (ConnectionError, OSError) as e:
            raise _abort_error(
                r, f"control channel to {ch.peer} failed: {e}") from e
        if tag != expect_tag:
            raise ConnectionError(f"expected tag {expect_tag} from rank "
                                  f"{r}, got {tag}")
        return data

    def _recv_into(self, r: int, out) -> int:
        ch = self._channels[r]
        try:
            tag, n, spill = ch.recv_into_spill(out)
        except (ConnectionError, OSError) as e:
            raise _abort_error(
                r, f"control channel to {ch.peer} failed: {e}") from e
        if tag != TAG_DATA:
            raise ConnectionError(f"expected tag {TAG_DATA} from rank {r}, "
                                  f"got {tag}")
        if spill is not None:
            raise ConnectionError(f"data frame of {n} bytes from rank {r} "
                                  f"overflows its buffer")
        return n

    def _send_all(self, payload, tag: int, exclude: int = -1) -> None:
        try:
            for r, ch in self._channels.items():
                if r != exclude:
                    ch.send(payload, tag)
        except (ConnectionError, OSError) as e:
            dead = _dead_peers(self._channels)
            origin = dead[0] if dead else 0
            raise _abort_error(origin, f"send from the coordinator "
                                       f"failed: {e}") from e

    def gather_requests(self, payload: bytes) -> Optional[List[bytes]]:
        out = [_frame(payload)] + [b""] * (self._size - 1)
        for r in self._channels:
            out[r] = self._recv(r, TAG_REQUESTS)
        return out

    def broadcast_responses(self, payload: Optional[bytes]) -> bytes:
        self._send_all(payload, TAG_RESPONSES)
        return payload

    def gather_data(self, payload) -> Optional[List[bytes]]:
        out = [payload] + [b""] * (self._size - 1)
        for r in self._channels:
            out[r] = self._recv(r, TAG_DATA)
        return out

    def broadcast_data(self, payload, root_rank: int = 0) -> bytes:
        if root_rank != 0:
            payload = self._recv(root_rank, TAG_DATA)
        self._send_all(payload, TAG_DATA, exclude=root_rank)
        return payload

    def scatter_data(self, payloads) -> bytes:
        try:
            for r, ch in self._channels.items():
                ch.send(payloads[r], TAG_DATA)
        except (ConnectionError, OSError) as e:
            raise _abort_error(0, f"scatter from the coordinator "
                                  f"failed: {e}") from e
        return payloads[0]

    def gather_data_into(self, payload, outs) -> Optional[List[int]]:
        lens = [len(network.as_byte_view(payload))] + [0] * (self._size - 1)
        for r in self._channels:
            lens[r] = self._recv_into(r, outs[r])
        return lens

    def broadcast_data_into(self, payload, out, root_rank: int = 0) -> int:
        if root_rank == 0:
            self._send_all(payload, TAG_DATA)
            return len(network.as_byte_view(payload))
        n = self._recv_into(root_rank, out)
        self._send_all(network.as_byte_view(out)[:n], TAG_DATA,
                       exclude=root_rank)
        return n

    def scatter_data_into(self, payloads, out) -> int:
        self.scatter_data(payloads)
        return len(network.as_byte_view(payloads[0]))

    def close(self) -> None:
        for ch in self._channels.values():
            ch.close()


class TcpWorker(Controller):
    """Ranks 1..size-1: one persistent connection to the coordinator."""

    def __init__(self, rank: int, size: int, addr: str, port: int,
                 secret: bytes = b"", start_timeout: float = 30.0):
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

    def _fail(self, e: Exception) -> WorldAbortedError:
        return _abort_error(
            0, f"control channel to {self._ch.peer} failed: {e}")

    def _send(self, payload, tag: int) -> None:
        try:
            self._ch.send(payload, tag)
        except (ConnectionError, OSError) as e:
            raise self._fail(e) from e

    def _recv(self, expect_tag: int) -> bytes:
        try:
            tag, data = self._ch.recv()
        except (ConnectionError, OSError) as e:
            raise self._fail(e) from e
        if tag != expect_tag:
            raise ConnectionError(f"expected tag {expect_tag} from "
                                  f"{self._ch.peer}, got {tag}")
        return data

    def _recv_into(self, out) -> int:
        try:
            tag, n, spill = self._ch.recv_into_spill(out)
        except (ConnectionError, OSError) as e:
            raise self._fail(e) from e
        if tag != TAG_DATA or spill is not None:
            raise ConnectionError(f"expected a data frame that fits its "
                                  f"buffer from {self._ch.peer}, got tag "
                                  f"{tag} of {n} bytes")
        return n

    def gather_requests(self, payload: bytes) -> Optional[List[bytes]]:
        self._send(payload, TAG_REQUESTS)
        return None

    def broadcast_responses(self, payload: Optional[bytes]) -> bytes:
        return self._recv(TAG_RESPONSES)

    def gather_data(self, payload) -> Optional[List[bytes]]:
        self._send(payload, TAG_DATA)
        return None

    def broadcast_data(self, payload, root_rank: int = 0) -> bytes:
        if self.rank == root_rank:
            self._send(payload, TAG_DATA)
            return payload
        return self._recv(TAG_DATA)

    def scatter_data(self, payloads) -> bytes:
        return self._recv(TAG_DATA)

    def gather_data_into(self, payload, outs) -> Optional[List[int]]:
        self._send(payload, TAG_DATA)
        return None

    def broadcast_data_into(self, payload, out, root_rank: int = 0) -> int:
        if self.rank == root_rank:
            self._send(payload, TAG_DATA)
            return len(network.as_byte_view(payload))
        return self._recv_into(out)

    def scatter_data_into(self, payloads, out) -> int:
        return self._recv_into(out)

    def close(self) -> None:
        self._ch.close()
