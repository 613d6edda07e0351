"""Framed, HMAC-authenticated TCP messaging.

Counterpart of ``horovod_tpu/common/network.py``: ``Channel`` (:181),
``_recv_exact_into``, ``connect`` (:519), ``listen`` (:549) and
``backoff_delays``, with the same frame layout, so that the bytes on the
wire are the reference's: ``u32 payload_len | u8 tag | payload``, and
with a secret key a 32-byte HMAC-SHA256 of (tag | payload) before the
payload. Payloads are sent from and received into the memory of
contiguous host buffers (bytes, numpy arrays, CPU torch tensors,
pinned ones included) without a copy; a frame may be sent from a list
of such buffers (the response cache's speculative frames: a header per
segment between the fused payloads), and a received frame is a fresh
``bytearray`` the receiver owns. The native core's vectored and
zero-copy sends and the heartbeat deadlines wait for their slices
(``ROADMAP.md`` A6.2, A6.6, A6.10).
"""

from __future__ import annotations

import hashlib
import hmac
import random
import socket
import struct
import time
from typing import Callable, Iterator, Optional, Tuple

import torch

_HDR = struct.Struct("<IB")
_DIGEST_LEN = 32
# Frames up to this size go out as one concatenated sendall (one
# packet); larger ones send the header and the payload separately, so
# the payload is never copied into a new bytes object.
_INLINE_SEND = 16 * 1024


def as_byte_view(payload):
    """Flat byte view over a contiguous host buffer; bytes pass through
    and an empty buffer becomes ``b""``. A torch tensor must be a
    contiguous CPU tensor: it is viewed as bytes (bfloat16 included),
    never copied, so that a receive fills the tensor itself."""
    if isinstance(payload, (bytes, bytearray)):
        return payload
    if isinstance(payload, torch.Tensor):
        if payload.device.type != "cpu" or not payload.is_contiguous():
            raise TypeError("as_byte_view needs a contiguous CPU tensor, "
                            f"got {payload.device} "
                            f"contiguous={payload.is_contiguous()}")
        if payload.numel() == 0:
            return b""
        payload = payload.reshape(-1).view(torch.uint8).numpy()
    mv = memoryview(payload)
    return mv.cast("B") if mv.nbytes else b""


def _recv_exact_into(sock: socket.socket, view: memoryview,
                     who: str = "peer") -> None:
    """Fill ``view`` from ``sock``; ``who`` names the peer in errors."""
    got = 0
    n = len(view)
    while got < n:
        r = sock.recv_into(view[got:])
        if r == 0:
            raise ConnectionError(f"connection to {who} closed while "
                                  f"reading")
        got += r


def _recv_exact(sock: socket.socket, n: int,
                who: str = "peer") -> bytearray:
    buf = bytearray(n)
    _recv_exact_into(sock, memoryview(buf), who)
    return buf


class Channel:
    """One framed duplex connection, HMAC-authenticated when a secret is
    set. ``peer`` labels the other end in every transport error; the
    controllers set it to the peer's rank after the handshake."""

    def __init__(self, sock: socket.socket, secret: bytes = b"",
                 peer: Optional[str] = None):
        self.sock = sock
        self.secret = secret
        if peer is None:
            try:
                name = sock.getpeername()
                if isinstance(name, tuple) and len(name) >= 2:
                    peer = f"{name[0]}:{name[1]}"
                else:
                    peer = str(name) or "peer"
            except OSError:
                peer = "peer"
        self.peer = peer
        # Collectives are latency-bound: do not batch small frames.
        try:
            self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass  # not a TCP socket (a socketpair in a test)

    def send(self, payload, tag: int = 0) -> None:
        """Send one frame from any contiguous host buffer, or from a list
        of them whose bytes follow one another in the frame (no join:
        runs of small parts go out together, each large one from its own
        memory)."""
        views = [as_byte_view(p) for p in payload] \
            if isinstance(payload, list) else [as_byte_view(payload)]
        n = sum(len(v) for v in views)
        head = _HDR.pack(n, tag)
        if self.secret:
            h = hmac.new(self.secret, bytes((tag,)), hashlib.sha256)
            for v in views:
                h.update(v)
            head += h.digest()
        small = [head]
        for v in views:
            if len(v) <= _INLINE_SEND:
                small.append(v)
                continue
            self.sock.sendall(b"".join(small))
            small = []
            self.sock.sendall(v)
        if small:
            self.sock.sendall(b"".join(small))

    def recv(self) -> Tuple[int, bytearray]:
        who = self.peer
        n, tag = _HDR.unpack(_recv_exact(self.sock, _HDR.size, who))
        digest = (_recv_exact(self.sock, _DIGEST_LEN, who) if self.secret
                  else None)
        payload = _recv_exact(self.sock, n, who)
        self._verify(tag, payload, digest)
        return tag, payload

    def recv_into_spill(self, buf):
        """Receive one frame into the writable buffer ``buf``. A frame
        larger than ``buf`` comes back whole as bytes instead. Returns
        (tag, payload_nbytes, spill), ``spill`` None when the payload
        landed in ``buf``."""
        who = self.peer
        n, tag = _HDR.unpack(_recv_exact(self.sock, _HDR.size, who))
        digest = (_recv_exact(self.sock, _DIGEST_LEN, who) if self.secret
                  else None)
        view = memoryview(as_byte_view(buf)) if n else memoryview(b"")
        if n > len(view):
            payload = _recv_exact(self.sock, n, who)
            self._verify(tag, payload, digest)
            return tag, n, payload
        _recv_exact_into(self.sock, view[:n], who)
        self._verify(tag, view[:n], digest)
        return tag, n, None

    def _verify(self, tag: int, payload, digest) -> None:
        if digest is None:
            return
        h = hmac.new(self.secret, bytes((tag,)), hashlib.sha256)
        h.update(payload)
        if not hmac.compare_digest(digest, h.digest()):
            raise ConnectionError(
                f"HMAC authentication failed for frame from {self.peer}")

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


def backoff_delays(base: float = 0.05, cap: float = 1.0,
                   factor: float = 2.0, jitter: float = 0.25,
                   rng: Optional[Callable[[], float]] = None
                   ) -> Iterator[float]:
    """Capped exponential backoff with multiplicative jitter, so that
    ranks retrying against one listener do not retry in lockstep."""
    if rng is None:
        rng = random.random
    delay = base
    while True:
        yield min(cap, delay) * (1.0 + jitter * (2.0 * rng() - 1.0))
        delay = min(cap, delay * factor)


def connect(addr: str, port: int, secret: bytes = b"",
            timeout: Optional[float] = None,
            retry_deadline: Optional[float] = None) -> Channel:
    """Connect, retrying with backoff for ``retry_deadline`` seconds."""
    deadline = (time.monotonic() + retry_deadline
                if retry_deadline is not None else None)
    delays = backoff_delays()
    attempts = 0
    while True:
        try:
            attempts += 1
            sock = socket.create_connection((addr, port), timeout=timeout)
            # The connect timeout must not linger as a recv timeout: a
            # worker blocks in recv for a whole cycle.
            sock.settimeout(None)
            return Channel(sock, secret, peer=f"{addr}:{port}")
        except OSError as e:
            now = time.monotonic()
            if deadline is None or now >= deadline:
                raise ConnectionError(
                    f"Could not connect to {addr}:{port} after "
                    f"{attempts} attempt(s): {e}") from e
            time.sleep(min(next(delays), max(0.0, deadline - now)))


def listen(port: int = 0, host: str = "") -> socket.socket:
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(128)
    return srv
