"""The port's fail-fast liveness layer against the JAX package's.

- Frames, bit for bit: PING and ABORT encodings from the same inputs
  (``common/heartbeat.py``), their decodings, truncations and refusals.
- The fault spec grammar: the same ``Fault`` fields for the same strings
  (``common/faults.py``); the reference's elastic-only ``rdzv`` trigger
  and ``preempt`` action raise ``NotImplementedError`` here.
- The knobs: HOROVOD_HEARTBEAT_INTERVAL/TIMEOUT parse as the reference's,
  detection is on by default, and HOROVOD_HEARTBEAT_TIMEOUT and
  HOROVOD_COMPRESSION no longer raise (HOROVOD_TPU_ICI still does).
- ``drain_abort_notice`` over socket pairs, with frames written by the
  reference's channel; an armed channel's deadline, beacons and ABORT
  handling in the controllers; ``WorldAborted`` statuses.
- Spawned worlds, all started at once by one module fixture (this file
  run as a script is a rank; ``tests/torch_worlds.py``, one deadline
  for all of them), with the reference's heartbeat knobs of
  its multi-process tests (interval 0.3 s, timeout 3 s): SIGKILL of
  rank 1 of 3 just before its 3rd collective, of rank 0, a 8 s hang of
  rank 1's loop at cycle 20, a severed control channel at cycle 20, and
  SIGKILL of rank 1 at op 40 of a bf16-compressed world deep in its
  cached, speculative steady state. Every survivor raises
  WorldAbortedError naming the faulted rank within the heartbeat timeout
  plus ``SLACK_S`` of its last good collective and leaves a flight dump
  naming it; rank 2 of the worlds that lose rank 1 has no channel to
  rank 1, so it names rank 1 only through the ABORT the coordinator
  fans to it.
"""

import json
import os
import pathlib
import signal
import socket
import sys
import threading
import time
import traceback

import pytest
import torch

HB_ENV = {"HOROVOD_HEARTBEAT_INTERVAL": "0.3",
          "HOROVOD_HEARTBEAT_TIMEOUT": "3"}
HB_TIMEOUT_S = 3.0
# Detection latency past the heartbeat timeout that a survivor may take:
# one ping slice (0.3 s), the 0.25 s sweep for a queued notice, the
# teardown and a loaded host's scheduling.
SLACK_S = 4.0


# -- frames ----------------------------------------------------------------
PINGS = [(7, 123456789), (0, 2 ** 63), (-1, 0), (2 ** 31 - 1, 2 ** 64 - 1)]
ABORTS = [(3, "rank 3 lost its host"), (1, "死 ✂ cause"), (-1, ""),
          (5, "x" * 4096)]


@pytest.mark.parametrize("rank,seq", PINGS)
def test_ping_frames_equal_the_reference(worlds, rank, seq):
    """(The first test asks for the worlds, so that they run while the
    in-process tests do.)"""
    from horovod_tpu.common import heartbeat as ref
    from horovod_tpu_torch.common import heartbeat as hb
    payload = hb.encode_ping(rank, seq)
    assert payload == ref.encode_ping(rank, seq)
    assert hb.decode_ping(payload) == ref.decode_ping(payload) == (rank, seq)


@pytest.mark.parametrize("origin,cause", ABORTS)
def test_abort_frames_equal_the_reference(origin, cause):
    from horovod_tpu.common import heartbeat as ref
    from horovod_tpu_torch.common import heartbeat as hb
    payload = hb.encode_abort(origin, cause)
    assert payload == ref.encode_abort(origin, cause)
    assert hb.decode_abort(payload) == ref.decode_abort(payload) \
        == (origin, cause)
    # a dying sender's truncated frame keeps its origin, as the reference
    for cut in (8, 9, 12, len(payload) - 1):
        if 8 <= cut <= len(payload):
            assert hb.decode_abort(payload[:cut]) == \
                ref.decode_abort(payload[:cut])
    # a received frame is a bytearray or a memoryview of one
    assert hb.decode_abort(bytearray(payload)) == (origin, cause)


@pytest.mark.parametrize("bad", [b"", b"\x01\x02", b"\x00" * 5,
                                 b"\x00" * 13])
def test_bad_frames_are_refused_alike(bad):
    from horovod_tpu.common import heartbeat as ref
    from horovod_tpu_torch.common import heartbeat as hb
    for mod in (ref, hb):
        with pytest.raises(ValueError):
            mod.decode_ping(bad)
    if len(bad) < 8:
        for mod in (ref, hb):
            with pytest.raises(ValueError):
                mod.decode_abort(bad)


# -- the spec grammar ------------------------------------------------------
SPECS = [
    "rank=1:kill:cycle=40",
    "rank=1:kill:cycle=40; rank=2:delay:op=3:ms=50",
    "hang:cycle=5:seconds=2.5;sever:op=1:target=3",
    "rank=2:delay:cycle=10:ms=40:count=8",
    "exit:op=7:code=3",
    " rank=0 : sever : cycle=20 ;; ",
    "delay:op=1",
]
FIELDS = ("action", "rank", "at_cycle", "at_op", "seconds", "ms", "code",
          "target", "count", "fired")


@pytest.mark.parametrize("spec", SPECS)
def test_spec_grammar_gives_the_reference_faults(spec):
    from horovod_tpu.common import faults as ref
    from horovod_tpu_torch.common import faults
    mine, theirs = faults.parse_spec(spec), ref.parse_spec(spec)
    assert len(mine) == len(theirs) > 0
    for m, t in zip(mine, theirs):
        assert t.at_rdzv is None
        assert [getattr(m, f) for f in FIELDS] == \
            [getattr(t, f) for f in FIELDS]
        assert repr(m) == repr(t)


@pytest.mark.parametrize("spec", [
    "explode:cycle=1", "kill:cycle=1:when=later", "kill:rank=1",
    "kill:cycle=1:op=2", "kill:cycle=1:count=2", "delay:cycle=1:count=0",
    "kill:hang:cycle=1", "rank=1:cycle=2", "kill:cycle=x"])
def test_bad_specs_raise_alike(spec):
    from horovod_tpu.common import faults as ref
    from horovod_tpu_torch.common import faults
    with pytest.raises(ValueError):
        ref.parse_spec(spec)
    with pytest.raises(ValueError):
        faults.parse_spec(spec)


@pytest.mark.parametrize("spec", ["rank=1:kill:rdzv=1", "preempt:cycle=3",
                                  "preempt:op=1:seconds=5"])
def test_elastic_faults_name_their_roadmap_item(spec):
    from horovod_tpu.common import faults as ref
    from horovod_tpu_torch.common import faults
    ref.parse_spec(spec)  # the reference has them
    with pytest.raises(NotImplementedError, match="A9"):
        faults.parse_spec(spec)


class _Rt:
    """Just enough of a runtime for the ticks."""

    class controller:
        rank = 0

        @staticmethod
        def sever_connection(target=None):
            _Rt.severed.append(target)

    severed = []


def test_ticks_fire_as_the_reference(monkeypatch):
    """A repeating delay fires on ``count`` consecutive hits and is spent;
    a sever goes to the controller; a fault scoped to another launch rank
    never fires; install/clear arm and disarm the plan; load_env reads the
    spec once."""
    from horovod_tpu.common import faults as ref
    from horovod_tpu_torch.common import faults
    monkeypatch.setenv("HOROVOD_RANK", "0")
    try:
        pairs = []
        for mod in (faults, ref):
            mod.clear()
            f = mod.install("delay", at_cycle=3, ms=0.0, count=2)
            other = mod.install("delay", rank=5, at_cycle=1, ms=0.0)
            seen = []
            for cycle in range(1, 6):
                mod.tick_cycle(_Rt(), cycle)
                seen.append((f.count, f.fired, other.fired))
            pairs.append(seen)
            assert mod._PLAN is not None
            mod.clear()
            assert mod._PLAN is None
        assert pairs[0] == pairs[1]
        _Rt.severed.clear()
        faults.install("sever", at_op=2, target=1)
        faults.tick_op(_Rt(), 1)
        assert _Rt.severed == []
        faults.tick_op(_Rt(), 2)
        faults.tick_op(_Rt(), 3)
        assert _Rt.severed == [1]
        faults.clear()
        monkeypatch.setenv("HOROVOD_FAULT_SPEC", "rank=3:kill:op=9")
        faults.load_env()
        monkeypatch.setenv("HOROVOD_FAULT_SPEC", "rank=4:kill:op=9")
        faults.load_env()  # once per process
        assert [repr(f) for f in faults._PLAN] == \
            ["Fault(kill@op=9, rank=3)"]
    finally:
        faults.clear()
        ref.clear()


# -- the knobs -------------------------------------------------------------
def test_heartbeat_knobs_parse_as_the_reference(monkeypatch):
    from horovod_tpu.common.config import Config as RefConfig
    from horovod_tpu_torch.common.config import Config
    assert (Config().heartbeat_interval_s, Config().heartbeat_timeout_s) \
        == (RefConfig().heartbeat_interval_s,
            RefConfig().heartbeat_timeout_s) == (5.0, 30.0)
    assert Config().heartbeat_timeout_s > Config().heartbeat_interval_s > 0
    for interval, timeout in (("0.25", "7.5"), ("0.3", "3"), ("1", "0"),
                              ("2", "-1"), ("x", "")):
        monkeypatch.setenv("HOROVOD_HEARTBEAT_INTERVAL", interval)
        monkeypatch.setenv("HOROVOD_HEARTBEAT_TIMEOUT", timeout)
        mine, theirs = Config.from_env(), RefConfig.from_env()
        assert (mine.heartbeat_interval_s, mine.heartbeat_timeout_s) == \
            (theirs.heartbeat_interval_s, theirs.heartbeat_timeout_s)


@pytest.mark.parametrize("name,value,raises", [
    ("HOROVOD_HEARTBEAT_TIMEOUT", "3", False),
    ("HOROVOD_COMPRESSION", "bf16", False),
    ("HOROVOD_COMPRESSION", "int8", False),
    ("HOROVOD_TPU_ICI", "1", True)])
def test_ported_knobs_no_longer_raise(monkeypatch, name, value, raises):
    from horovod_tpu_torch.common.config import Config
    monkeypatch.setenv(name, value)
    if raises:
        with pytest.raises(NotImplementedError, match="IciPlane"):
            Config.from_env()
    else:
        Config.from_env()


# -- channels and controllers over socket pairs ----------------------------
def _pair(mine_cls, peer_cls):
    a, b = socket.socketpair()
    return mine_cls(a), peer_cls(b)


def test_drain_abort_notice_over_socket_pairs():
    """The port's sweep finds a notice the reference's channel wrote,
    behind PINGs; an empty or closed channel gives None; a notice that
    arrives within the grace is found."""
    from horovod_tpu.common import heartbeat as ref_hb
    from horovod_tpu.common.controller import TAG_ABORT as REF_ABORT
    from horovod_tpu.common.controller import TAG_PING as REF_PING
    from horovod_tpu.common.network import Channel as RefChannel
    from horovod_tpu_torch.common.controller import (
        TAG_ABORT, TAG_PING, _drain_abort,
    )
    from horovod_tpu_torch.common.network import Channel
    assert (TAG_PING, TAG_ABORT) == (REF_PING, REF_ABORT)
    mine, peer = _pair(Channel, RefChannel)
    peer.send(ref_hb.encode_abort(3, "rank 3 fell over"), REF_ABORT)
    assert _drain_abort({3: mine}, 0.0) == (3, "rank 3 fell over")
    peer.send(ref_hb.encode_ping(2, 1), REF_PING)
    peer.send(ref_hb.encode_abort(2, "died"), REF_ABORT)
    assert _drain_abort({2: mine}, 0.0) == (2, "died")
    assert _drain_abort({1: mine}, 0.0) is None
    peer.close()
    assert _drain_abort({1: mine}, 0.0) is None
    mine, peer = _pair(Channel, RefChannel)

    def late():
        time.sleep(0.1)
        peer.send(ref_hb.encode_abort(1, "late"), REF_ABORT)

    t = threading.Thread(target=late)
    t.start()
    try:
        assert _drain_abort({1: mine}, 1.0) == (1, "late")
    finally:
        t.join()


def test_an_armed_channel_gives_up_on_silence_and_beacons():
    """A silent peer fails the recv after the timeout (not before), the
    idle beacon runs at least twice a window, a PING trickle from the
    reference's channel keeps the recv alive, and the socket's kernel
    timeouts are set; timeout 0 disarms."""
    from horovod_tpu.common import heartbeat as ref_hb
    from horovod_tpu.common.network import Channel as RefChannel
    from horovod_tpu_torch.common.network import Channel
    mine, peer = _pair(Channel, RefChannel)
    ticks = []
    mine.arm(0.6, 5.0, on_idle=lambda: ticks.append(time.monotonic()))
    assert mine._hb[:2] == (0.6, 0.3)  # the slice clamped to half
    tv = mine.sock.getsockopt(socket.SOL_SOCKET, socket.SO_RCVTIMEO, 16)
    assert tv != bytes(16)
    t0 = time.monotonic()
    with pytest.raises(ConnectionError, match="heartbeat timeout"):
        mine.recv()
    assert 0.55 <= time.monotonic() - t0 < 3.0
    assert len(ticks) >= 2

    stop = threading.Event()

    def pinger():
        while not stop.is_set():
            peer.send(ref_hb.encode_ping(0, 1), 5)
            time.sleep(0.1)
        peer.send(b"data", 4)

    t = threading.Thread(target=pinger)
    t.start()
    try:
        t0 = time.monotonic()
        while time.monotonic() - t0 < 1.2:  # twice the timeout
            tag, _ = mine.recv()
            assert tag == 5
        stop.set()
        while True:
            tag, data = mine.recv()
            if tag == 4:
                break
        assert data == b"data"
    finally:
        stop.set()
        t.join()
    mine.arm(0, 1.0)
    assert mine._hb is None


def _coordinator_with(peers):
    """A TcpCoordinator whose workers are the given channels (no
    handshake), armed with a 1 s deadline."""
    from horovod_tpu_torch.common.controller import TcpCoordinator
    c = TcpCoordinator(len(peers) + 1, heartbeat_interval=0.2,
                       heartbeat_timeout=1.0)
    c._server.close()
    c._channels = dict(peers)
    for ch in c._channels.values():
        ch.arm(1.0, 0.2, on_idle=c._ping_peers)
    return c


def test_controllers_absorb_pings_and_raise_aborts():
    """The coordinator skips PINGs on control and data receives, raises a
    resolved WorldAbortedError for an ABORT, names a worker that goes
    silent, PINGs the other workers while it waits, and fans its own
    ABORT; a worker absorbs PINGs into a data buffer and raises for an
    ABORT."""
    from horovod_tpu_torch.common import heartbeat as hb
    from horovod_tpu_torch.common.controller import (
        TAG_ABORT, TAG_DATA, TAG_PING, TAG_REQUESTS, TcpWorker,
    )
    from horovod_tpu_torch.common.network import Channel
    from horovod_tpu_torch.common.status import WorldAbortedError
    c1, w1 = _pair(Channel, Channel)
    c2, w2 = _pair(Channel, Channel)
    coord = _coordinator_with({1: c1, 2: c2})
    try:
        for w in (w1, w2):
            w.send(hb.encode_ping(1, 1), TAG_PING)
            w.send(b"req", TAG_REQUESTS)
        assert coord.gather_requests(b"own") == [b"own", b"req", b"req"]
        w1.send(hb.encode_ping(1, 2), TAG_PING)
        w1.send(torch.arange(4, dtype=torch.int32), TAG_DATA)
        w2.send(torch.arange(4, dtype=torch.int32) * 2, TAG_DATA)
        outs = [None, torch.zeros(4, dtype=torch.int32),
                torch.zeros(4, dtype=torch.int32)]
        assert coord.gather_data_into(torch.zeros(4, dtype=torch.int32),
                                      outs) == [16, 16, 16]
        assert outs[1].tolist() == [0, 1, 2, 3]
        assert outs[2].tolist() == [0, 2, 4, 6]
        w1.send(hb.encode_abort(2, "rank 2 saw it"), TAG_ABORT)
        with pytest.raises(WorldAbortedError) as e:
            coord.gather_requests(b"own")
        assert (e.value.origin_rank, e.value.cause, e.value.resolved) == \
            (2, "rank 2 saw it", True)
        # rank 1 silent now: rank 2 hears PINGs while the coordinator waits
        t0 = time.monotonic()
        with pytest.raises(WorldAbortedError) as e:
            coord.gather_requests(b"own")
        assert e.value.origin_rank == 1 and not e.value.resolved
        assert "heartbeat timeout" in e.value.cause
        assert time.monotonic() - t0 >= 0.95
        pings = 0
        w2.sock.settimeout(0.5)
        while True:
            try:
                tag, data = w2.recv()
            except socket.timeout:
                break
            assert tag == TAG_PING and hb.decode_ping(data)[0] == 0
            pings += 1
        assert pings >= 2
        assert sorted(coord.peer_heartbeat_ages()) == [1, 2]
        coord.abort(1, "gone")
        for w in (w1, w2):
            w.sock.settimeout(1.0)
            tag, data = w.recv()
            while tag == TAG_PING:
                tag, data = w.recv()
            assert (tag, hb.decode_abort(data)) == (TAG_ABORT, (1, "gone"))
    finally:
        coord.close()
    # a worker: PINGs absorbed into its data buffer, then the notice
    up, down = _pair(Channel, Channel)
    worker = TcpWorker.__new__(TcpWorker)
    worker._ch, worker._hb_timeout, worker._hb_interval = up, 1.0, 0.2
    worker._ping_seq, worker._last_ping, worker.last_ping = 0, 0.0, None
    worker._up_seen = time.monotonic()
    down.send(hb.encode_ping(0, 9), TAG_PING)
    down.send(torch.full((8,), 7, dtype=torch.uint8), TAG_DATA)
    out = torch.zeros(8, dtype=torch.uint8)
    assert worker._recv_up_into(out) == 8 and out.tolist() == [7] * 8
    assert worker.last_ping == (0, 9)
    down.send(hb.encode_abort(1, "fanned"), TAG_ABORT)
    with pytest.raises(WorldAbortedError) as e:
        worker._recv_up_into(torch.zeros(2, dtype=torch.uint8))
    assert (e.value.origin_rank, e.value.cause) == (1, "fanned")
    worker.close()
    down.close()


def test_world_aborted_statuses_equal_the_reference():
    from horovod_tpu.common.status import Status as RefStatus
    from horovod_tpu.common.status import WorldAbortedError as RefError
    from horovod_tpu_torch.common.status import (
        HorovodInternalError, Status, WorldAbortedError,
    )
    for origin, cause in ((4, "host fell over"), (-1, "stalled"),
                          (0, "")):
        st, ref = Status.WorldAborted(origin, cause), \
            RefStatus.WorldAborted(origin, cause)
        assert (st.type.value, st.reason, st.aborted_by) == \
            (ref.type.value, ref.reason, ref.aborted_by)
        assert not st.ok()
    e = WorldAbortedError("msg", origin_rank=2)
    assert isinstance(e, HorovodInternalError) and e.origin_rank == 2
    assert e.cause == RefError("msg", origin_rank=2).cause == "msg"
    assert Status.Aborted("clean shutdown").aborted_by is None


# -- the spawned worlds ----------------------------------------------------
def _abort_main(out_dir: str, victim: int, same_name: bool) -> int:
    """One rank of a world with a fault armed by HOROVOD_FAULT_SPEC: run
    allreduces (one name each, or one name throughout for the cached
    steady state) against their closed forms until the world aborts;
    record the error and the seconds since the last good collective."""
    t_proc = time.monotonic()
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    hvd.init(device="cpu")
    t_init = time.monotonic() - t_proc
    rank, size = hvd.rank(), hvd.size()
    x = torch.full((64,), float(rank + 1))
    want = torch.full((64,), float(sum(range(1, size + 1))))
    t_start = last_ok = time.monotonic()
    result = {"rank": rank, "ops": 0}
    try:
        while True:
            name = "ck.steady" if same_name else f"ab/{result['ops']}"
            got = hvd.allreduce(x, op=hvd.Sum, name=name)
            assert torch.equal(got, want), (got, want)
            last_ok = time.monotonic()
            result["ops"] += 1
            if last_ok - t_start > 60:
                raise AssertionError("collectives kept succeeding")
    except hvd.HorovodInternalError as e:
        now = time.monotonic()
        result.update(raised=type(e).__name__, message=str(e),
                      origin=getattr(e, "origin_rank", None),
                      after_last_ok=now - last_ok)
    stats = dict(basics.runtime().stats)
    result.update(cached_cycles=stats["cached_cycles"],
                  spec_cycles=stats["spec_cycles"])
    try:
        hvd.allreduce(torch.ones(4), name="after")
        result["after"] = "returned"
    except hvd.HorovodInternalError as e:
        result["after"] = [type(e).__name__, getattr(e, "origin_rank", None)]
    t0 = time.monotonic()
    hvd.shutdown()
    result.update(init_s=t_init, shutdown_s=time.monotonic() - t0,
                  total_s=time.monotonic() - t_proc)
    with open(os.path.join(out_dir, f"result{rank}.json"), "w") as f:
        json.dump(result, f)
    return 0


# World -> (ranks, faulted rank, fault spec, one name throughout, extra
# environment of every rank).
WORLDS = {
    "kill1": (3, 1, "rank=1:kill:op=3", False, {}),
    "kill0": (3, 0, "rank=0:kill:op=3", False, {}),
    "hang1": (3, 1, "rank=1:hang:cycle=20:seconds=8", False, {}),
    "sever1": (3, 1, "rank=1:sever:cycle=20", False, {}),
    "cached1": (3, 1, "rank=1:kill:op=40", True,
                {"HOROVOD_COMPRESSION": "bf16"}),
}
# One deadline for all five worlds together, from their start: a world
# that misses it costs it once and names its unfinished ranks. On an
# 8-core host the five are done about 12 s after they start, 35 s with
# 16 busy loops beside them, and 63 s with the whole run pinned to one
# core.
WORLDS_DEADLINE_S = 75.0


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Start every world of ``WORLDS`` at once; the tests wait for them
    (the in-process tests above run meanwhile)."""
    from tests.torch_worlds import Worlds, child_env
    spawned = Worlds(WORLDS_DEADLINE_S)
    try:
        for kind, (n, victim, spec, same, extra) in WORLDS.items():
            out = tmp_path_factory.mktemp(f"abort_{kind}")
            port = spawned.reserve_port()
            envs = [child_env(**HB_ENV, **extra, HOROVOD_FAULT_SPEC=spec,
                              HOROVOD_RANK=r, HOROVOD_SIZE=n,
                              HOROVOD_CONTROLLER_ADDR="127.0.0.1",
                              HOROVOD_CONTROLLER_PORT=port,
                              HOROVOD_CYCLE_TIME=2,
                              HOROVOD_TPU_FLIGHT_DIR=out)
                    for r in range(n)]
            argv = [pathlib.Path(__file__), out, victim, "1" if same else "0"]
            spawned.start(kind, out, [argv] * n, envs)
        yield spawned
    finally:
        spawned.close()


def test_a_world_past_the_shared_deadline_is_named_and_killed(tmp_path):
    """The worlds' fixture: a rank still running when the shared deadline
    passes fails its world at once, named, and is killed; the logs of
    the world's ranks come with it, the late one's with its stack."""
    from tests.torch_worlds import Worlds, child_env
    spawned = Worlds(1.0)
    try:
        spawned.start("slow", tmp_path, [
            ["-c", "print('rank 0 done')"],
            ["-c", "import time; print('rank 1 up', flush=True); "
                   "time.sleep(60)"]], [child_env()] * 2)
        t0 = time.monotonic()
        with pytest.raises(AssertionError) as e:
            spawned.wait("slow")
        assert time.monotonic() - t0 < 5.0
        msg = str(e.value)
        assert msg.startswith("world slow: ranks [") and "1] of 2" in msg
        assert "rank 1 up" in msg and "most recent call first" in msg
        procs = spawned._started["slow"][1]
        assert all(p.poll() is not None for p in procs)
        with pytest.raises(AssertionError):  # the verdict is kept
            spawned.wait("slow")
    finally:
        spawned.close()


def _flight_dump(out: pathlib.Path, rank: int) -> list:
    """The records of rank ``rank``'s one flight dump in ``out``: the
    header, then the ring's events."""
    files = list(out.glob(f"hvd-flight-rank{rank}.pid*.jsonl"))
    assert len(files) == 1, (rank, sorted(p.name for p in out.iterdir()))
    return [json.loads(line) for line in files[0].read_text().splitlines()]


@pytest.mark.parametrize("kind", list(WORLDS))
def test_survivors_name_the_faulted_rank_in_time(worlds, kind):
    n, victim, spec, same, _ = WORLDS[kind]
    rcs, results, logs = worlds.wait(kind)
    logs = "\n".join(logs)
    action = spec.split(":")[1]
    for r in range(n):
        res = results[r]
        if r == victim:
            if action == "kill":
                assert rcs[r] == -signal.SIGKILL and res is None, logs
            else:  # hang, sever: any structured internal error
                assert rcs[r] == 0 and res is not None, logs
                assert res["raised"] in ("WorldAbortedError",
                                         "HorovodInternalError"), res
            continue
        assert rcs[r] == 0 and res is not None, logs
        assert res["raised"] == "WorldAbortedError", res
        assert res["origin"] == victim, res
        assert f"rank {victim}" in res["message"], res
        assert res["after_last_ok"] < HB_TIMEOUT_S + SLACK_S, res
        # handles enqueued after the abort fail the same structured way
        assert res["after"] == ["WorldAbortedError", victim], res
        # and the flight recorder left a postmortem naming the origin
        dump = _flight_dump(worlds.out(kind), r)
        assert dump[0]["origin"] == victim, dump[0]
        assert any(e["ev"] == "abort" and e.get("arg") == victim
                   for e in dump[1:]), dump
    # Where rank 1 is faulted, rank 2 named it above: its only channel is
    # to the coordinator, so that name came in the coordinator's ABORT.
    if kind == "hang1":
        # found by the deadline: the hang outlasts the detection
        for r in (0, 2):
            assert results[r]["after_last_ok"] >= HB_TIMEOUT_S - 0.5, \
                results[r]
    if kind == "cached1":
        for r in (0, 2):
            assert results[r]["cached_cycles"] >= 10, results[r]
            assert results[r]["spec_cycles"] >= 10, results[r]


if __name__ == "__main__":
    try:
        sys.exit(_abort_main(sys.argv[1], int(sys.argv[2]),
                             sys.argv[3] == "1"))
    except Exception:
        traceback.print_exc()
        sys.exit(1)
