"""The port's hierarchical control plane against the JAX package's.

- In-process, on the same inputs as the reference's functions:
  ``pack_frames`` / ``unpack_frames`` bit for bit, every truncation
  raising ConnectionError; ``_dialable_leaf_ip`` on the v4 and v6
  loopback families; a local root's upward request frame
  (``TcpWorker._gather_up``, driven over socket pairs in both packages)
  on seeded host frame streams, the fold and the PACKED envelope (a
  two-rank host's count byte is the CACHED_AGG kind); the coordinator's
  ``_expand`` on built aggregates; ``host_groups`` and
  ``compute_topology`` on uneven host lists; the knob.
- Spawned worlds, all started at once by one module fixture (this file
  run as a script is a rank; ``tests/torch_worlds.py``, one deadline for
  all of them), each rank with ``HOROVOD_HOSTNAME`` set:
  (a) 5 ranks on 2 + 3 fake hosts, cache on: the tree's shape, every
      collective and a broadcast from every root (the reference's
      ``scenario_hier_controller``), then cached and speculative cycles
      through the folded host with the metrics and trace planes on:
      the world's sums exact through the root's fold, one trace track a
      rank;
  (b) 4 ranks on 2 x 2, cache off: the mixed-op storm through the PACKED
      envelope, then autotune, whose tuned values reach the migrated
      leaf through the root's relay of the trailer;
  (c) 4 ranks on 2 x 2, heartbeat 0.3 s / timeout 3 s: SIGKILL of the
      local root (rank 2) at op 3; every survivor, its leaf included,
      raises WorldAbortedError naming rank 2 in time;
  (d) 3 ranks on 1 + 2 with ``HOROVOD_TPU_HIER_CONTROLLER=0``: a flat
      star, no migration and no aggregate.
"""

import json
import os
import pathlib
import signal
import socket
import sys
import time
import traceback

import numpy as np
import pytest
import torch

# -- frames ----------------------------------------------------------------
PACKS = [[], [b""], [b"alpha", b"", b"gamma" * 7],
         [bytes(range(256)) * 3, b"\x02", b"\xfe\x00"]]


@pytest.mark.parametrize("frames", PACKS,
                         ids=["empty", "one_empty", "three", "binary"])
def test_pack_frames_equal_the_reference(worlds, frames):
    """(The first test asks for the worlds, so that they run while the
    in-process tests do.) Every cut of the aggregate raises
    ConnectionError in both packages, and so do trailing bytes."""
    from horovod_tpu.common import controller as ref
    from horovod_tpu_torch.common import controller as port
    blob = port.pack_frames(frames)
    assert blob == ref.pack_frames(frames)
    assert port.unpack_frames(blob) == ref.unpack_frames(blob) == frames
    # a frame may be any contiguous host buffer
    assert port.pack_frames([torch.frombuffer(bytearray(f), dtype=torch.uint8)
                             if f else torch.empty(0, dtype=torch.uint8)
                             for f in frames]) == blob
    for cut in list(range(len(blob))) + [None]:
        bad = blob[:cut] if cut is not None else blob + b"x"
        for mod in (port, ref):
            with pytest.raises(ConnectionError):
                mod.unpack_frames(bad)


@pytest.mark.parametrize("ip", ["127.0.0.1", "127.8.9.10", "::1", "10.0.0.5",
                                "fe80::1", "::ffff:10.1.2.3", "not-an-ip", ""])
def test_dialable_leaf_ip_equals_the_reference(ip):
    from horovod_tpu.common.controller import _dialable_leaf_ip as ref
    from horovod_tpu_torch.common.controller import _dialable_leaf_ip
    assert _dialable_leaf_ip(ip) == ref(ip)
    if ip.startswith("127.") or ip == "::1":
        assert not _dialable_leaf_ip(ip)


HOSTS = [["a", "b", "b", "c", "b", "a", "c", "c", "d"],
         ["x"], ["x", "y"], ["x", "x", "y", "y", "y"],
         ["h0", "h1", "h1", "h2", "h2", "h2", "h2"]]


@pytest.mark.parametrize("hostnames", HOSTS)
def test_host_groups_and_topology_equal_the_reference(hostnames):
    from horovod_tpu.common import controller as ref
    from horovod_tpu_torch.common import controller as port
    assert port.host_groups(hostnames) == ref.host_groups(hostnames)
    fields = ("rank", "size", "local_rank", "local_size", "cross_rank",
              "cross_size", "is_homogeneous")
    for r in range(len(hostnames)):
        mine = port.compute_topology(r, hostnames)
        theirs = ref.compute_topology(r, hostnames)
        assert [getattr(mine, f) for f in fields] == \
            [getattr(theirs, f) for f in fields]


def test_the_knob_parses_as_the_reference(monkeypatch):
    from horovod_tpu.common.config import Config as RefConfig
    from horovod_tpu_torch.common import config
    assert "HOROVOD_TPU_HIER_CONTROLLER" not in config._NOT_PORTED
    for value in (None, "0", "1", "off", "yes"):
        if value is None:
            monkeypatch.delenv("HOROVOD_TPU_HIER_CONTROLLER", raising=False)
        else:
            monkeypatch.setenv("HOROVOD_TPU_HIER_CONTROLLER", value)
        mine = config.Config.from_env().hier_controller
        assert mine == RefConfig.from_env().hier_controller
        assert mine == (value in (None, "1", "yes"))


def _host_frames(seed):
    """{package: [frame of each rank of one host]}: the same seeded frames
    serialized by both packages. A host of 2 or 3 ranks whose frames are
    cache bitmask frames of one epoch (foldable) or a mix with a
    speculative, FULL or diverged-epoch frame (packed)."""
    from horovod_tpu.common import message as ref_msg
    from horovod_tpu.common import wire as ref_wire
    from horovod_tpu_torch.common import message as port_msg
    from horovod_tpu_torch.common import wire as port_wire
    rng = np.random.RandomState(seed)
    n = 2 + seed % 2
    kinds = ["cached"] * n
    odd = ["cached", "spec", "full", "epoch"][seed % 4]
    kinds[int(rng.randint(n))] = odd
    epoch, nslots = int(rng.randint(1 << 20)), int(rng.randint(1, 70))
    spec = [int(x) for x in rng.randint(0, 256, 16)]
    out = {}
    for impl, msg, wire in (("ref", ref_msg, ref_wire),
                            ("port", port_msg, port_wire)):
        r = np.random.RandomState(seed + 1)
        frames = []
        for rank, kind in enumerate(kinds):
            hit = int(r.randint(0, 1 << min(nslots, 60)))
            inv = int(r.randint(0, 1 << min(nslots, 60))) \
                if r.rand() < 0.3 else 0
            reqs = [msg.Request(
                request_rank=rank, request_type=msg.RequestType.ALLREDUCE,
                tensor_type=msg.DataType.FLOAT32, tensor_name=f"t{rank}.{i}",
                root_rank=-1, device=-1, tensor_shape=(3, rank + 1))
                for i in range(int(r.randint(0, 3)))]
            if kind == "full":
                obj = msg.RequestList(reqs, shutdown=False)
            elif kind == "spec":
                payload = np.asarray(spec, np.uint8) if impl == "ref" else \
                    torch.tensor(spec, dtype=torch.uint8)
                obj = msg.CacheCycleRequest(
                    epoch=epoch, nslots=nslots, hit_mask=hit,
                    spec_payload=[(msg.DataType.UINT8, payload)])
            else:
                obj = msg.CacheCycleRequest(
                    epoch=epoch + (kind == "epoch"), nslots=nslots,
                    hit_mask=hit, invalid_mask=inv, requests=reqs,
                    shutdown=bool(r.rand() < 0.2))
            frames.append(wire.serialize_cycle_request(obj))
        out[impl] = frames
    return out


def _root_shells(mod, frames, net):
    """A local root of ``mod`` (either package's TcpWorker, built without
    its handshake) whose leaves have sent ``frames[1:]`` over socket
    pairs: (root, the far end of its upward channel, the leaves' ends)."""
    w = mod.TcpWorker.__new__(mod.TcpWorker)
    w.topology = mod.Topology(rank=10, size=10 + len(frames))
    w._members = list(range(10, 10 + len(frames)))
    w._children, w._child_metrics, w._child_trace = {}, {}, []
    w._child_seen = {}
    w._child_fanout = None
    w._up_rank = 0
    w._hb_timeout, w._hb_interval, w._ping_seq, w._last_ping = 0, 0, 0, 0.0
    a, b = socket.socketpair()
    w._ch, up = net.Channel(a), net.Channel(b)
    leaves = []
    for r, f in zip(w._members[1:], frames[1:]):
        c, d = socket.socketpair()
        w._children[r] = net.Channel(c)
        leaves.append(d)
        net.Channel(d).send(f, mod.TAG_REQUESTS)
    return w, up, leaves


SEEDS = list(range(12))


@pytest.mark.parametrize("seed", SEEDS)
def test_a_local_roots_request_frame_equals_the_reference(seed):
    """The frame a local root sends up for its host (the fold into one
    CACHED_AGG frame, or the PACKED envelope over the host's frames)
    is the reference's byte for byte, and both coordinators spread it
    over the same slots."""
    from horovod_tpu.common import controller as ref
    from horovod_tpu.common import network as ref_net
    from horovod_tpu_torch.common import controller as port
    from horovod_tpu_torch.common import network as port_net
    from horovod_tpu_torch.common import wire
    frames = _host_frames(seed)
    sent = {}
    for impl, mod, net in (("ref", ref, ref_net), ("port", port, port_net)):
        root, up, leaves = _root_shells(mod, frames[impl], net)
        try:
            root._gather_up(frames[impl][0], mod.TAG_REQUESTS)
            tag, data = up.recv()
            assert tag == mod.TAG_REQUESTS
            sent[impl] = bytes(data)
        finally:
            root.close()
            up.close()
            for d in leaves:
                d.close()
    assert sent["port"] == sent["ref"]
    blob = sent["port"]
    n = len(frames["port"])
    folded = seed % 4 == 0
    if folded:
        assert blob[0] == wire.FRAME_CACHED_AGG
    else:
        assert blob[:1] == wire.PACKED_PREFIX
        assert port.unpack_frames(blob[1:]) == \
            [bytes(f) for f in frames["port"]]
        if n == 2:
            # a bare pack of two frames leads with the CACHED_AGG kind
            assert port.pack_frames(frames["port"])[0] == \
                wire.FRAME_CACHED_AGG
    # the coordinators' spread: own frame at 0, the host at 1..n
    members = {1: list(range(1, n + 1))}
    got = []
    for mod in (port, ref):
        c = mod.TcpCoordinator.__new__(mod.TcpCoordinator)
        c._members, c._has_aggregates = members, True
        got.append(c._expand([b"own", blob] + [b""] * (n - 1),
                             allow_combined=True))
    assert got[0] == got[1]
    if folded:
        assert got[0] == [b"own", blob] + [b""] * (n - 1)
    else:
        assert got[0] == [b"own"] + [bytes(f) for f in frames["port"]]


EXPAND_CASES = ["data", "packed", "folded", "bad_kind", "short", "truncated"]


@pytest.mark.parametrize("case", EXPAND_CASES)
def test_expand_equals_the_reference(case):
    """``_expand`` on built aggregates: data packs and PACKED envelopes
    spread over the members, a folded frame left in its owner's slot,
    and a bare pack on the request tag, a pack of the wrong count or a
    truncated one refused (ConnectionError) by both."""
    from horovod_tpu.common import controller as ref
    from horovod_tpu_torch.common import controller as port
    from horovod_tpu_torch.common import wire
    members = {1: [1], 2: [2, 3, 4], 5: [5, 6]}
    host2, host5 = [b"two", b"", b"four" * 9], [b"five", b"\x02six"]
    folded = bytes((wire.FRAME_CACHED_AGG,)) + b"\x00" * 20
    packed = {
        "data": (False, port.pack_frames(host2), port.pack_frames(host5)),
        "packed": (True, wire.PACKED_PREFIX + port.pack_frames(host2),
                   wire.PACKED_PREFIX + port.pack_frames(host5)),
        "folded": (True, folded, wire.PACKED_PREFIX
                   + port.pack_frames(host5)),
        "bad_kind": (True, port.pack_frames(host2), folded),
        "short": (False, port.pack_frames(host2[:2]),
                  port.pack_frames(host5)),
        "truncated": (False, port.pack_frames(host2)[:-3],
                      port.pack_frames(host5)),
    }[case]
    combined, agg2, agg5 = packed
    results = []
    for mod in (port, ref):
        c = mod.TcpCoordinator.__new__(mod.TcpCoordinator)
        c._members, c._has_aggregates = members, True
        out = [b"zero", b"one", agg2, b"", b"", agg5, b""]
        try:
            results.append(c._expand(out, allow_combined=combined))
        except ConnectionError:
            results.append("refused")
    assert results[0] == results[1]
    if case in ("bad_kind", "short", "truncated"):
        assert results[0] == "refused"
    elif case == "folded":
        assert results[0] == [b"zero", b"one", folded, b"", b""] + host5
    else:
        assert results[0] == [b"zero", b"one"] + host2 + host5


# -- the spawned worlds ----------------------------------------------------
HB_ENV = {"HOROVOD_HEARTBEAT_INTERVAL": "0.3",
          "HOROVOD_HEARTBEAT_TIMEOUT": "3"}
HB_TIMEOUT_S = 3.0
SLACK_S = 4.0  # as tests/test_torch_faults.py
STEADY = 24
SUMMED = ["hvd_bytes_allreduced_total", 'hvd_ops_total{op="allreduce"}',
          "hvd_cached_cycles_total", "hvd_fused_spec_cycles_total"]
AUTOTUNE_ENV = {"HOROVOD_AUTOTUNE": "1",
                "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "1",
                "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": "2",
                "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": "3"}


def _shape(hvd, ctl):
    """The tree as this rank sees it."""
    if hvd.rank() == 0:
        return {"channels": sorted(ctl._channels),
                "members": {str(o): ms for o, ms in ctl._members.items()},
                "aggregates": ctl._has_aggregates}
    return {"children": sorted(ctl._children), "up": ctl._up_rank,
            "up_ip": ctl._ch.sock.getpeername()[0]}


def _collectives(hvd, rank, size):
    """The reference's scenario_hier_controller on torch tensors: each
    result equal to its closed form, or an AssertionError."""
    ssum = sum(range(1, size + 1))
    hs = [hvd.allreduce_async(torch.full((8,), float(rank + 1) * (i + 1),
                                         dtype=torch.float64),
                              op=hvd.Sum, name=f"hc/ar{i}")
          for i in range(12)]
    for i, h in enumerate(hs):
        assert torch.equal(hvd.synchronize(h), torch.full(
            (8,), float(ssum * (i + 1)), dtype=torch.float64)), i
    out = hvd.allgather(torch.full((rank + 1, 2), float(rank)), name="hc/ag")
    off = 0
    for r in range(size):
        assert torch.equal(out[off:off + r + 1], torch.full((r + 1, 2),
                                                            float(r)))
        off += r + 1
    for root in range(size):
        got = hvd.broadcast(torch.full((5,), float(rank * 10),
                                       dtype=torch.float64), root,
                            name=f"hc/bc{root}")
        assert torch.equal(got, torch.full((5,), float(root * 10),
                                           dtype=torch.float64)), root
    x = torch.arange(size * 2, dtype=torch.float32) + 100 * rank
    want = torch.cat([torch.arange(rank * 2, rank * 2 + 2,
                                   dtype=torch.float32) + 100 * s
                      for s in range(size)])
    assert torch.equal(hvd.alltoall(x, name="hc/a2a"), want)
    x = torch.arange(size * 3, dtype=torch.float32) * (rank + 1)
    assert torch.equal(hvd.reducescatter(x, name="hc/rs", op=hvd.Sum),
                       torch.arange(rank * 3, rank * 3 + 3,
                                    dtype=torch.float32) * ssum)
    hvd.barrier()


def _storm(hvd, rank, size):
    """The reference's scenario_mixed_op_storm: 30 collectives submitted
    in another order on every rank, each equal to its closed form."""
    rng = np.random.RandomState(1000 + rank)
    ssum = sum(range(1, size + 1))
    jobs = [(k, i) for i in range(10) for k in ("ar", "bc", "ag")]
    handles = {}
    for idx in rng.permutation(len(jobs)):
        kind, i = jobs[idx]
        if kind == "ar":
            handles[kind, i] = hvd.allreduce_async(
                torch.full((64 + i,), float(rank + 1) * (i + 1),
                           dtype=torch.float64), op=hvd.Sum,
                name=f"storm.ar{i}")
        elif kind == "bc":
            handles[kind, i] = hvd.broadcast_async(
                torch.full((8,), float(rank * 100 + i)), i % size,
                name=f"storm.bc{i}")
        else:
            handles[kind, i] = hvd.allgather_async(
                torch.full((rank + 1, 2), float(rank * 10 + i)),
                name=f"storm.ag{i}")
    for i in range(10):
        assert torch.equal(hvd.synchronize(handles["ar", i]), torch.full(
            (64 + i,), float(ssum * (i + 1)), dtype=torch.float64))
        assert torch.equal(hvd.synchronize(handles["bc", i]), torch.full(
            (8,), float((i % size) * 100 + i)))
        g = hvd.synchronize(handles["ag", i])
        want = torch.cat([torch.full((r + 1, 2), float(r * 10 + i))
                          for r in range(size)])
        assert torch.equal(g, want), i


def _count_folds(ctl, counts):
    """Wrap the coordinator's ``_expand`` to count the folded CACHED_AGG
    frames it is handed (the reference keeps no such counter)."""
    from horovod_tpu_torch.common import wire
    expand = ctl._expand

    def counting(out, allow_combined=False):
        if allow_combined:
            for owner, ms in ctl._members.items():
                if len(ms) > 1 and out[owner][:1] == wire.CACHED_AGG_PREFIX:
                    counts["folded"] += 1
        return expand(out, allow_combined)

    ctl._expand = counting


def _world_a(hvd, rt, rank, size, result):
    ctl = rt.controller
    counts = {"folded": 0}
    if rank == 0:
        _count_folds(ctl, counts)
    _collectives(hvd, rank, size)
    st = rt.stats
    before = (st["cached_cycles"], st["spec_cycles"])
    x = torch.full((256,), float(rank + 1), dtype=torch.float64)
    want = torch.full((256,), float(sum(range(1, size + 1))),
                      dtype=torch.float64)
    for _ in range(STEADY):
        assert torch.equal(hvd.allreduce(x, op=hvd.Sum, name="hc.steady"),
                           want)
    result.update(cached=st["cached_cycles"] - before[0],
                  spec=st["spec_cycles"] - before[1])
    local = hvd.metrics()["local"]
    mine = [local[n]["v"] for n in SUMMED]
    ranks = hvd.allgather(torch.tensor([mine], dtype=torch.float64),
                          name="hc.locals").tolist()
    if rank == 0:
        want_sums = [sum(r[i] for r in ranks) for i in range(len(SUMMED))]
        deadline = time.monotonic() + 20.0
        while True:
            world = hvd.metrics()["world"]
            got = [world.get(n, {}).get("v") for n in SUMMED]
            reporting = world["hvd_ranks_reporting"]["v"]
            if (got == want_sums and reporting == size) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.02)
        result.update(world_sums=got, want_sums=want_sums,
                      reporting=reporting, folded=counts["folded"],
                      owners=sorted(rt._aggregator._owners))
    # the workers' shutdown would end the world under rank 0's reads
    hvd.barrier()


def _world_b(hvd, rt, rank, size, result):
    _storm(hvd, rank, size)
    pm = rt.parameter_manager
    x = torch.full((4096,), float(rank + 1))
    steps = None
    for i in range(400):
        hvd.allreduce(x, op=hvd.Sum, name=f"at.{i}")
        flag = torch.tensor([float(rank == 0 and not pm.tuning)])
        if hvd.broadcast(flag, 0, name=f"at.done/{i}").item() == 1.0:
            steps = i + 1
            break
    hvd.barrier()
    tuned = hvd.broadcast(torch.tensor(
        [float(pm.fusion_threshold_bytes()), pm.cycle_time_ms()],
        dtype=torch.float64), 0, name="at.vals")
    result.update(steps=steps, tuned=tuned.tolist(),
                  mine=[float(pm.fusion_threshold_bytes()),
                        pm.cycle_time_ms()],
                  cached=rt.stats["cached_cycles"])


def _world_c(hvd, rt, rank, size, result):
    x = torch.full((64,), float(rank + 1))
    want = torch.full((64,), float(sum(range(1, size + 1))))
    t_start = last_ok = time.monotonic()
    ops = 0
    try:
        while True:
            got = hvd.allreduce(x, op=hvd.Sum, name=f"ab/{ops}")
            assert torch.equal(got, want), (got, want)
            last_ok = time.monotonic()
            ops += 1
            if last_ok - t_start > 60:
                raise AssertionError("collectives kept succeeding")
    except hvd.HorovodInternalError as e:
        result.update(raised=type(e).__name__, message=str(e),
                      origin=getattr(e, "origin_rank", None),
                      after_last_ok=time.monotonic() - last_ok, ops=ops)


def _world_d(hvd, rt, rank, size, result):
    got = hvd.allreduce(torch.full((6,), float(rank + 1)), op=hvd.Sum,
                        name="flat/ar")
    assert torch.equal(got, torch.full((6,), float(sum(range(1, size + 1)))))


def _world_main(kind: str, out_dir: str) -> int:
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    hvd.init(device="cpu")
    rank, size = hvd.rank(), hvd.size()
    rt = basics.runtime()
    result = {"rank": rank, "shape": _shape(hvd, rt.controller)}
    {"a": _world_a, "b": _world_b, "c": _world_c, "d": _world_d}[kind](
        hvd, rt, rank, size, result)
    hvd.shutdown()
    with open(os.path.join(out_dir, f"result{rank}.json"), "w") as f:
        json.dump(result, f)
    return 0


# World -> (ranks, ranks on the first host, extra environment).
WORLDS = {
    "a": (5, 2, {"HOROVOD_TPU_METRICS": 1,
                 "HOROVOD_TPU_METRICS_INTERVAL": 0.02,
                 "HOROVOD_TPU_TRACE_INTERVAL": 0.02}),
    "b": (4, 2, dict(AUTOTUNE_ENV, HOROVOD_CACHE_ENABLED=0)),
    "c": (4, 2, dict(HB_ENV, HOROVOD_FAULT_SPEC="rank=2:kill:op=3")),
    "d": (3, 1, {"HOROVOD_TPU_HIER_CONTROLLER": 0}),
}
# One deadline for the four worlds together, from their start (16 ranks
# at once; about 10 s on an 8-core host).
WORLDS_DEADLINE_S = 75.0


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    from tests.torch_worlds import Worlds, child_env
    spawned = Worlds(WORLDS_DEADLINE_S)
    try:
        for kind, (n, first, extra) in WORLDS.items():
            out = tmp_path_factory.mktemp(f"hier_{kind}")
            port = spawned.reserve_port()
            extra = dict(extra)
            if kind == "a":
                extra["HOROVOD_TPU_TRACE"] = out / "trace.json"
            envs = [child_env(**extra, HOROVOD_RANK=r, HOROVOD_SIZE=n,
                              HOROVOD_HOSTNAME=f"fakehost{int(r >= first)}",
                              HOROVOD_CONTROLLER_ADDR="127.0.0.1",
                              HOROVOD_CONTROLLER_PORT=port,
                              HOROVOD_CYCLE_TIME=2)
                    for r in range(n)]
            spawned.start(kind, out, [[pathlib.Path(__file__), kind, out]] * n,
                          envs)
        yield spawned
    finally:
        spawned.close()


def _results(worlds, kind, expect_rc=None):
    n = WORLDS[kind][0]
    rcs, results, logs = worlds.wait(kind)
    logs = "\n".join(logs)
    expect = [0] * n
    for r, rc in (expect_rc or {}).items():
        expect[r] = rc
    assert rcs == expect, logs
    return results, logs


def test_remote_leaves_sit_behind_their_local_root(worlds):
    """World (a): fan-in (host-0 ranks - 1) + (remote hosts) = 2; the
    remote host's leaves talk only to their root over loopback; every
    collective and a broadcast from every root exact (each rank raises
    otherwise)."""
    results, logs = _results(worlds, "a")
    r0 = results[0]
    assert r0["shape"] == {"channels": [1, 2],
                           "members": {"1": [1], "2": [2, 3, 4]},
                           "aggregates": True}, r0
    assert results[1]["shape"]["children"] == [] and \
        results[1]["shape"]["up"] == 0
    assert results[2]["shape"]["children"] == [3, 4] and \
        results[2]["shape"]["up"] == 0
    for r in (3, 4):
        assert results[r]["shape"] == {"children": [], "up": 2,
                                       "up_ip": "127.0.0.1"}, results[r]


def test_cached_and_speculative_cycles_run_through_the_folded_host(worlds):
    """World (a)'s steady state: every rank ran cached and speculative
    cycles (each result exact), and the coordinator took the folded
    host's CACHED_AGG frames."""
    results, logs = _results(worlds, "a")
    for r in results:
        assert r["cached"] >= STEADY // 2 and r["spec"] >= STEADY // 2, r
    assert results[0]["folded"] >= 1, results[0]


def test_world_metrics_add_up_through_the_roots_fold(worlds):
    results, logs = _results(worlds, "a")
    r0 = results[0]
    assert r0["world_sums"] == r0["want_sums"], r0
    assert r0["reporting"] == 5
    # the aggregator holds one frame a channel: the local root's answers
    # for its host
    assert r0["owners"] == [1, 2], r0


def test_world_trace_has_a_track_per_rank(worlds):
    _results(worlds, "a")
    events = json.loads((worlds.out("a") / "trace.json").read_text())
    names = {e["pid"]: e["args"]["name"] for e in events
             if e.get("name") == "process_name"}
    assert names == {r: f"rank {r}" for r in range(5)}
    for r in range(5):
        wcs = [e["args"]["wc"] for e in events
               if e.get("pid") == r and e.get("name") == "ROUND"]
        assert wcs and wcs == sorted(set(wcs)), (r, wcs[:20])


def test_unfolded_frames_ride_the_packed_envelope(worlds):
    """World (b), cache off: the mixed-op storm through the PACKED
    envelope (each rank's results exact), then autotune's values reach
    every rank, the migrated leaf (rank 3) through its root's relay."""
    results, logs = _results(worlds, "b")
    r0 = results[0]
    assert r0["shape"]["members"] == {"1": [1], "2": [2, 3]}, r0
    assert results[3]["shape"]["up"] == 2
    assert r0["steps"] is not None, "no convergence within the op budget"
    for r in results:
        assert r["steps"] == r0["steps"] and r["cached"] == 0, r
        assert r["mine"] == r0["tuned"] == r["tuned"], results


def test_a_dead_local_root_is_named_by_every_survivor(worlds):
    """World (c): rank 2, the second host's root, killed at op 3; rank 3
    below it finds its upward channel dead, ranks 0 and 1 learn it from
    the coordinator; each raises WorldAbortedError naming rank 2 in
    time."""
    results, logs = _results(worlds, "c", {2: -signal.SIGKILL})
    assert results[2] is None
    for r in (0, 1, 3):
        res = results[r]
        assert res["raised"] == "WorldAbortedError", res
        assert res["origin"] == 2 and "rank 2" in res["message"], res
        assert res["after_last_ok"] < HB_TIMEOUT_S + SLACK_S, res
    assert results[3]["shape"]["up"] == 2


def test_the_knob_off_keeps_the_flat_star(worlds):
    """World (d), HOROVOD_TPU_HIER_CONTROLLER=0 on 1 + 2 hosts: every
    worker on its own channel, no aggregate, nobody migrated."""
    results, logs = _results(worlds, "d")
    assert results[0]["shape"] == {"channels": [1, 2],
                                   "members": {"1": [1], "2": [2]},
                                   "aggregates": False}
    for r in (1, 2):
        assert results[r]["shape"]["children"] == [] and \
            results[r]["shape"]["up"] == 0


if __name__ == "__main__":
    try:
        sys.exit(_world_main(sys.argv[1], sys.argv[2]))
    except Exception:
        traceback.print_exc()
        sys.exit(1)
