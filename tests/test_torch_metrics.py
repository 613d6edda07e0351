"""The port's metrics plane against the JAX package's, and both
observability planes in a spawned world.

- METRICS frames, bit for bit: the same snapshots give the same bytes
  (``common/wire.py``), each side parses and combines the other's.
- The registry: ``snapshot``, ``merge_into`` and ``render_prometheus``
  equal the reference's after the same ``inc``, ``set`` and
  ``observe`` calls; ``WorldAggregator.world()`` equals the
  reference's for the same ingested frames (garbled and mismatched
  frames included); the HTTP endpoint serves the same text.
- The disabled path: every instrumented call site of the runtime, the
  controller, the operation manager and the backends holds
  ``NOOP_METRIC``, as the reference's test asserts.
- The knobs parse as the reference's; HOROVOD_TPU_METRICS and
  HOROVOD_TPU_TRACE no longer raise, the rest of ``_NOT_PORTED`` does.
- A spawned 3-rank world with both planes on (this file run as a script
  is a rank, started by a module fixture under one shared deadline):
  rank 0's world view is the sum of the ranks' counts, ``GET /metrics``
  on an ephemeral port says the same, and the merged trace has one
  track per rank with the same round numbers on every rank.

Inputs come from a numpy seed; every comparison is exact.
"""

import json
import os
import pathlib
import sys
import time
import traceback
import urllib.request

import numpy as np
import pytest
import torch

SEED = 2507


def _snapshot(rng, n: int, labels: bool = True) -> dict:
    snap = {}
    for i in range(n):
        name = f"hvd_m{i}" + ('{peer="%d"}' % i if labels and i % 3 == 0
                              else "")
        kind = "cgh"[int(rng.integers(0, 3))]
        if kind == "c":
            snap[name] = {"k": "c", "v": float(rng.integers(0, 10 ** 6))}
        elif kind == "g":
            snap[name] = {"k": "g", "agg": ("sum", "max")[i % 2],
                          "v": float(rng.standard_normal())}
        else:
            bounds = sorted({float(b) for b in rng.random(4)})
            counts = [int(c) for c in rng.integers(0, 50, len(bounds) + 1)]
            snap[name] = {"k": "h", "bounds": bounds, "counts": counts,
                          "sum": float(rng.random() * 9),
                          "count": sum(counts)}
    return snap


@pytest.mark.parametrize("n", [0, 1, 7])
def test_metrics_frames_equal_the_reference(world, n):
    """(The first test asks for the world, so that it runs while the
    in-process tests do.)"""
    from horovod_tpu.common import wire as ref
    from horovod_tpu_torch.common import wire
    rng = np.random.default_rng(SEED + n)
    snap = _snapshot(rng, n)
    mine = wire.serialize_metrics_frame(3, snap)
    assert mine == ref.serialize_metrics_frame(3, snap)
    assert wire.parse_metrics_frame(mine) == ref.parse_metrics_frame(mine) \
        == (3, snap)
    other = ref.serialize_metrics_frame(2, snap)
    assert wire.combine_metrics_frames([mine, other]) == \
        ref.combine_metrics_frames([mine, other])
    bad = b"\x01\x00"
    assert wire.combine_metrics_frames([mine, bad], drop_incompatible=True) \
        == ref.combine_metrics_frames([mine, bad], drop_incompatible=True)
    for cut in range(1, len(mine)):
        for parse in (wire.parse_metrics_frame, ref.parse_metrics_frame):
            with pytest.raises(Exception):
                parse(mine[:cut])


def _drive(reg, rng, rounds: int = 200):
    """The same calls on either package's registry."""
    c = [reg.counter(f"hvd_c{i}", "a counter") for i in range(3)]
    c.append(reg.counter('hvd_ops_total{op="allreduce"}'))
    g = [reg.gauge("hvd_g", "a gauge"),
         reg.gauge('hvd_age{peer="1"}', "oldest", agg="max")]
    h = [reg.histogram("hvd_h", "latency"),
         reg.histogram('hvd_r{op="x"}', "ratio", (0.1, 0.5, 1.0))]
    for _ in range(rounds):
        k = int(rng.integers(0, 3))
        if k == 0:
            c[int(rng.integers(0, 4))].inc(float(rng.integers(1, 9)))
        elif k == 1:
            g[int(rng.integers(0, 2))].set(float(rng.standard_normal()))
        else:
            h[int(rng.integers(0, 2))].observe(float(rng.random() * 2))
    c[0].set_total(12345)


def test_registry_equals_the_reference():
    from horovod_tpu.common import metrics as rmetrics
    from horovod_tpu_torch.common import metrics as hmetrics
    snaps = []
    for mod in (hmetrics, rmetrics):
        reg = mod.MetricsRegistry()
        _drive(reg, np.random.default_rng(SEED))
        snaps.append(reg.snapshot())
        with pytest.raises(ValueError):
            reg.gauge("hvd_c0")  # a name keeps its kind
        with pytest.raises(ValueError):
            reg.gauge("hvd_g", agg="max")
    mine, ref = snaps
    assert mine == ref
    assert hmetrics.render_prometheus(mine) == \
        rmetrics.render_prometheus(ref)
    folded = [mod.merge_into(mod.merge_into({}, s), s)
              for mod, s in ((hmetrics, mine), (rmetrics, ref))]
    assert folded[0] == folded[1]
    assert hmetrics.render_prometheus(folded[0]) == \
        rmetrics.render_prometheus(folded[1])
    assert hmetrics.LATENCY_BUCKETS == rmetrics.LATENCY_BUCKETS
    assert hmetrics.RATIO_BUCKETS == rmetrics.RATIO_BUCKETS


def test_world_aggregator_equals_the_reference():
    from horovod_tpu.common import metrics as rmetrics
    from horovod_tpu.common import wire as rwire
    from horovod_tpu_torch.common import metrics as hmetrics
    rng = np.random.default_rng(SEED)
    snaps = [_snapshot(np.random.default_rng(SEED), 6) for _ in range(4)]
    for s in snaps[1:]:
        for rec in s.values():
            if rec["k"] != "h":
                rec["v"] = float(rng.integers(0, 100))
    clash = {next(iter(snaps[0])): {"k": "g", "agg": "sum", "v": 1.0}}
    if snaps[0][next(iter(snaps[0]))]["k"] == "g":
        clash = {next(iter(snaps[0])): {"k": "c", "v": 1.0}}
    frames = [(1, rwire.serialize_metrics_frame(1, snaps[1])),
              (2, rwire.serialize_metrics_frame(2, snaps[2])),
              (1, rwire.serialize_metrics_frame(1, snaps[3])),  # latest wins
              (3, b"garbled"),
              (3, rwire.serialize_metrics_frame(1, clash))]
    worlds = []
    for mod in (hmetrics, rmetrics):
        agg = mod.WorldAggregator(size=4)
        agg.update_local(snaps[0])
        for owner, payload in frames:
            agg.ingest(owner, payload)
        worlds.append(agg.world())
    assert worlds[0] == worlds[1]
    assert worlds[0]["hvd_ranks_reporting"]["v"] == 4.0


def test_metrics_http_serves_prometheus_and_json():
    from horovod_tpu.common import metrics as rmetrics
    from horovod_tpu_torch.common import metrics as hmetrics
    reg = hmetrics.MetricsRegistry()
    _drive(reg, np.random.default_rng(SEED), rounds=50)
    snap = reg.snapshot()
    srv = hmetrics.MetricsHTTPServer(lambda: snap, port=0, host="127.0.0.1")
    try:
        base = f"http://127.0.0.1:{srv.port}"
        text = urllib.request.urlopen(base + "/metrics", timeout=5).read()
        assert text.decode() == rmetrics.render_prometheus(snap)
        got = json.loads(urllib.request.urlopen(base + "/metrics.json",
                                                timeout=5).read())
        assert got == snap
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/other", timeout=5)
    finally:
        srv.close()


def test_disabled_metrics_installs_noop_hooks_everywhere(monkeypatch):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.common import metrics as hm
    from horovod_tpu_torch.common import trace as htrace
    for name in ("HOROVOD_TPU_METRICS", "HOROVOD_TPU_TRACE"):
        monkeypatch.delenv(name, raising=False)
    hvd.init(device="cpu")
    try:
        rt = basics.runtime()
        assert rt.metrics is hm.NOOP_REGISTRY and not rt._metrics_on
        sites = [n for n in dir(rt) if n.startswith("_m_")]
        assert len(sites) >= 15, sites
        for n in sites:
            assert getattr(rt, n) is hm.NOOP_METRIC, n
        om = rt.op_manager
        assert not om._metrics_on and om._m_fill is hm.NOOP_METRIC
        for m in (list(om._m_ops.values()) + list(om._m_bytes.values())
                  + list(om._m_wall.values())):
            assert m is hm.NOOP_METRIC
        for b in om.backends:
            assert b.m_ops is hm.NOOP_METRIC, b.name
            assert b.m_bytes is hm.NOOP_METRIC, b.name
        ctl = rt.controller
        assert not ctl._metrics_on
        assert ctl._m_ctrl_rx is hm.NOOP_METRIC
        assert ctl._m_ctrl_tx is hm.NOOP_METRIC
        assert ctl._on_arrivals is None and not ctl._trace_on
        assert rt._aggregator is None and rt._metrics_http is None
        assert rt._trace is htrace.NOOP_TRACE and rt._straggler is None
        hvd.allreduce(torch.ones(4), name="noop.a")
        view = hvd.metrics()
        assert view == {"enabled": False, "local": {}, "world": None,
                        "http_port": None}
    finally:
        hvd.shutdown()


KNOB_CASES = [
    {},
    {"HOROVOD_TPU_METRICS": "1", "HOROVOD_TPU_METRICS_INTERVAL": "0.25",
     "HOROVOD_TPU_METRICS_PORT": "0", "HOROVOD_TPU_METRICS_ADDR": "127.0.0.1",
     "HOROVOD_TPU_METRICS_LOG": "/tmp/m.jsonl"},
    {"HOROVOD_TPU_METRICS": "yes", "HOROVOD_TPU_METRICS_INTERVAL": "bad",
     "HOROVOD_TPU_METRICS_PORT": "x", "HOROVOD_TPU_TRACE": "/tmp/t.json",
     "HOROVOD_TPU_TRACE_INTERVAL": "0.5"},
    {"HOROVOD_TPU_METRICS": "0", "HOROVOD_TPU_METRICS_PORT": "-1",
     "HOROVOD_TPU_TRACE": "", "HOROVOD_TPU_TRACE_INTERVAL": ""},
]
FIELDS = ("metrics_enabled", "metrics_interval_s", "metrics_port",
          "metrics_addr", "metrics_log", "trace_path", "trace_interval_s")


@pytest.mark.parametrize("case", range(len(KNOB_CASES)))
def test_knobs_parse_as_the_reference(monkeypatch, case):
    from horovod_tpu.common.config import Config as RefConfig
    from horovod_tpu_torch.common.config import Config
    for name in {k for c in KNOB_CASES for k in c}:
        monkeypatch.delenv(name, raising=False)
    for name, value in KNOB_CASES[case].items():
        monkeypatch.setenv(name, value)
    mine, ref = Config.from_env(), RefConfig.from_env()
    assert [getattr(mine, f) for f in FIELDS] == \
        [getattr(ref, f) for f in FIELDS]


def test_the_other_unported_knobs_still_raise(monkeypatch):
    from horovod_tpu_torch.common import config
    assert "HOROVOD_TPU_METRICS" not in config._NOT_PORTED
    assert "HOROVOD_TPU_TRACE" not in config._NOT_PORTED
    values = {"HOROVOD_TPU_RING_THRESHOLD": "0",
              "HOROVOD_OVERLAP_BUCKETS": "2", "HOROVOD_OVERLAP_BYTES": "9"}
    for name in config._NOT_PORTED:
        monkeypatch.delenv(name, raising=False)
    for name in config._NOT_PORTED:
        monkeypatch.setenv(name, values.get(name, "1"))
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            config.Config.from_env()
        monkeypatch.delenv(name)
    config.Config.from_env()


# -- the spawned world -----------------------------------------------------
STEPS = 24
# The world series that stop with the work: rank 0 holds them to the sums
# of the ranks' own counts.
SUMMED = ["hvd_bytes_allreduced_total", 'hvd_ops_total{op="allreduce"}',
          "hvd_cached_cycles_total", "hvd_fused_spec_cycles_total"]
WORLD_SIZE = 3
# One deadline for the world from its start (about 4 s on an 8-core host).
WORLD_DEADLINE_S = 45.0


def _folded_cycles(agg):
    """({rank: hvd_cycles_total of the latest snapshot rank 0 holds of
    it}, the world's hvd_cycles_total), read with no frame folded in
    between (the counts only rise, so equal reads around the fold mean
    it folded those)."""
    def latest():
        with agg._lock:
            out = {r: snap["hvd_cycles_total"]["v"]
                   for r, (_, snap, _) in agg._owners.items()}
            out[0] = agg._local["hvd_cycles_total"]["v"]
        return out
    while True:
        before = latest()
        world = agg.world()["hvd_cycles_total"]["v"]
        if latest() == before:
            return before, world


def _world_main(out_dir: str) -> int:
    """One rank with both planes on: allreduces of one name (classic,
    then cached and speculative), the ranks' own counts allgathered, and
    on rank 0 the world view polled until it is their sum."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    hvd.init(device="cpu")
    rank, size = hvd.rank(), hvd.size()
    rt = basics.runtime()
    x = torch.full((256,), float(rank + 1), dtype=torch.float64)
    want = torch.full((256,), float(sum(range(1, size + 1))),
                      dtype=torch.float64)
    for _ in range(STEPS):
        assert torch.equal(hvd.allreduce(x, op=hvd.Sum, name="mw.steady"),
                           want)
    view = hvd.metrics()
    local = view["local"]
    st = rt.stats
    mine = [local["hvd_bytes_allreduced_total"]["v"],
            local['hvd_ops_total{op="allreduce"}']["v"],
            float(st["cached_cycles"]), float(st["spec_cycles"]),
            float(st["cycles"])]
    result = {"rank": rank, "local": mine, "http_port": view["http_port"]}
    ranks = hvd.allgather(torch.tensor([mine], dtype=torch.float64),
                          name="mw.locals").tolist()
    result["ranks"] = ranks
    if rank == 0:
        want_sums = [sum(r[i] for r in ranks) for i in range(4)]
        names = SUMMED
        # hvd_cycles_total goes on with the idle rounds: polled until each
        # rank's latest snapshot is from its allgather above or later,
        # read with no frame folded in between, and held to their sum
        at_gather = {r: ranks[r][4] for r in range(size)}
        agg = rt._aggregator
        deadline = time.monotonic() + 20.0
        while True:
            world = hvd.metrics()["world"]
            got = [world.get(n, {}).get("v") for n in names]
            folded, cycles = _folded_cycles(agg)
            fresh = folded.keys() == at_gather.keys() and all(
                folded[r] >= c for r, c in at_gather.items())
            if (got == want_sums and fresh
                    and world["hvd_ranks_reporting"]["v"] == size) \
                    or time.monotonic() > deadline:
                break
            time.sleep(0.02)
        result.update(world_sums=got, want_sums=want_sums,
                      reporting=world["hvd_ranks_reporting"]["v"],
                      world_cycles=cycles, fresh=fresh,
                      folded_cycles=list(folded.values()))
        text = urllib.request.urlopen(
            f"http://127.0.0.1:{view['http_port']}/metrics",
            timeout=10).read().decode()
        result["scrape"] = [line for line in text.splitlines()
                            if line.split(" ")[0] in names
                            or line.startswith("# TYPE hvd_cycles_total")]
        result["straggler"] = rt._straggler.window_stats()["gathers"]
    # the workers' shutdown would end the world under rank 0's reads
    hvd.barrier()
    hvd.shutdown()
    with open(os.path.join(out_dir, f"result{rank}.json"), "w") as f:
        json.dump(result, f)
    return 0


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from tests.torch_worlds import Worlds, child_env
    spawned = Worlds(WORLD_DEADLINE_S)
    try:
        out = tmp_path_factory.mktemp("planes")
        port = spawned.reserve_port()
        envs = [child_env(HOROVOD_RANK=r, HOROVOD_SIZE=WORLD_SIZE,
                          HOROVOD_CONTROLLER_ADDR="127.0.0.1",
                          HOROVOD_CONTROLLER_PORT=port,
                          HOROVOD_CYCLE_TIME=2,
                          HOROVOD_TPU_METRICS=1,
                          HOROVOD_TPU_METRICS_INTERVAL=0.02,
                          HOROVOD_TPU_METRICS_PORT=0,
                          HOROVOD_TPU_METRICS_ADDR="127.0.0.1",
                          HOROVOD_TPU_METRICS_LOG=out / "metrics.jsonl",
                          HOROVOD_TPU_TRACE=out / "trace.json",
                          HOROVOD_TPU_TRACE_INTERVAL=0.02,
                          HOROVOD_TPU_FLIGHT_DIR=out)
                for r in range(WORLD_SIZE)]
        argv = [pathlib.Path(__file__), out]
        spawned.start("planes", out, [argv] * WORLD_SIZE, envs)
        yield spawned
    finally:
        spawned.close()


def test_world_metrics_add_up(world):
    rcs, results, logs = world.wait("planes")
    logs = "\n".join(logs)
    assert rcs == [0] * WORLD_SIZE and None not in results, logs
    r0 = results[0]
    assert r0["world_sums"] == r0["want_sums"], r0
    assert r0["reporting"] == WORLD_SIZE
    # every rank moved the same allreduce bytes; the steady state went
    # through the cache and the fused speculative round
    nbytes = 256 * 8 * STEPS
    assert [r["local"][0] for r in results] == [nbytes] * WORLD_SIZE
    assert [r["local"][1] for r in results] == [STEPS] * WORLD_SIZE
    assert min(r["local"][2] for r in results) >= STEPS // 2, results
    assert min(r["local"][3] for r in results) >= STEPS // 2, results
    assert r0["fresh"] and len(r0["folded_cycles"]) == WORLD_SIZE, r0
    assert r0["world_cycles"] == sum(r0["folded_cycles"]), r0
    assert r0["straggler"] > 0
    # GET /metrics says what hvd.metrics() said
    scraped = {line.split(" ")[0]: float(line.split(" ")[1])
               for line in r0["scrape"] if not line.startswith("#")}
    assert scraped == dict(zip(SUMMED, r0["want_sums"])), r0["scrape"]
    assert "# TYPE hvd_cycles_total counter" in r0["scrape"]
    assert [r["http_port"] is not None for r in results] == \
        [True] + [False] * (WORLD_SIZE - 1)
    lines = (world.out("planes") / "metrics.jsonl").read_text().splitlines()
    assert lines and "hvd_cycles_total" in json.loads(lines[-1])["world"]
    # no abort: no flight dump
    assert not list(world.out("planes").glob("hvd-flight-*"))


def test_world_trace_has_a_track_per_rank(world):
    rcs, _, logs = world.wait("planes")
    logs = "\n".join(logs)
    assert rcs == [0] * WORLD_SIZE, logs
    events = json.loads((world.out("planes") / "trace.json").read_text())
    names = {e["pid"]: e["args"]["name"] for e in events
             if e.get("name") == "process_name"}
    assert names == {r: f"rank {r}" for r in range(WORLD_SIZE)}
    spans = [e for e in events if e.get("ph") in ("X", "i")]
    rounds = {r: [e["args"]["wc"] for e in spans
                  if e["pid"] == r and e["name"] == "ROUND"]
              for r in range(WORLD_SIZE)}
    for r, wcs in rounds.items():
        assert wcs and wcs == sorted(set(wcs)), (r, wcs[:20])
    # the batches executed the classic way carry the same round numbers
    # on every rank (a worker's tail may miss the file: compare prefixes)
    execs = {r: [e["args"]["wc"] for e in spans
                 if e["pid"] == r and e["name"].startswith("ALLREDUCE x")]
             for r in range(WORLD_SIZE)}
    n = min(len(v) for v in execs.values())
    assert n >= 2, execs
    assert all(v[:n] == execs[0][:n] for v in execs.values()), execs
    # each track in the coordinator's clock never runs backwards
    for r in range(WORLD_SIZE):
        ts = [e["ts"] for e in spans if e["pid"] == r]
        assert ts == sorted(ts), r


if __name__ == "__main__":
    try:
        sys.exit(_world_main(sys.argv[1]))
    except Exception:
        traceback.print_exc()
        sys.exit(1)
