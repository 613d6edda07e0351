"""The port's trace plane against the JAX package's.

- TRACE frames, bit for bit: the same sections give the same bytes
  (``common/wire.py``), each side parses and combines the other's, and
  a truncated frame raises on both.
- ``ClockSync``: the same offsets from the same stamp series.
- ``StragglerTracker``: the same window statistics, report line and
  metrics after the same gathers.
- ``WorldTraceWriter``: the same Chrome-trace events from the same
  sections, clock echoes and start time.
- ``FlightRecorder``: the same dump from the same events at the same
  clock readings, the pid, the wall clock and the build line left out;
  SIGUSR2 dumps; ``HOROVOD_TPU_FLIGHT=0`` hands out the no-op recorder.
- ``build_info``: the port's version, no native core, the reference's
  knobs digest.

Inputs come from a numpy seed; every comparison is exact.
"""

import json
import os
import signal
import time

import numpy as np
import pytest

SEED = 2510


def _sections(rng, nsec: int):
    out = []
    for s in range(nsec):
        echo = None
        if rng.random() < 0.5:
            echo = (int(rng.integers(0, 2 ** 40)), float(rng.random() * 1e4),
                    float(rng.random() * 1e4))
        spans = [(int(rng.integers(0, 2)), int(rng.integers(0, 2 ** 50)),
                  float(rng.random() * 1e4), float(rng.random()),
                  f"SPAN{int(rng.integers(0, 99))} ✓")
                 for _ in range(int(rng.integers(0, 6)))]
        out.append({"rank": int(rng.integers(-1, 64)),
                    "dropped": int(rng.integers(0, 5)),
                    "echo": echo, "spans": spans})
    return out


@pytest.mark.parametrize("nsec", [0, 1, 3])
def test_trace_frames_equal_the_reference(nsec):
    from horovod_tpu.common import wire as ref
    from horovod_tpu_torch.common import wire
    rng = np.random.default_rng(SEED + nsec)
    secs = _sections(rng, nsec)
    mine = wire.serialize_trace_frame(secs)
    assert mine == ref.serialize_trace_frame(secs)
    assert wire.parse_trace_frame(mine) == ref.parse_trace_frame(mine)
    other = ref.serialize_trace_frame(_sections(rng, 2))
    assert wire.combine_trace_frames([mine, other, b"\x09junk"]) == \
        ref.combine_trace_frames([mine, other, b"\x09junk"])
    for cut in range(1, len(mine)):
        for parse in (wire.parse_trace_frame, ref.parse_trace_frame):
            with pytest.raises(Exception):
                parse(mine[:cut])


def test_code_families_equal_the_reference():
    from horovod_tpu.common import wire as ref
    from horovod_tpu_torch.common import wire
    assert (wire.SPAN_SLICE, wire.SPAN_MARK) == (ref.SPAN_SLICE, ref.SPAN_MARK)
    assert wire.SPAN_NAMES == ref.SPAN_NAMES
    assert wire.EV_NAMES == ref.EV_NAMES
    for name in ref.EV_NAMES.values():
        key = f"EV_{name.upper()}"
        assert getattr(wire, key) == getattr(ref, key)


def test_clock_offsets_equal_the_reference():
    from horovod_tpu.common import trace as rtrace
    from horovod_tpu_torch.common import trace as htrace
    rng = np.random.default_rng(SEED)
    a, b = htrace.ClockSync(), rtrace.ClockSync()
    for seq in range(300):  # past PING_MEMORY: the oldest are forgotten
        t1 = float(seq) + rng.random()
        a.ping_sent(seq, t1)
        b.ping_sent(seq, t1)
    for _ in range(200):
        rank = int(rng.integers(1, 5))
        seq = int(rng.integers(0, 320))
        t2, t3, t4 = (float(x) for x in np.sort(rng.random(3) * 3) + seq)
        a.echo(rank, seq, t2, t3, t4)
        b.echo(rank, seq, t2, t3, t4)
    assert a.offsets() and a.offsets() == b.offsets()
    for r in range(6):
        assert a.offset_of(r) == b.offset_of(r)
    # the worker side: one echo per PING, and only the coordinator's
    a.ping_received(2, 5, 1.0)
    assert a.take_echo() is None
    a.ping_received(0, 7, 2.0)
    seq, t2, t3 = a.take_echo()
    assert (seq, t2) == (7, 2.0) and t3 >= t2 and a.take_echo() is None


def test_straggler_attribution_equals_the_reference():
    from horovod_tpu.common import metrics as rmetrics
    from horovod_tpu.common import trace as rtrace
    from horovod_tpu_torch.common import metrics as hmetrics
    from horovod_tpu_torch.common import trace as htrace
    rng = np.random.default_rng(SEED)
    regs = (hmetrics.MetricsRegistry(), rmetrics.MetricsRegistry())
    mine = htrace.StragglerTracker(regs[0])
    ref = rtrace.StragglerTracker(regs[1])
    mine.WINDOW = ref.WINDOW = 50
    mine._window = type(mine._window)(maxlen=50)
    ref._window = type(ref._window)(maxlen=50)
    assert mine.report_line() == ref.report_line() == ""
    for _ in range(130):  # past the window: old gathers slide out
        arrivals = {r: float(rng.random() * (1 + r)) for r in range(4)}
        mine.note_gather(arrivals)
        ref.note_gather(arrivals)
    assert mine.window_stats() == ref.window_stats()
    assert mine.report_line() == ref.report_line() != ""
    assert regs[0].snapshot() == regs[1].snapshot()


def test_world_trace_writer_equals_the_reference(tmp_path):
    from horovod_tpu.common import trace as rtrace
    from horovod_tpu_torch.common import trace as htrace
    rng = np.random.default_rng(SEED)
    clocks = (htrace.ClockSync(), rtrace.ClockSync())
    paths = (tmp_path / "mine.json", tmp_path / "ref.json")
    writers = [mod.WorldTraceWriter(str(p), clock)
               for mod, p, clock in zip((htrace, rtrace), paths, clocks)]
    t0 = writers[0]._t0
    writers[1]._t0 = t0
    from horovod_tpu_torch.common import wire
    for seq in range(1, 6):
        for c in clocks:
            c.ping_sent(seq, t0 + seq)
    for step in range(6):
        secs = []
        for rank in range(3):
            echo = None
            if rank and step < 5:
                echo = (step + 1, t0 + step + 1.0 + 0.01 * rank,
                        t0 + step + 1.001 + 0.01 * rank)
            spans = [(int(rng.integers(0, 2)), step * 3 + k,
                      t0 + step + float(rng.random()), float(rng.random()),
                      f"ROUND{k}") for k in range(3)]
            secs.append({"rank": rank, "dropped": int(step == 4),
                         "echo": echo, "spans": spans})
        frame = wire.serialize_trace_frame(secs)
        for w in writers:
            w.ingest(0, frame)  # the arrival t4 is each side's own clock
    # the out-of-order batch of a rank is clamped, not run backwards
    for w in writers:
        w.add_section(1, [(0, 99, t0 - 5.0, 0.5, "EARLY")], 0)
        w.close()
    events = [json.loads(p.read_text()) for p in paths]
    # t4 differs by when each side stamped it, so the offsets may too:
    # the two files agree event for event on all but the times, and on
    # the times of rank 0 (no offset) and of the clamped track.
    assert len(events[0]) == len(events[1])
    for a, b in zip(*events):
        if a.get("pid") == 0 or "ts" not in a:
            assert a == b
        else:
            assert {k: v for k, v in a.items() if k != "ts"} == \
                {k: v for k, v in b.items() if k != "ts"}
    assert writers[0].spans_written == writers[1].spans_written
    assert writers[0].dropped_events == writers[1].dropped_events == 0


def test_world_trace_writer_offsets_equal_the_reference(tmp_path):
    """With the clock tables filled alike, every event is the same."""
    from horovod_tpu.common import trace as rtrace
    from horovod_tpu_torch.common import trace as htrace
    rng = np.random.default_rng(SEED + 1)
    clocks = (htrace.ClockSync(), rtrace.ClockSync())
    for c in clocks:
        for r in (1, 2):
            c.ping_sent(r, 10.0)
            c.echo(r, r, 10.5 + 0.25 * r, 10.5 + 0.25 * r, 10.01)
    paths = (tmp_path / "mine.json", tmp_path / "ref.json")
    writers = [mod.WorldTraceWriter(str(p), clock)
               for mod, p, clock in zip((htrace, rtrace), paths, clocks)]
    writers[1]._t0 = writers[0]._t0
    for rank in (0, 1, 2):
        spans = [(int(rng.integers(0, 2)), k, writers[0]._t0 + float(k)
                  + float(rng.random()), float(rng.random()), "ROUND")
                 for k in range(5)]
        for w in writers:
            w.add_section(rank, spans, dropped=rank)
    for w in writers:
        w.close()
    mine, ref = (json.loads(p.read_text()) for p in paths)
    assert mine == ref
    assert {e["pid"] for e in mine} == {0, 1, 2}


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        self.t += 0.125
        return self.t


def _record_all(rec, rng):
    for i in range(40):
        ev = int(rng.integers(0, 8))
        arg = None if rng.random() < 0.3 else int(rng.integers(-1, 4))
        rec.record(ev, cycle=i, arg=arg,
                   note="" if rng.random() < 0.5 else f"note {i} ✓")


@pytest.mark.parametrize("capacity", [8, 16, 512])
def test_flight_dump_equals_the_reference(tmp_path, monkeypatch, capacity):
    from horovod_tpu.common import trace as rtrace
    from horovod_tpu_torch.common import trace as htrace
    monkeypatch.setenv("HOROVOD_RANK", "2")
    lines = []
    for mod, name in ((htrace, "mine"), (rtrace, "ref")):
        monkeypatch.setattr(time, "monotonic", _Clock())
        rec = mod.FlightRecorder(capacity)
        rec.set_identity(1)
        _record_all(rec, np.random.default_rng(SEED))
        path = rec.dump(cause="rank 1 hung", origin=1,
                        path=str(tmp_path / f"{name}.jsonl"))
        rec.dump(cause="again", origin=-1, path=path)
        monkeypatch.undo()
        monkeypatch.setenv("HOROVOD_RANK", "2")
        lines.append([json.loads(x) for x in open(path).read().splitlines()])
    mine, ref = lines
    assert len(mine) == len(ref) == 2 * (1 + min(capacity, 40))
    for a, b in zip(mine, ref):
        if "flight" in a:
            for k in ("ts", "mono", "pid", "build", "generation"):
                a.pop(k, None)
                b.pop(k, None)
        assert a == b


def test_flight_recorder_is_on_by_default_and_off_by_knob(monkeypatch,
                                                          tmp_path):
    from horovod_tpu_torch.common import trace as htrace
    try:
        monkeypatch.delenv("HOROVOD_TPU_FLIGHT", raising=False)
        htrace._reset_for_tests()
        rec = htrace.flight()
        assert rec.enabled and rec is htrace.flight()
        monkeypatch.setenv("HOROVOD_TPU_FLIGHT", "0")
        htrace._reset_for_tests()
        assert htrace.flight() is htrace.NOOP_RECORDER
        assert htrace.NOOP_RECORDER.dump() is None
        assert htrace.create_collector(False) is htrace.NOOP_TRACE
        assert htrace.create_collector(True).enabled
    finally:
        monkeypatch.undo()
        htrace._reset_for_tests()


def test_sigusr2_dumps_the_ring(monkeypatch, tmp_path):
    from horovod_tpu_torch.common import trace as htrace
    monkeypatch.setenv("HOROVOD_TPU_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("HOROVOD_RANK", "3")
    prev = signal.getsignal(signal.SIGUSR2)
    try:
        htrace._reset_for_tests()
        htrace.flight().record(htrace.EV_MARK, cycle=4, note="poke")
        htrace._SIGUSR2_INSTALLED = False
        assert htrace.install_sigusr2()
        os.kill(os.getpid(), signal.SIGUSR2)
        files = list(tmp_path.glob("hvd-flight-rank3.pid*.jsonl"))
        assert len(files) == 1
        head, *events = [json.loads(x)
                         for x in files[0].read_text().splitlines()]
        assert head["cause"] == "SIGUSR2" and head["launch_rank"] == 3
        assert events[-1] == {"t": events[-1]["t"], "ev": "mark",
                              "cycle": 4, "note": "poke"}
    finally:
        signal.signal(signal.SIGUSR2, prev)
        htrace._SIGUSR2_INSTALLED = False
        htrace._reset_for_tests()


def test_build_info_names_the_port(monkeypatch):
    from horovod_tpu.common import trace as rtrace
    import horovod_tpu_torch
    from horovod_tpu_torch.common import trace as htrace
    monkeypatch.setenv("HOROVOD_TPU_TRACE", "/x")
    info = htrace.build_info()
    assert info == {"version": horovod_tpu_torch.__version__,
                    "native": "none", "knobs": rtrace.knobs_digest(),
                    "flags": "none"}
