"""The port's autotuner against the JAX package's, and autotune and the
stall report's world line in a spawned world.

- The optimizer (``horovod_tpu_torch/optim``): the reference's GP and BO
  cases (``tests/test_autotune.py``), the GP's ``predict`` equal to the
  reference's, and ``next_sample`` for one seed and 12 samples equal to
  the reference's bit for bit.
- ``_BucketTuner`` and ``ParameterManager.configure_wire``: the
  counterparts of ``tests/test_compression.py``'s tuner cases, each also
  held to the reference's tuner on the same feeds (the ring and
  two-level codes are only data to the unit tuner).
- ``ParameterManager``: one stream of cycles drives both packages, with
  ``time.monotonic`` of both modules on one fake clock: the same plans,
  revisions, speculation gates, tuned values and CSV rows; the
  reference's ``test_tunes_then_converges`` and
  ``test_worker_applies_synced_params``.
- The knobs parse as the reference's, and ``HOROVOD_AUTOTUNE=1`` no
  longer raises.
- ``StallInspector.check(world_stats=)``: the reference's
  ``test_stall_report_carries_world_stats``, both packages.
- A spawned two-rank world (this file run as a script is a rank, started
  by a module fixture) with the response cache on and a bf16 proposal on
  both ranks, the counterpart of ``tests/test_autotune_mp.py``: it
  converges within its op budget, the worker adopts rank 0's values,
  the CSV holds the Bayesian samples, every move of the plan evicted the
  cached allreduce verdicts on every rank alike, each result is the
  closed form of a candidate wire and, once settled, of the settled
  plan's; then a stalled tensor's warning carries the world line (the
  world cycle, the heartbeat ages, the tuner's settled plan).

Inputs come from numpy seeds; every comparison is exact unless a
tolerance is stated.
"""

import json
import os
import pathlib
import sys
import time
import traceback
import types

import numpy as np
import pytest
import torch

SEED = 2608
WORLD_SIZE = 2
# The world's sizes, one tensor a size bucket (BUCKET_BOUNDS 64 KiB, 1
# MiB): 16 KiB, 512 KiB and 8 MiB of fp32.
BUCKET_NUMELS = (4096, 131072, 2097152)
# Steps (three allreduces and a broadcast) the world may take to converge.
OP_BUDGET = 400
SETTLED_STEPS = 3
# The world's tuner: one warm-up sample, 2 cycles a sample, 3 Bayesian
# samples (the reference's multi-process test's knobs).
MAX_SAMPLES = 3
WORLD_DEADLINE_S = 60.0
# Rank 1 submits the stalled tensor once rank 0 has logged its warning
# (a tuned cycle time of ~100 ms makes the idle hold ~0.8 s a round, so
# no fixed wait is safe), or after this long.
STALL_WAIT_S = 20.0


# -- the optimizer ----------------------------------------------------------

def test_gp_fit_predict_interpolates(world):
    """(The first test asks for the world, so that it runs while the
    in-process tests do.)"""
    from horovod_tpu_torch.optim.gaussian_process import (
        GaussianProcessRegressor)
    gp = GaussianProcessRegressor(alpha=1e-10)
    x = np.array([[0.0], [0.5], [1.0]])
    y = np.array([0.0, 1.0, 0.0])
    gp.fit(x, y)
    mean, std = gp.predict(x)
    np.testing.assert_allclose(mean, y, atol=1e-4)
    assert np.all(std < 1e-2)


def test_gp_predict_without_fit():
    from horovod_tpu_torch.optim.gaussian_process import (
        GaussianProcessRegressor)
    gp = GaussianProcessRegressor()
    mean, std = gp.predict(np.array([[0.3]]))
    assert mean[0] == 0.0
    assert std[0] > 0


@pytest.mark.parametrize("dim,alpha", [(1, 1e-6), (2, 0.8), (3, 1e-8)])
def test_gp_predict_equals_the_reference(dim, alpha):
    from horovod_tpu.optim.gaussian_process import (
        GaussianProcessRegressor as Ref)
    from horovod_tpu_torch.optim.gaussian_process import (
        GaussianProcessRegressor)
    rng = np.random.RandomState(SEED + dim)
    x, y = rng.uniform(size=(9, dim)), rng.standard_normal(9)
    q = rng.uniform(size=(64, dim))
    mine, ref = GaussianProcessRegressor(alpha=alpha), Ref(alpha=alpha)
    for gp in (mine, ref):
        gp.fit(x, y)
    for a, b in zip(mine.predict(q), ref.predict(q)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def test_bo_finds_peak_of_smooth_function():
    from horovod_tpu_torch.optim.bayesian_optimization import (
        BayesianOptimization)
    bo = BayesianOptimization(bounds=[(0.0, 1.0)], alpha=1e-6, seed=1)
    x = bo.next_sample()
    for _ in range(20):
        bo.add_sample(x, -(float(x[0]) - 0.7) ** 2)
        x = bo.next_sample()
    best, _ = bo.best()
    assert abs(best[0] - 0.7) < 0.15


def test_bo_respects_bounds():
    from horovod_tpu_torch.optim.bayesian_optimization import (
        BayesianOptimization)
    bo = BayesianOptimization(bounds=[(2.0, 4.0), (10.0, 20.0)], seed=0)
    for _ in range(5):
        x = bo.next_sample()
        assert 2.0 <= x[0] <= 4.0
        assert 10.0 <= x[1] <= 20.0
        bo.add_sample(x, float(np.sum(x)))


def test_bo_lbfgs_refinement_beats_candidate_sweep():
    from horovod_tpu_torch.optim.bayesian_optimization import (
        BayesianOptimization)
    bo = BayesianOptimization(bounds=[(0.0, 64.0), (1.0, 100.0)],
                              alpha=1e-6, seed=3)
    rng = np.random.RandomState(0)
    for _ in range(12):
        x = np.array([rng.uniform(0, 64), rng.uniform(1, 100)])
        bo.add_sample(x, -((x[0] - 20.0) / 32.0) ** 2
                      - ((x[1] - 60.0) / 50.0) ** 2)
    bo._gp.fit(np.stack(bo._xs), np.asarray(bo._ys))
    cand = bo._rng.uniform(size=(2048, bo.dim))
    ei = bo._expected_improvement(cand)
    refined, refined_ei = bo._maximize_ei(cand, ei)
    assert refined is not None, "scipy present: the refinement runs"
    assert refined_ei >= float(ei.max()) - 1e-12
    assert np.all(refined >= 0.0) and np.all(refined <= 1.0)
    # from a sweep whose candidates all miss the acquisition's peak,
    # L-BFGS-B finds a strictly better point than any candidate
    coarse = bo._rng.uniform(size=(4, bo.dim))
    coarse_ei = bo._expected_improvement(coarse)
    ref2, ref2_ei = bo._maximize_ei(coarse, coarse_ei, n_starts=4)
    assert ref2 is not None
    assert ref2_ei > float(coarse_ei.max()), (ref2_ei, float(coarse_ei.max()))
    nxt = bo.next_sample()
    assert 0.0 <= nxt[0] <= 64.0 and 1.0 <= nxt[1] <= 100.0


@pytest.mark.parametrize("seed", [0, 7])
def test_next_sample_sequence_equals_the_reference(seed):
    """12 samples of the tuner's box under a smooth score with noise:
    every point the port proposes is the reference's, bit for bit."""
    from horovod_tpu.optim.bayesian_optimization import (
        BayesianOptimization as Ref)
    from horovod_tpu_torch.optim.bayesian_optimization import (
        BayesianOptimization)
    box = [(0.0, 64.0), (1.0, 100.0)]
    mine = BayesianOptimization(bounds=box, alpha=0.8, seed=seed)
    ref = Ref(bounds=box, alpha=0.8, seed=seed)
    noise = np.random.RandomState(SEED + seed)
    for _ in range(12):
        a, b = mine.next_sample(), ref.next_sample()
        assert a.tobytes() == b.tobytes(), (a, b)
        y = -((a[0] - 20.0) / 32.0) ** 2 - ((a[1] - 60.0) / 50.0) ** 2 \
            + 0.05 * noise.standard_normal()
        mine.add_sample(a, y)
        ref.add_sample(b, y)
    (pa, sa), (pb, sb) = mine.best(), ref.best()
    assert pa.tobytes() == pb.tobytes() and sa == sb


# -- the bucket tuner -------------------------------------------------------

def _tuner_feeds(t, quality, idle_below: int):
    """Feed ``t`` as tests/test_compression.py:289 does; the feeds."""
    feeds = []
    guard = 0
    while not t.done:
        guard += 1
        assert guard < 100
        if t.bucket < idle_below:
            feeds.append((1.0, 0))
        else:
            feeds.append((quality.get(t.current_combo(), 1.0), 1 << 20))
        t.feed(*feeds[-1])
    return feeds


def test_bucket_tuner_converges_to_best_combo_and_skips_idle_buckets():
    from horovod_tpu.common import parameter_manager as rpm
    from horovod_tpu_torch.common import parameter_manager as pm
    from horovod_tpu_torch.common import wire_dtype as wd
    combos = [(wd.ALG_DEFAULT, wd.WIRE_NONE), (wd.ALG_DEFAULT, wd.WIRE_BF16),
              (wd.ALG_RING, wd.WIRE_NONE), (wd.ALG_RING, wd.WIRE_BF16),
              (wd.ALG_TWOLEVEL, wd.WIRE_NONE),
              (wd.ALG_TWOLEVEL, wd.WIRE_BF16)]
    quality = {(wd.ALG_TWOLEVEL, wd.WIRE_BF16): 4.0,
               (wd.ALG_RING, wd.WIRE_BF16): 2.0}
    t = pm._BucketTuner(combos, 3)
    feeds = _tuner_feeds(t, quality, 2)
    assert t.plan[0] == (wd.ALG_DEFAULT, None)  # idle: the default kept
    assert t.plan[1] == (wd.ALG_DEFAULT, None)
    assert t.plan[2] == (wd.ALG_TWOLEVEL, wd.WIRE_BF16)
    ref = rpm._BucketTuner(combos, 3)
    for f in feeds:
        ref.feed(*f)
    assert (t.plan, t.revision, t.describe()) == \
        (ref.plan, ref.revision, ref.describe())


def _config(mod, **kw):
    cfg = mod.Config()
    cfg.autotune = True
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def _managers(rank: int = 0, **kw):
    """A port and a reference ParameterManager of one configuration."""
    from horovod_tpu.common import config as rconfig
    from horovod_tpu.common import parameter_manager as rpm
    from horovod_tpu_torch.common import config
    from horovod_tpu_torch.common import parameter_manager as pm
    ctl = types.SimpleNamespace(rank=rank)
    return (pm.ParameterManager(_config(config, **kw), ctl),
            rpm.ParameterManager(_config(rconfig, **kw), ctl))


def test_parameter_manager_grid_then_bayes():
    """The grid settles the bucket table, then the Bayesian phase still
    converges: tuning ends once, in both packages alike."""
    from horovod_tpu_torch.common import wire_dtype as wd
    pms = _managers(autotune_warmup_samples=1, autotune_steps_per_sample=2,
                    autotune_bayes_opt_max_samples=3)
    for p in pms:
        # two ranks on one host: the grid is default x {none, bf16}
        p.configure_wire(wd.WIRE_BF16, multi_host=False, world_size=2)
    cycles = []
    for p in pms:
        for n in range(2000):
            p.plan(2 << 20)
            p.on_cycle(2 << 20)
            if not p.tuning:
                break
        cycles.append(n)
        assert not p.tuning
        plan = p.bucket_plan()
        assert plan[2][0] == wd.ALG_DEFAULT
        assert plan[2][1] in (wd.WIRE_NONE, wd.WIRE_BF16)
    assert cycles[0] == cycles[1]
    assert pms[0].plan_revision == pms[1].plan_revision


def test_wire_candidates_never_exceed_proposal():
    from horovod_tpu_torch.common import wire_dtype as wd
    for p in _managers():
        p.configure_wire(wd.WIRE_NONE, multi_host=False, world_size=2)
        # nothing to explore: one combination, no tuner armed
        assert p._bucket_tuner is None


# -- the manager against the reference on one stream -------------------------

STREAMS = {
    # the star: the runtime's arguments, a bf16 proposal on two ranks
    "star": dict(args=(1, False, 2), kw=dict(
        shm_enabled=False, ring_allowed=False, ici_allowed=False)),
    # the whole grid as data: int8 on four ranks over hosts, ring, ICI
    "grid": dict(args=(3, True, 4), kw=dict(
        shm_enabled=True, ring_allowed=True, ici_allowed=True)),
}


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_manager_follows_the_reference_on_one_stream(monkeypatch, tmp_path,
                                                     stream):
    """The same cycles (batches of seeded sizes, seeded durations on one
    fake clock) drive both managers: every stamped plan, revision,
    speculation gate and value, the settled table and the CSV agree."""
    from horovod_tpu.common import parameter_manager as rpm
    from horovod_tpu_torch.common import parameter_manager as pm
    now = [100.0]
    clock = types.SimpleNamespace(monotonic=lambda: now[0])
    monkeypatch.setattr(pm, "time", clock)
    monkeypatch.setattr(rpm, "time", clock)
    from horovod_tpu.common import config as rconfig
    from horovod_tpu_torch.common import config
    logs = [tmp_path / "mine.csv", tmp_path / "ref.csv"]
    knobs = dict(autotune_warmup_samples=2, autotune_steps_per_sample=3,
                 autotune_bayes_opt_max_samples=6)
    ctl = types.SimpleNamespace(rank=0)
    mine = pm.ParameterManager(
        _config(config, autotune_log=str(logs[0]), **knobs), ctl)
    ref = rpm.ParameterManager(
        _config(rconfig, autotune_log=str(logs[1]), **knobs), ctl)
    args, kw = STREAMS[stream]["args"], STREAMS[stream]["kw"]
    mine.configure_wire(*args, **kw)
    ref.configure_wire(*args, **kw)
    mine.configure_overlap(True)
    ref.configure_overlap(True)
    rng = np.random.RandomState(SEED)
    seen = [[], []]
    for _ in range(3000):
        if not ref.tuning:
            break
        sizes = [int(s) for s in rng.choice(
            [512, 70 << 10, 3 << 20], size=rng.randint(0, 4))]
        dt = float(rng.uniform(0.001, 0.02))
        for p, out in zip((mine, ref), seen):
            out.append(([p.plan(n) for n in sizes], p.plan_revision,
                        p.spec_safe, p.overlap_buckets(),
                        p.tuned_overlap_buckets, p.fusion_threshold_bytes(),
                        p.cycle_time_ms(), p.tuning))
        now[0] += dt
        for p in (mine, ref):
            p.on_cycle(sum(sizes))
    assert not ref.tuning and not mine.tuning
    assert seen[0] == seen[1]
    assert mine.bucket_plan() == ref.bucket_plan()
    assert logs[0].read_text() == logs[1].read_text()
    assert len(logs[0].read_text().splitlines()) == 7


def test_tunes_then_converges(tmp_path):
    from horovod_tpu_torch.common import config
    from horovod_tpu_torch.common.controller import LocalController
    from horovod_tpu_torch.common.parameter_manager import ParameterManager
    cfg = _config(config, autotune_warmup_samples=1, autotune_steps_per_sample=2,
                  autotune_bayes_opt_max_samples=4,
                  autotune_log=str(tmp_path / "autotune.csv"))
    p = ParameterManager(cfg, LocalController())
    assert p.tuning
    # warm-up 1 sample + 4 samples x 3 medians, 2 cycles each
    for _ in range(2 * (1 + 4 * 3) + 4):
        p.on_cycle(1 << 20)
    assert not p.tuning
    assert 0 <= p.fusion_threshold_bytes() <= 64 << 20
    assert 1.0 <= p.cycle_time_ms() <= 100.0
    log = (tmp_path / "autotune.csv").read_text().strip().splitlines()
    assert log[0].startswith("sample,")
    assert len(log) == 5  # the header and 4 samples


def test_worker_applies_synced_params():
    mine, ref = _managers(rank=1)
    for p in (mine, ref):
        p.apply_synced(32 << 20, 7.5)
        assert p.fusion_threshold_bytes() == 32 << 20
        assert p.cycle_time_ms() == 7.5
        # a tuned fusion threshold of 0 (fusion off) is adopted: only a
        # cycle time of 0 marks a trailer without tuned values
        p.apply_synced(0, 100.0)
        assert p.fusion_threshold_bytes() == 0
        assert p.cycle_time_ms() == 100.0
        p.apply_synced(0, 0.0)
        assert (p.fusion_threshold_bytes(), p.cycle_time_ms()) == (0, 100.0)
        p.apply_synced(0, 5.0, 4)
        assert p.overlap_buckets() == 4
        assert p.tuned_overlap_buckets == -1  # only rank 0 stamps
        assert not p.tuning and p.spec_safe and p.plan_revision == 1


# -- the knobs ----------------------------------------------------------------

KNOB_CASES = [
    {},
    {"HOROVOD_AUTOTUNE": "1", "HOROVOD_AUTOTUNE_LOG": "/tmp/a.csv",
     "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "1",
     "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE": "2",
     "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES": "3",
     "HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE": "0.25"},
    {"HOROVOD_AUTOTUNE": "yes", "HOROVOD_AUTOTUNE_WARMUP_SAMPLES": "x",
     "HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE": "bad"},
]
FIELDS = ("autotune", "autotune_log", "autotune_warmup_samples",
          "autotune_steps_per_sample", "autotune_bayes_opt_max_samples",
          "autotune_gaussian_process_noise")


@pytest.mark.parametrize("case", range(len(KNOB_CASES)))
def test_autotune_knobs_parse_as_the_reference(monkeypatch, case):
    """HOROVOD_AUTOTUNE=1 no longer raises."""
    from horovod_tpu.common.config import Config as RefConfig
    from horovod_tpu_torch.common import config
    assert "HOROVOD_AUTOTUNE" not in config._NOT_PORTED
    for name in {k for c in KNOB_CASES for k in c}:
        monkeypatch.delenv(name, raising=False)
    for name, value in KNOB_CASES[case].items():
        monkeypatch.setenv(name, value)
    mine, ref = config.Config.from_env(), RefConfig.from_env()
    assert [getattr(mine, f) for f in FIELDS] == \
        [getattr(ref, f) for f in FIELDS]


# -- the stall report's world line ---------------------------------------------

@pytest.mark.parametrize("package", ["horovod_tpu_torch", "horovod_tpu"])
def test_stall_report_carries_world_stats(capsys, package):
    import importlib
    hlog = importlib.import_module(f"{package}.common.logging")
    coord = importlib.import_module(f"{package}.common.coordinator")
    msg = importlib.import_module(f"{package}.common.message")
    hlog.set_level("info")
    try:
        insp = coord.StallInspector(size=2, warning_time=0.0)
        table = coord.MessageTable()
        table.increment_tensor_count(
            msg.Request(request_rank=0, tensor_name="grad"), 2)
        insp.check(table, world_stats="tensor queue depth 3; oldest peer "
                                      "heartbeat ages: rank 1 4.2s")
    finally:
        hlog.set_level("warning")
    err = capsys.readouterr().err
    assert "world health: tensor queue depth 3" in err
    warning = [ln for ln in err.splitlines() if "Stalled op: grad" in ln]
    assert len(warning) == 1
    assert warning[0].endswith("[world: tensor queue depth 3; oldest peer "
                               "heartbeat ages: rank 1 4.2s]")


def test_clock_offsets_line_equals_the_reference():
    from horovod_tpu.common import trace as rtrace
    from horovod_tpu_torch.common import trace as htrace
    lines = []
    for mod in (htrace, rtrace):
        mod._reset_for_tests()
        try:
            assert mod.clock_offsets_line() == ""
            c = mod.clock()
            for seq, (t1, t2, t3, t4) in enumerate(
                    [(1.0, 1.5, 1.6, 1.2), (2.0, 2.4, 2.41, 2.05)]):
                c.ping_sent(seq, t1)
                c.echo(1 + seq, seq, t2, t3, t4)
            lines.append(mod.clock_offsets_line())
        finally:
            mod._reset_for_tests()
    assert lines[0] == lines[1] and lines[0].startswith("rank 1 ")


# -- the spawned world ----------------------------------------------------------

def _closed_forms(xs):
    """{wire code: each bucket's allreduce sum of ``xs`` (one list of
    bucket tensors a rank) at that wire}, from the port's CPU codec."""
    from horovod_tpu_torch.common import wire_dtype as wd
    from horovod_tpu_torch.ops.socket_ops import _accumulate
    out = {wd.WIRE_NONE: [], wd.WIRE_BF16: []}
    for b in range(len(BUCKET_NUMELS)):
        parts = [x[b] for x in xs]
        acc = parts[0].clone()
        for p in parts[1:]:
            _accumulate(acc, p)
        out[wd.WIRE_NONE].append(acc)
        n = parts[0].numel()
        ws = [wd.compress(p, wd.WIRE_BF16) for p in parts]
        out[wd.WIRE_BF16].append(wd.decompress(
            wd.reduce_wire(ws[0], ws[1:], wd.WIRE_BF16, torch.float32, n),
            wd.WIRE_BF16, torch.float32, n))
    return out


def _world_inputs(rank: int):
    rng = np.random.RandomState(SEED + 100 * rank)
    return [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
            for n in BUCKET_NUMELS]


def _world_main(out_dir: str) -> int:
    """One rank: allreduces of one tensor a size bucket, each step ended
    by rank 0's tuning flag, until the world converges; then the tuned
    values against rank 0's, steps under the settled plan, and a tensor
    rank 1 submits late (the stall report)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.common import wire_dtype as wd
    hvd.init(device="cpu")
    rank = hvd.rank()
    rt = basics.runtime()
    pm = rt.parameter_manager
    assert pm is not None, "HOROVOD_AUTOTUNE=1 builds the manager"
    xs = [_world_inputs(r) for r in range(WORLD_SIZE)]
    want = _closed_forms(xs)
    assert all(not torch.equal(a, b)
               for a, b in zip(want[wd.WIRE_NONE], want[wd.WIRE_BF16]))
    mine = xs[rank]
    wires = [{wd.WIRE_NONE: 0, wd.WIRE_BF16: 0} for _ in BUCKET_NUMELS]
    other = 0
    t0 = time.monotonic()
    steps = None
    for i in range(OP_BUDGET):
        for b, x in enumerate(mine):
            got = hvd.allreduce(x, op=hvd.Sum, name=f"at.b{b}")
            hit = [w for w in wires[b] if torch.equal(got, want[w][b])]
            if hit:
                wires[b][hit[0]] += 1
            else:
                other += 1
        flag = torch.tensor([float(rank == 0 and not pm.tuning)])
        if hvd.broadcast(flag, 0, name="at.done").item() == 1.0:
            steps = i + 1
            break
    converge_s = time.monotonic() - t0
    result = {"rank": rank, "steps": steps, "converge_s": converge_s,
              "other": other,
              "wires": [[c[wd.WIRE_NONE], c[wd.WIRE_BF16]] for c in wires]}
    if steps is not None:
        # the cycle that carried the converged trailer has passed every
        # rank's apply_synced once this barrier is through
        hvd.barrier()
        tuned = hvd.broadcast(torch.tensor(
            [float(pm.fusion_threshold_bytes()), pm.cycle_time_ms()],
            dtype=torch.float64), 0, name="at.vals")
        result["tuned"] = tuned.tolist()
        result["mine"] = [float(pm.fusion_threshold_bytes()),
                          pm.cycle_time_ms()]
        # rank 0's settled caps (-1: no cap, the negotiated bf16)
        caps = hvd.broadcast(torch.tensor(
            [-1 if c is None else c for _, c in pm.bucket_plan()],
            dtype=torch.int64), 0, name="at.plan").tolist()
        result["caps"] = caps
        settled = []
        for _ in range(SETTLED_STEPS):
            for b, x in enumerate(mine):
                got = hvd.allreduce(x, op=hvd.Sum, name=f"at.b{b}")
                w = wd.WIRE_BF16 if caps[b] in (-1, wd.WIRE_BF16) \
                    else wd.WIRE_NONE
                settled.append(bool(torch.equal(got, want[w][b])))
        result["settled"] = settled
        result["plan"] = [list(p) for p in pm.bucket_plan()]
        result["revision"] = pm.plan_revision
        # the stall report: rank 1 submits this tensor late
        if rank == 1:
            log0 = pathlib.Path(out_dir) / "rank0.log"
            deadline = time.monotonic() + STALL_WAIT_S
            while "Stalled op: at.stall" not in log0.read_text(
                    errors="replace") and time.monotonic() < deadline:
                time.sleep(0.05)
        hvd.allreduce(mine[0], op=hvd.Sum, name="at.stall")
        result["world_cycle"] = rt._world_cycle
    st = rt.stats
    result.update(plan_moves=st["plan_moves"],
                  plan_evictions=st["plan_evictions"],
                  cache_evictions=st["cache_evictions"],
                  spec_cycles=st["spec_cycles"], epoch=rt._cache.epoch)
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
        out = tmp_path_factory.mktemp("autotune")
        port = spawned.reserve_port()
        envs = [child_env(HOROVOD_RANK=r, HOROVOD_SIZE=WORLD_SIZE,
                          HOROVOD_CONTROLLER_ADDR="127.0.0.1",
                          HOROVOD_CONTROLLER_PORT=port,
                          HOROVOD_COMPRESSION="bf16",
                          HOROVOD_AUTOTUNE=1,
                          HOROVOD_AUTOTUNE_LOG=out / "autotune.csv",
                          HOROVOD_AUTOTUNE_WARMUP_SAMPLES=1,
                          HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE=2,
                          HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES=MAX_SAMPLES,
                          HOROVOD_STALL_CHECK_TIME_SECONDS=0.5,
                          HOROVOD_LOG_LEVEL="info")
                for r in range(WORLD_SIZE)]
        argv = [pathlib.Path(__file__), out]
        spawned.start("autotune", out, [argv] * WORLD_SIZE, envs)
        yield spawned
    finally:
        spawned.close()


def _world_results(world):
    rcs, results, logs = world.wait("autotune")
    assert rcs == [0] * WORLD_SIZE and None not in results, "\n".join(logs)
    return results, logs


def test_world_converges_and_the_worker_adopts(world):
    results, logs = _world_results(world)
    r0, r1 = results
    assert r0["steps"] is not None, "no convergence within the op budget"
    assert r0["steps"] == r1["steps"]
    # every rank holds rank 0's values, as the trailer carried them
    for r in results:
        assert r["mine"] == r0["tuned"] == r["tuned"], results
    lines = (world.out("autotune") / "autotune.csv").read_text().splitlines()
    assert lines[0] == ("sample,fusion_threshold_mb,cycle_time_ms,"
                        "score_bytes_per_us")
    assert len(lines) == 1 + MAX_SAMPLES, lines
    for row in lines[1:]:
        _, mb, ms, score = row.split(",")
        assert 0.0 <= float(mb) <= 64.0
        assert 1.0 <= float(ms) <= 100.0
        assert float(score) >= 0.0
    # the star's grid: the default algorithm, no cap or a cap at or
    # below the proposal
    assert all(a == 0 and c in (None, 0, 1) for a, c in r0["plan"]), r0
    assert "autotune converged" in logs[0]


def test_each_plan_move_evicts_the_cached_verdicts(world):
    results, _ = _world_results(world)
    r0, r1 = results
    # the grid moved the plan under test at least once a bucket (a
    # bucket it measures: once a candidate and pass; one it skips for
    # lack of traffic: once), and convergence moved it again
    buckets = len(BUCKET_NUMELS)
    assert r0["revision"] >= r0["plan_moves"] >= buckets + 1, r0
    # every move found cached allreduce verdicts and evicted them, on
    # every rank alike
    assert r0["plan_evictions"] == r0["plan_moves"], r0
    assert r1["plan_moves"] == 0
    assert r0["cache_evictions"] == r1["cache_evictions"] \
        >= r0["plan_evictions"], results
    assert r0["epoch"] == r1["epoch"]


def test_results_are_the_closed_forms_of_the_stamped_wires(world):
    results, _ = _world_results(world)
    plan = results[0]["plan"]
    for r in results:
        assert r["other"] == 0, r
        # every bucket ran the negotiated bf16 before its turn; one the
        # grid measured (its settled cap a candidate) also ran uncapped,
        # and one it skipped for lack of traffic keeps no cap
        for (none, bf16), (_, cap) in zip(r["wires"], plan):
            assert bf16 > 0 and (none > 0 or cap is None), r
        assert r["settled"] == [True] * SETTLED_STEPS * len(BUCKET_NUMELS)


def test_stall_warning_carries_the_world_line(world):
    results, logs = _world_results(world)
    log0 = logs[0]
    warnings = [ln for ln in log0.splitlines()
                if "Stalled op: at.stall" in ln]
    assert warnings, log0
    for ln in warnings:
        assert "[world: world cycle " in ln, ln
        assert "oldest peer heartbeat ages (coordinator clock): rank 1 " \
            in ln, ln
        assert "autotune settled: plan b0=" in ln, ln
        assert ln.endswith("]")
    assert "world health: world cycle " in log0


if __name__ == "__main__":
    try:
        sys.exit(_world_main(sys.argv[1]))
    except Exception:
        traceback.print_exc()
        sys.exit(1)
