"""The process-group data plane (horovod_tpu_torch/ops/process_group_ops.py)
against the socket star, in spawned gloo worlds on the CPU.

Three worlds start once for the module, at once (this file run as a
script is a rank), each with the plane built for ``"cpu"`` tensors:

- 2 ranks on one host (``HOROVOD_XLA_BCAST=psum``), with a second plane
  built for ``tree``;
- 4 ranks on two fake hosts (``HOROVOD_HOSTNAME=fakehost{rank // 2}``,
  ``HOROVOD_XLA_BCAST=tree``), with a flat plane and a hierarchical one
  (``HOROVOD_HIERARCHICAL_ALLREDUCE=1``, ``_ALLGATHER=1``);
- 2 ranks whose rank 1 fails its local probe.

Every rank runs the same ops (every op, fused and grouped allreduces,
fused and ragged allgathers, the skew guard's psum rendering forced on
every rank) through the star, then through each plane, and compares:

- exact (bit for bit): every op at 2 ranks (a sum of two terms has one
  order); integer-valued data, data movement (allgather, broadcast,
  alltoall) and the forced psum rendering at every size; the
  hierarchical renderings against the flat one on integer-valued data;
- within a bound elsewhere (random fp32 and fp64 sums at 4 ranks): each
  order rounds three times, so two orders differ by at most
  6 x eps x sum of |x_r| (eps = 2^-24 in fp32, 2^-53 in fp64); the
  reference's own tests compare closed forms with numpy's default 1e-7.

The runtime's per-backend counts show the plane served every response
of its runs, each but the barrier completed on a finalizer thread (the
gloo rendering); in the world with a refusing rank every rank runs
every op on the star. ``ragged_psum_wins`` is checked against the
reference's as a pure function.
"""

import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys
import traceback

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
WORLDS = {"two": 2, "four": 4, "refuse": 2}


# -- the ops, run on every rank ------------------------------------------
def _values(rank, shape, seed, dtype=torch.float32):
    rng = np.random.RandomState(seed * 10 + rank)
    return torch.tensor(rng.randn(*shape)).to(dtype)


def _ints(rank, shape, seed, dtype=torch.float32):
    rng = np.random.RandomState(seed * 10 + rank)
    return torch.tensor(rng.randint(-64, 64, shape)).to(dtype)


# Ops whose results at 4 ranks are sums of full-precision random values:
# op -> (eps, each rank's input (rank -> tensor), prescale, postscale).
ROUNDED = {
    "allreduce_random_fp32": (2.0 ** -24, lambda r: _values(r, (33,), 3),
                              1.0, 1.0),
    "allreduce_random_fp64": (2.0 ** -53, lambda r: _values(
        r, (17,), 4, torch.float64), 1.0, 1.0),
    "allreduce_scaled_fp32": (2.0 ** -24, lambda r: _values(r, (9,), 5),
                              1 / 3, 1 / 7)}


def run_ops(hvd, pgo, rank, size, tag):
    """Every op once; {op: output}."""
    out = {}

    def n(s):
        return f"{s}.{tag}"
    out["allreduce_sum_int_valued"] = hvd.allreduce(
        _ints(rank, (4, 3), 1), op=hvd.Sum, name=n("ar"))
    out["allreduce_average_int_valued"] = hvd.allreduce(
        _ints(rank, (5,), 2), name=n("avg"))
    for op, (_, inputs, pre, post) in ROUNDED.items():
        out[op] = hvd.allreduce(inputs(rank), op=hvd.Sum, name=n(op),
                                prescale_factor=pre, postscale_factor=post)
    out["allreduce_bf16"] = hvd.allreduce(
        _ints(rank, (64,), 6, torch.bfloat16), op=hvd.Sum, name=n("bf16"))
    out["allreduce_int32"] = hvd.allreduce(
        _ints(rank, (7,), 7, torch.int32), op=hvd.Sum, name=n("i32"))
    out["allreduce_int16_on_the_star"] = hvd.allreduce(
        _ints(rank, (7,), 8, torch.int16), op=hvd.Sum, name=n("i16"))
    grouped = hvd.grouped_allreduce(
        [_ints(rank, (3 + i,), 20 + i) for i in range(5)], op=hvd.Sum,
        name=n("grp"))
    for i, g in enumerate(grouped):
        out[f"grouped_{i}"] = g
    handles = [hvd.allreduce_async(_ints(rank, (2, i + 1), 30 + i),
                                   op=hvd.Sum, name=n(f"fused{i}"))
               for i in range(4)]
    for i, h in enumerate(handles):
        out[f"fused_async_{i}"] = hvd.synchronize(h)
    out["allgather_ragged"] = hvd.allgather(
        _values(rank, (rank + 1, 3), 40), name=n("ag"))
    handles = [hvd.allgather_async(_values(rank, (rank % 2 + i, 2), 41 + i),
                                   name=n(f"agf{i}")) for i in range(3)]
    for i, h in enumerate(handles):
        out[f"allgather_fused_{i}"] = hvd.synchronize(h)
    wins = pgo.ragged_psum_wins
    pgo.ragged_psum_wins = lambda *a: True   # on every rank alike
    try:
        handles = [hvd.allgather_async(
            _values(rank, ((rank * 3 + i) % 4 + 1, 2, 2), 50 + i),
            name=n(f"agpsum{i}")) for i in range(2)]
        for i, h in enumerate(handles):
            out[f"allgather_psum_forced_{i}"] = hvd.synchronize(h)
    finally:
        pgo.ragged_psum_wins = wins
    out["broadcast_fp64_root1"] = hvd.broadcast(
        _values(rank, (3, 3), 60, torch.float64), 1, name=n("bc"))
    out["broadcast_bf16_root0"] = hvd.broadcast(
        _values(rank, (5,), 61, torch.bfloat16), 0, name=n("bc0"))
    out["alltoall"] = hvd.alltoall(
        _values(rank, (2 * size, 3), 70), name=n("a2a"))
    out["reducescatter_sum"] = hvd.reducescatter(
        _ints(rank, (2 * size, 2), 80), name=n("rs"))
    out["reducescatter_average"] = hvd.reducescatter(
        _ints(rank, (size, 3), 81), name=n("rsa"), op=hvd.Average)
    hvd.barrier(name=n("barrier"))
    return out


def _compare(label, got, want, size):
    """Raises unless ``got`` equals ``want`` as the module says it must:
    exactly, except for the random sums at more than 2 ranks, which are
    held to 6 eps sum_r |pre x_r| (x post) plus one rounding of the
    postscale."""
    for op in want:
        a, b = got[op], want[op]
        assert a.dtype == b.dtype and a.shape == b.shape, (op, a, b)
        if size == 2 or op not in ROUNDED:
            assert torch.equal(a, b), (label, op, a, b)
            continue
        eps, inputs, pre, post = ROUNDED[op]
        mass = sum((inputs(r) * pre).abs() for r in range(size))
        bound = 6 * eps * mass * post + 2 * eps * b.abs()
        assert bool(((a - b).abs() <= bound).all()), (label, op, a, b)


def _world_main(kind: str, out_dir: str) -> int:
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.ops import process_group_ops as pgo
    hvd.init(device="cpu")
    rank, size = hvd.rank(), hvd.size()
    rt = basics.runtime()
    cfg = rt.config
    star = list(rt.op_manager.backends)
    flat_cfg = dataclasses.replace(cfg, hierarchical_allreduce=False,
                                   hierarchical_allgather=False)
    planes = {"flat": pgo.ProcessGroupBackend(rt.controller, flat_cfg,
                                              "cpu")}
    if kind == "two":
        planes["tree"] = pgo.ProcessGroupBackend(
            rt.controller, dataclasses.replace(flat_cfg,
                                               xla_broadcast="tree"), "cpu")
    if kind == "four":
        planes["hier"] = pgo.ProcessGroupBackend(rt.controller, cfg, "cpu")
    for p in planes.values():
        p.create_groups()
        p.finalizer = rt.finalizer
    if kind == "refuse" and rank == 1:
        planes["flat"]._probe_local = lambda entries: False
    # Count the batches handed to the finalizer (gloo completes every op
    # but the barrier there).
    finalized = []
    submit = rt.finalizer.submit
    rt.finalizer.submit = lambda fn: finalized.append(fn) or submit(fn)
    outs, stats, results = {}, {}, {}
    for label in ["star"] + list(planes):
        rt.op_manager.backends = (star if label == "star"
                                  else [planes[label]] + star)
        before = dict(rt.stats)
        n_finalized = len(finalized)
        outs[label] = run_ops(hvd, pgo, rank, size, label)
        stats[label] = {k: v - before.get(k, 0) for k, v in rt.stats.items()
                        if k.startswith("responses")}
        stats[label]["finalized"] = len(finalized) - n_finalized
    for label in planes:
        for base in ("star", "flat") if label == "hier" else ("star",):
            key = f"{label}_vs_{base}"
            try:
                _compare(key, outs[label], outs[base], size)
                results[key] = "ok"
            except Exception:
                results[key] = traceback.format_exc()
    results["stats"] = stats
    results["renderings"] = {k: p.rendering for k, p in planes.items()}
    results["hierarchical"] = {k: p._hierarchical for k, p in planes.items()}
    results["topology"] = [hvd.local_rank(), hvd.local_size(),
                           hvd.cross_rank(), hvd.cross_size()]
    hvd.shutdown()
    with open(os.path.join(out_dir, f"result{rank}.json"), "w") as f:
        json.dump(results, f)
    return 0


# -- the spawned worlds --------------------------------------------------
def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Start the three worlds at once; the tests below wait for them."""
    started = {}
    for (kind, size), port in zip(WORLDS.items(), _free_ports(len(WORLDS))):
        out = tmp_path_factory.mktemp(f"plane_{kind}")
        procs = []
        for r in range(size):
            env = dict(os.environ, HOROVOD_RANK=str(r),
                       HOROVOD_SIZE=str(size),
                       HOROVOD_CONTROLLER_ADDR="127.0.0.1",
                       HOROVOD_CONTROLLER_PORT=str(port),
                       HOROVOD_CYCLE_TIME="1",
                       GLOO_SOCKET_IFNAME="lo",
                       PYTHONPATH=str(REPO) + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
            if kind == "four":
                env.update(HOROVOD_HOSTNAME=f"fakehost{r // 2}",
                           HOROVOD_XLA_BCAST="tree",
                           HOROVOD_HIERARCHICAL_ALLREDUCE="1",
                           HOROVOD_HIERARCHICAL_ALLGATHER="1")
            procs.append(subprocess.Popen(
                [sys.executable, str(pathlib.Path(__file__)), kind,
                 str(out)], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        started[kind] = (out, procs)
    done = {}

    def wait(kind):
        if kind not in done:
            out, procs = started[kind]
            logs = []
            for p in procs:
                try:
                    stdout, stderr = p.communicate(timeout=120)
                except subprocess.TimeoutExpired:
                    for q in procs:
                        q.kill()
                    raise
                logs.append(stdout + stderr)
                assert p.returncode == 0, "\n".join(logs)
            done[kind] = ([json.loads((out / f"result{r}.json").read_text())
                           for r in range(len(procs))], logs)
        return done[kind]

    yield wait
    for _, procs in started.values():
        for p in procs:
            if p.poll() is None:
                p.kill()


# -- the tests -----------------------------------------------------------
@pytest.mark.parametrize("kind,comparison", [
    ("two", "flat_vs_star"), ("two", "tree_vs_star"),
    ("four", "flat_vs_star"), ("four", "hier_vs_star"),
    ("four", "hier_vs_flat"), ("refuse", "flat_vs_star")])
def test_plane_results_equal_the_stars(worlds, kind, comparison):
    results, _ = worlds(kind)
    for rank, res in enumerate(results):
        assert res[comparison] == "ok", f"rank {rank}:\n{res[comparison]}"


@pytest.mark.parametrize("kind", ["two", "four"])
def test_the_plane_served_every_response_of_its_runs(worlds, kind):
    results, _ = worlds(kind)
    for res in results:
        assert res["stats"]["star"].get("responses.process_group", 0) == 0
        for label, rendering in res["renderings"].items():
            assert rendering == "gloo"
            got = res["stats"][label]
            # The int16 allreduce is the one op the plane leaves to the
            # star (no gloo or NCCL sum for it).
            assert got["responses.socket"] == 1, got
            assert got["responses.process_group"] == \
                got["responses"] - 1, got
            # Every plane response but the barrier completed on a
            # finalizer thread.
            assert got["finalized"] == got["responses.process_group"] - 1


def test_hierarchical_plane_on_two_fake_hosts(worlds):
    results, _ = worlds("four")
    for rank, res in enumerate(results):
        assert res["topology"] == [rank % 2, 2, rank // 2, 2]
        assert res["hierarchical"] == {"flat": False, "hier": True}


def test_a_refusing_rank_sends_every_rank_to_the_star(worlds):
    results, logs = worlds("refuse")
    for res in results:
        got = res["stats"]["flat"]
        assert got.get("responses.process_group", 0) == 0, got
        assert got["responses.socket"] == got["responses"] > 0, got
        assert res["renderings"]["flat"] is None
    assert "another rank cannot join" in logs[0], logs[0]


@pytest.mark.parametrize("sizes,slice_numels,world", [
    ([1, 1], [4], 2), ([1, 40, 1, 1], [3], 4),
    ([1, 1, 1, 1, 1, 1, 1, 64], [2], 8),
    ([64, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2], [5, 7], 8),
    ([0, 0, 0, 0, 0, 0, 0, 9], [1], 8), ([3] * 16, [2], 16),
    ([1] * 15 + [1000], [1], 16), ([2 ** 28, 1, 1, 1, 1, 1, 1, 1], [16], 8),
    ([5], [3], 1)])
def test_skew_guard_decides_as_the_reference(sizes, slice_numels, world):
    from horovod_tpu.ops.xla_ops import ragged_psum_wins as ref
    from horovod_tpu_torch.ops.process_group_ops import ragged_psum_wins
    assert ragged_psum_wins(sizes, slice_numels, world) == \
        ref(sizes, slice_numels, world)


def test_skew_guard_table_has_both_verdicts():
    from horovod_tpu_torch.ops.process_group_ops import ragged_psum_wins
    assert ragged_psum_wins([1] * 7 + [64], [2], 8)
    assert not ragged_psum_wins([1, 40, 1, 1], [3], 4)


@pytest.mark.parametrize("value", ["psum", "tree", "PSUM", "bogus"])
def test_xla_bcast_is_parsed_and_validated(monkeypatch, value):
    from horovod_tpu_torch.common.config import Config
    monkeypatch.setenv("HOROVOD_XLA_BCAST", value)
    if value == "bogus":
        with pytest.raises(ValueError, match="psum"):
            Config.from_env()
    else:
        assert Config.from_env().xla_broadcast == value.lower()


def test_hierarchical_variables_are_config_fields(monkeypatch):
    from horovod_tpu_torch.common.config import Config
    monkeypatch.setenv("HOROVOD_HIERARCHICAL_ALLREDUCE", "1")
    monkeypatch.setenv("HOROVOD_HIERARCHICAL_ALLGATHER", "1")
    cfg = Config.from_env()
    assert cfg.hierarchical_allreduce and cfg.hierarchical_allgather
    monkeypatch.setenv("HOROVOD_TPU_ICI", "1")
    with pytest.raises(NotImplementedError, match="A6.5"):
        Config.from_env()


def test_agree_is_a_world_wide_and():
    from horovod_tpu_torch.common.controller import LocalController
    ctl = LocalController()
    assert ctl.agree(True) is True
    assert ctl.agree(False) is False


if __name__ == "__main__":
    sys.exit(_world_main(sys.argv[1], sys.argv[2]))
