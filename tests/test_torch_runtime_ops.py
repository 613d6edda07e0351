"""The port's negotiated runtime on torch tensors (CPU), against the JAX
package's.

- Size 1, in process: the cases of ``tests/test_ops_single.py`` (the
  identities, prescale, async poll/synchronize, many tensors fused, the
  duplicate name, bfloat16, integer average rejected, alltoall and
  reducescatter), and the hook-driven eager ``DistributedOptimizer``
  against ``horovod_tpu.torch.DistributedOptimizer`` on the same model
  and batches: exactly equal losses and parameters.
- Worlds of 2 and 3 ranks, each started once for the module (this file
  run as a script is a rank), run in one spawn the scenarios of
  ``tests/mp_scenarios.py`` this slice covers, at the response cache's
  defaults, and hold every output to the scenario's closed-form value
  exactly; a stall warning at ``HOROVOD_STALL_CHECK_TIME_SECONDS=1``;
  the timeline's vocabulary; an eager-optimizer step that equals the
  single-process whole-batch step (1e-6: the ranks' gradients are summed
  in another order than one batch's); a steady state of identical steps
  that runs through the cache's bitmask and its speculative fused
  cycles, with every rank's cache in lockstep. A 2-rank world with the
  cache off (``nocache``) runs the same scenarios, and its training
  steps equal the cached world's bit for bit. A 2-rank world with 4
  cache slots and speculation off on rank 1 (``evict``) keeps its caches
  coherent under constant eviction and runs the classic path. Two more
  2-rank worlds lose rank 0 or rank 1 after a barrier: the survivor's
  pending allreduce raises WorldAbortedError naming the dead rank.
- The socket star's host arithmetic against the reference's numpy, bit
  for bit.
"""

import copy
import json
import os
import pathlib
import sys
import time
import traceback

import numpy as np
import pytest
import torch

SCENARIOS = ["allreduce", "allreduce_fused", "allreduce_multi_dtype",
             "allgather", "broadcast", "alltoall", "reducescatter",
             "grouped_allreduce", "out_of_order", "mismatch", "stall",
             "eager_step", "steady"]
# The 2-rank world with 4 cache slots runs these only.
EVICT_SCENARIOS = ["steady", "evict"]
LM = dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=8,
          mlp_ratio=2, max_seq_len=16)
LR = 0.1


# -- the scenarios, run on every rank of a spawned world -----------------
def _eq(got, want):
    assert got.dtype == want.dtype and torch.equal(got, want), (got, want)


def scenario_allreduce(hvd, rank, size):
    x = torch.full((4, 3), float(rank + 1))
    ssum = sum(range(1, size + 1))
    _eq(hvd.allreduce(x, average=False, name="ar"),
        torch.full((4, 3), float(ssum)))
    _eq(hvd.allreduce(x, average=True, name="ar_avg"),
        torch.full((4, 3), ssum / size))


def scenario_allreduce_fused(hvd, rank, size):
    handles = [hvd.allreduce_async(
        torch.full((10,), float(rank + 1) * (i + 1), dtype=torch.float64),
        average=False, name=f"f/{i}") for i in range(30)]
    ssum = sum(range(1, size + 1))
    for i, h in enumerate(handles):
        _eq(hvd.synchronize(h),
            torch.full((10,), float(ssum * (i + 1)), dtype=torch.float64))


def scenario_allreduce_multi_dtype(hvd, rank, size):
    for dt in (torch.int32, torch.int64, torch.float16, torch.float32,
               torch.float64, torch.bfloat16, torch.uint8):
        x = (torch.arange(6) + rank).to(dt)
        want = (size * torch.arange(6) + sum(range(size))).to(dt)
        _eq(hvd.allreduce(x, average=False, name=f"dt/{dt}"), want)


def scenario_allgather(hvd, rank, size):
    x = torch.full((rank + 1, 2), float(rank))
    want = torch.cat([torch.full((r + 1, 2), float(r)) for r in range(size)])
    _eq(hvd.allgather(x, name="ag"), want)
    # An entry with no rows on rank 0 is fine too.
    _eq(hvd.allgather(torch.full((rank, 3), float(rank)), name="ag0"),
        torch.cat([torch.full((r, 3), float(r)) for r in range(size)]))


def scenario_broadcast(hvd, rank, size):
    for root in range(size):
        x = torch.full((3, 3), float(rank * 10), dtype=torch.float64)
        _eq(hvd.broadcast(x, root_rank=root, name=f"bc/{root}"),
            torch.full((3, 3), float(root * 10), dtype=torch.float64))


def scenario_alltoall(hvd, rank, size):
    per = 2
    x = torch.arange(size * per, dtype=torch.float32) + 100 * rank
    want = torch.cat([torch.arange(rank * per, (rank + 1) * per) + 100 * src
                      for src in range(size)]).float()
    _eq(hvd.alltoall(x, name="a2a"), want)


def scenario_reducescatter(hvd, rank, size):
    x = torch.arange(size * 3, dtype=torch.float32) * (rank + 1)
    ssum = sum(range(1, size + 1))
    want = (torch.arange(size * 3, dtype=torch.float32)
            * ssum)[rank * 3:(rank + 1) * 3]
    _eq(hvd.reducescatter(x, name="rs"), want)
    # Average divides by the world size (see the coordinator's note).
    mean = hvd.reducescatter(x, name="rs_avg", op=hvd.Average)
    _eq(mean, want * torch.tensor(1.0 / size))


def scenario_grouped_allreduce(hvd, rank, size):
    ssum = sum(range(1, size + 1))
    tensors = [torch.full((16 + i,), float(rank + 1) * (i + 1),
                          dtype=torch.float64) for i in range(6)]
    tensors.append(torch.full((4,), rank + 1, dtype=torch.int64))
    outs = hvd.grouped_allreduce(tensors, average=False, name="grp")
    for i in range(6):
        _eq(outs[i], torch.full((16 + i,), ssum * (i + 1.0),
                                dtype=torch.float64))
    _eq(outs[6], torch.full((4,), ssum, dtype=torch.int64))
    avg = hvd.grouped_allreduce([torch.full((3,), float(rank + 1) * 2)],
                                name="grp.avg")
    _eq(avg[0], torch.full((3,), 2.0 * ssum / size))
    bad = [torch.ones(5), torch.ones(4 + rank % 2)]
    try:
        hvd.grouped_allreduce(bad, average=False, name="grp.bad")
    except hvd.HorovodInternalError as e:
        assert "shape" in str(e).lower()
    else:
        raise AssertionError("expected a group member error")
    for name, member in (("grp.val", torch.ones(2, dtype=torch.int32)),
                         ("grp.cplx", torch.ones(2, dtype=torch.complex64))):
        try:
            hvd.grouped_allreduce([torch.ones(2), member], name=name)
        except ValueError:
            pass
        else:
            raise AssertionError(f"{name}: expected ValueError")
        _eq(hvd.grouped_allreduce([torch.ones(2)], average=False,
                                  name=f"{name}.after")[0],
            torch.full((2,), float(size)))


def scenario_out_of_order(hvd, rank, size):
    names = ["oo/a", "oo/b", "oo/c"]
    if rank % 2:
        names.reverse()
    handles = {n: hvd.allreduce_async(torch.full((5,), float(rank)),
                                      average=False, name=n) for n in names}
    for n, h in handles.items():
        _eq(hvd.synchronize(h), torch.full((5,), float(sum(range(size)))))


def scenario_mismatch(hvd, rank, size):
    dt = torch.float64 if rank == size - 1 else torch.float32
    try:
        hvd.allreduce(torch.ones(3, dtype=dt), name="mm")
    except hvd.HorovodInternalError as e:
        assert "Mismatched data types" in str(e), e
    else:
        raise AssertionError("expected a dtype mismatch error")
    _eq(hvd.allreduce(torch.ones(3), average=False, name="mm.after"),
        torch.full((3,), float(size)))


def scenario_stall(hvd, rank, size):
    """Rank 0 submits at once, the others 2.2 s later: rank 0's
    coordinator warns (HOROVOD_STALL_CHECK_TIME_SECONDS=1), then the
    tensor completes."""
    if rank:
        time.sleep(2.2)
    _eq(hvd.allreduce(torch.ones(2), average=False, name="stall.x"),
        torch.full((2,), float(size)))


def _lm_loss(T, model, tokens):
    hidden = model(tokens, return_hidden=True)
    return T.lm_loss_from_hidden(hidden, model.lm_head.weight.t(), tokens,
                                 chunk=8)


def _cache_fingerprint(hvd, tag):
    """Every rank's (epoch, CRC of the cache's coherent state), gathered:
    the ranks' rows must be equal."""
    import zlib
    from horovod_tpu_torch.common import basics
    cache = basics.runtime()._cache
    fp = [cache.epoch, zlib.crc32(repr(cache.state_fingerprint()).encode())]
    return hvd.allgather(torch.tensor([fp]), name=tag)


def scenario_steady(hvd, rank, size, results):
    """Six identical steps of two named sums, an average (the
    postscale) and a prescaled sum, exact every step: the steady state
    the response cache serves (four tensors: the ``evict`` world's
    slots). Records the cache's counts after them, and every rank's
    fingerprint."""
    from horovod_tpu_torch.common import basics
    ssum = sum(range(1, size + 1))
    xs = [torch.full((64 + i,), float(rank + 1) * (i + 1),
                     dtype=torch.float64) for i in range(2)]
    y = torch.full((5,), float(rank + 1))
    for _ in range(6):
        hs = [hvd.allreduce_async(x, average=False, name=f"st.{i}")
              for i, x in enumerate(xs)]
        h_avg = hvd.allreduce_async(y, op=hvd.Average, name="st.avg")
        h_pre = hvd.allreduce_async(y, op=hvd.Sum, prescale_factor=2.0,
                                    name="st.pre")
        for i, h in enumerate(hs):
            _eq(hvd.synchronize(h), torch.full((64 + i,), ssum * (i + 1.0),
                                               dtype=torch.float64))
        _eq(hvd.synchronize(h_avg),
            torch.full((5,), float(ssum)) * torch.tensor(1.0 / size))
        _eq(hvd.synchronize(h_pre), torch.full((5,), 2.0 * ssum))
    stats = basics.runtime().negotiation_cache_stats()
    if stats["enabled"]:
        stats["fingerprints"] = _cache_fingerprint(hvd, "st.fp").tolist()
    results["steady_stats"] = stats


def scenario_evict(hvd, rank, size, results):
    """Ten tensors per step through 4 cache slots for four steps: every
    put evicts, names come back after their eviction, the results stay
    exact and the caches in lockstep."""
    ssum = sum(range(1, size + 1))
    fps = []
    for step in range(4):
        hs = [hvd.allreduce_async(torch.full((8,), float(rank + 1) * (i + 1)),
                                  average=False, name=f"ev.{i}")
              for i in range(10)]
        for i, h in enumerate(hs):
            _eq(hvd.synchronize(h), torch.full((8,), ssum * (i + 1.0)))
        fps.append(_cache_fingerprint(hvd, f"ev.fp{step}").tolist())
    results["evict_fingerprints"] = fps


def scenario_eager_step(hvd, rank, size, out_dir):
    """Weights from rank 1 (broadcast through the runtime), rows
    2r..2r+1 of the batch, one eager-optimizer step, then two more on
    the same rows (the last two replay from the response cache)."""
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.torch import eager
    model = T.TransformerLM(T.TransformerConfig(dtype=torch.float32, **LM),
                            device="cpu",
                            generator=torch.Generator().manual_seed(10 + rank))
    eager.broadcast_parameters(model.state_dict(), root_rank=1)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    opt = eager.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9),
        named_parameters=model.named_parameters())
    tokens = torch.tensor(np.random.RandomState(7).randint(
        0, LM["vocab_size"], (2 * size, LM["max_seq_len"])))
    _lm_loss(T, model, tokens[2 * rank:2 * rank + 2]).backward()
    opt.step()
    eager.broadcast_optimizer_state(opt, root_rank=0)
    after = {k: v.clone() for k, v in model.state_dict().items()}
    for _ in range(2):
        opt.zero_grad()
        _lm_loss(T, model, tokens[2 * rank:2 * rank + 2]).backward()
        opt.step()
    torch.save({"init": init, "after": after, "final": model.state_dict()},
               os.path.join(out_dir, f"{rank}.pt"))


def _world_main(out_dir: str, scenarios) -> int:
    """One rank of a spawned world: the scenarios in turn, each one's
    outcome in ``<out_dir>/result<rank>.json``."""
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    rank, size = hvd.rank(), hvd.size()
    results = {}
    for name in scenarios:
        fn = globals()[f"scenario_{name}"]
        try:
            if name == "eager_step":
                fn(hvd, rank, size, out_dir)
            elif name in ("steady", "evict"):
                fn(hvd, rank, size, results)
            else:
                fn(hvd, rank, size)
            results[name] = "ok"
        except Exception:
            results[name] = traceback.format_exc()
    from horovod_tpu_torch.common import basics
    results["stats"] = basics.runtime().stats
    results["cache"] = basics.runtime().negotiation_cache_stats()
    hvd.shutdown()
    with open(os.path.join(out_dir, f"result{rank}.json"), "w") as f:
        json.dump(results, f)
    return 0


def _death_main(out_dir: str, dead: int) -> int:
    """One rank of a world in which rank ``dead`` exits abruptly after a
    barrier: the survivor's next allreduce must raise, naming it, and
    its shutdown must return."""
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    rank = hvd.rank()
    hvd.barrier()
    if rank == dead:
        os._exit(0)  # no shutdown: the sockets just close
    t0 = time.monotonic()
    try:
        hvd.allreduce(torch.ones(2), name="orphan")
        result = {"raised": None}
    except hvd.HorovodInternalError as e:
        result = {"raised": type(e).__name__, "message": str(e),
                  "origin": getattr(e, "origin_rank", None),
                  "seconds": time.monotonic() - t0}
    hvd.shutdown()
    with open(os.path.join(out_dir, f"result{rank}.json"), "w") as f:
        json.dump(result, f)
    return 0


# -- the spawned worlds --------------------------------------------------
# World kind -> (ranks, environment of every rank, of rank 1 only).
WORLD_ENV = {2: (2, {}, {}), 3: (3, {}, {}),
             "nocache": (2, {"HOROVOD_CACHE_CAPACITY": "0"}, {}),
             "evict": (2, {"HOROVOD_CACHE_CAPACITY": "4"},
                       {"HOROVOD_CACHE_SPECULATIVE": "0"}),
             "dead0": (2, {}, {}), "dead1": (2, {}, {})}


# One deadline for the worlds together, from their start (about 10 s on
# an 8-core host).
WORLDS_DEADLINE_S = 90.0


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Start the worlds of ``WORLD_ENV`` at once (a 2-rank and a 3-rank
    world, the 2-rank world without the cache and with 4 slots, and two
    2-rank worlds that lose rank 0 or rank 1); the tests below wait for
    them (the in-process tests run meanwhile; ``tests/torch_worlds.py``:
    one deadline, logs in files, the ports held until the worlds end)."""
    from tests.torch_worlds import Worlds, child_env
    spawned = Worlds(WORLDS_DEADLINE_S)
    try:
        for size, (n, every, rank1) in WORLD_ENV.items():
            out = tmp_path_factory.mktemp(f"world{size}")
            args = [out]
            if str(size).startswith("dead"):
                args = ["--death", size[-1], out]
            elif size == "evict":
                args.append(",".join(EVICT_SCENARIOS))
            port = spawned.reserve_port()
            envs = [child_env(**every, **(rank1 if r == 1 else {}),
                              HOROVOD_RANK=r, HOROVOD_SIZE=n,
                              HOROVOD_CONTROLLER_ADDR="127.0.0.1",
                              HOROVOD_CONTROLLER_PORT=port,
                              HOROVOD_CYCLE_TIME=2,
                              HOROVOD_STALL_CHECK_TIME_SECONDS=1,
                              HOROVOD_TIMELINE=out / "timeline.json",
                              HOROVOD_TIMELINE_MARK_CYCLES=1)
                    for r in range(n)]
            spawned.start(size, out, [[pathlib.Path(__file__)] + args] * n,
                          envs)

        def wait(size):
            rcs, results, logs = spawned.wait(size)
            assert rcs == [0] * len(rcs), "\n".join(logs)
            return spawned.out(size), results, logs
        yield wait
    finally:
        spawned.close()


@pytest.fixture
def port_world():
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


# -- size 1, in process (tests/test_ops_single.py) -----------------------
def test_basics_at_size_one(worlds, port_world):
    hvd = port_world
    assert hvd.initialized()
    assert (hvd.rank(), hvd.size(), hvd.local_rank(), hvd.local_size(),
            hvd.cross_rank(), hvd.cross_size()) == (0, 1, 0, 1, 0, 1)
    assert hvd.is_homogeneous()
    hvd.init(device="cpu")  # a second init is a no-op
    assert hvd.size() == 1


def test_uninitialized_raises():
    import horovod_tpu_torch as hvd
    assert not hvd.initialized()
    with pytest.raises(ValueError):
        hvd.rank()
    with pytest.raises(ValueError):
        hvd.allreduce(torch.ones(2))


@pytest.mark.parametrize("case", ["average", "sum", "prescale", "allgather",
                                  "broadcast", "alltoall", "reducescatter",
                                  "bfloat16"])
def test_size_one_ops_are_identities(port_world, case):
    hvd = port_world
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 4, generator=g)
    if case == "average":
        _eq(hvd.allreduce(x, average=True), x)
    elif case == "sum":
        x = x.double()
        _eq(hvd.allreduce(x, average=False), x)
    elif case == "prescale":
        _eq(hvd.allreduce(torch.ones(4), op=hvd.Sum, prescale_factor=2.0),
            torch.full((4,), 2.0))
    elif case == "allgather":
        _eq(hvd.allgather(x), x)
    elif case == "broadcast":
        _eq(hvd.broadcast(x, root_rank=0), x)
    elif case == "alltoall":
        _eq(hvd.alltoall(torch.arange(6.0)), torch.arange(6.0))
    elif case == "reducescatter":
        _eq(hvd.reducescatter(torch.arange(6.0)), torch.arange(6.0))
    else:
        _eq(hvd.allreduce(torch.ones(16, dtype=torch.bfloat16),
                          average=False),
            torch.ones(16, dtype=torch.bfloat16))


def test_async_poll_synchronize(port_world):
    hvd = port_world
    h = hvd.allreduce_async(torch.ones(1000), average=False, name="async_t")
    deadline = time.monotonic() + 10
    while not hvd.poll(h):
        assert time.monotonic() < deadline
    _eq(hvd.synchronize(h), torch.ones(1000))
    with pytest.raises(ValueError):
        hvd.synchronize(h)  # released


def test_many_tensors_fused(port_world):
    from horovod_tpu_torch.common import basics
    hvd = port_world
    stats = basics.runtime().stats
    before = dict(stats)
    handles = [hvd.allreduce_async(torch.full((10,), float(i)),
                                   average=False, name=f"fuse/{i}")
               for i in range(50)]
    for i, h in enumerate(handles):
        _eq(hvd.synchronize(h), torch.full((10,), float(i)))
    assert stats["tensors"] - before["tensors"] == 50
    assert stats["responses"] - before["responses"] < 50  # some fused


def test_duplicate_name_raises(port_world, monkeypatch):
    """Two in-flight ops under one name: the second fails. The loop is
    kept from draining the queue meanwhile, so that the first is still in
    flight when the second is enqueued (at size 1 it would otherwise
    complete within a cycle)."""
    from horovod_tpu_torch.common import basics
    hvd = port_world
    table = basics.runtime().tensor_table
    monkeypatch.setattr(table, "pop_messages", lambda: [])
    h1 = hvd.allreduce_async(torch.ones(4), name="dup")
    h2 = hvd.allreduce_async(torch.ones(4), name="dup")
    with pytest.raises(hvd.HorovodInternalError, match="same name"):
        hvd.synchronize(h2)
    monkeypatch.undo()
    _eq(hvd.synchronize(h1), torch.ones(4))


def test_integer_average_rejected(port_world):
    hvd = port_world
    with pytest.raises(ValueError, match="integer"):
        hvd.allreduce(torch.arange(4), average=True)
    with pytest.raises(ValueError, match="integer"):
        hvd.allreduce(torch.arange(4, dtype=torch.int32), op=hvd.Sum,
                      prescale_factor=0.5)
    _eq(hvd.allreduce(torch.arange(4), op=hvd.Sum), torch.arange(4))


def test_autograd_through_the_eager_ops(port_world):
    from horovod_tpu_torch.torch import eager
    x = torch.arange(4.0, requires_grad=True)
    (eager.allreduce(x, op=eager.Sum) * torch.arange(4.0)).sum().backward()
    _eq(x.grad, torch.arange(4.0))
    y = torch.ones(2, 3, requires_grad=True)
    eager.allgather(y).sum().backward()
    _eq(y.grad, torch.ones(2, 3))
    z = torch.ones(3, requires_grad=True)
    (2 * eager.broadcast(z, 0)).sum().backward()
    _eq(z.grad, torch.full((3,), 2.0))
    w = torch.zeros(3)
    _eq(eager.broadcast_(eager.allreduce_(w), 0), torch.zeros(3))


def test_not_ported_planes_raise(monkeypatch):
    import horovod_tpu_torch as hvd
    # The heartbeat (A6.2) and wire compression (A6.5) are ported now;
    # their knobs are held in tests/test_torch_faults.py.
    for name, value in (("HOROVOD_TPU_ICI", "1"),
                        ("HOROVOD_TPU_RING_THRESHOLD", "0"),
                        ("HOROVOD_TPU_SHM", "1"),
                        ("HOROVOD_TWO_LEVEL", "1")):
        monkeypatch.setenv(name, value)
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            hvd.init(device="cpu")
        assert not hvd.initialized()
        monkeypatch.delenv(name)
    monkeypatch.setenv("HOROVOD_CACHE_CAPACITY", "0")
    monkeypatch.setenv("HOROVOD_TPU_SHM", "0")
    hvd.init(device="cpu")
    hvd.shutdown()


@pytest.mark.parametrize("backward_passes", [1, 2])
def test_eager_optimizer_equals_the_reference_at_size_one(port_world,
                                                          backward_passes):
    """``horovod_tpu.torch.DistributedOptimizer`` and the port's eager
    one, SGD with momentum on the same tiny TransformerLM and batches,
    both runtimes at their response cache's defaults: the same losses
    and parameters, bit for bit, and both caches served the steps."""
    import horovod_tpu as ref_hvd
    import horovod_tpu.torch as ref_torch
    from horovod_tpu.common import basics as ref_basics
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.models import transformer as T
    from horovod_tpu_torch.torch import eager
    ref_hvd.init()
    try:
        mine = T.TransformerLM(T.TransformerConfig(dtype=torch.float32, **LM),
                               device="cpu",
                               generator=torch.Generator().manual_seed(3))
        theirs = copy.deepcopy(mine)
        opts = [w(torch.optim.SGD(m.parameters(), lr=LR, momentum=0.9),
                  named_parameters=m.named_parameters(),
                  backward_passes_per_step=backward_passes)
                for w, m in ((eager.DistributedOptimizer, mine),
                             (ref_torch.DistributedOptimizer, theirs))]
        rng = np.random.RandomState(5)
        for _ in range(3):
            losses = []
            batches = [torch.tensor(rng.randint(0, LM["vocab_size"],
                                                (2, LM["max_seq_len"])))
                       for _ in range(backward_passes)]
            for opt, model in zip(opts, (mine, theirs)):
                opt.zero_grad()
                for tokens in batches:
                    loss = _lm_loss(T, model, tokens)
                    loss.backward()
                opt.step()
                losses.append(loss.item())
            assert losses[0] == losses[1]
        for (name, a), (_, b) in zip(mine.named_parameters(),
                                     theirs.named_parameters()):
            assert torch.equal(a, b), name
        for rt in (basics.runtime(), ref_basics.runtime()):
            st = rt.negotiation_cache_stats()
            assert st["capacity"] == 1024 and st["hits"] > 0, st
            assert rt.config.cache_speculative
        eager.broadcast_optimizer_state(opts[0], root_rank=0)
    finally:
        ref_hvd.shutdown()


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32",
                                   "float64", "int32"])
def test_star_arithmetic_is_the_references_bit_for_bit(dtype):
    """The socket star's host arithmetic against the reference's numpy
    (``horovod_tpu/ops/socket_ops.py:348-420`` with the native core
    off): the prescale in the fusion pack, ``acc += peer`` in rank order
    in the tensor's dtype, the postscale; each rounds to nearest-even in
    both, so the results are equal bit for bit, bfloat16 included."""
    import ml_dtypes
    from horovod_tpu_torch.ops.backend import pack, scale_
    from horovod_tpu_torch.ops.socket_ops import _accumulate
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    bits = {2: np.uint16, 4: np.uint32, 8: np.uint64}[np.dtype(np_dt).itemsize]
    rng = np.random.RandomState(0)
    floating = dtype != "int32"
    pre, post = (1 / 3, 1 / 7) if floating else (1.0, 1.0)
    ranks = [(rng.randn(2, 1000) * 10.0 ** rng.uniform(-3, 3, (2, 1000))
              if floating else rng.randint(-2 ** 20, 2 ** 20, (2, 1000))
              ).astype(np_dt) for _ in range(4)]

    def to_torch(a):
        return torch.from_numpy(a.view(bits).copy()).view(
            getattr(torch, dtype))

    # The reference: pack (each rank's two entries) with the prescale,
    # the coordinator's sum, the postscale.
    packed = [np.concatenate([x.reshape(-1) for x in r])
              * np.asarray(pre, np_dt) for r in ranks]
    want = packed[0].copy()
    for peer in packed[1:]:
        want += peer
    want = want * np.asarray(post, np_dt)
    got = [pack([to_torch(x) for x in r], pre) for r in ranks]
    acc = got[0]
    for peer in got[1:]:
        _accumulate(acc, peer)
    scale_(acc, post)
    assert torch.equal(acc, to_torch(want))


def test_bench_eager_step_equals_the_in_step_one(port_world):
    """``bench.transformer_step(eager=True)`` (the step phase 9 of
    chip_smoke.py runs at full width) equals the in-step step at size 1:
    the same losses and parameters after three steps."""
    from horovod_tpu_torch import bench
    from horovod_tpu_torch.models import transformer as T
    cfg = T.TransformerConfig(dtype=torch.float32, **LM)
    runs = []
    for eager in (False, True):
        step, model = bench.transformer_step(cfg, 2, seed=4, device="cpu",
                                             eager=eager)
        losses = [step().item() for _ in range(3)]
        runs.append((losses, [p.detach() for p in model.parameters()]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_eager_optimizer_releases_the_model(port_world):
    """Once the step and the model are dropped, the eager optimizer's
    gradient hooks keep no parameter, gradient or momentum alive: a
    process that trains several models one after the other (phase 9 of
    chip_smoke.py) gets their memory back."""
    import gc
    import weakref
    from horovod_tpu_torch import bench
    from horovod_tpu_torch.models import transformer as T
    cfg = T.TransformerConfig(dtype=torch.float32, **LM)
    step, model = bench.transformer_step(cfg, 2, seed=4, device="cpu",
                                         eager=True)
    for _ in range(2):
        step().item()
    refs = [weakref.ref(p) for p in model.parameters()]
    del step, model
    gc.collect()
    assert [r for r in refs if r() is not None] == []


# -- the worlds ----------------------------------------------------------
@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("size", [2, 3, "nocache"])
def test_world_scenario(worlds, size, scenario):
    _, results, _ = worlds(size)
    for rank, res in enumerate(results):
        assert res[scenario] == "ok", f"rank {rank}:\n{res[scenario]}"


@pytest.mark.parametrize("size", [2, 3])
def test_world_stall_warning_and_timeline(worlds, size):
    out, results, logs = worlds(size)
    assert "Stalled op: stall.x" in logs[0], logs[0]
    assert "waiting on ranks: [" in logs[0]
    names = {e.get("name") for e in json.loads(
        (out / "timeline.json").read_text())}
    for required in ("NEGOTIATE_ALLREDUCE", "NEGOTIATE_ALLGATHER",
                     "NEGOTIATE_BROADCAST", "NEGOTIATE_ALLTOALL",
                     "NEGOTIATE_REDUCESCATTER", "ALLREDUCE", "ALLGATHER",
                     "BROADCAST", "QUEUE", "COLLECTIVE",
                     "MEMCPY_IN_FUSION_BUFFER", "MEMCPY_OUT_FUSION_BUFFER",
                     "CYCLE_START"):
        assert required in names, (required, sorted(n for n in names if n))
    # Tensors were fused: fewer responses than tensors on every rank.
    for res in results:
        assert res["stats"]["responses"] < res["stats"]["tensors"]


@pytest.mark.parametrize("size", [2, 3])
def test_world_eager_step_equals_the_whole_batch_step(worlds, size):
    out, _, _ = worlds(size)
    from horovod_tpu_torch.models import transformer as T
    model = T.TransformerLM(T.TransformerConfig(dtype=torch.float32, **LM),
                            device="cpu",
                            generator=torch.Generator().manual_seed(11))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    opt = torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9)
    tokens = torch.tensor(np.random.RandomState(7).randint(
        0, LM["vocab_size"], (2 * size, LM["max_seq_len"])))
    _lm_loss(T, model, tokens).backward()
    opt.step()
    want = model.state_dict()
    ranks = [torch.load(out / f"{r}.pt") for r in range(size)]
    for name in want:
        for got in ranks:
            assert torch.equal(got["init"][name], start[name]), name
            np.testing.assert_allclose(got["after"][name].numpy(),
                                       want[name].numpy(), atol=1e-6,
                                       err_msg=name)
            assert torch.equal(got["after"][name],
                               ranks[0]["after"][name]), name
        assert not torch.equal(want[name], start[name]), name


@pytest.mark.parametrize("size", [2, 3])
def test_world_steady_state_runs_through_the_cache(worlds, size):
    """At the cache's defaults the steady steps negotiate through the
    bitmask (cached cycles) and complete in speculative fused cycles on
    the star, with every rank's cache in the same state."""
    out, results, _ = worlds(size)
    for rank, res in enumerate(results):
        st = res["steady_stats"]
        assert st["enabled"] and st["capacity"] == 1024, st
        assert st["cached_cycles"] > 0, (rank, st)
        assert st["spec_cycles"] > 0, (rank, st)
        rows = st["fingerprints"]
        assert len(rows) == size and all(r == rows[0] for r in rows), rows
    names = {e.get("name") for e in json.loads(
        (out / "timeline.json").read_text())}
    assert "NEGOTIATE_CACHED_FUSED" in names


def test_cache_off_world_equals_the_cached_one_bit_for_bit(worlds):
    """HOROVOD_CACHE_CAPACITY=0 runs the full path on every rank, and
    three eager-optimizer steps (two of them replayed from the cache in
    the cached world) give the same parameters bit for bit."""
    off, off_results, _ = worlds("nocache")
    on, _, _ = worlds(2)
    for res in off_results:
        assert res["cache"] == {"enabled": False}
        assert res["stats"]["cached_cycles"] == 0
    for r in range(2):
        a, b = torch.load(on / f"{r}.pt"), torch.load(off / f"{r}.pt")
        for stage in ("init", "after", "final"):
            for name in a[stage]:
                assert torch.equal(a[stage][name], b[stage][name]), \
                    (r, stage, name)


def test_eviction_world_stays_coherent_with_speculation_off_on_one_rank(
        worlds):
    """4 slots against ten tensors a step: constant eviction, the two
    ranks' epochs and cache states equal after every step, the results
    exact (in the scenarios); with speculation off on rank 1 every cycle
    runs the classic path, and rank 0 stops bidding after its bids are
    denied."""
    _, results, _ = worlds("evict")
    for rank, res in enumerate(results):
        for scenario in EVICT_SCENARIOS:
            assert res[scenario] == "ok", f"rank {rank}:\n{res[scenario]}"
        assert res["cache"]["capacity"] == 4
        assert res["cache"]["entries"] <= 4
        assert res["stats"]["cache_evictions"] > 0
        assert res["cache"]["cached_cycles"] > 0
        assert res["cache"]["spec_cycles"] == 0
        for rows in res["evict_fingerprints"]:
            assert rows[0] == rows[1], rows
    assert results[0]["evict_fingerprints"] == \
        results[1]["evict_fingerprints"]
    assert results[1]["cache"]["spec_bids"] == 0
    assert 0 < results[0]["cache"]["spec_bids"] <= 8
    assert results[0]["stats"]["spec_denials"] > 0
    # each denied bid's pack is counted as unused (it is packed again)
    assert results[0]["stats"]["spec_unused_bytes"] > 0
    assert results[1]["stats"]["spec_unused_bytes"] == 0


@pytest.mark.parametrize("dead", [0, 1])
def test_a_rank_that_dies_fails_the_survivors_handles(worlds, dead):
    """A peer whose socket closes surfaces as a WorldAbortedError (a
    HorovodInternalError) naming it on the survivor's pending handle,
    not as a hang; the survivor's shutdown returns."""
    _, results, _ = worlds(f"dead{dead}")
    survivor = results[1 - dead]
    assert results[dead] is None
    assert survivor["raised"] == "WorldAbortedError", survivor
    assert survivor["origin"] == dead, survivor
    assert survivor["seconds"] < 10


if __name__ == "__main__":
    if sys.argv[1] == "--death":
        sys.exit(_death_main(sys.argv[3], int(sys.argv[2])))
    sys.exit(_world_main(sys.argv[1], sys.argv[2].split(",")
                         if len(sys.argv) > 2 else SCENARIOS))
