"""The port's response cache against the JAX package's, on the CPU.

- ``ResponseCache``: scripted and seeded op sequences (puts with
  rank-local signatures, lookups, LRU touches, mask and name evictions)
  run through both caches; after every op the lookup's (state, slot), the
  epoch, the length, the hit/miss/eviction counts, the coherent
  fingerprint and the mask of allreduce slots must be equal. The scripted cases are those of
  ``tests/test_response_cache.py::TestResponseCache``.
- The cycle frames: every kind, request and response, from seeded
  contents, byte-identical in both ``wire`` modules, and each package
  parses the other's bytes to equal contents; ``combine_cycle_requests``
  agrees and refuses speculative and diverged frames; the port refuses a
  frame cut at any byte with ``ConnectionError``.
- The runtime's pure helpers: ``_unfuse``, the replay plans, and
  ``_reduce_spec`` (bit for bit, in fp32, fp64, fp16 and int32; diverged
  layouts refused); a rank whose cache setting differs from the
  coordinator's is refused on both sides; the config knobs.
"""

import numpy as np
import pytest
import torch

from horovod_tpu.common import coordinator as ref_coord
from horovod_tpu.common import message as ref_msg
from horovod_tpu.common import runtime as ref_runtime
from horovod_tpu.common import wire as ref_wire
from horovod_tpu_torch.common import coordinator as port_coord
from horovod_tpu_torch.common import message as port_msg
from horovod_tpu_torch.common import runtime as port_runtime
from horovod_tpu_torch.common import wire as port_wire

IMPLS = {"ref": (ref_coord, ref_msg), "port": (port_coord, port_msg)}


def _req(msg, name, rank=0, shape=(4,), dtype="FLOAT32", device=-1,
         op="ALLREDUCE", root=-1, pre=1.0, post=1.0):
    return msg.Request(request_rank=rank,
                       request_type=getattr(msg.RequestType, op),
                       tensor_type=getattr(msg.DataType, dtype),
                       tensor_name=name, root_rank=root, device=device,
                       tensor_shape=shape, prescale_factor=pre,
                       postscale_factor=post)


def _resp(msg, name, numel=4, op="ALLREDUCE"):
    return msg.Response(response_type=getattr(msg.ResponseType, op),
                        tensor_names=[name], devices=[-1, -1],
                        tensor_sizes=[numel])


# -- the cache ---------------------------------------------------------------
# An op script: ("put", name, rank-local shape) | ("lookup", name, shape)
# | ("touch", mask) | ("evict", mask) | ("evict_name", name)
SCRIPTS = {
    "lookup_states": (4, [
        ("lookup", "g", (4,)), ("put", "g", (4,)), ("lookup", "g", (4,)),
        ("lookup", "g", (8,)), ("lookup_dtype", "g", (4,))]),
    "lru_capacity_eviction_and_slot_reuse": (2, [
        ("put", "a", (4,)), ("put", "b", (4,)), ("put", "c", (4,)),
        ("lookup", "a", (4,)), ("lookup", "c", (4,)),
        ("lookup", "b", (4,))]),
    "touch_steers_eviction": (2, [
        ("put", "a", (4,)), ("put", "b", (4,)), ("touch", 0b01),
        ("put", "c", (4,)), ("lookup", "b", (4,)), ("lookup", "a", (4,))]),
    "touch_does_not_bump_epoch": (4, [
        ("put", "a", (4,)), ("touch", 0b1), ("touch", 0b1)]),
    "evict_slots_ascending": (4, [
        ("put", "a", (4,)), ("put", "b", (4,)), ("put", "c", (4,)),
        ("put", "d", (4,)), ("evict", 0b0101), ("lookup", "a", (4,)),
        ("lookup", "c", (4,)), ("lookup", "b", (4,)), ("put", "e", (4,)),
        ("lookup", "e", (4,)), ("evict_name", "b"), ("put", "f", (4,))]),
}


def _seeded_script(seed):
    rng = np.random.RandomState(seed)
    cap = int(rng.randint(2, 9))
    names = [f"t{i}" for i in range(int(rng.randint(cap, 3 * cap)))]
    ops = []
    for _ in range(120):
        kind = rng.choice(["put", "put", "lookup", "lookup", "touch",
                           "evict", "evict_name"])
        if kind in ("put", "lookup"):
            ops.append((kind, names[rng.randint(len(names))],
                        (int(rng.randint(1, 4)), 4)))
        elif kind == "evict_name":
            ops.append((kind, names[rng.randint(len(names))]))
        else:
            ops.append((kind, int(rng.randint(0, 1 << (cap + 1)))))
    return cap, ops


def _run_script(impl, cap, ops, device=-1, dim0_scale=1):
    """Runs ``ops`` on a fresh cache of package ``impl``; returns what
    was observed after every op. ``device`` and ``dim0_scale`` change
    the rank-local part of the signatures only."""
    coord, msg = IMPLS[impl]
    cache = coord.ResponseCache(cap)
    seen = []
    for op in ops:
        kind, arg = op[0], op[1]
        out = None
        if kind in ("put", "lookup", "lookup_dtype"):
            shape = (op[2][0] * dim0_scale,) + tuple(op[2][1:])
            req = _req(msg, arg, shape=shape, device=device,
                       dtype="FLOAT64" if kind == "lookup_dtype"
                       else "FLOAT32")
            if kind == "put":
                cache.put(arg, coord.ResponseCache.signature(req),
                          _resp(msg, arg), req.tensor_type, 4)
            else:
                state, slot = cache.lookup(req)
                out = (int(state), slot)
        elif kind == "touch":
            # A broadcast mask names existing slots only.
            cache.touch_mask(arg & ((1 << cache.nslots) - 1))
        elif kind == "evict":
            cache.evict_slots(arg & ((1 << cache.nslots) - 1))
        else:
            cache.evict_name(arg)
        seen.append((out, cache.epoch, len(cache), cache.nslots,
                     cache.hits, cache.misses, cache.evictions,
                     cache.state_fingerprint(),
                     cache.slot_mask(msg.ResponseType.ALLREDUCE)))
    return seen


@pytest.mark.parametrize("case", list(SCRIPTS) + [f"seed{s}"
                                                  for s in range(6)])
def test_cache_sequences_match_the_reference(case):
    cap, ops = SCRIPTS[case] if case in SCRIPTS else \
        _seeded_script(int(case[4:]))
    got = _run_script("port", cap, ops)
    assert got == _run_script("ref", cap, ops)
    if case == "touch_does_not_bump_epoch":
        assert got[0][1] == got[-1][1]
    if case == "evict_slots_ascending":
        assert got[9][0] == (int(port_coord.ResponseCache.HIT), 0)


@pytest.mark.parametrize("seed", range(3))
def test_two_ranks_march_in_lockstep(seed):
    """Caches of two ranks, their signatures rank-local (device, dim 0),
    fed the same world events: the coherent state stays equal after
    every op, and equal to the reference's."""
    cap, ops = _seeded_script(100 + seed)
    ops = [op for op in ops if op[0] != "lookup"]
    r0 = _run_script("port", cap, ops, device=0, dim0_scale=1)
    r1 = _run_script("port", cap, ops, device=1, dim0_scale=3)
    assert [o[7] for o in r0] == [o[7] for o in r1]
    assert [o[7] for o in r0] == [o[7] for o in _run_script(
        "ref", cap, ops, device=1, dim0_scale=3)]


def test_capacity_must_be_positive():
    for coord, _ in IMPLS.values():
        with pytest.raises(ValueError):
            coord.ResponseCache(0)


# -- the frames --------------------------------------------------------------
SPEC_DTYPES = ["FLOAT32", "FLOAT64", "FLOAT16", "BFLOAT16", "INT32",
               "UINT8"]


def _segments(rng, n):
    """(ref segments, port segments): the same bytes as numpy arrays
    (ml_dtypes for bfloat16) and as torch tensors."""
    import ml_dtypes
    ref, port = [], []
    for _ in range(n):
        name = SPEC_DTYPES[rng.randint(len(SPEC_DTYPES))]
        numel = int(rng.randint(0, 40))
        t_dt = port_msg.datatype_to_torch_dtype(port_msg.DataType[name])
        raw = rng.randint(0, 256, numel * t_dt.itemsize).astype(np.uint8)
        np_dt = ml_dtypes.bfloat16 if name == "BFLOAT16" else \
            np.dtype(str(t_dt)[6:])
        ref.append((ref_msg.DataType[name], raw.view(np_dt)))
        port.append((port_msg.DataType[name],
                     torch.frombuffer(bytearray(raw.tobytes()), dtype=t_dt)
                     if numel else torch.empty(0, dtype=t_dt)))
    return ref, port


def _frame_contents(seed):
    """{package: (request frames' objects, response frames' objects)}
    with the same contents, from a seed."""
    rng = np.random.RandomState(seed)
    nslots = int(rng.randint(0, 70))
    mask = (lambda: int(rng.randint(0, 1 << min(nslots, 62)))
            if nslots else 0)
    epoch = int(rng.randint(0, 1 << 40))
    fields = dict(epoch=epoch, nslots=nslots)
    hit, inv, grant = mask(), mask(), mask()
    shutdown = bool(rng.rand() < 0.5)
    n_req = int(rng.randint(0, 4))
    req_fields = [dict(name=f"r{i}", rank=int(rng.randint(4)),
                       shape=tuple(int(d) for d in
                                   rng.randint(1, 9, rng.randint(0, 4))),
                       dtype="BFLOAT16" if rng.rand() < 0.5 else "INT64",
                       device=int(rng.randint(-1, 2)),
                       pre=float(rng.choice([1.0, 0.5])))
                  for i in range(n_req)]
    ref_seg, port_seg = _segments(rng, int(rng.randint(0, 4)))
    out = {}
    for impl, (_, msg) in IMPLS.items():
        reqs = [_req(msg, **f) for f in req_fields]
        resps = msg.ResponseList(
            [_resp(msg, f"n{i}", 3 + i) for i in range(n_req)],
            shutdown=shutdown, tuned_fusion_threshold_bytes=1 << 26)
        seg = ref_seg if impl == "ref" else port_seg
        requests = [
            msg.RequestList(reqs, shutdown=shutdown),
            msg.CacheCycleRequest(hit_mask=hit, invalid_mask=inv,
                                  requests=reqs, shutdown=shutdown,
                                  **fields),
            msg.CacheCycleRequest(hit_mask=hit, spec_payload=seg, **fields),
        ]
        responses = [
            resps,
            msg.CacheCycleResponse(grant_mask=grant, invalid_mask=inv,
                                   response_list=resps, **fields),
            msg.CacheCycleResponse(grant_mask=grant, spec_payload=seg,
                                   **fields),
        ]
        out[impl] = (requests, responses)
    return out


def _norm(obj):
    """A package-neutral view of a cycle message."""
    def raw(buf):
        if isinstance(buf, torch.Tensor):
            return buf.numpy().tobytes() if buf.dtype != torch.bfloat16 \
                else buf.view(torch.int16).numpy().tobytes()
        return bytes(memoryview(buf).cast("B")) if len(
            memoryview(buf).cast("B")) else b""

    def req(r):
        return (int(r.request_type), r.request_rank, int(r.tensor_type),
                r.tensor_name, r.root_rank, r.device, tuple(r.tensor_shape),
                r.prescale_factor, r.postscale_factor, r.wire_dtype)

    def resp(r):
        return (int(r.response_type), list(r.tensor_names),
                r.error_message, list(r.devices), list(r.tensor_sizes),
                r.prescale_factor, r.postscale_factor, r.wire_dtype,
                r.algorithm)

    def rlist(rl):
        return (rl.shutdown, rl.tuned_cycle_time_ms,
                rl.tuned_fusion_threshold_bytes, rl.tuned_overlap_buckets,
                [resp(r) for r in rl.responses])

    kind = type(obj).__name__
    if kind == "RequestList":
        return kind, obj.shutdown, [req(r) for r in obj.requests]
    if kind == "ResponseList":
        return kind, rlist(obj)
    seg = None if obj.spec_payload is None else \
        [(int(d), raw(b)) for d, b in obj.spec_payload]
    if kind == "CacheCycleRequest":
        return (kind, obj.epoch, obj.nslots, obj.hit_mask, obj.invalid_mask,
                [req(r) for r in obj.requests], obj.shutdown, seg)
    return (kind, obj.epoch, obj.nslots, obj.grant_mask, obj.invalid_mask,
            rlist(obj.response_list), seg)


FRAME_KINDS = [("request", 0), ("request", 1), ("request", 2),
               ("response", 0), ("response", 1), ("response", 2)]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("side,kind", FRAME_KINDS)
def test_cycle_frames_are_the_references_bytes(side, kind, seed):
    """FULL, CACHED and CACHED_SPEC frames, request and response: equal
    bytes from equal contents, and each package parses the other's."""
    contents = _frame_contents(seed)
    i = 0 if side == "request" else 1
    ref_obj, port_obj = contents["ref"][i][kind], contents["port"][i][kind]
    ser = f"serialize_cycle_{side}"
    parse = f"parse_cycle_{side}"
    ref_bytes = getattr(ref_wire, ser)(ref_obj)
    port_bytes = getattr(port_wire, ser)(port_obj)
    assert port_bytes == ref_bytes
    assert port_bytes[0] == (0, 1, 3)[kind]
    assert _norm(getattr(port_wire, parse)(ref_bytes)) == _norm(ref_obj)
    assert _norm(getattr(ref_wire, parse)(port_bytes)) == _norm(port_obj)
    assert _norm(getattr(port_wire, parse)(port_bytes)) == _norm(port_obj)
    # A frame cut at any byte is refused as a transport error.
    for cut in range(len(port_bytes)):
        with pytest.raises(ConnectionError):
            getattr(port_wire, parse)(port_bytes[:cut])


def test_aggregate_frame_and_spec_frame_parts_match():
    contents = _frame_contents(7)
    ref_cf, port_cf = contents["ref"][0][1], contents["port"][0][1]
    agg = port_wire.serialize_cycle_request(port_cf, aggregate=True)
    assert agg == ref_wire.serialize_cycle_request(ref_cf, aggregate=True)
    assert agg[0] == port_wire.FRAME_CACHED_AGG
    assert _norm(port_wire.parse_cycle_request(agg)) == _norm(port_cf)
    meta = [(port_msg.DataType.FLOAT32, 12), (port_msg.DataType.INT64, 0)]
    for world_id in (0, 5):
        assert port_wire.spec_frame_parts(3, 19, 0b101, meta, world_id) == \
            ref_wire.spec_frame_parts(3, 19, 0b101, meta, world_id)


@pytest.mark.parametrize("case", ["fold", "nested", "spec", "full",
                                  "epoch", "world"])
def test_combine_cycle_requests_matches_the_reference(case):
    """The fold of several ranks' frames (AND of hits, OR of invalids and
    shutdown, requests concatenated), the same bytes in both packages;
    speculative, FULL, diverged-epoch and mixed-world frames refused
    (None) by both."""
    frames = {}
    for impl, (_, msg) in IMPLS.items():
        wire = ref_wire if impl == "ref" else port_wire

        def cached(epoch, hit, inv, reqs=(), shutdown=False):
            return wire.serialize_cycle_request(msg.CacheCycleRequest(
                epoch=epoch, nslots=8, hit_mask=hit, invalid_mask=inv,
                requests=[_req(msg, n, rank=r) for n, r in reqs],
                shutdown=shutdown))

        a = cached(5, 0b0111, 0b1000, [("x", 1)])
        b = cached(5, 0b1101, 0b0010, [("y", 2)], shutdown=True)
        c = cached(5, 0b1011, 0)
        spec = wire.serialize_cycle_request(msg.CacheCycleRequest(
            epoch=5, nslots=8, hit_mask=1, spec_payload=[
                (msg.DataType.FLOAT64, np.ones(2))]))
        full = wire.serialize_cycle_request(msg.RequestList([]))
        frames[impl] = {
            "fold": [a, b], "spec": [spec, a], "full": [a, full],
            "epoch": [a, cached(6, 1, 0)],
            "world": [wire.stamp_world(a, 3), wire.stamp_world(b, 4)],
            "nested": [None, c]}
        frames[impl]["nested"][0] = wire.combine_cycle_requests([a, b])
    ref_out = ref_wire.combine_cycle_requests(frames["ref"][case])
    port_out = port_wire.combine_cycle_requests(frames["port"][case])
    assert port_out == ref_out
    if case in ("fold", "nested"):
        assert port_out[0] == port_wire.FRAME_CACHED_AGG
        out = port_wire.parse_cycle_request(port_out)
        assert out.hit_mask == (0b0101 if case == "fold" else 0b0001)
        assert out.invalid_mask == 0b1010
        assert out.shutdown is True
    else:
        assert port_out is None


# -- the runtime's helpers ---------------------------------------------------
@pytest.mark.parametrize("case", ["allreduce", "allgather", "sizeless"])
def test_unfuse_matches_the_reference(case):
    got = {}
    for impl, (_, msg) in IMPLS.items():
        rt = port_runtime.Runtime if impl == "port" else ref_runtime.Runtime
        if case == "allreduce":
            fused = msg.Response(response_type=msg.ResponseType.ALLREDUCE,
                                 tensor_names=["a", "b"], devices=[-1, -1],
                                 tensor_sizes=[10, 20], prescale_factor=0.5)
            got[impl] = [rt._unfuse(fused, i, 2) for i in range(2)]
        elif case == "allgather":
            fused = msg.Response(response_type=msg.ResponseType.ALLGATHER,
                                 tensor_names=["g1", "g2"],
                                 devices=[-1, -1, -1],
                                 tensor_sizes=[3, 4, 5, 1, 1, 1])
            got[impl] = [rt._unfuse(fused, i, 3) for i in range(2)]
        else:
            bc = msg.Response(response_type=msg.ResponseType.BROADCAST,
                              tensor_names=["w"], devices=[-1, -1])
            got[impl] = [rt._unfuse(bc, 0, 2)]
    assert [_norm(msg.ResponseList(r)) for msg, r in
            ((port_msg, got["port"]),)] == \
        [_norm(msg.ResponseList(r)) for msg, r in ((ref_msg, got["ref"]),)]


@pytest.mark.parametrize("threshold", [1 << 20, 96, 40])
def test_replay_plans_match_the_reference(threshold):
    """The same puts in both caches, then each runtime's replay plan of
    the same grant masks: equal fused batches (ascending slots, fused
    under the threshold), and replay leaves the cached entries intact."""
    rng = np.random.RandomState(threshold)
    shells = {}
    for impl, (coord, msg) in IMPLS.items():
        rt_cls = port_runtime.Runtime if impl == "port" else \
            ref_runtime.Runtime
        rt = rt_cls.__new__(rt_cls)
        rt._cache = coord.ResponseCache(16)
        rt._replay_plans = {}
        rt._replay_epoch = -1
        shells[impl] = (rt, msg, coord)
    puts = [(f"p{i}", int(n), ["FLOAT32", "FLOAT64"][i % 2])
            for i, n in enumerate(rng.randint(1, 12, 10))]
    for rt, msg, coord in shells.values():
        for name, n, dtype in puts:
            req = _req(msg, name, shape=(n,), dtype=dtype)
            rt._cache.put(name, coord.ResponseCache.signature(req),
                          _resp(msg, name, n), req.tensor_type, 1)
    for mask in (0b1111111111, 0b1010110001, int(rng.randint(1, 1024))):
        plans = {impl: _norm(msg.ResponseList(
            rt._replay_grants(mask, threshold)))
            for impl, (rt, msg, _) in shells.items()}
        assert plans["port"] == plans["ref"]
    port_rt = shells["port"][0]
    assert port_rt._cache.entry(0).response.tensor_names == ["p0"]
    assert port_rt._cache.state_fingerprint() == \
        shells["ref"][0]._cache.state_fingerprint()


@pytest.mark.parametrize("dtype", ["float32", "float64", "float16",
                                   "int32"])
def test_reduce_spec_is_the_references_bit_for_bit(dtype):
    """The coordinator's inline sum of three ranks' segments, in
    ascending rank order in the dtype: the same bits as the
    reference's."""
    rng = np.random.RandomState(1)
    floating = dtype != "int32"
    arrays = [[(rng.randn(n) * 10.0 ** rng.uniform(-3, 3, n)
                if floating else rng.randint(-2 ** 20, 2 ** 20, n))
               .astype(dtype) for n in (300, 7)] for _ in range(3)]
    got = {}
    for impl, (_, msg) in IMPLS.items():
        rt = port_runtime.Runtime if impl == "port" else ref_runtime.Runtime
        dt = msg.numpy_dtype_to_datatype(np.dtype(dtype))
        frames = [msg.CacheCycleRequest(
            epoch=0, nslots=2, hit_mask=0b11,
            spec_payload=[(dt, memoryview(a.copy())) for a in rank])
            for rank in arrays]
        got[impl] = [(int(d), np.asarray(b).tobytes())
                     for d, b in rt._reduce_spec(frames)]
    assert got["port"] == got["ref"]
    want = arrays[0][0].copy()
    want += arrays[1][0]
    want += arrays[2][0]
    assert got["port"][0][1] == want.tobytes()


@pytest.mark.parametrize("case", ["length", "dtype", "segments"])
def test_reduce_spec_refuses_diverged_layouts(case):
    dt = port_msg.DataType
    a = [(dt.FLOAT64, memoryview(np.ones(4)))]
    b = {"length": [(dt.FLOAT64, memoryview(np.ones(5)))],
         "dtype": [(dt.INT64, memoryview(np.ones(4, np.int64)))],
         "segments": a + a}[case]
    frames = [port_msg.CacheCycleRequest(epoch=0, nslots=1, hit_mask=1,
                                         spec_payload=p) for p in (a, b)]
    with pytest.raises(ConnectionError):
        port_runtime.Runtime._reduce_spec(frames)


def _shell(cache_on: bool):
    rt = port_runtime.Runtime.__new__(port_runtime.Runtime)
    rt._cache = port_coord.ResponseCache(8) if cache_on else None
    return rt


@pytest.mark.parametrize("coordinator_cache", [True, False])
def test_a_rank_with_another_cache_setting_is_refused(coordinator_cache):
    """A coordinator with the cache on refuses a FULL frame, one with it
    off refuses a CACHED frame; a worker refuses a verdict of the other
    kind or of another epoch: ConnectionError, never a silent full
    path."""
    peer = port_msg.RequestList([]) if coordinator_cache else \
        port_msg.CacheCycleRequest(epoch=0, nslots=0)
    with pytest.raises(ConnectionError, match="HOROVOD_CACHE"):
        _shell(coordinator_cache)._coordinate_cycle(
            [port_wire.serialize_cycle_request(peer)])
    worker = _shell(not coordinator_cache)
    if coordinator_cache:
        with pytest.raises(ConnectionError, match="diverged"):
            worker._apply_cached_cycle(
                port_msg.CacheCycleResponse(epoch=0, nslots=0), [])
    else:
        worker._cache.put("x", (), port_msg.Response(), 7, 1)
        with pytest.raises(ConnectionError, match="diverged"):
            worker._apply_cached_cycle(
                port_msg.CacheCycleResponse(epoch=0, nslots=0), [])


@pytest.mark.parametrize("env,want", [
    ({}, (True, 1024, True)),
    ({"HOROVOD_CACHE_ENABLED": "0", "HOROVOD_CACHE_CAPACITY": "77",
      "HOROVOD_CACHE_SPECULATIVE": "0"}, (False, 77, False)),
    ({"HOROVOD_CACHE_CAPACITY": "0"}, (True, 0, True)),
])
def test_config_knobs_match_the_reference(monkeypatch, env, want):
    from horovod_tpu.common.config import Config as RefConfig
    from horovod_tpu_torch.common.config import Config
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for cfg in (Config.from_env(), RefConfig.from_env()):
        assert (cfg.cache_enabled, cfg.cache_capacity,
                cfg.cache_speculative) == want
