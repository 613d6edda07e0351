"""The port's negotiation (``horovod_tpu_torch.common.coordinator`` and
``wire``) against the JAX package's, on the same request sequences.

Sequences come from a numpy seed: tensor names, collective kinds,
dtypes, shapes, broadcast roots, scale factors, placements, the order in
which each rank submits and the cycle each request arrives in, and the
mismatch cases (another op, dtype, shape, rank of the tensor, root or
placement on one rank; a dim 0 that does not divide by the world size).
Both coordinators run the reference runtime's cycle
(``horovod_tpu/common/runtime.py:2808`` ``_coordinate``) over them; the
Responses must be equal field by field, cycle by cycle, and the request
and response frames byte-identical and parsed alike by both ``wire``
modules.
"""

import numpy as np
import pytest

from horovod_tpu.common import coordinator as ref_coord
from horovod_tpu.common import message as ref_msg
from horovod_tpu.common import wire as ref_wire
from horovod_tpu_torch.common import coordinator as port_coord
from horovod_tpu_torch.common import message as port_msg
from horovod_tpu_torch.common import wire as port_wire

IMPLS = {"ref": (ref_coord, ref_msg, ref_wire),
         "port": (port_coord, port_msg, port_wire)}
KINDS = ["ALLREDUCE"] * 4 + ["ALLGATHER"] * 2 + [
    "BROADCAST", "ALLTOALL", "REDUCESCATTER", "BARRIER"]
DTYPES = ["FLOAT32"] * 4 + ["BFLOAT16", "FLOAT16", "FLOAT64", "INT32",
                           "INT64", "UINT8"]
MISMATCHES = ["op", "dtype", "shape", "ndim", "root", "device",
              "divisible"]


def _spec(seed: int, size: int):
    """Per-rank request fields and arrival cycles for one world."""
    rng = np.random.RandomState(seed)
    per_rank = [[] for _ in range(size)]
    for i in range(rng.randint(12, 40)):
        kind = KINDS[rng.randint(len(KINDS))]
        dtype = DTYPES[rng.randint(len(DTYPES))]
        shape = [int(d) for d in rng.randint(1, 5, rng.randint(1, 4))]
        if kind in ("ALLTOALL", "REDUCESCATTER"):
            shape[0] *= size
        if kind == "BARRIER":
            shape, dtype = [], "UINT8"
        scales = (1.0, 0.5, 2.0, 1.0 / 3)
        pre = post = 1.0
        if kind == "ALLREDUCE" and rng.rand() < 0.3:
            pre = scales[rng.randint(4)]
            post = scales[rng.randint(4)]
        base = dict(kind=kind, dtype=dtype, shape=shape, pre=pre, post=post,
                    root=int(rng.randint(size)) if kind == "BROADCAST"
                    else -1, device=int(rng.rand() < 0.8) - 1)
        victim = rng.randint(size)
        mismatch = MISMATCHES[rng.randint(len(MISMATCHES))] \
            if rng.rand() < 0.25 else None
        for r in range(size):
            f = dict(base, name=f"t{i}", shape=list(base["shape"]))
            if kind == "ALLGATHER":  # dim 0 may differ per rank
                f["shape"][0] = int(rng.randint(0, 5))
            if r == victim and mismatch == "op":
                f["kind"] = "BROADCAST" if kind != "BROADCAST" \
                    else "ALLREDUCE"
                f["root"] = 0
            elif r == victim and mismatch == "dtype":
                f["dtype"] = "FLOAT64" if f["dtype"] != "FLOAT64" \
                    else "INT32"
            elif r == victim and mismatch == "shape" and f["shape"]:
                f["shape"][-1] += 1
            elif r == victim and mismatch == "ndim":
                f["shape"] = f["shape"] + [2]
            elif r == victim and mismatch == "root" and kind == "BROADCAST":
                f["root"] = (f["root"] + 1) % size
            elif r == victim and mismatch == "device":
                f["device"] = -1 - f["device"]
            elif mismatch == "divisible" and kind in ("ALLTOALL",
                                                      "REDUCESCATTER"):
                f["shape"][0] += 1
            per_rank[r].append(f)
    # Each rank submits in its own order, spread over three cycles.
    arrivals = []
    for r in range(size):
        order = rng.permutation(len(per_rank[r]))
        cycles = np.sort(rng.randint(0, 3, len(order)))
        arrivals.append([(int(c), per_rank[r][k])
                         for c, k in zip(cycles, order)])
    threshold = int(rng.choice([64, 4096, 64 << 20]))
    return arrivals, threshold


def _request(msg, rank: int, f):
    return msg.Request(request_rank=rank,
                       request_type=msg.RequestType[f["kind"]],
                       tensor_type=msg.DataType[f["dtype"]],
                       tensor_name=f["name"], root_rank=f["root"],
                       device=f["device"], tensor_shape=f["shape"],
                       prescale_factor=f["pre"], postscale_factor=f["post"])


def _fields(resp):
    return (int(resp.response_type), list(resp.tensor_names),
            resp.error_message, list(resp.devices), list(resp.tensor_sizes),
            resp.prescale_factor, resp.postscale_factor, resp.wire_dtype,
            resp.algorithm)


def _negotiate(impl: str, arrivals, threshold, size):
    """The reference runtime's ``_coordinate`` cycle by cycle. Returns,
    per cycle, the request frames of every rank and the fused
    ResponseList."""
    coord, msg, wire = IMPLS[impl]
    table = coord.MessageTable()
    dtypes, slice_numels = {}, {}
    out = []
    for cycle in range(3):
        lists = [msg.RequestList([_request(msg, r, f) for c, f in
                                  arrivals[r] if c == cycle])
                 for r in range(size)]
        frames = [wire.serialize_cycle_request(rl) for rl in lists]
        for rl in (wire.parse_cycle_request(fr) for fr in frames):
            for req in rl.requests:
                dtypes[req.tensor_name] = req.tensor_type
                slice_numels[req.tensor_name] = int(
                    np.prod(req.tensor_shape[1:], dtype=np.int64))
                table.increment_tensor_count(req, size)
        responses = [coord.construct_response(table, name, size)
                     for name in table.pop_ready()]
        fused = coord.fuse_responses(responses, dtypes, threshold,
                                     slice_numels)
        for resp in fused:
            for n in resp.tensor_names:
                dtypes.pop(n, None)
                slice_numels.pop(n, None)
        out.append((frames, msg.ResponseList(fused, shutdown=cycle == 2)))
    return out


@pytest.mark.parametrize("size", [2, 3, 4])
@pytest.mark.parametrize("seed", range(6))
def test_seeded_sequences_negotiate_alike(seed, size):
    arrivals, threshold = _spec(1000 * size + seed, size)
    ref = _negotiate("ref", arrivals, threshold, size)
    port = _negotiate("port", arrivals, threshold, size)
    n_responses = 0
    for cycle, ((ref_frames, ref_rl), (port_frames, port_rl)) in \
            enumerate(zip(ref, port)):
        assert port_frames == ref_frames, cycle
        assert [_fields(r) for r in port_rl.responses] == \
            [_fields(r) for r in ref_rl.responses], cycle
        ref_bytes = ref_wire.serialize_cycle_response(ref_rl)
        port_bytes = port_wire.serialize_cycle_response(port_rl)
        assert port_bytes == ref_bytes, cycle
        # Each side parses the other's frames.
        assert port_wire.parse_cycle_response(ref_bytes) == port_rl
        assert ref_wire.parse_cycle_response(port_bytes) == ref_rl
        for fr in ref_frames:
            assert port_wire.serialize_cycle_request(
                port_wire.parse_cycle_request(fr)) == fr
            assert ref_wire.serialize_cycle_request(
                ref_wire.parse_cycle_request(fr)) == fr
        n_responses += len(port_rl.responses)
    assert n_responses > 0


@pytest.mark.parametrize("mismatch", MISMATCHES)
def test_each_mismatch_gives_the_same_error(mismatch):
    """One tensor, one rank off in one way: the same ERROR Response
    (same message) from both coordinators."""
    kind = {"root": "BROADCAST", "divisible": "REDUCESCATTER"}.get(
        mismatch, "ALLREDUCE")
    base = dict(name="x", kind=kind, dtype="FLOAT32", shape=[4, 3],
                pre=1.0, post=1.0, root=0 if kind == "BROADCAST" else -1,
                device=0)
    odd = dict(base, shape=list(base["shape"]))
    if mismatch == "op":
        odd.update(kind="ALLGATHER")
    elif mismatch == "dtype":
        odd.update(dtype="BFLOAT16")
    elif mismatch == "shape":
        odd["shape"][1] = 5
    elif mismatch == "ndim":
        odd.update(kind="ALLGATHER", shape=[4])
        base.update(kind="ALLGATHER")
    elif mismatch == "root":
        odd.update(root=1)
    elif mismatch == "device":
        odd.update(device=-1)
    else:
        base["shape"] = odd["shape"] = [5, 3]
    got = {}
    for impl, (coord, msg, _) in IMPLS.items():
        table = coord.MessageTable()
        for r, f in enumerate([base, odd]):
            table.increment_tensor_count(_request(msg, r, f), 2)
        (name,) = table.pop_ready()
        got[impl] = _fields(coord.construct_response(table, name, 2))
    assert got["port"] == got["ref"]
    assert got["port"][0] == int(port_msg.ResponseType.ERROR)
    assert got["port"][2]


def test_reducescatter_carries_its_scale_factors():
    """The one departure: the port's REDUCESCATTER Response carries the
    requests' factors (an averaged reducescatter divides by the world
    size); the reference's leaves them at 1.0."""
    f = dict(name="rs", kind="REDUCESCATTER", dtype="FLOAT32", shape=[4],
             pre=1.0, post=0.5, root=-1, device=-1)
    got = {}
    for impl, (coord, msg, _) in IMPLS.items():
        table = coord.MessageTable()
        for r in range(2):
            table.increment_tensor_count(_request(msg, r, f), 2)
        got[impl] = coord.construct_response(table, "rs", 2)
    assert got["port"].postscale_factor == 0.5
    assert got["ref"].postscale_factor == 1.0
    assert _fields(got["port"])[:5] == _fields(got["ref"])[:5]


@pytest.mark.parametrize("world_id", [0, 7, 0xDEADBEEF])
def test_world_envelope_matches(world_id):
    frame = port_wire.serialize_cycle_request(port_msg.RequestList(
        [_request(port_msg, 1, dict(name="a", kind="ALLREDUCE",
                                    dtype="BFLOAT16", shape=[3], pre=1.0,
                                    post=1.0, root=-1, device=0))]))
    stamped = port_wire.stamp_world(frame, world_id)
    assert stamped == ref_wire.stamp_world(frame, world_id)
    assert port_wire.unstamp_world(stamped, world_id) == frame
    assert ref_wire.unstamp_world(stamped, world_id) == frame
    with pytest.raises(ConnectionError):
        port_wire.unstamp_world(stamped, world_id + 1)


def test_truncated_and_foreign_frames_are_refused():
    frame = port_wire.serialize_cycle_response(port_msg.ResponseList(
        [port_msg.Response(tensor_names=["a", "b"], tensor_sizes=[3, 4],
                           devices=[0, 0])]))
    for cut in (1, 10, len(frame) - 1):
        with pytest.raises(ConnectionError):
            port_wire.parse_cycle_response(frame[:cut])
    with pytest.raises(ConnectionError, match="HOROVOD_CACHE_CAPACITY=0"):
        port_wire.parse_cycle_response(b"\x01" + frame[1:])


def test_torch_and_numpy_dtype_maps_agree():
    import ml_dtypes
    import torch
    pairs = [(torch.uint8, np.uint8), (torch.int8, np.int8),
             (torch.uint16, np.uint16), (torch.int16, np.int16),
             (torch.int32, np.int32), (torch.int64, np.int64),
             (torch.float16, np.float16), (torch.float32, np.float32),
             (torch.float64, np.float64), (torch.bool, np.bool_),
             (torch.bfloat16, ml_dtypes.bfloat16)]
    for t, n in pairs:
        dt = port_msg.torch_dtype_to_datatype(t)
        assert int(dt) == int(ref_msg.numpy_dtype_to_datatype(n))
        assert dt == port_msg.numpy_dtype_to_datatype(n)
        assert port_msg.datatype_size(dt) == t.itemsize
    with pytest.raises(ValueError):
        port_msg.torch_dtype_to_datatype(torch.complex64)


def test_stall_inspector_warns_as_the_reference(capfd, monkeypatch):
    """A tensor some ranks never submit: both inspectors warn with the
    same text, once, and ask for a shutdown past the second threshold."""
    import time
    monkeypatch.setenv("HOROVOD_LOG_HIDE_TIME", "1")
    lines = {}
    for impl, (coord, msg, _) in IMPLS.items():
        stall = coord.StallInspector(3, warning_time=0.01,
                                     shutdown_time=0.05)
        table = coord.MessageTable(on_remove=stall.tensor_completed)
        table.increment_tensor_count(_request(msg, 1, dict(
            name="late", kind="ALLREDUCE", dtype="FLOAT32", shape=[2],
            pre=1.0, post=1.0, root=-1, device=-1)), 3)
        time.sleep(0.02)
        assert stall.should_check()
        assert not stall.check(table)
        time.sleep(0.05)
        assert stall.check(table)  # warned before: now past shutdown
        lines[impl] = [ln for ln in capfd.readouterr().err.splitlines()
                       if "late" in ln]
    assert len(lines["port"]) == len(lines["ref"]) == 1
    assert lines["port"] == lines["ref"]
    assert "waiting on ranks: [0, 2]" in lines["port"][0]
