"""The port's wire-dtype compression against the JAX package's.

Bit for bit unless a test says otherwise; the same numpy inputs, made
from a seed, go through the reference's pure-Python functions and the
port's torch ones.

- The shared dtype table and the framework-level casts' pass-through
  while a wire dtype is active (``TestSharedDtypeTable``).
- The codec (``TestCodec``): the knob names, the verdict's resolution,
  the bf16 and fp16 casts and their inverses (ties, subnormals,
  overflow, float64 inputs), int8's scale and lanes, error feedback over
  a chain of steps and its LRU cap, and the coordinator's reduction in
  the wire dtype.
- Negotiation (``TestNegotiation``): the coordinator's verdicts (the
  least aggressive proposal, compressible dtypes only, int8 allgathers
  as bf16), fusion that never joins two verdicts, the response cache's
  signature, and the serialized Request and Response bytes; and seeded
  request streams negotiated by both coordinators into the same bytes.
- Spawned worlds, all started at once by one module fixture (this file
  run as a script is a rank): bf16 on 3 ranks, int8 on 2, and a 2-rank
  world where only rank 1 proposes bf16. Every output equals the
  reference codec's closed form on the same inputs: allreduce (sum,
  average, scaled, fused, float64, and 12 steps under one name that run
  the speculative cycle where the wire is a cast and build an
  error-feedback chain at int8, whose residuals equal the reference's),
  allgather, reducescatter, and the uncompressed broadcast and 16-bit
  and integer allreduces; the mixed world's outputs are exactly the
  uncompressed ones.
"""

import os
import pathlib
import sys
import traceback

import numpy as np
import pytest
import torch

STEADY = 12


def _bits(t):
    """A tensor or array as its bytes, for bit-for-bit comparison."""
    if isinstance(t, torch.Tensor):
        if not t.numel():
            return b""
        t = t.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(t).reshape(-1).view(np.uint8).tobytes()


def _tdt(np_dtype):
    return {np.dtype(np.float32): torch.float32,
            np.dtype(np.float64): torch.float64}[np.dtype(np_dtype)]


# -- the shared dtype table ------------------------------------------------
class TestSharedDtypeTable:
    def test_the_float_table_agrees_with_the_reference(self, worlds):
        from horovod_tpu.common import wire_dtype as ref
        from horovod_tpu_torch.common import wire_dtype as wd
        for dt in (torch.float16, torch.float32, torch.float64,
                   torch.bfloat16, torch.int8, torch.int32, torch.uint8,
                   torch.bool, torch.float8_e4m3fn, torch.float8_e5m2):
            name = str(dt).split(".")[1]
            assert wd.is_floating(dt) == ref.is_floating_name(name), dt

    def test_framework_cast_is_a_pass_through_while_wire_active(self):
        from horovod_tpu_torch.common import wire_dtype as wd
        from horovod_tpu_torch.common.compression import Compression
        x = torch.ones(8)
        wd.set_active(wd.WIRE_BF16)
        try:
            assert wd.active() == wd.WIRE_BF16
            for c in (Compression.bf16, Compression.fp16):
                out, ctx = c.compress(x)
                assert out is x and ctx is None
                assert c.decompress(out, ctx) is x
        finally:
            wd.set_active(wd.WIRE_NONE)
        out, ctx = Compression.fp16.compress(x)
        assert out.dtype == torch.float16 and ctx == torch.float32
        i = torch.arange(4)
        assert Compression.bf16.compress(i) == (i, None)


# -- the codec -------------------------------------------------------------
def _cast_cases(dtype):
    rng = np.random.RandomState(3)
    dt = np.dtype(dtype)
    cases = {
        "randn": rng.randn(4099),
        "small": rng.randn(1000) * 1e-6,
        "subnormal": rng.randn(1000) * 1e-41,
        "special": np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf,
                             65504.0, 65520.0, 1e5, 3e38, -3e38, 1e-8]),
        "empty": np.zeros(0),
    }
    # float32 values exactly halfway between two bf16 (or fp16) values,
    # and float64 values a hair off such halves (double rounding)
    u = (rng.randint(0, 2 ** 16, 4000).astype(np.uint32) << 16) | 0x8000
    halves = u.view(np.float32)
    h = rng.randint(0, 2 ** 15, 4000).astype(np.uint16).view(np.float16)
    h = h[np.isfinite(h)]
    nxt = np.nextafter(h, np.float16(np.inf))
    mid16 = (h.astype(np.float64) + nxt.astype(np.float64)) / 2
    cases["bf16_halves"] = halves[np.isfinite(halves)].astype(np.float64)
    cases["fp16_halves"] = mid16[np.isfinite(mid16)]
    if dt == np.float64:
        cases["bf16_near_halves"] = cases["bf16_halves"] * (1 + 2.0 ** -40)
        cases["fp16_near_halves"] = cases["fp16_halves"] * (1 - 2.0 ** -40)
    with np.errstate(over="ignore"):
        return {k: v.astype(dt) for k, v in cases.items()}


CAST_CASES = [(w, dt, case) for w in (1, 2) for dt in (np.float32, np.float64)
              for case in _cast_cases(dt)]


class TestCodec:
    def test_knob_names_and_resolution(self):
        from horovod_tpu.common import wire_dtype as ref
        from horovod_tpu_torch.common import wire_dtype as wd
        for name in ("none", "bf16", "FP16", " int8 ", "NONE"):
            assert wd.wire_code_of(name) == ref.wire_code_of(name)
        for bad in ("bf17", "", "float16"):
            with pytest.raises(ValueError):
                ref.wire_code_of(bad)
            with pytest.raises(ValueError, match="HOROVOD_COMPRESSION"):
                wd.wire_code_of(bad)
        for codes in ([1, 0], [3, 1], [2, 2], [], [3, 3, 3], [3, 2, 1]):
            assert wd.resolve(codes) == ref.resolve(codes)
        for w in range(4):
            assert wd.ring_wire(w) == ref.ring_wire(w)
            assert wd.allgather_wire(w) == ref.allgather_wire(w)
            for count, size in ((0, 4), (1000, 4), (7, 8)):
                assert wd.compressed_nbytes(w, count, size) == \
                    ref.compressed_nbytes(w, count, size)
        assert (wd.WIRE_NAMES, wd.ALG_NAMES) == (ref.WIRE_NAMES,
                                                 ref.ALG_NAMES)
        assert wd.COMPRESSIBLE == {d.value for d in ref.COMPRESSIBLE}
        for w in (1, 2):
            assert wd.wire_datatype(w).value == ref.wire_datatype(w).value
        with pytest.raises(ValueError):
            wd.wire_datatype(wd.WIRE_INT8)

    def test_config_rejects_typo(self, monkeypatch):
        from horovod_tpu.common.config import Config as RefConfig
        from horovod_tpu_torch.common.config import Config
        monkeypatch.setenv("HOROVOD_COMPRESSION", "b16")
        for cfg in (RefConfig, Config):
            with pytest.raises(ValueError):
                cfg.from_env()
        monkeypatch.setenv("HOROVOD_COMPRESSION", "BF16")
        assert Config.from_env().compression == \
            RefConfig.from_env().compression == "bf16"

    @pytest.mark.parametrize("wire,dtype,case", CAST_CASES)
    def test_cast_bits(self, wire, dtype, case):
        from horovod_tpu.common import wire_dtype as ref
        from horovod_tpu_torch.common import wire_dtype as wd
        x = _cast_cases(dtype)[case]
        with np.errstate(over="ignore"):
            want = ref.compress(x, wire)
        got = wd.compress(torch.from_numpy(x), wire)
        assert got.dtype == wd.wire_torch_dtype(wire)
        assert _bits(got) == _bits(want)
        back = ref.decompress(want, wire, dtype, x.size)
        mine = wd.decompress(got, wire, _tdt(dtype), x.size)
        assert mine.dtype == _tdt(dtype) and _bits(mine) == _bits(back)
        # the received bytes (a memoryview of a frame) decode alike
        assert _bits(wd.decompress(memoryview(_bits(want)), wire,
                                   _tdt(dtype), x.size)) == _bits(back)

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    @pytest.mark.parametrize("case", ["randn", "constant", "zeros", "empty",
                                      "halves", "tiny", "one_big"])
    def test_int8_bits(self, dtype, case):
        from horovod_tpu.common import wire_dtype as ref
        from horovod_tpu_torch.common import wire_dtype as wd
        rng = np.random.RandomState(5)
        x = {"randn": rng.randn(5003) * 3,
             "constant": np.full(64, 7.5),
             "zeros": np.zeros(33),
             "empty": np.zeros(0),
             # lanes that land on .5 after the scaling: rint's ties
             "halves": np.arange(-254, 255) / 2.0,
             "tiny": rng.randn(100) * 1e-30,
             "one_big": np.r_[rng.randn(100), 1e4]}[case].astype(dtype)
        want = ref.quantize(x)
        got = wd.quantize(torch.from_numpy(x))
        assert got.dtype == torch.uint8 and _bits(got) == _bits(want)
        back = ref.dequantize(want, dtype, x.size)
        for buf in (got, memoryview(_bits(want))):
            mine = wd.dequantize(buf, _tdt(dtype), x.size)
            assert _bits(mine) == _bits(back)
        assert _bits(wd.compress(torch.from_numpy(x), wd.WIRE_INT8)) == \
            _bits(want)
        assert _bits(wd.decompress(got, wd.WIRE_INT8, _tdt(dtype),
                                   x.size)) == _bits(back)

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_error_feedback_chain_bits(self, dtype):
        """50 steps of compensate, quantize, keep the error: the payloads
        and the residuals equal the reference's at every step, and the
        accumulated stream tracks the true sum (DGC's property)."""
        from horovod_tpu.common import wire_dtype as ref
        from horovod_tpu_torch.common import wire_dtype as wd
        rng = np.random.RandomState(0)
        a = rng.randn(512).astype(dtype)
        ef_ref, ef = ref.ErrorFeedback(), wd.ErrorFeedback()
        acc = np.zeros_like(a)
        for step in range(50):
            x = a * dtype(1 + 0.01 * step)
            q_ref = ref.quantize_ef(x, ef_ref, ("k",))
            q = wd.quantize_ef(torch.from_numpy(x), ef, ("k",))
            assert _bits(q) == _bits(q_ref), step
            assert _bits(ef.residual(("k",))) == \
                _bits(ef_ref._residuals[("k",)]), step
            acc += ref.dequantize(q_ref, dtype, a.size)
        want = sum(a * dtype(1 + 0.01 * s) for s in range(50))
        assert np.abs(acc - want).max() <= 2 * np.abs(a).max() * 1.5 / 127
        ef.drop(("k",))
        assert ef.residual(("k",)) is None

    def test_error_feedback_lru_keeps_hot_keys_past_cap(self):
        from horovod_tpu.common import wire_dtype as ref
        from horovod_tpu_torch.common import wire_dtype as wd
        ef_ref, ef = ref.ErrorFeedback(), wd.ErrorFeedback()
        assert ef._CAP == ef_ref._CAP
        hot = np.full(16, 0.3, np.float32)
        for i in range(3 * ef._CAP):
            cold = np.full(16, float(i + 1), np.float32)
            for e, q, mk in ((ef_ref, ref.quantize, np.asarray),
                             (ef, wd.quantize, torch.from_numpy)):
                for key, x in ((("hot",), hot), ((f"cold{i}",), cold)):
                    comp = e.apply(key, mk(x))
                    e.update(key, comp, q(comp))
            assert list(ef._residuals) == list(ef_ref._residuals), i
            assert ("hot",) in ef._residuals
            assert len(ef._residuals) <= ef._CAP

    @pytest.mark.parametrize("wire", [1, 2, 3])
    @pytest.mark.parametrize("ranks", [2, 4])
    def test_reduce_wire_bits(self, wire, ranks):
        from horovod_tpu.common import wire_dtype as ref
        from horovod_tpu_torch.common import wire_dtype as wd
        rng = np.random.RandomState(wire * 10 + ranks)
        parts = [rng.randn(257).astype(np.float32) * (r + 1)
                 for r in range(ranks)]
        wires = [ref.compress(p, wire) for p in parts]
        mine = [wd.compress(torch.from_numpy(p), wire) for p in parts]
        own = np.array(wires[0], copy=True)
        want = ref.reduce_wire(own, wires[1:], wire, np.float32, 257)
        # peers as received: memoryviews of frames, or tensors
        peers = [memoryview(_bits(m)) if i % 2 else m
                 for i, m in enumerate(mine[1:])]
        got = wd.reduce_wire(mine[0].clone(), peers, wire, torch.float32,
                             257)
        assert _bits(got) == _bits(want)

    def test_static_policy_and_latch(self):
        from horovod_tpu.common import wire_dtype as ref
        from horovod_tpu_torch.common import wire_dtype as wd
        theirs = ref.StaticWirePolicy(False, 1 << 20, multi_host=False)
        for n in (0, 4096, 2 << 20, 1 << 30):
            assert wd.StaticWirePolicy().plan(n) == theirs.plan(n)
        assert wd.active() == wd.WIRE_NONE
        wd.set_active(wd.WIRE_INT8)
        assert wd.active() == wd.WIRE_INT8
        wd.set_active(wd.WIRE_NONE)


# -- negotiation -----------------------------------------------------------
def _impls():
    from horovod_tpu.common import coordinator as rc
    from horovod_tpu.common import message as rm
    from horovod_tpu.common import wire as rw
    from horovod_tpu_torch.common import coordinator as pc
    from horovod_tpu_torch.common import message as pm
    from horovod_tpu_torch.common import wire as pw
    return {"ref": (rc, rm, rw), "port": (pc, pm, pw)}


def _req(msg, rank, wire, name="t", dtype="FLOAT32", shape=(8,),
         kind="ALLREDUCE"):
    return msg.Request(request_rank=rank,
                       request_type=msg.RequestType[kind],
                       tensor_type=msg.DataType[dtype], tensor_name=name,
                       tensor_shape=shape, wire_dtype=wire)


VERDICTS = [  # (kind, dtype, proposals per rank)
    ("ALLREDUCE", "FLOAT32", (3, 1, 3)),
    ("ALLREDUCE", "FLOAT32", (1, 0, 1)),
    ("ALLREDUCE", "FLOAT64", (2, 2)),
    ("ALLREDUCE", "INT32", (1, 1)),
    ("ALLREDUCE", "BFLOAT16", (1, 1)),
    ("ALLGATHER", "FLOAT32", (3, 3)),
    ("ALLGATHER", "FLOAT32", (2, 3, 3)),
    ("ALLGATHER", "FLOAT16", (1, 1)),
    ("REDUCESCATTER", "FLOAT32", (3, 3)),
    ("REDUCESCATTER", "FLOAT64", (1, 0)),
    ("BROADCAST", "FLOAT32", (0, 0)),
    ("ALLTOALL", "FLOAT32", (0, 0)),
]


class TestNegotiation:
    @pytest.mark.parametrize("kind,dtype,proposals", VERDICTS)
    def test_verdicts_equal_the_reference(self, kind, dtype, proposals):
        size = len(proposals)
        out = {}
        for impl, (coord, msg, wire) in _impls().items():
            table = coord.MessageTable()
            for r, w in enumerate(proposals):
                table.increment_tensor_count(
                    _req(msg, r, w, dtype=dtype, kind=kind,
                         shape=(size * 2, 3)), size)
            resp = coord.construct_response(table, "t", size)
            out[impl] = (resp.wire_dtype, wire.serialize_response_list(
                msg.ResponseList([resp])))
        assert out["port"] == out["ref"]

    def test_wire_rides_request_and_response_bytes(self):
        frames = {}
        for impl, (_, msg, wire) in _impls().items():
            rl = msg.RequestList([_req(msg, 1, 3), _req(msg, 0, 1, "u")])
            resp = msg.Response(response_type=msg.ResponseType.ALLREDUCE,
                                tensor_names=["t"], tensor_sizes=[8],
                                wire_dtype=1, algorithm=3)
            frames[impl] = (wire.serialize_request_list(rl),
                            wire.serialize_response_list(
                                msg.ResponseList([resp])))
            back = wire.parse_response_list(frames[impl][1]).responses[0]
            assert (back.wire_dtype, back.algorithm) == (1, 3)
            assert wire.parse_request_list(frames[impl][0]) \
                .requests[0].wire_dtype == 3
        assert frames["port"] == frames["ref"]

    def test_cache_signature_includes_wire_dtype(self):
        states = {}
        for impl, (coord, msg, _) in _impls().items():
            cache = coord.ResponseCache(8)
            req = _req(msg, 0, 1)
            cache.put("t", coord.ResponseCache.signature(req),
                      msg.Response(response_type=msg.ResponseType.ALLREDUCE,
                                   tensor_names=["t"], tensor_sizes=[8]),
                      msg.DataType.FLOAT32, 1)
            states[impl] = [cache.lookup(_req(msg, 0, w))[0]
                            for w in (1, 0, 3, 1)]
        assert states["port"] == states["ref"]
        rc = _impls()["port"][0].ResponseCache
        assert states["port"] == [rc.HIT, rc.INVALID, rc.INVALID, rc.HIT]

    def test_fusion_keeps_mixed_verdicts_apart(self):
        fused = {}
        for impl, (coord, msg, _) in _impls().items():
            def resp(name, wire=0, alg=0):
                return msg.Response(
                    response_type=msg.ResponseType.ALLREDUCE,
                    tensor_names=[name], tensor_sizes=[8], devices=[0, 0],
                    wire_dtype=wire, algorithm=alg)
            dtypes = {n: msg.DataType.FLOAT32 for n in "abcde"}
            out = coord.fuse_responses(
                [resp("a", 1), resp("b", 0), resp("c", 1), resp("d", 0, 3),
                 resp("e", 3)], dtypes, 1 << 20, {n: 1 for n in "abcde"})
            fused[impl] = sorted((tuple(f.tensor_names), f.wire_dtype)
                                 for f in out)
        assert fused["port"] == fused["ref"]
        assert (("a", "c"), 1) in fused["port"]

    @pytest.mark.parametrize("seed", range(4))
    def test_seeded_streams_negotiate_into_the_same_bytes(self, seed):
        """Random requests (kinds, dtypes, shapes, per-rank proposals)
        arriving over three cycles, run through both coordinators'
        tables, response construction and fusion: the same bytes."""
        rng = np.random.RandomState(seed)
        size = 2 + seed % 3
        kinds = ["ALLREDUCE", "ALLGATHER", "REDUCESCATTER", "BROADCAST"]
        dtypes = ["FLOAT32", "FLOAT64", "BFLOAT16", "INT32"]
        specs = []
        for i in range(24):
            kind = kinds[rng.randint(4)]
            specs.append(dict(name=f"t{i}", kind=kind,
                              dtype=dtypes[rng.randint(4)],
                              shape=(size * int(rng.randint(1, 4)), 3),
                              wires=[int(rng.randint(4))
                                     for _ in range(size)],
                              cycle=[int(rng.randint(3))
                                     for _ in range(size)]))
        out = {}
        for impl, (coord, msg, wire) in _impls().items():
            table = coord.MessageTable()
            dts, numels = {}, {}
            frames = []
            for cycle in range(3):
                for s in specs:
                    for r in range(size):
                        if s["cycle"][r] != cycle:
                            continue
                        req = msg.Request(
                            request_rank=r,
                            request_type=msg.RequestType[s["kind"]],
                            tensor_type=msg.DataType[s["dtype"]],
                            tensor_name=s["name"], tensor_shape=s["shape"],
                            root_rank=0, wire_dtype=s["wires"][r])
                        dts[s["name"]] = req.tensor_type
                        numels[s["name"]] = 3
                        table.increment_tensor_count(req, size)
                resps = [coord.construct_response(table, n, size)
                         for n in table.pop_ready()]
                fused = coord.fuse_responses(resps, dts, 4096, numels)
                frames.append(wire.serialize_response_list(
                    msg.ResponseList(fused)))
            out[impl] = frames
        assert out["port"] == out["ref"]


# -- the spawned worlds ----------------------------------------------------
def _inputs(rank: int, size: int):
    """Rank ``rank``'s inputs, made from a seed with numpy."""
    rng = np.random.RandomState(100 + rank)
    x = {"a": rng.randn(1000).astype(np.float32) * (rank + 1),
         "b": rng.randn(300).astype(np.float32),
         "g0": rng.randn(17).astype(np.float32),
         "g1": rng.randn(64).astype(np.float32) * 10,
         "g2": rng.randn(5).astype(np.float32) * 1e-3,
         "d": rng.randn(200),
         "i": rng.randint(-1000, 1000, 50).astype(np.int32),
         "ag": rng.randn(rank + 1, 3).astype(np.float32),
         "rs": rng.randn(size * 4, 2).astype(np.float32)}
    for k in range(STEADY):
        x[f"s{k}"] = rng.randn(333).astype(np.float32)
    return x


def _compression_main(out_dir: str) -> int:
    """One rank of a compression world: the collectives of the module's
    docstring on CPU tensors; saves every output, the runtime's counts
    and this rank's int8 residuals."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    hvd.init(device="cpu")
    rank, size = hvd.rank(), hvd.size()
    x = {k: torch.from_numpy(v) for k, v in _inputs(rank, size).items()}
    out = {"ar_sum": hvd.allreduce(x["a"], op=hvd.Sum, name="ar_sum"),
           "ar_avg": hvd.allreduce(x["a"], average=True, name="ar_avg"),
           "ar_scaled": hvd.allreduce(x["b"], op=hvd.Sum, name="ar_scaled",
                                      prescale_factor=0.5,
                                      postscale_factor=3.0)}
    for i, o in enumerate(hvd.grouped_allreduce(
            [x["g0"], x["g1"], x["g2"]], op=hvd.Sum, name="grp")):
        out[f"grp{i}"] = o
    out["ar_f64"] = hvd.allreduce(x["d"], op=hvd.Sum, name="ar_f64")
    out["ar_bf16"] = hvd.allreduce(x["a"].bfloat16(), op=hvd.Sum,
                                   name="ar_bf16")
    out["ar_int"] = hvd.allreduce(x["i"], op=hvd.Sum, name="ar_int")
    out["ag"] = hvd.allgather(x["ag"], name="ag")
    out["rs"] = hvd.reducescatter(x["rs"], name="rs")
    out["rs_avg"] = hvd.reducescatter(x["rs"], name="rs_avg",
                                      op=hvd.Average)
    out["bc"] = hvd.broadcast(x["a"], 1, name="bc")
    for k in range(STEADY):
        out[f"s{k}"] = hvd.allreduce(x[f"s{k}"], op=hvd.Sum, name="steady")
    rt = basics.runtime()
    star = next(b for b in rt.op_manager.backends if b.name == "socket")
    residuals = {"|".join(k): v for k, v in star._ef._residuals.items()}
    stats = dict(rt.stats)
    hvd.shutdown()
    torch.save({"out": out, "residuals": residuals, "stats": stats},
               os.path.join(out_dir, f"result{rank}.pt"))
    return 0


# World -> (ranks, HOROVOD_COMPRESSION of each rank).
WORLDS = {"bf16": ("bf16", "bf16", "bf16"), "int8": ("int8", "int8"),
          "mixed": ("none", "bf16")}
# One deadline for the three worlds together, from their start (about
# 5 s on an 8-core host).
WORLDS_DEADLINE_S = 90.0


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Start every world of ``WORLDS`` at once; the first test asks for
    them, so that they run while the in-process tests do
    (``tests/torch_worlds.py``: one deadline, logs in files, the ports
    held until the worlds end)."""
    from tests.torch_worlds import Worlds, child_env
    spawned = Worlds(WORLDS_DEADLINE_S)
    try:
        for kind, comps in WORLDS.items():
            out = tmp_path_factory.mktemp(f"wire_{kind}")
            port = spawned.reserve_port()
            envs = [child_env(HOROVOD_COMPRESSION=comp, HOROVOD_RANK=r,
                              HOROVOD_SIZE=len(comps),
                              HOROVOD_CONTROLLER_ADDR="127.0.0.1",
                              HOROVOD_CONTROLLER_PORT=port,
                              HOROVOD_CYCLE_TIME=2)
                    for r, comp in enumerate(comps)]
            spawned.start(kind, out, [[pathlib.Path(__file__), out]]
                          * len(comps), envs)
        done = {}

        def wait(kind):
            if kind not in done:
                rcs, _, logs = spawned.wait(kind)
                assert rcs == [0] * len(rcs), "\n".join(logs)
                out = spawned.out(kind)
                done[kind] = [torch.load(out / f"result{r}.pt")
                              for r in range(len(rcs))]
            return done[kind]
        yield wait
    finally:
        spawned.close()


def _expected(wires, size):
    """Every output of the world of ``wires`` (the ranks' proposals),
    computed by the reference's codec on the ranks' inputs."""
    from horovod_tpu.common import wire_dtype as ref
    xs = [_inputs(r, size) for r in range(size)]
    verdict = ref.resolve(ref.wire_code_of(w) for w in wires)
    efs = [ref.ErrorFeedback() for _ in range(size)]

    def allreduce(parts, pre=1.0, post=1.0, key=None):
        dt = parts[0].dtype
        if pre != 1.0:
            parts = [p * np.asarray(pre, dt) for p in parts]
        n = parts[0].size
        w = verdict if dt in (np.float32, np.float64) else ref.WIRE_NONE
        if w == ref.WIRE_NONE:
            acc = parts[0].copy()
            for p in parts[1:]:
                acc += p
        elif w == ref.WIRE_INT8:
            qs = [ref.quantize_ef(p, ef, key) for p, ef in zip(parts, efs)]
            acc = ref.dequantize(ref.reduce_wire(qs[0], qs[1:], w, dt, n),
                                 dt, n)
        else:
            ws = [ref.compress(p, w) for p in parts]
            acc = ref.decompress(ref.reduce_wire(ws[0].copy(), ws[1:], w,
                                                 dt, n), w, dt, n)
        if post != 1.0:
            acc = acc * np.asarray(post, dt)
        return acc

    def reducescatter(parts, post, r):
        per = parts[0].size // size
        flat = [p.reshape(-1) for p in parts]
        if verdict == ref.WIRE_NONE:
            acc = flat[0].copy()
            for p in flat[1:]:
                acc += p
            res = acc[r * per:(r + 1) * per].copy()
        elif verdict == ref.WIRE_INT8:
            qs = [ref.quantize(p) for p in flat]
            acc = ref.dequantize(qs[0], np.float32, flat[0].size)
            for q in qs[1:]:
                acc += ref.dequantize(q, np.float32, flat[0].size)
            res = ref.dequantize(ref.quantize(acc[r * per:(r + 1) * per]),
                                 np.float32, per)
        else:
            ws = [ref.compress(p, verdict) for p in flat]
            acc = ref.reduce_wire(ws[0].copy(), ws[1:], verdict,
                                  np.float32, flat[0].size)
            res = ref.decompress(acc[r * per:(r + 1) * per], verdict,
                                 np.float32, per)
        if post != 1.0:
            res = res * np.asarray(post, np.float32)
        return res.reshape((per // 2, 2))

    want = {"ar_sum": allreduce([x["a"] for x in xs], key=("ar_sum",)),
            "ar_avg": allreduce([x["a"] for x in xs], post=1.0 / size,
                                key=("ar_avg",)),
            "ar_scaled": allreduce([x["b"] for x in xs], 0.5, 3.0,
                                   key=("ar_scaled",))}
    fused = allreduce([np.concatenate([x["g0"], x["g1"], x["g2"]])
                       for x in xs], key=("grp.0", "grp.1", "grp.2"))
    want.update(grp0=fused[:17], grp1=fused[17:81], grp2=fused[81:])
    want["ar_f64"] = allreduce([x["d"] for x in xs], key=("ar_f64",))
    bf = [torch.from_numpy(x["a"]).bfloat16() for x in xs]
    acc = bf[0].clone()
    for b in bf[1:]:
        acc += b
    want["ar_bf16"] = acc
    want["ar_int"] = sum(x["i"] for x in xs)
    agw = ref.allgather_wire(verdict)
    want["ag"] = np.concatenate([
        x["ag"] if agw == ref.WIRE_NONE else ref.decompress(
            ref.compress(x["ag"].reshape(-1), agw), agw, np.float32,
            x["ag"].size).reshape(x["ag"].shape) for x in xs])
    want["bc"] = xs[1]["a"]
    for k in range(STEADY):
        want[f"s{k}"] = allreduce([x[f"s{k}"] for x in xs], key=("steady",))
    per_rank = []
    for r in range(size):
        w = dict(want, rs=reducescatter([x["rs"] for x in xs], 1.0, r),
                 rs_avg=reducescatter([x["rs"] for x in xs], 1.0 / size, r))
        per_rank.append(w)
    return verdict, per_rank, efs


@pytest.mark.parametrize("kind", list(WORLDS))
def test_world_outputs_equal_the_reference_codec(worlds, kind):
    from horovod_tpu.common import wire_dtype as ref
    results = worlds(kind)
    size = len(WORLDS[kind])
    verdict, want, efs = _expected(WORLDS[kind], size)
    for r, res in enumerate(results):
        for name, w in want[r].items():
            got = res["out"][name]
            w = w if isinstance(w, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(w))
            assert got.dtype == w.dtype and got.shape == w.shape, name
            assert _bits(got) == _bits(w), (kind, r, name)
        stats = res["stats"]
        assert stats["cached_cycles"] > 0, stats
        if verdict == ref.WIRE_INT8:
            # int8 never speculates; its residuals are the reference's
            assert stats["spec_cycles"] == 0, stats
            mine = res["residuals"]
            theirs = {"|".join(k): v for k, v in efs[r]._residuals.items()}
            assert sorted(mine) == sorted(theirs)
            for key in theirs:
                assert _bits(mine[key]) == _bits(theirs[key]), key
        else:
            assert stats["spec_cycles"] >= STEADY // 2, stats
            assert not res["residuals"]
    if kind == "mixed":
        assert verdict == ref.WIRE_NONE


if __name__ == "__main__":
    try:
        sys.exit(_compression_main(sys.argv[1]))
    except Exception:
        traceback.print_exc()
        sys.exit(1)
