"""The CPU side of the narrow tf32 dq and dk/dv (fp32 at head dims 16 and
32, csrc/flash_bwd_tf32_narrow_sm90.cu): the route every fp32 backward up
to D 32 takes now (the simt kernels have none left), its padding ladder,
launcher checks and C entries, the plain dq and dk/dv in ``TF32X3`` (what
the kernels compute) against the reference's Pallas backward in
interpret mode, ``_flash_bwd`` padding once for both kernels, and CPU
models of the kernels' order of sums, whose stages several consumer
warpgroups share (``kDqSplit``, ``kDqKv``; ``kDkvSplit``, ``kDkvQ``),
held to both. The kernels themselves run on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Tolerance: the reference's fp32 gradient bound (tests/test_parallel.py),
per element 1e-4 of the largest value in its row (the last axis), plus an
absolute 1e-6, or ``tolerance.DQ_ATOL`` for dq (a query that sees one key
has a dq of pure rounding noise), as tests/test_torch_flash_bwd_tf32.py
holds the wider tf32 builds: 3xTF32 leaves each product within 2^-21 of
fp32's, and the warpgroups' partial sums meet by fp32 adds, both far
below the bound. A result that lost one warpgroup's stage must fail it by
more than chip_smoke.py's LOST_FP32_BY.
"""

import functools
import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from horovod_tpu.parallel import flash_attention as ref
from horovod_tpu_torch import _cuda
from horovod_tpu_torch.parallel import flash_attention as port
from horovod_tpu_torch.utils import tolerance
from tests import torch_refpool
from tests.torch_threads import one_torch_thread  # noqa: F401

GRAD_TOL = 1e-4
SOURCE = "flash_bwd_tf32_narrow_sm90.cu"
ENTRIES = {"hvdt_flash_dq_tf32_narrow": "hvdt_flash_dq_tf32",
           "hvdt_flash_dkv_tf32_narrow": "hvdt_flash_dkv_tf32"}


def _constant(name):
    with open(os.path.join(_cuda.CSRC_DIR, SOURCE)) as fh:
        src = fh.read()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


class _CudaLike:
    """What ``_check_tensor_cores`` reads of a CUDA tensor (device, shape,
    dtype, base address), so that its head-dim and alignment checks run
    here."""

    def __init__(self, d, dtype=torch.float32, misaligned=0):
        self.device = torch.device("cuda")
        self.shape = (1, 64, 2, d)
        self.dtype = dtype
        self._ptr = 1 << 20 | misaligned

    def data_ptr(self):
        return self._ptr


@pytest.mark.parametrize("d", [1, 8, 15, 16, 17, 24, 31, 32])
def test_fp32_backward_takes_the_narrow_tf32_builds(d):
    """Every fp32 dq and dk/dv up to D 32 takes the tf32 design, as the
    forward does, all three padding D 1-16 to 16 and D 17-32 to 32; the
    dk/dv build at D is named by D."""
    for kern in port.KERNELS:
        assert port._design(torch.float32, d, kern) == "tf32"
    built = 16 if d <= 16 else 32
    for kern in port.KERNELS:
        assert port.padded_head_dim(d, "tf32", kern) == built
    assert port.tf32_dkv_part(built) == built
    assert port.TF32_NARROW_DIMS["dq"] == port.TF32_NARROW_DIMS["dkv"] == (
        16, 32)


@pytest.mark.parametrize("kern", ["dq", "dkv"])
@pytest.mark.parametrize("d", [16, 32])
def test_launcher_checks_take_the_narrow_builds(d, kern):
    """The tf32 dq and dk/dv take CUDA fp32 tensors at D 16 and 32 with
    16-byte-aligned bases; a misaligned base, a head dim between the builds
    and a 16-bit input are refused before any launch."""
    port._check_tensor_cores("b", kern, [_CudaLike(d)] * 4, "tf32")
    for i in range(4):
        tensors = [_CudaLike(d)] * 4
        tensors[i] = _CudaLike(d, misaligned=4)
        with pytest.raises(ValueError, match="16-byte"):
            port._check_tensor_cores("b", kern, tensors, "tf32")
    for bad in (_CudaLike(d - 8), _CudaLike(d, torch.bfloat16)):
        with pytest.raises(ValueError, match="tf32 kernel takes"):
            port._check_tensor_cores("b", kern, [bad] * 4, "tf32")


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_c_entries_take_what_the_bindings_pass(entry):
    """The narrow C entries declare as many parameters as
    horovod_tpu_torch/_cuda.py's ctypes signature passes, the same as the
    wider tf32 entries' (the library is built and loaded on the card
    only)."""
    with open(os.path.join(_cuda.CSRC_DIR, SOURCE)) as fh:
        src = fh.read()
    decl = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src)
    assert decl
    assert len(decl.group(1).split(",")) == len(_cuda._SIGNATURES[entry])
    assert _cuda._SIGNATURES[entry] == _cuda._SIGNATURES[ENTRIES[entry]]


def test_cpu_tensors_take_the_plain_backward_and_the_launchers_refuse():
    q = torch.zeros(1, 64, 2, 16)
    st = torch.zeros(1, 2, 64)
    port.reset_launch_counts()
    for fn in (port._flash_dq_tf32, port._flash_dkv_tf32):
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, q, q, q, st, st, True, 0, 0)
    dq, (dk, dv) = port._flash_bwd(q, q, q, q, st, st, True, 0, 0)
    assert dq.shape == dk.shape == dv.shape == q.shape
    assert not any(port.launch_counts().values())


# sq, sk, causal, q_offset, k_offset (batch 1, heads 2): S 64 and the
# ragged pair (100, 127), causal and not, with offsets and rows that see
# no key.
CASES = [
    pytest.param(64, 64, True, 0, 0, id="s64_causal"),
    pytest.param(64, 64, False, 0, 0, id="s64_noncausal"),
    pytest.param(100, 127, True, 27, 0, id="s100_sk127_q_offset"),
    pytest.param(100, 127, False, 0, 0, id="s100_sk127_noncausal"),
    pytest.param(100, 127, True, 0, 40, id="s100_sk127_dead_rows"),
]


def _args(d, sq, sk, causal, qo, ko):
    """q, k, v, do from a numpy seed and the backward's arguments, with the
    plain forward's (o, m, l)."""
    rng = np.random.RandomState(sq + sk + d)
    q, k, v, do = (torch.tensor(rng.randn(1, n, 2, d).astype(np.float32))
                   for n in (sq, sk, sk, sq))
    o, m, l = port._flash_fwd_plain(q, k, v, causal, qo, ko)
    lse = port._lse_from_stats(m, l)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    return (o, m, l), (q, k, v, do, lse, delta, causal, qo, ko)


def _reference_job(d, sq, sk, causal, qo, ko):
    """The reference's (dq, dk, dv) from the plain forward's stats,
    interpret mode, causal throughout (one compilation a shape; its
    default blocks take each sequence whole): a q offset of Sk lets every
    row see every key. A worker's job (``_jobs``)."""
    stats, (q, k, v, do, *_) = _args(d, sq, sk, causal, qo, ko)
    out = ref.flash_attention_bwd(
        *(jnp.asarray(x.numpy()) for x in (q, k, v, *stats, do)),
        causal=True, q_offset=qo if causal else sk,
        k_offset=ko if causal else 0, interpret=True)
    return tuple(torch.tensor(np.asarray(x)) for x in out)


def _reference(d, sq, sk, causal, qo, ko):
    """The pool's ``_reference_job`` result for these arguments; several
    tests hold their results to it."""
    return torch_refpool.result((__name__, d, sq, sk, causal, qo, ko))


def _jobs():
    """Every reference result the module's tests read, as
    ``torch_refpool`` jobs."""
    cases = [(d, *c.values) for c in CASES for d in (8, 16, 24, 32)]
    cases += [(d, 100, 127, True, 27, 0) for d in (8, 16, 20, 32)]
    return [((__name__, *c), _reference_job, c) for c in cases]


torch_refpool.register(_jobs)


@pytest.fixture(autouse=True, scope="module")
def _references():
    torch_refpool.start()


def _ratio(mine, want):
    """The largest err / bound of (dq, dk, dv) under the fp32 gradient
    bound."""
    return max(tolerance.worst(mine[0], want[0], GRAD_TOL,
                               atol=tolerance.DQ_ATOL)[1],
               tolerance.worst(mine[1], want[1], GRAD_TOL)[1],
               tolerance.worst(mine[2], want[2], GRAD_TOL)[1])


def _plain_on_build(args):
    """The plain dq and dk/dv in TF32X3 as the card runs them at D: zero-
    padded to the narrow build, scaled by the true D, sliced back."""
    def dq(*a, scale=None):
        return port._flash_dq_plain(*a, operands=port.TF32X3, scale=scale)

    def dkv(*a, scale=None):
        return port._flash_dkv_plain(*a, operands=port.TF32X3, scale=scale)
    tensors, rest = args[:4], args[4:]
    kw = dict(design="tf32")
    return (port._on_padded_head_dim(dq, tensors, *rest, kernel="dq", **kw),
            *port._on_padded_head_dim(dkv, tensors, *rest, kernel="dkv",
                                      **kw))


@pytest.mark.parametrize("d", [8, 16, 24, 32])
@pytest.mark.parametrize("sq,sk,causal,qo,ko", CASES)
def test_plain_tf32x3_backward_matches_reference(d, sq, sk, causal, qo, ko):
    """What the card holds the kernels to, the plain dq and dk/dv in
    TF32X3 at the build's padded head dim, against the reference's
    backward in interpret mode at the true D and against the plain fp32
    versions: within the fp32 gradient bound; rows that see no key give
    zero gradients."""
    _, args = _args(d, sq, sk, causal, qo, ko)
    mine = _plain_on_build(args)
    assert all(g.shape[-1] == d for g in mine)
    assert _ratio(mine, _reference(d, sq, sk, causal, qo, ko)) <= 1.0
    plain = (port._flash_dq_plain(*args), *port._flash_dkv_plain(*args))
    assert _ratio(mine, plain) <= 1.0
    if ko == 40:
        assert not mine[0][:, :40].any()


@pytest.mark.parametrize("d,built", [(8, 16), (16, 16), (20, 32), (32, 32)])
def test_fp32_backward_pads_once_for_both_narrow_kernels(d, built):
    """``_flash_bwd`` with the plain TF32X3 versions in the kernels' place
    pads q, k, v and do once, to the narrow build, hands dq and dk/dv the
    same tensors, and gives the reference's gradients."""
    _, args = _args(d, 100, 127, True, 27, 0)
    seen = []

    def plain(fn):
        def run(*a, **kw):
            seen.append(a[:4])
            return fn(*a, operands=port.TF32X3, **kw)
        return run
    launchers = {("dq", "tf32"): plain(port._flash_dq_plain),
                 ("dkv", "tf32"): plain(port._flash_dkv_plain)}
    dq, (dk, dv) = port._flash_bwd(*args, launchers=launchers)
    assert len(seen) == 2 and all(a is b for a, b in zip(*seen))
    assert seen[0][0].shape[-1] == built
    for g, x in zip((dq, dk, dv), args[:3]):
        assert g.shape == x.shape and g.dtype == torch.float32
    assert _ratio((dq, dk, dv), _reference(d, 100, 127, True, 27, 0)) <= 1.0


def _dq_stages(args, n):
    """Each ``n``-key kv stage's ds k, a TF32X3 product of its own, in
    stage order: what the narrow tf32 dq's warpgroups add, computed once
    for every count of warpgroups."""
    q, k, v, do, lse, delta, causal, qo, ko = args
    scale = 1.0 / math.sqrt(q.shape[-1])
    out = []
    for j in range(-(-k.shape[1] // n)):
        keys = slice(j * n, (j + 1) * n)
        _, ds = port._p_ds_plain(q, k[:, keys], v[:, keys], do, lse, delta,
                                 causal, qo, ko + j * n, scale, port.TF32X3)
        out.append(port._product("bhqk,bkhd->bqhd", ds, k[:, keys],
                                 port.TF32X3))
    return out


def _dq_order(args, split, n, lost=None, stages=None):
    """dq as the narrow tf32 dq sums it at ``split`` consumer warpgroups and
    ``n``-key stages: warpgroup w takes kv stages w, w + split, ... (those
    wholly in a q tile's future add zeros, so every q tile's may be taken
    here), each stage's ds k a TF32X3 product of its own added to the
    warpgroup's sum; then the warpgroups' sums added in the order w = 0, 1,
    .... ``lost``: a stage left out (a kernel that dropped it). ``stages``:
    ``_dq_stages(args, n)``, where the caller has them."""
    stages = _dq_stages(args, n) if stages is None else stages
    parts = [torch.zeros_like(args[0]) for _ in range(split)]
    for j, ds_k in enumerate(stages):
        if j != lost:
            parts[j % split] = parts[j % split] + ds_k
    return functools.reduce(torch.add, parts)


def _dkv_stages(args, n):
    """For each 64-key tile: its keys, the first ``n``-query stage it sees
    (u0), and each stage's (u, ds^T q, p^T do) from u0 on, TF32X3 products
    of their own: what the narrow tf32 dk/dv's warpgroups add, computed
    once for every count of warpgroups."""
    q, k, v, do, lse, delta, causal, qo, ko = args
    scale = 1.0 / math.sqrt(q.shape[-1])
    sq, sk = q.shape[1], k.shape[1]
    stages = -(-sq // n)
    tiles = []
    for t0 in range(0, sk, 64):
        keys = slice(t0, t0 + 64)
        need = ko + t0 - qo - (n - 1)
        u0 = min(stages, -(-need // n)) if causal and need > 0 else 0
        prods = []
        for u in range(u0, stages):
            qs = slice(u * n, (u + 1) * n)
            p, ds = port._p_ds_plain(q[:, qs], k[:, keys], v[:, keys],
                                     do[:, qs], lse[..., qs], delta[..., qs],
                                     causal, qo + u * n, ko + t0, scale,
                                     port.TF32X3)
            prods.append((u, port._product("bhqk,bqhd->bkhd", ds, q[:, qs],
                                           port.TF32X3),
                          port._product("bhqk,bqhd->bkhd", p, do[:, qs],
                                        port.TF32X3)))
        tiles.append((keys, u0, prods))
    return tiles


def _dkv_order(args, split, n, lost=None, tiles=None):
    """(dk, dv) as the narrow tf32 dk/dv sums them at ``split`` consumer
    warpgroups and ``n``-query stages: for each 64-key tile, the q stages
    from the first one the tile sees (u0) dealt round-robin (stage u to
    warpgroup (u - u0) % split), each stage's p^T do and ds^T q TF32X3
    products of their own added to the warpgroup's sums; then the
    warpgroups' sums added in the order w = 0, 1, .... ``lost``: a q stage
    left out of every tile. ``tiles``: ``_dkv_stages(args, n)``, where the
    caller has them."""
    k, v = args[1], args[2]
    tiles = _dkv_stages(args, n) if tiles is None else tiles
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for keys, u0, prods in tiles:
        parts = [[0, 0] for _ in range(split)]
        for u, ds_q, p_do in prods:
            if u == lost:
                continue
            w = parts[(u - u0) % split]
            w[0] = w[0] + ds_q
            w[1] = w[1] + p_do
        dk[:, keys] = functools.reduce(torch.add, (w[0] for w in parts))
        dv[:, keys] = functools.reduce(torch.add, (w[1] for w in parts))
    return dk, dv


@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("sq,sk,causal,qo,ko", CASES)
def test_kernel_order_matches_plain_and_reference(d, sq, sk, causal, qo,
                                                  ko):
    """The kernels' order of sums with 1, 2 and the package's warpgroups,
    on 32- and 64-row stages (the package's constants among them), against
    the plain TF32X3 dq and dk/dv and the reference, within the fp32
    gradient bound."""
    _, args = _args(d, sq, sk, causal, qo, ko)
    plain = (port._flash_dq_plain(*args, operands=port.TF32X3),
             *port._flash_dkv_plain(*args, operands=port.TF32X3))
    theirs = _reference(d, sq, sk, causal, qo, ko)
    splits = (_constant("kDqSplit"), _constant("kDkvSplit"))
    stages = (_constant("kDqKv"), _constant("kDkvQ"))
    assert splits == (2, 3) and stages == (64, 32)
    for n in (32, 64):
        dq_stages, dkv_tiles = _dq_stages(args, n), _dkv_stages(args, n)
        for g in (1, 2) + splits:
            mine = (_dq_order(args, g, n, stages=dq_stages),
                    *_dkv_order(args, g, n, tiles=dkv_tiles))
            assert _ratio(mine, plain) <= 1.0, (n, g)
            assert _ratio(mine, theirs) <= 1.0, (n, g)


def test_last_warpgroup_stages_of_chip_smoke_follow_the_kernels():
    """chip_smoke.py's must-fail cases for the warpgroups' sums leave out
    one stage that the last consumer warpgroup takes at the file's
    constants, at the C4 shape's fp32 D 16 and 32: keys of a kv stage of
    dq (kv stage j goes to warpgroup j % kDqSplit) and queries of a q stage
    of dk/dv (of the first kv tile, which sees every q stage: stage u goes
    to warpgroup u % kDkvSplit). The kernels' order without that stage
    fails the fp32 gradient bound by more than LOST_FP32_BY, as the plain
    results without those keys or queries do, and agrees with those (here
    B 1, H 1, D 16, S 1024, causal)."""
    lost = chip_smoke.TF32_NARROW_LOST
    for kern, split, n in (("dq", "kDqSplit", "kDqKv"),
                           ("dkv", "kDkvSplit", "kDkvQ")):
        split, n = _constant(split), _constant(n)
        lo, hi = lost[f"{kern}_last_warpgroup"]
        assert hi - lo == n and lo % n == 0 and hi <= chip_smoke.C4_SHAPE["s"]
        assert (lo // n) % split == split - 1 and split > 1
        one = lost[kern]  # the one-stage case
        assert one[1] - one[0] == n and one[0] % n == 0
    for tag in ("fp32_d16", "fp32_d32"):
        assert chip_smoke.LOST_C4[tag] is lost
    rng = np.random.RandomState(5)
    q, k, v, do = (torch.tensor(rng.randn(1, 1024, 1, 16).astype(np.float32))
                   for _ in range(4))
    o, m, l = port._flash_fwd_plain(q, k, v, True, 0, 0)
    lse = port._lse_from_stats(m, l)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, True, 0, 0)
    kw = dict(atol=tolerance.DQ_ATOL)
    split, n = _constant("kDqSplit"), _constant("kDqKv")
    lo, hi = lost["dq_last_warpgroup"]
    dq = port._flash_dq_plain(*args, operands=port.TF32X3)
    dq_stages = _dq_stages(args, n)
    dq_lost = _dq_order(args, split, n, lost=lo // n, stages=dq_stages)
    kept = chip_smoke.dq_without_keys(port, q, k, v, do, lse, delta, lo, hi,
                                      operands=port.TF32X3)
    for x in (dq_lost, kept):
        assert tolerance.worst(x, dq, GRAD_TOL, **kw)[1] > (
            chip_smoke.LOST_FP32_BY)
    assert tolerance.worst(dq_lost, kept, GRAD_TOL, **kw)[1] <= 1.0
    assert tolerance.worst(_dq_order(args, split, n, stages=dq_stages), dq,
                           GRAD_TOL, **kw)[1] <= 1.0
    split, n = _constant("kDkvSplit"), _constant("kDkvQ")
    lo, hi = lost["dkv_last_warpgroup"]
    dk, dv = port._flash_dkv_plain(*args, operands=port.TF32X3)
    do_x, delta_x = do.clone(), delta.clone()
    do_x[:, lo:hi] = 0
    delta_x[:, :, lo:hi] = 0
    kept = port._flash_dkv_plain(q, k, v, do_x, lse, delta_x, True, 0, 0,
                                 operands=port.TF32X3)
    dkv_lost = _dkv_order(args, split, n, lost=lo // n)
    for got, want, ok in zip(dkv_lost, (dk, dv), kept):
        assert tolerance.worst(got, want, GRAD_TOL)[1] > (
            chip_smoke.LOST_FP32_BY)
        assert tolerance.worst(ok, want, GRAD_TOL)[1] > (
            chip_smoke.LOST_FP32_BY)
        assert tolerance.worst(got, ok, GRAD_TOL)[1] <= 1.0
