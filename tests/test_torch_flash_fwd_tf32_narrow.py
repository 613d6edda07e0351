"""The CPU side of the narrow tf32 forward (fp32 at head dims 16 and 32,
csrc/flash_fwd_tf32_narrow_sm90.cu): the route every fp32 forward up to
D 32 takes now (dq and dk/dv take their own narrow tf32 builds there,
tests/test_torch_flash_bwd_tf32_narrow.py), its padding ladder and
launcher checks, the plain forward in ``TF32X3`` (what the
kernel computes) against the reference's Pallas forward in interpret
mode, and a CPU model of the kernel's order of sums, whose kv tiles
several consumer warpgroups share (``kNarrowSplit``, ``kNarrowKv``), held
to both. The kernel itself runs on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerances. The reference's fp32 bound (tests/test_parallel.py): 2e-5 of
the row for o, m and l element by element (m with an absolute 1e-5, l
1e-6), as tests/test_torch_flash_fwd_tf32_wide.py holds the wider tf32
builds: 3xTF32 leaves each product within 2^-21 of fp32's, and the
warpgroups' partial sums meet through exp(m_w - m) factors that are
exact to an fp32 rounding, both far below the bound. A result that lost
one warpgroup's kv tile must fail it by more than chip_smoke.py's
LOST_FP32_BY.
"""

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

FWD_TOL = 2e-5
LOG2E = 1.4426950408889634
NEG_INF = -1e30
SOURCE = "flash_fwd_tf32_narrow_sm90.cu"


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
def test_fp32_forward_takes_tf32_and_the_backward_simt(d):
    """Every fp32 forward up to D 32 takes the tf32 design (its narrow
    builds), and so do dq and dk/dv now (theirs; the simt kernels have no
    route left); all three pad D 1-16 to 16 and D 17-32 to 32, so the
    backward still pads once for both."""
    designs = [port._design(torch.float32, d, kern) for kern in port.KERNELS]
    assert designs == ["tf32", "tf32", "tf32"]
    built = 16 if d <= 16 else 32
    assert [port.padded_head_dim(d, design, kern) for design, kern in
            zip(designs, port.KERNELS)] == [built] * 3
    assert port.tf32_fwd_part(built) == built
    assert port.tf32_dkv_part(built) == built


def test_tf32_route_past_32_is_unchanged():
    assert port.TF32_NARROW_DIMS == dict.fromkeys(port.KERNELS, (16, 32))
    for d, built in ((33, 64), (64, 64), (100, 128), (600, 608)):
        for kern in port.KERNELS:
            assert port._design(torch.float32, d, kern) == "tf32"
            assert port.padded_head_dim(d, "tf32", kern) == built
    for dtype in (torch.bfloat16, torch.float16):
        for d in (16, 32):
            assert port._design(dtype, d, "fwd") == "sm90"


@pytest.mark.parametrize("d", [16, 32])
def test_launcher_checks_take_the_narrow_builds_alone(d):
    """The tf32 forward takes CUDA fp32 tensors at D 16 and 32 (and a
    16-byte-aligned base), as the tf32 dq and dk/dv now do (their narrow
    builds), and no head dim between the builds or 16-bit input gets
    through."""
    port._check_tensor_cores("f", "fwd", [_CudaLike(d)] * 3, "tf32")
    for kern in ("dq", "dkv"):
        port._check_tensor_cores("b", kern, [_CudaLike(d)] * 4, "tf32")
    with pytest.raises(ValueError, match="16-byte"):
        port._check_tensor_cores("f", "fwd", [_CudaLike(d), _CudaLike(
            d, misaligned=4), _CudaLike(d)], "tf32")
    for bad in (_CudaLike(d - 8), _CudaLike(d, torch.bfloat16)):
        with pytest.raises(ValueError, match="tf32 kernel takes"):
            port._check_tensor_cores("f", "fwd", [bad] * 3, "tf32")


def test_cpu_tensors_take_the_plain_forward_and_the_launcher_refuses():
    q = torch.zeros(1, 64, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        port._flash_fwd_tf32(q, q, q, True, 0, 0)
    o, m, l = port._flash_fwd(q, q, q, True, 0, 0)
    assert o.shape == q.shape and m.shape == l.shape == (1, 2, 64)
    assert port.launch_counts()["flash_fwd_tf32"] == 0


def test_c_entry_takes_what_the_binding_passes():
    """hvdt_flash_fwd_tf32_narrow declares as many parameters as
    horovod_tpu_torch/_cuda.py's ctypes signature passes, the same as the
    wider tf32 entry's (the library is built and loaded on the card
    only)."""
    entry = "hvdt_flash_fwd_tf32_narrow"
    with open(os.path.join(_cuda.CSRC_DIR, SOURCE)) as fh:
        src = fh.read()
    decl = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src)
    assert decl
    assert len(decl.group(1).split(",")) == len(_cuda._SIGNATURES[entry])
    assert (_cuda._SIGNATURES[entry]
            == _cuda._SIGNATURES["hvdt_flash_fwd_tf32"])


# sq, sk, causal, q_offset, k_offset (batch 1, heads 2): S 64 and the
# ragged pair (100, 127), one of the reference's shapes in
# tests/test_torch_flash_sm90_narrow.py (whose compilations it shares at
# D 16 and 32), causal and not, with offsets and rows that see no key.
CASES = [
    pytest.param(64, 64, True, 0, 0, id="s64_causal"),
    pytest.param(64, 64, False, 0, 0, id="s64_noncausal"),
    pytest.param(100, 127, True, 27, 0, id="s100_sk127_q_offset"),
    pytest.param(100, 127, False, 0, 0, id="s100_sk127_noncausal"),
    pytest.param(100, 127, True, 0, 40, id="s100_sk127_dead_rows"),
]


def _inputs(d, sq, sk):
    rng = np.random.RandomState(sq + sk + d)
    return [torch.tensor(rng.randn(1, n, 2, d).astype(np.float32))
            for n in (sq, sk, sk)]


def _reference_job(d, sq, sk, causal, qo, ko):
    """The reference's (o, m, l) on ``_inputs(d, sq, sk)``, causal
    throughout (one compilation a shape): a q offset of Sk lets every row
    see every key. A worker's job (``_jobs``)."""
    q, k, v = _inputs(d, sq, sk)
    out = ref.flash_attention_stats(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)), causal=True,
        q_offset=qo if causal else sk, k_offset=ko if causal else 0,
        interpret=True)
    return [torch.tensor(np.asarray(x)) for x in out]


def _reference(d, sq, sk, causal, qo, ko):
    """The pool's ``_reference_job`` result for these arguments; several
    tests hold their results to it."""
    return torch_refpool.result((__name__, d, sq, sk, causal, qo, ko))


def _jobs():
    """Every reference result the module's tests read, as
    ``torch_refpool`` jobs."""
    cases = [(d, *c.values) for c in CASES for d in (8, 16, 24, 32)]
    cases += []
    return [((__name__, *c), _reference_job, c) for c in cases]


torch_refpool.register(_jobs)


@pytest.fixture(autouse=True, scope="module")
def _references():
    torch_refpool.start()


def _plain_tf32x3(q, k, v, causal, qo, ko):
    """The plain forward in TF32X3 as the card runs it at D: zero-padded
    to the narrow build, scaled by the true D, sliced back."""
    def fwd(q, k, v, causal, qo, ko, scale=None):
        return port._flash_fwd_plain(q, k, v, causal, qo, ko,
                                     operands=port.TF32X3, scale=scale)
    return port._on_padded_head_dim(fwd, (q, k, v), causal, qo, ko,
                                    design="tf32", kernel="fwd")


def _held(mine, want):
    """Largest err/bound of (o, m, l) against ``want``."""
    o, m, l = mine
    return max(tolerance.worst(o, want[0], FWD_TOL)[1],
               tolerance.worst(m, want[1], FWD_TOL, atol=1e-5,
                               rows=False)[1],
               tolerance.worst(l, want[2], FWD_TOL, rows=False)[1])


@pytest.mark.parametrize("d", [8, 16, 24, 32])
@pytest.mark.parametrize("sq,sk,causal,qo,ko", CASES)
def test_plain_tf32x3_forward_matches_reference(d, sq, sk, causal, qo, ko):
    """What the card holds the kernel to, the plain forward in TF32X3 at
    the build's padded head dim, against the reference's forward in
    interpret mode at the true D, and against the plain fp32 forward:
    within the fp32 bound (one TF32 product misses it)."""
    q, k, v = _inputs(d, sq, sk)
    mine = _plain_tf32x3(q, k, v, causal, qo, ko)
    assert mine[0].shape == q.shape
    assert _held(mine, _reference(d, sq, sk, causal, qo, ko)) <= 1.0
    assert _held(mine, port._flash_fwd_plain(q, k, v, causal, qo, ko)) <= 1.0
    if ko == 40:
        assert torch.all(mine[2][..., :40] == 0)
        assert torch.all(mine[1][..., :40] == NEG_INF)
        assert not mine[0][:, :40].any()


def _tile_scores(q, k, causal, qo, ko, kv):
    """Each visible ``kv``-key tile's keys and its scaled, masked logits
    s [B, H, Sq, keys] (q k^T in TF32X3), as every consumer warpgroup
    computes them whatever the split: computed once, shared by the
    splits and by a kernel that drops a tile."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    sq, sk = q.shape[1], k.shape[1]
    nk = -(-sk // kv)
    if causal:
        reach = qo + (-(-sq // 64) * 64) - 1 - ko
        nk = min(nk, max(reach // kv + 1, 0))
    q_pos = qo + torch.arange(sq)
    tiles = []
    for j in range(nk):
        keys = slice(j * kv, min((j + 1) * kv, sk))
        s = port._product("bqhd,bkhd->bhqk", q, k[:, keys],
                          port.TF32X3) * scale
        ok = torch.ones(sq, s.shape[-1], dtype=torch.bool)
        if causal:
            ok = q_pos[:, None] >= ko + torch.arange(keys.start,
                                                     keys.stop)[None]
        tiles.append((keys, s.masked_fill(~ok, float("-inf"))))
    return tiles


def _warpgroup(q, v, tiles, w, split, lost=None):
    """(m, l, O) of consumer warpgroup ``w`` of ``split``: the visible
    tiles w, w + split, ... in turn (``lost`` left out), each with the
    warpgroup's own online softmax."""
    b, sq, h, _ = q.shape
    m = torch.full((b, h, sq), NEG_INF)
    l = torch.zeros(b, h, sq)
    o = torch.zeros(b, h, sq, v.shape[-1])
    for j in range(w, len(tiles), split):
        if j == lost:
            continue
        keys, s = tiles[j]
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp2((m - m_new) * LOG2E)
        p = torch.exp2(s * LOG2E - (m_new * LOG2E)[..., None])
        l = l * corr + p.sum(-1)
        pv = port._product("bhqk,bkhd->bhqd", p, v[:, keys], port.TF32X3)
        o = o * corr[..., None] + pv
        m = m_new
    return m, l, o


def _combined(parts):
    """(o, m, l) from the warpgroups' parts: the rows' max over them, and
    each one's O and l scaled by 2^((m_w - m) log2 e) and added in the
    order w = 0, 1, ...."""
    m = torch.stack([p[0] for p in parts]).amax(0)
    l = o = 0
    for m_w, l_w, o_w in parts:
        a = torch.exp2((m_w - m) * LOG2E)
        l = l + l_w * a
        o = o + o_w * a[..., None]
    o = o / torch.where(l == 0, torch.ones_like(l), l)[..., None]
    return o.transpose(1, 2), m, l


def _kernel_order(q, k, v, causal, qo, ko, split, kv, lost=None,
                  tiles=None):
    """(o, m, l) as the narrow tf32 forward sums them at ``split``
    consumer warpgroups and ``kv``-key tiles: warpgroup w takes the
    visible tiles w, w + split, ... in turn, each with an online softmax
    of its own (p = 2^(x log2 e - m log2 e) against its running max, l
    and O rescaled by corr = 2^((m_old - m) log2 e), O = O corr + P V with
    each tile's P V a product of its own in TF32X3); then the rows' max
    over the warpgroups, and each warpgroup's O and l scaled by 2^((m_w -
    m) log2 e) and added in the order w = 0, 1, .... ``lost``: a tile
    left out (a kernel that dropped it). ``tiles``: ``_tile_scores``'s,
    when the caller already has them."""
    if tiles is None:
        tiles = _tile_scores(q, k, causal, qo, ko, kv)
    return _combined([_warpgroup(q, v, tiles, w, split, lost)
                      for w in range(split)])


@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("sq,sk,causal,qo,ko", CASES)
def test_kernel_order_matches_plain_and_reference(d, sq, sk, causal, qo,
                                                  ko):
    """The kernel's order of sums with 1, 2 and 4 warpgroups, on 32- and
    64-key tiles (the package's constants among them), against the plain
    TF32X3 forward and the reference, within the fp32 bound."""
    q, k, v = _inputs(d, sq, sk)
    plain = port._flash_fwd_plain(q, k, v, causal, qo, ko,
                                  operands=port.TF32X3)
    theirs = _reference(d, sq, sk, causal, qo, ko)
    assert (_constant("kNarrowSplit"), _constant("kNarrowKv")) == (4, 32)
    for kv in (32, 64):
        tiles = _tile_scores(q, k, causal, qo, ko, kv)
        for split in (1, 2, 4):
            mine = _kernel_order(q, k, v, causal, qo, ko, split, kv,
                                 tiles=tiles)
            assert _held(mine, plain) <= 1.0, (kv, split)
            assert _held(mine, theirs) <= 1.0, (kv, split)


def test_last_warpgroup_tile_of_chip_smoke_follows_the_kernel():
    """chip_smoke.py's must-fail case for the combine leaves out one kv
    tile that the last consumer warpgroup takes at the file's constants
    (kv tile j goes to warpgroup j % kNarrowSplit), at the C4 shape's fp32
    D 16 and 32; the kernel's order without that tile fails the fp32
    bound by more than LOST_FP32_BY, as the plain forward without its
    keys does (here B 1, H 2, D 16)."""
    split, kv = _constant("kNarrowSplit"), _constant("kNarrowKv")
    lo, hi = chip_smoke.TF32_NARROW_LAST_WARPGROUP_KEYS
    assert hi - lo == kv and lo % kv == 0 and hi <= chip_smoke.C4_SHAPE["s"]
    assert (lo // kv) % split == split - 1 and split > 1
    for tag in ("fp32_d16", "fp32_d32"):
        assert chip_smoke.LOST_C4[tag]["fwd_last_warpgroup"] == (lo, hi)
    rng = np.random.RandomState(5)
    q, k, v = (torch.tensor(rng.randn(1, 1024, 2, 16).astype(np.float32))
               for _ in range(3))
    plain = port._flash_fwd_plain(q, k, v, True, 0, 0)
    # The warpgroups other than the last see the same tiles with and
    # without the lost one: their parts are computed once.
    tiles = _tile_scores(q, k, True, 0, 0, kv)
    parts = [_warpgroup(q, v, tiles, w, split) for w in range(split)]
    lost = _combined(parts[:-1] + [
        _warpgroup(q, v, tiles, split - 1, split, lost=lo // kv)])
    kept = chip_smoke.fwd_without_keys(port, q, k, v, lo, hi)
    for o in (lost[0], kept):
        assert tolerance.worst(o, plain[0], FWD_TOL)[1] > (
            chip_smoke.LOST_FP32_BY)
    assert tolerance.worst(lost[0], kept, FWD_TOL)[1] <= 1.0
    assert _held(_combined(parts), plain) <= 1

