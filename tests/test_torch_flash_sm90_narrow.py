"""The CPU side of the narrow sm90 forward, dq and dk/dv kernels (bf16 and
fp16 at head dims 16 and 32, whose tiles are rows of 32 or 64 bytes):
which design and padded head dim each kernel gets at every head dim up to
32, the plain versions' ``operands`` rounding (the 16-bit p, and ds, that
the kernels feed the tensor cores) against the reference's Pallas kernels
in interpret mode, the bound that must pass that rounding and reject a
lost tile, and the backward's one padding for the sm90 dq and dk/dv.
The kernels themselves run on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerances, as in tests/test_torch_flash_sm90_wide.py: rounding p (or ds)
to a 16-bit type moves it by at most u = 2^-8 (bf16) or 2^-11 (fp16) of
itself, and an fp16 p below 2^-14 by at most 2^-25, so o moves by at most
(u |P| + floor) @ |V| / l and dq, dk, dv by the same products with ds
and k, ds and q, p and do (the provable bound
tests/test_torch_flash_sm90.py holds the bf16
forward to at D 64); against the reference, fp32 throughout, the rounding
is the only difference beyond its fp32 bounds (2e-5 forward, 1e-4
gradients).

The narrow forward deals a q tile's kv tiles round-robin among several
consumer warpgroups (``kNarrowSplit`` in csrc/flash_fwd_sm90.cu) and adds
their partial l and O in warpgroup order: ``_split_order`` repeats that
order of fp32 sums in torch (each thread's share of a row's l summed key
by key, the quad's four shares added in pairs, O summed 16 keys at a
time) so that the CPU holds it to the plain forward and the reference;
``_one_warpgroup_order`` is the order before the split, one warpgroup
over every tile.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from horovod_tpu.parallel import flash_attention as ref
from horovod_tpu_torch.parallel import flash_attention as port
from horovod_tpu_torch.utils import tolerance
from tests import torch_refpool
from tests.torch_threads import one_torch_thread  # noqa: F401

FWD_TOL = 2e-5
GRAD_TOL = 1e-4
UNIT = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}
FLOOR = {torch.bfloat16: 0.0, torch.float16: 2.0 ** -25}
SIXTEEN_BIT = (torch.bfloat16, torch.float16)


def _values(seed, dtype, d, n=4, b=1, s=64, h=2):
    """Inputs that are exact values of ``dtype``, held as fp32."""
    rng = np.random.RandomState(seed)
    return [torch.tensor(rng.randn(b, s, h, d).astype(np.float32))
            .to(dtype).float() for _ in range(n)]


def _rounding(x, dtype):
    """The most that rounding ``x`` to ``dtype`` can move each element."""
    return torch.clamp(UNIT[dtype] * x.abs(), min=FLOOR[dtype])


def _jax(*xs):
    return [jnp.asarray(x.numpy()) for x in xs]


def _stats(q, k, v, do):
    o, m, l = port._flash_fwd_plain(q, k, v, True, 0, 0)
    lse = port._lse_from_stats(m, l)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return (o, m, l), (q, k, v, do, lse, delta, True, 0, 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_design_and_padding_at_every_head_dim_up_to_32(dtype):
    """16-bit: all three kernels on sm90 (narrow builds); fp32: all three
    on tf32 (their narrow builds). Every kernel pads D 1-16 to 16 and D
    17-32 to 32, so the backward pads q, k, v and do once for dq and
    dk/dv."""
    want = ("sm90",) * 3 if dtype in SIXTEEN_BIT else ("tf32",) * 3
    for d in range(1, 33):
        designs = tuple(port._design(dtype, d, kern) for kern in port.KERNELS)
        assert designs == want, d
        padded = {port.padded_head_dim(d, design, kern)
                  for design, kern in zip(designs, port.KERNELS)}
        assert padded == {16 if d <= 16 else 32}, d
    # Past 32 dq joins the others on sm90 (16-bit), tf32 takes fp32.
    assert port._design(dtype, 33, "dq") == (
        "sm90" if dtype in SIXTEEN_BIT else "tf32")


@pytest.mark.parametrize("dtype", SIXTEEN_BIT)
@pytest.mark.parametrize("d", [8, 20])
def test_dq_and_dkv_pad_to_one_head_dim(dtype, d):
    """The narrow sm90 dq and dk/dv builds (``SM90_NARROW_DIMS``) agree,
    and with the simt ladder (``HEAD_DIMS``, fp32's), so ``_flash_bwd``
    pads once."""
    dq = port.padded_head_dim(d, port._design(dtype, d, "dq"), "dq")
    dkv = port.padded_head_dim(d, port._design(dtype, d, "dkv"), "dkv")
    assert dq == dkv == (16 if d <= 16 else 32)
    assert port.SM90_NARROW_DIMS == port.HEAD_DIMS[:2]


def _operands_ref(dtype, d, s):
    """A worker's job: the reference's forward output and backward at its
    default blocks on ``test_plain_operands_match_reference``'s values
    and the plain forward's stats."""
    q, k, v, do = _values(d + s, dtype, d, b=2, s=s)
    (o, m, l), _ = _stats(q, k, v, do)
    o_ref = ref.flash_attention_stats(*_jax(q, k, v), causal=True,
                                      interpret=True)[0]
    grads = ref.flash_attention_bwd(*_jax(q, k, v, o, m, l, do),
                                    causal=True, interpret=True)
    return np.asarray(o_ref), [np.asarray(g) for g in grads]


OPERAND_DIMS, OPERAND_LENGTHS = [16, 32], [32, 100]


@pytest.mark.parametrize("dtype", SIXTEEN_BIT)
@pytest.mark.parametrize("d", OPERAND_DIMS)
@pytest.mark.parametrize("s", OPERAND_LENGTHS)
def test_plain_operands_match_reference(dtype, d, s):
    """The plain forward, dq and dk/dv with 16-bit operand rounding, at
    the entry's S 32 and a ragged S 100 (a full 64-row tile and a ragged
    one), against the reference's forward and backward at its default
    blocks (one block below 128) on the same values: within the provable
    bound of the rounding beyond the reference's fp32 bounds; and the
    rounding itself within that bound of the fp32 plain versions."""
    q, k, v, do = _values(d + s, dtype, d, b=2, s=s)
    (o, m, l), args = _stats(q, k, v, do)
    o_ref, (dq_ref, dk_ref, dv_ref) = torch_refpool.result(
        (__name__, "operands", dtype, d, s))
    o_r, m_r, l_r = port._flash_fwd_plain(q, k, v, True, 0, 0,
                                          operands=dtype)
    assert torch.equal(m, m_r) and torch.equal(l, l_r)
    sc, allowed = port._scores(q, k, True, 0, 0)
    p = torch.exp(sc - m[..., None]) * allowed
    moved = torch.einsum("bhqk,bkhd->bqhd", _rounding(p, dtype) * allowed,
                         v.abs()) / l.transpose(1, 2)[..., None]
    assert torch.all((o_r - o).abs() <= moved + 1e-6)
    assert (o_r - o).abs().max() > 0
    err = (o_r - torch.tensor(np.asarray(o_ref))).abs()
    assert torch.all(err <= moved + FWD_TOL), err.max()

    dq = port._flash_dq_plain(*args)
    dq_r = port._flash_dq_plain(*args, operands=dtype)
    dk, dv = port._flash_dkv_plain(*args)
    dk_r, dv_r = port._flash_dkv_plain(*args, operands=dtype)
    p, ds = port._p_ds_plain(*args)
    lim_q = torch.einsum("bhqk,bkhd->bqhd", _rounding(ds, dtype), k.abs())
    lim_v = torch.einsum("bhqk,bqhd->bkhd", _rounding(p, dtype), do.abs())
    lim_k = torch.einsum("bhqk,bqhd->bkhd", _rounding(ds, dtype), q.abs())
    assert (dq_r - dq).abs().max() > 0
    for mine, fp32, theirs, lim in ((dq_r, dq, dq_ref, lim_q),
                                    (dk_r, dk, dk_ref, lim_k),
                                    (dv_r, dv, dv_ref, lim_v)):
        assert torch.all((mine - fp32).abs() <= lim + 1e-6)
        err = (mine - torch.tensor(np.asarray(theirs))).abs()
        assert torch.all(err <= lim + GRAD_TOL), err.max()


@pytest.mark.parametrize("dtype", SIXTEEN_BIT)
@pytest.mark.parametrize("d", [16, 32])
def test_tolerance_passes_rounding_and_rejects_lost_tiles(dtype, d):
    """The bound chip_smoke.py holds the narrow kernels to passes the
    16-bit operand rounding alone (the plain version that rounds where
    the kernels do, in the inputs' type) and rejects, by more than
    LOST_NARROW_BY times, the forward and dq without one 64-key stage and
    dk and dv without one 64-query tile: what a wrong swizzle or tile
    offset would lose."""
    q, k, v, do = (x.to(dtype) for x in _values(d + 7, dtype, d, s=256))
    step = tolerance.step_of(dtype)
    o = port._flash_fwd_plain(q, k, v, True, 0, 0)[0]
    o_b = port._flash_fwd_plain(q, k, v, True, 0, 0, operands=dtype)[0]
    kw = dict(step=step, plain_b=o_b)
    assert tolerance.worst(o_b, o, FWD_TOL, **kw)[1] <= 1.0
    lost = chip_smoke.fwd_without_keys(port, q, k, v, 128, 192)
    by = chip_smoke.LOST_NARROW_BY
    assert tolerance.worst(lost, o, FWD_TOL, **kw)[1] > by

    _, args = _stats(q, k, v, do)
    dq = port._flash_dq_plain(*args)
    kw = dict(step=step, atol=tolerance.DQ_ATOL,
              plain_b=port._flash_dq_plain(*args, operands=dtype))
    assert tolerance.worst(kw["plain_b"], dq, GRAD_TOL, **kw)[1] <= 1.0
    lost = chip_smoke.dq_without_keys(port, *args[:6], 128, 192)
    assert tolerance.worst(lost, dq, GRAD_TOL, **kw)[1] > by

    plain = port._flash_dkv_plain(*args)
    plain_b = port._flash_dkv_plain(*args, operands=dtype)
    do_x, delta_x = do.clone(), args[5].clone()
    do_x[:, 128:192] = 0
    delta_x[:, :, 128:192] = 0
    lost = port._flash_dkv_plain(q, k, v, do_x, args[4], delta_x, True, 0, 0)
    for mine, p, pb in zip(lost, plain, plain_b):
        kw = dict(step=step, plain_b=pb)
        assert tolerance.worst(pb, p, GRAD_TOL, **kw)[1] <= 1.0
        assert tolerance.worst(mine, p, GRAD_TOL, **kw)[1] > by


@pytest.mark.parametrize("dtype", SIXTEEN_BIT)
def test_backward_at_d24_pads_once_for_the_sm90_dq_and_dkv(dtype):
    """``_flash_bwd`` at D 24 with the plain versions in the kernels'
    place: dq and dk/dv (both sm90) run at 32 on the same padded tensors,
    padded once, and give bit for bit what padding for each apart gives,
    and the unpadded plain versions up to the fp32 order of the zero
    columns."""
    d = 24
    q, k, v, do = (x.to(dtype) for x in _values(d + 5, dtype, d, s=64))
    _, args = _stats(q, k, v, do)
    plains = {"dq": port._flash_dq_plain, "dkv": port._flash_dkv_plain}
    seen = []

    def recording(kern, fn):
        def run(*a, **kw):
            seen.append((kern, a[:4]))
            return fn(*a, **kw)
        return run
    launchers = {(kern, design): recording((kern, design), fn)
                 for kern, fn in plains.items()
                 for design in ("sm90", "simt")}
    dq, (dk, dv) = port._flash_bwd(*args, launchers=launchers)
    assert [kern for kern, _ in seen] == [("dq", "sm90"), ("dkv", "sm90")]
    (_, a), (_, b) = seen
    assert all(x is y for x, y in zip(a, b)) and a[0].shape[-1] == 32
    apart = [port._on_padded_head_dim(fn, args[:4], *args[4:],
                                      design=port._design(dtype, d, kern),
                                      kernel=kern)
             for kern, fn in plains.items()]
    unpadded = (port._flash_dq_plain(*args), *port._flash_dkv_plain(*args))
    for mine, theirs, exact in zip((dq, dk, dv), (apart[0], *apart[1]),
                                   unpadded):
        assert mine.shape == q.shape and mine.dtype == dtype
        assert torch.equal(mine, theirs)
        np.testing.assert_allclose(mine.float().numpy(),
                                   exact.float().numpy(), rtol=1e-6,
                                   atol=tolerance.step_of(dtype))


def test_narrow_launchers_take_only_cuda_tensors_of_their_head_dims():
    q = torch.zeros(1, 64, 2, 16, dtype=torch.bfloat16)
    st = torch.zeros(1, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        port._flash_fwd_sm90(q, q, q, True, 0, 0)
    with pytest.raises(ValueError, match="CUDA"):
        port._flash_dq_sm90(q, q, q, q, st, st, True, 0, 0)
    with pytest.raises(ValueError, match="CUDA"):
        port._flash_dkv_sm90(q, q, q, q, st, st, True, 0, 0)
    for kern in port.KERNELS:
        assert port.SM90_KERNEL_DIMS[kern][:2] == (16, 32)


LOG2E = 1.4426950408889634
NEG_INF = -1e30
# The keys of the narrow forward's kv stage (kNarrowKv), and a 16-key tile
# that no build takes, so that S 100 and 127 deal seven or eight tiles
# among the warpgroups.
NARROW_KV = 64
SPLIT_CASES = [
    # sq, sk, causal, q_offset, k_offset
    pytest.param(100, 100, True, 16, 0, id="causal_s100_q_offset"),
    pytest.param(100, 100, True, 0, 40, id="causal_s100_dead_rows"),
    pytest.param(100, 127, False, 0, 0, id="noncausal_s100_sk127"),
    pytest.param(100, 127, True, 27, 0, id="causal_s100_sk127"),
]


def _softmax_parts(q, k, v, causal, qo, ko, kv):
    """What both orders start from: m (the rows' final max, -1e30 where a
    row sees no key), p = 2^(s log2 e - m log2 e) with masked entries at
    -inf (so p is exactly 0 there), zero-padded to whole kv tiles, p in
    the inputs' type, and v zero-padded alike, [B, H, Sk, D]."""
    s, allowed = port._scores(q, k, causal, qo, ko)
    if allowed is not None:
        s = s.masked_fill(~allowed, float("-inf"))
    m = s.amax(dim=-1).clamp(min=NEG_INF)
    p = torch.exp2(s * LOG2E - (m * LOG2E)[..., None])
    pad = -k.shape[1] % kv
    p = F.pad(p, (0, pad))
    vv = F.pad(v.float().transpose(1, 2), (0, 0, 0, pad))
    return m, p, p.to(q.dtype).float(), vv


def _thread_sums(p, keys, lc):
    """The four quad threads' shares of each row's l, ``lc``, summed on
    over ``keys`` (a range of whole 8-key groups) key by key in the
    kernel's order: thread c takes keys 8 g + 2 c and 8 g + 2 c + 1 of
    each group g."""
    for g in range(keys.start // 8, keys.stop // 8):
        pairs = p[..., 8 * g:8 * g + 8].reshape(lc.shape + (2,))
        for e in range(2):
            lc = lc + pairs[..., e]
    return lc


def _quad(lc):
    return (lc[..., 0] + lc[..., 1]) + (lc[..., 2] + lc[..., 3])


def _steps(pr, vv, keys, o):
    """O summed on over ``keys`` 16 at a time, a k16 product a step."""
    for k0 in range(keys.start, keys.stop, 16):
        o = o + pr[..., k0:k0 + 16] @ vv[:, :, k0:k0 + 16]
    return o


def _finish(o, l, dtype):
    inv = 1.0 / torch.where(l == 0.0, torch.ones_like(l), l)
    return (o * inv[..., None]).transpose(1, 2).to(dtype)


def _split_order(q, k, v, causal, qo, ko, split, kv=NARROW_KV, parts=None):
    """(o, m, l) as the narrow forward sums them with ``split`` consumer
    warpgroups on ``kv``-key tiles: warpgroup w takes tiles w, w + split,
    ... in order, sums its threads' shares of l and its O over them, and
    the warpgroups' quad-summed l and O are added in the order w = 0, 1,
    ... (tiles past the causal reach, which the kernel skips, add exact
    zeros here). ``parts``: ``_softmax_parts(..., kv)``, where the caller
    has them (they do not depend on the split)."""
    m, p, pr, vv = (_softmax_parts(q, k, v, causal, qo, ko, kv)
                    if parts is None else parts)
    l = o = None
    for w in range(split):
        lc = torch.zeros(p.shape[:-1] + (4,))
        ow = torch.zeros(p.shape[:-1] + (q.shape[-1],))
        for j in range(w, p.shape[-1] // kv, split):
            keys = range(j * kv, (j + 1) * kv)
            lc = _thread_sums(p, keys, lc)
            ow = _steps(pr, vv, keys, ow)
        lw = _quad(lc)
        l, o = (lw, ow) if w == 0 else (l + lw, o + ow)
    return _finish(o, l, q.dtype), m, l


def _one_warpgroup_order(q, k, v, causal, qo, ko, parts=None):
    """(o, m, l) in the order before the split: one warpgroup, every key
    in turn. ``parts``: ``_softmax_parts(..., 16)``, where the caller has
    them."""
    m, p, pr, vv = (_softmax_parts(q, k, v, causal, qo, ko, 16)
                    if parts is None else parts)
    keys = range(0, p.shape[-1])
    l = _quad(_thread_sums(p, keys, torch.zeros(p.shape[:-1] + (4,))))
    o = _steps(pr, vv, keys, torch.zeros(p.shape[:-1] + (q.shape[-1],)))
    return _finish(o, l, q.dtype), m, l


def _split_inputs(dtype, d, sq, sk):
    # The shapes of the reference calls above and in
    # tests/test_torch_flash_attention.py.
    b = 2 if sq == sk else 1
    rng = np.random.RandomState(sq + sk + d)
    return [torch.tensor(rng.randn(b, n, 2, d).astype(np.float32))
            .to(dtype) for n in (sq, sk, sk)]


def _split_ref(dtype, d, sq, sk, causal, qo, ko):
    """A worker's job: the reference's (o, m, l) on ``_split_inputs``.
    The reference runs causal throughout (one compilation a shape): a q
    offset of Sk lets every row see every key, as without the mask."""
    q, k, v = _split_inputs(dtype, d, sq, sk)
    return [np.asarray(x) for x in ref.flash_attention_stats(
        *_jax(q.float(), k.float(), v.float()), causal=True,
        q_offset=qo if causal else sk, k_offset=ko if causal else 0,
        interpret=True)]


def _jobs():
    """Every reference result the module's tests read, as
    ``torch_refpool`` jobs."""
    jobs = [((__name__, "operands", t, d, s), _operands_ref, (t, d, s))
            for s in OPERAND_LENGTHS for d in OPERAND_DIMS
            for t in SIXTEEN_BIT]
    jobs += [((__name__, "split", t, d, *c.values), _split_ref,
              (t, d, *c.values))
             for c in SPLIT_CASES for d in (16, 32) for t in SIXTEEN_BIT]
    return jobs


torch_refpool.register(_jobs)


@pytest.fixture(autouse=True, scope="module")
def _references():
    torch_refpool.start()


@pytest.mark.parametrize("dtype", SIXTEEN_BIT)
@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("sq,sk,causal,qo,ko", SPLIT_CASES)
def test_split_order_matches_plain_and_reference(dtype, d, sq, sk, causal,
                                                 qo, ko):
    """The narrow forward's order of sums with 1, 2 and 4 warpgroups (its
    64-key tiles, and 16-key ones that deal seven or eight tiles) against
    the plain forward, within the bound chip_smoke.py holds the kernel to
    (m bit for bit, l within 2e-5), and against the reference's forward
    in interpret mode within the provable bound of the 16-bit p beyond
    its fp32 bound; one warpgroup gives the bits of the order before the
    split."""
    q, k, v = _split_inputs(dtype, d, sq, sk)
    o_p, m_p, l_p = port._flash_fwd_plain(q, k, v, causal, qo, ko)
    o_b = port._flash_fwd_plain(q, k, v, causal, qo, ko, operands=dtype)[0]
    o_r, m_r, l_r = (torch.tensor(x) for x in torch_refpool.result(
        (__name__, "split", dtype, d, sq, sk, causal, qo, ko)))
    sc, allowed = port._scores(q, k, causal, qo, ko)
    p = torch.exp(sc - m_p[..., None])
    if allowed is not None:
        p = p * allowed
    moved = torch.einsum("bhqk,bkhd->bqhd", _rounding(p, dtype),
                         v.float().abs()) / torch.where(
        l_p == 0, torch.ones_like(l_p), l_p).transpose(1, 2)[..., None]
    step = tolerance.step_of(dtype)
    parts = {kv: _softmax_parts(q, k, v, causal, qo, ko, kv)
             for kv in (NARROW_KV, 16)}
    before = _one_warpgroup_order(q, k, v, causal, qo, ko, parts[16])
    for kv in (NARROW_KV, 16):
        for split in (1, 2, 4):
            o, m, l = _split_order(q, k, v, causal, qo, ko, split, kv,
                                   parts[kv])
            if split == 1:
                for a, b in zip((o, m, l), before):
                    assert torch.equal(a, b)
            assert torch.equal(m, m_p)
            assert tolerance.worst(l, l_p, 2e-5, rows=False)[1] <= 1.0
            assert tolerance.worst(o, o_p, FWD_TOL, step=step,
                                   plain_b=o_b)[1] <= 1.0
            err = (o.float() - o_r).abs()
            assert torch.all(err <= moved + FWD_TOL + step * o_r.abs()), (
                kv, split, err.max())
            np.testing.assert_allclose(l.numpy(), l_r.numpy(), rtol=2e-5,
                                       atol=1e-6)
            np.testing.assert_allclose(m.numpy(), m_r.numpy(), rtol=2e-5,
                                       atol=1e-5)


def test_last_warpgroup_tile_of_chip_smoke_follows_the_kernel():
    """chip_smoke.py's must-fail case for the narrow forward's combine
    leaves out one whole kv tile that the last consumer warpgroup takes,
    at the constants csrc/flash_fwd_sm90.cu sets (kv tile j goes to
    warpgroup j % kNarrowSplit)."""
    import os
    import re
    from horovod_tpu_torch import _cuda
    with open(os.path.join(_cuda.CSRC_DIR, "flash_fwd_sm90.cu")) as fh:
        src = fh.read()
    split, kv = (int(re.search(rf"constexpr int {name} = (\d+);",
                               src).group(1))
                 for name in ("kNarrowSplit", "kNarrowKv"))
    assert kv == NARROW_KV
    lo, hi = chip_smoke.NARROW_LAST_WARPGROUP_KEYS
    assert hi - lo == kv and lo % kv == 0 and hi <= chip_smoke.C4_SHAPE["s"]
    assert (lo // kv) % split == split - 1 and split > 1
    for tag in ("bf16_d16", "bf16_d32"):
        assert chip_smoke.LOST_C4[tag]["fwd_last_warpgroup"] == (lo, hi)
