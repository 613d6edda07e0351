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
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from horovod_tpu.parallel import flash_attention as ref
from horovod_tpu_torch.parallel import flash_attention as port
from horovod_tpu_torch.utils import tolerance

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
    on simt. Every kernel pads D 1-16 to 16 and D 17-32 to 32, so the
    backward pads q, k, v and do once for dq and dk/dv."""
    want = ("sm90" if dtype in SIXTEEN_BIT else "simt",) * 3
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


@pytest.mark.parametrize("dtype", SIXTEEN_BIT)
@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("s", [32, 100])
def test_plain_operands_match_reference(dtype, d, s):
    """The plain forward, dq and dk/dv with 16-bit operand rounding, at
    the entry's S 32 and a ragged S 100 (a full 64-row tile and a ragged
    one), against the reference's forward and backward at its default
    blocks (one block below 128) on the same values: within the provable
    bound of the rounding beyond the reference's fp32 bounds; and the
    rounding itself within that bound of the fp32 plain versions."""
    q, k, v, do = _values(d + s, dtype, d, b=2, s=s)
    (o, m, l), args = _stats(q, k, v, do)
    o_r, m_r, l_r = port._flash_fwd_plain(q, k, v, True, 0, 0,
                                          operands=dtype)
    assert torch.equal(m, m_r) and torch.equal(l, l_r)
    sc, allowed = port._scores(q, k, True, 0, 0)
    p = torch.exp(sc - m[..., None]) * allowed
    moved = torch.einsum("bhqk,bkhd->bqhd", _rounding(p, dtype) * allowed,
                         v.abs()) / l.transpose(1, 2)[..., None]
    assert torch.all((o_r - o).abs() <= moved + 1e-6)
    assert (o_r - o).abs().max() > 0
    o_ref = ref.flash_attention_stats(*_jax(q, k, v), causal=True,
                                      interpret=True)[0]
    err = (o_r - torch.tensor(np.asarray(o_ref))).abs()
    assert torch.all(err <= moved + FWD_TOL), err.max()

    dq_ref, dk_ref, dv_ref = ref.flash_attention_bwd(
        *_jax(q, k, v, o, m, l, do), causal=True, interpret=True)
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
