"""The CPU side of the stream dk/dv (bf16 and fp16 dk/dv past head dim
256, csrc/flash_dkv_stream_sm90.cu) and of the sm90 forward on the
caller's tensors at head dims between its builds (csrc/flash_fwd_sm90.cu;
which head dims each sm90 kernel reads in place):
the plain dk/dv with 16-bit operands, which the card holds the stream dk/dv
to, against the reference's ``_bwd_dkv_kernel`` at D 320; which tensors the
forward's launcher is given (the caller's own at every multiple of 8 past
32, copies padded to the next build elsewhere) and, at D 96, its result
against the reference's forward; and the shared bound
(horovod_tpu_torch/utils/tolerance.py), which must pass the 16-bit
rounding and reject each way these kernels could lose work. The
reference runs its Pallas kernels in interpret mode with blocks of 32, as
tests/test_torch_flash_sm90_wide.py runs them. The kernels themselves run
on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances. Rounding p and ds to a 16-bit type moves each by at most u =
2^-8 (bf16) or 2^-11 (fp16) of itself, and an fp16 value below 2^-14 by at
most 2^-25; so dv moves by at most that of p times |do| summed over the
queries and dk by that of ds times |q|: the provable bounds of
tests/test_torch_flash_sm90_wide.py. Against the reference (fp32
throughout) that rounding is the only difference beyond the fp32 bounds
of tests/test_parallel.py (2e-5 forward, 1e-4 gradients); a bf16 o is
rounded once more on output, by at most 2^-8 of itself.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
# 16-bit head dims the sm90 forward reads in place (the Phi-2 and
# Phi-3-mini widths 80 and 96 among them), and two it must pad: 20 (a
# narrow build) and 260 (a row of 520 bytes, no TMA stride).
IN_PLACE = (80, 96, 200, 320)
PADDED = {20: 32, 260: 384}


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


def _bwd_args(q, k, v, do):
    o, m, l = port._flash_fwd_plain(q, k, v, True, 0, 0)
    lse = port._lse_from_stats(m, l)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return (o, m, l), (q, k, v, do, lse, delta, True, 0, 0)


def _dkv_ref():
    """A worker's job: the reference's dk and dv at bf16 D 320 on the
    values and plain forward stats of ``test_plain_dkv_bf16_operands_at_
    d320_match_reference``."""
    q, k, v, do = _values(14, torch.bfloat16, 320)
    (o, m, l), _ = _bwd_args(q, k, v, do)
    _, dk_ref, dv_ref = ref.flash_attention_bwd(
        *_jax(q, k, v, o, m, l, do), causal=True, block_q=32, block_k=32,
        interpret=True)
    return np.asarray(dk_ref), np.asarray(dv_ref)


def _fwd_ref():
    """A worker's job: the reference's forward stats on the values of
    ``test_sm90_forward_in_place_at_d96_matches_reference``."""
    vals = _values(96, torch.bfloat16, 96, n=3, s=64)
    return [np.asarray(x) for x in ref.flash_attention_stats(
        *_jax(*vals), causal=True, block_q=32, block_k=32, interpret=True)]


def _jobs():
    """Every reference result the module's tests read, as
    ``torch_refpool`` jobs."""
    return [((__name__, "dkv"), _dkv_ref, ()),
            ((__name__, "fwd"), _fwd_ref, ())]

torch_refpool.register(_jobs)


@pytest.fixture(autouse=True, scope="module")
def _references():
    torch_refpool.start()


def test_plain_dkv_bf16_operands_at_d320_match_reference():
    """The stream dk/dv's plain version (bf16 p and ds for the tensor
    cores, ds from the unrounded p) against the reference's dk/dv on the
    same values at D 320, where the stream design serves dk/dv."""
    dtype = torch.bfloat16
    q, k, v, do = _values(14, dtype, 320)
    (o, m, l), args = _bwd_args(q, k, v, do)
    dk_ref, dv_ref = torch_refpool.result((__name__, "dkv"))
    assert port._design(dtype, 320, "dkv") == "stream"
    dk_r, dv_r = port._flash_dkv_plain(*args, operands=dtype)
    p, ds = port._p_ds_plain(*args)
    lim_v = torch.einsum("bhqk,bqhd->bkhd", _rounding(p, dtype), do.abs())
    lim_k = torch.einsum("bhqk,bqhd->bkhd", _rounding(ds, dtype), q.abs())
    for mine, theirs, lim in ((dk_r, dk_ref, lim_k), (dv_r, dv_ref, lim_v)):
        err = (mine - torch.tensor(np.asarray(theirs))).abs()
        assert torch.all(err <= lim + GRAD_TOL), err.max()
    assert (dv_r - port._flash_dkv_plain(*args)[1]).abs().max() > 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_tolerance_passes_operands_and_fails_a_lost_q_tile_or_region(dtype):
    """The stream dk/dv's ways to lose work at D 320: one 64-query tile
    (do and delta zeroed there, which leaves it out of dk and dv
    exactly), or one 64-column region of the sums over D for s (q and k
    zeroed there for s alone); the bound passes the 16-bit p and ds
    rounding and rejects both, in dk and in dv."""
    _, args = _bwd_args(*_values(5, dtype, 320, s=256))
    q, k, v, do, lse, delta = args[:6]
    plain = port._flash_dkv_plain(*args)
    rounded = port._flash_dkv_plain(*args, operands=dtype)
    do_x, delta_x = do.clone(), delta.clone()
    do_x[:, 128:192] = 0
    delta_x[:, :, 128:192] = 0
    tile = port._flash_dkv_plain(q, k, v, do_x, lse, delta_x, True, 0, 0)
    region = chip_smoke.bwd_without_columns(port, *args[:6], 64, 128)[1:]
    for i in range(2):
        kw = dict(step=tolerance.step_of(dtype), plain_b=rounded[i])
        assert tolerance.worst(rounded[i], plain[i], GRAD_TOL, **kw)[1] <= 1
        for lost in (tile[i], region[i]):
            assert tolerance.worst(lost, plain[i], GRAD_TOL, **kw)[1] > 1


@pytest.mark.parametrize("kern,widest", [("fwd", 512), ("dq", 256),
                                          ("dkv", 256)])
def test_sm90_kernels_read_in_place_at_multiples_of_8(kern, widest):
    """Each sm90 kernel past its narrow builds takes any 16-bit head dim
    whose row is a multiple of 16 bytes as it is, up to its widest build
    (512 for the forward, 256 for dq and dk/dv); no other design does,
    and every other head dim pads."""
    for d in range(1, 700):
        want = d % 8 == 0 and 32 < d <= widest
        assert port._reads_in_place(d, "sm90", kern) == want, d
        for design in ("stream", "tf32", "simt"):
            assert not port._reads_in_place(d, design, kern)


def _recording_forward(monkeypatch):
    """The sm90 forward's launcher replaced by its plain version, which
    records the tensors and the result of each call."""
    calls = []

    def launcher(q, k, v, *args, **kw):
        out = port._flash_fwd_plain(q, k, v, *args, **kw)
        calls.append(((q, k, v), out))
        return out
    monkeypatch.setitem(port._LAUNCHERS, ("fwd", "sm90"), launcher)
    return calls


@pytest.mark.parametrize("d", IN_PLACE)
def test_sm90_forward_gets_the_callers_tensors_between_builds(d,
                                                              monkeypatch):
    """At 16-bit D 80, 96, 200 and 320 the forward's launcher is given q,
    k and v themselves (no pad) and its o is the result (no slice)."""
    calls = _recording_forward(monkeypatch)
    qkv = tuple(x.to(torch.bfloat16) for x in _values(d, torch.bfloat16, d,
                                                       n=3, s=32))
    assert port._design(torch.bfloat16, d, "fwd") == "sm90"
    o, m, l = port._launch("fwd", "sm90", qkv, True, 0, 0)
    (seen, out), = calls
    assert all(a is b for a, b in zip(seen, qkv))
    assert o is out[0] and o.shape == qkv[0].shape


@pytest.mark.parametrize("d", sorted(PADDED))
def test_sm90_forward_pads_where_a_row_is_no_tma_stride(d, monkeypatch):
    """At D 20 (a narrow build's) and 260 (a row of 520 bytes, which TMA
    cannot stride) the launcher is given copies padded to the build,
    and the result is cut back to d."""
    calls = _recording_forward(monkeypatch)
    qkv = tuple(x.to(torch.bfloat16) for x in _values(d, torch.bfloat16, d,
                                                       n=3, s=32))
    o, _, _ = port._launch("fwd", "sm90", qkv, True, 0, 0)
    (seen, _), = calls
    assert [t.shape[-1] for t in seen] == [PADDED[d]] * 3
    assert not any(a is b for a, b in zip(seen, qkv))
    assert o.shape == qkv[0].shape


def test_sm90_forward_in_place_at_d96_matches_reference(monkeypatch):
    """Phi-3-mini's head dim through the in-place path, with the plain
    version in the kernel's place, against the reference's forward on
    the same values: o within the fp32 bound and its bf16 rounding, m and
    l within the fp32 bound (the scale is 1/sqrt(96), not the build's)."""
    _recording_forward(monkeypatch)
    vals = _values(96, torch.bfloat16, 96, n=3, s=64)
    o, m, l = port._launch("fwd", "sm90",
                           tuple(x.to(torch.bfloat16) for x in vals), True,
                           0, 0)
    o_ref, m_ref, l_ref = torch_refpool.result((__name__, "fwd"))
    np.testing.assert_allclose(o.float().numpy(), np.asarray(o_ref),
                               atol=FWD_TOL, rtol=UNIT[torch.bfloat16])
    for mine, theirs in ((m, m_ref), (l, l_ref)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                   atol=FWD_TOL, rtol=FWD_TOL)


def test_tolerance_fails_the_in_place_forwards_lost_box_or_wrong_scale():
    """The in-place forward's ways to go wrong at D 96: the region that
    straddles d (columns 64-95 of q and k) read as zeros, or the build's
    scale, 1/sqrt(128), in place of 1/sqrt(96); the bound passes the bf16
    p rounding and rejects both."""
    dtype = torch.bfloat16
    q, k, v = _values(7, dtype, 96, n=3, s=256)
    plain = port._flash_fwd_plain(q, k, v, True, 0, 0)[0]
    rounded = port._flash_fwd_plain(q, k, v, True, 0, 0, operands=dtype)[0]
    kw = dict(step=tolerance.step_of(dtype), plain_b=rounded)
    assert tolerance.worst(rounded, plain, FWD_TOL, **kw)[1] <= 1.0
    lost = chip_smoke.fwd_without_columns(port, q, k, v, 64, 96)
    scaled = port._flash_fwd_plain(q, k, v, True, 0, 0,
                                   scale=port._softmax_scale(128))[0]
    for wrong in (lost, scaled):
        assert tolerance.worst(wrong, plain, FWD_TOL, **kw)[1] > 1.0
