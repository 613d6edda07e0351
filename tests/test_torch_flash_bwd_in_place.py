"""The CPU side of the sm90 dq and dk/dv on the caller's tensors at head
dims between their builds (csrc/flash_dq_sm90.cu, csrc/flash_dkv_sm90.cu):
which tensors ``_flash_bwd`` gives the two launchers (the caller's own at
16-bit D 80, 96 and 200, one padded copy for both at D 20 and 260), the
in-place route at Phi-3-mini's D 96 with the plain versions in the
kernels' place against the reference's backward, and the shared bound
(horovod_tpu_torch/utils/tolerance.py), which must pass the 16-bit
rounding and reject each way an in-place backward could go wrong: the
box that straddles d read as zeros, or the build's scale taken for the
true head dim's. The reference runs its Pallas kernels in interpret mode
with blocks of 32, as tests/test_torch_flash_dkv_stream.py runs them. The
kernels themselves run on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerances. Rounding p and ds to bf16 moves each by at most u = 2^-8 of
itself, so dv moves by at most u |p| |do| summed over the queries, dk by
u |ds| |q| and dq by u |ds| |k| summed over the keys (the bounds of
tests/test_torch_flash_dkv_stream.py); a bf16 output is rounded once
more, by at most u of itself. Against the reference (fp32 throughout)
those roundings are the only difference beyond the fp32 bound of
tests/test_parallel.py (1e-4 for gradients).
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

GRAD_TOL = 1e-4
UNIT = 2.0 ** -8   # bf16's rounding, relative
# 16-bit head dims both sm90 backward kernels read in place (Phi-2's 80,
# Phi-3-mini's 96, and 200 on the D 256 builds, dk/dv's wide one), and
# two where they pad, to one copy for both: 20 (the narrow build of 32)
# and 260 (a row of 520 bytes, no TMA stride: the stream design at 320).
IN_PLACE = (80, 96, 200)
PADDED = {20: 32, 260: 320}
PLAINS = {"dq": port._flash_dq_plain, "dkv": port._flash_dkv_plain}


def _values(seed, d, n=4, b=1, s=64, h=2):
    """bf16 inputs, made with numpy."""
    rng = np.random.RandomState(seed)
    return [torch.tensor(rng.randn(b, s, h, d).astype(np.float32))
            .to(torch.bfloat16) for _ in range(n)]


def _bwd_args(q, k, v, do):
    """The forward's stats (fp32 plain version) and ``_flash_bwd``'s
    arguments: q, k, v, do as given, lse and delta fp32 [B, H, Sq]."""
    o, m, l = port._flash_fwd_plain(q, k, v, True, 0, 0)
    lse = port._lse_from_stats(m, l)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return (o, m, l), (q, k, v, do, lse, delta, True, 0, 0)


def _recording(seen, operands=None):
    """Every (kernel, design)'s launcher replaced by the plain version,
    which records the tensors it was given (``seen[kernel]``)."""
    def launcher(kern):
        def run(*a, **kw):
            seen[kern] = a[:4]
            return PLAINS[kern](*a, operands=operands, **kw)
        return run
    return {(kern, design): launcher(kern) for kern in PLAINS
            for design in ("sm90", "stream", "tf32", "simt")}


@pytest.mark.parametrize("d", IN_PLACE)
def test_backward_gives_both_kernels_the_callers_tensors(d):
    """At 16-bit D 80, 96 and 200 ``_flash_bwd`` gives dq and dk/dv (both
    sm90) q, k, v and do themselves (no pad), and their results are the
    gradients (no slice)."""
    _, args = _bwd_args(*_values(d, d))
    for kern in PLAINS:
        assert port._design(torch.bfloat16, d, kern) == "sm90"
        assert port.padded_head_dim(d, "sm90", kern) > d
    seen = {}
    dq, (dk, dv) = port._flash_bwd(*args, launchers=_recording(seen))
    for kern in PLAINS:
        assert all(a is b for a, b in zip(seen[kern], args[:4]))
    assert dq.shape == dk.shape == dv.shape == args[0].shape


@pytest.mark.parametrize("d", sorted(PADDED))
def test_backward_pads_once_where_a_kernel_cannot_read_in_place(d):
    """At D 20 (the narrow builds) and 260 (no TMA stride; the stream
    design at 320) both launchers get one and the same copy padded to
    the build, and the gradients are cut back to d."""
    _, args = _bwd_args(*_values(d, d))
    seen = {}
    dq, (dk, dv) = port._flash_bwd(*args, launchers=_recording(seen))
    assert all(a is b for a, b in zip(seen["dq"], seen["dkv"]))
    assert [t.shape[-1] for t in seen["dq"]] == [PADDED[d]] * 4
    assert not any(a is b for a, b in zip(seen["dq"], args[:4]))
    assert dq.shape == dk.shape == dv.shape == args[0].shape


def _d96_ref():
    """A worker's job: the reference's backward (fp32) on the values and
    plain forward stats of ``test_in_place_backward_at_d96_matches_
    reference``."""
    q, k, v, do = _values(96, 96)
    (o, m, l), _ = _bwd_args(q, k, v, do)
    jax_args = [jnp.asarray(x.float().numpy()) for x in (q, k, v, o, m, l, do)]
    return [torch.tensor(np.asarray(x)) for x in ref.flash_attention_bwd(
        *jax_args, causal=True, block_q=32, block_k=32, interpret=True)]


def _jobs():
    """The reference result the module's tests read, as a
    ``torch_refpool`` job."""
    return [((__name__, "d96"), _d96_ref, ())]

torch_refpool.register(_jobs)


@pytest.fixture(autouse=True, scope="module")
def _references():
    torch_refpool.start()


def test_in_place_backward_at_d96_matches_reference():
    """Phi-3-mini's head dim through the in-place route, with the plain
    versions (bf16 p and ds, as the kernels round them) in the kernels'
    place, against the reference's backward on the same values: dq, dk
    and dv within the fp32 bound, the operands' bf16 rounding and that of
    the bf16 outputs (the scale is 1/sqrt(96), not the build's)."""
    q, k, v, do = _values(96, 96)
    (o, m, l), args = _bwd_args(q, k, v, do)
    dq, (dk, dv) = port._flash_bwd(
        *args, launchers=_recording({}, operands=torch.bfloat16))
    refs = torch_refpool.result((__name__, "d96"))
    p, ds = port._p_ds_plain(*args)
    ds_u, p_u = UNIT * ds.abs(), UNIT * p.abs()
    lims = (torch.einsum("bhqk,bkhd->bqhd", ds_u, k.float().abs()),
            torch.einsum("bhqk,bqhd->bkhd", ds_u, q.float().abs()),
            torch.einsum("bhqk,bqhd->bkhd", p_u, do.float().abs()))
    for mine, theirs, lim in zip((dq, dk, dv), refs, lims):
        assert mine.dtype == torch.bfloat16 and mine.shape == q.shape
        err = (mine.float() - theirs).abs()
        assert torch.all(err <= lim + GRAD_TOL + UNIT * theirs.abs()), \
            err.max()


@pytest.mark.parametrize("d,columns,scale", [(96, (64, 96), 128),
                                             (200, (192, 200), None)])
def test_tolerance_fails_the_in_place_backwards_lost_box_or_wrong_scale(
        d, columns, scale):
    """The in-place backward's ways to go wrong: the part of the box that
    straddles d (columns 64-95 at D 96, 192-199 at D 200) left out of the
    logits of dq, dk and dv, or at D 96 the build's scale, 1/sqrt(128),
    in place of 1/sqrt(96); the bound (as chip_smoke.py holds the sm90
    dq and dk/dv to it) passes the bf16 p and ds rounding and rejects
    each, in every gradient."""
    dtype = torch.bfloat16
    _, args = _bwd_args(*(x.float() for x in _values(d + 1, d, s=128)))
    plain = (port._flash_dq_plain(*args), *port._flash_dkv_plain(*args))
    rounded = (port._flash_dq_plain(*args, operands=dtype),
               *port._flash_dkv_plain(*args, operands=dtype))
    wrong = [chip_smoke.bwd_without_columns(port, *args[:6], *columns)]
    if scale:
        sc = port._softmax_scale(scale)
        wrong.append((port._flash_dq_plain(*args, scale=sc),
                      *port._flash_dkv_plain(*args, scale=sc)))
    for i, atol in enumerate((tolerance.DQ_ATOL, 1e-6, 1e-6)):
        kw = dict(atol=atol, step=tolerance.step_of(dtype),
                  plain_b=rounded[i])
        assert tolerance.worst(rounded[i], plain[i], GRAD_TOL, **kw)[1] <= 1
        for lost in wrong:
            assert tolerance.worst(lost[i], plain[i], GRAD_TOL, **kw)[1] > 10
