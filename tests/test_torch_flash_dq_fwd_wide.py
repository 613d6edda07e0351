"""The CPU side of the tensor-core dq at fp16 and at head dims up to 256
(sm90) and past it (stream), and of the sm90 forward at head dims
257-512: the plain versions' ``operands`` rounding (16-bit ds for the dq;
bf16 and fp16 p for the forward) that the card's checks compare those
kernels with, its agreement with the reference's dq and forward (Pallas,
interpret mode, blocks of 32, as tests/test_torch_flash_dq_sm90.py and
tests/test_torch_flash_head_dims.py run them), the shared tolerance
(horovod_tpu_torch/utils/tolerance.py), which must pass that rounding and
fail a dq with one 32-key stage (the D 256 kernel's), or at D 320 one
64-key tile or one 64-column region of the logits (the stream dq's),
left out, the stream design's start per kernel, and the backward's
padding of q, k, v and do, once for each head dim its two kernels run
at (none at 16-bit D 320, nor where both sm90 kernels read the caller's
tensors). The kernels themselves run on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Tolerances. Rounding ds (or p) to a 16-bit type moves it by at most u =
2^-8 (bf16) or 2^-11 (fp16) of itself, and an fp16 value below 2^-14
(subnormal) by at most 2^-25; so dq moves by at most (u |dS| + floor) @
|K| and o by (u |P| + floor) @ |V| / l: the provable bounds of
tests/test_torch_flash_sm90_wide.py, plus 1e-6 of fp32 noise. Against the
reference (fp32 throughout) the rounding is the only difference beyond
the fp32 bounds of tests/test_parallel.py (2e-5 forward, 1e-4
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
from tests import torch_refpool
from tests.torch_threads import one_torch_thread  # noqa: F401

FWD_TOL = 2e-5
GRAD_TOL = 1e-4
UNIT = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}
FLOOR = {torch.bfloat16: 0.0, torch.float16: 2.0 ** -25}
WIDE_FORWARD = [(torch.bfloat16, 384), (torch.float16, 384),
                (torch.bfloat16, 512), (torch.float16, 512)]


def _values(seed, dtype, d, n=4, b=1, s=128, h=2):
    """Inputs that are exact values of ``dtype``, held as fp32."""
    rng = np.random.RandomState(seed)
    return [torch.tensor(rng.randn(b, s, h, d).astype(np.float32))
            .to(dtype).float() for _ in range(n)]


def _rounding(x, dtype):
    """The most that rounding ``x`` to ``dtype`` can move each element."""
    return torch.clamp(UNIT[dtype] * x.abs(), min=FLOOR[dtype])


def _jax(*xs):
    return [jnp.asarray(x.numpy()) for x in xs]


def _bwd_args(q, k, v, do, causal=True):
    o, m, l = port._flash_fwd_plain(q, k, v, causal, 0, 0)
    lse = port._lse_from_stats(m, l)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return (o, m, l), (q, k, v, do, lse, delta, causal, 0, 0)


def _dq_limit(args, dtype):
    """The provable effect of rounding ds to ``dtype`` on dq."""
    _, ds = port._p_ds_plain(*args)
    return torch.einsum("bhqk,bkhd->bqhd", _rounding(ds, dtype),
                        args[1].abs()) + 1e-6


@pytest.mark.parametrize("causal", [True, False])
def test_plain_dq_fp16_operands_within_provable_bound(causal):
    _, args = _bwd_args(*_values(0, torch.float16, 256, s=256), causal)
    dq = port._flash_dq_plain(*args)
    dq_h = port._flash_dq_plain(*args, operands=torch.float16)
    assert torch.all((dq_h - dq).abs() <= _dq_limit(args, torch.float16))
    assert (dq_h - dq).abs().max() > 0


@pytest.mark.parametrize("dtype,d", WIDE_FORWARD)
def test_plain_wide_forward_operands_within_provable_bound(dtype, d):
    q, k, v = _values(d, dtype, d, n=3)
    o, m, l = port._flash_fwd_plain(q, k, v, True, 0, 0)
    o_r, m_r, l_r = port._flash_fwd_plain(q, k, v, True, 0, 0,
                                          operands=dtype)
    assert torch.equal(m, m_r) and torch.equal(l, l_r)
    s, allowed = port._scores(q, k, True, 0, 0)
    p = torch.exp(s - m[..., None]) * allowed
    moved = torch.einsum("bhqk,bkhd->bqhd", _rounding(p, dtype) * allowed,
                         v.abs())
    limit = moved / l.transpose(1, 2)[..., None] + 1e-6
    assert torch.all((o_r - o).abs() <= limit)
    assert (o_r - o).abs().max() > 0


def _dq_ref(seed, dtype, d, s):
    """A worker's job: the reference's dq on ``_values(seed, dtype, d,
    s=s)`` and the plain forward's stats, fp32 throughout."""
    (o, m, l), args = _bwd_args(*_values(seed, dtype, d, s=s))
    q, k, v, do = args[:4]
    return np.asarray(ref.flash_attention_bwd(
        *_jax(q, k, v, o, m, l, do), causal=True, block_q=32, block_k=32,
        interpret=True)[0])


def _forward_ref(dtype, d):
    """A worker's job: the reference's forward output on
    ``test_plain_wide_forward_operands_match_reference``'s values."""
    q, k, v = _values(d + 1, dtype, d, n=3)
    return np.asarray(ref.flash_attention_stats(
        *_jax(q, k, v), causal=True, block_q=32, block_k=32,
        interpret=True)[0])


def _jobs():
    """Every reference result the module's tests read, as
    ``torch_refpool`` jobs."""
    dq = [(1, torch.float16, 256, 128), (5, torch.bfloat16, 320, 64)]
    return ([((__name__, "dq", *a), _dq_ref, a) for a in dq]
            + [((__name__, "fwd", t, d), _forward_ref, (t, d))
               for t, d in WIDE_FORWARD])


torch_refpool.register(_jobs)


@pytest.fixture(autouse=True, scope="module")
def _references():
    torch_refpool.start()


def test_plain_fp16_operands_dq_matches_reference():
    """The reference's dq from the same fp16-valued inputs and stats at D
    256, fp32 throughout: the rounding of ds is the only difference,
    inside the provable bound."""
    (o, m, l), args = _bwd_args(*_values(1, torch.float16, 256))
    theirs = torch_refpool.result((__name__, "dq", 1, torch.float16, 256,
                                   128))
    mine = port._flash_dq_plain(*args, operands=torch.float16)
    limit = (_dq_limit(args, torch.float16) + GRAD_TOL).numpy()
    assert np.all(np.abs(mine.numpy() - np.asarray(theirs)) <= limit)


def test_plain_bf16_operands_dq_matches_reference_at_d320():
    """The same at bf16 D 320, the stream dq's narrowest build: the
    reference's dq against the plain dq with bf16 ds, inside the provable
    bound of that rounding."""
    (o, m, l), args = _bwd_args(*_values(5, torch.bfloat16, 320, s=64))
    theirs = torch_refpool.result((__name__, "dq", 5, torch.bfloat16, 320,
                                   64))
    mine = port._flash_dq_plain(*args, operands=torch.bfloat16)
    limit = (_dq_limit(args, torch.bfloat16) + GRAD_TOL).numpy()
    assert np.all(np.abs(mine.numpy() - np.asarray(theirs)) <= limit)
    assert port._design(torch.bfloat16, 320, "dq") == "stream"


@pytest.mark.parametrize("dtype,d", WIDE_FORWARD)
def test_plain_wide_forward_operands_match_reference(dtype, d):
    """The plain forward with 16-bit p against the reference's Pallas
    forward on the same values at D 384 and 512: the rounding of p moves
    o by at most (u + floor * S) max|v|."""
    q, k, v = _values(d + 1, dtype, d, n=3)
    o_ref = torch_refpool.result((__name__, "fwd", dtype, d))
    o_r = port._flash_fwd_plain(q, k, v, True, 0, 0, operands=dtype)[0]
    limit = (UNIT[dtype] + FLOOR[dtype] * q.shape[1]) * v.abs().amax()
    np.testing.assert_allclose(o_r.numpy(), np.asarray(o_ref),
                               atol=limit.item() + FWD_TOL, rtol=0)


def test_tolerance_passes_fp16_operands_and_fails_a_lost_32_key_stage():
    _, args = _bwd_args(*_values(2, torch.float16, 256, s=256))
    dq = port._flash_dq_plain(*args)
    dq_h = port._flash_dq_plain(*args, operands=torch.float16)
    kw = dict(step=tolerance.FP16_STEP, atol=tolerance.DQ_ATOL,
              plain_b=dq_h)
    assert tolerance.worst(dq_h, dq, GRAD_TOL, **kw)[1] <= 1.0
    lost = chip_smoke.dq_without_keys(port, *args[:6], 128, 160)
    assert tolerance.worst(lost, dq, GRAD_TOL, **kw)[1] > 1.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_tolerance_passes_operands_and_fails_a_lost_tile_or_region_at_d320(
        dtype):
    """The stream dq's two ways to lose work: one 64-key tile, or one
    64-column region of the sums over D for s (q and k zeroed there for s
    alone); the bound passes the 16-bit ds rounding and rejects both."""
    _, args = _bwd_args(*_values(3, dtype, 320, s=256))
    dq = port._flash_dq_plain(*args)
    kw = dict(step=tolerance.step_of(dtype), atol=tolerance.DQ_ATOL,
              plain_b=port._flash_dq_plain(*args, operands=dtype))
    assert tolerance.worst(kw["plain_b"], dq, GRAD_TOL, **kw)[1] <= 1.0
    tile = chip_smoke.dq_without_keys(port, *args[:6], 128, 192)
    region = chip_smoke.bwd_without_columns(port, *args[:6], 64, 128)[0]
    for lost in (tile, region):
        assert tolerance.worst(lost, dq, GRAD_TOL, **kw)[1] > 1.0


def test_stream_design_starts_past_each_kernels_sm90_builds():
    """``stream`` serves the forward past 512 and dq and dk/dv past 256
    (where each kernel's sm90 builds end) at every multiple of 64, for
    bf16 and fp16 alike: no 16-bit head dim reaches simt."""
    for d in range(257, 1100, 9):
        for dtype in (torch.bfloat16, torch.float16):
            for kern in ("dq", "dkv"):
                assert port._design(dtype, d, kern) == "stream"
                assert (port.padded_head_dim(d, "stream", kern)
                        == -(-d // 64) * 64)
        if d <= 512:
            assert port._design(torch.float16, d, "fwd") == "sm90"
            with pytest.raises(ValueError, match="forward past head dim "
                                                 "512 and the dq and dk/dv "
                                                 "past head dim 256"):
                port.padded_head_dim(d, "stream", "fwd")
    for kern in ("dq", "dkv"):
        assert port._design(torch.bfloat16, 256, kern) == "sm90"
        with pytest.raises(ValueError, match="dk/dv past head dim 256"):
            port.padded_head_dim(256, "stream", kern)


def test_backward_at_d320_reads_the_callers_tensors():
    """At 16-bit D 320, ``_flash_bwd`` runs dq and dk/dv (both stream, at
    320) on q, k, v and do as they are, with no pad at all, each bit for
    bit what its kernel launched apart gives."""
    q, k, v, do = (x.to(torch.bfloat16)
                   for x in _values(9, torch.bfloat16, 320, s=64))
    _, args = _bwd_args(q, k, v, do)
    plains = {"dq": port._flash_dq_plain, "dkv": port._flash_dkv_plain}
    seen = {}

    def recording(kern, fn):
        def run(*a, **kw):
            seen[kern] = a[:4]
            return fn(*a, **kw)
        return run
    launchers = {(kern, "stream"): recording(kern, fn)
                 for kern, fn in plains.items()}
    dq, (dk, dv) = port._flash_bwd(*args, launchers=launchers)
    for kern in plains:
        assert all(a is b for a, b in zip(seen[kern], args[:4]))
    apart = [port._on_padded_head_dim(fn, args[:4], *args[4:],
                                      design=port._design(q.dtype, 320,
                                                          kern),
                                      kernel=kern)
             for kern, fn in plains.items()]
    for mine, theirs in zip((dq, dk, dv), (apart[0], *apart[1])):
        assert mine.shape == q.shape and torch.equal(mine, theirs)


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 200),
                                     (torch.float16, 80),
                                     (torch.float32, 80),
                                     (torch.float32, 600)])
def test_backward_pads_once_bit_identical_on_plain_versions(dtype, d):
    """``_flash_bwd`` with the plain versions in the kernels' place: dq
    and dk/dv read the same tensors, padded once at the head dim both run
    at (fp32 D 80 and 600) or, where both sm90 kernels read them in place
    (bf16 D 200, fp16 D 80), the caller's own, and give bit for bit what
    each gives apart."""
    q, k, v, do = (x.to(dtype) for x in _values(d + 4, dtype, d, s=64))
    _, args = _bwd_args(q, k, v, do)
    plains = {"dq": port._flash_dq_plain, "dkv": port._flash_dkv_plain}
    seen = []

    def recording(fn):
        def run(*a, **kw):
            seen.append(a[:4])
            return fn(*a, **kw)
        return run
    launchers = {(kern, design): recording(fn)
                 for kern, fn in plains.items()
                 for design in ("sm90", "simt", "tf32")}
    dq, (dk, dv) = port._flash_bwd(*args, launchers=launchers)
    designs = {kern: port._design(dtype, d, kern) for kern in plains}
    built = {port.padded_head_dim(d, designs[kern], kern) for kern in plains}
    in_place = {port._reads_in_place(d, designs[kern], kern)
                for kern in plains}
    assert len(built) == 1 and built.pop() > d and len(in_place) == 1
    assert len(seen) == 2
    assert all(a is b for a, b in zip(*seen))
    if in_place.pop():
        assert all(a is b for a, b in zip(seen[0], args[:4]))
    else:
        assert not any(a is b for a, b in zip(seen[0], args[:4]))
    apart = [port._on_padded_head_dim(fn, args[:4], *args[4:],
                                      design=designs[kern], kernel=kern)
             for kern, fn in plains.items()]
    for mine, theirs in zip((dq, dk, dv), (apart[0], *apart[1])):
        assert mine.shape == q.shape and mine.dtype == dtype
        assert torch.equal(mine, theirs)
