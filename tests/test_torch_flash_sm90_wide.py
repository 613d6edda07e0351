"""The CPU side of the tensor-core (sm90) forward and dk/dv kernels at fp16
and at head dims up to 256 (the forward to 512), and of the kernels past D
512: which design and padded head dim each kernel gets, the plain
versions' ``operands`` rounding (fp16 p and ds for fp16 inputs, bf16 for
bf16) that the card's checks compare those kernels with, and the padding
paths, all against the reference's Pallas kernels in interpret mode on the
CPU (``block_q=block_k=32``, as tests/test_torch_flash_head_dims.py runs
them). The kernels themselves run on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerances. Rounding p (or ds) to a 16-bit type moves it by at most u = 2^-8
(bf16) or 2^-11 (fp16) of itself, and an fp16 p below 2^-14 (subnormal) by
at most 2^-25; so o moves by at most (u |P| + floor) @ |V| / l and dk, dv by
the same products with ds and q, p and do: the provable bounds of
tests/test_torch_flash_sm90.py, with each type's u. Against the reference
(fp32 throughout) the rounding is the only difference beyond the fp32
bounds of tests/test_parallel.py (2e-5 forward, 1e-4 gradients).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.parallel import flash_attention as ref
from horovod_tpu_torch.parallel import flash_attention as port
from tests import torch_refpool
from tests.torch_threads import one_torch_thread  # noqa: F401

FWD_TOL = 2e-5
GRAD_TOL = 1e-4
UNIT = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}
FLOOR = {torch.bfloat16: 0.0, torch.float16: 2.0 ** -25}
ROUNDED_CASES = [(torch.float16, 128), (torch.bfloat16, 256),
                 (torch.float16, 256)]


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
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    return (o, m, l), (q, k, v, do, lse, delta, True, 0, 0)


@pytest.mark.parametrize("dtype,d", ROUNDED_CASES)
def test_plain_forward_operands_within_provable_bound(dtype, d):
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


@pytest.mark.parametrize("dtype,d", ROUNDED_CASES)
def test_plain_dkv_operands_within_provable_bound(dtype, d):
    q, k, v, do = _values(d + 1, dtype, d)
    _, args = _stats(q, k, v, do)
    dk, dv = port._flash_dkv_plain(*args)
    dk_r, dv_r = port._flash_dkv_plain(*args, operands=dtype)
    p, ds = port._p_ds_plain(*args)
    lim_v = torch.einsum("bhqk,bqhd->bkhd", _rounding(p, dtype), do.abs())
    lim_k = torch.einsum("bhqk,bqhd->bkhd", _rounding(ds, dtype), q.abs())
    assert torch.all((dv_r - dv).abs() <= lim_v + 1e-6)
    assert torch.all((dk_r - dk).abs() <= lim_k + 1e-6)
    assert (dv_r - dv).abs().max() > 0 and (dk_r - dk).abs().max() > 0


def _operands_ref(dtype, d):
    """A worker's job: the reference's forward output and dk, dv on
    ``test_plain_operands_match_reference``'s values and the plain
    forward's stats, fp32 throughout."""
    q, k, v, do = _values(d + 2, dtype, d)
    o_ref = ref.flash_attention_stats(
        *_jax(q, k, v), causal=True, block_q=32, block_k=32,
        interpret=True)[0]
    (o, m, l), _ = _stats(q, k, v, do)
    _, dk_ref, dv_ref = ref.flash_attention_bwd(
        *_jax(q, k, v, o, m, l, do), causal=True, block_q=32, block_k=32,
        interpret=True)
    return [np.asarray(x) for x in (o_ref, dk_ref, dv_ref)]


@pytest.mark.parametrize("dtype,d", ROUNDED_CASES)
def test_plain_operands_match_reference(dtype, d):
    """The plain forward and dk/dv with 16-bit operand rounding against
    the reference's Pallas forward and backward on the same values, fp32
    throughout: apart from the fp32 bounds, only the rounding differs."""
    q, k, v, do = _values(d + 2, dtype, d)
    o_ref, dk_ref, dv_ref = torch_refpool.result(
        (__name__, "operands", dtype, d))
    o_r = port._flash_fwd_plain(q, k, v, True, 0, 0, operands=dtype)[0]
    s = q.shape[1]
    fwd_limit = (UNIT[dtype] + FLOOR[dtype] * s) * v.abs().amax().item()
    np.testing.assert_allclose(o_r.numpy(), np.asarray(o_ref),
                               atol=fwd_limit + FWD_TOL, rtol=0)
    (o, m, l), args = _stats(q, k, v, do)
    dk_r, dv_r = port._flash_dkv_plain(*args, operands=dtype)
    p, ds = port._p_ds_plain(*args)
    lim_v = torch.einsum("bhqk,bqhd->bkhd", _rounding(p, dtype), do.abs())
    lim_k = torch.einsum("bhqk,bqhd->bkhd", _rounding(ds, dtype), q.abs())
    for mine, theirs, lim in ((dk_r, dk_ref, lim_k), (dv_r, dv_ref, lim_v)):
        err = (mine - torch.tensor(np.asarray(theirs))).abs()
        assert torch.all(err <= lim + GRAD_TOL), err.max()


DESIGNS = [
    # dtype, d, (fwd, dq, dkv) designs, (fwd, dq, dkv) padded head dims
    (torch.bfloat16, 16, "sm90 sm90 sm90", (16, 16, 16)),
    (torch.bfloat16, 32, "sm90 sm90 sm90", (32, 32, 32)),
    (torch.bfloat16, 33, "sm90 sm90 sm90", (64, 64, 64)),
    (torch.bfloat16, 64, "sm90 sm90 sm90", (64, 64, 64)),
    (torch.bfloat16, 80, "sm90 sm90 sm90", (128, 128, 128)),
    (torch.bfloat16, 96, "sm90 sm90 sm90", (128, 128, 128)),
    (torch.bfloat16, 128, "sm90 sm90 sm90", (128, 128, 128)),
    (torch.bfloat16, 160, "sm90 sm90 sm90", (256, 256, 256)),
    (torch.bfloat16, 200, "sm90 sm90 sm90", (256, 256, 256)),
    (torch.bfloat16, 256, "sm90 sm90 sm90", (256, 256, 256)),
    (torch.bfloat16, 257, "sm90 stream stream", (384, 320, 320)),
    (torch.bfloat16, 320, "sm90 stream stream", (384, 320, 320)),
    (torch.bfloat16, 512, "sm90 stream stream", (512, 512, 512)),
    (torch.bfloat16, 640, "stream stream stream", (640, 640, 640)),
    (torch.bfloat16, 600, "stream stream stream", (640, 640, 640)),
    (torch.float16, 640, "stream stream stream", (640, 640, 640)),
    (torch.float16, 32, "sm90 sm90 sm90", (32, 32, 32)),
    (torch.float16, 48, "sm90 sm90 sm90", (64, 64, 64)),
    (torch.float16, 128, "sm90 sm90 sm90", (128, 128, 128)),
    (torch.float16, 256, "sm90 sm90 sm90", (256, 256, 256)),
    (torch.float16, 384, "sm90 stream stream", (384, 384, 384)),
    (torch.float32, 32, "tf32 tf32 tf32", (32, 32, 32)),
    (torch.float32, 64, "tf32 tf32 tf32", (64, 64, 64)),
    (torch.float32, 96, "tf32 tf32 tf32", (96, 96, 96)),
    (torch.float32, 128, "tf32 tf32 tf32", (128, 128, 128)),
    (torch.float32, 256, "tf32 tf32 tf32", (256, 256, 256)),
    (torch.float32, 320, "tf32 tf32 tf32", (320, 320, 320)),
    (torch.float32, 1000, "tf32 tf32 tf32", (1024, 1024, 1024)),
    (torch.float32, 100, "tf32 tf32 tf32", (128, 128, 128)),
    (torch.float32, 600, "tf32 tf32 tf32", (608, 608, 608)),
]


@pytest.mark.parametrize("dtype,d,designs,padded", DESIGNS)
def test_design_and_padding_per_kernel(dtype, d, designs, padded):
    """bf16 and fp16 take sm90 for the forward at D 1-512 and stream past
    it, sm90 for dq and dk/dv at D 1-256 and stream for both past it; fp32
    takes tf32 for all three at every D (the narrow builds up to D 32).
    Each kernel pads
    to a head dim of its own design (16-bit D 257-320: dq and dk/dv at
    320, the forward's build 384)."""
    got = [port._design(dtype, d, kern) for kern in port.KERNELS]
    assert got == designs.split()
    assert [port.padded_head_dim(d, design, kern)
            for design, kern in zip(got, port.KERNELS)] == list(padded)


def test_padded_head_dim_past_512_never_raises():
    for d in range(513, 2200, 7):
        for kern in port.KERNELS:
            built = port.padded_head_dim(d, "simt", kern)
            assert built % port.CHUNK == 0 and d <= built < d + port.CHUNK
        # the forward's own designs there: stream (16-bit), tf32 (fp32)
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            design = port._design(dtype, d, "fwd")
            width = port.STREAM_DESIGNS[design][2]
            built = port.padded_head_dim(d, design, "fwd")
            assert built % width == 0 and d <= built < d + width
    with pytest.raises(ValueError, match="past head dim 512"):
        port.padded_head_dim(512, "stream", "fwd")
    with pytest.raises(ValueError, match="dk/dv past head dim 256"):
        port.padded_head_dim(256, "stream", "dkv")
    with pytest.raises(ValueError, match="dkv kernel takes head dims up to "
                                         "256"):
        port.padded_head_dim(320, "sm90", "dkv")
    with pytest.raises(ValueError, match="dq kernel takes head dims up to "
                                         "256"):
        port.padded_head_dim(320, "sm90", "dq")
    with pytest.raises(ValueError, match="512"):
        port.padded_head_dim(513, "sm90", "fwd")
    assert port.padded_head_dim(320, "sm90", "fwd") == 384


def _d640_ref():
    """A worker's job: the reference's output and the gradients of
    sum(out ** 2) at fp32 D 640, from one compiled program (the forward
    and its VJP with the cotangent 2 out)."""
    import jax
    qn, kn, vn = (x.numpy() for x in _values(640, torch.float32, 640,
                                               n=3))
    qj, kj, vj = map(jnp.asarray, (qn, kn, vn))

    def ref_flash(*a):
        return ref.flash_attention(*a, causal=True, block_q=32, block_k=32,
                                   interpret=True)

    def both(*a):
        out, vjp = jax.vjp(ref_flash, *a)
        return out, vjp(2.0 * out)
    out_ref, grads_ref = jax.jit(both)(qj, kj, vj)
    return np.asarray(out_ref), [np.asarray(g) for g in grads_ref]


def test_fp32_d640_plain_path_matches_reference():
    """D 640 on the CPU (the plain versions, which the card's chunked
    simt kernels are held to) against the reference, at its own fp32
    bounds; forward and all three gradients through autograd."""
    qn, kn, vn = (x.numpy() for x in _values(640, torch.float32, 640,
                                               n=3))
    out_ref, grads_ref = torch_refpool.result((__name__, "d640"))
    q, k, v = (torch.tensor(x, requires_grad=True) for x in (qn, kn, vn))
    out = port.flash_attention(q, k, v)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref),
                               atol=FWD_TOL)
    for mine, theirs in zip((q.grad, k.grad, v.grad), grads_ref):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                   atol=GRAD_TOL)


U = 2.0 ** -24   # the unit roundoff of fp32


def _gamma(n):
    """gamma_n = n u / (1 - n u): the relative error bound of n fp32
    roundings in a row (Higham, Accuracy and Stability, 3.1)."""
    return n * U / (1 - n * U)


def _order_bounds(q, k, v, do, lse, delta):
    """Per-element bounds on how far two fp32 evaluations of the plain
    forward (o, m, l) and dk/dv on the same inputs can part when only the
    order of their sums over D differs (see the test's docstring), from
    these inputs. q, k, v, do: fp32 [B, S, H, D] (causal, offsets 0);
    lse, delta: the backward's [B, H, S]."""
    d, sq, sk = q.shape[-1], q.shape[1], k.shape[1]
    scale = port._softmax_scale(d)
    allowed = torch.ones(sq, sk, dtype=torch.bool).tril()
    # |ds| per pair, and its row maximum
    dsig = (2 * _gamma(d + 1) * scale * allowed
            * torch.einsum("bqhd,bkhd->bhqk", q.abs(), k.abs()))
    dmax = dsig.amax(-1)
    s, _ = port._scores(q, k, True, 0, 0)
    keys = 2 * _gamma(sk)
    # forward: m moves by dmax; p (e^{s - m}) by the relative r_p, l by r_l
    m = s.amax(-1)
    p = torch.exp(s - m[..., None]) * allowed
    l = p.sum(-1)
    r_p = torch.expm1(2 * dmax) + 8 * U
    r_l = r_p + keys

    def per_row(x):   # [B, H, Sq] -> [B, Sq, H, 1]
        return x.transpose(1, 2)[..., None]
    a = torch.einsum("bhqk,bkhd->bqhd", p, v.abs()) / per_row(l)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v).abs() / per_row(l)
    b_o = (((per_row(r_p) + keys) * a + per_row(r_l) * o)
           / (1 - per_row(r_l)) + 2 * U * o)
    # backward, against the given lse and delta: p (e^{s - lse}) moves by
    # the relative r_b, dp by eta, ds as the product rule gives
    p = torch.exp(s - lse[..., None]) * allowed
    r_b = (torch.expm1(dmax) + 8 * U)[..., None]
    x = (torch.einsum("bqhd,bkhd->bhqk", do, v) - delta[..., None]).abs()
    eta = (2 * _gamma(d) * torch.einsum("bqhd,bkhd->bhqk", do.abs(),
                                        v.abs()) + 2 * U * x)
    ds = p * x * scale
    dds = scale * p * (r_b * (x + eta) + eta) + 6 * U * ds
    rows = 2 * _gamma(sq)
    b_dk = (torch.einsum("bhqk,bqhd->bkhd", dds, q.abs())
            + rows * torch.einsum("bhqk,bqhd->bkhd", ds, q.abs()))
    b_dv = (torch.einsum("bhqk,bqhd->bkhd", r_b * p, do.abs())
            + rows * torch.einsum("bhqk,bqhd->bkhd", p, do.abs()))
    return (b_o, dmax, r_l * l), (b_dk, b_dv)


def _within(mine, plain, limit):
    """The largest |mine - plain| / limit over the elements."""
    return ((mine - plain).abs() / limit).max().item()


def _padded_ref(design, dtype, d):
    """A worker's job: the reference's forward output on
    ``test_padding_on_plain_versions_matches_unpadded_and_reference``'s
    values."""
    q, k, v, _ = _values(d + 3, dtype, d)
    return np.asarray(ref.flash_attention_stats(
        *_jax(q, k, v), causal=True, block_q=32, block_k=32,
        interpret=True)[0])


PADDED_CASES = [("simt", torch.float32, 600), ("sm90", torch.bfloat16, 200),
                ("sm90", torch.float16, 80)]


def _jobs():
    """Every reference result the module's tests read, as
    ``torch_refpool`` jobs."""
    return ([((__name__, "operands", t, d), _operands_ref, (t, d))
             for t, d in ROUNDED_CASES]
            + [((__name__, "d640"), _d640_ref, ())]
            + [((__name__, "padded", *c), _padded_ref, c)
               for c in PADDED_CASES])


torch_refpool.register(_jobs)


@pytest.fixture(autouse=True, scope="module")
def _references():
    torch_refpool.start()


@pytest.mark.parametrize("design,dtype,d", PADDED_CASES)
def test_padding_on_plain_versions_matches_unpadded_and_reference(
        design, dtype, d):
    """What the card runs at a head dim no kernel of the design is built
    for (D 600 on the simt chunks of 640, D 200 and fp16 D 80 on the sm90
    kernels of 256 and 128, which read the tensors as they are,
    ``_reads_in_place``), with the plain versions
    in the kernels' place: equal to the unpadded plain versions up to the
    order of the fp32 sums over D, and to the reference.

    The zero columns change how einsum groups the sums over D, in a way
    that depends on the machine's BLAS, so the padded and unpadded plain
    versions are held to a bound derived from fp32 summation, per element
    from these inputs (``_order_bounds``). u = 2^-24, gamma_n = n u / (1 -
    n u). Each version's s = scale sum_i q_i k_i takes D products, D - 1
    additions (the padding adds exact zeros) and the scale: within
    gamma_{D+1} scale sum_i |q_i k_i| of the exact value, so the two part
    by |ds| <= 2 gamma_{D+1} scale sum_i |q_i k_i|; dmax is a row's
    largest |ds|. Then m moves by at most dmax; p = exp(s - m) by a
    relative r_p = e^{2 dmax} - 1 + 8u (the exp and the subtraction round
    on either side); l = sum_k p by r_l = r_p + 2 gamma_Sk (each side's
    own sum over the keys); o = sum_k p v / l by ((r_p + 2 gamma_Sk)
    sum_k p |v| / l + r_l |o|) / (1 - r_l) + 2u |o|. The backward takes
    lse and delta as given: p = exp(s - lse) moves by r_b = e^{dmax} - 1
    + 8u, dp = do . v by eta = 2 gamma_D sum_i |do_i v_i| + 2u |dp -
    delta|, ds = p (dp - delta) scale by scale p (r_b (|dp - delta| +
    eta) + eta) + 6u |ds|; dk = sum_q ds q and dv = sum_q p do by those
    times |q| and |do| summed over the queries, plus 2 gamma_Sq of the
    sums of |ds q| and |p do|. The bound has its power: the padded
    forward with the padded head dim's scale (what ``_at_head_dim`` would
    run without ``scale=``) must miss it more than tenfold (D 600: 18.7
    times the bound, where the two scales differ by 3%)."""
    q, k, v, do = _values(d + 3, dtype, d)
    fwd = port._on_padded_head_dim(port._flash_fwd_plain, (q, k, v), True,
                                   0, 0, design=design, kernel="fwd")
    plain = port._flash_fwd_plain(q, k, v, True, 0, 0)
    assert fwd[0].shape == q.shape
    _, args = _stats(q, k, v, do)
    fwd_limit, bwd_limit = _order_bounds(q, k, v, do, *args[4:6])
    for mine, p, limit in zip(fwd, plain, fwd_limit):
        assert _within(mine, p, limit) <= 1.0
    built = port.padded_head_dim(d, design, "fwd")
    wrong_scale = port._flash_fwd_plain(
        *port._pad_head_dim((q, k, v), built), True, 0, 0)[0][..., :d]
    assert _within(wrong_scale, plain[0], fwd_limit[0]) > 10.0
    o_ref = torch_refpool.result((__name__, "padded", design, dtype, d))
    np.testing.assert_allclose(fwd[0].numpy(), np.asarray(o_ref),
                               atol=FWD_TOL)
    dk, dv = port._on_padded_head_dim(port._flash_dkv_plain, (q, k, v, do),
                                      *args[4:], design=design,
                                      kernel="dkv")
    for mine, p, limit in zip((dk, dv), port._flash_dkv_plain(*args),
                              bwd_limit):
        assert mine.shape == q.shape
        assert _within(mine, p, limit) <= 1.0
