"""The CPU side of the fused 16-bit backward (csrc/flash_bwd_sm90.cu) and
of the backward's lse and delta pre-pass: which backwards take the fused
kernel (``_fused_bwd``, its build and whether it reads in place), the
pre-pass's plain version against the reference's lse and delta, the fused
kernel's plain version (dq summed per 128-key kv tile in a fixed order)
against the reference's backward, and ``_flash_bwd``'s route with the
fused launcher replaced by that plain version. The reference runs its
Pallas kernels in interpret mode, at its default blocks below S 128 and
blocks of 64 past it. The kernels themselves run on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Tolerances. lse is m + log l in fp32 on both sides (within 1e-6 of |m| +
|log l|, a few roundings of its terms, which cancel where lse is near 0;
+inf on the rows that saw no key, equal); delta is a sum of D fp32 products
that the two sides sum in other orders (1e-5 of the sum of |do o|, the
reference's 2e-5 forward bound halved, as the row has no softmax). The
fused plain version rounds p and ds to the input's 16-bit type where the
kernel feeds them to the tensor cores: each moves by at most one step of
that type (2^-8 bf16, 2^-10 fp16) of itself, so dv moves by at most that
step of |p| |do| summed over the queries, dk of |ds| |q| and dq of |ds|
|k| summed over the keys (tests/test_torch_flash_bwd_in_place.py's
bounds); its 16-bit outputs are rounded once more, by at most one step of
themselves; beyond those, the reference's gradient bound (1e-4) holds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.parallel import flash_attention as ref
from horovod_tpu_torch.parallel import flash_attention as port
from horovod_tpu_torch.utils import tolerance

GRAD_TOL = 1e-4
STEP = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -10}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_fused_route_covers_the_16_bit_head_dims_33_to_128(dtype):
    """bf16 and fp16 at every head dim 33-128 take the fused kernel, on the
    build of 64 up to 64 and of 128 past it, on the caller's tensors where
    d is a multiple of 8; the dq and dk/dv pair keeps its design (_design
    is per kernel)."""
    for d in range(33, 129):
        assert port._fused_bwd(dtype, d)
        assert port.padded_head_dim(d, "sm90", "bwd") == (64 if d <= 64
                                                          else 128)
        assert port._reads_in_place(d, "sm90", "bwd") == (d % 8 == 0)
        assert port._run_head_dim(d, "sm90", "bwd") == (
            d if d % 8 == 0 else port.padded_head_dim(d, "sm90", "bwd"))
        for kern in ("dq", "dkv"):
            assert port._design(dtype, d, kern) == "sm90"


@pytest.mark.parametrize("dtype,d", [
    (torch.bfloat16, 16), (torch.float16, 32), (torch.bfloat16, 129),
    (torch.float16, 256), (torch.bfloat16, 320), (torch.float16, 640),
    (torch.float32, 64), (torch.float32, 128), (torch.float32, 40)])
def test_fused_route_leaves_the_other_backwards_alone(dtype, d):
    """D <= 32 (the narrow builds), 129-256 (the D 256 builds), past 256
    (the stream design) and every fp32 head dim (tf32) keep their dq and
    dk/dv; the fused launcher refuses those head dims."""
    assert not port._fused_bwd(dtype, d)
    if dtype != torch.float32 and d > 128:
        with pytest.raises(ValueError):
            port.padded_head_dim(d, "sm90", "bwd")


def _stats_inputs(seed, b, s, h, d, dead=()):
    rng = np.random.RandomState(seed)
    o, do = (rng.randn(b, s, h, d).astype(np.float32) for _ in range(2))
    m = rng.randn(b, h, s).astype(np.float32)
    l = rng.uniform(0.5, 4.0, (b, h, s)).astype(np.float32)
    l[:, :, list(dead)] = 0.0
    return o, do, m, l


@pytest.mark.parametrize("d", [16, 80, 128])
def test_prepass_plain_version_matches_reference_stats(d):
    """_bwd_stats_plain (the pre-pass kernel's plain version) against the
    reference's lse (_lse_from_stats, +inf on rows with l == 0) and delta
    (rowsum(do * o) in fp32, as flash_attention_bwd sums it)."""
    b, s, h = 2, 48, 3
    o, do, m, l = _stats_inputs(d, b, s, h, d, dead=(0, 5, 47))
    lse, delta = port._bwd_stats_plain(*map(torch.tensor, (o, do, m, l)))
    lse_r = np.asarray(ref._lse_from_stats(jnp.asarray(m), jnp.asarray(l))
                       ).reshape(b, h, s)
    delta_r = np.asarray(jnp.sum(jnp.asarray(do) * jnp.asarray(o), axis=-1)
                         ).transpose(0, 2, 1)
    assert lse.shape == delta.shape == (b, h, s)
    assert lse.dtype == delta.dtype == torch.float32
    dead = np.isinf(lse_r)
    assert dead.sum() == b * h * 3
    assert np.array_equal(np.isinf(lse.numpy()), dead)
    assert np.all(lse.numpy()[dead] > 0)
    terms = (np.abs(m) + np.abs(np.log(np.where(l > 0, l, 1.0))))[~dead]
    assert np.all(np.abs(lse.numpy()[~dead] - lse_r[~dead]) <= 1e-6 * terms)
    size = np.abs(do * o).sum(-1).transpose(0, 2, 1)
    assert np.all(np.abs(delta.numpy() - delta_r) <= 1e-5 * size)


def test_prepass_takes_the_plain_version_on_the_cpu():
    """_bwd_prep on CPU tensors: the plain lse and delta, no counters, no
    launch counted (any 16-bit or fp32 dtype)."""
    o, do, m, l = (torch.tensor(x) for x in _stats_inputs(1, 1, 40, 2, 24,
                                                          dead=(3,)))
    port.reset_launch_counts()
    for dt in (torch.float32, torch.bfloat16):
        lse, delta, counters = port._bwd_prep(o.to(dt), do.to(dt), m, l, 9)
        want = port._bwd_stats_plain(o.to(dt), do.to(dt), m, l)
        assert counters is None
        assert torch.equal(lse, want[0]) and torch.equal(delta, want[1])
    assert not any(port.launch_counts().values())


# D, Sq, Sk, q_offset, k_offset (each in bf16 and fp16: one reference
# compile a shape)
FUSED_CASES = [
    pytest.param(40, 100, 100, 16, 0, id="d40_s100_q_offset"),
    pytest.param(64, 128, 192, 64, 0, id="d64_sq128_sk192"),
    pytest.param(80, 192, 192, 0, 32, id="d80_s192_dead_rows"),
    pytest.param(128, 100, 127, 27, 0, id="d128_sq100_sk127"),
]


def _fused_args(dtype, d, sq, sk, qo, ko, seed=0):
    """16-bit q, k, v, do (numpy-made), the fp32 plain forward's o, m, l
    and the plain pre-pass's lse and delta."""
    rng = np.random.RandomState(seed + d + sq)
    q, k, v, do = (torch.tensor(rng.randn(1, n, 1, d).astype(np.float32))
                   .to(dtype) for n in (sq, sk, sk, sq))
    o, m, l = port._flash_fwd_plain(q, k, v, True, qo, ko)
    lse, delta = port._bwd_stats_plain(o, do, m, l)
    return (q, k, v, do), (o, m, l), (lse, delta, True, qo, ko)


@pytest.mark.parametrize("d,sq,sk,qo,ko", FUSED_CASES)
def test_fused_plain_version_matches_the_reference_backward(d, sq, sk, qo,
                                                            ko):
    """_flash_bwd_sm90_plain in bf16 and fp16, p and ds rounded to the
    input's type, against the reference's backward on the same values
    (fp32): within the reference's gradient bound, the operands' rounding
    and that of the 16-bit outputs; its dk and dv are _flash_dkv_plain's."""
    for dtype in (torch.bfloat16, torch.float16):
        _check_fused_plain(dtype, d, sq, sk, qo, ko)


def _check_fused_plain(dtype, d, sq, sk, qo, ko):
    (q, k, v, do), (o, m, l), args = _fused_args(dtype, d, sq, sk, qo, ko)
    blocks = {} if max(sq, sk) < 128 else dict(block_q=64, block_k=64)
    jax_args = [jnp.asarray(x.float().numpy()) for x in (q, k, v, o, m, l,
                                                         do)]
    refs = [torch.tensor(np.asarray(x)) for x in ref.flash_attention_bwd(
        *jax_args, causal=True, q_offset=qo, k_offset=ko, interpret=True,
        **blocks)]
    p, ds = port._p_ds_plain(q, k, v, do, *args)
    unit = STEP[dtype]
    lims = (torch.einsum("bhqk,bkhd->bqhd", unit * ds.abs(), k.float().abs()),
            torch.einsum("bhqk,bqhd->bkhd", unit * ds.abs(), q.float().abs()),
            torch.einsum("bhqk,bqhd->bkhd", unit * p.abs(), do.float().abs()))
    mine = port._flash_bwd_sm90_plain(q, k, v, do, *args, operands=dtype)
    for x, theirs, lim, like in zip(mine, refs, lims, (q, k, v)):
        assert x.dtype == dtype and x.shape == like.shape
        err = (x.float() - theirs).abs()
        assert torch.all(err <= lim + GRAD_TOL + unit * theirs.abs()), \
            err.max()
    dkv = port._flash_dkv_plain(q, k, v, do, *args, operands=dtype)
    assert all(torch.equal(a, b) for a, b in zip(mine[1:], dkv))


@pytest.mark.parametrize("d", [80, 50])
def test_backward_runs_the_fused_launcher_once_and_no_pair(d):
    """_flash_bwd at bf16 D 80 (in place) and D 50 (padded once to 64)
    with the fused key's launcher replaced by its plain version: one call,
    on the caller's tensors or one padded copy, with the true head dim's
    scale and the gradients cut back to d; the dq and dk/dv launchers are
    never called."""
    (q, k, v, do), _, args = _fused_args(torch.bfloat16, d, 64, 64, 0, 0)
    calls = []

    def fused(*a, scale=None):
        calls.append((a[:4], scale))
        return port._flash_bwd_sm90_plain(*a, operands=torch.bfloat16,
                                          scale=scale)

    def pair(*a, **kw):
        raise AssertionError("a dq or dk/dv launcher ran")
    launchers = {key: pair for key in port._LAUNCHERS}
    launchers["bwd", "sm90"] = fused
    dq, (dk, dv) = port._flash_bwd(q, k, v, do, *args, launchers=launchers)
    assert len(calls) == 1
    seen, scale = calls[0]
    if d % 8 == 0:
        assert all(a is b for a, b in zip(seen, (q, k, v, do)))
        assert scale is None
    else:
        assert [t.shape[-1] for t in seen] == [64] * 4
        assert scale == port._softmax_scale(d)
    want = port._flash_bwd_sm90_plain(q, k, v, do, *args,
                                      operands=torch.bfloat16)
    for mine, theirs in zip((dq, dk, dv), want):
        assert mine.shape == q.shape
        # The padded copy's zero columns add nothing but may reorder the
        # fp32 sums.
        assert tolerance.worst(mine, theirs, GRAD_TOL,
                               step=tolerance.BF16_STEP)[1] <= 1.0


def test_fused_launcher_refuses_cpu_tensors_and_other_head_dims():
    """The fused launcher takes CUDA tensors of 16-bit head dims 33-128
    only; CPU tensors reach the plain versions through _flash_bwd alone."""
    q = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16)
    st = torch.zeros(1, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        port._flash_bwd_sm90(q, q, q, q, st, st, True, 0, 0)
    port.reset_launch_counts()
    dq, (dk, dv) = port._flash_bwd(q, q, q, q, st, st, True, 0, 0)
    assert dq.shape == dk.shape == dv.shape == q.shape
    assert not any(port.launch_counts().values())
    assert port._fused_bwd_counters(torch.zeros(3, 100, 5, 8)) == 3 * 5 * 2 + 1


@pytest.mark.parametrize("entry", ["hvdt_flash_bwd_sm90",
                                   "hvdt_flash_bwd_prep"])
def test_c_entries_take_the_arguments_their_ctypes_rows_pass(entry):
    """The fused backward's and the pre-pass's C entries
    (csrc/flash_bwd_sm90.cu) declare as many parameters as
    horovod_tpu_torch/_cuda.py's ctypes rows pass, pointers where it
    passes pointers (the library is built and loaded on the card only)."""
    import ctypes
    import os
    import re
    from horovod_tpu_torch import _cuda
    with open(os.path.join(_cuda.CSRC_DIR, "flash_bwd_sm90.cu")) as fh:
        src = fh.read()
    decl = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src)
    assert decl
    params = [p.strip() for p in decl.group(1).split(",")]
    row = _cuda._SIGNATURES[entry]
    assert len(params) == len(row)
    for param, kind in zip(params, row):
        assert ("*" in param) == (kind is ctypes.c_void_p), (param, kind)
